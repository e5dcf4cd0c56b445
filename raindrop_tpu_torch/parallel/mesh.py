"""The device mesh (port of raindrop_tpu/parallel/mesh.py) on
torch.distributed: one process a rank, the ranks laid out as a
("data", "model") grid.

  data   data parallelism over samples: each rank of a data group runs
         its contiguous rows of every global batch, and the gradients are
         averaged over the group before the optimizer step;
  model  Megatron tensor parallelism: the hot matmuls are split over the
         ranks of a model group (`tensor_parallel_specs`), each rank holds
         its slice of those parameters (`shard_params`) and the products
         are combined by collectives over the group (parallel/tensor.py).

Where the JAX package declares shardings and lets XLA place the
collectives, the port runs them explicitly. `make_mesh` is an
`init_device_mesh` over the process group, which `initialize_distributed`
starts: NCCL on CUDA, gloo on the CPU; torchrun's environment with
auto=True. Everything here also runs at world size 1, where every
collective is skipped.

The split rule is the JAX package's, leaf for leaf: column-parallel (the
output dim, dim 0 of a torch-layout [out, in] weight and of a bias) the
encoder's in_proj_w / in_proj_b and lin1, and propagation's lin_value;
row-parallel (the input dim, dim 1) out_proj.w and lin2.w; a leaf whose
dim does not divide by the model axis stays replicated. Where JAX's
GSPMD cuts in_proj_w [3d, d] into contiguous rows, the port gives a rank
its heads' rows of each of q, k and v (three blocks, `shard_blocks`), so
a rank's attention runs on its own heads without moving q, k, v.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "model")


def free_port() -> int:
    """A free TCP port on localhost (the rendezvous of a local group)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (the default when a card is present), gloo
    otherwise."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           auto: bool = False, backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> bool:
    """Start the process group. auto=True reads torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK: `init_method="env://"`);
    explicit arguments give the rendezvous `coordinator` ("host:port"),
    the world size and this process's rank. With neither this is a no-op
    (one process). `backend` defaults to default_backend(). Returns True
    iff a group was started here (False when one is already up)."""
    if dist.is_initialized():
        return False
    backend = backend or default_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    if auto:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return True
    if (num_processes is not None and num_processes > 1) or coordinator:
        if coordinator is None:
            raise ValueError("a process group of several processes needs "
                             "coordinator='host:port'")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes or 1),
                                rank=int(process_id or 0), timeout=timeout)
        return True
    return False


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              backend: Optional[str] = None):
    """A ("data", "model") DeviceMesh over the process group's ranks,
    rank r at (r // n_model, r % n_model). n_data None takes the world
    size over n_model. With no group started and a mesh of one rank, a
    single-process group is started on a free localhost port first."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise ValueError(f"a {n_data}x{n_model} mesh needs a process group "
                             f"of that many ranks (initialize_distributed)")
        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend=backend)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


@dataclass(frozen=True)
class Coords:
    """A rank's place on the mesh."""
    data_rank: int = 0
    n_data: int = 1
    model_rank: int = 0
    n_model: int = 1

    @property
    def world(self) -> int:
        return self.n_data * self.n_model


def coords(mesh) -> Coords:
    """This rank's Coords on `mesh` (None: the one-device Coords)."""
    if mesh is None:
        return Coords()
    n_data, n_model = (mesh.size(mesh.mesh_dim_names.index(a)) for a in AXES)
    return Coords(mesh.get_local_rank("data"), n_data,
                  mesh.get_local_rank("model"), n_model)


def group(mesh, axis: str):
    """The process group of this rank's line along `axis`, or None where
    the axis has one rank (a collective over it is the identity)."""
    if mesh is None or mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


@dataclass(frozen=True)
class Shard:
    """One rank's part of a forward: rows b0 .. b0 + B_local of a global
    batch of `batch` rows (data rank `data_rank` of `n_data`), and part
    `model_rank` of `n_model` on the model axis; the collectives of each
    axis run over its group (None: one rank). The
    dropout masks hash at these global coordinates (utils/dropout.py,
    the kernels' `origin`), so the ranks together draw the one-device
    masks."""
    b0: int = 0
    batch: int = 0
    model_rank: int = 0
    n_model: int = 1
    model_group: Any = None
    data_rank: int = 0
    n_data: int = 1
    data_group: Any = None

    @staticmethod
    def of(mesh, local_rows: int) -> Optional["Shard"]:
        """The Shard of this rank on `mesh` for a local batch of
        `local_rows` (None without a mesh, and on a mesh of one rank: its
        forward is then the one-device forward, line for line)."""
        c = coords(mesh)
        if c.world == 1:
            return None
        return Shard(c.data_rank * local_rows, c.n_data * local_rows,
                     c.model_rank, c.n_model, group(mesh, "model"),
                     c.data_rank, c.n_data, group(mesh, "data"))

    def part(self, n: int) -> Tuple[int, int]:
        """(offset, size) of this rank's part of an axis of n split over
        the model axis."""
        if n % self.n_model:
            raise ValueError(f"an axis of {n} does not split over "
                             f"{self.n_model} model ranks")
        size = n // self.n_model
        return self.model_rank * size, size


def data_only(shard: Optional[Shard]) -> Optional[Shard]:
    """`shard` with its model axis folded away (the rank's rows of the
    batch alone), None where that leaves one rank: the work a route runs
    whole on every model rank (a scale-out route's model axis carries the
    route's split, not tensor parallelism's)."""
    if shard is None or shard.n_data == 1:
        return None
    return dataclasses.replace(shard, model_rank=0, n_model=1, model_group=None)


def batch_rows(batch: int, data_rank: int, n_data: int) -> slice:
    """This data rank's contiguous rows of a global batch (the port's
    counterpart of shard_batch: each rank keeps its slice on its own
    device). `batch` must divide by n_data: the loss is a mean over the
    global batch, so the shards must be equal."""
    if batch % n_data:
        raise ValueError(f"a global batch of {batch} rows does not divide into "
                         f"{n_data} equal shards (data ranks)")
    per = batch // n_data
    return slice(data_rank * per, (data_rank + 1) * per)


# ---------------------------------------------------------- tensor parallel
def split_dim(path: List[str], shape, n_model: int) -> Optional[int]:
    """The dim of the leaf at `path` (its keys from the root) that the
    model axis splits, or None (replicated): the JAX package's
    tensor_parallel_specs rule."""
    if n_model <= 1 or not shape:
        return None
    leaf = path[-1] if path else ""
    parent = path[-2] if len(path) >= 2 else ""
    in_attn_block = "transformer_encoder" in path
    ndim = len(shape)

    def div(dim):
        return ndim > dim and shape[dim] % n_model == 0

    col = ((in_attn_block and parent == "lin1")
           or (in_attn_block and leaf in ("in_proj_w", "in_proj_b"))
           or parent == "lin_value")
    row = in_attn_block and parent in ("lin2", "out_proj") and leaf == "w"
    if col and ndim >= 1 and div(0):
        return 0
    if row and ndim == 2 and div(1):
        return 1
    return None


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(list(path), tree)


def tensor_parallel_specs(params, n_model: int = 1):
    """The split dim (int) or None of every leaf of `params` (a tree of
    tensors, arrays or anything with a .shape), for a model axis of
    n_model ranks."""
    return _walk(params, lambda path, leaf: split_dim(
        path, tuple(getattr(leaf, "shape", ())), n_model))


def shard_blocks(path: List[str], shape, dim: Optional[int], n_model: int,
                 model_rank: int) -> List[Tuple[Tuple[int, ...], Tuple[slice, ...]]]:
    """The blocks of a full leaf of `shape` that model rank `model_rank`
    holds, in the order its local tensor concatenates them along `dim`:
    (origin, slices) each. in_proj_w / in_proj_b [3d, ...] give three
    blocks (the rank's rows of q, of k and of v) when d divides by
    n_model; every other split leaf one contiguous block; a replicated
    leaf (dim None) the whole."""
    full = tuple(slice(0, n) for n in shape)
    if dim is None:
        return [((0,) * len(shape), full)]
    n = shape[dim]
    parts = 3 if (path[-1] in ("in_proj_w", "in_proj_b")
                  and n % (3 * n_model) == 0) else 1
    size = n // parts // n_model
    out = []
    for i in range(parts):
        start = i * (n // parts) + model_rank * size
        origin = tuple(start if a == dim else 0 for a in range(len(shape)))
        sl = tuple(slice(start, start + size) if a == dim else full[a]
                   for a in range(len(shape)))
        out.append((origin, sl))
    return out


def local_leaf(path, leaf: torch.Tensor, n_model: int, model_rank: int):
    """This model rank's part of the full `leaf` (a new tensor)."""
    dim = split_dim(path, tuple(leaf.shape), n_model)
    if dim is None:
        return leaf
    blocks = shard_blocks(path, tuple(leaf.shape), dim, n_model, model_rank)
    return torch.cat([leaf[sl] for _, sl in blocks], dim=dim).contiguous()


def shard_params(params, mesh=None, *, n_model: Optional[int] = None,
                 model_rank: Optional[int] = None):
    """The tree this rank keeps of the full `params`: its part of every
    split leaf (`shard_blocks`), the replicated leaves as they are. The
    model axis from `mesh`, or given."""
    c = coords(mesh)
    n = c.n_model if n_model is None else n_model
    m = c.model_rank if model_rank is None else model_rank
    if n == 1:
        return params
    return _walk(params, lambda path, leaf: local_leaf(path, leaf, n, m))
