"""The multi-process input pipeline and per-rank sharded checkpoints (port
of raindrop_tpu/parallel/multihost.py).

  1. Sampler shards: every rank runs the same seeded balanced sampler
     (data/sampler.py), so it draws the same global batch index stream,
     and keeps its own contiguous slice of every batch. Disjoint and
     deterministic with no communication; the one numpy generator state
     restores every rank's sampler.
  2. Batches: where the JAX package stitches the ranks' slices into one
     global array (`global_batch`), each rank here keeps its slice on its
     own device and the collectives of the step (parallel/tensor.py, the
     trainer's gradient average) do the rest. Every rank holds the whole
     split in host memory (these datasets are at most 12k samples) and
     shards the work, not the storage.
  3. Per-rank checkpoint shards: each rank writes the blocks of the
     parameters it holds as `<path>.shard<k>-of<n>.npz`, with the JAX
     package's keys: a replicated leaf under its path, written by rank 0
     alone; a split leaf as one `<leaf>@<origin>` entry per contiguous
     block (a rank's heads' rows of in_proj_w are three) plus
     `<leaf>#shape`, written by the ranks of data rank 0. Loading
     reassembles whichever shard files are present, refuses a leaf whose
     blocks do not cover it and files of two generations (two process
     counts). The two packages read each other's files.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from raindrop_tpu_torch.bridge import array_to_tensor, tensor_to_array
from raindrop_tpu_torch.parallel.mesh import batch_rows, coords, shard_blocks
from raindrop_tpu_torch.train.checkpoint import flatten_params


# --------------------------------------------------------------- sampling
def local_batch_indices(global_idx: np.ndarray, process_index: int,
                        process_count: int) -> np.ndarray:
    """This rank's contiguous slice of one global batch's sample indices
    (mesh.batch_rows: the data axis enumerates the ranks in order; the
    batch must divide by the rank count)."""
    return np.asarray(global_idx)[batch_rows(len(global_idx), process_index,
                                             process_count)]


def sharded_balanced_batches(y, batch_size: int, strategy: int, rng, *,
                             n_batches: Optional[int] = None,
                             process_index: int = 0,
                             process_count: int = 1) -> Iterator[np.ndarray]:
    """The balanced sampler, sharded: this rank's disjoint slice of every
    global batch. Every rank passes an identically seeded rng."""
    from raindrop_tpu_torch.data.sampler import balanced_batches

    yield from balanced_batches(y, batch_size, strategy, rng, n_batches=n_batches,
                                shard_id=process_index, num_shards=process_count)


# -------------------------------------------------- per-rank ckpt shards
def _array(leaf) -> np.ndarray:
    return tensor_to_array(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_sharded_checkpoint(path: str, tree, mesh=None, *, specs=None,
                            n_model: Optional[int] = None,
                            model_rank: Optional[int] = None,
                            data_rank: Optional[int] = None,
                            process_index: Optional[int] = None,
                            process_count: Optional[int] = None) -> str:
    """Write this rank's shard file of `tree`, the rank's part of a full
    parameter tree (parallel/mesh.shard_params); `specs` the full tree's
    tensor_parallel_specs (needed on a model axis of more than one rank).
    The rank's place from `mesh` or given (process_index defaults to
    data_rank * n_model + model_rank, process_count to the mesh's size).
    Stale shard files of another process count at `path` are removed
    first. Returns the file name written."""
    c = coords(mesh)
    n = c.n_model if n_model is None else n_model
    m = c.model_rank if model_rank is None else model_rank
    dr = c.data_rank if data_rank is None else data_rank
    pi = dr * n + m if process_index is None else process_index
    pc = c.world if process_count is None else process_count
    if specs is None and n > 1:
        raise ValueError("a model axis of several ranks needs the full tree's "
                         "specs (tensor_parallel_specs)")
    dims = dict(flatten_params(specs)) if specs is not None else {}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for key, leaf in flatten_params(tree):
        a = _array(leaf)
        dim = dims.get(key)
        if dim is None:
            if pi == 0:
                arrays[key] = a
            continue
        if dr != 0:
            continue
        full = tuple(s * n if i == dim else s for i, s in enumerate(a.shape))
        start = 0
        for origin, sl in shard_blocks(key.split("/"), full, dim, n, m):
            size = sl[dim].stop - sl[dim].start
            block = np.take(a, np.arange(start, start + size), axis=dim)
            arrays[f"{key}@{','.join(map(str, origin))}"] = block
            start += size
        arrays[f"{key}#shape"] = np.asarray(full, np.int64)
    for old in glob.glob(f"{path}.shard*-of*.npz"):
        if not old.endswith(f"-of{pc}.npz"):
            try:
                os.remove(old)
            except OSError:
                pass
    fname = f"{path}.shard{pi}-of{pc}.npz"
    tmp = f"{path}.writing{pi}.npz"     # outside the shard files' pattern
    np.savez(tmp, **arrays)
    os.replace(tmp, fname)
    return fname


def load_sharded_checkpoint(path: str, like=None):
    """Reassemble the `save_sharded_checkpoint` files at `path` (either
    package's) into full arrays keyed by leaf path; raises if a split leaf
    is not covered or the files come from runs of two process counts.
    `like` (a tree of tensors of the full shapes) rebuilds that tree, each
    leaf on its template's device and in its dtype."""
    files = sorted(glob.glob(f"{path}.shard*-of*.npz"))
    if not files:
        raise FileNotFoundError(f"no shard files at {path}.shard*-of*.npz")
    counts = {f.rsplit("-of", 1)[1] for f in files}
    if len(counts) > 1:
        raise ValueError(f"mixed shard generations at {path}: process counts "
                         f"{sorted(counts)} — remove the stale files")
    full: Dict[str, np.ndarray] = {}
    pieces: Dict[str, list] = {}
    shapes: Dict[str, tuple] = {}
    for f in files:
        with np.load(f) as z:
            for k in z.files:
                if k.endswith("#shape"):
                    shapes[k[:-6]] = tuple(int(v) for v in z[k])
                elif "@" in k:
                    leaf, origin = k.rsplit("@", 1)
                    origin = tuple(int(v) for v in origin.split(","))
                    pieces.setdefault(leaf, []).append((origin, z[k]))
                else:
                    full[k] = z[k]
    for leaf, parts in pieces.items():
        buf = np.zeros(shapes[leaf], parts[0][1].dtype)
        covered = np.zeros(shapes[leaf], bool)
        for origin, chunk in parts:
            sl = tuple(slice(o, o + s) for o, s in zip(origin, chunk.shape))
            buf[sl] = chunk
            covered[sl] = True
        if not covered.all():
            raise ValueError(f"shard files do not cover leaf {leaf!r}")
        full[leaf] = buf
    if like is None:
        return full

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [build(v, f"{prefix}/{i}" if prefix else str(i))
                    for i, v in enumerate(tree)]
        a = full[prefix]
        if tuple(a.shape) != tuple(tree.shape):
            raise ValueError(f"{prefix}: {a.shape} in the shard files, "
                             f"{tuple(tree.shape)} expected")
        return array_to_tensor(np.ascontiguousarray(a)).to(tree.device, tree.dtype)

    return build(like, "")
