"""Training loop (port of raindrop_tpu/train/trainer.py): the train
step, the epoch over a device-resident split, padded evaluation and the
reference's experiment protocol (`train_split`, `run_splits`).

Adam + mean cross-entropy on integer labels, as the reference protocol.
Parameters and Adam's moments live in the config's storage dtype (with
dtype="bfloat16" both are bf16, as optax keeps its state in the
parameter's dtype); under compute_dtype the forward casts the live leaves
and their gradients arrive in the storage dtype.
The optimizer is `torch.optim.Adam` (betas 0.9/0.999, eps 1e-8, no weight
decay: optax.adam's update rule) over ONLY the live parameters of
`raindrop_param_mask`. A dead parameter (one the forward never reads)
keeps its storage across steps, never gets a `.grad` and never an
optimizer state: torch Adam skipping grad-less parameters is the
reference's own semantics.

Where the JAX trainer is functional (params and optimizer state in, new
ones out, one compiled scan per epoch), this one owns its parameters and
its optimizer and updates them in place; an epoch is a Python loop of
steps with one device-to-host copy, of the losses, at its end.

The model is pluggable, as in the JAX trainer: the baselines
(baselines/adapters.py) hand in their `apply_fn`, `init_fn` and
`draw_seeds`, and every parameter of theirs is live unless an
`update_mask` says otherwise; without them the trainer runs Raindrop in
the same form (adapters.make_flagship). The step, `predict`, `step_flops`,
`train_split` and the checkpoints all go through `apply_fn`.

The protocol, as the reference runs it: Adam + cross-entropy on
class-balanced batches, validation after every epoch with the plateau
scheduler stepped on val AUPRC, the best checkpoint keyed on val AUROC,
test metrics from the softmax path with the best parameters, and over the
splits the best run per split by AUPRC, then mean and std. Beyond the
reference, the full training state goes to `<path>_last` every epoch and a
run resumes from it exactly. With `input_pipeline="streaming"` an epoch's
batches are gathered on the host and copied ahead of each step
(data/prefetch.py) instead of gathered from the split on the device: the
same batches, seeds and results. With `measure_mfu` one step's model FLOPs
are counted once (`step_flops`) and every epoch record gets the achieved
TFLOP/s and MFU.

On a mesh (`mesh`, parallel/mesh.py: one process a rank) every rank
builds the same Trainer and draws the same seeds from the same
generators. A data rank trains on its contiguous rows of each global
batch (the sampler's shard), the model runs Megatron's split over the
model axis (models/raindrop.py), and the gradients are averaged over the
data axis before the masked-Adam step, so a step equals the one-device
step up to the order of the sums. Each rank keeps its part of the
parameters and of Adam's moments. `predict` gathers the logits of every
rank's rows. `train_split` on more than one rank needs a checkpoint
path: the best parameters go to per-rank shard files
(parallel/multihost.py) and are read back for the test; the `_last`
state is gathered whole and written by rank 0 (the one-device format, so
a run resumes on any mesh). Only rank 0 prints. The streaming pipeline
runs on one rank only, as in the JAX package; `measure_mfu` counts a
rank's step on its rows, so its MFU is the card's. The mesh trains the
flagship model; a pluggable model runs on one device.

The scale-out routes (TrainConfig's context_parallel, pipeline_microbatches,
edge_partition; the JAX trainer's) need a mesh and the flagship model. The
mesh's model axis then carries the route's split instead of tensor
parallelism's: every rank holds the whole parameters and Adam's whole
moments, and the step's gradient is the one-device gradient on every rank
before the masked-Adam step, which runs replicated. The leaves a model
rank computes only in part are summed over the model axis first: under
'sp' / 'ring' the attention's in_proj (a rank projects its T rows), under
the pipeline every encoder leaf (a rank runs its layer); edge partitioning
leaves none partial. Checkpoints, `full_params` and `predict` are then
the one-device ones (rank 0's shard file holds the whole tree).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
# torch.optim.Optimizer imports torch._dynamo lazily, at the first
# add_param_group of a process, and on this torch that first import keeps
# every frame then on the stack alive: the first Trainer (its __init__
# frame holds self) would never be freed. Imported here, the frames kept are
# the importer's.
import torch._dynamo  # noqa: F401

from raindrop_tpu_torch import bridge
from raindrop_tpu_torch.baselines.adapters import ModelFns, make_flagship
from raindrop_tpu_torch.config import RaindropConfig, TrainConfig
from raindrop_tpu_torch.data.datasets import Split
from raindrop_tpu_torch.data.prefetch import PrefetchExecutor
from raindrop_tpu_torch.data.sampler import balanced_batches, n_batches_per_epoch
from raindrop_tpu_torch.parallel import tensor as tp
from raindrop_tpu_torch.parallel.multihost import (
    load_sharded_checkpoint, save_sharded_checkpoint)
from raindrop_tpu_torch.parallel.mesh import (
    batch_rows, coords, group, local_leaf, shard_blocks, shard_params,
    tensor_parallel_specs)
from raindrop_tpu_torch.serve import resolve_device
from raindrop_tpu_torch.train.checkpoint import (
    flatten_params, load_checkpoint, save_checkpoint)
from raindrop_tpu_torch.train.metrics import (
    classification_metrics, classification_report_str, confusion_matrix_np)
from raindrop_tpu_torch.train.plateau import ReduceLROnPlateau
from raindrop_tpu_torch.utils.diagnostics import (
    counted_flops, device_peak_flops, frozen_param_report, mfu)
from raindrop_tpu_torch.utils.dropout import DropoutSeeds, ModelSeeds
from raindrop_tpu_torch.utils.tracking import _SafeTracker

Batch = Dict[str, torch.Tensor]
Seeds = Union[DropoutSeeds, ModelSeeds, Sequence[Union[DropoutSeeds, ModelSeeds]],
              None]


@dataclasses.dataclass
class TrainResult:
    test_metrics: Dict[str, float]
    best_val_auroc: float
    best_val_auprc: float
    history: List[Dict[str, Any]]
    samples_per_sec: float
    params: Any = None                  # the tested parameters, on the device
    test_confusion: Any = None          # [n_classes, n_classes] int array
    test_report: str = ""               # per-class report text


class Trainer:
    """One (model config, train config) pair with its parameters and its
    masked-Adam optimizer on `device`; reusable across splits."""

    def __init__(self, cfg: RaindropConfig, tcfg: TrainConfig, device="cuda",
                 params=None, init_fn=None, apply_fn=None, draw_seeds=None,
                 update_mask=None, mesh=None):
        """`params`: a parameter tree to train (moved to `device`; its
        leaves become the trainer's own), else `init_fn(tcfg.seed)`.
        `init_fn`: seed -> parameter tree, what `train_split` starts every
        run from (default the model's own).

        The model (baselines/adapters.ModelFns): `apply_fn(params, src,
        static, times, lengths, train, seeds)` -> (logits, aux),
        `draw_seeds(generator, rows)` the seeds one of its training
        forwards consumes (None: it drops nothing); without an apply_fn,
        Raindrop (adapters.make_flagship). `update_mask`: a tree of bools
        over the parameters, False for a leaf Adam leaves alone; by default
        the model's own: raindrop_param_mask for the flagship, every leaf
        live for an `apply_fn` (the JAX trainer's update_mask=None).
        `mesh`: a ("data", "model") DeviceMesh (parallel/mesh.make_mesh)
        this rank trains on; `params` and `init_fn` give the full tree,
        of which the rank keeps its part."""
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = dev = resolve_device(device)
        self.mesh = mesh
        routes = dict(context_parallel=tcfg.context_parallel,
                      pipeline_parallel=tcfg.pipeline_microbatches,
                      edge_partition=tcfg.edge_partition)
        self._route = (tcfg.context_parallel != "none"
                       or tcfg.pipeline_microbatches > 0 or tcfg.edge_partition)
        if self._route and mesh is None:
            raise ValueError(
                "context_parallel/pipeline_microbatches/edge_partition "
                "need a mesh (Trainer(..., mesh=make_mesh(n_data, n_model)))")
        if self._route and apply_fn is not None:
            raise ValueError("scale-out routes apply to the flagship "
                             "raindrop model only")
        self._coords = c = coords(mesh)
        self._data_group = group(mesh, "data")
        self._model_group = group(mesh, "model")
        if c.world > 1 and apply_fn is not None:
            raise ValueError("a mesh of several ranks trains the flagship model "
                             "only; a pluggable model runs on one device")
        # tensor parallelism's split of the parameters: off under a route
        self._n_split = 1 if self._route else c.n_model
        if self._n_split > 1:
            for name, n in (("nhead", cfg.nhead), ("ffn_dim", cfg.ffn_dim),
                            ("max_len * d_ob", cfg.max_len * cfg.d_ob)):
                if n % c.n_model:
                    raise ValueError(f"tensor parallelism over {c.n_model} model "
                                     f"ranks needs {name} ({n}) divisible by it")
        self._specs = None
        # the model's functions close over cfg and the device, not over
        # self: a cycle would keep a dropped trainer's parameters (7 GB at
        # PAM's width on a 2048-step window) alive until the cyclic
        # collector runs
        model = (make_flagship(cfg, dev, mesh, **routes) if apply_fn is None
                 else ModelFns(init_fn, apply_fn, draw_seeds))
        self._init = init_fn or model.init_fn
        self._apply, self._draw = model.apply_fn, model.draw_seeds
        self._update_mask = model.update_mask if update_mask is None else update_mask
        # the trainer's own seed stream (dropout masks), on the host so a
        # draw never waits for the card
        self._seed_gen = torch.Generator().manual_seed(tcfg.seed)
        self.set_params(self._init(tcfg.seed) if params is None else params)

    # ---- parameters and optimizer ---------------------------------------
    def set_params(self, params) -> None:
        """Adopt `params` (the full tree; on a model axis the rank keeps its
        part) and start a fresh optimizer over its live leaves."""
        device = self.device      # not self: `own` is in a cycle with itself

        def own(tree):
            if isinstance(tree, dict):
                return {k: own(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [own(v) for v in tree]
            return tree.detach().to(device).clone()

        n_model = self._n_split
        if n_model > 1:
            self._specs = tensor_parallel_specs(params, n_model)
            params = shard_params(params, n_model=n_model,
                                  model_rank=self._coords.model_rank)
        elif self._route and self._multi:   # every leaf whole on a route's mesh
            self._specs = tensor_parallel_specs(params, 1)
        self.params = own(params)
        leaves = flatten_params(self.params)
        if self._update_mask is None:
            mask = {path: True for path, _ in leaves}
        else:
            mask = dict(flatten_params(self._update_mask))
        if {path for path, _ in leaves} != set(mask):
            raise ValueError("params do not have the tree of the model's "
                             "update mask")
        self.live = [(path, t) for path, t in leaves if mask[path]]
        self.dead = [(path, t) for path, t in leaves if not mask[path]]
        for _, t in self.live:
            t.requires_grad_(True)
        self.optimizer = torch.optim.Adam(
            [t for _, t in self.live], lr=self.tcfg.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        """Rewritable between steps; nothing is rebuilt."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    def opt_state(self) -> Dict[str, Any]:
        """The optimizer's state as a tree of numpy arrays, the form
        `save_checkpoint` writes: the step count, the learning rate, and
        Adam's moments `mu`, `nu` for the live parameters (zeros before
        the first step), each in its parameter's dtype (bf16 as `|V2`
        bits, bridge.tensor_to_array)."""
        mu, nu, count = bridge.adam_state_to_numpy(self)
        for path, p in self.live:
            *parents, leaf = path.split("/")
            for tree in (mu, nu):
                for k in parents:
                    tree = tree.setdefault(k, {})
                if leaf not in tree:
                    tree[leaf] = bridge.zeros_array(p.shape, p.dtype)
        return {"count": np.asarray(count, np.int32),
                "learning_rate": np.asarray(self.learning_rate, np.float64),
                "mu": mu, "nu": nu}

    def load_opt_state(self, state: Dict[str, Any]) -> None:
        """Adopt a tree of `opt_state`'s form (of the full parameters; on a
        model axis the rank keeps its part of the moments)."""
        mu, nu = state["mu"], state["nu"]
        if self._n_split > 1:
            mu, nu = (self._local_tree(t) for t in (mu, nu))
        bridge.adam_state_from_jax(self, mu, nu, int(state["count"]))
        self.learning_rate = float(state["learning_rate"])

    # ---- the mesh -------------------------------------------------------
    @property
    def _multi(self) -> bool:
        """More than one rank: the per-rank checkpoint path of train_split."""
        return self._coords.world > 1

    def _split_dims(self) -> Dict[str, Optional[int]]:
        return dict(flatten_params(self._specs)) if self._specs is not None else {}

    def _local_tree(self, tree):
        """This model rank's part of a full tree of numpy arrays in the
        parameters' layout (Adam's moments)."""
        n, m = self._n_split, self._coords.model_rank

        def walk(t, path):
            if isinstance(t, dict):
                return {k: walk(v, path + [k]) for k, v in t.items()}
            a = bridge.array_to_tensor(np.ascontiguousarray(t))
            return bridge.tensor_to_array(local_leaf(path, a, n, m))

        return walk(tree, [])

    def _whole(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The full leaf at `path` from every model rank's part (a new
        tensor; `t` itself when the leaf is not split)."""
        dim = self._split_dims().get(path)
        if dim is None:
            return t
        n = self._n_split
        shape = [s * n if a == dim else s for a, s in enumerate(t.shape)]
        blocks = shard_blocks(path.split("/"), shape, dim, n, self._coords.model_rank)
        return tp.gather(t.detach(), blocks, dim, shape, self._model_group)

    def full_params(self):
        """The full parameter tree, gathered over the model axis (every
        rank gets it; the trainer's own tree off a model axis)."""
        if self._n_split == 1:
            return self.params

        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
            return self._whole(prefix, tree)

        return walk(self.params, "")

    def full_opt_state(self) -> Dict[str, Any]:
        """`opt_state` of the full parameters, gathered over the model axis."""
        state = self.opt_state()
        if self._n_split == 1:
            return state

        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
            t = bridge.array_to_tensor(tree).to(self.device)
            return bridge.tensor_to_array(self._whole(prefix, t))

        state["mu"], state["nu"] = walk(state["mu"], ""), walk(state["nu"], "")
        return state

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of x [rows, ...] from every data rank's
        (no autograd)."""
        c = self._coords
        if self._data_group is None:
            return x
        return tp.gather_dim(x.detach(), c.data_rank, c.n_data, self._data_group, 0)

    def _snapshot(self):
        """The parameter tree with the live leaves copied; a dead leaf
        never changes, so the snapshot shares it."""
        live = {path for path, _ in self.live}

        def walk(tree, prefix):
            if isinstance(tree, (list, tuple)):
                return [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in tree.items()}
            return tree.detach().clone() if prefix in live else tree.detach()

        return walk(self.params, "")

    def draw_seeds(self, rows: int = 0,
                   generator: Optional[torch.Generator] = None) -> Seeds:
        """The seeds one train_step on a batch of `rows` samples consumes,
        from the trainer's stream (or from `generator`): the model's
        draw_seeds once per microbatch, None for a model that drops
        nothing."""
        if self._draw is None:
            return None
        gen = self._seed_gen if generator is None else generator
        n = self.tcfg.grad_microbatches
        draws = [self._draw(gen, rows // n) for _ in range(n)]
        return draws[0] if n == 1 else draws

    # ---- the step --------------------------------------------------------
    def loss_fn(self, batch: Batch, seeds):
        """Batch-major batch {"P" [B, T, 2F], "time" [B, T], "y" [B],
        "static" [B, S] (optional)} -> (loss, (logits, aux))."""
        src = batch["P"].transpose(0, 1)
        times = batch["time"].transpose(0, 1)
        lengths = (times > 0).sum(dim=0)
        logits, aux = self._apply(self.params, src, batch.get("static"), times,
                                  lengths, True, seeds)
        loss = torch.nn.functional.cross_entropy(logits, batch["y"].long())
        if self.tcfg.aux_loss_weight:
            loss = loss + self.tcfg.aux_loss_weight * aux.sum()
        return loss, (logits, aux)

    def _backward(self, batch: Batch, seeds: Seeds):
        """Leave the mean gradient of the batch in the live `.grad`s;
        returns (loss, logits), detached."""
        n_micro = self.tcfg.grad_microbatches
        self.optimizer.zero_grad(set_to_none=True)
        if n_micro == 1:
            if isinstance(seeds, (list, tuple)):
                (seeds,) = seeds
            loss, (logits, _) = self.loss_fn(batch, seeds)
            loss.backward()
            return loss.detach(), logits.detach()
        rows = batch["P"].shape[0]
        if rows % n_micro:
            raise ValueError(
                f"batch of {rows} rows not divisible by grad_microbatches="
                f"{n_micro} (strategy-2 batches hold 2*(batch_size//2) samples)")
        if seeds is None:
            seeds = [None] * n_micro
        if not isinstance(seeds, (list, tuple)) or len(seeds) != n_micro:
            raise ValueError(f"grad_microbatches={n_micro} needs that many "
                             f"seed sets, one per chunk")
        per = rows // n_micro
        # the chunks' gradients add up in f32 and their mean is taken back
        # to each parameter's dtype, as the JAX trainer's accumulator does
        # (a bf16 .grad would round every addition)
        acc = [None] * len(self.live)
        losses, logits = [], []
        for i in range(n_micro):
            chunk = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, (lg, _) = self.loss_fn(chunk, seeds[i])
            loss.backward()
            for j, (_, t) in enumerate(self.live):
                if t.grad is not None:
                    g = t.grad.to(torch.float32)
                    acc[j] = g if acc[j] is None else acc[j] + g
                    t.grad = None
            losses.append(loss.detach())
            logits.append(lg.detach())
        for a, (_, t) in zip(acc, self.live):
            if a is not None:
                t.grad = (a / n_micro).to(t.dtype)
        return torch.stack(losses).mean(), torch.cat(logits)

    def train_step(self, batch: Batch, seeds: Seeds = None):
        """One optimizer step on a device batch. `seeds`: a DropoutSeeds
        (a pluggable model's: what its draw_seeds returns; a sequence of
        grad_microbatches of them when that is > 1); None draws from the
        trainer's own stream. Returns (loss, logits) on the
        device, without synchronising. On a data axis `batch` is this
        rank's rows of the global batch, the seeds are the global batch's,
        the loss is the global batch's mean and the logits the rank's rows
        (with grad_microbatches each rank splits its own rows)."""
        if seeds is None:
            seeds = self.draw_seeds(batch["P"].shape[0] * self._coords.n_data)
        loss, logits = self._backward(batch, seeds)
        if self._route and self._model_group is not None:
            self._sum_partial_grads()
        if self._data_group is not None:
            # the mean over the data axis: the global batch's gradient and
            # loss, in one all_reduce of the flattened f32 gradients and loss
            n = self._coords.n_data
            grads = [t.grad for _, t in self.live if t.grad is not None]
            flat = tp.all_reduce(torch.cat([g.reshape(-1).to(torch.float32)
                                            for g in (*grads, loss.reshape(1))]),
                                 self._data_group) / n
            for g, part in zip(grads, flat.split([g.numel() for g in grads] + [1])):
                g.copy_(part.view_as(g))
            loss = flat[-1]
        self.optimizer.step()
        return loss, logits

    def _partial(self, path: str) -> bool:
        """Whether a model rank computes the gradient of the leaf at `path`
        only in part under the trainer's route (its sum over the model axis
        is the one-device gradient)."""
        parts = path.split("/")
        if parts[0] != "transformer_encoder":
            return False
        if self.tcfg.pipeline_microbatches > 0:
            return True          # a stage runs one layer
        return self.tcfg.context_parallel != "none" and parts[-1] in (
            "in_proj_w", "in_proj_b")   # a rank projects its T rows

    def _sum_partial_grads(self) -> None:
        """Sum the partial leaves' gradients over the model axis (one
        all_reduce of them flattened in f32; a leaf the rank never reached
        contributes zeros)."""
        live = [t for path, t in self.live if self._partial(path)]
        if not live:
            return
        for t in live:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        flat = tp.all_reduce(torch.cat([t.grad.reshape(-1).to(torch.float32)
                                        for t in live]), self._model_group)
        for t, part in zip(live, flat.split([t.numel() for t in live])):
            t.grad.copy_(part.view_as(t.grad))

    def train_epoch(self, data, idx: Optional[torch.Tensor] = None,
                    seeds: Optional[Sequence[Seeds]] = None):
        """One epoch of optimizer steps over `data`: a split resident on
        the device (the whole split batch-major, `idx` [K, B] the sample
        indices of the K batches, gathered there), or, with `idx` None, an
        iterable of device batches (the streaming pipeline's
        PrefetchExecutor). Returns (losses [K] on the host, the last step's
        logits on the device); the host waits for the card once, for the
        losses. On a data axis `idx` holds the global batches and each rank
        gathers its rows of them."""
        if idx is not None:
            c = self._coords
            if c.n_data > 1:
                idx = idx[:, batch_rows(idx.shape[1], c.data_rank, c.n_data)]
            idx = idx.to(self.device)
            if seeds is not None and len(seeds) != idx.shape[0]:
                raise ValueError(f"{len(seeds)} seed sets for {idx.shape[0]} steps")
            split = data
            batches = ({name: t[rows] for name, t in split.items()} for rows in idx)
        else:
            batches = data
        losses, logits = [], None
        for k, batch in enumerate(batches):
            loss, logits = self.train_step(
                batch, None if seeds is None else seeds[k])
            losses.append(loss)
        return torch.stack(losses).cpu(), logits

    def step_flops(self, batch: Batch) -> float:
        """Model FLOPs of one train_step on `batch` (utils/diagnostics.
        counted_flops: the matmuls PyTorch runs plus the kernels' credit),
        counted by running the step's forward and backward once without
        disturbing the training: the gradients come from
        torch.autograd.grad (no `.grad` is written), nothing is updated,
        and the dropout seeds come from a generator of the count's own, not
        from the trainer's stream. The kernels' launch counts do see it."""
        rows = batch["P"].shape[0]
        n_micro = self.tcfg.grad_microbatches
        seeds = self.draw_seeds(rows, torch.Generator().manual_seed(0))
        chunks = [seeds] if n_micro == 1 else (seeds or [None] * n_micro)
        live = [t for _, t in self.live]
        per = rows // n_micro

        def step():
            for i, chunk_seeds in enumerate(chunks):
                chunk = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                loss, _ = self.loss_fn(chunk, chunk_seeds)
                torch.autograd.grad(loss, live, allow_unused=True)

        return counted_flops(step)

    # ---- evaluation ------------------------------------------------------
    @torch.no_grad()
    def predict(self, params, P, time, static, batch_size: int = 100) -> np.ndarray:
        """Chunked inference on host arrays P [N, T, 2F], time [N, T],
        static [N, S] or None -> logits [N, n_classes] (numpy). The tail
        chunk is padded with repeats of its last row, so every launch has
        `batch_size` rows."""
        params = self.params if params is None else params
        N = P.shape[0]
        out = np.zeros((N, self.cfg.n_classes), np.float32)
        c = self._coords
        if c.n_data > 1:
            # every rank runs its rows of each chunk; the logits gathered
            batch_size = max(batch_size // c.n_data * c.n_data, c.n_data)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                self.device, torch.float32)

        for start in range(0, N, batch_size):
            end = min(start + batch_size, N)
            n = end - start
            idxb = np.concatenate([np.arange(start, end),
                                   np.full(batch_size - n, end - 1, np.int64)])
            if c.n_data > 1:
                idxb = idxb[batch_rows(batch_size, c.data_rank, c.n_data)]
            times = dev(time[idxb]).transpose(0, 1)
            logits, _ = self._apply(
                params, dev(P[idxb]).transpose(0, 1),
                None if static is None else dev(static[idxb]), times,
                (times > 0).sum(dim=0), False, None)
            logits = self._gather_rows(logits.to(torch.float32))
            out[start:end] = logits[:n].to("cpu").numpy()
        return out

    # ---- the per-split protocol ------------------------------------------
    def train_split(self, split: Split, *, seed: Optional[int] = None,
                    log_file=None, checkpoint_path: Optional[str] = None,
                    resume_from: Optional[str] = None, verbose: bool = True,
                    on_epoch_end=None, tracker=None) -> TrainResult:
        """Run the full per-split protocol from fresh parameters
        (`init_fn(seed)`; seed defaults to tcfg.seed).

        checkpoint_path: the parameters with the best val AUROC go to
        <path>.npz, the full training state (parameters, optimizer state,
        scheduler, sampler and seed-generator states, epoch, history) to
        <path>_last.npz after every epoch. resume_from: a `_last` path to
        continue from exactly. on_epoch_end: callable(epoch, record),
        called once the epoch's checkpoint is written. tracker: a
        RunTracker (utils/tracking.py); its failures never reach the run.
        On more than one rank checkpoint_path is required (the best
        parameters persist as per-rank shard files) and only rank 0
        prints; `verbose` must be the same on every rank.
        """
        if not isinstance(tracker, _SafeTracker):
            tracker = _SafeTracker(tracker)
        cfg, tcfg = self.cfg, self.tcfg
        multi = self._multi
        if multi and not checkpoint_path:
            raise ValueError("training on several ranks requires checkpoint_path "
                             "(the best parameters persist as per-rank shard "
                             "files; see parallel/multihost.py)")
        if multi and tcfg.input_pipeline == "streaming":
            raise ValueError("input_pipeline='streaming' runs on one rank; a "
                             "mesh keeps the split resident on every rank")
        rank0 = not multi or dist.get_rank() == 0
        show = verbose and rank0
        seed = tcfg.seed if seed is None else seed
        rng_np = np.random.default_rng(seed)
        self._seed_gen.manual_seed(seed)
        scheduler = ReduceLROnPlateau(
            tcfg.learning_rate, factor=tcfg.plateau_factor,
            patience=tcfg.plateau_patience, threshold=tcfg.plateau_threshold,
            min_lr=tcfg.plateau_min_lr)
        strategy = tcfg.batching_strategy
        n_batches = n_batches_per_epoch(
            split.ytrain, tcfg.batch_size, strategy, tcfg.n_batches_strategy3)

        best = {"auroc": 0.0, "auprc": 0.0, "params": None}
        history: List[Dict[str, Any]] = []
        n_samples_done = 0
        start_epoch = 0

        if resume_from is None:
            self.set_params(self._init(seed))
            self.learning_rate = tcfg.learning_rate
        else:
            params, opt_state, meta = load_checkpoint(
                resume_from, self.full_params(), self.full_opt_state())
            self.set_params(params)
            self.load_opt_state(opt_state)
            scheduler.load_state_dict(meta["scheduler"])
            rng_np.bit_generator.state = meta["np_rng_state"]
            self._seed_gen.set_state(torch.tensor(
                meta["seed_generator_state"], dtype=torch.uint8))
            start_epoch = meta["epoch"] + 1
            best.update(auroc=meta["best_auroc"], auprc=meta["best_auprc"])
            history = meta.get("history", [])
            # the best-val parameters lie next to the _last file: without
            # them a resumed run whose remaining epochs never beat the
            # restored AUROC would test on the final parameters
            if resume_from.endswith("_last"):
                best_path = resume_from[: -len("_last")]
                if multi and glob.glob(f"{best_path}.shard*-of*.npz"):
                    best["params"] = "__sharded__"
                elif not multi and os.path.exists(best_path + ".npz"):
                    best["params"], _, _ = load_checkpoint(best_path, self.params)

        # the training split as the step reads it: on the device, or on the
        # host for the streaming pipeline (batches gathered there and
        # copied ahead of the step, data/prefetch.py)
        host = {"P": split.Ptrain, "time": split.Ptrain_time, "y": split.ytrain}
        if split.Ptrain_static is not None:
            host["static"] = split.Ptrain_static
        dtypes = {"P": torch.float32, "time": torch.float32, "y": torch.int64,
                  "static": torch.float32}
        streaming = tcfg.input_pipeline == "streaming"
        train_dev = None if streaming else {
            k: torch.as_tensor(np.ascontiguousarray(a)).to(self.device, dtypes[k])
            for k, a in host.items()}

        # opt-in MFU telemetry: the model FLOPs of one step on a batch of
        # the split's shape, counted once (on rows of a sampler draw of its
        # own, so the run's sampler stream is untouched); the epoch records
        # then carry the achieved TFLOP/s and the MFU
        step_flops, peak, last_elapsed = None, None, 0.0
        if tcfg.measure_mfu:
            rows = next(balanced_batches(split.ytrain, tcfg.batch_size, strategy,
                                         np.random.default_rng(0), n_batches=1))
            c = self._coords
            rows = rows[batch_rows(len(rows), c.data_rank, c.n_data)]   # this rank's
            step_flops = self.step_flops({
                k: torch.as_tensor(np.ascontiguousarray(a[rows])).to(
                    self.device, dtypes[k]) for k, a in host.items()})
            peak = device_peak_flops(self.device)

        t0 = time.time()
        snapshot = None
        if tcfg.diag_frozen_params:
            snapshot = {path: t.detach().clone()
                        for path, t in flatten_params(self.params)}

        for epoch in range(start_epoch, tcfg.num_epochs):
            idx = np.stack(list(balanced_batches(
                split.ytrain, tcfg.batch_size, strategy, rng_np,
                n_batches=n_batches)))
            if streaming:
                with PrefetchExecutor(host, idx, depth=tcfg.prefetch_depth,
                                      device=self.device, dtypes=dtypes) as batches:
                    losses, logits = self.train_epoch(batches)
                if len(losses) != len(idx):
                    raise RuntimeError(f"the prefetch executor gave {len(losses)} "
                                       f"of {len(idx)} batches")
            else:
                losses, logits = self.train_epoch(train_dev, torch.from_numpy(idx))
            loss = float(losses[-1])
            n_samples_done += idx.size

            # the last batch's train confusion matrix at the first and last
            # epoch: the reference's sanity print, labels [0, 1] hard-coded
            # (every rank gathers, rank 0 prints)
            if verbose and epoch in (start_epoch, tcfg.num_epochs - 1):
                lg = self._gather_rows(logits.to(torch.float32)).to("cpu").numpy()
                if show:
                    print(confusion_matrix_np(split.ytrain[idx[-1]], np.argmax(lg, 1),
                                              labels=[0, 1]))

            if snapshot is not None:
                for name in frozen_param_report(
                        snapshot, dict(flatten_params(self.params))):
                    print(f"Not updated in {name}")
                snapshot = None

            # validation, every epoch, on the element-wise sigmoid
            val_logits = self.predict(None, split.Pval, split.Pval_time,
                                      split.Pval_static)
            val = classification_metrics(val_logits, split.yval, cfg.n_classes,
                                         prob_mode="sigmoid")
            new_lr = scheduler.step(val["auprc"])
            self.learning_rate = new_lr

            rec = {"epoch": epoch, "train_loss": loss,
                   "val_auroc": val["auroc"], "val_auprc": val["auprc"],
                   "lr": new_lr, "elapsed_s": time.time() - t0}
            if step_flops and rec["elapsed_s"] > last_elapsed:
                # achieved model FLOP/s over the epoch's wall time, which
                # holds its validation and the previous epoch's checkpoint
                # writes too (the JAX package's definition)
                flops_per_sec = (step_flops * n_batches
                                 / (rec["elapsed_s"] - last_elapsed))
                rec["train_tflops_per_sec"] = flops_per_sec / 1e12
                rec["mfu"] = mfu(flops_per_sec, peak)
            last_elapsed = rec["elapsed_s"]
            history.append(rec)
            tracker.log_epoch(rec)
            if log_file:
                log_file.write(json.dumps(rec) + "\n")
                log_file.flush()
            if show:
                print(f"epoch {epoch}: loss={rec['train_loss']:.4f} "
                      f"val_auroc={val['auroc']*100:.2f} "
                      f"val_auprc={val['auprc']*100:.2f} lr={new_lr:.2e}")

            if val["auroc"] > best["auroc"]:
                if multi:
                    # each rank persists its part; the test reads them back
                    best.update(auroc=val["auroc"], auprc=val["auprc"],
                                params="__sharded__")
                    save_sharded_checkpoint(checkpoint_path, self.params, self.mesh,
                                            specs=self._specs)
                else:
                    best.update(auroc=val["auroc"], auprc=val["auprc"],
                                params=self._snapshot())
                    if checkpoint_path:
                        save_checkpoint(checkpoint_path, self.params,
                                        meta={"epoch": epoch, "val": val,
                                              "config": dataclasses.asdict(cfg)})
            if checkpoint_path:
                # the whole state (gathered over the model axis), by rank 0
                params_all, opt_all = self.full_params(), self.full_opt_state()
                if rank0:
                    save_checkpoint(
                        checkpoint_path + "_last", params_all, opt_all,
                        meta={"epoch": epoch,
                              "scheduler": scheduler.state_dict(),
                              "np_rng_state": rng_np.bit_generator.state,
                              "seed_generator_state":
                                  self._seed_gen.get_state().tolist(),
                              "best_auroc": best["auroc"],
                              "best_auprc": best["auprc"],
                              "history": history})
                del params_all, opt_all
                if multi:
                    tp.barrier(device=self.device)
            if on_epoch_end is not None:
                on_epoch_end(epoch, rec)

        elapsed = time.time() - t0
        # test with the best parameters, on the softmax
        if best["params"] == "__sharded__":
            tp.barrier(device=self.device)
            full = load_sharded_checkpoint(checkpoint_path, like=self.full_params())
            c = self._coords
            test_params = shard_params(full, n_model=self._n_split,
                                       model_rank=c.model_rank)
        else:
            test_params = self.params if best["params"] is None else best["params"]
        test_logits = self.predict(test_params, split.Ptest, split.Ptest_time,
                                   split.Ptest_static)
        test = classification_metrics(test_logits, split.ytest, cfg.n_classes,
                                      prob_mode="softmax")
        ypred = np.argmax(test_logits, axis=1)
        confusion = confusion_matrix_np(split.ytest, ypred,
                                        labels=range(cfg.n_classes))
        report = classification_report_str(split.ytest, ypred)
        if show:
            print("classification report\n" + report)
            print(confusion)
        return TrainResult(
            test_metrics=test, best_val_auroc=best["auroc"],
            best_val_auprc=best["auprc"], history=history,
            samples_per_sec=n_samples_done / max(elapsed, 1e-9),
            params=test_params, test_confusion=confusion, test_report=report)


def run_splits(make_split, cfg: RaindropConfig, tcfg: TrainConfig, *,
               device="cuda", verbose: bool = True,
               resume_from: Optional[str] = None,
               tracker=None, mesh=None) -> Dict[str, Any]:
    """The n_splits x n_runs protocol with the reference's aggregation:
    the best run per split by AUPRC, then mean and std over the splits (in
    percent).

    make_split: callable split_idx (1-based) -> Split. With
    tcfg.resplit_per_run it is called as make_split(split_idx, run=m) for
    every run instead and must draw a new partition per run. resume_from
    continues the first run of the first split. `mesh`: train every run
    on it (Trainer's); only rank 0 prints."""
    tracker = _SafeTracker(tracker)
    tracker.start({"dataset": tcfg.dataset,
                   "model_config": dict(vars(cfg)),
                   "train_config": dict(vars(tcfg))})
    trainer = Trainer(cfg, tcfg, device=device, mesh=mesh)
    show = verbose and (not trainer._multi or dist.get_rank() == 0)
    log_file = open(tcfg.log_path, "a") if tcfg.log_path else None
    per_split: List[Dict[str, float]] = []
    try:
        for k in range(1, tcfg.n_splits + 1):
            split = None if tcfg.resplit_per_run else make_split(k)
            runs = []
            for m in range(tcfg.n_runs):
                if show:
                    print(f"--- split {k} run {m + 1} ---")
                split_m = (make_split(k, run=m) if tcfg.resplit_per_run
                           else split)
                ckpt = os.path.join(tcfg.checkpoint_dir,
                                    f"raindrop_{tcfg.dataset}_s{k}_r{m}")
                runs.append(trainer.train_split(
                    split_m, seed=tcfg.seed + m, log_file=log_file,
                    checkpoint_path=ckpt, verbose=verbose,
                    resume_from=(resume_from if k == 1 and m == 0 else None),
                    tracker=tracker))
            best_run = max(runs, key=lambda r: r.test_metrics["auprc"])
            per_split.append(best_run.test_metrics)
    finally:
        if log_file:
            log_file.close()

    summary = {}
    for name in per_split[0]:
        vals = np.array([m[name] for m in per_split]) * 100.0
        summary[name] = {"mean": float(vals.mean()), "std": float(vals.std()),
                         "per_split": vals.tolist()}
    if show:
        for name, s in summary.items():
            print(f"{name:>9} = {s['mean']:.1f} +/- {s['std']:.1f}")
    tracker.finish(summary)
    return {"summary": summary, "per_split": per_split}
