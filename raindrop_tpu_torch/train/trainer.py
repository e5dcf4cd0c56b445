"""Training loop (port of raindrop_tpu/train/trainer.py): the train step,
the epoch over a device-resident split and padded evaluation.

Adam + mean cross-entropy on integer labels, as the reference protocol.
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

The per-split protocol (`train_split`, `run_splits`: validation metrics,
the plateau scheduler, checkpoint saving, resume) comes with the protocol
slice and raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from raindrop_tpu_torch.config import RaindropConfig, TrainConfig
from raindrop_tpu_torch.models.raindrop import (
    prop_branch, raindrop_apply, raindrop_init, raindrop_param_mask,
    warm_propagation)
from raindrop_tpu_torch.serve import resolve_device
from raindrop_tpu_torch.utils.dropout import DropoutSeeds

Batch = Dict[str, torch.Tensor]
Seeds = Union[DropoutSeeds, Sequence[DropoutSeeds], None]


def flatten_params(tree, prefix="") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a parameter tree in sorted-key order, the
    order the JAX package flattens its dict trees in."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.extend(flatten_params(tree[k], path))
        else:
            out.append((path, tree[k]))
    return out


class Trainer:
    """One (model config, train config) pair with its parameters and its
    masked-Adam optimizer on `device`."""

    def __init__(self, cfg: RaindropConfig, tcfg: TrainConfig, device="cuda",
                 params=None):
        """`params`: a parameter tree to train (moved to `device`; its
        leaves become the trainer's own), else `raindrop_init` from
        `tcfg.seed`."""
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        # the trainer's own seed stream (dropout masks), on the host so a
        # draw never waits for the card
        self._seed_gen = torch.Generator().manual_seed(tcfg.seed)
        if params is None:
            params = raindrop_init(tcfg.seed, cfg, device=self.device)
        self.set_params(params)
        warm_propagation(cfg, self.device)

    # ---- parameters and optimizer ---------------------------------------
    def set_params(self, params) -> None:
        """Adopt `params` and start a fresh optimizer over its live leaves."""
        def own(tree):
            if isinstance(tree, dict):
                return {k: own(v) for k, v in tree.items()}
            return tree.detach().to(self.device).clone()

        self.params = own(params)
        mask = dict(flatten_params(raindrop_param_mask(self.cfg)))
        leaves = flatten_params(self.params)
        if {path for path, _ in leaves} != set(mask):
            raise ValueError("params do not have the tree of raindrop_init "
                             "for this config")
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

    def draw_seeds(self, rows: int = 0) -> Seeds:
        """The seeds one train_step on a batch of `rows` samples consumes,
        from the trainer's stream. Only the COO propagation branch with
        prop_dropout reads per-sample seeds, so only then are they drawn."""
        n = self.tcfg.grad_microbatches
        per_sample = (self.cfg.prop_dropout > 0.0
                      and prop_branch(self.cfg, True, False) == "coo")
        draws = [DropoutSeeds.draw(self._seed_gen, self.cfg.nlayers,
                                   rows // n if per_sample else 0)
                 for _ in range(n)]
        return draws[0] if n == 1 else draws

    # ---- the step --------------------------------------------------------
    def loss_fn(self, batch: Batch, seeds: Optional[DropoutSeeds]):
        """Batch-major batch {"P" [B, T, 2F], "time" [B, T], "y" [B],
        "static" [B, S] (optional)} -> (loss, (logits, aux))."""
        src = batch["P"].transpose(0, 1)
        times = batch["time"].transpose(0, 1)
        lengths = (times > 0).sum(dim=0)
        logits, aux = raindrop_apply(
            self.params, self.cfg, src, batch.get("static"), times, lengths,
            train=True, seeds=seeds)
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
            if seeds is not None and not isinstance(seeds, DropoutSeeds):
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
        if isinstance(seeds, DropoutSeeds) or len(seeds) != n_micro:
            raise ValueError(f"grad_microbatches={n_micro} needs that many "
                             f"DropoutSeeds, one per chunk")
        per = rows // n_micro
        losses, logits = [], []
        for i in range(n_micro):
            chunk = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, (lg, _) = self.loss_fn(chunk, seeds[i])
            # the chunks' gradients add up in .grad; dividing each chunk's
            # loss by n_micro makes the sum the mean of the chunk means
            (loss / n_micro).backward()
            losses.append(loss.detach())
            logits.append(lg.detach())
        return torch.stack(losses).mean(), torch.cat(logits)

    def train_step(self, batch: Batch, seeds: Seeds = None):
        """One optimizer step on a device batch. `seeds`: a DropoutSeeds
        (a sequence of grad_microbatches of them when that is > 1); None
        draws from the trainer's own stream. Returns (loss, logits) on the
        device, without synchronising."""
        if seeds is None and (self.cfg.dropout > 0.0 or self.cfg.prop_dropout > 0.0):
            seeds = self.draw_seeds(batch["P"].shape[0])
        loss, logits = self._backward(batch, seeds)
        self.optimizer.step()
        return loss, logits

    def train_epoch(self, data: Batch, idx: torch.Tensor,
                    seeds: Optional[Sequence[Seeds]] = None):
        """One epoch over a split resident on the device: `data` holds the
        whole split batch-major, `idx` [K, B] (on the device) the sample
        indices of the K batches, gathered there. Returns (losses [K] on
        the host, the last step's logits on the device); the host waits
        for the card once, for the losses."""
        idx = idx.to(self.device)
        if seeds is not None and len(seeds) != idx.shape[0]:
            raise ValueError(f"{len(seeds)} seed sets for {idx.shape[0]} steps")
        losses, logits = [], None
        for k in range(idx.shape[0]):
            batch = {name: t[idx[k]] for name, t in data.items()}
            loss, logits = self.train_step(
                batch, None if seeds is None else seeds[k])
            losses.append(loss)
        return torch.stack(losses).cpu(), logits

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

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                self.device, torch.float32)

        for start in range(0, N, batch_size):
            end = min(start + batch_size, N)
            n = end - start
            idxb = np.concatenate([np.arange(start, end),
                                   np.full(batch_size - n, end - 1, np.int64)])
            times = dev(time[idxb]).transpose(0, 1)
            logits, _ = raindrop_apply(
                params, self.cfg, dev(P[idxb]).transpose(0, 1),
                None if static is None else dev(static[idxb]), times,
                (times > 0).sum(dim=0), train=False)
            out[start:end] = logits[:n].cpu().numpy()
        return out

    # ---- the per-split protocol ------------------------------------------
    def train_split(self, *args, **kwargs):
        raise NotImplementedError(
            "train_split (validation metrics, the plateau scheduler, "
            "checkpoint saving, resume) comes with the protocol slice")

    def run_splits(self, *args, **kwargs):
        raise NotImplementedError(
            "run_splits (the 5-split protocol) comes with the protocol slice")
