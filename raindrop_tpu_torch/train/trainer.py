"""Training loop (port of raindrop_tpu/train/trainer.py): the train
step, the epoch over a device-resident split, padded evaluation and the
reference's experiment protocol (`train_split`, `run_splits`).

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

The protocol, as the reference runs it: Adam + cross-entropy on
class-balanced batches, validation after every epoch with the plateau
scheduler stepped on val AUPRC, the best checkpoint keyed on val AUROC,
test metrics from the softmax path with the best parameters, and over the
splits the best run per split by AUPRC, then mean and std. Beyond the
reference, the full training state goes to `<path>_last` every epoch and a
run resumes from it exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
# torch.optim.Optimizer imports torch._dynamo lazily, at the first
# add_param_group of a process, and on this torch that first import keeps
# every frame then on the stack alive: the first Trainer (its __init__
# frame holds self) would never be freed. Imported here, the frames kept are
# the importer's.
import torch._dynamo  # noqa: F401

from raindrop_tpu_torch import bridge
from raindrop_tpu_torch.config import RaindropConfig, TrainConfig
from raindrop_tpu_torch.data.datasets import Split
from raindrop_tpu_torch.data.sampler import balanced_batches, n_batches_per_epoch
from raindrop_tpu_torch.models.raindrop import (
    prop_branch, raindrop_apply, raindrop_init, raindrop_param_mask,
    warm_propagation)
from raindrop_tpu_torch.serve import resolve_device
from raindrop_tpu_torch.train.checkpoint import (
    flatten_params, load_checkpoint, save_checkpoint)
from raindrop_tpu_torch.train.metrics import (
    classification_metrics, classification_report_str, confusion_matrix_np)
from raindrop_tpu_torch.train.plateau import ReduceLROnPlateau
from raindrop_tpu_torch.utils.diagnostics import frozen_param_report
from raindrop_tpu_torch.utils.dropout import DropoutSeeds
from raindrop_tpu_torch.utils.tracking import _SafeTracker

Batch = Dict[str, torch.Tensor]
Seeds = Union[DropoutSeeds, Sequence[DropoutSeeds], None]


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
                 params=None, init_fn=None):
        """`params`: a parameter tree to train (moved to `device`; its
        leaves become the trainer's own), else `init_fn(tcfg.seed)`.
        `init_fn`: seed -> parameter tree, what `train_split` starts every
        run from (default `raindrop_init` on the device)."""
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = dev = resolve_device(device)
        # the default init closes over the device, not over self: a cycle
        # would keep a dropped trainer's parameters (7 GB at PAM's width on
        # a 2048-step window) alive until the cyclic collector runs
        self._init = init_fn or (lambda seed: raindrop_init(seed, cfg, device=dev))
        # the trainer's own seed stream (dropout masks), on the host so a
        # draw never waits for the card
        self._seed_gen = torch.Generator().manual_seed(tcfg.seed)
        self.set_params(self._init(tcfg.seed) if params is None else params)
        warm_propagation(cfg, self.device)

    # ---- parameters and optimizer ---------------------------------------
    def set_params(self, params) -> None:
        """Adopt `params` and start a fresh optimizer over its live leaves."""
        device = self.device      # not self: `own` is in a cycle with itself

        def own(tree):
            if isinstance(tree, dict):
                return {k: own(v) for k, v in tree.items()}
            return tree.detach().to(device).clone()

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

    def opt_state(self) -> Dict[str, Any]:
        """The optimizer's state as a tree of numpy arrays, the form
        `save_checkpoint` writes: the step count, the learning rate, and
        Adam's moments `mu`, `nu` for the live parameters (zeros before
        the first step)."""
        mu, nu, count = bridge.adam_state_to_numpy(self)
        for path, p in self.live:
            *parents, leaf = path.split("/")
            for tree in (mu, nu):
                for k in parents:
                    tree = tree.setdefault(k, {})
                if leaf not in tree:
                    tree[leaf] = np.zeros(tuple(p.shape), np.float32)
        return {"count": np.asarray(count, np.int32),
                "learning_rate": np.asarray(self.learning_rate, np.float64),
                "mu": mu, "nu": nu}

    def load_opt_state(self, state: Dict[str, Any]) -> None:
        """Adopt a tree of `opt_state`'s form."""
        bridge.adam_state_from_jax(self, state["mu"], state["nu"],
                                   int(state["count"]))
        self.learning_rate = float(state["learning_rate"])

    def _snapshot(self):
        """The parameter tree with the live leaves copied; a dead leaf
        never changes, so the snapshot shares it."""
        live = {path for path, _ in self.live}

        def walk(tree, prefix):
            out = {}
            for k, v in tree.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    out[k] = walk(v, path)
                else:
                    out[k] = v.detach().clone() if path in live else v.detach()
            return out

        return walk(self.params, "")

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
        """
        if not isinstance(tracker, _SafeTracker):
            tracker = _SafeTracker(tracker)
        cfg, tcfg = self.cfg, self.tcfg
        if tcfg.measure_mfu:
            raise NotImplementedError(
                "measure_mfu (FLOPs and MFU against the H100 peak) comes "
                "with the diagnostics slice")
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
                resume_from, self.params, self.opt_state())
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
                if os.path.exists(best_path + ".npz"):
                    best["params"], _, _ = load_checkpoint(best_path, self.params)

        t0 = time.time()
        snapshot = None
        if tcfg.diag_frozen_params:
            snapshot = {path: t.detach().clone()
                        for path, t in flatten_params(self.params)}

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(self.device, dtype)

        train_dev = {"P": dev(split.Ptrain, torch.float32),
                     "time": dev(split.Ptrain_time, torch.float32),
                     "y": dev(split.ytrain, torch.int64)}
        if split.Ptrain_static is not None:
            train_dev["static"] = dev(split.Ptrain_static, torch.float32)

        for epoch in range(start_epoch, tcfg.num_epochs):
            idx = np.stack(list(balanced_batches(
                split.ytrain, tcfg.batch_size, strategy, rng_np,
                n_batches=n_batches)))
            losses, logits = self.train_epoch(train_dev, torch.from_numpy(idx))
            loss = float(losses[-1])
            n_samples_done += idx.size

            # the last batch's train confusion matrix at the first and last
            # epoch: the reference's sanity print, labels [0, 1] hard-coded
            if verbose and epoch in (start_epoch, tcfg.num_epochs - 1):
                print(confusion_matrix_np(
                    split.ytrain[idx[-1]],
                    np.argmax(logits.cpu().numpy(), 1), labels=[0, 1]))

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
            history.append(rec)
            tracker.log_epoch(rec)
            if log_file:
                log_file.write(json.dumps(rec) + "\n")
                log_file.flush()
            if verbose:
                print(f"epoch {epoch}: loss={rec['train_loss']:.4f} "
                      f"val_auroc={val['auroc']*100:.2f} "
                      f"val_auprc={val['auprc']*100:.2f} lr={new_lr:.2e}")

            if val["auroc"] > best["auroc"]:
                best.update(auroc=val["auroc"], auprc=val["auprc"],
                            params=self._snapshot())
                if checkpoint_path:
                    save_checkpoint(checkpoint_path, self.params,
                                    meta={"epoch": epoch, "val": val,
                                          "config": dataclasses.asdict(cfg)})
            if checkpoint_path:
                save_checkpoint(
                    checkpoint_path + "_last", self.params, self.opt_state(),
                    meta={"epoch": epoch,
                          "scheduler": scheduler.state_dict(),
                          "np_rng_state": rng_np.bit_generator.state,
                          "seed_generator_state":
                              self._seed_gen.get_state().tolist(),
                          "best_auroc": best["auroc"],
                          "best_auprc": best["auprc"],
                          "history": history})
            if on_epoch_end is not None:
                on_epoch_end(epoch, rec)

        elapsed = time.time() - t0
        # test with the best parameters, on the softmax
        test_params = self.params if best["params"] is None else best["params"]
        test_logits = self.predict(test_params, split.Ptest, split.Ptest_time,
                                   split.Ptest_static)
        test = classification_metrics(test_logits, split.ytest, cfg.n_classes,
                                      prob_mode="softmax")
        ypred = np.argmax(test_logits, axis=1)
        confusion = confusion_matrix_np(split.ytest, ypred,
                                        labels=range(cfg.n_classes))
        report = classification_report_str(split.ytest, ypred)
        if verbose:
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
               tracker=None) -> Dict[str, Any]:
    """The n_splits x n_runs protocol with the reference's aggregation:
    the best run per split by AUPRC, then mean and std over the splits (in
    percent).

    make_split: callable split_idx (1-based) -> Split. With
    tcfg.resplit_per_run it is called as make_split(split_idx, run=m) for
    every run instead and must draw a new partition per run. resume_from
    continues the first run of the first split."""
    tracker = _SafeTracker(tracker)
    tracker.start({"dataset": tcfg.dataset,
                   "model_config": dict(vars(cfg)),
                   "train_config": dict(vars(tcfg))})
    trainer = Trainer(cfg, tcfg, device=device)
    log_file = open(tcfg.log_path, "a") if tcfg.log_path else None
    per_split: List[Dict[str, float]] = []
    try:
        for k in range(1, tcfg.n_splits + 1):
            split = None if tcfg.resplit_per_run else make_split(k)
            runs = []
            for m in range(tcfg.n_runs):
                if verbose:
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
    if verbose:
        for name, s in summary.items():
            print(f"{name:>9} = {s['mean']:.1f} +/- {s['std']:.1f}")
    tracker.finish(summary)
    return {"summary": summary, "per_split": per_split}
