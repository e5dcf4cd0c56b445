"""ReduceLROnPlateau with torch semantics (port of
raindrop_tpu/train/plateau.py).

The reference steps torch.optim.lr_scheduler.ReduceLROnPlateau(mode='max',
factor=0.1, patience=1, threshold=1e-4 rel, cooldown=0, min_lr=1e-8) on the
per-epoch validation AUPRC. The state machine lives here, on the host, with
the JAX package's state dict, so a scheduler state crosses between the two
packages' checkpoints; the trainer writes the returned rate into its
optimizer (`Trainer.learning_rate`).

'rel' threshold in max mode: an epoch improves iff metric > best * (1 +
threshold); the rate drops by `factor` after more than `patience`
consecutive epochs without improvement, floored at min_lr.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, lr: float, mode: str = "max", factor: float = 0.1,
                 patience: int = 1, threshold: float = 1e-4,
                 min_lr: float = 1e-8):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.lr = float(lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("-inf") if mode == "max" else float("inf")
        self.num_bad_epochs = 0

    def _is_better(self, metric: float) -> bool:
        # torch's _is_better for threshold_mode='rel', with no special case
        # for a negative best (the max-mode bound is best * (1 + threshold),
        # which for best < 0 lies slightly below best)
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Record one epoch's metric; returns the (possibly reduced) rate."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return dict(lr=self.lr, best=self.best, num_bad_epochs=self.num_bad_epochs)

    def load_state_dict(self, s):
        self.lr, self.best, self.num_bad_epochs = s["lr"], s["best"], s["num_bad_epochs"]


def noam_schedule(model_size: int, factor: float, warmup: int):
    """Noam (Transformer warm-up) schedule, which the reference ships
    unused: lr(step) = factor * model_size^-0.5 * min(step^-0.5,
    step * warmup^-1.5). Returns a function of the 0-based update count
    (a Python number or a tensor; the reference's counter is 1-based, so
    the count is shifted by one)."""
    def schedule(count):
        step = count + 1.0
        return factor * (model_size ** -0.5) * min(step ** -0.5,
                                                   step * warmup ** -1.5)
    return schedule
