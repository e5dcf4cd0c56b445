"""Parameter bridge between the JAX package's parameter tree and the port.

Both sides keep the same tree: nested dicts whose leaves are arrays, with
linear weights already in torch layout [out, in]. So the bridge converts
leaves and checks the tree against the one `raindrop_init` builds for the
config; it reorders nothing.

The optimizer bridge carries optax's masked-Adam state (first and second
moments as parameter-shaped trees with entries for the live parameters,
and the step count) into and out of a `Trainer`'s `torch.optim.Adam`, so
both trainers can start from the same point mid-run.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.models.raindrop import raindrop_init


def _check_tree(tree, template, path="") -> None:
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"params{path}: keys {got}, expected {sorted(template)}")
        for k in template:
            _check_tree(tree[k], template[k], f"{path}/{k}")
        return
    if tuple(np.shape(tree)) != tuple(template.shape):
        raise ValueError(f"params{path}: shape {tuple(np.shape(tree))}, "
                         f"expected {tuple(template.shape)}")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree_of_numpy: Dict[str, Any], cfg: RaindropConfig,
                    device="cuda"):
    """JAX parameter tree (nested dicts of numpy arrays, e.g.
    `jax.device_get(params)`) -> the port's parameters on `device`."""
    _check_tree(tree_of_numpy, raindrop_init(None, cfg, device="meta"))
    return _map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32, copy=True)).to(device), tree_of_numpy)


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameters -> nested dicts of float32 numpy arrays (the
    JAX package's tree). Copies: the trainer updates its parameters in
    place, and a CPU tensor's `.numpy()` shares its memory."""
    return _map(lambda t: t.detach().to("cpu", torch.float32).numpy().copy(),
                params)


def _lookup(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def adam_state_from_jax(trainer, mu, nu, count) -> None:
    """Load optax Adam moments into `trainer.optimizer`. `mu`, `nu`: nested
    dicts of numpy arrays in the parameter tree's shape, read at the live
    parameters' paths only (dead leaves may be missing or anything);
    `count`: the number of steps taken."""
    for path, p in trainer.live:
        m, v = (np.asarray(_lookup(t, path), dtype=np.float32) for t in (mu, nu))
        if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
            raise ValueError(f"optimizer state {path}: shapes {m.shape}, "
                             f"{v.shape}, expected {tuple(p.shape)}")
        trainer.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(m.copy()).to(p.device),
            "exp_avg_sq": torch.from_numpy(v.copy()).to(p.device),
        }


def adam_state_to_numpy(trainer):
    """(mu, nu, count) of `trainer.optimizer`: nested dicts of numpy arrays
    holding the live parameters only (a dead parameter has no state), and
    the step count (0 before the first step)."""
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    count = 0
    for path, p in trainer.live:
        st = trainer.optimizer.state.get(p)
        if not st:
            continue
        count = int(st["step"])
        *parents, leaf = path.split("/")
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            for k in parents:
                tree = tree.setdefault(k, {})
            tree[leaf] = st[key].detach().to("cpu", torch.float32).numpy().copy()
    return mu, nu, count
