"""Parameter bridge between the JAX package's parameter tree and the port.

Both sides keep the same tree: nested dicts whose leaves are arrays, with
linear weights already in torch layout [out, in]. So the bridge converts
leaves and checks the tree against the one `raindrop_init` builds for the
config; it reorders nothing.
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
    JAX package's tree)."""
    return _map(lambda t: t.detach().to("cpu", torch.float32).numpy(), params)
