"""Checkpoints in the JAX package's `.npz` format
(raindrop_tpu/train/checkpoint.py): parameters, optimizer state and a JSON
sidecar, so a run resumes exactly and parameters cross between the two
packages.

A checkpoint is `<path>.npz` with one array per parameter under the key
`params/<a>/<b>/...` (the path through the parameter tree), optional
`opt/...` arrays, and an optional `<path>.meta.json`. A parameter file
written here loads with the JAX package's `load_checkpoint` and the
reverse. The optimizer state is the port's own tree (`Trainer.opt_state`:
`opt/count`, `opt/learning_rate`, `opt/mu/<path>` and `opt/nu/<path>` for
the live parameters); optax's state has other keys, so Adam moments cross
between the packages through `bridge.adam_state_to_numpy` and
`bridge.adam_state_from_jax`, not through this file.

The trainer's `<path>_last` sidecar holds the epoch, the numpy sampler
state, the plateau scheduler's state, the best validation metrics, the
history and, in place of the JAX trainer's `jax_key`, the state of the
trainer's dropout-seed generator (`seed_generator_state`, the bytes of a
torch.Generator state as a list).

The JAX package's orbax functions (sharded checkpoints) come with the
scale-out slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def flatten_params(tree, prefix="") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict in sorted-key order, the order
    the JAX package flattens its dict trees in; a path joins the keys with
    '/', which is also the checkpoint's key format."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.extend(flatten_params(tree[k], path))
        else:
            out.append((path, tree[k]))
    return out


def _arrays(tree, prefix: str) -> Dict[str, np.ndarray]:
    return {path: (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf))
            for path, leaf in flatten_params(tree, prefix)}


def save_checkpoint(path: str, params, opt_state=None, *,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write <path>.npz (and <path>.meta.json when `meta` is given).
    `params` and `opt_state` are nested dicts of tensors or arrays. Each
    file is written beside its place and renamed into it, so a reader never
    sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _arrays(params, "params")
    if opt_state is not None:
        arrays.update(_arrays(opt_state, "opt"))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    if meta is not None:
        with open(path + ".meta.json.tmp", "w") as f:
            json.dump(meta, f, indent=2, default=str)
        os.replace(path + ".meta.json.tmp", path + ".meta.json")


def load_checkpoint(path: str, params_template, opt_state_template=None
                    ) -> Tuple[Any, Any, Optional[Dict]]:
    """Restore into the structure of the templates. A tensor leaf of a
    template (e.g. of `raindrop_init(seed, cfg, device)`) gives a tensor
    of its dtype on its device, an array leaf (of `Trainer.opt_state()`)
    a numpy array of its dtype. Returns (params, opt_state or None, meta
    or None)."""
    with np.load(path + ".npz", allow_pickle=False) as z:
        arrays = dict(z)

    def restore(tree, prefix):
        if isinstance(tree, dict):
            return {k: restore(v, f"{prefix}/{k}") for k, v in tree.items()}
        if prefix not in arrays:
            raise KeyError(f"{path}.npz has no {prefix}")
        a = np.asarray(arrays[prefix])
        shape = tuple(tree.shape)
        if a.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{prefix}: {a.shape} does not fit {shape}")
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(a.reshape(shape).copy()).to(
                device=tree.device, dtype=tree.dtype)
        return np.array(a, dtype=np.asarray(tree).dtype).reshape(shape)

    params = restore(params_template, "params")
    opt_state = (restore(opt_state_template, "opt")
                 if opt_state_template is not None else None)
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return params, opt_state, meta
