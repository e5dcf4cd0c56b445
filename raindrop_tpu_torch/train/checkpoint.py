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

A bfloat16 leaf is stored as the JAX package's `np.savez` stores one: a
raw 2-byte `|V2` array of its bits (`bridge.tensor_to_array`), and a
`|V2` array reads back as bfloat16 by its bits, so a bf16 checkpoint of
either package loads bit-equal in the port without `ml_dtypes`.

The JAX package's orbax functions have no counterpart here; a mesh's
per-rank sharded checkpoints are parallel/multihost.py's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from raindrop_tpu_torch.bridge import array_to_tensor, is_bf16_array, tensor_to_array


def flatten_params(tree, prefix="") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of nested dicts and lists, the order the JAX
    package flattens its trees in: a dict's keys sorted, a list's items in
    index order (a baseline's `layers/0`, `layers/1`, ..., `layers/10`); a
    path joins the keys and indices with '/', which is also the
    checkpoint's key format."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    else:
        items = list(enumerate(tree))
    out = []
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.extend(flatten_params(v, path))
        else:
            out.append((path, v))
    return out


def _arrays(tree, prefix: str) -> Dict[str, np.ndarray]:
    return {path: (tensor_to_array(leaf) if isinstance(leaf, torch.Tensor)
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
        if isinstance(tree, (list, tuple)):
            return [restore(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
        if prefix not in arrays:
            raise KeyError(f"{path}.npz has no {prefix}")
        a = np.asarray(arrays[prefix])
        shape = tuple(tree.shape)
        if a.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{prefix}: {a.shape} does not fit {shape}")
        if isinstance(tree, torch.Tensor):
            return array_to_tensor(a.reshape(shape)).to(
                device=tree.device, dtype=tree.dtype)
        want = np.asarray(tree).dtype
        if is_bf16_array(a) or is_bf16_array(np.zeros(0, want)):
            # numpy cannot cast to or from raw bf16 bits: through torch
            dt = array_to_tensor(np.zeros(0, want)).dtype
            return tensor_to_array(array_to_tensor(a).to(dt)).reshape(shape)
        return np.array(a, dtype=want).reshape(shape)

    params = restore(params_template, "params")
    opt_state = (restore(opt_state_template, "opt")
                 if opt_state_template is not None else None)
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return params, opt_state, meta
