"""Read the JAX package's `.npz` checkpoints (raindrop_tpu/train/checkpoint.py).

A checkpoint is `<path>.npz` with one array per parameter under the key
`params/<a>/<b>/...` (the path through the parameter tree), optional
`opt/...` optimizer arrays, and an optional `<path>.meta.json`. This slice
reads parameters only, with numpy; saving and the optimizer state come
with the training slice.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def load_checkpoint(path: str, params_template, opt_state_template=None
                    ) -> Tuple[Any, None, Optional[Dict]]:
    """Restore parameters into the structure, dtypes and devices of
    `params_template` (e.g. `raindrop_init(seed, cfg, device)`). Returns
    (params, None, meta) like the JAX function's (params, opt_state, meta)."""
    if opt_state_template is not None:
        raise NotImplementedError(
            "restoring optimizer state comes with the training slice")
    with np.load(path + ".npz", allow_pickle=False) as z:
        arrays = dict(z)

    def restore(tree, prefix):
        if isinstance(tree, dict):
            return {k: restore(v, f"{prefix}/{k}") for k, v in tree.items()}
        key = "params" + prefix
        if key not in arrays:
            raise KeyError(f"{path}.npz has no {key}")
        a = np.asarray(arrays[key])
        if a.size != tree.numel():
            raise ValueError(f"{key}: {a.shape} does not fit {tuple(tree.shape)}")
        return torch.from_numpy(a.reshape(tuple(tree.shape)).copy()).to(
            device=tree.device, dtype=tree.dtype)

    params = restore(params_template, "")
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return params, None, meta
