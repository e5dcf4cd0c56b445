"""Parameter bridge between the JAX package's parameter tree and the port.

Both sides keep the same tree: nested dicts (and, in two baselines, lists)
whose leaves are arrays, with linear weights already in torch layout
[out, in]. So the bridge converts leaves and checks the tree against the
one the port's init builds for the config (`raindrop_init`, or a
baseline's); it reorders nothing, and drops the JAX trees' static `_meta`
entries, which the port keeps outside its parameters.

Leaves keep their dtype both ways. A bfloat16 leaf crosses by its bits,
with no `ml_dtypes` (which comes with JAX and is not on the card's
machine): into the port from a numpy array of `ml_dtypes.bfloat16` (as JAX
hands it over) or a raw 2-byte `|V2` array (what `np.savez` writes for it),
out of the port as a `|V2` array, which `.view(ml_dtypes.bfloat16)` reads.

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


# numpy's form of a bfloat16 leaf outside JAX: two raw bytes an element
BF16_NUMPY = np.dtype("V2")


def is_bf16_array(a) -> bool:
    """A numpy array holding bfloat16 values: `ml_dtypes.bfloat16` (found
    by its name, without importing ml_dtypes) or raw 2-byte `|V2`."""
    dt = np.asarray(a).dtype
    return dt == BF16_NUMPY or (dt.name == "bfloat16" and dt.itemsize == 2)


def array_to_tensor(a) -> torch.Tensor:
    """A numpy array -> a CPU tensor of its own (a copy) in its dtype; a
    bfloat16 array (`is_bf16_array`) -> torch.bfloat16 by its bits."""
    a = np.asarray(a)
    if is_bf16_array(a):
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy array of its own (a copy) in its dtype; bfloat16
    -> a `|V2` array of its bits."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_NUMPY).copy()
    return t.numpy().copy()


def zeros_array(shape, dtype: torch.dtype) -> np.ndarray:
    """Zeros of `shape` in the numpy form of a tensor dtype."""
    return tensor_to_array(torch.zeros(tuple(shape), dtype=dtype))


def _check_tree(tree, template, path="") -> None:
    if isinstance(template, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__
            raise ValueError(f"params{path}: {got} items, expected a list of "
                             f"{len(template)}")
        for i, (t, tmpl) in enumerate(zip(tree, template)):
            _check_tree(t, tmpl, f"{path}/{i}")
        return
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
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _drop_meta(tree):
    """The tree without the JAX package's static `_meta` entries (leafless
    settings objects; the port keeps them outside its parameters)."""
    if isinstance(tree, dict):
        return {k: _drop_meta(v) for k, v in tree.items() if k != "_meta"}
    if isinstance(tree, (list, tuple)):
        return [_drop_meta(v) for v in tree]
    return tree


def _leaf_from_jax(a) -> torch.Tensor:
    if is_bf16_array(a):
        return array_to_tensor(a)
    a = np.asarray(a)
    if a.dtype == np.float16:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_jax(tree_of_numpy: Dict[str, Any], cfg: RaindropConfig,
                    device="cuda", template=None):
    """JAX parameter tree (nested dicts and lists of numpy arrays, e.g.
    `jax.device_get(params)`) -> the port's parameters on `device`, each
    leaf in its own dtype: bfloat16 (by its bits) and float16 as they are,
    anything else as float32. The tree is checked against `template`: by
    default `raindrop_init`'s for cfg; a baseline's is its init on the meta
    device (`make_baseline(name, cfg, hp, device="meta").init_fn(None)`).
    The JAX package's `_meta` entries are dropped."""
    tree = _drop_meta(tree_of_numpy)
    if template is None:
        template = raindrop_init(None, cfg, device="meta")
    _check_tree(tree, template)
    return _map(lambda a: _leaf_from_jax(a).to(device), tree)


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameters -> nested dicts and lists of numpy arrays (the
    JAX package's tree without its `_meta` entries): float32 and float16 as they are, bfloat16 as `|V2`
    arrays of its bits (`tensor_to_array`). Copies: the trainer updates its
    parameters in place, and a CPU tensor's `.numpy()` shares its memory."""
    return _map(tensor_to_array, params)


def _lookup(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def adam_state_from_jax(trainer, mu, nu, count) -> None:
    """Load optax Adam moments into `trainer.optimizer`. `mu`, `nu`: nested
    dicts of numpy arrays in the parameter tree's shape, read at the live
    parameters' paths only (dead leaves may be missing or anything);
    `count`: the number of steps taken. The moments take their
    parameter's dtype, as optax keeps them."""
    for path, p in trainer.live:
        m, v = (array_to_tensor(_lookup(t, path)) for t in (mu, nu))
        if tuple(m.shape) != tuple(p.shape) or tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"optimizer state {path}: shapes {tuple(m.shape)}, "
                             f"{tuple(v.shape)}, expected {tuple(p.shape)}")
        trainer.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(p.device, p.dtype),
            "exp_avg_sq": v.to(p.device, p.dtype),
        }


def adam_state_to_numpy(trainer):
    """(mu, nu, count) of `trainer.optimizer`: nested dicts of numpy arrays
    (in their tensors' dtypes, `tensor_to_array`) holding the live
    parameters only (a dead parameter has no state), and the step count (0
    before the first step)."""
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
            tree[leaf] = tensor_to_array(st[key])
    return mu, nu, count
