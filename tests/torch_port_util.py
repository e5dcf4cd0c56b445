"""Helpers shared by the port's training tests: dropout seeds read off the
JAX key chain, a narrowed batch, and random encoder-layer trees."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.nn import transformer as jtr

from raindrop_tpu_torch.utils.dropout import DropoutSeeds, LayerSeeds


def seed32(key) -> int:
    """The uint32 seed the JAX `dropout` derives from a key."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).reshape(-1)
    with np.errstate(over="ignore"):
        return int((kd[-1] * np.uint32(0x85EBCA6B)) ^ kd[0])


def kernel_seed(key) -> int:
    """The int32 seed the JAX encoder hands its kernels from a key."""
    return int(jax.random.randint(key, (1,), 0, 2 ** 31 - 1, jnp.int32)[0])


def layer_seeds(keys) -> LayerSeeds:
    """LayerSeeds from a layer's 4 keys (attn/kernel, post-attn, ffn, post-ffn)."""
    return LayerSeeds(kernel_seed(keys[0]), *(seed32(k) for k in keys))


def seeds_from_jax_key(rng, nlayers: int, rows: int = 0) -> DropoutSeeds:
    """The seeds `raindrop_apply(train=True, rng=rng)` of the JAX package
    consumes, by the same splits. `rows` = the batch size also reads the
    per-sample seeds of the COO propagation branch (one key per sample,
    split off each propagation layer's key)."""
    r_drop, r_prop1, r_prop2, r_trans = jax.random.split(rng, 4)
    keys = jax.random.split(r_trans, 4 * nlayers)

    def per_sample(key):
        return tuple(seed32(k) for k in jax.random.split(key, rows)) if rows else ()

    return DropoutSeeds(
        seed32(r_drop), seed32(r_prop1), seed32(r_prop2),
        tuple(layer_seeds(keys[4 * i: 4 * i + 4]) for i in range(nlayers)),
        per_sample(r_prop1), per_sample(r_prop2))


def random_layer(seed: int, d: int, ffn: int):
    """A JAX encoder-layer tree (numpy leaves) with every bias and LayerNorm
    parameter random, so each one's gradient is exercised."""
    p = jax.device_get(jtr._layer_init(jax.random.PRNGKey(seed), d, ffn))
    rng = np.random.default_rng(seed)

    def r(n, base=0.0):
        return (base + 0.1 * rng.normal(size=(n,))).astype(np.float32)

    p["in_proj_b"] = r(3 * d)
    p["out_proj"]["b"] = r(d)
    p["ln1"] = {"scale": r(d, 1.0), "bias": r(d)}
    p["ln2"] = {"scale": r(d, 1.0), "bias": r(d)}
    return p


def to_torch(tree, requires_grad=False):
    if isinstance(tree, dict):
        return {k: to_torch(v, requires_grad) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, np.float32))
    return t.requires_grad_() if requires_grad else t


def model_batch(cfg, B, seed=1, lengths=None):
    """Time-major src [T, B, 2F], static, times [T, B], lengths [B]."""
    rng = np.random.default_rng(seed)
    T, F = cfg.max_len, cfg.d_inp
    if lengths is None:
        lengths = np.array(([T, max(T - 7, 1), 0] * B)[:B], np.int32)
    live = np.arange(T)[:, None] < lengths[None, :]                # [T, B]
    mask = ((rng.uniform(size=(T, B, F)) > 0.5) & live[..., None]).astype(np.float32)
    src = np.concatenate([rng.normal(size=(T, B, F)).astype(np.float32) * mask,
                          mask], -1)
    times = (np.cumsum(rng.uniform(0.1, 1.0, size=(T, B)), 0) * live).astype(np.float32)
    static = (rng.normal(size=(B, cfg.d_static)).astype(np.float32)
              if cfg.static else None)
    return src, static, times, np.asarray(lengths, np.int32)
