"""fused_encoder_layer forward: the port's plain version against the JAX
kernel (Pallas, interpret mode on the CPU), on out, attn and lse.

Tolerance 2e-5 in f32 (the same arithmetic, summed in another order); out
at 2e-2 with bf16 operands.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.nn import transformer as jtr
from raindrop_tpu.ops import fused_encoder as jfe

from raindrop_tpu_torch.bridge import _map
from raindrop_tpu_torch.nn import transformer as tr
from raindrop_tpu_torch.ops import fused_encoder as fe

B, D, FFN, NHEAD = 3, 16, 32, 2


def _layer(seed):
    """A JAX layer tree with every bias and LayerNorm parameter random."""
    p = jax.device_get(jtr._layer_init(jax.random.PRNGKey(seed), D, FFN))
    rng = np.random.default_rng(seed)

    def r(n, base=0.0):
        return (base + 0.1 * rng.normal(size=(n,))).astype(np.float32)

    p["in_proj_b"] = r(3 * D)
    p["out_proj"]["b"] = r(D)
    p["ln1"] = {"scale": r(D, 1.0), "bias": r(D)}
    p["ln2"] = {"scale": r(D, 1.0), "bias": r(D)}
    return p


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    return x, np.array([T, T - 5, 0], np.int32)


def _torch(p):
    return _map(lambda a: torch.from_numpy(np.array(a, np.float32)), p)


@pytest.mark.parametrize("T", [13, 24])
def test_fused_fwd_f32_matches_jax(T):
    p = _layer(T)
    x, lengths = _inputs(T, T)
    out, attn, lse = fe._fused_fwd(_torch(p), torch.from_numpy(x),
                                   torch.from_numpy(lengths), None, 0.0, None,
                                   NHEAD)
    jout, res = jfe._fused_fwd(p, jnp.asarray(x), jnp.asarray(lengths), None,
                               0.0, None, NHEAD)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(attn.numpy(), np.asarray(res[4])[:, :T], **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[5])[:, :, :T], **tol)


@pytest.mark.parametrize("T", [13, 24])
def test_fused_fwd_bf16_matches_jax(T):
    p = _layer(T + 1)
    x, lengths = _inputs(T, T + 1)
    out = fe.fused_encoder_layer(_torch(p), torch.from_numpy(x),
                                 torch.from_numpy(lengths), None, 0.0,
                                 "bfloat16", NHEAD)
    jout = jfe.fused_encoder_layer(p, jnp.asarray(x), jnp.asarray(lengths),
                                   None, 0.0, "bfloat16", NHEAD)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-2)


def test_fused_layer_equals_the_unfused_layer():
    p = _torch(_layer(2))
    x, lengths = _inputs(20, 2)
    mask = torch.from_numpy(np.arange(20)[None, :] >= lengths[:, None])
    fused = tr.transformer_encoder_layer_apply(
        p, torch.from_numpy(x), mask, NHEAD, backend="fused_layer",
        score_dtype="float32")
    dense = tr.transformer_encoder_layer_apply(
        p, torch.from_numpy(x), mask, NHEAD, backend="dense")
    np.testing.assert_allclose(fused.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


def test_fused_layer_refuses_dropout():
    p = _torch(_layer(0))
    with pytest.raises(NotImplementedError, match="training slice"):
        fe.fused_encoder_layer(p, torch.zeros((1, 8, D)), torch.tensor([8]),
                               None, 0.1, None, NHEAD)
