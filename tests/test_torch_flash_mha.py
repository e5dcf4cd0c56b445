"""The split-head flash_mha, forward and backward: the port's plain
versions against the JAX `flash_mha` and its `jax.vjp` (Pallas, interpret
mode on the CPU), in both of the JAX package's regimes: one program per
head (T padded to 8 <= MAX_FUSED_T) and 128-row blocks beyond. Both sides
hash the dropout masks from the global (row, column), so the comparison is
exact with dropout too.

The streaming regime runs at a real T = 1152 once, and at T = 200 with the
JAX module's MAX_FUSED_T patched down to 64 for the grid of operand types
and rates (the port has one regime, so nothing is patched there). Both
regimes run again at the sensor-wise head dims past 128, PAM-sw's 170 and
P12-sw's 360 (the JAX kernels pad them to 256 and 384; on the card the
port runs them in the Narrow and Wide geometries), and the streaming one
at a real T = 1152 at hd 170.

Tolerances: 1e-5 in f32 (the same arithmetic, summed in another order);
2e-2 with bf16 operands. The JAX one-program backward evaluates
exp(s - lse) with lse = -1e30 on a sample of length 0 and can give
inf * 0 there; the port gives exact zeros, and such a sample is compared
only where the reference is finite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.ops import flash_attention as jfa

from raindrop_tpu_torch.ops import flash_attention as fa

SEED = 424242
TOL = {None: 1e-5, "bfloat16": 2e-2}


def _inputs(B, H, T, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    lengths = np.array(([T, T - 5, 0] * B)[:B], np.int32)
    return q, k, v, g, lengths


def _jax(q, k, v, g, lengths, rate, cd):
    fn = lambda q, k, v: jfa.flash_mha(  # noqa: E731
        q, k, v, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, cd)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port(q, k, v, g, lengths, rate, cd):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_mha(tq, tk, tv, torch.from_numpy(lengths), SEED, rate, cd)
    o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _compare(q, k, v, g, lengths, rate, cd):
    jo, jgrads = _jax(q, k, v, g, lengths, rate, cd)
    o, grads = _port(q, k, v, g, lengths, rate, cd)
    np.testing.assert_allclose(o, jo, rtol=0, atol=TOL[cd])
    empty = lengths == 0
    assert (o[empty] == 0).all()
    for got, want in zip(grads, jgrads):
        assert np.isfinite(got).all() and (got[empty] == 0).all()
        assert np.isfinite(want[~empty]).all()
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=TOL[cd])


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T", [16, 70])
def test_fused_regime_matches_jax_vjp(T, cd, rate):
    assert fa.pad8(T) <= jfa.MAX_FUSED_T
    _compare(*_inputs(3, 2, T, 12, seed=T), rate, cd)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_streaming_regime_matches_jax_vjp(monkeypatch, cd, rate):
    monkeypatch.setattr(jfa, "MAX_FUSED_T", 64)
    T = 200                       # two 128-row blocks on the JAX side
    _compare(*_inputs(3, 2, T, 12, seed=7), rate, cd)


def test_streaming_regime_at_a_real_length_matches_jax_vjp():
    T = jfa.MAX_FUSED_T + 128
    q, k, v, g, _ = _inputs(2, 1, T, 8, seed=11)
    _compare(q, k, v, g, np.array([T - 200, T], np.int32), 0.3, None)


# the sensor-wise head dims: PAM-sw (2 heads of d_inp * (d_ob + d_pe) =
# 340) and P12-sw (720)
WIDE_HD = [170, 360]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("D", WIDE_HD)
def test_fused_regime_matches_jax_vjp_at_wide_heads(D, cd, rate):
    _compare(*_inputs(3, 2, 70, D, seed=D), rate, cd)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("D", WIDE_HD)
def test_streaming_regime_matches_jax_vjp_at_wide_heads(monkeypatch, D, cd, rate):
    monkeypatch.setattr(jfa, "MAX_FUSED_T", 64)
    _compare(*_inputs(3, 2, 200, D, seed=D + 1), rate, cd)


def test_streaming_regime_at_a_real_length_and_pam_sw_head_dim():
    T = jfa.MAX_FUSED_T + 128
    q, k, v, g, _ = _inputs(2, 1, T, 170, seed=13)
    _compare(q, k, v, g, np.array([T - 200, T], np.int32), 0.3, None)


def test_strided_head_views_give_the_contiguous_result():
    """The model hands flash_mha the [B, T, H, D] views of its projection."""
    B, H, T, D = 2, 2, 24, 6
    rng = np.random.default_rng(3)
    proj = torch.from_numpy(rng.normal(size=(B, T, 3 * H * D)).astype(np.float32))
    views = [t.reshape(B, T, H, D).transpose(1, 2) for t in proj.split(H * D, -1)]
    lengths = torch.tensor([T, 9])
    a = fa.flash_mha(*views, lengths, SEED, 0.2, "bfloat16")
    b = fa.flash_mha(*(x.contiguous() for x in views), lengths, SEED, 0.2, "bfloat16")
    assert torch.equal(a, b)


def test_flash_mha_equals_the_packed_function_on_the_head_views():
    """Both hash b * H + h, the global row and the global column."""
    B, H, T, D = 3, 2, 37, 8
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H * D)).astype(np.float32))
               for _ in range(3))
    lengths = torch.tensor([T, 30, 0])
    packed = fa.flash_mha_packed(q, k, v, lengths, SEED, 0.2, None, H)
    split = fa.flash_mha(*(x.reshape(B, T, H, D).transpose(1, 2) for x in (q, k, v)),
                         lengths, SEED, 0.2, None)
    assert torch.equal(split.transpose(1, 2).reshape(B, T, H * D), packed)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_is_the_gradient_of_the_plain_forward(rate):
    q, k, v, g, lengths = (torch.from_numpy(a) for a in _inputs(3, 2, 37, 8, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa._flash_fwd_plain(*leaves, lengths, torch.float32, SEED, rate)
    o.backward(g)
    got = fa._flash_bwd_plain(q, k, v, lengths, SEED, rate, torch.float32,
                              o.detach(), lse.detach(), g)
    for a, leaf in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-5)


def test_bad_arguments_raise():
    q = torch.zeros((1, 2, 8, 4))
    lengths = torch.tensor([8])
    with pytest.raises(ValueError, match="dropout_rate"):
        fa.flash_mha(q, q, q, lengths, None, 1.0)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_mha(q, q, q, lengths, 2 ** 31, 0.2)
    with pytest.raises(ValueError, match=r"\[B, H, T, D\]"):
        fa.flash_mha(q[0], q[0], q[0], lengths)
    with pytest.raises(ValueError, match="compute_dtype"):
        fa.flash_mha(q, q, q, lengths, None, 0.0, "float16")
    # the head-dim limit is the kernels': the plain version takes any D
    wide = torch.zeros((1, 1, 8, fa.MAX_HEAD_DIM + 8))
    assert fa.flash_mha(wide, wide, wide, lengths).shape == wide.shape
