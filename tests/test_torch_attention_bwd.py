"""flash_mha_packed with dropout and its backward: the port's plain
versions against `jax.vjp` of the JAX kernel (Pallas, interpret mode on
the CPU), which draws the same counter-hash masks.

Tolerances: 1e-5 in f32 (the same arithmetic, summed in another order);
2e-2 with bf16 operands (8-bit mantissas; a value on a rounding boundary
may round the other way after a last-bit difference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.ops import flash_attention as jfa

from raindrop_tpu_torch.ops import flash_attention as fa

B, D, NHEAD, SEED = 3, 16, 2, 424242
TOL = {None: 1e-5, "bfloat16": 2e-2}


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(4))
    return q, k, v, g, np.array([T, T - 5, 0], np.int32)


def _jax(q, k, v, g, lengths, rate, cd):
    fn = lambda q, k, v: jfa.flash_mha_packed(  # noqa: E731
        q, k, v, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, cd,
        NHEAD)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T", [16, 37])
def test_forward_and_gradients_match_jax_vjp(T, cd, rate):
    q, k, v, g, lengths = _inputs(T, seed=T)
    jo, jgrads = _jax(q, k, v, g, lengths, rate, cd)
    assert all(np.isfinite(x).all() for x in jgrads)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_mha_packed(tq, tk, tv, torch.from_numpy(lengths), SEED, rate,
                            cd, NHEAD)
    o.backward(torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), jo, rtol=0, atol=TOL[cd])
    for t, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=TOL[cd])
        assert (t.grad[2] == 0).all()        # the length-0 sample


def test_dropout_changes_the_output_and_none_means_seed_zero():
    q, k, v, _, lengths = (torch.from_numpy(a) for a in _inputs(16))
    base = fa.flash_mha_packed(q, k, v, lengths, None, 0.0, None, NHEAD)
    d0 = fa.flash_mha_packed(q, k, v, lengths, None, 0.2, None, NHEAD)
    d0b = fa.flash_mha_packed(q, k, v, lengths, 0, 0.2, None, NHEAD)
    d1 = fa.flash_mha_packed(q, k, v, lengths, 1, 0.2, None, NHEAD)
    assert torch.equal(d0, d0b)
    assert not torch.equal(d0, base) and not torch.equal(d0, d1)
    # lse sums the undropped probabilities: dropout leaves it unchanged
    lse0 = fa._packed_fwd(q, k, v, lengths, None, 0.0, None, NHEAD)[1]
    lse1 = fa._packed_fwd(q, k, v, lengths, 1, 0.2, None, NHEAD)[1]
    assert torch.equal(lse0, lse1)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_is_the_gradient_of_the_plain_forward(rate):
    """In f32 `_packed_bwd_plain` is the exact gradient: torch autograd
    through `_packed_fwd_plain` gives the same to 1e-5."""
    q, k, v, g, lengths = (torch.from_numpy(a) for a in _inputs(37, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa._packed_fwd_plain(*leaves, lengths, NHEAD, torch.float32, SEED, rate)
    o.backward(g)
    got = fa._packed_bwd_plain(q, k, v, lengths, SEED, rate, NHEAD,
                               torch.float32, o.detach(), lse.detach(), g)
    for a, leaf in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-5)


def test_a_length_zero_sample_gets_exact_zeros_whatever_the_scores():
    """Scores large enough to overflow exp2 once the lse is -1e30: the
    port never evaluates the exponent there."""
    q, k, v, g, lengths = (torch.from_numpy(a) for a in _inputs(16, seed=9))
    q = q * 1e3
    o, lse = fa._packed_fwd_plain(q, k, v, lengths, NHEAD, torch.float32)
    got = fa._packed_bwd_plain(q, k, v, lengths, 0, 0.0, NHEAD, torch.float32,
                               o, lse, g)
    for a in got:
        assert torch.isfinite(a).all() and (a[2] == 0).all()


def test_bad_arguments_raise():
    q = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="dropout_rate"):
        fa.flash_mha_packed(q, q, q, torch.tensor([8]), None, 1.0, None, 2)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_mha_packed(q, q, q, torch.tensor([8]), 2 ** 31, 0.2, None, 2)
