"""fused_encoder_layer with dropout and its backward: the port's plain
versions against `jax.vjp` of the JAX kernel (Pallas, interpret mode on
the CPU; the same counter-hash masks at all four dropout sites).

dx and every one of the 12 weight gradients are compared. Tolerances:
2e-5 in f32 relative to max(1, the gradient's max) (the same arithmetic,
summed in another order); 2e-2 with bf16 operands.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.ops import fused_encoder as jfe

from raindrop_tpu_torch.nn import transformer as tr
from raindrop_tpu_torch.ops import fused_encoder as fe

from tests.torch_port_util import random_layer, to_torch

B, D, FFN, NHEAD, SEED = 3, 16, 24, 2, 777
TOL = {None: 2e-5, "bfloat16": 2e-2}


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    x, g = (rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(2))
    return x, g, np.array([T, T - 5, 0], np.int32)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T", [16, 37])
def test_forward_and_all_gradients_match_jax_vjp(T, cd, rate):
    p = random_layer(T, D, FFN)
    x, g, lengths = _inputs(T, T)
    fn = lambda p, x: jfe.fused_encoder_layer(  # noqa: E731
        p, x, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, cd, NHEAD)
    jout, vjp = jax.vjp(fn, p, jnp.asarray(x))
    jdp, jdx = vjp(jnp.asarray(g))

    tp = to_torch(p, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = fe.fused_encoder_layer(tp, tx, torch.from_numpy(lengths), SEED, rate,
                                 cd, NHEAD)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0,
                               atol=TOL[cd])

    def close(name, got, want):
        want = np.asarray(want)
        assert np.isfinite(want).all(), name
        err = np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max())
        assert err <= TOL[cd], (name, err)

    close("dx", tx.grad, jdx)
    for path in fe._WEIGHTS:
        close("/".join(path), _leaf(tp, path).grad, _leaf(jdp, path))


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_is_the_gradient_of_the_plain_forward(rate):
    p = to_torch(random_layer(5, D, FFN))
    x, g, lengths = (torch.from_numpy(a) for a in _inputs(37, 5))
    leaves = [t.clone().requires_grad_() for t in fe._flatten(p)]
    xl = x.clone().requires_grad_()
    out, attn, lse = fe._fused_fwd_plain(fe._unflatten(leaves), xl, lengths, NHEAD,
                                         torch.float32, SEED, rate)
    out.backward(g)
    dx, dws = fe._fused_bwd_plain(p, x, lengths, SEED, rate, NHEAD, torch.float32,
                                  attn.detach(), lse.detach(), g)
    np.testing.assert_allclose(dx.numpy(), xl.grad.numpy(), rtol=0, atol=2e-5)
    for path, dw, leaf in zip(fe._WEIGHTS, dws, leaves):
        np.testing.assert_allclose(dw.numpy(), leaf.grad.numpy(), rtol=0,
                                   atol=2e-5, err_msg="/".join(path))


def test_relu_branches_can_be_passed_to_the_plain_backward():
    """`relu_on` replaces `f_pre > 0`: the layer's own branches change
    nothing, the opposite branches change what lies behind the relu and
    nothing in front of it."""
    p = to_torch(random_layer(6, D, FFN))
    x, g, lengths = (torch.from_numpy(a) for a in _inputs(16, 6))
    od = torch.float32
    _, attn, lse = fe._fused_fwd_plain(p, x, lengths, NHEAD, od)
    f_pre = fe._recompute(p, x, attn, lambda t: t, (None, None, None))[4]
    args = (p, x, lengths, 0, 0.0, NHEAD, od, attn, lse, g)
    dx, dws = fe._fused_bwd_plain(*args)
    dx_same, dws_same = fe._fused_bwd_plain(*args, relu_on=f_pre > 0)
    assert torch.equal(dx, dx_same)
    assert all(torch.equal(a, b) for a, b in zip(dws, dws_same))
    dx_off, dws_off = fe._fused_bwd_plain(*args, relu_on=f_pre <= 0)
    names = ["/".join(path) for path in fe._WEIGHTS]
    behind = {"lin2/w", "lin2/b", "ln2/scale", "ln2/bias"}
    for name, a, b in zip(names, dws, dws_off):
        assert torch.equal(a, b) == (name in behind), name
    assert not torch.equal(dx, dx_off)


def test_each_dropout_site_is_live():
    """Every site's mask reaches the output: f32, rate 0.2 against rate 0
    differ, two seeds differ, and the same seed repeats bit for bit."""
    p = to_torch(random_layer(1, D, FFN))
    x, _, lengths = (torch.from_numpy(a) for a in _inputs(16, 1))
    run = lambda seed, rate: fe.fused_encoder_layer(  # noqa: E731
        p, x, lengths, seed, rate, None, NHEAD)
    assert torch.equal(run(3, 0.2), run(3, 0.2))
    assert not torch.equal(run(3, 0.2), run(4, 0.2))
    assert not torch.equal(run(3, 0.2), run(3, 0.0))
    assert torch.equal(run(None, 0.2), run(0, 0.2))


def test_fused_layer_gradient_equals_the_unfused_layer_at_dropout_zero():
    p1 = to_torch(random_layer(2, D, FFN), requires_grad=True)
    p2 = to_torch(random_layer(2, D, FFN), requires_grad=True)
    x, g, lengths = _inputs(20, 2)
    mask = torch.from_numpy(np.arange(20)[None, :] >= lengths[:, None])
    for p, backend in ((p1, "fused_layer"), (p2, "dense")):
        out = tr.transformer_encoder_layer_apply(
            p, torch.from_numpy(x), mask, NHEAD, backend=backend,
            score_dtype="float32")
        out.backward(torch.from_numpy(g))
    for path in fe._WEIGHTS:
        np.testing.assert_allclose(_leaf(p1, path).grad.numpy(),
                                   _leaf(p2, path).grad.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg="/".join(path))


def test_scratch_listing_counts_every_buffer():
    sizes = fe.bwd_scratch_floats(128, 600, 84, 136, 2)
    M = 128 * 600
    assert sizes["qkv"] == sizes["dqkv"] == M * 252
    assert sizes["f"] == sizes["dfpre"] == M * 136
    assert sizes["delta"] == 128 * 2 * 600
    assert sizes["row_partials"] == 128 * 19 * (9 * 84 + 136)
    assert sizes["wgrad_partials"] == 150 * 3 * 84 * 84
