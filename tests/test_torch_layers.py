"""Leaf layers of the port against the JAX package, on the CPU, in f32.

Tolerance rtol = atol = 1e-6: the same f32 arithmetic, summed in another
order by another library.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.graph import propagate as jprop
from raindrop_tpu.nn import aggregate as jagg
from raindrop_tpu.nn import linear as jlin
from raindrop_tpu.nn import transformer as jtr
from raindrop_tpu.ops import pe as jpe

from raindrop_tpu_torch.bridge import _map
from raindrop_tpu_torch.graph import propagate as prop
from raindrop_tpu_torch.nn import aggregate as agg
from raindrop_tpu_torch.nn import linear as lin
from raindrop_tpu_torch.nn import transformer as tr
from raindrop_tpu_torch.ops import pe
from raindrop_tpu_torch.parallel.mesh import Shard

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(tree):
    return _map(lambda a: torch.from_numpy(np.array(a, np.float32)), jax.device_get(tree))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("d_pe,max_len", [(16, 215), (16, 600), (8, 60)])
def test_time_positional_encoding(d_pe, max_len):
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.0, 2.0, size=(max_len // 4, 5)), 0)
    times = times.astype(np.float32)
    np.testing.assert_array_equal(pe.pe_timescales(d_pe, max_len),
                                  jpe.pe_timescales(d_pe, max_len))
    _close(pe.time_positional_encoding(torch.from_numpy(times), d_pe, max_len),
           jpe.time_positional_encoding(jnp.asarray(times), d_pe, max_len))


def test_linear_and_mlp():
    jparams = jlin.mlp_init(jax.random.PRNGKey(1), [24, 24, 5])
    x = np.random.default_rng(1).normal(size=(7, 24)).astype(np.float32)
    p = _t(jparams)
    _close(lin.linear_apply(p["lin0"], torch.from_numpy(x)),
           jlin.linear_apply(jparams["lin0"], jnp.asarray(x)))
    _close(lin.mlp_apply(p, torch.from_numpy(x)),
           jlin.mlp_apply(jparams, jnp.asarray(x)))


def test_padding_mask_and_masked_mean_pool():
    rng = np.random.default_rng(2)
    r_out = rng.normal(size=(4, 11, 6)).astype(np.float32)
    lengths = np.array([11, 6, 1, 0], np.int32)
    np.testing.assert_array_equal(
        agg.padding_mask(torch.from_numpy(lengths), 11).numpy(),
        np.asarray(jagg.padding_mask(jnp.asarray(lengths), 11)))
    _close(agg.masked_mean_pool(torch.from_numpy(r_out), torch.from_numpy(lengths)),
           jagg.masked_mean_pool(jnp.asarray(r_out), jnp.asarray(lengths)))


@pytest.mark.parametrize("adj_kind", ["uniform", "shared", "per_sample"])
def test_ob_propagate_dense_complete(adj_kind):
    n, D, B = 5, 12, 3
    jparams = jprop.ob_propagation_init(jax.random.PRNGKey(4), D, D, n, 4)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, n, D)).astype(np.float32)
    if adj_kind == "uniform":
        adj = np.ones((n, n), np.float32)
    elif adj_kind == "shared":
        adj = rng.normal(size=(n, n)).astype(np.float32)
    else:
        adj = rng.normal(size=(B, n, n)).astype(np.float32)
    uniform = adj_kind == "uniform"
    out, alpha = prop.ob_propagate_dense_complete(
        _t(jparams), torch.from_numpy(x), torch.from_numpy(adj), uniform=uniform)
    jout, jalpha = jprop.ob_propagate_dense_complete(
        jparams, jnp.asarray(x), jnp.asarray(adj), uniform=uniform)
    _close(out, jout)
    _close(alpha, jalpha)


def test_ob_propagation_init_tree_matches_jax():
    jparams = jax.device_get(jprop.ob_propagation_init(
        jax.random.PRNGKey(0), 16, 16, 4, 4))
    p = prop.ob_propagation_init(torch.Generator().manual_seed(0), 16, 16, 4, 4,
                                 device="cpu")
    shapes = _map(lambda t: tuple(t.shape), p)
    assert shapes == _map(lambda a: tuple(np.shape(a)), jparams)


@pytest.mark.parametrize("tie", [False, True])
def test_alpha_pairwise_distance(tie):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 25)).astype(np.float32)
    if tie:
        a[:] = 1.0          # the shipped graph: every alpha equal, distance 0
    # rtol 1e-4, not 1e-6: the Gram form leaves a rounding residue on the
    # diagonal (d2 = |a|^2 + |a|^2 - 2<a,a>) whose sqrt, when positive,
    # differs between the two libraries' matrix products
    _close(prop.alpha_pairwise_distance(torch.from_numpy(a)),
           jprop.alpha_pairwise_distance(jnp.asarray(a)), rtol=1e-4, atol=1e-6)


def test_dense_encoder_with_an_all_padded_sample():
    d, nhead, ffn, T = 16, 2, 32, 9
    jparams = jtr.transformer_encoder_init(jax.random.PRNGKey(6), d, nhead, ffn, 2)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, T, d)).astype(np.float32)
    lengths = np.array([T, 4, 0], np.int32)
    mask = np.arange(T)[None, :] >= lengths[:, None]
    got = tr.transformer_encoder_apply(_t(jparams), torch.from_numpy(x),
                                       torch.from_numpy(mask), nhead,
                                       backend="dense")
    want = jtr.transformer_encoder_apply(jparams, jnp.asarray(x),
                                         jnp.asarray(mask), nhead,
                                         backend="dense")
    assert torch.isfinite(got).all()
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_encoder_refuses_what_this_slice_does_not_serve():
    from raindrop_tpu_torch.utils.dropout import LayerSeeds

    p = tr.transformer_encoder_init(torch.Generator(), 8, 2, 16, 1, device="cpu")
    x = torch.zeros((1, 4, 8))
    # training is served now: without seeds the rate is 0 (the eval
    # output), with seeds the masks apply
    x = torch.ones((1, 4, 8))
    ev = tr.transformer_encoder_apply(p, x, None, 2)
    assert torch.equal(
        tr.transformer_encoder_apply(p, x, None, 2, dropout_rate=0.1, train=True), ev)
    seeds = [LayerSeeds(1, 2, 3, 4, 5)]
    assert not torch.equal(
        tr.transformer_encoder_apply(p, x, None, 2, dropout_rate=0.5, train=True,
                                     seeds=seeds), ev)
    with pytest.raises(ValueError, match="layer seeds"):
        tr.transformer_encoder_apply(p, x, None, 2, dropout_rate=0.5, train=True,
                                     seeds=seeds * 2)
    # the context-parallel backends run since the model-axis routes'
    # slice: without a shard (a mesh) they raise JAX's error; on one rank
    # they are the dense rung's function
    for backend in ("sp", "ring"):
        with pytest.raises(ValueError, match="needs a mesh"):
            tr.transformer_encoder_apply(p, x, None, 2, backend=backend)
        one = tr.transformer_encoder_apply(p, x, None, 2, backend=backend,
                                           shard=Shard(0, 1))
        assert torch.allclose(one, ev, rtol=1e-5, atol=1e-6), backend
    with pytest.raises(ValueError):
        tr.transformer_encoder_apply(p, x, None, 2, backend="bogus")
