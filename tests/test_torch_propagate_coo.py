"""ob_propagate_coo and ob_propagate_selfattention of the port against the
JAX package's on the CPU: values and gradients w.r.t. x, the same parameters
(bridged leaf by leaf), edges in shuffled order.

Seeded dropout compares exactly in its masks: the port's seed is read off
the JAX key (tests/torch_port_util.seed32). Tolerances: 1e-5 on values
relative to max(1, |reference|), 1e-4 on gradients (the same f32
arithmetic in another order; 'sddmm' projects the N nodes where 'gather'
projects the E gathered rows, another rounding again).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.graph import propagate as jprop

from raindrop_tpu_torch.graph import propagate as prop

from tests.torch_port_util import seed32, to_torch

N, D, OB = 9, 24, 3


def _setup(heads=1, seed=0):
    rng = np.random.default_rng(seed)
    E = 40
    src = rng.integers(0, N, size=E)
    dst = rng.integers(0, N, size=E)
    dst = np.where(dst == 6, 2, dst)                   # node 6: no incoming edge
    ei = np.stack([src, dst]).astype(np.int32)
    jparams = jprop.ob_propagation_init(jax.random.PRNGKey(seed), D, D // heads, N,
                                        OB, heads=heads)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=E).astype(np.float32)
    cot = rng.normal(size=(N, D)).astype(np.float32)
    return jparams, to_torch(jax.device_get(jparams)), ei, x, w, cot


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("decompose", [False, True])
def test_coo_value_and_gradient_match_jax(decompose, train):
    jparams, params, ei, x, w, cot = _setup()
    key = jax.random.PRNGKey(7)
    kw = dict(ob_dim=OB, n_nodes=N, dropout_rate=0.3, train=train,
              decompose=decompose)

    def jfn(a):
        out, (_, alpha) = jprop.ob_propagate_coo(
            jparams, a, None, jnp.asarray(ei), jnp.asarray(w), rng=key, **kw)
        return out, alpha

    (jout, jalpha), vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(cot), jnp.zeros_like(jalpha)))
    tx = torch.from_numpy(x).requires_grad_()
    out, (ei2, alpha) = prop.ob_propagate_coo(
        params, tx, None, torch.from_numpy(ei), torch.from_numpy(w),
        seed=seed32(key), **kw)
    assert ei2.shape == (2, ei.shape[1]) and alpha.shape == (ei.shape[1], 1)
    np.testing.assert_array_equal(alpha[:, 0].numpy(), w)      # PRE-softmax
    _close(out.detach(), jout, 1e-5)
    assert (out.detach()[6] == 0).all()
    out.backward(torch.from_numpy(cot))
    _close(tx.grad, jdx, 1e-4)
    if train:       # the dropout did something, and the masks agree
        ev, _ = prop.ob_propagate_coo(params, tx.detach(), None, torch.from_numpy(ei),
                                      torch.from_numpy(w), **{**kw, "train": False})
        assert not torch.allclose(ev, out.detach())


def test_coo_batched_equals_the_jax_function_mapped_over_samples():
    jparams, params, ei, x, w, _ = _setup()
    rng = np.random.default_rng(3)
    B = 4
    xb = rng.normal(size=(B, N, D)).astype(np.float32)
    wb = rng.uniform(0.5, 2.0, size=(B, ei.shape[1])).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    kw = dict(ob_dim=OB, n_nodes=N, dropout_rate=0.25, train=True)
    jout = jax.vmap(lambda a, ww, r: jprop.ob_propagate_coo(
        jparams, a, None, jnp.asarray(ei), ww, rng=r, **kw)[0])(
            jnp.asarray(xb), jnp.asarray(wb), keys)
    out, (_, alpha) = prop.ob_propagate_coo(
        params, torch.from_numpy(xb), None, torch.from_numpy(ei),
        torch.from_numpy(wb), seed=[seed32(k) for k in keys], **kw)
    assert alpha.shape == (B, ei.shape[1], 1)
    _close(out, jout, 1e-5)
    # use_beta is served now (tests/test_torch_beta.py): without a time
    # encoding it has nothing to condition on
    with pytest.raises(ValueError, match="p_t"):
        prop.ob_propagate_coo(params, torch.from_numpy(xb), None,
                              torch.from_numpy(ei), torch.from_numpy(wb),
                              use_beta=True)


@pytest.mark.parametrize("edge_weights", [False, True])
@pytest.mark.parametrize("backend,jbackend", [("gather", "xla"), ("xla", "xla"),
                                              ("sddmm", "sddmm")])
def test_selfattention_value_and_gradient_match_jax(backend, jbackend, edge_weights):
    heads = 2
    jparams, params, ei, x, w, cot = _setup(heads=heads, seed=1)
    key = jax.random.PRNGKey(9)
    jw, tw = (jnp.asarray(w), torch.from_numpy(w)) if edge_weights else (None, None)
    kw = dict(heads=heads, n_nodes=N, dropout_rate=0.2, train=True)

    def jfn(a):
        out, (_, alpha) = jprop.ob_propagate_selfattention(
            jparams, a, jnp.asarray(ei), jw, rng=key, score_backend=jbackend, **kw)
        return out, alpha

    (jout, jalpha), vjp = jax.vjp(jfn, jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(cot), jnp.zeros_like(jalpha)))
    tx = torch.from_numpy(x).requires_grad_()
    out, (_, alpha) = prop.ob_propagate_selfattention(
        params, tx, torch.from_numpy(ei), tw, seed=seed32(key),
        score_backend=backend, **kw)
    assert alpha.shape == (ei.shape[1], heads)
    _close(alpha.detach(), jalpha, 1e-5)                       # POST-softmax
    _close(out.detach(), jout, 1e-5)
    out.backward(torch.from_numpy(cot))
    _close(tx.grad, jdx, 1e-4)


def test_selfattention_refuses_an_unknown_backend():
    _, params, ei, x, _, _ = _setup(heads=2)
    with pytest.raises(ValueError, match="score_backend"):
        prop.ob_propagate_selfattention(params, torch.from_numpy(x),
                                        torch.from_numpy(ei), heads=2,
                                        score_backend="pallas")
