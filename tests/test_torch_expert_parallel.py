"""Expert parallelism in the port (raindrop_tpu_torch/parallel/expert.py)
on two gloo ranks: moe_ffn_apply with each rank's experts against JAX's
unsharded moe_ffn_apply (outputs, aux loss and the gradients, which the
JAX side takes with jax.vjp), from the rank's part of the tree and from
the whole tree alike, and transformer_moe over the mesh against one
device. Tolerances: JAX's own for its sharded MoE (rtol and atol 1e-5 on
the outputs, rtol 1e-5 on the aux loss); gradients 1e-5 (the experts'
sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.parallel import expert as jexpert

from raindrop_tpu_torch.baselines.transformer_moe import (
    transformer_moe_apply, transformer_moe_init)
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.parallel.launch import run_ranks

from tests import torch_mesh_workers as workers


D, FFN, E = 8, 12, 4
TMOE_KW = dict(max_len=8, nlayers=1, nhead=1)


def _moe_inputs():
    params = jax.device_get(jexpert.moe_ffn_init(jax.random.PRNGKey(1), D, FFN, E))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, D)).astype(np.float32)
    g_out = rng.normal(size=(4, 6, D)).astype(np.float32)
    return params, x, g_out


def _tmoe_inputs():
    cfg = dataset_config("P19", **TMOE_KW)
    params = transformer_moe_init(torch.Generator().manual_seed(0), cfg, n_experts=4,
                                  device="cpu")
    rng = np.random.default_rng(0)
    T, B, F = cfg.max_len, 8, cfg.d_inp
    src = rng.normal(size=(T, B, 2 * F)).astype(np.float32)
    times = np.cumsum(rng.uniform(0.1, 1.0, size=(T, B)), 0).astype(np.float32)
    static = rng.normal(size=(B, cfg.d_static)).astype(np.float32)
    lengths = np.full((B,), T, np.int32)
    return cfg, params, (src, static, times, lengths)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_numpy_tree(v) for v in t]
    return np.asarray(t)


@pytest.fixture(scope="module")
def ranks():
    """Both checks' results on one group of two gloo ranks (1 x 2 mesh)."""
    params, x, g_out = _moe_inputs()
    _, tparams, arrays = _tmoe_inputs()
    return run_ranks(workers.expert, 2, (_numpy_tree(params), x, g_out),
                     (TMOE_KW, _numpy_tree({k: v for k, v in tparams.items()}), *arrays))


def test_moe_over_two_ranks_matches_jax_unsharded(ranks):
    params, x, g_out = _moe_inputs()

    def f(p, x):
        out, aux = jexpert.moe_ffn_apply(p, x)
        return jnp.sum(out * g_out) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    for rank, (res, _) in enumerate(ranks):
        experts = slice(rank * E // 2, (rank + 1) * E // 2)
        for got_out, got_aux, got_dx, grads in res:    # the rank's part, the whole
            np.testing.assert_allclose(got_out, np.asarray(out), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got_aux, float(aux), rtol=1e-5)
            np.testing.assert_allclose(got_dx, np.asarray(gx), rtol=1e-5, atol=1e-5)
            for k in ("w1", "b1", "w2", "b2"):
                g = grads[k]
                if g.shape[0] == E:     # the whole tree: the rank's experts only
                    others = np.ones(E, bool)
                    others[experts] = False
                    assert not g[others].any(), k
                    g = g[experts]
                np.testing.assert_allclose(g, np.asarray(gp[k])[experts],
                                           rtol=1e-5, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(grads["gate_w"], np.asarray(gp["gate"]["w"]),
                                       rtol=1e-5, atol=1e-5)


def test_transformer_moe_over_a_mesh_matches_one_device(ranks):
    cfg, params, arrays = _tmoe_inputs()
    with torch.no_grad():
        expect, aux0 = transformer_moe_apply(
            params, cfg, *(torch.from_numpy(a) for a in arrays))
    for _, (got, aux) in ranks:
        np.testing.assert_allclose(got, expect.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux, float(aux0), rtol=1e-5)
