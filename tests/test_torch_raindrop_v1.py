"""graph/transformer_conv.py and models/raindrop_v1.py against the JAX
package's on the CPU.

TransformerConv: the attention from queries and keys (with edge features)
and from edge weights, with and without the root weight and the beta
gate, 2 heads concatenated and averaged, dropout on alpha by the same
hash; out and alpha, and the gradients of every parameter and of x. The
port runs a batch of graphs with one edge list (nodes on axis 0, the
samples after it) in one call: held against JAX's map over the samples.
Raindrop v1 (eICU widths, max_len 16, one layer, B=4, a weighted
global_adj): logits, distance and gradients, eval and train.

Tolerances: 1e-5 on values (f32, another summation order); each gradient
element 1e-4 of its leaf's largest JAX gradient plus 1e-9, the floor below
which a gradient is rounding noise; the key bias, whose true gradient is 0,
1e-6 of the largest gradient of any leaf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.graph import transformer_conv as jconv
from raindrop_tpu.models import raindrop_v1 as jv1

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.graph.transformer_conv import (
    ConvSpec, transformer_conv_apply, transformer_conv_init)
from raindrop_tpu_torch.models.raindrop_v1 import raindrop_v1_apply, raindrop_v1_init
from raindrop_tpu_torch.train.checkpoint import flatten_params

from tests.torch_port_util import (
    baseline_seeds_from_jax_key, model_batch, seed32, without_meta)

TOL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-9
KEY_BIAS, KEY_BIAS_TOL = ("lin_key/b",), 1e-6
N, C_IN, C_OUT, H = 7, 5, 3, 2


def _graph(seed=0, n_edges=18):
    rng = np.random.default_rng(seed)
    edge_index = np.stack([rng.integers(0, N, n_edges),
                           rng.integers(0, N - 1, n_edges)]).astype(np.int32)
    return edge_index, rng.uniform(0.5, 2.0, n_edges).astype(np.float32)


def _tree_to_torch(tree):
    return {k: ({kk: torch.tensor(np.asarray(vv), requires_grad=True)
                 for kk, vv in v.items()}) for k, v in tree.items() if k != "_meta"}


def _assert_grads(tree, jgrads, what):
    jgrads = dict(flatten_params(without_meta(jgrads)))
    top = max(float(np.abs(v).max()) for v in jgrads.values())
    for path, t in flatten_params(tree):
        want = jgrads[path]
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        # the key bias: a softmax over a node's edges does not see a shift
        # of its keys, so its true gradient is 0 and both packages give
        # rounding noise of the other gradients' size, held to 1e-6 of the
        # largest of them
        tol = KEY_BIAS_TOL * top if path in KEY_BIAS else _grad_tol(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{what} {path}")


def _grad_tol(want):
    return GRAD_REL * float(np.abs(want).max()) + GRAD_FLOOR


CASES = [  # (weights, root_weight, beta, concat, edge_dim, dropout)
    (False, True, False, True, None, 0.0),
    (True, True, False, True, None, 0.0),
    (False, True, True, True, None, 0.0),
    (False, False, False, False, 4, 0.0),
    (True, True, True, False, None, 0.0),
    (False, True, False, True, 4, 0.3),
]


@pytest.mark.parametrize("weights,root,beta,concat,edge_dim,rate", CASES)
def test_transformer_conv_matches_jax(weights, root, beta, concat, edge_dim, rate):
    edge_index, w = _graph()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(N, C_IN)).astype(np.float32)
    attr = rng.normal(size=(edge_index.shape[1], 4)).astype(np.float32)
    jp = jconv.transformer_conv_init(jax.random.PRNGKey(3), C_IN, C_OUT, heads=H,
                                     concat=concat, beta=beta, root_weight=root,
                                     edge_dim=edge_dim)
    key = jax.random.PRNGKey(9)
    ew = jnp.asarray(w) if weights else None
    ea = jnp.asarray(attr) if edge_dim else None

    def jfn(p, xx):
        out, (_, alpha) = jconv.transformer_conv_apply(
            p, xx, jnp.asarray(edge_index), ew, ea, n_nodes=N,
            dropout_rate=rate, rng=key, train=rate > 0)
        return out, alpha

    g = rng.normal(size=(N, H * C_OUT if concat else C_OUT)).astype(np.float32)
    # one compiled program for the values and the gradients
    (jout, jalpha), (jgp, jgx) = jax.jit(lambda p, xx: (jfn(p, xx), jax.grad(
        lambda p, xx: jnp.sum(jfn(p, xx)[0] * g), argnums=(0, 1))(p, xx)))(
            jp, jnp.asarray(x))

    spec = ConvSpec(C_IN, C_OUT, heads=H, concat=concat, beta=beta, root_weight=root,
                    edge_dim=edge_dim)
    p = _tree_to_torch(jax.device_get(jp))
    assert {k for k, _ in flatten_params(p)} == {
        k for k, _ in flatten_params(transformer_conv_init(None, spec, "meta"))}
    tx = torch.tensor(x, requires_grad=True)
    out, (_, alpha) = transformer_conv_apply(
        p, spec, tx, torch.from_numpy(edge_index),
        torch.from_numpy(w) if weights else None,
        torch.from_numpy(attr) if edge_dim else None, n_nodes=N,
        dropout_rate=rate, seed=seed32(key) if rate else None, train=rate > 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(jalpha), rtol=TOL,
                               atol=TOL)
    (out * torch.from_numpy(g)).sum().backward()
    _assert_grads(p, jax.device_get(jgp), "conv")
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=_grad_tol(jgx))


def test_batched_conv_equals_the_map_over_samples():
    """One call over x [N, B, C] with a shared edge list gives, for each
    sample, JAX's single-graph result (what its vmap does)."""
    edge_index, w = _graph(2)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(3, N, C_IN)).astype(np.float32)
    jp = jconv.transformer_conv_init(jax.random.PRNGKey(4), C_IN, C_OUT, heads=H,
                                     beta=True)
    spec = ConvSpec(C_IN, C_OUT, heads=H, beta=True)
    p = _tree_to_torch(jax.device_get(jp))
    with torch.no_grad():
        for weights in (None, w):
            out, (_, alpha) = transformer_conv_apply(
                p, spec, torch.from_numpy(xs.transpose(1, 0, 2).copy()),
                torch.from_numpy(edge_index),
                None if weights is None else torch.from_numpy(weights))
            for b in range(3):
                jout, (_, jalpha) = jax.jit(jconv.transformer_conv_apply)(
                    jp, jnp.asarray(xs[b]), jnp.asarray(edge_index),
                    None if weights is None else jnp.asarray(weights))
                np.testing.assert_allclose(out[:, b].numpy(), np.asarray(jout),
                                           rtol=TOL, atol=TOL)
                np.testing.assert_allclose(alpha[:, b].numpy(), np.asarray(jalpha),
                                           rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def v1():
    kw = dict(max_len=16, nlayers=1)
    jcfg, cfg = jax_dataset_config("eICU", **kw), dataset_config("eICU", **kw)
    jp = jax.jit(lambda k: jv1.raindrop_v1_init(k, jcfg))(jax.random.PRNGKey(0))
    src, static, times, lengths = model_batch(cfg, 4, seed=3,
                                              lengths=np.array([16, 11, 0, 5]))
    adj = np.random.default_rng(6).uniform(0.0, 2.0, (cfg.d_inp, cfg.d_inp))
    adj[adj < 0.6] = 0.0
    return jcfg, cfg, jp, (src, static, times, lengths), adj.astype(np.float32)


@pytest.mark.parametrize("train,weighted", [(False, False), (True, False), (True, True)])
def test_raindrop_v1_forward_distance_and_gradients_match_jax(v1, train, weighted):
    jcfg, cfg, jp, batch, adj = v1
    adj = adj if weighted else None
    key = jax.random.PRNGKey(11)
    jargs = tuple(jnp.asarray(a) for a in batch)
    rng = np.random.default_rng(8)
    g = rng.normal(size=(4, cfg.n_classes)).astype(np.float32)

    def jfn(p):
        return jv1.raindrop_v1_apply(p, jcfg, *jargs, train=train,
                                     rng=key if train else None, global_adj=adj)

    (jlogits, jdist), jgrads = jax.jit(lambda p: (
        jfn(p), jax.grad(lambda p: jnp.sum(jfn(p)[0] * g))(p)))(jp)
    p = params_from_jax(jax.device_get(jp), cfg, device="cpu",
                        template=raindrop_v1_init(None, cfg, device="meta"))
    for _, t in flatten_params(p):
        t.requires_grad_(True)
    targs = (torch.from_numpy(batch[0]), torch.from_numpy(batch[1]),
             torch.from_numpy(batch[2]), torch.from_numpy(batch[3]).long())
    seeds = baseline_seeds_from_jax_key("raindrop_v1", key, cfg) if train else None
    logits, dist = raindrop_v1_apply(p, cfg, *targs, train=train, seeds=seeds,
                                     global_adj=adj)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(dist), float(jdist), rtol=TOL, atol=TOL)
    (logits * torch.from_numpy(g)).sum().backward()
    _assert_grads(p, jax.device_get(jgrads), "raindrop_v1")


def test_raindrop_v1_refuses_fewer_steps_than_sensors():
    cfg = dataset_config("eICU", max_len=8, nlayers=1)
    src, static, times, lengths = model_batch(cfg, 2)
    p = raindrop_v1_init(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="max_len >= d_inp"):
        raindrop_v1_apply(p, cfg, torch.from_numpy(src), torch.from_numpy(static),
                          torch.from_numpy(times), torch.from_numpy(lengths).long())
