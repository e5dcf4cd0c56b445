"""use_beta (the time-conditioned edge attention with top-50% pruning) of
the port against the JAX package on the CPU, in f32.

Held to 1e-5 relative to max(1, |JAX|): `_beta_gamma`; one COO beta layer,
unbatched and batched against the JAX layer mapped over the samples (with
and without softmax-weight dropout, the masks hashed from the same seeds);
the dense two-layer block on its factored all-ones route and on its
[B, s, t, D] grid route (a general adj, and the all-ones one under
dropout); the whole `raindrop_apply` on the dense and COO branches, with
and without sensor_wise_mask, eval and train; and three trainer steps (in
tests/test_torch_trainer.py's bounds).

The kept edges are compared with JAX's. Where a kept edge differs, its
score must lie within 1e-6 relative of the K-th score (a near-tie the two
frameworks' summation orders may break either way): the test prints the
edge as the witness and fails otherwise, and such a sample's outputs
(another edge kept) are not compared. On the all-ones graph the scores of
one target tie exactly across its sources, so there the order of ties
decides, and it must be the stable argsort's.

The distance raindrop_apply returns is the alpha regularizer's Gram form
|a|^2 + |b|^2 - 2<a, b> in f32. With use_beta the alphas of two samples
are close, the form cancels, and the f32 value of either package is about
1e-4 off its float64 value (JAX's own is; the same alphas through the two
packages' functions differ by 5e-5). So the alphas raindrop_apply hands it
are held to JAX's to 1e-5, and the distance to its float64 value from
them within the Gram form's f32 error bound (`_gram_bound`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.graph import propagate as jprop
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.graph import propagate as prop
from raindrop_tpu_torch.graph.structure import complete_graph_edges
from raindrop_tpu_torch.models.raindrop import prop_branch, raindrop_apply
from raindrop_tpu_torch.utils.dropout import DropoutSeeds

from tests.test_torch_trainer import _three_steps
from tests.torch_port_util import model_batch, seed32, seeds_from_jax_key

TOL = 1e-5
TIE = 1e-6
MAX_LEN, F, OB, D_PE = 12, 36, 4, 16          # P12's sensors at a short window
D = MAX_LEN * OB


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
    assert err <= tol, err


def _layers(seed=0):
    """Both propagation layers of a P12-width model at MAX_LEN, numpy and
    bridged, with the biases of increase_dim random (the init's are small)."""
    kw = dict(max_len=MAX_LEN, use_beta=True)
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(seed),
                                            jax_dataset_config("P12", **kw)))
    params = params_from_jax(tree, dataset_config("P12", **kw), device="cpu")
    return tree, params


def _kept(edge_index, n):
    """[..., 2, K] kept edges -> sorted flat ids s * n + t."""
    ei = np.asarray(edge_index)
    return np.sort(ei[..., 0, :] * n + ei[..., 1, :], axis=-1)


def _same_kept(got, want, scores, k, what):
    """got, want: [B, K] sorted flat ids of the kept edges; scores [B, E]
    (the JAX side's). Every edge kept by one side only must be a near-tie
    with the K-th score (printed as the witness). Returns [B] bool: the
    samples whose kept sets are equal; at least one must be."""
    got, want, scores = np.atleast_2d(got), np.atleast_2d(want), np.atleast_2d(scores)
    same = np.ones(got.shape[0], bool)
    for b in range(got.shape[0]):
        diff = np.setxor1d(got[b], want[b])
        if diff.size == 0:
            continue
        same[b] = False
        kth = -np.sort(-scores[b])[k - 1]
        for e in diff:
            rel = abs(scores[b, e] - kth) / max(abs(kth), 1e-30)
            print(f"{what}: sample {b} edge {e} kept by one side only, score "
                  f"{scores[b, e]!r} against the K-th {kth!r} ({rel:.2e} apart)")
            assert rel <= TIE, (what, b, int(e), rel)
    assert same.any(), what
    return same


def _close_rows(got, want, rows, tol=TOL):
    """_close on the samples (leading axis) of `rows`."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    _close(got[rows], np.asarray(want)[rows], tol)


def test_beta_gamma_matches_jax():
    tree, params = _layers()
    rng = np.random.default_rng(0)
    E = 50
    x = rng.normal(size=(E, D)).astype(np.float32)
    pt = rng.normal(size=(MAX_LEN, D_PE)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(E,)).astype(np.float32)
    tgt = rng.integers(0, F, size=(E,))
    want = jprop._beta_gamma(tree["ob_propagation"], jnp.asarray(x), jnp.asarray(pt),
                             jnp.asarray(w), jnp.asarray(tgt), OB)
    got = prop._beta_gamma(params["ob_propagation"], torch.from_numpy(x),
                           torch.from_numpy(pt), torch.from_numpy(w),
                           torch.from_numpy(tgt), OB)
    assert got.shape == (E, D)
    _close(got, want)
    # batched over a leading axis: the same function sample by sample
    xb, ptb = np.stack([x, x[::-1]]), np.stack([pt, pt * 0.5])
    gotb = prop._beta_gamma(params["ob_propagation"], torch.from_numpy(xb),
                            torch.from_numpy(ptb), torch.from_numpy(np.stack([w, w])),
                            torch.from_numpy(np.stack([tgt, tgt])), OB)
    _close(gotb[0], want)
    with pytest.raises(ValueError, match="8\\*ob_dim"):
        prop._beta_gamma(params["ob_propagation"], torch.from_numpy(x),
                         torch.from_numpy(pt[:, :8]), torch.from_numpy(w),
                         torch.from_numpy(tgt), OB)


def _graph(weighted, seed=1):
    ei, _ = complete_graph_edges(F)
    rng = np.random.default_rng(seed)
    w = (rng.uniform(0.5, 2.0, size=(ei.shape[1],)) if weighted
         else np.ones(ei.shape[1])).astype(np.float32)
    return ei, w


@pytest.mark.parametrize("weighted", [False, True])
def test_one_coo_beta_layer_matches_jax(weighted):
    """One sample: out, the kept edges (the stable argsort's, ties and all)
    and their mean gamma."""
    tree, params = _layers()
    ei, w = _graph(weighted)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(F, D)).astype(np.float32)
    pt = rng.normal(size=(MAX_LEN, D_PE)).astype(np.float32)
    kw = dict(use_beta=True, ob_dim=OB, n_nodes=F)
    jout, (jei, jalpha) = jprop.ob_propagate_coo(
        tree["ob_propagation"], jnp.asarray(x), jnp.asarray(pt), jnp.asarray(ei),
        jnp.asarray(w), **kw)
    out, (tei, alpha) = prop.ob_propagate_coo(
        params["ob_propagation"], torch.from_numpy(x), torch.from_numpy(pt),
        torch.from_numpy(ei), torch.from_numpy(w), **kw)
    K = ei.shape[1] // 2
    assert tuple(tei.shape) == (2, K) and tuple(alpha.shape) == (K,)
    scores = np.asarray(jnp.mean(jprop._beta_gamma(
        tree["ob_propagation"], jnp.asarray(x)[ei[1]], jnp.asarray(pt),
        jnp.asarray(w), jnp.asarray(ei[1]), OB), axis=1))
    _same_kept(_kept(tei.numpy(), F), _kept(jei, F), scores, K, "one layer")
    # alpha is the kept scores in argsort order: near-ties inside the kept
    # set may order otherwise, so the values are compared sorted
    _close(np.sort(alpha.numpy()), np.sort(np.asarray(jalpha)))
    _close(out, jout)


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_coo_beta_batched_equals_the_jax_layer_mapped_over_samples(dropout):
    """Both layers as the model runs them: layer 1 prunes each sample to
    its own edges, layer 2 runs over those per-sample edge lists."""
    tree, params = _layers()
    ei, w = _graph(False)
    rng = np.random.default_rng(3)
    B = 3
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    pt = rng.normal(size=(B, MAX_LEN, D_PE)).astype(np.float32)
    k1 = jax.random.split(jax.random.PRNGKey(4), B)
    k2 = jax.random.split(jax.random.PRNGKey(5), B)
    kw = dict(ob_dim=OB, n_nodes=F, dropout_rate=dropout, train=True)

    def one(xs, ps, r1, r2):
        o1, (e2, a1) = jprop.ob_propagate_coo(
            tree["ob_propagation"], xs, ps, jnp.asarray(ei), jnp.asarray(w),
            use_beta=True, rng=r1, **kw)
        o2, (_, a2) = jprop.ob_propagate_coo(
            tree["ob_propagation_layer2"], o1, ps, e2, a1, rng=r2, **kw)
        return o1, e2, a1, o2, a2[:, 0]

    jo1, je2, ja1, jo2, ja2 = jax.vmap(one)(jnp.asarray(x), jnp.asarray(pt), k1, k2)
    s1 = [seed32(k) for k in k1] if dropout else None
    s2 = [seed32(k) for k in k2] if dropout else None
    o1, (e2, a1) = prop.ob_propagate_coo(
        params["ob_propagation"], torch.from_numpy(x), torch.from_numpy(pt),
        torch.from_numpy(ei), torch.from_numpy(w), use_beta=True, seed=s1, **kw)
    o2, (_, a2) = prop.ob_propagate_coo(
        params["ob_propagation_layer2"], o1, torch.from_numpy(pt), e2, a1,
        seed=s2, **kw)
    K = ei.shape[1] // 2
    assert tuple(e2.shape) == (B, 2, K) and tuple(a2.shape) == (B, K, 1)
    # all-ones graph: each target's sources tie exactly, so the stable
    # order decides; where the kept sets are equal so are the edge lists
    scores = np.asarray(jnp.mean(jax.vmap(lambda xs, ps: jprop._beta_gamma(
        tree["ob_propagation"], xs[ei[1]], ps, jnp.asarray(w), jnp.asarray(ei[1]),
        OB))(jnp.asarray(x), jnp.asarray(pt)), axis=-1))
    same = _same_kept(_kept(e2.numpy(), F), _kept(je2, F), scores, K, "COO batched")
    np.testing.assert_array_equal(e2.numpy()[same], np.asarray(je2)[same])
    _close_rows(a1, ja1, same)
    _close_rows(o1, jo1, same)
    _close_rows(o2, jo2, same)
    _close_rows(a2[..., 0], ja2, same)


def _dense_inputs(seed=6, B=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    pe = rng.normal(size=(B, MAX_LEN, D_PE)).astype(np.float32)
    return x, pe


@pytest.mark.parametrize("route,dropout", [
    ("uniform", 0.0), ("uniform", 0.3), ("grid", 0.0), ("grid", 0.3)])
def test_dense_beta_block_matches_jax(route, dropout):
    """The dense two-layer block: 'uniform' is the all-ones graph (factored
    route, or the grid under dropout), 'grid' a general adj. Dropout masks
    are hashed from the seeds of the same keys; the kept-edge mask is held
    against the JAX COO layers' kept edges."""
    tree, params = _layers()
    x, pe = _dense_inputs()
    B = x.shape[0]
    adj = (np.ones((F, F)) if route == "uniform"
           else np.random.default_rng(7).uniform(0.5, 2.0, size=(F, F))).astype(np.float32)
    key = jax.random.PRNGKey(8)
    kw = dict(ob_dim=OB, dropout_rate=dropout, train=True,
              uniform_adj=route == "uniform")
    jout, jalpha = jprop.raindrop_propagate_beta_dense(
        tree["ob_propagation"], tree["ob_propagation_layer2"], jnp.asarray(x),
        jnp.asarray(pe), jnp.asarray(adj), rng=key, **kw)
    seeds = tuple(seed32(k) for k in jax.random.split(key)) if dropout else None
    out, alpha, mask = prop.raindrop_propagate_beta_dense(
        params["ob_propagation"], params["ob_propagation_layer2"], torch.from_numpy(x),
        torch.from_numpy(pe), torch.from_numpy(adj), seeds=seeds, return_mask=True,
        **kw)
    K = F * F // 2
    assert tuple(out.shape) == (B, F, D) and tuple(alpha.shape) == (B, K)
    assert int(mask.sum()) == B * K
    # JAX's kept edges: its block's scores (adj * the mean of beta over
    # time, the lines of raindrop_propagate_beta_dense) by the stable argsort
    p1 = tree["ob_propagation"]
    h_w = (jnp.asarray(x) @ p1["increase_dim"]["w"].T
           + p1["increase_dim"]["b"]).reshape(B, F, MAX_LEN, 8 * OB)
    beta = (jnp.einsum("btsc,tc->bts", h_w[..., :16], p1["map_weights"])
            + jnp.einsum("btsc,bsc->bts", h_w[..., 16:], jnp.asarray(pe))) / (8 * OB)
    scores = np.asarray((jnp.asarray(adj)[None] * jnp.mean(beta, axis=-1)[:, None, :])
                        .reshape(B, -1))
    want = np.sort(np.argsort(-scores, axis=-1, kind="stable")[:, :K], axis=-1)
    got = np.sort(np.nonzero(mask.reshape(B, -1).numpy())[1].reshape(B, K), axis=-1)
    same = _same_kept(got, want, scores, K, f"dense {route}")
    _close(alpha, jalpha)
    _close_rows(out, jout, same)


def test_dense_block_equals_coo_on_the_all_ones_graph():
    """The port's two forms of the block, as the model's two branches run
    them on the shipped graph: the same kept edges, out and alpha."""
    _, params = _layers()
    x, pe = _dense_inputs(9)
    B = x.shape[0]
    p1, p2 = params["ob_propagation"], params["ob_propagation_layer2"]
    xt, pet = torch.from_numpy(x), torch.from_numpy(pe)
    out_d, alpha_d, mask = prop.raindrop_propagate_beta_dense(
        p1, p2, xt, pet, torch.ones((F, F)), ob_dim=OB, uniform_adj=True,
        return_mask=True)
    ei = torch.from_numpy(complete_graph_edges(F)[0])
    kw = dict(ob_dim=OB, n_nodes=F)
    o1, (e2, a1) = prop.ob_propagate_coo(p1, xt, pet, ei, torch.ones(F * F),
                                         use_beta=True, **kw)
    out_c, (_, a2) = prop.ob_propagate_coo(p2, o1, pet, e2, a1, **kw)
    kept = torch.zeros((B, F * F), dtype=torch.bool)
    kept.scatter_(1, e2[:, 0] * F + e2[:, 1], True)
    assert torch.equal(kept.reshape(B, F, F), mask)
    _close(out_d, out_c.detach())
    _close(alpha_d, a2[..., 0].detach())


def test_keep_mask_follows_the_stable_argsort_on_ties():
    scores = torch.tensor([[1.0, 3.0, 2.0, 2.0, 2.0, 0.5]])
    mask = prop.beta_keep_mask(scores, 3)
    want = torch.zeros_like(mask)
    want[0, torch.argsort(-scores[0], stable=True)[:3]] = True
    assert torch.equal(mask, want)
    assert mask.tolist() == [[False, True, True, True, False, False]]


def _exact_distance(alpha):
    a = np.asarray(alpha, np.float64)
    d2 = ((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(np.maximum(d2, 0.0)).mean())


def _gram_bound(alpha):
    """The f32 Gram form's error bound on the mean distance: a pair's
    |a|^2 + |b|^2 - 2<a, b> is off by at most (E + 2) u (|a| + |b|)^2
    (three E-term dot products, u = 2^-24), which moves its square root by
    at most min(sqrt(err), err / (2 d))."""
    a = np.asarray(alpha, np.float64)
    E = a.shape[-1]
    n = np.sqrt((a * a).sum(-1))
    err = (E + 2) * 2.0 ** -24 * (n[:, None] + n[None, :]) ** 2
    d = np.sqrt(np.maximum(((a[:, None, :] - a[None, :, :]) ** 2).sum(-1), 0.0))
    with np.errstate(divide="ignore"):
        move = np.minimum(np.sqrt(err), err / (2 * d))
    return float(move.mean())


def _model_case(overrides, train, B=4, seed=10):
    kw = dict(max_len=MAX_LEN, use_beta=True, attention_backend="dense",
              **overrides)
    if train:
        kw["prop_dropout"] = 0.1
    jcfg, cfg = jax_dataset_config("P12", **kw), dataset_config("P12", **kw)
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(seed), jcfg))
    params = params_from_jax(tree, cfg, device="cpu")
    src, static, times, lengths = model_batch(cfg, B, seed)
    key = jax.random.PRNGKey(seed + 1)
    return jcfg, cfg, tree, params, (src, static, times, lengths), key


def _alpha_all(module, apply_fn, *args, **kw):
    """The alphas a raindrop_apply hands its distance, seen on the way
    through `module`'s name for alpha_pairwise_distance."""
    seen = []
    real = module.alpha_pairwise_distance

    def spy(a):
        seen.append(a)
        return real(a)

    module.alpha_pairwise_distance = spy
    try:
        out = apply_fn(*args, **kw)
    finally:
        module.alpha_pairwise_distance = real
    return out, np.asarray(seen[0]) if not isinstance(seen[0], torch.Tensor) else seen[0]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("overrides", [
    {}, {"prop_backend": "coo"}, {"prop_backend": "pallas"},
    {"sensor_wise_mask": True}, {"sensor_wise_mask": True, "prop_backend": "coo"}])
def test_raindrop_apply_matches_jax(overrides, train):
    """The whole forward: the dense beta block (also under 'pallas', which
    beta routes off), the COO branch, with sensor_wise_mask; train mode
    drops with dropout 0.2 and prop_dropout 0.1 on the same masks (the
    block's two seeds, the COO branch's per-sample ones)."""
    jcfg, cfg, tree, params, (src, static, times, lengths), key = _model_case(
        overrides, train)
    B = src.shape[1]
    branch = prop_branch(cfg, train, False)
    assert branch == ("coo" if overrides.get("prop_backend") == "coo" else "dense")
    import raindrop_tpu.models.raindrop as jmodel

    (jlogits, jdist), jalpha = _alpha_all(
        jmodel, jax_raindrop_apply, jax.tree.map(jnp.asarray, tree), jcfg,
        jnp.asarray(src), jnp.asarray(static), jnp.asarray(times),
        jnp.asarray(lengths), train=train, rng=key)
    seeds = seeds_from_jax_key(key, cfg.nlayers, rows=B) if train else None
    import raindrop_tpu_torch.models.raindrop as model

    (logits, dist), alpha = _alpha_all(
        model, raindrop_apply, params, cfg, *(torch.from_numpy(a) for a in
                                              (src, static, times, lengths)),
        train=train, seeds=seeds)
    assert logits.dtype == torch.float32 and tuple(alpha.shape) == (B, F * F // 2)
    _close(logits, jlogits)
    _close(alpha, jalpha)
    # the distance: see the module docstring
    a = alpha.detach().numpy()
    err = abs(float(dist) - _exact_distance(a))
    print(f"distance {float(dist)!r}, float64 {_exact_distance(a)!r}, JAX "
          f"{float(jdist)!r}; the port's f32 error {err:.2e}, bound {_gram_bound(a):.2e}")
    assert err <= _gram_bound(a)


def test_raindrop_apply_with_a_global_adj_takes_coo_beta():
    jcfg, cfg, tree, params, (src, static, times, lengths), _ = _model_case(
        {"prop_backend": "pallas"}, False)
    w = np.random.default_rng(11).uniform(0.5, 2.0, size=(F, F)).astype(np.float32)
    assert prop_branch(cfg, False, True) == "coo"
    jlogits, _ = jax_raindrop_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(src), jnp.asarray(static),
        jnp.asarray(times), jnp.asarray(lengths), global_adj=jnp.asarray(w))
    logits, _ = raindrop_apply(params, cfg, *(torch.from_numpy(a) for a in
                                              (src, static, times, lengths)),
                               global_adj=torch.from_numpy(w))
    _close(logits, jlogits)


def test_the_dense_block_asks_for_its_seeds():
    _, cfg, _, params, (src, static, times, lengths), _ = _model_case({}, True)
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(0), cfg.nlayers)
    with pytest.raises(ValueError, match="beta=True"):
        raindrop_apply(params, cfg, *(torch.from_numpy(a) for a in
                                      (src, static, times, lengths)),
                       train=True, seeds=seeds)


@pytest.mark.parametrize("overrides", [
    {"attention_backend": "flash"}, {"prop_backend": "coo"}])
def test_three_beta_steps_match_the_jax_trainer(overrides):
    """Three steps from the same parameters, batches and masks, in
    tests/test_torch_trainer.py's bounds (losses 1e-5 relative, parameters
    2e-6 + 1e-4 relative, 5e-5 at most). prop_dropout 0.1: the dense
    block's two seeds, or the COO branch's per-sample ones."""
    _three_steps("P12", 0.2, use_beta=True, prop_dropout=0.1, **overrides)


def test_the_trainer_draws_the_blocks_seeds():
    from tests.test_torch_trainer import _setup

    _, _, tr, _ = _setup("P12", 0.2, use_beta=True, prop_dropout=0.1)
    seeds = tr.draw_seeds(6)
    assert len(seeds.beta) == 2 and seeds.prop1_rows == ()
    _, _, tr, _ = _setup("P12", 0.2, use_beta=True, prop_dropout=0.1,
                         prop_backend="coo")
    seeds = tr.draw_seeds(6)
    assert seeds.beta == () and len(seeds.prop1_rows) == 6
