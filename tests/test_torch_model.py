"""raindrop_apply of the port against the JAX eval forward, all four
presets, every encoder backend, on the CPU; and at the P19 dims (F=34,
T=60: N=34, E=1156, D=240) every propagation backend with and without a
weighted global_adj, eval and train mode.

max_len is cut to 40 for the presets (the propagation weights grow as
max_len^2) and B = 3 with lengths [T, T-7, 0]. attention_score_dtype is
float32, so the flash and fused-layer rungs are exact f32 on both sides:
tolerance 1e-4 on the logits, the same arithmetic summed in another order.
Train mode compares with the same dropout masks on both sides
(tests/torch_port_util.seeds_from_jax_key), the per-sample ones of the COO
branch included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply, raindrop_init
from raindrop_tpu_torch.utils.dropout import DropoutSeeds

from tests.torch_port_util import seeds_from_jax_key

MAX_LEN = 40


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    B, T, F = 3, cfg.max_len, cfg.d_inp
    lengths = np.array([T, T - 7, 0], np.int32)
    live = np.arange(T)[:, None] < lengths[None, :]                # [T, B]
    mask = ((rng.uniform(size=(T, B, F)) > 0.5) & live[..., None]).astype(np.float32)
    src = np.concatenate([rng.normal(size=(T, B, F)).astype(np.float32) * mask,
                          mask], -1)
    times = (np.cumsum(rng.uniform(0.1, 1.0, size=(T, B)), 0) * live).astype(np.float32)
    static = (rng.normal(size=(B, cfg.d_static)).astype(np.float32)
              if cfg.static else None)
    return src, static, times, lengths


@pytest.mark.parametrize("backend", ["dense", "flash", "fused_layer"])
@pytest.mark.parametrize("preset", ["P19", "P12", "eICU", "PAM"])
def test_eval_forward_matches_jax(preset, backend):
    kw = dict(max_len=MAX_LEN, attention_backend=backend,
              attention_score_dtype="float32")
    jcfg, cfg = jax_dataset_config(preset, **kw), dataset_config(preset, **kw)
    jparams = jax_raindrop_init(jax.random.PRNGKey(2), jcfg)
    # random biases in the encoder and head, so logits are not ~constant
    rng = np.random.default_rng(3)
    tree = jax.device_get(jparams)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    src, static, times, lengths = _batch(cfg)
    logits, dist = raindrop_apply(
        params, cfg, torch.from_numpy(src),
        None if static is None else torch.from_numpy(static),
        torch.from_numpy(times), torch.from_numpy(lengths))
    jlogits, jdist = jax_raindrop_apply(
        jparams, jcfg, jnp.asarray(src),
        None if static is None else jnp.asarray(static),
        jnp.asarray(times), jnp.asarray(lengths))
    assert logits.shape == (3, cfg.n_classes)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(dist), float(jdist), atol=1e-6)


@pytest.mark.parametrize("change,kw", [
    ("train", {}),
    # use_beta, use_beta with sensor_wise_mask and compute_dtype are served
    # now (tests/test_torch_beta.py, tests/test_torch_mixed_precision.py),
    # and the scale-out routes (tests/test_torch_scale_out_routes.py); these
    # cases hold what raises: a route without a mesh or two routes on the
    # temporal encoder (the JAX package's errors), and a parameter dtype
    # neither package runs
    pytest.param("call", {"pipeline_parallel": 2}, id="cfg-kw1"),
    pytest.param("call", {"edge_partition": True}, id="cfg-kw2"),
    ("cfg", {"dtype": "int8"}),
    ("scale_out", {}),
])
def test_refuses_what_this_slice_does_not_serve(change, kw):
    cfg = dataset_config("P19", max_len=8)
    params = raindrop_init(0, cfg, device="cpu")
    src, static, times, lengths = (torch.from_numpy(a) for a in _batch(cfg))
    call = dict()
    if change == "cfg":
        # the JAX package's own error: its init refuses a dtype that is
        # not floating point
        with pytest.raises(ValueError, match="float dtype"):
            dataset_config("P19", max_len=8, **kw)
        return
    if change == "call":
        call.update(kw)
    elif change == "train":
        call["train"] = True
    else:
        call["context_parallel"] = "ring"
    if change == "train":
        # training is served now (tests/test_torch_train_forward.py); with
        # dropout in the config it asks for its seeds
        with pytest.raises(ValueError, match="seeds"):
            raindrop_apply(params, cfg, src, static, times, lengths, **call)
        seeds = DropoutSeeds.draw(torch.Generator().manual_seed(0), cfg.nlayers)
        logits, _ = raindrop_apply(params, cfg, src, static, times, lengths,
                                   seeds=seeds, **call)
        assert torch.isfinite(logits).all()
        return
    with pytest.raises(ValueError, match="need a mesh"):
        raindrop_apply(params, cfg, src, static, times, lengths, **call)
    if change == "scale_out":
        with pytest.raises(ValueError, match="pick one"):
            raindrop_apply(params, cfg, src, static, times, lengths,
                           pipeline_parallel=2, **call)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prop_backend", ["auto", "coo", "pallas"])
def test_propagation_backends_match_jax(prop_backend, weighted, train):
    """prop_backend x global_adj at the P19 dims. Train mode runs dropout
    0.2 and prop_dropout 0.1, which sends 'pallas' to the dense branch
    without a global_adj and to COO with one, as in the JAX package."""
    kw = dict(prop_backend=prop_backend, attention_backend="dense",
              attention_score_dtype="float32", dropout=0.2, prop_dropout=0.1)
    jcfg, cfg = jax_dataset_config("P19", **kw), dataset_config("P19", **kw)
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    F = cfg.d_inp
    adj = rng.uniform(0.5, 2.0, size=(F, F)).astype(np.float32) if weighted else None
    src, static, times, lengths = _batch(cfg)
    key = jax.random.PRNGKey(13)
    logits, dist = raindrop_apply(
        params_from_jax(tree, cfg, device="cpu"), cfg, torch.from_numpy(src),
        torch.from_numpy(static), torch.from_numpy(times), torch.from_numpy(lengths),
        train=train, seeds=seeds_from_jax_key(key, cfg.nlayers, rows=3),
        global_adj=None if adj is None else torch.from_numpy(adj))
    jlogits, jdist = jax_raindrop_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(src), jnp.asarray(static),
        jnp.asarray(times), jnp.asarray(lengths), train=train, rng=key,
        global_adj=None if adj is None else jnp.asarray(adj))
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(dist), float(jdist), atol=1e-6)


def test_prop_branch_keeps_the_jax_fall_through():
    from raindrop_tpu_torch.models.raindrop import prop_branch

    def branch(backend, train, adj, prop_dropout=0.1):
        return prop_branch(dataset_config("P19", prop_backend=backend,
                                          prop_dropout=prop_dropout), train, adj)

    assert [branch("auto", t, a) for t in (False, True) for a in (False, True)] \
        == ["dense", "coo", "dense", "coo"]
    assert {branch("coo", t, a) for t in (False, True) for a in (False, True)} == {"coo"}
    assert branch("pallas", False, False) == branch("pallas", False, True) == "pallas"
    assert branch("pallas", True, False) == "dense"     # softmax-weight dropout
    assert branch("pallas", True, True) == "coo"
    assert branch("pallas", True, True, prop_dropout=0.0) == "pallas"
    with pytest.raises(ValueError, match="prop_backend"):
        branch("palas", False, False)


def test_coo_training_asks_for_per_sample_seeds_and_global_adj_is_checked():
    cfg = dataset_config("P19", max_len=8, prop_backend="coo", prop_dropout=0.1)
    params = raindrop_init(0, cfg, device="cpu")
    src, static, times, lengths = (torch.from_numpy(a) for a in _batch(cfg))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="rows=3"):
        raindrop_apply(params, cfg, src, static, times, lengths, train=True,
                       seeds=DropoutSeeds.draw(gen, cfg.nlayers))
    logits, _ = raindrop_apply(params, cfg, src, static, times, lengths, train=True,
                               seeds=DropoutSeeds.draw(gen, cfg.nlayers, rows=3))
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="global_adj"):
        raindrop_apply(params, cfg, src, static, times, lengths,
                       global_adj=torch.ones((3, 3)))
