"""The sensor-wise model past 1024 steps against JAX on the CPU: with
`sensor_wise_mask=True` the encoder is d_inp * (d_ob + d_pe) wide with 2
heads, and at max_len > 1024 with `attention_backend='flash'` both
packages run it through their split-head `flash_mha` (the JAX side in its
streaming regime, Pallas in interpret mode) at a head dim past 128.

The model is narrow but keeps PAM-sw's head dim: 4 sensors with d_ob = 1
and d_pe = 84 give d = 340, 2 heads of 170, at max_len = 1032 (the
propagation holds 13 matrices of (max_len * d_ob)^2 parameters a layer, so
d_ob stays 1). attention_score_dtype is float32, so both sides compute
exact f32. Tolerances as in tests/test_torch_long_sequence.py: logits
1e-4, the loss 1e-5 relative, the parameters after one trainer step 5e-5
(the key bias 3e-3: its true gradient is zero), the server's flash route
against its dense one 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import TrainConfig as JaxTrainConfig
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.nn import aggregate as jagg
from raindrop_tpu.train.trainer import Trainer as JaxTrainer

from raindrop_tpu_torch.bridge import (
    adam_state_from_jax, adam_state_to_numpy, params_from_jax, params_to_numpy)
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply, raindrop_init
from raindrop_tpu_torch.nn import transformer as tr_mod
from raindrop_tpu_torch.nn.aggregate import sensor_wise_pool
from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.serve import InferenceServer
from raindrop_tpu_torch.train.trainer import Trainer, flatten_params

from tests.test_torch_long_sequence import tree_leaf
from tests.test_torch_trainer import _adam_trees
from tests.torch_port_util import model_batch, seeds_from_jax_key

T_LONG, B, HD = 1032, 3, 170
KW = dict(max_len=T_LONG, d_inp=4, d_ob=1, d_pe=84, nhid=12, sensor_wise_mask=True,
          attention_backend="flash", attention_score_dtype="float32")


def _trees(seed=2):
    jcfg, cfg = jax_dataset_config("PAM", **KW), dataset_config("PAM", **KW)
    assert cfg.d_transformer == 2 * HD and cfg.nhead == 2
    assert fa.pad8(cfg.max_len) > fa.MAX_FUSED_T
    jtr = JaxTrainer(jcfg, JaxTrainConfig(dataset="PAM", learning_rate=1e-3,
                                          batch_size=B))
    tree = jax.device_get(jtr._init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(3)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    return jtr, jcfg, cfg, tree


def _step_batch(cfg):
    src, _, times, _ = model_batch(cfg, B, lengths=np.array([T_LONG, 1030, 517]))
    y = np.array([0, 5, 2], np.int32)
    return {"P": src.transpose(1, 0, 2).copy(), "time": times.T.copy(), "y": y}


def test_the_sensor_wise_long_model_takes_flash_mha_at_hd_170():
    cfg = dataset_config("PAM", **KW)
    for on_cuda in (True, False):
        assert tr_mod.encoder_rung(cfg.attention_backend, T_LONG, cfg.d_transformer,
                                   cfg.nhead, on_cuda) == "flash_mha"
    # the full-width configuration the card runs: PAM-sw at max_len 2048
    full = dataset_config("PAM", max_len=2048, sensor_wise_mask=True)
    assert full.d_transformer // full.nhead == HD
    assert tr_mod.encoder_rung(full.attention_backend, 2048, full.d_transformer,
                               full.nhead, True) == "flash_mha"
    assert HD <= fa.MAX_HEAD_DIM


def test_sensor_wise_pool_over_a_long_window_matches_jax():
    """The pool in f32 over T = 2048 steps, every sensor's weight up to T
    (a sensor never observed in a sample): 1e-6 relative, one sum in
    another order."""
    rng = np.random.default_rng(0)
    r_out = rng.normal(size=(2, 2048, 3, 8)).astype(np.float32)
    observed = (rng.uniform(size=(2, 2048, 3)) > 0.9).astype(np.float32)
    observed[:, :, 1] = 0.0
    got = sensor_wise_pool(torch.from_numpy(r_out), torch.from_numpy(observed))
    want = np.asarray(jagg.sensor_wise_pool(jnp.asarray(r_out), jnp.asarray(observed)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("train", [False, True])
def test_raindrop_apply_matches_jax(train, monkeypatch):
    """Eval, and train with the shipped dropout and the JAX key's masks:
    each layer calls flash_mha on (B, 2, 1032, 170) head views."""
    _, jcfg, cfg, tree = _trees()
    calls = []
    real = tr_mod.flash_mha
    monkeypatch.setattr(tr_mod, "flash_mha",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    src, _, times, lengths = model_batch(cfg, B)
    key = jax.random.PRNGKey(13)
    logits, dist = raindrop_apply(
        params_from_jax(tree, cfg, device="cpu"), cfg, torch.from_numpy(src), None,
        torch.from_numpy(times), torch.from_numpy(lengths), train=train,
        seeds=seeds_from_jax_key(key, cfg.nlayers))
    jlogits, jdist = jax_raindrop_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(src), None,
        jnp.asarray(times), jnp.asarray(lengths), train=train, rng=key)
    assert calls == [(B, 2, T_LONG, HD)] * cfg.nlayers
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(dist), float(jdist), atol=1e-6)


def test_one_trainer_step_from_the_bridged_state_matches_jax():
    """One masked-Adam step (dropout 0.2) from the JAX trainer's state,
    carried across the bridge after a first JAX step: the loss, the logits
    and every parameter against the JAX trainer's second step; live
    parameters changed, dead ones untouched."""
    jtr, jcfg, cfg, tree = _trees()
    batch = _step_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    opt_state = jtr.optimizer.init(jparams)
    jparams, opt_state, _, _ = jtr._train_step(jparams, opt_state, jb,
                                               jax.random.PRNGKey(99))
    start = jax.device_get(jparams)
    tr = Trainer(cfg, TrainConfig(dataset="PAM", learning_rate=1e-3, batch_size=B),
                 device="cpu", params=params_from_jax(start, cfg, device="cpu"))
    adam_state_from_jax(tr, *_adam_trees(opt_state))
    key = jax.random.PRNGKey(100)
    jparams, _, jloss, jlogits = jtr._train_step(jparams, opt_state, jb, key)
    loss, logits = tr.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                                 seeds_from_jax_key(key, cfg.nlayers))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    want = dict(flatten_params(jax.device_get(jparams)))
    live = {path for path, _ in tr.live}
    for path, t in flatten_params(tr.params):
        got, ref = t.detach().numpy(), want[path]
        if path not in live:
            np.testing.assert_array_equal(got, ref, err_msg=path)
            continue
        atol = 3e-3 if path.endswith("in_proj_b") else 5e-5
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=path)
        assert not np.array_equal(got, tree_leaf(start, path)), path


def test_the_bridge_carries_every_leaf_both_ways():
    """Every leaf of the sensor-wise long model's tree and of its Adam
    state crosses the bridge and back bit for bit, with the shapes the
    port's init gives."""
    jtr, _, cfg, tree = _trees()
    back = dict(flatten_params(params_to_numpy(params_from_jax(tree, cfg, "cpu"))))
    leaves = dict(flatten_params(tree))
    assert set(back) == set(leaves)
    for path, want in leaves.items():
        np.testing.assert_array_equal(back[path], want, err_msg=path)
    shapes = {p: tuple(t.shape) for p, t in flatten_params(
        raindrop_init(None, cfg, device="meta"))}
    assert shapes == {p: tuple(np.shape(a)) for p, a in leaves.items()}
    jparams = jax.tree.map(jnp.asarray, tree)
    opt_state = jtr.optimizer.init(jparams)
    batch = {k: jnp.asarray(v) for k, v in _step_batch(cfg).items()}
    jparams, opt_state, _, _ = jtr._train_step(jparams, opt_state, batch,
                                               jax.random.PRNGKey(1))
    mu, nu, count = _adam_trees(opt_state)
    tr = Trainer(cfg, TrainConfig(dataset="PAM", batch_size=B), device="cpu",
                 params=params_from_jax(jax.device_get(jparams), cfg, device="cpu"))
    adam_state_from_jax(tr, mu, nu, count)
    mu2, nu2, count2 = adam_state_to_numpy(tr)
    assert count2 == count == 1
    for path, _ in tr.live:
        np.testing.assert_array_equal(tree_leaf(mu2, path), tree_leaf(mu, path),
                                      err_msg=path)
        np.testing.assert_array_equal(tree_leaf(nu2, path), tree_leaf(nu, path),
                                      err_msg=path)


def test_the_server_serves_the_long_sensor_wise_route():
    """InferenceServer at max_len > 1024 with the sensor-wise mask: the
    flash route (flash_mha at hd 170) against the dense one on the same
    parameters, probabilities within 1e-5; padded and chunked buckets."""
    cfg = dataset_config("PAM", **KW)
    params = raindrop_init(0, cfg, device="cpu")
    src, _, times, _ = model_batch(cfg, 5, lengths=np.array([T_LONG, 1, 600, 1031, 77]))
    P, tm = src.transpose(1, 0, 2).copy(), times.T.copy()
    probs = {}
    for backend in ("flash", "dense"):
        c = dataset_config("PAM", **{**KW, "attention_backend": backend})
        server = InferenceServer(c, params, buckets=(2, 4), device="cpu")
        probs[backend] = server.predict(P, tm, None)
        server.close()
    assert probs["flash"].shape == (5, cfg.n_classes)
    assert np.isfinite(probs["flash"]).all()
    np.testing.assert_allclose(probs["flash"].sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs["flash"], probs["dense"], rtol=0, atol=1e-5)
