"""The T > 1024 route of the port against JAX on the CPU: the encoder
ladder, `raindrop_apply` (eval and train mode, the same dropout masks) and
one trainer step, with `attention_backend='flash'`, which sends both
packages through their split-head `flash_mha` (the JAX side in its
streaming regime, Pallas in interpret mode).

The model is narrow, 4 sensors with d_ob = 1 at max_len = 1032, because
each propagation layer holds 13 matrices of (max_len * d_ob)^2 parameters.
attention_score_dtype is float32, so both sides compute exact f32:
tolerance 1e-4 on the logits and 1e-5 relative on the loss (the same
arithmetic summed in another order); the parameters after the step are
held as tests/test_torch_trainer.py holds them and says why.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import TrainConfig as JaxTrainConfig
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.ops.flash_attention import MAX_FUSED_T as JAX_MAX_FUSED_T
from raindrop_tpu.train.trainer import Trainer as JaxTrainer

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply
from raindrop_tpu_torch.nn import transformer as tr_mod
from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.train.trainer import Trainer, flatten_params

from tests.torch_port_util import model_batch, seeds_from_jax_key

T_LONG, B = 1032, 3
KW = dict(max_len=T_LONG, d_inp=4, d_ob=1, d_pe=12, nhid=12,
          attention_backend="flash", attention_score_dtype="float32")


@pytest.mark.parametrize("backend,T,on_cuda,want", [
    ("auto", 2048, True, "flash_mha"), ("auto", 1025, True, "flash_mha"),
    ("auto", 1024, True, "fused_layer"), ("auto", 215, True, "flash"),
    ("auto", 60, True, "dense"), ("auto", 2048, False, "dense"),
    ("flash", 2048, False, "flash_mha"), ("flash", 1024, False, "flash"),
    ("dense", 2048, True, "dense")])
def test_ladder_takes_flash_mha_beyond_the_packed_kernel(backend, T, on_cuda, want):
    """The JAX ladder on its accelerator: flash at every T >= 128 that the
    fused layer does not take, split-head beyond MAX_FUSED_T."""
    assert fa.MAX_FUSED_T == JAX_MAX_FUSED_T
    assert tr_mod.encoder_rung(backend, T, 84, 2, on_cuda) == want


def test_fused_layer_beyond_its_length_raises_as_in_jax():
    x = torch.zeros((1, 1032, 8))
    p = tr_mod._layer_init(torch.Generator().manual_seed(0), 8, 16, "cpu")
    with pytest.raises(ValueError, match="T <= 1024"):
        tr_mod.transformer_encoder_layer_apply(p, x, None, 2, backend="fused_layer")


def _trees(seed=2):
    jcfg, cfg = jax_dataset_config("PAM", **KW), dataset_config("PAM", **KW)
    assert cfg.d_transformer == 16 and fa.pad8(cfg.max_len) > fa.MAX_FUSED_T
    jtr = JaxTrainer(jcfg, JaxTrainConfig(dataset="PAM", learning_rate=1e-3,
                                          batch_size=B))
    tree = jax.device_get(jtr._init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(3)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    return jtr, jcfg, cfg, tree


@pytest.mark.parametrize("train", [False, True])
def test_raindrop_apply_on_the_long_route_matches_jax(train, monkeypatch):
    _, jcfg, cfg, tree = _trees()
    calls = []
    real = tr_mod.flash_mha
    monkeypatch.setattr(tr_mod, "flash_mha",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    src, static, times, lengths = model_batch(cfg, B)
    key = jax.random.PRNGKey(13)
    logits, dist = raindrop_apply(
        params_from_jax(tree, cfg, device="cpu"), cfg, torch.from_numpy(src), None,
        torch.from_numpy(times), torch.from_numpy(lengths), train=train,
        seeds=seeds_from_jax_key(key, cfg.nlayers))
    jlogits, jdist = jax_raindrop_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(src), None,
        jnp.asarray(times), jnp.asarray(lengths), train=train, rng=key)
    assert calls == [(B, 2, T_LONG, 8)] * cfg.nlayers
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(dist), float(jdist), atol=1e-6)


def test_one_trainer_step_on_the_long_route_matches_jax():
    jtr, jcfg, cfg, tree = _trees()
    tr = Trainer(cfg, TrainConfig(dataset="PAM", learning_rate=1e-3, batch_size=B),
                 device="cpu", params=params_from_jax(tree, cfg, device="cpu"))
    src, _, times, _ = model_batch(cfg, B, lengths=np.array([T_LONG, 1030, 517]))
    y = np.array([0, 5, 2], np.int32)
    batch = {"P": src.transpose(1, 0, 2).copy(), "time": times.T.copy(), "y": y}
    key = jax.random.PRNGKey(100)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams, _, jloss, jlogits = jtr._train_step(
        jparams, jtr.optimizer.init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    loss, logits = tr.train_step(
        {k: torch.from_numpy(v) for k, v in batch.items()},
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
        # one Adam step moves every live parameter by lr whatever its
        # gradient's size; the key bias's true gradient is zero
        atol = 3e-3 if path.endswith("in_proj_b") else 5e-5
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=path)
        assert not np.array_equal(got, tree_leaf(tree, path)), path


def tree_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_the_server_serves_the_long_route():
    """InferenceServer at max_len > 1024: the flash route against the
    dense one on the same parameters, probabilities within 1e-5."""
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer

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
