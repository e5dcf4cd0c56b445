"""raindrop_apply of the port against the JAX eval forward, all four
presets, every encoder backend, on the CPU.

max_len is cut to 40 (the propagation weights grow as max_len^2) and
B = 3 with lengths [T, T-7, 0]. attention_score_dtype is float32, so the
flash and fused-layer rungs are exact f32 on both sides: tolerance 1e-4
on the logits, the same arithmetic summed in another order.
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
    ("cfg", {"use_beta": True}),
    ("cfg", {"sensor_wise_mask": True}),
    ("cfg", {"compute_dtype": "bfloat16"}),
    ("cfg", {"prop_backend": "coo"}),
    ("cfg", {"prop_backend": "pallas"}),
    ("global_adj", {}),
    ("scale_out", {}),
])
def test_refuses_what_this_slice_does_not_serve(change, kw):
    cfg = dataset_config("P19", max_len=8)
    params = raindrop_init(0, cfg, device="cpu")
    src, static, times, lengths = (torch.from_numpy(a) for a in _batch(cfg))
    call = dict()
    if change == "cfg":
        cfg = dataset_config("P19", max_len=8, **kw)
    elif change == "train":
        call["train"] = True
    elif change == "global_adj":
        call["global_adj"] = torch.ones((cfg.d_inp, cfg.d_inp))
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
    with pytest.raises(NotImplementedError):
        raindrop_apply(params, cfg, src, static, times, lengths, **call)
