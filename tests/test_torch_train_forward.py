"""raindrop_apply(train=True) of the port against the JAX train-mode
forward: the four presets narrowed (max_len 37, so the kernels' padded row
count differs from T), each encoder rung forced, shipped dropout 0.2.

The port's DropoutSeeds are read off the JAX key chain
(tests/torch_port_util.seeds_from_jax_key), and both sides draw their
masks from the same counter hash, so the outputs agree to f32 rounding:
tolerance 1e-4 on the logits (the same arithmetic, summed in another
order), attention operands in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.models.raindrop import raindrop_param_mask as jax_param_mask

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply, raindrop_param_mask
from raindrop_tpu_torch.utils.dropout import DropoutSeeds

from tests.torch_port_util import model_batch, seeds_from_jax_key

MAX_LEN = 37


def _setup(preset, **kw):
    kw = dict(max_len=MAX_LEN, attention_score_dtype="float32", **kw)
    jcfg, cfg = jax_dataset_config(preset, **kw), dataset_config(preset, **kw)
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    return jcfg, cfg, tree


def _both(jcfg, cfg, tree, key, B=3):
    src, static, times, lengths = model_batch(cfg, B)
    logits, dist = raindrop_apply(
        params_from_jax(tree, cfg, device="cpu"), cfg, torch.from_numpy(src),
        None if static is None else torch.from_numpy(static),
        torch.from_numpy(times), torch.from_numpy(lengths), train=True,
        seeds=seeds_from_jax_key(key, cfg.nlayers))
    jlogits, jdist = jax_raindrop_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(src),
        None if static is None else jnp.asarray(static), jnp.asarray(times),
        jnp.asarray(lengths), train=True, rng=key)
    return logits, dist, np.asarray(jlogits), float(jdist)


@pytest.mark.parametrize("backend", ["dense", "flash", "fused_layer"])
@pytest.mark.parametrize("preset", ["P19", "P12", "eICU", "PAM"])
def test_train_forward_matches_jax(preset, backend):
    jcfg, cfg, tree = _setup(preset, attention_backend=backend)
    logits, dist, jlogits, jdist = _both(jcfg, cfg, tree, jax.random.PRNGKey(11))
    assert logits.shape == (3, cfg.n_classes) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(dist), jdist, atol=1e-6)


def test_train_forward_with_propagation_dropout_matches_jax():
    """prop_dropout > 0 takes the non-uniform branch (softmax over sources,
    dropout on the weights, rescale) even on the all-ones graph."""
    jcfg, cfg, tree = _setup("P19", attention_backend="dense", prop_dropout=0.3)
    logits, dist, jlogits, jdist = _both(jcfg, cfg, tree, jax.random.PRNGKey(4))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(dist), jdist, atol=1e-6)
    cfg0 = dataset_config("P19", max_len=MAX_LEN, attention_backend="dense",
                          attention_score_dtype="float32")
    src, static, times, lengths = (torch.from_numpy(a) for a in model_batch(cfg, 3))
    seeds = seeds_from_jax_key(jax.random.PRNGKey(4), cfg.nlayers)
    base, _ = raindrop_apply(params_from_jax(tree, cfg, device="cpu"), cfg0, src,
                             static, times, lengths, train=True, seeds=seeds)
    assert not torch.allclose(base, logits)


def test_train_mode_differs_from_eval_and_needs_seeds():
    _, cfg, tree = _setup("P19", attention_backend="dense")
    params = params_from_jax(tree, cfg, device="cpu")
    src, static, times, lengths = (torch.from_numpy(a) for a in model_batch(cfg, 3))
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(0), cfg.nlayers)
    ev, _ = raindrop_apply(params, cfg, src, static, times, lengths)
    tr1, _ = raindrop_apply(params, cfg, src, static, times, lengths, train=True,
                            seeds=seeds)
    tr2, _ = raindrop_apply(params, cfg, src, static, times, lengths, train=True,
                            seeds=seeds)
    assert torch.equal(tr1, tr2) and not torch.allclose(tr1, ev)
    # eval ignores seeds
    ev2, _ = raindrop_apply(params, cfg, src, static, times, lengths, seeds=seeds)
    assert torch.equal(ev, ev2)
    with pytest.raises(ValueError, match="seeds"):
        raindrop_apply(params, cfg, src, static, times, lengths, train=True)


@pytest.mark.parametrize("preset", ["P19", "PAM"])
def test_param_mask_equals_jax(preset):
    jmask = jax_param_mask(jax_dataset_config(preset, max_len=8))
    mask = raindrop_param_mask(dataset_config(preset, max_len=8))
    assert mask == jmask
    assert mask["encoder"] == {"w": False, "b": False}
    assert mask["ob_propagation"]["lin_value"] == {"w": True, "b": True}
    assert not mask["ob_propagation"]["increase_dim"]["w"]
