"""The sensor-wise mask (`sensor_wise_mask=True`) in the port against the
JAX package, on the CPU: the per-sensor pool, the packed attention and the
fused encoder layer at the head dims it gives (140, 170 and 360; the
encoder runs at d_inp * (d_ob + d_pe) with 2 heads), the whole model on
each rung of the encoder ladder, three trainer steps and an epoch, the
parameter and optimizer bridge and the server.

The JAX kernels run in Pallas interpret mode, as the JAX package's own
tests run them off the TPU; the port's wrappers run their plain versions
(a CPU tensor never reaches CUDA). Tolerances, as in the narrower tests of
each module: the pool 1e-6 (one sum in another order); the packed
attention 2e-5 in f32 and 2e-2 with bf16 operands (8-bit mantissas); the
fused layer 2e-5 in f32 relative to max(1, |gradient|) and 2e-2 in bf16;
the model's logits 1e-4 (attention_score_dtype float32, so every rung is
f32 on both sides); the trainer's steps as their docstring says.
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
from raindrop_tpu.nn import aggregate as jagg
from raindrop_tpu.ops import flash_attention as jfa
from raindrop_tpu.ops import fused_encoder as jfe
from raindrop_tpu.serve import InferenceServer as JaxInferenceServer

from raindrop_tpu_torch.bridge import (
    adam_state_from_jax, adam_state_to_numpy, params_from_jax, params_to_numpy)
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.models.raindrop import (
    raindrop_apply, raindrop_init, raindrop_param_mask)
from raindrop_tpu_torch.nn.aggregate import sensor_wise_pool
from raindrop_tpu_torch.nn.transformer import encoder_rung
from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.serve import InferenceServer
from raindrop_tpu_torch.train.trainer import flatten_params

from tests.test_torch_model import _batch
from tests.test_torch_trainer import (
    _adam_trees, _batch_np, _setup, _split, _three_steps, _torch_batch)
from tests.torch_port_util import random_layer, seeds_from_jax_key, to_torch

SW = {"sensor_wise_mask": True}
MAX_LEN = 16
SEED = 31337
# the rung the ladder takes for each preset at its full max_len on the card
# (T >= 384 and T <= 1024: the fused layer; T >= 128: flash; below: dense)
RUNGS = {"P19": "dense", "P12": "flash", "eICU": "flash", "PAM": "fused_layer"}


def _cfgs(preset, **kw):
    kw = {**SW, "max_len": MAX_LEN, "attention_score_dtype": "float32", **kw}
    return jax_dataset_config(preset, **kw), dataset_config(preset, **kw)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _assert_within_half_a_step(tr, jparams):
    """Every parameter within lr / 2 of the JAX trainer's after a step from
    one state: an element whose gradient had the other sign would be about
    2 lr away."""
    want = dict(flatten_params(jax.device_get(jparams)))
    for path, t in flatten_params(tr.params):
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=0,
                                   atol=tr.learning_rate / 2, err_msg=path)


@pytest.mark.parametrize("seed", [0, 1])
def test_sensor_wise_pool_matches_jax(seed):
    """Including the reference's quirk: the sum weights the unobserved
    steps, the denominator counts the observed ones plus 1."""
    rng = np.random.default_rng(seed)
    r_out = rng.normal(size=(3, 11, 5, 20)).astype(np.float32)
    observed = (rng.uniform(size=(3, 11, 5)) > 0.4).astype(np.float32)
    observed[1] = 0.0                      # a sample with nothing observed
    got = sensor_wise_pool(torch.from_numpy(r_out), torch.from_numpy(observed))
    want = jagg.sensor_wise_pool(jnp.asarray(r_out), jnp.asarray(observed))
    assert got.shape == (3, 5 * 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T", [13, 24])
@pytest.mark.parametrize("hd", [140, 170, 360])
def test_packed_attention_matches_jax_at_wide_heads(hd, T, cd, rate):
    """flash_mha_packed forward and backward at the sensor-wise head dims,
    B = 3 with a length-0 sample (exact zeros), against jax.vjp."""
    rng = np.random.default_rng(hd + T)
    q, k, v, g = (rng.normal(size=(3, T, 2 * hd)).astype(np.float32)
                  for _ in range(4))
    lengths = np.array([T, T - 5, 0], np.int32)
    fn = lambda q, k, v: jfa.flash_mha_packed(  # noqa: E731
        q, k, v, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, cd, 2)
    jo, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_mha_packed(tq, tk, tv, torch.from_numpy(lengths), SEED, rate, cd, 2)
    o.backward(torch.from_numpy(g))
    tol = 2e-5 if cd is None else 2e-2
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=tol)
    assert (o[2] == 0).all()
    for t, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0, atol=tol)
        assert (t.grad[2] == 0).all()


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T", [13, 24])
def test_fused_layer_matches_jax_at_pam_sensor_wise_width(T, cd):
    """The fused encoder layer at PAM's sensor-wise width (d = 340, ffn =
    136, 2 heads of 170) with dropout 0.2 at all four sites: out, dx and
    the 12 weight gradients against jax.vjp."""
    d, ffn, rate = 340, 136, 0.2
    p = random_layer(T, d, ffn)
    rng = np.random.default_rng(T)
    x, g = (rng.normal(size=(3, T, d)).astype(np.float32) for _ in range(2))
    lengths = np.array([T, T - 5, 0], np.int32)
    fn = lambda p, x: jfe.fused_encoder_layer(  # noqa: E731
        p, x, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, cd, 2)
    jout, vjp = jax.vjp(fn, p, jnp.asarray(x))
    jdp, jdx = vjp(jnp.asarray(g))
    tp = to_torch(p, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = fe.fused_encoder_layer(tp, tx, torch.from_numpy(lengths), SEED, rate, cd, 2)
    out.backward(torch.from_numpy(g))
    tol = 2e-5 if cd is None else 2e-2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=tol)

    def close(name, got, want):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max())
        assert np.isfinite(want).all() and err <= tol, (name, err)

    close("dx", tx.grad, jdx)
    for path in fe._WEIGHTS:
        close("/".join(path), _leaf(tp, path).grad, _leaf(jdp, path))


@pytest.mark.parametrize("preset", list(RUNGS))
def test_sensor_wise_widths_and_rungs(preset):
    cfg = dataset_config(preset, **SW)
    assert cfg.d_transformer == cfg.d_inp * (cfg.d_ob + cfg.d_pe)
    assert cfg.d_final == cfg.d_transformer + (cfg.d_inp if cfg.static else 0)
    assert encoder_rung(cfg.attention_backend, cfg.max_len, cfg.d_transformer,
                        cfg.nhead, True) == RUNGS[preset]
    assert encoder_rung(cfg.attention_backend, cfg.max_len, cfg.d_transformer,
                        cfg.nhead, False) == "dense"


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("preset", list(RUNGS))
def test_forward_on_each_rung_matches_jax(preset, train):
    """The whole model at max_len 16 with the preset's rung forced (the
    ladder picks it by T on the card): eval, and train with dropout 0.2 and
    the JAX key's masks."""
    jcfg, cfg = _cfgs(preset, attention_backend=RUNGS[preset])
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    params = params_from_jax(tree, cfg, device="cpu")
    src, static, times, lengths = _batch(cfg)
    key = jax.random.PRNGKey(17)
    logits, dist = raindrop_apply(
        params, cfg, torch.from_numpy(src),
        None if static is None else torch.from_numpy(static),
        torch.from_numpy(times), torch.from_numpy(lengths), train=train,
        seeds=seeds_from_jax_key(key, cfg.nlayers) if train else None)
    jlogits, jdist = jax_raindrop_apply(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(src),
        None if static is None else jnp.asarray(static), jnp.asarray(times),
        jnp.asarray(lengths), train=train, rng=key)
    assert logits.shape == (3, cfg.n_classes) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(dist), float(jdist), atol=1e-6)


# the learning rate of the free-running steps: tests/test_torch_trainer.py's
# 1e-3 drives the sensor-wise model's loss from below 3 to above 7 within
# three steps on the JAX side too (test_jax_alone_parts_at_lr_1e_3)
FREE_LR = 1e-5


@pytest.mark.parametrize("preset", list(RUNGS))
def test_three_steps_match_the_jax_trainer(preset):
    """Three free-running masked-Adam steps (dropout 0.2, the preset's
    rung) held to the bounds of tests/test_torch_trainer.py, unchanged:
    loss 1e-5 relative, logits 1e-4 + 1e-5, parameters 5e-5 absolute with
    at most 0.01% of a tensor's elements past 2e-6 + 1e-4 relative, the
    key bias 3 lr; live parameters changed, dead ones untouched. At lr
    FREE_LR: at that file's 1e-3 the model diverges within three steps and
    JAX parts from itself past these bounds (test_jax_alone_parts_at_lr_1e_3);
    test_each_step_from_the_jax_state_matches holds the steps at 1e-3."""
    _three_steps(preset, 0.2, FREE_LR, attention_backend=RUNGS[preset], **SW)


@pytest.mark.parametrize("preset", ["P19", "P12"])
def test_jax_alone_parts_at_lr_1e_3(preset):
    """The witness for FREE_LR: the JAX trainer against itself with every
    starting parameter one ulp up, three free-running steps at lr 1e-3.
    Its loss rises past 7 (from below 1), and its parameters part past
    the 5e-5 that tests/test_torch_trainer.py allows between the port and
    JAX, so no port can be held there at these widths."""
    jtr, jparams, _, cfg = _setup(preset, 0.2, attention_backend=RUNGS[preset], **SW)
    nudged = jax.tree.map(lambda x: jnp.nextafter(x, jnp.inf), jparams)
    split = _split(cfg, 24)
    states = [jtr.optimizer.init(jparams), jtr.optimizer.init(nudged)]
    rng = np.random.default_rng(5)
    for step in range(3):
        b = {k: jnp.asarray(v)
             for k, v in _batch_np(split, rng.permutation(24)[:6]).items()}
        key = jax.random.PRNGKey(100 + step)
        jparams, states[0], loss, _ = jtr._train_step(jparams, states[0], b, key)
        nudged, states[1], _, _ = jtr._train_step(nudged, states[1], b, key)
        if step == 0:
            first = float(loss)
    assert first < 1.0 < 7.0 < float(loss), (first, float(loss))
    parted = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(jparams), jax.tree.leaves(nudged)))
    assert parted > 5e-5, parted


@pytest.mark.parametrize("preset", list(RUNGS))
def test_each_step_from_the_jax_state_matches(preset):
    """Three masked-Adam steps at lr 1e-3 (dropout 0.2, the preset's rung),
    each from the JAX trainer's parameters and Adam state carried across
    the bridge, so that every step starts from one state: loss 1e-5
    relative and logits 1e-4 + 1e-5 as in tests/test_torch_trainer.py; the
    Adam moments, which carry the gradient, 1e-5 of each tensor's largest
    value; every parameter within half a step (lr / 2) of JAX's, so none
    moved the other way; live parameters changed, dead ones untouched."""
    jtr, jparams, tr, cfg = _setup(preset, 0.2, attention_backend=RUNGS[preset], **SW)
    split = _split(cfg, 24)
    before = dict(flatten_params(params_to_numpy(tr.params)))
    opt_state = jtr.optimizer.init(jparams)
    rng = np.random.default_rng(5)
    for step in range(3):
        if step:
            tr.set_params(params_from_jax(jax.device_get(jparams), cfg, device="cpu"))
            adam_state_from_jax(tr, *_adam_trees(opt_state))
        idx = rng.permutation(24)[:6]
        key = jax.random.PRNGKey(100 + step)
        b = _batch_np(split, idx)
        jparams, opt_state, jloss, jlogits = jtr._train_step(
            jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        loss, logits = tr.train_step(_torch_batch(b),
                                     seeds_from_jax_key(key, cfg.nlayers, rows=6))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-5)
        mu, nu, count = _adam_trees(opt_state)
        mu2, nu2, count2 = adam_state_to_numpy(tr)
        assert count2 == count == step + 1
        for path, _ in tr.live:
            keys = path.split("/")
            for got, want in ((_leaf(mu2, keys), _leaf(mu, keys)),
                              (_leaf(nu2, keys), _leaf(nu, keys))):
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-5 * np.abs(want).max(),
                                           err_msg=path)
        _assert_within_half_a_step(tr, jparams)
    live = {path for path, _ in tr.live}
    for path, t in flatten_params(tr.params):
        same = np.array_equal(t.detach().numpy(), before[path])
        assert same != (path in live), path


@pytest.mark.parametrize("preset", ["P12", "PAM"])
def test_epoch_loop_equals_its_steps(preset):
    """Trainer.train_epoch at the sensor-wise widths: the losses of an
    epoch of 3 steps equal 3 train_step calls on the same seed stream, bit
    for bit, and every loss is finite."""
    _, _, tr1, cfg = _setup(preset, 0.2, attention_backend=RUNGS[preset], **SW)
    tr2 = _setup(preset, 0.2, attention_backend=RUNGS[preset], **SW)[2]
    split = _split(cfg, 18)
    data = _torch_batch(split if split["static"] is not None
                        else {k: v for k, v in split.items() if v is not None})
    idx = torch.from_numpy(np.stack([np.random.default_rng(s).permutation(18)[:6]
                                     for s in range(3)]))
    losses, _ = tr1.train_epoch(data, idx)
    singles = [tr2.train_step({k: v[idx[i]] for k, v in data.items()})[0]
               for i in range(3)]
    assert torch.isfinite(losses).all()
    assert torch.equal(losses, torch.stack(singles))


@pytest.mark.parametrize("preset", list(RUNGS))
def test_bridge_round_trip_at_sensor_wise_widths(preset):
    """The parameter tree, its mask of live parameters and the Adam state
    cross the bridge at the sensor-wise widths: two JAX steps, the state
    into the port's trainer, out again bit for bit, and a third step on
    both sides that agrees."""
    jtr, jparams, tr, cfg = _setup(preset, 0.0, **SW)
    tree = jax.device_get(jparams)
    back = dict(flatten_params(params_to_numpy(params_from_jax(tree, cfg, "cpu"))))
    for path, want in flatten_params(tree):
        np.testing.assert_array_equal(back[path], want, err_msg=path)
    jmask = dict(flatten_params(jax_param_mask(jax_dataset_config(
        preset, **SW, max_len=MAX_LEN))))
    assert dict(flatten_params(raindrop_param_mask(cfg))) == jmask
    shapes = {p: tuple(t.shape) for p, t in flatten_params(
        raindrop_init(None, cfg, device="meta"))}
    assert shapes == {p: tuple(np.shape(a)) for p, a in flatten_params(tree)}

    split = _split(cfg, 12)
    b = _batch_np(split, np.arange(6))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    opt_state = jtr.optimizer.init(jparams)
    for s in range(2):
        jparams, opt_state, _, _ = jtr._train_step(jparams, opt_state, jb,
                                                   jax.random.PRNGKey(s))
    mu, nu, count = _adam_trees(opt_state)
    tr.set_params(params_from_jax(jax.device_get(jparams), cfg, device="cpu"))
    adam_state_from_jax(tr, mu, nu, count)
    mu2, _, count2 = adam_state_to_numpy(tr)
    assert count2 == count == 2
    for path, _ in tr.live:
        np.testing.assert_array_equal(_leaf(mu2, path.split("/")),
                                      _leaf(mu, path.split("/")), err_msg=path)
    jparams, opt_state, jloss, _ = jtr._train_step(jparams, opt_state, jb,
                                                   jax.random.PRNGKey(2))
    loss, _ = tr.train_step(_torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_within_half_a_step(tr, jparams)


@pytest.mark.parametrize("preset", list(RUNGS))
def test_server_matches_the_jax_server(preset):
    """InferenceServer with a sensor-wise config (buckets 2 and 4, 5 rows:
    padded and chunked) against the JAX InferenceServer on the same
    parameters, and submit against predict."""
    jcfg, cfg = _cfgs(preset)
    jparams = jax_raindrop_init(jax.random.PRNGKey(4), jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    split = _split(cfg, 5, seed=9)
    server = InferenceServer(cfg, params, buckets=(2, 4), device="cpu")
    jserver = JaxInferenceServer(jcfg, jparams, buckets=(2, 4))
    try:
        got = server.predict(split["P"], split["time"], split["static"])
        want = jserver.predict(split["P"], split["time"], split["static"])
        assert got.shape == (5, cfg.n_classes)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
        sub = server.submit(split["P"][:3], split["time"][:3],
                            None if split["static"] is None else split["static"][:3],
                            timeout=120)
        np.testing.assert_allclose(sub, got[:3], rtol=1e-6, atol=1e-6)
    finally:
        server.close()
        jserver.close()
