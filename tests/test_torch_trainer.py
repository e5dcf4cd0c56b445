"""The port's Trainer against the JAX Trainer on the CPU: three optimizer
steps from the same (bridged) parameters, batches and dropout masks.

The JAX side runs its jitted `_train_step` (optax masked Adam); the port's
DropoutSeeds are read off the same keys. Tolerances: losses 1e-5
relative; parameters after three steps 2e-6 absolute plus 1e-4 relative
at lr 1e-3 (Adam's first steps move every live parameter by about lr
whatever the gradient's size, so a last-bit difference in a tiny gradient
can show as a few 1e-7 of parameter). The key bias of the attention (the
middle third of in_proj_b) is held only to 3 * lr: its true gradient is
zero (a softmax does not see a shift of its keys), so what Adam normalises
there is rounding noise, which differs between the two frameworks. For
the same reason a stray element with a gradient near zero may miss the
tight bound: at most 0.01% of a tensor's elements may, and none by more
than 5e-5 (a twentieth of one lr-sized step).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raindrop_tpu.config import TrainConfig as JaxTrainConfig
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.data import sampler as jsampler
from raindrop_tpu.train.trainer import Trainer as JaxTrainer

from raindrop_tpu_torch.bridge import (
    adam_state_from_jax, adam_state_to_numpy, params_from_jax, params_to_numpy)
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.data import sampler
from raindrop_tpu_torch.train.trainer import Trainer, flatten_params

from tests.torch_port_util import model_batch, seeds_from_jax_key

MAX_LEN, B, LR = 16, 6, 1e-3


def _split(cfg, n, seed=0):
    """A batch-major synthetic split as numpy arrays."""
    lengths = np.random.default_rng(seed).integers(1, cfg.max_len + 1, size=n)
    src, static, times, _ = model_batch(cfg, n, seed, lengths=lengths)
    y = np.random.default_rng(seed + 1).integers(0, cfg.n_classes, size=n)
    return dict(P=src.transpose(1, 0, 2).copy(), time=times.T.copy(),
                static=static, y=y.astype(np.int32))


def _batch_np(split, idx):
    return {k: v[idx] for k, v in split.items() if v is not None}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _adam_trees(opt_state):
    """(mu, nu, count) of the JAX trainer's optimizer state as numpy, dead
    leaves (optax MaskedNode) as None."""
    adam = opt_state.inner_state.inner_state[0]
    is_masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    conv = lambda t: jax.tree.map(  # noqa: E731
        lambda x: None if is_masked(x) else np.asarray(x), t, is_leaf=is_masked)
    return conv(adam.mu), conv(adam.nu), int(adam.count)


def _assert_params_close(tr, want, lr=LR):
    for path, t in flatten_params(tr.params):
        got, ref = t.detach().numpy(), want[path]
        if path.endswith("in_proj_b"):
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d:2 * d], ref[d:2 * d], rtol=0,
                                       atol=3 * lr, err_msg=path)
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5, err_msg=path)
        off = np.abs(got - ref) > 2e-6 + 1e-4 * np.abs(ref)
        assert off.mean() <= 1e-4, (path, int(off.sum()), off.size)


def _setup(preset, dropout, lr=LR, **cfg_kw):
    kw = dict(max_len=MAX_LEN, dropout=dropout, attention_score_dtype="float32",
              **cfg_kw)
    jcfg, cfg = jax_dataset_config(preset, **kw), dataset_config(preset, **kw)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(dataset=preset, learning_rate=lr,
                                          batch_size=B))
    jparams = jtr._init(jax.random.PRNGKey(0))
    tree = jax.device_get(jparams)
    tr = Trainer(cfg, TrainConfig(dataset=preset, learning_rate=lr, batch_size=B),
                 device="cpu", params=params_from_jax(tree, cfg, device="cpu"))
    return jtr, jparams, tr, cfg


@pytest.mark.parametrize("preset,dropout,backend", [
    ("P19", 0.0, "auto"), ("P19", 0.2, "auto"), ("PAM", 0.2, "auto"),
    ("P12", 0.2, "flash"), ("PAM", 0.2, "fused_layer")])
def test_three_steps_match_the_jax_trainer(preset, dropout, backend):
    _three_steps(preset, dropout, attention_backend=backend)


@pytest.mark.parametrize("prop_backend,prop_dropout", [
    ("pallas", 0.0), ("pallas", 0.1), ("coo", 0.1)])
def test_three_steps_with_a_graph_backend_match_the_jax_trainer(prop_backend,
                                                                prop_dropout):
    """prop_backend='pallas': the SpMM wrapper forward and backward (its
    plain version here); with prop_dropout > 0 a training step falls
    through to the dense branch, as in the JAX package. 'coo' with
    prop_dropout drops softmax weights with one seed per sample."""
    from raindrop_tpu_torch.ops.sparse import spmm_segment_softmax

    _three_steps("P19", 0.2, prop_backend=prop_backend, prop_dropout=prop_dropout)
    # on the CPU the wrapper runs its plain version: nothing was launched
    assert spmm_segment_softmax.launches == spmm_segment_softmax.bwd_launches == 0


def _three_steps(preset, dropout, lr=LR, **cfg_kw):
    jtr, jparams, tr, cfg = _setup(preset, dropout, lr, **cfg_kw)
    split = _split(cfg, 24)
    start = params_to_numpy(tr.params)
    opt_state = jtr.optimizer.init(jparams)
    rng = np.random.default_rng(5)
    for step in range(3):
        idx = rng.permutation(24)[:B]
        key = jax.random.PRNGKey(100 + step)
        b = _batch_np(split, idx)
        jparams, opt_state, jloss, jlogits = jtr._train_step(
            jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        loss, logits = tr.train_step(_torch_batch(b),
                                     seeds_from_jax_key(key, cfg.nlayers, rows=B))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-5)
    want = dict(flatten_params(jax.device_get(jparams)))
    before = dict(flatten_params(start))
    live = {path for path, _ in tr.live}
    _assert_params_close(tr, want, lr)
    for path, t in flatten_params(tr.params):
        got = t.detach().numpy()
        if path in live:
            assert not np.array_equal(got, before[path]), path
        else:
            np.testing.assert_array_equal(got, before[path], err_msg=path)


def test_the_trainer_draws_per_sample_seeds_only_for_the_coo_branch():
    _, _, tr, cfg = _setup("P19", 0.2, prop_backend="coo", prop_dropout=0.1)
    seeds = tr.draw_seeds(B)
    assert len(seeds.prop1_rows) == len(seeds.prop2_rows) == B
    batch = _torch_batch(_batch_np(_split(cfg, 12), np.arange(B)))
    loss, _ = tr.train_step(batch)            # draws its own, one per sample
    assert torch.isfinite(loss)
    for kw in (dict(prop_backend="pallas", prop_dropout=0.1),
               dict(prop_backend="coo"), {}):
        _, _, other, _ = _setup("P19", 0.2, **kw)
        assert other.draw_seeds(B).prop1_rows == ()


def test_dead_parameters_are_untouched_and_stateless():
    _, _, tr, cfg = _setup("P12", 0.2)
    dead_ptrs = [t.data_ptr() for _, t in tr.dead]
    dead_vals = [t.clone() for _, t in tr.dead]
    split = _split(cfg, 12)
    for _ in range(2):
        tr.train_step(_torch_batch(_batch_np(split, np.arange(B))))
    assert {p for p, _ in tr.dead} >= {"encoder/w", "ob_propagation/lin_key/w",
                                       "ob_propagation_layer2/increase_dim/w"}
    for (path, t), ptr, val in zip(tr.dead, dead_ptrs, dead_vals):
        assert t.data_ptr() == ptr and torch.equal(t, val), path
        assert t.grad is None and not t.requires_grad, path
        assert t not in tr.optimizer.state, path
    assert len(tr.optimizer.state) == len(tr.live)
    assert all(t.grad is not None for _, t in tr.live)


def test_grad_microbatches_two_equals_one():
    _, _, tr1, cfg = _setup("P19", 0.0)
    tr2 = Trainer(cfg, dataclasses.replace(tr1.tcfg, grad_microbatches=2),
                  device="cpu", params=tr1.params)
    batch = _torch_batch(_batch_np(_split(cfg, 12), np.arange(B)))
    l1, lg1 = tr1.train_step(batch)
    l2, lg2 = tr2.train_step(batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    np.testing.assert_allclose(lg2.numpy(), lg1.numpy(), rtol=1e-4, atol=1e-5)
    for (path, a), (_, b) in zip(flatten_params(tr2.params),
                                 flatten_params(tr1.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=path)
    tr3 = Trainer(cfg, dataclasses.replace(tr1.tcfg, grad_microbatches=4),
                  device="cpu", params=tr1.params)
    with pytest.raises(ValueError, match="not divisible"):
        tr3.train_step(batch)


def test_epoch_loop_equals_the_steps_and_lr_is_rewritable():
    _, _, tr1, cfg = _setup("P12", 0.2)
    tr2 = Trainer(cfg, tr1.tcfg, device="cpu", params=tr1.params)
    split = _split(cfg, 24)
    data = _torch_batch({k: v for k, v in split.items()})
    idx = torch.from_numpy(np.stack([np.random.default_rng(s).permutation(24)[:B]
                                     for s in range(4)]))
    tr1.learning_rate = tr2.learning_rate = 5e-4
    assert tr2.optimizer.param_groups[0]["lr"] == 5e-4
    losses, logits = tr1.train_epoch(data, idx)
    assert losses.shape == (4,) and losses.device.type == "cpu"
    assert torch.isfinite(losses).all() and logits.shape == (B, cfg.n_classes)
    # the same seed stream, step by step
    singles = [tr2.train_step({k: v[idx[k_]] for k, v in data.items()})[0]
               for k_ in range(4)]
    assert torch.equal(losses, torch.stack(singles))


def test_padded_tail_predict_matches_jax():
    jtr, jparams, tr, cfg = _setup("P12", 0.2)
    split = _split(cfg, 11)
    want = jtr.predict(jparams, split["P"], split["time"], split["static"],
                       batch_size=4)
    got = tr.predict(None, split["P"], split["time"], split["static"], batch_size=4)
    assert got.shape == (11, cfg.n_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, tr.predict(tr.params, split["P"], split["time"], split["static"],
                        batch_size=100), rtol=1e-5, atol=1e-6)


def test_adam_state_round_trip_through_the_bridge():
    """Two JAX steps, then the optimizer state crosses the bridge and both
    trainers take a third step from it."""
    jtr, jparams, tr, cfg = _setup("P19", 0.0)
    split = _split(cfg, 12)
    b = _batch_np(split, np.arange(B))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    opt_state = jtr.optimizer.init(jparams)
    for s in range(2):
        jparams, opt_state, _, _ = jtr._train_step(jparams, opt_state, jb,
                                                   jax.random.PRNGKey(s))
    mu, nu, count = _adam_trees(opt_state)
    tr.set_params(params_from_jax(jax.device_get(jparams), cfg, device="cpu"))
    adam_state_from_jax(tr, mu, nu, count)
    mu2, nu2, count2 = adam_state_to_numpy(tr)
    assert count2 == count == 2
    for path, _ in tr.live:
        keys = path.split("/")
        a, c = mu, mu2
        for k in keys:
            a, c = a[k], c[k]
        np.testing.assert_array_equal(a, c, err_msg=path)
    assert "encoder" not in mu2
    jparams, opt_state, jloss, _ = jtr._train_step(jparams, opt_state, jb,
                                                   jax.random.PRNGKey(2))
    loss, _ = tr.train_step(_torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(flatten_params(jax.device_get(jparams)))
    _assert_params_close(tr, want)
    with pytest.raises(ValueError, match="shapes"):
        adam_state_from_jax(tr, {**mu, "R_u": np.zeros((2, 2))}, nu, 1)


def test_sampler_copy_draws_the_same_batches():
    y = np.random.default_rng(0).integers(0, 2, size=200)
    for strategy in (1, 2, 3):
        assert (sampler.n_batches_per_epoch(y, 16, strategy)
                == jsampler.n_batches_per_epoch(y, 16, strategy))
        got = list(sampler.balanced_batches(y, 16, strategy, np.random.default_rng(3)))
        want = list(jsampler.balanced_batches(y, 16, strategy, np.random.default_rng(3)))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_what_the_protocol_slice_brings_raises():
    # train_split and run_splits are served (tests/test_torch_protocol.py
    # holds them against JAX), and so are measure_mfu and the streaming
    # pipeline (tests/test_torch_diagnostics.py, test_torch_prefetch.py),
    # and the scale-out routes (tests/test_torch_scale_out_routes.py): a
    # route needs a mesh and the flagship model, as in the JAX trainer
    assert not hasattr(Trainer, "run_splits")       # module-level, as in JAX
    TrainConfig(measure_mfu=True, input_pipeline="streaming")
    cfg = dataset_config("P19", max_len=8)
    for kw in ({"context_parallel": "ring"}, {"pipeline_microbatches": 2},
               {"edge_partition": True}):
        with pytest.raises(ValueError, match="need a mesh"):
            Trainer(cfg, TrainConfig(**kw), device="cpu")
        with pytest.raises(ValueError, match="flagship"):
            Trainer(cfg, TrainConfig(**kw), device="cpu", mesh=object(),
                    apply_fn=lambda *a: None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(dataset_config("P19", max_len=8), TrainConfig())


def test_a_dropped_trainer_frees_its_parameters_without_the_cyclic_collector():
    """A Trainer is in no reference cycle, so its parameters (7 GB at PAM's
    width on a 2048-step window) go when the last reference does, not when
    the cyclic collector next runs: on the default init path, on the
    params= path and after a step. A first Trainer is made beforehand: the
    process's first meta-device arithmetic (raindrop_param_mask) keeps the
    frames then on the stack alive."""
    import gc
    import weakref

    cfg = dataset_config("P19", max_len=MAX_LEN)
    tcfg = TrainConfig(dataset="P19", batch_size=B)
    first = Trainer(cfg, tcfg, device="cpu")
    batch = _torch_batch(_batch_np(_split(cfg, B), np.arange(B)))
    gc.collect()
    gc.disable()
    try:
        for params in (None, first.params):
            tr = Trainer(cfg, tcfg, device="cpu", params=params)
            tr.train_step(batch)
            ref = weakref.ref(tr.params["R_u"])
            del tr
            assert ref() is None
    finally:
        gc.enable()


_FIRST_TRAINER = r"""
import gc, sys, weakref
import numpy as np
import torch
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.train.trainer import Trainer

gc.disable()
cfg = dataset_config("P19", max_len=16)
B, T, F = 6, cfg.max_len, cfg.d_inp
rng = np.random.default_rng(0)
mask = (rng.uniform(size=(B, T, F)) > 0.5).astype(np.float32)
P = np.concatenate([rng.normal(size=(B, T, F)).astype(np.float32) * mask, mask], -1)
batch = {"P": torch.from_numpy(P),
         "time": torch.from_numpy(np.cumsum(rng.uniform(0.1, 1.0, (B, T)), 1)
                                  .astype(np.float32)),
         "y": torch.from_numpy(rng.integers(0, cfg.n_classes, B).astype(np.int32)),
         "static": torch.from_numpy(rng.normal(size=(B, cfg.d_static)).astype(np.float32))}
tr = Trainer(cfg, TrainConfig(dataset="P19", batch_size=B), device="cpu")
tr.train_step(batch)
ref = weakref.ref(tr.params["R_u"])
del tr
print("freed" if ref() is None else "alive")
"""


def test_the_first_trainer_of_a_process_is_freed_without_the_cyclic_collector():
    """In a fresh process with the cyclic collector off, the first Trainer
    (initialised and stepped) goes with its last reference:
    raindrop_param_mask makes no meta tensor, whose first arithmetic in a
    process kept the frames then on the stack alive on this torch."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    out = subprocess.run([sys.executable, "-c", _FIRST_TRAINER], capture_output=True,
                         text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "freed", out.stdout


@pytest.mark.parametrize("preset,overrides", [
    ("P19", {}), ("P12", {}), ("PAM", {}), ("P12", {"use_beta": True}),
    ("PAM", {"sensor_wise_mask": True})])
def test_param_mask_has_the_init_tree_built_from_the_config_alone(preset, overrides):
    """raindrop_param_mask gives, from the config alone, a boolean for every
    leaf of raindrop_init's tree: the unused encoder and the propagation
    layers' dead weights False (with use_beta the first layer's beta
    weights are live, the second layer's, which runs without beta, dead),
    every other leaf True."""
    from raindrop_tpu_torch.models.raindrop import raindrop_init, raindrop_param_mask

    cfg = dataclasses.replace(dataset_config(preset, max_len=8), **overrides)
    params = raindrop_init(0, cfg, device="cpu")
    mask = raindrop_param_mask(cfg)
    beta = {"increase_dim", "map_weights"} if cfg.use_beta else set()
    live = {"ob_propagation": {"lin_value"} | beta,
            "ob_propagation_layer2": {"lin_value"}}

    def expect(tree, path=()):
        if isinstance(tree, dict):
            return {k: expect(v, path + (k,)) for k, v in tree.items()}
        if path[0] == "encoder":
            return False
        if path[0].startswith("ob_propagation"):
            return path[1] in live[path[0]]
        return True

    assert mask == expect(params)
    assert list(mask) == list(params)
