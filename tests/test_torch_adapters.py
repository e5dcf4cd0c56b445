"""The Trainer's pluggable model against the JAX Trainer(apply_fn=...) on
the CPU, for every baseline family: three optimizer steps from the same
bridged parameters, batches and dropout masks (each family's seeds read
off the JAX step's key), held to tests/test_torch_trainer.py's bounds
(losses 1e-5 relative, logits 1e-4 / 1e-5; parameters 5e-5 absolute, and
2e-6 plus 1e-4 relative but for 0.01% of a leaf's elements).

Adam's first steps move a parameter by about lr whatever its gradient's
size, so an element whose gradient is below what
tests/test_torch_baselines.py resolves (1e-4 of its leaf's largest plus
1e-9, at any of the three steps; JAX's gradients read off its Adam first
moment, mu_k = 0.9 mu_(k-1) + 0.1 g_k) may take a full step of the other
sign: those elements are held to 3 * lr, what three steps can move one
(the key biases, whose true gradient is 0, are wholly such elements).
IP-Net is resolved at 1e-3 and its logits held to 1e-4, since JAX's own
f32 forward is 1e-4 from float64 there (LOGIT_ATOL). Every other element
is held to the bounds above. With an `apply_fn` every leaf is live, as JAX's update_mask=None. Also:
checkpoints of a baseline tree cross both ways bit for bit (`layers/0/...`
paths, the JAX tree's `_meta` dropped), `flatten_params` orders a list by
index, the update mask, and `predict` and `train_split` through apply_fn.

Sizes as tests/test_torch_baselines.py: eICU's widths at max_len 16, one
layer, B=6; MTGNN at 2 layers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raindrop_tpu.baselines import adapters as jadapters
from raindrop_tpu.config import TrainConfig as JaxTrainConfig
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.train import checkpoint as jcheckpoint
from raindrop_tpu.train.trainer import Trainer as JaxTrainer

from raindrop_tpu_torch.baselines import adapters
from raindrop_tpu_torch.bridge import params_to_numpy
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.data.datasets import synthetic_split
from raindrop_tpu_torch.train.checkpoint import (
    flatten_params, load_checkpoint, save_checkpoint)
from raindrop_tpu_torch.train.trainer import Trainer

from test_torch_baselines import GRAD_FLOOR, GRAD_REL, HP, KW, port_params
from test_torch_trainer import _batch_np, _split, _torch_batch
from tests.torch_port_util import (
    baseline_seeds_from_jax_key, jax_baseline_params, without_meta)

NAMES = adapters.BASELINES + ("grud_bce",)
B, LR = 6, 1e-3
# IP-Net's train-mode logits: the JAX package's f32 forward sits 1.1e-5 to
# 1.3e-5 (1e-4 relative) from a float64 evaluation of itself on these
# batches (its interpolation kernel's exponentials of squared time
# distances; the port's is 6e-7 to 1e-6 from it: tests/jax_ipnet_float64.py
# measures both), and a step on it carries
# that on: its logits are held to 1e-4, and an element of its gradients is
# resolved only above 1e-3 of its leaf's largest
LOGIT_ATOL = {"ipnet": 1e-4}
GRAD_RES = {"ipnet": 1e-3}


def _setup(name, dropout=0.2):
    hp = HP.get(name)
    jcfg = jax_dataset_config("eICU", dropout=dropout, **KW)
    cfg = dataset_config("eICU", dropout=dropout, **KW)
    jinit, japply = jadapters.make_baseline(name, jcfg, dict(hp or {}))
    jtr = JaxTrainer(jcfg, JaxTrainConfig(dataset="eICU", learning_rate=LR, batch_size=B),
                     apply_fn=japply, init_fn=jinit)
    host = jax_baseline_params(name, hp, **KW)
    b = adapters.make_baseline(name, cfg, hp, device="cpu")
    tr = Trainer(cfg, TrainConfig(dataset="eICU", learning_rate=LR, batch_size=B),
                 device="cpu", params=port_params(name, cfg, host, hp),
                 init_fn=b.init_fn, apply_fn=b.apply_fn, draw_seeds=b.draw_seeds)
    return jtr, host, tr, cfg, hp


def _jax_steps(jtr, host, split, name, cfg, hp, record):
    """Three JAX trainer steps from the host tree `host` (sampler draws and
    keys fixed) -> (the parameters after them, and for each leaf the mask
    of its elements whose gradient at some step is below the gradient
    test's resolution); the port trainer `record` takes the same steps
    beside them and each step's loss and logits are compared."""
    jparams = jax.tree_util.tree_map(jnp.array, host)
    opt_state = jtr.optimizer.init(jparams)
    rng = np.random.default_rng(5)
    small, mu_prev = {}, None
    for step in range(3):
        idx = rng.permutation(24)[:B]
        key = jax.random.PRNGKey(100 + step)
        b = _batch_np(split, idx)
        jparams, opt_state, jloss, jlogits = jtr._train_step(
            jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        mu = _adam_mu(opt_state)
        for path, m in mu.items():
            g = np.abs(m if mu_prev is None else m - 0.9 * mu_prev[path]) / 0.1
            res = GRAD_RES.get(name, GRAD_REL)
            small[path] = small.get(path, False) | (g <= res * g.max() + GRAD_FLOOR)
        mu_prev = mu
        loss, logits = record.train_step(
            _torch_batch(b), baseline_seeds_from_jax_key(name, key, cfg, hp))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4,
                                   atol=LOGIT_ATOL.get(name, 1e-5))
    return dict(flatten_params(params_to_numpy_jax(jparams))), small


def _adam_mu(opt_state):
    """Adam's first moment in a JAX trainer's optimizer state, by path."""
    (state,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return dict(flatten_params(params_to_numpy_jax(state.mu)))


@pytest.mark.parametrize("name", NAMES)
def test_three_steps_match_the_jax_trainer(name):
    jtr, host, tr, cfg, hp = _setup(name)
    assert len(tr.live) == len(flatten_params(tr.params)) and not tr.dead
    split = _split(cfg, 24)
    want, small = _jax_steps(jtr, host, split, name, cfg, hp, record=tr)
    for path, t in flatten_params(tr.params):
        got, ref, s = t.detach().numpy(), want[path], small[path]
        np.testing.assert_allclose(got[s], ref[s], rtol=0, atol=3 * LR, err_msg=path)
        dev, ref = np.abs(got - ref)[~s], ref[~s]
        assert dev.size == 0 or (dev.max() <= 5e-5 and (
            dev > 2e-6 + 1e-4 * np.abs(ref)).mean() <= 1e-4), (name, path, dev.max())


def params_to_numpy_jax(jparams):
    return without_meta(jax.device_get(jparams))


@pytest.mark.parametrize("name", ["transformer_moe", "mtgnn"])
def test_checkpoints_cross_both_ways_bit_for_bit(name, tmp_path):
    """A JAX baseline checkpoint (lists under `layers/0/...`, the `_meta`
    entries dropped) loads in the port bit for bit, and the reverse."""
    hp = HP.get(name)
    cfg = dataset_config("eICU", **KW)
    jparams = jax_baseline_params(name, hp, seed=1, **KW)
    jcheckpoint.save_checkpoint(str(tmp_path / "j"), jparams)
    template = adapters.make_baseline(name, cfg, hp, device="cpu").init_fn(0)
    got, _, _ = load_checkpoint(str(tmp_path / "j"), template)
    want = dict(flatten_params(params_to_numpy_jax(jparams)))
    assert [p for p, _ in flatten_params(got)] == list(want)
    for path, t in flatten_params(got):
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
    save_checkpoint(str(tmp_path / "t"), template)
    back, _, _ = jcheckpoint.load_checkpoint(str(tmp_path / "t"), jparams)
    mine = dict(flatten_params(params_to_numpy(template)))
    for path, a in flatten_params(params_to_numpy_jax(back)):
        np.testing.assert_array_equal(a, mine[path], err_msg=path)


def test_flatten_params_orders_lists_by_index():
    tree = {"b": [torch.full((1,), float(i)) for i in range(12)], "a": torch.zeros(2)}
    paths = [p for p, _ in flatten_params(tree)]
    assert paths == ["a"] + [f"b/{i}" for i in range(12)]
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
              for kp, _ in jax.tree_util.tree_flatten_with_path(
                  {"b": [np.zeros(1)] * 12, "a": np.zeros(2)})[0]]
    assert paths == jpaths


def test_update_mask_freezes_leaves_and_the_default_is_all_live():
    cfg = dataset_config("eICU", **KW)
    b = adapters.make_baseline("transformer", cfg, device="cpu")
    params = b.init_fn(0)
    frozen = _bools(params, lambda path: not path.startswith("mlp/"))
    tr = Trainer(cfg, TrainConfig(dataset="eICU", batch_size=B), device="cpu",
                 params=params, apply_fn=b.apply_fn, draw_seeds=b.draw_seeds,
                 update_mask=frozen)
    assert tr.dead and all(p.startswith("mlp/") for p, _ in tr.dead)
    before = {p: t.clone() for p, t in tr.dead}
    batch = _torch_batch(_batch_np(_split(cfg, 12), np.arange(B)))
    tr.train_step(batch)
    for p, t in tr.dead:
        assert torch.equal(t, before[p]), p
    with pytest.raises(ValueError, match="update mask"):
        Trainer(cfg, TrainConfig(dataset="eICU"), device="cpu", params=params,
                apply_fn=b.apply_fn, update_mask={"encoder": True})


def _bools(tree, live, prefix=""):
    if isinstance(tree, dict):
        return {k: _bools(v, live, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bools(v, live, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return live(prefix[:-1])


def test_predict_and_train_split_go_through_the_model():
    """A baseline's protocol: fresh parameters from its init_fn, predict
    through its apply_fn, a resumable checkpoint of its tree."""
    cfg = dataset_config("eICU", **KW)
    b = adapters.make_baseline("transformer_moe", cfg, device="cpu")
    tcfg = TrainConfig(dataset="eICU", batch_size=16, num_epochs=2)
    tr = Trainer(cfg, tcfg, device="cpu", init_fn=b.init_fn, apply_fn=b.apply_fn,
                 draw_seeds=b.draw_seeds)
    split = synthetic_split("eICU", 80, 1, T=cfg.max_len)
    res = tr.train_split(split, checkpoint_path=None, verbose=False)
    assert len(res.history) == 2 and 0.0 <= res.test_metrics["auroc"] <= 1.0
    got = tr.predict(res.params, split.Ptest, split.Ptest_time, split.Ptest_static,
                     batch_size=7)
    with torch.no_grad():
        src = torch.from_numpy(split.Ptest).transpose(0, 1)
        tm = torch.from_numpy(split.Ptest_time).transpose(0, 1)
        want, _ = b.apply_fn(res.params, src, torch.from_numpy(split.Ptest_static),
                             tm, (tm > 0).sum(0), False, None)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_a_baseline_run_resumes_bit_for_bit(tmp_path):
    """train_split with checkpoints for a list tree (MoE's `layers/0/...`):
    a run resumed from the first epoch's `_last` file ends where the
    uninterrupted one does, parameters, history and test metrics."""
    cfg = dataset_config("eICU", **KW)
    b = adapters.make_baseline("transformer_moe", cfg, device="cpu")
    split = synthetic_split("eICU", 80, 2, T=cfg.max_len)

    def run(epochs, path, resume=None):
        tr = Trainer(cfg, TrainConfig(dataset="eICU", batch_size=16, num_epochs=epochs),
                     device="cpu", init_fn=b.init_fn, apply_fn=b.apply_fn,
                     draw_seeds=b.draw_seeds)
        return tr, tr.train_split(split, checkpoint_path=str(tmp_path / path),
                                  resume_from=resume, verbose=False)

    run(1, "a")
    tr, resumed = run(2, "b", resume=str(tmp_path / "a_last"))
    tr_full, full = run(2, "c")
    assert [h["train_loss"] for h in resumed.history] == [
        h["train_loss"] for h in full.history]
    assert resumed.test_metrics == full.test_metrics
    for (path, t), (_, u) in zip(flatten_params(tr.params), flatten_params(tr_full.params)):
        assert torch.equal(t, u), path
