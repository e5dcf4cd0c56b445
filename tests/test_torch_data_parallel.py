"""The port's mesh steps against the JAX package's, on the CPU: ranks of a
gloo group (raindrop_tpu_torch.parallel.launch, spawned processes) each
train on their rows and part of the model, against JAX's one-device step
and its GSPMD steps on the 8 virtual devices (make_mesh(4, 2) and
(2, 4)), from the same parameters, batch and dropout masks (the port's
seeds read off JAX's key; every mask hashed at global coordinates).

Tolerances, JAX's own for its mesh steps (tests/test_tensor_parallel.py):
the loss rtol 2e-5 and atol 2e-5; logits and parameters after the step
2e-4. The key bias of the attention (the middle third of in_proj_b) has
a true gradient of zero, so Adam normalises rounding noise there: it is
held to 3 * lr, as tests/test_torch_trainer.py holds it. One Adam step
at lr 1e-4 moves a parameter by at most about 1e-4 whatever its
gradient, so the parameters alone would pass a wrong gradient: the
step's gradient is held too, through Adam's first moment after it
(mu = (1 - b1) * g of the gradient averaged over the data axis and
gathered over the model axis), every element within 1e-4 of its leaf's
largest JAX |mu| plus 1e-10, as tests/test_torch_baselines.py holds
gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from raindrop_tpu.config import TrainConfig as JaxTrainConfig
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.data import synthetic_split
from raindrop_tpu.parallel import make_mesh as jax_make_mesh
from raindrop_tpu.parallel.mesh import shard_params as jax_shard_params
from raindrop_tpu.train import Trainer as JaxTrainer

from raindrop_tpu_torch.parallel.launch import run_ranks
from raindrop_tpu_torch.train.checkpoint import flatten_params

from tests import torch_mesh_workers as workers
from tests.torch_port_util import seeds_from_jax_key

LR = 1e-4           # TrainConfig's default, the JAX mesh test's
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-10


def _adam_mu(opt_state):
    """Adam's first moment in a JAX trainer's optimizer state, by path
    (a masked leaf has none)."""
    (state,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return {path: np.asarray(v) for path, v in
            flatten_params(jax.device_get(state.mu))}


def _jax_step(mesh, preset, cfg_kw, tcfg_kw, jparams, batch, key):
    cfg = jax_dataset_config(preset, **cfg_kw)
    trainer = JaxTrainer(cfg, JaxTrainConfig(dataset=preset, **tcfg_kw), mesh=mesh)
    # a fresh copy each time: the step donates its parameters
    params = jax.tree.map(jnp.asarray, jparams)
    if mesh is not None:
        params = jax_shard_params(mesh, params)
    opt_state = trainer.optimizer.init(params)
    b = trainer._device_batch(batch["P"], batch["time"], batch.get("static"),
                              batch["y"])
    params, opt_state, loss, logits = trainer._train_step(params, opt_state, b, key)
    return (float(loss), np.asarray(jax.device_get(logits)),
            dict(flatten_params(jax.device_get(params))), _adam_mu(opt_state))


def _setup(preset, cfg_kw, tcfg_kw, n, B, seed=0):
    cfg = jax_dataset_config(preset, **cfg_kw)
    trainer = JaxTrainer(cfg, JaxTrainConfig(dataset=preset, **tcfg_kw))
    jparams = jax.device_get(trainer._init(jax.random.PRNGKey(0)))
    split = synthetic_split(preset, n=n, seed=seed, T=cfg.max_len)
    idx = np.arange(B)
    batch = {"P": split.Ptrain[idx], "time": split.Ptrain_time[idx],
             "y": np.asarray(split.ytrain[idx])}
    if split.Ptrain_static is not None:
        batch["static"] = split.Ptrain_static[idx]
    return cfg, jparams, batch


def _assert_close(got, want, what):
    loss, logits, params, mu = got
    w_loss, w_logits, w_params, w_mu = want
    assert set(mu) == set(w_mu), what
    for path, ref in w_mu.items():
        tol = GRAD_REL * float(np.abs(ref).max()) + GRAD_FLOOR
        np.testing.assert_allclose(mu[path], ref, rtol=0, atol=tol,
                                   err_msg=f"{what} mu {path}")
    np.testing.assert_allclose(loss, w_loss, rtol=2e-5, atol=2e-5, err_msg=what)
    np.testing.assert_allclose(logits, w_logits, rtol=2e-4, atol=2e-4, err_msg=what)
    assert set(params) == set(w_params)
    for path, ref in w_params.items():
        g, r = params[path], np.asarray(ref)
        if path.endswith("in_proj_b"):
            d = r.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], r[d:2 * d], rtol=0, atol=3 * LR,
                                       err_msg=f"{what} {path}")
            g, r = np.delete(g, np.s_[d:2 * d]), np.delete(r, np.s_[d:2 * d])
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4, err_msg=f"{what} {path}")


def _gathered(results, c_of=lambda r: r[3]):
    """(loss, the global batch's logits, the full parameters, Adam's full
    first moment) of a run from every rank's result: the logits of the
    model-rank-0 ranks in data order; every rank's loss, parameters and
    moments must agree."""
    ranks = sorted(results, key=lambda r: (c_of(r).data_rank, c_of(r).model_rank))
    logits = np.concatenate([r[1] for r in ranks if c_of(r).model_rank == 0])
    for r in ranks[1:]:
        assert r[0] == ranks[0][0]
        for tree in (2, 4):
            for path, v in r[tree].items():
                np.testing.assert_array_equal(v, ranks[0][tree][path], err_msg=path)
    return ranks[0][0], logits, ranks[0][2], ranks[0][4]


P19 = ("P19", dict(max_len=8), dict(batch_size=8, num_epochs=1, batching_strategy=2))


@pytest.fixture(scope="module")
def p19_jax():
    """JAX's one-device step and its two mesh steps at P19 (max_len 8, B 8,
    the preset's dropout 0.2), and the seeds of its key."""
    preset, cfg_kw, tcfg_kw = P19
    cfg, jparams, batch = _setup(preset, cfg_kw, tcfg_kw, 32, 8)
    key = jax.random.PRNGKey(1)
    steps = {shape: _jax_step(None if shape is None else jax_make_mesh(*shape),
                              preset, cfg_kw, tcfg_kw, jparams, batch, key)
             for shape in (None, (4, 2), (2, 4))}
    return cfg, jparams, batch, seeds_from_jax_key(key, cfg.nlayers, rows=8), steps


def _port_run(p19, extra=()):
    cfg, tree, batch, seeds, _ = p19
    preset, cfg_kw, tcfg_kw = P19
    return [(preset, cfg_kw, tcfg_kw, tree, batch, seeds), *extra]


def _check_mesh(res, shape, wants):
    """One mesh's results on every rank: the first run against `wants`,
    predict gathered alike on every rank, the size refusal."""
    got = _gathered([r[shape][0][0] for r in res])
    for want in wants:
        _assert_close(got, want, f"mesh {shape}")
    preds = [r[shape][1] for r in res]
    for p in preds[1:]:
        np.testing.assert_array_equal(p, preds[0])
    assert np.isfinite(preds[0]).all()
    assert all("!=" in r[shape][2] for r in res)
    return preds[0]


def test_dp_and_tp_steps_on_two_ranks_match_jax(p19_jax):
    """Two gloo ranks as DP 2x1 and as TP 1x2: P19 (the dense rung)
    against JAX's one-device step and both of its mesh steps; on TP 1x2
    also one step at P12's width (d 160, two heads of 80, one a rank) on
    the packed rung (attention_backend 'flash': each rank runs
    flash_mha_packed's plain version on its head at its origin) against
    JAX's one-device step on its packed kernel. The ranks agree on the
    loss and the parameters, `predict` gathers the global batch's logits
    on every rank, and a mesh the world does not hold raises."""
    preset, cfg_kw, tcfg_kw = ("P12", dict(max_len=16, attention_backend="flash",
                                           attention_score_dtype="float32"),
                               dict(batch_size=4, num_epochs=1, batching_strategy=2))
    cfg, jparams, batch = _setup(preset, cfg_kw, tcfg_kw, 16, 4, seed=1)
    key = jax.random.PRNGKey(2)
    want_p12 = _jax_step(None, preset, cfg_kw, tcfg_kw, jparams, batch, key)
    p12 = (preset, cfg_kw, tcfg_kw, jparams, batch,
           seeds_from_jax_key(key, cfg.nlayers, rows=4))
    res = run_ranks(workers.one_step, 2, [((2, 1), _port_run(p19_jax)),
                                          ((1, 2), _port_run(p19_jax, [p12]))])
    wants = list(p19_jax[4].values())
    pred = _check_mesh(res, (2, 1), wants)
    assert pred.shape == (8, 2)
    _check_mesh(res, (1, 2), wants)
    _assert_close(_gathered([r[(1, 2)][0][1] for r in res]), want_p12,
                  "mesh (1, 2) P12 packed")


def test_dp_x_tp_step_on_four_ranks_matches_jax(p19_jax):
    """DP x TP 2x2 on four gloo ranks, as above."""
    res = run_ranks(workers.one_step, 4, [((2, 2), _port_run(p19_jax))])
    _check_mesh(res, (2, 2), list(p19_jax[4].values()))
