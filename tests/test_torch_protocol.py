"""The trainer protocol of the port against the JAX package's, on the CPU:
the plateau scheduler, checkpoints both ways, `train_split` epoch by epoch,
resume, `run_splits` and the tracker.

`train_split` runs at dropout 0 from the same (bridged) initial parameters
on the same synthetic split; the sampler streams are equal by construction
(the same numpy generator). Tolerances over 4 epochs of 9 Adam steps at
the shipped lr 1e-4, which the plateau scheduler cuts to 1e-5 on the way:
the last batch's loss within 1e-4 relative (the frameworks' f32 sums
differ in the last bits and Adam carries the difference along: 2e-7 after
the first epoch, 9e-6 after the fourth; at lr 1e-3 it reaches 2e-3), val
AUROC / AUPRC within 1e-6 (rank statistics: equal unless a near-tie
swaps), the learning rate exactly; test metrics within 1e-6.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from raindrop_tpu.config import TrainConfig as JaxTrainConfig
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.data.datasets import synthetic_split as jax_synthetic_split
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.train import checkpoint as jckpt
from raindrop_tpu.train import plateau as jplateau
from raindrop_tpu.train.trainer import Trainer as JaxTrainer

from raindrop_tpu_torch import bridge
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.data.datasets import synthetic_split
from raindrop_tpu_torch.models.raindrop import raindrop_init
from raindrop_tpu_torch.train import plateau
from raindrop_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from raindrop_tpu_torch.train.trainer import (
    TrainResult, Trainer, flatten_params, run_splits)
from raindrop_tpu_torch.utils.diagnostics import frozen_param_report
from raindrop_tpu_torch.utils.tracking import JSONLTracker, RunTracker

T = 16


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


# ------------------------------------------------------------------ plateau
@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", range(6))
def test_plateau_follows_the_jax_class(seed, mode):
    rng = np.random.default_rng(seed)
    kw = dict(mode=mode, factor=float(rng.choice([0.1, 0.5])),
              patience=int(rng.integers(0, 4)),
              threshold=float(rng.choice([1e-4, 1e-2])), min_lr=1e-6)
    a, b = plateau.ReduceLROnPlateau(1e-2, **kw), jplateau.ReduceLROnPlateau(1e-2, **kw)
    metrics = np.round(rng.normal(size=40) * rng.choice([1.0, 0.01]), 3)
    for i, m in enumerate(metrics):
        assert a.step(float(m)) == b.step(float(m))
        assert a.state_dict() == b.state_dict()
        if i == 20:     # a state crosses between the packages
            a2 = plateau.ReduceLROnPlateau(1e-2, **kw)
            a2.load_state_dict(json.loads(json.dumps(b.state_dict())))
            a = a2


def test_plateau_refuses_an_unknown_mode_and_noam_matches():
    with pytest.raises(ValueError, match="mode"):
        plateau.ReduceLROnPlateau(1e-3, mode="up")
    f, jf = plateau.noam_schedule(84, 2.0, 400), jplateau.noam_schedule(84, 2.0, 400)
    for count in (0, 1, 399, 400, 5000):
        assert abs(f(count) - float(jf(count))) <= 1e-6 * float(jf(count))
    assert float(f(torch.tensor(10.0))) == pytest.approx(f(10))


# -------------------------------------------------------------- checkpoints
def _cfgs(preset="P19", **kw):
    kw = dict(max_len=T, dropout=0.0, attention_score_dtype="float32", **kw)
    return jax_dataset_config(preset, **kw), dataset_config(preset, **kw)


def test_a_port_checkpoint_loads_with_the_jax_function(tmp_path):
    jcfg, cfg = _cfgs()
    params = raindrop_init(3, cfg, device="cpu")
    path = str(tmp_path / "sub" / "best")
    save_checkpoint(path, params, meta={"epoch": 2, "config": dataclasses.asdict(cfg)})
    template = jax_raindrop_init(jax.random.PRNGKey(0), jcfg)
    jparams, jopt, meta = jckpt.load_checkpoint(path, template)
    assert jopt is None and meta["epoch"] == 2
    got, want = _flat(jax.device_get(jparams)), _flat(bridge.params_to_numpy(params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_jax_checkpoint_and_its_adam_moments_reach_the_port(tmp_path):
    """Parameters cross through the file; optax's moments through the
    bridge into the port's optimizer, then through the port's own file."""
    jcfg, cfg = _cfgs()
    jtr = JaxTrainer(jcfg, JaxTrainConfig(dataset="P19", batch_size=8))
    jparams = jtr._init(jax.random.PRNGKey(1))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jparams)
    params, _, _ = load_checkpoint(str(tmp_path / "jax"),
                                   raindrop_init(0, cfg, device="cpu"))
    tr = Trainer(cfg, TrainConfig(dataset="P19", batch_size=8), device="cpu",
                 params=params)
    rng = np.random.default_rng(0)
    mu = {p: rng.normal(size=tuple(t.shape)).astype(np.float32) for p, t in tr.live}
    nu = {p: rng.uniform(size=tuple(t.shape)).astype(np.float32) for p, t in tr.live}

    def tree(flat):
        out = {}
        for path, a in flat.items():
            *parents, leaf = path.split("/")
            node = out
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = a
        return out

    bridge.adam_state_from_jax(tr, tree(mu), tree(nu), 7)
    tr.learning_rate = 3e-4
    save_checkpoint(str(tmp_path / "last"), tr.params, tr.opt_state(),
                    meta={"epoch": 0})
    fresh = Trainer(cfg, TrainConfig(dataset="P19", batch_size=8), device="cpu")
    p2, opt2, meta = load_checkpoint(str(tmp_path / "last"), fresh.params,
                                     fresh.opt_state())
    assert meta == {"epoch": 0}
    fresh.set_params(p2)
    fresh.load_opt_state(opt2)
    assert fresh.learning_rate == 3e-4
    mu2, nu2, count = bridge.adam_state_to_numpy(fresh)
    assert count == 7
    for path in mu:
        np.testing.assert_array_equal(_flat(mu2)[path], mu[path])
        np.testing.assert_array_equal(_flat(nu2)[path], nu[path])
    for (path, a), (_, b) in zip(flatten_params(fresh.params), flatten_params(params)):
        assert torch.equal(a.detach(), b), path
    with np.load(str(tmp_path / "last") + ".npz") as z:
        keys = set(z.files)
    assert {"opt/count", "opt/learning_rate", "params/R_u"} <= keys
    assert any(k.startswith("opt/mu/") for k in keys)


# -------------------------------------------------------------- train_split
def _tcfg(cls, **kw):
    base = dict(dataset="P19", num_epochs=4, learning_rate=1e-4, batch_size=16,
                batching_strategy=2, seed=5)
    return cls(**{**base, **kw})


def test_train_split_follows_the_jax_trainer(monkeypatch):
    # both packages' splits on their numpy path, the port's inputs as before
    # its C++ host runtime existed: on the runtime's splits (1e-15 apart in
    # the stats) the two trainings part by 4e-5 in the loss by epoch 2 and
    # one of the 35 validation pairs flips (ROADMAP queue 3)
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    jcfg, cfg = _cfgs()
    jsplit = jax_synthetic_split("P19", 120, 2, T=T)
    split = synthetic_split("P19", 120, 2, T=T)
    jtr = JaxTrainer(jcfg, _tcfg(JaxTrainConfig))
    tree = jax.device_get(jtr._init(jax.random.PRNGKey(0)))
    jtr._init = lambda key: jax.tree.map(np.array, tree)
    want = jtr.train_split(jsplit, verbose=False)
    tr = Trainer(cfg, _tcfg(TrainConfig), device="cpu",
                 init_fn=lambda seed: bridge.params_from_jax(tree, cfg, "cpu"))
    got = tr.train_split(split, verbose=False)
    assert isinstance(got, TrainResult)
    assert len(got.history) == len(want.history) == 4
    for a, b in zip(got.history, want.history):
        assert a["epoch"] == b["epoch"]
        assert a["lr"] == b["lr"]
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-4 * abs(b["train_loss"])
        assert abs(a["val_auroc"] - b["val_auroc"]) <= 1e-6
        assert abs(a["val_auprc"] - b["val_auprc"]) <= 1e-6
    assert got.history[-1]["train_loss"] < got.history[0]["train_loss"]
    assert [r["lr"] for r in got.history] == [1e-4, 1e-4, 1e-5, 1e-5]
    assert abs(got.best_val_auroc - want.best_val_auroc) <= 1e-6
    assert got.test_metrics.keys() == want.test_metrics.keys()
    for k in want.test_metrics:
        assert abs(got.test_metrics[k] - want.test_metrics[k]) <= 1e-6, k
    assert got.test_confusion.shape == (2, 2)
    assert got.test_confusion.sum() == len(split.ytest)
    assert "weighted avg" in got.test_report and got.samples_per_sec > 0


def _pam_trainer(tmp_path=None, **tkw):
    """A multiclass trainer with dropout on (the seed stream is live)."""
    cfg = dataset_config("PAM", max_len=T, d_inp=5, d_pe=4, dropout=0.2,
                         attention_score_dtype="float32")
    tcfg = TrainConfig(dataset="PAM", num_epochs=3, learning_rate=1e-3,
                       batch_size=16, batching_strategy=3,
                       n_batches_strategy3=4, seed=2, **tkw)
    return Trainer(cfg, tcfg, device="cpu"), cfg, tcfg


def _pam_split(cfg, seed=0):
    P = synthetic_split("PAM", 80, seed, T=T)
    keep = slice(0, cfg.d_inp)           # 5 of PAM's 17 sensors: values, mask

    def cut(a):
        return np.concatenate([a[..., :17][..., keep], a[..., 17:][..., keep]], -1)

    return dataclasses.replace(P, Ptrain=cut(P.Ptrain), Pval=cut(P.Pval),
                               Ptest=cut(P.Ptest))


def _records(history):
    return [{k: v for k, v in r.items() if k != "elapsed_s"} for r in history]


def test_resume_reproduces_the_uninterrupted_run(tmp_path, capsys):
    tr, cfg, tcfg = _pam_trainer()
    split = _pam_split(cfg)
    seen = []
    full = tr.train_split(split, checkpoint_path=str(tmp_path / "full"),
                          on_epoch_end=lambda e, rec: seen.append(e))
    assert seen == [0, 1, 2]
    assert "classification report" in capsys.readouterr().out

    # the same run cut after its second epoch, then resumed
    tr2, _, _ = _pam_trainer()
    cut_cfg = dataclasses.replace(tcfg, num_epochs=2)
    tr2.tcfg = cut_cfg
    tr2.train_split(split, checkpoint_path=str(tmp_path / "cut"), verbose=False)
    tr3, _, _ = _pam_trainer()
    resumed = tr3.train_split(split, checkpoint_path=str(tmp_path / "cut"),
                              resume_from=str(tmp_path / "cut_last"), verbose=False)
    assert _records(resumed.history) == _records(full.history)
    assert resumed.test_metrics == full.test_metrics
    assert resumed.best_val_auroc == full.best_val_auroc
    for (path, a), (_, b) in zip(flatten_params(tr3.params), flatten_params(tr.params)):
        assert torch.equal(a.detach(), b.detach()), path
    # the best file reloads, and the _last sidecar names the port's state
    best, _, meta = load_checkpoint(str(tmp_path / "full"), tr.params)
    assert meta["config"]["max_len"] == T and "val" in meta
    for (path, a), (_, b) in zip(flatten_params(best), flatten_params(full.params)):
        assert torch.equal(a, b.detach()), path
    with open(str(tmp_path / "full_last") + ".meta.json") as f:
        last = json.load(f)
    assert {"epoch", "scheduler", "np_rng_state", "seed_generator_state",
            "best_auroc", "best_auprc", "history"} <= last.keys()
    assert "jax_key" not in last and last["epoch"] == 2


def test_a_resumed_run_that_never_improves_tests_on_the_restored_best(tmp_path):
    tr, cfg, tcfg = _pam_trainer()
    split = _pam_split(cfg)
    tr.tcfg = dataclasses.replace(tcfg, num_epochs=2)
    first = tr.train_split(split, checkpoint_path=str(tmp_path / "c"), verbose=False)
    with open(str(tmp_path / "c_last") + ".meta.json") as f:
        meta = json.load(f)
    meta["best_auroc"] = 2.0             # nothing can beat it
    with open(str(tmp_path / "c_last") + ".meta.json", "w") as f:
        json.dump(meta, f)
    tr2, _, _ = _pam_trainer()
    res = tr2.train_split(split, resume_from=str(tmp_path / "c_last"), verbose=False)
    assert res.best_val_auroc == 2.0
    best, _, _ = load_checkpoint(str(tmp_path / "c"), tr2.params)
    for (path, a), (_, b) in zip(flatten_params(res.params), flatten_params(best)):
        assert torch.equal(a.detach(), b), path
    assert first.history == res.history[:2]


def test_log_file_tracker_and_frozen_report(tmp_path, capsys):
    class Failing(RunTracker):
        def log_epoch(self, record):
            raise RuntimeError("sink down")

    tr, cfg, _ = _pam_trainer(diag_frozen_params=True)
    split = _pam_split(cfg)
    sink = JSONLTracker(str(tmp_path / "events.jsonl"))
    with open(tmp_path / "log.jsonl", "w") as log:
        res = tr.train_split(split, log_file=log, tracker=sink, verbose=False)
    sink.close()
    lines = [json.loads(x) for x in open(tmp_path / "log.jsonl")]
    assert _records(lines) == _records(res.history)
    events = [json.loads(x) for x in open(tmp_path / "events.jsonl")]
    assert [e["event"] for e in events] == ["epoch"] * 3
    out = capsys.readouterr().out
    assert "Not updated in ob_propagation/lin_key/w" in out
    assert "Not updated in ob_propagation/lin_value/w" not in out
    # a failing sink is reported once and never reaches the run
    tr.train_split(split, tracker=Failing(), verbose=False)
    assert capsys.readouterr().out.count("tracking disabled") == 1


def test_frozen_param_report_names_the_unchanged_leaves():
    a = {"x": {"w": torch.ones(2), "b": torch.zeros(2)}, "y": torch.ones(1)}
    b = {"x": {"w": torch.ones(2), "b": torch.ones(2)}, "y": torch.ones(1)}
    assert frozen_param_report(a, b) == ["x/w", "y"]


# --------------------------------------------------------------- run_splits
@pytest.mark.parametrize("resplit", [False, True])
def test_run_splits_summary(tmp_path, resplit):
    _, cfg, tcfg = _pam_trainer()
    tcfg = dataclasses.replace(
        tcfg, num_epochs=1, n_splits=2, n_runs=2, resplit_per_run=resplit,
        checkpoint_dir=str(tmp_path / "ckpt"), log_path=str(tmp_path / "log.jsonl"))
    calls = []

    def make_split(k, run=None):
        calls.append((k, run))
        return _pam_split(cfg, seed=k + (0 if run is None else 10 * run))

    events = []

    class Sink(RunTracker):
        def start(self, config):
            events.append(("start", sorted(config)))

        def finish(self, summary):
            events.append(("finish", sorted(summary)))

    out = run_splits(make_split, cfg, tcfg, device="cpu", verbose=False,
                     tracker=Sink())
    assert calls == ([(1, 0), (1, 1), (2, 0), (2, 1)] if resplit
                     else [(1, None), (2, None)])
    names = {"accuracy", "auroc", "auprc", "precision", "recall", "f1"}
    assert out.keys() == {"summary", "per_split"} and len(out["per_split"]) == 2
    assert out["summary"].keys() == names
    for name, s in out["summary"].items():
        assert s.keys() == {"mean", "std", "per_split"}
        vals = np.array([m[name] for m in out["per_split"]]) * 100.0
        assert s["mean"] == pytest.approx(vals.mean()) and s["std"] == pytest.approx(vals.std())
    assert events == [("start", ["dataset", "model_config", "train_config"]),
                           ("finish", sorted(names))]
    assert len(open(tmp_path / "log.jsonl").readlines()) == 4
    for k in (1, 2):
        for m in (0, 1):
            assert (tmp_path / "ckpt" / f"raindrop_PAM_s{k}_r{m}_last.npz").exists()
