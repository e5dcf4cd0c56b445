"""The port's experiment CLI (`python -m raindrop_tpu_torch.run`), in process
on tiny synthetic data and dataset files, on the CPU (--device cpu): the
raindrop cases of tests/test_cli.py, every --model, the flags that wait
for later slices, and the JAX package's run.py on the same command line:
the same model and training configurations field for field, and the same
splits array for array (both packages' run_splits, and for a baseline
their Trainer, replaced by a recorder, so nothing trains; a baseline's
recorder also holds the init's tree shapes, so its --<family>-* flags
reach the model the same way)."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import raindrop_tpu.train as jtrain
from raindrop_tpu import run as jrun
from test_torch_load_split import assert_splits_equal, write_root
from tests.torch_port_util import without_meta

from raindrop_tpu_torch import run
from raindrop_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, *extra, out="out.json"):
    out_path = str(tmp_path / out)
    rc = run.main([
        "--dataset", "P19", "--synthetic", "48", "--max-len", "8",
        "--batch-size", "8", "--epochs", "1", "--n-splits", "1",
        "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--out-json", out_path, *extra])
    assert rc == 0
    with open(out_path) as f:
        return json.load(f)


# smaller hyperparameter groups than the published ones keep these CPU runs
# short (MTGNN's 5 layers pad T to a receptive field of 187); the recorder
# case with --mtgnn-layers below checks that a group's flags reach the model
SMALL_HP = {"mtgnn": ["--mtgnn-layers", "2"],
            "mtand": ["--mtand-num-ref-points", "16", "--mtand-embed-time", "16"],
            "ipnet": ["--ipnet-ref-points", "24", "--ipnet-hid", "16"]}


@pytest.mark.parametrize("model", run.MODELS[1:])
def test_cli_every_model_smoke(tmp_path, model):
    """Each baseline family through the CLI on the CPU: eICU's widths at
    max_len 16 (Raindrop v1's edges need max_len >= d_inp = 14)."""
    res = _run(tmp_path, "--model", model, "--dataset", "eICU", "--max-len", "16",
               "--synthetic", "40", "--track-jsonl", str(tmp_path / "t.jsonl"),
               *SMALL_HP.get(model, []))
    acc = res["missing_0.0"]["accuracy"]["mean"]
    assert np.isfinite(acc) and 0 <= acc <= 100
    events = [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [e["event"] for e in events] == ["start", "epoch", "finish"]
    assert np.isfinite(events[1]["train_loss"])
    assert events[0]["config"]["model"] == model


def test_cli_raindrop_smoke(tmp_path, capsys):
    res = _run(tmp_path)
    auroc = res["missing_0.0"]["auroc"]["mean"]
    assert np.isfinite(auroc) and 0 <= auroc <= 100
    assert "auroc" in capsys.readouterr().out


def test_cli_resume_from(tmp_path):
    """One epoch writes <ckpt>_last; a second run resumes from it to epoch 2
    and gives the uninterrupted 2-epoch run's summary."""
    _run(tmp_path)
    last = str(tmp_path / "ckpt" / "raindrop_P19_s1_r0_last")
    assert os.path.exists(last + ".npz")
    resumed = _run(tmp_path, "--epochs", "2", "--resume-from", last,
                   "--checkpoint-dir", str(tmp_path / "ckpt2"), out="r.json")
    full = _run(tmp_path, "--epochs", "2", "--checkpoint-dir",
                str(tmp_path / "ckpt3"), out="f.json")
    assert resumed == full


@pytest.mark.parametrize("method", ["mean", "forward", "cubic_spline", "knn", "mice"])
def test_cli_imputation(tmp_path, method):
    res = _run(tmp_path, "--imputation", method, out=f"{method}.json")
    assert np.isfinite(res["missing_0.0"]["accuracy"]["mean"])


def test_cli_streaming_mfu_and_sensor_removal(tmp_path):
    res = _run(tmp_path, "--input-pipeline", "streaming", "--measure-mfu", "true",
               "--withmissingratio", "true", "--feature_removal_level", "sample",
               "--n-splits", "1")
    assert sorted(res) == [f"missing_{r}" for r in (0.1, 0.2, 0.3, 0.4, 0.5)]


def test_cli_compare_golden(tmp_path, capsys):
    gp = str(tmp_path / "golden.npy")
    np.save(gp, np.array([[55.0], [30.0], [50.0]]))      # acc/auprc/auroc, 1 split
    res = _run(tmp_path, "--compare-golden", gp, out="gc.json")
    assert set(res["golden_delta"]) == {"accuracy", "auprc", "auroc"}
    assert "golden comparison" in capsys.readouterr().out


def test_cli_compare_golden_split_mismatch(tmp_path, capsys):
    gp = str(tmp_path / "g5.npy")
    np.save(gp, np.tile(np.array([[55.0], [30.0], [50.0]]), (1, 5)))
    res = _run(tmp_path, "--compare-golden", gp, out="gm.json")
    assert "golden_delta" in res
    assert "[warn]" in capsys.readouterr().out


def test_cli_compare_golden_skipped_without_the_standard_run(tmp_path, capsys):
    gp = str(tmp_path / "g.npy")
    np.save(gp, np.array([[55.0], [30.0], [50.0]]))
    res = _run(tmp_path, "--compare-golden", gp, "--missing-ratio", "0.2",
               "--feature_removal_level", "sample", out="gs.json")
    assert "golden_delta" not in res
    assert "--compare-golden skipped" in capsys.readouterr().out


def test_cli_track_jsonl_lifecycle(tmp_path):
    track = tmp_path / "track.jsonl"
    _run(tmp_path, "--epochs", "2", "--track-jsonl", str(track))
    events = [json.loads(ln) for ln in track.read_text().splitlines()]
    assert [e["event"] for e in events] == ["start", "epoch", "epoch", "finish"]
    assert events[0]["config"]["train_config"]["dataset"] == "P19"


def test_cli_refuses_unknown_baseline_and_scale_out(tmp_path):
    with pytest.raises(SystemExit):
        run.main(["--model", "nope"])
    # --distributed, --data-parallel and --model-parallel run since the
    # mesh's slice, the model-axis routes since theirs
    # (tests/test_torch_scale_out_routes.py); without a mesh, or for a
    # baseline family, a route raises the JAX CLI's errors
    for flags in (["--context-parallel", "ring"],
                  ["--pipeline-microbatches", "2"], ["--edge-partition", "true"],
                  ["--edge-partition", "true", "--model", "transformer"]):
        with pytest.raises(ValueError, match="need a mesh"):
            run.main([*flags, "--synthetic", "8", "--device", "cpu"])


def test_cli_without_cuda_stops_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--dataset", "P19", "--synthetic", "16", "--max-len", "8"])
    out = subprocess.run(
        [sys.executable, "-m", "raindrop_tpu_torch.run", "--dataset", "P19",
         "--synthetic", "16", "--max-len", "8", "--epochs", "1",
         "--out-json", str(tmp_path / "o.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not (tmp_path / "o.json").exists()


def _shapes(tree):
    """{path: shape} of a parameter tree of either package (`_meta` left out)."""
    from raindrop_tpu_torch.train.checkpoint import flatten_params

    return dict(flatten_params(without_meta(tree, lambda a: tuple(np.shape(a)))))


def _recorded(monkeypatch, argv):
    """Per package, what its main hands run_splits (cfg, tcfg, make_split)
    or, for a baseline, its Trainer: (cfg, tcfg, [(split, seed, resume_from)
    of every train_split call], the init's tree shapes)."""
    import jax

    seen = {}

    def recorder(side):
        def fake(make_split, cfg, tcfg, **kw):
            seen.setdefault(side, []).append((cfg, tcfg, make_split, None))
            return {"summary": {"auroc": {"mean": 50.0, "std": 0.0,
                                          "per_split": [50.0]}}}
        return fake

    def trainer(side):
        class FakeTrainer:
            def __init__(self, cfg, tcfg, *a, init_fn=None, **kw):
                key = jax.random.PRNGKey(0) if side == "jax" else 0
                self.calls = []
                seen.setdefault(side, []).append(
                    (cfg, tcfg, self.calls, _shapes(init_fn(key))))

            def train_split(self, split, *, seed=None, resume_from=None, **kw):
                self.calls.append((split, seed, resume_from))
                return SimpleNamespace(test_metrics={"auroc": 0.5, "auprc": 0.5})
        return FakeTrainer

    monkeypatch.setattr(jtrain, "run_splits", recorder("jax"))
    monkeypatch.setattr(ttrainer, "run_splits", recorder("port"))
    monkeypatch.setattr(jtrain, "Trainer", trainer("jax"))
    monkeypatch.setattr(ttrainer, "Trainer", trainer("port"))
    assert jrun.main(argv) == 0
    assert run.main([*argv, "--device", "cpu"]) == 0
    return seen["jax"], seen["port"]


@pytest.mark.parametrize("argv", [
    ["--dataset", "P19", "--synthetic", "40", "--max-len", "8"],
    ["--dataset", "PAM", "--synthetic", "40", "--max-len", "12", "--imputation",
     "mean", "--missing-ratio", "0.3", "--feature_removal_level", "sample",
     "--input-pipeline", "streaming", "--measure-mfu", "true", "--lr", "3e-4",
     "--dropout", "0.0", "--epochs", "3", "--batch-size", "16"],
    ["--dataset", "P12", "--synthetic", "40", "--max-len", "8", "--use-beta", "true",
     "--sensor-wise-mask", "true", "--prop-backend", "pallas", "--resplit-per-run",
     "true", "--n-runs", "2", "--grad-microbatches", "2", "--seed", "3",
     "--withmissingratio", "true", "--feature_removal_level", "sample"],
    ["--dataset", "P19", "--synthetic", "40", "--max-len", "8", "--model",
     "transformer", "--resplit-per-run", "true", "--n-runs", "2", "--n-splits", "2"],
    ["--dataset", "P19", "--synthetic", "40", "--max-len", "8", "--model", "mtgnn",
     "--mtgnn-layers", "3", "--n-splits", "2", "--seed", "2"],
])
def test_same_argv_same_configs_and_splits_as_the_jax_cli(monkeypatch, argv):
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    jax_calls, port_calls = _recorded(monkeypatch, argv)
    assert len(jax_calls) == len(port_calls) >= 1
    for (jcfg, jtcfg, jsplit, jshapes), (cfg, tcfg, split, shapes) in zip(
            jax_calls, port_calls):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)
        if jshapes is None:          # the flagship: run_splits's make_split
            for k, kw in ((1, {}), (2, {}), (1, {"run": 1})):
                assert_splits_equal(split(k, **kw), jsplit(k, **kw))
            continue
        assert shapes == jshapes
        assert len(split) == len(jsplit) == tcfg.n_splits * tcfg.n_runs
        for (sp, seed, resume), (jsp, jseed, jresume) in zip(split, jsplit):
            assert (seed, resume) == (jseed, jresume)
            assert_splits_equal(sp, jsp)


def test_same_argv_same_splits_from_files(monkeypatch, tmp_path):
    """A P12 root: Setting 4's age split reversed, the time axis truncated,
    Setting 2 by a ranking file, forward imputation."""
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    root = write_root(tmp_path / "P12data", "P12")
    ranking = np.random.default_rng(0).permutation(36)
    ig = str(tmp_path / "ig.npy")
    np.save(ig, np.array([[int(i), f"s{i}"] for i in ranking], dtype=object),
            allow_pickle=True)
    argv = ["--dataset", "P12", "--data-root", root, "--max-len", "10",
            "--splittype", "age", "--reverse", "true", "--imputation", "forward",
            "--feature_removal_level", "set", "--missing-ratio", "0.25",
            "--ig-scores", ig]
    (jcall,), (call,) = _recorded(monkeypatch, argv)
    assert dataclasses.asdict(call[1]) == dataclasses.asdict(jcall[1])
    got, want = call[2](1), jcall[2](1)
    assert got.Ptrain.shape[1] == 10
    assert_splits_equal(got, want)
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.array([[0, "s0"]] * 36, dtype=object), allow_pickle=True)
    with pytest.raises(SystemExit, match="permutation"):
        run.make_split(run.build_parser().parse_args(
            [*argv[:-1], bad]), call[0], 1, 0.25)


def test_cli_data_parallel_over_two_gloo_ranks(tmp_path):
    """`run.main` with --data-parallel 2 on two gloo ranks (the group
    started by the launcher, so --distributed true finds it up): both
    ranks train, rank 0 alone writes the `_last` state and --out-json,
    and the summary is the one-rank run's. The
    two runs differ only in the order of the gradient sums (DP averages
    over the ranks), so the metrics are held to 1e-6 (percent)."""
    from raindrop_tpu_torch.parallel.launch import run_ranks
    from tests import torch_mesh_workers as workers

    argv = ["--dataset", "P19", "--synthetic", "48", "--max-len", "8",
            "--batch-size", "8", "--epochs", "1", "--n-splits", "1", "--device", "cpu"]
    one = _run(tmp_path, out="one.json")
    out = str(tmp_path / "dp.json")
    ckpt = str(tmp_path / "dp_ckpt")
    rcs = run_ranks(workers.cli, 2, [*argv, "--distributed", "true", "--data-parallel",
                                     "2", "--checkpoint-dir", ckpt, "--out-json", out])
    assert rcs == [0, 0]
    with open(out) as f:
        dp = json.load(f)
    for name, s in one["missing_0.0"].items():
        np.testing.assert_allclose(dp["missing_0.0"][name]["mean"], s["mean"],
                                   rtol=0, atol=1e-6, err_msg=name)
    # rank 0 wrote the run's state; a best epoch (a val AUROC above 0)
    # would have left one shard file a rank beside it
    files = sorted(os.listdir(ckpt))
    assert files[-2:] == ["raindrop_P19_s1_r0_last.meta.json",
                          "raindrop_P19_s1_r0_last.npz"]
    assert files[:-2] in ([], ["raindrop_P19_s1_r0.shard0-of2.npz",
                               "raindrop_P19_s1_r0.shard1-of2.npz"])
