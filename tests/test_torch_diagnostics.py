"""The port's diagnostics (utils/diagnostics.py): the FLOP count and the
kernels' credit, the NaN guard against the JAX package's, Throughput, MFU,
and measure_mfu's telemetry leaving the run bit-equal.

The kernels' credit is checked as the functions the wrappers credit
(attention_flops, layer_flops, edge_flops) against FlopCounterMode's count
of a plain PyTorch form at the same shapes, within 2% (equal here); on the
CPU a wrapper runs its plain version and credits nothing (its launches
credit on the card: tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import torch_flops_util as fu
from raindrop_tpu.utils import diagnostics as jdiag

from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.data.datasets import synthetic_split
from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.nn import transformer as tr
from raindrop_tpu_torch.train.checkpoint import flatten_params
from raindrop_tpu_torch.train.trainer import Trainer
from raindrop_tpu_torch.utils import diagnostics as diag


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (3, 5, 7), (64, 32, 16)])
def test_counted_flops_of_a_matmul_is_2mkn(M, K, N):
    a, b = torch.randn(M, K), torch.randn(K, N)
    assert diag.counted_flops(lambda: a @ b) == 2 * M * K * N
    x = torch.randn(M, K, requires_grad=True)
    # forward and the backward's dx (b needs no gradient)
    assert diag.counted_flops(lambda: (x @ b).sum().backward()) == 4 * M * K * N


def test_counted_flops_adds_the_credit_of_open_counts_only():
    build.credit(1e9)                          # no count open: dropped
    with build.flop_credit() as outer:
        build.credit(5.0)
        assert diag.counted_flops(lambda: build.credit(7.0)) == 7.0
        build.credit(1.0)
    assert outer[0] == 13.0
    assert not build._credits


@pytest.mark.parametrize("case", range(5), ids=[c[0] for c in fu.credit_cases()])
def test_each_wrapper_credit_matches_the_plain_count(case):
    name, credit, fn, args = fu.credit_cases()[case]
    plain = fn(*args, "cpu", False)
    assert abs(credit - plain) <= fu.FLOP_TOL * plain, (name, credit, plain)


@pytest.mark.parametrize("case", range(5), ids=[c[0] for c in fu.credit_cases()])
def test_a_wrapper_on_the_cpu_credits_nothing(case):
    """On a CPU tensor the wrapper runs its plain version: no kernel
    launched, so nothing is credited."""
    _, _, fn, args = fu.credit_cases()[case]
    with build.flop_credit() as box:
        fn(*args, "cpu", True)
    assert box[0] == 0.0


def test_no_fused_layer_credit_where_d_is_not_divisible_by_nhead(monkeypatch):
    """The credit follows the rung that runs (nn/transformer.encoder_rung,
    which has the d % nhead guard): at d % nhead != 0 no backend and no T
    takes the fused layer, so its wrapper, the only place its credit is
    given, is never called."""
    for backend in ("auto", "fused_layer", "flash", "dense"):
        for T in (64, 384, 600, 1024, 2048):
            assert tr.encoder_rung(backend, T, 85, 2, True) != "fused_layer"
            assert tr.encoder_rung(backend, T, 84, 2, True) in (
                "fused_layer", "flash", "flash_mha", "dense")
    assert tr.encoder_rung("auto", 600, 84, 2, True) == "fused_layer"
    calls = []
    monkeypatch.setattr(tr, "fused_encoder_layer",
                        lambda *a, **k: calls.append(a) or a[1])
    gen = torch.Generator().manual_seed(0)
    p = tr._layer_init(gen, 84, 20, "cpu")
    x = torch.randn(2, 16, 84)
    tr.transformer_encoder_layer_apply(p, x, None, 2, backend="fused_layer")
    assert len(calls) == 1
    p5 = tr._layer_init(gen, 85, 20, "cpu")
    with pytest.raises(RuntimeError):      # d % nhead: no rung runs it at all
        tr.transformer_encoder_layer_apply(p5, torch.randn(2, 16, 85), None, 2,
                                           backend="fused_layer")
    assert len(calls) == 1


def test_nan_guard_matches_the_jax_package():
    tree = {"a": {"w": np.array([1.0, np.nan, np.inf], np.float32),
                  "b": np.zeros(3, np.float32)},
            "c": np.array([[np.nan, 1.0]], np.float32),
            "n": np.array([1, 2], np.int32)}
    want = jdiag.nan_guard(tree, raise_error=False)
    got = diag.nan_guard({k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                              if isinstance(v, dict) else torch.from_numpy(v))
                          for k, v in tree.items()}, raise_error=False)
    assert got == want == {"a/w": 2, "c": 1}
    with pytest.raises(FloatingPointError, match="grads"):
        diag.nan_guard({"x": torch.tensor([float("nan")])}, "grads")
    assert diag.nan_guard(torch.ones(3)) == {}
    assert diag.nan_guard(torch.tensor([1.0, float("inf")]), raise_error=False) == {"": 1}


def test_debug_nan_context_names_the_op():
    x = torch.tensor([0.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="returned nan"):
        with diag.debug_nan_context():
            (x / x).sum().backward()


def test_profile_trace_writes_a_trace(tmp_path):
    with diag.profile_trace(str(tmp_path / "trace")) as prof:
        torch.randn(8, 8) @ torch.randn(8, 8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_throughput_matches_the_jax_package():
    for mod in (diag, jdiag):
        t = mod.Throughput(edges_per_sample=2 * 36 * 36)
        t.update(100)
        t.update(28)
        s = t.summary()
        assert s["edges_per_sec"] == pytest.approx(s["samples_per_sec"] * 2592)
        assert s["samples_per_sec"] == pytest.approx(128 / s["elapsed_s"])
        t.reset()
        assert "edges_per_sec" not in mod.Throughput().summary()


def test_mfu_and_the_peak(monkeypatch):
    assert diag.mfu(None, 989.4e12) is None
    assert diag.mfu(1e12, None) is None
    assert diag.mfu(98.94e12, 989.4e12) == pytest.approx(0.1)
    assert diag.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert diag.device_peak_flops("cuda:0") == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    assert diag.device_peak_flops("cuda") is None


def _run(cfg, split, **kw):
    tcfg = TrainConfig(dataset=kw.pop("dataset"), num_epochs=2, batch_size=16,
                       seed=4, **kw)
    trainer = Trainer(cfg, tcfg, device="cpu")
    res = trainer.train_split(split, verbose=False)
    return res, [t.detach().clone() for _, t in flatten_params(trainer.params)]


@pytest.mark.parametrize("dataset,kw", [("P12", {}), ("PAM", {"batching_strategy": 3,
                                                              "n_batches_strategy3": 3}),
                                        ("P19", {"grad_microbatches": 2})])
def test_measure_mfu_leaves_the_run_bit_equal_and_adds_both_fields(dataset, kw):
    cfg = dataset_config(dataset, max_len=10, d_ob=2, d_pe=4)
    split = synthetic_split(dataset, 64, 2, T=10)
    plain, p0 = _run(cfg, split, dataset=dataset, **kw)
    timed, p1 = _run(cfg, split, dataset=dataset, measure_mfu=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert timed.test_metrics == plain.test_metrics
    for a, b in zip(plain.history, timed.history):
        assert set(b) == set(a) | {"train_tflops_per_sec", "mfu"}
        assert {k: v for k, v in a.items() if k != "elapsed_s"} == {
            k: v for k, v in b.items() if k not in ("elapsed_s", "train_tflops_per_sec",
                                                    "mfu")}
        assert b["train_tflops_per_sec"] > 0 and b["mfu"] is None   # no peak on the CPU


def test_step_flops_writes_no_grad_and_draws_nothing_from_the_trainer():
    cfg = dataset_config("P12", max_len=10, d_ob=2, d_pe=4)
    trainer = Trainer(cfg, TrainConfig(dataset="P12", batch_size=8), device="cpu")
    split = synthetic_split("P12", 32, 1, T=10)
    batch = {"P": torch.from_numpy(split.Ptrain[:8]),
             "time": torch.from_numpy(split.Ptrain_time[:8]),
             "y": torch.from_numpy(split.ytrain[:8]).long(),
             "static": torch.from_numpy(split.Ptrain_static[:8])}
    state = trainer._seed_gen.get_state()
    before = [t.detach().clone() for _, t in trainer.live]
    flops = trainer.step_flops(batch)
    assert flops > 0
    assert torch.equal(trainer._seed_gen.get_state(), state)
    assert all(t.grad is None for _, t in trainer.live)
    assert all(torch.equal(a, t) for a, (_, t) in zip(before, trainer.live))
    # the dense rung on the CPU: every product is a matmul the counter sees
    assert trainer.step_flops(batch) == flops
