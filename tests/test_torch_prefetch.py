"""The port's streaming input pipeline (data/prefetch.py) against the JAX
package's, and the streaming train_split against the resident one.

The executor's guarantees (order, the depth bound, a producer fault at the
consumer, an early close) as tests/test_prefetch.py holds the JAX one to;
assemble_batch equal to the JAX package's numpy path bit for bit; staging
onto a device (the CPU here: torch tensors of the asked dtypes; the CUDA
copy stream is held on the card, tests/test_torch_kernels_cuda.py). A
streaming train_split is bit-equal to the resident one: the same sampler
stream and seeds, only the batch transport differs.
"""

import threading
import time

import numpy as np
import pytest
import torch

from raindrop_tpu.data import prefetch as jprefetch

from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.data.datasets import synthetic_split
from raindrop_tpu_torch.data.prefetch import PrefetchExecutor, assemble_batch
from raindrop_tpu_torch.train.checkpoint import flatten_params
from raindrop_tpu_torch.train.trainer import Trainer


def make_data(n=64, t=12, f=5, static=True, seed=0):
    rng = np.random.default_rng(seed)
    data = {
        "P": rng.normal(size=(n, t, 2 * f)).astype(np.float32),
        "time": rng.uniform(size=(n, t)).astype(np.float32),
        "y": rng.integers(0, 2, size=(n,)).astype(np.int64),
    }
    if static:
        data["static"] = rng.normal(size=(n, 4)).astype(np.float32)
    return data


def test_assemble_batch_equals_the_jax_package():
    data = make_data()
    idx = np.array([9, 4, 4, 31, 0])
    got = assemble_batch(data, idx)
    want = jprefetch.assemble_batch(data, idx, use_native=False)
    assert set(got) == set(want)
    for k in want:
        assert got[k].flags.c_contiguous
        np.testing.assert_array_equal(got[k], want[k])


def test_order_and_content():
    data = make_data()
    batches = [np.array([0, 1]), np.array([5, 9]), np.array([63, 2])]
    with PrefetchExecutor(data, batches, depth=2) as ex:
        out = list(ex)
    assert len(out) == 3
    for want_idx, got in zip(batches, out):
        for k in data:
            np.testing.assert_array_equal(got[k], data[k][want_idx])


def test_bounded_depth_blocks_producer():
    data = make_data()
    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield np.array([i % 64])

    ex = PrefetchExecutor(data, gen(), depth=2)
    time.sleep(0.3)
    # depth 2 queued, one held by the blocked put, one drawn: at most 4
    assert 2 <= len(produced) <= 4
    first = next(ex)
    np.testing.assert_array_equal(first["y"], data["y"][[0]])
    ex.close()
    assert not ex._thread.is_alive()


def test_exception_propagates():
    data = make_data()

    def gen():
        yield np.array([0])
        raise RuntimeError("boom")

    ex = PrefetchExecutor(data, gen(), depth=2)
    assert next(ex) is not None
    with pytest.raises(RuntimeError, match="boom"):
        while True:
            next(ex)


def test_early_close_stops_the_producer():
    data = make_data()
    ex = PrefetchExecutor(data, (np.array([i % 64]) for i in range(10 ** 6)), depth=2)
    next(ex)
    ex.close()
    assert not ex._thread.is_alive()
    with pytest.raises(StopIteration):
        next(ex)


def test_staging_runs_on_the_producer(monkeypatch):
    data = make_data()
    seen = []
    stage = PrefetchExecutor._stage

    def spy(self, batch):
        seen.append(threading.current_thread().name)
        return stage(self, batch)

    monkeypatch.setattr(PrefetchExecutor, "_stage", spy)
    with PrefetchExecutor(data, [np.array([1]), np.array([2])], device="cpu") as ex:
        assert len(list(ex)) == 2
    assert len(seen) == 2 and all(t != threading.main_thread().name for t in seen)


def test_device_staging_gives_tensors_of_the_asked_dtypes():
    data = make_data()
    data["y"] = data["y"].astype(np.int32)
    idx = [np.array([3, 1]), np.array([7, 7, 2])]
    with PrefetchExecutor(data, idx, device="cpu",
                          dtypes={"y": torch.int64}) as ex:
        out = list(ex)
    for i, got in zip(idx, out):
        assert got["y"].dtype == torch.int64 and got["P"].dtype == torch.float32
        for k in data:
            np.testing.assert_array_equal(got[k].numpy(), data[k][i])


def _fields(res, trainer):
    hist = [{k: v for k, v in r.items() if k != "elapsed_s"} for r in res.history]
    return (hist, res.test_metrics,
            [t.detach().clone() for _, t in flatten_params(trainer.params)],
            [t.detach().clone() for _, t in flatten_params(res.params)])


@pytest.mark.parametrize("dataset,kw", [
    ("P19", {}),                                   # strategy 2, statics
    ("PAM", {"batching_strategy": 3, "n_batches_strategy3": 4}),
    ("P12", {"grad_microbatches": 2}),
])
def test_streaming_train_split_is_bit_equal_to_the_resident_one(dataset, kw):
    """Parameters (final and best), history but its wall clock, and test
    metrics: exactly equal."""
    cfg = dataset_config(dataset, max_len=10, d_ob=2, d_pe=4)
    split = synthetic_split(dataset, 72, 3, T=10)
    runs = []
    for pipeline in ("resident", "streaming"):
        tcfg = TrainConfig(dataset=dataset, num_epochs=2, batch_size=16, seed=5,
                           input_pipeline=pipeline, prefetch_depth=2, **kw)
        trainer = Trainer(cfg, tcfg, device="cpu")
        runs.append(_fields(trainer.train_split(split, verbose=False), trainer))
    (h0, t0, p0, b0), (h1, t1, p1, b1) = runs
    assert h0 == h1
    assert t0 == t1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


def test_the_producer_casts_in_numpy(monkeypatch):
    """A target dtype numpy has is cast by numpy on the producer thread:
    no torch cast runs there before the copy (bfloat16, which numpy lacks,
    is still cast by torch)."""
    data = make_data()
    data["y"] = data["y"].astype(np.int32)
    casts = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        if any(isinstance(a, torch.dtype) for a in (*args, *kwargs.values())):
            casts.append(threading.current_thread().name)
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    with PrefetchExecutor(data, [np.array([3, 1]), np.array([2])], device="cpu",
                          dtypes={"y": torch.int64, "time": torch.float64}) as ex:
        out = list(ex)
    assert casts == []
    assert out[0]["y"].dtype == torch.int64 and out[0]["time"].dtype == torch.float64
    np.testing.assert_array_equal(out[1]["time"].numpy(), data["time"][[2]].astype(np.float64))
    with PrefetchExecutor(data, [np.array([0])], device="cpu",
                          dtypes={"P": torch.bfloat16}) as ex:
        (b,) = list(ex)
    assert b["P"].dtype == torch.bfloat16 and len(casts) == 1
    assert torch.equal(b["P"], torch.from_numpy(data["P"][[0]]).to(torch.bfloat16))


@pytest.mark.parametrize("threads", [1, 4])
def test_streaming_is_bit_equal_to_resident_at_each_thread_count(threads):
    """The pair that once differed on the CPU (P12, B=16, 2 epochs, ROADMAP
    queue 3): resident and streaming under torch.set_num_threads(threads),
    parameters, best parameters, history and test metrics bit-equal."""
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        cfg = dataset_config("P12", max_len=10, d_ob=2, d_pe=4)
        split = synthetic_split("P12", 96, 4, T=10)
        runs = []
        for pipeline in ("resident", "streaming"):
            tcfg = TrainConfig(dataset="P12", num_epochs=2, batch_size=16, seed=6,
                               input_pipeline=pipeline, prefetch_depth=2)
            trainer = Trainer(cfg, tcfg, device="cpu")
            runs.append(_fields(trainer.train_split(split, verbose=False), trainer))
    finally:
        torch.set_num_threads(saved)
    (h0, t0, p0, b0), (h1, t1, p1, b1) = runs
    assert h0 == h1 and t0 == t1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


def test_an_unknown_input_pipeline_is_refused():
    with pytest.raises(ValueError, match="input_pipeline"):
        TrainConfig(input_pipeline="bogus")
    TrainConfig(input_pipeline="streaming")
