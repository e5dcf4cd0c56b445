"""Failure detection and elastic recovery in the port
(raindrop_tpu_torch/parallel/elastic.py), the JAX package's five cases
(tests/test_elastic.py) on the port's Trainer, and a restart on a
two-rank data-parallel mesh (gloo): a run killed after an epoch and
restarted from its `_last` checkpoint ends where an uninterrupted run
does, and a monitor sees stale heartbeats. The restarted run restores
every stream, so its results are held equal exactly."""

import json
import threading
import time

import numpy as np
import pytest

from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.data.datasets import synthetic_split
from raindrop_tpu_torch.parallel.elastic import (
    FaultInjector, Heartbeat, HeartbeatMonitor, SimulatedFailure, run_elastic)
from raindrop_tpu_torch.parallel.launch import run_ranks
from raindrop_tpu_torch.train.trainer import Trainer

from tests import torch_mesh_workers as workers


def _setup():
    cfg = dataset_config("PAM", max_len=12, nlayers=1, nhead=1)
    split = synthetic_split("PAM", 120, 0, T=12)
    tcfg = TrainConfig(dataset="PAM", num_epochs=4, learning_rate=1e-3,
                       batch_size=24, batching_strategy=3, n_batches_strategy3=4,
                       seed=3)
    return cfg, tcfg, split


def _trainer(cfg, tcfg):
    return Trainer(cfg, tcfg, device="cpu")


def test_elastic_restart_matches_uninterrupted_run(tmp_path):
    cfg, tcfg, split = _setup()
    full = _trainer(cfg, tcfg).train_split(
        split, checkpoint_path=str(tmp_path / "full"), verbose=False)
    # a crash at epoch 1 (after its checkpoint is durable), restarted once
    result, restarts = run_elastic(
        _trainer(cfg, tcfg), split, checkpoint_path=str(tmp_path / "elastic"),
        fault_injector=FaultInjector([1]), max_restarts=2)
    assert restarts == 1
    assert [r["epoch"] for r in result.history] == [0, 1, 2, 3]
    assert result.test_metrics == full.test_metrics
    np.testing.assert_array_equal(result.params["mlp_static"]["lin0"]["w"].numpy(),
                                  full.params["mlp_static"]["lin0"]["w"].numpy())


def test_elastic_restart_before_first_checkpoint(tmp_path):
    """A death at epoch 0 resumes from epoch 0's checkpoint (written before
    the hook fires): every epoch still runs once."""
    cfg, tcfg, split = _setup()
    result, restarts = run_elastic(
        _trainer(cfg, tcfg), split, checkpoint_path=str(tmp_path / "early"),
        fault_injector=FaultInjector([0]), max_restarts=2)
    assert restarts == 1
    assert [r["epoch"] for r in result.history] == [0, 1, 2, 3]


def test_elastic_exhausts_restarts(tmp_path):
    cfg, tcfg, split = _setup()
    with pytest.raises(SimulatedFailure):
        run_elastic(_trainer(cfg, tcfg), split, checkpoint_path=str(tmp_path / "dead"),
                    fault_injector=FaultInjector([0, 1, 2, 3]), max_restarts=2)


def test_heartbeat_monitor_detects_staleness(tmp_path):
    d = str(tmp_path / "hb")
    hb0 = Heartbeat(d, process_id=0)
    hb1 = Heartbeat(d, process_id=1)
    hb0.beat(step=5)
    hb1.beat(step=5)
    mon = HeartbeatMonitor(d, timeout_s=60.0)
    assert mon.all_alive(2)
    assert mon.stale() == []
    # two minutes with no beats: both flagged
    assert mon.stale(now=time.time() + 120.0) == [0, 1]
    assert not mon.all_alive(2, now=time.time() + 120.0)
    # process 0 goes silent (its beat backdated); process 1 keeps beating
    with open(hb0.path) as f:
        beat = json.load(f)
    beat["time"] -= 300.0
    with open(hb0.path, "w") as f:
        json.dump(beat, f)
    hb1.beat(step=7)
    assert mon.stale() == [0]
    assert not mon.all_alive(2)


def test_heartbeat_background_thread(tmp_path):
    """The thread beats on its own: wait, with a deadline, until it has
    beaten twice after the first beat instead of sleeping a fixed time."""
    d = str(tmp_path / "hb2")
    with Heartbeat(d, process_id=0, interval_s=0.05) as hb:
        deadline = time.monotonic() + 30.0
        seen = threading.Event()
        while time.monotonic() < deadline:
            if hb.count >= 3:
                seen.set()
                break
            time.sleep(0.01)
        assert seen.is_set(), "the heartbeat thread did not beat within 30 s"
        hb.beat(step=3)
    beats = HeartbeatMonitor(d).read()
    assert len(beats) == 1
    assert beats[0]["step"] == 3
    assert beats[0]["count"] >= 4


def test_elastic_restart_on_a_data_parallel_mesh(tmp_path):
    """Two gloo ranks (DP 2 x 1): the run with a fault at epoch 1 restarts
    once from the `_last` state rank 0 wrote and ends where the
    uninterrupted two-rank run ends; the best parameters went to per-rank
    shard files."""
    split = synthetic_split("PAM", 120, 0, T=12)
    ranks = run_ranks(workers.elastic, 2, 2, split,
                      [(str(tmp_path / "full"), None), (str(tmp_path / "hit"), 1)])
    full, hit = ([r[i] for r in ranks] for i in (0, 1))
    for (m_full, ep_full, r_full, p_full), (m_hit, ep_hit, r_hit, p_hit) in zip(full, hit):
        assert r_full == 0 and r_hit == 1
        assert ep_full == ep_hit == [0, 1, 2]
        assert m_hit == m_full
        for k in p_full:
            np.testing.assert_array_equal(p_hit[k], p_full[k], err_msg=k)
    assert full[0][0] == full[1][0]
    assert sorted(p.name for p in tmp_path.glob("hit.shard*")) == [
        "hit.shard0-of2.npz", "hit.shard1-of2.npz"]
