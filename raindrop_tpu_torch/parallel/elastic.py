"""Failure detection and elastic recovery (port of
raindrop_tpu/parallel/elastic.py): heartbeats, fault injection and
restart from the last durable checkpoint.

  * Heartbeat / HeartbeatMonitor: each training process writes a small
    JSON beat file (step, beat count, wall time), by hand or from a
    background thread; a monitor flags the processes whose last beat is
    stale. One beat file per rank in a shared directory.
  * FaultInjector: deterministic fault injection for tests and drills,
    raising SimulatedFailure at chosen epochs as if the process had been
    preempted.
  * run_elastic: supervises Trainer.train_split; on a failure it resumes
    from the `<checkpoint>_last` state written after every epoch
    (parameters, Adam state, scheduler, the sampler's numpy state and the
    dropout-seed generator's, the epoch) up to max_restarts times. Resume
    restores every stream exactly, so a restarted run ends where an
    uninterrupted one does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class SimulatedFailure(RuntimeError):
    """Raised by FaultInjector to emulate a preemption or a crash."""


class Heartbeat:
    """Liveness beacon of one training process: writes
    `<dir>/heartbeat_<process_id>.json` with the latest step, a beat
    counter and the wall time. Use it as a context manager (a background
    thread beats every `interval_s`) or call .beat(step) by hand."""

    def __init__(self, directory: str, process_id: int = 0,
                 interval_s: float = 10.0):
        self.directory = directory
        self.process_id = process_id
        self.interval_s = interval_s
        self.path = os.path.join(directory, f"heartbeat_{process_id}.json")
        self._step = 0
        self._count = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    @property
    def count(self) -> int:
        return self._count

    def beat(self, step: Optional[int] = None) -> None:
        with self._lock:
            if step is not None:
                self._step = step
            self._count += 1
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"process_id": self.process_id, "step": self._step,
                           "count": self._count, "time": time.time()}, f)
            os.replace(tmp, self.path)  # a monitor never sees a torn file

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def __enter__(self) -> "Heartbeat":
        self.beat()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 5.0)


class HeartbeatMonitor:
    """Supervisor-side staleness detector over a heartbeat directory."""

    def __init__(self, directory: str, timeout_s: float = 60.0):
        self.directory = directory
        self.timeout_s = timeout_s

    def read(self) -> List[Dict[str, Any]]:
        beats = []
        if not os.path.isdir(self.directory):
            return beats
        for name in sorted(os.listdir(self.directory)):
            if not (name.startswith("heartbeat_") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    beats.append(json.load(f))
            except (json.JSONDecodeError, OSError):
                continue  # a vanished or torn file counts as missing this poll
        return beats

    def stale(self, now: Optional[float] = None) -> List[int]:
        """Process ids whose last beat is older than timeout_s."""
        now = time.time() if now is None else now
        return [b["process_id"] for b in self.read()
                if now - b["time"] > self.timeout_s]

    def all_alive(self, n_processes: int, now: Optional[float] = None) -> bool:
        beats = {b["process_id"] for b in self.read()}
        return beats >= set(range(n_processes)) and not self.stale(now)


class FaultInjector:
    """Dies at the given epochs (the run's global epoch numbers), each at
    most once per injector, so a restarted run that replays an epoch does
    not trip over an old fault again."""

    def __init__(self, fail_at_epochs):
        self._pending = set(int(e) for e in fail_at_epochs)

    def __call__(self, epoch: int, record: Dict[str, Any]) -> None:
        if epoch in self._pending:
            self._pending.discard(epoch)
            raise SimulatedFailure(f"injected failure at epoch {epoch}")


def run_elastic(trainer, split, *, checkpoint_path: str,
                max_restarts: int = 3, seed: Optional[int] = None,
                heartbeat: Optional[Heartbeat] = None,
                fault_injector: Optional[Callable] = None,
                verbose: bool = False):
    """Supervised training with restart from checkpoint: runs
    trainer.train_split, and after any exception resumes from
    `<checkpoint_path>_last` (written after every epoch; from scratch if
    the run died before the first), until it completes or max_restarts
    restarts are spent. Every rank of a mesh runs it alike (the fault
    injector fires on each at the same epoch). Returns (TrainResult,
    restarts)."""
    restarts = 0
    resume: Optional[str] = None

    def hook(epoch: int, rec: Dict[str, Any]) -> None:
        if heartbeat is not None:
            heartbeat.beat(step=epoch)
        if fault_injector is not None:
            fault_injector(epoch, rec)

    while True:
        try:
            result = trainer.train_split(
                split, seed=seed, checkpoint_path=checkpoint_path,
                resume_from=resume, verbose=verbose, on_epoch_end=hook)
            return result, restarts
        except Exception as e:  # noqa: BLE001 - any crash is a restart
            restarts += 1
            if restarts > max_restarts:
                raise
            last = checkpoint_path + "_last"
            resume = last if os.path.exists(last + ".npz") else None
            if verbose:
                print(f"[elastic] {type(e).__name__}: {e} - restart "
                      f"{restarts}/{max_restarts} from {resume or 'scratch'}")
