"""Run-tracking hook points (the port's own copy of
raindrop_tpu/utils/tracking.py): the reference's disabled W&B slot as a
dependency-free callback interface.

    tracker.start(config_dict)     once per run
    tracker.log_epoch(record)      every epoch (the record is the trainer's
                                   history entry: epoch, train_loss,
                                   val_auroc, val_auprc, lr, elapsed_s)
    tracker.finish(summary_dict)   once, with the final test metrics

`Trainer.train_split(tracker=...)` and `run_splits(tracker=...)` drive it.
A tracker must never raise into the training loop: `_SafeTracker` catches,
reports once and disables the sink.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional


class RunTracker:
    """No-op base class; subclass and override any subset."""

    def start(self, config: Dict[str, Any]) -> None:
        pass

    def log_epoch(self, record: Dict[str, Any]) -> None:
        pass

    def finish(self, summary: Dict[str, Any]) -> None:
        pass


class JSONLTracker(RunTracker):
    """Append lifecycle events as JSON lines: {"event": "start"|"epoch"|
    "finish", ...payload}. One file can hold many runs."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def _write(self, event: str, payload: Dict[str, Any]) -> None:
        self._f.write(json.dumps({"event": event, **payload},
                                 default=str) + "\n")
        self._f.flush()

    def start(self, config: Dict[str, Any]) -> None:
        self._write("start", {"config": config})

    def log_epoch(self, record: Dict[str, Any]) -> None:
        self._write("epoch", record)

    def finish(self, summary: Dict[str, Any]) -> None:
        self._write("finish", {"summary": summary})

    def close(self) -> None:
        self._f.close()


class _SafeTracker(RunTracker):
    """Wraps a user tracker so sink failures cannot kill training; the
    first failure is printed once and the sink is disabled."""

    def __init__(self, inner: Optional[RunTracker]):
        self.inner = inner
        self._dead = inner is None

    def _call(self, name: str, payload) -> None:
        if self._dead:
            return
        try:
            getattr(self.inner, name)(payload)
        except Exception as e:  # noqa: BLE001: telemetry must not raise
            print(f"tracker {type(self.inner).__name__}.{name} failed "
                  f"({e!r}); tracking disabled for this run")
            self._dead = True

    def start(self, config) -> None:
        self._call("start", config)

    def log_epoch(self, record) -> None:
        self._call("log_epoch", record)

    def finish(self, summary) -> None:
        self._call("finish", summary)
