"""Host batch executor, the streaming input pipeline (the port of
raindrop_tpu/data/prefetch.py).

The trainer's default keeps the whole split on the card and gathers each
batch there (train/trainer.py). This is the regime for a split that does
not fit in device memory: a bounded producer / consumer executor that
gathers batches from host arrays on a worker thread (the C++ host
runtime's gather for float32 arrays, native.gather_rows, as in the JAX
package; numpy fancy indexing, which defines the semantics, for the rest
and under RAINDROP_TPU_NATIVE=0) and, with `device=` a CUDA device,
stages them onto the card there: each batch goes through pinned host buffers and a
non-blocking copy on a CUDA stream of the executor's own, so the copy of
batch k+1 overlaps the compute of batch k. The consumer's stream waits on
each batch's copy (an event recorded after it) before it reads the batch,
and every staged tensor is marked as used on the consumer's stream
(`record_stream`), so the caching allocator does not hand its memory to a
later copy while the step still reads it. The pinned buffers come from
PyTorch's pinned-memory allocator, which keeps a buffer until the copy out
of it has completed.

Semantics:
  * order-preserving: batches come out in the order the index iterator
    produced them;
  * bounded: at most `depth` assembled batches exist at once (default 2,
    double buffering), so host memory stays O(depth * batch);
  * fault-propagating: a producer exception re-raises at the consumer's
    next __next__, with the executor shut down;
  * close() (or garbage collection) stops the producer without draining.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from raindrop_tpu_torch import native

_SENTINEL = object()


def assemble_batch(data: Dict[str, np.ndarray],
                   idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Gather one batch-major batch from host arrays keyed e.g. {"P"
    [N, T, C], "time" [N, T], "static" [N, S], "y" [N]}; every array comes
    out C-contiguous; the float32 arrays through the C++ host runtime's
    gather unless RAINDROP_TPU_NATIVE=0. (The JAX package's time-major
    option has no caller here: the trainer transposes at the model's
    boundary.)"""
    use_native = native.enabled()
    return {k: (native.gather_rows(arr, idx) if use_native and arr.dtype == np.float32
                else np.ascontiguousarray(arr[idx]))
            for k, arr in data.items()}


def _numpy_dtype(dt: torch.dtype) -> Optional[np.dtype]:
    """numpy's dtype for a torch dtype, None where numpy has none."""
    try:
        return torch.empty(0, dtype=dt).numpy().dtype
    except TypeError:
        return None


class _Staged:
    """A batch whose copy to the card was issued on the executor's stream;
    `event` completes with the copy."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event


class PrefetchExecutor:
    """Iterate assembled (optionally device-staged) batches ahead of the
    consumer. See the module docstring for the guarantees."""

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_indices: Iterable[np.ndarray],
        *,
        depth: int = 2,
        device=None,
        dtypes: Optional[Dict[str, torch.dtype]] = None,
    ):
        """device: stage every batch as torch tensors on this device, on
        the producer thread (on a CUDA device through pinned buffers and
        the executor's own copy stream, see the module docstring), where
        the JAX package's executor takes a `jax.device_put`; None yields the
        numpy batches. `dtypes` maps a key to the tensor dtype it takes
        there (default: the array's own)."""
        self._data = data
        self._indices = iter(batch_indices)
        self._device = None if device is None else torch.device(device)
        self._dtypes = dict(dtypes or {})
        # the numpy dtype of each target that has one: the producer casts
        # in numpy and runs no torch op before the copy (bfloat16, which
        # numpy lacks, is cast by torch)
        self._np_dtypes = {k: _numpy_dtype(dt) for k, dt in self._dtypes.items()}
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            if self._device.index is None:
                self._device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self._device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    # ---- producer ---------------------------------------------------------
    def _stage(self, batch: Dict[str, np.ndarray]):
        """Torch tensors of `batch` on the device; on a CUDA device the
        copies are issued on the executor's stream and a _Staged returned."""
        host = {}
        for k, a in batch.items():
            np_dt, dt = self._np_dtypes.get(k), self._dtypes.get(k)
            t = torch.from_numpy(a if np_dt is None else a.astype(np_dt, copy=False))
            host[k] = t if dt is None or t.dtype == dt else t.to(dt)
        if self._stream is None:
            return {k: t.to(self._device) for k, t in host.items()}
        with torch.cuda.stream(self._stream):
            dev = {k: t.pin_memory().to(self._device, non_blocking=True)
                   for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(dev, event)

    def _produce(self):
        try:
            if self._stream is not None:
                # the thread's current device is the default one until set
                torch.cuda.set_device(self._device)
            for idx in self._indices:
                if self._stop.is_set():
                    return
                batch = assemble_batch(self._data, np.asarray(idx))
                if self._device is not None:
                    batch = self._stage(batch)
                # a blocking put bounds memory; it polls so close() can
                # interrupt it
                self._put_or_stop(batch)
            self._put_or_stop(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 -- reaches the consumer
            # the same stop-checked loop as the batch put: the exception
            # (or nothing, once the consumer has called close()) always
            # reaches the queue, so the consumer never waits on a queue
            # that will not end
            self._put_or_stop(e)

    def _put_or_stop(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # ---- consumer ---------------------------------------------------------
    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        # a timed get and a liveness check: after close() (or a dead
        # producer that enqueued nothing) no sentinel will come, so an
        # unbounded get() would hang; a stopped or dead producer with an
        # empty queue is the end. After close() nothing more comes out,
        # not even a batch the producer put while close() drained the queue
        if self._stop.is_set():
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                if not self._thread.is_alive():
                    # the producer may have enqueued its last item between
                    # the Empty and the liveness check; dead, it adds
                    # nothing more, so one more non-blocking get settles it
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        raise StopIteration from None
        if item is _SENTINEL:
            self._thread.join(timeout=5.0)
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        if isinstance(item, _Staged):
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(item.event)
            for t in item.tensors.values():
                t.record_stream(stream)
            return item.tensors
        return item

    def close(self):
        """Stop the producer and drop the queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass
