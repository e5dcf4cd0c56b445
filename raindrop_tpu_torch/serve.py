"""Inference serving for Raindrop on the card (port of raindrop_tpu/serve.py).

Same surface and semantics as the JAX server:

  * **Batch buckets**: a request is zero-padded up to the nearest bucket
    (padded rows have all-zero times, so lengths 0, masked everywhere
    downstream); requests above the top bucket are chunked. PyTorch runs
    eagerly, so there is no ahead-of-time compilation; the buckets stay
    because they bound the shapes a later PR can capture in CUDA graphs.
  * **Micro-batching**: concurrent `submit`/`submit_async` calls are
    coalesced by a batcher thread into shared launches; a fetch pool reads
    results back so one group's readback overlaps the next group's launch.
  * **Pipelined streaming** (`predict_stream`): up to `depth` launches in
    flight, fetched on a thread pool, results in order.
  * **bfloat16 wire format** (`transfer_dtype`): request tensors are cast
    on the host before the host-to-device copy, then to the model's
    storage dtype (`cfg.dtype`) on the card, the times the lengths are
    counted from included; probabilities come back as float32 numpy.
  * **Mixed precision**: under `compute_dtype` the server casts its live
    parameters to it once (`models/raindrop.compute_params`); the forward
    then finds them cast, with the bits a per-call cast gives.

`python -m raindrop_tpu_torch.serve --dataset PAM --port 8000` serves a
stdlib-HTTP JSON endpoint (POST /predict, GET /healthz) on the card;
`--device cpu` serves on the CPU.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from raindrop_tpu_torch.baselines.adapters import make_flagship
from raindrop_tpu_torch.config import RaindropConfig, dataset_config
from raindrop_tpu_torch.models.raindrop import compute_params, raindrop_init, torch_dtype

_WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def resolve_device(device) -> torch.device:
    """The device to serve on; CUDA that is missing raises, it never turns
    into the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _resolve(fut, result=None, exc=None):
    """Set a caller's future once: whichever of the fetch stage and close()
    comes second finds it done and leaves it."""
    from concurrent.futures import InvalidStateError

    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class InferenceServer:
    """Bucketed batch inference for a Raindrop model on one device."""

    # close() returns within this many seconds (the batcher's join timeout)
    _close_timeout_s = 10.0

    def __init__(
        self,
        cfg: RaindropConfig,
        params,
        *,
        buckets: Sequence[int] = (1, 8, 32, 128),
        apply_fn=None,
        transfer_dtype: str = "float32",
        coalesce_window_s: float = 0.002,
        device="cuda",
    ):
        """transfer_dtype: the wire format of request tensors; 'bfloat16'
        halves host-to-device bytes at an input quantization of about 3
        significant digits (compute runs in the model's dtype).

        coalesce_window_s: how long the batcher waits for more concurrent
        requests once the first of a group arrives; a full top bucket
        launches at once.
        """
        if transfer_dtype not in _WIRE:
            raise ValueError(f"transfer_dtype must be one of {sorted(_WIRE)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.buckets = sorted(buckets)
        self.transfer_dtype = _WIRE[transfer_dtype]
        self._dtype = torch_dtype(cfg.dtype)
        # the tree the forward reads: for the flagship its live leaves in
        # the compute dtype, cast once (the parameters never change);
        # self.params stays as given
        self._params = self.params
        if apply_fn is None:
            flagship = make_flagship(cfg, self.device)
            with torch.no_grad():
                self._params = compute_params(self.params, cfg)

            def apply_fn(p, src, static, times, lengths):
                return flagship.apply_fn(p, src, static, times, lengths, False, None)[0]
        self._apply = apply_fn
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "samples": 0, "batches": 0,
                      "coalesced_launches": 0, "coalesced_requests": 0,
                      "latency_ms_sum": 0.0}
        self._coalesce_s = coalesce_window_s
        self._submit_q: "queue.Queue" = queue.Queue()
        self._batcher_thread: Optional[threading.Thread] = None
        self._closed = False
        # the batcher thread only launches; reading results back and
        # resolving futures runs on this pool, at most _pipeline_depth
        # groups in flight
        self._pipeline_depth = 4
        self._fetch_pool = None
        self._inflight = threading.Semaphore(self._pipeline_depth)
        # groups taken off the queue and not yet resolved; close() fails
        # what is still here when its time is up
        self._pending: Dict[int, list] = {}
        self._shutdown = threading.Event()

    @torch.no_grad()
    def _forward(self, P: torch.Tensor, times: torch.Tensor,
                 static: Optional[torch.Tensor]) -> torch.Tensor:
        """Wire-dtype batch-major tensors on the device -> float32
        probabilities (the softmax in the logits' dtype, as in JAX)."""
        dt = self._dtype
        P = P.to(dt)
        times = times.to(dt)
        static = None if static is None else static.to(dt)
        src = P.transpose(0, 1)
        tm = times.transpose(0, 1)
        lengths = (tm > 0).sum(dim=0)
        logits = self._apply(self._params, src, static, tm, lengths)
        return torch.softmax(logits, dim=-1).to(torch.float32)

    # -- inference -----------------------------------------------------------
    def predict(self, P: np.ndarray, times: np.ndarray,
                static: Optional[np.ndarray] = None) -> np.ndarray:
        """P [n, T, 2F], times [n, T], static [n, S]|None -> probs [n, C].

        Requests larger than the top bucket are chunked; smaller ones are
        zero-padded up to the nearest bucket.
        """
        t0 = time.perf_counter()
        n = P.shape[0]
        probs, n_launches = self._run_batches(P, times, static)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["samples"] += n
            self.stats["batches"] += n_launches
            self.stats["latency_ms_sum"] += 1e3 * (time.perf_counter() - t0)
        return probs

    # -- micro-batching (thread-safe submit + coalescing batcher) ----------
    def submit(self, P: np.ndarray, times: np.ndarray,
               static: Optional[np.ndarray] = None,
               timeout: Optional[float] = None) -> np.ndarray:
        """Thread-safe micro-batching entry point: concurrent calls are
        coalesced into shared bucketed launches and each caller blocks for
        its own slice of the results. Results equal predict()'s."""
        t0 = time.perf_counter()
        out = self.submit_async(P, times, static).result(timeout)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["latency_ms_sum"] += 1e3 * (time.perf_counter() - t0)
        return out

    def submit_async(self, P: np.ndarray, times: np.ndarray,
                     static: Optional[np.ndarray] = None):
        """Enqueue the request and return its `concurrent.futures.Future`.
        Counts toward `samples` here and `batches` at launch; `requests`
        and the latency stay defined over synchronous calls."""
        from concurrent.futures import Future

        fut: "Future" = Future()
        item = (np.asarray(P), np.asarray(times),
                None if static is None else np.asarray(static), fut)
        # closed-check and enqueue under the lock that close() takes to
        # enqueue its sentinel, so no request lands behind the sentinel
        with self._lock:
            if self._closed:
                raise RuntimeError("server closed")
            self._ensure_batcher_locked()
            self.stats["samples"] += item[0].shape[0]
            self._submit_q.put(item)
        return fut

    def _ensure_batcher_locked(self):
        """Start the batcher thread and fetch pool (caller holds _lock)."""
        if self._batcher_thread is None or not self._batcher_thread.is_alive():
            if self._fetch_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._fetch_pool = ThreadPoolExecutor(
                    max_workers=self._pipeline_depth,
                    thread_name_prefix="serve-fetch")
            self._batcher_thread = threading.Thread(
                target=self._batcher_loop, daemon=True)
            self._batcher_thread.start()

    @staticmethod
    def _compat_key(item):
        """Only shape-compatible requests share a launch, so a malformed
        request fails alone."""
        P, times, static, _ = item
        return (P.shape[1:], times.shape[1:],
                None if static is None else static.shape[1:])

    def _batcher_loop(self):
        top = self.buckets[-1]
        leftover = None
        while True:
            if leftover is not None:
                first, leftover = leftover, None
            else:
                try:
                    first = self._submit_q.get(timeout=0.1)
                except queue.Empty:
                    if self._closed:
                        return
                    continue
            if first is None:
                return
            group = [first]
            key = self._compat_key(first)
            n_total = first[0].shape[0]
            # wait up to the coalesce window for more compatible requests,
            # or until a full top bucket is pending
            deadline = time.perf_counter() + self._coalesce_s
            while n_total < top:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._submit_q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._closed = True
                    break
                if self._compat_key(item) != key:
                    leftover = item        # starts the next group
                    break
                group.append(item)
                n_total += item[0].shape[0]
            self._dispatch_group(group)

    def _run_batches(self, P, times, static):
        """Chunk to the top bucket, launch, fetch, unpad. Returns
        (probs [n, C], n_launches). The one path behind predict() and the
        batcher's retries."""
        top = self.buckets[-1]
        n = P.shape[0]
        if n == 0:
            return np.zeros((0, self.cfg.n_classes), np.float32), 0
        outs = []
        n_launches = 0
        for start in range(0, n, top):
            chunk = slice(start, min(start + top, n))
            probs = self._launch_chunk(
                P[chunk], times[chunk],
                None if static is None else static[chunk])
            outs.append(self._fetch(probs)[:chunk.stop - chunk.start])
            n_launches += 1
        return np.concatenate(outs), n_launches

    def _fetch(self, dev: torch.Tensor) -> np.ndarray:
        """Device-to-host readback of one launched bucket (waits for it)."""
        return dev.to("cpu").numpy()

    def _dispatch_group(self, group):
        """Concatenate a group's tensors and launch its buckets; fetching
        and resolving the futures runs on the fetch pool. At most
        _pipeline_depth groups are in flight; a group waiting for a slot
        fails with 'server closed' once close() gives up waiting."""
        with self._lock:
            self._pending[id(group)] = group
        try:
            P = np.concatenate([g[0] for g in group if g[0].shape[0]]
                               or [group[0][0]])
            times = np.concatenate([g[1] for g in group if g[0].shape[0]]
                                   or [group[0][1]])
            static = (np.concatenate([g[2] for g in group if g[0].shape[0]]
                                     or [group[0][2]])
                      if group[0][2] is not None else None)
            n = P.shape[0]
            if n == 0:
                empty = np.zeros((0, self.cfg.n_classes), np.float32)
                for g in group:
                    _resolve(g[3], empty)
                self._done(group)
                return
            while not self._inflight.acquire(timeout=0.05):
                if self._shutdown.is_set():
                    raise RuntimeError("server closed")
            try:
                top = self.buckets[-1]
                launches = []
                for start in range(0, n, top):
                    chunk = slice(start, min(start + top, n))
                    dev = self._launch_chunk(
                        P[chunk], times[chunk],
                        None if static is None else static[chunk])
                    launches.append((dev, chunk.stop - chunk.start))
                self._fetch_pool.submit(self._finish_group, group, launches)
            except BaseException:
                self._inflight.release()
                raise
        except Exception as e:  # noqa: BLE001 — delivered to the callers
            self._fail_or_retry(group, e)

    def _finish_group(self, group, launches):
        """Fetch stage (pool thread): read back each bucket, slice results
        to the callers' futures, account stats."""
        try:
            try:
                outs = [self._fetch(dev)[:rows] for dev, rows in launches]
            finally:
                self._inflight.release()
            all_probs = np.concatenate(outs)
            with self._lock:
                self.stats["batches"] += len(launches)
                self.stats["coalesced_launches"] += len(launches)
                self.stats["coalesced_requests"] += len(group)
            off = 0
            for g in group:
                k = g[0].shape[0]
                _resolve(g[3], all_probs[off:off + k])
                off += k
            self._done(group)
        except Exception as e:  # noqa: BLE001 — delivered to the callers
            self._fail_or_retry(group, e)

    def _done(self, group):
        with self._lock:
            self._pending.pop(id(group), None)

    def _fail_or_retry(self, group, err):
        """A coalesced launch failed as a unit: retry each member alone so
        only the offending request sees the error. After close() has given
        up waiting, every member fails instead."""
        if len(group) == 1 or self._shutdown.is_set():
            for g in group:
                _resolve(g[3], exc=err)
            self._done(group)
            return
        for g in group:
            if g[3].done():
                continue
            try:
                probs, n_launches = self._run_batches(g[0], g[1], g[2])
                with self._lock:
                    self.stats["batches"] += n_launches
                _resolve(g[3], probs)
            except Exception as e:  # noqa: BLE001
                _resolve(g[3], exc=e)
        self._done(group)

    def close(self):
        """Stop the batcher and return within _close_timeout_s. Queued and
        in-flight requests complete if they can within that time; every
        future still pending then (queued, waiting for a pipeline slot, or
        behind a readback that does not return) fails with 'server closed',
        and anything that races in after the drain fails the same way. The
        fetch pool is shut down without waiting: a readback that hangs
        keeps its thread until it returns, but no caller waits on it."""
        deadline = time.monotonic() + self._close_timeout_s
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._submit_q.put(None)
        t = self._batcher_thread
        if t is not None and t.is_alive():
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._lock:
            futs = [g[3] for grp in self._pending.values() for g in grp]
        if futs:
            from concurrent.futures import wait
            wait(futs, timeout=max(0.0, deadline - time.monotonic()))
        self._shutdown.set()
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=False, cancel_futures=True)
        closed = RuntimeError("server closed")
        with self._lock:
            pending = [g for grp in self._pending.values() for g in grp]
            self._pending.clear()
        for g in pending:
            _resolve(g[3], exc=closed)
        while True:
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _resolve(item[3], exc=closed)

    def predict_stream(self, requests, *, depth: int = 4):
        """Yield probs [n_i, C] for each request (P_i, times_i, static_i|None)
        in order, with up to `depth` launches and fetches in flight.
        Results equal predict()'s."""
        import collections
        from concurrent.futures import ThreadPoolExecutor

        top = self.buckets[-1]
        inflight: "collections.deque" = collections.deque()
        with ThreadPoolExecutor(max_workers=depth) as pool:
            def drain_one():
                fut, n = inflight.popleft()
                return fut.result()[:n]

            for (P, times, static) in requests:
                n = P.shape[0]
                if n > top:
                    raise ValueError(
                        f"stream request n={n} exceeds top bucket {top}; "
                        f"chunk client-side or use predict()")
                dev = self._launch_chunk(P, times, static)
                # 'requests' is not counted: the latency is defined over
                # synchronous predict() calls
                inflight.append((pool.submit(self._fetch, dev), n))
                with self._lock:
                    self.stats["samples"] += n
                    self.stats["batches"] += 1
                if len(inflight) >= depth:
                    yield drain_one()
            while inflight:
                yield drain_one()

    def _wire(self, a: np.ndarray) -> torch.Tensor:
        # cast on the host, so the copy to the device carries the wire format
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return t.to(self.transfer_dtype).to(self.device)

    def _launch_chunk(self, P, times, static):
        """Pad and launch one bucket; returns the device tensor of
        probabilities for the padded bucket (the launch is asynchronous)."""
        n = P.shape[0]
        b = _bucket_for(n, self.buckets)
        if n < b:
            pad = b - n
            P = np.concatenate([P, np.zeros((pad,) + P.shape[1:], P.dtype)])
            times = np.concatenate(
                [times, np.zeros((pad,) + times.shape[1:], times.dtype)])
            if static is not None:
                static = np.concatenate(
                    [static, np.zeros((pad,) + static.shape[1:], static.dtype)])
        if self.cfg.static and static is None:
            raise ValueError(
                f"model config expects static features [n, {self.cfg.d_static}]")
        return self._forward(self._wire(P), self._wire(times),
                             None if static is None else self._wire(static))

    # -- introspection -------------------------------------------------------
    def health(self) -> Dict[str, object]:
        s = dict(self.stats)
        s["avg_latency_ms"] = (s.pop("latency_ms_sum") / s["requests"]
                               if s["requests"] else 0.0)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {"status": "ok", "device": str(self.device),
                "device_name": name, "buckets": list(self.buckets), **s}


def make_http_server(server: InferenceServer, host: str = "127.0.0.1",
                     port: int = 8000):
    """Wrap an InferenceServer in a stdlib ThreadingHTTPServer.

    POST /predict  {"P": [[..]], "times": [[..]], "static": [[..]]|null}
                   -> {"probs": [[..]]}
    GET  /healthz  -> server.health()
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, server.health())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                P = np.asarray(req["P"], np.float32)
                times = np.asarray(req["times"], np.float32)
                static = (np.asarray(req["static"], np.float32)
                          if req.get("static") is not None else None)
                # concurrent HTTP clients coalesce into shared launches
                probs = server.submit(P, times, static)
                self._send(200, {"probs": probs.tolist()})
            except Exception as e:  # surface errors to the client
                self._send(400, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Raindrop inference server (PyTorch)")
    ap.add_argument("--dataset", default="P19")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path without .npz, as the JAX trainer "
                         "writes it (default: random init from --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--buckets", default="1,8,32,128")
    ap.add_argument("--transfer-dtype", default="float32",
                    choices=sorted(_WIRE),
                    help="wire format of request tensors; bfloat16 halves "
                         "host-to-device bytes at ~3-digit input quantization")
    args = ap.parse_args(argv)

    cfg = dataset_config(args.dataset)
    device = resolve_device(args.device)
    params = raindrop_init(args.seed, cfg, device=device)
    if args.checkpoint:
        from raindrop_tpu_torch.train.checkpoint import load_checkpoint
        params, _, _ = load_checkpoint(args.checkpoint, params)
    server = InferenceServer(
        cfg, params, buckets=[int(b) for b in args.buckets.split(",")],
        transfer_dtype=args.transfer_dtype, device=device)
    httpd = make_http_server(server, args.host, args.port)
    print(f"serving {args.dataset} on http://{args.host}:{args.port} "
          f"({device}, buckets {server.buckets})")
    try:
        httpd.serve_forever()
    finally:
        server.close()


if __name__ == "__main__":
    main()
