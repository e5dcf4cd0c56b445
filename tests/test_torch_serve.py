"""InferenceServer of the port, on the CPU: buckets, chunking, concurrent
submit, predict_stream, the bf16 wire, HTTP, and agreement with the JAX
InferenceServer for the same parameters."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.serve import InferenceServer as JaxInferenceServer

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply
from raindrop_tpu_torch.serve import InferenceServer, make_http_server

BUCKETS = (2, 4)


@pytest.fixture(scope="module")
def small():
    jparams = jax_raindrop_init(jax.random.PRNGKey(0),
                                jax_dataset_config("P19", max_len=8))
    cfg = dataset_config("P19", max_len=8)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    server = InferenceServer(cfg, params, buckets=BUCKETS, device="cpu")
    yield cfg, params, jparams, server
    server.close()


def _request(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    T, F = cfg.max_len, cfg.d_inp
    lengths = rng.integers(1, T + 1, size=n)
    live = np.arange(T)[None, :] < lengths[:, None]
    mask = ((rng.uniform(size=(n, T, F)) > 0.5) & live[..., None]).astype(np.float32)
    P = np.concatenate(
        [rng.normal(size=(n, T, F)).astype(np.float32) * mask, mask], -1)
    times = (np.cumsum(rng.uniform(0.1, 1.0, size=(n, T)), 1) * live).astype(np.float32)
    static = rng.normal(size=(n, cfg.d_static)).astype(np.float32)
    return P, times, static


def _direct(cfg, params, P, times, static):
    tm = torch.from_numpy(times).T
    logits, _ = raindrop_apply(params, cfg, torch.from_numpy(P).transpose(0, 1),
                               torch.from_numpy(static), tm, (tm > 0).sum(0))
    return torch.softmax(logits, -1).numpy()


@pytest.mark.parametrize("n", [0, 1, 3, 5, BUCKETS[-1] + 3])
def test_predict_pads_and_chunks(small, n):
    cfg, params, _, server = small
    P, times, static = _request(cfg, n, seed=n)
    probs = server.predict(P, times, static)
    assert probs.shape == (n, cfg.n_classes)
    if n:
        np.testing.assert_allclose(probs, _direct(cfg, params, P, times, static),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)


def test_bucket_padding_does_not_change_a_sample(small):
    cfg, _, _, server = small
    P, times, static = _request(cfg, 4, seed=11)
    alone = server.predict(P[:1], times[:1], static[:1])
    full = server.predict(P, times, static)
    np.testing.assert_allclose(alone, full[:1], rtol=1e-5, atol=1e-6)


def test_probabilities_equal_the_jax_server(small):
    cfg, _, jparams, server = small
    jserver = JaxInferenceServer(jax_dataset_config("P19", max_len=8), jparams,
                                 buckets=BUCKETS, precompile=False)
    P, times, static = _request(cfg, 7, seed=3)
    np.testing.assert_allclose(server.predict(P, times, static),
                               jserver.predict(P, times, static),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prop_backend", ["pallas", "coo"])
def test_graph_backends_equal_the_jax_server(small, prop_backend):
    """The server takes the config as it is: prop_backend 'pallas' (the
    SpMM wrapper, its plain version here) and 'coo' serve the same
    probabilities as the JAX server with that backend."""
    _, params, jparams, _ = small
    kw = dict(max_len=8, prop_backend=prop_backend)
    server = InferenceServer(dataset_config("P19", **kw), params, buckets=BUCKETS,
                             device="cpu")
    jserver = JaxInferenceServer(jax_dataset_config("P19", **kw), jparams,
                                 buckets=BUCKETS, precompile=False)
    P, times, static = _request(server.cfg, 5, seed=4)
    try:
        np.testing.assert_allclose(server.predict(P, times, static),
                                   jserver.predict(P, times, static),
                                   rtol=1e-5, atol=1e-6)
    finally:
        server.close()


def test_concurrent_submit_matches_predict(small):
    cfg, _, _, server = small
    reqs = [_request(cfg, 1 + i % 3, seed=20 + i) for i in range(8)]
    out = [None] * len(reqs)

    def client(i):
        out[i] = server.submit(*reqs[i], timeout=60)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for r, got in zip(reqs, out):
        np.testing.assert_allclose(got, server.predict(*r), rtol=1e-5, atol=1e-6)
    assert server.health()["coalesced_requests"] >= 1


def test_predict_stream_in_order(small):
    cfg, _, _, server = small
    reqs = [_request(cfg, 1 + i % BUCKETS[-1], seed=40 + i) for i in range(5)]
    streamed = list(server.predict_stream(reqs, depth=2))
    assert len(streamed) == len(reqs)
    for r, got in zip(reqs, streamed):
        np.testing.assert_allclose(got, server.predict(*r), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        list(server.predict_stream([_request(cfg, BUCKETS[-1] + 1)]))


def test_bf16_wire_is_close(small):
    cfg, params, _, server = small
    wire = InferenceServer(cfg, params, buckets=BUCKETS, device="cpu",
                           transfer_dtype="bfloat16")
    P, times, static = _request(cfg, 4, seed=5)
    # bf16 keeps ~3 significant digits of each input
    np.testing.assert_allclose(wire.predict(P, times, static),
                               server.predict(P, times, static), atol=2e-2)
    with pytest.raises(ValueError):
        InferenceServer(cfg, params, device="cpu", transfer_dtype="float16")


def test_http_round_trip(small):
    cfg, _, _, server = small
    httpd = make_http_server(server, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        port = httpd.server_address[1]
        P, times, static = _request(cfg, 3, seed=7)
        body = json.dumps({"P": P.tolist(), "times": times.tolist(),
                           "static": static.tolist()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            probs = np.asarray(json.loads(resp.read())["probs"])
        np.testing.assert_allclose(probs, server.predict(P, times, static),
                                   rtol=1e-5, atol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    assert not th.is_alive()


@pytest.mark.parametrize("depth", [4, 1])
def test_close_returns_in_time_when_a_readback_hangs(small, depth):
    """A readback that never returns: close() still returns within its
    timeout and fails every pending caller with 'server closed'. With a
    pipeline depth of 1 the second group waits for a slot behind the hung
    one (in _dispatch_group) and fails the same way."""
    import time
    from concurrent.futures import wait

    cfg, params, _, _ = small
    server = InferenceServer(cfg, params, buckets=BUCKETS, device="cpu")
    server._pipeline_depth = depth
    server._inflight = threading.Semaphore(depth)
    server._close_timeout_s = 1.0
    release = threading.Event()
    server._fetch = lambda dev: (release.wait(), dev.numpy())[1]
    P, times, static = _request(cfg, 3, seed=11)

    def pending(n):   # wait until the batcher holds n groups
        deadline = time.monotonic() + 30
        while len(server._pending) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(server._pending) == n

    # the second request arrives after the first was dispatched: two groups
    first = server.submit_async(P[:2], times[:2], static[:2])
    pending(1)
    second = server.submit_async(P[2:], times[2:], static[2:])
    pending(2)
    try:
        t0 = time.monotonic()
        server.close()
        took = time.monotonic() - t0
        assert took < 1.0 + 0.5, took
        done, _ = wait([first, second], timeout=0)
        assert len(done) == 2
        for fut in (first, second):
            with pytest.raises(RuntimeError, match="server closed"):
                fut.result(timeout=0)
        with pytest.raises(RuntimeError, match="server closed"):
            server.submit_async(P[:1], times[:1], static[:1])
    finally:
        release.set()      # let the hung pool thread end
