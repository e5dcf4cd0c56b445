#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out details.json]

Phases, each of which fails the run (non-zero exit, no result line) when a
check does not hold:

  1. set-up: TF32 off for matmuls and cuDNN (the reference semantics are
     full f32), the card's name and power limit, the kernels built from
     raindrop_tpu_torch/csrc/ with nvcc (build seconds printed);
  2. flash_mha_packed forward, kernel against its plain PyTorch version at
     the P12 (B=128, T=215, d=160) and eICU (T=300, d=72) shapes, f32 and
     bf16 operands, ragged lengths including 0, 1 and T;
  3. fused_encoder_layer forward, the same at the PAM shape (B=128, T=600,
     d=84, ffn=136) on out, attn and lse;
  4. an InferenceServer for PAM at full width (random weights from a seed)
     answering predict on 1, 5, 128 and 200 rows, submit from 4 threads,
     predict_stream and the bf16 wire format, held against the same server
     on the dense plain path; it must have gone through the fused-layer
     kernel;
  5. the same for P12, which must have gone through flash_mha_packed.

Times are CUDA-event means over repeated launches after a warm-up. Bounds
use the H100 SXM data-sheet peaks (3.35 TB/s; 67 TFLOP/s f32 outside the
tensor cores, 989 TFLOP/s dense bf16); the card's power limit is printed
beside them. The line before the last is the kernels' JSON record, the
last line the result. `--out PATH` also writes every number to PATH as
JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def ragged_lengths(gen, B, T, device):
    import torch

    lengths = torch.randint(0, T + 1, (B,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[2] = 0, 1, T
    return lengths


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------------- kernels
def flash_phase(label, B, T, d, H, dtype, device="cuda", seed=0):
    """Kernel vs plain for flash_mha_packed's forward at one shape."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, T, d), generator=gen, device=device)
               for _ in range(3))
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    o_k, lse_k = fa._packed_fwd(q, k, v, lengths, None, 0.0, cd, H)
    o_p, lse_p = fa._packed_fwd_plain(q, k, v, lengths, H, od)
    torch.cuda.synchronize()
    err = max(max_err(o_k, o_p), max_err(lse_k, lse_p))
    ok = err <= TOL[dtype] and bool(torch.isfinite(o_k).all())
    print(f"[flash] {label} {dtype} B={B} T={T} d={d} H={H}: max_abs_err "
          f"{err:.3e} (tol {TOL[dtype]:g})", flush=True)
    if not ok:
        raise AssertionError(f"flash_mha_packed kernel disagrees at {label} {dtype}")

    # inputs already in the operand dtype, so the timed call is the launch
    qo, ko, vo = (x.to(od) for x in (q, k, v))
    ms = time_ms(lambda: fa._packed_fwd(qo, ko, vo, lengths, None, 0.0, cd, H))
    plain_ms = time_ms(lambda: fa._packed_fwd_plain(qo, ko, vo, lengths, H, od))
    live = lengths > 0
    hd = d // H
    qh, kh, vh = (x[live].reshape(-1, T, H, hd).transpose(1, 2).contiguous()
                  for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep))
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = 3 * B * T * d * esize + B * T * d * 4 + B * H * T * 4 + B * 4
    flops = 4.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    print(f"[flash] {label} {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return dict(label=label, dtype=dtype, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops)


def random_layer(gen, d, ffn, device):
    """A layer dict like nn/transformer._layer_init's, with every bias and
    LayerNorm parameter random so the kernels' use of each is checked."""
    import torch
    from raindrop_tpu_torch.nn.transformer import _layer_init

    p = _layer_init(gen, d, ffn, device)

    def r(n, base=0.0):
        return base + 0.1 * torch.randn((n,), generator=gen, device=device)

    p["in_proj_b"] = r(3 * d)
    p["out_proj"]["b"] = r(d)
    p["ln1"] = {"scale": r(d, 1.0), "bias": r(d)}
    p["ln2"] = {"scale": r(d, 1.0), "bias": r(d)}
    return p


def fused_phase(label, B, T, d, ffn, H, dtype, device="cuda", seed=0):
    """Kernel vs plain for fused_encoder_layer's forward at one shape."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    x = torch.randn((B, T, d), generator=gen, device=device)
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    got = fe._fused_fwd(p, x, lengths, None, 0.0, cd, H)
    want = fe._fused_fwd_plain(p, x, lengths, H, od)
    torch.cuda.synchronize()
    errs = {n: max_err(a, b) for n, a, b in zip(("out", "attn", "lse"), got, want)}
    err = max(errs.values())
    print(f"[fused] {label} {dtype} B={B} T={T} d={d} ffn={ffn} H={H}: "
          f"max_abs_err {errs} (tol {TOL[dtype]:g})", flush=True)
    if err > TOL[dtype] or not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"fused_encoder_layer kernel disagrees at {label} {dtype}")

    ms = time_ms(lambda: fe._fused_fwd(p, x, lengths, None, 0.0, cd, H))
    plain_ms = time_ms(lambda: fe._fused_fwd_plain(p, x, lengths, H, od))
    layer = torch.nn.TransformerEncoderLayer(
        d, H, ffn, dropout=0.0, batch_first=True, device=device).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(p["in_proj_w"])
        layer.self_attn.in_proj_bias.copy_(p["in_proj_b"])
        layer.self_attn.out_proj.weight.copy_(p["out_proj"]["w"])
        layer.self_attn.out_proj.bias.copy_(p["out_proj"]["b"])
        for mod, key in ((layer.linear1, "lin1"), (layer.linear2, "lin2")):
            mod.weight.copy_(p[key]["w"])
            mod.bias.copy_(p[key]["b"])
        for mod, key in ((layer.norm1, "ln1"), (layer.norm2, "ln2")):
            mod.weight.copy_(p[key]["scale"])
            mod.bias.copy_(p[key]["bias"])
    live = lengths > 0
    xl = x[live].to(od)
    layer = layer.to(od)
    pad = (torch.arange(T, device=device)[None, :] >= lengths[live][:, None])
    with torch.no_grad():
        library_ms = time_ms(lambda: layer(xl, src_key_padding_mask=pad))
    hd = d // H
    esize = 2 if dtype == "bfloat16" else 4
    weights = (4 * d * d + 2 * d * ffn) * esize + (3 * d + 6 * d + ffn) * 4
    nbytes = B * T * d * 4 * 3 + B * H * T * 4 + B * 4 + weights
    dense = 2.0 * B * T * (3 * d * d + d * d + 2 * d * ffn)
    flops = dense + 4.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    # the qkv intermediate the two-launch design writes and reads back
    qkv_bytes = 2 * B * T * 3 * d * 4
    print(f"[fused] {label} {dtype}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, TransformerEncoderLayer {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); qkv round trip {qkv_bytes / 1e6:.1f} MB",
          flush=True)
    return dict(label=label, dtype=dtype, max_abs_err=err, errs=errs, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops,
                qkv_roundtrip_bytes=qkv_bytes)


# ----------------------------------------------------------------- serving
def make_requests(cfg, n, seed):
    """Synthetic batch-major requests: ragged lengths in 1..T, zero times
    past each length, z-scored values where observed."""
    rng = np.random.default_rng(seed)
    T, F = cfg.max_len, cfg.d_inp
    lengths = rng.integers(1, T + 1, size=n)
    live = np.arange(T)[None, :] < lengths[:, None]
    mask = ((rng.uniform(size=(n, T, F)) > 0.6) & live[..., None]).astype(np.float32)
    P = np.concatenate(
        [rng.normal(size=(n, T, F)).astype(np.float32) * mask, mask], -1)
    times = (np.cumsum(rng.uniform(0.1, 1.0, size=(n, T)), 1) * live).astype(np.float32)
    static = (rng.normal(size=(n, cfg.d_static)).astype(np.float32)
              if cfg.static else None)
    return P, times, static


def _rows(x, sl):
    return None if x is None else x[sl]


def serve_phase(dataset, kernel_fn, wrappers, device="cuda", seed=0,
                cfg_overrides=None, buckets=(1, 8, 32, 128)):
    """Serve one preset at full width and check it. Every wrapper's launch
    count is set to 0 just before the served requests and read just after;
    returns those counts by wrapper name. `kernel_fn` is the wrapper this
    preset's path must go through."""
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer

    kw = dict(cfg_overrides or {})
    cfg = dataset_config(dataset, **kw)
    params = raindrop_init(seed, cfg, device=device)
    server = InferenceServer(cfg, params, buckets=buckets, device=device)
    top = buckets[-1]
    P, times, static = make_requests(cfg, top + 72, seed + 1)

    t0 = time.perf_counter()
    for fn in wrappers:
        fn.launches = 0
    outs = {n: server.predict(P[:n], times[:n], _rows(static, slice(0, n)))
            for n in (1, 5, top, top + 72)}
    results = [None] * 4

    def client(i):
        sl = slice(10 * i, 10 * i + 7)
        results[i] = server.submit(P[sl], times[sl], _rows(static, sl),
                                   timeout=300)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"{dataset}: submit from 4 threads did not finish")
    reqs = [(P[s:s + 8], times[s:s + 8], _rows(static, slice(s, s + 8)))
            for s in range(0, 48, 8)]
    streamed = list(server.predict_stream(reqs, depth=3))
    wire = InferenceServer(cfg, server.params, buckets=buckets, device=device,
                           transfer_dtype="bfloat16")
    wire_probs = wire.predict(P[:top], times[:top], _rows(static, slice(0, top)))
    launches = {fn.__name__: fn.launches for fn in wrappers}
    served_s = time.perf_counter() - t0
    wire.close()
    print(f"[serve] {dataset}: served in {served_s:.3f} s, launches "
          f"{launches}; health {server.health()}", flush=True)

    full = outs[top + 72]
    all_probs = [*outs.values(), *results, *streamed, wire_probs]
    for pr in all_probs:
        if not np.isfinite(pr).all() or np.abs(pr.sum(-1) - 1).max() > 1e-5:
            raise AssertionError(f"{dataset}: probabilities not finite or not "
                                 f"summing to 1")
    checks = {
        "alone_vs_full_bucket": float(np.abs(outs[1][0] - outs[top][0]).max()),
        "predict_vs_chunked": float(np.abs(outs[top] - full[:top]).max()),
        "submit_vs_predict": max(float(np.abs(results[i] - full[10 * i:10 * i + 7]).max())
                                 for i in range(4)),
        "stream_vs_predict": float(np.abs(np.concatenate(streamed) - full[:48]).max()),
        "bf16_wire_vs_f32": float(np.abs(wire_probs - outs[top]).max()),
    }
    limits = {"alone_vs_full_bucket": 1e-5, "predict_vs_chunked": 1e-5,
              "submit_vs_predict": 1e-5, "stream_vs_predict": 1e-5,
              "bf16_wire_vs_f32": 5e-2}

    # the same params on the dense plain path, and the kernel path with
    # f32 attention operands
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        c_k = dataset_config(dataset, **{**kw, "attention_score_dtype": score})
        c_d = dataset_config(dataset, **{**kw, "attention_backend": "dense",
                                         "attention_score_dtype": score})
        s_k = InferenceServer(c_k, server.params, buckets=buckets, device=device)
        s_d = InferenceServer(c_d, server.params, buckets=buckets, device=device)
        a = s_k.predict(P[:top], times[:top], _rows(static, slice(0, top)))
        b = s_d.predict(P[:top], times[:top], _rows(static, slice(0, top)))
        checks[f"kernel_vs_dense_{score}"] = float(np.abs(a - b).max())
        limits[f"kernel_vs_dense_{score}"] = tol
    print(f"[serve] {dataset}: checks {checks}", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{dataset}: checks over their limits: {bad} "
                             f"(limits {limits})")
    if launches[kernel_fn.__name__] <= 0:
        raise AssertionError(f"{dataset}: the served path never launched "
                             f"{kernel_fn.__name__}")
    timing = serve_timing(dataset, server, P, times, static)
    server.close()
    return launches, dict(served_s=served_s, checks=checks, limits=limits,
                          **timing)


def serve_timing(dataset, server, P, times, static, reps=7):
    """Request latency by bucket (host clock around predict, which ends in
    the device-to-host copy) and a profile of the top bucket: device time
    by kernel and the device's idle share of the request's wall time."""
    import torch

    latency = {}
    for n in server.buckets:
        args = (P[:n], times[:n], _rows(static, slice(0, n)))
        server.predict(*args)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            server.predict(*args)
            ts.append(1e3 * (time.perf_counter() - t0))
        latency[n] = float(np.median(ts))
    top = server.buckets[-1]
    args = (P[:top], times[:top], _rows(static, slice(0, top)))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            server.predict(*args)
        wall_ms = 1e3 * (time.perf_counter() - t0) / 3
    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", 0.0)
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 3e3
    device_ms = sum(kernels.values())
    top_k = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    idle = 1.0 - device_ms / wall_ms if device_ms > 0 else None
    print(f"[serve] {dataset}: predict latency ms by bucket {latency}; top "
          f"bucket profiled: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"idle share {idle}", flush=True)
    for name, ms in top_k.items():
        print(f"[serve] {dataset}:   {ms:8.4f} ms  {name[:100]}", flush=True)
    return dict(latency_ms=latency, profile_wall_ms=wall_ms,
                profile_device_ms=device_ms, idle_share=idle,
                device_ms_by_kernel=top_k)


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number measured to this JSON file")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from raindrop_tpu_torch.kernels import build
        from raindrop_tpu_torch.ops.flash_attention import flash_mha_packed
        from raindrop_tpu_torch.ops.fused_encoder import fused_encoder_layer
    except ImportError as e:
        print(f"chip_smoke: the raindrop_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set-up: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False", flush=True)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {list(build.SOURCES)}", flush=True)

    flash = [flash_phase("P12", 128, 215, 160, 2, dt) for dt in ("float32", "bfloat16")]
    flash += [flash_phase("eICU", 128, 300, 72, 2, dt) for dt in ("float32", "bfloat16")]
    fused = [fused_phase("PAM", 128, 600, 84, 136, 2, dt)
             for dt in ("float32", "bfloat16")]

    wrappers = (flash_mha_packed, fused_encoder_layer)
    pam_launches, pam = serve_phase("PAM", fused_encoder_layer, wrappers)
    p12_launches, p12 = serve_phase("P12", flash_mha_packed, wrappers)

    # the kernels' record at the main path's shapes and operand dtype
    # (attention_score_dtype defaults to bfloat16)
    def record(name, source, replaces, launches, runs, label):
        main_run = next(r for r in runs if r["label"] == label
                        and r["dtype"] == "bfloat16")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in runs),
                "ms": main_run["ms"], "plain_ms": main_run["plain_ms"],
                "bound_ms": main_run["bound_ms"],
                "bound_by": main_run["bound_by"],
                "library_ms": main_run["library_ms"]}

    kernels = [
        record("flash_mha_packed_fwd", "raindrop_tpu_torch/csrc/flash_packed.cu",
               "raindrop_tpu/ops/flash_attention.py:566",
               p12_launches["flash_mha_packed"], flash,
               "P12"),
        record("fused_encoder_layer_fwd", "raindrop_tpu_torch/csrc/fused_encoder.cu",
               "raindrop_tpu/ops/fused_encoder.py:131",
               pam_launches["fused_encoder_layer"], fused,
               "PAM"),
    ]
    detail = {"card": card, "build_s": build_s, "flash": flash, "fused": fused,
              "serve": {"PAM": {"launches": pam_launches, **pam},
                        "P12": {"launches": p12_launches, **p12}},
              "kernels": kernels}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)

    name = torch.cuda.get_device_name(0)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
