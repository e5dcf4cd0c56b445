#!/usr/bin/env python3
"""Compare checkouts of the PyTorch port on one NVIDIA GPU, in turns.

    python3 chip_ab.py --run ROOT:TASKS [--run ROOT:TASKS ...] [--out FILE]

Each --run is one process on the checkout at ROOT (a directory holding
chip_smoke.py and raindrop_tpu_torch/), doing the comma-separated TASKS in
order with that checkout's own code:

  build       nvcc-build the flash_packed library from a clean build
              directory (seconds, wall clock);
  one_unit    compile every unit of flash_packed in a single nvcc process
              (seconds; where the library is built from several units);
  kernels     flash_mha_packed in bf16 at P12 (B=128, T=215, d=160),
              eICU (T=300, d=72), P12 at B=1 (the smallest served
              bucket) and P12-sw (T=215, d=720: hd 360, the two-warpgroup
              route past hd_pad 144; the scalar Wide kernels in a
              checkout without it), 2 heads, ragged lengths: the forward
              (dropout 0) and the backward (dropout 0.2), checked against
              the plain version, timed by CUDA events (20 calls) and by
              torch.profiler device time, plus the host time of a call;
              then fused_encoder_layer in bf16 at PAM (B=128, T=600, d=84,
              ffn=136) and PAM-sw (d=340), 2 heads: the forward (dropout
              0; out against the plain version) and the backward (dropout
              0.2), the same three times (5 and 3 calls);
  serve_train chip_smoke.serve_phase and train_phase for P12 (latency by
              bucket, step ms, device ms, idle share);
  latency     a P12 server (random weights from seed 0): request latency
              by bucket, the median of 31 requests, and the top bucket's
              device time and idle share (chip_smoke.serve_timing);
  split       flash_mha at PAM's width on a 2048-step window (B=128, H=2,
              D=42, bf16, ragged lengths): the forward (dropout 0) and the
              backward (dropout 0.2) timed by CUDA events (10 calls);
  bits        flash_mha forward and backward at head dims 8, 42 and 128
              (each column count of the Narrow geometry), T 600 and 2048,
              f32 and bf16 operands, dropout 0.2, B=8, H=2: a SHA-256 of
              the bytes of o, lse, dq, dk and dv; the same of
              flash_mha_packed at P12 (T=215, d=160), eICU (T=300, d=72)
              and eICU-sw (d=280) in bf16 (the one-warpgroup tensor-core
              route) and at P12-sw (d=720) in f32 (the scalar route),
              dropout 0 and 0.2, B=8, 2 heads; and fused_encoder_layer
              with f32 operands at PAM's width (d=84) and PAM-sw's (340),
              ffn=136, 2 heads, T 100 and 600, dropout 0 and 0.2, B=8: a
              SHA-256 of out, attn, lse, dx and the 12 weight gradients;
              to compare checkouts bit for bit;
  sample_err  the largest chip_smoke.sample_err of o and of each gradient
              against the plain version, by test and operand dtype, on the
              inputs of the attention tests in
              tests/test_torch_kernels_cuda.py (flash_mha_packed backward,
              its tensor-core route against the scalar one, flash_mha at
              hd <= 128 and past it) and at the main path's shape (B=16,
              H=2, T=2048, hd 42, 170 and 360, dropout 0 and 0.2, the plain
              version on 8 samples): the readings SAMPLE_TOL is set from;
  ptxas       compile every unit of the five kernel libraries with
              `-Xptxas -v` (all nvcc processes together): registers, stack
              frame and spill bytes of each kernel, the spilling ones
              printed, and every flash_mha kernel (split_*_kernel, each
              geometry and column count), every tensor-core kernel of
              the fused layer (*_tc*, pack_weights_kernel) and every
              two-warpgroup packed kernel (packed_*_wide) printed.

Give the runs in an order that favours no checkout (A B B A). Each task
prints `TASK name {...}` when it ends and each run `RESULT {...}`; --out
writes the runs as a JSON list. A run that fails is recorded with its
error and the tasks it finished, and the others go on.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SHAPES = (("P12", 128, 215, 160, 2), ("eICU", 128, 300, 72, 2), ("P12-B1", 1, 215, 160, 2),
          ("P12-sw", 128, 215, 720, 2))


def _load_smoke(root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def task_build(root, cs):
    from raindrop_tpu_torch.kernels import build

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    build.build(["flash_packed"])
    return {"build_s": time.perf_counter() - t0}


def task_one_unit(root, cs):
    from raindrop_tpu_torch.kernels import build

    units = [str(u) for u in build._units("flash_packed")]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "one_unit.cu")
        with open(src, "w") as f:
            f.writelines(f'#include "{u}"\n' for u in units)
        t0 = time.perf_counter()
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                               "-o", os.path.join(tmp, "one_unit.so"), src],
                              capture_output=True, text=True)
        took = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"one-unit build failed:\n{proc.stdout}{proc.stderr}")
    return {"units": len(units), "one_unit_build_s": took}


def task_kernels(root, cs):
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    od = torch.bfloat16
    out = {}
    for label, B, T, d, H in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda").to(od)
                      for _ in range(4))
        lengths = (cs.ragged_lengths(gen, B, T, "cuda") if B >= 3
                   else torch.full((B,), T, dtype=torch.int32, device="cuda"))
        o, lse = fa._packed_fwd_cuda(q, k, v, lengths, cs.SEED, 0.2, H, od)
        want = fa._packed_fwd_plain(q, k, v, lengths, H, od, cs.SEED, 0.2)
        err = max(cs.max_err(o, want[0]), cs.max_err(lse, want[1]))
        if err > cs.TOL["bfloat16"]:
            raise AssertionError(f"{label}: forward disagrees with the plain version: {err}")
        calls = {
            "fwd": lambda: fa._packed_fwd_cuda(q, k, v, lengths, 0, 0.0, H, od),
            "bwd": lambda: fa._packed_bwd_cuda(q, k, v, lengths, cs.SEED, 0.2, H, od,
                                               o, lse, g),
        }
        for name, fn in calls.items():
            ms = cs.time_ms(fn)
            fn()
            device_ms = cs.profile_device(lambda: [fn() for _ in range(20)], 20)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0) / 50
            torch.cuda.synchronize()
            out[f"{label}_{name}"] = {"ms": ms, "device_ms": device_ms,
                                      "host_ms": host_ms}
            print(f"[ab] {root}: {label} bf16 {name}: {ms:.4f} ms by events, device "
                  f"{device_ms:.4f} ms, host {host_ms:.4f} ms a call", flush=True)
    out.update(_fused_times(root, cs))
    return out


def _fused_times(root, cs):
    """fused_encoder_layer in bf16 at PAM and PAM-sw, B=128: forward and
    backward by events, device time and host time a call."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe

    out, od = {}, torch.bfloat16
    for label, d in (("PAM", 84), ("PAM-sw", 340)):
        B, T, ffn, H = 128, 600, 136, 2
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = cs.random_layer(gen, d, ffn, "cuda")
        x, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(2))
        lengths = cs.ragged_lengths(gen, B, T, "cuda")
        ws = fe._flatten(p)
        got = fe._fused_fwd_cuda(ws, x, lengths, 0, 0.0, H, od)
        want = fe._fused_fwd_plain(p, x, lengths, H, od)
        err = cs.sample_err(got[0], want[0], lengths)
        if err > cs.SAMPLE_TOL["bfloat16"]:
            raise AssertionError(f"fused {label}: out disagrees with the plain version: {err}")
        _, attn, lse = fe._fused_fwd_cuda(ws, x, lengths, cs.SEED, 0.2, H, od)
        calls = {
            "fused_fwd": (lambda: fe._fused_fwd_cuda(ws, x, lengths, 0, 0.0, H, od), 5),
            "fused_bwd": (lambda: fe._fused_bwd_cuda(ws, x, lengths, cs.SEED, 0.2, H, od,
                                                     attn, lse, g), 3),
        }
        for name, (fn, reps) in calls.items():
            ms = cs.time_ms(fn, reps=reps, warmup=1)
            fn()
            device_ms = cs.profile_device(lambda: [fn() for _ in range(reps)], reps)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0) / reps
            torch.cuda.synchronize()
            out[f"{label}_{name}"] = {"ms": ms, "device_ms": device_ms, "host_ms": host_ms}
            print(f"[ab] {root}: {label} bf16 {name}: {ms:.4f} ms by events, device "
                  f"{device_ms:.4f} ms, host {host_ms:.4f} ms a call", flush=True)
        torch.cuda.empty_cache()
    return out


def task_serve_train(root, cs):
    from raindrop_tpu_torch.ops.flash_attention import flash_mha, flash_mha_packed
    from raindrop_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from raindrop_tpu_torch.ops.sparse import sddmm, spmm_segment_softmax

    wrappers = (flash_mha_packed, fused_encoder_layer, spmm_segment_softmax, sddmm,
                flash_mha)
    launches, serve = cs.serve_phase("P12", [flash_mha_packed], wrappers)
    tf, tb, train = cs.train_phase("P12", [flash_mha_packed], wrappers)
    keep = ("profile_wall_ms", "profile_device_ms", "idle_share", "device_ms_by_kernel")
    return {"serve": {"launches": launches,
                      **{k: serve[k] for k in ("latency_ms", *keep)}},
            "train": {"launches": tf, "bwd_launches": tb,
                      **{k: train[k] for k in ("step_ms", "step_ms_median", "epoch_ms",
                                               "samples_per_s", *keep)}}}


def task_latency(root, cs):
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer

    cfg = dataset_config("P12")
    server = InferenceServer(cfg, raindrop_init(0, cfg, device="cuda"),
                             buckets=(1, 8, 32, 128), device="cuda")
    P, times, static = cs.make_requests(cfg, 128, 1)
    timing = cs.serve_timing("P12", server, P, times, static, reps=31)
    server.close()
    return {k: timing[k] for k in ("latency_ms", "profile_wall_ms", "profile_device_ms",
                                   "idle_share")}


def task_split(root, cs):
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    B, H, T, D, od = 128, 2, 2048, 42, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (x.to(od) for x in cs._head_views(gen, B, H, T, D, 4, "cuda"))
    lengths = cs.ragged_lengths(gen, B, T, "cuda")
    o, lse = fa._flash_fwd_cuda(q, k, v, lengths, cs.SEED, 0.2, od)
    out = {
        "fwd_ms": cs.time_ms(lambda: fa._flash_fwd_cuda(q, k, v, lengths, 0, 0.0, od),
                             reps=10, warmup=2),
        "bwd_ms": cs.time_ms(lambda: fa._flash_bwd_cuda(q, k, v, lengths, cs.SEED, 0.2, od,
                                                        o, lse, g), reps=10, warmup=2)}
    print(f"[ab] {root}: flash_mha B={B} T={T} D={D} bf16: forward {out['fwd_ms']:.4f} ms, "
          f"backward {out['bwd_ms']:.4f} ms", flush=True)
    return out


def task_bits(root, cs):
    import hashlib

    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    out = {}
    for D in (8, 42, 128):
        for T in (600, 2048):
            gen = torch.Generator(device="cuda").manual_seed(D + T)
            q, k, v, g = cs._head_views(gen, 8, 2, T, D, 4, "cuda")
            lengths = cs.ragged_lengths(gen, 8, T, "cuda")
            for cd in (None, "bfloat16"):
                o, lse = fa._flash_fwd(q, k, v, lengths, cs.SEED, 0.2, cd)
                grads = fa._flash_bwd_cuda(q, k, v, lengths, cs.SEED, 0.2,
                                           fa.operand_dtype(cd), o, lse, g)
                h = hashlib.sha256()
                for x in (o, lse, *grads):
                    h.update(x.contiguous().cpu().numpy().tobytes())
                out[f"D{D}_T{T}_{cd or 'float32'}"] = h.hexdigest()
    out.update(_packed_bits(cs))
    out.update(_fused_bits(cs))
    print(f"[ab] {root}: bits {out}", flush=True)
    return out


def _packed_bits(cs):
    """SHA-256 of flash_mha_packed's o, lse, dq, dk and dv on the routes
    this comparison holds still: the one-warpgroup tensor cores (bf16 at
    P12, eICU, eICU-sw) and the scalar kernels (f32 at P12-sw)."""
    import hashlib

    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    out = {}
    for label, T, d, cd in (("P12", 215, 160, "bfloat16"), ("eICU", 300, 72, "bfloat16"),
                            ("eICU-sw", 300, 280, "bfloat16"), ("P12-sw", 215, 720, None)):
        for rate in (0.0, 0.2):
            gen = torch.Generator(device="cuda").manual_seed(d + T)
            q, k, v, g = (torch.randn((8, T, d), generator=gen, device="cuda")
                          for _ in range(4))
            lengths = cs.ragged_lengths(gen, 8, T, "cuda")
            o, lse = fa._packed_fwd(q, k, v, lengths, cs.SEED, rate, cd, 2)
            grads = fa._packed_bwd_cuda(q, k, v, lengths, cs.SEED, rate, 2,
                                        fa.operand_dtype(cd), o, lse, g)
            h = hashlib.sha256()
            for x in (o, lse, *grads):
                h.update(x.contiguous().cpu().numpy().tobytes())
            out[f"packed_{label}_rate{rate}_{cd or 'float32'}"] = h.hexdigest()
    return out


def _fused_bits(cs):
    """SHA-256 of the f32 fused layer's out, attn, lse, dx and 12 weight
    gradients at PAM's and PAM-sw's widths."""
    import hashlib

    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe

    out = {}
    for d in (84, 340):
        for T in (100, 600):
            for rate in (0.0, 0.2):
                gen = torch.Generator(device="cuda").manual_seed(d + T)
                p = cs.random_layer(gen, d, 136, "cuda")
                x, g = (torch.randn((8, T, d), generator=gen, device="cuda")
                        for _ in range(2))
                lengths = cs.ragged_lengths(gen, 8, T, "cuda")
                lengths[3] = 45
                fwd = fe._fused_fwd(p, x, lengths, cs.SEED, rate, None, 2)
                dx, dws = fe._fused_bwd_cuda(fe._flatten(p), x, lengths, cs.SEED, rate, 2,
                                             torch.float32, fwd[1], fwd[2], g)
                h = hashlib.sha256()
                for t in (*fwd, dx, *dws):
                    h.update(t.contiguous().cpu().numpy().tobytes())
                out[f"fused_d{d}_T{T}_rate{rate}_float32"] = h.hexdigest()
    return out


def task_sample_err(root, cs):
    import itertools

    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    # the card tests import test_torch_packed_plan's mirror, as pytest
    # would with tests/ on the path
    sys.path.insert(0, os.path.join(root, "tests"))
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(root, "tests", "test_torch_kernels_cuda.py"))
    tk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tk)
    out = {}

    def note(test, cd, names, got, want, lengths):
        for n, a, b in zip(names, got, want):
            key = f"{test} {cd or 'float32'} {n}"
            out[key] = max(out.get(key, 0.0), cs.sample_err(a, b, lengths))

    def gen():          # the tests' fixture: a generator seeded 0 per case
        return torch.Generator(device="cuda").manual_seed(0)

    for (T, d, nh), cd, rate in itertools.product(tk.PACKED_SHAPES, (None, "bfloat16"),
                                                  (0.0, 0.2)):
        g_ = gen()
        q, k, v, g = (torch.randn((5, T, d), generator=g_, device="cuda") for _ in range(4))
        L = tk._lengths(g_, 5, T)
        od = fa.operand_dtype(cd)
        o, lse = fa._packed_fwd(q, k, v, L, cs.SEED, rate, cd, nh)
        args = (q, k, v, L, cs.SEED, rate, nh, od, o, lse, g)
        note("packed", cd, ("dq", "dk", "dv"), fa._packed_bwd_cuda(*args),
             fa._packed_bwd_plain(*args), L)
        if cd:
            note("tc_vs_scalar", cd, ("dq", "dk", "dv"), fa._packed_bwd_cuda(*args),
                 fa._packed_bwd_cuda(*args, impl="scalar"), L)

    def split(test, B, H, T, D, layout, cd, rate, lengths_fn):
        g_ = gen()
        q, k, v = tk._head_inputs(g_, B, H, T, D, layout)
        g = torch.randn((B, H, T, D), generator=g_, device="cuda")
        L = lengths_fn(g_, B, T)
        od = fa.operand_dtype(cd)
        o, lse = fa._flash_fwd(q, k, v, L, cs.SEED, rate, cd)
        args = (q, k, v, L, cs.SEED, rate, od, o, lse, g)
        note(test, cd, ("o", "dq", "dk", "dv"), (o, *fa._flash_bwd_cuda(*args)),
             (fa._flash_fwd_plain(q, k, v, L, od, cs.SEED, rate)[0],
              *fa._flash_bwd_plain(*args)), L)

    for (T, H, D), layout, cd, rate in itertools.product(
            ((13, 2, 8), (70, 2, 42), (600, 2, 42), (1152, 2, 42), (200, 1, 128)),
            ("contiguous", "projection"), (None, "bfloat16"), (0.0, 0.2)):
        split("split", 4, H, T, D, layout, cd, rate, tk._lengths)
    for D, T, layout, cd, rate in itertools.product(
            tk.WIDE_SPLIT_HD, (65, 1025, 2048), ("contiguous", "projection"),
            (None, "bfloat16"), (0.0, 0.2)):
        split("wide", 5, 2, T, D, layout, cd, rate, tk._wide_lengths)
    for D, dtype, rate in itertools.product((42, 170, 360), ("float32", "bfloat16"),
                                            (0.0, 0.2)):
        gen_ = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, g = cs._head_views(gen_, 16, 2, 2048, D, 4, "cuda")
        L = cs.ragged_lengths(gen_, 16, 2048, "cuda")
        errs = cs.check_flash_mha(q, k, v, g, L, dtype, rate, 8, f"hd={D}")[3]
        for n, e in errs.items():
            key = f"T2048_hd{D} {dtype} {n}"
            out[key] = max(out.get(key, 0.0), e)
        torch.cuda.empty_cache()
    for key, e in out.items():
        print(f"[ab] sample_err {key}: {e:.3e}", flush=True)
    return out


def task_ptxas(root, cs):
    import re
    from raindrop_tpu_torch.kernels import build

    units = [u for name in build.SOURCES for u in build._units(name)]
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([build._nvcc(), *flags, "-Xptxas", "-v", "-I",
                                   str(build.CSRC), "-c", "-o",
                                   os.path.join(tmp, f"{u.stem}.o"), str(u)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for u in units]
        logs = [proc.communicate()[0] for proc in procs]
    for u, proc, log in zip(units, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {u.name}:\n{log}")
    kernels, name = {}, None
    for u, log in zip(units, logs):
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and name:
                kernels[name] = dict(unit=u.stem, stack=int(m[1]), spill_stores=int(m[2]),
                                     spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and name in kernels:
                kernels[name]["registers"] = int(m[1])
    names = list(kernels)
    filt = shutil.which("cu++filt", path=os.path.dirname(build._nvcc())) or shutil.which("c++filt")
    if filt:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            kernels = {d: kernels[n] for n, d in zip(names, out.stdout.splitlines())}
    spilling = {k: v for k, v in kernels.items() if v["spill_stores"] or v["spill_loads"]}
    for k, v in spilling.items():
        print(f"[ptxas] spills: {v} {k[:160]}", flush=True)
    split = {k: v for k, v in kernels.items() if "split_" in k}
    for k, v in split.items():
        print(f"[ptxas] flash_mha: {v} {k[:160]}", flush=True)
    fused = {k: v for k, v in kernels.items() if v["unit"].startswith("fused_encoder")
             and ("_tc" in k or "pack_weights" in k)}
    for k, v in fused.items():
        print(f"[ptxas] fused tensor cores: {v} {k[:160]}", flush=True)
    wide = {k: v for k, v in kernels.items() if v["unit"].endswith("_wide")}
    for k, v in wide.items():
        print(f"[ptxas] packed past hd_pad 144: {v} {k[:160]}", flush=True)
    return {"kernels": len(kernels), "spilling": len(spilling),
            "max_registers": max(v.get("registers", 0) for v in kernels.values()),
            "split_kernels": len(split),
            "split_spilling": sum(1 for v in split.values()
                                  if v["spill_stores"] or v["spill_loads"]),
            "fused_tc_kernels": len(fused),
            "fused_tc_spilling": sum(1 for v in fused.values()
                                     if v["spill_stores"] or v["spill_loads"]),
            "packed_wide_kernels": len(wide),
            "packed_wide_spilling": sum(1 for v in wide.values()
                                        if v["spill_stores"] or v["spill_loads"]),
            "by_kernel": kernels}


TASKS = {"build": task_build, "one_unit": task_one_unit, "kernels": task_kernels,
         "serve_train": task_serve_train, "latency": task_latency, "split": task_split,
         "bits": task_bits, "sample_err": task_sample_err, "ptxas": task_ptxas}


def worker(root, tasks):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _load_smoke(root)
    result = {"root": root, "tasks": tasks}
    for name in tasks:
        result[name] = TASKS[name](root, cs)
        print(f"TASK {name} " + json.dumps(result[name]), flush=True)
    print("RESULT " + json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", default=[],
                    help="ROOT:TASKS, TASKS comma-separated from " + ", ".join(TASKS))
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "TASKS"), help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker[0], args.worker[1].split(","))
        return 0
    try:
        import torch
    except ImportError:
        print("chip_ab: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    runs, failed = [], 0
    for spec in args.run:
        root, tasks = spec.rsplit(":", 1)
        unknown = set(tasks.split(",")) - set(TASKS)
        if unknown:
            raise SystemExit(f"unknown tasks {sorted(unknown)}")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               tasks], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            failed += 1
            done = {}
            for ln in proc.stdout.splitlines():
                if ln.startswith("TASK "):
                    name, _, rec = ln[len("TASK "):].partition(" ")
                    done[name] = json.loads(rec)
            runs.append({"root": root, "tasks": tasks, **done,
                         "error": proc.stderr[-4000:]})
            print(f"[ab] {root}:{tasks} failed:\n{proc.stderr[-4000:]}", flush=True)
        else:
            runs.append(json.loads(lines[-1][len("RESULT "):]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
