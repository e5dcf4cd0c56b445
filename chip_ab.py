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
  split       flash_mha on a 2048-step window (B=128, H=2, bf16, ragged
              lengths) at PAM's head dim (42), PAM-sw's (170) and 360: the
              forward (dropout 0) and the backward (dropout 0.2) timed by
              CUDA events (5 calls) on the operands as the checkout's model
              path casts them (into heads zero-padded to 8 columns where the
              checkout has `_flash_operands`) and there on a plain cast too
              (dense heads: 4-byte copies at hd 42 and 170);
  long        PAM at max_len 2048, without and with sensor_wise_mask (hd 42
              and 170): a training step at B=128 (CUDA events, median of 3,
              and device time) and a server's latency by bucket with the
              top bucket's device time;
  fused_step  the same at PAM's own max_len (600), without and with
              sensor_wise_mask (d=84 and 340, hd 42 and 170): the fused
              layer's paths;
  bits        flash_mha forward and backward at head dims 8, 42 and 128
              (each column count of the Narrow geometry), T 600 and 2048,
              f32 and bf16 operands (the bf16 hashes move with the route:
              the tensor cores against the scalar kernels), and at 170 and
              360 (T 2048, f32), dropout 0.2, B=8, H=2: a SHA-256 of
              the bytes of o, lse, dq, dk and dv; the same of
              flash_mha_packed at P12 (T=215, d=160), eICU (T=300, d=72)
              and eICU-sw (d=280) in bf16 (the one-warpgroup tensor-core
              route) and at P12-sw (d=720) in bf16 (the two-warpgroup
              route) and f32 (the scalar route),
              dropout 0 and 0.2, B=8, 2 heads; and fused_encoder_layer
              with f32 and bf16 operands at PAM's width (d=84) and
              PAM-sw's (340), ffn=136, 2 heads, T 100 and 600, dropout 0
              and 0.2, B=8: a SHA-256 of out, attn, lse, dx and the 12
              weight gradients (the bf16 PAM-sw hashes move with the
              attention's route); and the sparse-graph kernels, B=8:
              spmm_segment_softmax's out, w, dx and dgamma with the
              target's and the source's row gathered on the P12 (D=860)
              and PAM (D=2400) graphs, and sddmm's alpha, dq and dk at P12
              (D=860, and D=430 at B=2) and PAM (D=120), each hashed
              apart; to compare checkouts bit for bit;
  graph       the sparse-graph kernels at every shape of chip_smoke's
              graph phase: spmm_segment_softmax forward, backward (dgamma
              and dx) and dx alone on the P12, PAM and kNN graphs (B=128,
              D 860, 2400, 240) with the target's and the source's row
              gathered, sddmm forward and backward at P12 B=2 and B=1
              (D=430) and at B=128 on the three graphs (D 860 and 120):
              chip_smoke.spmm_phase's and sddmm_phase's checks, CUDA-event
              times, bounds and library times, plus the profiler's device
              time of each call (20 calls) and the launch plan's route;
  graph_host  sddmm at the self-attention's shapes (P12 graph, D=430, B=1
              and 2), forward and backward: the host time a call (300
              calls without a synchronisation between them), CUDA events
              over 200 calls and the profiler's device time, the calls
              where a host-bound time hides the kernel's;
  ds_rounding where bf16 gradients' sample_err comes from at its largest
              reading (flash_mha, T=600, hd 42, B=128, dropout 0): the
              tensor-core and scalar kernels and the plain backward in f32
              and in f64 (all rounding ds and p to bf16 before their
              products) against one another, and the share of ds elements
              whose bf16 value the f32 and f64 evaluations round apart;
  sample_err  the largest chip_smoke.sample_err of o and of each gradient
              against the plain version, by test and operand dtype, on the
              inputs of the attention tests in
              tests/test_torch_kernels_cuda.py (flash_mha_packed backward,
              its tensor-core route against the scalar one, flash_mha at
              hd <= 128 and past it) and at the main path's shape (B=16,
              H=2, T=2048, hd 42, 170 and 360, dropout 0 and 0.2, the plain
              version on 8 samples): the readings SAMPLE_TOL is set from;
  delta       the packed backward's row term delta = sum of do * o over
              each head's columns alone, at P12, eICU and P12-sw (B=128,
              2 heads, do bf16, o f32), by CUDA events (50 calls) in torch
              ops: the checkout's plain form (`_packed_delta` where it has
              one) and three forms side by side, the f32 reduction over the
              head's columns (before the mesh's slice), f64 products summed
              in f64, and an f32 halving sum (both tried for a shard's
              bits); and where the checkout has csrc/row_delta.cuh, that
              kernel's device time inside the backward (torch.profiler, 20
              calls) and its delta against the plain form's, bit for bit;
  mesh_faults two gloo ranks sharing the card, P12 (B=128) as
              chip_smoke.two_rank_phase runs it, sound and with a fault
              planted in each rank's process at run time (nothing on disk
              changes): "no_data_all_reduce" (DP 2x1: every all_reduce
              the identity), "copy_to_grad_halved" (TP 1x2 in f32 and
              bf16: the gradient of a column-parallel input halved after
              its all_reduce, the same on both ranks) and "head_origin_0"
              (TP in f32 and bf16: every rank's attention dropout hashed
              as head 0); chip_smoke.two_rank_errors of each run against
              the one-rank steps: the readings TWO_RANK_TOL and
              TWO_RANK_BF16_TOL are set from;
  route_faults  chip_smoke.scale_out_phase's runs on two gloo ranks, sound
              and with a fault planted in each rank's process at run time:
              "kv_grad_not_summed" (SP's key/value gather with gather's
              backward: each rank keeps only its own queries' share),
              "partial_grads_not_summed" (the trainer leaves the partial
              leaves' gradients unsummed over the model axis: SP's and
              ring's in_proj, the pipeline's layers), "ring_grad_dropped"
              (the ring's rotation passes no gradient back) and
              "edge_input_grad_not_summed" (edge partitioning's node
              features enter without copy_to); chip_smoke.step_errors of
              each against the sound references: the readings the routes'
              limits are set from;
  ptxas       compile every unit of the five kernel libraries with
              `-Xptxas -v` (all nvcc processes together): registers, stack
              frame and spill bytes of each kernel, the spilling ones
              printed, and every flash_mha kernel (split_*_kernel, each
              geometry and column count; split_*_tc and split_*_wide
              counted apart), every tensor-core kernel of
              the fused layer (*_tc*, *_wide, pack_weights_kernel), every
              two-warpgroup packed kernel (packed_*_wide) and every one
              past hd 368 on the tensor cores (packed_*_tcc) printed.

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

    # the packed pair's entry points and its tensor-core kernels (flash_mha's
    # entry points, a unit of the same library, share helper names with
    # flash_packed.cu and cannot join it in one file)
    units = [str(u) for u in build._units("flash_packed") if u.stem != "flash_split"]
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

    B, H, T, od = 128, 2, 2048, torch.bfloat16
    out = {}
    for D in (42, 170, 360):
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, g = cs._head_views(gen, B, H, T, D, 4, "cuda")
        lengths = cs.ragged_lengths(gen, B, T, "cuda")
        # the operands as this checkout's model path casts them (the padded
        # cast where the checkout has one), and a plain cast
        # (each with the columns its heads hold, which that checkout's
        # wrappers take as `cols`)
        prep = getattr(fa, "_flash_operands", None)
        plain = [x.to(od) for x in (q, k, v, g)]
        casts = {"model": (plain, None)}
        if prep:
            casts = {"model": prep((q, k, v, g), od), "plain_cast": (plain, None)}
        del q, k, v, g, plain
        for name, ((qo, ko, vo, go), cols) in casts.items():
            kw = {} if cols is None else dict(cols=cols)
            bkw = {} if cols is None else dict(cols=cols, g_cols=cols)
            o, lse = fa._flash_fwd_cuda(qo, ko, vo, lengths, cs.SEED, 0.2, od, **kw)
            fwd = cs.time_ms(lambda: fa._flash_fwd_cuda(qo, ko, vo, lengths, 0, 0.0, od, **kw),
                             reps=5, warmup=1)
            bwd = cs.time_ms(lambda: fa._flash_bwd_cuda(qo, ko, vo, lengths, cs.SEED, 0.2, od,
                                                        o, lse, go, **bkw), reps=5, warmup=1)
            key = f"D{D}" + ("" if name == "model" else f"_{name}")
            out[f"{key}_fwd_ms"], out[f"{key}_bwd_ms"] = fwd, bwd
            print(f"[ab] {root}: flash_mha B={B} T={T} D={D} bf16 ({name}): forward "
                  f"{fwd:.4f} ms (dropout 0), backward {bwd:.4f} ms (dropout 0.2)", flush=True)
        del casts
        torch.cuda.empty_cache()
    return out


def task_long(root, cs):
    """PAM's width on a 2048-step window, without and with sensor_wise_mask
    (hd 42 and 170): _steps."""
    return _steps(root, cs, (("PAM-2048", cs.LONG),
                             ("PAM-sw-2048", {**cs.LONG, "sensor_wise_mask": True})))


def task_fused_step(root, cs):
    """PAM at its own max_len (600: the fused layer), without and with
    sensor_wise_mask (d=84 and 340): _steps."""
    return _steps(root, cs, (("PAM", {}), ("PAM-sw", {"sensor_wise_mask": True})))


def _steps(root, cs, configs):
    """For each (label, dataset_config overrides) of PAM (full width and
    depth, random weights): a training step at B=128 on
    synthetic_split("PAM", 320, T=max_len) batches (sampler strategy 3),
    CUDA events around each of 3 steps after a warm-up epoch and the
    profiler's device time of an epoch; then a server's request latency
    by bucket and the top bucket's device time (chip_smoke.serve_timing)."""
    import numpy as np
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer
    from raindrop_tpu_torch.train.trainer import Trainer

    out, batch, n_batches = {}, 128, 3
    for label, over in configs:
        cfg = dataset_config("PAM", **over)
        tcfg = TrainConfig(dataset="PAM", num_epochs=1, learning_rate=1e-4,
                           batch_size=batch, batching_strategy=3,
                           n_batches_strategy3=n_batches, seed=1)
        trainer = Trainer(cfg, tcfg, device="cuda")
        split = synthetic_split("PAM", 320, 0, T=cfg.max_len)
        data = {"P": torch.from_numpy(split.Ptrain).to("cuda"),
                "time": torch.from_numpy(split.Ptrain_time).to("cuda"),
                "y": torch.from_numpy(split.ytrain).to("cuda").long()}
        n_train = len(split.ytrain)
        idx = torch.stack([torch.randperm(n_train, generator=torch.Generator().manual_seed(i))
                           [:batch] for i in range(n_batches)]).to("cuda")
        trainer.train_epoch(data, idx)
        step_ms = []
        for k in range(n_batches):
            b = {name: t[idx[k]] for name, t in data.items()}
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            trainer.train_step(b)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
        wall_ms, device_ms, idle, top_k = cs.profile_device(
            lambda: trainer.train_epoch(data, idx), n_batches)
        del trainer, data
        torch.cuda.empty_cache()
        server = InferenceServer(cfg, raindrop_init(0, cfg, device="cuda"),
                                 buckets=(1, 8, 32, 128), device="cuda")
        P, times, static = cs.make_requests(cfg, 128, 1)
        timing = cs.serve_timing(label, server, P, times, static)
        server.close()
        del server
        torch.cuda.empty_cache()
        out[label] = {"step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
                      "step_device_ms": device_ms, "step_idle_share": idle,
                      "step_device_ms_by_kernel": top_k,
                      **{k: timing[k] for k in ("latency_ms", "profile_device_ms",
                                                "idle_share", "device_ms_by_kernel")}}
        print(f"[ab] {root}: {label} step {out[label]['step_ms_median']:.3f} ms (CUDA "
              f"events, median of {n_batches}), device {device_ms:.3f} ms a step; top "
              f"bucket {timing['latency_ms'][128]:.3f} ms, device "
              f"{timing['profile_device_ms']:.3f} ms", flush=True)
    return out


def task_bits(root, cs):
    import hashlib

    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    out = {}
    shapes = [(D, T, (None, "bfloat16")) for D in (8, 42, 128) for T in (600, 2048)]
    shapes += [(D, 2048, (None,)) for D in (170, 360)]
    for D, T, cds in shapes:
        gen = torch.Generator(device="cuda").manual_seed(D + T)
        q, k, v, g = cs._head_views(gen, 8, 2, T, D, 4, "cuda")
        lengths = cs.ragged_lengths(gen, 8, T, "cuda")
        for cd in cds:
            o, lse = fa._flash_fwd(q, k, v, lengths, cs.SEED, 0.2, cd)
            grads = fa._flash_bwd_cuda(q, k, v, lengths, cs.SEED, 0.2,
                                       fa.operand_dtype(cd), o, lse, g)
            h = hashlib.sha256()
            for x in (o, lse, *grads):
                h.update(x.contiguous().cpu().numpy().tobytes())
            out[f"D{D}_T{T}_{cd or 'float32'}"] = h.hexdigest()
    out.update(_packed_bits(cs))
    out.update(_fused_bits(cs))
    out.update(_graph_bits(cs))
    print(f"[ab] {root}: bits {out}", flush=True)
    return out


def _packed_bits(cs):
    """SHA-256 of flash_mha_packed's o, lse, dq, dk and dv on every route:
    the one-warpgroup tensor cores (bf16 at P12, eICU, eICU-sw), the two
    (bf16 at P12-sw) and the scalar kernels (f32 at P12-sw)."""
    import hashlib

    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    out = {}
    for label, T, d, cd in (("P12", 215, 160, "bfloat16"), ("eICU", 300, 72, "bfloat16"),
                            ("eICU-sw", 300, 280, "bfloat16"), ("P12-sw", 215, 720, None),
                            ("P12-sw", 215, 720, "bfloat16")):
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


def _graph_bits(cs):
    """SHA-256 of each sparse-graph kernel output, B=8: spmm's out, w, dx
    and dgamma (both gathers) at P12 and PAM, sddmm's alpha, dq, dk."""
    import hashlib

    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()

    out = {}
    for label, D in (("P12", 860), ("PAM", 2400)):
        src, dst, N, _ = cs.graph_topology(label, "cuda", 0)
        topo = sp.topology(src, dst, N)
        gen = torch.Generator(device="cuda").manual_seed(D)
        x, g_out = (torch.randn((8, N, D), generator=gen, device="cuda") for _ in range(2))
        gamma, g_w = (torch.randn((8, src.numel()), generator=gen, device="cuda")
                      for _ in range(2))
        for gt in (True, False):
            o, w = sp._spmm_fwd_cuda(x, gamma, topo, gt)
            dx, dgamma = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gt)
            side = "target" if gt else "source"
            for name, t in (("out", o), ("w", w), ("dx", dx), ("dgamma", dgamma)):
                out[f"spmm_{label}_{side}_{name}"] = digest(t)
    for label, B, D in (("P12", 8, 860), ("P12", 2, 430), ("PAM", 8, 120)):
        src, dst, N, _ = cs.graph_topology(label, "cuda", 0)
        topo = sp.topology(src, dst, N)
        gen = torch.Generator(device="cuda").manual_seed(D + B)
        q, k = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(2))
        d_alpha = torch.randn((B, src.numel()), generator=gen, device="cuda")
        alpha = sp._sddmm_fwd_cuda(q, k, topo, D ** -0.5)
        dq, dk = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, D ** -0.5)
        for name, t in (("alpha", alpha), ("dq", dq), ("dk", dk)):
            out[f"sddmm_{label}_B{B}_D{D}_{name}"] = digest(t)
    return out


def task_graph(root, cs):
    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    out = {}

    def device_ms(fn):
        fn()
        return cs.profile_device(lambda: [fn() for _ in range(20)], 20)[1]

    for label, D in (("P12", 860), ("PAM", 2400), ("kNN", 240)):
        src, dst, N, _ = cs.graph_topology(label, "cuda", 0)
        topo = sp.topology(src, dst, N)
        for gt in (True, False):
            fwd, bwd = cs.spmm_phase(label, 128, D, gt)
            # the phase's inputs again (its generator, seeded 1)
            gen = torch.Generator(device="cuda").manual_seed(1)
            x, g_out = (torch.randn((128, N, D), generator=gen, device="cuda")
                        for _ in range(2))
            gamma, g_w = (torch.randn((128, src.numel()), generator=gen, device="cuda")
                          for _ in range(2))
            w = sp._spmm_fwd_cuda(x, gamma, topo, gt)[1]
            rec = {"route": fwd.get("route"), "fwd_ms": fwd["ms"], "bwd_ms": bwd["ms"],
                   "dx_ms": bwd["dx_only_ms"],
                   "fwd_device_ms": device_ms(lambda: sp._spmm_fwd_cuda(x, gamma, topo, gt)),
                   "bwd_device_ms": device_ms(
                       lambda: sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gt)),
                   "dx_device_ms": device_ms(lambda: sp._spmm_bwd_cuda(
                       g_out, None, x, w, topo, gt, need_dgamma=False)),
                   "fwd_bound_ms": fwd["bound_ms"], "bwd_bound_ms": bwd["bound_ms"],
                   "dx_bound_ms": bwd["dx_only_bound_ms"],
                   "fwd_library_ms": fwd["library_ms"], "bwd_library_ms": bwd["library_ms"],
                   "max_abs_err": max(fwd["max_abs_err"], bwd["max_abs_err"])}
            out[f"spmm_{label}_{'target' if gt else 'source'}"] = rec
            print(f"[ab] {root}: graph spmm {label} gather_target={gt}: {rec}", flush=True)
    shapes = [("P12", 2, 430), ("P12", 1, 430)]
    shapes += [(label, 128, D) for label in ("P12", "PAM", "kNN") for D in (860, 120)]
    for label, B, D in shapes:
        fwd, bwd = cs.sddmm_phase(label, B, D)
        src, dst, N, _ = cs.graph_topology(label, "cuda", 0)
        topo = sp.topology(src, dst, N)
        gen = torch.Generator(device="cuda").manual_seed(2)
        q, k = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(2))
        d_alpha = torch.randn((B, src.numel()), generator=gen, device="cuda")
        scale = D ** -0.5
        rec = {"route": fwd.get("route"), "fwd_ms": fwd["ms"], "bwd_ms": bwd["ms"],
               "fwd_device_ms": device_ms(lambda: sp._sddmm_fwd_cuda(q, k, topo, scale)),
               "bwd_device_ms": device_ms(
                   lambda: sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)),
               "fwd_bound_ms": fwd["bound_ms"], "bwd_bound_ms": bwd["bound_ms"],
               "fwd_library_ms": fwd["library_ms"], "bwd_library_ms": bwd["library_ms"],
               "max_abs_err": max(fwd["max_abs_err"], bwd["max_abs_err"])}
        out[f"sddmm_{label}_B{B}_D{D}"] = rec
        print(f"[ab] {root}: graph sddmm {label} B={B} D={D}: {rec}", flush=True)
    return out


def task_graph_host(root, cs):
    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    def host_ms(fn, n=300):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0) / n

    out = {}
    src, dst, N, _ = cs.graph_topology("P12", "cuda", 0)
    topo = sp.topology(src, dst, N)
    for B in (1, 2):
        gen = torch.Generator(device="cuda").manual_seed(2)
        q, k = (torch.randn((B, N, 430), generator=gen, device="cuda") for _ in range(2))
        d_alpha = torch.randn((B, src.numel()), generator=gen, device="cuda")
        calls = {"fwd": lambda: sp._sddmm_fwd_cuda(q, k, topo, 0.1),
                 "bwd": lambda: sp._sddmm_bwd_cuda(d_alpha, q, k, topo, 0.1)}
        for name, fn in calls.items():
            rec = {"host_ms": host_ms(fn), "ms": cs.time_ms(fn, reps=200),
                   "device_ms": cs.profile_device(lambda: [fn() for _ in range(20)], 20)[1]}
            out[f"sddmm_B{B}_{name}"] = rec
            print(f"[ab] {root}: sddmm B={B} D=430 {name}: {rec}", flush=True)
    return out


def _fused_bits(cs):
    """SHA-256 of the fused layer's out, attn, lse, dx and 12 weight
    gradients at PAM's and PAM-sw's widths, f32 and bf16 operands."""
    import hashlib

    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa
    from raindrop_tpu_torch.ops import fused_encoder as fe

    out = {}
    for d in (84, 340):
        for T in (100, 600):
            for rate in (0.0, 0.2):
                for cd in (None, "bfloat16"):
                    gen = torch.Generator(device="cuda").manual_seed(d + T)
                    p = cs.random_layer(gen, d, 136, "cuda")
                    x, g = (torch.randn((8, T, d), generator=gen, device="cuda")
                            for _ in range(2))
                    lengths = cs.ragged_lengths(gen, 8, T, "cuda")
                    lengths[3] = 45
                    fwd = fe._fused_fwd(p, x, lengths, cs.SEED, rate, cd, 2)
                    dx, dws = fe._fused_bwd_cuda(fe._flatten(p), x, lengths, cs.SEED, rate,
                                                 2, fa.operand_dtype(cd), fwd[1], fwd[2], g)
                    h = hashlib.sha256()
                    for t in (*fwd, dx, *dws):
                        h.update(t.contiguous().cpu().numpy().tobytes())
                    out[f"fused_d{d}_T{T}_rate{rate}_{cd or 'float32'}"] = h.hexdigest()
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


def _plain_bwd(q, k, v, do, delta, lengths, lse, od, acc, round_ds=True):
    """flash_mha's plain backward at dropout 0 (fa._heads_bwd_plain's
    function and rounding points) with every product and ds in the dtype
    `acc`; ds (and p for dv) rounded to `od` before their products unless
    round_ds is False. q, k, v, do hold values already rounded to `od`."""
    import math

    import torch

    T, D = q.shape[-2:]
    scale = 1.0 / math.sqrt(D)
    qa, ka, va, da = (x.to(acc) for x in (q, k, v, do))
    live = (torch.arange(T, device=q.device)[None, :]
            < lengths.to(torch.int64)[:, None])[:, None, None, :]
    s = (qa @ ka.transpose(-1, -2)) * (scale * 1.4426950408889634)
    p = torch.exp2(torch.where(live, s - lse[..., None].to(acc),
                               torch.full_like(s, -float("inf"))))
    ds = p * ((da @ va.transpose(-1, -2)) - delta[..., None].to(acc))
    if round_ds:
        ds, pr = ds.to(od).to(acc), p.to(od).to(acc)
    else:
        pr = p
    valid = (lengths > 0).to(acc)[:, None, None, None]
    return ((ds @ ka) * scale * valid, (ds.transpose(-1, -2) @ qa) * scale * valid,
            (pr.transpose(-1, -2) @ da) * valid), ds


def task_ds_rounding(root, cs):
    """Where the bf16 gradients' sample_err comes from, at the shape of the
    largest reading (flash_mha, T=600, hd 42, B=128, H=2, dropout 0, the
    inputs of chip_smoke.flash_mha_phase): the kernels (tensor-core route
    and scalar) and the plain backward in f32 and in f64, each rounding ds
    and p to bf16 before their products, held against one another by
    chip_smoke.sample_err; and the share of live ds elements whose bf16
    value differs between the f32 and the f64 evaluation. "plain_tf32" is
    the f32 evaluation with TF32 matmuls: the operands hold bf16 values,
    which TF32 keeps exactly, so it differs from "plain_f32" only in running
    its products on cuBLAS's tensor-core kernels (their accumulation).
    Also the sample (and its length) of the largest tensor-core dq reading."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    B, H, T, D, od = 128, 2, 600, 42, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = cs._head_views(gen, B, H, T, D, 4, "cuda")
    lengths = cs.ragged_lengths(gen, B, T, "cuda")
    o, lse = fa._flash_fwd(q, k, v, lengths, cs.SEED, 0.0, "bfloat16")
    grads = {"tc": fa._flash_bwd_cuda(q, k, v, lengths, cs.SEED, 0.0, od, o, lse, g),
             "scalar": fa._flash_bwd_cuda(q, k, v, lengths, cs.SEED, 0.0, od, o, lse, g,
                                          "scalar")}
    qr, kr, vr, dr = (x.to(od).float() for x in (q, k, v, g))
    delta = (dr * o).sum(-1)
    ds = {}
    for name, acc, rnd in (("plain_f32", torch.float32, True),
                           ("plain_f64", torch.float64, True),
                           ("plain_f32_ds_unrounded", torch.float32, False),
                           ("plain_tf32", torch.float32, True)):
        torch.backends.cuda.matmul.allow_tf32 = name == "plain_tf32"
        try:
            grads[name], d = _plain_bwd(qr, kr, vr, dr, delta, lengths, lse, od, acc, rnd)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        if name in ("plain_f32", "plain_f64"):
            ds[name] = d.to(od)
        del d
    live = ds["plain_f32"] != 0
    out = {"ds_bf16_flips_f32_vs_f64": float(
        ((ds["plain_f32"] != ds["plain_f64"]) & live).sum() / live.sum())}
    del ds
    pairs = [("tc", "plain_f32"), ("scalar", "plain_f32"), ("plain_f64", "plain_f32"),
             ("tc", "plain_f64"), ("scalar", "plain_f64"), ("tc", "scalar"),
             ("tc", "plain_f32_ds_unrounded"), ("scalar", "plain_f32_ds_unrounded"),
             ("plain_tf32", "plain_f64"), ("tc", "plain_tf32")]
    for a, b in pairs:
        for n, x, y in zip(("dq", "dk", "dv"), grads[a], grads[b]):
            out[f"{a}_vs_{b} {n}"] = cs.sample_err(x, y.float(), lengths)
    x, y = grads["tc"][0], grads["plain_f64"][0].float()
    diff = (x - y).abs().reshape(B, -1).amax(1)
    scale = y.abs().reshape(B, -1).amax(1)
    scale = torch.where(lengths > 1, scale, scale.max())
    worst = int((diff / scale.clamp(min=torch.finfo(torch.float32).tiny)).argmax())
    out["tc_vs_plain_f64 dq worst sample"] = worst
    out["tc_vs_plain_f64 dq worst sample length"] = int(lengths[worst])
    for key, e in out.items():
        print(f"[ab] ds_rounding {key}: {e:.3e}", flush=True)
    return out


def task_ptxas(root, cs):
    import re
    from raindrop_tpu_torch.kernels import build

    # a unit several libraries link (the tensor-core route past hd 368) once
    units = list(dict.fromkeys(u for name in build.SOURCES for u in build._units(name)))
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
    # the tensor-core kernels that flash_mha_packed and flash_mha share
    tc = {k: v for k, v in kernels.items() if v["unit"].startswith("flash_packed_")}
    fused = {k: v for k, v in kernels.items() if v["unit"].startswith("fused_encoder")
             and ("_tc" in k or "_wide" in k or "pack_weights" in k)}
    for k, v in fused.items():
        print(f"[ptxas] fused tensor cores: {v} {k[:160]}", flush=True)
    fused_wide = {k: v for k, v in fused.items() if v["unit"].endswith("_wide")}
    wide = {k: v for k, v in kernels.items()
            if v["unit"].startswith("flash_packed_") and v["unit"].endswith("_wide")}
    for k, v in wide.items():
        print(f"[ptxas] packed past hd_pad 144: {v} {k[:160]}", flush=True)
    cluster = {k: v for k, v in kernels.items() if v["unit"].endswith("_tcc")}
    for k, v in cluster.items():
        print(f"[ptxas] packed past hd 368 (tc_cluster): {v} {k[:160]}", flush=True)
    return {"kernels": len(kernels), "spilling": len(spilling),
            "max_registers": max(v.get("registers", 0) for v in kernels.values()),
            "split_kernels": len(split),
            "split_spilling": sum(1 for v in split.values()
                                  if v["spill_stores"] or v["spill_loads"]),
            "tc_kernels": len(tc),
            "tc_spilling": sum(1 for v in tc.values() if v["spill_stores"] or v["spill_loads"]),
            "tc_max_registers": max((v.get("registers", 0) for v in tc.values()), default=0),
            "fused_tc_kernels": len(fused),
            "fused_tc_spilling": sum(1 for v in fused.values()
                                     if v["spill_stores"] or v["spill_loads"]),
            "fused_wide_kernels": len(fused_wide),
            "fused_wide_spilling": sum(1 for v in fused_wide.values()
                                       if v["spill_stores"] or v["spill_loads"]),
            "fused_wide_max_registers": max((v.get("registers", 0)
                                             for v in fused_wide.values()), default=0),
            "packed_wide_kernels": len(wide),
            "packed_wide_spilling": sum(1 for v in wide.values()
                                        if v["spill_stores"] or v["spill_loads"]),
            "by_kernel": kernels}


def task_delta(root, cs):
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    def f32_sum(do, o):
        return (do.to(torch.float32) * o).sum(-1)

    def f64_sum(do, o):
        return (do.double() * o.double()).sum(-1).to(torch.float32)

    def halving(do, o):
        x = do.to(torch.float32) * o
        while x.shape[-1] > 1:
            n = x.shape[-1]
            h = n // 2
            s = x[..., :h] + x[..., h:2 * h]
            if n % 2:
                s[..., :1] += x[..., 2 * h:]
            x = s
        return x[..., 0]

    out = {}
    for label, B, T, d, H in SHAPES:
        if B < 128:
            continue
        gen = torch.Generator(device="cuda").manual_seed(0)
        do = torch.randn((B, T, H, d // H), generator=gen, device="cuda").to(torch.bfloat16)
        o = torch.randn((B, T, H, d // H), generator=gen, device="cuda")
        forms = {"f32_sum": f32_sum, "f64_sum": f64_sum, "halving": halving}
        if hasattr(fa, "_packed_delta"):
            forms["checkout"] = lambda a, b: fa._packed_delta(
                a.reshape(B, T, d), b.reshape(B, T, d), H)
        ref = f64_sum(do, o)
        if os.path.exists(os.path.join(root, "raindrop_tpu_torch", "csrc", "row_delta.cuh")):
            od = torch.bfloat16
            q, k, v, gh = (torch.randn((B, T, d), generator=gen, device="cuda").to(od)
                           for _ in range(4))
            lengths = cs.ragged_lengths(gen, B, T, "cuda")
            of, lse = fa._packed_fwd_cuda(q, k, v, lengths, cs.SEED, 0.2, H, od)
            args = (q, k, v, lengths, cs.SEED, 0.2, H, od, of, lse, gh)
            fa._packed_bwd_cuda(*args)
            top = cs.profile_device(lambda: [fa._packed_bwd_cuda(*args) for _ in range(20)],
                                    20)[3]
            kernel_ms = sum(t for name, t in top.items() if "row_delta" in name)
            # the entry point as the wrapper calls it, with a delta buffer
            # of this task's own: the kernel's delta against the plain form
            plan = fa.packed_plan(B, T, d, H, od, "auto",
                                  fa._align(*(x.data_ptr() for x in (q, k, v, gh))))
            delta = torch.empty((B, H, T), dtype=torch.float32, device="cuda")
            grads = [torch.empty((B, T, d), dtype=torch.float32, device="cuda")
                     for _ in range(3)]
            err = fa._lib().rd_packed_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), gh.data_ptr(), of.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
                *(x.data_ptr() for x in grads), B, T, d, H, 1.0 / (d // H) ** 0.5, 1,
                cs.SEED, 0.2, 0, 0, H, plan.as_ints,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"rd_packed_bwd: {err}")
            plain = fa._packed_delta(gh, of, H)
            out[f"{label}_kernel"] = {"device_ms": kernel_ms,
                                      "bit_equal_to_plain": bool(torch.equal(delta.view(torch.int32),
                                                                        plain.view(torch.int32))),
                                      "max_abs_err_vs_plain": cs.max_err(delta, plain)}
            print(f"[ab] {root}: {label} delta kernel: {kernel_ms:.4f} ms device time "
                  f"inside the backward; {out[f'{label}_kernel']}", flush=True)
        for name, fn in forms.items():
            got = fn(do, o)
            got = got.transpose(1, 2) if name == "checkout" else got
            ms = cs.time_ms(lambda: fn(do, o), reps=50)
            out[f"{label}_{name}"] = {"ms": ms, "max_abs_err_vs_f64": cs.max_err(got, ref)}
            print(f"[ab] {root}: {label} delta {name}: {ms:.4f} ms, "
                  f"{out[f'{label}_{name}']['max_abs_err_vs_f64']:.3e} from the f64 sum",
                  flush=True)
    return out


MESH_FAULTS = {"sound": ("2x1", "1x2", "1x2 bf16"),
               "no_data_all_reduce": ("2x1",),
               "copy_to_grad_halved": ("1x2", "1x2 bf16"),
               "head_origin_0": ("1x2", "1x2 bf16")}


def _plant(fault):
    """Plant `fault` in this process's modules (mesh_faults)."""
    import torch
    import raindrop_tpu_torch.nn.transformer as transformer
    import raindrop_tpu_torch.parallel.tensor as tp

    if fault == "no_data_all_reduce":
        tp.all_reduce = lambda x, group: x
    elif fault == "copy_to_grad_halved":
        class Halved(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, group):
                ctx.group = group
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return tp.all_reduce(g.contiguous().clone(), ctx.group) / 2, None

        tp.copy_to = lambda x, group: x if group is None else Halved.apply(x, group)
    elif fault == "head_origin_0":
        transformer._kernel_origin = (
            lambda shard, nhead: None if shard is None else (shard.b0, 0, nhead))
    elif fault != "sound":
        raise ValueError(fault)


def _fault_worker(rank, root, fault, device, seed, batch):
    import torch

    cs = _load_smoke(root)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _plant(fault)
    runs = [r for r in cs.TWO_RANK_RUNS if r[0] in MESH_FAULTS[fault]]
    return cs._two_rank_steps(device, seed, batch, runs)


ROUTE_FAULTS = {"sound": None,
                "kv_grad_not_summed": ("a sp",),
                "partial_grads_not_summed": ("a ring", "d pipeline"),
                "ring_grad_dropped": ("a ring",),
                "edge_input_grad_not_summed": ("e edge partition",)}


def _plant_route(fault):
    """Plant a route fault in this process's modules (route_faults)."""
    import torch
    import raindrop_tpu_torch.parallel.tensor as tp
    from raindrop_tpu_torch.train.trainer import Trainer

    if fault == "kv_grad_not_summed":
        class NoSum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, local, rank, n, group, dim):
                out = tp._GatherScatter.forward(ctx, local, rank, n, group, dim)
                ctx.args = (rank, n, dim)
                return out

            @staticmethod
            def backward(ctx, g):
                rank, n, dim = ctx.args
                size = g.shape[dim] // n
                return g.narrow(dim, rank * size, size).contiguous(), None, None, None, None

        tp.gather_scatter = lambda local, rank, n, group, dim: (
            local if group is None else NoSum.apply(local, rank, n, group, dim))
    elif fault == "partial_grads_not_summed":
        Trainer._sum_partial_grads = lambda self: None
    elif fault == "ring_grad_dropped":
        tp._PPermute.backward = staticmethod(lambda ctx, g: (torch.zeros_like(g), None, None))
    elif fault == "edge_input_grad_not_summed":
        tp.copy_to = lambda x, group: x
    elif fault != "sound":
        raise ValueError(fault)


def _route_fault_worker(rank, root, fault, device, seed, batch, refs):
    cs = _load_smoke(root)
    _plant_route(fault)
    return cs._scale_out_worker(rank, device, seed, batch, refs, ROUTE_FAULTS[fault])


def task_route_faults(root, cs):
    import torch
    from raindrop_tpu_torch.parallel.launch import run_ranks

    refs = cs.scale_out_reference("cuda", 0, 128)
    torch.cuda.empty_cache()
    out = {}
    for fault, keys in ROUTE_FAULTS.items():
        t0 = time.perf_counter()
        ranks = run_ranks(_route_fault_worker, 2, root, fault, "cuda", 0, 128, refs,
                          backend="gloo", timeout_s=900, threads=4)
        errors = {k: v["errors"] for k, v in ranks[0].items() if "errors" in v}
        for name, e in errors.items():
            print(f"[ab] {root}: route fault {fault}, {name}: {json.dumps(e)}", flush=True)
        out[fault] = {"errors": errors, "seconds": time.perf_counter() - t0}
    return out


def task_mesh_faults(root, cs):
    import torch
    from raindrop_tpu_torch.parallel.launch import run_ranks

    refs = cs.two_rank_reference("cuda", 0, 128)
    torch.cuda.empty_cache()
    out = {}
    for fault, names in MESH_FAULTS.items():
        runs = [r for r in cs.TWO_RANK_RUNS if r[0] in names]
        t0 = time.perf_counter()
        ranks = run_ranks(_fault_worker, 2, root, fault, "cuda", 0, 128,
                          backend="gloo", timeout_s=600, threads=4)
        errors = cs.two_rank_errors(refs, ranks, runs=runs)
        for name, e in errors.items():
            for k in ("launches", "bwd_launches", "ref_losses"):
                e.pop(k, None)
            print(f"[ab] {root}: mesh fault {fault}, {name}: {json.dumps(e)}", flush=True)
        out[fault] = {"errors": errors, "seconds": time.perf_counter() - t0}
    return out


TASKS = {"build": task_build, "one_unit": task_one_unit, "kernels": task_kernels,
         "ds_rounding": task_ds_rounding,
         "serve_train": task_serve_train, "latency": task_latency, "split": task_split,
         "long": task_long, "fused_step": task_fused_step,
         "bits": task_bits, "sample_err": task_sample_err, "ptxas": task_ptxas,
         "graph": task_graph, "graph_host": task_graph_host, "delta": task_delta,
         "mesh_faults": task_mesh_faults, "route_faults": task_route_faults}


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
