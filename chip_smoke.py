#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py [--out details.json]

Phases, each of which fails the run (non-zero exit, no result line) when a
check does not hold:

  1. set-up: TF32 off for matmuls and cuDNN (the reference semantics are
     full f32), the card's name and power limit, the kernels built from
     raindrop_tpu_torch/csrc/ with nvcc (build seconds printed); then the
     SASS check: cuobjdump -sass on the flash_packed library and the fused
     layer's two must find HGMMA (wgmma) instructions in each tensor-core
     kernel family (SASS_FAMILIES: the packed attention's three, and every
     bf16 row product of the fused layer with its attention);
  2. flash_mha_packed forward, kernel against its plain PyTorch version at
     the P12 (B=128, T=215, d=160) and eICU (T=300, d=72) shapes, f32 and
     bf16 operands, ragged lengths including 0, 1 and T, bit-equal on a
     repeat and for 8 samples launched alone, exact zeros for the
     length-0 sample; in bf16 the
     tensor-core kernel is timed in turns with the previous design (the
     scalar kernel, prev_ms), and each time's share of the bound printed;
  3. fused_encoder_layer forward, the same at the PAM shape (B=128, T=600,
     d=84, ffn=136): out and attn sample by sample, lse (attn zero for the
     length-0 sample, 8 samples alone bit-equal); in bf16 the tensor-core
     route (every row product on wgmma, the attention too at hd 42) timed
     in turns with the previous design (the scalar kernels);
  4. flash_mha_packed backward at the same shapes, dropout 0 and 0.2: the
     forward with dropout, then dq, dk, dv of the two backward kernels
     against the plain backward, finite, zero on the length-0 sample, and
     bit-equal on a repeat (prev_ms as in phase 2);
  5. flash_mha_packed in bf16 at the edge shapes, B=4, 2 heads: head dims
     3 and 13 (odd: 2-byte plain loads, unpaired stores), 8, 42 (4-byte
     copies), 84, 128, 129, 140 and 144 (tensor cores up to a padded 144),
     170 and 360 (the scalar kernels, Narrow and Wide geometry), T = 64,
     65 and 1024, dropout 0 and 0.2: the plan's route forward and backward
     against the plain version and against the scalar kernels, bit-equal
     on a repeat, exact zeros for the length-0 sample;
  6. fused_encoder_layer backward at the PAM shape, the same grid: dx (sample
     by sample) and the 12 weight gradients against the plain backward,
     bit-equal on a repeat, a zero attention gradient for the length-0
     sample, the tensor-core route timed in turns with the previous design;
 6a. the fused layer at an edge shape, B=4, T=100 (ending inside a 64-row
     tile), lengths 0, 1, 45 and 100, PAM's and PAM-sw's widths, f32 and
     bf16, dropout 0 and 0.2: forward and backward against the plain
     version and (bf16) the previous design, bit-equal on a repeat, exact
     zeros for the length-0 sample; every fused run's routes checked (bf16
     tensor cores, the attention scalar at PAM-sw's hd 170; f32 scalar);
 6b. phases 2, 4, 3 and 6 at the sensor-wise widths (sensor_wise_mask:
     d = d_inp * (d_ob + d_pe), 2 heads), B=128: P12-sw (T=215, d=720, hd
     360: the scalar route in both dtypes) and eICU-sw (T=300, d=280, hd
     140: tensor cores in bf16) forward and backward, PAM-sw's fused
     layer (T=600, d=340, ffn=136, hd 170) forward and backward; each
     route checked;
  7. an InferenceServer for PAM at full width (random weights from a seed)
     answering predict on 1, 5, 128 and 200 rows, submit from 4 threads,
     predict_stream and the bf16 wire format, held against the same server
     on the dense plain path; a row's probabilities across batches within
     1e-5 on the kernel path with f32 operands too, and within the same
     limit on the kernels' plain versions in bf16 (each server's own batch
     dependence printed); it must have gone through the fused-layer kernel;
  8. the same for P12, which must have gone through flash_mha_packed,
     every launch on the tensor-core route (bf16 operands);
  9. a Trainer for PAM at full width and depth (B=128, lr 1e-4, shipped
     dropout 0.2) on a synthetic split resident on the card: one epoch and
     a padded predict; finite losses, backward launches of the preset's
     kernel, dead parameters bit-identical and live ones changed, the same
     epoch twice bit-equal, the first step's loss and gradient norm against
     the dense path at dropout 0, a falling loss on a fixed batch, and on
     that batch at lr 1e-3 and dropout 0 ten steps beside the dense path's,
     the loss before and after the first one held to it (f32 and bf16
     operands);
 10. the same for P12 (every flash_mha_packed launch, forward and
     backward, on the tensor-core route);
 10b. phases 7 and 8 with sensor_wise_mask for P19 (the dense rung at
     T=60: no kernel launched), P12 (every flash_mha_packed launch on the
     scalar route), eICU (every launch on the tensor cores) and PAM (the
     fused layer), a row's probabilities held across batches to
     BATCH_LIMIT_SW with bf16 operands, on the kernels and on their plain
     versions; and phase 9 for P12, eICU and PAM
     with it, the falling-loss check at the rate FIT_LR_SW gives; PAM and
     PAM-sw served and trained with every fused_encoder_layer launch on the
     tensor-core route;
 11. spmm_segment_softmax, kernels against their plain PyTorch versions,
     forward (out, w) and backward (dx, dgamma, cotangents on both
     outputs): the complete sensor graphs of P12 (B=128, N=36, E=1296,
     D=860) and PAM (N=17, E=289, D=2400) with the messages gathered at
     the target and at the source, and a kNN graph (N=128, k=6, E=768,
     D=240, edges shuffled, one node without an incoming edge); zero rows
     exact, bit-equal on a repeat;
 12. sddmm forward and backward on the same graphs at D=860 and D=120, and
     at the shape the self-attention phase gives it;
 13. an InferenceServer for P12 with prop_backend='pallas' (every check of
     phase 8, held against the dense plain path: dense attention and dense
     propagation), which must launch the SpMM kernel twice per forward;
     and one raindrop_apply with a random global_adj in [0.5, 2],
     'pallas' against 'coo';
 14. a Trainer for P12 with prop_backend='pallas' (every check of phase 10;
     the SpMM backward must have been launched);
 15. ob_propagate_selfattention (N=36, D=860, 2 heads) on a kNN and on the
     complete graph, score_backend 'sddmm' against 'gather', value and
     gradient w.r.t. x;
 16. flash_mha (split heads, any T) forward and backward, kernels against
     their plain PyTorch versions, f32 and bf16 operands, dropout 0 and
     0.2, ragged lengths including 0, at B=128, H=2, D=42 and T=600 (the
     JAX package's one-program regime) and T=2048 (its streaming regime),
     on the strided head views the model hands it; finite, zero on the
     length-0 sample, bit-equal on a repeat. At T=2048 the plain version
     runs on 8 samples at a time (its [B, H, T, T] int64 mask would take
     8.6 GB at B=128);
 17. the public op at T=600 with dropout 0.2 through autograd, held against
     flash_mha_packed on the same [B, T, d] tensors and seed (both hash
     b * H + h, the global row and column): output and gradients;
 18. an InferenceServer for PAM's width on a 2048-step window
     (dataset_config("PAM", max_len=2048), full width and depth; every
     check of phase 7, held against the dense plain path), which must
     launch flash_mha twice per forward;
 19. the trainer protocol on that configuration: train_split on
     synthetic_split("PAM", T=2048) (B=128, sampler strategy 3, dropout
     0.2) for 1 epoch with checkpoints, resumed from the `_last` file for
     a second, and the uninterrupted 2-epoch run, whose history the resumed
     one must equal bit for bit; finite records, metrics in [0, 1], the
     best file reloads, forward launches = 2 x (steps + predict chunks),
     backward launches = 2 x steps; the first step's loss and gradient norm
     against the dense path at dropout 0 on DENSE_ROWS (16) samples; step
     ms, samples/s and the idle share;
 20. run_splits, 2 splits of 1 epoch, for the summary's shape;
 21. flash_mha past hd 128 as phase 16 does it at T=2048: PAM-sw's head
     (hd 170, d_inp * (d_ob + d_pe) = 340 over 2 heads: the Narrow
     geometry at 48 columns a thread) and hd 360 (the Wide geometry,
     32-row blocks), f32 and bf16 operands, dropout 0 and 0.2, SDPA with a
     key mask beside; then the edge shapes, B=5, hd 129, 170, 192, 193,
     200, 360 and 368 x T 65, 1025 and 2048 x dropout 0 and 0.2, both
     operand dtypes, one length ending 45 rows into a 64-row block: forward
     and backward against the plain version, bit-equal on a repeat, exact
     zeros for the length-0 sample;
 22. phase 18 for PAM with sensor_wise_mask at max_len 2048 (PAM-sw-2048,
     hd 170): exactly two flash_mha launches per forward and no other
     kernel, a row's probabilities across batches held to phase 18's 1e-5
     (in bf16 and f32, and on the kernels' plain versions in bf16:
     plain_kernels swaps flash_mha's in);
 23. phase 9 on that configuration (B=128; the checks against the dense
     path and the falling-loss check at FIT_LR_SW on the first batch's
     first DENSE_ROWS rows, as past 1024 steps always), through flash_mha
     forward and backward;
 24. phase 19 on that configuration, 2 epochs with checkpoints and a third
     resumed, bit-equal to the uninterrupted 3-epoch run, the launch
     counts, the first step against the dense path, step ms, samples/s and
     the idle share.

Every phase's seconds are printed as `[phase] name: s` and kept under
"phase_s" in the --out file.

Times are CUDA-event means over repeated launches after a warm-up. Bounds
use the H100 SXM data-sheet peaks (3.35 TB/s; 67 TFLOP/s f32 outside the
tensor cores, 989 TFLOP/s dense bf16); the card's power limit is printed
beside them. Outputs are held to max_abs_err 1e-4 with f32 operands
(another summation order) and 2e-2 with bf16 operands. The attention
kernels' gradients, flash_mha's o, and the fused layer's out, attn and dx
are held sample by sample to SAMPLE_TOL (1e-5 f32, 5e-3 bf16) of each
sample's largest plain value (sample_err); the fused layer's weight
gradients, sums over every row, to TOL relative to max(1, the plain
gradient's largest value), its plain backward taking the kernel's relu
branches (fused_bwd_phase says why). The sparse-graph kernels are
f32 throughout and are held to 1e-5 relative to max(1, |plain|).
The line before the last is the kernels' JSON record (twenty records:
twelve kernels at the main paths' shapes, the packed pair and the fused
layer again at the sensor-wise widths, and flash_mha forward and backward
at PAM-sw-2048's hd 170; the fused layer's list the CUDA kernels of its
tensor-core route and of the previous design, and its launches are the
tensor-core ones), the last line the result. `--out PATH` also
writes every number to PATH as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# sample_err's limits for the attention kernels' gradients (and
# flash_mha's o), f32 / bf16 operands. The largest readings on an H100,
# here and in chip_ab.py's task sample_err (the card tests' inputs):
# gradients 1.1e-6 / 3.2e-3 (flash_mha_packed at eICU, B=128; flash_mha's
# 2.0e-3), o 2.3e-6 / 2.6e-3.
SAMPLE_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
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


def attention_bytes(lengths, T, d, H, esize, backward=False) -> float:
    """Bytes an attention kernel must move over [B, T, d] operands: q (and
    do) of the samples with a live key, k and v below each length only (the
    kernels never read past it), the f32 outputs over all of T (o; or dq,
    dk and dv), the [B, H, T] f32 statistics (lse written for every sample;
    lse and delta read for the live ones) and the lengths."""
    B = lengths.numel()
    live, keys = int((lengths > 0).sum()), float(lengths.sum())
    if backward:
        return (2 * live * T * d * esize + 2 * keys * d * esize + 3 * B * T * d * 4
                + 2 * live * H * T * 4 + B * 4)
    return live * T * d * esize + 2 * keys * d * esize + B * T * d * 4 + B * H * T * 4 + B * 4


def ragged_lengths(gen, B, T, device):
    import torch

    lengths = torch.randint(0, T + 1, (B,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[2] = 0, 1, T
    return lengths


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def time_designs(run, dtype, reps=20):
    """Times of run(impl): the plan's route ("auto") and, in bf16, the
    previous design (the scalar kernels, "scalar"), timed in turns scalar,
    tc, tc, scalar so that the card's clocks favour neither. f32 takes the
    scalar route either way: its prev_ms is None. ms are CUDA-event means
    over `reps` calls; device_ms the profiler's device time of a call
    (the kernels alone, without the host's gaps between launches)."""
    if dtype != "bfloat16":
        return dict(ms=time_ms(lambda: run("auto"), reps), prev_ms=None,
                    device_ms=device_ms(lambda: run("auto")), prev_device_ms=None)
    t = {"auto": [], "scalar": []}
    for impl in ("scalar", "auto", "auto", "scalar"):
        t[impl].append(time_ms(lambda: run(impl), reps))
    return dict(ms=sum(t["auto"]) / 2, prev_ms=sum(t["scalar"]) / 2,
                device_ms=device_ms(lambda: run("auto")),
                prev_device_ms=device_ms(lambda: run("scalar")))


def device_ms(fn, reps=20) -> float:
    """Device time of one fn() call by torch.profiler, after a warm-up."""
    fn()
    return profile_device(lambda: [fn() for _ in range(reps)], reps)[1]


def device_line(times) -> str:
    parts = [f"kernel {times['device_ms']:.4f} ms"]
    if times["prev_device_ms"] is not None:
        parts.append(f"previous design {times['prev_device_ms']:.4f} ms")
    parts.append(f"library {times['library_device_ms']:.4f} ms")
    return ", ".join(parts)


def design_line(ms, prev_ms, bound_ms) -> str:
    """The shares of the bound, and the previous design's time beside."""
    line = f"{bound_ms / ms:.1%} of the bound"
    if prev_ms is not None:
        line += (f"; previous design {prev_ms:.4f} ms ({bound_ms / prev_ms:.1%} of "
                 f"the bound, {prev_ms / ms:.2f}x)")
    return line


@contextlib.contextmanager
def phase(seconds, name):
    """Time one phase of main by the host clock: print its seconds and keep
    them in the dict `seconds` under `name`."""
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0
    print(f"[phase] {name}: {seconds[name]:.1f} s", flush=True)


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
    o_k2, lse_k2 = fa._packed_fwd(q, k, v, lengths, None, 0.0, cd, H)
    o_p, lse_p = fa._packed_fwd_plain(q, k, v, lengths, H, od)
    torch.cuda.synchronize()
    route = fa.packed_plan(B, T, d, H, od).route
    err = max(max_err(o_k, o_p), max_err(lse_k, lse_p))
    ok = err <= TOL[dtype] and bool(torch.isfinite(o_k).all())
    print(f"[flash] {label} {dtype} B={B} T={T} d={d} H={H} ({route} route): "
          f"max_abs_err {err:.3e} (tol {TOL[dtype]:g})", flush=True)
    if not ok:
        raise AssertionError(f"flash_mha_packed kernel disagrees at {label} {dtype}")
    if not (torch.equal(o_k, o_k2) and torch.equal(lse_k, lse_k2)):
        raise AssertionError(f"flash forward not bit-equal on a repeat at {label} {dtype}")
    if not (bool((o_k[0] == 0).all()) and bool((lse_k[0] == fa.NEG_INF).all())):
        raise AssertionError(f"flash forward: the length-0 sample is not zero at {label}")
    # a sample's bits do not depend on the batch it is launched in
    o_s, lse_s = fa._packed_fwd(q[:8], k[:8], v[:8], lengths[:8], None, 0.0, cd, H)
    if not (torch.equal(o_s, o_k[:8]) and torch.equal(lse_s, lse_k[:8])):
        raise AssertionError(f"flash forward: 8 samples alone differ from the same "
                             f"samples in a batch of {B} at {label} {dtype}")

    # inputs already in the operand dtype, so the timed call is the launch
    qo, ko, vo = (x.to(od) for x in (q, k, v))
    times = time_designs(
        lambda impl: fa._packed_fwd_cuda(qo, ko, vo, lengths, 0, 0.0, H, od, impl), dtype)
    ms, prev_ms = times["ms"], times["prev_ms"]
    plain_ms = time_ms(lambda: fa._packed_fwd_plain(qo, ko, vo, lengths, H, od))
    live = lengths > 0
    hd = d // H
    qh, kh, vh = (x[live].reshape(-1, T, H, hd).transpose(1, 2).contiguous()
                  for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep))
    times["library_device_ms"] = device_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep))
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = attention_bytes(lengths, T, d, H, esize)
    flops = 4.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    print(f"[flash] {label} {dtype}: kernel {ms:.4f} ms, {design_line(ms, prev_ms, bound_ms)}, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); device time {device_line(times)}", flush=True)
    return dict(label=label, dtype=dtype, route=route, max_abs_err=err, **times,
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
    """Kernel vs plain for fused_encoder_layer's forward at one shape: out
    and attn held sample by sample (sample_err) to SAMPLE_TOL, lse to TOL;
    in bf16 the tensor-core route timed in turns with the previous design
    (the scalar kernels)."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    x = torch.randn((B, T, d), generator=gen, device=device)
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    plan = fe.fused_plan(d, ffn, H, od)
    got = fe._fused_fwd(p, x, lengths, None, 0.0, cd, H)
    again = fe._fused_fwd(p, x, lengths, None, 0.0, cd, H)
    want = fe._fused_fwd_plain(p, x, lengths, H, od)
    torch.cuda.synchronize()
    errs = {"out": sample_err(got[0], want[0], lengths),
            "attn": sample_err(got[1], want[1], lengths),
            "lse": max_err(got[2], want[2])}
    err = max(max_err(a, b) for a, b in zip(got, want))
    print(f"[fused] {label} {dtype} B={B} T={T} d={d} ffn={ffn} H={H} ({plan.route} "
          f"route, attention {plan.attn_route}): sample_err out {errs['out']:.3e}, attn "
          f"{errs['attn']:.3e} (tol {SAMPLE_TOL[dtype]:g}), lse max_abs_err "
          f"{errs['lse']:.3e} (tol {TOL[dtype]:g}); max_abs_err {err:.3e}", flush=True)
    if (max(errs["out"], errs["attn"]) > SAMPLE_TOL[dtype] or errs["lse"] > TOL[dtype]
            or not bool(torch.isfinite(got[0]).all())):
        raise AssertionError(f"fused_encoder_layer kernel disagrees at {label} {dtype}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"fused forward not bit-equal on a repeat at {label} {dtype}")
    # the length-0 sample attends to nothing: attention output 0, lse NEG_INF
    if not (bool((got[1][0] == 0).all()) and bool((got[2][0] == -1e30).all())):
        raise AssertionError(f"fused forward: the length-0 sample's attention is not "
                             f"zero at {label}")
    alone = fe._fused_fwd(p, x[:8], lengths[:8], None, 0.0, cd, H)
    if not all(torch.equal(a, b[:8]) for a, b in zip(alone, got)):
        raise AssertionError(f"fused forward: 8 samples alone differ from the same "
                             f"samples in a batch of {B} at {label} {dtype}")

    ws = fe._flatten(p)
    times = time_designs(
        lambda impl: fe._fused_fwd_cuda(ws, x, lengths, 0, 0.0, H, od, impl), dtype)
    ms, prev_ms = times["ms"], times["prev_ms"]
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
        times["library_device_ms"] = device_ms(lambda: layer(xl, src_key_padding_mask=pad))
    hd = d // H
    esize = 2 if dtype == "bfloat16" else 4
    weights = (4 * d * d + 2 * d * ffn) * esize + (3 * d + 6 * d + ffn) * 4
    nbytes = B * T * d * 4 * 3 + B * H * T * 4 + B * 4 + weights
    dense = 2.0 * B * T * (3 * d * d + d * d + 2 * d * ffn)
    flops = dense + 4.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    # the qkv intermediate A writes and B reads back (bf16 on the tensor cores)
    qkv_bytes = 2 * B * T * 3 * d * (2 if plan.route == "tc" else 4)
    print(f"[fused] {label} {dtype}: kernel {ms:.4f} ms, {design_line(ms, prev_ms, bound_ms)}, "
          f"plain {plain_ms:.4f} ms, TransformerEncoderLayer {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); device time {device_line(times)}; qkv round "
          f"trip {qkv_bytes / 1e6:.1f} MB", flush=True)
    return dict(label=label, dtype=dtype, route=plan.route, attn_route=plan.attn_route,
                max_abs_err=err, errs=errs, **times, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, qkv_roundtrip_bytes=qkv_bytes)


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1.0))


def sample_err(got, want, lengths) -> float:
    """An attention output or gradient [B, ...] against its plain version,
    sample by sample: the largest max |got - want| over that sample's max
    |want|. A sample of length 0 or 1 is held to the largest max |want| of
    all: with one key p = 1, so its dq and dk are rounding noise about 0
    (and its dv the sum of T rows of do, which would set the scale of
    every sample if the scale were one max over the batch)."""
    import torch

    B = got.shape[0]
    diff = (got.float() - want.float()).abs().reshape(B, -1).amax(1)
    scale = want.float().abs().reshape(B, -1).amax(1)
    scale = torch.where(lengths.to(scale.device) > 1, scale, scale.max())
    return float((diff / scale.clamp(min=torch.finfo(torch.float32).tiny)).max())


SEED = 20231


def flash_bwd_phase(label, B, T, d, H, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for flash_mha_packed's forward with dropout and its
    backward at one shape."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device=device)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    o_k, lse_k = fa._packed_fwd(q, k, v, lengths, SEED, rate, cd, H)
    o_p, lse_p = fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, rate)
    fwd_err = max(max_err(o_k, o_p), max_err(lse_k, lse_p))
    args = (q, k, v, lengths, SEED, rate, H, od, o_k, lse_k, g)
    got = fa._packed_bwd_cuda(*args)
    again = fa._packed_bwd_cuda(*args)
    want = fa._packed_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {n: sample_err(a, b, lengths) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    err = max(errs.values())
    print(f"[flash_bwd] {label} {dtype} dropout {rate}: forward max_abs_err "
          f"{fwd_err:.3e} (tol {TOL[dtype]:g}), gradients sample_err {errs} (tol "
          f"{SAMPLE_TOL[dtype]:g})", flush=True)
    if fwd_err > TOL[dtype] or err > SAMPLE_TOL[dtype]:
        raise AssertionError(f"flash_mha_packed backward disagrees at {label} {dtype}")
    for a, a2 in zip(got, again):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"flash backward not finite or not bit-equal "
                                 f"on a repeat at {label} {dtype}")
        if not bool((a[0] == 0).all()):
            raise AssertionError("flash backward: the length-0 sample is not zero")

    qo, ko, vo = (x.to(od) for x in (q, k, v))
    targs = (qo, ko, vo, lengths, SEED, rate, H, od, o_k, lse_k, g)
    times = time_designs(lambda impl: fa._packed_bwd_cuda(*targs, impl), dtype)
    ms, prev_ms = times["ms"], times["prev_ms"]
    plain_ms = time_ms(lambda: fa._packed_bwd_plain(*targs), reps=5, warmup=1)
    live = lengths > 0
    hd = d // H
    qh, kh, vh = (x[live].reshape(-1, T, H, hd).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=keep, dropout_p=rate)
    gh = g[live].to(od).reshape(-1, T, H, hd).transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                     retain_graph=True))
    times["library_device_ms"] = device_ms(
        lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True))
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = attention_bytes(lengths, T, d, H, esize, backward=True)
    flops = 10.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    print(f"[flash_bwd] {label} {dtype} dropout {rate}: kernels {ms:.4f} ms, "
          f"{design_line(ms, prev_ms, bound_ms)}, plain {plain_ms:.4f} ms, sdpa backward "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); device time "
          f"{device_line(times)}", flush=True)
    return dict(label=label, dtype=dtype, rate=rate, max_abs_err=err,
                fwd_max_abs_err=fwd_err, errs=errs, **times, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)


def flash_edge_phase(hd, T, rate, B=4, H=2, device="cuda", seed=0):
    """flash_mha_packed in bf16 at an edge shape (head dims 3, 8, 13, 42,
    84, 128, and 129, 140, 144, 170, 360 of the sensor-wise widths; T = 64,
    65, 1024): the plan's route (the tensor-core kernels up to hd_pad 144,
    the scalar ones beyond) against the plain version and against the
    scalar kernels, forward and backward, bit-equal on a repeat, exact
    zeros for the length-0 sample."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    d, od, tol = H * hd, torch.bfloat16, TOL["bfloat16"]
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device=device)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)
    plan = fa.packed_plan(B, T, d, H, od)
    fwd = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, H, od)
    fwd2 = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, H, od)
    prev = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, H, od, "scalar")
    plain = fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, rate)
    args = (q, k, v, lengths, SEED, rate, H, od, *fwd, g)
    got = fa._packed_bwd_cuda(*args)
    again = fa._packed_bwd_cuda(*args)
    prev_b = fa._packed_bwd_cuda(*args, "scalar")
    plain_b = fa._packed_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {"fwd_vs_plain": max(max_err(a, b) for a, b in zip(fwd, plain)),
            "fwd_vs_prev": max(max_err(a, b) for a, b in zip(fwd, prev)),
            "bwd_vs_plain": max(sample_err(a, b, lengths) for a, b in zip(got, plain_b)),
            "bwd_vs_prev": max(sample_err(a, b, lengths) for a, b in zip(got, prev_b))}
    limits = {"fwd_vs_plain": tol, "fwd_vs_prev": tol,
              "bwd_vs_plain": SAMPLE_TOL["bfloat16"], "bwd_vs_prev": SAMPLE_TOL["bfloat16"]}
    print(f"[flash_edge] hd={hd} T={T} dropout {rate} ({plan.route} route, copy "
          f"{plan.copy_bytes} B, hd padded {plan.hd_pad}, {plan.rows}-row blocks): "
          f"{errs} (limits {limits})", flush=True)
    if any(errs[n] > limits[n] for n in errs):
        raise AssertionError(f"flash_mha_packed tc kernels disagree at hd={hd} T={T}")
    for a, a2 in zip((*fwd, *got), (*fwd2, *again)):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"flash tc kernels not finite or not bit-equal on a "
                                 f"repeat at hd={hd} T={T}")
    zero = [fwd[0][0], *(x[0] for x in got)]
    if not all(bool((z == 0).all()) for z in zero) or not bool((fwd[1][0] == fa.NEG_INF).all()):
        raise AssertionError(f"flash tc kernels: the length-0 sample is not zero at "
                             f"hd={hd} T={T}")
    return dict(hd=hd, T=T, rate=rate, route=plan.route, copy_bytes=plan.copy_bytes,
                **errs)


# the tensor-core kernel families of each library whose SASS must hold
# HGMMA (wgmma): the packed attention's three and, on the fused layer's bf16
# route, every row product (qkv, the forward's tail, the backward's row
# kernel, dx, the weight gradients) and the attention at PAM's head dim
SASS_FAMILIES = {
    "flash_packed": ("packed_fwd_tc", "packed_dq_tc", "packed_dkv_tc"),
    "fused_encoder": ("qkv_rows_tc_kernel", "layer_tail_tc", "fused_attn_fwd_tc"),
    "fused_encoder_bwd": ("qkv_rows_tc_kernel", "layer_bwd_rows_tc", "dx_rows_tc",
                          "wgrad_tc", "fused_dq_tc", "fused_dkv_tc"),
}


# the CUDA kernels a fused-layer call launches on the bf16 tensor-core route
# (the kernels' JSON record lists them beside the wrapper's); the previous
# design's, timed in turns with them as prev_ms, stay on the f32 route
FUSED_FWD_KERNELS = {
    "sources_also": ["raindrop_tpu_torch/csrc/rows_tc.cuh",
                     "raindrop_tpu_torch/csrc/fused_encoder_attn_tc.cu",
                     "raindrop_tpu_torch/csrc/attention_tc.cuh"],
    "kernels_tc": ["pack_weights_kernel", "qkv_rows_tc_kernel",
                   "fused_attn_fwd_tc (hd_pad <= 144; attn_rows_kernel on bf16 beyond)",
                   "layer_tail_tc"],
    "kernels_previous": ["qkv_rows_kernel", "attn_rows_kernel", "layer_tail_kernel"]}
FUSED_BWD_KERNELS = {
    "sources_also": ["raindrop_tpu_torch/csrc/rows_tc.cuh",
                     "raindrop_tpu_torch/csrc/fused_encoder_dq_tc.cu",
                     "raindrop_tpu_torch/csrc/fused_encoder_dkv_tc.cu",
                     "raindrop_tpu_torch/csrc/attention_tc.cuh"],
    "kernels_tc": ["pack_weights_kernel", "qkv_rows_tc_kernel", "layer_bwd_rows_tc",
                   "fused_dq_tc, fused_dkv_tc (hd_pad <= 144; fused_dq_kernel, "
                   "fused_dkv_kernel on bf16 beyond)", "dx_rows_tc", "wgrad_tc",
                   "reduce_kernel"],
    "kernels_previous": ["qkv_rows_kernel", "layer_bwd_rows_kernel", "fused_dq_kernel",
                         "fused_dkv_kernel", "dx_rows_kernel", "wgrad_kernel",
                         "reduce_kernel"]}


def sass_phase():
    """Count the tensor-core instructions in the built libraries (cuobjdump
    -sass): HGMMA (wgmma) and HMMA (mma.sync) per kernel family. Fails when
    a kernel of SASS_FAMILIES has none; without cuobjdump on the machine it
    says so and checks nothing."""
    import re
    import shutil
    from raindrop_tpu_torch.kernels import build

    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("[sass] cuobjdump is not on this machine: the SASS check did not run",
              flush=True)
        return None
    out_counts = {}
    procs = {}
    tmp = tempfile.TemporaryDirectory()
    # one cuobjdump a library, all at once, each into a file (a pipe would
    # stall the others until its reader came)
    for name in SASS_FAMILIES:
        build.load(name)
        with open(os.path.join(tmp.name, name), "w") as sink:
            procs[name] = subprocess.Popen([tool, "-sass", str(build._lib_path(name))],
                                           stdout=sink)
    try:
        for name, families in SASS_FAMILIES.items():
            lib = str(build._lib_path(name))
            if procs[name].wait(timeout=300) != 0:
                raise RuntimeError(f"cuobjdump -sass failed on {lib}")
            with open(os.path.join(tmp.name, name)) as f:
                out = f.read()
            alts = [r"packed_\w+?_(?:tc|kernel)"] + [f for f in families
                                                      if not f.startswith("packed")]
            pattern = re.compile(r"Function : \S*?(" + "|".join(alts) + ")")
            counts, fam = {}, None
            for line in out.splitlines():
                m = pattern.search(line)
                if m:
                    fam = counts.setdefault(m.group(1), {"functions": 0, "HGMMA": 0, "HMMA": 0})
                    fam["functions"] += 1
                elif fam is not None and "Function : " in line:
                    fam = None
                elif fam is not None:
                    for op in ("HGMMA", "HMMA"):
                        if re.search(rf"\b{op}\.", line):
                            fam[op] += 1
            print(f"[sass] {os.path.basename(lib)}: {counts}", flush=True)
            for fam_name in families:
                if counts.get(fam_name, {}).get("HGMMA", 0) <= 0:
                    raise AssertionError(f"no HGMMA instruction in {fam_name} ({name}): "
                                         f"{counts.get(fam_name)}")
            out_counts[name] = counts
    finally:                        # no dump outlives the phase
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    return out_counts


def fused_bwd_phase(label, B, T, d, ffn, H, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for fused_encoder_layer's forward with dropout and
    its backward at one shape: dx held sample by sample (sample_err) to
    SAMPLE_TOL, the 12 weight gradients (sums over every row) to TOL
    relative to max(1, the plain gradient's largest value); in bf16 the
    tensor-core route timed in turns with the previous design."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    x, g = (torch.randn((B, T, d), generator=gen, device=device) for _ in range(2))
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    plan = fe.fused_plan(d, ffn, H, od)
    fwd_k = fe._fused_fwd(p, x, lengths, SEED, rate, cd, H)
    fwd_p = fe._fused_fwd_plain(p, x, lengths, H, od, SEED, rate)
    fwd_err = max(sample_err(fwd_k[0], fwd_p[0], lengths),
                  sample_err(fwd_k[1], fwd_p[1], lengths))
    lse_err = max_err(fwd_k[2], fwd_p[2])
    _, attn, lse = fwd_k
    ws = fe._flatten(p)
    args = (x, lengths, SEED, rate, H, od, attn, lse, g)
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, *args, scratch_out=scratch)
    dx2, dws2 = fe._fused_bwd_cuda(ws, *args)
    # The layer has a relu. A pre-activation within rounding of zero can
    # fall on either side in the kernel and in the plain version, and the
    # branch moves single gradient elements by O(1) whatever the
    # arithmetic's precision (at this shape about one of 10.4 million
    # elements does). So the plain backward is given the kernel's branches,
    # which makes the comparison one of arithmetic; the branches themselves
    # are held to differ only where the plain pre-activation is within the
    # tolerance of zero, and so for no more than that share of the elements.
    ffn_on = scratch["f"].reshape(B, T, ffn) > 0
    if not bool((scratch["dqkv"].reshape(B, T, 3 * d)[0] == 0).all()):
        raise AssertionError(f"fused backward: the length-0 sample's attention "
                             f"gradient is not zero at {label} {dtype}")
    scratch.clear()
    f_pre = fe._recompute(
        p, x, fwd_p[1], lambda t: t.to(od).to(torch.float32),
        fe._site_keeps(SEED, rate, B, T, d, ffn, device))[4]
    if rate > 0.0:
        kept = fe._site_keep(SEED, B, fe.SITE_FFN_MID, T, ffn, rate, device)
    else:
        kept = torch.ones_like(ffn_on)
    flips = ffn_on != ((f_pre > 0) & kept)
    n_flips = int(flips.sum())
    flip_pre = float(f_pre[flips].abs().max()) if n_flips else 0.0
    del f_pre, kept
    pdx, pdws = fe._fused_bwd_plain(p, *args, relu_on=ffn_on)
    torch.cuda.synchronize()
    names = ["/".join(path) for path in fe._WEIGHTS]
    errs = {"dx": sample_err(dx, pdx, lengths)}
    errs.update({n: rel_err(a, b) for n, a, b in zip(names, dws, pdws)})
    werr = max(errs[n] for n in names)
    err = max(max_err(a, b) for a, b in zip([dx, *dws], [pdx, *pdws]))
    print(f"[fused_bwd] {label} {dtype} dropout {rate} ({plan.route} route, attention "
          f"{plan.attn_route}): forward sample_err {fwd_err:.3e}, lse {lse_err:.3e}; dx "
          f"sample_err {errs['dx']:.3e} (tol {SAMPLE_TOL[dtype]:g}), weight gradients rel "
          f"err {werr:.3e} (tol {TOL[dtype]:g}) {errs}; relu branches that differ from the "
          f"plain version's: {n_flips} of {flips.numel()}, largest |pre-activation| "
          f"among them {flip_pre:.3e}", flush=True)
    if (fwd_err > SAMPLE_TOL[dtype] or lse_err > TOL[dtype]
            or errs["dx"] > SAMPLE_TOL[dtype] or werr > TOL[dtype]
            or flip_pre > TOL[dtype] or n_flips > TOL[dtype] * flips.numel()):
        raise AssertionError(f"fused_encoder_layer backward disagrees at {label} {dtype}")
    for name, a, a2 in zip(["dx"] + names, [dx, *dws], [dx2, *dws2]):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"fused backward {name} not finite or not "
                                 f"bit-equal on a repeat at {label} {dtype}")
    del pdx, pdws, fwd_p

    times = time_designs(lambda impl: fe._fused_bwd_cuda(ws, *args, impl=impl), dtype,
                         reps=10)
    ms, prev_ms = times["ms"], times["prev_ms"]
    plain_ms = time_ms(lambda: fe._fused_bwd_plain(p, *args), reps=3, warmup=1)
    layer = torch.nn.TransformerEncoderLayer(
        d, H, ffn, dropout=rate, batch_first=True, device=device, dtype=od).train()
    live = lengths > 0
    xl = x[live].to(od).requires_grad_()
    pad = (torch.arange(T, device=device)[None, :] >= lengths[live][:, None])
    out = layer(xl, src_key_padding_mask=pad)
    wrt = (xl, *layer.parameters())
    gl = g[live].to(od)
    library_ms = time_ms(lambda: torch.autograd.grad(out, wrt, gl, retain_graph=True),
                         reps=10, warmup=2)
    times["library_device_ms"] = device_ms(
        lambda: torch.autograd.grad(out, wrt, gl, retain_graph=True), reps=10)
    hd = d // H
    esize = 2 if dtype == "bfloat16" else 4
    n_w = 4 * d * d + 2 * d * ffn
    n_v = 9 * d + ffn
    nbytes = (B * T * d * 4 * 4 + B * H * T * 4 + B * 4
              + n_w * esize + n_v * 4 + (n_w + n_v) * 4)
    # every forward product is recomputed and has two backward products;
    # the attention has five against the forward's two
    dense = 3 * 2.0 * B * T * (4 * d * d + 2 * d * ffn)
    flops = dense + 10.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    scratch = fe.bwd_scratch_floats(B, T, d, ffn, H, plan)
    scratch_mb = {k: 4 * n / 1e6 for k, n in scratch.items()}
    print(f"[fused_bwd] {label} {dtype} dropout {rate}: kernels {ms:.4f} ms, "
          f"{design_line(ms, prev_ms, bound_ms)}, plain {plain_ms:.4f} ms, "
          f"TransformerEncoderLayer backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); device time {device_line(times)}; intermediates in device "
          f"memory {sum(scratch_mb.values()):.1f} MB", flush=True)
    return dict(label=label, dtype=dtype, rate=rate, route=plan.route,
                attn_route=plan.attn_route, max_abs_err=err, fwd_sample_err=fwd_err,
                errs=errs, relu_flips=n_flips, **times, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, scratch_mb=scratch_mb)


def fused_edge_phase(label, d, ffn, H, dtype, rate, T=100, device="cuda", seed=0):
    """fused_encoder_layer at an edge shape: T = 100 ends 36 rows into a
    64-row tile, lengths 0, 1, 45 (inside a tile) and T; forward and
    backward against the plain version (out, attn and dx by sample_err,
    the weight gradients by rel_err; the plain backward takes the kernel's
    relu branches), in bf16 also against the previous design (the scalar
    kernels), bit-equal on a repeat, exact zeros for the length-0 sample."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    B = 4
    x, g = (torch.randn((B, T, d), generator=gen, device=device) for _ in range(2))
    lengths = torch.tensor([0, 1, 45, T], dtype=torch.int32, device=device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    plan = fe.fused_plan(d, ffn, H, od)
    ws = fe._flatten(p)
    fwd = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od)
    fwd2 = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od)
    plain = fe._fused_fwd_plain(p, x, lengths, H, od, SEED, rate)
    args = (x, lengths, SEED, rate, H, od, fwd[1], fwd[2], g)
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, *args, scratch_out=scratch)
    dx2, dws2 = fe._fused_bwd_cuda(ws, *args)
    pdx, pdws = fe._fused_bwd_plain(p, *args,
                                    relu_on=scratch["f"].reshape(B, T, ffn) > 0)
    errs = {"out": sample_err(fwd[0], plain[0], lengths),
            "attn": sample_err(fwd[1], plain[1], lengths),
            "dx": sample_err(dx, pdx, lengths),
            "weights": max(rel_err(a, b) for a, b in zip(dws, pdws))}
    limits = {"out": SAMPLE_TOL[dtype], "attn": SAMPLE_TOL[dtype],
              "dx": SAMPLE_TOL[dtype], "weights": TOL[dtype]}
    if dtype == "bfloat16":
        prev = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od, "scalar")
        pdx_s, pdws_s = fe._fused_bwd_cuda(ws, *args, impl="scalar")
        errs["out_vs_prev"] = sample_err(fwd[0], prev[0], lengths)
        errs["dx_vs_prev"] = sample_err(dx, pdx_s, lengths)
        errs["weights_vs_prev"] = max(rel_err(a, b) for a, b in zip(dws, pdws_s))
        limits.update(out_vs_prev=SAMPLE_TOL[dtype], dx_vs_prev=SAMPLE_TOL[dtype],
                      weights_vs_prev=TOL[dtype])
    torch.cuda.synchronize()
    print(f"[fused_edge] {label} {dtype} dropout {rate} T={T} lengths 0, 1, 45, {T} "
          f"({plan.route} route, attention {plan.attn_route}): {errs} (limits {limits})",
          flush=True)
    if any(errs[n] > limits[n] for n in errs):
        raise AssertionError(f"fused_encoder_layer disagrees at the edge shape {label} "
                             f"{dtype} dropout {rate}")
    for a, a2 in zip((*fwd, dx, *dws), (*fwd2, dx2, *dws2)):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"fused layer not finite or not bit-equal on a repeat "
                                 f"at the edge shape {label} {dtype}")
    if not (bool((fwd[1][0] == 0).all()) and bool((fwd[2][0] == -1e30).all())
            and bool((scratch["dqkv"].reshape(B, T, 3 * d)[0] == 0).all())):
        raise AssertionError(f"fused layer: the length-0 sample's attention is not zero "
                             f"at the edge shape {label} {dtype}")
    return dict(label=label, dtype=dtype, rate=rate, T=T, route=plan.route,
                attn_route=plan.attn_route, **errs)


def _head_views(gen, B, H, T, D, n, device):
    """n [B, H, T, D] views of one [B, T, n*H*D] projection: the strides
    nn/transformer.py hands flash_mha."""
    import torch

    proj = torch.randn((B, T, n * H * D), generator=gen, device=device)
    return [t.reshape(B, T, H, D).transpose(1, 2) for t in proj.split(H * D, dim=-1)]


def _in_chunks(fn, B, step):
    """fn(slice) over the batch in chunks of `step` samples."""
    return [fn(slice(b0, min(b0 + step, B))) for b0 in range(0, B, step)]


def check_flash_mha(q, k, v, g, lengths, dtype, rate, n_plain, what):
    """flash_mha's kernels at one shape, forward and backward, each twice,
    against the plain version on the first `n_plain` samples (b * H + h
    keys the dropout mask, so a slice's plain masks are the kernel's only
    from sample 0): o and lse to TOL, o and each gradient to SAMPLE_TOL
    by sample_err; bit-equal on a repeat and finite; exact zeros for
    sample 0, of length 0. Returns (o, lse, forward max_abs_err, the
    sample_err of o, dq, dk and dv)."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    c = slice(0, n_plain)
    o, lse = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    o2, lse2 = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    args = (q, k, v, lengths, SEED, rate, od, o, lse, g)
    got = fa._flash_bwd_cuda(*args)
    again = fa._flash_bwd_cuda(*args)
    o_p, lse_p = fa._flash_fwd_plain(q[c], k[c], v[c], lengths[c], od, SEED, rate)
    want = fa._flash_bwd_plain(q[c], k[c], v[c], lengths[c], SEED, rate, od,
                               o[c], lse[c], g[c])
    torch.cuda.synchronize()
    fwd_err = max(max_err(o[c], o_p), max_err(lse[c], lse_p))
    errs = {n: sample_err(a[c], b, lengths[c])
            for n, a, b in zip(("o", "dq", "dk", "dv"), (o, *got), (o_p, *want))}
    if fwd_err > TOL[dtype] or max(errs.values()) > SAMPLE_TOL[dtype]:
        raise AssertionError(
            f"flash_mha kernels disagree at {what}: forward max_abs_err {fwd_err:.3e} "
            f"(tol {TOL[dtype]:g}), sample_err {errs} (tol {SAMPLE_TOL[dtype]:g})")
    _equal_and_finite([("o", o, o2), ("lse", lse, lse2)]
                      + [(n, a, a2) for n, a, a2 in zip(("dq", "dk", "dv"), got, again)],
                      f"flash_mha {what}")
    if not all(bool((a[0] == 0).all()) for a in (o, *got)):
        raise AssertionError(f"flash_mha: the length-0 sample is not zero at {what}")
    return o, lse, fwd_err, errs


def flash_mha_phase(label, B, H, T, D, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for flash_mha, forward (with dropout when rate > 0)
    and backward, at one shape (check_flash_mha; the plain version on the
    first `chunk` samples, which hold the lengths 0, 1 and T), then their
    times. Returns (forward run, backward run)."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = _head_views(gen, B, H, T, D, 4, device)
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    chunk = B if T <= 1024 else 8
    o, lse, fwd_err, errs = check_flash_mha(q, k, v, g, lengths, dtype, rate, chunk,
                                            f"{label} {dtype} dropout {rate}")
    err = max(errs[n] for n in ("dq", "dk", "dv"))
    print(f"[flash_mha] {label} {dtype} B={B} H={H} T={T} D={D} dropout {rate}: "
          f"forward max_abs_err {fwd_err:.3e} (tol {TOL[dtype]:g}), sample_err "
          f"{errs} (tol {SAMPLE_TOL[dtype]:g}; plain version on the first {chunk} "
          f"samples)", flush=True)

    # inputs already in the operand dtype, so the timed calls are the launches
    qo, ko, vo = (x.to(od) for x in (q, k, v))
    reps = dict(reps=20, warmup=3) if T <= 1024 else dict(reps=5, warmup=1)
    ms = time_ms(lambda: fa._flash_fwd(qo, ko, vo, lengths, SEED, rate, cd), **reps)
    targs = (qo, ko, vo, lengths, SEED, rate, od, o, lse, g)
    bwd_ms = time_ms(lambda: fa._flash_bwd_cuda(*targs), **reps)
    plain_ms = time_ms(lambda: _in_chunks(
        lambda c: fa._flash_fwd_plain(qo[c], ko[c], vo[c], lengths[c], od, SEED, rate),
        B, chunk), reps=2, warmup=1)
    bwd_plain_ms = time_ms(lambda: _in_chunks(
        lambda c: fa._flash_bwd_plain(qo[c], ko[c], vo[c], lengths[c], SEED, rate, od,
                                      o[c], lse[c], g[c]), B, chunk), reps=2, warmup=1)
    live = lengths > 0
    qh, kh, vh = (x[live].contiguous().requires_grad_() for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep, dropout_p=rate),
                             **reps)
    out = sdpa(qh, kh, vh, attn_mask=keep, dropout_p=rate)
    gh = g[live].to(od)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                         retain_graph=True), **reps)
    del out, qh, kh, vh
    esize = 2 if dtype == "bfloat16" else 4
    total = float(lengths.sum())
    fwd_bytes = attention_bytes(lengths, T, H * D, H, esize)
    fwd_flops = 4.0 * T * D * H * total
    bwd_bytes = attention_bytes(lengths, T, H * D, H, esize, backward=True)
    bwd_flops = 10.0 * T * D * H * total
    bound_ms, bound_by = bound(fwd_bytes, fwd_flops, dtype)
    bwd_bound_ms, bwd_bound_by = bound(bwd_bytes, bwd_flops, dtype)
    print(f"[flash_mha] {label} {dtype} dropout {rate}: forward {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); backward {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, sdpa "
          f"backward {bwd_library_ms:.4f} ms, bound {bwd_bound_ms:.4f} ms "
          f"({bwd_bound_by}); {fwd_flops / 1e9:.1f} / {bwd_flops / 1e9:.1f} GFLOP",
          flush=True)
    shape = dict(label=label, dtype=dtype, rate=rate, B=B, H=H, T=T, D=D)
    fwd = dict(**shape, max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=fwd_bytes, flops=fwd_flops)
    bwd = dict(**shape, max_abs_err=err, errs=errs, ms=bwd_ms, plain_ms=bwd_plain_ms,
               library_ms=bwd_library_ms, bound_ms=bwd_bound_ms,
               bound_by=bwd_bound_by, bytes=bwd_bytes, flops=bwd_flops)
    return fwd, bwd


def flash_mha_op_phase(wrappers, device="cuda", seed=0, B=128, T=600, H=2, D=42,
                       rate=0.2):
    """The public op through autograd at a length the packed kernel also
    takes, f32 operands, dropout on: flash_mha on the head views against
    flash_mha_packed on the same [B, T, d] tensors and seed. Both hash
    b * H + h, the global row and the global column, so they draw the same
    masks and agree to rounding (1e-5). Returns flash_mha's forward and
    backward launch counts and the differences."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed + 7)
    q, k, v, g = (torch.randn((B, T, H * D), generator=gen, device=device)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)

    def heads(x):
        return x.reshape(B, T, H, D).transpose(1, 2)

    for fn in wrappers:
        fn.launches = fn.bwd_launches = 0
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.flash_mha(*(heads(x) for x in leaves), lengths, SEED, rate, None)
    o.backward(heads(g))
    counts = (fa.flash_mha.launches, fa.flash_mha.bwd_launches)
    p_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_p = fa.flash_mha_packed(*p_leaves, lengths, SEED, rate, None, H)
    o_p.backward(g)
    torch.cuda.synchronize()
    checks = {"o": max_err(o.detach().transpose(1, 2).reshape(B, T, H * D),
                           o_p.detach())}
    for n, a, b in zip(("dq", "dk", "dv"), leaves, p_leaves):
        checks[n] = rel_err(a.grad, b.grad)
    print(f"[flash_mha] public op at B={B} T={T} H={H} D={D} dropout {rate}, f32: "
          f"against flash_mha_packed {checks} (tol 1e-5); launches {counts[0]} "
          f"forward, {counts[1]} backward", flush=True)
    bad = {n: x for n, x in checks.items() if not x <= 1e-5}
    if bad or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"flash_mha and flash_mha_packed disagree: {bad}")
    if counts != (1, 1):
        raise AssertionError(f"flash_mha: expected one launch each way, got {counts}")
    return counts[0], counts[1], checks


def flash_mha_edge_phase(hd, T, rate, B=5, H=2, device="cuda", seed=0):
    """flash_mha at an edge shape past hd 128 (129, 170, 192: the Narrow
    geometry at 48 columns a thread; 193, 200, 360, 368: the Wide one,
    32-row blocks; T = 65, 1025, 2048) on the projection's head views, f32
    and bf16 operands, by check_flash_mha on every sample; one length ends
    45 rows into a 64-row block."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed + hd + T)
    q, k, v, g = _head_views(gen, B, H, T, hd, 4, device)
    lengths = ragged_lengths(gen, B, T, device)
    lengths[3] = min(T, 64 * (T // 128) + 45)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        _, _, fwd_err, rel = check_flash_mha(q, k, v, g, lengths, dtype, rate, B,
                                             f"hd={hd} T={T} {dtype} dropout {rate}")
        errs[dtype] = {"fwd": fwd_err, **rel}
    rows = fa.scalar_rows(hd)
    print(f"[flash_mha_edge] hd={hd} T={T} dropout {rate} ({rows}-row blocks): {errs} "
          f"(tol: fwd {TOL}, sample_err {SAMPLE_TOL})", flush=True)
    return dict(hd=hd, T=T, rate=rate, rows=rows, errs=errs)


# ------------------------------------------------------------ graph kernels
GRAPH_TOL = 1e-5    # f32 throughout, another summation order


def graph_topology(kind, device="cuda", seed=0):
    """(src, dst, N, complete) int64 on the card. 'P12' and 'PAM': the
    model's complete sensor graph in source-major order, so the
    destinations are not sorted. 'kNN': each of N=128 random points sends
    an edge to its 6 nearest neighbours (E=768), the edges into the last
    node redirected so it has no incoming edge, in shuffled order. 'kNN36'
    the same with 36 points."""
    import torch

    if kind in ("P12", "PAM"):
        N = 36 if kind == "P12" else 17
        idx = torch.arange(N, device=device)
        return idx.repeat_interleave(N), idx.repeat(N), N, True
    N, k = (128, 6) if kind == "kNN" else (36, 6)
    gen = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand((N, 2), generator=gen, device=device)
    dist = torch.cdist(pts, pts) + 10.0 * torch.eye(N, device=device)
    dst = dist.topk(k, largest=False).indices.reshape(-1)
    src = torch.arange(N, device=device).repeat_interleave(k)
    dst = torch.where(dst == N - 1, torch.zeros_like(dst), dst)
    order = torch.randperm(N * k, generator=gen, device=device)
    return src[order], dst[order], N, False


def _equal_and_finite(pairs, what):
    import torch

    for name, a, a2 in pairs:
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"{what}: {name} not finite or not bit-equal "
                                 f"on a repeat")


def _spmm_library(x, gamma, N, gather_target, src=None, dst=None):
    """The dense form: one softmax over the [N, N] grid of logits and one
    bmm. Returns (out, w). A complete graph in source-major order is the
    grid itself; any other graph gives `src` and `dst`, and its logits are
    scattered into a grid of -inf first (a masked softmax; a node without
    incoming edges softmaxes to NaN and is set to 0; duplicate edges would
    overwrite each other, so the caller compares only without them)."""
    import torch

    B = x.shape[0]
    if src is None:
        W = torch.softmax(gamma.reshape(B, N, N), dim=1)           # [b, s, n]
    else:
        grid = torch.full((B, N, N), float("-inf"), dtype=x.dtype, device=x.device)
        grid[:, src, dst] = gamma
        W = torch.nan_to_num(torch.softmax(grid, dim=1), nan=0.0)
    A = torch.diag_embed(W.sum(1)) if gather_target else W.transpose(1, 2)
    w = W.reshape(B, N * N) if src is None else W[:, src, dst]
    return torch.bmm(A, x), w


def spmm_phase(label, B, D, gather_target, device="cuda", seed=0):
    """Kernels vs plain for spmm_segment_softmax, forward and backward, on
    one graph. Returns (forward run, backward run)."""
    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    src, dst, N, complete = graph_topology(label, device, seed)
    E = src.numel()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x, g_out = (torch.randn((B, N, D), generator=gen, device=device) for _ in range(2))
    gamma, g_w = (torch.randn((B, E), generator=gen, device=device) for _ in range(2))
    topo = sp.topology(src, dst, N)
    what = f"spmm {label} gather_target={gather_target}"

    out, w = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
    out2, w2 = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
    dx, dgamma = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
    dx2, dgamma2 = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
    # the model's form: constant edge weights, no cotangent on them
    dx_only, _ = sp._spmm_bwd_cuda(g_out, None, x, w, topo, gather_target,
                                   need_dgamma=False)
    p_out, p_w = sp._spmm_fwd_plain(x, gamma, src, dst, N, gather_target)
    p_dx, p_dgamma = sp._spmm_bwd_plain(g_out, g_w, x, w, src, dst, N, gather_target)
    torch.cuda.synchronize()
    errs = {"out": rel_err(out, p_out), "w": rel_err(w, p_w)}
    bwd_errs = {"dx": rel_err(dx, p_dx), "dgamma": rel_err(dgamma, p_dgamma)}
    empty = torch.bincount(dst, minlength=N) == 0
    print(f"[spmm] {label} B={B} N={N} E={E} D={D} gather_target={gather_target}: "
          f"forward rel err {errs}, backward rel err {bwd_errs} (tol {GRAPH_TOL:g}); "
          f"{int(empty.sum())} nodes without an incoming edge", flush=True)
    if max(*errs.values(), *bwd_errs.values()) > GRAPH_TOL:
        raise AssertionError(f"{what}: the kernels disagree with the plain version")
    _equal_and_finite([("out", out, out2), ("w", w, w2), ("dx", dx, dx2),
                       ("dgamma", dgamma, dgamma2), ("dx alone", dx_only, dx)], what)
    if not bool((out[:, empty] == 0).all()):
        raise AssertionError(f"{what}: a node without incoming edges is not zero")
    if not complete and int(empty.sum()) < 1:
        raise AssertionError(f"{what}: the graph has no empty segment")
    del p_out, p_w, p_dx, p_dgamma

    ms = time_ms(lambda: sp._spmm_fwd_cuda(x, gamma, topo, gather_target))
    plain_ms = time_ms(lambda: sp._spmm_fwd_plain(x, gamma, src, dst, N, gather_target),
                       reps=5, warmup=1)
    bwd_ms = time_ms(lambda: sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target))
    dx_ms = time_ms(lambda: sp._spmm_bwd_cuda(g_out, None, x, w, topo, gather_target,
                                              need_dgamma=False))
    bwd_plain_ms = time_ms(lambda: sp._spmm_bwd_plain(g_out, g_w, x, w, src, dst, N,
                                                      gather_target), reps=5, warmup=1)
    # the library yardstick: the dense [N, N] form, masked for a sparse graph
    lib_edges = () if complete else (src, dst)
    dups = E - int(torch.unique(src * N + dst).numel())
    l_out, l_w = _spmm_library(x, gamma, N, gather_target, *lib_edges)
    lib_err = max(rel_err(out, l_out), rel_err(w, l_w))
    if dups == 0 and lib_err > GRAPH_TOL:
        raise AssertionError(f"{what}: the dense softmax + bmm form differs "
                             f"by {lib_err}")
    if dups:
        print(f"[spmm] {label}: {dups} duplicate edges, which the dense form "
              f"merges: it is timed, not compared", flush=True)
    library_ms = time_ms(lambda: _spmm_library(x, gamma, N, gather_target, *lib_edges))
    xr, gr = x.clone().requires_grad_(), gamma.clone().requires_grad_()
    outs = _spmm_library(xr, gr, N, gather_target, *lib_edges)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        outs, (xr, gr), (g_out, g_w), retain_graph=True))
    del outs, xr, gr, l_out, l_w
    # bytes: each array once; of x only the rows some edge gathers
    gidx = dst if gather_target else src
    rows = int(torch.unique(gidx).numel())
    index_bytes = (3 * E + N + 1) * 4
    fwd_bytes = (B * rows * D + B * N * D + 2 * B * E) * 4 + index_bytes
    fwd_flops = 2.0 * B * E * D + 4.0 * B * E
    bound_ms, bound_by = bound(fwd_bytes, fwd_flops, "float32")
    # backward: g_out, x, w, g_w in; dx, dgamma out
    bwd_bytes = (B * N * D + B * rows * D + 2 * B * E + B * N * D + B * E) * 4 + 2 * index_bytes
    bwd_bound_ms, bwd_bound_by = bound(bwd_bytes, 4.0 * B * E * D + 4.0 * B * E, "float32")
    # dx alone: g_out and w in, dx out
    dx_bytes = (2 * B * N * D + B * E) * 4 + index_bytes
    dx_bound_ms, dx_bound_by = bound(dx_bytes, 2.0 * B * E * D, "float32")
    print(f"[spmm] {label} gather_target={gather_target}: forward {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, softmax+bmm {library_ms}, bound {bound_ms:.4f} ms "
          f"({bound_by}); backward {bwd_ms:.4f} ms (dx alone {dx_ms:.4f} ms, bound "
          f"{dx_bound_ms:.4f}), plain {bwd_plain_ms:.4f} ms, softmax+bmm backward "
          f"{bwd_library_ms}, bound {bwd_bound_ms:.4f} ms ({bwd_bound_by})", flush=True)
    shape = dict(label=label, gather_target=gather_target, B=B, N=N, E=E, D=D)
    fwd = dict(**shape, max_abs_err=max(errs.values()), errs=errs, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=fwd_bytes, flops=fwd_flops)
    bwd = dict(**shape, max_abs_err=max(bwd_errs.values()), errs=bwd_errs, ms=bwd_ms,
               plain_ms=bwd_plain_ms, library_ms=bwd_library_ms,
               bound_ms=bwd_bound_ms, bound_by=bwd_bound_by, bytes=bwd_bytes,
               dx_only_ms=dx_ms, dx_only_bound_ms=dx_bound_ms,
               dx_only_bound_by=dx_bound_by)
    return fwd, bwd


def sddmm_phase(label, B, D, device="cuda", seed=0):
    """Kernels vs plain for sddmm, forward and backward, on one graph.
    Returns (forward run, backward run)."""
    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    src, dst, N, complete = graph_topology(label, device, seed)
    E = src.numel()
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    q, k = (torch.randn((B, N, D), generator=gen, device=device) for _ in range(2))
    d_alpha = torch.randn((B, E), generator=gen, device=device)
    topo = sp.topology(src, dst, N)
    scale = D ** -0.5
    what = f"sddmm {label} D={D}"
    alpha = sp._sddmm_fwd_cuda(q, k, topo, scale)
    alpha2 = sp._sddmm_fwd_cuda(q, k, topo, scale)
    dq, dk = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    dq2, dk2 = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    p_alpha = sp._sddmm_fwd_plain(q, k, src, dst, scale)
    p_dq, p_dk = sp._sddmm_bwd_plain(d_alpha, q, k, src, dst, scale)
    torch.cuda.synchronize()
    err = rel_err(alpha, p_alpha)
    bwd_errs = {"dq": rel_err(dq, p_dq), "dk": rel_err(dk, p_dk)}
    print(f"[sddmm] {label} B={B} N={N} E={E} D={D}: forward rel err {err:.3e}, "
          f"backward rel err {bwd_errs} (tol {GRAPH_TOL:g})", flush=True)
    if max(err, *bwd_errs.values()) > GRAPH_TOL:
        raise AssertionError(f"{what}: the kernels disagree with the plain version")
    _equal_and_finite([("alpha", alpha, alpha2), ("dq", dq, dq2), ("dk", dk, dk2)], what)
    del p_alpha, p_dq, p_dk

    ms = time_ms(lambda: sp._sddmm_fwd_cuda(q, k, topo, scale))
    plain_ms = time_ms(lambda: sp._sddmm_fwd_plain(q, k, src, dst, scale),
                       reps=5, warmup=1)
    bwd_ms = time_ms(lambda: sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale))
    bwd_plain_ms = time_ms(lambda: sp._sddmm_bwd_plain(d_alpha, q, k, src, dst, scale),
                           reps=5, warmup=1)
    # the library yardstick, one bmm over all N x N pairs: on the complete
    # graph in source-major order alpha[b, s * N + n] = scale * k[b, s] . q[b, n]
    # is the product itself, on a sparse graph its E entries are read out
    def lib(q_, k_):
        grid = torch.bmm(k_, q_.transpose(1, 2)) * scale
        return grid.reshape(B, E) if complete else grid[:, src, dst]

    if rel_err(alpha, lib(q, k)) > GRAPH_TOL:
        raise AssertionError(f"{what}: the dense bmm form differs")
    library_ms = time_ms(lambda: lib(q, k))
    qr, kr = q.clone().requires_grad_(), k.clone().requires_grad_()
    a = lib(qr, kr)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(a, (qr, kr), d_alpha,
                                                         retain_graph=True))
    del a, qr, kr
    q_rows, k_rows = int(torch.unique(dst).numel()), int(torch.unique(src).numel())
    index_bytes = 2 * E * 4
    fwd_bytes = (B * (q_rows + k_rows) * D + B * E) * 4 + index_bytes
    bound_ms, bound_by = bound(fwd_bytes, 2.0 * B * E * D, "float32")
    bwd_bytes = (B * (q_rows + k_rows) * D + B * E + 2 * B * N * D) * 4 \
        + 2 * index_bytes + 2 * (E + N + 1) * 4
    bwd_bound_ms, bwd_bound_by = bound(bwd_bytes, 4.0 * B * E * D, "float32")
    print(f"[sddmm] {label} D={D}: forward {ms:.4f} ms, plain {plain_ms:.4f} ms, bmm "
          f"{library_ms}, bound {bound_ms:.4f} ms ({bound_by}); backward {bwd_ms:.4f} "
          f"ms, plain {bwd_plain_ms:.4f} ms, bmm backward {bwd_library_ms}, bound "
          f"{bwd_bound_ms:.4f} ms ({bwd_bound_by})", flush=True)
    shape = dict(label=label, B=B, N=N, E=E, D=D)
    fwd = dict(**shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=fwd_bytes)
    bwd = dict(**shape, max_abs_err=max(bwd_errs.values()), errs=bwd_errs, ms=bwd_ms,
               plain_ms=bwd_plain_ms, library_ms=bwd_library_ms,
               bound_ms=bwd_bound_ms, bound_by=bwd_bound_by, bytes=bwd_bytes)
    return fwd, bwd


def global_adj_phase(wrappers, device="cuda", seed=0, B=32):
    """raindrop_apply at P12 full width with random edge weights in
    [0.5, 2]: prop_backend 'pallas' (the SpMM kernel) against 'coo' (the
    segment ops), f32 attention operands, logits within 1e-4."""
    import torch
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_apply, raindrop_init
    from raindrop_tpu_torch.ops.sparse import spmm_segment_softmax

    cfgs = {b: dataset_config("P12", prop_backend=b, attention_score_dtype="float32")
            for b in ("pallas", "coo")}
    cfg = cfgs["pallas"]
    params = raindrop_init(seed, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    W = 0.5 + 1.5 * torch.rand((cfg.d_inp, cfg.d_inp), generator=gen, device=device)
    P, times, static = (torch.from_numpy(a).to(device)
                        for a in make_requests(cfg, B, seed + 4))
    src, tm = P.transpose(0, 1), times.transpose(0, 1)
    lengths = (tm > 0).sum(dim=0)
    out = {}
    with torch.no_grad():
        for name, c in cfgs.items():
            for fn in wrappers:
                fn.launches = 0
            logits, dist = raindrop_apply(params, c, src, static, tm, lengths,
                                          global_adj=W)
            out[name] = (logits, float(dist), spmm_segment_softmax.launches)
    torch.cuda.synchronize()
    diff = max_err(out["pallas"][0], out["coo"][0])
    print(f"[global_adj] P12 B={B}, weights in [0.5, 2]: pallas vs coo logits max "
          f"abs diff {diff:.3e} (tol 1e-4), distance {out['pallas'][1]:.6f} vs "
          f"{out['coo'][1]:.6f}; SpMM launches {out['pallas'][2]} (pallas), "
          f"{out['coo'][2]} (coo)", flush=True)
    if not diff <= 1e-4 or not bool(torch.isfinite(out["pallas"][0]).all()):
        raise AssertionError("raindrop_apply(global_adj): pallas and coo disagree")
    if out["pallas"][2] != 2 or out["coo"][2] != 0:
        raise AssertionError("raindrop_apply(global_adj): 'pallas' must launch the "
                             "SpMM kernel twice, 'coo' never")
    return dict(max_abs_diff=diff, launches=out["pallas"][2])


def selfattention_phase(wrappers, device="cuda", seed=0, N=36, D=860, heads=2):
    """ob_propagate_selfattention with score_backend 'sddmm' (the kernel)
    against 'gather', value and gradient w.r.t. x, on a kNN graph and on the
    complete one. Returns sddmm's forward and backward launch counts."""
    import torch
    from raindrop_tpu_torch.graph.propagate import (
        ob_propagate_selfattention, ob_propagation_init)
    from raindrop_tpu_torch.ops.sparse import sddmm

    gen = torch.Generator(device=device).manual_seed(seed + 5)
    params = ob_propagation_init(gen, D, D // heads, N, 4, heads=heads, device=device)
    x0 = torch.randn((N, D), generator=gen, device=device)
    cot = torch.randn((N, D), generator=gen, device=device)
    for fn in wrappers:
        fn.launches = fn.bwd_launches = 0
    checks = {}
    for kind in ("kNN36", "P12"):
        src, dst, n, _ = graph_topology(kind, device, seed)
        assert n == N
        ei = torch.stack([src, dst])
        res = {}
        for backend in ("sddmm", "gather"):
            x = x0.clone().requires_grad_()
            out, (_, alpha) = ob_propagate_selfattention(
                params, x, ei, heads=heads, n_nodes=N, score_backend=backend)
            out.backward(cot)
            res[backend] = (out.detach(), alpha.detach(), x.grad)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "alpha", "dx"), res["sddmm"], res["gather"]):
            checks[f"{kind}_{name}"] = rel_err(a, b)
    counts = (sddmm.launches, sddmm.bwd_launches)
    print(f"[selfattention] N={N} D={D} heads={heads}: sddmm vs gather rel err "
          f"{checks} (tol {GRAPH_TOL:g}); sddmm launches {counts[0]} forward, "
          f"{counts[1]} backward", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= GRAPH_TOL}
    if bad:
        raise AssertionError(f"selfattention: sddmm and gather disagree: {bad}")
    if counts != (2 * heads, 2 * heads):
        raise AssertionError(f"selfattention: expected {2 * heads} sddmm launches "
                             f"each way, got {counts}")
    return counts[0], counts[1], checks


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


PLAIN_ATTENTION = {"attention_backend": "dense"}
# Samples in the dense-path checks past MAX_FUSED_T steps: the dense rung
# keeps [B, H, T, T] f32 scores for its backward, 4.3 GB a tensor at
# B=128, H=2, T=2048.
DENSE_ROWS = 16
# The served rows' batch-composition limit with sensor_wise_mask and bf16
# attention operands. Another bucket gives cuBLAS another GEMM algorithm
# upstream of the encoder; a last-bit difference there can flip a bf16
# rounding of an attention operand (the kernels give a sample the same
# bits in any batch: flash_phase and fused_phase check it), and the
# sensor-wise pool weighs a sensor's steps by up to T (600 at PAM), so a
# row's probabilities move up to T times further than without the mask.
# serve_phase holds the kernel path with f32 operands to 1e-5, and the
# kernels' plain versions in bf16 (plain_kernels) to this limit: at PAM-sw
# on an H100 their rows move as far as the kernels' (4.6e-5 against 4.7e-5).
BATCH_LIMIT_SW = 1e-4
# The fixed-batch falling-loss check's rate with sensor_wise_mask. The
# reference's sensor-wise pool sums the unobserved steps over (#observed +
# 1), so a sensor never observed in a sample weighs up to T (215 at P12)
# and the head sees inputs of that size; Adam's first, sign-like steps then
# overshoot: at lr 1e-3 the loss on one batch jumps within the first steps
# and need not end below where it started. train_phase fits the dense
# path at 1e-3 on the same batch beside the kernel path (dropout 0): its
# loss does the same.
FIT_LR_SW = 1e-5
PLAIN_ALL = {"attention_backend": "dense", "prop_backend": "auto"}


COUNTS = ("launches", "bwd_launches", "tc_launches", "tc_bwd_launches")


def reset_counts(wrappers):
    """Set every launch count of the wrappers to 0 (flash_mha_packed also
    counts its tensor-core launches apart, as tc_launches / tc_bwd_launches)."""
    for fn in wrappers:
        for attr in COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_counts(wrappers, attr):
    """{wrapper name: count}, plus "<name>.tc" where the wrapper counts its
    tensor-core launches apart."""
    out = {fn.__name__: getattr(fn, attr) for fn in wrappers}
    out.update({f"{fn.__name__}.tc": getattr(fn, f"tc_{attr}") for fn in wrappers
                if hasattr(fn, f"tc_{attr}")})
    return out


def check_tc(what, *counts):
    """Every flash_mha_packed launch in these counts took the tensor-core
    route (the model's attention operands are bf16)."""
    for c in counts:
        if c["flash_mha_packed"] <= 0 or c["flash_mha_packed.tc"] != c["flash_mha_packed"]:
            raise AssertionError(f"{what}: flash_mha_packed launches off the "
                                 f"tensor-core route: {c}")


def check_fused_tc(what, *counts):
    """Every fused_encoder_layer launch in these counts took the
    tensor-core route (bf16 operands: PAM's and PAM-sw's widths)."""
    for c in counts:
        if (c["fused_encoder_layer"] <= 0
                or c["fused_encoder_layer.tc"] != c["fused_encoder_layer"]):
            raise AssertionError(f"{what}: fused_encoder_layer launches off the "
                                 f"tensor-core route: {c}")


def check_scalar(what, *counts):
    """Every flash_mha_packed launch in these counts took the scalar route
    (a head dim past the tensor-core kernels' widths: P12's sensor-wise
    hd 360)."""
    for c in counts:
        if c["flash_mha_packed"] <= 0 or c["flash_mha_packed.tc"] != 0:
            raise AssertionError(f"{what}: flash_mha_packed launches off the "
                                 f"scalar route: {c}")


@contextlib.contextmanager
def plain_kernels():
    """The encoder's kernel rungs run their wrappers' plain versions on the
    card, operands rounded as the kernels round them: the plain path at the
    kernels' precision (the dense rung attends in f32), which serve_phase
    serves beside the kernels to see how far its rows move across batches."""
    from raindrop_tpu_torch.nn import transformer as tr
    from raindrop_tpu_torch.ops import flash_attention as fa
    from raindrop_tpu_torch.ops import fused_encoder as fe

    saved = tr.flash_mha_packed, tr.fused_encoder_layer, tr.flash_mha
    tr.flash_mha_packed = lambda q, k, v, lengths, seed, rate, cd, nhead: (
        fa._packed_fwd_plain(q, k, v, lengths, nhead, fa.operand_dtype(cd),
                             fa._seed_int(seed), rate)[0])
    tr.fused_encoder_layer = lambda p, x, lengths, seed, rate, cd, nhead: (
        fe._fused_fwd_plain(p, x, lengths, nhead, fa.operand_dtype(cd),
                            fa._seed_int(seed), rate)[0])
    tr.flash_mha = lambda q, k, v, lengths, seed, rate, cd: (
        fa._flash_fwd_plain(q, k, v, lengths, fa.operand_dtype(cd),
                            fa._seed_int(seed), rate)[0])
    try:
        yield
    finally:
        tr.flash_mha_packed, tr.fused_encoder_layer, tr.flash_mha = saved


def serve_phase(dataset, kernel_fns, wrappers, device="cuda", seed=0,
                cfg_overrides=None, plain_overrides=PLAIN_ATTENTION,
                buckets=(1, 8, 32, 128), batch_limit=1e-5):
    """Serve one preset at full width and check it. Every wrapper's launch
    count is set to 0 just before the served requests and read just after;
    returns those counts by wrapper name. `kernel_fns` are the wrappers
    this path must go through; `plain_overrides` turn its config into the
    plain path it is held against; `batch_limit` bounds how far a row's
    probabilities may move with the batch it is served in (other buckets
    give cuBLAS other GEMM algorithms: the last bits move). The dense plain
    server's own stream-against-predict difference is printed beside."""
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
    reset_counts(wrappers)
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
    launches = read_counts(wrappers, "launches")
    served_s = time.perf_counter() - t0
    # model forwards behind those requests, for the launches-per-forward checks
    forwards = server.health()["batches"] + wire.health()["batches"]
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
    limits = {"alone_vs_full_bucket": batch_limit, "predict_vs_chunked": batch_limit,
              "submit_vs_predict": batch_limit, "stream_vs_predict": batch_limit,
              "bf16_wire_vs_f32": 5e-2}
    batch = {}

    # the same params on the dense plain path, and the kernel path with
    # f32 attention operands; each one's rows streamed 8 at a time against
    # the same rows in the top bucket (its own batch dependence), and the
    # kernels' plain versions in bf16 beside
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        c_k = dataset_config(dataset, **{**kw, "attention_score_dtype": score})
        c_d = dataset_config(dataset, **{**kw, **plain_overrides,
                                         "attention_score_dtype": score})
        s_k = InferenceServer(c_k, server.params, buckets=buckets, device=device)
        s_d = InferenceServer(c_d, server.params, buckets=buckets, device=device)
        a = s_k.predict(P[:top], times[:top], _rows(static, slice(0, top)))
        b = s_d.predict(P[:top], times[:top], _rows(static, slice(0, top)))
        checks[f"kernel_vs_dense_{score}"] = float(np.abs(a - b).max())
        limits[f"kernel_vs_dense_{score}"] = tol
        for path, srv, top_probs in (("kernel", s_k, a), ("dense", s_d, b)):
            batch[f"{path}_{score}"] = float(np.abs(np.concatenate(
                list(srv.predict_stream(reqs, depth=3))) - top_probs[:48]).max())
        if score == "bfloat16":
            with plain_kernels():
                c = s_k.predict(P[:top], times[:top], _rows(static, slice(0, top)))
                batch["plain_bfloat16"] = float(np.abs(np.concatenate(
                    list(s_k.predict_stream(reqs, depth=3))) - c[:48]).max())
            batch["kernel_vs_plain_bfloat16"] = float(np.abs(a - c).max())
        s_k.close()
        s_d.close()
    checks["kernel_float32_stream_vs_predict"] = batch["kernel_float32"]
    limits["kernel_float32_stream_vs_predict"] = 1e-5
    # the plain path at the kernels' precision holds the batch limit too
    checks["plain_bfloat16_stream_vs_predict"] = batch["plain_bfloat16"]
    limits["plain_bfloat16_stream_vs_predict"] = batch_limit
    print(f"[serve] {dataset}: checks {checks}; stream_vs_predict by path and "
          f"operand dtype {batch}", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{dataset}: checks over their limits: {bad} "
                             f"(limits {limits})")
    for fn in kernel_fns:
        if launches[fn.__name__] <= 0:
            raise AssertionError(f"{dataset}: the served path never launched "
                                 f"{fn.__name__}")
    timing = serve_timing(dataset, server, P, times, static)
    server.close()
    return launches, dict(served_s=served_s, forwards=forwards, checks=checks,
                          limits=limits, stream_vs_predict_by_path=batch, **timing)


def check_two_a_forward(label, launches, serve):
    """A served 2048-step path launched flash_mha twice a forward (once a
    layer) and no other kernel."""
    if launches["flash_mha"] != 2 * serve["forwards"]:
        raise AssertionError(
            f"{label}: two flash_mha launches per forward expected, got "
            f"{launches['flash_mha']} for {serve['forwards']} forwards")
    others = {k: v for k, v in launches.items() if k != "flash_mha" and v}
    if others:
        raise AssertionError(f"{label}: the served path launched other kernels: {others}")


def profile_device(fn, n):
    """Run fn() under torch.profiler: (wall ms, device ms, idle share, top
    device operations), all per one of the `n` units of work fn does."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    kernels = {}
    for evt in prof.key_averages():
        # kernels and copies only: an annotation such as the optimizer's
        # step is mirrored on the device timeline and would count twice
        if (getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.key.startswith("Optimizer.")):
            us = getattr(evt, "self_device_time_total", 0.0)
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / (1e3 * n)
    device_ms = sum(kernels.values())
    top_k = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    idle = 1.0 - device_ms / wall_ms if device_ms > 0 else None
    return wall_ms, device_ms, idle, top_k


def serve_timing(dataset, server, P, times, static, reps=7):
    """Request latency by bucket (host clock around predict, which ends in
    the device-to-host copy) and a profile of the top bucket: device time
    by kernel and the device's idle share of the request's wall time."""
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
    wall_ms, device_ms, idle, top_k = profile_device(
        lambda: [server.predict(*args) for _ in range(3)], 3)
    print(f"[serve] {dataset}: predict latency ms by bucket {latency}; top "
          f"bucket profiled: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"idle share {idle}", flush=True)
    for name, ms in top_k.items():
        print(f"[serve] {dataset}:   {ms:8.4f} ms  {name[:100]}", flush=True)
    return dict(latency_ms=latency, profile_wall_ms=wall_ms,
                profile_device_ms=device_ms, idle_share=idle,
                device_ms_by_kernel=top_k)


# ---------------------------------------------------------------- training
def make_split(cfg, n, seed, device):
    """A synthetic labelled split resident on `device`, batch-major:
    make_requests plus labels cycling through the classes."""
    import torch

    P, times, static = make_requests(cfg, n, seed)
    y = (np.arange(n) % cfg.n_classes).astype(np.int64)
    data = {"P": torch.from_numpy(P), "time": torch.from_numpy(times),
            "y": torch.from_numpy(y)}
    if static is not None:
        data["static"] = torch.from_numpy(static)
    return {k: v.to(device) for k, v in data.items()}, y


def grad_norm(trainer):
    import torch

    return float(torch.sqrt(sum((t.grad.double() ** 2).sum()
                                for _, t in trainer.live)))


def train_phase(dataset, kernel_fns, wrappers, device="cuda", seed=0, batch=128,
                cfg_overrides=None, plain_overrides=PLAIN_ATTENTION, fit_lr=1e-3):
    """Train one preset at full width and depth and check it. Every
    wrapper's counts are set to 0 just before the epoch and the predict and
    read just after; returns the forward and backward counts by wrapper
    name. `kernel_fns` are the wrappers this training must go through,
    forward and backward; `plain_overrides` turn its config into the plain
    path its first step and its steps at lr 1e-3 on one batch are held
    against; `fit_lr` is the learning rate of the falling-loss check on
    that batch, cut to its first DENSE_ROWS rows past MAX_FUSED_T steps."""
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.nn.transformer import encoder_rung
    from raindrop_tpu_torch.ops.flash_attention import MAX_FUSED_T
    from raindrop_tpu_torch.train.trainer import Trainer, flatten_params
    from raindrop_tpu_torch.utils.dropout import DropoutSeeds

    kw = dict(cfg_overrides or {})
    cfg = dataset_config(dataset, **kw)
    strategy = 3 if cfg.n_classes > 2 else 2
    tcfg = TrainConfig(dataset=dataset, learning_rate=1e-4, batch_size=batch,
                       batching_strategy=strategy, seed=seed + 1)
    rung = encoder_rung(cfg.attention_backend, cfg.max_len, cfg.d_transformer,
                        cfg.nhead, True)
    n = 5 * batch
    data, y = make_split(cfg, n, seed + 2, device)
    idx_np = np.stack(list(balanced_batches(
        y, batch, strategy, np.random.default_rng(seed),
        n_batches=6 if strategy == 3 else None)))
    idx = torch.from_numpy(idx_np).to(device)
    steps = idx.shape[0]
    print(f"[train] {dataset}: T={cfg.max_len} d={cfg.d_transformer} "
          f"ffn={cfg.ffn_dim} nlayers={cfg.nlayers} dropout={cfg.dropout} "
          f"operands {cfg.attention_score_dtype}; encoder rung: {rung}; "
          f"{steps} steps of {batch} from {n} samples (strategy {strategy})",
          flush=True)
    if steps < 5:
        raise AssertionError(f"{dataset}: an epoch of {steps} steps, need 5")

    trainer = Trainer(cfg, tcfg, device=device)
    before = {path: t.detach().clone() for path, t in flatten_params(trainer.params)}
    t0 = time.perf_counter()
    reset_counts(wrappers)
    losses, _ = trainer.train_epoch(data, idx)
    n_pred = min(200, n)    # two chunks of 100: the second is a padded tail
    P_host, time_host = (data[k][:n_pred].cpu().numpy() for k in ("P", "time"))
    static_host = data["static"][:n_pred].cpu().numpy() if "static" in data else None
    logits = trainer.predict(None, P_host, time_host, static_host)
    launches = read_counts(wrappers, "launches")
    bwd_launches = read_counts(wrappers, "bwd_launches")
    train_s = time.perf_counter() - t0
    print(f"[train] {dataset}: epoch + predict in {train_s:.3f} s; losses "
          f"{[round(float(x), 6) for x in losses]}; forward launches {launches}, "
          f"backward launches {bwd_launches}", flush=True)
    if not bool(torch.isfinite(losses).all()) or not np.isfinite(logits).all():
        raise AssertionError(f"{dataset}: a loss or a predicted logit is not finite")
    if logits.shape != (n_pred, cfg.n_classes):
        raise AssertionError(f"{dataset}: predict gave {logits.shape}")
    for fn in kernel_fns:
        if bwd_launches[fn.__name__] <= 0 or launches[fn.__name__] <= 0:
            raise AssertionError(f"{dataset}: training never launched "
                                 f"{fn.__name__} forward and backward")
    live = {path for path, _ in trainer.live}
    for path, t in flatten_params(trainer.params):
        same = torch.equal(t.detach(), before[path])
        if same == (path in live):
            raise AssertionError(f"{dataset}: parameter {path} is "
                                 f"{'unchanged' if same else 'changed'} after an epoch")
    if len(trainer.optimizer.state) != len(trainer.live):
        raise AssertionError(f"{dataset}: optimizer state for a dead parameter")

    # the same epoch from the same seeds: bit-equal losses
    again, _ = Trainer(cfg, tcfg, device=device).train_epoch(data, idx)
    if not torch.equal(again, losses):
        raise AssertionError(f"{dataset}: the same epoch twice gave {losses} "
                             f"and {again}")

    # first step's loss and gradient norm against the dense path, dropout 0
    rows = DENSE_ROWS if cfg.max_len > MAX_FUSED_T else None
    first = {k: v[idx[0][:rows]] for k, v in data.items()}
    checks, limits = {}, {}
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        pair = []
        for plain in ({}, plain_overrides):
            c = dataset_config(dataset, **{**kw, "dropout": 0.0, **plain,
                                           "attention_score_dtype": score})
            tr_ = Trainer(c, tcfg, device=device, params=trainer.params)
            loss, _ = tr_._backward(first, None)
            pair.append((float(loss), grad_norm(tr_)))
            del tr_
        (lk, gk), (ld, gd) = pair
        checks[f"loss_vs_dense_{score}"] = abs(lk - ld) / abs(ld)
        checks[f"grad_norm_vs_dense_{score}"] = abs(gk - gd) / gd
        limits[f"loss_vs_dense_{score}"] = limits[f"grad_norm_vs_dense_{score}"] = tol
        print(f"[train] {dataset}: first step, {score} operands, dropout 0: loss "
              f"{lk:.7f} (dense {ld:.7f}), gradient norm {gk:.7f} (dense {gd:.7f})",
              flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{dataset}: against the dense path: {bad} "
                             f"(limits {limits})")

    # fit_lr on one fixed batch: the loss falls over 10 steps (measured
    # before and after under one fixed set of masks)
    fixed = DropoutSeeds.draw(torch.Generator().manual_seed(seed), cfg.nlayers)

    def fit_batch(lr):
        fit = Trainer(cfg, tcfg, device=device, params=trainer.params)
        fit.learning_rate = lr
        with torch.no_grad():
            before = float(fit.loss_fn(first, fixed)[0])
        steps = [float(fit.train_step(first)[0]) for _ in range(10)]
        with torch.no_grad():
            after = float(fit.loss_fn(first, fixed)[0])
        print(f"[train] {dataset}: fixed batch at lr {lr:g}: loss {before:.6f} -> "
              f"{after:.6f} after 10 steps; step losses "
              f"{[round(x, 5) for x in steps]}", flush=True)
        return before, after, steps

    loss0, loss1, fit_losses = fit_batch(fit_lr)
    if not loss1 < loss0:
        raise AssertionError(f"{dataset}: the loss did not fall: {loss0} -> {loss1}")

    # lr 1e-3 on that batch at dropout 0, ten steps on the kernel path and
    # on the dense one: the loss before and after the first step agree (the
    # first-step tolerances); past a jump of the loss the two part as the
    # JAX trainer parts from itself (tests/test_torch_sensor_wise.py), and
    # whether the dense path's loss falls there is FIT_LR_SW's witness
    follow = {}
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        runs = []
        for plain in ({}, plain_overrides):
            c = dataset_config(dataset, **{**kw, "dropout": 0.0, **plain,
                                           "attention_score_dtype": score})
            fit = Trainer(c, tcfg, device=device, params=trainer.params)
            fit.learning_rate = 1e-3
            runs.append([float(fit.train_step(first)[0]) for _ in range(10)])
            del fit
        (lk, ld) = runs
        follow[score] = dict(kernel=lk, dense=ld, first_two=max(
            abs(a - b) / abs(b) for a, b in zip(lk[:2], ld[:2])), limit=tol)
        print(f"[train] {dataset}: lr 1e-3, dropout 0, {score} operands, step "
              f"losses {[round(x, 5) for x in lk]}, dense {[round(x, 5) for x in ld]}: "
              f"the first two {follow[score]['first_two']:.3e} apart (limit {tol:g})",
              flush=True)
    bad = {k: v["first_two"] for k, v in follow.items() if not v["first_two"] <= v["limit"]}
    if bad:
        raise AssertionError(f"{dataset}: at lr 1e-3 the first step's losses part "
                             f"from the dense path's: {bad}")

    # timings: CUDA events around each step, then a profiled epoch
    timed = Trainer(cfg, tcfg, device=device, params=trainer.params)
    timed.train_epoch(data, idx[:2])
    step_ms = []
    for k in range(steps):
        b = {name: t[idx[k]] for name, t in data.items()}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        timed.train_step(b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    timed.train_epoch(data, idx)
    epoch_ms = 1e3 * (time.perf_counter() - t0)
    wall_ms, device_ms, idle, top_k = profile_device(
        lambda: timed.train_epoch(data, idx), steps)
    step_med = float(np.median(step_ms))
    sps = batch * steps / (epoch_ms / 1e3)
    print(f"[train] {dataset}: step {step_med:.3f} ms (median of {steps}, CUDA "
          f"events; all {[round(x, 3) for x in step_ms]}); epoch of {steps} steps "
          f"{epoch_ms:.3f} ms by the host clock = {sps:.1f} samples/s; profiled: "
          f"wall {wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, idle "
          f"share {idle}", flush=True)
    for name, ms in top_k.items():
        print(f"[train] {dataset}:   {ms:8.4f} ms/step  {name[:100]}", flush=True)
    return launches, bwd_launches, dict(
        rung=rung, steps=steps, train_s=train_s, losses=[float(x) for x in losses],
        checks=checks, limits=limits, fixed_batch=(loss0, loss1),
        fixed_batch_losses=fit_losses, fit_lr=fit_lr, lr_1e3_vs_dense=follow,
        step_ms=step_ms, step_ms_median=step_med,
        epoch_ms=epoch_ms, samples_per_s=sps, profile_wall_ms=wall_ms,
        profile_device_ms=device_ms, idle_share=idle, device_ms_by_kernel=top_k)


# ----------------------------------------------------------------- protocol
LONG = {"max_len": 2048}


def _history(result):
    return [{k: v for k, v in rec.items() if k != "elapsed_s"}
            for rec in result.history]


def _check_result(what, result, cfg, epochs):
    if len(result.history) != epochs:
        raise AssertionError(f"{what}: {len(result.history)} records for {epochs} epochs")
    for rec in result.history:
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{what}: a record is not finite: {rec}")
        if not (0.0 <= rec["val_auroc"] <= 1.0 and 0.0 <= rec["val_auprc"] <= 1.0):
            raise AssertionError(f"{what}: validation metrics outside [0, 1]: {rec}")
    if not all(0.0 <= v <= 1.0 for v in result.test_metrics.values()):
        raise AssertionError(f"{what}: test metrics outside [0, 1]: {result.test_metrics}")
    if result.test_confusion.shape != (cfg.n_classes, cfg.n_classes):
        raise AssertionError(f"{what}: confusion matrix {result.test_confusion.shape}")


def protocol_phase(wrappers, device="cuda", seed=0, batch=128, n=320, n_batches=3,
                   overrides=LONG, label="PAM-2048", epochs=3):
    """train_split with checkpoints, resume and the uninterrupted run on
    PAM's width with `overrides` (max_len 2048; with sensor_wise_mask too):
    epochs - 1 epochs with checkpoints, the last epoch resumed from the
    `_last` file, the uninterrupted run of `epochs`; the first step against
    the dense path; the step's time. Returns flash_mha's forward and
    backward launch counts over the checkpointed run, and the details."""
    import dataclasses
    import tempfile

    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.nn.transformer import encoder_rung
    from raindrop_tpu_torch.ops.flash_attention import flash_mha
    from raindrop_tpu_torch.train.checkpoint import load_checkpoint
    from raindrop_tpu_torch.train.trainer import Trainer, flatten_params

    cfg = dataset_config("PAM", **overrides)
    tcfg = TrainConfig(dataset="PAM", num_epochs=epochs, learning_rate=1e-4,
                       batch_size=batch, batching_strategy=3,
                       n_batches_strategy3=n_batches, seed=seed + 1)
    T, d, H = cfg.max_len, cfg.d_transformer, cfg.nhead
    rung = encoder_rung(cfg.attention_backend, T, d, H, True)
    trainer = Trainer(cfg, tcfg, device=device)
    n_all = sum(t.numel() for _, t in flatten_params(trainer.params))
    n_live = sum(t.numel() for _, t in trainer.live)
    side = T * cfg.d_ob
    print(f"[protocol] {label}: PAM at max_len {T}, sensor_wise_mask "
          f"{cfg.sensor_wise_mask}: d={d}, ffn={cfg.ffn_dim}, {H} heads of "
          f"{d // H}, {cfg.nlayers} layers, {cfg.n_classes} classes; each propagation "
          f"layer holds 13 matrices' worth of {side}^2 f32 = "
          f"{13 * side * side * 4 / 1e9:.2f} GB; {n_all / 1e6:.1f} M parameters "
          f"({4 * n_all / 1e9:.2f} GB), {n_live / 1e6:.1f} M live, Adam moments "
          f"{8 * n_live / 1e9:.2f} GB; attention: B*H = {batch * H} heads of {T} x {T}; "
          f"encoder rung: {rung}", flush=True)
    if rung != "flash_mha":
        raise AssertionError(f"max_len {T} must take the flash_mha rung, got {rung}")
    t0 = time.perf_counter()
    split = synthetic_split("PAM", n, seed, T=T)
    n_train, n_val, n_test = len(split.ytrain), len(split.yval), len(split.ytest)
    print(f"[protocol] {label}: synthetic_split: {n_train} train, {n_val} val, {n_test} test, "
          f"made in {time.perf_counter() - t0:.1f} s; {n_batches} batches of {batch} "
          f"an epoch (sampler strategy 3), dropout {cfg.dropout}, operands "
          f"{cfg.attention_score_dtype}", flush=True)

    def chunks(m):          # predict's chunks of 100 rows
        return -(-m // 100)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, label)
        # epochs - 1 epochs with checkpoints: the run that gets interrupted
        cut_epochs = epochs - 1
        trainer.tcfg = dataclasses.replace(tcfg, num_epochs=cut_epochs)
        for fn in wrappers:
            fn.launches = fn.bwd_launches = 0
        t0 = time.perf_counter()
        cut = trainer.train_split(split, checkpoint_path=path, verbose=False)
        cut_s = time.perf_counter() - t0
        fwd, bwd = flash_mha.launches, flash_mha.bwd_launches
        _check_result(f"{label} train_split, {cut_epochs} epochs", cut, cfg, cut_epochs)
        steps = cut_epochs * n_batches
        want_fwd = cfg.nlayers * (steps + cut_epochs * chunks(n_val) + chunks(n_test))
        sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        print(f"[protocol] {label}: {cut_epochs} epochs + test in {cut_s:.1f} s: "
              f"history {_history(cut)}; "
              f"test {cut.test_metrics}; flash_mha launches {fwd} forward (expected "
              f"{want_fwd}), {bwd} backward (expected {cfg.nlayers * steps}); "
              f"files {sizes}", flush=True)
        if fwd != want_fwd or bwd != cfg.nlayers * steps:
            raise AssertionError(f"{label} train_split: flash_mha launch counts are off")
        best, _, meta = load_checkpoint(path, trainer.params)
        for (name, a), (_, b) in zip(flatten_params(best), flatten_params(cut.params)):
            if not torch.equal(a, b.detach()):
                raise AssertionError(f"the best file does not reload: {name}")
        if meta["config"]["max_len"] != T:
            raise AssertionError("the best file's sidecar lost its config")
        del best, cut
        # a fresh trainer picks the run up for its last epoch
        del trainer
        torch.cuda.empty_cache()
        trainer = Trainer(cfg, tcfg, device=device)
        t0 = time.perf_counter()
        resumed = trainer.train_split(split, checkpoint_path=path,
                                      resume_from=path + "_last", verbose=False)
        resume_s = time.perf_counter() - t0
    _check_result(f"{label} train_split, resumed", resumed, cfg, epochs)
    # the same trainer, from scratch again, uninterrupted and without files
    t0 = time.perf_counter()
    full = trainer.train_split(split, verbose=False)
    full_s = time.perf_counter() - t0
    _check_result(f"{label} train_split, {epochs} epochs", full, cfg, epochs)
    print(f"[protocol] {label}: resumed last epoch in {resume_s:.1f} s, uninterrupted "
          f"{epochs} epochs in {full_s:.1f} s ({full.samples_per_sec:.1f} samples/s with "
          f"validation): history {_history(full)}; test {full.test_metrics}", flush=True)
    if _history(resumed) != _history(full) or resumed.test_metrics != full.test_metrics:
        raise AssertionError(f"{label}: the resumed run differs from the uninterrupted one: "
                             f"{_history(resumed)} vs {_history(full)}")
    del resumed

    # first step's loss and gradient norm against the dense path, dropout 0,
    # on DENSE_ROWS samples
    data = {"P": torch.from_numpy(split.Ptrain[:DENSE_ROWS]).to(device),
            "time": torch.from_numpy(split.Ptrain_time[:DENSE_ROWS]).to(device),
            "y": torch.from_numpy(split.ytrain[:DENSE_ROWS]).to(device).long()}
    checks, limits = {}, {}
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        pair = []
        for plain in ({}, PLAIN_ATTENTION):
            c = dataset_config("PAM", **{**overrides, "dropout": 0.0, **plain,
                                        "attention_score_dtype": score})
            tr_ = Trainer(c, tcfg, device=device, params=trainer.params)
            loss, _ = tr_._backward(data, None)
            pair.append((float(loss), grad_norm(tr_)))
            del tr_
        (lk, gk), (ld, gd) = pair
        checks[f"loss_vs_dense_{score}"] = abs(lk - ld) / abs(ld)
        checks[f"grad_norm_vs_dense_{score}"] = abs(gk - gd) / gd
        limits[f"loss_vs_dense_{score}"] = limits[f"grad_norm_vs_dense_{score}"] = tol
        print(f"[protocol] {label}: first step on {DENSE_ROWS} samples, {score} operands, "
              f"dropout 0: loss "
              f"{lk:.7f} (dense {ld:.7f}), gradient norm {gk:.7f} (dense {gd:.7f})",
              flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{label} against the dense path: {bad} (limits {limits})")
    torch.cuda.empty_cache()

    # timings: CUDA events around each step, then an epoch, then a profile
    train_dev = {"P": torch.from_numpy(split.Ptrain).to(device),
                 "time": torch.from_numpy(split.Ptrain_time).to(device),
                 "y": torch.from_numpy(split.ytrain).to(device).long()}
    idx = torch.stack([torch.randperm(n_train, generator=torch.Generator().manual_seed(i))
                       [:batch] for i in range(n_batches)]).to(device)
    trainer.train_epoch(train_dev, idx[:1])
    step_ms = []
    for k in range(n_batches):
        b = {name: t[idx[k]] for name, t in train_dev.items()}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_step(b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    trainer.train_epoch(train_dev, idx)
    epoch_ms = 1e3 * (time.perf_counter() - t0)
    wall_ms, device_ms, idle, top_k = profile_device(
        lambda: trainer.train_epoch(train_dev, idx), n_batches)
    step_med = float(np.median(step_ms))
    sps = batch * n_batches / (epoch_ms / 1e3)
    print(f"[protocol] {label}: step {step_med:.3f} ms (median of {n_batches}, CUDA "
          f"events; all {[round(x, 3) for x in step_ms]}); epoch of {n_batches} steps "
          f"{epoch_ms:.3f} ms by the host clock = {sps:.1f} samples/s; profiled: wall "
          f"{wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, idle share {idle}",
          flush=True)
    for name, ms in top_k.items():
        print(f"[protocol] {label}:   {ms:8.4f} ms/step  {name[:100]}", flush=True)
    return fwd, bwd, dict(
        label=label, epochs=epochs, rung=rung, params=n_all, live_params=n_live,
        split=(n_train, n_val, n_test),
        cut_s=cut_s, resume_s=resume_s, full_s=full_s, files=sizes,
        history=_history(full), test=full.test_metrics, checks=checks, limits=limits,
        step_ms=step_ms, step_ms_median=step_med, epoch_ms=epoch_ms,
        samples_per_s=sps, profile_wall_ms=wall_ms, profile_device_ms=device_ms,
        idle_share=idle, device_ms_by_kernel=top_k)


def run_splits_phase(device="cuda", seed=0, batch=128, n=320, n_batches=2):
    """run_splits on the 2048 configuration: 2 splits of 1 epoch, for the
    summary's shape."""
    import tempfile

    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.train.trainer import run_splits

    cfg = dataset_config("PAM", **LONG)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(dataset="PAM", num_epochs=1, learning_rate=1e-4,
                           batch_size=batch, batching_strategy=3,
                           n_batches_strategy3=n_batches, n_splits=2, seed=seed + 1,
                           checkpoint_dir=tmp)
        out = run_splits(lambda k: synthetic_split("PAM", n, seed + k, T=cfg.max_len),
                         cfg, tcfg, device=device, verbose=False)
        files = sorted(os.listdir(tmp))
    took = time.perf_counter() - t0
    print(f"[protocol] run_splits, 2 splits of 1 epoch, in {took:.1f} s: summary "
          f"{out['summary']}; files {files}", flush=True)
    names = {"accuracy", "auroc", "auprc", "precision", "recall", "f1"}
    if set(out["summary"]) != names or len(out["per_split"]) != 2:
        raise AssertionError(f"run_splits: summary {sorted(out['summary'])}")
    for name, s_ in out["summary"].items():
        if len(s_["per_split"]) != 2 or not (0.0 <= s_["mean"] <= 100.0
                                             and np.isfinite(s_["std"])):
            raise AssertionError(f"run_splits: {name} = {s_}")
    if len([f for f in files if f.endswith("_last.npz")]) != 2:
        raise AssertionError(f"run_splits: checkpoints {files}")
    return dict(seconds=took, summary=out["summary"])


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number measured to this JSON file")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
        from raindrop_tpu_torch.ops.flash_attention import flash_mha, flash_mha_packed
        from raindrop_tpu_torch.ops.fused_encoder import fused_encoder_layer
        from raindrop_tpu_torch.ops.sparse import (
            sddmm, spmm_segment_softmax, topology)
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
    phase_s = {}
    with phase(phase_s, "sass"):
        sass = sass_phase()

    grid = [(dt, rate) for dt in ("float32", "bfloat16") for rate in (0.0, 0.2)]
    with phase(phase_s, "packed and fused-layer kernels"):
        flash = [flash_phase("P12", 128, 215, 160, 2, dt) for dt in ("float32", "bfloat16")]
        flash += [flash_phase("eICU", 128, 300, 72, 2, dt) for dt in ("float32", "bfloat16")]
        fused = [fused_phase("PAM", 128, 600, 84, 136, 2, dt)
                 for dt in ("float32", "bfloat16")]
        flash_bwd = [flash_bwd_phase("P12", 128, 215, 160, 2, dt, rate) for dt, rate in grid]
        flash_bwd += [flash_bwd_phase("eICU", 128, 300, 72, 2, dt, rate) for dt, rate in grid]
        edges = [flash_edge_phase(hd, T, rate)
                 for hd in (3, 8, 13, 42, 84, 128, 129, 140, 144, 170, 360)
                 for T in (64, 65, 1024) for rate in (0.0, 0.2)]
        fused_bwd = [fused_bwd_phase("PAM", 128, 600, 84, 136, 2, dt, rate)
                     for dt, rate in grid]
    torch.cuda.empty_cache()
    # the fused layer at an edge shape (T and a length ending inside a
    # 64-row tile, lengths 0 and 1) at PAM's width and its sensor-wise one
    with phase(phase_s, "fused-layer edge shapes"):
        fused_edges = [fused_edge_phase(label, d, 136, 2, dt, rate)
                       for label, d in (("PAM", 84), ("PAM-sw", 340))
                       for dt, rate in grid]
    # the sensor-wise widths (d_inp * (d_ob + d_pe), 2 heads): P12 hd 360 on
    # the scalar route in both dtypes, eICU hd 140 on the tensor cores in
    # bf16, PAM's fused layer at d=340, hd 170
    with phase(phase_s, "packed and fused-layer kernels, sensor-wise widths"):
        sw_shapes = (("P12-sw", 215, 720), ("eICU-sw", 300, 280))
        sw_flash = [flash_phase(label, 128, T, d, 2, dt) for label, T, d in sw_shapes
                    for dt in ("float32", "bfloat16")]
        sw_flash_bwd = [flash_bwd_phase(label, 128, T, d, 2, dt, rate)
                        for label, T, d in sw_shapes for dt, rate in grid]
        sw_fused = [fused_phase("PAM-sw", 128, 600, 340, 136, 2, dt)
                    for dt in ("float32", "bfloat16")]
        sw_fused_bwd = [fused_bwd_phase("PAM-sw", 128, 600, 340, 136, 2, dt, rate)
                        for dt, rate in grid]
    for r in sw_flash:
        want = "tc" if r["label"] == "eICU-sw" and r["dtype"] == "bfloat16" else "scalar"
        if r["route"] != want:
            raise AssertionError(f"{r['label']} {r['dtype']} took the {r['route']} "
                                 f"route, expected {want}")
    # the fused layer: bf16 row products on the tensor cores at both widths,
    # the attention too at PAM's hd 42 (scalar at PAM-sw's 170); f32 scalar
    for r in (*fused, *fused_bwd, *sw_fused, *sw_fused_bwd, *fused_edges):
        bf = r["dtype"] == "bfloat16"
        want = ("tc" if bf else "scalar",
                "tc" if bf and not r["label"].endswith("-sw") else "scalar")
        if (r["route"], r["attn_route"]) != want:
            raise AssertionError(f"fused layer {r['label']} {r['dtype']} took the "
                                 f"{r['route']}/{r['attn_route']} routes, expected {want}")
    torch.cuda.empty_cache()
    with phase(phase_s, "graph kernels"):
        spmm_runs = [spmm_phase(label, 128, D, gt)
                     for label, D in (("P12", 860), ("PAM", 2400), ("kNN", 240))
                     for gt in (True, False)]
        spmm_fwd, spmm_bwd = ([r[i] for r in spmm_runs] for i in (0, 1))
        # B=1, N=36, D=430: what ob_propagate_selfattention hands the kernel
        # (one sample, one call per head); the others are batch-scale shapes
        sddmm_runs = [sddmm_phase("P12", 1, 430)]
        sddmm_runs += [sddmm_phase(label, 128, D) for label in ("P12", "PAM", "kNN")
                       for D in (860, 120)]
        sddmm_fwd, sddmm_bwd = ([r[i] for r in sddmm_runs] for i in (0, 1))
    torch.cuda.empty_cache()

    wrappers = (flash_mha_packed, fused_encoder_layer, spmm_segment_softmax, sddmm,
                flash_mha)
    with phase(phase_s, "serve and train PAM, P12"):
        pam_launches, pam = serve_phase("PAM", [fused_encoder_layer], wrappers)
        p12_launches, p12 = serve_phase("P12", [flash_mha_packed], wrappers)
        pam_tf, pam_tb, pam_train = train_phase("PAM", [fused_encoder_layer], wrappers)
        p12_tf, p12_tb, p12_train = train_phase("P12", [flash_mha_packed], wrappers)
    check_tc("P12 serving and training", p12_launches, p12_tf, p12_tb)
    check_fused_tc("PAM serving and training", pam_launches, pam_tf, pam_tb)
    torch.cuda.empty_cache()

    # sensor_wise_mask on every preset: P19 stays on the dense rung (T=60),
    # P12 and eICU take flash_mha_packed (scalar at hd 360, tensor cores at
    # hd 140), PAM the fused layer at d=340
    sw = {"sensor_wise_mask": True}
    with phase(phase_s, "serve and train, sensor-wise"):
        sw_serve = {
            name: serve_phase(name, fns, wrappers, cfg_overrides=sw,
                              batch_limit=BATCH_LIMIT_SW)
            for name, fns in (("P19", []), ("P12", [flash_mha_packed]),
                              ("eICU", [flash_mha_packed]),
                              ("PAM", [fused_encoder_layer]))}
        if any(sw_serve["P19"][0].values()):
            raise AssertionError(f"P19-sw serving launched a kernel: {sw_serve['P19'][0]}")
        sw_train = {
            name: train_phase(name, [fn], wrappers, cfg_overrides=sw, fit_lr=FIT_LR_SW)
            for name, fn in (("P12", flash_mha_packed), ("eICU", flash_mha_packed),
                             ("PAM", fused_encoder_layer))}
    check_scalar("P12-sw serving and training", sw_serve["P12"][0],
                 *sw_train["P12"][:2])
    check_tc("eICU-sw serving and training", sw_serve["eICU"][0], *sw_train["eICU"][:2])
    check_fused_tc("PAM-sw serving and training", sw_serve["PAM"][0], *sw_train["PAM"][:2])
    torch.cuda.empty_cache()

    # the sparse-graph path: P12 with prop_backend='pallas', held against
    # the plain path with dense attention and dense propagation
    graph = {"prop_backend": "pallas"}
    graph_fns = [flash_mha_packed, spmm_segment_softmax]
    builds = topology.builds
    with phase(phase_s, "graph paths"):
        g12_launches, g12 = serve_phase("P12", graph_fns, wrappers, cfg_overrides=graph,
                                        plain_overrides=PLAIN_ALL)
        check_tc("P12 pallas serving", g12_launches)
        if g12_launches["spmm_segment_softmax"] != g12_launches["flash_mha_packed"]:
            raise AssertionError(f"P12 pallas: two SpMM launches per forward expected, "
                                 f"as many as flash launches: {g12_launches}")
        adj = global_adj_phase(wrappers)
        g12_tf, g12_tb, g12_train = train_phase("P12", graph_fns, wrappers,
                                                cfg_overrides=graph,
                                                plain_overrides=PLAIN_ALL)
        check_tc("P12 pallas training", g12_tf, g12_tb)
        # every server and trainer above shares the model's edge tensors: the
        # graph was sorted for the kernels once, when the first was built
        builds = topology.builds - builds
        print(f"[graph] the model's sensor graph was sorted {builds} time(s) over "
              f"the P12 pallas serving, global_adj and training phases", flush=True)
        if builds != 1:
            raise AssertionError(f"the topology cache missed: {builds} builds")
        sd_f, sd_b, selfatt = selfattention_phase(wrappers)
    torch.cuda.empty_cache()

    # long sequences: the split-head flash_mha at the one-program regime's
    # shape (T=600) and the streaming regime's (T=2048), then the paths
    with phase(phase_s, "flash_mha kernels"):
        mha_runs = [flash_mha_phase(label, 128, 2, T, 42, dt, rate)
                    for label, T in (("PAM-600", 600), ("PAM-2048", 2048))
                    for dt, rate in grid]
        mha_fwd, mha_bwd = ([r[i] for r in mha_runs] for i in (0, 1))
        op_f, op_b, op_checks = flash_mha_op_phase(wrappers)
    torch.cuda.empty_cache()
    with phase(phase_s, "serve PAM-2048"):
        long_launches, long_serve = serve_phase("PAM", [flash_mha], wrappers,
                                                cfg_overrides=LONG)
    check_two_a_forward("PAM-2048", long_launches, long_serve)
    torch.cuda.empty_cache()
    with phase(phase_s, "protocol PAM-2048"):
        # two epochs, the second resumed (three before PAM-sw-2048's run
        # joined the script: the 7 GB checkpoint files take most of it)
        long_tf, long_tb, long_train = protocol_phase(wrappers, epochs=2)
    torch.cuda.empty_cache()
    with phase(phase_s, "run_splits PAM-2048"):
        splits = run_splits_phase()
    torch.cuda.empty_cache()

    # flash_mha past hd 128: PAM-sw's head (170, the Narrow geometry at 48
    # columns a thread) and 360 (Wide) on a 2048-step window, the edge
    # shapes of both geometries, then PAM-sw at max_len 2048 served,
    # trained and run through train_split
    with phase(phase_s, "flash_mha kernels past hd 128"):
        sw_mha_runs = [flash_mha_phase(label, 128, 2, 2048, D, dt, rate)
                       for label, D in (("PAM-sw-2048", 170), ("hd360-2048", 360))
                       for dt, rate in grid]
        sw_mha_fwd, sw_mha_bwd = ([r[i] for r in sw_mha_runs] for i in (0, 1))
        mha_edges = [flash_mha_edge_phase(hd, T, rate)
                     for hd in (129, 170, 192, 193, 200, 360, 368)
                     for T in (65, 1025, 2048) for rate in (0.0, 0.2)]
    torch.cuda.empty_cache()
    sw_long = {**sw, **LONG}
    with phase(phase_s, "serve PAM-sw-2048"):
        sw_long_launches, sw_long_serve = serve_phase(
            "PAM", [flash_mha], wrappers, cfg_overrides=sw_long)
    check_two_a_forward("PAM-sw-2048", sw_long_launches, sw_long_serve)
    torch.cuda.empty_cache()
    with phase(phase_s, "train PAM-sw-2048"):
        sw_long_tf, sw_long_tb, sw_long_train = train_phase(
            "PAM", [flash_mha], wrappers, cfg_overrides=sw_long, fit_lr=FIT_LR_SW)
    torch.cuda.empty_cache()
    with phase(phase_s, "protocol PAM-sw-2048"):
        sw_long_pf, sw_long_pb, sw_long_protocol = protocol_phase(
            wrappers, overrides=sw_long, label="PAM-sw-2048")
    torch.cuda.empty_cache()

    # the kernels' record at the main paths' shapes and operand dtype
    # (attention_score_dtype defaults to bfloat16; training runs the shipped
    # dropout 0.2, serving none); flash_mha_packed's also carry prev_ms, the
    # previous design (scalar kernels) timed in turns with it, and the
    # profiler's device times of the kernel, the previous design and the
    # library call (CUDA events around a short call time the host too)
    def record(name, source, replaces, launches, runs, label, rate=None):
        main_run = next(r for r in runs if r["label"] == label
                        and r["dtype"] == "bfloat16" and r.get("rate") == rate)
        extra = {k: main_run[k] for k in ("prev_ms", "device_ms", "prev_device_ms",
                                          "library_device_ms", "attn_route")
                 if k in main_run}
        if "route" in main_run:     # the launch plan's; "route" below is the language's
            extra["plan_route"] = main_run["route"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in runs),
                "ms": main_run["ms"], **extra, "plain_ms": main_run["plain_ms"],
                "bound_ms": main_run["bound_ms"],
                "bound_by": main_run["bound_by"],
                "library_ms": main_run["library_ms"]}

    kernels = [
        record("flash_mha_packed_fwd", "raindrop_tpu_torch/csrc/flash_packed.cu",
               "raindrop_tpu/ops/flash_attention.py:566",
               p12_launches["flash_mha_packed"], flash, "P12"),
        record("flash_mha_packed_bwd", "raindrop_tpu_torch/csrc/flash_packed.cu",
               "raindrop_tpu/ops/flash_attention.py:610",
               p12_tb["flash_mha_packed"], flash_bwd, "P12", 0.2),
        {**record("fused_encoder_layer_fwd", "raindrop_tpu_torch/csrc/fused_encoder.cu",
                  "raindrop_tpu/ops/fused_encoder.py:131",
                  pam_launches["fused_encoder_layer.tc"], fused, "PAM"),
         **FUSED_FWD_KERNELS},
        {**record("fused_encoder_layer_bwd",
                  "raindrop_tpu_torch/csrc/fused_encoder_bwd.cu",
                  "raindrop_tpu/ops/fused_encoder.py:183",
                  pam_tb["fused_encoder_layer.tc"], fused_bwd, "PAM", 0.2),
         **FUSED_BWD_KERNELS},
    ]

    split_src = "raindrop_tpu_torch/csrc/flash_split.cu"
    jax_flash = "raindrop_tpu/ops/flash_attention.py"
    # the served 2048 path runs no dropout, the trained one the shipped 0.2;
    # the public op at T=600 ran 0.2 both ways
    kernels += [
        record("flash_mha_fwd", split_src, f"{jax_flash}:191",
               long_launches["flash_mha"], mha_fwd, "PAM-2048", 0.0),
        {**record("flash_mha_bwd", split_src, f"{jax_flash}:237", long_tb, mha_bwd,
                  "PAM-2048", 0.2), "replaces_also": [f"{jax_flash}:275"]},
        record("flash_mha_fused_regime_fwd", split_src, f"{jax_flash}:121", op_f,
               mha_fwd, "PAM-600", 0.2),
        record("flash_mha_fused_regime_bwd", split_src, f"{jax_flash}:146", op_b,
               mha_bwd, "PAM-600", 0.2),
    ]

    def graph_record(name, line, launches, runs, ms_key="ms", bound_key="bound"):
        """The run at the main path's shape: the first of `runs`."""
        r = runs[0]
        return {"name": name, "route": "cuda",
                "source": "raindrop_tpu_torch/csrc/sparse_graph.cu",
                "replaces": f"raindrop_tpu/ops/sparse_pallas.py:{line}",
                "launches": launches,
                "max_abs_err": max(x["max_abs_err"] for x in runs),
                "ms": r[ms_key], "plain_ms": r["plain_ms"],
                "bound_ms": r[f"{bound_key}_ms"], "bound_by": r[f"{bound_key}_by"],
                "library_ms": r["library_ms"]}

    # SpMM at the P12 model shape with the target's features gathered; its
    # backward as the model runs it (constant edge weights: dx alone), the
    # plain and library times beside it being those of the full backward
    kernels += [
        graph_record("spmm_segment_softmax_fwd", 64,
                     g12_launches["spmm_segment_softmax"], spmm_fwd),
        graph_record("spmm_segment_softmax_bwd", 110,
                     g12_tb["spmm_segment_softmax"], spmm_bwd, "dx_only_ms",
                     "dx_only_bound"),
        graph_record("sddmm_fwd", 195, sd_f, sddmm_fwd),
        graph_record("sddmm_bwd", 230, sd_b, sddmm_bwd),
    ]
    # the same kernels at the sensor-wise widths, launch counts from those
    # serving (forward) and training (backward) runs
    sw_src = "raindrop_tpu_torch/csrc/flash_packed.cu"
    kernels += [
        record("flash_mha_packed_fwd_P12_sw", sw_src,
               "raindrop_tpu/ops/flash_attention.py:566",
               sw_serve["P12"][0]["flash_mha_packed"], sw_flash, "P12-sw"),
        record("flash_mha_packed_bwd_P12_sw", sw_src,
               "raindrop_tpu/ops/flash_attention.py:610",
               sw_train["P12"][1]["flash_mha_packed"], sw_flash_bwd, "P12-sw", 0.2),
        record("flash_mha_packed_fwd_eICU_sw", sw_src,
               "raindrop_tpu/ops/flash_attention.py:566",
               sw_serve["eICU"][0]["flash_mha_packed"], sw_flash, "eICU-sw"),
        record("flash_mha_packed_bwd_eICU_sw", sw_src,
               "raindrop_tpu/ops/flash_attention.py:610",
               sw_train["eICU"][1]["flash_mha_packed"], sw_flash_bwd, "eICU-sw", 0.2),
        {**record("fused_encoder_layer_fwd_PAM_sw",
                  "raindrop_tpu_torch/csrc/fused_encoder.cu",
                  "raindrop_tpu/ops/fused_encoder.py:131",
                  sw_serve["PAM"][0]["fused_encoder_layer.tc"], sw_fused, "PAM-sw"),
         **FUSED_FWD_KERNELS},
        {**record("fused_encoder_layer_bwd_PAM_sw",
                  "raindrop_tpu_torch/csrc/fused_encoder_bwd.cu",
                  "raindrop_tpu/ops/fused_encoder.py:183",
                  sw_train["PAM"][1]["fused_encoder_layer.tc"], sw_fused_bwd, "PAM-sw", 0.2),
         **FUSED_BWD_KERNELS},
    ]
    # flash_mha past hd 128 at PAM-sw's head dim (170) on its 2048-step
    # window: launches from that configuration's server (forward) and its
    # train_split run (backward); max_abs_err over hd 170 and 360
    kernels += [
        record("flash_mha_fwd_PAM_sw", split_src, f"{jax_flash}:191",
               sw_long_launches["flash_mha"], sw_mha_fwd, "PAM-sw-2048", 0.0),
        {**record("flash_mha_bwd_PAM_sw", split_src, f"{jax_flash}:237", sw_long_pb,
                  sw_mha_bwd, "PAM-sw-2048", 0.2), "replaces_also": [f"{jax_flash}:275"]},
    ]
    for rec in kernels:
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} was never launched on its path")
    detail = {"card": card, "build_s": build_s, "sass": sass, "flash": flash,
              "fused": fused, "flash_bwd": flash_bwd, "flash_edge": edges,
              "fused_bwd": fused_bwd, "fused_edge": fused_edges,
              "sensor_wise": {
                  "flash": sw_flash, "flash_bwd": sw_flash_bwd, "fused": sw_fused,
                  "fused_bwd": sw_fused_bwd,
                  "serve": {k: {"launches": v[0], **v[1]} for k, v in sw_serve.items()},
                  "train": {k: {"launches": v[0], "bwd_launches": v[1], **v[2]}
                            for k, v in sw_train.items()}},
              "spmm_fwd": spmm_fwd, "spmm_bwd": spmm_bwd,
              "sddmm_fwd": sddmm_fwd, "sddmm_bwd": sddmm_bwd,
              "serve": {"PAM": {"launches": pam_launches, **pam},
                        "P12": {"launches": p12_launches, **p12},
                        "P12_pallas": {"launches": g12_launches, **g12}},
              "train": {"PAM": {"launches": pam_tf, "bwd_launches": pam_tb,
                                **pam_train},
                        "P12": {"launches": p12_tf, "bwd_launches": p12_tb,
                                **p12_train},
                        "P12_pallas": {"launches": g12_tf, "bwd_launches": g12_tb,
                                       **g12_train}},
              "global_adj": adj,
              "selfattention": {"launches": sd_f, "bwd_launches": sd_b,
                                "checks": selfatt},
              "flash_mha_fwd": mha_fwd, "flash_mha_bwd": mha_bwd,
              "flash_mha_op": {"launches": op_f, "bwd_launches": op_b,
                               "checks": op_checks},
              "long": {"serve": {"launches": long_launches, **long_serve},
                       "train": {"launches": long_tf, "bwd_launches": long_tb,
                                 **long_train},
                       "run_splits": splits},
              "long_sensor_wise": {
                  "flash_mha_fwd": sw_mha_fwd, "flash_mha_bwd": sw_mha_bwd,
                  "flash_mha_edge": mha_edges,
                  "serve": {"launches": sw_long_launches, **sw_long_serve},
                  "train": {"launches": sw_long_tf, "bwd_launches": sw_long_tb,
                            **sw_long_train},
                  "protocol": {"launches": sw_long_pf, "bwd_launches": sw_long_pb,
                               **sw_long_protocol}},
              "phase_s": phase_s, "total_s": time.perf_counter() - t_start,
              "kernels": kernels}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)

    name = torch.cuda.get_device_name(0)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build "
          f"{build_s:.1f} s of it", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
