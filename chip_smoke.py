#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

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
  4. flash_mha_packed backward at the same shapes, dropout 0 and 0.2: the
     forward with dropout, then dq, dk, dv of the two backward kernels
     against the plain backward, finite, zero on the length-0 sample, and
     bit-equal on a repeat;
  5. fused_encoder_layer backward at the PAM shape, the same grid: dx and
     the 12 weight gradients against the plain backward, bit-equal on a
     repeat;
  6. an InferenceServer for PAM at full width (random weights from a seed)
     answering predict on 1, 5, 128 and 200 rows, submit from 4 threads,
     predict_stream and the bf16 wire format, held against the same server
     on the dense plain path; it must have gone through the fused-layer
     kernel;
  7. the same for P12, which must have gone through flash_mha_packed;
  8. a Trainer for PAM at full width and depth (B=128, lr 1e-4, shipped
     dropout 0.2) on a synthetic split resident on the card: one epoch and
     a padded predict; finite losses, backward launches of the preset's
     kernel, dead parameters bit-identical and live ones changed, the same
     epoch twice bit-equal, the first step's loss and gradient norm against
     the dense path at dropout 0, and a falling loss on a fixed batch;
  9. the same for P12;
 10. spmm_segment_softmax, kernels against their plain PyTorch versions,
     forward (out, w) and backward (dx, dgamma, cotangents on both
     outputs): the complete sensor graphs of P12 (B=128, N=36, E=1296,
     D=860) and PAM (N=17, E=289, D=2400) with the messages gathered at
     the target and at the source, and a kNN graph (N=128, k=6, E=768,
     D=240, edges shuffled, one node without an incoming edge); zero rows
     exact, bit-equal on a repeat;
 11. sddmm forward and backward on the same graphs at D=860 and D=120, and
     at the shape the self-attention phase gives it;
 12. an InferenceServer for P12 with prop_backend='pallas' (every check of
     phase 7, held against the dense plain path: dense attention and dense
     propagation), which must launch the SpMM kernel twice per forward;
     and one raindrop_apply with a random global_adj in [0.5, 2],
     'pallas' against 'coo';
 13. a Trainer for P12 with prop_backend='pallas' (every check of phase 9;
     the SpMM backward must have been launched);
 14. ob_propagate_selfattention (N=36, D=860, 2 heads) on a kNN and on the
     complete graph, score_backend 'sddmm' against 'gather', value and
     gradient w.r.t. x;
 15. flash_mha (split heads, any T) forward and backward, kernels against
     their plain PyTorch versions, f32 and bf16 operands, dropout 0 and
     0.2, ragged lengths including 0, at B=128, H=2, D=42 and T=600 (the
     JAX package's one-program regime) and T=2048 (its streaming regime),
     on the strided head views the model hands it; finite, zero on the
     length-0 sample, bit-equal on a repeat. At T=2048 the plain version
     runs on 8 samples at a time (its [B, H, T, T] int64 mask would take
     8.6 GB at B=128);
 16. the public op at T=600 with dropout 0.2 through autograd, held against
     flash_mha_packed on the same [B, T, d] tensors and seed (both hash
     b * H + h, the global row and column): output and gradients;
 17. an InferenceServer for PAM's width on a 2048-step window
     (dataset_config("PAM", max_len=2048), full width and depth; every
     check of phase 6, held against the dense plain path), which must
     launch flash_mha twice per forward;
 18. the trainer protocol on that configuration: train_split on
     synthetic_split("PAM", T=2048) (B=128, sampler strategy 3, dropout
     0.2) for 2 epochs with checkpoints, resumed from the `_last` file for
     a third, and the uninterrupted 3-epoch run, whose history the resumed
     one must equal bit for bit; finite records, metrics in [0, 1], the
     best file reloads, forward launches = 2 x (steps + predict chunks),
     backward launches = 2 x steps; the first step's loss and gradient norm
     against the dense path at dropout 0 on 16 samples; step ms, samples/s
     and the idle share;
 19. run_splits, 2 splits of 1 epoch, for the summary's shape.

Times are CUDA-event means over repeated launches after a warm-up. Bounds
use the H100 SXM data-sheet peaks (3.35 TB/s; 67 TFLOP/s f32 outside the
tensor cores, 989 TFLOP/s dense bf16); the card's power limit is printed
beside them. Gradients are compared relative to max(1, the plain
gradient's largest value): 1e-4 with f32 operands (another summation
order), 2e-2 with bf16 operands; the fused layer's plain backward takes
the kernel's relu branches (fused_bwd_phase says why). The sparse-graph
kernels are f32 throughout and are held to 1e-5 relative to max(1, |plain|).
The line before the last is the kernels' JSON record (twelve records), the
last line the result. `--out PATH` also writes every
number to PATH as JSON.
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


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1.0))


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
    errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    err = max(errs.values())
    print(f"[flash_bwd] {label} {dtype} dropout {rate}: forward max_abs_err "
          f"{fwd_err:.3e}, gradients rel err {errs} (tol {TOL[dtype]:g})", flush=True)
    if fwd_err > TOL[dtype] or err > TOL[dtype]:
        raise AssertionError(f"flash_mha_packed backward disagrees at {label} {dtype}")
    for a, a2 in zip(got, again):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"flash backward not finite or not bit-equal "
                                 f"on a repeat at {label} {dtype}")
        if not bool((a[0] == 0).all()):
            raise AssertionError("flash backward: the length-0 sample is not zero")

    qo, ko, vo = (x.to(od) for x in (q, k, v))
    targs = (qo, ko, vo, lengths, SEED, rate, H, od, o_k, lse_k, g)
    ms = time_ms(lambda: fa._packed_bwd_cuda(*targs))
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
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = (4 * B * T * d * esize + 3 * B * T * d * 4 + 2 * B * H * T * 4 + B * 4)
    flops = 10.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    print(f"[flash_bwd] {label} {dtype} dropout {rate}: kernels {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(label=label, dtype=dtype, rate=rate, max_abs_err=err,
                fwd_max_abs_err=fwd_err, errs=errs, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)


def fused_bwd_phase(label, B, T, d, ffn, H, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for fused_encoder_layer's forward with dropout and
    its backward (dx and the 12 weight gradients) at one shape."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    x, g = (torch.randn((B, T, d), generator=gen, device=device) for _ in range(2))
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    fwd_k = fe._fused_fwd(p, x, lengths, SEED, rate, cd, H)
    fwd_p = fe._fused_fwd_plain(p, x, lengths, H, od, SEED, rate)
    fwd_err = max(max_err(a, b) for a, b in zip(fwd_k, fwd_p))
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
    names = ["dx"] + ["/".join(path) for path in fe._WEIGHTS]
    errs = {n: rel_err(a, b) for n, a, b in zip(names, [dx, *dws], [pdx, *pdws])}
    err = max(errs.values())
    print(f"[fused_bwd] {label} {dtype} dropout {rate}: forward max_abs_err "
          f"{fwd_err:.3e}, gradients rel err {errs} (tol {TOL[dtype]:g}); relu "
          f"branches that differ from the plain version's: {n_flips} of "
          f"{flips.numel()}, largest |pre-activation| among them {flip_pre:.3e}",
          flush=True)
    if (fwd_err > TOL[dtype] or err > TOL[dtype] or flip_pre > TOL[dtype]
            or n_flips > TOL[dtype] * flips.numel()):
        raise AssertionError(f"fused_encoder_layer backward disagrees at {label} {dtype}")
    for name, a, a2 in zip(names, [dx, *dws], [dx2, *dws2]):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"fused backward {name} not finite or not "
                                 f"bit-equal on a repeat at {label} {dtype}")
    del pdx, pdws, fwd_p

    ms = time_ms(lambda: fe._fused_bwd_cuda(ws, *args), reps=10, warmup=2)
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
    scratch = fe.bwd_scratch_floats(B, T, d, ffn, H)
    scratch_mb = {k: 4 * n / 1e6 for k, n in scratch.items()}
    print(f"[fused_bwd] {label} {dtype} dropout {rate}: kernels {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, TransformerEncoderLayer backward {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}); intermediates in device "
          f"memory {sum(scratch_mb.values()):.1f} MB", flush=True)
    return dict(label=label, dtype=dtype, rate=rate, max_abs_err=err,
                fwd_max_abs_err=fwd_err, errs=errs, relu_flips=n_flips,
                ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, scratch_mb=scratch_mb)


def _head_views(gen, B, H, T, D, n, device):
    """n [B, H, T, D] views of one [B, T, n*H*D] projection: the strides
    nn/transformer.py hands flash_mha."""
    import torch

    proj = torch.randn((B, T, n * H * D), generator=gen, device=device)
    return [t.reshape(B, T, H, D).transpose(1, 2) for t in proj.split(H * D, dim=-1)]


def _in_chunks(fn, B, step):
    """fn(slice) over the batch in chunks of `step` samples."""
    return [fn(slice(b0, min(b0 + step, B))) for b0 in range(0, B, step)]


def flash_mha_phase(label, B, H, T, D, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for flash_mha, forward (with dropout when rate > 0)
    and backward, at one shape. The plain version runs on `chunk` samples
    at a time; b * H + h keys the dropout mask, so a chunk's plain masks
    are the kernel's only for the first chunk, which is the one compared
    (it holds the samples of length 0, 1 and T). Returns (forward run,
    backward run)."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = _head_views(gen, B, H, T, D, 4, device)
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    chunk = B if T <= 1024 else 8
    c0 = slice(0, chunk)
    o, lse = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    o2, lse2 = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    args = (q, k, v, lengths, SEED, rate, od, o, lse, g)
    got = fa._flash_bwd_cuda(*args)
    again = fa._flash_bwd_cuda(*args)
    o_p, lse_p = fa._flash_fwd_plain(q[c0], k[c0], v[c0], lengths[c0], od, SEED, rate)
    want = fa._flash_bwd_plain(q[c0], k[c0], v[c0], lengths[c0], SEED, rate, od,
                               o[c0], lse[c0], g[c0])
    torch.cuda.synchronize()
    fwd_err = max(max_err(o[c0], o_p), max_err(lse[c0], lse_p))
    errs = {n: rel_err(a[c0], b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    err = max(errs.values())
    print(f"[flash_mha] {label} {dtype} B={B} H={H} T={T} D={D} dropout {rate}: "
          f"forward max_abs_err {fwd_err:.3e}, gradients rel err {errs} (tol "
          f"{TOL[dtype]:g}; plain version on the first {chunk} samples)", flush=True)
    if fwd_err > TOL[dtype] or err > TOL[dtype]:
        raise AssertionError(f"flash_mha kernels disagree at {label} {dtype}")
    _equal_and_finite([("o", o, o2), ("lse", lse, lse2)]
                      + [(n, a, a2) for n, a, a2 in zip(("dq", "dk", "dv"), got, again)],
                      f"flash_mha {label} {dtype}")
    for a in (o, *got):
        if not bool((a[0] == 0).all()):
            raise AssertionError("flash_mha: the length-0 sample is not zero")
    del o_p, lse_p, want, again, o2, lse2

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
    n_el = B * H * T * D
    total = float(lengths.sum())
    fwd_bytes = 3 * n_el * esize + n_el * 4 + B * H * T * 4 + B * 4
    fwd_flops = 4.0 * T * D * H * total
    bwd_bytes = 4 * n_el * esize + 3 * n_el * 4 + 2 * B * H * T * 4 + B * 4
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
PLAIN_ALL = {"attention_backend": "dense", "prop_backend": "auto"}


def serve_phase(dataset, kernel_fns, wrappers, device="cuda", seed=0,
                cfg_overrides=None, plain_overrides=PLAIN_ATTENTION,
                buckets=(1, 8, 32, 128)):
    """Serve one preset at full width and check it. Every wrapper's launch
    count is set to 0 just before the served requests and read just after;
    returns those counts by wrapper name. `kernel_fns` are the wrappers
    this path must go through; `plain_overrides` turn its config into the
    plain path it is held against."""
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
    limits = {"alone_vs_full_bucket": 1e-5, "predict_vs_chunked": 1e-5,
              "submit_vs_predict": 1e-5, "stream_vs_predict": 1e-5,
              "bf16_wire_vs_f32": 5e-2}

    # the same params on the dense plain path, and the kernel path with
    # f32 attention operands
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
    print(f"[serve] {dataset}: checks {checks}", flush=True)
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
                          limits=limits, **timing)


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
                cfg_overrides=None, plain_overrides=PLAIN_ATTENTION):
    """Train one preset at full width and depth and check it. Every
    wrapper's counts are set to 0 just before the epoch and the predict and
    read just after; returns the forward and backward counts by wrapper
    name. `kernel_fns` are the wrappers this training must go through,
    forward and backward; `plain_overrides` turn its config into the plain
    path its first step is held against."""
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.nn.transformer import encoder_rung
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
    for fn in wrappers:
        fn.launches = fn.bwd_launches = 0
    losses, _ = trainer.train_epoch(data, idx)
    n_pred = min(200, n)    # two chunks of 100: the second is a padded tail
    P_host, time_host = (data[k][:n_pred].cpu().numpy() for k in ("P", "time"))
    static_host = data["static"][:n_pred].cpu().numpy() if "static" in data else None
    logits = trainer.predict(None, P_host, time_host, static_host)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    bwd_launches = {fn.__name__: fn.bwd_launches for fn in wrappers}
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
    first = {k: v[idx[0]] for k, v in data.items()}
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

    # lr 1e-3 on one fixed batch: the loss falls over 10 steps (measured
    # before and after under one fixed set of masks)
    fit = Trainer(cfg, tcfg, device=device, params=trainer.params)
    fit.learning_rate = 1e-3
    fixed = DropoutSeeds.draw(torch.Generator().manual_seed(seed), cfg.nlayers)
    with torch.no_grad():
        loss0 = float(fit.loss_fn(first, fixed)[0])
    fit_losses = [float(fit.train_step(first)[0]) for _ in range(10)]
    with torch.no_grad():
        loss1 = float(fit.loss_fn(first, fixed)[0])
    print(f"[train] {dataset}: fixed batch at lr 1e-3: loss {loss0:.6f} -> "
          f"{loss1:.6f} after 10 steps; step losses "
          f"{[round(x, 5) for x in fit_losses]}", flush=True)
    if not loss1 < loss0:
        raise AssertionError(f"{dataset}: the loss did not fall: {loss0} -> {loss1}")
    del fit

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
        fixed_batch_losses=fit_losses, step_ms=step_ms, step_ms_median=step_med,
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


def protocol_phase(wrappers, device="cuda", seed=0, batch=128, n=320, n_batches=3):
    """train_split with checkpoints, resume and the uninterrupted run on
    PAM's width at max_len 2048; the first step against the dense path; the
    step's time. Returns flash_mha's forward and backward launch counts
    over the checkpointed 2-epoch run, and the details."""
    import dataclasses
    import tempfile

    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.nn.transformer import encoder_rung
    from raindrop_tpu_torch.ops.flash_attention import flash_mha
    from raindrop_tpu_torch.train.checkpoint import load_checkpoint
    from raindrop_tpu_torch.train.trainer import Trainer, flatten_params

    cfg = dataset_config("PAM", **LONG)
    tcfg = TrainConfig(dataset="PAM", num_epochs=3, learning_rate=1e-4,
                       batch_size=batch, batching_strategy=3,
                       n_batches_strategy3=n_batches, seed=seed + 1)
    T, d, H = cfg.max_len, cfg.d_transformer, cfg.nhead
    rung = encoder_rung(cfg.attention_backend, T, d, H, True)
    trainer = Trainer(cfg, tcfg, device=device)
    n_all = sum(t.numel() for _, t in flatten_params(trainer.params))
    n_live = sum(t.numel() for _, t in trainer.live)
    side = T * cfg.d_ob
    print(f"[protocol] PAM at max_len {T}: d={d}, ffn={cfg.ffn_dim}, {H} heads of "
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
    print(f"[protocol] synthetic_split: {n_train} train, {n_val} val, {n_test} test, "
          f"made in {time.perf_counter() - t0:.1f} s; {n_batches} batches of {batch} "
          f"an epoch (sampler strategy 3), dropout {cfg.dropout}, operands "
          f"{cfg.attention_score_dtype}", flush=True)

    def chunks(m):          # predict's chunks of 100 rows
        return -(-m // 100)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pam2048")
        # 2 epochs with checkpoints: the run that gets interrupted
        trainer.tcfg = dataclasses.replace(tcfg, num_epochs=2)
        for fn in wrappers:
            fn.launches = fn.bwd_launches = 0
        t0 = time.perf_counter()
        cut = trainer.train_split(split, checkpoint_path=path, verbose=False)
        cut_s = time.perf_counter() - t0
        fwd, bwd = flash_mha.launches, flash_mha.bwd_launches
        _check_result("train_split, 2 epochs", cut, cfg, 2)
        steps = 2 * n_batches
        want_fwd = cfg.nlayers * (steps + 2 * chunks(n_val) + chunks(n_test))
        sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        print(f"[protocol] 2 epochs + test in {cut_s:.1f} s: history {_history(cut)}; "
              f"test {cut.test_metrics}; flash_mha launches {fwd} forward (expected "
              f"{want_fwd}), {bwd} backward (expected {cfg.nlayers * steps}); "
              f"files {sizes}", flush=True)
        if fwd != want_fwd or bwd != cfg.nlayers * steps:
            raise AssertionError("train_split: flash_mha launch counts are off")
        best, _, meta = load_checkpoint(path, trainer.params)
        for (name, a), (_, b) in zip(flatten_params(best), flatten_params(cut.params)):
            if not torch.equal(a, b.detach()):
                raise AssertionError(f"the best file does not reload: {name}")
        if meta["config"]["max_len"] != T:
            raise AssertionError("the best file's sidecar lost its config")
        del best, cut
        # a fresh trainer picks the run up for its third epoch
        del trainer
        torch.cuda.empty_cache()
        trainer = Trainer(cfg, tcfg, device=device)
        t0 = time.perf_counter()
        resumed = trainer.train_split(split, checkpoint_path=path,
                                      resume_from=path + "_last", verbose=False)
        resume_s = time.perf_counter() - t0
    _check_result("train_split, resumed", resumed, cfg, 3)
    # the same trainer, from scratch again, uninterrupted and without files
    t0 = time.perf_counter()
    full = trainer.train_split(split, verbose=False)
    full_s = time.perf_counter() - t0
    _check_result("train_split, 3 epochs", full, cfg, 3)
    print(f"[protocol] resumed third epoch in {resume_s:.1f} s, uninterrupted 3 "
          f"epochs in {full_s:.1f} s ({full.samples_per_sec:.1f} samples/s with "
          f"validation): history {_history(full)}; test {full.test_metrics}", flush=True)
    if _history(resumed) != _history(full) or resumed.test_metrics != full.test_metrics:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: "
                             f"{_history(resumed)} vs {_history(full)}")
    del resumed

    # first step's loss and gradient norm against the dense path, dropout 0,
    # on 16 samples (dense attention keeps [B, H, T, T] scores for its backward)
    data = {"P": torch.from_numpy(split.Ptrain[:16]).to(device),
            "time": torch.from_numpy(split.Ptrain_time[:16]).to(device),
            "y": torch.from_numpy(split.ytrain[:16]).to(device).long()}
    checks, limits = {}, {}
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        pair = []
        for plain in ({}, PLAIN_ATTENTION):
            c = dataset_config("PAM", **{**LONG, "dropout": 0.0, **plain,
                                        "attention_score_dtype": score})
            tr_ = Trainer(c, tcfg, device=device, params=trainer.params)
            loss, _ = tr_._backward(data, None)
            pair.append((float(loss), grad_norm(tr_)))
            del tr_
        (lk, gk), (ld, gd) = pair
        checks[f"loss_vs_dense_{score}"] = abs(lk - ld) / abs(ld)
        checks[f"grad_norm_vs_dense_{score}"] = abs(gk - gd) / gd
        limits[f"loss_vs_dense_{score}"] = limits[f"grad_norm_vs_dense_{score}"] = tol
        print(f"[protocol] first step on 16 samples, {score} operands, dropout 0: loss "
              f"{lk:.7f} (dense {ld:.7f}), gradient norm {gk:.7f} (dense {gd:.7f})",
              flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"PAM-2048 against the dense path: {bad} (limits {limits})")
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
    print(f"[protocol] PAM-2048: step {step_med:.3f} ms (median of {n_batches}, CUDA "
          f"events; all {[round(x, 3) for x in step_ms]}); epoch of {n_batches} steps "
          f"{epoch_ms:.3f} ms by the host clock = {sps:.1f} samples/s; profiled: wall "
          f"{wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, idle share {idle}",
          flush=True)
    for name, ms in top_k.items():
        print(f"[protocol] PAM-2048:   {ms:8.4f} ms/step  {name[:100]}", flush=True)
    return fwd, bwd, dict(
        rung=rung, params=n_all, live_params=n_live, split=(n_train, n_val, n_test),
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

    flash = [flash_phase("P12", 128, 215, 160, 2, dt) for dt in ("float32", "bfloat16")]
    flash += [flash_phase("eICU", 128, 300, 72, 2, dt) for dt in ("float32", "bfloat16")]
    fused = [fused_phase("PAM", 128, 600, 84, 136, 2, dt)
             for dt in ("float32", "bfloat16")]
    grid = [(dt, rate) for dt in ("float32", "bfloat16") for rate in (0.0, 0.2)]
    flash_bwd = [flash_bwd_phase("P12", 128, 215, 160, 2, dt, rate) for dt, rate in grid]
    flash_bwd += [flash_bwd_phase("eICU", 128, 300, 72, 2, dt, rate) for dt, rate in grid]
    fused_bwd = [fused_bwd_phase("PAM", 128, 600, 84, 136, 2, dt, rate)
                 for dt, rate in grid]
    torch.cuda.empty_cache()
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
    pam_launches, pam = serve_phase("PAM", [fused_encoder_layer], wrappers)
    p12_launches, p12 = serve_phase("P12", [flash_mha_packed], wrappers)
    pam_tf, pam_tb, pam_train = train_phase("PAM", [fused_encoder_layer], wrappers)
    p12_tf, p12_tb, p12_train = train_phase("P12", [flash_mha_packed], wrappers)
    torch.cuda.empty_cache()

    # the sparse-graph path: P12 with prop_backend='pallas', held against
    # the plain path with dense attention and dense propagation
    graph = {"prop_backend": "pallas"}
    graph_fns = [flash_mha_packed, spmm_segment_softmax]
    builds = topology.builds
    g12_launches, g12 = serve_phase("P12", graph_fns, wrappers, cfg_overrides=graph,
                                    plain_overrides=PLAIN_ALL)
    if g12_launches["spmm_segment_softmax"] != g12_launches["flash_mha_packed"]:
        raise AssertionError(f"P12 pallas: two SpMM launches per forward expected, "
                             f"as many as flash launches: {g12_launches}")
    adj = global_adj_phase(wrappers)
    g12_tf, g12_tb, g12_train = train_phase("P12", graph_fns, wrappers,
                                            cfg_overrides=graph,
                                            plain_overrides=PLAIN_ALL)
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
    mha_runs = [flash_mha_phase(label, 128, 2, T, 42, dt, rate)
                for label, T in (("PAM-600", 600), ("PAM-2048", 2048))
                for dt, rate in grid]
    mha_fwd, mha_bwd = ([r[i] for r in mha_runs] for i in (0, 1))
    op_f, op_b, op_checks = flash_mha_op_phase(wrappers)
    torch.cuda.empty_cache()
    long_launches, long_serve = serve_phase("PAM", [flash_mha], wrappers,
                                            cfg_overrides=LONG)
    if long_launches["flash_mha"] != 2 * long_serve["forwards"]:
        raise AssertionError(
            f"PAM-2048: two flash_mha launches per forward expected, got "
            f"{long_launches['flash_mha']} for {long_serve['forwards']} forwards")
    torch.cuda.empty_cache()
    long_tf, long_tb, long_train = protocol_phase(wrappers)
    torch.cuda.empty_cache()
    splits = run_splits_phase()

    # the kernels' record at the main paths' shapes and operand dtype
    # (attention_score_dtype defaults to bfloat16; training runs the shipped
    # dropout 0.2, serving none)
    def record(name, source, replaces, launches, runs, label, rate=None):
        main_run = next(r for r in runs if r["label"] == label
                        and r["dtype"] == "bfloat16" and r.get("rate") == rate)
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
               p12_launches["flash_mha_packed"], flash, "P12"),
        record("flash_mha_packed_bwd", "raindrop_tpu_torch/csrc/flash_packed.cu",
               "raindrop_tpu/ops/flash_attention.py:610",
               p12_tb["flash_mha_packed"], flash_bwd, "P12", 0.2),
        record("fused_encoder_layer_fwd", "raindrop_tpu_torch/csrc/fused_encoder.cu",
               "raindrop_tpu/ops/fused_encoder.py:131",
               pam_launches["fused_encoder_layer"], fused, "PAM"),
        record("fused_encoder_layer_bwd",
               "raindrop_tpu_torch/csrc/fused_encoder_bwd.cu",
               "raindrop_tpu/ops/fused_encoder.py:183",
               pam_tb["fused_encoder_layer"], fused_bwd, "PAM", 0.2),
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
    for rec in kernels:
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} was never launched on its path")
    detail = {"card": card, "build_s": build_s, "flash": flash, "fused": fused,
              "flash_bwd": flash_bwd, "fused_bwd": fused_bwd,
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
