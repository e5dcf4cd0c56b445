"""Fused post-LN encoder layer forward (port of the `fused_encoder_layer`
forward in raindrop_tpu/ops/fused_encoder.py).

    attn = MHA(x)                     (packed heads, base-2 softmax)
    x1   = LN1(x + attn Wo^T + bo)
    out  = LN2(x1 + W2 relu(W1 x1 + b1) + b2)

`p` is the nn/transformer layer dict. On a CUDA tensor `_fused_fwd`
launches the hand-written kernels in `csrc/fused_encoder.cu` (two launches:
the qkv projection, then attention and the row-local rest of the layer per
64-row block) or raises; on a CPU tensor it runs `_fused_fwd_plain`, the
same function in plain PyTorch. Dropout and the backward come with the
training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.ops.flash_attention import (
    LOG2E, MAX_FUSED_T, _packed_fwd_plain, operand_dtype, refuse_dropout)

_EPS = 1e-5


def fused_encoder_layer(p, x, lengths, seed=None, dropout_rate=0.0,
                        compute_dtype=None, nhead=1) -> torch.Tensor:
    """One post-LN encoder layer. x [B, T, d]; lengths [B]. Returns out
    [B, T, d] in x's dtype."""
    out, _, _ = _fused_fwd(p, x, lengths, seed, dropout_rate, compute_dtype,
                           nhead)
    return out.to(x.dtype)


fused_encoder_layer.launches = 0


def _fused_fwd(p, x, lengths, seed, dropout_rate, compute_dtype, nhead):
    """Returns (out, attn [B, T, d] f32, lse [B, nhead, T] f32, base 2);
    attn and lse are what the backward of the training slice reads."""
    refuse_dropout(dropout_rate, "fused_encoder_layer")
    B, T, d = x.shape
    if d % nhead:
        raise ValueError(f"d={d} not divisible by nhead={nhead}")
    if -(-T // 8) * 8 > MAX_FUSED_T:
        raise ValueError(f"fused encoder layer requires T <= {MAX_FUSED_T}")
    if lengths.shape != (B,):
        raise ValueError("lengths must be [B]")
    od = operand_dtype(compute_dtype)
    if x.is_cuda:
        return _fused_fwd_cuda(p, x, lengths, nhead, od)
    return _fused_fwd_plain(p, x, lengths, nhead, od)


def _ln(h, p):
    mu = h.mean(dim=-1, keepdim=True)
    var = (h - mu).square().mean(dim=-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + _EPS) * p["scale"] + p["bias"]


def _fused_fwd_plain(p, x, lengths, nhead, od):
    """The kernels' function in plain PyTorch, with the TPU kernel's
    rounding: every product operand in `od`, q/k/v rounded after their
    bias, f32 accumulation, attention normalising the PV output."""
    d = x.shape[-1]
    x = x.to(torch.float32)

    def r(t):
        return t.to(od).to(torch.float32)

    qkv = r(x) @ r(p["in_proj_w"]).T + p["in_proj_b"]
    q, k, v = r(qkv).split(d, dim=-1)
    attn, lse = _packed_fwd_plain(q, k, v, lengths, nhead, od)
    x1 = _ln(x + (r(attn) @ r(p["out_proj"]["w"]).T + p["out_proj"]["b"]),
             p["ln1"])
    f = torch.relu(r(x1) @ r(p["lin1"]["w"]).T + p["lin1"]["b"])
    f2 = r(f) @ r(p["lin2"]["w"]).T + p["lin2"]["b"]
    return _ln(x1 + f2, p["ln2"]), attn, lse


_WEIGHTS = (("in_proj_w",), ("in_proj_b",), ("out_proj", "w"),
            ("out_proj", "b"), ("ln1", "scale"), ("ln1", "bias"),
            ("lin1", "w"), ("lin1", "b"), ("lin2", "w"), ("lin2", "b"),
            ("ln2", "scale"), ("ln2", "bias"))


def _fused_fwd_cuda(p, x, lengths, nhead, od):
    B, T, d = x.shape
    dev = x.device
    ffn = p["lin1"]["w"].shape[0]
    ws = []
    for path in _WEIGHTS:
        w = p
        for key in path:
            w = w[key]
        if w.device != dev:
            raise ValueError(f"weight {'/'.join(path)} is on {w.device}, x on {dev}")
        ws.append(w.to(torch.float32).contiguous())
    want = [(3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (ffn, d), (ffn,),
            (d, ffn), (d,), (d,), (d,)]
    for path, w, shape in zip(_WEIGHTS, ws, want):
        if tuple(w.shape) != shape:
            raise ValueError(f"weight {'/'.join(path)} is {tuple(w.shape)}, "
                             f"expected {shape}")
    if lengths.device != dev:
        raise ValueError(f"lengths is on {lengths.device}, x on {dev}")
    xf = x.to(torch.float32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    qkv = torch.empty((B, T, 3 * d), dtype=torch.float32, device=dev)
    out = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    attn = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    lse = torch.empty((B, nhead, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().rd_fused_layer_fwd(
        xf.data_ptr(), *(w.data_ptr() for w in ws), lens.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), attn.data_ptr(), lse.data_ptr(),
        B, T, d, ffn, nhead, (1.0 / math.sqrt(d // nhead)) * LOG2E,
        int(od == torch.bfloat16), stream)
    build.check(err, "fused_encoder_layer forward")
    build.count_launch(fused_encoder_layer)
    return out, attn, lse


def _lib():
    lib = build.load("fused_encoder")
    fn = lib.rd_fused_layer_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
