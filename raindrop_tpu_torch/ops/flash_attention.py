"""Packed-heads flash attention forward (port of the `flash_mha_packed`
forward in raindrop_tpu/ops/flash_attention.py).

q, k, v [B, T, d] with d = nhead * hd stay in the model's natural layout;
o [B, T, d] f32; lse [B, nhead, T] f32 in base 2 (log2(e) folded into the
score scale, as on the TPU). Keys at t >= lengths[b] are masked; a sample
with length 0 gives o = 0 and lse = NEG_INF.

On a CUDA tensor `_packed_fwd` launches the hand-written kernel in
`csrc/flash_packed.cu` (or raises); on a CPU tensor it runs
`_packed_fwd_plain`, the same function in plain PyTorch, which the CPU
tests hold against the JAX package and `chip_smoke.py` holds the kernel
against on the card. Dropout, the backward and the split-head `flash_mha`
(T > 1024) come with later slices.
"""

from __future__ import annotations

import ctypes
import math
import torch

from raindrop_tpu_torch.kernels import build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# The largest T (padded to 8) the JAX package's packed kernel takes; the
# port's encoder ladder keeps it (nn/transformer.py).
MAX_FUSED_T = 1024


def operand_dtype(compute_dtype) -> torch.dtype:
    """Operand dtype of the attention products: f32 or bf16."""
    if compute_dtype in (None, "float32"):
        return torch.float32
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported flash compute_dtype {compute_dtype}")


def refuse_dropout(dropout_rate: float, what: str) -> None:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            f"{what} with dropout_rate > 0 comes with the training slice")


def flash_mha_packed(q, k, v, lengths, seed=None, dropout_rate=0.0,
                     compute_dtype=None, nhead=1) -> torch.Tensor:
    """Packed-heads attention: q, k, v [B, T, d] -> o [B, T, d] f32."""
    o, _ = _packed_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype,
                       nhead)
    return o


flash_mha_packed.launches = 0


def _packed_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype, nhead):
    """Returns (o [B, T, d] f32, lse [B, nhead, T] f32, base 2)."""
    refuse_dropout(dropout_rate, "flash_mha_packed")
    B, T, d = q.shape
    if d % nhead:
        raise ValueError(f"d={d} not divisible by nhead={nhead}")
    if -(-T // 8) * 8 > MAX_FUSED_T:
        raise NotImplementedError(
            f"flash_mha for T={T} > {MAX_FUSED_T} comes with a later slice")
    if k.shape != q.shape or v.shape != q.shape or lengths.shape != (B,):
        raise ValueError("q, k, v must be [B, T, d] and lengths [B]")
    od = operand_dtype(compute_dtype)
    if q.is_cuda:
        return _packed_fwd_cuda(q, k, v, lengths, nhead, od)
    return _packed_fwd_plain(q, k, v, lengths, nhead, od)


def _packed_fwd_plain(q, k, v, lengths, nhead, od):
    """The kernel's function in plain PyTorch: scores in f32 from operands
    rounded to `od`, probabilities rounded to `od` before the PV product,
    the PV output normalised by the row sum (as the TPU kernel does)."""
    B, T, d = q.shape
    hd = d // nhead
    scale2 = (1.0 / math.sqrt(hd)) * LOG2E

    def heads(x):  # [B, T, d] -> [B, H, T, hd] in f32 from od operands
        return x.to(od).to(torch.float32).reshape(B, T, nhead, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    lengths = lengths.to(torch.int64)
    s = (qh @ kh.transpose(-1, -2)) * scale2
    col = torch.arange(T, device=q.device)
    bias = torch.where(col[None, :] < lengths[:, None], 0.0, NEG_INF)
    s = s + bias[:, None, None, :].to(torch.float32)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(od).to(torch.float32) @ vh) / l
    valid = (lengths > 0)[:, None, None]
    lse = torch.where(valid, mx[..., 0] + torch.log2(l[..., 0]),
                      torch.full_like(l[..., 0], NEG_INF))
    o = o.transpose(1, 2).reshape(B, T, d)
    o = torch.where(valid, o, torch.zeros_like(o))
    return o, lse


def _packed_fwd_cuda(q, k, v, lengths, nhead, od):
    B, T, d = q.shape
    dev = q.device
    for name, x in (("k", k), ("v", v), ("lengths", lengths)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    for x in (q, k, v):
        if not x.is_floating_point():
            raise TypeError(f"q, k, v must be floating point, got {x.dtype}")
    q, k, v = (x.to(od).contiguous() for x in (q, k, v))
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    lse = torch.empty((B, nhead, T), dtype=torch.float32, device=dev)
    fn = _lib().rd_packed_fwd
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
             o.data_ptr(), lse.data_ptr(), B, T, d, nhead,
             (1.0 / math.sqrt(d // nhead)) * LOG2E,
             int(od == torch.bfloat16), stream)
    build.check(err, "flash_mha_packed forward")
    build.count_launch(flash_mha_packed)
    return o, lse


def _lib():
    lib = build.load("flash_packed")
    fn = lib.rd_packed_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
