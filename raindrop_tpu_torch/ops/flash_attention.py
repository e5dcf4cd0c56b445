"""Flash attention, forward and backward (port of `flash_mha_packed` and
`flash_mha` in raindrop_tpu/ops/flash_attention.py).

`flash_mha_packed`: q, k, v [B, T, d] with d = nhead * hd stay in the
model's natural layout; o [B, T, d] f32; lse [B, nhead, T] f32 in base 2
(log2(e) folded into the score scale, as on the TPU); T (padded to 8) at
most MAX_FUSED_T. `flash_mha`: the split-head form, q, k, v [B, H, T, D]
with any T and any strides whose last is 1, o [B, H, T, D] f32. Keys at
t >= lengths[b] are masked; a sample with length 0 gives o = 0,
lse = NEG_INF and zero gradients.

Dropout on the probabilities draws its keep bits from a counter hash of
(seed, b * nhead + h, query row, key column) (`_dropout_keep_hash`), the
one the JAX package uses off the TPU, so forward and backward regenerate
the same mask and the tests compare with JAX exactly. The row sum `l`
takes the undropped probabilities; only the PV operand is dropped.

Both are `torch.autograd.Function`s. On CUDA tensors their forward and
backward launch the hand-written kernels in `csrc/flash_packed.cu` and
`csrc/flash_split.cu` (or raise); on CPU tensors they run
`_packed_fwd_plain` / `_packed_bwd_plain` and `_flash_fwd_plain` /
`_flash_bwd_plain`, the same functions in plain PyTorch, which the CPU
tests hold against the JAX package and `chip_smoke.py` holds the kernels
against on the card.

The JAX `flash_mha` has two regimes, one program per head while a [T, T]
score tile fits the TPU's VMEM (T padded to 8 <= 1024) and 128-row blocks
with an online softmax beyond. No [T, T] tile fits an SM's shared memory
at any T the model uses, so here one set of kernels (forward, dq, dk+dv)
streams 64-key tiles at every T. Both regimes hash the dropout mask from
the global (row, column), so one mask function serves both as well.
"""

from __future__ import annotations

import ctypes
import math

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.utils.dropout import M32, _mul32, finalize32, threshold32

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# The largest T (padded to 8) the JAX package's packed kernel takes; the
# port's encoder ladder keeps it (nn/transformer.py): beyond it the model
# runs the split-head flash_mha.
MAX_FUSED_T = 1024
# The largest head dim the kernels take (csrc/attention.cuh RD_DISPATCH_HD:
# a thread holds hd / 4 output columns in registers).
MAX_HEAD_DIM = 128


def operand_dtype(compute_dtype) -> torch.dtype:
    """Operand dtype of the attention products: f32 or bf16."""
    if compute_dtype in (None, "float32"):
        return torch.float32
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported flash compute_dtype {compute_dtype}")


def pad8(T: int) -> int:
    """T padded to a multiple of 8: the row count the JAX kernels hash
    their site masks with."""
    return -(-T // 8) * 8


def _dropout_keep_hash(seed, bh, iq: int, ik: int, shape, rate: float,
                       device=None) -> torch.Tensor:
    """Keep mask (bool) of a `shape` = (rows, cols) block at block
    coordinates (iq, ik), one per entry of `bh` (an int or an int64 tensor
    of any shape): returns bh.shape + shape. `rows`/`cols` enter the hash,
    so pass the padded shape the JAX kernel was called with."""
    rows, cols = shape
    bh = torch.as_tensor(bh, dtype=torch.int64, device=device)
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    seed = 0 if seed is None else int(seed)
    x = (_mul32(torch.as_tensor(seed & M32, dtype=torch.int64, device=device),
                0x9E3779B9)
         ^ _mul32((bh[..., None, None] + 1) & M32, 0x85EBCA6B)
         ^ _mul32((((iq * rows) & M32) + r) & M32, 0xC2B2AE35)
         ^ _mul32((((ik * cols) & M32) + c) & M32, 0x27D4EB2F))
    return finalize32(x) >= threshold32(rate)


def _attn_keep(seed, B, T, nhead, rate, device) -> torch.Tensor:
    """[B, nhead, T, T] keep mask of the attention probabilities."""
    bh = torch.arange(B * nhead, dtype=torch.int64, device=device)
    t8 = pad8(T)
    keep = _dropout_keep_hash(seed, bh.reshape(B, nhead), 0, 0, (t8, t8), rate,
                              device)
    return keep[:, :, :T, :T]


def _check(q, k, v, lengths, nhead):
    B, T, d = q.shape
    if d % nhead:
        raise ValueError(f"d={d} not divisible by nhead={nhead}")
    if pad8(T) > MAX_FUSED_T:
        raise ValueError(
            f"flash_mha_packed requires T <= {MAX_FUSED_T} (got {T}); "
            f"use flash_mha")
    if k.shape != q.shape or v.shape != q.shape or lengths.shape != (B,):
        raise ValueError("q, k, v must be [B, T, d] and lengths [B]")


def _check_rate(dropout_rate: float) -> float:
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    return rate


def _seed_int(seed) -> int:
    """The kernels' int32 seed; None means 0, as in the JAX package."""
    if seed is None:
        return 0
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"the kernel seed must fit int32, got {seed}")
    return seed


def _packed_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype, nhead):
    """Returns (o [B, T, d] f32, lse [B, nhead, T] f32, base 2)."""
    _check(q, k, v, lengths, nhead)
    rate = _check_rate(dropout_rate)
    od = operand_dtype(compute_dtype)
    if q.is_cuda:
        return _packed_fwd_cuda(q, k, v, lengths, _seed_int(seed), rate, nhead, od)
    return _packed_fwd_plain(q, k, v, lengths, nhead, od, _seed_int(seed), rate)


def _heads(x, nhead, od):
    """[B, T, d] -> [B, H, T, hd] in f32 from operands rounded to od."""
    B, T, d = x.shape
    return (x.to(od).to(torch.float32).reshape(B, T, nhead, d // nhead)
            .transpose(1, 2))


def _packed_fwd_plain(q, k, v, lengths, nhead, od, seed=0, rate=0.0):
    """The packed kernel's function in plain PyTorch (`_heads_fwd_plain` on
    the head views of [B, T, d])."""
    B, T, d = q.shape
    o, lse = _heads_fwd_plain(*(_heads(x, nhead, od) for x in (q, k, v)),
                              lengths, od, seed, rate)
    return o.transpose(1, 2).reshape(B, T, d), lse


def _heads_fwd_plain(qh, kh, vh, lengths, od, seed=0, rate=0.0):
    """The forward kernels' function on qh, kh, vh [B, H, T, D] (f32 values
    already rounded to `od`): scores in f32, probabilities (dropped and
    rescaled when rate > 0) rounded to `od` before the PV product, the PV
    output normalised by the row sum of the undropped probabilities (as
    the TPU kernel does). Returns (o [B, H, T, D], lse [B, H, T] base 2)."""
    B, H, T, D = qh.shape
    scale2 = (1.0 / math.sqrt(D)) * LOG2E
    lengths = lengths.to(torch.int64)
    s = (qh @ kh.transpose(-1, -2)) * scale2
    col = torch.arange(T, device=qh.device)
    bias = torch.where(col[None, :] < lengths[:, None], 0.0, NEG_INF)
    s = s + bias[:, None, None, :].to(torch.float32)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        p = p * _attn_keep(seed, B, T, H, rate, qh.device) / (1.0 - rate)
    o = (p.to(od).to(torch.float32) @ vh) / l
    valid = (lengths > 0)[:, None, None]
    lse = torch.where(valid, mx[..., 0] + torch.log2(l[..., 0]),
                      torch.full_like(l[..., 0], NEG_INF))
    o = torch.where(valid[..., None], o, torch.zeros_like(o))
    return o, lse


def _packed_bwd_plain(q, k, v, lengths, seed, rate, nhead, od, o, lse, g):
    """The backward kernels' function in plain PyTorch, with their
    rounding points: the incoming gradient cast to `od`; delta = per-head
    sum of do * o in f32; p recomputed from the saved base-2 lse; ds and
    the dropped p rounded to `od` before their products; dq and dk scaled
    by 1/sqrt(hd). A sample with length 0 gets exact zeros (the exponent
    is never evaluated there). Returns dq, dk, dv [B, T, d] f32."""
    B, T, d = q.shape
    hd = d // nhead
    scale = 1.0 / math.sqrt(hd)
    do = g.to(od)
    delta = ((do.to(torch.float32) * o).reshape(B, T, nhead, hd).sum(-1)
             .transpose(1, 2))                                  # [B, H, T]
    return _attention_bwd_plain(q, k, v, do, delta, lengths, seed, rate, nhead,
                                od, lse, scale)


def _attention_bwd_plain(q, k, v, do, delta, lengths, seed, rate, nhead, od,
                         lse, scale):
    """dq, dk, dv from od-rounded q, k, v, do [B, T, d], the saved lse and
    delta [B, H, T] (shared with the fused layer's backward)."""
    B, T, d = q.shape
    grads = _heads_bwd_plain(*(_heads(x, nhead, od) for x in (q, k, v, do)),
                             delta, lengths, seed, rate, od, lse, scale)
    return tuple(x.transpose(1, 2).reshape(B, T, d) for x in grads)


def _heads_bwd_plain(qh, kh, vh, doh, delta, lengths, seed, rate, od, lse,
                     scale):
    """The backward kernels' function on [B, H, T, D] views (f32 values
    already rounded to `od`): p recomputed from the saved base-2 lse, ds and
    the dropped p rounded to `od` before their products, dq and dk scaled
    by `scale`, exact zeros for a sample of length 0."""
    B, H, T, D = qh.shape
    lengths = lengths.to(torch.int64)
    valid = (lengths > 0)[:, None, None, None]
    col = torch.arange(T, device=qh.device)
    live = (col[None, :] < lengths[:, None])[:, None, None, :]   # [B,1,1,T]
    s = (qh @ kh.transpose(-1, -2)) * (scale * LOG2E)
    arg = torch.where(live & valid, s - lse[..., None],
                      torch.full_like(s, -float("inf")))
    p = torch.exp2(arg)
    dp = doh @ vh.transpose(-1, -2)
    if rate > 0.0:
        keep = _attn_keep(seed, B, T, H, rate, qh.device)
        p_drop = p * keep / (1.0 - rate)
        dp = dp * keep / (1.0 - rate)
    else:
        p_drop = p
    ds = (p * (dp - delta[..., None])).to(od).to(torch.float32)
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dv = p_drop.to(od).to(torch.float32).transpose(-1, -2) @ doh
    vf = valid.to(torch.float32)
    return dq * (scale * vf), dk * (scale * vf), dv * vf


class _FlashPacked(torch.autograd.Function):
    """flash_mha_packed with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, seed, dropout_rate, compute_dtype, nhead):
        o, lse = _packed_fwd(q, k, v, lengths, seed, dropout_rate,
                             compute_dtype, nhead)
        od = operand_dtype(compute_dtype)
        ctx.save_for_backward(q.to(od), k.to(od), v.to(od), lengths, o, lse)
        ctx.args = (_seed_int(seed), float(dropout_rate), nhead, od)
        ctx.in_dtypes = (q.dtype, k.dtype, v.dtype)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        seed, rate, nhead, od = ctx.args
        if g.is_cuda:
            dq, dk, dv = _packed_bwd_cuda(q, k, v, lengths, seed, rate, nhead,
                                          od, o, lse, g)
        else:
            dq, dk, dv = _packed_bwd_plain(q, k, v, lengths, seed, rate, nhead,
                                           od, o, lse, g)
        dq, dk, dv = (x.to(t) for x, t in zip((dq, dk, dv), ctx.in_dtypes))
        return dq, dk, dv, None, None, None, None, None


def flash_mha_packed(q, k, v, lengths, seed=None, dropout_rate=0.0,
                     compute_dtype=None, nhead=1) -> torch.Tensor:
    """Packed-heads attention: q, k, v [B, T, d] -> o [B, T, d] f32.
    `seed` is the int32 seed of the dropout mask (None means 0);
    differentiable in q, k and v."""
    return _FlashPacked.apply(q, k, v, lengths, seed, dropout_rate,
                              compute_dtype, nhead)


# forward launches; `bwd_launches` counts the backward's
flash_mha_packed.launches = 0
flash_mha_packed.bwd_launches = 0


def _same_device(dev, **tensors):
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")


def _packed_fwd_cuda(q, k, v, lengths, seed, rate, nhead, od):
    B, T, d = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths)
    for x in (q, k, v):
        if not x.is_floating_point():
            raise TypeError(f"q, k, v must be floating point, got {x.dtype}")
    q, k, v = (x.detach().to(od).contiguous() for x in (q, k, v))
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    lse = torch.empty((B, nhead, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().rd_packed_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, T, d, nhead,
        (1.0 / math.sqrt(d // nhead)) * LOG2E, int(od == torch.bfloat16),
        seed, rate, stream)
    build.check(err, "flash_mha_packed forward")
    build.count_launch(flash_mha_packed)
    return o, lse


def _packed_bwd_cuda(q, k, v, lengths, seed, rate, nhead, od, o, lse, g):
    """dq, dk, dv through the two backward kernels (one CTA per 64 query
    rows for dq, one per 64 key rows for dk and dv). delta is prepared
    here in torch ops, as the JAX package prepares it outside its kernel."""
    B, T, d = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths, o=o, lse=lse, g=g)
    if g.shape != q.shape:
        raise ValueError(f"the incoming gradient is {tuple(g.shape)}, "
                         f"expected {tuple(q.shape)}")
    hd = d // nhead
    q, k, v = (x.detach().to(od).contiguous() for x in (q, k, v))
    do = g.detach().to(od).contiguous()
    delta = ((do.to(torch.float32) * o).reshape(B, T, nhead, hd).sum(-1)
             .transpose(1, 2).contiguous())
    lens = lengths.to(torch.int32).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty((B, T, d), dtype=torch.float32, device=dev)
                  for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = 1.0 / math.sqrt(hd)
    err = _lib().rd_packed_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), lens.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, d, nhead, scale,
        int(od == torch.bfloat16), seed, rate, stream)
    build.check(err, "flash_mha_packed backward")
    build.count_launch(flash_mha_packed, "bwd_launches")
    return dq, dk, dv


def _lib():
    lib = build.load("flash_packed")
    if lib.rd_packed_fwd.argtypes is None:
        tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_void_p]
        lib.rd_packed_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                      + tail)
        lib.rd_packed_fwd.restype = ctypes.c_int
        lib.rd_packed_bwd.argtypes = ([ctypes.c_void_p] * 10
                                      + [ctypes.c_int] * 4 + tail)
        lib.rd_packed_bwd.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------- flash_mha
def _check_heads(q, k, v, lengths):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape or lengths.shape != (q.shape[0],):
        raise ValueError("q, k, v must be [B, H, T, D] and lengths [B]")


def _rounded(x, od):
    """f32 values rounded to the operand dtype."""
    return x.to(od).to(torch.float32)


def _flash_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype):
    """Returns (o [B, H, T, D] f32, lse [B, H, T] f32, base 2)."""
    _check_heads(q, k, v, lengths)
    rate = _check_rate(dropout_rate)
    od = operand_dtype(compute_dtype)
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, lengths, _seed_int(seed), rate, od)
    return _flash_fwd_plain(q, k, v, lengths, od, _seed_int(seed), rate)


def _flash_fwd_plain(q, k, v, lengths, od, seed=0, rate=0.0):
    """flash_mha's forward in plain PyTorch (see `_heads_fwd_plain`)."""
    return _heads_fwd_plain(*(_rounded(x, od) for x in (q, k, v)), lengths, od,
                            seed, rate)


def _flash_bwd_plain(q, k, v, lengths, seed, rate, od, o, lse, g):
    """flash_mha's backward in plain PyTorch, with the kernels' rounding
    points (see `_packed_bwd_plain`). Returns dq, dk, dv [B, H, T, D] f32."""
    do = g.to(od)
    delta = (do.to(torch.float32) * o).sum(-1)                  # [B, H, T]
    return _heads_bwd_plain(*(_rounded(x, od) for x in (q, k, v, do)), delta,
                            lengths, seed, rate, od, lse,
                            1.0 / math.sqrt(q.shape[-1]))


class _FlashSplit(torch.autograd.Function):
    """flash_mha with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, seed, dropout_rate, compute_dtype):
        o, lse = _flash_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype)
        od = operand_dtype(compute_dtype)
        ctx.save_for_backward(q.to(od), k.to(od), v.to(od), lengths, o, lse)
        ctx.args = (_seed_int(seed), float(dropout_rate), od)
        ctx.in_dtypes = (q.dtype, k.dtype, v.dtype)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        seed, rate, od = ctx.args
        fn = _flash_bwd_cuda if g.is_cuda else _flash_bwd_plain
        dq, dk, dv = fn(q, k, v, lengths, seed, rate, od, o, lse, g)
        dq, dk, dv = (x.to(t) for x, t in zip((dq, dk, dv), ctx.in_dtypes))
        return dq, dk, dv, None, None, None, None


def flash_mha(q, k, v, lengths, seed=None, dropout_rate=0.0,
              compute_dtype=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + key mask) v per head, at any T.

    q, k, v [B, H, T, D] (any strides with a contiguous last dim: the
    [B, T, H, D] view of a projection works without a copy); lengths [B]
    valid key counts, shared by a sample's heads; `seed` the int32 seed of
    the dropout mask on the probabilities (None means 0); compute_dtype
    None keeps f32 operands, "bfloat16" rounds the operands of every
    product to bf16 (f32 accumulation and softmax statistics). Returns o
    [B, H, T, D] f32; on the card its memory is laid out [B, T, H, D], so
    merging the heads afterwards is a view. Differentiable in q, k and v."""
    return _FlashSplit.apply(q, k, v, lengths, seed, dropout_rate,
                             compute_dtype)


flash_mha.launches = 0
flash_mha.bwd_launches = 0


def _head_strides(*xs):
    """The [B, H, T, D] tensors `xs` as the kernels take them, with a unit
    last stride and one (batch, head, row) stride triple for all (copies
    when they differ), and that triple in elements."""
    if any(x.stride(-1) != 1 or x.stride() != xs[0].stride() for x in xs):
        xs = tuple(x.contiguous() for x in xs)
    return xs, xs[0].stride()[:3]


def _empty_heads(B, H, T, D, device):
    """An f32 [B, H, T, D] tensor laid out [B, T, H, D] in memory."""
    return torch.empty((B, T, H, D), dtype=torch.float32,
                       device=device).transpose(1, 2)


def _check_flash_cuda(q, k, v):
    B, H, T, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the flash_mha kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got D={D}")
    if B > 65535 or H > 65535:
        raise ValueError(f"the flash_mha kernels take up to 65535 samples "
                         f"and heads (grid dimensions), got B={B}, H={H}")
    for x in (q, k, v):
        if not x.is_floating_point():
            raise TypeError(f"q, k, v must be floating point, got {x.dtype}")


def _flash_fwd_cuda(q, k, v, lengths, seed, rate, od):
    B, H, T, D = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths)
    _check_flash_cuda(q, k, v)
    (q, k, v), s_in = _head_strides(*(x.detach().to(od) for x in (q, k, v)))
    lens = lengths.to(torch.int32).contiguous()
    o = _empty_heads(B, H, T, D, dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 6)(*s_in, *o.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _split_lib().rd_split_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), lse.data_ptr(), strides, B, H, T, D,
        (1.0 / math.sqrt(D)) * LOG2E, int(od == torch.bfloat16), seed, rate,
        stream)
    build.check(err, "flash_mha forward")
    build.count_launch(flash_mha)
    return o, lse


def _flash_bwd_cuda(q, k, v, lengths, seed, rate, od, o, lse, g):
    """dq, dk, dv through the two backward kernels (one CTA per 64 query
    rows for dq, one per 64 key rows for dk and dv). delta is prepared here
    in torch ops, as the JAX package prepares it outside its kernels."""
    B, H, T, D = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths, o=o, lse=lse, g=g)
    _check_flash_cuda(q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"the incoming gradient is {tuple(g.shape)}, "
                         f"expected {tuple(q.shape)}")
    (q, k, v), s_in = _head_strides(*(x.detach().to(od) for x in (q, k, v)))
    (do,), s_do = _head_strides(g.detach().to(od))
    delta = (do.to(torch.float32) * o).sum(-1).contiguous()      # [B, H, T]
    lens = lengths.to(torch.int32).contiguous()
    lse = lse.contiguous()
    # one allocation, so the three gradients share their strides
    grads = torch.empty((3, B, T, H, D), dtype=torch.float32, device=dev)
    dq, dk, dv = (x.transpose(1, 2) for x in grads.unbind(0))
    strides = (ctypes.c_int64 * 9)(*s_in, *s_do, *dq.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _split_lib().rd_split_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), lens.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, B, H, T, D,
        1.0 / math.sqrt(D), int(od == torch.bfloat16), seed, rate, stream)
    build.check(err, "flash_mha backward")
    build.count_launch(flash_mha, "bwd_launches")
    return dq, dk, dv


def _split_lib():
    lib = build.load("flash_split")
    if lib.rd_split_fwd.argtypes is None:
        tail = [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_void_p]
        lib.rd_split_fwd.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.rd_split_fwd.restype = ctypes.c_int
        lib.rd_split_bwd.argtypes = [ctypes.c_void_p] * 10 + tail
        lib.rd_split_bwd.restype = ctypes.c_int
    return lib
