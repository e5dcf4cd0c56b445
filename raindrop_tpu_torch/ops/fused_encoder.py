"""Fused post-LN encoder layer, forward and backward (port of
`fused_encoder_layer` in raindrop_tpu/ops/fused_encoder.py).

    attn = MHA(x)                     (packed heads, base-2 softmax)
    x1   = LN1(x + drop(attn Wo^T + bo))
    out  = LN2(x1 + drop(W2 drop(relu(W1 x1 + b1)) + b2))

`p` is the nn/transformer layer dict. Dropout has four sites, each a
counter-hash mask regenerated in the backward: the attention
probabilities, keyed (seed, b * nhead + h) as in the packed kernel, and
three site masks keyed (seed, b, site) with sites 101 (attention out),
102 (FFN hidden) and 103 (FFN out), whose row term is site * t8 + row
with t8 = T padded to 8. These are the masks the JAX package draws off the
TPU; its two-heads-per-draw hardware generator has no counterpart here.

`fused_encoder_layer` is a `torch.autograd.Function` over x and the 12
weights. On CUDA tensors forward and backward launch the hand-written
kernels in `csrc/fused_encoder.cu` and `csrc/fused_encoder_bwd.cu` (or
raise: `fused_smem` reads each launch's shared memory from them, which
bounds the widths they take, d = 340 with ffn = 136 and 2 heads at PAM's
sensor-wise width among them); on CPU tensors they run `_fused_fwd_plain` and
`_fused_bwd_plain`, the same functions in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.ops.flash_attention import (
    LOG2E, MAX_FUSED_T, _attention_bwd_plain, _check_rate, _dropout_keep_hash,
    _packed_fwd_plain, _seed_int, operand_dtype, pad8)

_EPS = 1e-5
SITE_ATTN_OUT, SITE_FFN_MID, SITE_FFN_OUT = 101, 102, 103


def _site_keep(seed, B, site, T, n, rate, device) -> torch.Tensor:
    """[B, T, n] keep mask of one dropout site."""
    b = torch.arange(B, dtype=torch.int64, device=device)
    return _dropout_keep_hash(seed, b, site, 0, (pad8(T), n), rate, device)[:, :T]


_WEIGHTS = (("in_proj_w",), ("in_proj_b",), ("out_proj", "w"),
            ("out_proj", "b"), ("ln1", "scale"), ("ln1", "bias"),
            ("lin1", "w"), ("lin1", "b"), ("lin2", "w"), ("lin2", "b"),
            ("ln2", "scale"), ("ln2", "bias"))


def _flatten(p):
    ws = []
    for path in _WEIGHTS:
        w = p
        for key in path:
            w = w[key]
        ws.append(w)
    return ws


def _unflatten(ws):
    (w_in, b_in, wo, bo, g1, be1, w1, bf1, w2, bf2, g2, be2) = ws
    return {"in_proj_w": w_in, "in_proj_b": b_in,
            "out_proj": {"w": wo, "b": bo}, "ln1": {"scale": g1, "bias": be1},
            "lin1": {"w": w1, "b": bf1}, "lin2": {"w": w2, "b": bf2},
            "ln2": {"scale": g2, "bias": be2}}


def _check(x, lengths, nhead):
    B, T, d = x.shape
    if d % nhead:
        raise ValueError(f"d={d} not divisible by nhead={nhead}")
    if pad8(T) > MAX_FUSED_T:
        raise ValueError(f"fused encoder layer requires T <= {MAX_FUSED_T}")
    if lengths.shape != (B,):
        raise ValueError("lengths must be [B]")


def _fused_fwd(p, x, lengths, seed, dropout_rate, compute_dtype, nhead):
    """Returns (out, attn [B, T, d] f32, lse [B, nhead, T] f32, base 2);
    attn and lse are what the backward reads."""
    _check(x, lengths, nhead)
    rate = _check_rate(dropout_rate)
    od = operand_dtype(compute_dtype)
    if x.is_cuda:
        return _fused_fwd_cuda(_flatten(p), x, lengths, _seed_int(seed), rate,
                               nhead, od)
    return _fused_fwd_plain(p, x, lengths, nhead, od, _seed_int(seed), rate)


def _ln_fwd(h, p):
    mu = h.mean(dim=-1, keepdim=True)
    var = (h - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + _EPS)
    xhat = (h - mu) * rstd
    return xhat * p["scale"] + p["bias"], xhat, rstd


def _ln_bwd(g, xhat, rstd, scale):
    """dL/dh of y = xhat * scale + bias; also dscale and dbias summed over
    every row."""
    dxhat = g * scale
    dh = (dxhat - dxhat.mean(dim=-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True)) * rstd
    return dh, (g * xhat).sum(dim=(0, 1)), g.sum(dim=(0, 1))


def _recompute(p, x, attn, r, keeps):
    """The row-local part of the forward from x and the attention output:
    returns what forward and backward both need."""
    keep2, keep3, keep4 = keeps
    ao = r(attn) @ r(p["out_proj"]["w"]).T + p["out_proj"]["b"]
    if keep2 is not None:
        ao = ao * keep2
    x1, xhat1, rstd1 = _ln_fwd(x + ao, p["ln1"])
    f_pre = r(x1) @ r(p["lin1"]["w"]).T + p["lin1"]["b"]
    f = torch.relu(f_pre)
    if keep3 is not None:
        f = f * keep3
    f2 = r(f) @ r(p["lin2"]["w"]).T + p["lin2"]["b"]
    if keep4 is not None:
        f2 = f2 * keep4
    out, xhat2, rstd2 = _ln_fwd(x1 + f2, p["ln2"])
    return out, x1, xhat1, rstd1, f_pre, f, xhat2, rstd2


def _site_keeps(seed, rate, B, T, d, ffn, device):
    """The three site masks scaled by 1/(1-rate), or Nones at rate 0."""
    if rate <= 0.0:
        return None, None, None
    return tuple(
        _site_keep(seed, B, site, T, n, rate, device).to(torch.float32) / (1.0 - rate)
        for site, n in ((SITE_ATTN_OUT, d), (SITE_FFN_MID, ffn), (SITE_FFN_OUT, d)))


def _fused_fwd_plain(p, x, lengths, nhead, od, seed=0, rate=0.0):
    """The kernels' function in plain PyTorch, with the TPU kernel's
    rounding: every product operand in `od`, q/k/v rounded after their
    bias, f32 accumulation, attention normalising the PV output."""
    B, T, d = x.shape
    x = x.to(torch.float32)

    def r(t):
        return t.to(od).to(torch.float32)

    qkv = r(x) @ r(p["in_proj_w"]).T + p["in_proj_b"]
    q, k, v = r(qkv).split(d, dim=-1)
    attn, lse = _packed_fwd_plain(q, k, v, lengths, nhead, od, seed, rate)
    keeps = _site_keeps(seed, rate, B, T, d, p["lin1"]["w"].shape[0], x.device)
    out = _recompute(p, x, attn, r, keeps)[0]
    return out, attn, lse


def _fused_bwd_plain(p, x, lengths, seed, rate, nhead, od, attn, lse, g,
                     relu_on=None):
    """The backward kernels' function in plain PyTorch: recompute the
    forward from x and the saved attn and lse, then the gradient of every
    stage with each product operand rounded to `od` where the TPU kernel
    rounds it; delta comes from d_attn * attn per head. Returns dx
    [B, T, d] f32 and the 12 weight gradients in `_WEIGHTS` order (torch
    layout [out, in]).

    `relu_on` [B, T, ffn] bool, when given, replaces `f_pre > 0` as the
    relu's branch in the backward. A pre-activation within rounding of
    zero can fall on either side in two implementations, and the branch
    moves single gradient elements by O(1); a comparison at a large shape
    passes the kernel's branches so that it tests the arithmetic."""
    B, T, d = x.shape
    ffn = p["lin1"]["w"].shape[0]
    hd = d // nhead
    scale = 1.0 / math.sqrt(hd)
    x = x.to(torch.float32)
    g = g.to(torch.float32)

    def r(t):
        return t.to(od).to(torch.float32)

    def wgrad(a, go):  # [out, in] = sum over rows of go^T a
        return go.reshape(-1, go.shape[-1]).T @ a.reshape(-1, a.shape[-1])

    xo = r(x)
    qkv = xo @ r(p["in_proj_w"]).T + p["in_proj_b"]
    q, k, v = r(qkv).split(d, dim=-1)
    keeps = _site_keeps(seed, rate, B, T, d, ffn, x.device)
    keep2, keep3, keep4 = keeps
    _, x1, xhat1, rstd1, f_pre, f, xhat2, rstd2 = _recompute(p, x, attn, r, keeps)

    dh2, dg2, dbe2 = _ln_bwd(g, xhat2, rstd2, p["ln2"]["scale"])
    df2 = dh2 * keep4 if keep4 is not None else dh2
    df2o = r(df2)
    dw2 = wgrad(r(f), df2o)
    dbf2 = df2.sum(dim=(0, 1))
    df = df2o @ r(p["lin2"]["w"])
    if keep3 is not None:
        df = df * keep3
    dfpre = df * (f_pre > 0 if relu_on is None else relu_on)
    dfpreo = r(dfpre)
    dw1 = wgrad(r(x1), dfpreo)
    dbf1 = dfpre.sum(dim=(0, 1))
    dx1 = dh2 + dfpreo @ r(p["lin1"]["w"])
    dh1, dg1, dbe1 = _ln_bwd(dx1, xhat1, rstd1, p["ln1"]["scale"])
    dao = dh1 * keep2 if keep2 is not None else dh1
    daoo = r(dao)
    dwo = wgrad(r(attn), daoo)
    dbo = dao.sum(dim=(0, 1))
    d_attn = daoo @ r(p["out_proj"]["w"])

    delta = (d_attn * attn).reshape(B, T, nhead, hd).sum(-1).transpose(1, 2)
    dq, dk, dv = _attention_bwd_plain(q, k, v, r(d_attn), delta, lengths, seed,
                                      rate, nhead, od, lse, scale)
    dqkv = torch.cat([dq, dk, dv], dim=-1)                 # [B, T, 3d]
    dqkvo = r(dqkv)
    dw_in = wgrad(xo, dqkvo)
    db_in = dqkv.sum(dim=(0, 1))
    dx = dh1 + dqkvo @ r(p["in_proj_w"])
    return dx, [dw_in, db_in, dwo, dbo, dg1, dbe1, dw1, dbf1, dw2, dbf2, dg2,
                dbe2]


class _FusedLayer(torch.autograd.Function):
    """fused_encoder_layer over (x, 12 weights) with its hand-written
    backward."""

    @staticmethod
    def forward(ctx, x, lengths, seed, dropout_rate, compute_dtype, nhead, *ws):
        out, attn, lse = _fused_fwd(_unflatten(ws), x, lengths, seed,
                                    dropout_rate, compute_dtype, nhead)
        ctx.save_for_backward(x, lengths, attn, lse, *ws)
        ctx.args = (_seed_int(seed), float(dropout_rate), nhead,
                    operand_dtype(compute_dtype))
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, lengths, attn, lse, *ws = ctx.saved_tensors
        seed, rate, nhead, od = ctx.args
        if g.is_cuda:
            dx, dws = _fused_bwd_cuda(ws, x, lengths, seed, rate, nhead, od,
                                      attn, lse, g)
        else:
            dx, dws = _fused_bwd_plain(_unflatten(ws), x, lengths, seed, rate,
                                       nhead, od, attn, lse, g)
        dws = [dw.to(w.dtype) for dw, w in zip(dws, ws)]
        return (dx.to(x.dtype), None, None, None, None, None, *dws)


def fused_encoder_layer(p, x, lengths, seed=None, dropout_rate=0.0,
                        compute_dtype=None, nhead=1) -> torch.Tensor:
    """One post-LN encoder layer. x [B, T, d]; lengths [B]; `seed` the
    int32 seed of the four dropout masks (None means 0). Returns out
    [B, T, d] in x's dtype; differentiable in x and the layer's weights."""
    return _FusedLayer.apply(x, lengths, seed, dropout_rate, compute_dtype,
                             nhead, *_flatten(p))


# forward calls that launched the kernels; `bwd_launches` counts backwards
fused_encoder_layer.launches = 0
fused_encoder_layer.bwd_launches = 0


def _prepare(ws, x, lengths):
    """Checked f32 contiguous weights, x and int32 lengths for a launch."""
    B, T, d = x.shape
    dev = x.device
    ffn = ws[6].shape[0]
    want = [(3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (ffn, d), (ffn,),
            (d, ffn), (d,), (d,), (d,)]
    out = []
    for path, w, shape in zip(_WEIGHTS, ws, want):
        name = "/".join(path)
        if w.device != dev:
            raise ValueError(f"weight {name} is on {w.device}, x on {dev}")
        if tuple(w.shape) != shape:
            raise ValueError(f"weight {name} is {tuple(w.shape)}, expected {shape}")
        out.append(w.detach().to(torch.float32).contiguous())
    if lengths.device != dev:
        raise ValueError(f"lengths is on {lengths.device}, x on {dev}")
    return (out, x.detach().to(torch.float32).contiguous(),
            lengths.to(torch.int32).contiguous(), ffn)


def _fused_fwd_cuda(ws, x, lengths, seed, rate, nhead, od):
    B, T, d = x.shape
    dev = x.device
    ws, xf, lens, ffn = _prepare(ws, x, lengths)
    _check_fits(d, ffn, nhead)
    qkv = torch.empty((B, T, 3 * d), dtype=torch.float32, device=dev)
    out = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    attn = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    lse = torch.empty((B, nhead, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().rd_fused_layer_fwd(
        xf.data_ptr(), *(w.data_ptr() for w in ws), lens.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), attn.data_ptr(), lse.data_ptr(),
        B, T, d, ffn, nhead, (1.0 / math.sqrt(d // nhead)) * LOG2E,
        int(od == torch.bfloat16), seed, rate, stream)
    build.check(err, "fused_encoder_layer forward")
    build.count_launch(fused_encoder_layer)
    return out, attn, lse


# rows of [B*T] one CTA of the weight-gradient kernel sums; the split is a
# function of the shape alone, so the result is the same bits every run
WGRAD_CHUNK = 512
# rows per CTA of the qkv projection and the row-local backward kernels (BR
# in csrc/fused_rows.cuh)
BWD_ROWS = 32


def fused_smem(d, ffn, nhead):
    """(shared bytes of each launch of the fused layer's kernels at one
    width, whether the kernels take it), as csrc/fused_encoder.cu and
    csrc/fused_encoder_bwd.cu compute them (it builds the kernels: on the
    card only): the qkv projection, the attention (the scalar routines in
    the geometry of the head dim), the forward's row-local tail, the
    backward's row-local kernel, dq, dk/dv and dx. Every byte 0 where no
    geometry takes the head dim."""
    fwd, bwd = (ctypes.c_int * 3)(), (ctypes.c_int * 5)()
    err = (_lib().rd_fused_layer_fwd_smem(d, ffn, nhead, fwd)
           | _lib_bwd().rd_fused_layer_bwd_smem(d, ffn, nhead, bwd))
    names = ("qkv", "attn_fwd", "tail", "bwd_rows", "attn_dq", "attn_dkv", "dx")
    return dict(zip(names, (*fwd, *bwd[1:]))), err == 0


@functools.lru_cache(maxsize=64)
def _check_fits(d, ffn, nhead):
    """Raise for a width the kernels do not take (the C entry points refuse
    it too)."""
    smem, fits = fused_smem(d, ffn, nhead)
    if not fits:
        raise ValueError(f"the fused layer's kernels do not take d={d}, ffn={ffn}, "
                         f"{nhead} heads: shared bytes {smem}")


def bwd_scratch_floats(B, T, d, ffn, nhead):
    """Per-buffer float counts of what the backward keeps in device memory
    between its launches (also what PERF.md lists)."""
    M = B * T
    blocks = B * (-(-T // BWD_ROWS))
    chunks = -(-M // WGRAD_CHUNK)
    return {
        "qkv": M * 3 * d, "x1": M * d, "f": M * ffn, "df2": M * d,
        "dfpre": M * ffn, "dao": M * d, "d_attn": M * d, "dh1": M * d,
        "dqkv": M * 3 * d, "delta": B * nhead * T,
        "row_partials": blocks * (9 * d + ffn),
        "wgrad_partials": chunks * max(3 * d * d, d * ffn),
    }


def _fused_bwd_cuda(ws, x, lengths, seed, rate, nhead, od, attn, lse, g,
                    scratch_out=None):
    """dx and the 12 weight gradients through the backward kernels; every
    intermediate buffer is allocated here and listed by
    `bwd_scratch_floats`. A dict passed as `scratch_out` receives those
    buffers (flat f32), for a check that wants to look at them."""
    B, T, d = x.shape
    dev = x.device
    if g.shape != x.shape:
        raise ValueError(f"the incoming gradient is {tuple(g.shape)}, "
                         f"expected {tuple(x.shape)}")
    for name, t in (("attn", attn), ("lse", lse), ("g", g)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    ws, xf, lens, ffn = _prepare(ws, x, lengths)
    _check_fits(d, ffn, nhead)
    gf = g.detach().to(torch.float32).contiguous()
    attn, lse = attn.contiguous(), lse.contiguous()
    sizes = bwd_scratch_floats(B, T, d, ffn, nhead)
    scratch = {k: torch.empty((n,), dtype=torch.float32, device=dev)
               for k, n in sizes.items()}
    dx = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    dw_in, dwo, dw1, dw2 = (torch.empty(ws[i].shape, dtype=torch.float32, device=dev)
                            for i in (0, 2, 6, 8))
    # the bias and LayerNorm gradients come back in one buffer:
    # [dg2, dbe2, dbf2, dbf1 (ffn), dg1, dbe1, dbo, db_in (3d)]
    vec = torch.empty((9 * d + ffn,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    order = ("qkv", "x1", "f", "df2", "dfpre", "dao", "d_attn", "dh1", "dqkv",
             "delta", "row_partials", "wgrad_partials")
    err = _lib_bwd().rd_fused_layer_bwd(
        xf.data_ptr(), *(w.data_ptr() for w in ws), lens.data_ptr(),
        attn.data_ptr(), lse.data_ptr(), gf.data_ptr(),
        *(scratch[k].data_ptr() for k in order), dx.data_ptr(),
        dw_in.data_ptr(), dwo.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
        vec.data_ptr(), B, T, d, ffn, nhead, WGRAD_CHUNK,
        1.0 / math.sqrt(d // nhead), int(od == torch.bfloat16), seed, rate,
        stream)
    build.check(err, "fused_encoder_layer backward")
    build.count_launch(fused_encoder_layer, "bwd_launches")
    if scratch_out is not None:
        scratch_out.update(scratch)
    dg2, dbe2, dbf2, dbf1, dg1, dbe1, dbo, db_in = vec.split(
        [d, d, d, ffn, d, d, d, 3 * d])
    return dx, [dw_in, db_in, dwo, dbo, dg1, dbe1, dw1, dbf1, dw2, dbf2, dg2,
                dbe2]


_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_double,
         ctypes.c_void_p]
_SMEM_ARGS = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]


def _lib():
    lib = build.load("fused_encoder")
    fn = lib.rd_fused_layer_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + _TAIL
        fn.restype = ctypes.c_int
        lib.rd_fused_layer_fwd_smem.argtypes = _SMEM_ARGS
        lib.rd_fused_layer_fwd_smem.restype = ctypes.c_int
    return lib


def _lib_bwd():
    lib = build.load("fused_encoder_bwd")
    fn = lib.rd_fused_layer_bwd
    if fn.argtypes is None:
        # x, 12 weights, lengths, attn, lse, g; 12 scratch; dx, 4 weight
        # gradients, vec; B, T, d, ffn, nhead, chunk
        fn.argtypes = [ctypes.c_void_p] * 35 + [ctypes.c_int] * 6 + _TAIL
        fn.restype = ctypes.c_int
        lib.rd_fused_layer_bwd_smem.argtypes = _SMEM_ARGS
        lib.rd_fused_layer_bwd_smem.restype = ctypes.c_int
    return lib
