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
TPU; its two-heads-per-draw hardware generator has no counterpart here. A
launch over rows b0.. of a larger batch (a data-parallel rank's shard)
passes `origin` = (b0, 0, nhead): its sample b then hashes as sample
b0 + b, so the shards draw the full batch's masks. A call over more than
MAX_BATCH samples runs as launches of at most that many at their origins
(`batch_chunks`), the backward summing the chunks' weight gradients.

`fused_encoder_layer` is a `torch.autograd.Function` over x and the 12
weights. On CUDA tensors forward and backward launch the hand-written
kernels in `csrc/fused_encoder.cu` and `csrc/fused_encoder_bwd.cu` (or
raise) by the route of their launch plan (`fused_plan`), at every width
the JAX kernel takes (any d divisible by nhead, any ffn and head dim):
where a whole tile of the layer's rows fits a block (to d = 360 at ffn
136, 226 at ffn 2d; PAM's sensor-wise 340 among them), with bf16
operands every row product on the tensor cores (`csrc/rows_tc.cuh`) and
the attention too, on one warpgroup up to a padded head dim of 144 and on
two past it to hd 192 (`csrc/attention_tc_wide.cuh`, PAM's sensor-wise hd
170), with f32 operands (and bf16 where a tensor-core tile would not
fit) the scalar kernels; past those widths (P12's sensor-wise d = 720,
P19's 680, any head past 368) the "stream" route
(`csrc/rows_stream.cuh`): every product a launch with its activation
streamed through K (tensor cores in bf16, scalar in f32), the LayerNorms
and dropout sites as row kernels, the attention past hd 368 in bf16 on
the tensor cores (`csrc/attention_tc_cluster.cuh`, a cluster of CTAs a
block of rows, to hd 2048) and in f32 on `csrc/attention_hd_stream.cuh`.
On CPU tensors they run `_fused_fwd_plain` and `_fused_bwd_plain`, the
same functions in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.ops.flash_attention import (
    HD_STREAM_ROWS, LOG2E, MAX_FUSED_T, MAX_HEAD_DIM, NARROW_MAX_HD, TC_CLUSTER_MAX_HD,
    TC_MAX_HD_PAD, _ROUTES, _align, _attention_bwd_plain, _check_rate,
    _dropout_keep_hash, _packed_fwd_plain, _seed_int, batch_chunks, drop_origin,
    operand_dtype, pad8, tc_cluster_size, tc_cluster_smem, wide_pad)

_EPS = 1e-5
SITE_ATTN_OUT, SITE_FFN_MID, SITE_FFN_OUT = 101, 102, 103


def layer_flops(B: int, T: int, d: int, ffn: int) -> int:
    """Model FLOPs of one layer forward over B samples: the qkv projection
    (6 T d^2), the attention (4 T^2 d, `attention_flops`), the output
    projection (2 T d^2) and the two FFN products (4 T d ffn), 2 a
    multiply-add. The kernels credit it for a forward and twice it for a
    backward; the attention inside is not credited again."""
    return B * (4 * T * T * d + 8 * T * d * d + 4 * T * d * ffn)


def _site_keep(seed, B, site, T, n, rate, device, b0=0) -> torch.Tensor:
    """[B, T, n] keep mask of one dropout site, the samples at b0.."""
    b = torch.arange(b0, b0 + B, dtype=torch.int64, device=device)
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


def _fused_fwd(p, x, lengths, seed, dropout_rate, compute_dtype, nhead,
               origin=None):
    """Returns (out, attn [B, T, d] f32, lse [B, nhead, T] f32, base 2);
    attn and lse are what the backward reads."""
    _check(x, lengths, nhead)
    rate = _check_rate(dropout_rate)
    od = operand_dtype(compute_dtype)
    if x.is_cuda:
        return _fused_fwd_cuda(_flatten(p), x, lengths, _seed_int(seed), rate,
                               nhead, od, origin=origin)
    return _fused_fwd_plain(p, x, lengths, nhead, od, _seed_int(seed), rate,
                            origin)


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


def _site_keeps(seed, rate, B, T, d, ffn, device, b0=0):
    """The three site masks scaled by 1/(1-rate), or Nones at rate 0."""
    if rate <= 0.0:
        return None, None, None
    return tuple(
        _site_keep(seed, B, site, T, n, rate, device, b0).to(torch.float32) / (1.0 - rate)
        for site, n in ((SITE_ATTN_OUT, d), (SITE_FFN_MID, ffn), (SITE_FFN_OUT, d)))


def _fused_fwd_plain(p, x, lengths, nhead, od, seed=0, rate=0.0, origin=None):
    """The kernels' function in plain PyTorch, with the TPU kernel's
    rounding: every product operand in `od`, q/k/v rounded after their
    bias, f32 accumulation, attention normalising the PV output."""
    B, T, d = x.shape
    x = x.to(torch.float32)

    def r(t):
        return t.to(od).to(torch.float32)

    qkv = r(x) @ r(p["in_proj_w"]).T + p["in_proj_b"]
    q, k, v = r(qkv).split(d, dim=-1)
    origin = drop_origin(origin, B, nhead)
    attn, lse = _packed_fwd_plain(q, k, v, lengths, nhead, od, seed, rate, origin)
    keeps = _site_keeps(seed, rate, B, T, d, p["lin1"]["w"].shape[0], x.device,
                        origin[0])
    out = _recompute(p, x, attn, r, keeps)[0]
    return out, attn, lse


def _fused_bwd_plain(p, x, lengths, seed, rate, nhead, od, attn, lse, g,
                     relu_on=None, origin=None):
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
    origin = drop_origin(origin, B, nhead)
    keeps = _site_keeps(seed, rate, B, T, d, ffn, x.device, origin[0])
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
                                      rate, nhead, od, lse, scale, origin)
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
    def forward(ctx, x, lengths, seed, dropout_rate, compute_dtype, nhead, origin,
                *ws):
        origin = drop_origin(origin, x.shape[0], nhead)
        out, attn, lse = _fused_fwd(_unflatten(ws), x, lengths, seed,
                                    dropout_rate, compute_dtype, nhead, origin)
        ctx.save_for_backward(x, lengths, attn, lse, *ws)
        ctx.args = (_seed_int(seed), float(dropout_rate), nhead,
                    operand_dtype(compute_dtype), origin)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, lengths, attn, lse, *ws = ctx.saved_tensors
        seed, rate, nhead, od, origin = ctx.args
        if g.is_cuda:
            dx, dws = _fused_bwd_cuda(ws, x, lengths, seed, rate, nhead, od,
                                      attn, lse, g, origin=origin)
        else:
            dx, dws = _fused_bwd_plain(_unflatten(ws), x, lengths, seed, rate,
                                       nhead, od, attn, lse, g, origin=origin)
        dws = [dw.to(w.dtype) for dw, w in zip(dws, ws)]
        return (dx.to(x.dtype), None, None, None, None, None, None, *dws)


def fused_encoder_layer(p, x, lengths, seed=None, dropout_rate=0.0,
                        compute_dtype=None, nhead=1, origin=None) -> torch.Tensor:
    """One post-LN encoder layer. x [B, T, d]; lengths [B]; `seed` the
    int32 seed of the four dropout masks (None means 0); `origin`
    (b0, 0, nhead) for rows b0.. of a larger batch (None: b0 = 0). Returns
    out [B, T, d] in x's dtype; differentiable in x and the layer's
    weights."""
    return _FusedLayer.apply(x, lengths, seed, dropout_rate, compute_dtype,
                             nhead, origin, *_flatten(p))


# forward calls that launched the kernels; `bwd_launches` counts backwards;
# the tc_ counts those of the two on the tensor-core route, the tc_wide_
# counts those whose attention ran on two warpgroups (past hd_pad 144), the
# stream_ counts those on the "stream" route, the tc_cluster_ counts those
# whose attention ran past hd 368 on the tensor cores and the hd_stream_
# counts those whose attention ran past it on the scalar kernels
fused_encoder_layer.launches = 0
fused_encoder_layer.bwd_launches = 0
fused_encoder_layer.tc_launches = 0
fused_encoder_layer.tc_bwd_launches = 0
fused_encoder_layer.tc_wide_launches = 0
fused_encoder_layer.tc_wide_bwd_launches = 0
fused_encoder_layer.stream_launches = 0
fused_encoder_layer.stream_bwd_launches = 0
fused_encoder_layer.tc_cluster_launches = 0
fused_encoder_layer.tc_cluster_bwd_launches = 0
fused_encoder_layer.hd_stream_launches = 0
fused_encoder_layer.hd_stream_bwd_launches = 0


SMEM = 232448             # shared bytes a block may use on sm_90
# The fused layer's launches, in the order of the plan
# (csrc/fused_plan.cuh): the qkv projection, the attention forward, the
# forward's row-local tail, the backward's row kernel, dq, dk/dv, dx and
# the weight gradients. On the "stream" route "qkv" is every product of the
# forward and "dx" every product of the backward (one kernel, each call its
# own weight), "tail" and "bwd_rows" the row kernels (LayerNorms, dropout
# sites, relu, delta, column sums) of either direction.
LAUNCHES = ("qkv", "attn_fwd", "tail", "bwd_rows", "attn_dq", "attn_dkv",
            "dx", "wgrad")
# rows of [B*T] one CTA of the weight-gradient kernel sums; the split is a
# function of the shape alone, so the result is the same bits every run
WGRAD_CHUNK = 512
# rows per CTA of the scalar qkv projection, row-local backward and dx
# kernels (BR in csrc/fused_rows.cuh); 64 on the tensor cores
BWD_ROWS = 32
_TC_ROWS = 64                  # rows of a tensor-core tile (wgmma M)
_TC_THREADS = 256              # two warpgroups a CTA (rows_tc.cuh NTH)
_RING = 2 * 2 * 64 * 64 * 2    # two steps of two 64 x 64 bf16 weight panels
_STAGE = 64 * 132 * 4          # a step's two 64-column chunks, f32, staged
_WGRAD = 2 * 2 * 64 * 64 * 2   # two stages of a G^T and an A^T tile (one warpgroup)
_WIDE_KEYS = 32                # rows of a streamed tile on "tc_wide"
# The "stream" route (csrc/rows_stream.cuh): a tensor-core product's two
# [64, 64] bf16 chunks of A and the weight ring; a scalar product's 16-deep
# steps of a 64 x 64 A and weight tile; a row kernel's rows (a warp each)
STREAM_TC_SMEM = 2 * 64 * 64 * 2 + _RING
STREAM_SCALAR_SMEM = 2 * 16 * 64 * 4
STREAM_ROW_WARPS = 8
# the route past hd 368's shared bytes, forward, dq, dk/dv
# (csrc/attention_hd_stream.cuh)
_HD_STREAM_SMEM = (45568, 54016, 91392)


@dataclass(frozen=True)
class FusedLaunch:
    """One launch of the plan: its route ("tc", "tc_wide" for the attention
    on two warpgroups past hd_pad 144, "scalar", "stream" for the row
    products and row kernels at any width, "tc_cluster" for the attention
    past hd 368 in bf16, "hd_stream" for it in f32), the rows of a CTA's
    tile (the output tile's rows for the weight gradients, the rows of a
    row kernel's CTA), the copy width in
    bytes (16 for the tensor cores' weight panels, the attention tiles'
    width on its tensor-core routes, the operand size on the scalar ones),
    the threads of a CTA and its shared bytes."""

    route: str
    rows: int
    copy_bytes: int
    threads: int
    smem: int


@dataclass(frozen=True)
class FusedPlan:
    """What surrounds the fused layer's launches at one width, computed on
    the host and checked field for field by both C entry points
    (csrc/fused_plan.cuh `Plan`). `route` is the row products' (qkv, tail,
    backward rows, dx, weight gradients), `attn_route` the attention's;
    `launches` follow LAUNCHES."""

    route: str
    attn_route: str
    launches: tuple

    def __getitem__(self, name) -> FusedLaunch:
        return self.launches[LAUNCHES.index(name)]

    @functools.cached_property
    def as_ints(self):
        """The plan as the C entry points take it: 5 ints a launch, the
        route 0 (scalar), 1 (tc), 2 (tc_wide), 3 (hd_stream), 4 (stream)
        or 5 (tc_cluster); KeyError for another."""
        vals = [v for l in self.launches
                for v in (_ROUTES[l.route], l.rows, l.copy_bytes, l.threads, l.smem)]
        return (ctypes.c_int * len(vals))(*vals)


def _pad(x, m):
    return -(-x // m) * m


def _tile(k):          # a [64, k] bf16 operand tile, k padded to 64
    return _TC_ROWS * _pad(k, 64) * 2


def _f32_rows(n):      # a [64, n] f32 row buffer
    return _pad(_TC_ROWS * n * 4, 128)


def _scalar_attn(hd, es):
    """The scalar attention's three launches (Narrow geometry up to hd
    NARROW_MAX_HD, Wide beyond): attention.cuh attn_smem_floats and
    attention_bwd.cuh attn_dq/dkv_smem_floats."""
    r = k = 64 if hd <= NARROW_MAX_HD else 32
    return (FusedLaunch("scalar", r, es, 256, ((r + 2 * k) * (hd + 1) + r * (k + 1)) * 4),
            FusedLaunch("scalar", r, es, 256, (2 * (r + k) * (hd + 1) + r * (k + 1)) * 4),
            FusedLaunch("scalar", r, es, 256,
                        (2 * (r + k) * (hd + 1) + 2 * r * (k + 1) + 2 * k) * 4))


def _tc_attn(hd, copy):
    """The tensor-core attention's three launches: one warpgroup up to
    hd_pad TC_MAX_HD_PAD, two past it."""
    hdk = _pad(hd, 16)
    if hdk <= TC_MAX_HD_PAD:
        tile = 64 * hdk * 2
        return (FusedLaunch("tc", 64, copy, 128, 5 * tile),
                FusedLaunch("tc", 64, copy, 128, 6 * tile),
                FusedLaunch("tc", 64, copy, 128, 6 * tile + 2 * 2 * 64 * 4))
    # two warpgroups: 64-row tiles of the own side (Q; Q and dO; K and V),
    # a two-stage ring of 32-row tiles of the streamed side, and in the
    # dk/dv pass two stages of 32 lse and delta floats
    # (csrc/attention_tc_wide.cuh wide_*_smem_bytes)
    own, streamed = 64 * wide_pad(hd) * 2, _WIDE_KEYS * wide_pad(hd) * 2
    return (FusedLaunch("tc_wide", 64, copy, 256, own + 4 * streamed),
            FusedLaunch("tc_wide", 64, copy, 256, 2 * own + 4 * streamed),
            FusedLaunch("tc_wide", 64, copy, 256,
                        2 * own + 4 * streamed + 2 * 2 * _WIDE_KEYS * 4))


def _scalar_wgrad(es):
    return FusedLaunch("scalar", 64, es, 256, 2 * 16 * 64 * 4)


def _launches(d, ffn, nhead, es, tc, copy):
    """The eight launches of a route, or None where one would not fit."""
    hd = d // nhead
    if tc:
        th = _TC_THREADS
        rows = (FusedLaunch("tc", 64, 16, th, _tile(d) + _RING + _STAGE),
                FusedLaunch("tc", 64, 16, th,
                            _f32_rows(d) + _tile(d) + _tile(ffn) + _RING),
                FusedLaunch("tc", 64, 16, th, _f32_rows(d) + _tile(d) + _tile(ffn)
                            + _f32_rows(ffn) + _RING + 4 * 64 * 4),
                FusedLaunch("tc", 64, 16, th, _tile(3 * d) + _RING + _STAGE),
                FusedLaunch("tc", 64, 16, 128, _WGRAD))
    else:
        rows = (FusedLaunch("scalar", BWD_ROWS, es, 256, BWD_ROWS * (d + 1) * 4),
                FusedLaunch("scalar", 64, es, 256, (2 * 64 * (d + 1) + 64 * (ffn + 1)) * 4),
                FusedLaunch("scalar", BWD_ROWS, es, 256, (BWD_ROWS * max(d + 1, ffn + 1)
                                                           + 4 * BWD_ROWS * (d + 1)
                                                           + 2 * BWD_ROWS) * 4),
                FusedLaunch("scalar", BWD_ROWS, es, 256, BWD_ROWS * (3 * d + 1) * 4),
                _scalar_wgrad(es))
    attn = _tc_attn(hd, copy) if tc else _scalar_attn(hd, es)
    qkv, tail, bwd_rows, dx, wgrad = rows
    launches = (qkv, attn[0], tail, bwd_rows, attn[1], attn[2], dx, wgrad)
    if max(l.smem for l in launches) > SMEM:
        return None
    return launches


def _stream_launches(d, ffn, nhead, es, copy):
    """The eight launches of the "stream" route, whose shared bytes do not
    grow with d or ffn: the products (bf16 on the tensor cores, f32
    scalar) and the row kernels; the weight gradients on the kernels of the
    other routes (fixed tiles); the attention up to hd MAX_HEAD_DIM in bf16
    on "tc" or "tc_wide" (as the packed pair's, two warpgroups past hd_pad
    144), in f32 on the scalar kernels; past it in bf16 on "tc_cluster" (to
    hd TC_CLUSTER_MAX_HD, the packed pair's kernels on the qkv rows) and in
    f32 (and bf16 past that) on "hd_stream"."""
    hd = d // nhead
    bf = es == 2
    if bf:
        prod = FusedLaunch("stream", _TC_ROWS, 16, _TC_THREADS, STREAM_TC_SMEM)
        wgrad = FusedLaunch("tc", 64, 16, 128, _WGRAD)
    else:
        prod = FusedLaunch("stream", 64, es, 256, STREAM_SCALAR_SMEM)
        wgrad = _scalar_wgrad(es)
    rows = FusedLaunch("stream", STREAM_ROW_WARPS, 4, 256, 0)
    if bf and hd <= MAX_HEAD_DIM:
        attn = _tc_attn(hd, copy)
    elif bf and hd <= TC_CLUSTER_MAX_HD:
        attn = tuple(FusedLaunch("tc_cluster", 64, copy, th, b) for th, b in
                     zip((128, 128, 256), tc_cluster_smem(tc_cluster_size(hd)[1])))
    elif hd <= MAX_HEAD_DIM:
        attn = _scalar_attn(hd, es)
    else:
        attn = tuple(FusedLaunch("hd_stream", HD_STREAM_ROWS, es, 256, b)
                     for b in _HD_STREAM_SMEM)
    return (prod, attn[0], rows, rows, attn[1], attn[2], prod, wgrad)


@functools.lru_cache(maxsize=256)
def fused_plan(d, ffn, nhead, od, impl="auto", align=16) -> FusedPlan:
    """The launch plan of the fused layer's kernels at one width for
    operands of dtype `od` on the card. bf16 takes the tensor-core route
    wherever its tiles fit a block and the head dim is at most
    NARROW_MAX_HD (PAM's d = 84 and its sensor-wise 340 among them): every
    row product on the tensor cores, the attention on one warpgroup ("tc")
    up to a padded head dim of TC_MAX_HD_PAD and on two ("tc_wide",
    padded to 176 or 208) past it, PAM-sw's hd 170 among them. f32 and
    other bf16 widths take the scalar route (every product scalar FMA)
    where its tiles fit; impl="scalar" asks for the scalar kernels in bf16
    too (the previous design, for measurement). Every width neither takes
    (P12-sw at d = 720, P19-sw at 680, any head past MAX_HEAD_DIM) runs
    the "stream" route (`_stream_launches`), whose shared bytes do not
    grow with the width (its attention past MAX_HEAD_DIM on "tc_cluster"
    in bf16, "hd_stream" in f32); impl="stream" forces it at any width.
    `align` is the alignment in bytes of the qkv and d_attn buffers: with the head's
    offset in a row (2 hd bytes) and the row strides (6 d and 2 d) it
    bounds the tensor-core attention's copy width, 16, 8, 4 or 2 bytes
    (PAM, hd 42, and PAM-sw, hd 170: 4). Raises ValueError only where d
    is not divisible by nhead, or ffn or nhead is below 1."""
    if impl not in ("auto", "scalar", "stream"):
        raise ValueError(f"impl must be 'auto', 'scalar' or 'stream', got {impl!r}")
    if nhead <= 0 or d % nhead or ffn <= 0:
        raise ValueError(f"d={d} not divisible by nhead={nhead}, or ffn={ffn} < 1")
    hd = d // nhead
    es = od.itemsize
    copy = 16
    while copy > 2 and ((2 * hd) % copy or (2 * d) % copy or align % copy):
        copy //= 2
    if impl != "stream" and hd <= MAX_HEAD_DIM:
        if od == torch.bfloat16 and impl == "auto" and hd <= NARROW_MAX_HD:
            launches = _launches(d, ffn, nhead, es, True, copy)
            if launches is not None:
                return FusedPlan("tc", launches[1].route, launches)
        launches = _launches(d, ffn, nhead, es, False, es)
        if launches is not None:
            return FusedPlan("scalar", "scalar", launches)
    launches = _stream_launches(d, ffn, nhead, es, copy)
    return FusedPlan("stream", launches[1].route, launches)


def c_plan(d, ffn, nhead, od, route, copy_bytes):
    """(the C library's plan ints for a route, "scalar", "tc" or "stream",
    whether it takes the width): rd_fused_plan in csrc/fused_encoder.cu,
    which both entry points check FusedPlan.as_ints against (it builds the
    kernels: on the card only)."""
    out = (ctypes.c_int * (5 * len(LAUNCHES)))()
    err = _lib().rd_fused_plan(d, ffn, nhead, int(od == torch.bfloat16),
                               _ROUTES[route], copy_bytes, out)
    return tuple(out), err == 0


def fused_smem(d, ffn, nhead, od=torch.float32, route="scalar", copy_bytes=None):
    """({launch: shared bytes}, whether the route takes the width), as the C
    library computes its plan; copy_bytes: the tensor-core attention's copy
    width (the operand size by default)."""
    ints, ok = c_plan(d, ffn, nhead, od, route,
                      od.itemsize if copy_bytes is None else copy_bytes)
    return dict(zip(LAUNCHES, ints[4::5])), ok


def _packed_elems(d, ffn, n):
    """bf16 elements of the first n packed weights (csrc/fused_plan.cuh
    packed_layout): the forward's four, the backward's eight."""
    shapes = ((3 * d, d), (d, d), (ffn, d), (d, ffn), (ffn, d), (d, ffn), (d, d),
              (d, 3 * d))
    return sum(_pad(N, 128) * _pad(K, 64) for N, K in shapes[:n])


def _count(plan, attr):
    """One launch on `attr` and, on the tensor-core route, on tc_<attr>
    (and on tc_wide_<attr> where the attention ran on two warpgroups); on
    the "stream" route on stream_<attr> (and on tc_cluster_<attr> or
    hd_stream_<attr> where the attention ran past hd 368)."""
    build.count_launch(fused_encoder_layer, attr)
    if plan.route in ("tc", "stream"):
        build.count_launch(fused_encoder_layer, f"{plan.route}_{attr}")
    if plan.attn_route in ("tc_wide", "tc_cluster", "hd_stream"):
        build.count_launch(fused_encoder_layer, f"{plan.attn_route}_{attr}")


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


def _qkv_dtype(plan):
    """The dtype of the qkv (and the attention's d_attn) buffer: bf16 where
    the attention runs on the tensor cores ("tc", "tc_wide", "tc_cluster"),
    f32 (each value rounded to the operand dtype) on the scalar kernels and
    "hd_stream"."""
    return (torch.bfloat16 if plan.attn_route in ("tc", "tc_wide", "tc_cluster")
            else torch.float32)


def _packs(plan, od):
    """Whether the route runs the row products on the tensor cores, which
    stream the weights as packed bf16 panels."""
    return plan.route == "tc" or (plan.route == "stream" and od == torch.bfloat16)


def _fused_fwd_cuda(ws, x, lengths, seed, rate, nhead, od, impl="auto", origin=None):
    """The forward kernels of the plan's route. `impl="scalar"` reaches the
    scalar kernels with bf16 operands (the previous design, measured beside
    the tensor-core one), `impl="stream"` the "stream" route at any width;
    the model never passes either."""
    B, T, d = x.shape
    dev = x.device
    ws, xf, lens, ffn = _prepare(ws, x, lengths)
    b0, h0, heads = drop_origin(origin, B, nhead)
    route = fused_plan(d, ffn, nhead, od, impl)
    wpack = (torch.empty((_packed_elems(d, ffn, 4),), dtype=torch.bfloat16, device=dev)
             if _packs(route, od) else None)
    out = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    attn = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    lse = torch.empty((B, nhead, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, c1 in batch_chunks(B):
        qkv = torch.empty((c1 - c0, T, 3 * d), dtype=_qkv_dtype(route), device=dev)
        # the "stream" route's x1 [M, d] and FFN hidden [M, ffn] rows
        rows = (torch.empty(((c1 - c0) * T * (d + ffn),), dtype=torch.float32, device=dev)
                if route.route == "stream" else None)
        plan = fused_plan(d, ffn, nhead, od, impl, _align(qkv.data_ptr()))
        err = _lib().rd_fused_layer_fwd(
            xf[c0:c1].data_ptr(), *(w.data_ptr() for w in ws), lens[c0:c1].data_ptr(),
            qkv.data_ptr(), out[c0:c1].data_ptr(), attn[c0:c1].data_ptr(),
            lse[c0:c1].data_ptr(), 0 if wpack is None else wpack.data_ptr(),
            0 if rows is None else rows.data_ptr(),
            c1 - c0, T, d, ffn, nhead, (1.0 / math.sqrt(d // nhead)) * LOG2E,
            int(od == torch.bfloat16), seed, rate, b0 + c0, h0, heads,
            plan.as_ints, stream)
        build.check(err, "fused_encoder_layer forward")
        _count(plan, "launches")
    build.credit(layer_flops(B, T, d, ffn))
    return out, attn, lse


# what the backward keeps in device memory between its launches, in the
# order the C entry point takes it; on the tensor-core route the first
# seven are bf16 where a product alone reads them (qkv, x1, f, df2, dfpre,
# dao, d_attn) and h1 and the packed weights join; the "stream" route's
# rows are f32 (its products read A in f32), with xhat1 and xhat2, both
# LayerNorms' 1/std, dh2, dx1 and, where its attention runs on the tensor
# cores, a bf16 copy of d_attn
_SCRATCH = ("qkv", "x1", "f", "df2", "dfpre", "dao", "d_attn", "dh1", "dqkv",
            "delta", "row_partials", "wgrad_partials", "h1", "wpack", "xhat1",
            "xhat2", "rstd", "dh2", "dx1", "d_attn_op")


def bwd_scratch(B, T, d, ffn, nhead, plan=None):
    """{buffer: (elements, dtype)} of what the backward keeps in device
    memory between its launches on the plan's route (the scalar route's
    f32 buffers when plan is None)."""
    M = B * T
    chunks = -(-M // WGRAD_CHUNK)
    f32 = torch.float32
    if plan is not None and plan.route == "stream":
        out = {name: (M * d, f32) for name in ("x1", "df2", "dao", "d_attn", "dh1",
                                                "xhat1", "xhat2", "dh2", "dx1")}
        q = _qkv_dtype(plan)
        # the column sums' partials share the weight gradients' buffer
        out.update({"qkv": (M * 3 * d, q), "f": (M * ffn, f32), "dfpre": (M * ffn, f32),
                    "dqkv": (M * 3 * d, f32), "delta": (B * nhead * T, f32),
                    "wgrad_partials": (chunks * max(3 * d * d, d * ffn), f32),
                    "rstd": (2 * M, f32)})
        if q == torch.bfloat16:
            out["d_attn_op"] = (M * d, q)
        if plan["qkv"].copy_bytes == 16:      # the products on the tensor cores
            out["wpack"] = (_packed_elems(d, ffn, 8), torch.bfloat16)
        return out
    tc = plan is not None and plan.route == "tc"
    rows = _TC_ROWS if tc else BWD_ROWS
    blocks = B * (-(-T // rows))
    op = torch.bfloat16 if tc else torch.float32
    out = {
        "qkv": (M * 3 * d, op), "x1": (M * d, op), "f": (M * ffn, op),
        "df2": (M * d, op), "dfpre": (M * ffn, op), "dao": (M * d, op),
        "d_attn": (M * d, op), "dh1": (M * d, f32), "dqkv": (M * 3 * d, f32),
        "delta": (B * nhead * T, f32), "row_partials": (blocks * (9 * d + ffn), f32),
        "wgrad_partials": (chunks * max(3 * d * d, d * ffn), f32),
    }
    if tc:
        out["h1"] = (M * d, f32)
        out["wpack"] = (_packed_elems(d, ffn, 8), torch.bfloat16)
    return out


def bwd_scratch_floats(B, T, d, ffn, nhead, plan=None):
    """Per-buffer sizes of `bwd_scratch` in 4-byte floats (what PERF.md
    lists)."""
    return {k: -(-n * dt.itemsize // 4)
            for k, (n, dt) in bwd_scratch(B, T, d, ffn, nhead, plan).items()}


def _fused_bwd_cuda(ws, x, lengths, seed, rate, nhead, od, attn, lse, g,
                    scratch_out=None, impl="auto", origin=None):
    """dx and the 12 weight gradients through the backward kernels of the
    plan's route; every intermediate buffer is allocated here and listed by
    `bwd_scratch`. A dict passed as `scratch_out` receives those buffers
    (flat, in their dtypes), for a check that wants to look at them (where
    the call is split, batch_chunks, each buffer of the launches
    concatenated in order). `impl` as in `_fused_fwd_cuda`."""
    B, T, d = x.shape
    dev = x.device
    if g.shape != x.shape:
        raise ValueError(f"the incoming gradient is {tuple(g.shape)}, "
                         f"expected {tuple(x.shape)}")
    for name, t in (("attn", attn), ("lse", lse), ("g", g)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    ws, xf, lens, ffn = _prepare(ws, x, lengths)
    b0, h0, heads = drop_origin(origin, B, nhead)
    route = fused_plan(d, ffn, nhead, od, impl)
    gf = g.detach().to(torch.float32).contiguous()
    attn, lse = attn.contiguous(), lse.contiguous()
    dx = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    # the weight gradients, and the bias and LayerNorm gradients in one
    # buffer: [dg2, dbe2, dbf2, dbf1 (ffn), dg1, dbe1, dbo, db_in (3d)]
    wgrads = [torch.empty(ws[i].shape, dtype=torch.float32, device=dev)
              for i in (0, 2, 6, 8)] + [torch.empty((9 * d + ffn,), dtype=torch.float32,
                                                    device=dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    kept = []
    for c0, c1 in batch_chunks(B):
        sizes = bwd_scratch(c1 - c0, T, d, ffn, nhead, route)
        scratch = {k: torch.empty((n,), dtype=dt, device=dev) for k, (n, dt) in sizes.items()}
        plan = fused_plan(d, ffn, nhead, od, impl, _align(*(
            scratch[k].data_ptr() for k in ("qkv", "d_attn", "d_attn_op") if k in scratch)))
        # a split call sums its launches' weight gradients
        part = wgrads if c0 == 0 else [torch.empty_like(w) for w in wgrads]
        err = _lib_bwd().rd_fused_layer_bwd(
            xf[c0:c1].data_ptr(), *(w.data_ptr() for w in ws), lens[c0:c1].data_ptr(),
            attn[c0:c1].data_ptr(), lse[c0:c1].data_ptr(), gf[c0:c1].data_ptr(),
            *(scratch[k].data_ptr() if k in scratch else 0 for k in _SCRATCH),
            dx[c0:c1].data_ptr(), *(w.data_ptr() for w in part), c1 - c0, T, d, ffn,
            nhead, WGRAD_CHUNK, 1.0 / math.sqrt(d // nhead), int(od == torch.bfloat16),
            seed, rate, b0 + c0, h0, heads, plan.as_ints, stream)
        build.check(err, "fused_encoder_layer backward")
        _count(plan, "bwd_launches")
        if c0:
            for w, dw in zip(wgrads, part):
                w += dw
        if scratch_out is not None:
            kept.append(scratch)
    build.credit(2 * layer_flops(B, T, d, ffn))
    if scratch_out is not None:
        scratch_out.update({k: torch.cat([sc[k] for sc in kept]) for k in kept[0]})
    dw_in, dwo, dw1, dw2, vec = wgrads
    dg2, dbe2, dbf2, dbf1, dg1, dbe1, dbo, db_in = vec.split(
        [d, d, d, ffn, d, d, d, 3 * d])
    return dx, [dw_in, db_in, dwo, dbo, dg1, dbe1, dw1, dbf1, dw2, dbf2, dg2,
                dbe2]


_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_double,
         ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


def _lib():
    lib = build.load("fused_encoder")
    fn = lib.rd_fused_layer_fwd
    if fn.argtypes is None:
        # x, 12 weights, lengths, qkv, out, attn, lse, packed weights, the
        # "stream" route's rows; B, T, d, ffn, nhead
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + _TAIL
        fn.restype = ctypes.c_int
        lib.rd_fused_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.rd_fused_plan.restype = ctypes.c_int
    return lib


def _lib_bwd():
    lib = build.load("fused_encoder_bwd")
    fn = lib.rd_fused_layer_bwd
    if fn.argtypes is None:
        # x, 12 weights, lengths, attn, lse, g; 20 scratch; dx, 4 weight
        # gradients, vec; B, T, d, ffn, nhead, chunk
        fn.argtypes = [ctypes.c_void_p] * 43 + [ctypes.c_int] * 6 + _TAIL
        fn.restype = ctypes.c_int
    return lib
