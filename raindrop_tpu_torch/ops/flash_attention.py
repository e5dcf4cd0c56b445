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
takes the undropped probabilities; only the PV operand is dropped. A
launch over a block of a larger batch or of more heads (a rank's shard,
parallel/mesh.py) passes `origin` = (b0, h0, H): its sample b and head h
then hash as (b0 + b) * H + h0 + h, the bits of the full launch, whose
default is (0, 0, nhead).

Both are `torch.autograd.Function`s. On CUDA tensors their forward and
backward launch the hand-written kernels in `csrc/flash_packed.cu` and
`csrc/flash_split.cu` (or raise), each on the route of its launch plan
(`packed_plan`, `split_plan`): for bf16 operands the tensor-core kernels
on one warpgroup up to a padded head dim of 144 and on two past it (up to
368, the sensor-wise P12's 360), the scalar ones for f32; past head dim
368 for bf16 the tensor-core route "tc_cluster" (csrc/attention_tc_cluster.cuh:
a cluster of ceil(hd / 256) CTAs a block of rows, each owning a slice of
the head's columns, their partial scores summed in distributed shared
memory; up to hd 2048, the sensor-wise P12's 720 at one head), and for f32
(and bf16 past 2048) the "hd_stream" kernels (csrc/attention_hd_stream.cuh:
the head dim streamed in chunks, the output's columns split over CTAs,
shared memory that does not grow with it). `flash_mha` casts f32 operands
into heads zero-padded to a multiple of 8 columns (`_padded_cast`), so its
tensor-core copies move 16 bytes at hd 42 and 170. A call over more than
MAX_BATCH samples (or, for `flash_mha`, heads) is split into launches of
at most that many, each at its sample and head origin, so its dropout
masks are the whole call's (`batch_chunks`). On CPU tensors they run
`_packed_fwd_plain` / `_packed_bwd_plain` and `_flash_fwd_plain` /
`_flash_bwd_plain`, the same functions in plain PyTorch, which the CPU
tests hold against the JAX package and `chip_smoke.py` holds the kernels
against on the card.

The JAX `flash_mha` has two regimes, one program per head while a [T, T]
score tile fits the TPU's VMEM (T padded to 8 <= 1024) and 128-row blocks
with an online softmax beyond. No [T, T] tile fits an SM's shared memory
at any T the model uses, so here one set of kernels (forward, dq, dk+dv)
streams key tiles at every T (on the scalar route 64 rows up to hd
NARROW_MAX_HD, 32 beyond).
Both regimes hash the dropout mask from the global (row, column), so one
mask function serves both as well.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.utils.dropout import M32, _mul32, finalize32, threshold32

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# The largest T (padded to 8) the JAX package's packed kernel takes; the
# port's encoder ladder keeps it (nn/transformer.py): beyond it the model
# runs the split-head flash_mha.
MAX_FUSED_T = 1024
# The launch plan's routing limits, the widths the kernels are instantiated
# for (the C entry points refuse a plan past them; the shared memory of
# each launch is theirs to compute, `packed_smem`, `split_smem`). The
# largest head dim of the scalar and tensor-core kernels (csrc/attention.cuh
# SCALAR_MAX_HD, the Wide geometry; the fused layer's attention stops
# there): past it bf16 takes the "tc_cluster" route and f32 "hd_stream".
# The widest preset head is P12-sw's 360; P12-sw at one head is 720.
MAX_HEAD_DIM = 368
# The scalar kernels' Narrow geometry (64-row blocks and tiles) up to this
# head dim (attention.cuh NARROW_MAX_HD); the Wide one (32) beyond.
NARROW_MAX_HD = 192
# The widest padded head dim of the one-warpgroup tensor-core kernels
# (csrc/flash_packed.cuh TC_MAX_HD_PAD, which the fused layer's attention
# shares): eICU's sensor-wise hd 140.
TC_MAX_HD_PAD = 144
# The two-warpgroup tensor-core kernels past it ("tc_wide",
# csrc/attention_tc_wide.cuh): bf16 heads padded to 176, 208, ..., 368
# (hd 145-176 to 176; P12's sensor-wise 360 to 368).
TC_WIDE_MIN_HD_PAD, TC_WIDE_STEP, TC_WIDE_MAX_HD_PAD = 176, 32, 368
# The scalar route past MAX_HEAD_DIM (csrc/attention_hd_stream.cuh): 32-row
# blocks, each CTA owning HD_STREAM_SLICE columns of the outputs
HD_STREAM_ROWS, HD_STREAM_SLICE = 32, 256
# The tensor-core route past MAX_HEAD_DIM for bf16 ("tc_cluster",
# csrc/attention_tc_cluster.cuh): a cluster of ceil(hd / 256) CTAs a block
# of 64 rows, each owning W columns of the head (the share rounded up to
# 32: 192, 224 or 256), 32-row streamed tiles; to hd TC_CLUSTER_MAX_HD (8
# CTAs, the portable cluster size); bf16 past it stays on "hd_stream"
TC_CLUSTER_SLICE, TC_CLUSTER_KEYS, TC_CLUSTER_MAX_HD = 256, 32, 2048
# the routes' ints in the C entry points' plans; 4 ("stream") is the fused
# layer's row products at any width (ops/fused_encoder.py fused_plan)
_ROUTES = {"scalar": 0, "tc": 1, "tc_wide": 2, "hd_stream": 3, "stream": 4,
           "tc_cluster": 5}
_ROWS = 64              # rows of a CTA's block (and of a streamed tile on "tc")
# samples and heads a launch puts on the kernels' grid (its z and y axes): a
# larger call is split into launches of at most this many (batch_chunks)
MAX_BATCH = 65535
# the hashed (sample, head) index b * heads + h is a uint32, as in the JAX
# package: a call's origin places its samples and heads below this
HASH_SPAN = 2 ** 32


def operand_dtype(compute_dtype) -> torch.dtype:
    """Operand dtype of the attention products: f32 or bf16."""
    if compute_dtype in (None, "float32"):
        return torch.float32
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported flash compute_dtype {compute_dtype}")


def attention_flops(B: int, T: int, d: int) -> int:
    """Model FLOPs of one attention forward over B samples of T steps and
    width d (all heads): q k^T and p v, 2 a multiply-add, over every key
    position (the plain version's work). The kernels credit it for a
    forward and twice it for a backward (dq, dk, dp, dv; the backward's
    recompute of the scores is not credited, the MFU convention)."""
    return 4 * B * T * T * d


def pad8(T: int) -> int:
    """T padded to a multiple of 8: the row count the JAX kernels hash
    their site masks with."""
    return -(-T // 8) * 8


@dataclass(frozen=True)
class PackedPlan:
    """What surrounds a flash_mha_packed launch, computed on the host and
    checked by the C entry points (csrc/flash_packed.cu `Plan`), which add
    each kernel's shared memory (`packed_smem`).

    route: "tc" (tensor cores, bf16 operands, one warpgroup a CTA),
    "tc_wide" (the same past hd_pad 144 on two warpgroups, each owning
    half of the output's columns), "tc_cluster" (the same past hd
    MAX_HEAD_DIM on a cluster of CTAs, each owning W columns), "scalar"
    (f32 FMA) or "hd_stream" (f32 FMA past hd MAX_HEAD_DIM, f32 operands
    and bf16 on request: a CTA a 32-row block and HD_STREAM_SLICE columns
    of the output);
    hd_pad: the head dim padded to 16 ("tc") or to 176 + 32 j
    ("tc_wide"), the K depth of the score products and the N width of the
    output products (each warpgroup's half of it on "tc_wide"), the
    cluster's columns n W on "tc_cluster", hd itself on the scalar and
    "hd_stream" routes; copy_bytes: the width of one tile copy; rows: the
    rows of a CTA's block (64; 32 in the scalar kernels' Wide geometry,
    past hd 192, and on "hd_stream"); threads: the forward's, dq's and
    dk/dv's block sizes; grid: (query or key blocks, heads, samples), on
    "hd_stream" and "tc_cluster" the blocks times the column slices along
    x; the dk/dv pass on "tc" and "tc_wide" runs two CTAs a key block (dv
    and dk), 2 * grid[0] along x."""

    route: str
    hd: int
    hd_pad: int
    copy_bytes: int
    rows: int
    threads: tuple
    grid: tuple

    @property
    def dkv_grid(self):
        """The dk/dv pass's grid: two CTAs a key block on "tc" and
        "tc_wide" (dv and dk), one on the others ("tc_cluster" holds both
        on two warpgroups)."""
        if self.route in ("scalar", "hd_stream", "tc_cluster"):
            return self.grid
        return (2 * self.grid[0], *self.grid[1:])

    def _ints(self):
        return (_ROUTES[self.route], self.hd_pad, self.copy_bytes, self.rows,
                *self.threads, *self.grid)

    @functools.cached_property
    def as_ints(self):
        """The plan as the C entry points take it: 10 ints (11 for a
        SplitPlan)."""
        vals = self._ints()
        return (ctypes.c_int * len(vals))(*vals)


def _align(*ptrs) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    while a > 1 and any(p % a for p in ptrs):
        a //= 2
    return a


def scalar_rows(hd):
    """Rows of a CTA's block and of a streamed tile in the scalar kernels:
    64 (the Narrow geometry) up to hd NARROW_MAX_HD, 32 (Wide) beyond."""
    return _ROWS if hd <= NARROW_MAX_HD else _ROWS // 2


def hd_stream_grid_x(T, hd):
    """The "hd_stream" route's grid along x: 32-row blocks times the
    slices of HD_STREAM_SLICE columns."""
    return -(-T // HD_STREAM_ROWS) * -(-hd // HD_STREAM_SLICE)


def tc_cluster_size(hd):
    """The CTAs of a "tc_cluster" cluster at head dim hd and the columns W
    each owns (csrc/attention_tc_cluster.cuh cluster_size, slice_cols)."""
    n = -(-hd // TC_CLUSTER_SLICE)
    return n, -(-(-(-hd // n)) // 32) * 32


def tc_cluster_smem(W):
    """Shared bytes of the "tc_cluster" forward, dq and dk/dv kernels at W
    columns a CTA (csrc/attention_tc_cluster.cuh *_smem_bytes): the own
    64-row tiles, a two-stage ring of 32-row tiles, two buffers of f32
    partial score tiles [64, 32] (one forward, S and dP backward), and in
    the dk/dv pass two stages of 32 lse and delta floats."""
    own, streamed, part = 64 * W * 2, TC_CLUSTER_KEYS * W * 2, 64 * TC_CLUSTER_KEYS * 4
    ring = 4 * streamed
    dq = 2 * own + ring + 4 * part
    return own + ring + 2 * part, dq, dq + 2 * 2 * TC_CLUSTER_KEYS * 4


def _tc_cluster_plan(hd, T, heads, B):
    """(hd_pad, threads, grid) of the "tc_cluster" route."""
    n, W = tc_cluster_size(hd)
    return n * W, (128, 128, 256), (-(-T // _ROWS) * n, heads, B)


def _check_impl(impl):
    if impl not in ("auto", "scalar", "hd_stream"):
        raise ValueError(f"impl must be 'auto', 'scalar' or 'hd_stream', got {impl!r}")


@functools.lru_cache(maxsize=256)
def packed_plan(B, T, d, nhead, od, impl="auto", align=16) -> PackedPlan:
    """The launch plan of flash_mha_packed's kernels for [B, T, d] operands
    of dtype `od` on the card: bf16 takes the tensor-core route "tc" while
    the head dim padded to 16 is at most TC_MAX_HD_PAD and "tc_wide" past
    it; f32 (TF32 would miss its 1e-4) takes the scalar one, in the Narrow
    geometry up to hd NARROW_MAX_HD and the Wide one beyond; past hd
    MAX_HEAD_DIM bf16 takes "tc_cluster" up to hd TC_CLUSTER_MAX_HD and f32
    (and bf16 past that) "hd_stream". impl="scalar" asks for the scalar
    kernels in bf16 too (the previous design, for measurement; past
    MAX_HEAD_DIM "hd_stream"), and impl="hd_stream" for the f32 route past
    MAX_HEAD_DIM at any hd and dtype (whose bits are the scalar Wide
    kernels', a check on the card; the previous design past it). `align`
    is the operands' address alignment in bytes: with the row stride (2 d bytes)
    and the head offset (2 hd bytes per head) it bounds the copy width,
    16, 8, 4 or 2 bytes (eICU, hd 36: 8; hd 42: 4)."""
    _check_impl(impl)
    if d % nhead:
        raise ValueError(f"d={d} not divisible by nhead={nhead}")
    hd = d // nhead
    tc = od == torch.bfloat16 and impl == "auto" and hd <= TC_CLUSTER_MAX_HD
    if impl == "hd_stream" or (hd > MAX_HEAD_DIM and not tc):
        return PackedPlan("hd_stream", hd, hd, od.itemsize, HD_STREAM_ROWS, (256,) * 3,
                          (hd_stream_grid_x(T, hd), nhead, B))
    hd_pad = -(-hd // 16) * 16
    if tc:
        width = 16
        while width > 2 and ((2 * hd) % width or (2 * d) % width
                             or align % width):
            width //= 2
        if hd > MAX_HEAD_DIM:
            hd_pad, threads, grid = _tc_cluster_plan(hd, T, nhead, B)
            return PackedPlan("tc_cluster", hd, hd_pad, width, _ROWS, threads, grid)
        grid = (-(-T // _ROWS), nhead, B)
        if hd_pad <= TC_MAX_HD_PAD:
            return PackedPlan("tc", hd, hd_pad, width, _ROWS, (128,) * 3, grid)
        if wide_pad(hd) <= TC_WIDE_MAX_HD_PAD:
            return PackedPlan("tc_wide", hd, wide_pad(hd), width, _ROWS,
                              (256,) * 3, grid)
    rows = scalar_rows(hd)
    return PackedPlan("scalar", hd, hd, od.itemsize, rows, (256,) * 3,
                      (-(-T // rows), nhead, B))


def wide_pad(hd):
    """The padded head dim of the "tc_wide" route for hd 145 .. 368
    (csrc/attention_tc_wide.cuh wide_pad)."""
    steps = -(-max(hd - TC_WIDE_MIN_HD_PAD, 0) // TC_WIDE_STEP)
    return TC_WIDE_MIN_HD_PAD + TC_WIDE_STEP * steps


@dataclass(frozen=True)
class SplitPlan(PackedPlan):
    """What surrounds a flash_mha launch, computed on the host and checked
    by the C entry points (csrc/flash_split.cu `make_plan`), which add each
    kernel's shared memory (`split_smem`). The fields of PackedPlan, and
    cols: the columns a tile copy reads from each row, D, or D padded to 8
    where the operands are `_padded_cast`'s zero-padded heads. Its launches
    run the tensor-core kernels of flash_mha_packed's plan on strided
    operands."""

    cols: int

    def _ints(self):
        return (*super()._ints(), self.cols)


def pad8_cols(D):
    """D padded to a multiple of 8 columns (16 bytes of bf16)."""
    return -(-D // 8) * 8


@functools.lru_cache(maxsize=256)
def split_plan(B, H, T, D, od, strides=(), align=16, impl="auto", padded=False):
    """The launch plan of flash_mha's kernels for [B, H, T, D] operands of
    dtype `od` on the card: bf16 takes the tensor-core route "tc" while D
    padded to 16 is at most TC_MAX_HD_PAD and "tc_wide" past it (as
    packed_plan does) and "tc_cluster" past MAX_HEAD_DIM up to
    TC_CLUSTER_MAX_HD; f32 the scalar kernels, in the Narrow geometry up
    to hd NARROW_MAX_HD and the Wide one beyond, and "hd_stream" past
    MAX_HEAD_DIM (bf16 too past TC_CLUSTER_MAX_HD); impl as in packed_plan.
    `strides`: the (batch, head, row) element strides of each operand set
    (q, k, v; and do in the backward); `align`: the operands' address
    alignment in bytes; `padded`: the operands are heads zero-padded to
    pad8_cols(D) columns, so a copy reads those. The copy width is the
    largest of 16, 8, 4, 2 bytes dividing the columns' bytes, every stride
    in bytes and `align` (the model's dense bf16 cast at hd 42 or 170: 4;
    padded: 16). The tensor-core dk/dv pass runs two CTAs a key block, so
    its grid is 2 * grid[0] along x. The "hd_stream" route reads one
    element at a time: its copy width is the element's and `cols` is D."""
    _check_impl(impl)
    tc = od == torch.bfloat16 and impl == "auto" and D <= TC_CLUSTER_MAX_HD
    if impl == "hd_stream" or (D > MAX_HEAD_DIM and not tc):
        return SplitPlan("hd_stream", D, D, od.itemsize, HD_STREAM_ROWS, (256,) * 3,
                         (hd_stream_grid_x(T, D), H, B), D)
    hd_pad = -(-D // 16) * 16
    if tc:
        cols = pad8_cols(D) if padded else D
        width = 16
        while width > 2 and ((2 * cols) % width or align % width
                             or any((2 * x) % width for s3 in strides for x in s3)):
            width //= 2
        if D > MAX_HEAD_DIM:
            hd_pad, threads, grid = _tc_cluster_plan(D, T, H, B)
            return SplitPlan("tc_cluster", D, hd_pad, width, _ROWS, threads, grid, cols)
        grid = (-(-T // _ROWS), H, B)
        if hd_pad <= TC_MAX_HD_PAD:
            return SplitPlan("tc", D, hd_pad, width, _ROWS, (128,) * 3, grid, cols)
        return SplitPlan("tc_wide", D, wide_pad(D), width, _ROWS, (256,) * 3, grid,
                         cols)
    rows = scalar_rows(D)
    return SplitPlan("scalar", D, D, od.itemsize, rows, (256,) * 3,
                     (-(-T // rows), H, B), D)


def packed_smem(B, T, d, nhead, od, impl="auto"):
    """Shared bytes of the forward, dq and dk/dv kernels that the plan of
    these arguments launches, as csrc/flash_packed.cu computes them (it
    builds the kernels: on the card only). Raises ValueError where one
    would not fit a block."""
    plan = packed_plan(B, T, d, nhead, od, impl)
    out = (ctypes.c_int * 3)()
    err = _lib().rd_packed_smem(B, T, d, nhead, int(od == torch.bfloat16),
                                _ROUTES[plan.route], out)
    if err:
        raise ValueError(f"flash_mha_packed's {plan.route} kernels do not fit "
                         f"hd={plan.hd}: shared bytes {tuple(out)}")
    return tuple(out)


def tc_cluster_occupancy(hd):
    """How many clusters of the "tc_cluster" forward, dq and dk/dv kernels
    at head dim hd the card holds at once (cudaOccupancyMaxActiveClusters,
    csrc/flash_packed.cu rd_tcc_clusters; on the card only)."""
    out = (ctypes.c_int * 3)()
    build.check(_lib().rd_tcc_clusters(hd, out),
                "cudaOccupancyMaxActiveClusters")
    return tuple(out)


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


def drop_origin(origin, B, H):
    """(b0, h0, heads) of a call over B samples and H heads: `origin` as
    given, or (0, 0, H) for None. Every hashed (sample, head) index
    (b0 + b) * heads + h0 + h must fit the uint32 of the JAX package's
    hash: (b0 + B) * heads <= HASH_SPAN."""
    b0, h0, heads = (0, 0, H) if origin is None else (int(v) for v in origin)
    if b0 < 0 or h0 < 0 or h0 + H > heads or (b0 + B) * heads > HASH_SPAN:
        raise ValueError(f"origin {(b0, h0, heads)} does not place {B} samples and "
                         f"{H} heads where every (sample, head) index "
                         f"b * heads + h fits 32 bits")
    return b0, h0, heads


def batch_chunks(n, step=MAX_BATCH):
    """The (start, stop) ranges a call over n samples (or heads) splits
    into, each at most `step` long: one launch each, at its origin."""
    return [(i, min(n, i + step)) for i in range(0, n, step)]


def _attn_keep(seed, B, T, nhead, rate, device, origin=None) -> torch.Tensor:
    """[B, nhead, T, T] keep mask of the attention probabilities, hashed at
    `origin` (drop_origin)."""
    b0, h0, heads = drop_origin(origin, B, nhead)
    b = torch.arange(b0, b0 + B, dtype=torch.int64, device=device)
    h = torch.arange(h0, h0 + nhead, dtype=torch.int64, device=device)
    t8 = pad8(T)
    keep = _dropout_keep_hash(seed, b[:, None] * heads + h[None, :], 0, 0,
                              (t8, t8), rate, device)
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


def _packed_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype, nhead,
                origin=None):
    """Returns (o [B, T, d] f32, lse [B, nhead, T] f32, base 2)."""
    _check(q, k, v, lengths, nhead)
    rate = _check_rate(dropout_rate)
    od = operand_dtype(compute_dtype)
    origin = drop_origin(origin, q.shape[0], nhead)
    if q.is_cuda:
        return _packed_fwd_cuda(q, k, v, lengths, _seed_int(seed), rate, nhead, od,
                                origin=origin)
    return _packed_fwd_plain(q, k, v, lengths, nhead, od, _seed_int(seed), rate,
                             origin)


def _heads(x, nhead, od):
    """[B, T, d] -> [B, H, T, hd] in f32 from operands rounded to od."""
    B, T, d = x.shape
    return (x.to(od).to(torch.float32).reshape(B, T, nhead, d // nhead)
            .transpose(1, 2))


def _packed_fwd_plain(q, k, v, lengths, nhead, od, seed=0, rate=0.0, origin=None):
    """The packed kernel's function in plain PyTorch (`_heads_fwd_plain` on
    the head views of [B, T, d])."""
    B, T, d = q.shape
    o, lse = _heads_fwd_plain(*(_heads(x, nhead, od) for x in (q, k, v)),
                              lengths, od, seed, rate, origin)
    return o.transpose(1, 2).reshape(B, T, d), lse


def _heads_fwd_plain(qh, kh, vh, lengths, od, seed=0, rate=0.0, origin=None):
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
        p = p * _attn_keep(seed, B, T, H, rate, qh.device, origin) / (1.0 - rate)
    o = (p.to(od).to(torch.float32) @ vh) / l
    valid = (lengths > 0)[:, None, None]
    lse = torch.where(valid, mx[..., 0] + torch.log2(l[..., 0]),
                      torch.full_like(l[..., 0], NEG_INF))
    o = torch.where(valid[..., None], o, torch.zeros_like(o))
    return o, lse


def _row_delta(do, o):
    """The backward's row term delta = sum over the last dim of do * o, in
    f32 in the order of the CUDA kernel that computes it on the card
    (csrc/row_delta.cuh), bit for bit: 32 lanes, lane l summing columns l,
    l + 32, ... in turn (0 past the last column), then the lanes' sums
    halved (lanes i and i + 16, then i + 8, ... 1). The order does not
    depend on the tensor's shape, so a row's delta is the same whatever
    rows share the launch, and a shard of the batch or of the heads
    (parallel/mesh.py) gets the full launch's bits."""
    x = do.to(torch.float32) * o
    n = x.shape[-1]
    lanes = torch.nn.functional.pad(x, (0, -n % 32)).unflatten(-1, (-1, 32))
    acc = lanes[..., 0, :]
    for j in range(1, lanes.shape[-2]):
        acc = acc + lanes[..., j, :]
    for w in (16, 8, 4, 2, 1):
        acc = acc[..., :w] + acc[..., w:2 * w]
    return acc[..., 0]


def _packed_delta(do, o, nhead):
    """delta [B, H, T] of [B, T, d] = nhead heads (`_row_delta` per head)."""
    B, T, d = o.shape
    hd = d // nhead
    heads = (B, T, nhead, hd)
    return _row_delta(do.reshape(heads), o.reshape(heads)).transpose(1, 2)


def _packed_bwd_plain(q, k, v, lengths, seed, rate, nhead, od, o, lse, g,
                      origin=None):
    """The backward kernels' function in plain PyTorch, with their
    rounding points: the incoming gradient cast to `od`; delta = per-head
    sum of do * o (`_packed_delta`); p recomputed from the saved base-2
    lse; ds and the dropped p rounded to `od` before their products; dq
    and dk scaled by 1/sqrt(hd). A sample with length 0 gets exact zeros (the exponent
    is never evaluated there). Returns dq, dk, dv [B, T, d] f32."""
    scale = 1.0 / math.sqrt(q.shape[2] // nhead)
    do = g.to(od)
    delta = _packed_delta(do, o, nhead)                         # [B, H, T]
    return _attention_bwd_plain(q, k, v, do, delta, lengths, seed, rate, nhead,
                                od, lse, scale, origin)


def _attention_bwd_plain(q, k, v, do, delta, lengths, seed, rate, nhead, od,
                         lse, scale, origin=None):
    """dq, dk, dv from od-rounded q, k, v, do [B, T, d], the saved lse and
    delta [B, H, T] (shared with the fused layer's backward)."""
    B, T, d = q.shape
    grads = _heads_bwd_plain(*(_heads(x, nhead, od) for x in (q, k, v, do)),
                             delta, lengths, seed, rate, od, lse, scale, origin)
    return tuple(x.transpose(1, 2).reshape(B, T, d) for x in grads)


def _heads_bwd_plain(qh, kh, vh, doh, delta, lengths, seed, rate, od, lse,
                     scale, origin=None):
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
        keep = _attn_keep(seed, B, T, H, rate, qh.device, origin)
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
    def forward(ctx, q, k, v, lengths, seed, dropout_rate, compute_dtype, nhead,
                origin):
        origin = drop_origin(origin, q.shape[0], nhead)
        o, lse = _packed_fwd(q, k, v, lengths, seed, dropout_rate,
                             compute_dtype, nhead, origin)
        od = operand_dtype(compute_dtype)
        ctx.save_for_backward(q.to(od), k.to(od), v.to(od), lengths, o, lse)
        ctx.args = (_seed_int(seed), float(dropout_rate), nhead, od, origin)
        ctx.in_dtypes = (q.dtype, k.dtype, v.dtype)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        seed, rate, nhead, od, origin = ctx.args
        if g.is_cuda:
            dq, dk, dv = _packed_bwd_cuda(q, k, v, lengths, seed, rate, nhead,
                                          od, o, lse, g, origin=origin)
        else:
            dq, dk, dv = _packed_bwd_plain(q, k, v, lengths, seed, rate, nhead,
                                           od, o, lse, g, origin)
        dq, dk, dv = (x.to(t) for x, t in zip((dq, dk, dv), ctx.in_dtypes))
        return dq, dk, dv, None, None, None, None, None, None


def flash_mha_packed(q, k, v, lengths, seed=None, dropout_rate=0.0,
                     compute_dtype=None, nhead=1, origin=None) -> torch.Tensor:
    """Packed-heads attention: q, k, v [B, T, d] -> o [B, T, d] f32.
    `seed` is the int32 seed of the dropout mask (None means 0); `origin`
    (b0, h0, H) the place of these B samples and nhead heads in the batch
    and heads whose mask they draw (drop_origin; None: their own).
    Differentiable in q, k and v."""
    return _FlashPacked.apply(q, k, v, lengths, seed, dropout_rate,
                              compute_dtype, nhead, origin)


# forward launches; `bwd_launches` counts the backward's; the tc_ counts
# those of the two on the tensor-core route up to hd_pad 144, the tc_wide_
# counts those on the route past it, the tc_cluster_ counts those on the
# tensor cores past head dim 368 and the hd_stream_ counts those on the
# scalar route past it (a call split by batch_chunks counts each launch)
ROUTE_COUNTS = ("launches", "bwd_launches", "tc_launches", "tc_bwd_launches",
                "tc_wide_launches", "tc_wide_bwd_launches", "tc_cluster_launches",
                "tc_cluster_bwd_launches", "hd_stream_launches",
                "hd_stream_bwd_launches")
for _attr in ROUTE_COUNTS:
    setattr(flash_mha_packed, _attr, 0)


def _same_device(dev, **tensors):
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")


def _count(plan, attr, fn=flash_mha_packed):
    """One launch of the wrapper `fn` on `attr` and, on a route other than
    "scalar", on <route>_<attr> (tc_<attr>, tc_wide_<attr>,
    tc_cluster_<attr>, hd_stream_<attr>)."""
    build.count_launch(fn, attr)
    if plan.route != "scalar":
        build.count_launch(fn, f"{plan.route}_{attr}")


def _packed_fwd_cuda(q, k, v, lengths, seed, rate, nhead, od, impl="auto",
                     origin=None):
    """The forward kernel of the plan's route. `impl="scalar"` reaches the
    scalar kernel with bf16 operands (the previous design, measured beside
    the tensor-core one); the model never passes it."""
    B, T, d = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths)
    for x in (q, k, v):
        if not x.is_floating_point():
            raise TypeError(f"q, k, v must be floating point, got {x.dtype}")
    b0, h0, heads = drop_origin(origin, B, nhead)
    q, k, v = (x.detach().to(od).contiguous() for x in (q, k, v))
    lens = lengths.to(torch.int32).contiguous()
    o = torch.empty((B, T, d), dtype=torch.float32, device=dev)
    lse = torch.empty((B, nhead, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, c1 in batch_chunks(B):
        xs = [x[c0:c1] for x in (q, k, v, lens, o, lse)]
        plan = packed_plan(c1 - c0, T, d, nhead, od, impl,
                           _align(*(x.data_ptr() for x in xs[:3])))
        err = _lib().rd_packed_fwd(
            *(x.data_ptr() for x in xs), c1 - c0, T, d, nhead,
            (1.0 / math.sqrt(d // nhead)) * LOG2E, int(od == torch.bfloat16),
            seed, rate, b0 + c0, h0, heads, plan.as_ints, stream)
        build.check(err, "flash_mha_packed forward")
        _count(plan, "launches")
    build.credit(attention_flops(B, T, d))
    return o, lse


def _packed_bwd_cuda(q, k, v, lengths, seed, rate, nhead, od, o, lse, g,
                     impl="auto", origin=None):
    """dq, dk, dv through the two backward kernels of the plan's route (one
    CTA per 64 query rows for dq, one per 64 key rows for dk and dv), after
    a launch that sums delta from do and o (csrc/row_delta.cuh; the JAX
    package prepares delta outside its kernel). `impl` as in
    `_packed_fwd_cuda`."""
    B, T, d = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths, o=o, lse=lse, g=g)
    if g.shape != q.shape:
        raise ValueError(f"the incoming gradient is {tuple(g.shape)}, "
                         f"expected {tuple(q.shape)}")
    hd = d // nhead
    b0, h0, heads = drop_origin(origin, B, nhead)
    q, k, v = (x.detach().to(od).contiguous() for x in (q, k, v))
    do = g.detach().to(od).contiguous()
    o = o.detach().to(torch.float32).contiguous()
    delta = torch.empty((B, nhead, T), dtype=torch.float32, device=dev)
    lens = lengths.to(torch.int32).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty((B, T, d), dtype=torch.float32, device=dev)
                  for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = 1.0 / math.sqrt(hd)
    for c0, c1 in batch_chunks(B):
        xs = [x[c0:c1] for x in (q, k, v, do, o, lse, delta, lens, dq, dk, dv)]
        plan = packed_plan(c1 - c0, T, d, nhead, od, impl,
                           _align(*(x.data_ptr() for x in xs[:4])))
        err = _lib().rd_packed_bwd(
            *(x.data_ptr() for x in xs), c1 - c0, T, d, nhead, scale,
            int(od == torch.bfloat16), seed, rate, b0 + c0, h0, heads,
            plan.as_ints, stream)
        build.check(err, "flash_mha_packed backward")
        _count(plan, "bwd_launches")
    build.credit(2 * attention_flops(B, T, d))
    return dq, dk, dv


def _lib():
    lib = build.load("flash_packed")
    if lib.rd_packed_fwd.argtypes is None:
        tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.rd_packed_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                      + tail)
        lib.rd_packed_fwd.restype = ctypes.c_int
        lib.rd_packed_bwd.argtypes = ([ctypes.c_void_p] * 11
                                      + [ctypes.c_int] * 4 + tail)
        lib.rd_packed_bwd.restype = ctypes.c_int
        lib.rd_packed_smem.argtypes = ([ctypes.c_int] * 6
                                       + [ctypes.POINTER(ctypes.c_int)])
        lib.rd_packed_smem.restype = ctypes.c_int
        lib.rd_tcc_clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.rd_tcc_clusters.restype = ctypes.c_int
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


def _flash_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype, cols=None,
               origin=None):
    """Returns (o [B, H, T, D] f32, lse [B, H, T] f32, base 2). `cols` as in
    `_flash_fwd_cuda`."""
    _check_heads(q, k, v, lengths)
    rate = _check_rate(dropout_rate)
    od = operand_dtype(compute_dtype)
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, lengths, _seed_int(seed), rate, od,
                               cols=cols, origin=origin)
    return _flash_fwd_plain(q, k, v, lengths, od, _seed_int(seed), rate, origin)


def _flash_fwd_plain(q, k, v, lengths, od, seed=0, rate=0.0, origin=None):
    """flash_mha's forward in plain PyTorch (see `_heads_fwd_plain`)."""
    return _heads_fwd_plain(*(_rounded(x, od) for x in (q, k, v)), lengths, od,
                            seed, rate, origin)


def _flash_bwd_plain(q, k, v, lengths, seed, rate, od, o, lse, g, origin=None):
    """flash_mha's backward in plain PyTorch, with the kernels' rounding
    points (see `_packed_bwd_plain`). Returns dq, dk, dv [B, H, T, D] f32."""
    do = g.to(od)
    delta = _row_delta(do, o)                                   # [B, H, T]
    return _heads_bwd_plain(*(_rounded(x, od) for x in (q, k, v, do)), delta,
                            lengths, seed, rate, od, lse,
                            1.0 / math.sqrt(q.shape[-1]), origin)


class _FlashSplit(torch.autograd.Function):
    """flash_mha with its hand-written backward. On the card the operands
    are cast once (`_flash_operands`: heads zero-padded to 8 columns on the
    bf16 tensor-core route) and saved cast for the backward, with the
    columns they hold (`ctx.cols`)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, seed, dropout_rate, compute_dtype, origin):
        od = operand_dtype(compute_dtype)
        ctx.in_dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.cols = None
        origin = drop_origin(origin, q.shape[0], q.shape[1])
        if q.is_cuda:
            _check_heads(q, k, v, lengths)
            (q, k, v), ctx.cols = _flash_operands((q, k, v), od)
        o, lse = _flash_fwd(q, k, v, lengths, seed, dropout_rate, compute_dtype,
                            ctx.cols, origin)
        ctx.save_for_backward(q.to(od), k.to(od), v.to(od), lengths, o, lse)
        ctx.args = (_seed_int(seed), float(dropout_rate), od, origin)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        seed, rate, od, origin = ctx.args
        if g.is_cuda:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, lengths, seed, rate, od, o, lse,
                                         g, cols=ctx.cols, origin=origin)
        else:
            dq, dk, dv = _flash_bwd_plain(q, k, v, lengths, seed, rate, od, o,
                                          lse, g, origin)
        dq, dk, dv = (x.to(t) for x, t in zip((dq, dk, dv), ctx.in_dtypes))
        return dq, dk, dv, None, None, None, None, None


def flash_mha(q, k, v, lengths, seed=None, dropout_rate=0.0,
              compute_dtype=None, origin=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + key mask) v per head, at any T.

    q, k, v [B, H, T, D] (any strides with a contiguous last dim: the
    [B, T, H, D] view of a projection works without a copy in f32); lengths
    [B] valid key counts, shared by a sample's heads; `seed` the int32 seed
    of the dropout mask on the probabilities (None means 0); compute_dtype
    None keeps f32 operands, "bfloat16" rounds the operands of every
    product to bf16 (f32 accumulation and softmax statistics). Returns o
    [B, H, T, D] f32; on the card its memory is laid out [B, T, H, D], so
    merging the heads afterwards is a view. `origin` (b0, h0, H) as in
    flash_mha_packed. Differentiable in q, k and v."""
    return _FlashSplit.apply(q, k, v, lengths, seed, dropout_rate,
                             compute_dtype, origin)


# the counts of flash_mha_packed (ROUTE_COUNTS); the launches that no
# route count takes ran the scalar kernels
for _attr in ROUTE_COUNTS:
    setattr(flash_mha, _attr, 0)
del _attr


def _padded_cast(xs, od):
    """The [B, H, T, D] tensors `xs` cast to `od` into one buffer laid out
    [len(xs), B, T, H, pad8_cols(D)] whose pad columns are zeros; returns
    the [B, H, T, D] views of it (one stride triple for all, a head
    starting at a multiple of 16 bytes). The cast copies anyway, so the
    padding costs only the zeroing of the pad columns: it lets a
    tensor-core tile copy read pad8_cols(D) columns by 16 bytes where D
    columns would take 4-byte copies (hd 42, 170)."""
    B, H, T, D = xs[0].shape
    cols = pad8_cols(D)
    buf = torch.empty((len(xs), B, T, H, cols), dtype=od, device=xs[0].device)
    if cols > D:
        buf[..., D:].zero_()
    views = buf[..., :D].transpose(2, 3).unbind(0)
    for view, x in zip(views, xs):
        view.copy_(x.detach())
    return views


def _flash_operands(xs, od, impl="auto"):
    """The operands `xs` in `od` for the kernels, and the columns a kernel
    copy may read from each of their rows: f32 cast to bf16 on the
    tensor-core routes ("tc", "tc_wide", "tc_cluster") goes through
    `_padded_cast` (pad8_cols(D) columns); operands already in `od` stay as
    they are, and f32 and impl="scalar" (the previous design) take a plain
    cast (D columns: their copy width is what their strides allow;
    "hd_stream" reads one element at a time)."""
    D = xs[0].shape[-1]
    if all(x.dtype == od for x in xs):
        return tuple(xs), D
    if od == torch.bfloat16 and impl == "auto" and D <= TC_CLUSTER_MAX_HD:
        return _padded_cast(xs, od), pad8_cols(D)
    return tuple(x.detach().to(od) for x in xs), D


def _head_strides(xs, cols):
    """The [B, H, T, D] tensors `xs`, holding `cols` columns a row, as the
    kernels take them, with a unit last stride and one (batch, head, row)
    stride triple for all: (tensors, that triple in elements, columns).
    Where the strides differ it copies them into dense heads of D columns."""
    if any(x.stride(-1) != 1 or x.stride() != xs[0].stride() for x in xs):
        xs, cols = tuple(x.contiguous() for x in xs), xs[0].shape[-1]
    return xs, xs[0].stride()[:3], cols


def _empty_heads(B, H, T, D, device):
    """An f32 [B, H, T, D] tensor laid out [B, T, H, D] in memory."""
    return torch.empty((B, T, H, D), dtype=torch.float32,
                       device=device).transpose(1, 2)


def _check_flash_cuda(q, k, v):
    for x in (q, k, v):
        if not x.is_floating_point():
            raise TypeError(f"q, k, v must be floating point, got {x.dtype}")


def _head_chunks(B, H):
    """(b0, b1, h0, h1) of each launch of a [B, H, ...] call: at most
    MAX_BATCH samples and heads a launch (batch_chunks)."""
    return [(b0, b1, h0, h1) for b0, b1 in batch_chunks(B) for h0, h1 in batch_chunks(H)]


def _flash_plan(xs, od, impl, strides, B, H, T, D, cols):
    """The launch plan for operands `xs` (the kernels' tensors, each with
    the stride triples in `strides`, holding `cols` columns a row): padded
    when cols is past D."""
    return split_plan(B, H, T, D, od, tuple(strides),
                      _align(*(x.data_ptr() for x in xs)), impl, cols > D)


def _flash_fwd_cuda(q, k, v, lengths, seed, rate, od, impl="auto", cols=None,
                    origin=None):
    """The forward kernel of the plan's route. `impl="scalar"` reaches the
    scalar kernel with bf16 operands (the previous design, measured beside
    the tensor-core one); the model never passes it. `cols`: the columns
    q, k and v hold a row when the caller cast them already
    (`_flash_operands`); None casts them here."""
    B, H, T, D = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths)
    _check_flash_cuda(q, k, v)
    b0, h0, heads = drop_origin(origin, B, H)
    if cols is None:
        (q, k, v), cols = _flash_operands((q, k, v), od, impl)
    (q, k, v), s_in, cols = _head_strides((q, k, v), cols)
    lens = lengths.to(torch.int32).contiguous()
    o = _empty_heads(B, H, T, D, dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 6)(*s_in, *o.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, c1, g0, g1 in _head_chunks(B, H):
        qc, kc, vc, oc = (x[c0:c1, g0:g1] for x in (q, k, v, o))
        # lse's chunk is dense unless the heads are split (past MAX_BATCH)
        lse_c = lse[c0:c1] if g1 - g0 == H else torch.empty(
            (c1 - c0, g1 - g0, T), dtype=torch.float32, device=dev)
        plan = _flash_plan((qc, kc, vc), od, impl, (s_in,), c1 - c0, g1 - g0, T, D, cols)
        err = _split_lib().rd_split_fwd(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens[c0:c1].data_ptr(),
            oc.data_ptr(), lse_c.data_ptr(), strides, c1 - c0, g1 - g0, T, D,
            (1.0 / math.sqrt(D)) * LOG2E, int(od == torch.bfloat16), seed, rate,
            b0 + c0, h0 + g0, heads, plan.as_ints, stream)
        build.check(err, "flash_mha forward")
        if g1 - g0 != H:
            lse[c0:c1, g0:g1] = lse_c
        _count(plan, "launches", flash_mha)
    build.credit(attention_flops(B, T, H * D))
    return o, lse


def _flash_bwd_cuda(q, k, v, lengths, seed, rate, od, o, lse, g, impl="auto",
                    cols=None, g_cols=None, origin=None):
    """dq, dk, dv through the two backward kernels of the plan's route (one
    CTA per block of query rows for dq; for dk and dv one per block of key
    rows on the scalar route, two on the tensor-core ones), after the
    launch that sums delta from do and o (csrc/row_delta.cuh). `impl` and
    `cols` (of q, k, v) as in `_flash_fwd_cuda`; `g_cols` the same of g."""
    B, H, T, D = q.shape
    dev = q.device
    _same_device(dev, k=k, v=v, lengths=lengths, o=o, lse=lse, g=g)
    _check_flash_cuda(q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"the incoming gradient is {tuple(g.shape)}, "
                         f"expected {tuple(q.shape)}")
    if cols is None:
        (q, k, v), cols = _flash_operands((q, k, v), od, impl)
    (q, k, v), s_in, cols = _head_strides((q, k, v), cols)
    if g_cols is None:
        (g,), g_cols = _flash_operands((g,), od, impl)
    (do,), s_do, g_cols = _head_strides((g,), g_cols)
    b0, h0, heads = drop_origin(origin, B, H)
    o = o.detach().to(torch.float32)
    if o.stride(-1) != 1:
        o = o.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    lse = lse.contiguous()
    # one allocation, so the three gradients share their strides
    grads = torch.empty((3, B, T, H, D), dtype=torch.float32, device=dev)
    dq, dk, dv = (x.transpose(1, 2) for x in grads.unbind(0))
    strides = (ctypes.c_int64 * 12)(*s_in, *s_do, *dq.stride()[:3], *o.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, c1, g0, g1 in _head_chunks(B, H):
        xs = [x[c0:c1, g0:g1] for x in (q, k, v, do, o)]
        gs = [x[c0:c1, g0:g1] for x in (dq, dk, dv)]
        lse_c = lse[c0:c1, g0:g1].contiguous()
        delta = torch.empty((c1 - c0, g1 - g0, T), dtype=torch.float32, device=dev)
        plan = _flash_plan(xs[:4], od, impl, (s_in, s_do), c1 - c0, g1 - g0, T, D,
                           min(cols, g_cols))
        err = _split_lib().rd_split_bwd(
            *(x.data_ptr() for x in xs), lse_c.data_ptr(), delta.data_ptr(),
            lens[c0:c1].data_ptr(), *(x.data_ptr() for x in gs), strides, c1 - c0,
            g1 - g0, T, D, 1.0 / math.sqrt(D), int(od == torch.bfloat16), seed, rate,
            b0 + c0, h0 + g0, heads, plan.as_ints, stream)
        build.check(err, "flash_mha backward")
        _count(plan, "bwd_launches", flash_mha)
    build.credit(2 * attention_flops(B, T, H * D))
    return dq, dk, dv


@functools.lru_cache(maxsize=64)
def split_smem(D, route="scalar"):
    """Shared bytes of flash_mha's forward, dq and dk/dv kernels at head dim
    D on a route ("scalar", "tc", "tc_wide", "tc_cluster", "hd_stream"), as
    csrc/flash_split.cu
    computes them for its launches (it builds the kernels: on the card
    only). Raises ValueError for a head dim the route does not take."""
    out = (ctypes.c_int * 3)()
    if _split_lib().rd_split_smem(D, _ROUTES[route], out):
        raise ValueError(f"the flash_mha {route} kernels do not take hd={D}: "
                         f"shared bytes {tuple(out)}")
    return tuple(out)


def _split_lib():
    lib = build.load("flash_packed")
    if lib.rd_split_fwd.argtypes is None:
        tail = [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.rd_split_fwd.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.rd_split_fwd.restype = ctypes.c_int
        lib.rd_split_bwd.argtypes = [ctypes.c_void_p] * 11 + tail
        lib.rd_split_bwd.restype = ctypes.c_int
        lib.rd_split_smem.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
        lib.rd_split_smem.restype = ctypes.c_int
    return lib
