"""The tensor-core route past head dim 368 ("tc_cluster"), on the CPU.

Past MAX_HEAD_DIM (368) bf16 operands of flash_mha_packed, flash_mha and
the fused layer's attention take "tc_cluster" on the card
(csrc/attention_tc_cluster.cuh) up to hd 2048: a cluster of
n = ceil(hd / 256) CTAs a 64-row block, each owning W columns of the head
(the share rounded up to 32), their partial scores summed in distributed
shared memory in rank order. Here, without a card:
- the launch plans at every bf16 hd 369-2048 (route, n, W, grid, threads,
  and the shared bytes, a mirror of the header's sizes that must fit a
  block); bf16 past 2048, f32 and impl="hd_stream" keep "hd_stream";
- the fused layer's attention route at d = nhead x hd;
- a plain-torch mirror of the cluster's algorithm (the partial scores of
  W-column slices summed in rank order, an online base-2 softmax over
  32-key tiles, the slice products; the backward's two passes) against the
  JAX packed kernel (Pallas in interpret mode) at hd 400 and 720, forward
  and gradients, dropout 0 and 0.2, at 2e-5 in f32 (the attention's f32
  tolerance in tests/test_torch_wide_heads.py).
The kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, marker `cuda`).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.ops import flash_attention as jfa

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe

BF16, F32 = torch.bfloat16, torch.float32
SMEM = 232448        # a block's shared bytes on the H100
SEED = 4242
TOL = 2e-5
# the hd ranges of each cluster size n = 2 .. 8
CLUSTERS = [(n, range(max(369, 256 * (n - 1) + 1), 256 * n + 1)) for n in range(2, 9)]


def _mirror_size(hd):
    """(n, W): the header's cluster_size and slice_cols."""
    n = -(-hd // 256)
    return n, -(-(-(-hd // n)) // 32) * 32


def _mirror_smem(W):
    """The header's shared bytes (forward, dq, dk/dv): Q (Q and dO; K and V)
    as 64 x W bf16 tiles, a ring of two stages of two 32 x W tiles, two
    buffers of one (forward) or two (backward) [64, 32] f32 partial score
    tiles, and in the dk/dv pass two stages of 32 lse and delta floats."""
    own, ring, part = 64 * W * 2, 2 * 2 * 32 * W * 2, 64 * 32 * 4
    return (own + ring + 2 * part, 2 * own + ring + 4 * part,
            2 * own + ring + 4 * part + 2 * 2 * 32 * 4)


@pytest.mark.parametrize("n,hds", CLUSTERS, ids=[f"n{n}" for n, _ in CLUSTERS])
def test_every_bf16_head_dim_past_368_takes_the_cluster_route(n, hds):
    """Both plans at every bf16 hd of a cluster size, one and three heads:
    the route, n W columns, 64-row blocks times n along x (the dk/dv pass
    on the same grid, both outputs on two warpgroups), the threads, the
    ints the C entry points check, and shared bytes that fit a block."""
    for hd in hds:
        n_, W = _mirror_size(hd)
        assert n_ == n and W in (192, 224, 256) and n * W >= hd > (n - 1) * W
        assert fa.tc_cluster_size(hd) == (n, W)
        assert fa.tc_cluster_smem(W) == _mirror_smem(W)
        assert max(_mirror_smem(W)) <= SMEM
        for nhead in (1, 3):
            p = fa.packed_plan(7, 215, nhead * hd, nhead, BF16)
            copy = 16 if hd % 8 == 0 else 8 if hd % 4 == 0 else 4 if hd % 2 == 0 else 2
            assert (p.route, p.hd, p.hd_pad, p.rows, p.copy_bytes, p.threads) == (
                "tc_cluster", hd, n * W, 64, copy, (128, 128, 256))
            assert p.grid == (4 * n, nhead, 7) == p.dkv_grid
            assert tuple(p.as_ints) == (5, n * W, copy, 64, 128, 128, 256, 4 * n, nhead, 7)
        s = fa.split_plan(5, 2, 2048, hd, BF16, ((2048 * 2 * fa.pad8_cols(hd),
                                                  fa.pad8_cols(hd), 2 * fa.pad8_cols(hd)),),
                          16, padded=True)
        assert (s.route, s.hd_pad, s.rows, s.copy_bytes, s.cols, s.grid) == (
            "tc_cluster", n * W, 64, 16, fa.pad8_cols(hd), (32 * n, 2, 5))


@pytest.mark.parametrize("hd", [369, 720, 1024, 2048, 2049, 4096])
def test_f32_hd_stream_and_past_2048_keep_the_scalar_route(hd):
    """f32 at every hd past 368, impl="hd_stream" at any dtype and bf16
    past 2048 plan "hd_stream" as before, field for field."""
    slices = -(-hd // fa.HD_STREAM_SLICE)
    cases = [(F32, "auto"), (BF16, "hd_stream"), (F32, "hd_stream")]
    if hd > fa.TC_CLUSTER_MAX_HD:
        cases.append((BF16, "auto"))
    for od, impl in cases:
        p = fa.packed_plan(7, 215, hd, 1, od, impl)
        assert (p.route, p.hd_pad, p.rows, p.copy_bytes, p.threads, p.grid) == (
            "hd_stream", hd, 32, od.itemsize, (256,) * 3, (7 * slices, 1, 7))
        s = fa.split_plan(5, 2, 2048, hd, od, ((2048 * 2 * hd, hd, 2 * hd),), 16, impl,
                          od == BF16)
        assert (s.route, s.hd_pad, s.cols, s.grid) == ("hd_stream", hd, hd,
                                                      (64 * slices, 2, 5))
    # the scalar route past 368 reads its operands as given: no padded cast
    x = torch.zeros(1, 1, 4, hd)
    (y,), cols = fa._flash_operands((x,), BF16, "hd_stream")
    assert cols == hd and y.dtype == BF16
    (y,), cols = fa._flash_operands((torch.zeros(1, 1, 4, 371),), BF16)
    assert cols == 376      # the tensor-core routes' padded cast


@pytest.mark.parametrize("nhead", [1, 2, 3])
def test_the_fused_layer_s_attention_past_368(nhead):
    """The fused layer at d = nhead x hd runs the "stream" route; its
    attention takes "tc_cluster" in bf16 up to hd 2048 (bf16 qkv rows, the
    three launches of the packed pair's kernels with the copy width the
    rows allow) and "hd_stream" in f32 and past 2048."""
    for hd in list(range(369, 2049, 61)) + [720, 1024, 2048, 2049]:
        d = nhead * hd
        for od in (BF16, F32):
            plan = fe.fused_plan(d, 64, nhead, od)
            assert plan.route == "stream"
            attn = [plan[x] for x in ("attn_fwd", "attn_dq", "attn_dkv")]
            if od == F32 or hd > fa.TC_CLUSTER_MAX_HD:
                assert plan.attn_route == "hd_stream"
                assert fe._qkv_dtype(plan) == F32
                continue
            _, W = _mirror_size(hd)
            copy = 16
            while (2 * hd) % copy or (2 * d) % copy:
                copy //= 2
            assert plan.attn_route == "tc_cluster" and fe._qkv_dtype(plan) == BF16
            assert [(l.route, l.rows, l.copy_bytes, l.threads, l.smem) for l in attn] == [
                ("tc_cluster", 64, copy, th, b) for th, b in zip((128, 128, 256),
                                                                 _mirror_smem(W))]
            assert list(plan.as_ints)[5:10] == [5, 64, copy, 128, _mirror_smem(W)[0]]
            assert "d_attn_op" in fe.bwd_scratch(2, 16, d, 64, nhead, plan)


# ------------------------------------------------- the algorithm's mirror
def _slice_sum(a, b, n, W):
    """a [R, hd] b [K, hd]^T as the cluster sums it: rank r's partial over
    columns r W .. r W + W - 1, added in rank order 0 .. n-1."""
    acc = None
    for r in range(n):
        cols = slice(r * W, min((r + 1) * W, a.shape[-1]))
        part = a[:, cols] @ b[:, cols].T
        acc = part if acc is None else acc + part
    return acc


def _mirror_fwd(q, k, v, length, keep, inv):
    """One (sample, head): o [T, hd], lse [T] base 2, by 64-row blocks
    and 32-key tiles, the online softmax on the summed partial scores and
    the output product slice by slice."""
    T, hd = q.shape
    n, W = _mirror_size(hd)
    scale2 = math.log2(math.e) / math.sqrt(hd)
    o, lse = torch.zeros(T, hd), torch.full((T,), fa.NEG_INF)
    if length <= 0:
        return o, lse
    for q0 in range(0, T, 64):
        rows = slice(q0, min(q0 + 64, T))
        nr = rows.stop - q0
        m, l, acc = torch.full((nr,), fa.NEG_INF), torch.zeros(nr), torch.zeros(nr, hd)
        for k0 in range(0, length, 32):
            ks = slice(k0, min(k0 + 32, length))
            s = _slice_sum(q[rows], k[ks], n, W) * scale2
            m_new = torch.maximum(m, s.amax(1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            l = l * alpha + p.sum(1)
            pw = p if keep is None else p * keep[rows, ks] * inv
            for r in range(n):
                cols = slice(r * W, min((r + 1) * W, hd))
                acc[:, cols] = acc[:, cols] * alpha[:, None] + pw @ v[ks, cols]
            m = m_new
        o[rows] = acc / l[:, None]
        lse[rows] = m + torch.log2(l)
    return o, lse


def _mirror_bwd(q, k, v, do, o, lse, length, keep, inv):
    """One (sample, head): dq by 64-row query blocks over 32-key tiles, dk
    and dv by 64-row key blocks over 32-row query tiles, each from the
    summed partial S and dP (S^T and dP^T) and the slice products."""
    T, hd = q.shape
    n, W = _mirror_size(hd)
    scale = 1.0 / math.sqrt(hd)
    scale2 = scale * math.log2(math.e)
    delta = (do * o).sum(1)
    dq, dk, dv = (torch.zeros(T, hd) for _ in range(3))
    if length <= 0:
        return dq, dk, dv
    slices = [slice(r * W, min((r + 1) * W, hd)) for r in range(n)]
    for q0 in range(0, T, 64):
        rows = slice(q0, min(q0 + 64, T))
        for k0 in range(0, length, 32):
            ks = slice(k0, min(k0 + 32, length))
            p = torch.exp2(_slice_sum(q[rows], k[ks], n, W) * scale2 - lse[rows, None])
            dp = _slice_sum(do[rows], v[ks], n, W)
            if keep is not None:
                dp = dp * keep[rows, ks] * inv
            ds = p * (dp - delta[rows, None])
            for cols in slices:
                dq[rows, cols] += ds @ k[ks, cols]
    for k0 in range(0, length, 64):
        keys = slice(k0, min(k0 + 64, length))
        for t0 in range(0, T, 32):
            qs = slice(t0, min(t0 + 32, T))
            p = torch.exp2(_slice_sum(k[keys], q[qs], n, W) * scale2 - lse[None, qs])
            dp = _slice_sum(v[keys], do[qs], n, W)
            pd = p
            if keep is not None:
                kt = keep[qs, keys].T
                pd, dp = p * kt * inv, dp * kt * inv
            ds = p * (dp - delta[None, qs])
            for cols in slices:
                dv[keys, cols] += pd @ do[qs, cols]
                dk[keys, cols] += ds @ q[qs, cols]
    return dq * scale, dk * scale, dv


def _mirror(q, k, v, g, lengths, rate, nhead):
    """The mirror over [B, T, d] operands: o and the three gradients."""
    B, T, d = q.shape
    hd = d // nhead
    heads = lambda x: torch.from_numpy(x).reshape(B, T, nhead, hd)  # noqa: E731
    qh, kh, vh, gh = map(heads, (q, k, v, g))
    keep = fa._attn_keep(SEED, B, T, nhead, rate, "cpu") if rate else None
    out = [torch.zeros(B, T, nhead, hd) for _ in range(4)]
    for b in range(B):
        for h in range(nhead):
            kp = None if keep is None else keep[b, h]
            args = (qh[b, :, h], kh[b, :, h], vh[b, :, h])
            o, lse = _mirror_fwd(*args, int(lengths[b]), kp, 1.0 / (1.0 - rate))
            grads = _mirror_bwd(*args, gh[b, :, h], o, lse, int(lengths[b]), kp,
                                1.0 / (1.0 - rate))
            for x, y in zip(out, (o, *grads)):
                x[b, :, h] = y
    return [x.reshape(B, T, d).numpy() for x in out]


def _jax_packed(q, k, v, g, lengths, rate, nhead):
    fn = lambda q, k, v: jfa.flash_mha_packed(  # noqa: E731
        q, k, v, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, None, nhead)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(o)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd,nhead,T", [(400, 1, 40), (400, 2, 21), (720, 1, 37)])
def test_the_cluster_algorithm_matches_jax(hd, nhead, T, rate):
    """The mirror at hd 400 (2 CTAs of 224 columns, the last 48 zeroed pad)
    and 720 (3 of 256, 48 pad), B=2 with one ragged length, against the JAX
    packed kernel and its vjp: o, dq, dk, dv at 2e-5."""
    rng = np.random.default_rng(hd + T)
    q, k, v, g = (rng.normal(size=(2, T, nhead * hd)).astype(np.float32) for _ in range(4))
    lengths = np.array([T, T - 12], np.int32)
    got = _mirror(q, k, v, g, lengths, rate, nhead)
    want = _jax_packed(q, k, v, g, lengths, rate, nhead)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)


def test_a_length_0_sample_gives_zeros():
    """The mirror (as the kernels: the whole cluster leaves at once) gives
    o = 0, lse = NEG_INF and zero gradients for a sample of length 0, as the
    port's plain version does."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(9, 400)).astype(np.float32))
                  for _ in range(4))
    o, lse = _mirror_fwd(q, k, v, 0, None, 1.0)
    assert (o == 0).all() and (lse == fa.NEG_INF).all()
    assert all((x == 0).all() for x in _mirror_bwd(q, k, v, g, o, lse, 0, None, 1.0))
    po, plse = fa._packed_fwd_plain(q[None], k[None], v[None], torch.tensor([0]), 1, F32)
    assert (po == 0).all() and (plse == fa.NEG_INF).all()
