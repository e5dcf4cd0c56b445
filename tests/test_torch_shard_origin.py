"""Dropout at shard origins: a rank that runs a block of the batch or of
the heads draws, bit for bit, the matching block of the full call's
masks. The plain versions of rows 1-4 of the kernel table
(flash_mha_packed forward and backward, the fused layer forward and
backward), flash_mha's, and `dropout`, in train mode at rate 0.2: every
output of a shard's call equals the slice of the full call's, exactly.
The fused layer's weight gradients are sums over the rows, so a shard's
are a part of the sum: they are held to the full call's with the rows
outside the shard given a zero gradient, at 1e-5 (the same sums in
another order)."""

import itertools

import numpy as np
import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.utils.dropout import dropout

from tests.torch_port_util import random_layer, to_torch

RATE, SEED = 0.2, 12345


@pytest.mark.parametrize("shape", [(6, 8, 5), (3, 4, 7, 7), (40,)])
def test_dropout_at_every_origin_is_the_full_masks_block(shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    full = dropout(SEED, x, RATE)
    assert 0 < (full == 0).float().mean() < 0.4
    # every block cut by halving or thirding each axis
    cuts = [sorted({0, n // 3, n // 2, n}) for n in shape]
    for starts in itertools.product(*[c[:-1] for c in cuts]):
        for ends in itertools.product(*[c[1:] for c in cuts]):
            if any(e <= s for s, e in zip(starts, ends)):
                continue
            sl = tuple(slice(s, e) for s, e in zip(starts, ends))
            got = dropout(SEED, x[sl], RATE, origin=starts, full_shape=shape)
            assert torch.equal(got, full[sl]), sl


def test_dropout_refuses_a_block_outside_the_tensor():
    with pytest.raises(ValueError):
        dropout(SEED, torch.ones(2, 3), RATE, origin=(1, 0), full_shape=(2, 3))


def _qkv(B, T, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, d, generator=g) for _ in range(3))
    lengths = torch.tensor([T, 1, 0, T - 3, 5, T][:B], dtype=torch.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("od", [torch.float32, torch.bfloat16])
def test_packed_rows_and_heads_at_their_origin_are_the_full_calls(od):
    """Rows 1-2: a batch shard [b0:b0+n] at origin (b0, 0, H) and one head
    at (b0, h, H) give the full call's o, lse, dq, dk, dv there."""
    B, T, H, hd = 6, 20, 2, 8
    d = H * hd
    q, k, v, lengths = _qkv(B, T, d)
    g = torch.randn(B, T, d, generator=torch.Generator().manual_seed(1))
    o, lse = fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, RATE)
    grads = fa._packed_bwd_plain(q, k, v, lengths, SEED, RATE, H, od, o, lse, g)
    # the keep masks of every (sample, head) block
    full_keep = fa._attn_keep(SEED, B, T, H, RATE, None)
    for b0, n, h0, nh in itertools.product(range(B), (1, 2), range(H), (1, 2)):
        if b0 + n <= B and h0 + nh <= H:
            assert torch.equal(fa._attn_keep(SEED, n, T, nh, RATE, None, (b0, h0, H)),
                               full_keep[b0:b0 + n, h0:h0 + nh])
    # the outputs; a single (sample, head) pair is left out here: its
    # products are plain [T, T] x [T, hd] GEMMs on the CPU, whose last bit
    # may differ from the batched product's whatever the masks
    for b0, n, heads_of in ((0, 3, (None, 0, 1)), (2, 2, (None, 0, 1)), (5, 1, (None,))):
        rows = slice(b0, b0 + n)
        for h in heads_of:
            cols = slice(None) if h is None else slice(h * hd, (h + 1) * hd)
            heads = slice(None) if h is None else slice(h, h + 1)
            nh = H if h is None else 1
            origin = (b0, 0 if h is None else h, H)
            args = [x[rows][..., cols] for x in (q, k, v)]
            o_s, lse_s = fa._packed_fwd_plain(*args, lengths[rows], nh, od, SEED, RATE,
                                              origin)
            assert torch.equal(o_s, o[rows][..., cols])
            assert torch.equal(lse_s, lse[rows][:, heads])
            g_s = fa._packed_bwd_plain(*args, lengths[rows], SEED, RATE, nh, od, o_s,
                                       lse_s, g[rows][..., cols], origin)
            for got, want in zip(g_s, grads):
                assert torch.equal(got, want[rows][..., cols])
    # and through the autograd function, as the model calls it
    out = fa.flash_mha_packed(q[2:4], k[2:4], v[2:4], lengths[2:4], SEED, RATE,
                              None, H, origin=(2, 0, H))
    assert torch.equal(out, fa.flash_mha_packed(q, k, v, lengths, SEED, RATE, None, H)[2:4])
    with pytest.raises(ValueError, match="origin"):
        fa.flash_mha_packed(q, k, v, lengths, SEED, RATE, None, H, origin=(0, 1, H))


def test_flash_mha_at_an_origin_is_the_full_calls():
    """flash_mha's plain forward and backward on one head of a batch shard."""
    B, H, T, D = 4, 3, 17, 6
    g = torch.Generator().manual_seed(2)
    q, k, v, go = (torch.randn(B, H, T, D, generator=g) for _ in range(4))
    lengths = torch.tensor([17, 0, 4, 9], dtype=torch.int32)
    od = torch.float32
    o, lse = fa._flash_fwd_plain(q, k, v, lengths, od, SEED, RATE)
    grads = fa._flash_bwd_plain(q, k, v, lengths, SEED, RATE, od, o, lse, go)
    rows, heads = slice(1, 3), slice(2, 3)
    args = [x[rows, heads] for x in (q, k, v)]
    o_s, lse_s = fa._flash_fwd_plain(*args, lengths[rows], od, SEED, RATE, (1, 2, H))
    assert torch.equal(o_s, o[rows, heads]) and torch.equal(lse_s, lse[rows, heads])
    g_s = fa._flash_bwd_plain(*args, lengths[rows], SEED, RATE, od, o_s, lse_s,
                              go[rows, heads], (1, 2, H))
    for got, want in zip(g_s, grads):
        assert torch.equal(got, want[rows, heads])


@pytest.mark.parametrize("od", [torch.float32, torch.bfloat16])
def test_fused_layer_rows_at_their_origin_are_the_full_calls(od):
    """Rows 3-4: the fused layer on rows [b0:b0+n] at origin (b0, 0, H)
    gives the full call's out, attn, lse and dx there; its weight
    gradients are the full call's with the other rows' gradient zero."""
    B, T, H, d, ffn = 5, 12, 2, 12, 10
    p = to_torch(random_layer(3, d, ffn))
    x = torch.randn(B, T, d, generator=torch.Generator().manual_seed(4))
    g = torch.randn(B, T, d, generator=torch.Generator().manual_seed(5))
    lengths = torch.tensor([12, 0, 7, 1, 12], dtype=torch.int32)
    out, attn, lse = fe._fused_fwd_plain(p, x, lengths, H, od, SEED, RATE)
    dx, _ = fe._fused_bwd_plain(p, x, lengths, SEED, RATE, H, od, attn, lse, g)
    for b0, n in ((0, 2), (2, 3), (4, 1)):
        rows = slice(b0, b0 + n)
        o_s, a_s, l_s = fe._fused_fwd_plain(p, x[rows], lengths[rows], H, od, SEED,
                                            RATE, (b0, 0, H))
        assert torch.equal(o_s, out[rows]) and torch.equal(a_s, attn[rows])
        assert torch.equal(l_s, lse[rows])
        dx_s, dws_s = fe._fused_bwd_plain(p, x[rows], lengths[rows], SEED, RATE, H, od,
                                          a_s, l_s, g[rows], origin=(b0, 0, H))
        assert torch.equal(dx_s, dx[rows])
        g_rows = torch.zeros_like(g)
        g_rows[rows] = g[rows]
        _, dws_want = fe._fused_bwd_plain(p, x, lengths, SEED, RATE, H, od, attn, lse,
                                          g_rows)
        for got, want in zip(dws_s, dws_want):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
