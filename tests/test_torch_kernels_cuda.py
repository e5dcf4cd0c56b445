"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import). On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -q
Tolerances: 1e-4 with f32 operands (another summation order), 2e-2 with
bf16 operands (8-bit mantissas, rounding at other points of the sums).
The attention kernels' gradients, and flash_mha's o besides, are compared
sample by sample relative to that sample's largest plain value
(_sample_err): 1e-5 f32, 5e-3 bf16 (chip_smoke.SAMPLE_TOL; on these
inputs an H100 reads at most 1.1e-6 / 2.9e-3 for gradients and 2.3e-6 /
2.6e-3 for o: `python3 chip_ab.py --run .:sample_err`). The fused
layer's out, attn and dx are held sample by sample too (the same limits),
its weight gradients, sums over every row, relative to max(1, the plain
gradient's max). The sparse-graph kernels are all f32: 1e-5 relative to
max(1, |plain|).
"""

import dataclasses

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.ops import sparse as sp
from raindrop_tpu_torch.nn.transformer import _layer_init
from test_torch_packed_plan import wide_smem
from test_torch_split_plan import hd_stream_smem, split_smem_mirror

TOL = {None: 1e-4, "bfloat16": 2e-2}
SAMPLE_TOL = {None: 1e-5, "bfloat16": 5e-3}
SEED = 20231
# flash_mha_packed's shapes: hd 8, 36 (eICU), 80 (P12), 84, 42 (4-byte
# copies), 128, and 13 and 3 (odd: 2-byte plain loads, unpaired stores),
# T within a tile, one row past it, and the longest; the sensor-wise head
# dims 140 (eICU: tensor cores at hd_pad 144 in bf16), 170 (PAM) and 360
# (P12), and 129 (one past the old limit). Past hd_pad 144 bf16 takes the
# two-warpgroup kernels ("tc_wide"; f32 the scalar Narrow geometry up to
# hd 192, Wide beyond): hd 145, 193 and 199 (odd: 2-byte loads), 150
# (4-byte copies), 160, 176 (the first wide width), 192, 256 and 368 (the
# last), T 33, 64, 65, 100, 215 and 1024 (a 32-row key tile ending inside
# a 64-row block, and the longest)
PACKED_SHAPES = [(13, 16, 2), (130, 72, 2), (215, 160, 2), (70, 84, 1), (64, 84, 2),
                 (65, 256, 2), (1024, 84, 2), (1024, 256, 2), (100, 26, 2), (65, 6, 2),
                 (300, 280, 2), (65, 340, 2), (215, 720, 2), (33, 720, 2), (64, 258, 2),
                 (65, 290, 2), (33, 320, 2), (100, 300, 2), (215, 352, 2), (64, 384, 2),
                 (65, 386, 2), (1024, 512, 2), (215, 736, 2), (1024, 736, 2), (64, 199, 1)]
pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _lengths(gen, B, T):
    lengths = torch.randint(0, T + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[-1] = 0, 1, T
    return lengths


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def _sample_err(got, want, lengths):
    """Per sample, max |got - want| over that sample's max |want|; samples
    of length 0 or 1 over the largest max |want| of all (with one key
    p = 1: their dq and dk are rounding noise about 0)."""
    B = got.shape[0]
    diff = (got - want).abs().reshape(B, -1).amax(1)
    scale = want.abs().reshape(B, -1).amax(1)
    scale = torch.where(lengths > 1, scale, scale.max())
    return (diff / scale.clamp(min=torch.finfo(torch.float32).tiny)).max().item()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,nhead", PACKED_SHAPES)
def test_flash_kernel_matches_plain(gen, T, d, nhead, cd, rate):
    B = 5
    q, k, v = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(3))
    lengths = _lengths(gen, B, T)
    before = fa.flash_mha_packed.launches
    o, lse = fa._packed_fwd(q, k, v, lengths, SEED, rate, cd, nhead)
    assert fa.flash_mha_packed.launches == before + 1
    po, plse = fa._packed_fwd_plain(q, k, v, lengths, nhead, fa.operand_dtype(cd),
                                    SEED, rate)
    torch.cuda.synchronize()
    assert (o - po).abs().max().item() <= TOL[cd]
    assert (lse - plse).abs().max().item() <= TOL[cd]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,nhead", PACKED_SHAPES)
def test_flash_backward_matches_plain(gen, T, d, nhead, cd, rate):
    B = 5
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda")
                  for _ in range(4))
    lengths = _lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    o, lse = fa._packed_fwd(q, k, v, lengths, SEED, rate, cd, nhead)
    before = fa.flash_mha_packed.bwd_launches
    got = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    assert fa.flash_mha_packed.bwd_launches == before + 1
    again = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    want = fa._packed_bwd_plain(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert torch.isfinite(a).all() and torch.equal(a, a2)
        assert (a[0] == 0).all()                 # the length-0 sample
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL[cd]


# the baselines' head dims at their T (baselines/): the transformer at eICU
# (hd 15: 2-byte copies) and P12 (hd 26: 4-byte copies), Raindrop v1 at
# eICU (hd 35, 2 bytes) and P12 (hd 90, 4 bytes)
BASELINE_HEADS = [(300, 15), (215, 26), (300, 35), (215, 90)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,hd", BASELINE_HEADS)
def test_packed_pair_at_the_baselines_head_dims(gen, T, hd, cd, rate):
    B, nhead = 8, 2
    d = nhead * hd
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda")
                  for _ in range(4))
    lengths = _lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    plan = fa.packed_plan(B, T, d, nhead, od)
    assert plan.route == ("tc" if cd else "scalar")
    before = (fa.flash_mha_packed.launches, fa.flash_mha_packed.bwd_launches)
    o, lse = fa._packed_fwd(q, k, v, lengths, SEED, rate, cd, nhead)
    got = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    assert (fa.flash_mha_packed.launches, fa.flash_mha_packed.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    po, plse = fa._packed_fwd_plain(q, k, v, lengths, nhead, od, SEED, rate)
    want = fa._packed_bwd_plain(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    torch.cuda.synchronize()
    assert (o - po).abs().max().item() <= TOL[cd]
    assert (lse - plse).abs().max().item() <= TOL[cd]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and (a[0] == 0).all()
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL[cd]


def test_flash_autograd_reaches_the_backward_kernels(gen):
    q, k, v = (torch.randn((3, 40, 16), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    lengths = torch.tensor([40, 7, 0], device="cuda")
    before = fa.flash_mha_packed.bwd_launches
    fa.flash_mha_packed(q, k, v, lengths, SEED, 0.2, None, 2).square().sum().backward()
    assert fa.flash_mha_packed.bwd_launches == before + 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T,d,nhead", PACKED_SHAPES)
def test_flash_tensor_core_kernels_match_the_scalar_ones(gen, T, d, nhead, rate):
    """bf16: the plan's route (the tensor cores on one warpgroup up to
    hd_pad 144, on two past it) against the previous design (the scalar
    kernels, same operands): forward, dq, dk, dv, each launch counted on
    its route, bit-equal on a repeat, exact zeros for the length-0 sample."""
    B = 5
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda")
                  for _ in range(4))
    lengths = _lengths(gen, B, T)
    od = torch.bfloat16
    route = fa.packed_plan(B, T, d, nhead, od).route
    assert route == ("tc" if -(-(d // nhead) // 16) * 16 <= fa.TC_MAX_HD_PAD else "tc_wide")
    names = ("tc_launches", "tc_bwd_launches", "tc_wide_launches", "tc_wide_bwd_launches")
    before = [getattr(fa.flash_mha_packed, n) for n in names]
    o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, nhead, od)
    o2, lse2 = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, nhead, od)
    so, slse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, impl="scalar")
    got = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    again = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    want = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g,
                               impl="scalar")
    tc, wide = int(route == "tc"), int(route == "tc_wide")
    assert [getattr(fa.flash_mha_packed, n) - b for n, b in zip(names, before)] == [
        2 * tc, 2 * tc, 2 * wide, 2 * wide]
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o - so).abs().max().item() <= TOL["bfloat16"]
    assert (lse - slse).abs().max().item() <= TOL["bfloat16"]
    assert (o[0] == 0).all() and (lse[0] == fa.NEG_INF).all()
    for a, a2, b in zip(got, again, want):
        assert torch.isfinite(a).all() and torch.equal(a, a2)
        assert (a[0] == 0).all()
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL["bfloat16"]


def test_flash_autograd_in_bf16_reaches_the_tensor_core_kernels(gen):
    q, k, v = (torch.randn((3, 215, 160), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    lengths = torch.tensor([215, 70, 0], device="cuda")
    f0 = (fa.flash_mha_packed.launches, fa.flash_mha_packed.tc_launches)
    b0 = (fa.flash_mha_packed.bwd_launches, fa.flash_mha_packed.tc_bwd_launches)
    fa.flash_mha_packed(q, k, v, lengths, SEED, 0.2, "bfloat16", 2).square().sum().backward()
    assert (fa.flash_mha_packed.launches, fa.flash_mha_packed.tc_launches) == (
        f0[0] + 1, f0[1] + 1)
    assert (fa.flash_mha_packed.bwd_launches, fa.flash_mha_packed.tc_bwd_launches) == (
        b0[0] + 1, b0[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert all((t.grad[2] == 0).all() for t in (q, k, v))


def test_flash_autograd_in_bf16_reaches_the_wide_kernels(gen):
    """P12's sensor-wise head (hd 360, d 720) in bf16 through autograd: one
    forward and one backward launch, both on the two-warpgroup route."""
    q, k, v = (torch.randn((3, 215, 720), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    lengths = torch.tensor([215, 70, 0], device="cuda")
    f0 = (fa.flash_mha_packed.launches, fa.flash_mha_packed.tc_wide_launches)
    b0 = (fa.flash_mha_packed.bwd_launches, fa.flash_mha_packed.tc_wide_bwd_launches)
    fa.flash_mha_packed(q, k, v, lengths, SEED, 0.2, "bfloat16", 2).square().sum().backward()
    assert (fa.flash_mha_packed.launches, fa.flash_mha_packed.tc_wide_launches) == (
        f0[0] + 1, f0[1] + 1)
    assert (fa.flash_mha_packed.bwd_launches, fa.flash_mha_packed.tc_wide_bwd_launches) == (
        b0[0] + 1, b0[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert all((t.grad[2] == 0).all() for t in (q, k, v))


@pytest.mark.parametrize("hd", [145, 150, 176, 177, 193, 256, 360, 368])
def test_wide_shared_memory_is_the_mirror(gen, hd):
    """rd_packed_smem on the "tc_wide" route equals the Python mirror
    (tests/test_torch_packed_plan.py wide_smem), which the CPU tests hold
    within a block at every width."""
    plan = fa.packed_plan(8, 215, 2 * hd, 2, torch.bfloat16)
    assert plan.route == "tc_wide"
    assert fa.packed_smem(8, 215, 2 * hd, 2, torch.bfloat16) == wide_smem(plan.hd_pad)


def _random_layer(gen, d, ffn):
    p = _layer_init(gen, d, ffn, "cuda")

    def r(n, base=0.0):
        return base + 0.1 * torch.randn((n,), generator=gen, device="cuda")

    p["in_proj_b"] = r(3 * d)
    p["out_proj"]["b"] = r(d)
    p["ln1"] = {"scale": r(d, 1.0), "bias": r(d)}
    p["ln2"] = {"scale": r(d, 1.0), "bias": r(d)}
    return p


# the fused layer's widths: d 16, 24 (3 heads), 84 (PAM), 152, 340 (PAM-sw:
# in bf16 the attention on two warpgroups, "tc_wide", at hd 170), 300 (hd
# 150, "tc_wide" at hd_pad 176) and 192 at one head (hd 192, "tc_wide" at
# hd_pad 208); T = 100 ends 36 rows into a 64-row tile, with lengths 0, 1,
# 45 and 100
FUSED_SHAPES = [(13, 16, 32, 2), (600, 84, 136, 2), (70, 24, 48, 3), (600, 340, 136, 2),
                (33, 340, 136, 2), (100, 84, 136, 2), (100, 340, 136, 2),
                (100, 300, 136, 2), (100, 192, 64, 1)]


def _attn_route(d, ffn, nhead, cd):
    """The fused plan's attention route for the operands of `cd`; in bf16
    "tc_wide" exactly where the head dim pads past 144."""
    route = fe.fused_plan(d, ffn, nhead, fa.operand_dtype(cd)).attn_route
    hd_pad = -(-(d // nhead) // 16) * 16
    assert route == ("scalar" if cd is None else "tc" if hd_pad <= 144 else "tc_wide")
    return route


def _fused_lengths(gen, B, T):
    lengths = _lengths(gen, B, T)
    if T == 100:
        lengths[2] = 45
    return lengths


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,ffn,nhead", FUSED_SHAPES + [(60, 152, 272, 2)])
def test_fused_backward_matches_plain(gen, T, d, ffn, nhead, cd, rate):
    B = 4
    p = _random_layer(gen, d, ffn)
    x, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(2))
    lengths = _fused_lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    _, attn, lse = fe._fused_fwd(p, x, lengths, SEED, rate, cd, nhead)
    ws = fe._flatten(p)
    before = fe.fused_encoder_layer.bwd_launches
    before_tc = fe.fused_encoder_layer.tc_bwd_launches
    before_wide = fe.fused_encoder_layer.tc_wide_bwd_launches
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, attn, lse, g,
                                 scratch_out=scratch)
    assert fe.fused_encoder_layer.bwd_launches == before + 1
    tc = fe.fused_plan(d, ffn, nhead, od).route == "tc"
    assert tc == (cd == "bfloat16")
    assert fe.fused_encoder_layer.tc_bwd_launches == before_tc + tc
    wide = _attn_route(d, ffn, nhead, cd) == "tc_wide"
    assert fe.fused_encoder_layer.tc_wide_bwd_launches == before_wide + wide
    dx2, dws2 = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, attn, lse, g)
    # a relu pre-activation within rounding of zero may take the other
    # branch on the two sides, an O(1) change of single elements: the plain
    # version takes the kernel's branches, so the arithmetic is compared
    relu_on = scratch["f"].reshape(B, T, ffn) > 0
    pdx, pdws = fe._fused_bwd_plain(p, x, lengths, SEED, rate, nhead, od, attn, lse, g,
                                    relu_on=relu_on)
    torch.cuda.synchronize()
    assert torch.isfinite(dx).all() and torch.equal(dx, dx2)
    assert _sample_err(dx, pdx, lengths) <= SAMPLE_TOL[cd]
    assert (scratch["dqkv"].reshape(B, T, 3 * d)[0] == 0).all()
    names = ["/".join(path) for path in fe._WEIGHTS]
    for name, a, a2, b in zip(names, dws, dws2, pdws):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all() and torch.equal(a, a2), name
        assert _rel_err(a, b) <= TOL[cd], (name, _rel_err(a, b))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,ffn,nhead", FUSED_SHAPES)
def test_fused_kernel_matches_plain(gen, T, d, ffn, nhead, cd, rate):
    B = 4
    p = _random_layer(gen, d, ffn)
    x = torch.randn((B, T, d), generator=gen, device="cuda")
    lengths = _fused_lengths(gen, B, T)
    before = fe.fused_encoder_layer.launches
    before_tc = fe.fused_encoder_layer.tc_launches
    before_wide = fe.fused_encoder_layer.tc_wide_launches
    got = fe._fused_fwd(p, x, lengths, SEED, rate, cd, nhead)
    assert fe.fused_encoder_layer.launches == before + 1
    assert fe.fused_encoder_layer.tc_launches == before_tc + (cd == "bfloat16")
    wide = _attn_route(d, ffn, nhead, cd) == "tc_wide"
    assert fe.fused_encoder_layer.tc_wide_launches == before_wide + wide
    again = fe._fused_fwd(p, x, lengths, SEED, rate, cd, nhead)
    want = fe._fused_fwd_plain(p, x, lengths, nhead, fa.operand_dtype(cd), SEED,
                               rate)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _sample_err(got[0], want[0], lengths) <= SAMPLE_TOL[cd]
    assert _sample_err(got[1], want[1], lengths) <= SAMPLE_TOL[cd]
    assert (got[2] - want[2]).abs().max().item() <= TOL[cd]
    assert (got[1][0] == 0).all() and (got[2][0] == fa.NEG_INF).all()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T,d,ffn,nhead", FUSED_SHAPES)
def test_fused_tensor_core_route_matches_the_scalar_one(gen, T, d, ffn, nhead, rate):
    """bf16: the tensor-core route against the previous design's scalar
    kernels (impl="scalar"), forward and backward."""
    B, od = 4, torch.bfloat16
    p = _random_layer(gen, d, ffn)
    x, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(2))
    lengths = _fused_lengths(gen, B, T)
    ws = fe._flatten(p)
    tc = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, nhead, od)
    sc = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, nhead, od, "scalar")
    for a, b in zip(tc[:2], sc[:2]):
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL["bfloat16"]
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, *tc[1:], g,
                                 scratch_out=scratch)
    sdx, sdws = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, *tc[1:], g,
                                   impl="scalar")
    torch.cuda.synchronize()
    assert _sample_err(dx, sdx, lengths) <= SAMPLE_TOL["bfloat16"]
    for a, b in zip(dws, sdws):
        assert _rel_err(a, b) <= TOL["bfloat16"]


def test_fused_autograd_in_bf16_reaches_the_tensor_core_kernels(gen):
    B, T, d, ffn, nhead = 3, 100, 84, 136, 2
    p = _random_layer(gen, d, ffn)
    x = torch.randn((B, T, d), generator=gen, device="cuda", requires_grad=True)
    lengths = torch.tensor([0, 45, T], dtype=torch.int32, device="cuda")
    counts = [fe.fused_encoder_layer.tc_launches, fe.fused_encoder_layer.tc_bwd_launches]
    out = fe.fused_encoder_layer(p, x, lengths, SEED, 0.2, "bfloat16", nhead)
    out.sum().backward()
    assert fe.fused_encoder_layer.tc_launches == counts[0] + 1
    assert fe.fused_encoder_layer.tc_bwd_launches == counts[1] + 1
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("impl", ["auto", "scalar"])
@pytest.mark.parametrize("od", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,ffn,nhead", [(16, 32, 2), (24, 48, 3), (84, 136, 2),
                                         (152, 272, 2), (340, 136, 2), (72, 136, 2),
                                         (26, 48, 2), (290, 136, 2), (300, 136, 2),
                                         (352, 136, 2), (177, 64, 1), (192, 64, 1)])
def test_fused_plan_is_the_c_librarys(gen, d, ffn, nhead, od, impl):
    """The wrapper's launch plan (fused_plan) is the one the C entry points
    recompute, field for field: route, tile rows, copy width, threads and
    shared bytes of all eight launches."""
    plan = fe.fused_plan(d, ffn, nhead, od, impl)
    ints, ok = fe.c_plan(d, ffn, nhead, od, plan.route, plan["attn_fwd"].copy_bytes)
    assert ok and ints == tuple(plan.as_ints)


@pytest.mark.parametrize("route", [0, 1, 3])
def test_fused_entry_points_refuse_another_attention_route(gen, monkeypatch, route):
    """At PAM-sw (hd 170) the C entry points take the attention on route 2
    (tc_wide) alone: a plan whose three attention launches carry route 0, 1
    or 3 (when this test was written a value they did not know; now
    "hd_stream", which no plan at hd 170 holds), every other field as it
    was, is refused by the forward and the backward."""
    B, T, d, ffn, nhead, od = 2, 33, 340, 136, 2, torch.bfloat16
    p = _random_layer(gen, d, ffn)
    x, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(2))
    lengths = torch.tensor([0, T], dtype=torch.int32, device="cuda")
    ws = fe._flatten(p)
    _, attn, lse = fe._fused_fwd_cuda(ws, x, lengths, SEED, 0.0, nhead, od)
    real = fe.fused_plan

    class Tampered:
        def __init__(self, plan):
            self.route, self.attn_route = plan.route, plan.attn_route
            ints = list(plan.as_ints)
            for i in (1, 4, 5):          # attn_fwd, attn_dq, attn_dkv
                assert ints[5 * i] == 2
                ints[5 * i] = route
            self.as_ints = type(plan.as_ints)(*ints)

    monkeypatch.setattr(fe, "fused_plan", lambda *a, **k: Tampered(real(*a, **k)))
    with pytest.raises(RuntimeError, match="forward"):
        fe._fused_fwd_cuda(ws, x, lengths, SEED, 0.0, nhead, od)
    with pytest.raises(RuntimeError, match="backward"):
        fe._fused_bwd_cuda(ws, x, lengths, SEED, 0.0, nhead, od, attn, lse, g)


# the "stream" route: forced (impl="stream") at the widths of the other
# routes' tests, where every attention route below hd 368 is reached (in
# bf16 hd 8 and 42 on "tc", 170, 192 and 200 on "tc_wide"; the scalar
# kernels in f32), and taken by itself past them: P12-sw at T=600 with 2
# heads (hd 360, "tc_wide" at hd_pad 368 in bf16) and 1 (hd 720,
# "tc_cluster" in bf16, "hd_stream" in f32), P19-sw (d 680), a head of 400
# at 3 heads, and T = 100, 33
# and 65 rows ending inside a tile
STREAM_SHAPES = [(13, 16, 32, 2, "stream"), (100, 84, 136, 2, "stream"),
                 (33, 340, 136, 2, "stream"), (100, 192, 64, 1, "stream"),
                 (65, 400, 136, 2, "stream"), (64, 720, 288, 2, "auto"),
                 (100, 720, 288, 1, "auto"), (33, 680, 272, 2, "auto"),
                 (65, 1200, 96, 3, "auto"), (600, 720, 288, 1, "auto")]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,ffn,nhead,impl", STREAM_SHAPES)
def test_fused_stream_route_matches_plain(gen, T, d, ffn, nhead, impl, cd, rate):
    """The "stream" route's forward and backward against the plain versions
    (held as the other routes are), every launch counted on it (and past hd
    368 on "tc_cluster" in bf16, "hd_stream" in f32), and a repeat
    bit-equal."""
    B = 3 if T == 600 else 4
    od = fa.operand_dtype(cd)
    plan = fe.fused_plan(d, ffn, nhead, od, impl)
    hd = d // nhead
    assert plan.route == "stream"
    past = "hd_stream" if cd is None else "tc_cluster"
    assert plan.attn_route == (past if hd > fa.MAX_HEAD_DIM else "scalar" if cd is None
                               else "tc" if -(-hd // 16) * 16 <= 144 else "tc_wide")
    p = _random_layer(gen, d, ffn)
    x, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(2))
    lengths = _fused_lengths(gen, B, T)
    ws = fe._flatten(p)
    layer = fe.fused_encoder_layer
    attrs = ("launches", "stream_launches", "hd_stream_launches", "bwd_launches",
             "stream_bwd_launches", "hd_stream_bwd_launches", "tc_cluster_launches",
             "tc_cluster_bwd_launches")
    before = {a: getattr(layer, a) for a in attrs}
    got = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, nhead, od, impl)
    again = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, nhead, od, impl)
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, *got[1:], g,
                                 scratch_out=scratch, impl=impl)
    dx2, dws2 = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, *got[1:], g,
                                   impl=impl)
    hds, tcc = plan.attn_route == "hd_stream", plan.attn_route == "tc_cluster"
    assert {a: getattr(layer, a) - before[a] for a in attrs} == {
        "launches": 2, "stream_launches": 2, "hd_stream_launches": 2 * hds,
        "bwd_launches": 2, "stream_bwd_launches": 2, "hd_stream_bwd_launches": 2 * hds,
        "tc_cluster_launches": 2 * tcc, "tc_cluster_bwd_launches": 2 * tcc}
    want = fe._fused_fwd_plain(p, x, lengths, nhead, od, SEED, rate)
    relu_on = scratch["f"].reshape(B, T, ffn) > 0
    pdx, pdws = fe._fused_bwd_plain(p, x, lengths, SEED, rate, nhead, od, *got[1:], g,
                                    relu_on=relu_on)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _sample_err(got[0], want[0], lengths) <= SAMPLE_TOL[cd]
    assert _sample_err(got[1], want[1], lengths) <= SAMPLE_TOL[cd]
    assert (got[2] - want[2]).abs().max().item() <= TOL[cd]
    assert (got[1][0] == 0).all() and (got[2][0] == fa.NEG_INF).all()
    assert torch.isfinite(dx).all() and torch.equal(dx, dx2)
    assert _sample_err(dx, pdx, lengths) <= SAMPLE_TOL[cd]
    assert (scratch["dqkv"].reshape(B, T, 3 * d)[0] == 0).all()
    for name, a, a2, b in zip(["/".join(path) for path in fe._WEIGHTS], dws, dws2, pdws):
        assert torch.isfinite(a).all() and torch.equal(a, a2), name
        assert _rel_err(a, b) <= TOL[cd], (name, _rel_err(a, b))


@pytest.mark.parametrize("od", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,ffn,nhead", [(16, 32, 2), (84, 136, 2), (340, 136, 2),
                                         (400, 136, 1), (720, 288, 2), (720, 288, 1),
                                         (680, 272, 2), (2048, 4096, 8)])
def test_fused_stream_plan_is_the_c_librarys(gen, d, ffn, nhead, od):
    """The "stream" route's plan (forced, and where it is the only route) is
    the one the C entry points recompute, field for field."""
    for impl in ("stream", "auto"):
        plan = fe.fused_plan(d, ffn, nhead, od, impl)
        ints, ok = fe.c_plan(d, ffn, nhead, od, plan.route, plan["attn_fwd"].copy_bytes)
        assert ok and ints == tuple(plan.as_ints)


def test_wrappers_refuse_bad_inputs(gen):
    q = torch.randn((2, 8, 16), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        fa._packed_fwd(q, q, q, torch.tensor([8, 8]), None, 0.0, None, 2)
    with pytest.raises(ValueError):
        fa._packed_fwd(q, q[:, :4], q, torch.tensor([8, 8], device="cuda"),
                       None, 0.0, None, 2)
    # every head dim is taken (hd 136 was refused before the sensor-wise
    # slice, hd 369 before the "hd_stream" route; bf16 past 368 runs
    # "tc_cluster" since)
    lens = torch.tensor([16], device="cuda")
    for d in (272, 2 * (fa.MAX_HEAD_DIM + 8)):
        taken = torch.randn((1, 16, d), generator=gen, device="cuda")
        assert torch.isfinite(fa._packed_fwd(taken, taken, taken, lens, None, 0.0,
                                             "bfloat16", 2)[0]).all()
    with pytest.raises(ValueError, match="32 bits"):
        fa._packed_fwd(q, q, q, torch.tensor([8, 8], device="cuda"), None, 0.0, None, 2,
                       origin=(2 ** 31, 0, 2))


def test_fused_layer_fits_pam_sensor_wise_on_the_card(gen):
    """Every launch of the fused layer fits a block's 232,448 bytes at PAM's
    sensor-wise width (d = 340, ffn = 136, 2 heads), as the C library
    computes them, on both routes. The tensor-core route's backward row
    kernel (an f32 [64, d] buffer, the d-wide and FFN bf16 tiles padded to
    64 columns, an f32 [64, ffn] buffer, two steps of two 8 KB weight
    panels, four row statistics) takes 229,376; the scalar route's forward
    attention and tail in one CTA, as before their split, would need
    322,560. P19's
    sensor-wise width (d = 680) fits neither: the "stream" route takes it
    (its launches' shared bytes do not grow with d)."""
    bf16 = torch.bfloat16
    smem, fits = fe.fused_smem(340, 136, 2, bf16, "tc", 2)
    assert fits and max(smem.values()) <= 232448
    assert smem["bwd_rows"] == 87040 + 49152 + 24576 + 34816 + 32768 + 1024 == 229376
    assert smem["tail"] == 193536 and smem["dx"] == 163840 + 33792
    smem, fits = fe.fused_smem(340, 136, 2)
    assert fits and max(smem.values()) <= 232448
    assert smem["tail"] + smem["attn_fwd"] - 4 * 64 * 137 == 322560
    assert smem["bwd_rows"] == 218496
    assert not fe.fused_smem(680, 272, 2)[1]
    assert not fe.fused_smem(680, 272, 2, bf16, "tc", 16)[1]
    for od in (torch.float32, bf16):
        smem, fits = fe.fused_smem(680, 272, 2, od, "stream", od.itemsize)
        assert fits and max(smem.values()) <= 232448
    x = torch.randn((1, 8, 680), generator=gen, device="cuda")
    p = _random_layer(gen, 680, 272)
    for cd in (None, "bfloat16"):
        before = fe.fused_encoder_layer.stream_launches
        out = fe._fused_fwd(p, x, torch.tensor([8], device="cuda"), None, 0.0, cd, 2)[0]
        assert torch.isfinite(out).all()
        assert fe.fused_encoder_layer.stream_launches == before + 1


def _graph(gen, kind):
    """(src, dst, N) on the card: edges in shuffled order; 'knn' leaves the
    last two nodes without an incoming edge, 'skewed' gives one node a
    segment longer than a CTA's staging buffer, 'long' one longer than the
    tile route's staging of 1024 CSR positions (E = 1560)."""
    if kind == "complete":
        N = 17
        src = torch.arange(N, device="cuda").repeat_interleave(N)
        dst = torch.arange(N, device="cuda").repeat(N)
        return src, dst, N
    if kind == "knn":
        N, k = 40, 6
        dst = torch.arange(N - 2, device="cuda").repeat_interleave(k)
    else:
        N = 12
        n = 700 if kind == "skewed" else 1500
        dst = torch.cat([torch.full((n,), 3, device="cuda"),
                         torch.randint(0, N, (60,), generator=gen, device="cuda")])
    src = torch.randint(0, N, (dst.numel(),), generator=gen, device="cuda")
    order = torch.randperm(dst.numel(), generator=gen, device="cuda")
    return src[order], dst[order], N


_GRAPH_COUNTS = ("launches", "bwd_launches", *(
    f"{r}_{a}" for r in sp.ROUTES for a in ("launches", "bwd_launches")))


def _graph_counts(fn):
    return {a: getattr(fn, a) for a in _GRAPH_COUNTS}


def _launched(fn, before):
    """The launch counts of `fn` that moved since `before`."""
    return {a: n - before[a] for a, n in _graph_counts(fn).items() if n != before[a]}


def _want(fwd_route, fwd, bwd_route, bwd):
    want = {"launches": fwd, f"{fwd_route}_launches": fwd}
    if bwd:
        want.update({"bwd_launches": bwd, f"{bwd_route}_bwd_launches": bwd})
    return want


def _check_spmm(gen, src, dst, N, B, D, gather_target):
    """Both spmm kernels against the plain versions, bit-equal on a
    repeat, every launch on the plan's route (one a pass, or one for each
    MAX_BATCH samples)."""
    E = src.numel()
    x, g_out = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(2))
    gamma, g_w = (torch.randn((B, E), generator=gen, device="cuda") for _ in range(2))
    topo = sp.topology(src, dst, N)
    side = "target" if gather_target else "source"
    routes = [sp.graph_plan(B, N, E, D, f"{d}_{side}").route for d in ("fwd", "bwd")]
    if gather_target:
        assert routes == ["row", "row"]
    before = _graph_counts(sp.spmm_segment_softmax)
    out, w = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
    dx, dgamma = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
    n = len(fa.batch_chunks(B))
    assert _launched(sp.spmm_segment_softmax, before) == _want(routes[0], n, routes[1], n)
    out2, w2 = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
    dx2, dgamma2 = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
    p_out, p_w = sp._spmm_fwd_plain(x, gamma, src, dst, N, gather_target)
    p_dx, p_dgamma = sp._spmm_bwd_plain(g_out, g_w, x, w, src, dst, N, gather_target)
    torch.cuda.synchronize()
    for name, a, a2, b in (("out", out, out2, p_out), ("w", w, w2, p_w),
                           ("dx", dx, dx2, p_dx), ("dgamma", dgamma, dgamma2, p_dgamma)):
        assert torch.isfinite(a).all() and torch.equal(a, a2), name
        assert _rel_err(a, b) <= 1e-5, (name, _rel_err(a, b))
    empty = torch.bincount(dst, minlength=N) == 0
    assert (out[:, empty] == 0).all()
    # one row of logits broadcast over the batch is read in place
    row = gamma[0]
    out_b, w_b = sp._spmm_fwd_cuda(x, row[None].expand(B, -1), topo, gather_target)
    out_c, w_c = sp._spmm_fwd_cuda(x, row[None].repeat(B, 1), topo, gather_target)
    assert torch.equal(out_b, out_c) and torch.equal(w_b, w_c)
    # no gradient for gamma, no cotangent on the weights
    dx3, none = sp._spmm_bwd_cuda(g_out, None, x, w, topo, gather_target,
                                  need_dgamma=False)
    assert none is None and torch.equal(dx3, dx)


def _check_sddmm(gen, src, dst, N, B, D):
    """sddmm's kernels against the plain versions, bit-equal on a repeat,
    every launch on the plan's route."""
    E = src.numel()
    q, k = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(2))
    d_alpha = torch.randn((B, E), generator=gen, device="cuda")
    topo = sp.topology(src, dst, N)
    scale = D ** -0.5
    routes = [sp.graph_plan(B, N, E, D, kind).route for kind in ("sddmm_fwd", "sddmm_bwd")]
    before = _graph_counts(sp.sddmm)
    alpha = sp._sddmm_fwd_cuda(q, k, topo, scale)
    dq, dk = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    n = len(fa.batch_chunks(B))
    assert _launched(sp.sddmm, before) == _want(routes[0], n, routes[1], n)
    alpha2 = sp._sddmm_fwd_cuda(q, k, topo, scale)
    dq2, dk2 = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    p_alpha = sp._sddmm_fwd_plain(q, k, src, dst, scale)
    p_dq, p_dk = sp._sddmm_bwd_plain(d_alpha, q, k, src, dst, scale)
    torch.cuda.synchronize()
    for name, a, a2, b in (("alpha", alpha, alpha2, p_alpha), ("dq", dq, dq2, p_dq),
                           ("dk", dk, dk2, p_dk)):
        assert torch.isfinite(a).all() and torch.equal(a, a2), name
        assert _rel_err(a, b) <= 1e-5, (name, _rel_err(a, b))


@pytest.mark.parametrize("gather_target", [False, True])
@pytest.mark.parametrize("D", [7, 240, 1100])
@pytest.mark.parametrize("kind", ["complete", "knn", "skewed"])
def test_spmm_kernels_match_plain(gen, kind, D, gather_target):
    _check_spmm(gen, *_graph(gen, kind), 5, D, gather_target)


@pytest.mark.parametrize("D", [7, 120, 860])
@pytest.mark.parametrize("kind", ["complete", "knn", "skewed"])
def test_sddmm_kernels_match_plain(gen, kind, D):
    _check_sddmm(gen, *_graph(gen, kind), 4, D)


# the widths of the graph phases (430: the self-attention's head, 4-byte
# copies; 860 P12, 2400 PAM) and 7 (odd), at B=1 (columns split over the
# card), 2 and 128
@pytest.mark.parametrize("gather_target", [False, True])
@pytest.mark.parametrize("D", [7, 430, 860, 2400])
@pytest.mark.parametrize("B", [1, 2, 128])
@pytest.mark.parametrize("kind", ["complete", "knn", "skewed", "long"])
def test_spmm_kernels_match_plain_by_batch_and_width(gen, kind, B, D, gather_target):
    _check_spmm(gen, *_graph(gen, kind), B, D, gather_target)


@pytest.mark.parametrize("D", [7, 430, 860, 2400])
@pytest.mark.parametrize("B", [1, 2, 128])
@pytest.mark.parametrize("kind", ["complete", "knn", "skewed", "long"])
def test_sddmm_kernels_match_plain_by_batch_and_width(gen, kind, B, D):
    _check_sddmm(gen, *_graph(gen, kind), B, D)


def _csr_cut(B, D, k, kind):
    """The least N at which a graph of k edges into each node leaves the
    tile route for "csr"."""
    n = 1
    while sp.graph_plan(B, n, k * n, D, kind).route == "tile":
        n += 1
    return n


@pytest.mark.parametrize("side", [-1, 0])
@pytest.mark.parametrize("family", ["fwd_source", "sddmm_fwd"])
def test_graph_kernels_at_the_csr_edge(gen, family, side):
    """The last N on "tile" (shared bytes at their largest) and the first on
    "csr", for the weighted sums (fwd_source's cut) and the edge dot
    products (sddmm_fwd's, bwd_source's too): every kernel against its
    plain version there, each launch on its kind's route."""
    B, D, k = 2, 36, 6
    N = _csr_cut(B, D, k, family) + side
    plan = sp.graph_plan(B, N, k * N, D, family)
    assert plan.route == ("tile" if side else "csr")
    assert plan.smem <= sp.MAX_SMEM
    dst = torch.arange(N, device="cuda").repeat_interleave(k)
    src = torch.randint(0, N, (k * N,), generator=gen, device="cuda")
    order = torch.randperm(k * N, generator=gen, device="cuda")
    src, dst = src[order], dst[order]
    _check_spmm(gen, src, dst, N, B, D, False)
    _check_sddmm(gen, src, dst, N, B, D)


def test_graph_plan_of_the_kernels_matches_the_wrappers(gen):
    """rd_graph_plan (csrc/sparse_graph.cu) makes graph_plan's plan at every
    graph phase's shape and at the edges; an entry point refuses a plan
    that differs from its own."""
    shapes = [(B, N, E, D) for B in (1, 2, 128)
              for N, E in ((36, 1296), (17, 289), (128, 768), (40, 228), (12, 1560))
              for D in (7, 120, 240, 430, 860, 1100, 2400)]
    for kind in ("fwd_source", "sddmm_fwd"):
        cut = _csr_cut(2, 36, 6, kind)
        shapes += [(2, n, 6 * n, 36) for n in (cut - 1, cut)]
    shapes += [(512, 100, 10000, 64), (3, 5000, 6000, 2500)]
    for shape in shapes:
        for kind in sp.KINDS:
            for align in (16, 8, 4):
                assert sp.graph_plan_c(*shape, kind, align) == sp.graph_plan(
                    *shape, kind, align), (shape, kind, align)
    src, dst, N = _graph(gen, "knn")
    B, D, E = 2, 16, src.numel()
    x = torch.randn((B, N, D), device="cuda")
    topo = sp.topology(src, dst, N)
    out = torch.empty_like(x)
    w = torch.empty((B, E), device="cuda")
    good = sp.graph_plan(B, N, E, D, "fwd_source")
    bad = sp.GraphPlan("csr", *dataclasses.astuple(good)[1:])
    for plan, ok in ((good, True), (bad, False)):
        err = sp._lib().rd_spmm_fwd(
            x.data_ptr(), x.data_ptr(), 0, topo.table, out.data_ptr(), w.data_ptr(), B, N,
            E, D, 0, plan.address, torch.cuda.current_stream().cuda_stream)
        assert (err == 0) == ok, (plan, err)


def test_sparse_autograd_reaches_the_backward_kernels(gen):
    src, dst, N = _graph(gen, "knn")
    x = torch.randn((3, N, 24), generator=gen, device="cuda", requires_grad=True)
    gamma = torch.randn((3, src.numel()), generator=gen, device="cuda",
                        requires_grad=True)
    before = (sp.spmm_segment_softmax.bwd_launches, sp.sddmm.bwd_launches)
    out, w = sp.spmm_segment_softmax(x, gamma, src, dst, n_nodes=N)
    alpha = sp.sddmm(out, x, src, dst, 0.5)
    (alpha.square().sum() + w.sin().sum()).backward()
    assert (sp.spmm_segment_softmax.bwd_launches,
            sp.sddmm.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(x.grad).all() and torch.isfinite(gamma.grad).all()
    with pytest.raises(ValueError):      # node features on another device
        sp.spmm_segment_softmax(x.cpu(), gamma.cpu(), src, dst, n_nodes=N)
    with pytest.raises(TypeError):
        sp.sddmm(x.double(), x.double(), src, dst)


def _head_inputs(gen, B, H, T, D, layout, n=3):
    """n random [B, H, T, D] tensors: contiguous, or the strided head views
    of one [B, T, n*H*D] projection (the model's layout)."""
    if layout == "contiguous":
        return [torch.randn((B, H, T, D), generator=gen, device="cuda")
                for _ in range(n)]
    proj = torch.randn((B, T, n * H * D), generator=gen, device="cuda")
    return [t.reshape(B, T, H, D).transpose(1, 2) for t in proj.split(H * D, dim=-1)]


def _split_route(D, cd):
    """The route flash_mha's plan takes at head dim D: the tensor cores in
    bf16 (one warpgroup to hd_pad 144, two past it), scalar in f32."""
    if cd is None:
        return "scalar"
    return "tc" if -(-D // 16) * 16 <= fa.TC_MAX_HD_PAD else "tc_wide"


def _split_counts():
    return {a: getattr(fa.flash_mha, a) for a in (
        "launches", "bwd_launches", "tc_launches", "tc_bwd_launches",
        "tc_wide_launches", "tc_wide_bwd_launches")}


def _check_split_routes(before, D, cd, fwd, bwd):
    """fwd forward and bwd backward launches since `before`, every one on
    the route of D and cd (none counted on a tensor-core route in f32)."""
    got = {a: n - before[a] for a, n in _split_counts().items()}
    route = _split_route(D, cd)
    want = {"launches": fwd, "bwd_launches": bwd, "tc_launches": 0, "tc_bwd_launches": 0,
            "tc_wide_launches": 0, "tc_wide_bwd_launches": 0}
    if route != "scalar":
        want.update({f"{route}_launches": fwd, f"{route}_bwd_launches": bwd})
    assert got == want


def _against_scalar(q, k, v, lengths, cd, rate, o, grads, g):
    """In bf16, the tensor-core route against the scalar kernels (the
    previous design) on the same operands, sample by sample."""
    if cd is None:
        return
    od = fa.operand_dtype(cd)
    so, slse = fa._flash_fwd_cuda(q, k, v, lengths, SEED, rate, od, "scalar")
    prev = fa._flash_bwd_cuda(q.detach(), k.detach(), v.detach(), lengths, SEED, rate,
                              od, so, slse, g, "scalar")
    torch.cuda.synchronize()
    assert _sample_err(o, so, lengths) <= SAMPLE_TOL[cd]
    for a, b in zip(grads, prev):
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL[cd]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("T,H,D", [(13, 2, 8), (70, 2, 42), (600, 2, 42),
                                   (1152, 2, 42), (200, 1, 128)])
def test_flash_mha_kernels_match_plain(gen, T, H, D, layout, cd, rate):
    """Forward, dq and dk+dv of flash_mha in both of the JAX package's
    regimes (T <= 1024 and beyond), through the autograd function, on the
    plan's route (bf16: the tensor cores; f32: the scalar kernels); in bf16
    also against the scalar kernels."""
    B = 4
    q, k, v = (x.requires_grad_() for x in _head_inputs(gen, B, H, T, D, layout))
    g = torch.randn((B, H, T, D), generator=gen, device="cuda")
    lengths = _lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    before = _split_counts()
    o = fa.flash_mha(q, k, v, lengths, SEED, rate, cd)
    got = torch.autograd.grad(o, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(o, (q, k, v), g)
    _check_split_routes(before, D, cd, 1, 2)
    _, lse = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    po, plse = fa._flash_fwd_plain(q, k, v, lengths, od, SEED, rate)
    want = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), lengths, SEED,
                               rate, od, o.detach(), lse, g)
    torch.cuda.synchronize()
    assert (o - po).abs().max().item() <= TOL[cd]
    assert (lse - plse).abs().max().item() <= TOL[cd]
    assert _sample_err(o, po, lengths) <= SAMPLE_TOL[cd]
    assert (o[0] == 0).all()
    for a, a2, b in zip(got, again, want):
        assert torch.isfinite(a).all() and torch.equal(a, a2)
        assert (a[0] == 0).all()               # the length-0 sample
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL[cd]
    _against_scalar(q, k, v, lengths, cd, rate, o.detach(), got, g)


def _split_vs_packed(gen, B, T, H, D, lengths):
    """flash_mha on the head views of [B, T, H * D] tensors against
    flash_mha_packed on the tensors themselves, dropout 0.2, through
    autograd: f32 operands agree to 1e-5 (both hash b * H + h, the global
    row and the global column, so the masks are the same; the scalar
    kernels' geometries differ). In bf16 the two launch the same
    tensor-core kernels (flash_packed_{fwd,dq,dkv}_{tc,wide}.cu) at the same
    padded head dim on the same values: flash_mha's operands sit in heads
    zero-padded to 8 columns where flash_mha_packed's are dense with the pad
    zeroed in shared memory, so only the strides and the copy width differ,
    and o, lse, dq, dk and dv are bit-equal (delta is the same per-row sum
    of do * o in the same memory order)."""
    q, k, v, g = (torch.randn((B, T, H * D), generator=gen, device="cuda")
                  for _ in range(4))

    def heads(x):
        return x.reshape(B, T, H, D).transpose(1, 2)

    for cd in (None, "bfloat16"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        p_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        split = fa.flash_mha(*(heads(x) for x in leaves), lengths, SEED, 0.2, cd)
        split.backward(heads(g))
        packed = fa.flash_mha_packed(*p_leaves, lengths, SEED, 0.2, cd, H)
        packed.backward(g)
        _, lse = fa._flash_fwd(*(heads(x) for x in (q, k, v)), lengths, SEED, 0.2, cd)
        _, plse = fa._packed_fwd(q, k, v, lengths, SEED, 0.2, cd, H)
        torch.cuda.synchronize()
        assert split.transpose(1, 2).is_contiguous()
        merged = split.transpose(1, 2).reshape(B, T, H * D)
        if cd is None:
            assert (merged - packed).abs().max() <= 1e-5
            continue
        assert torch.equal(merged, packed) and torch.equal(lse, plse)
        for a, b in zip(leaves, p_leaves):
            assert torch.equal(a.grad, b.grad)


def test_flash_mha_matches_the_packed_kernel(gen):
    """flash_mha against flash_mha_packed at P12's width (hd 80)."""
    B, T, H, D = 4, 215, 2, 80
    _split_vs_packed(gen, B, T, H, D, _lengths(gen, B, T))


# flash_mha past hd 128: the Narrow geometry at 48 columns a thread (129,
# PAM-sw's 170, 192 its last), the Wide one (32-row blocks and tiles: 193
# its first, 200, P12-sw's 360, 368 its last); T one row past a block, one
# past the JAX package's one-program regime, and PAM-sw's window
WIDE_SPLIT_HD = [129, 170, 192, 193, 200, 360, 368]


def _wide_lengths(gen, B, T):
    """Lengths 0, 1, T, one that ends 45 rows into a 64-row block (past
    row 32: a block's second half in the Narrow geometry, the next block
    in the Wide one) and one at random."""
    lengths = _lengths(gen, B, T)
    lengths[2] = min(T, 64 * (T // 128) + 45)
    return lengths


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("T", [65, 1025, 2048])
@pytest.mark.parametrize("D", WIDE_SPLIT_HD)
def test_flash_mha_kernels_match_plain_at_wide_heads(gen, D, T, layout, cd, rate):
    """flash_mha past hd 128, forward, dq and dk+dv through the autograd
    function, B = 5, H = 2, on the plan's route (bf16: "tc_wide" past
    hd_pad 144, "tc" at 129-144; f32 the scalar kernels): against the plain
    version and, in bf16, the scalar kernels, bit-equal on a repeat, exact
    zeros for the length-0 sample; every row of every block is compared (o
    is torch.empty: a row no CTA wrote would differ)."""
    B, H = 5, 2
    q, k, v = (x.requires_grad_() for x in _head_inputs(gen, B, H, T, D, layout))
    g = torch.randn((B, H, T, D), generator=gen, device="cuda")
    lengths = _wide_lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    before = _split_counts()
    o = fa.flash_mha(q, k, v, lengths, SEED, rate, cd)
    o2 = fa.flash_mha(q, k, v, lengths, SEED, rate, cd)
    got = torch.autograd.grad(o, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(o, (q, k, v), g)
    _check_split_routes(before, D, cd, 2, 2)
    _, lse = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    po, plse = fa._flash_fwd_plain(q, k, v, lengths, od, SEED, rate)
    want = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), lengths, SEED,
                               rate, od, o.detach(), lse, g)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    assert (o - po).abs().max().item() <= TOL[cd]
    assert (lse - plse).abs().max().item() <= TOL[cd]
    assert _sample_err(o, po, lengths) <= SAMPLE_TOL[cd]
    assert (o[0] == 0).all() and (lse[0] == fa.NEG_INF).all()
    for a, a2, b in zip(got, again, want):
        assert torch.isfinite(a).all() and torch.equal(a, a2)
        assert (a[0] == 0).all()               # the length-0 sample
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL[cd]
    _against_scalar(q, k, v, lengths, cd, rate, o.detach(), got, g)


@pytest.mark.parametrize("D", [1, 42, 128, 144, 145, *WIDE_SPLIT_HD])
def test_flash_mha_shared_memory_fits_a_block(gen, D):
    """The shared bytes of flash_mha's three launches on each route the
    head dim takes, as the C library computes them, are the mirror's
    (test_torch_split_plan.split_smem_mirror) and fit a block (232,448
    bytes); the Narrow geometry's dk/dv pass is the largest at hd 192, the
    Wide one's at 368; no route takes hd 369."""
    routes = ["scalar", "tc" if -(-D // 16) * 16 <= fa.TC_MAX_HD_PAD else "tc_wide"]
    for route in routes:
        smem = fa.split_smem(D, route)
        assert smem == split_smem_mirror(route, D)
        assert len(smem) == 3 and 0 < min(smem) and max(smem) <= 232448
    smem = fa.split_smem(D)
    if D == 192:
        assert smem[2] == 4 * (2 * 128 * 193 + 2 * 64 * 65 + 128)
    if D == 368:
        assert smem[2] == 4 * (2 * 64 * 369 + 2 * 32 * 33 + 64)
    for route in ("scalar", "tc", "tc_wide"):
        with pytest.raises(ValueError, match=str(fa.MAX_HEAD_DIM + 1)):
            fa.split_smem(fa.MAX_HEAD_DIM + 1, route)


@pytest.mark.parametrize("D", [42, 170])
def test_flash_mha_autograd_copies_by_16_bytes(gen, D, monkeypatch):
    """On the model's path (f32 head views of one projection, bf16
    operands) the forward and the backward of the autograd function both
    launch on the padded cast: 16-byte copies of pad8_cols(D) columns. The
    backward takes the columns from the forward's context, and casts the
    incoming gradient into padded heads too."""
    plans = []

    def record(*args, real=fa.split_plan, **kwargs):
        plans.append(real(*args, **kwargs))
        return plans[-1]

    monkeypatch.setattr(fa, "split_plan", record)
    B, H, T = 3, 2, 130
    q, k, v = (x.requires_grad_() for x in _head_inputs(gen, B, H, T, D, "projection"))
    g = torch.randn((B, H, T, D), generator=gen, device="cuda")
    before = _split_counts()
    o = fa.flash_mha(q, k, v, _lengths(gen, B, T), SEED, 0.2, "bfloat16")
    o.backward(g)
    _check_split_routes(before, D, "bfloat16", 1, 1)
    assert len(plans) == 2
    for plan in plans:
        assert (plan.route, plan.copy_bytes, plan.cols) == (
            _split_route(D, "bfloat16"), 16, fa.pad8_cols(D))
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


@pytest.mark.parametrize("D", [170, 360])
def test_flash_mha_matches_the_packed_kernel_at_wide_heads(gen, D):
    """As test_flash_mha_matches_the_packed_kernel, at PAM-sw's head dim
    and P12-sw's: f32 on the scalar kernels (the Narrow geometry at 170,
    Wide at 360), bf16 on the two-warpgroup tensor-core routines."""
    B, T, H = 4, 215, 2
    _split_vs_packed(gen, B, T, H, D, _wide_lengths(gen, B, T))


def test_flash_mha_refuses_a_head_dim_past_the_kernels(gen):
    """flash_mha refused head dims past MAX_HEAD_DIM (368) on the card with
    NotImplementedError; now the "hd_stream" route takes them, forward and
    backward, as the plain version does."""
    q = torch.randn((1, 1, 16, 376), generator=gen, device="cuda").requires_grad_()
    lengths = torch.tensor([16], device="cuda")
    before = fa.flash_mha.hd_stream_launches, fa.flash_mha.hd_stream_bwd_launches
    o = fa.flash_mha(q, q, q, lengths)
    o.backward(torch.ones_like(o))
    assert (fa.flash_mha.hd_stream_launches, fa.flash_mha.hd_stream_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    po, _ = fa._flash_fwd_plain(q.detach(), q.detach(), q.detach(), lengths, torch.float32)
    assert (o - po).abs().max().item() <= TOL[None]
    assert torch.isfinite(q.grad).all()


def _plain_rungs(monkeypatch):
    """The encoder's kernel rungs on their wrappers' plain versions (the
    operands rounded as the kernels round them), on the card."""
    from raindrop_tpu_torch.nn import transformer as tr

    monkeypatch.setattr(tr, "flash_mha_packed", lambda q, k, v, lengths, seed, rate, cd, nhead: (
        fa._packed_fwd_plain(q, k, v, lengths, nhead, fa.operand_dtype(cd),
                             fa._seed_int(seed), rate)[0]))
    monkeypatch.setattr(tr, "fused_encoder_layer", lambda p, x, lengths, seed, rate, cd, nhead: (
        fe._fused_fwd_plain(p, x, lengths, nhead, fa.operand_dtype(cd),
                            fa._seed_int(seed), rate)[0]))


def _model_step(cfg, params, batch, seeds):
    """Loss, logits and the live leaves' gradients of one training forward."""
    from raindrop_tpu_torch.models.raindrop import raindrop_apply, raindrop_param_mask
    from raindrop_tpu_torch.train.checkpoint import flatten_params

    mask = dict(flatten_params(raindrop_param_mask(cfg)))
    leaves = {p: t.detach().clone().requires_grad_(mask[p])
              for p, t in flatten_params(params)}
    tree = {}
    for p, t in leaves.items():
        *parents, leaf = p.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    src, static, times, lengths, y = batch
    logits, _ = raindrop_apply(tree, cfg, src, static, times, lengths, train=True,
                               seeds=seeds)
    loss = torch.nn.functional.cross_entropy(logits, y)
    loss.backward()
    return loss, logits, {p: t.grad for p, t in leaves.items() if mask[p]}


@pytest.mark.parametrize("preset", ["PAM", "P12"])
def test_bf16_compute_model_matches_the_plain_kernels(gen, preset, monkeypatch):
    """compute_dtype='bfloat16' at a preset's full width (B=8, the shipped
    dropout on the same seeds): every launch, forward and backward, on the
    tensor cores; logits and gradients f32; loss, logits and each live
    leaf's gradient within 2e-2 (relative to max(1, |plain|)) of the same
    step on the kernels' plain versions."""
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.utils.dropout import DropoutSeeds

    cfg = dataset_config(preset, compute_dtype="bfloat16")
    params = raindrop_init(1, cfg, device="cuda")
    B, T, F = 8, cfg.max_len, cfg.d_inp
    lengths = _lengths(gen, B, T)
    live = torch.arange(T, device="cuda")[:, None] < lengths[None, :]
    obs = (torch.rand((T, B, F), generator=gen, device="cuda") > 0.5) & live[..., None]
    vals = torch.randn((T, B, F), generator=gen, device="cuda") * obs
    src = torch.cat([vals, obs.float()], dim=-1)
    times = torch.cumsum(torch.rand((T, B), generator=gen, device="cuda"), 0) * live
    static = (torch.randn((B, cfg.d_static), generator=gen, device="cuda")
              if cfg.static else None)
    y = torch.arange(B, device="cuda") % cfg.n_classes
    batch = (src, static, times, lengths, y)
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(3), cfg.nlayers)
    fn = fe.fused_encoder_layer if preset == "PAM" else fa.flash_mha_packed
    before = (fn.tc_launches, fn.tc_bwd_launches)
    loss, logits, grads = _model_step(cfg, params, batch, seeds)
    assert (fn.tc_launches - before[0], fn.tc_bwd_launches - before[1]) == (
        cfg.nlayers, cfg.nlayers)
    assert logits.dtype == torch.float32
    _plain_rungs(monkeypatch)
    ploss, plogits, pgrads = _model_step(cfg, params, batch, seeds)
    assert abs(loss.item() - ploss.item()) <= 2e-2 * abs(ploss.item())
    assert _rel_err(logits, plogits) <= 2e-2
    for path, g in grads.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), path
        assert _rel_err(g, pgrads[path]) <= 2e-2, path


def test_dense_beta_block_matches_coo_on_the_card(gen):
    """use_beta at P12's width (B=16): the dense block against two COO
    layers on the complete graph, the same kept edges, out and alpha within
    1e-5 relative to max(1, |COO|)."""
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.graph import propagate as prop
    from raindrop_tpu_torch.models.raindrop import _complete_edges, raindrop_init

    cfg = dataset_config("P12", use_beta=True)
    params = raindrop_init(2, cfg, device="cuda")
    B, F, T = 16, cfg.d_inp, cfg.max_len
    x = torch.randn((B, F, T * cfg.d_ob), generator=gen, device="cuda")
    pe = torch.randn((B, T, cfg.d_pe), generator=gen, device="cuda")
    p1, p2 = params["ob_propagation"], params["ob_propagation_layer2"]
    with torch.no_grad():
        out_d, alpha_d, mask = prop.raindrop_propagate_beta_dense(
            p1, p2, x, pe, torch.ones((F, F), device="cuda"), ob_dim=cfg.d_ob,
            uniform_adj=True, return_mask=True)
        kw = dict(ob_dim=cfg.d_ob, n_nodes=F)
        o1, (e2, a1) = prop.ob_propagate_coo(p1, x, pe, torch.stack(_complete_edges(F, "cuda")),
                                             torch.ones(F * F, device="cuda"),
                                             use_beta=True, **kw)
        out_c, (_, a2) = prop.ob_propagate_coo(p2, o1, pe, e2, a1, **kw)
    kept = torch.zeros((B, F * F), dtype=torch.bool, device="cuda")
    kept.scatter_(1, e2[:, 0] * F + e2[:, 1], True)
    assert torch.equal(kept.reshape(B, F, F), mask)
    assert _rel_err(out_d, out_c) <= 1e-5
    assert _rel_err(alpha_d, a2[..., 0]) <= 1e-5


def test_prefetch_copy_stream_orders_every_batch(gen):
    """The streaming pipeline's staging on the card: every batch, read on
    the consumer's stream the moment it comes out (a device-side clone,
    which would race an unfinished copy without the executor's wait), equals
    the host gather exactly; 12 MB batches, depth 2, 24 batches, so pinned
    and device buffers are recycled under the copies."""
    import numpy as np

    from raindrop_tpu_torch.data.prefetch import PrefetchExecutor

    rng = np.random.default_rng(0)
    N, T, C = 2048, 64, 96
    data = {"P": rng.standard_normal((N, T, C), dtype=np.float32),
            "y": rng.integers(0, 8, N).astype(np.int32)}
    idx = [rng.integers(0, N, 512) for _ in range(24)]
    seen = []
    with PrefetchExecutor(data, idx, depth=2, device="cuda",
                          dtypes={"y": torch.int64}) as ex:
        for batch in ex:
            seen.append({k: v.clone() for k, v in batch.items()})
    assert len(seen) == len(idx)
    for i, got in zip(idx, seen):
        assert got["y"].dtype == torch.int64
        assert torch.equal(got["P"].cpu(), torch.from_numpy(data["P"][i]))
        assert torch.equal(got["y"].cpu(), torch.from_numpy(data["y"][i]).long())


@pytest.mark.parametrize("case", range(5))
def test_flop_credit_matches_the_plain_count_on_the_card(gen, case):
    """Each kernel wrapper's forward and backward on the card: the FLOPs its
    launches credit (the counter sees no matmul of theirs) against
    FlopCounterMode's count of the plain PyTorch form on the card, within
    2% (torch_flops_util.FLOP_TOL; equal at these shapes)."""
    import torch_flops_util as fu

    name, credit, fn, args = fu.credit_cases()[case]
    kernel = fn(*args, "cuda", True)
    plain = fn(*args, "cuda", False)
    assert kernel == credit, name
    assert abs(kernel - plain) <= fu.FLOP_TOL * plain, (name, kernel, plain)


@pytest.mark.parametrize("name", ["mtgnn", "transformer", "transformer_ctx",
                                  "transformer_moe", "seft", "raindrop_v1", "grud",
                                  "mtand", "dgm2", "ipnet"])
def test_a_baseline_step_repeats_bit_for_bit(gen, name):
    """One Trainer step of a baseline family at P12's published widths
    (B=64, dropout 0.2, the same seeds), twice from the same state: the loss
    and every parameter bit-equal, with cuDNN's global determinism flag
    unset (MTGNN's convolutions are matrix products of the port's own,
    baselines/mtgnn._conv2d; cuDNN's weight gradient adds with atomics).
    The families chip_smoke.baselines_phase checks the same way."""
    from raindrop_tpu_torch.baselines.adapters import make_baseline
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.train.trainer import Trainer

    assert not torch.backends.cudnn.deterministic
    cfg = dataset_config("P12")
    fam = make_baseline(name, cfg, device="cuda")
    params = fam.init_fn(0)
    B, T, F = 64, cfg.max_len, cfg.d_inp
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
    live = (torch.arange(T, device="cuda")[None] < lengths[:, None]).float()
    mask = (torch.rand(B, T, F, generator=gen, device="cuda") > 0.6).float() * live[..., None]
    values = torch.randn(B, T, F, generator=gen, device="cuda") * mask
    batch = {"P": torch.cat([values, mask], -1),
             "time": torch.cumsum(torch.rand(B, T, generator=gen, device="cuda"), 1) * live,
             "static": torch.randn(B, cfg.d_static, generator=gen, device="cuda"),
             "y": torch.arange(B, device="cuda") % cfg.n_classes}
    seeds = (fam.draw_seeds(torch.Generator().manual_seed(0), B)
             if fam.draw_seeds else None)
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, TrainConfig(dataset="P12", batch_size=B, learning_rate=1e-4),
                     device="cuda", params=params, init_fn=fam.init_fn,
                     apply_fn=fam.apply_fn, draw_seeds=fam.draw_seeds)
        loss, _ = tr.train_step(batch, seeds)
        runs.append((loss.clone(), [t.detach().clone() for _, t in tr.live]))
        del tr
    assert not torch.backends.cudnn.deterministic
    (l0, p0), (l1, p1) = runs
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert len(p0) == len(p1) and all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,nhead", [(215, 160, 2), (65, 340, 2), (1024, 84, 2)])
def test_packed_pair_at_a_shard_origin_is_the_full_launch(gen, T, d, nhead, cd):
    """A batch shard at (b0, 0, H) and one head at (b0, h, H): o, lse,
    dq, dk, dv bit-equal to those rows and heads of the full launch, and
    the shard's launch against its plain version at its origin."""
    od = fa.operand_dtype(cd)
    B, hd = 6, d // nhead
    q, k, v, g = (torch.randn(B, T, d, generator=gen, device="cuda") for _ in range(4))
    lengths = _lengths(gen, B, T)
    o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.2, nhead, od)
    grads = fa._packed_bwd_cuda(q, k, v, lengths, SEED, 0.2, nhead, od, o, lse, g)
    for b0, n, h in ((2, 3, None), (1, 4, 1), (5, 1, 0)):
        rows = slice(b0, b0 + n)
        cols = slice(None) if h is None else slice(h * hd, (h + 1) * hd)
        nh, origin = (nhead, (b0, 0, nhead)) if h is None else (1, (b0, h, nhead))
        args = [x[rows][..., cols].contiguous() for x in (q, k, v)]
        o_s, lse_s = fa._packed_fwd_cuda(*args, lengths[rows], SEED, 0.2, nh, od,
                                         origin=origin)
        assert torch.equal(o_s, o[rows][..., cols])
        assert torch.equal(lse_s, lse[rows][:, slice(None) if h is None else slice(h, h + 1)])
        g_s = fa._packed_bwd_cuda(*args, lengths[rows], SEED, 0.2, nh, od, o_s, lse_s,
                                  g[rows][..., cols].contiguous(), origin=origin)
        for got, want in zip(g_s, grads):
            assert torch.equal(got, want[rows][..., cols])
        want_o, _ = fa._packed_fwd_plain(*args, lengths[rows], nh, od, SEED, 0.2, origin)
        assert _sample_err(o_s, want_o, lengths[rows]) < SAMPLE_TOL[cd]
    # a launch's origin may pass sample 65535 (a split call's later
    # launches); an index past 32 bits is refused
    with pytest.raises(ValueError, match="origin"):
        fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.2, nhead, od,
                            origin=(2 ** 32 // nhead, 0, nhead))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_fused_layer_at_a_shard_origin_is_the_full_launch(gen, cd):
    """Rows b0.. of the fused layer at (b0, 0, H): out, attn, lse and dx
    bit-equal to the full launch's rows."""
    od = fa.operand_dtype(cd)
    B, T, d, ffn, H = 5, 600, 84, 136, 2
    ws = fe._flatten(_layer_init(gen, d, ffn, device="cuda"))
    x, g = (torch.randn(B, T, d, generator=gen, device="cuda") for _ in range(2))
    lengths = _lengths(gen, B, T)
    out, attn, lse = fe._fused_fwd_cuda(ws, x, lengths, SEED, 0.2, H, od)
    dx, _ = fe._fused_bwd_cuda(ws, x, lengths, SEED, 0.2, H, od, attn, lse, g)
    rows = slice(2, 5)
    o_s, a_s, l_s = fe._fused_fwd_cuda(ws, x[rows], lengths[rows], SEED, 0.2, H, od,
                                       origin=(2, 0, H))
    assert torch.equal(o_s, out[rows]) and torch.equal(a_s, attn[rows])
    assert torch.equal(l_s, lse[rows])
    dx_s, _ = fe._fused_bwd_cuda(ws, x[rows], lengths[rows], SEED, 0.2, H, od, a_s, l_s,
                                 g[rows], origin=(2, 0, H))
    assert torch.equal(dx_s, dx[rows])


# ------------------------------------------------------------------ past hd 368
# The scalar route past 368 ("hd_stream": f32, and bf16 on request, the
# previous design) and the tensor-core one ("tc_cluster": bf16 by default)
HD_STREAM_HD = [372, 720, 1023, 1024]


def _hd_stream_counts(fn):
    return fn.hd_stream_launches, fn.hd_stream_bwd_launches


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("hd", HD_STREAM_HD)
def test_hd_stream_packed_pair_matches_plain(gen, hd, cd, rate):
    """flash_mha_packed past hd 368 ("hd_stream", both dtypes: bf16 on
    impl="hd_stream"), one and two heads, T=65 (a block ending one row
    past 64): o, lse and the three gradients against the plain versions,
    bit-equal on a repeat, zeros for the length-0 sample, every launch
    counted on the route."""
    od = fa.operand_dtype(cd)
    for nhead, T in ((1, 65), (2, 33)):
        B, d = 4, nhead * hd
        q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(4))
        lengths = _lengths(gen, B, T)
        before = _hd_stream_counts(fa.flash_mha_packed)
        o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, "hd_stream")
        grads, grads2 = (fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse,
                                             g, "hd_stream") for _ in range(2))
        assert _hd_stream_counts(fa.flash_mha_packed) == (before[0] + 1, before[1] + 2)
        po, plse = fa._packed_fwd_plain(q, k, v, lengths, nhead, od, SEED, rate)
        want = fa._packed_bwd_plain(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
        torch.cuda.synchronize()
        assert (o - po).abs().max().item() <= TOL[cd]
        assert (lse - plse).abs().max().item() <= TOL[cd]
        assert (o[0] == 0).all()
        for a, a2, b in zip(grads, grads2, want):
            assert torch.isfinite(a).all() and torch.equal(a, a2) and (a[0] == 0).all()
            assert _sample_err(a, b, lengths) <= SAMPLE_TOL[cd]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("hd", HD_STREAM_HD)
def test_hd_stream_flash_mha_matches_plain(gen, hd, layout, cd, rate):
    """flash_mha past hd 368 on "hd_stream" (bf16 on impl="hd_stream") at
    T=130, H=2, on contiguous heads and on the model's strided views."""
    B, H, T = 3, 2, 130
    q, k, v = _head_inputs(gen, B, H, T, hd, layout)
    g = torch.randn((B, H, T, hd), generator=gen, device="cuda")
    lengths = _lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    before = _hd_stream_counts(fa.flash_mha)
    o, lse = fa._flash_fwd_cuda(q, k, v, lengths, SEED, rate, od, "hd_stream")
    got = fa._flash_bwd_cuda(q, k, v, lengths, SEED, rate, od, o, lse, g, "hd_stream")
    assert _hd_stream_counts(fa.flash_mha) == (before[0] + 1, before[1] + 1)
    po, _ = fa._flash_fwd_plain(q, k, v, lengths, od, SEED, rate)
    want = fa._flash_bwd_plain(q, k, v, lengths, SEED, rate, od, o, lse, g)
    torch.cuda.synchronize()
    assert _sample_err(o, po, lengths) <= SAMPLE_TOL[cd]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and (a[0] == 0).all()
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL[cd]


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("hd", [200, 360, 368])
def test_hd_stream_is_the_wide_scalar_kernels_bits(gen, hd, cd):
    """Below 369 impl="hd_stream" reaches the new route: its forward and
    gradients are the scalar Wide kernels' bits (the same geometry and
    summation orders in shared memory that does not grow with hd)."""
    od = fa.operand_dtype(cd)
    B, T, nhead = 3, 100, 2
    q, k, v, g = (torch.randn((B, T, nhead * hd), generator=gen, device="cuda")
                  for _ in range(4))
    lengths = _lengths(gen, B, T)
    runs = []
    for impl in ("scalar", "hd_stream"):
        o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.2, nhead, od, impl)
        runs.append((o, lse, *fa._packed_bwd_cuda(q, k, v, lengths, SEED, 0.2, nhead, od,
                                                  o, lse, g, impl)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [369, 720, 1024, 4096])
def test_hd_stream_shared_memory_is_the_mirror(gen, D):
    """The shared bytes of the route's three launches, as both C entry
    files compute them, are the mirror's at every hd."""
    assert fa.split_smem(D, "hd_stream") == hd_stream_smem()
    assert fa.packed_smem(2, 64, 2 * D, 2, torch.float32) == hd_stream_smem()
    assert fa.packed_smem(2, 64, D, 1, torch.bfloat16, "hd_stream") == hd_stream_smem()


TC_CLUSTER_PACKED = [372, 720, 1023]
TC_CLUSTER_SPLIT = [720, 1024]


def _tc_cluster_counts(fn):
    return fn.tc_cluster_launches, fn.tc_cluster_bwd_launches


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", TC_CLUSTER_PACKED)
def test_tc_cluster_packed_pair_matches_plain(gen, hd, rate):
    """flash_mha_packed past hd 368 in bf16 ("tc_cluster": 2 CTAs of 192
    columns at hd 372, 3 of 256 at 720, 4 of 256 at 1023, its odd rows
    copied by 2-byte loads), one head at T=215 and two at T=65 (a block
    ending one row past 64), lengths with 0, 1 and T: o, lse and the three
    gradients against the plain versions, a repeat bit-equal, exact zeros
    for the length-0 sample, every launch counted on the route."""
    od = torch.bfloat16
    for nhead, T in ((1, 215), (2, 65)):
        B, d = 5, nhead * hd
        q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(4))
        lengths = _lengths(gen, B, T)
        assert fa.packed_plan(B, T, d, nhead, od).route == "tc_cluster"
        before = _tc_cluster_counts(fa.flash_mha_packed)
        runs = []
        for _ in range(2):
            o, lse = fa._packed_fwd(q, k, v, lengths, SEED, rate, "bfloat16", nhead)
            runs.append((o, lse, *fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead,
                                                      od, o, lse, g)))
        assert _tc_cluster_counts(fa.flash_mha_packed) == (before[0] + 2, before[1] + 2)
        o, lse, *grads = runs[0]
        po, plse = fa._packed_fwd_plain(q, k, v, lengths, nhead, od, SEED, rate)
        want = fa._packed_bwd_plain(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        assert (o - po).abs().max().item() <= TOL["bfloat16"]
        assert (lse - plse).abs().max().item() <= TOL["bfloat16"]
        assert (o[0] == 0).all() and (lse[0] == fa.NEG_INF).all()
        for a, b in zip(grads, want):
            assert torch.isfinite(a).all() and (a[0] == 0).all()
            assert _sample_err(a, b, lengths) <= SAMPLE_TOL["bfloat16"]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("hd", TC_CLUSTER_SPLIT)
def test_tc_cluster_flash_mha_matches_plain(gen, hd, layout, rate):
    """flash_mha past hd 368 in bf16 through the autograd function
    ("tc_cluster", the operands' padded cast), T=600, one head on
    contiguous heads and on the model's strided views: o and the three
    gradients against the plain versions, a repeat bit-equal, zeros for
    the length-0 sample, one launch each way on the route."""
    B, H, T = 3, 1, 600
    q, k, v = (x.requires_grad_() for x in _head_inputs(gen, B, H, T, hd, layout))
    g = torch.randn((B, H, T, hd), generator=gen, device="cuda")
    lengths = _lengths(gen, B, T)
    od = torch.bfloat16
    runs = []
    for _ in range(2):
        before = _tc_cluster_counts(fa.flash_mha)
        o = fa.flash_mha(q, k, v, lengths, SEED, rate, "bfloat16")
        runs.append((o, *torch.autograd.grad(o, (q, k, v), g)))
        assert _tc_cluster_counts(fa.flash_mha) == (before[0] + 1, before[1] + 1)
    o, *got = runs[0]
    _, lse = fa._flash_fwd(q, k, v, lengths, SEED, rate, "bfloat16")
    po, _ = fa._flash_fwd_plain(q, k, v, lengths, od, SEED, rate)
    want = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), lengths, SEED, rate,
                               od, o.detach(), lse, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert _sample_err(o, po, lengths) <= SAMPLE_TOL["bfloat16"]
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and (a[0] == 0).all()
        assert _sample_err(a, b, lengths) <= SAMPLE_TOL["bfloat16"]


@pytest.mark.parametrize("D", [369, 720, 769, 1024, 1793, 2048])
def test_tc_cluster_shared_memory_and_occupancy(gen, D):
    """The shared bytes of the route's three launches, as both C entry
    files compute them, are the Python mirror's (fa.tc_cluster_smem, which
    tests/test_torch_tc_cluster.py holds to the header's sizes), and the
    card holds at least one cluster of each kernel at once."""
    smem = fa.tc_cluster_smem(fa.tc_cluster_size(D)[1])
    assert fa.split_smem(D, "tc_cluster") == smem
    assert fa.packed_smem(2, 64, D, 1, torch.bfloat16) == smem
    assert fa.packed_smem(2, 64, 3 * D, 3, torch.bfloat16) == smem
    assert min(fa.tc_cluster_occupancy(D)) >= 1


# ------------------------------------------------------------ past 65535 samples
BIG_B = 70000


def _big_lengths(gen, B, T):
    lengths = _lengths(gen, B, T)
    lengths[65535], lengths[65536] = 0, T
    return lengths


def _big_err(got, want, lengths, cd):
    """_sample_err over every sample in f32; in bf16 over the 128 samples
    at each end of either launch (SAMPLE_TOL comes from readings at B=128:
    the largest of 70000 bf16 samples passes it, chip_smoke.big_batch_phase
    prints how far)."""
    if cd is None or got.shape[0] < BIG_B:
        return _sample_err(got, want, lengths)
    ends = torch.cat([torch.arange(0, 128), torch.arange(65535 - 128, 65535 + 128),
                      torch.arange(BIG_B - 128, BIG_B)]).to(got.device)
    return _sample_err(got[ends], want[ends], lengths[ends])


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_packed_pair_takes_70000_samples(gen, cd):
    """Two launches a pass at origins 0 and 65535, dropout 0.2: the masks
    past sample 65535 are the plain version's (JAX's hash at that bh)."""
    B, T, d, nhead = BIG_B, 8, 64, 2
    od = fa.operand_dtype(cd)
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(4))
    lengths = _big_lengths(gen, B, T)
    before = fa.flash_mha_packed.launches, fa.flash_mha_packed.bwd_launches
    o, lse = fa._packed_fwd(q, k, v, lengths, SEED, 0.2, cd, nhead)
    grads = fa._packed_bwd_cuda(q, k, v, lengths, SEED, 0.2, nhead, od, o, lse, g)
    assert (fa.flash_mha_packed.launches, fa.flash_mha_packed.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    po, plse = fa._packed_fwd_plain(q, k, v, lengths, nhead, od, SEED, 0.2)
    want = fa._packed_bwd_plain(q, k, v, lengths, SEED, 0.2, nhead, od, o, lse, g)
    tail = [x[65535:].contiguous() for x in (q, k, v, lengths)]
    o2, lse2 = fa._packed_fwd_cuda(*tail, SEED, 0.2, nhead, od, origin=(65535, 0, nhead))
    assert torch.equal(o2, o[65535:]) and torch.equal(lse2, lse[65535:])
    torch.cuda.synchronize()
    assert _big_err(o, po, lengths, cd) <= SAMPLE_TOL[cd]
    assert (lse - plse).abs().max().item() <= TOL[cd]
    for a, b in zip(grads, want):
        assert _big_err(a, b, lengths, cd) <= SAMPLE_TOL[cd]


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("B,H", [(BIG_B, 2), (2, BIG_B)])
def test_flash_mha_takes_70000_samples_or_heads(gen, B, H, cd):
    T, D = 8, 16
    od = fa.operand_dtype(cd)
    q, k, v = (x.requires_grad_() for x in _head_inputs(gen, B, H, T, D, "projection"))
    g = torch.randn((B, H, T, D), generator=gen, device="cuda")
    lengths = _lengths(gen, B, T)
    before = fa.flash_mha.launches, fa.flash_mha.bwd_launches
    o = fa.flash_mha(q, k, v, lengths, SEED, 0.2, cd)
    got = torch.autograd.grad(o, (q, k, v), g)
    assert (fa.flash_mha.launches, fa.flash_mha.bwd_launches) == (before[0] + 2,
                                                                  before[1] + 2)
    _, lse = fa._flash_fwd(q, k, v, lengths, SEED, 0.2, cd)
    po, plse = fa._flash_fwd_plain(q, k, v, lengths, od, SEED, 0.2)
    want = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), lengths, SEED, 0.2,
                               od, o.detach(), lse, g)
    torch.cuda.synchronize()
    assert (lse - plse).abs().max().item() <= TOL[cd]
    assert _big_err(o, po, lengths, cd) <= SAMPLE_TOL[cd]
    for a, b in zip(got, want):
        assert _big_err(a, b, lengths, cd) <= SAMPLE_TOL[cd]


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_fused_layer_takes_70000_samples(gen, cd):
    """PAM's width at T=16, dropout 0.2: out, attn, lse and dx sample by
    sample, the weight gradients (the two launches' sums added) relative."""
    B, T, d, ffn, nhead = BIG_B, 16, 84, 136, 2
    od = fa.operand_dtype(cd)
    p = _random_layer(gen, d, ffn)
    x, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(2))
    lengths = _big_lengths(gen, B, T)
    ws = fe._flatten(p)
    before = fe.fused_encoder_layer.launches, fe.fused_encoder_layer.bwd_launches
    out, attn, lse = fe._fused_fwd_cuda(ws, x, lengths, SEED, 0.2, nhead, od)
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, x, lengths, SEED, 0.2, nhead, od, attn, lse, g,
                                 scratch_out=scratch)
    assert (fe.fused_encoder_layer.launches, fe.fused_encoder_layer.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    pout, pattn, plse = fe._fused_fwd_plain(p, x, lengths, nhead, od, SEED, 0.2)
    relu_on = scratch["f"].reshape(B, T, ffn) > 0
    pdx, pdws = fe._fused_bwd_plain(p, x, lengths, SEED, 0.2, nhead, od, attn, lse, g,
                                    relu_on=relu_on)
    torch.cuda.synchronize()
    for a, b in ((out, pout), (attn, pattn), (dx, pdx)):
        assert torch.isfinite(a).all() and _big_err(a, b, lengths, cd) <= SAMPLE_TOL[cd]
    assert (lse - plse).abs().max().item() <= TOL[cd]
    for a, b in zip(dws, pdws):
        assert _rel_err(a, b) <= TOL[cd]


def test_graph_kernels_take_70000_samples(gen):
    src, dst, N = _graph(gen, "knn")
    for gather_target in (False, True):
        _check_spmm(gen, src, dst, N, BIG_B, 8, gather_target)
    _check_sddmm(gen, src, dst, N, BIG_B, 8)
