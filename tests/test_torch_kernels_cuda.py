"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import). On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -q
Tolerances: 1e-4 with f32 operands (another summation order), 2e-2 with
bf16 operands (8-bit mantissas, rounding at other points of the sums).
The attention kernels' gradients, and flash_mha's o besides, are compared
sample by sample relative to that sample's largest plain value
(_sample_err): 1e-5 f32, 5e-3 bf16 (chip_smoke.SAMPLE_TOL; on these
inputs an H100 reads at most 1.1e-6 / 2.0e-3 for gradients and 2.3e-6 /
2.6e-3 for o: `python3 chip_ab.py --run .:sample_err`). The fused
layer's out, attn and dx are held sample by sample too (the same limits),
its weight gradients, sums over every row, relative to max(1, the plain
gradient's max). The sparse-graph kernels are all f32: 1e-5 relative to
max(1, |plain|).
"""

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.ops import sparse as sp
from raindrop_tpu_torch.nn.transformer import _layer_init

TOL = {None: 1e-4, "bfloat16": 2e-2}
SAMPLE_TOL = {None: 1e-5, "bfloat16": 5e-3}
SEED = 20231
# flash_mha_packed's shapes: hd 8, 36 (eICU), 80 (P12), 84, 42 (4-byte
# copies), 128, and 13 and 3 (odd: 2-byte plain loads, unpaired stores),
# T within a tile, one row past it, and the longest; the sensor-wise head
# dims 140 (eICU: tensor cores at hd_pad 144 in bf16), 170 (PAM: the
# scalar kernels' Narrow geometry at 48 columns a thread) and 360 (P12:
# the Wide geometry, 32-row tiles), and 129 (one past the old limit)
PACKED_SHAPES = [(13, 16, 2), (130, 72, 2), (215, 160, 2), (70, 84, 1), (64, 84, 2),
                 (65, 256, 2), (1024, 84, 2), (1024, 256, 2), (100, 26, 2), (65, 6, 2),
                 (300, 280, 2), (65, 340, 2), (215, 720, 2), (33, 720, 2), (64, 258, 2)]
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
    """bf16: the plan's route (the tensor cores up to hd_pad 144) against the
    previous design (the scalar kernels, same operands): forward, dq, dk,
    dv; past hd_pad 144 the plan takes the scalar kernels themselves."""
    B = 5
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device="cuda")
                  for _ in range(4))
    lengths = _lengths(gen, B, T)
    od = torch.bfloat16
    tc = int(fa.packed_plan(B, T, d, nhead, od).route == "tc")
    assert tc == (d // nhead <= fa.TC_MAX_HD_PAD)
    tc0 = (fa.flash_mha_packed.tc_launches, fa.flash_mha_packed.tc_bwd_launches)
    o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, nhead, od)
    so, slse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, impl="scalar")
    got = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g)
    want = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, nhead, od, o, lse, g,
                               impl="scalar")
    assert (fa.flash_mha_packed.tc_launches,
            fa.flash_mha_packed.tc_bwd_launches) == (tc0[0] + tc, tc0[1] + tc)
    torch.cuda.synchronize()
    assert (o - so).abs().max().item() <= TOL["bfloat16"]
    assert (lse - slse).abs().max().item() <= TOL["bfloat16"]
    assert (o[0] == 0).all() and (lse[0] == fa.NEG_INF).all()
    for a, b in zip(got, want):
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
# the tensor cores' row products with the scalar attention at hd 170);
# T = 100 ends 36 rows into a 64-row tile, with lengths 0, 1, 45 and 100
FUSED_SHAPES = [(13, 16, 32, 2), (600, 84, 136, 2), (70, 24, 48, 3), (600, 340, 136, 2),
                (33, 340, 136, 2), (100, 84, 136, 2), (100, 340, 136, 2)]


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
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, attn, lse, g,
                                 scratch_out=scratch)
    assert fe.fused_encoder_layer.bwd_launches == before + 1
    tc = fe.fused_plan(d, ffn, nhead, od).route == "tc"
    assert tc == (cd == "bfloat16")
    assert fe.fused_encoder_layer.tc_bwd_launches == before_tc + tc
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
    got = fe._fused_fwd(p, x, lengths, SEED, rate, cd, nhead)
    assert fe.fused_encoder_layer.launches == before + 1
    assert fe.fused_encoder_layer.tc_launches == before_tc + (cd == "bfloat16")
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
                                         (26, 48, 2)])
def test_fused_plan_is_the_c_librarys(gen, d, ffn, nhead, od, impl):
    """The wrapper's launch plan (fused_plan) is the one the C entry points
    recompute, field for field: route, tile rows, copy width, threads and
    shared bytes of all eight launches."""
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
    # head dims up to 368 are taken (hd 136 was refused before the
    # sensor-wise slice); past it the packed kernels refuse
    lens = torch.tensor([16], device="cuda")
    taken = torch.randn((1, 16, 272), generator=gen, device="cuda")
    assert torch.isfinite(fa._packed_fwd(taken, taken, taken, lens, None, 0.0,
                                         "bfloat16", 2)[0]).all()
    wide = torch.randn((1, 16, 2 * (fa.MAX_HEAD_DIM + 8)), generator=gen, device="cuda")
    with pytest.raises(ValueError, match=str(fa.MAX_HEAD_DIM)):
        fa._packed_fwd(wide, wide, wide, lens, None, 0.0, "bfloat16", 2)


def test_fused_layer_fits_pam_sensor_wise_on_the_card(gen):
    """Every launch of the fused layer fits a block's 232,448 bytes at PAM's
    sensor-wise width (d = 340, ffn = 136, 2 heads), as the C library
    computes them, on both routes. The tensor-core route's backward row
    kernel (an f32 [64, d] buffer, the d-wide and FFN bf16 tiles padded to
    64 columns, an f32 [64, ffn] buffer, two steps of two 8 KB weight
    panels, four row statistics) takes 229,376; the scalar route's forward
    attention and tail in one CTA, as before their split, would need
    322,560. P19's
    sensor-wise width (d = 680) fits neither: the model runs the dense rung
    there."""
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
    x = torch.randn((1, 8, 680), generator=gen, device="cuda")
    p = _random_layer(gen, 680, 272)
    for cd in (None, "bfloat16"):
        with pytest.raises(ValueError, match="do not take"):
            fe._fused_fwd(p, x, torch.tensor([8], device="cuda"), None, 0.0, cd, 2)


def _graph(gen, kind):
    """(src, dst, N) on the card: edges in shuffled order; 'knn' leaves the
    last two nodes without an incoming edge, 'skewed' gives one node a
    segment longer than a CTA's staging buffer."""
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
        dst = torch.cat([torch.full((700,), 3, device="cuda"),
                         torch.randint(0, N, (60,), generator=gen, device="cuda")])
    src = torch.randint(0, N, (dst.numel(),), generator=gen, device="cuda")
    order = torch.randperm(dst.numel(), generator=gen, device="cuda")
    return src[order], dst[order], N


@pytest.mark.parametrize("gather_target", [False, True])
@pytest.mark.parametrize("D", [7, 240, 1100])
@pytest.mark.parametrize("kind", ["complete", "knn", "skewed"])
def test_spmm_kernels_match_plain(gen, kind, D, gather_target):
    src, dst, N = _graph(gen, kind)
    B, E = 5, src.numel()
    x, g_out = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(2))
    gamma, g_w = (torch.randn((B, E), generator=gen, device="cuda") for _ in range(2))
    topo = sp.topology(src, dst, N)
    before = (sp.spmm_segment_softmax.launches, sp.spmm_segment_softmax.bwd_launches)
    out, w = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
    dx, dgamma = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
    assert (sp.spmm_segment_softmax.launches,
            sp.spmm_segment_softmax.bwd_launches) == (before[0] + 1, before[1] + 1)
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


@pytest.mark.parametrize("D", [7, 120, 860])
@pytest.mark.parametrize("kind", ["complete", "knn", "skewed"])
def test_sddmm_kernels_match_plain(gen, kind, D):
    src, dst, N = _graph(gen, kind)
    B, E = 4, src.numel()
    q, k = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(2))
    d_alpha = torch.randn((B, E), generator=gen, device="cuda")
    topo = sp.topology(src, dst, N)
    scale = D ** -0.5
    before = (sp.sddmm.launches, sp.sddmm.bwd_launches)
    alpha = sp._sddmm_fwd_cuda(q, k, topo, scale)
    dq, dk = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    assert (sp.sddmm.launches, sp.sddmm.bwd_launches) == (before[0] + 1, before[1] + 1)
    dq2, dk2 = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    p_alpha = sp._sddmm_fwd_plain(q, k, src, dst, scale)
    p_dq, p_dk = sp._sddmm_bwd_plain(d_alpha, q, k, src, dst, scale)
    torch.cuda.synchronize()
    assert _rel_err(alpha, p_alpha) <= 1e-5
    for name, a, a2, b in (("dq", dq, dq2, p_dq), ("dk", dk, dk2, p_dk)):
        assert torch.isfinite(a).all() and torch.equal(a, a2), name
        assert _rel_err(a, b) <= 1e-5, (name, _rel_err(a, b))


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


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("T,H,D", [(13, 2, 8), (70, 2, 42), (600, 2, 42),
                                   (1152, 2, 42), (200, 1, 128)])
def test_flash_mha_kernels_match_plain(gen, T, H, D, layout, cd, rate):
    """Forward, dq and dk+dv of flash_mha in both of the JAX package's
    regimes (T <= 1024 and beyond), through the autograd function."""
    B = 4
    q, k, v = (x.requires_grad_() for x in _head_inputs(gen, B, H, T, D, layout))
    g = torch.randn((B, H, T, D), generator=gen, device="cuda")
    lengths = _lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    f0, b0 = fa.flash_mha.launches, fa.flash_mha.bwd_launches
    o = fa.flash_mha(q, k, v, lengths, SEED, rate, cd)
    got = torch.autograd.grad(o, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(o, (q, k, v), g)
    assert (fa.flash_mha.launches, fa.flash_mha.bwd_launches) == (f0 + 1, b0 + 2)
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


def test_flash_mha_matches_the_packed_kernel(gen):
    """Both hash b * H + h, the global row and the global column: the same
    seed gives the same masks, so the outputs agree to rounding."""
    B, T, H, D = 4, 215, 2, 80
    q, k, v = (torch.randn((B, T, H * D), generator=gen, device="cuda")
               for _ in range(3))
    lengths = _lengths(gen, B, T)
    packed = fa.flash_mha_packed(q, k, v, lengths, SEED, 0.2, None, H)
    split = fa.flash_mha(*(x.reshape(B, T, H, D).transpose(1, 2) for x in (q, k, v)),
                         lengths, SEED, 0.2, None)
    torch.cuda.synchronize()
    assert split.transpose(1, 2).is_contiguous()
    assert (split.transpose(1, 2).reshape(B, T, H * D) - packed).abs().max() <= 1e-5


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
    function, B = 5, H = 2: against the plain version, bit-equal on a
    repeat, exact zeros for the length-0 sample; every row of every block
    is compared (o is torch.empty: a row no CTA wrote would differ)."""
    B, H = 5, 2
    q, k, v = (x.requires_grad_() for x in _head_inputs(gen, B, H, T, D, layout))
    g = torch.randn((B, H, T, D), generator=gen, device="cuda")
    lengths = _wide_lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    f0, b0 = fa.flash_mha.launches, fa.flash_mha.bwd_launches
    o = fa.flash_mha(q, k, v, lengths, SEED, rate, cd)
    o2 = fa.flash_mha(q, k, v, lengths, SEED, rate, cd)
    got = torch.autograd.grad(o, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(o, (q, k, v), g)
    assert (fa.flash_mha.launches, fa.flash_mha.bwd_launches) == (f0 + 2, b0 + 2)
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


@pytest.mark.parametrize("D", [1, 42, 128, *WIDE_SPLIT_HD])
def test_flash_mha_shared_memory_fits_a_block(gen, D):
    """The shared bytes of flash_mha's three launches, as the C library
    computes them, fit a block (232,448 bytes) at every head dim it takes;
    the Narrow geometry's dk/dv pass is the largest at hd 192, the Wide
    one's at 368."""
    smem = fa.split_smem(D)
    assert len(smem) == 3 and 0 < min(smem) and max(smem) <= 232448
    if D == 192:
        assert smem[2] == 4 * (2 * 128 * 193 + 2 * 64 * 65 + 128)
    if D == 368:
        assert smem[2] == 4 * (2 * 64 * 369 + 2 * 32 * 33 + 64)
    with pytest.raises(ValueError, match=str(fa.MAX_HEAD_DIM + 1)):
        fa.split_smem(fa.MAX_HEAD_DIM + 1)


@pytest.mark.parametrize("D", [170, 360])
def test_flash_mha_matches_the_packed_kernel_at_wide_heads(gen, D):
    """As test_flash_mha_matches_the_packed_kernel, at PAM-sw's head dim
    (the Narrow geometry) and P12-sw's (Wide), f32 operands, dropout 0.2."""
    B, T, H = 4, 215, 2
    q, k, v = (torch.randn((B, T, H * D), generator=gen, device="cuda")
               for _ in range(3))
    lengths = _wide_lengths(gen, B, T)
    packed = fa.flash_mha_packed(q, k, v, lengths, SEED, 0.2, None, H)
    split = fa.flash_mha(*(x.reshape(B, T, H, D).transpose(1, 2) for x in (q, k, v)),
                         lengths, SEED, 0.2, None)
    torch.cuda.synchronize()
    assert (split.transpose(1, 2).reshape(B, T, H * D) - packed).abs().max() <= 1e-5


def test_flash_mha_refuses_a_head_dim_past_the_kernels(gen):
    """flash_mha takes head dims up to MAX_HEAD_DIM (368) on the card; above
    it raises NotImplementedError naming the head dim, forward and
    backward (the plain version on the CPU takes any hd)."""
    q = torch.randn((1, 1, 16, 376), generator=gen, device="cuda")
    lengths = torch.tensor([16], device="cuda")
    with pytest.raises(NotImplementedError, match="D=376; no preset"):
        fa.flash_mha(q, q, q, lengths)
    o = torch.zeros_like(q)
    lse = torch.zeros((1, 1, 16), device="cuda")
    with pytest.raises(NotImplementedError, match="D=376; no preset"):
        fa._flash_bwd_cuda(q, q, q, lengths, 0, 0.0, torch.float32, o, lse, q)
