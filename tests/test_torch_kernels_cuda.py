"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import). On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -q
Tolerances: 1e-4 with f32 operands (another summation order), 2e-2 with
bf16 operands (8-bit mantissas, rounding at other points of the sums);
gradients are compared relative to max(1, the plain gradient's max). The
sparse-graph kernels are all f32: 1e-5 relative to max(1, |plain|).
"""

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.ops import sparse as sp
from raindrop_tpu_torch.nn.transformer import _layer_init

TOL = {None: 1e-4, "bfloat16": 2e-2}
SEED = 20231
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


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,nhead", [(13, 16, 2), (130, 72, 2), (215, 160, 2),
                                       (70, 84, 1)])
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
@pytest.mark.parametrize("T,d,nhead", [(13, 16, 2), (130, 72, 2), (215, 160, 2),
                                       (70, 84, 1)])
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
        assert _rel_err(a, b) <= TOL[cd]


def test_flash_autograd_reaches_the_backward_kernels(gen):
    q, k, v = (torch.randn((3, 40, 16), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    lengths = torch.tensor([40, 7, 0], device="cuda")
    before = fa.flash_mha_packed.bwd_launches
    fa.flash_mha_packed(q, k, v, lengths, SEED, 0.2, None, 2).square().sum().backward()
    assert fa.flash_mha_packed.bwd_launches == before + 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def _random_layer(gen, d, ffn):
    p = _layer_init(gen, d, ffn, "cuda")

    def r(n, base=0.0):
        return base + 0.1 * torch.randn((n,), generator=gen, device="cuda")

    p["in_proj_b"] = r(3 * d)
    p["out_proj"]["b"] = r(d)
    p["ln1"] = {"scale": r(d, 1.0), "bias": r(d)}
    p["ln2"] = {"scale": r(d, 1.0), "bias": r(d)}
    return p


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,ffn,nhead", [(13, 16, 32, 2), (600, 84, 136, 2),
                                           (70, 24, 48, 3), (60, 152, 272, 2)])
def test_fused_backward_matches_plain(gen, T, d, ffn, nhead, cd, rate):
    B = 4
    p = _random_layer(gen, d, ffn)
    x, g = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(2))
    lengths = _lengths(gen, B, T)
    od = fa.operand_dtype(cd)
    _, attn, lse = fe._fused_fwd(p, x, lengths, SEED, rate, cd, nhead)
    ws = fe._flatten(p)
    before = fe.fused_encoder_layer.bwd_launches
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, attn, lse, g,
                                 scratch_out=scratch)
    assert fe.fused_encoder_layer.bwd_launches == before + 1
    dx2, dws2 = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, nhead, od, attn, lse, g)
    # a relu pre-activation within rounding of zero may take the other
    # branch on the two sides, an O(1) change of single elements: the plain
    # version takes the kernel's branches, so the arithmetic is compared
    relu_on = scratch["f"].reshape(B, T, ffn) > 0
    pdx, pdws = fe._fused_bwd_plain(p, x, lengths, SEED, rate, nhead, od, attn, lse, g,
                                    relu_on=relu_on)
    torch.cuda.synchronize()
    names = ["dx"] + ["/".join(path) for path in fe._WEIGHTS]
    for name, a, a2, b in zip(names, [dx, *dws], [dx2, *dws2], [pdx, *pdws]):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all() and torch.equal(a, a2), name
        assert _rel_err(a, b) <= TOL[cd], (name, _rel_err(a, b))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,ffn,nhead", [(13, 16, 32, 2), (600, 84, 136, 2),
                                           (70, 24, 48, 3)])
def test_fused_kernel_matches_plain(gen, T, d, ffn, nhead, cd, rate):
    B = 4
    p = _random_layer(gen, d, ffn)
    x = torch.randn((B, T, d), generator=gen, device="cuda")
    lengths = _lengths(gen, B, T)
    before = fe.fused_encoder_layer.launches
    got = fe._fused_fwd(p, x, lengths, SEED, rate, cd, nhead)
    assert fe.fused_encoder_layer.launches == before + 1
    want = fe._fused_fwd_plain(p, x, lengths, nhead, fa.operand_dtype(cd), SEED,
                               rate)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL[cd]


def test_wrappers_refuse_bad_inputs(gen):
    q = torch.randn((2, 8, 16), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        fa._packed_fwd(q, q, q, torch.tensor([8, 8]), None, 0.0, None, 2)
    with pytest.raises(ValueError):
        fa._packed_fwd(q, q[:, :4], q, torch.tensor([8, 8], device="cuda"),
                       None, 0.0, None, 2)


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
    assert (o[0] == 0).all()
    for a, a2, b in zip(got, again, want):
        assert torch.isfinite(a).all() and torch.equal(a, a2)
        assert (a[0] == 0).all()               # the length-0 sample
        assert _rel_err(a, b) <= TOL[cd]


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


def test_flash_mha_refuses_a_head_dim_past_the_kernels(gen):
    q = torch.randn((1, 1, 16, 136), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="128"):
        fa.flash_mha(q, q, q, torch.tensor([16], device="cuda"))
