"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import). On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -q
Tolerances: 1e-4 with f32 operands (another summation order), 2e-2 with
bf16 operands (8-bit mantissas, rounding at other points of the sums);
gradients are compared relative to max(1, the plain gradient's max).
"""

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
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
