"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import). On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -q
Tolerances: 1e-4 with f32 operands (another summation order), 2e-2 with
bf16 operands (8-bit mantissas, rounding at other points of the sums).
"""

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.nn.transformer import _layer_init

TOL = {None: 1e-4, "bfloat16": 2e-2}
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


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,nhead", [(13, 16, 2), (130, 72, 2), (215, 160, 2),
                                       (70, 84, 1)])
def test_flash_kernel_matches_plain(gen, T, d, nhead, cd):
    B = 5
    q, k, v = (torch.randn((B, T, d), generator=gen, device="cuda") for _ in range(3))
    lengths = _lengths(gen, B, T)
    before = fa.flash_mha_packed.launches
    o, lse = fa._packed_fwd(q, k, v, lengths, None, 0.0, cd, nhead)
    assert fa.flash_mha_packed.launches == before + 1
    po, plse = fa._packed_fwd_plain(q, k, v, lengths, nhead, fa.operand_dtype(cd))
    torch.cuda.synchronize()
    assert (o - po).abs().max().item() <= TOL[cd]
    assert (lse - plse).abs().max().item() <= TOL[cd]


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("T,d,ffn,nhead", [(13, 16, 32, 2), (600, 84, 136, 2),
                                           (70, 24, 48, 3)])
def test_fused_kernel_matches_plain(gen, T, d, ffn, nhead, cd):
    B = 4
    p = _layer_init(gen, d, ffn, "cuda")
    p["in_proj_b"] = 0.1 * torch.randn((3 * d,), generator=gen, device="cuda")
    p["ln2"]["scale"] = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    x = torch.randn((B, T, d), generator=gen, device="cuda")
    lengths = _lengths(gen, B, T)
    before = fe.fused_encoder_layer.launches
    got = fe._fused_fwd(p, x, lengths, None, 0.0, cd, nhead)
    assert fe.fused_encoder_layer.launches == before + 1
    want = fe._fused_fwd_plain(p, x, lengths, nhead, fa.operand_dtype(cd))
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
