"""The launch plan of the fused encoder layer's kernels (`fused_plan`).

The plan is what surrounds each launch (route, tile rows, copy width,
threads, shared bytes); both C entry points recompute it and refuse one
that differs in any field, so these tests hold the rules the card relies
on without a card:
    python -m pytest tests/test_torch_fused_plan.py -q
The C library's own plan is held against this one on the card
(tests/test_torch_kernels_cuda.py, marker `cuda`).
"""

import pytest
import torch

from raindrop_tpu_torch.ops import fused_encoder as fe

BF16, F32 = torch.bfloat16, torch.float32
SMEM = 232448      # shared bytes a block may use on sm_90
ROW_LAUNCHES = ("qkv", "tail", "bwd_rows", "dx", "wgrad")
ATTN_LAUNCHES = ("attn_fwd", "attn_dq", "attn_dkv")
# the card tests' widths (d, ffn, nhead), PAM's and PAM's sensor-wise
WIDTHS = [(16, 32, 2), (24, 48, 3), (84, 136, 2), (152, 272, 2), (340, 136, 2)]


def _parent_takes(d, ffn, nhead):
    """Whether the previous design's kernels took the width: a geometry for
    the head dim and every scalar launch within a block's shared memory
    (csrc/fused_plan.cuh expected_plan, scalar route)."""
    hd = d // nhead
    if d % nhead or hd > 368:
        return False
    r = k = 64 if hd <= 192 else 32
    floats = [32 * (d + 1),                                          # qkv
              (r + 2 * k) * (hd + 1) + r * (k + 1),                   # attention
              2 * 64 * (d + 1) + 64 * (ffn + 1),                      # tail
              32 * max(d + 1, ffn + 1) + 4 * 32 * (d + 1) + 64,       # backward rows
              2 * (r + k) * (hd + 1) + r * (k + 1),                   # dq
              2 * (r + k) * (hd + 1) + 2 * r * (k + 1) + 2 * k,       # dk/dv
              32 * (3 * d + 1)]                                       # dx
    return max(floats) * 4 <= SMEM


def test_pam_takes_the_tensor_cores_throughout():
    plan = fe.fused_plan(84, 136, 2, BF16)
    assert (plan.route, plan.attn_route) == ("tc", "tc")
    for name in ROW_LAUNCHES:     # two warpgroups a CTA, one for the weight gradients
        assert (plan[name].route, plan[name].rows, plan[name].copy_bytes,
                plan[name].threads) == ("tc", 64, 16, 128 if name == "wgrad" else 256)
    # hd 42: a head starts 84 bytes into a bf16 row, so 4-byte copies
    for name in ATTN_LAUNCHES:
        assert (plan[name].route, plan[name].rows, plan[name].copy_bytes,
                plan[name].threads) == ("tc", 64, 4, 128)
    smem = {n: plan[n].smem for n in fe.LAUNCHES}
    # K padded to 64: d 84 -> 128, ffn 136 -> 192, 3d 252 -> 256; a ring of
    # two steps of two 8 KB weight panels; f32 [64, d] buffers; a 64 x 132
    # f32 step staged for the row-wise stores of qkv and dx; attention tiles
    # at hd_pad 48; the weight gradient's two stages of two 64 x 64 tiles
    assert smem == {"qkv": 16384 + 32768 + 33792,
                    "attn_fwd": 5 * 64 * 48 * 2,
                    "tail": 21504 + 16384 + 24576 + 32768,
                    "bwd_rows": 21504 + 16384 + 24576 + 34816 + 32768 + 1024,
                    "attn_dq": 6 * 64 * 48 * 2,
                    "attn_dkv": 6 * 64 * 48 * 2 + 1024,
                    "dx": 32768 + 32768 + 33792,
                    "wgrad": 32768}


def test_pam_sensor_wise_keeps_the_scalar_attention_past_hd_pad_144():
    plan = fe.fused_plan(340, 136, 2, BF16)
    assert (plan.route, plan.attn_route) == ("tc", "scalar")
    for name in ROW_LAUNCHES:
        assert plan[name].route == "tc" and plan[name].rows == 64
    # hd 170: the Narrow geometry (64-row blocks), bf16 operands
    for name in ATTN_LAUNCHES:
        assert (plan[name].route, plan[name].rows, plan[name].copy_bytes,
                plan[name].threads) == ("scalar", 64, 2, 256)
    assert plan["bwd_rows"].smem == 87040 + 49152 + 24576 + 34816 + 32768 + 1024
    assert plan["bwd_rows"].smem <= SMEM
    assert plan["tail"].smem == 87040 + 49152 + 24576 + 32768
    assert plan["dx"].smem == 64 * 1024 * 2 + 32768 + 33792
    assert plan["attn_dkv"].smem == (2 * 128 * 171 + 2 * 64 * 65 + 128) * 4


@pytest.mark.parametrize("d,ffn,nhead", WIDTHS)
def test_f32_is_always_scalar_and_keeps_the_previous_layout(d, ffn, nhead):
    plan = fe.fused_plan(d, ffn, nhead, F32)
    assert (plan.route, plan.attn_route) == ("scalar", "scalar")
    assert all(l.route == "scalar" and l.copy_bytes == 4 and l.threads == 256
               for l in plan.launches)
    assert (plan["qkv"].rows, plan["tail"].rows, plan["bwd_rows"].rows,
            plan["dx"].rows) == (32, 64, 32, 32)
    assert plan["qkv"].smem == 32 * (d + 1) * 4
    assert plan["dx"].smem == 32 * (3 * d + 1) * 4
    # the scalar route ignores the alignment
    assert fe.fused_plan(d, ffn, nhead, F32, align=2) == plan


@pytest.mark.parametrize("d,ffn,nhead", WIDTHS)
def test_impl_scalar_reaches_the_previous_design_in_bf16(d, ffn, nhead):
    plan = fe.fused_plan(d, ffn, nhead, BF16, impl="scalar")
    f32 = fe.fused_plan(d, ffn, nhead, F32)
    assert plan.route == "scalar" and plan.attn_route == "scalar"
    # the same kernels and shared bytes as f32, 2-byte operands
    assert [(l.rows, l.smem, l.threads) for l in plan.launches] == \
           [(l.rows, l.smem, l.threads) for l in f32.launches]
    assert all(l.copy_bytes == 2 for l in plan.launches)
    with pytest.raises(ValueError, match="impl"):
        fe.fused_plan(d, ffn, nhead, BF16, impl="wgmma")


@pytest.mark.parametrize("d,ffn,nhead", WIDTHS)
def test_bf16_widths_of_the_card_tests_take_the_tensor_cores(d, ffn, nhead):
    plan = fe.fused_plan(d, ffn, nhead, BF16)
    hd_pad = -(-(d // nhead) // 16) * 16
    assert plan.route == "tc"
    assert plan.attn_route == ("tc" if hd_pad <= fe.TC_MAX_HD_PAD else "scalar")
    assert max(l.smem for l in plan.launches) <= SMEM
    assert len(plan.as_ints) == 5 * len(fe.LAUNCHES)
    assert list(plan.as_ints)[0::5] == [int(l.route == "tc") for l in plan.launches]


@pytest.mark.parametrize("hd,align,want", [
    (8, 16, 16), (42, 16, 4), (36, 16, 8), (170, 16, 2), (13, 16, 2), (64, 16, 16),
    (64, 8, 8), (64, 4, 4), (40, 16, 16)])
def test_copy_width_divides_head_offsets_strides_and_alignment(hd, align, want):
    plan = fe.fused_plan(2 * hd, 64, 2, BF16, align=align)
    if plan.attn_route == "tc":
        assert plan["attn_fwd"].copy_bytes == want
        assert plan["attn_dq"].copy_bytes == plan["attn_dkv"].copy_bytes == want
    # the row products stream packed 16-byte panels whatever the alignment
    assert plan["qkv"].copy_bytes == 16


@pytest.mark.parametrize("nhead", [1, 2, 3, 4])
def test_every_width_the_previous_design_took_is_still_taken(nhead):
    """A sweep of widths: every width the previous design's kernels took is
    taken in both dtypes (in bf16 on the scalar route where a tensor-core
    tile would not fit); f32 raises exactly where they did not fit, and bf16
    there either raises or takes the tensor cores, whose tiles may fit
    where the scalar ones did not."""
    seen_scalar_bf16 = 0
    for d in range(nhead, 720 + 1, nhead * 7):
        for ffn in (16, 136, 272, 600):
            if _parent_takes(d, ffn, nhead):
                for od in (BF16, F32):
                    plan = fe.fused_plan(d, ffn, nhead, od)
                    assert max(l.smem for l in plan.launches) <= SMEM
                seen_scalar_bf16 += fe.fused_plan(d, ffn, nhead, BF16).route == "scalar"
            else:
                with pytest.raises(ValueError, match="do not take"):
                    fe.fused_plan(d, ffn, nhead, F32)
                try:
                    plan = fe.fused_plan(d, ffn, nhead, BF16)
                except ValueError as e:
                    assert "do not take" in str(e)
                else:
                    assert plan.route == "tc"
                    assert max(l.smem for l in plan.launches) <= SMEM
    assert seen_scalar_bf16 > 0     # the fall-back was exercised


def test_tc_scratch_listing():
    """The backward's buffers on the tensor-core route: product operands in
    bf16, sums' inputs in f32, h1 and the packed weights besides, 64-row
    tiles for the row partials."""
    B, T, d, ffn, nhead = 128, 600, 340, 136, 2
    plan = fe.fused_plan(d, ffn, nhead, BF16)
    sizes = fe.bwd_scratch(B, T, d, ffn, nhead, plan)
    M = B * T
    for name in ("qkv", "x1", "f", "df2", "dfpre", "dao", "d_attn", "wpack"):
        assert sizes[name][1] == BF16, name
    for name in ("dh1", "dqkv", "delta", "row_partials", "wgrad_partials", "h1"):
        assert sizes[name][1] == F32, name
    assert sizes["qkv"][0] == M * 3 * d and sizes["h1"][0] == M * d
    assert sizes["row_partials"][0] == B * 10 * (9 * d + ffn)
    # four forward and four transposed weights, N padded to 128, K to 64
    assert sizes["wpack"][0] == (1024 * 384 + 384 * 384 + 256 * 384 + 384 * 192
                                 + 256 * 384 + 384 * 192 + 384 * 384 + 384 * 1024)
    floats = fe.bwd_scratch_floats(B, T, d, ffn, nhead, plan)
    assert floats["qkv"] == M * 3 * d // 2 and floats["dqkv"] == M * 3 * d
    scalar = fe.bwd_scratch_floats(B, T, d, ffn, nhead)
    assert "h1" not in scalar and scalar["qkv"] == M * 3 * d
    assert scalar == fe.bwd_scratch_floats(B, T, d, ffn, nhead,
                                           fe.fused_plan(d, ffn, nhead, BF16, "scalar"))


def test_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="do not take"):
        fe.fused_plan(680, 272, 2, BF16)          # P19's sensor-wise width
    with pytest.raises(ValueError, match="do not take"):
        fe.fused_plan(2 * 369, 64, 2, BF16)       # a head past 368
    with pytest.raises(ValueError):
        fe.fused_plan(85, 136, 2, BF16)           # d not divisible by nhead


def test_tensor_cores_stop_at_hd_192():
    """Past hd 192 bf16 takes the scalar route: the tensor-core route's
    scalar attention runs the Narrow geometry alone (its Wide geometry on
    bf16 operands spilled registers); no preset's fused-layer head is wider
    than PAM-sw's 170."""
    assert fe.fused_plan(2 * 192, 16, 2, BF16).route == "tc"
    plan = fe.fused_plan(200, 16, 1, BF16)              # hd 200: the Wide geometry
    assert plan.route == "scalar" and plan["attn_fwd"].rows == 32
