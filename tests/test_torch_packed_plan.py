"""The launch plan of flash_mha_packed's kernels (`packed_plan`), on the CPU.

The plan is what surrounds a launch (route, padded head dims, shared
memory, copy width, grid); the C entry points check it field for field, so
these tests hold the rules the card relies on without a card:
    python -m pytest tests/test_torch_packed_plan.py -q
"""

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32


def test_route_follows_the_operand_dtype():
    assert fa.packed_plan(128, 215, 160, 2, BF16).route == "tc"
    assert fa.packed_plan(128, 215, 160, 2, F32).route == "scalar"
    # the previous design stays reachable in bf16, for measurement
    plan = fa.packed_plan(128, 215, 160, 2, BF16, impl="scalar")
    assert plan.route == "scalar" and plan.copy_bytes == 2
    with pytest.raises(ValueError):
        fa.packed_plan(128, 215, 160, 2, BF16, impl="wgmma")


@pytest.mark.parametrize("hd", range(1, fa.MAX_HEAD_DIM + 1))
def test_padded_head_dims(hd):
    plan = fa.packed_plan(4, 65, 2 * hd, 2, BF16)
    assert plan.hd == hd
    assert plan.hd_pad % 16 == 0 and hd <= plan.hd_pad < hd + 16
    assert plan.as_ints[1] == plan.hd_pad
    scalar = fa.packed_plan(4, 65, 2 * hd, 2, F32)
    assert scalar.hd_pad == hd


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("T", [1, 64, 65, 215, 300, 600, 1024])
def test_shared_memory_fits_every_head_dim(T, dtype):
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.packed_plan(8, T, 3 * hd, 3, dtype)
        assert len(plan.smem) == 3 and all(0 < b <= fa.MAX_SMEM for b in plan.smem)
        assert plan.smem == fa.packed_plan(8, 8, 3 * hd, 3, dtype).smem  # T streams
        assert plan.grid == (-(-T // 64), 3, 8)


def test_tensor_core_sizes():
    # P12 (hd 80): five 64 x 80 bf16 tiles forward (Q, two stages of K and
    # V), six in each backward pass, plus two stages of lse and delta rows
    plan = fa.packed_plan(128, 215, 160, 2, BF16)
    tile = 64 * 80 * 2
    assert plan.smem == (5 * tile, 6 * tile, 6 * tile + 1024)
    assert plan.threads == (128, 128, 128)
    assert plan.grid == (4, 2, 128)
    assert list(plan.as_ints) == [1, 80, 16, *plan.smem, 128, 128, 128, 4, 2, 128]


@pytest.mark.parametrize("hd,d,width", [
    (80, 160, 16),   # P12
    (36, 72, 8),     # eICU: head 1 starts 72 bytes into a row
    (42, 84, 4),     # head 1 at 84 bytes, rows of 168
    (84, 168, 8), (8, 16, 16), (128, 256, 16),
    (13, 26, 2),     # odd hd: no cp.async width divides the head offset
])
def test_copy_width_divides_the_alignment(hd, d, width):
    plan = fa.packed_plan(2, 100, d, d // hd, BF16)
    assert plan.copy_bytes == width
    for h in range(d // hd):
        assert (2 * hd * h) % width == 0      # head offset
    assert (2 * d) % width == 0               # row stride
    assert (2 * hd) % width == 0              # the copies tile a head's row
    # an operand address aligned to fewer bytes lowers it
    assert fa.packed_plan(2, 100, d, d // hd, BF16, align=4).copy_bytes == min(width, 4)


def test_alignment_of_addresses():
    assert fa._align(0, 256, 4096) == 16
    assert fa._align(256, 8) == 8
    assert fa._align(6) == 2


def test_head_dim_past_the_limit_raises():
    with pytest.raises(ValueError, match="128"):
        fa.packed_plan(1, 16, 272, 2, BF16)
    with pytest.raises(ValueError, match="128"):
        fa.packed_plan(1, 16, 129, 1, F32)
    fa.packed_plan(1, 16, 256, 2, BF16)       # hd = 128 is taken
