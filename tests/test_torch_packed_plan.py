"""The launch plan of flash_mha_packed's kernels (`packed_plan`).

The plan is what surrounds a launch (route, padded head dims, copy width,
rows, grid); the C entry points check it field for field, so these tests
hold the rules the card relies on without a card:
    python -m pytest tests/test_torch_packed_plan.py -q
Each kernel's shared memory is the C library's to compute
(`packed_smem`): the tests marked `cuda` hold it on the card and skip
without one.
"""

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32
SMEM = 232448      # shared bytes a block may use on sm_90


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


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
    if hd <= fa.TC_MAX_HD_PAD:
        # bf16 on the tensor cores while the padded width is a wgmma width
        # the kernels are built for
        assert plan.route == "tc"
        assert plan.hd_pad % 16 == 0 and hd <= plan.hd_pad < hd + 16
    else:
        assert plan.route == "scalar" and plan.hd_pad == hd
    assert plan.as_ints[1] == plan.hd_pad
    scalar = fa.packed_plan(4, 65, 2 * hd, 2, F32)
    assert scalar.route == "scalar" and scalar.hd_pad == hd


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("T", [1, 64, 65, 215, 300, 600, 1024])
def test_grid_streams_every_head_dim(T, dtype):
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        plan = fa.packed_plan(8, T, 3 * hd, 3, dtype)
        assert plan.grid == (-(-T // plan.rows), 3, 8)
        short = fa.packed_plan(8, 8, 3 * hd, 3, dtype)        # T streams
        assert (plan.route, plan.rows, plan.threads) == (short.route, short.rows,
                                                          short.threads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("T", [1, 64, 65, 215, 300, 600, 1024])
def test_shared_memory_fits_every_head_dim(card, T, dtype):
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        smem = fa.packed_smem(8, T, 3 * hd, 3, dtype)
        assert len(smem) == 3 and all(0 < b <= SMEM for b in smem)
        assert smem == fa.packed_smem(8, 8, 3 * hd, 3, dtype)  # T streams


def test_tensor_core_sizes():
    plan = fa.packed_plan(128, 215, 160, 2, BF16)
    assert plan.threads == (128, 128, 128)
    assert plan.grid == (4, 2, 128)
    assert list(plan.as_ints) == [1, 80, 16, 64, 128, 128, 128, 4, 2, 128]


@pytest.mark.cuda
def test_tensor_core_shared_memory(card):
    # P12 (hd 80): five 64 x 80 bf16 tiles forward (Q, two stages of K and
    # V), six in each backward pass, plus two stages of lse and delta rows
    tile = 64 * 80 * 2
    assert fa.packed_smem(128, 215, 160, 2, BF16) == (5 * tile, 6 * tile,
                                                      6 * tile + 1024)


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
    # the limit was 128 before the sensor-wise slice; it is 368 now
    with pytest.raises(ValueError, match="368"):
        fa.packed_plan(1, 16, 2 * 369, 2, BF16)
    with pytest.raises(ValueError, match="368"):
        fa.packed_plan(1, 16, 369, 1, F32)
    fa.packed_plan(1, 16, 2 * 368, 2, BF16)   # hd = 368 is taken
    fa.packed_plan(1, 16, 129, 1, F32)        # and so is hd = 129


@pytest.mark.parametrize("od", [BF16, F32])
def test_sensor_wise_routes(od):
    """The sensor-wise widths (2 heads): eICU's hd 140 keeps the tensor
    cores in bf16 at hd_pad 144; P12's hd 360 takes the scalar kernels in
    both dtypes, in the Wide geometry (32-row tiles); PAM's hd 170 (the
    fused layer's attention) the Narrow one."""
    eicu = fa.packed_plan(128, 300, 280, 2, od)
    if od == BF16:
        assert (eicu.route, eicu.hd_pad, eicu.rows) == ("tc", 144, 64)
    else:
        assert (eicu.route, eicu.rows) == ("scalar", 64)
    p12 = fa.packed_plan(128, 215, 720, 2, od)
    assert (p12.route, p12.hd_pad, p12.rows) == ("scalar", 360, 32)
    assert p12.copy_bytes == od.itemsize
    assert p12.threads == (256, 256, 256) and p12.grid == (7, 2, 128)
    pam = fa.packed_plan(128, 600, 340, 2, F32)
    assert (pam.route, pam.rows) == ("scalar", 64)


@pytest.mark.cuda
def test_sensor_wise_shared_memory(card):
    """The kernels' shared bytes at the sensor-wise widths: own rows and
    streamed tiles at stride hd + 1 and the probability or ds tiles at
    stride rows + 1 on the scalar route (3, 4 and 4 row tiles and 1, 1 and
    2 probability tiles in the forward, dq and dk/dv kernels, plus two
    stat rows in dk/dv); 64 x 144 bf16 tiles on the tensor cores."""
    def scalar(hd, rows):
        hp, pp = hd + 1, rows + 1
        return (4 * (3 * rows * hp + rows * pp), 4 * (4 * rows * hp + rows * pp),
                4 * (4 * rows * hp + 2 * rows * pp + 2 * rows))

    assert fa.packed_smem(128, 300, 280, 2, BF16) == (92160, 110592, 111616)
    assert fa.packed_smem(128, 300, 280, 2, F32) == scalar(140, 64) == (
        124928, 161024, 178176)
    for od in (BF16, F32):
        assert fa.packed_smem(128, 215, 720, 2, od) == scalar(360, 32) == (
            142848, 189056, 193536)
    assert fa.packed_smem(128, 600, 340, 2, F32) == scalar(170, 64) == (
        147968, 191744, 208896)
    # the Narrow geometry's dk/dv pass at its widest head dim, 192; the
    # Wide one at 368; the Narrow sizes are the ones every head dim up to
    # 128 always had
    assert fa.packed_smem(1, 16, 192, 1, F32) == scalar(192, 64)
    assert max(scalar(193, 64)) == SMEM
    assert max(fa.packed_smem(1, 16, 368, 1, F32)) <= SMEM
    assert fa.packed_smem(1, 16, 160, 2, F32) == scalar(80, 64)


def test_scalar_geometry_switches_where_narrow_stops_fitting():
    # the dk/dv pass of the Narrow geometry fits up to hd 193 (exactly the
    # block's 232,448 bytes there: test_sensor_wise_shared_memory), and its
    # 48 columns a thread hold 192; the Wide one takes the rest up to 368
    assert fa.packed_plan(1, 16, 192, 1, F32).rows == 64
    assert fa.packed_plan(1, 16, 193, 1, F32).rows == 32
    assert fa.packed_plan(1, 16, fa.MAX_HEAD_DIM, 1, F32).rows == 32
    # P12's hd 360 on the tensor cores would need five 64 x 368 bf16 tiles,
    # 235,520 bytes: past hd_pad 144 bf16 takes the scalar kernels
    assert 5 * 64 * 368 * 2 == 235520 > SMEM
    assert fa.packed_plan(1, 16, 2 * 144, 2, BF16).route == "tc"
    assert fa.packed_plan(1, 16, 2 * 145, 2, BF16).route == "scalar"
