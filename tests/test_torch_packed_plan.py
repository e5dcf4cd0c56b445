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
WIDE_PADS = (176, 208, 240, 272, 304, 336, 368)   # the "tc_wide" route's widths


def wide_smem(hd_pad):
    """Shared bytes of the "tc_wide" forward, dq and dk/dv kernels at a
    padded head dim (csrc/attention_tc_wide.cuh): 64-row tiles of the own
    side (Q; Q and dO; K and V) and a two-stage ring of 32-row tiles of the
    streamed side (K and V; K and V; Q and dO), plus two stages of 32 lse
    and 32 delta floats in the dk/dv pass."""
    own, streamed = 64 * hd_pad * 2, 32 * hd_pad * 2
    return (own + 4 * streamed, 2 * own + 4 * streamed,
            2 * own + 4 * streamed + 2 * 2 * 32 * 4)


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
        # past it on two warpgroups, at one of the wide route's widths
        assert plan.route == "tc_wide"
        assert plan.hd_pad in WIDE_PADS and hd <= plan.hd_pad < hd + 32
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
    # the limit was 128 before the sensor-wise slice and 368 before the
    # "hd_stream" route: past 368 f32 takes it and bf16 "tc_cluster" (to hd
    # 2048), and what raises is a route the plan does not know or a width
    # nhead does not divide
    assert fa.packed_plan(1, 16, 2 * 369, 2, BF16).route == "tc_cluster"
    assert fa.packed_plan(1, 16, 369, 1, F32).route == "hd_stream"
    assert fa.packed_plan(1, 16, 2 * 368, 2, BF16).route == "tc_wide"   # hd = 368
    assert fa.packed_plan(1, 16, 129, 1, F32).route == "scalar"         # and hd = 129
    with pytest.raises(ValueError, match="impl"):
        fa.packed_plan(1, 16, 720, 1, F32, "tc")
    with pytest.raises(ValueError, match="divisible"):
        fa.packed_plan(1, 16, 721, 2, F32)


@pytest.mark.parametrize("od", [BF16, F32])
def test_sensor_wise_routes(od):
    """The sensor-wise widths (2 heads): eICU's hd 140 keeps the tensor
    cores in bf16 at hd_pad 144; P12's hd 360 takes the two-warpgroup
    tensor-core kernels in bf16 at hd_pad 368 and the scalar ones in f32,
    in the Wide geometry (32-row blocks); PAM's hd 170 (the fused layer's
    attention) the Narrow one in f32."""
    eicu = fa.packed_plan(128, 300, 280, 2, od)
    if od == BF16:
        assert (eicu.route, eicu.hd_pad, eicu.rows) == ("tc", 144, 64)
    else:
        assert (eicu.route, eicu.rows) == ("scalar", 64)
    p12 = fa.packed_plan(128, 215, 720, 2, od)
    if od == BF16:
        assert (p12.route, p12.hd_pad, p12.rows, p12.copy_bytes) == ("tc_wide", 368, 64, 16)
        assert p12.threads == (256, 256, 256) and p12.grid == (4, 2, 128)
        assert list(p12.as_ints) == [2, 368, 16, 64, 256, 256, 256, 4, 2, 128]
    else:
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
    assert fa.packed_smem(128, 215, 720, 2, F32) == scalar(360, 32) == (
        142848, 189056, 193536)
    assert fa.packed_smem(128, 215, 720, 2, BF16, impl="scalar") == scalar(360, 32)
    assert fa.packed_smem(128, 215, 720, 2, BF16) == wide_smem(368) == (
        141312, 188416, 188928)
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
    # P12's hd 360 on the one-warpgroup tensor-core kernels would need five
    # 64 x 368 bf16 tiles, 235,520 bytes: past hd_pad 144 bf16 takes the
    # two-warpgroup kernels, which stream 32-row tiles, and no longer the
    # scalar ones
    assert 5 * 64 * 368 * 2 == 235520 > SMEM
    assert fa.packed_plan(1, 16, 2 * 144, 2, BF16).route == "tc"
    assert fa.packed_plan(1, 16, 2 * 145, 2, BF16).route == "tc_wide"
    assert fa.packed_plan(1, 16, 2 * 145, 2, BF16, impl="scalar").route == "scalar"


@pytest.mark.parametrize("hd", range(fa.TC_MAX_HD_PAD + 1, fa.MAX_HEAD_DIM + 1))
def test_wide_heads_take_the_two_warpgroup_kernels_in_bf16(hd):
    """Every bf16 head dim past hd_pad 144 (hd 145-368) takes "tc_wide":
    the smallest wide width at or above hd, 256 threads (two warpgroups)
    in each launch, 64-row blocks; f32 and impl="scalar" keep the scalar
    kernels as they were (rows by geometry, the hd itself)."""
    T, d = 215, 2 * hd
    plan = fa.packed_plan(128, T, d, 2, BF16)
    want_pad = min(p for p in WIDE_PADS if p >= hd)
    assert (plan.route, plan.hd, plan.hd_pad, plan.rows) == ("tc_wide", hd, want_pad, 64)
    assert plan.hd_pad == fa.wide_pad(hd)
    assert plan.threads == (256, 256, 256) and plan.grid == (4, 2, 128)
    assert list(plan.as_ints)[:2] == [2, want_pad]
    assert plan.copy_bytes == (16 if hd % 8 == 0 else 8 if hd % 4 == 0
                               else 4 if hd % 2 == 0 else 2)
    rows = 64 if hd <= fa.NARROW_MAX_HD else 32
    for f32 in (fa.packed_plan(128, T, d, 2, F32),
                fa.packed_plan(128, T, d, 2, BF16, impl="scalar")):
        assert (f32.route, f32.hd_pad, f32.rows, f32.threads) == (
            "scalar", hd, rows, (256, 256, 256))
        assert f32.grid == (-(-T // rows), 2, 128)


@pytest.mark.parametrize("hd_pad", WIDE_PADS)
def test_wide_kernels_fit_a_block_at_every_width(hd_pad):
    """The mirror of the "tc_wide" kernels' shared bytes: within a block's
    232,448 at every width (one CTA an SM), the widest at hd_pad 368 (P12's
    sensor-wise head), where five 64-row tiles would not fit."""
    fwd, dq, dkv = wide_smem(hd_pad)
    assert max(fwd, dq, dkv) <= SMEM
    assert fwd < dq < dkv
    if hd_pad == 368:
        assert (fwd, dq, dkv) == (141312, 188416, 188928)
        assert 5 * 64 * hd_pad * 2 > SMEM
