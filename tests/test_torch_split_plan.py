"""The launch plan of flash_mha's kernels (`split_plan`) and the operand
cast in front of them (`_padded_cast`).

The plan is what surrounds a launch (route, padded head dim, copy width,
the columns a copy reads, rows, threads, grid); csrc/flash_split.cu checks
it field for field, so these tests hold the rules the card relies on
without a card:
    python -m pytest tests/test_torch_split_plan.py -q
`split_smem_mirror` is the shared bytes the C library computes for each
route (tests/test_torch_kernels_cuda.py holds the two equal on the card).
"""

import pytest
import torch

from raindrop_tpu_torch.ops import flash_attention as fa
from test_torch_packed_plan import WIDE_PADS, wide_smem

BF16, F32 = torch.bfloat16, torch.float32
SMEM = 232448      # shared bytes a block may use on sm_90


def split_smem_mirror(route, D):
    """Shared bytes of flash_mha's forward, dq and dk/dv kernels at head dim
    D on a route: "tc", 64 x pad16(D) bf16 tiles (Q and two stages of K and
    V forward; six tiles in each backward pass, plus two stages of 64 lse
    and delta floats in dk/dv), as attention_tc.cuh sizes them; "tc_wide"
    the packed pair's two-warpgroup sizes (test_torch_packed_plan.wide_smem);
    "scalar", f32 tiles at stride D + 1 in the Narrow (64-row) or Wide
    (32-row) geometry, as attention.cuh / attention_bwd.cuh size them."""
    if route == "tc":
        tile = 64 * (-(-D // 16) * 16) * 2
        return (5 * tile, 6 * tile, 6 * tile + 2 * 2 * 64 * 4)
    if route == "tc_wide":
        return wide_smem(fa.wide_pad(D))
    rows = fa.scalar_rows(D)
    hp, pp = D + 1, rows + 1
    return (4 * (3 * rows * hp + rows * pp), 4 * (4 * rows * hp + rows * pp),
            4 * (4 * rows * hp + 2 * rows * pp + 2 * rows))


def dense_strides(T, H, D):
    """The (batch, head, row) strides of `.to(bf16)` of the model's head
    views: a dense [B, T, H, D] tensor."""
    return (T * H * D, D, H * D)


def padded_strides(T, H, D):
    """The same of `_padded_cast`'s views: heads of pad8_cols(D) columns."""
    c = fa.pad8_cols(D)
    return (T * H * c, c, H * c)


@pytest.mark.parametrize("D", range(1, fa.MAX_HEAD_DIM + 1))
def test_every_bf16_head_dim_takes_a_tensor_core_route(D):
    """bf16 takes "tc" while D padded to 16 is at most TC_MAX_HD_PAD (one
    warpgroup, 128 threads) and "tc_wide" past it (two, 256 threads, at
    one of the wide widths); both run 64-row blocks, the dk/dv pass two
    CTAs a key block. f32 and impl="scalar" keep the scalar kernels in
    the geometry they always had."""
    B, H, T = 128, 2, 2048
    for padded in (False, True):
        strides = (padded_strides if padded else dense_strides)(T, H, D)
        plan = fa.split_plan(B, H, T, D, BF16, (strides,), 16, "auto", padded)
        assert plan.hd == D and plan.rows == 64
        assert plan.grid == (32, H, B) and plan.dkv_grid == (64, H, B)
        if -(-D // 16) * 16 <= fa.TC_MAX_HD_PAD:
            assert (plan.route, plan.hd_pad, plan.threads) == ("tc", -(-D // 16) * 16,
                                                                (128,) * 3)
        else:
            assert plan.route == "tc_wide" and plan.threads == (256,) * 3
            assert plan.hd_pad in WIDE_PADS and plan.hd_pad == fa.wide_pad(D)
            assert D <= plan.hd_pad < D + 32
        assert plan.cols == (fa.pad8_cols(D) if padded else D) <= plan.hd_pad
        # PackedPlan's ten ints (the C Plan's first PLAN_INTS), then cols
        assert list(plan.as_ints) == [fa._ROUTES[plan.route], plan.hd_pad,
                                      plan.copy_bytes, 64, *plan.threads, *plan.grid,
                                      plan.cols]
    rows = 64 if D <= fa.NARROW_MAX_HD else 32
    for od, impl in ((F32, "auto"), (BF16, "scalar")):
        scalar = fa.split_plan(B, H, T, D, od, (dense_strides(T, H, D),), impl=impl)
        assert (scalar.route, scalar.hd_pad, scalar.cols, scalar.rows) == (
            "scalar", D, D, rows)
        assert scalar.threads == (256,) * 3 and scalar.copy_bytes == od.itemsize
        assert scalar.grid == scalar.dkv_grid == (-(-T // rows), H, B)


@pytest.mark.parametrize("T", [1, 64, 65, 600, 1024, 1025, 2048, 3001])
def test_grid_covers_every_row(T):
    """One CTA a 64-row block of queries (and two a block of keys in the
    tensor-core dk/dv pass) at any T, past 1024 too; the scalar route's
    blocks by its geometry."""
    for D, od, want in ((42, BF16, "tc"), (170, BF16, "tc_wide"), (360, BF16, "tc_wide"),
                        (42, F32, "scalar"), (360, F32, "scalar")):
        plan = fa.split_plan(3, 2, T, D, od, (dense_strides(T, 2, D),))
        assert plan.route == want
        assert plan.grid[0] * plan.rows >= T > (plan.grid[0] - 1) * plan.rows
        assert plan.dkv_grid[0] == (2 if want != "scalar" else 1) * plan.grid[0]


@pytest.mark.parametrize("D,dense,padded", [
    (42, 4, 16),     # PAM-2048: a head starts 84 bytes into a row
    (170, 4, 16),    # PAM-sw-2048: 340 bytes
    (360, 16, 16),   # 720 bytes: a multiple of 16 either way
    (36, 8, 16),     # eICU past 1024 steps: 72 bytes
    (80, 16, 16), (8, 16, 16),
    (13, 2, 16),     # odd: no cp.async width divides the head offset
    (145, 2, 16), (150, 4, 16),
])
def test_copy_width_from_strides_and_alignment(D, dense, padded):
    """The copy width divides the columns' bytes, every stride's bytes and
    the addresses' alignment: the model's dense bf16 cast at hd 42 and 170
    copies by 4 bytes, `_padded_cast`'s heads by 16; raw projection views
    ([B, T, 3 H D] split, bf16) by what their strides allow."""
    B, H, T = 4, 2, 100
    plan = fa.split_plan(B, H, T, D, BF16, (dense_strides(T, H, D),))
    assert (plan.copy_bytes, plan.cols) == (dense, D)
    pad = fa.split_plan(B, H, T, D, BF16, (padded_strides(T, H, D),), padded=True)
    assert (pad.copy_bytes, pad.cols) == (padded, fa.pad8_cols(D))
    for s in padded_strides(T, H, D):
        assert (2 * s) % pad.copy_bytes == 0
    # the raw projection's head views: row stride 3 H D
    proj = (T * 3 * H * D, D, 3 * H * D)
    raw = fa.split_plan(B, H, T, D, BF16, (proj,))
    assert all((2 * x) % raw.copy_bytes == 0 for x in (*proj, D))
    # an address aligned to fewer bytes lowers it; so does a do whose
    # strides differ from q's
    assert fa.split_plan(B, H, T, D, BF16, (padded_strides(T, H, D),), 4,
                         padded=True).copy_bytes == 4
    assert fa.split_plan(B, H, T, D, BF16, (padded_strides(T, H, D), (6, 6, 6)),
                         padded=True).copy_bytes == 4


def test_model_cast_layout_is_the_dense_one():
    """What `.to(bf16)` of the model's f32 head views gives (the layout
    dense_strides assumes), and what `_padded_cast` gives instead."""
    B, T, H, D = 2, 9, 2, 170
    proj = torch.randn((B, T, 3 * H * D))
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2) for t in proj.split(H * D, dim=-1))
    assert q.to(BF16).stride()[:3] == dense_strides(T, H, D)
    views, cols = fa._flash_operands((q, k, v), BF16)
    assert all(x.stride()[:3] == padded_strides(T, H, D) for x in views)
    assert cols == 176
    assert fa._flash_operands((q.to(BF16),), BF16)[1] == D


@pytest.mark.parametrize("D", [1, 8, 13, 42, 144, 145, 170, 360, 368])
def test_padded_cast_holds_the_plain_cast(D):
    """`_padded_cast` holds the same values as `.to(bf16)` of each operand,
    zeros in its pad columns, one stride triple for all; a head starts at a
    multiple of 16 bytes."""
    gen = torch.Generator().manual_seed(D)
    B, H, T = 3, 2, 17
    proj = torch.randn((B, T, 3 * H * D), generator=gen)
    xs = [t.reshape(B, T, H, D).transpose(1, 2) for t in proj.split(H * D, dim=-1)]
    xs.append(torch.randn((B, H, T, D), generator=gen))      # a contiguous one
    views = fa._padded_cast(xs, BF16)
    cols = fa.pad8_cols(D)
    for view, x in zip(views, xs):
        assert view.dtype == BF16 and view.shape == x.shape
        assert torch.equal(view, x.to(BF16))
        assert view.stride() == views[0].stride() == (T * H * cols, cols, H * cols, 1)
    buf = views[0]._base
    assert buf.shape == (len(xs), B, T, H, cols)
    assert (buf[..., D:] == 0).all()
    assert (2 * cols) % 16 == 0


def test_flash_operands_by_route():
    """f32 operands stay as they are; bf16 on the tensor-core route takes
    the padded cast (48 columns at hd 42); impl="scalar" (the previous
    design) a plain cast; operands already bf16 are not copied. Each comes
    with the columns a copy may read."""
    x = torch.randn((2, 2, 5, 42))
    (same,), cols = fa._flash_operands((x,), F32)
    assert same is x and cols == 42
    padded, cols = fa._flash_operands((x, x), BF16)
    assert cols == 48 and all(p.dtype == BF16 for p in padded)
    (plain,), cols = fa._flash_operands((x,), BF16, "scalar")
    assert plain.dtype == BF16 and cols == 42
    again, cols = fa._flash_operands(padded, BF16)
    assert again == padded and cols == 42     # bf16 views: no claim of zeros


def test_head_strides_keep_columns_only_without_a_copy():
    """The kernels' operands keep the padded columns while they share one
    stride triple; where the strides differ they are copied into dense
    heads, and a copy then reads D columns."""
    x = torch.randn((2, 2, 5, 42))
    views, cols = fa._flash_operands((x, x, x), BF16)
    kept, strides, c = fa._head_strides(views, cols)
    assert kept == views and c == 48 and strides == padded_strides(5, 2, 42)
    mixed = (views[0], views[1], x.to(BF16))
    dense, strides, c = fa._head_strides(mixed, cols)
    assert c == 42 and strides == dense[0].stride()[:3] == (2 * 5 * 42, 5 * 42, 42)
    assert all(torch.equal(a, b) for a, b in zip(dense, mixed))


@pytest.mark.parametrize("route", ["tc", "tc_wide", "scalar"])
def test_shared_memory_mirror_fits_a_block(route):
    """Every head dim a route takes fits a block's 232,448 bytes; the
    tensor-core routes' sizes are the packed pair's (the same routines)."""
    dims = {"tc": range(1, 145), "tc_wide": range(145, 369),
            "scalar": range(1, fa.MAX_HEAD_DIM + 1)}[route]
    for D in dims:
        fwd, dq, dkv = split_smem_mirror(route, D)
        assert 0 < fwd < dq <= dkv <= SMEM
    if route == "tc":
        assert split_smem_mirror("tc", 42) == (30720, 36864, 37888)
    if route == "tc_wide":
        assert split_smem_mirror("tc_wide", 170) == wide_smem(176)
        assert split_smem_mirror("tc_wide", 360) == (141312, 188416, 188928)
    if route == "scalar":
        assert split_smem_mirror("scalar", 192)[2] == 4 * (2 * 128 * 193 + 2 * 64 * 65 + 128)
        assert split_smem_mirror("scalar", 368)[2] == 4 * (2 * 64 * 369 + 2 * 32 * 33 + 64)


def test_head_dim_past_the_kernels_raises():
    # past 368 the "hd_stream" route takes f32 and "tc_cluster" bf16 (it
    # raised before); an unknown impl still raises
    assert fa.split_plan(1, 1, 16, 369, BF16).route == "tc_cluster"
    assert fa.split_plan(1, 1, 16, 400, F32).route == "hd_stream"
    assert fa.split_plan(1, 1, 16, 368, BF16).route == "tc_wide"
    with pytest.raises(ValueError, match="impl"):
        fa.split_plan(1, 1, 16, 400, F32, impl="tc")


def test_impl_is_checked():
    with pytest.raises(ValueError, match="impl"):
        fa.split_plan(1, 1, 16, 42, BF16, impl="wgmma")
    assert fa.split_plan(1, 1, 16, 42, BF16, impl="scalar").route == "scalar"
    assert fa.split_plan(1, 1, 16, 42, F32, impl="scalar").route == "scalar"


def hd_stream_smem():
    """Shared bytes of the "hd_stream" forward, dq and dk/dv kernels, as
    csrc/attention_hd_stream.cuh sizes them (the card tests hold
    split_smem and packed_smem to it): 32-row blocks and streamed tiles,
    head-dim chunks of 32 columns and output slices of HD_STREAM_SLICE,
    each row one float longer; probabilities (and dp) 32 x 33; the dk/dv
    pass its tile's lse and delta besides."""
    R = fa.HD_STREAM_ROWS
    chunk, probs, slice_ = R * 33, R * (R + 1), R * (fa.HD_STREAM_SLICE + 1)
    return (4 * (2 * chunk + probs + slice_), 4 * (4 * chunk + probs + slice_),
            4 * (4 * chunk + 2 * probs + 2 * R + 2 * slice_))
