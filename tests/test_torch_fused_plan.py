"""The launch plan of the fused encoder layer's kernels (`fused_plan`).

The plan is what surrounds each launch (route, tile rows, copy width,
threads, shared bytes); both C entry points recompute it and refuse one
that differs in any field, so these tests hold the rules the card relies
on without a card:
    python -m pytest tests/test_torch_fused_plan.py -q
The C library's own plan is held against this one on the card
(tests/test_torch_kernels_cuda.py, marker `cuda`). `_previous_plan` is
the plan as it stood before the "stream" route (every width either
tile-resident route took, None elsewhere), frozen here: at every width it
took the plan is the same, field for field.
"""

import pytest
import torch

from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.ops.flash_attention import wide_pad
from test_torch_packed_plan import wide_smem

BF16, F32 = torch.bfloat16, torch.float32
SMEM = 232448      # shared bytes a block may use on sm_90
ROW_LAUNCHES = ("qkv", "tail", "bwd_rows", "dx", "wgrad")
ATTN_LAUNCHES = ("attn_fwd", "attn_dq", "attn_dkv")
# the card tests' widths (d, ffn, nhead), PAM's and PAM's sensor-wise
WIDTHS = [(16, 32, 2), (24, 48, 3), (84, 136, 2), (152, 272, 2), (340, 136, 2)]
# the route ints the C entry points take (csrc/fused_plan.cuh Launch.route)
ROUTE_INTS = {"scalar": 0, "tc": 1, "tc_wide": 2}
# widths (d, ffn, nhead) of bf16 head dims past hd_pad 144 where every row
# product's tile fits: hd 145 (the first), 170 (PAM-sw), 176 (the last to
# pad to 176), 177 (the first to pad to 208) and 192 (the last the
# tensor-core route takes)
WIDE_WIDTHS = [(290, 136, 2), (340, 136, 2), (352, 136, 2), (177, 64, 1), (192, 64, 1)]


def _previous_plan(d, ffn, nhead, od, impl="auto", align=16):
    """The plan before the "stream" route (the tile-resident routes "tc"
    and "scalar"), as (route, attention route, launches as tuples), or
    None where it raised."""
    hd = d // nhead
    es = od.itemsize

    def pad(x, m):
        return -(-x // m) * m

    def tile(k):
        return 64 * pad(k, 64) * 2

    def f32_rows(n):
        return pad(64 * n * 4, 128)

    ring, stage, wgrad = 2 * 2 * 64 * 64 * 2, 64 * 132 * 4, 2 * 2 * 64 * 64 * 2

    def launches(tc, copy):
        if tc:
            rows = (("tc", 64, 16, 256, tile(d) + ring + stage),
                    ("tc", 64, 16, 256, f32_rows(d) + tile(d) + tile(ffn) + ring),
                    ("tc", 64, 16, 256, f32_rows(d) + tile(d) + tile(ffn) + f32_rows(ffn)
                     + ring + 4 * 64 * 4),
                    ("tc", 64, 16, 256, tile(3 * d) + ring + stage),
                    ("tc", 64, 16, 128, wgrad))
        else:
            rows = (("scalar", 32, es, 256, 32 * (d + 1) * 4),
                    ("scalar", 64, es, 256, (2 * 64 * (d + 1) + 64 * (ffn + 1)) * 4),
                    ("scalar", 32, es, 256, (32 * max(d + 1, ffn + 1) + 4 * 32 * (d + 1)
                                             + 2 * 32) * 4),
                    ("scalar", 32, es, 256, 32 * (3 * d + 1) * 4),
                    ("scalar", 64, es, 256, 2 * 16 * 64 * 4))
        hdk = pad(hd, 16)
        if tc and hdk <= 144:
            t = 64 * hdk * 2
            attn = (("tc", 64, copy, 128, 5 * t), ("tc", 64, copy, 128, 6 * t),
                    ("tc", 64, copy, 128, 6 * t + 2 * 2 * 64 * 4))
        elif tc:
            own, streamed = 64 * wide_pad(hd) * 2, 32 * wide_pad(hd) * 2
            attn = (("tc_wide", 64, copy, 256, own + 4 * streamed),
                    ("tc_wide", 64, copy, 256, 2 * own + 4 * streamed),
                    ("tc_wide", 64, copy, 256, 2 * own + 4 * streamed + 2 * 2 * 32 * 4))
        else:
            r = k = 64 if hd <= 192 else 32
            attn = (("scalar", r, es, 256, ((r + 2 * k) * (hd + 1) + r * (k + 1)) * 4),
                    ("scalar", r, es, 256, (2 * (r + k) * (hd + 1) + r * (k + 1)) * 4),
                    ("scalar", r, es, 256,
                     (2 * (r + k) * (hd + 1) + 2 * r * (k + 1) + 2 * k) * 4))
        qkv, tail, bwd_rows, dx, wg = rows
        out = (qkv, attn[0], tail, bwd_rows, attn[1], attn[2], dx, wg)
        return None if max(l[4] for l in out) > SMEM else out

    if d % nhead or hd > 368:
        return None
    if od == BF16 and impl == "auto" and hd <= 192:
        copy = 16
        while copy > 2 and ((2 * hd) % copy or (2 * d) % copy or align % copy):
            copy //= 2
        got = launches(True, copy)
        if got is not None:
            return ("tc", got[1][0], got)
    got = launches(False, es)
    return None if got is None else ("scalar", "scalar", got)


def _as_previous(plan):
    return (plan.route, plan.attn_route,
            tuple((l.route, l.rows, l.copy_bytes, l.threads, l.smem) for l in plan.launches))


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
    """The name is the previous design's: past hd_pad 144 the fused layer's
    attention kept the scalar kernels. It now takes the two-warpgroup
    tensor-core route ("tc_wide") at PAM-sw (d=340, hd 170, padded to 176);
    the row products are as they were."""
    plan = fe.fused_plan(340, 136, 2, BF16)
    assert (plan.route, plan.attn_route) == ("tc", "tc_wide")
    for name in ROW_LAUNCHES:
        assert plan[name].route == "tc" and plan[name].rows == 64
    # hd 170: 64-row blocks on two warpgroups; a head starts 340 bytes into
    # a bf16 row, so 4-byte copies
    for name in ATTN_LAUNCHES:
        assert (plan[name].route, plan[name].rows, plan[name].copy_bytes,
                plan[name].threads) == ("tc_wide", 64, 4, 256)
    assert plan["bwd_rows"].smem == 87040 + 49152 + 24576 + 34816 + 32768 + 1024
    assert plan["bwd_rows"].smem <= SMEM
    assert plan["tail"].smem == 87040 + 49152 + 24576 + 32768
    assert plan["dx"].smem == 64 * 1024 * 2 + 32768 + 33792
    # a 64 x 176 own tile (Q; Q and dO; K and V), four 32 x 176 streamed
    # tiles, and two stages of 32 lse and delta floats in the dk/dv pass
    assert (plan["attn_fwd"].smem, plan["attn_dq"].smem, plan["attn_dkv"].smem) == \
        (22528 + 45056, 2 * 22528 + 45056, 2 * 22528 + 45056 + 512) == wide_smem(176)


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
    assert plan.attn_route == ("tc" if hd_pad <= fe.TC_MAX_HD_PAD else "tc_wide")
    assert max(l.smem for l in plan.launches) <= SMEM
    assert len(plan.as_ints) == 5 * len(fe.LAUNCHES)
    assert list(plan.as_ints)[0::5] == [ROUTE_INTS[l.route] for l in plan.launches]


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
    """A sweep of widths: every width is taken in both dtypes, by "auto"
    and by impl="scalar". Where the design before the "stream" route took
    it (the first scalar kernels' widths, `_parent_takes`, in bf16 also
    the tensor cores' where their tiles fit) the plan is that design's,
    field for field (`_previous_plan`), in bf16 on the scalar route where a
    tensor-core tile would not fit; elsewhere it is the "stream" route,
    every launch within a block's shared memory."""
    seen = {"scalar bf16": 0, "stream": 0}
    for d in range(nhead, 720 + 1, nhead * 7):
        for ffn in (16, 136, 272, 600):
            for od in (BF16, F32):
                for impl in ("auto", "scalar"):
                    plan = fe.fused_plan(d, ffn, nhead, od, impl)
                    assert max(l.smem for l in plan.launches) <= SMEM
                    previous = _previous_plan(d, ffn, nhead, od, impl)
                    if previous is None:
                        assert plan.route == "stream"
                        seen["stream"] += 1
                    else:
                        assert _as_previous(plan) == previous
            assert (_previous_plan(d, ffn, nhead, F32) is not None) == \
                _parent_takes(d, ffn, nhead)
            seen["scalar bf16"] += (_parent_takes(d, ffn, nhead) and
                                    fe.fused_plan(d, ffn, nhead, BF16).route == "scalar")
    assert min(seen.values()) > 0     # the fall-back and the new route were exercised


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
    """Since the "stream" route a plan is refused only for d not divisible
    by nhead, or ffn or nhead below 1: P19's sensor-wise width and a head
    past 368 are taken (they raised "do not take" before; the head past 368
    on "tc_cluster" in bf16 since the tensor-core route past it)."""
    for od in (BF16, F32):
        plan = fe.fused_plan(680, 272, 2, od)     # P19's sensor-wise width
        assert (plan.route, plan.attn_route) == (
            "stream", "tc_wide" if od == BF16 else "scalar")
        plan = fe.fused_plan(2 * 369, 64, 2, od)  # a head past 368
        assert (plan.route, plan.attn_route) == (
            "stream", "tc_cluster" if od == BF16 else "hd_stream")
    for d, ffn, nhead in ((85, 136, 2), (84, 0, 2), (84, 136, 0), (84, 136, -2)):
        with pytest.raises(ValueError, match="not divisible"):
            fe.fused_plan(d, ffn, nhead, BF16)    # d not divisible by nhead


@pytest.mark.parametrize("od", [BF16, F32])
@pytest.mark.parametrize("nhead", [1, 2, 3, 8])
def test_the_stream_route_s_shared_bytes_do_not_grow_with_the_width(nhead, od):
    """Every launch of the "stream" route at d up to 2048 and ffn up to
    4096 fits a block; the products', the row kernels' and the weight
    gradients' shared bytes are one value at every width, the attention's
    bounded by the head dim's route (past hd 368 fixed in f32, "hd_stream",
    and one of three values in bf16, "tc_cluster")."""
    prod = (fe.STREAM_TC_SMEM if od == BF16 else fe.STREAM_SCALAR_SMEM)
    fixed = {"qkv": prod, "dx": prod, "tail": 0, "bwd_rows": 0,
             "wgrad": 32768 if od == BF16 else 8192}
    for d in range(nhead, 2048 + 1, nhead * 37):
        for ffn in (1, 64, 288, 1000, 4096):
            for impl in ("auto", "stream"):
                plan = fe.fused_plan(d, ffn, nhead, od, impl)
                assert max(l.smem for l in plan.launches) <= SMEM
                if plan.route != "stream":
                    continue
                assert {n: plan[n].smem for n in fixed} == fixed
                assert {plan[n].route for n in ("qkv", "dx", "tail", "bwd_rows")} == {"stream"}
                if d // nhead > 368:
                    attn = [plan[n].smem for n in ("attn_fwd", "attn_dq", "attn_dkv")]
                    if od == BF16:
                        assert plan.attn_route == "tc_cluster"
                        assert attn in ([90112, 131072, 131584], [102400, 147456, 147968],
                                        [114688, 163840, 164352])
                    else:
                        assert plan.attn_route == "hd_stream"
                        assert attn == [45568, 54016, 91392]
                ints = list(plan.as_ints)
                assert ints[0::5][0] == 4 and len(ints) == 5 * len(fe.LAUNCHES)


def test_impl_stream_forces_the_route_at_pam_and_pam_sw():
    """impl="stream" takes the new route at PAM's and PAM-sw's widths, its
    attention as the "auto" plan's (the tensor cores in bf16, one
    warpgroup at hd 42 and two at hd 170; scalar in f32), so the card can
    time the route against the tile-resident ones."""
    for d, attn in ((84, "tc"), (340, "tc_wide")):
        auto, stream = (fe.fused_plan(d, 136, 2, BF16, impl) for impl in ("auto", "stream"))
        assert (stream.route, stream.attn_route) == ("stream", attn)
        assert [stream[n] for n in ATTN_LAUNCHES] == [auto[n] for n in ATTN_LAUNCHES]
        f32 = fe.fused_plan(d, 136, 2, F32, "stream")
        assert (f32.route, f32.attn_route) == ("stream", "scalar")
        assert [f32[n] for n in ATTN_LAUNCHES] == \
            [fe.fused_plan(d, 136, 2, F32)[n] for n in ATTN_LAUNCHES]
    assert fe.bwd_scratch(2, 8, 84, 136, 2, fe.fused_plan(84, 136, 2, BF16, "stream"))[
        "d_attn_op"] == (2 * 8 * 84, BF16)


def test_tensor_cores_stop_at_hd_192():
    """Past hd 192 (NARROW_MAX_HD) bf16 takes the scalar route, as before
    the attention took the tensor cores there: the two-warpgroup attention
    is built for hd_pad 176 and 208 alone, and no preset's fused-layer head
    is wider than PAM-sw's 170."""
    assert fe.fused_plan(2 * 192, 16, 2, BF16).route == "tc"
    assert fe.fused_plan(2 * 192, 16, 2, BF16).attn_route == "tc_wide"
    plan = fe.fused_plan(200, 16, 1, BF16)              # hd 200: the Wide geometry
    assert plan.route == "scalar" and plan["attn_fwd"].rows == 32


def test_pam_sensor_wise_plan_is_unchanged_by_the_wide_packed_route():
    """Every field of PAM-sw's plan (d=340, hd 170) that the C entry points
    check. The name is the previous design's, when the fused layer's
    attention kept the scalar kernels there; it now runs flash_mha_packed's
    two-warpgroup routines ("tc_wide", route int 2) on the fused layer's
    qkv rows, and the five row launches are unchanged."""
    plan = fe.fused_plan(340, 136, 2, BF16)
    assert fe.TC_MAX_HD_PAD == 144
    assert list(plan.as_ints) == [
        1, 64, 16, 256, 115712,      # qkv
        2, 64, 4, 256, 67584,        # attn_fwd: tc_wide
        1, 64, 16, 256, 193536,      # tail
        1, 64, 16, 256, 229376,      # bwd_rows
        2, 64, 4, 256, 90112,        # attn_dq: tc_wide
        2, 64, 4, 256, 90624,        # attn_dkv: tc_wide
        1, 64, 16, 256, 197632,      # dx
        1, 64, 16, 128, 32768]       # wgrad
    for name in ATTN_LAUNCHES:
        assert plan[name].route == "tc_wide" and plan[name].threads == 256


@pytest.mark.parametrize("d,ffn,nhead", WIDE_WIDTHS)
def test_bf16_head_dims_past_hd_pad_144_take_tc_wide(d, ffn, nhead):
    """hd 145-192 in bf16: the row products on the tensor cores as before,
    the attention on two warpgroups (256 threads, 64-row blocks) with the
    two-warpgroup routines' shared bytes at the head dim padded to 176 or
    208 (the mirror tests/test_torch_packed_plan.py holds against the C
    library)."""
    hd = d // nhead
    plan = fe.fused_plan(d, ffn, nhead, BF16)
    assert (plan.route, plan.attn_route) == ("tc", "tc_wide")
    assert wide_pad(hd) == (176 if hd <= 176 else 208)
    smem = wide_smem(wide_pad(hd))
    for name, want in zip(ATTN_LAUNCHES, smem):
        assert (plan[name].route, plan[name].rows, plan[name].threads,
                plan[name].smem) == ("tc_wide", 64, 256, want)
    for name in ROW_LAUNCHES:
        assert plan[name].route == "tc"
    ints = list(plan.as_ints)
    assert ints[0::5] == [1, 2, 1, 1, 2, 2, 1, 1]
    assert ints[3::5] == [256, 256, 256, 256, 256, 256, 256, 128]
    # the copy width: the largest of 16, 8, 4, 2 dividing the head's offset
    # in a row (2 hd bytes), the row strides (6 d, 2 d) and the alignment
    want = next(w for w in (16, 8, 4, 2) if (2 * hd) % w == 0 and (2 * d) % w == 0)
    assert {plan[n].copy_bytes for n in ATTN_LAUNCHES} == {want}
    assert fe.fused_plan(d, ffn, nhead, BF16, align=2)["attn_dq"].copy_bytes == 2


@pytest.mark.parametrize("hd", [8, 42, 128, 140, 144])
def test_bf16_head_dims_up_to_hd_pad_144_keep_one_warpgroup(hd):
    """Up to hd_pad 144 the attention keeps the one-warpgroup kernels: 128
    threads, five, six and six 64-row tiles at the head dim padded to 16."""
    plan = fe.fused_plan(2 * hd, 136, 2, BF16)
    assert (plan.route, plan.attn_route) == ("tc", "tc")
    tile = 64 * (-(-hd // 16) * 16) * 2
    for name, want in zip(ATTN_LAUNCHES, (5 * tile, 6 * tile, 6 * tile + 1024)):
        assert (plan[name].route, plan[name].threads, plan[name].smem) == ("tc", 128, want)
    assert list(plan.as_ints)[0::5] == [1] * 8


@pytest.mark.parametrize("d,ffn,nhead", WIDE_WIDTHS)
def test_f32_and_impl_scalar_keep_the_scalar_attention_past_hd_pad_144(d, ffn, nhead):
    """f32, and bf16 with impl="scalar", keep the scalar kernels at hd
    145-192: the Narrow geometry (64-row blocks, 256 threads), every route
    int 0, the operand size as the copy width."""
    hd = d // nhead
    narrow = (((64 + 128) * (hd + 1) + 64 * 65) * 4, (256 * (hd + 1) + 64 * 65) * 4,
              (256 * (hd + 1) + 2 * 64 * 65 + 128) * 4)
    for od, impl in ((F32, "auto"), (BF16, "scalar")):
        plan = fe.fused_plan(d, ffn, nhead, od, impl)
        assert (plan.route, plan.attn_route) == ("scalar", "scalar")
        assert list(plan.as_ints)[0::5] == [0] * 8
        for name, want in zip(ATTN_LAUNCHES, narrow):
            assert (plan[name].rows, plan[name].copy_bytes, plan[name].threads,
                    plan[name].smem) == (64, od.itemsize, 256, want)


def test_a_route_the_c_side_does_not_know_is_refused():
    """FusedPlan.as_ints maps routes to the C side's ints (0 scalar, 1 tc, 2
    tc_wide) and raises for a route it has no int for, so no plan reaches
    the entry points with one (they refuse any plan whose ints differ from
    their own, tests/test_torch_kernels_cuda.py)."""
    plan = fe.fused_plan(340, 136, 2, BF16)
    assert {l.route: i for l, i in zip(plan.launches, list(plan.as_ints)[0::5])} == \
        {"tc": 1, "tc_wide": 2}
    bad = fe.FusedPlan("tc", "tc_huge", tuple(
        fe.FusedLaunch("tc_huge", l.rows, l.copy_bytes, l.threads, l.smem)
        if name in ATTN_LAUNCHES else l for name, l in zip(fe.LAUNCHES, plan.launches)))
    with pytest.raises(KeyError):
        bad.as_ints


def test_tc_wide_launches_are_counted_apart():
    """A call whose attention ran on two warpgroups adds one to tc_wide_<attr>
    beside <attr> and tc_<attr>; a one-warpgroup or scalar plan does not."""
    layer = fe.fused_encoder_layer
    attrs = ("launches", "tc_launches", "tc_wide_launches", "bwd_launches",
             "tc_bwd_launches", "tc_wide_bwd_launches")
    before = {a: getattr(layer, a) for a in attrs}
    fe._count(fe.fused_plan(340, 136, 2, BF16), "launches")
    fe._count(fe.fused_plan(84, 136, 2, BF16), "bwd_launches")
    fe._count(fe.fused_plan(340, 136, 2, F32), "bwd_launches")
    after = {a: getattr(layer, a) - before[a] for a in attrs}
    assert after == {"launches": 1, "tc_launches": 1, "tc_wide_launches": 1,
                     "bwd_launches": 2, "tc_bwd_launches": 1, "tc_wide_bwd_launches": 0}
    for a in attrs:
        setattr(layer, a, before[a])


def test_stream_launches_are_counted_apart():
    """A call on the "stream" route adds one to stream_<attr> beside <attr>
    (and to hd_stream_<attr> where its attention ran past hd 368 in f32,
    to tc_cluster_<attr> in bf16); no tc_ count moves."""
    layer = fe.fused_encoder_layer
    attrs = ("launches", "tc_launches", "stream_launches", "hd_stream_launches",
             "bwd_launches", "tc_bwd_launches", "stream_bwd_launches",
             "hd_stream_bwd_launches", "tc_cluster_launches", "tc_cluster_bwd_launches")
    before = {a: getattr(layer, a) for a in attrs}
    fe._count(fe.fused_plan(720, 288, 2, BF16), "launches")
    fe._count(fe.fused_plan(720, 288, 1, F32), "launches")
    fe._count(fe.fused_plan(720, 288, 1, BF16), "bwd_launches")
    after = {a: getattr(layer, a) - before[a] for a in attrs}
    assert after == {"launches": 2, "tc_launches": 0, "stream_launches": 2,
                     "hd_stream_launches": 1, "bwd_launches": 1, "tc_bwd_launches": 0,
                     "stream_bwd_launches": 1, "hd_stream_bwd_launches": 0,
                     "tc_cluster_launches": 0, "tc_cluster_bwd_launches": 1}
    for a in attrs:
        setattr(layer, a, before[a])
