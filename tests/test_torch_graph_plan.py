"""The sparse-graph kernels' launch plan (ops/sparse.py graph_plan), field
by field, on the CPU: the route, the column chunk, the column groups, the
shared bytes, the copy width and the grid at every shape of chip_smoke.py's
graph phases, and at the plan's edges (D % 4 != 0, an operand off 16-byte
alignment, shared bytes at a block's limit, the cut-over to "csr" in N, B=1
splitting its columns). The C entry points recompute the same plan and
refuse any other (csrc/sparse_graph.cu make_graph_plan; the card test
test_graph_plan_of_the_kernels_matches_the_wrappers holds the two equal).
Everything here is arithmetic on the host: no card is needed.
"""

import pytest
import torch

from raindrop_tpu_torch.graph import propagate as prop
from raindrop_tpu_torch.ops import sparse as sp
from raindrop_tpu_torch.ops.sparse import GraphPlan, graph_plan

P12, PAM, KNN = (36, 1296), (17, 289), (128, 768)


# (B, (N, E), D, kind) -> the plan, worked out by hand from graph_plan's
# docstring. "row": 256 columns a warp unless that leaves fewer than 264
# CTAs of 8 warps. "tile": a target of 264 CTAs (198 for dot products where
# E < 16 N, 132 for sddmm_bwd where E >= 16 N); for C = 128, 64, 32, groups
# = min(chunks, ceil(target / B), 8) and parts = min(ceil(target / (B
# groups)), N, ceil(E / 256)); shared
# bytes of a weighted sum 2 N (C + 4) 4 + 8 min(E, 1024) + 4 (N + 1) + 8 N,
# of the dot products 4 N (C + 4) 4 + 12 ceil(E / parts); the largest C
# within 58,112 bytes reaching the target, else the smallest that fits.
CASES = [
    # the model's form: P12 and PAM served and trained with prop_backend='pallas'
    (128, P12, 860, "fwd_target", GraphPlan("row", 256, 4, 1, 0, 16, (2304, 1))),
    (128, P12, 860, "bwd_target", GraphPlan("row", 256, 4, 1, 0, 16, (2304, 1))),
    (128, PAM, 2400, "fwd_target", GraphPlan("row", 256, 10, 1, 0, 16, (2720, 1))),
    (128, KNN, 240, "bwd_target", GraphPlan("row", 256, 1, 1, 0, 16, (2048, 1))),
    # the source's rows gathered: 38016 + 8192 + 148 + 288 = 46644
    (128, P12, 860, "fwd_source", GraphPlan("tile", 128, 3, 1, 46644, 16, (3, 128))),
    (128, PAM, 2400, "fwd_source", GraphPlan("tile", 128, 3, 1, 20472, 16, (3, 128))),
    # kNN: N=128 rows take 142,852 bytes at C=128 and 77,316 at 64; 32 is
    # the first within 58,112 (36864 + 6144 + 516 + 1024)
    (128, KNN, 240, "fwd_source", GraphPlan("tile", 32, 3, 1, 44548, 16, (3, 128))),
    # the backward runs the dot products too: at P12 C=128 they take
    # 76032 + 15552 bytes, C=64 39168 + 15552
    (128, P12, 860, "bwd_source", GraphPlan("tile", 64, 3, 1, 54720, 16, (3, 128))),
    # kNN (E = 6 N, light): no chunk within 58,112 bytes, so the smallest,
    # 73728 + 9216, two groups (ceil(198 / 128))
    (128, KNN, 240, "bwd_source", GraphPlan("tile", 32, 2, 1, 82944, 16, (2, 128))),
    (128, P12, 860, "sddmm_fwd", GraphPlan("tile", 64, 3, 1, 54720, 16, (3, 128))),
    # dq and dk in one launch: two groups (ceil(132 / 128)) a sample
    (128, P12, 860, "sddmm_bwd", GraphPlan("tile", 128, 2, 1, 46644, 16, (2, 128))),
    (128, PAM, 860, "sddmm_fwd", GraphPlan("tile", 128, 3, 1, 39372, 16, (3, 128))),
    (128, KNN, 860, "sddmm_fwd", GraphPlan("tile", 32, 2, 1, 82944, 16, (2, 128))),
    (128, KNN, 860, "sddmm_bwd", GraphPlan("tile", 32, 3, 1, 44548, 16, (3, 128))),
    # D=120: one chunk of 128 columns, so the nodes split into parts (2 of
    # them reach sddmm_bwd's 132); the dot products at C=128 exceed 58,112
    # bytes, at 64 two groups of two parts give 512 CTAs
    (128, P12, 120, "sddmm_bwd", GraphPlan("tile", 128, 1, 2, 46644, 16, (2, 128))),
    (128, P12, 120, "fwd_source", GraphPlan("tile", 128, 1, 3, 46644, 16, (3, 128))),
    (128, P12, 120, "sddmm_fwd", GraphPlan("tile", 64, 2, 2, 46944, 16, (4, 128))),
    # the self-attention phase's shape, its heads on the batch axis (B=2),
    # and one head a call (B=1): D=430 is not a multiple of 4 (4-byte
    # copies); no chunk reaches 264 CTAs, so the smallest splits furthest:
    # 8 groups (a cluster) of 32 columns, 6 parts (ceil(1296 / 256))
    (2, P12, 430, "sddmm_fwd", GraphPlan("tile", 32, 8, 6, 23328, 4, (48, 2))),
    (1, P12, 430, "sddmm_fwd", GraphPlan("tile", 32, 8, 6, 23328, 4, (48, 1))),
    (1, P12, 430, "sddmm_bwd", GraphPlan("tile", 32, 8, 6, 18996, 4, (48, 1))),
    (2, P12, 430, "sddmm_bwd", GraphPlan("tile", 32, 8, 6, 18996, 4, (48, 2))),
    # B=1 on "row": 256 columns give 9 CTAs, 128 give 18 (taken)
    (1, P12, 430, "fwd_target", GraphPlan("row", 128, 4, 1, 0, 4, (18, 1))),
    (1, P12, 860, "bwd_target", GraphPlan("row", 128, 7, 1, 0, 16, (32, 1))),
]


@pytest.mark.parametrize("B,graph,D,kind,want", CASES)
def test_graph_plan_at_the_graph_phases_shapes(B, graph, D, kind, want):
    N, E = graph
    assert graph_plan(B, N, E, D, kind) == want


@pytest.mark.parametrize("D,copy", [(7, 4), (430, 4), (860, 16), (1100, 16), (2400, 16),
                                    (2, 4), (4, 16)])
@pytest.mark.parametrize("kind", sp.KINDS)
def test_the_copy_width_needs_d_a_multiple_of_4_and_16_byte_operands(kind, D, copy):
    N, E = P12
    assert graph_plan(5, N, E, D, kind).copy == copy
    for align in (8, 4):
        assert graph_plan(5, N, E, D, kind, align).copy == 4
    # only the copy width depends on the alignment
    fields = lambda p: (p.route, p.chunk, p.groups, p.parts, p.smem, p.grid)
    assert fields(graph_plan(5, N, E, D, kind, 4)) == fields(graph_plan(5, N, E, D, kind))


@pytest.mark.parametrize("kind,last,parts,smem", [
    # weighted sums: 300 N + 8196 bytes at 32 columns (N=747: 232,296;
    # N=748: 232,596, past the limit)
    ("fwd_source", 747, 18, 232296), ("sddmm_bwd", 747, 18, 232296),
    # dot products: 576 N + 12 ceil(6 N / parts), parts = ceil(6 N / 256)
    # (N=398: 229,248 + 2,868; N=399: 229,824 + 2,880 = 232,704)
    ("sddmm_fwd", 398, 10, 232116), ("bwd_source", 398, 10, 232116)])
def test_the_csr_route_begins_where_32_columns_of_the_rows_stop_fitting(kind, last, parts,
                                                                         smem):
    """k = 6 edges a node, B=2, D=36 (two groups of 32 columns)."""
    B, D, k = 2, 36, 6
    at = graph_plan(B, last, k * last, D, kind)
    assert at == GraphPlan("tile", 32, 2, parts, smem, 16, (2 * parts, B))
    assert smem <= sp.MAX_SMEM
    past = graph_plan(B, last + 1, k * (last + 1), D, kind)
    assert past == GraphPlan("csr", 1024, 1, 1, 0, 4, (last + 1, B))
    # the csr route's own geometry: 1024 columns a CTA, a CTA per node
    assert graph_plan(3, 5000, 6000, 2500, kind) == GraphPlan("csr", 1024, 3, 1, 0, 4,
                                                              (5000, 3))


def test_the_shared_bytes_formulas():
    assert sp.sum_smem(36, 128, 1296) == 2 * 36 * 132 * 4 + 1024 * 8 + 37 * 4 + 8 * 36
    assert sp.sum_smem(17, 128, 289) == 2 * 17 * 132 * 4 + 289 * 8 + 18 * 4 + 8 * 17
    assert sp.dot_smem(36, 64, 1296) == 4 * 36 * 68 * 4 + 1296 * 12


@pytest.mark.parametrize("kind", ["fwd_target", "bwd_target"])
def test_the_row_route_stages_nothing_and_takes_any_node_count(kind):
    plan = graph_plan(2, 5000, 30000, 36, kind)
    assert plan == GraphPlan("row", 256, 1, 1, 0, 16, (1250, 1))


@pytest.mark.parametrize("B,chunk,groups,parts", [
    (1, 32, 8, 6), (2, 32, 8, 6), (5, 32, 8, 6), (11, 128, 4, 6), (33, 128, 4, 2),
    (66, 128, 4, 1), (88, 128, 3, 1), (132, 128, 2, 1), (264, 128, 1, 1)])
def test_small_batches_split_their_columns_and_positions_until_the_card_is_full(
        B, chunk, groups, parts):
    """The forward with the source gathered at P12, D=430: groups =
    min(chunks, ceil(264 / B), 8), parts = min(ceil(264 / (B groups)), 36,
    6), from the largest chunk whose grid reaches 264 CTAs (C=128 gives 4
    chunks, 64 gives 7)."""
    N, E = P12
    plan = graph_plan(B, N, E, 430, "fwd_source")
    assert (plan.chunk, plan.groups, plan.parts, plan.grid) == (
        chunk, groups, parts, (groups * parts, B))
    assert B * groups * parts >= sp.TARGET_CTAS or chunk == 32


def test_dot_products_split_their_positions_to_fit_a_thread_block():
    """A part's CSR positions are at most DOT_PART (2048): E = 10,000
    positions take at least 5 parts, even at a batch that needs none."""
    plan = graph_plan(512, 100, 10000, 64, "sddmm_fwd")
    assert plan == GraphPlan("tile", 32, 1, 5, 4 * 100 * 36 * 4 + 12 * 2000, 16, (5, 512))


def test_the_plan_as_the_c_entry_points_take_it():
    plan = graph_plan(128, *P12, 860, "fwd_source")
    assert list(plan.as_ints) == [1, 128, 3, 1, 46644, 16, 3, 128]
    assert list(graph_plan(128, *P12, 860, "fwd_target").as_ints)[0] == 0
    with pytest.raises(ValueError, match="kind"):
        graph_plan(128, *P12, 860, "spmm")


def test_the_wrappers_count_each_route_apart():
    for fn in (sp.spmm_segment_softmax, sp.sddmm):
        for route in sp.ROUTES:
            for attr in ("launches", "bwd_launches"):
                assert isinstance(getattr(fn, f"{route}_{attr}"), int)


def test_selfattention_folds_the_heads_into_one_sddmm_call(monkeypatch):
    """ob_propagate_selfattention(score_backend='sddmm') hands sddmm its
    heads on the batch axis: one call of [heads, N, D / heads]."""
    gen = torch.Generator().manual_seed(0)
    N, D, heads = 9, 12, 3
    params = prop.ob_propagation_init(gen, D, D // heads, N, 4, heads=heads,
                                      device="cpu")
    x = torch.randn((N, D), generator=gen)
    ei = torch.stack([torch.arange(N).repeat_interleave(N), torch.arange(N).repeat(N)])
    calls = []

    def counted(q, k, src, dst, scale=1.0):
        calls.append(tuple(q.shape))
        return sp.sddmm(q, k, src, dst, scale)

    monkeypatch.setattr(prop, "sddmm", counted)
    out, (_, alpha) = prop.ob_propagate_selfattention(
        params, x, ei, heads=heads, n_nodes=N, score_backend="sddmm")
    ref, (_, ref_alpha) = prop.ob_propagate_selfattention(
        params, x, ei, heads=heads, n_nodes=N, score_backend="gather")
    assert calls == [(heads, N, D // heads)]
    assert alpha.shape == (N * N, heads)
    torch.testing.assert_close(alpha, ref_alpha, rtol=0, atol=1e-6)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
