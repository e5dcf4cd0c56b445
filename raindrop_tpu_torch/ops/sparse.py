"""Sparse sensor-graph ops: fused SpMM + segment softmax, and SDDMM (port
of raindrop_tpu/ops/sparse_pallas.py).

    spmm_segment_softmax(x, gamma, src, dst, n_nodes=N, gather_target=...)
        out[b, n] = sum_{e: dst_e = n} softmax_n(gamma[b])_e * x[b, idx_e]
        with idx = dst (gather_target, the Ob_propagation x_i quirk) or src;
        returns (out [B, N, D], the post-softmax weights [B, E])
    sddmm(q, k, src, dst, scale)
        alpha[b, e] = scale * q[b, dst_e] . k[b, src_e]

One edge topology serves the whole batch, edges in any order, a scalar
weight per edge, everything f32. Both are `torch.autograd.Function`s. On
CUDA tensors forward and backward launch the hand-written kernels of
`csrc/sparse_graph.cu` (or raise): destination-sorted CSR segment kernels
with fixed summation orders, so a repeat gives the same bits. On CPU
tensors they run `_spmm_fwd_plain`, `_spmm_bwd_plain`, `_sddmm_fwd_plain`
and `_sddmm_bwd_plain`, the same functions in plain PyTorch over
ops/segment.py, which the CPU tests hold against the JAX package and which
the kernels are held against on the card.

The kernels need the edges grouped by destination and by source. That is
worked out once per topology (`topology`: two stable sorts) and cached on
the identity of the index tensors, so a model that calls with the same
`src`/`dst` tensors for ever sorts once. Do not write into index tensors
that were handed to these functions.

Each call on the card follows a launch plan (`graph_plan`, checked by the
C entry points): route "row" where every edge of a segment gathers the
segment's own row (the model's `gather_target=True`, forward and dx),
"tile" for every other gather (a sample's rows staged in shared memory),
"csr" where a sample's rows do not fit a tile (the previous design). The
wrappers count their launches on each route apart (`row_launches`,
`tile_bwd_launches`, ...). A call over more than 65535 samples (the
grid's y axis) runs as launches of at most that many (batch_chunks; the
samples are independent), each counted.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.ops.flash_attention import _align, batch_chunks
from raindrop_tpu_torch.ops.segment import segment_max, segment_softmax, segment_sum

# the launch plan's constants (csrc/sparse_graph.cu)
ROUTES = ("row", "tile", "csr")
KINDS = ("fwd_target", "fwd_source", "bwd_target", "bwd_source", "sddmm_fwd",
         "sddmm_bwd")
MAX_SMEM = 232448       # a block's shared memory on the H100
TARGET_CTAS = 264       # two CTAs on each of the H100's 132 SMs
EDGE_STAGE = 1024       # CSR positions a tile-route sum stages at a time
ROW_PAD = 4             # floats between a staged row's chunk and the next row
SMEM_PREFER = MAX_SMEM // 4   # a tile that lets 4 CTAs share an SM
MAX_GROUPS = 8          # column groups: a portable cluster's CTAs
THREADS = 256           # threads per CTA; the row route runs a warp an item
DOT_PART = 2048         # most CSR positions of a dot-product part (its shared bytes)
CSR_CHUNK = 1024        # columns of a csr-route CTA (256 threads x 4)


@dataclass(frozen=True)
class Topology:
    """One edge list prepared for the kernels, all int32 on the edges'
    device: `src`, `dst` [E] as given; `dst_perm` [E] the edge ids in
    stable order of dst with `dst_ptr` [N+1] the segment bounds in it; the
    same by src. In CSR order: `dst_nbr` = src[dst_perm] and `dst_seg` =
    dst[dst_perm] (each position's source, and its segment's node),
    `src_nbr` = dst[src_perm]; the tile route reads these instead of
    chasing perm."""
    n_nodes: int
    src: torch.Tensor
    dst: torch.Tensor
    dst_perm: torch.Tensor
    dst_ptr: torch.Tensor
    src_perm: torch.Tensor
    src_ptr: torch.Tensor
    dst_nbr: torch.Tensor
    dst_seg: torch.Tensor
    src_nbr: torch.Tensor

    @functools.cached_property
    def table(self) -> int:
        """The address of the arrays' device pointers in the order of
        csrc/sparse_graph.cu `Topo`, built once (the entry points take the
        topology as this one pointer)."""
        arrays = (self.src, self.dst, self.dst_perm, self.dst_ptr, self.dst_nbr,
                  self.dst_seg, self.src_perm, self.src_ptr, self.src_nbr)
        table = (ctypes.c_void_p * len(arrays))(*(t.data_ptr() for t in arrays))
        object.__setattr__(self, "_table", table)    # kept alive with the topology
        return ctypes.addressof(table)


def _csr(ids: torch.Tensor, n_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    perm = torch.sort(ids.to(torch.int64), stable=True).indices
    counts = torch.bincount(ids.to(torch.int64), minlength=n_nodes)
    ptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=ids.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return perm.to(torch.int32).contiguous(), ptr.to(torch.int32).contiguous()


def build_topology(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                   n_nodes: int) -> Topology:
    """Check an edge list and sort it into the two CSRs."""
    _check_edges(edge_src, edge_dst)
    E = edge_src.shape[0]
    if E == 0 or E >= 2 ** 31:
        raise ValueError(f"the kernels take 1 <= E < 2**31 edges, got {E}")
    both = torch.stack([edge_src.to(torch.int64), edge_dst.to(torch.int64)])
    lo, hi = int(both.min()), int(both.max())
    if lo < 0 or hi >= n_nodes:
        raise ValueError(f"edge endpoints span [{lo}, {hi}], outside "
                         f"[0, n_nodes={n_nodes})")
    dst_perm, dst_ptr = _csr(edge_dst, n_nodes)
    src_perm, src_ptr = _csr(edge_src, n_nodes)
    src = edge_src.to(torch.int32).contiguous()
    dst = edge_dst.to(torch.int32).contiguous()
    dst_order, src_order = dst_perm.to(torch.int64), src_perm.to(torch.int64)
    return Topology(n_nodes, src, dst, dst_perm, dst_ptr, src_perm, src_ptr,
                    src[dst_order].contiguous(), dst[dst_order].contiguous(),
                    dst[src_order].contiguous())


_TOPO_CACHE_SIZE = 16
_topo_lock = threading.Lock()
# key -> (the index tensors, kept alive so their addresses stay theirs; Topology)
_topo_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t._version, t.dtype, str(t.device), tuple(t.shape),
            t.stride())


def topology(edge_src: torch.Tensor, edge_dst: torch.Tensor,
             n_nodes: int) -> Topology:
    """The cached Topology of these index tensors (same storage, same
    version counter), built on a miss."""
    key = (_tensor_key(edge_src), _tensor_key(edge_dst), int(n_nodes))
    with _topo_lock:
        hit = _topo_cache.get(key)
        if hit is not None:
            _topo_cache.move_to_end(key)
            return hit[1]
    topo = build_topology(edge_src, edge_dst, int(n_nodes))
    with _topo_lock:
        topology.builds += 1
        _topo_cache[key] = ((edge_src, edge_dst), topo)
        while len(_topo_cache) > _TOPO_CACHE_SIZE:
            _topo_cache.popitem(last=False)
    return topo


# cache misses so far: a path that keeps its index tensors adds none
topology.builds = 0


def _check_edges(edge_src, edge_dst) -> None:
    if (edge_src.dim() != 1 or edge_src.shape != edge_dst.shape
            or edge_src.is_floating_point() or edge_dst.is_floating_point()):
        raise ValueError("edge_src and edge_dst must be integer tensors [E]")
    if edge_src.device != edge_dst.device:
        raise ValueError("edge_src and edge_dst lie on different devices")


def _check_nodes(name, x, edge_src, n_nodes=None) -> None:
    if x.dim() != 3 or (n_nodes is not None and x.shape[1] != n_nodes):
        raise ValueError(f"{name} must be [B, n_nodes, D] (n_nodes={n_nodes}), "
                         f"got {tuple(x.shape)}")
    if x.device != edge_src.device:
        raise ValueError(f"{name} is on {x.device}, the edges on {edge_src.device}")
    if x.is_cuda and x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, {name} is {x.dtype}")


# ---------------------------------------------------------------- plain
def _spmm_fwd_plain(x, gamma, edge_src, edge_dst, n_nodes, gather_target):
    """The forward in plain PyTorch: (out [B, N, D], w [B, E])."""
    idx = (edge_dst if gather_target else edge_src).to(torch.int64)
    w = segment_softmax(gamma.transpose(0, 1), edge_dst, n_nodes)     # [E, B]
    msgs = x[:, idx].transpose(0, 1) * w[..., None]                   # [E, B, D]
    out = segment_sum(msgs, edge_dst, n_nodes).transpose(0, 1)
    return out, w.transpose(0, 1)


def _spmm_bwd_plain(g_out, g_w, x, w, edge_src, edge_dst, n_nodes,
                    gather_target, need_dgamma=True):
    """The backward written out: (dx [B, N, D], dgamma [B, E] or None).
    `g_w`, the cotangent of the returned weights, may be None. The dot
    products of s are shifted by a constant per segment (their max) before
    g_w is added and the weighted sum taken: the weights sum to 1 only up
    to rounding, which the shift keeps from being multiplied by |s|."""
    dst = edge_dst.to(torch.int64)
    idx = dst if gather_target else edge_src.to(torch.int64)
    g_e = g_out[:, dst].transpose(0, 1)                               # [E, B, D]
    wt = w.transpose(0, 1)                                            # [E, B]
    dx = segment_sum(g_e * wt[..., None], idx, n_nodes).transpose(0, 1)
    if not need_dgamma:
        return dx, None
    s = (g_e * x[:, idx].transpose(0, 1)).sum(-1)
    s = s - segment_max(s, dst, n_nodes)[dst]
    if g_w is not None:
        s = s + g_w.transpose(0, 1)
    inner = segment_sum(wt * s, dst, n_nodes)                         # [N, B]
    return dx, (wt * (s - inner[dst])).transpose(0, 1)


def _sddmm_fwd_plain(q, k, edge_src, edge_dst, scale):
    return (q[:, edge_dst.to(torch.int64)]
            * k[:, edge_src.to(torch.int64)]).sum(-1) * scale


def _sddmm_bwd_plain(d_alpha, q, k, edge_src, edge_dst, scale):
    """(dq, dk) [B, N, D]: d_alpha-weighted partner rows summed per node."""
    src, dst = edge_src.to(torch.int64), edge_dst.to(torch.int64)
    n_nodes = q.shape[1]
    wt = (d_alpha * scale).transpose(0, 1)[..., None]                 # [E, B, 1]
    dq = segment_sum(wt * k[:, src].transpose(0, 1), dst, n_nodes)
    dk = segment_sum(wt * q[:, dst].transpose(0, 1), src, n_nodes)
    return dq.transpose(0, 1), dk.transpose(0, 1)


# ----------------------------------------------------------- launch plan
@dataclass(frozen=True)
class GraphPlan:
    """A call's launch plan, computed on the host and checked field by
    field by the C entry points (csrc/sparse_graph.cu `make_graph_plan`).
    route: "row", "tile" or "csr"; chunk: a warp's columns on "row" (128 or
    256), a staged tile's on "tile" (32, 64 or 128), 1024 on "csr"; groups:
    the column chunks of a row on "row", the CTAs (one cluster) a sample's
    columns are split over on "tile", the grid's z on "csr"; parts: the
    parts a sample's nodes (weighted sums) or CSR positions (dot products)
    are split over on "tile" (else 1); smem: the largest dynamic shared
    bytes of the call's kernels; copy: 16-byte or 4-byte copies and loads;
    grid: the main kernel's (x, y)."""

    route: str
    chunk: int
    groups: int
    parts: int
    smem: int
    copy: int
    grid: Tuple[int, int]

    @functools.cached_property
    def as_ints(self):
        """The plan as the C entry points take it: 8 ints."""
        vals = (ROUTES.index(self.route), self.chunk, self.groups, self.parts,
                self.smem, self.copy, *self.grid)
        return (ctypes.c_int * len(vals))(*vals)

    @functools.cached_property
    def address(self) -> int:
        """The address of as_ints, which the entry points read."""
        return ctypes.addressof(self.as_ints)


def sum_smem(N, C, E):
    """Shared bytes of a weighted sum on the tile route (tile_sum_kernel) at
    N rows and C columns: two staged buffers of N rows, C + ROW_PAD floats
    apart; min(E, EDGE_STAGE) staged CSR positions (weight and row offset,
    8 bytes each); ptr (N + 1 ints); the forward's softmax max and sum (two
    floats a node)."""
    return 2 * N * (C + ROW_PAD) * 4 + min(E, EDGE_STAGE) * 8 + (N + 1) * 4 + 8 * N


def dot_smem(N, C, per):
    """Shared bytes of the tile route's edge dot products (tile_dot_kernel):
    two staged buffers of each operand's N rows, and for a part's `per` CSR
    positions their partial sums and row offsets (12 bytes each)."""
    return 4 * N * (C + ROW_PAD) * 4 + 12 * per


@functools.lru_cache(maxsize=256)
def graph_plan(B, N, E, D, kind, align=16) -> GraphPlan:
    """The launch plan of a call on the card: `kind` is which reduction
    (KINDS: spmm_segment_softmax's forward and backward with the target's
    or the source's row gathered, sddmm's forward and backward), `align`
    the operands' address alignment in bytes. The copy width is 16 bytes
    where D % 4 == 0 and align is 16, else 4.

    "row" (fwd_target, bwd_target): a warp per (sample, node, chunk of
    columns), 8 a CTA; the chunk is 256 columns, or 128 where 256 leaves
    fewer than TARGET_CTAS CTAs.

    "tile" (the rest): a CTA per (column group, part, sample). The target
    is TARGET_CTAS, three quarters of it for dot products on a light graph
    (E < 16 N: their tiles leave room for fewer CTAs an SM), half for
    sddmm_bwd on a denser one (dq and dk share a launch). For each chunk C
    of 128, 64, 32: groups = min(chunks of D, ceil(target / B),
    MAX_GROUPS); parts = min(ceil(target / (B groups)), N, ceil(E /
    THREADS)), and where dot products run (sddmm_fwd, bwd_source) at least
    ceil(E / DOT_PART), which bounds a part's staged positions; smem the
    largest of the call's kernels (sum_smem, dot_smem). The plan takes the
    largest C whose smem is at most SMEM_PREFER and whose B groups parts
    reaches the target, else the smallest C that fits a block (B=1 splits
    its columns and parts furthest). "csr" where even 32 columns of the
    rows do not fit."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    copy = 16 if D % 4 == 0 and align % 16 == 0 else 4
    if kind in ("fwd_target", "bwd_target"):
        for cpt in (8, 4):
            chunks = -(-D // (32 * cpt))
            ctas = -(-(B * N * chunks) // (THREADS // 32))
            if ctas >= TARGET_CTAS:
                break
        return GraphPlan("row", 32 * cpt, chunks, 1, 0, copy, (ctas, 1))
    sums = kind != "sddmm_fwd"
    dots = kind in ("sddmm_fwd", "bwd_source")
    light = E < 16 * N
    target = (TARGET_CTAS * 3 // 4 if dots and light else
              TARGET_CTAS // 2 if kind == "sddmm_bwd" and not light else TARGET_CTAS)
    plan = None
    for C in (128, 64, 32):
        groups = min(-(-D // C), -(-target // B), MAX_GROUPS)
        parts = min(-(-target // (B * groups)), N, -(-E // THREADS))
        if dots:
            parts = max(parts, -(-E // DOT_PART))
        smem = max(sum_smem(N, C, E) if sums else 0,
                   dot_smem(N, C, -(-E // parts)) if dots else 0)
        if smem > MAX_SMEM:
            continue
        plan = GraphPlan("tile", C, groups, parts, smem, copy, (groups * parts, B))
        if smem <= SMEM_PREFER and B * groups * parts >= target:
            break
    if plan is None:
        return GraphPlan("csr", CSR_CHUNK, -(-D // CSR_CHUNK), 1, 0, 4, (N, B))
    return plan


# ----------------------------------------------------------------- CUDA
def _lib():
    lib = build.load("sparse_graph")
    if lib.rd_spmm_fwd.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        # pointers, the topology's table and the plan's ints as addresses
        lib.rd_graph_plan.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.rd_spmm_fwd.argtypes = [p, p, ll, p, p, p] + [i] * 5 + [p, p]
        lib.rd_spmm_bwd.argtypes = [p] * 7 + [i] * 5 + [p, p]
        lib.rd_sddmm_fwd.argtypes = [p] * 4 + [i] * 4 + [f, p, p]
        lib.rd_sddmm_bwd.argtypes = [p] * 6 + [i] * 4 + [f, p, p]
        for fn in (lib.rd_graph_plan, lib.rd_spmm_fwd, lib.rd_spmm_bwd,
                   lib.rd_sddmm_fwd, lib.rd_sddmm_bwd):
            fn.restype = ctypes.c_int
    return lib


def graph_plan_c(B, N, E, D, kind, align=16) -> GraphPlan:
    """The plan csrc/sparse_graph.cu makes for these arguments (it builds
    the library: on the card only); the card tests hold it equal to
    graph_plan."""
    out = (ctypes.c_int * 8)()
    err = _lib().rd_graph_plan(B, N, E, D, KINDS.index(kind), align, out)
    if err:
        raise ValueError(f"rd_graph_plan refused B={B} N={N} E={E} D={D} {kind}")
    return GraphPlan(ROUTES[out[0]], *out[1:6], (out[6], out[7]))


def edge_flops(B: int, E: int, D: int) -> int:
    """Model FLOPs of one pass over the edges: a D-wide multiply-add per
    edge and sample (spmm_segment_softmax's weighted sum, sddmm's dot
    product), as the dense form over a complete graph (E = N^2) counts
    them. The kernels credit it once for a forward, once for each of the
    backward's products they compute (dx, and dgamma where it is needed;
    dq and dk)."""
    return 2 * B * E * D


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(fn, plan: GraphPlan, attr):
    """One launch of the wrapper `fn` on `attr` and on <route>_<attr>."""
    build.count_launch(fn, attr, f"{plan.route}_{attr}")


def _spmm_fwd_cuda(x, gamma, topo: Topology, gather_target):
    B, N, D = x.shape
    E = topo.src.shape[0]
    x = x.contiguous()
    # one row of logits broadcast over the batch (a stride-0 expand) is
    # read in place; anything else is made [B, E] contiguous
    if gamma.stride(0) == 0 and (E == 1 or gamma.stride(1) == 1):
        g_stride = 0
    else:
        gamma = gamma.contiguous()
        g_stride = E
    out = torch.empty((B, N, D), dtype=torch.float32, device=x.device)
    w = torch.empty((B, E), dtype=torch.float32, device=x.device)
    for c0, c1 in batch_chunks(B):
        # the C entry point also holds the outputs, allocated here, to the
        # alignment: a misaligned one is refused, not misread
        plan = graph_plan(c1 - c0, N, E, D, "fwd_target" if gather_target else "fwd_source",
                          _align(x[c0:c1].data_ptr()))
        err = _lib().rd_spmm_fwd(
            x[c0:c1].data_ptr(), gamma[c0:c1].data_ptr(), g_stride, topo.table,
            out[c0:c1].data_ptr(), w[c0:c1].data_ptr(), c1 - c0, N, E, D,
            int(gather_target), plan.address, _stream(x))
        build.check(err, "spmm_segment_softmax forward")
        _count(spmm_segment_softmax, plan, "launches")
    build.credit(edge_flops(B, E, D))
    return out, w


def _spmm_bwd_cuda(g_out, g_w, x, w, topo: Topology, gather_target,
                   need_dgamma=True):
    B, N, D = x.shape
    E = topo.src.shape[0]
    g_out = g_out.to(torch.float32).contiguous()
    if g_w is not None:
        g_w = g_w.to(torch.float32).contiguous()
    x, w = x.contiguous(), w.contiguous()
    dx = torch.empty((B, N, D), dtype=torch.float32, device=x.device)
    dgamma = (torch.empty((B, E), dtype=torch.float32, device=x.device)
              if need_dgamma else None)
    for c0, c1 in batch_chunks(B):
        g_c, x_c = g_out[c0:c1], x[c0:c1]
        plan = graph_plan(c1 - c0, N, E, D, "bwd_target" if gather_target else "bwd_source",
                          _align(g_c.data_ptr(), x_c.data_ptr()))
        err = _lib().rd_spmm_bwd(
            g_c.data_ptr(), None if g_w is None else g_w[c0:c1].data_ptr(), x_c.data_ptr(),
            w[c0:c1].data_ptr(), topo.table, dx[c0:c1].data_ptr(),
            None if dgamma is None else dgamma[c0:c1].data_ptr(), c1 - c0, N, E, D,
            int(gather_target), plan.address, _stream(x))
        build.check(err, "spmm_segment_softmax backward")
        _count(spmm_segment_softmax, plan, "bwd_launches")
    build.credit((1 + need_dgamma) * edge_flops(B, E, D))
    return dx, dgamma


def _sddmm_fwd_cuda(q, k, topo: Topology, scale):
    B, N, D = q.shape
    E = topo.src.shape[0]
    q, k = q.contiguous(), k.contiguous()
    alpha = torch.empty((B, E), dtype=torch.float32, device=q.device)
    for c0, c1 in batch_chunks(B):
        q_c, k_c = q[c0:c1], k[c0:c1]
        plan = graph_plan(c1 - c0, N, E, D, "sddmm_fwd", _align(q_c.data_ptr(), k_c.data_ptr()))
        err = _lib().rd_sddmm_fwd(
            q_c.data_ptr(), k_c.data_ptr(), topo.table, alpha[c0:c1].data_ptr(), c1 - c0,
            N, E, D, float(scale), plan.address, _stream(q))
        build.check(err, "sddmm forward")
        _count(sddmm, plan, "launches")
    build.credit(edge_flops(B, E, D))
    return alpha


def _sddmm_bwd_cuda(d_alpha, q, k, topo: Topology, scale):
    B, N, D = q.shape
    E = topo.src.shape[0]
    d_alpha = d_alpha.to(torch.float32).contiguous()
    q, k = q.contiguous(), k.contiguous()
    dq = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    for c0, c1 in batch_chunks(B):
        q_c, k_c = q[c0:c1], k[c0:c1]
        plan = graph_plan(c1 - c0, N, E, D, "sddmm_bwd", _align(q_c.data_ptr(), k_c.data_ptr()))
        err = _lib().rd_sddmm_bwd(
            d_alpha[c0:c1].data_ptr(), q_c.data_ptr(), k_c.data_ptr(), topo.table,
            dq[c0:c1].data_ptr(), dk[c0:c1].data_ptr(), c1 - c0, N, E, D, float(scale),
            plan.address, _stream(q))
        build.check(err, "sddmm backward")
        _count(sddmm, plan, "bwd_launches")
    build.credit(2 * edge_flops(B, E, D))
    return dq, dk


# ------------------------------------------------------------- autograd
class _SpmmSegmentSoftmax(torch.autograd.Function):
    """spmm_segment_softmax with its hand-written backward."""

    @staticmethod
    def forward(ctx, x, gamma, edge_src, edge_dst, n_nodes, gather_target):
        if x.is_cuda:
            topo = topology(edge_src, edge_dst, n_nodes)
            out, w = _spmm_fwd_cuda(x, gamma, topo, gather_target)
        else:
            topo = None
            out, w = _spmm_fwd_plain(x.detach(), gamma.detach(), edge_src,
                                     edge_dst, n_nodes, gather_target)
        ctx.save_for_backward(x, w, edge_src, edge_dst)
        ctx.args = (topo, n_nodes, gather_target)
        ctx.set_materialize_grads(False)
        return out, w

    @staticmethod
    def backward(ctx, g_out, g_w):
        x, w, edge_src, edge_dst = ctx.saved_tensors
        topo, n_nodes, gather_target = ctx.args
        need_dx, need_dgamma = ctx.needs_input_grad[:2]
        if g_out is None:
            g_out = torch.zeros_like(x)
        if x.is_cuda:
            dx, dgamma = _spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target,
                                        need_dgamma)
        else:
            dx, dgamma = _spmm_bwd_plain(g_out, g_w, x, w, edge_src, edge_dst,
                                         n_nodes, gather_target, need_dgamma)
        return (dx if need_dx else None), dgamma, None, None, None, None


class _Sddmm(torch.autograd.Function):
    """sddmm with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, edge_src, edge_dst, scale):
        if q.is_cuda:
            topo = topology(edge_src, edge_dst, q.shape[1])
            alpha = _sddmm_fwd_cuda(q, k, topo, scale)
        else:
            topo = None
            alpha = _sddmm_fwd_plain(q.detach(), k.detach(), edge_src, edge_dst,
                                     scale)
        ctx.save_for_backward(q, k, edge_src, edge_dst)
        ctx.args = (topo, scale)
        return alpha

    @staticmethod
    def backward(ctx, d_alpha):
        q, k, edge_src, edge_dst = ctx.saved_tensors
        topo, scale = ctx.args
        if q.is_cuda:
            dq, dk = _sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
        else:
            dq, dk = _sddmm_bwd_plain(d_alpha, q, k, edge_src, edge_dst, scale)
        return dq, dk, None, None, None


def spmm_segment_softmax(x: torch.Tensor, gamma: torch.Tensor,
                         edge_src: torch.Tensor, edge_dst: torch.Tensor, *,
                         n_nodes: int, gather_target: bool = False):
    """x [B, N, D] node features, gamma [B, E] pre-softmax edge logits (a
    row broadcast over the batch may be a stride-0 expand), edge_src and
    edge_dst [E] integer -> (out [B, N, D], weights [B, E] post-softmax,
    in the caller's edge order). A node without incoming edges gives a
    zero row. Differentiable in x and gamma, through both outputs."""
    _check_edges(edge_src, edge_dst)
    _check_nodes("x", x, edge_src, n_nodes)
    if gamma.shape != (x.shape[0], edge_src.shape[0]) or gamma.device != x.device:
        raise ValueError(f"gamma must be [B, E] = {(x.shape[0], edge_src.shape[0])} "
                         f"on {x.device}, got {tuple(gamma.shape)} on {gamma.device}")
    if x.is_cuda and gamma.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, gamma is {gamma.dtype}")
    return _SpmmSegmentSoftmax.apply(x, gamma, edge_src, edge_dst, int(n_nodes),
                                     bool(gather_target))


def sddmm(q: torch.Tensor, k: torch.Tensor, edge_src: torch.Tensor,
          edge_dst: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Per-edge scaled dot products alpha[b, e] = scale * q[b, dst_e] .
    k[b, src_e]: q (target side) and k (source side) [B, N, D] -> [B, E].
    Differentiable in q and k."""
    _check_edges(edge_src, edge_dst)
    _check_nodes("q", q, edge_src)
    if k.shape != q.shape or k.device != q.device or k.dtype != q.dtype:
        raise ValueError("q and k must agree in shape, device and dtype")
    return _Sddmm.apply(q, k, edge_src, edge_dst, float(scale))


# forward launches; `bwd_launches` counts the backward's; <route>_launches
# and <route>_bwd_launches count those on each route of the launch plan
for _fn in (spmm_segment_softmax, sddmm):
    for _attr in ("launches", "bwd_launches"):
        setattr(_fn, _attr, 0)
        for _route in ROUTES:
            setattr(_fn, f"{_route}_{_attr}", 0)
del _fn, _attr, _route
