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
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.ops.segment import segment_max, segment_softmax, segment_sum

MAX_BATCH = 65535       # the kernels put the sample on the grid's y axis


@dataclass(frozen=True)
class Topology:
    """One edge list prepared for the kernels, all int32 on the edges'
    device: `src`, `dst` [E] as given; `dst_perm` [E] the edge ids in
    stable order of dst with `dst_ptr` [N+1] the segment bounds in it; the
    same by src."""
    n_nodes: int
    src: torch.Tensor
    dst: torch.Tensor
    dst_perm: torch.Tensor
    dst_ptr: torch.Tensor
    src_perm: torch.Tensor
    src_ptr: torch.Tensor


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
    return Topology(n_nodes, edge_src.to(torch.int32).contiguous(),
                    edge_dst.to(torch.int32).contiguous(),
                    dst_perm, dst_ptr, src_perm, src_ptr)


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
    if x.is_cuda and x.shape[0] > MAX_BATCH:
        raise ValueError(f"the kernels take at most {MAX_BATCH} samples a call")


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


# ----------------------------------------------------------------- CUDA
def _lib():
    lib = build.load("sparse_graph")
    if lib.rd_spmm_fwd.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.rd_spmm_fwd.argtypes = [p, p, ll, p, p, p, p, p, i, i, i, i, p]
        lib.rd_spmm_bwd.argtypes = [p] * 12 + [i] * 4 + [p]
        lib.rd_sddmm_fwd.argtypes = [p] * 5 + [i] * 4 + [f, p]
        lib.rd_sddmm_bwd.argtypes = [p] * 11 + [i] * 4 + [f, p]
        for fn in (lib.rd_spmm_fwd, lib.rd_spmm_bwd, lib.rd_sddmm_fwd,
                   lib.rd_sddmm_bwd):
            fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _spmm_fwd_cuda(x, gamma, topo: Topology, gather_target):
    B, N, D = x.shape
    E = topo.src.shape[0]
    x = x.detach().contiguous()
    gamma = gamma.detach()
    # one row of logits broadcast over the batch (a stride-0 expand) is
    # read in place; anything else is made [B, E] contiguous
    if gamma.stride(0) == 0 and (E == 1 or gamma.stride(1) == 1):
        g_stride = 0
    else:
        gamma = gamma.contiguous()
        g_stride = E
    out = torch.empty((B, N, D), dtype=torch.float32, device=x.device)
    w = torch.empty((B, E), dtype=torch.float32, device=x.device)
    gidx = topo.dst if gather_target else topo.src
    err = _lib().rd_spmm_fwd(
        x.data_ptr(), gamma.data_ptr(), g_stride, gidx.data_ptr(),
        topo.dst_perm.data_ptr(), topo.dst_ptr.data_ptr(), out.data_ptr(),
        w.data_ptr(), B, N, E, D, _stream(x))
    build.check(err, "spmm_segment_softmax forward")
    build.count_launch(spmm_segment_softmax)
    return out, w


def _spmm_bwd_cuda(g_out, g_w, x, w, topo: Topology, gather_target,
                   need_dgamma=True):
    B, N, D = x.shape
    E = topo.src.shape[0]
    g_out = g_out.detach().to(torch.float32).contiguous()
    if g_w is not None:
        g_w = g_w.detach().to(torch.float32).contiguous()
    x, w = x.detach().contiguous(), w.detach().contiguous()
    dx = torch.empty((B, N, D), dtype=torch.float32, device=x.device)
    dgamma = (torch.empty((B, E), dtype=torch.float32, device=x.device)
              if need_dgamma else None)
    if gather_target:
        gidx, idx_perm, idx_ptr = topo.dst, topo.dst_perm, topo.dst_ptr
    else:
        gidx, idx_perm, idx_ptr = topo.src, topo.src_perm, topo.src_ptr
    err = _lib().rd_spmm_bwd(
        g_out.data_ptr(), None if g_w is None else g_w.data_ptr(), x.data_ptr(),
        w.data_ptr(), gidx.data_ptr(), topo.dst.data_ptr(),
        topo.dst_perm.data_ptr(), topo.dst_ptr.data_ptr(), idx_perm.data_ptr(),
        idx_ptr.data_ptr(), dx.data_ptr(),
        None if dgamma is None else dgamma.data_ptr(), B, N, E, D, _stream(x))
    build.check(err, "spmm_segment_softmax backward")
    build.count_launch(spmm_segment_softmax, "bwd_launches")
    return dx, dgamma


def _sddmm_fwd_cuda(q, k, topo: Topology, scale):
    B, N, D = q.shape
    E = topo.src.shape[0]
    q, k = q.detach().contiguous(), k.detach().contiguous()
    alpha = torch.empty((B, E), dtype=torch.float32, device=q.device)
    err = _lib().rd_sddmm_fwd(
        q.data_ptr(), k.data_ptr(), topo.src.data_ptr(), topo.dst.data_ptr(),
        alpha.data_ptr(), B, N, E, D, float(scale), _stream(q))
    build.check(err, "sddmm forward")
    build.count_launch(sddmm)
    return alpha


def _sddmm_bwd_cuda(d_alpha, q, k, topo: Topology, scale):
    B, N, D = q.shape
    E = topo.src.shape[0]
    d_alpha = d_alpha.detach().to(torch.float32).contiguous()
    q, k = q.detach().contiguous(), k.detach().contiguous()
    dq = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, N, D), dtype=torch.float32, device=q.device)
    err = _lib().rd_sddmm_bwd(
        d_alpha.data_ptr(), q.data_ptr(), k.data_ptr(), topo.src.data_ptr(),
        topo.dst.data_ptr(), topo.dst_perm.data_ptr(), topo.dst_ptr.data_ptr(),
        topo.src_perm.data_ptr(), topo.src_ptr.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), B, N, E, D, float(scale), _stream(q))
    build.check(err, "sddmm backward")
    build.count_launch(sddmm, "bwd_launches")
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


# forward launches; `bwd_launches` counts the backward's
spmm_segment_softmax.launches = 0
spmm_segment_softmax.bwd_launches = 0
sddmm.launches = 0
sddmm.bwd_launches = 0
