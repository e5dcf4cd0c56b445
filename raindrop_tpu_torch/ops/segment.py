"""Segment ops over an edge axis (port of raindrop_tpu/ops/segment.py).

`data` is [E] or [E, ...]: axis 0 runs over edges, `segment_ids` [E] names
each edge's segment (its destination node) in any order, and the result
has `num_segments` rows. These are the plain-PyTorch counterparts of
torch_scatter.scatter and torch_geometric.utils.softmax (reference
code/Ob_propagation.py:195,227). They carry the COO propagation path and
are the reference the CUDA kernels of ops/sparse.py are held against.

Every result is the same on a repeat, on the card too. `index_add_` adds
with float atomics on CUDA, in an order that changes from run to run, so
there the sum is a product with the segments' one-hot matrix [N, E]
instead (a matrix product has a fixed summation order); on the CPU
`index_add_` adds in edge order. The maximum does not depend on the order,
so it is a `scatter_reduce` on both.
"""

from __future__ import annotations

import torch


def _ids(segment_ids: torch.Tensor) -> torch.Tensor:
    return segment_ids.to(torch.int64)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[n] = sum of data[e] over the edges with segment_ids[e] == n;
    a segment without edges gives zeros."""
    ids = _ids(segment_ids)
    if data.is_cuda:
        return _segment_sum_onehot(data, ids, num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)


def _segment_sum_onehot(data, ids, num_segments):
    E = data.shape[0]
    onehot = torch.zeros((num_segments, E), dtype=data.dtype, device=data.device)
    onehot[ids, torch.arange(E, device=data.device)] = 1.0
    return (onehot @ data.reshape(E, -1)).reshape(
        (num_segments,) + tuple(data.shape[1:]))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[n] = max of data[e] over the segment; -inf for an empty one."""
    ids = _ids(segment_ids).reshape((-1,) + (1,) * (data.dim() - 1))
    out = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, ids.expand_as(data), data, "amax",
                              include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over the edges of each segment, independently per trailing
    element: per-segment max subtraction, exp, per-segment normalisation.
    A zero denominator divides by 1.

    The maximum is a constant shift (its gradient cancels exactly), so it
    is taken outside the autograd graph.
    """
    ids = _ids(segment_ids)
    maxes = segment_max(logits.detach(), ids, num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))
    ex = torch.exp(logits - maxes[ids])
    denom = segment_sum(ex, ids, num_segments)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return ex / denom[ids]


def _flat_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[B, E] per-sample ids -> [B*E] ids into B*num_segments segments."""
    B = segment_ids.shape[0]
    offsets = num_segments * torch.arange(B, device=segment_ids.device)[:, None]
    return (_ids(segment_ids) + offsets).reshape(-1)


def segment_sum_rows(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """`segment_sum` of each sample over its own edge list: data [B, E, ...],
    segment_ids [B, E] -> [B, num_segments, ...]. On the card a batched
    product with each sample's one-hot matrix [N, E] (fixed order, and B
    times smaller than the one-hot of the flattened batch)."""
    B, E = segment_ids.shape
    rest = tuple(data.shape[2:])
    if data.is_cuda:
        onehot = torch.zeros((B, num_segments, E), dtype=data.dtype,
                             device=data.device)
        onehot.scatter_(1, _ids(segment_ids)[:, None, :], 1.0)
        return (onehot @ data.reshape(B, E, -1)).reshape((B, num_segments) + rest)
    out = segment_sum(data.reshape((B * E,) + rest),
                      _flat_ids(segment_ids, num_segments), B * num_segments)
    return out.reshape((B, num_segments) + rest)


def segment_softmax_rows(logits: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """`segment_softmax` of each sample over its own edge list: logits
    [B, E, ...], segment_ids [B, E] -> [B, E, ...]."""
    B, E = segment_ids.shape
    rest = tuple(logits.shape[2:])
    flat = _flat_ids(segment_ids, num_segments)
    maxes = segment_max(logits.detach().reshape((B * E,) + rest), flat,
                        B * num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))
    ex = torch.exp(logits - maxes[flat].reshape(logits.shape))
    denom = segment_sum_rows(ex, segment_ids, num_segments)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return ex / denom.reshape((B * num_segments,) + rest)[flat].reshape(logits.shape)


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] along axis 0 (x [N, ...], ids [E] -> [E, ...]). On the card a
    product with the ids' one-hot matrix [E, N]: the same values (a copy
    times 1 plus zeros), and a gradient that adds in a fixed order where
    x[ids]'s backward adds with float atomics (under TF32 matmuls the copy
    would round)."""
    ids = _ids(ids)
    if not x.is_cuda:
        return x[ids]
    N, E = x.shape[0], ids.shape[0]
    onehot = torch.zeros((E, N), dtype=x.dtype, device=x.device)
    onehot[torch.arange(E, device=x.device), ids] = 1.0
    return (onehot @ x.reshape(N, -1)).reshape((E,) + tuple(x.shape[1:]))
