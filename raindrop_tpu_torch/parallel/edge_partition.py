"""Edge-partitioned graph aggregation over the mesh's model axis (port of
raindrop_tpu/parallel/edge_partition.py): the batched graph's edges split
into n contiguous shards, one a model rank; each rank takes the segment
statistics and the partial aggregate of its shard, and collectives over
the model group combine them:

  segment max                        all_reduce MAX (no gradient: the
                                     softmax does not depend on the shift)
  softmax denominator                all_reduce SUM (`psum`: each rank
                                     uses the sum for its own edges)
  weighted aggregate                 all_reduce SUM (`reduce_from`: every
                                     rank uses the whole)

Node features are whole on every model rank and enter through `copy_to`,
so their gradient, which each rank computes from its edges only, is
summed over the model axis; every parameter upstream then gets the
one-device gradient on every rank, and no leaf is left partial. The math
is ops/segment.segment_softmax and segment_sum's; the data axis splits the
batch as everywhere (each rank's rows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.ops.segment import gather_rows, segment_max, segment_sum
from raindrop_tpu_torch.parallel import tensor as tp
from raindrop_tpu_torch.parallel.mesh import Shard


def _local_agg(x, gamma, src, dst, n_nodes: int, gather_target: bool, group):
    """This rank's edge shard (src, dst [E_loc], gamma [B, E_loc]) over the
    nodes x [B, N, D] -> (out [B, N, D], w [B, E_loc])."""
    idx = dst if gather_target else src
    g = gamma.transpose(0, 1)                       # [E_loc, B]: edges on axis 0
    # 1) the global per-destination max (stability)
    loc_max = segment_max(g.detach(), dst, n_nodes)             # [N, B]
    loc_max = torch.where(torch.isfinite(loc_max), loc_max,
                          torch.full_like(loc_max, float("-inf")))
    glob_max = tp.all_reduce_max(loc_max, group)
    glob_max = torch.where(torch.isfinite(glob_max), glob_max,
                           torch.zeros_like(glob_max))
    # 2) the global denominator
    ex = torch.exp(g - glob_max[dst])
    denom = tp.psum(segment_sum(ex, dst, n_nodes), group)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    # 3) the partial weighted aggregate, summed over the edge shards
    w = ex / denom[dst]                                           # [E_loc, B]
    msgs = gather_rows(x.transpose(0, 1), idx) * w[..., None]    # [E_loc, B, D]
    out = tp.reduce_from(segment_sum(msgs, dst, n_nodes), group)  # [N, B, D]
    return out.transpose(0, 1), w.transpose(0, 1)


def spmm_segment_softmax_sharded(
    x: torch.Tensor,           # [B, N, D] this data rank's rows, whole nodes
    gamma: torch.Tensor,       # [B, E_loc] this rank's edge shard
    edge_src: torch.Tensor,    # [E_loc]
    edge_dst: torch.Tensor,    # [E_loc]
    shard: Optional[Shard] = None,
    *,
    gather_target: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distributed ops/sparse.spmm_segment_softmax: the softmax of
    gamma over each destination's edges (all shards), the messages
    (x at the source, or at the target with gather_target) weighted and
    summed at the destination. Returns (out [B, N, D] whole on every model
    rank, the softmax weights of this rank's edges [B, E_loc])."""
    group = None if shard is None else shard.model_group
    x = tp.copy_to(x, group)
    return _local_agg(x, gamma, edge_src.to(torch.int64), edge_dst.to(torch.int64),
                      x.shape[1], gather_target, group)


def edge_shard(edge_src: torch.Tensor, edge_dst: torch.Tensor, gamma: torch.Tensor,
               shard: Optional[Shard] = None):
    """This model rank's contiguous E / n edges: (src, dst, gamma[:, part]),
    what P('model') gives a rank in the JAX package; ValueError when the
    axis does not divide the edge count."""
    n = 1 if shard is None else shard.n_model
    E = edge_src.shape[0]
    if E % n:
        raise ValueError(f"the mesh 'model' axis size {n} must divide the edge "
                         f"count {E} for edge partitioning")
    if n == 1:
        return edge_src, edge_dst, gamma
    size = E // n
    sl = slice(shard.model_rank * size, (shard.model_rank + 1) * size)
    return edge_src[sl], edge_dst[sl], gamma[:, sl]
