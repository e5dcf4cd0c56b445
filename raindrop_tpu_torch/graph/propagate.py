"""Observation propagation, the Raindrop graph message-passing layer
(port of `raindrop_tpu/graph/propagate.py`).

The reference's quirks are kept: messages carry the TARGET node's features
(x_i, code/Ob_propagation.py:200); `ob_propagate_coo` returns the attention
BEFORE the softmax (:190-193), which becomes the next layer's edge weights;
the softmax groups the edges by target with a per-segment max subtraction.

  * `ob_propagate_coo`: an explicit edge list in any order, over the
    segment ops of ops/segment.py; one sample or a batch that shares the
    topology;
  * `ob_propagate_dense_complete`: the complete-graph layer as dense
    matrix products, the default for the shipped all-ones graph;
  * `ob_propagate_selfattention`: the reference's dormant dot-product
    attention messages, its per-edge scores by gathers or by the SDDMM
    kernel of ops/sparse.py;
  * `ob_propagation_init` (the full parameter set, so checkpoints
    round-trip) and the alpha-distance regularizer.

The time-conditioned attention with edge pruning (use_beta) comes with the
capability slice and raises NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.nn.init import glorot, torch_linear_params, uniform
from raindrop_tpu_torch.nn.linear import linear_apply
from raindrop_tpu_torch.ops.segment import segment_softmax, segment_sum
from raindrop_tpu_torch.ops.sparse import sddmm
from raindrop_tpu_torch.utils.dropout import dropout, dropout_rows


def ob_propagation_init(gen, in_channels: int, out_channels: int,
                        n_nodes: int, ob_dim: int, heads: int = 1,
                        device="cuda", dtype=torch.float32):
    """Parameters of one propagation layer: the reference constructor's full
    set (code/Ob_propagation.py:40-69), though the shipped forward only
    reads lin_value."""
    ho = heads * out_channels
    bound = 1.0 / math.sqrt(in_channels)
    return {
        "lin_key": torch_linear_params(gen, in_channels, ho, device, dtype),
        "lin_query": torch_linear_params(gen, in_channels, ho, device, dtype),
        "lin_value": torch_linear_params(gen, in_channels, ho, device, dtype),
        "lin_skip": torch_linear_params(gen, in_channels, ho, device, dtype),
        "weight": glorot(gen, (in_channels, ho), device, dtype),
        "bias": uniform(gen, (ho,), -bound, bound, device, dtype),
        "nodewise_weights": glorot(gen, (n_nodes, ho), device, dtype),
        "increase_dim": torch_linear_params(gen, in_channels, ho * 8,
                                            device, dtype),
        "map_weights": glorot(gen, (n_nodes, heads * 16), device, dtype),
    }


def ob_propagate_coo(
    params,
    x: torch.Tensor,              # [n_nodes, D] or [B, n_nodes, D], D = T * ob_dim
    p_t: Optional[torch.Tensor],  # [T, d_pe]; only use_beta reads it
    edge_index: torch.Tensor,     # [2, E] int (row 0 = source, row 1 = target)
    edge_weights: torch.Tensor,   # [E], or [B, E] with a batched x
    *,
    use_beta: bool = False,
    ob_dim: int = 4,
    n_nodes: Optional[int] = None,
    dropout_rate: float = 0.0,
    seed=None,
    train: bool = False,
    decompose: bool = False,
):
    """One propagation step over an explicit edge list.

    Returns (out, (edge_index, alpha)) with out shaped like x and alpha the
    PRE-softmax attention, [E, 1] (== edge_weights; [B, E, 1] batched).
    Where the JAX package maps this function over the samples, the port
    takes the batch in one call: every sample shares the topology. `seed`
    is the uint32 seed of the softmax-weight dropout on g [E, 1]; batched,
    a sequence of B seeds, one per sample (utils/dropout.dropout_rows).

    decompose=True switches the message transform to the reference's
    dormant nodewise-decomposition branch (code/Ob_propagation.py:198-206):
    message = x_i @ outer(nw[src], nw[tgt]) = (x_i . nw[src]) * nw[tgt].
    """
    if use_beta:
        raise NotImplementedError(
            "use_beta (time-conditioned attention, edge pruning) comes with "
            "the capability slice")
    batched = x.dim() == 3
    xb = x if batched else x[None]
    B = xb.shape[0]
    if n_nodes is None:
        n_nodes = xb.shape[1]
    src, tgt = edge_index[0].to(torch.int64), edge_index[1].to(torch.int64)
    if edge_weights.dim() == 1:
        edge_weights = edge_weights[None].expand(B, -1)
    x_tgt = xb[:, tgt]                      # x_i, the target's features
    gamma = edge_weights[..., None]         # [B, E, 1]
    g = segment_softmax(gamma.transpose(0, 1), tgt, n_nodes).transpose(0, 1)
    if seed is not None:
        g = dropout_rows(seed if batched else [seed], g, dropout_rate, train)
    if decompose:
        nw = params["nodewise_weights"]
        msg = (x_tgt * nw[src]).sum(-1, keepdim=True) * nw[tgt]
    else:
        msg = torch.relu(linear_apply(params["lin_value"], x_tgt))
    msg = msg * g                           # [B, E, D] * [B, E, 1]
    out = segment_sum(msg.transpose(0, 1), tgt, n_nodes).transpose(0, 1)
    if not batched:
        out, gamma = out[0], gamma[0]
    return out, (edge_index, gamma)


def ob_propagate_selfattention(
    params,
    x: torch.Tensor,              # [n_nodes, D]
    edge_index: torch.Tensor,     # [2, E]
    edge_weights: Optional[torch.Tensor] = None,  # [E]; overrides Q.K when given
    *,
    heads: int = 1,
    n_nodes: Optional[int] = None,
    dropout_rate: float = 0.0,
    seed=None,
    train: bool = False,
    score_backend: str = "gather",
):
    """The reference's dormant dot-product attention messages
    (`message_selfattention`, code/Ob_propagation.py:134-155): alpha =
    Q(x_i) . K(x_j) / sqrt(C) per head (edge_weights instead, when given),
    a softmax over each node's incoming edges, messages V(x_j) * alpha
    summed by target. Returns (out [n_nodes, heads*C], (edge_index, alpha
    [E, heads] POST-softmax)).

    score_backend: 'gather' (also accepted under the JAX package's name
    'xla') gathers the E rows and projects them; 'sddmm' projects the N
    nodes and takes the per-edge dot products with ops/sparse.sddmm (the
    hand-written CUDA kernel on the card). Same values, another rounding.
    """
    if score_backend not in ("gather", "xla", "sddmm"):
        raise ValueError(f"score_backend must be 'gather', 'xla' or 'sddmm', "
                         f"got {score_backend!r}")
    if n_nodes is None:
        n_nodes = x.shape[0]
    src, dst = edge_index[0].to(torch.int64), edge_index[1].to(torch.int64)
    D = params["lin_query"]["w"].shape[0]
    C = D // heads
    if edge_weights is not None:
        alpha = edge_weights[:, None].expand(-1, heads)
    elif score_backend == "sddmm":
        # the heads on sddmm's batch axis: one call, [heads, E] -> [E, heads]
        qn = linear_apply(params["lin_query"], x).reshape(n_nodes, heads, C)
        kn = linear_apply(params["lin_key"], x).reshape(n_nodes, heads, C)
        alpha = sddmm(qn.permute(1, 0, 2).contiguous(),
                      kn.permute(1, 0, 2).contiguous(), edge_index[0],
                      edge_index[1], scale=1.0 / math.sqrt(C)).transpose(0, 1)
    else:
        q = linear_apply(params["lin_query"], x[dst]).reshape(-1, heads, C)
        k = linear_apply(params["lin_key"], x[src]).reshape(-1, heads, C)
        alpha = (q * k).sum(-1) / math.sqrt(C)                   # [E, H]
    alpha = segment_softmax(alpha, dst, n_nodes)
    a = dropout(seed, alpha, dropout_rate, train)
    msg = linear_apply(params["lin_value"], x[src]).reshape(-1, heads, C)
    msg = msg * a[:, :, None]
    out = segment_sum(msg.reshape(-1, heads * C), dst, n_nodes)
    return out, (edge_index, alpha)


def ob_propagate_dense_complete(
    params,
    x: torch.Tensor,              # [B, n_nodes, D]
    adj_weights: torch.Tensor,    # [n_nodes, n_nodes] w[s, t] or [B, n, n]
    *,
    dropout_rate: float = 0.0,
    seed=None,
    train: bool = False,
    uniform: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complete-graph layer (use_beta=False). Messages carry the target's
    own features, so out[b, t] = relu(lin_value(x[b, t])) * sum_s
    softmax_s(w[s, t]).

    uniform=True asserts all-ones weights: the softmax is exactly uniform
    and sums to 1, so out IS relu(lin_value(x)) and the rescale is skipped,
    unless training drops softmax weights (dropout_rate > 0 with a `seed`,
    the uint32 seed of utils/dropout.dropout on g [B, n, n]).
    Returns (out [B, n, D], alpha [B, n*n]) with alpha the pre-softmax
    weights in row-major (source-major) order.
    """
    B = x.shape[0]
    msg = torch.relu(linear_apply(params["lin_value"], x))   # [B, n, D]
    if uniform and not (train and dropout_rate > 0.0):
        n = x.shape[1]
        return msg, torch.ones((B, n * n), dtype=x.dtype, device=x.device)
    if adj_weights.dim() == 2:
        adj_weights = adj_weights[None].expand((B,) + tuple(adj_weights.shape))
    g = torch.softmax(adj_weights, dim=1)                     # over sources
    g = dropout(seed, g, dropout_rate, train)
    out = msg * g.sum(dim=1)[..., None]
    return out, adj_weights.reshape(B, -1)


def alpha_pairwise_distance(alpha_all: torch.Tensor) -> torch.Tensor:
    """mean_{b,b'} ||alpha[b] - alpha[b']||_2 over the batch, alpha_all [B, E].

    Gram form |a|^2 + |b|^2 - 2<a,b> in f32, with a double-where sqrt that
    is exact in the forward and gives subgradient 0 where d2 <= 0.
    """
    a = alpha_all.to(torch.float32)
    sq = (a * a).sum(dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (a @ a.T)
    pos = d2 > 0.0
    d = torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))),
                    torch.zeros_like(d2))
    return d.mean().to(alpha_all.dtype)
