"""Observation propagation, the Raindrop graph message-passing layer
(port of `raindrop_tpu/graph/propagate.py`).

The reference's quirks are kept: messages carry the TARGET node's features
(x_i, code/Ob_propagation.py:200); `ob_propagate_coo` returns the attention
BEFORE the softmax (:190-193), which becomes the next layer's edge weights;
the softmax groups the edges by target with a per-segment max subtraction.

  * `ob_propagate_coo`: an explicit edge list in any order, over the
    segment ops of ops/segment.py; one sample, a batch that shares the
    topology, or a batch with an edge list per sample; with use_beta the
    time-conditioned edge attention (`_beta_gamma`) and top-50% pruning,
    aggregated by SOURCE (code/Ob_propagation.py:161-185);
  * `raindrop_propagate_beta_dense`: the whole use_beta two-layer block on
    the complete graph as masked dense reductions, equal to two COO layers;
  * `ob_propagate_dense_complete`: the complete-graph layer as dense
    matrix products, the default for the shipped all-ones graph;
  * `ob_propagate_selfattention`: the reference's dormant dot-product
    attention messages, its per-edge scores by gathers or by the SDDMM
    kernel of ops/sparse.py;
  * `ob_propagation_init` (the full parameter set, so checkpoints
    round-trip) and the alpha-distance regularizer.

On a mesh a layer's "lin_value" may be a callable (the model's
column-parallel product, parallel/tensor.column_parallel_linear) and the
dense layers' `rows` = (b0, batch) place their batch-major dropout masks
at the rank's rows of the global batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.nn.init import glorot, torch_linear_params, uniform
from raindrop_tpu_torch.nn.linear import linear_apply
from raindrop_tpu_torch.ops.segment import (
    segment_softmax, segment_softmax_rows, segment_sum, segment_sum_rows)
from raindrop_tpu_torch.ops.sparse import sddmm
from raindrop_tpu_torch.utils.dropout import batch_block, dropout, dropout_rows


def lin_value(params, x: torch.Tensor) -> torch.Tensor:
    """lin_value(x): the layer's linear, or the callable the model hands in
    for it on a model axis."""
    f = params["lin_value"]
    return f(x) if callable(f) else linear_apply(f, x)


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


def _beta_channels(ob_dim: int, d_pe: int) -> int:
    ch = 8 * ob_dim   # the reference hard-codes 32 with d_ob=4 (code/Ob_propagation.py:165)
    if ch != 16 + d_pe:
        raise ValueError(f"use_beta requires 8*ob_dim == 16 + d_pe (got "
                         f"ob_dim={ob_dim}, d_pe={d_pe})")
    return ch


def _beta(params, rows, p_t, ch, nodes=None):
    """beta[..., r, t] = mean_c(increase_dim(rows)[r, t, c] *
    [map_w[nodes_r] || p_t[t]][c]) for rows [..., R, T*ob_dim] of the nodes
    `nodes` [..., R] (None: row r is node r, map_w read in place, so its
    gradient is a plain sum), p_t [..., T, d_pe]: the two halves of the
    channel sum as products, so no [R, T, ch] operand is built."""
    n_step = p_t.shape[-2]
    h_w = linear_apply(params["increase_dim"], rows)
    h_w = h_w.reshape(h_w.shape[:-1] + (n_step, ch))          # [..., R, T, ch]
    if nodes is None:
        node_part = torch.einsum("...rtc,rc->...rt", h_w[..., :16],
                                 params["map_weights"])
    else:
        node_part = torch.einsum("...rtc,...rc->...rt", h_w[..., :16],
                                 params["map_weights"][nodes])
    return (node_part + torch.einsum("...rtc,...tc->...rt", h_w[..., 16:], p_t)) / ch


def _repeat_last(x, n):
    """repeat_interleave(x, n, dim=-1) as a broadcast: its gradient is a sum
    over the copies (no index_add, whose float atomics on the card add in
    no fixed order)."""
    return x[..., None].expand(x.shape + (n,)).reshape(x.shape[:-1] + (-1,))


def _beta_gamma(params, x_tgt, p_t, edge_weights, tgt, ob_dim):
    """Time-conditioned edge attention (use_beta, reference
    code/Ob_propagation.py:161-176), for one sample or batched over a
    leading axis: x_tgt [..., E, D] the targets' features, p_t
    [..., T, d_pe], edge_weights and tgt [..., E]. Returns gamma
    [..., E, T*ob_dim] = repeat_interleave(beta[e] * w_e, ob_dim)."""
    ch = _beta_channels(ob_dim, p_t.shape[-1])
    beta = _beta(params, x_tgt, p_t, ch, tgt)                  # [..., E, T]
    return _repeat_last(beta * edge_weights[..., None], ob_dim)


def _gather_rows(x, index):
    """x [B, n, D], index [B, E] -> x[b, index[b, e]] [B, E, D]."""
    return torch.gather(x, 1, index[..., None].expand(-1, -1, x.shape[-1]))


def ob_propagate_coo(
    params,
    x: torch.Tensor,              # [n_nodes, D] or [B, n_nodes, D], D = T * ob_dim
    p_t: Optional[torch.Tensor],  # [T, d_pe] ([B, T, d_pe] batched); use_beta reads it
    edge_index: torch.Tensor,     # [2, E] int (row 0 = source, row 1 = target), or [B, 2, E]
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

    Returns (out, (edge_index', alpha)) with out shaped like x. Without
    use_beta alpha is the PRE-softmax attention [E, 1] (== edge_weights;
    [B, E, 1] batched) and edge_index' the edge list given. With use_beta
    the layer keeps the K = E//2 edges of highest mean gamma (a stable
    argsort, ties to the lower edge position, as `jnp.argsort`), softmaxes
    and sums them by SOURCE, and returns their edge list [2, K] ([B, 2, K]:
    each sample keeps its own edges) and their mean gamma [K] ([B, K]).

    Where the JAX package maps this function over the samples, the port
    takes the batch in one call: over one shared edge list [2, E], or one
    per sample [B, 2, E] (the layer after a pruning one). `seed` is the
    uint32 seed of the softmax-weight dropout on g; batched, a sequence of
    B seeds, one per sample (utils/dropout.dropout_rows).

    decompose=True switches the message transform to the reference's
    dormant nodewise-decomposition branch (code/Ob_propagation.py:198-206):
    message = x_i @ outer(nw[src], nw[tgt]) = (x_i . nw[src]) * nw[tgt].
    """
    batched = x.dim() == 3
    xb = x if batched else x[None]
    B = xb.shape[0]
    if n_nodes is None:
        n_nodes = xb.shape[1]
    if edge_weights.dim() == 1:
        edge_weights = edge_weights[None].expand(B, -1)
    if use_beta or edge_index.dim() == 3:
        seeds = None if seed is None else (seed if batched else [seed])
        out, ei, alpha = _coo_rows(params, xb, p_t, edge_index, edge_weights,
                                   use_beta, ob_dim, n_nodes, dropout_rate,
                                   seeds, train, decompose)
        if not batched:
            out, ei, alpha = out[0], ei[0], alpha[0]
        return out, (ei, alpha)
    src, tgt = edge_index[0].to(torch.int64), edge_index[1].to(torch.int64)
    x_tgt = xb[:, tgt]                      # x_i, the target's features
    gamma = edge_weights[..., None]         # [B, E, 1]
    g = segment_softmax(gamma.transpose(0, 1), tgt, n_nodes).transpose(0, 1)
    if seed is not None:
        g = dropout_rows(seed if batched else [seed], g, dropout_rate, train)
    msg = _message(params, x_tgt, src, tgt, decompose) * g   # [B, E, D] * [B, E, 1]
    out = segment_sum(msg.transpose(0, 1), tgt, n_nodes).transpose(0, 1)
    if not batched:
        out, gamma = out[0], gamma[0]
    return out, (edge_index, gamma)


def _message(params, x_tgt, src, tgt, decompose):
    if decompose:
        nw = params["nodewise_weights"]
        return (x_tgt * nw[src]).sum(-1, keepdim=True) * nw[tgt]
    return torch.relu(lin_value(params, x_tgt))


def _coo_rows(params, xb, p_t, edge_index, edge_weights, use_beta, ob_dim,
              n_nodes, dropout_rate, seeds, train, decompose):
    """`ob_propagate_coo` on a batch whose samples may each have their own
    edge list (after pruning they do): the segment ops take per-sample
    segment ids. Returns (out [B, n, D], edge_index' [B, 2, E'], alpha)."""
    B = xb.shape[0]
    if edge_index.dim() == 2:
        edge_index = edge_index[None].expand(B, -1, -1)
    src, tgt = edge_index[:, 0].to(torch.int64), edge_index[:, 1].to(torch.int64)
    if use_beta:
        if p_t is None:
            raise ValueError("use_beta needs the time encoding p_t")
        p_b = p_t if p_t.dim() == 3 else p_t[None].expand(B, -1, -1)
        ch = _beta_channels(ob_dim, p_b.shape[-1])
        # beta depends on the target alone: one row per node, gathered to
        # the edges, so the edges of one target tie exactly on a uniform
        # graph, as they do in the reference
        beta = _beta(params, xb, p_b, ch)                        # [B, n, T]
        beta_e = torch.gather(beta, 1, tgt[..., None].expand(-1, -1, beta.shape[-1]))
        gamma = _repeat_last(beta_e * edge_weights[..., None], ob_dim)  # [B, E, D]
        k = gamma.shape[1] // 2
        top = torch.argsort(-gamma.mean(dim=-1), dim=-1, stable=True)[:, :k]
        gamma = torch.gather(gamma, 1, top[..., None].expand(-1, -1, gamma.shape[-1]))
        src, tgt = torch.gather(src, 1, top), torch.gather(tgt, 1, top)
        edge_index = torch.stack([src, tgt], dim=1)
        agg = src                            # the source-index aggregation quirk
        alpha = gamma.mean(dim=-1)           # [B, K]
    else:
        gamma = edge_weights[..., None]      # [B, E, 1]
        agg = tgt
        alpha = gamma
    g = segment_softmax_rows(gamma, agg, n_nodes)
    if seeds is not None:
        g = dropout_rows(seeds, g, dropout_rate, train)
    msg = _message(params, _gather_rows(xb, tgt), src, tgt, decompose) * g
    return segment_sum_rows(msg, agg, n_nodes), edge_index, alpha


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
    msg = lin_value(params, x[src]).reshape(-1, heads, C)
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
    rows=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complete-graph layer (use_beta=False). Messages carry the target's
    own features, so out[b, t] = relu(lin_value(x[b, t])) * sum_s
    softmax_s(w[s, t]).

    uniform=True asserts all-ones weights: the softmax is exactly uniform
    and sums to 1, so out IS relu(lin_value(x)) and the rescale is skipped,
    unless training drops softmax weights (dropout_rate > 0 with a `seed`,
    the uint32 seed of utils/dropout.dropout on g [B, n, n], hashed at rows
    `rows` = (b0, batch) of a global batch when given).
    Returns (out [B, n, D], alpha [B, n*n]) with alpha the pre-softmax
    weights in row-major (source-major) order.
    """
    B = x.shape[0]
    msg = torch.relu(lin_value(params, x))                   # [B, n, D]
    if uniform and not (train and dropout_rate > 0.0):
        n = x.shape[1]
        return msg, torch.ones((B, n * n), dtype=x.dtype, device=x.device)
    if adj_weights.dim() == 2:
        adj_weights = adj_weights[None].expand((B,) + tuple(adj_weights.shape))
    g = torch.softmax(adj_weights, dim=1)                     # over sources
    g = dropout(seed, g, dropout_rate, train, *batch_block(rows, g.shape))
    out = msg * g.sum(dim=1)[..., None]
    return out, adj_weights.reshape(B, -1)


def _masked_softmax(z, mask, dim):
    """Softmax along `dim` over the entries where `mask` holds; a segment
    with none gives all-zero weights (absent edges contribute nothing)."""
    neg = torch.where(mask, z, torch.full_like(z, float("-inf")))
    m = neg.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(z - m), torch.zeros_like(z))
    den = e.sum(dim=dim, keepdim=True)
    return e / torch.where(den == 0.0, torch.ones_like(den), den)


def beta_keep_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[B, E] True on the k edges a stable argsort(-scores)[:k] keeps, from
    one value sort and a tie quota: everything above the k-th score, then
    the ties at it in edge order until k are kept."""
    sorted_desc = -torch.sort(-scores, dim=-1).values
    thr = sorted_desc[:, k - 1:k]
    above = scores > thr
    ties = scores == thr
    quota = k - above.sum(dim=-1, keepdim=True)
    return above | (ties & (torch.cumsum(ties.to(torch.int64), dim=-1) <= quota))


def raindrop_propagate_beta_dense(
    params1,
    params2,
    x: torch.Tensor,              # [B, n_nodes, D], D = T * ob_dim
    pe: torch.Tensor,             # [B, T, d_pe]
    adj: torch.Tensor,            # [n_nodes, n_nodes] edge weights w[s, t]
    *,
    ob_dim: int,
    dropout_rate: float = 0.0,
    seeds=None,
    train: bool = False,
    uniform_adj: bool = False,
    return_mask: bool = False,
    rows=None,
):
    """The whole use_beta two-layer block on the complete graph (layer 1
    with the time-conditioned attention and top-50% pruning, layer 2 over
    the kept edges; reference code/models_rd.py:322-343 with use_beta),
    as masked dense reductions: equal to two `ob_propagate_coo` layers on
    the complete graph's edge list, without a gather or a scatter.

      * beta depends on the target alone: [B, t, T], shared by its edges;
      * pruning keeps E//2 edges of the flat e = s*n + t order by the
        stable argsort's rule (`beta_keep_mask`): under a uniform graph the
        scores of one target collide across its sources, so the tie order
        decides;
      * layer 1 softmaxes by SOURCE, per channel, over the kept targets;
      * layer 2's messages are the target's own features, so it is
        relu(V2(out1[t])) * sum_s of its softmax weights;
      * alpha_all = the kept edges' mean gamma in argsort order = the top
        K scores, descending.

    uniform_adj=True promises an all-ones adj: gamma[b, s, t, d] is then
    independent of s, so layer 1 is one exp over [B, t, D] (a global max
    stabilises it; it cancels in the ratio) and two [B, s, t] x [B, t, D]
    products, and the [B, s, t, D] grid is never built. The grid route
    runs for a general adj and under propagation dropout, whose mask is
    per edge and channel. `seeds`: the uint32 seeds of the two dropout
    sites (layer 1's g1 [B, s, t, D], layer 2's g2 [B, s, t]), or None;
    `rows` = (b0, batch) hashes them at those rows of a global batch.

    Returns (out2 [B, n, D], alpha_all [B, E//2]), and the kept-edge mask
    [B, s, t] after them with return_mask=True.
    """
    B, n, D = x.shape
    ch = _beta_channels(ob_dim, pe.shape[-1])
    K = (n * n) // 2
    s1, s2 = seeds if seeds is not None else (None, None)

    beta = _beta(params1, x, pe, ch)                                # [B, t, T]
    gamma_node = _repeat_last(beta, ob_dim)                         # [B, t, D]

    scores_grid = adj[None] * beta.mean(dim=-1)[:, None, :]         # [B, s, t]
    scores_flat = scores_grid.reshape(B, n * n)
    alpha_all = -torch.sort(-scores_flat, dim=-1).values[:, :K]
    mask = beta_keep_mask(scores_flat, K).reshape(B, n, n)

    v1 = torch.relu(lin_value(params1, x))                          # [B, t, D]
    drop_active = train and dropout_rate > 0.0 and s1 is not None
    if uniform_adj and not drop_active:
        M = gamma_node.detach().amax(dim=1, keepdim=True)           # [B, 1, D]
        e = torch.exp(gamma_node - M)
        maskf = mask.to(x.dtype)
        num = maskf @ (e * v1)
        den = maskf @ e
        out1 = num / torch.where(den == 0.0, torch.ones_like(den), den)
    else:
        gamma_grid = gamma_node[:, None, :, :] * adj[None, :, :, None]  # [B, s, t, D]
        g1 = _masked_softmax(gamma_grid, mask[..., None], dim=2)
        g1 = dropout(s1, g1, dropout_rate, train, *batch_block(rows, g1.shape))
        out1 = torch.einsum("bstd,btd->bsd", g1, v1)

    g2 = _masked_softmax(scores_grid, mask, dim=1)                  # [B, s, t]
    g2 = dropout(s2, g2, dropout_rate, train, *batch_block(rows, g2.shape))
    v2 = torch.relu(lin_value(params2, out1))
    out2 = v2 * g2.sum(dim=1)[..., None]
    if return_mask:
        return out2, alpha_all, mask
    return out2, alpha_all


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
