"""Observation propagation on the shipped complete sensor graph.

Port of the parts of `raindrop_tpu/graph/propagate.py` that the serving
path of the shipped config reaches: the full parameter set
(`ob_propagation_init`, so checkpoints round-trip), the dense
complete-graph layer and the alpha-distance regularizer. The COO, Pallas
and use_beta paths come with later slices.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from raindrop_tpu_torch.nn.init import glorot, torch_linear_params, uniform
from raindrop_tpu_torch.nn.linear import linear_apply


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


def ob_propagate_dense_complete(
    params,
    x: torch.Tensor,              # [B, n_nodes, D]
    adj_weights: torch.Tensor,    # [n_nodes, n_nodes] w[s, t] or [B, n, n]
    *,
    dropout_rate: float = 0.0,
    train: bool = False,
    uniform: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complete-graph layer (use_beta=False). Messages carry the target's
    own features, so out[b, t] = relu(lin_value(x[b, t])) * sum_s
    softmax_s(w[s, t]).

    uniform=True asserts all-ones weights: the softmax is exactly uniform
    and sums to 1, so out IS relu(lin_value(x)) and the rescale is skipped.
    Returns (out [B, n, D], alpha [B, n*n]) with alpha the pre-softmax
    weights in row-major (source-major) order.
    """
    if train and dropout_rate > 0.0:
        raise NotImplementedError(
            "propagation dropout in training comes with the training slice")
    B = x.shape[0]
    msg = torch.relu(linear_apply(params["lin_value"], x))   # [B, n, D]
    if uniform:
        n = x.shape[1]
        return msg, torch.ones((B, n * n), dtype=x.dtype, device=x.device)
    if adj_weights.dim() == 2:
        adj_weights = adj_weights[None].expand((B,) + tuple(adj_weights.shape))
    g = torch.softmax(adj_weights, dim=1)                     # over sources
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
