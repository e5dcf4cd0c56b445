"""Graph transformer convolution, multi-head dot-product graph attention
(port of raindrop_tpu/graph/transformer_conv.py, the reference's modified
PyG TransformerConv, code/transformer_conv.py).

Semantics, as the JAX function's:
  * per-edge attention alpha = (q_i . k_j) / sqrt(C) per head (:199),
    replaced entirely by `edge_weights` when they are given (:200-201);
  * a segment softmax over the edges into each target (:202);
  * messages lin_value(x_j) * alpha, x_j the SOURCE (:207-209);
  * optional edge features added to the keys (:192-196);
  * a root connection, optionally gated by
    sigmoid(lin_beta([out | x_r | out - x_r])) (:168-175);
  * alpha returned after the softmax (:161, :203).

The static settings (heads, channels, concat, beta, root weight, edge
features) are a `ConvSpec`, outside the parameter tree. Nodes lie on axis
0 of x and may carry batch axes after it: x [N, *batch, C] with one edge
list for every batch element, which is how Raindrop v1 runs its samples in
one call (models/raindrop_v1.py). The gathers and sums over edges are the
segment ops of ops/segment.py (one-hot products on the card, so a step
repeats bit for bit). The JAX package has no Pallas kernel here, and the
port none.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply
from raindrop_tpu_torch.ops.segment import gather_rows, segment_softmax, segment_sum
from raindrop_tpu_torch.utils.dropout import dropout


@dataclass(frozen=True)
class ConvSpec:
    """A TransformerConv's static settings (the JAX tree's `_meta`)."""
    in_channels: int
    out_channels: int
    heads: int = 1
    concat: bool = True
    beta: bool = False
    root_weight: bool = True
    edge_dim: Optional[int] = None

    @property
    def gated(self) -> bool:
        """The beta gate runs only with the root connection (:116)."""
        return self.beta and self.root_weight


def transformer_conv_init(gen, spec: ConvSpec, device="cuda"):
    ho = spec.heads * spec.out_channels
    c_in = spec.in_channels
    params = {
        "lin_key": torch_linear_params(gen, c_in, ho, device),
        "lin_query": torch_linear_params(gen, c_in, ho, device),
        "lin_value": torch_linear_params(gen, c_in, ho, device),
        "lin_skip": torch_linear_params(gen, c_in, ho if spec.concat
                                        else spec.out_channels, device),
    }
    if spec.edge_dim is not None:       # bias=False (:108)
        params["lin_edge"] = torch_linear_params(gen, spec.edge_dim, ho, device,
                                                 bias=False)
    if spec.gated:                      # bias=False (:116, :121)
        d = 3 * (ho if spec.concat else spec.out_channels)
        params["lin_beta"] = torch_linear_params(gen, d, 1, device, bias=False)
    return params


def transformer_conv_apply(
    params, spec: ConvSpec,
    x: torch.Tensor,                  # [N, *batch, in_channels]
    edge_index: torch.Tensor,         # [2, E] (row 0 = source, row 1 = target)
    edge_weights: Optional[torch.Tensor] = None,   # [E], overrides attention
    edge_attr: Optional[torch.Tensor] = None,      # [E, *batch, edge_dim]
    *,
    n_nodes: Optional[int] = None,
    dropout_rate: float = 0.0,
    seed=None,
    train: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out [N, *batch, heads * out] (concat) or [N, *batch, out]
    (mean over heads), (edge_index, alpha [E, *batch, heads] after the
    softmax)). With `edge_weights` the queries and keys do not reach the
    output, and are not computed. `seed` drops alpha in training."""
    H, C = spec.heads, spec.out_channels
    if n_nodes is None:
        n_nodes = x.shape[0]
    src, dst = edge_index[0], edge_index[1]
    batch = tuple(x.shape[1:-1])
    E = src.shape[0]

    def per_head(t):
        return t.reshape((E,) + batch + (H, C))

    x_j = gather_rows(x, src)                        # source (key/value side)
    if edge_weights is None:
        q = per_head(linear_apply(params["lin_query"], gather_rows(x, dst)))
        k = per_head(linear_apply(params["lin_key"], x_j))
        if spec.edge_dim is not None:
            if edge_attr is None:
                raise ValueError("edge_dim set but edge_attr missing")
            k = k + per_head(linear_apply(params["lin_edge"], edge_attr))
        alpha = (q * k).sum(dim=-1) / math.sqrt(C)  # [E, *batch, H]
    else:
        w = edge_weights.to(x.dtype).reshape((E,) + (1,) * (len(batch) + 1))
        alpha = w.expand((E,) + batch + (H,))
    alpha = segment_softmax(alpha, dst, n_nodes)
    alpha_out = alpha                                # after the softmax (:203)
    alpha = dropout(seed, alpha, dropout_rate, train)

    msg = per_head(linear_apply(params["lin_value"], x_j)) * alpha[..., None]
    out = segment_sum(msg.reshape((E,) + batch + (H * C,)), dst, n_nodes)
    if not spec.concat:
        out = out.reshape((n_nodes,) + batch + (H, C)).mean(dim=-2)

    if spec.root_weight:
        x_r = linear_apply(params["lin_skip"], x)
        if spec.gated:
            b = torch.sigmoid(linear_apply(
                params["lin_beta"], torch.cat([out, x_r, out - x_r], dim=-1)))
            out = b * x_r + (1 - b) * out
        else:
            out = out + x_r
    return out, (edge_index, alpha_out)
