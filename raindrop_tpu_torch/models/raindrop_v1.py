"""Raindrop v1, the variant with TransformerConv graph attention (port of
raindrop_tpu/models/raindrop_v1.py; reference code/models_rd.py:46-191).

The linear encoder times sqrt(d_model) (:130), dropout, a TransformerConv
over the global adjacency with self-loops forced (:149-166), the alpha
distance from the attention columns (:168-169), the time PE (d_inp wide)
concatenated (:171), the temporal encoder (d_model + d_inp wide: at P12
d=180, hd 90; at eICU d=70, hd 35; the packed flash kernels on the card),
the masked mean over time over (lengths + 1) (:181-185), the static
embedding concatenated, the MLP head.

Kept as the JAX function has them:
  * the node rows are the T time steps while the edges address only the
    first d_inp rows (models_rd.py:159-161): rows d_inp..T-1 get the root
    connection alone;
  * the edge weights replace the attention, so alpha is the softmax of the
    weights over each target's incoming edges, the same for every sample.
The JAX package maps the convolution over the samples; here it is one
call with the samples on a batch axis of the node features (nodes on axis
0, graph/transformer_conv.py), which is the same sum for each. At PAM
(d_static 0) the static embedding's init divides by zero, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.graph.structure import edges_from_adjacency
from raindrop_tpu_torch.graph.transformer_conv import (
    ConvSpec, transformer_conv_apply, transformer_conv_init)
from raindrop_tpu_torch.nn.aggregate import masked_mean_pool, padding_mask
from raindrop_tpu_torch.nn.init import generator_on, tiny_uniform, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.nn.transformer import (
    transformer_encoder_apply, transformer_encoder_init)
from raindrop_tpu_torch.ops.pe import time_positional_encoding
from raindrop_tpu_torch.utils.dropout import ModelSeeds, dropout


def conv_spec(cfg: RaindropConfig) -> ConvSpec:
    """d_pe = d_enc = d_inp (models_rd.py:70-71); the convolution maps
    d_inp -> d_inp * dim, dim = d_model // d_inp (:93-95), one head."""
    F = cfg.d_inp
    return ConvSpec(F, F * (cfg.d_model // F), heads=1)


def raindrop_v1_init(generator, cfg: RaindropConfig, device="cuda"):
    """d_final = d_inp * (dim + 1) + d_model (:97)."""
    gen = generator_on(generator, device)
    F = cfg.d_inp
    dim = cfg.d_model // F
    d_final = F * (dim + 1) + cfg.d_model
    return {
        "encoder": {
            "w": tiny_uniform(gen, (F, F), cfg.init_range, device),
            "b": torch_linear_params(gen, F, F, device)["b"],
        },
        "emb": {
            "w": tiny_uniform(gen, (cfg.d_model, cfg.d_static), cfg.init_range, device),
            "b": torch_linear_params(gen, cfg.d_static, cfg.d_model, device)["b"],
        },
        "transconv": transformer_conv_init(gen, conv_spec(cfg), device),
        "transformer_encoder": transformer_encoder_init(
            gen, cfg.d_model + F, cfg.nhead, cfg.ffn_dim, cfg.nlayers, device),
        "mlp_static": mlp_init(gen, [d_final, d_final, cfg.n_classes], device),
    }


def raindrop_v1_apply(
    params, cfg: RaindropConfig,
    src: torch.Tensor,                  # [T, B, 2F]
    static: torch.Tensor,               # [B, d_static]
    times: torch.Tensor,                # [T, B]
    lengths: torch.Tensor,              # [B]
    *,
    train: bool = False, seeds: Optional[ModelSeeds] = None,
    global_adj: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits, the alpha distance). `global_adj`: a host (numpy) [F, F]
    adjacency, default all ones; its edges are built on the host. `seeds`
    (train): `embed` and one LayerSeeds per encoder layer (the convolution
    drops nothing: its rate is 0, as in JAX)."""
    T = src.shape[0]
    F = cfg.d_inp
    if T < F:
        raise ValueError(f"raindrop_v1 needs max_len >= d_inp ({T} < {F}): its "
                         f"edges address the first d_inp of the T node rows")
    drop = train and seeds is not None
    h = linear_apply(params["encoder"], src[:, :, :F]) * math.sqrt(cfg.d_model)
    pe = time_positional_encoding(times, F, cfg.max_len)        # d_pe = F (:70)
    if drop:
        h = dropout(seeds.embed, h, cfg.dropout)
    emb = linear_apply(params["emb"], static)

    # the global structure with self-loops forced (models_rd.py:149-151)
    adj = (np.ones((F, F), np.float32) if global_adj is None
           else np.asarray(global_adj))
    edge_index, edge_weights = edges_from_adjacency(adj)
    # h [T, B, F]: node rows = time steps, the samples on the batch axis;
    # the edges address rows < F
    conv_out, (_, alpha) = transformer_conv_apply(
        params["transconv"], conv_spec(cfg), h,
        torch.from_numpy(edge_index).to(src.device),
        torch.from_numpy(edge_weights).to(src.device), n_nodes=T)
    a = alpha[..., 0].transpose(0, 1)                   # [B, E], head 0
    d2 = ((a[:, None] - a[None]) ** 2).sum(dim=-1)
    distance = torch.sqrt(torch.clamp(d2, min=0.0)).mean()

    output = torch.cat([conv_out, pe], dim=-1).transpose(0, 1)  # [B, T, F*dim + F]
    mask = padding_mask(lengths, T)
    r_out = transformer_encoder_apply(
        params["transformer_encoder"], output, mask, cfg.nhead, cfg.dropout,
        train, cfg.attention_backend, seeds=seeds.layers if drop else None)
    pooled = torch.cat([masked_mean_pool(r_out, lengths), emb], dim=1)
    return mlp_apply(params["mlp_static"], pooled), distance
