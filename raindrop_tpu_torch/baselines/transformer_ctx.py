"""Context-token Transformer baseline, TransformerModel (port of
raindrop_tpu/baselines/transformer_ctx.py).

Reference code/baselines/models.py:55-124: the value linear scaled by
sqrt(d_model), the time PE added over the full width, the static embedding
prepended as a context token at position 0, the key-padding mask over
T + 1 positions (lengths + 1 valid), the masked mean over the T + 1
outputs divided by (lengths + 1), an MLP head. d_model 64, 2 heads of 32:
on the card the packed flash kernels at T + 1 (216 at P12, 301 at eICU).
It needs static features: at PAM (d_static 0) the init divides by zero, as
the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.nn.init import generator_on, tiny_uniform, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.nn.transformer import (
    transformer_encoder_apply, transformer_encoder_init)
from raindrop_tpu_torch.ops.pe import time_positional_encoding
from raindrop_tpu_torch.utils.dropout import ModelSeeds


def transformer_ctx_init(generator, cfg: RaindropConfig, d_model: int = 64,
                         device="cuda"):
    gen = generator_on(generator, device)
    return {
        "encoder": {
            "w": tiny_uniform(gen, (d_model, cfg.d_inp), cfg.init_range, device),
            "b": torch_linear_params(gen, cfg.d_inp, d_model, device)["b"],
        },
        "emb": torch_linear_params(gen, cfg.d_static, d_model, device),
        "transformer_encoder": transformer_encoder_init(
            gen, d_model, cfg.nhead, cfg.ffn_dim, cfg.nlayers, device),
        "mlp": mlp_init(gen, [d_model, d_model, cfg.n_classes], device),
    }


def transformer_ctx_apply(
    params, cfg: RaindropConfig,
    src: torch.Tensor,                  # [T, B, 2F]
    static: Optional[torch.Tensor],     # [B, d_static]
    times: torch.Tensor,                # [T, B]
    lengths: torch.Tensor,              # [B]
    *, train: bool = False, seeds: Optional[ModelSeeds] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits, 0). `seeds` (train): one LayerSeeds per encoder layer
    (the JAX function hands its key straight to the encoder)."""
    T = src.shape[0]
    d_model = params["encoder"]["w"].shape[0]
    h = linear_apply(params["encoder"], src[:, :, :cfg.d_inp]) * math.sqrt(d_model)
    h = h + time_positional_encoding(times, d_model, cfg.max_len)  # additive (:104)
    emb = linear_apply(params["emb"], static)                      # [B, d_model]
    x = torch.cat([emb[None], h], dim=0)                # context token (:110)
    # T + 1 positions, those at or past length + 1 padded (:112-113)
    mask = (torch.arange(T + 1, device=src.device)[None, :]
            >= (lengths[:, None] + 1))
    r_out = transformer_encoder_apply(
        params["transformer_encoder"], x.transpose(0, 1), mask, cfg.nhead,
        cfg.dropout, train, cfg.attention_backend,
        seeds=seeds.layers if train and seeds is not None else None)
    keep = (~mask).to(r_out.dtype)[:, :, None]
    pooled = (r_out * keep).sum(dim=1) / (lengths[:, None].to(r_out.dtype) + 1.0)
    logits = mlp_apply(params["mlp"], pooled)
    return logits, logits.new_zeros(())
