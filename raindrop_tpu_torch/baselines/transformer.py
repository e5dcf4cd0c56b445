"""'Standard Transformer' baseline, TransformerModel2 (port of
raindrop_tpu/baselines/transformer.py).

Reference code/baselines/models.py:127-216: a value linear d_inp -> d_inp,
the time PE (d_pe wide) concatenated in front, the temporal encoder
(d_pe + d_inp wide: at P12 d=52, hd 26 over 2 heads; at eICU d=30, hd
15), masked mean (or max) pooling with the (lengths + 1) denominator, the
optional static embedding concatenated, a 2-layer MLP head. On the card
the encoder's ladder runs the packed flash kernels at T >= 128 (P12,
eICU). At PAM (d=33, 2 heads) the encoder's init raises, as the JAX
package's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.nn.aggregate import masked_mean_pool, padding_mask
from raindrop_tpu_torch.nn.init import generator_on, tiny_uniform, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.nn.transformer import (
    transformer_encoder_apply, transformer_encoder_init)
from raindrop_tpu_torch.ops.pe import time_positional_encoding
from raindrop_tpu_torch.utils.dropout import ModelSeeds, dropout


def transformer2_init(generator, cfg: RaindropConfig, device="cuda"):
    """Reads cfg's d_inp, d_static, n_classes, static, nhead, nlayers,
    ffn_dim, d_pe and init_range. `generator`: a torch.Generator on
    `device`, an int seed, or None with device="meta"."""
    gen = generator_on(generator, device)
    d_enc = cfg.d_inp
    d_model = cfg.d_pe + d_enc
    d_fi = d_enc + cfg.d_pe + (cfg.d_inp if cfg.static else 0)
    params = {
        "encoder": {
            "w": tiny_uniform(gen, (d_enc, cfg.d_inp), cfg.init_range, device),
            "b": torch_linear_params(gen, cfg.d_inp, d_enc, device)["b"],
        },
        "transformer_encoder": transformer_encoder_init(
            gen, d_model, cfg.nhead, cfg.ffn_dim, cfg.nlayers, device),
        "mlp": mlp_init(gen, [d_fi, d_fi, cfg.n_classes], device),
    }
    if cfg.static:
        params["emb"] = {
            "w": tiny_uniform(gen, (cfg.d_inp, cfg.d_static), cfg.init_range, device),
            "b": torch_linear_params(gen, cfg.d_static, cfg.d_inp, device)["b"],
        }
    return params


def transformer2_apply(
    params, cfg: RaindropConfig,
    src: torch.Tensor,                  # [T, B, 2F]
    static: Optional[torch.Tensor],
    times: torch.Tensor,                # [T, B]
    lengths: torch.Tensor,              # [B]
    *, train: bool = False, seeds: Optional[ModelSeeds] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (reference code/baselines/models.py:183-216) -> (logits, 0).
    `seeds` (train): `embed` and one LayerSeeds per encoder layer."""
    T = src.shape[0]
    drop = train and seeds is not None
    h = linear_apply(params["encoder"], src[:, :, :cfg.d_inp])   # the values half
    pe = time_positional_encoding(times, cfg.d_pe, cfg.max_len)
    h = torch.cat([pe, h], dim=2)                       # PE first (models.py:190)
    if drop:
        h = dropout(seeds.embed, h, cfg.dropout)
    mask = padding_mask(lengths, T)
    r_out = transformer_encoder_apply(
        params["transformer_encoder"], h.transpose(0, 1), mask, cfg.nhead,
        cfg.dropout, train, cfg.attention_backend,
        seeds=seeds.layers if drop else None)
    if cfg.aggreg == "mean":
        pooled = masked_mean_pool(r_out, lengths)
    else:  # 'max' (models.py:210): padded steps scaled by -10
        keep = (~mask).to(r_out.dtype)[:, :, None]
        pooled = (r_out * (keep + (1 - keep) * -10.0)).amax(dim=1)
    if cfg.static and static is not None:
        pooled = torch.cat([pooled, linear_apply(params["emb"], static)], dim=1)
    logits = mlp_apply(params["mlp"], pooled)
    return logits, logits.new_zeros(())
