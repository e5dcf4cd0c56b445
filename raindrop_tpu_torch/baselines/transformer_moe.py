"""Mixture-of-experts transformer (port of
raindrop_tpu/baselines/transformer_moe.py): the standard Transformer
baseline's front end and masked-mean pooling, every encoder layer's FFN
the top-1 routed MoE FFN of parallel/expert.py. The summed load-balancing
loss comes back as `aux` (weighted into the loss by
TrainConfig.aux_loss_weight). The attention runs `multihead_self_attention`
with backend "auto", whatever cfg.attention_backend says, as the JAX
function does: on the card the packed flash kernels at T >= 128.

At PAM (d = 33 over 2 heads) the JAX forward fails in a reshape; the port
refuses at init with the reason.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.nn.aggregate import masked_mean_pool, padding_mask
from raindrop_tpu_torch.nn.init import (
    generator_on, tiny_uniform, torch_linear_params, xavier_uniform)
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.nn.transformer import _layer_norm, multihead_self_attention
from raindrop_tpu_torch.ops.pe import time_positional_encoding
from raindrop_tpu_torch.parallel.expert import moe_ffn_apply, moe_ffn_init
from raindrop_tpu_torch.utils.dropout import ModelSeeds, dropout


def _moe_layer_init(gen, d_model: int, ffn_dim: int, n_experts: int, device):
    out_proj = torch_linear_params(gen, d_model, d_model, device)
    out_proj["b"] = torch.zeros((d_model,), device=device)

    def ln():
        return {"scale": torch.ones((d_model,), device=device),
                "bias": torch.zeros((d_model,), device=device)}

    return {
        "in_proj_w": xavier_uniform(gen, (3 * d_model, d_model), device),
        "in_proj_b": torch.zeros((3 * d_model,), device=device),
        "out_proj": out_proj,
        "moe": moe_ffn_init(gen, d_model, ffn_dim, n_experts, device),
        "ln1": ln(),
        "ln2": ln(),
    }


def transformer_moe_init(generator, cfg: RaindropConfig, n_experts: int = 4,
                         device="cuda"):
    gen = generator_on(generator, device)
    d_enc = cfg.d_inp
    d_model = cfg.d_pe + d_enc
    if d_model % cfg.nhead:
        raise ValueError(f"d_model={d_model} not divisible by nhead={cfg.nhead}")
    d_fi = d_enc + cfg.d_pe + (cfg.d_inp if cfg.static else 0)
    params = {
        "encoder": {
            "w": tiny_uniform(gen, (d_enc, cfg.d_inp), cfg.init_range, device),
            "b": torch_linear_params(gen, cfg.d_inp, d_enc, device)["b"],
        },
        "layers": [_moe_layer_init(gen, d_model, cfg.ffn_dim, n_experts, device)
                   for _ in range(cfg.nlayers)],
        "mlp": mlp_init(gen, [d_fi, d_fi, cfg.n_classes], device),
    }
    if cfg.static:
        params["emb"] = {
            "w": tiny_uniform(gen, (cfg.d_inp, cfg.d_static), cfg.init_range, device),
            "b": torch_linear_params(gen, cfg.d_static, cfg.d_inp, device)["b"],
        }
    return params


def transformer_moe_apply(
    params, cfg: RaindropConfig,
    src: torch.Tensor,                  # [T, B, 2F]
    static: Optional[torch.Tensor],
    times: torch.Tensor,                # [T, B]
    lengths: torch.Tensor,              # [B]
    *, train: bool = False, seeds: Optional[ModelSeeds] = None, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits, the summed load-balancing loss). `seeds` (train):
    `embed` and per layer a LayerSeeds whose `kernel` / `attn` drop the
    attention (the JAX layer's first key), `post_attn` and `post_ffn` the
    two residual branches (its second and third)."""
    T = src.shape[0]
    drop = train and seeds is not None
    rate = cfg.dropout if drop else 0.0
    h = linear_apply(params["encoder"], src[:, :, :cfg.d_inp])
    pe = time_positional_encoding(times, cfg.d_pe, cfg.max_len)
    h = torch.cat([pe, h], dim=2)
    if drop:
        h = dropout(seeds.embed, h, rate)
    x = h.transpose(0, 1)                               # [B, T, d]
    mask = padding_mask(lengths, T)
    aux_total = x.new_zeros(())
    for i, lp in enumerate(params["layers"]):
        s = seeds.layers[i] if drop else None
        attn = multihead_self_attention(lp, x, mask, cfg.nhead, cfg.dropout,
                                        train, "auto", seeds=s)
        if rate > 0.0:
            attn = dropout(s.post_attn, attn, rate)
        x = _layer_norm(lp["ln1"], x + attn)
        ffn, aux = moe_ffn_apply(lp["moe"], x, mesh=mesh)
        aux_total = aux_total + aux
        if rate > 0.0:
            ffn = dropout(s.post_ffn, ffn, rate)
        x = _layer_norm(lp["ln2"], x + ffn)
    pooled = masked_mean_pool(x, lengths)
    if cfg.static and static is not None:
        pooled = torch.cat([pooled, linear_apply(params["emb"], static)], dim=1)
    return mlp_apply(params["mlp"], pooled), aux_total
