"""Temporal transformer encoder (port of raindrop_tpu/nn/transformer.py).

Post-LN torch TransformerEncoderLayer semantics, built by hand over a
parameter dict: `torch.nn.TransformerEncoder` gives NaN on samples whose
keys are all padded, where this encoder gives zero attention. Layout
[B, T, d] inside the encoder. In training each layer takes a `LayerSeeds`
(utils/dropout.py): the dense rung drops the attention probabilities
[B, H, T, T] and the three sites of the unfused layer with the counter-hash
dropout, the flash and fused-layer rungs hand their int32 seed to the
kernels. Without seeds, or in eval, the rate is 0. The context-parallel
backends raise.

Encoder ladder. `backend="auto"` on a CUDA tensor keeps the JAX package's
structure and thresholds: the fused-layer kernel when d % nhead == 0,
T >= 384 and T (padded to 8) <= 1024; flash attention at every other
T >= 128; dense below. The flash rung runs the packed-heads kernel while
T (padded to 8) <= 1024 and the split-head `flash_mha` beyond ('flash_mha'
in `encoder_rung`'s words). The thresholds are the JAX package's, measured
on a TPU v5e, not on the H100: the card's own crossover is an open
question (PERF.md). On a CPU tensor `auto` is dense, as the JAX ladder is
off the TPU. An explicit "dense" | "flash" | "fused_layer" works on both
devices (on the CPU the kernels' plain versions run); "fused_layer" beyond
T = 1024 raises, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params, xavier_uniform
from raindrop_tpu_torch.nn.linear import linear_apply
from raindrop_tpu_torch.ops.flash_attention import (
    MAX_FUSED_T, flash_mha, flash_mha_packed)
from raindrop_tpu_torch.ops.fused_encoder import fused_encoder_layer
from raindrop_tpu_torch.utils.dropout import LayerSeeds, dropout

BACKENDS = ("auto", "dense", "flash", "fused_layer")


def _layer_init(gen, d_model: int, ffn_dim: int, device="cuda",
                dtype=torch.float32):
    out_proj = torch_linear_params(gen, d_model, d_model, device, dtype)
    out_proj["b"] = torch.zeros((d_model,), dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones((d_model,), dtype=dtype, device=device),
                "bias": torch.zeros((d_model,), dtype=dtype, device=device)}

    return {
        "in_proj_w": xavier_uniform(gen, (3 * d_model, d_model), device, dtype),
        "in_proj_b": torch.zeros((3 * d_model,), dtype=dtype, device=device),
        "out_proj": out_proj,
        "lin1": torch_linear_params(gen, d_model, ffn_dim, device, dtype),
        "lin2": torch_linear_params(gen, ffn_dim, d_model, device, dtype),
        "ln1": ln(),
        "ln2": ln(),
    }


def transformer_encoder_init(gen, d_model: int, nhead: int, ffn_dim: int,
                             num_layers: int, device="cuda",
                             dtype=torch.float32):
    if d_model % nhead:
        raise ValueError(f"d_model={d_model} not divisible by nhead={nhead}")
    return {f"layer{i}": _layer_init(gen, d_model, ffn_dim, device, dtype)
            for i in range(num_layers)}


def _layer_norm(p, x, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _lengths(key_padding_mask, B, T, device):
    # key_padding_mask marks t >= length (a contiguous suffix), so the
    # kernels take the prefix lengths
    if key_padding_mask is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return (~key_padding_mask).sum(dim=1).to(torch.int32)


def _score_dtype(score_dtype):
    return None if score_dtype in (None, "float32") else str(score_dtype)


def _refuse(backend: str):
    if backend not in BACKENDS:
        if backend in ("sp", "ring"):
            raise NotImplementedError(
                f"the context-parallel backend {backend!r} comes with the "
                f"scale-out slice")
        raise ValueError(f"unknown attention backend {backend!r}")


def _fits(T: int) -> bool:
    return -(-T // 8) * 8 <= MAX_FUSED_T


def _attention_rung(backend: str, T: int, on_cuda: bool) -> str:
    """The attention of an unfused layer: 'flash' (the packed-heads
    kernel), 'flash_mha' (the split-head one, beyond the packed kernel's
    T) or 'dense'."""
    _refuse(backend)
    if backend == "flash" or (backend == "auto" and on_cuda and T >= 128):
        return "flash" if _fits(T) else "flash_mha"
    return "dense"


def encoder_rung(backend: str, T: int, d: int, nhead: int, on_cuda: bool) -> str:
    """The rung of the ladder one layer takes: 'fused_layer', 'flash',
    'flash_mha' or 'dense'."""
    _refuse(backend)
    if d % nhead == 0 and (backend == "fused_layer" or (
            backend == "auto" and on_cuda and T >= 384 and _fits(T))):
        return "fused_layer"
    return _attention_rung(backend, T, on_cuda)


def multihead_self_attention(
    p,
    x: torch.Tensor,                 # [B, T, d]
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    dropout_rate: float = 0.0,
    train: bool = False,
    backend: str = "auto",
    score_dtype: Optional[str] = "bfloat16",
    seeds: Optional[LayerSeeds] = None,
) -> torch.Tensor:
    B, T, d = x.shape
    hd = d // nhead
    rung = _attention_rung(backend, T, x.is_cuda)
    rate = dropout_rate if (train and seeds is not None) else 0.0
    qkv = x @ p["in_proj_w"].T + p["in_proj_b"]           # [B, T, 3d]
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):  # [B, T, d] -> [B, nhead, T, hd], a view
        return t.reshape(B, T, nhead, hd).transpose(1, 2)

    if rung in ("flash", "flash_mha"):
        lengths = _lengths(key_padding_mask, B, T, x.device)
        seed = seeds.kernel if rate > 0.0 else None
        cd = _score_dtype(score_dtype)
        if rung == "flash":
            out = flash_mha_packed(q, k, v, lengths, seed, rate, cd, nhead)
        else:
            # the kernels read the head views in place and write o merged,
            # so neither side of the call copies
            out = flash_mha(heads(q), heads(k), heads(v), lengths, seed, rate,
                            cd).transpose(1, 2).reshape(B, T, d)
        return linear_apply(p["out_proj"], out)

    q, k, v = heads(q) * (hd ** -0.5), heads(k), heads(v)
    logits = q @ k.transpose(-1, -2)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    float("-inf"))
    attn = torch.softmax(logits, dim=-1)
    if key_padding_mask is not None:
        # an all-padded sample softmaxes over all -inf (NaN): give it zeros
        all_pad = key_padding_mask.all(dim=-1)[:, None, None, None]
        attn = torch.where(all_pad, torch.zeros_like(attn), attn)
    if rate > 0.0:
        attn = dropout(seeds.attn, attn, rate)
    out = (attn @ v).transpose(1, 2).reshape(B, T, d)
    return linear_apply(p["out_proj"], out)


def transformer_encoder_layer_apply(
    p,
    x: torch.Tensor,                # [B, T, d]
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    dropout_rate: float = 0.0,
    train: bool = False,
    backend: str = "auto",
    score_dtype: Optional[str] = "bfloat16",
    seeds: Optional[LayerSeeds] = None,
) -> torch.Tensor:
    """One post-LN encoder layer; backend 'fused_layer' (and 'auto' on CUDA
    at T >= 384) runs the whole layer through ops/fused_encoder.py."""
    B, T, d = x.shape
    rate = dropout_rate if (train and seeds is not None) else 0.0
    if encoder_rung(backend, T, d, nhead, x.is_cuda) == "fused_layer":
        return fused_encoder_layer(p, x, _lengths(key_padding_mask, B, T, x.device),
                                   seeds.kernel if rate > 0.0 else None, rate,
                                   _score_dtype(score_dtype), nhead)
    attn = multihead_self_attention(p, x, key_padding_mask, nhead,
                                    dropout_rate, train, backend, score_dtype,
                                    seeds)
    if rate > 0.0:
        attn = dropout(seeds.post_attn, attn, rate)
    x = _layer_norm(p["ln1"], x + attn)
    h = torch.relu(linear_apply(p["lin1"], x))
    if rate > 0.0:
        h = dropout(seeds.ffn, h, rate)
    h = linear_apply(p["lin2"], h)
    if rate > 0.0:
        h = dropout(seeds.post_ffn, h, rate)
    return _layer_norm(p["ln2"], x + h)


def transformer_encoder_apply(
    params,
    x: torch.Tensor,                # [B, T, d]
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    dropout_rate: float = 0.0,
    train: bool = False,
    backend: str = "auto",
    score_dtype: Optional[str] = "bfloat16",
    seeds: Optional[Sequence[LayerSeeds]] = None,
) -> torch.Tensor:
    """`seeds`: one LayerSeeds per layer (DropoutSeeds.layers) for
    training with dropout."""
    if seeds is not None and len(seeds) != len(params):
        raise ValueError(f"{len(seeds)} layer seeds for {len(params)} layers")
    for i in range(len(params)):
        x = transformer_encoder_layer_apply(
            params[f"layer{i}"], x, key_padding_mask, nhead, dropout_rate,
            train, backend, score_dtype, None if seeds is None else seeds[i])
    return x
