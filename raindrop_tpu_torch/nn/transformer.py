"""Temporal transformer encoder (port of raindrop_tpu/nn/transformer.py).

Post-LN torch TransformerEncoderLayer semantics, built by hand over a
parameter dict: `torch.nn.TransformerEncoder` gives NaN on samples whose
keys are all padded, where this encoder gives zero attention. Layout
[B, T, d] inside the encoder. Eval only in this slice: train=True with
dropout, and the context-parallel backends, raise.

Encoder ladder. `backend="auto"` on a CUDA tensor keeps the JAX package's
structure and thresholds: the fused-layer kernel when d % nhead == 0,
T >= 384 and T (padded to 8) <= 1024; the packed flash kernel when
128 <= T and T (padded to 8) <= 1024; dense otherwise. The thresholds are
the JAX package's, measured on a TPU v5e, not on the H100: the card's own
crossover is an open question (PERF.md). On a CPU tensor `auto` is dense,
as the JAX ladder is off the TPU. An explicit "dense" | "flash" |
"fused_layer" works on both devices (on the CPU the kernels' plain
versions run).
"""

from __future__ import annotations

from typing import Optional

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params, xavier_uniform
from raindrop_tpu_torch.nn.linear import linear_apply
from raindrop_tpu_torch.ops.flash_attention import MAX_FUSED_T, flash_mha_packed
from raindrop_tpu_torch.ops.fused_encoder import fused_encoder_layer

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


def _refuse(train: bool, dropout_rate: float, backend: str):
    if backend not in BACKENDS:
        if backend in ("sp", "ring"):
            raise NotImplementedError(
                f"the context-parallel backend {backend!r} comes with the "
                f"scale-out slice")
        raise ValueError(f"unknown attention backend {backend!r}")
    if train and dropout_rate > 0.0:
        raise NotImplementedError(
            "the encoder with dropout in training comes with the training slice")


def multihead_self_attention(
    p,
    x: torch.Tensor,                 # [B, T, d]
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    dropout_rate: float = 0.0,
    train: bool = False,
    backend: str = "auto",
    score_dtype: Optional[str] = "bfloat16",
) -> torch.Tensor:
    _refuse(train, dropout_rate, backend)
    B, T, d = x.shape
    hd = d // nhead
    qkv = x @ p["in_proj_w"].T + p["in_proj_b"]           # [B, T, 3d]
    q, k, v = qkv.split(d, dim=-1)
    t8 = -(-T // 8) * 8
    if backend == "auto":
        backend = ("flash" if x.is_cuda and T >= 128 and t8 <= MAX_FUSED_T
                   else "dense")
    if backend == "flash":
        out = flash_mha_packed(q, k, v, _lengths(key_padding_mask, B, T, x.device),
                               None, 0.0, _score_dtype(score_dtype), nhead)
        return linear_apply(p["out_proj"], out)

    def heads(t):  # [B, T, d] -> [B, nhead, T, hd]
        return t.reshape(B, T, nhead, hd).transpose(1, 2)

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
) -> torch.Tensor:
    """One post-LN encoder layer; backend 'fused_layer' (and 'auto' on CUDA
    at T >= 384) runs the whole layer through ops/fused_encoder.py."""
    _refuse(train, dropout_rate, backend)
    B, T, d = x.shape
    use_fused = d % nhead == 0 and (
        backend == "fused_layer"
        or (backend == "auto" and x.is_cuda and T >= 384
            and -(-T // 8) * 8 <= MAX_FUSED_T))
    if use_fused:
        return fused_encoder_layer(p, x, _lengths(key_padding_mask, B, T, x.device),
                                   None, 0.0, _score_dtype(score_dtype), nhead)
    attn = multihead_self_attention(p, x, key_padding_mask, nhead,
                                    dropout_rate, train, backend, score_dtype)
    x = _layer_norm(p["ln1"], x + attn)
    h = linear_apply(p["lin2"], torch.relu(linear_apply(p["lin1"], x)))
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
) -> torch.Tensor:
    for i in range(len(params)):
        x = transformer_encoder_layer_apply(
            params[f"layer{i}"], x, key_padding_mask, nhead, dropout_rate,
            train, backend, score_dtype)
    return x
