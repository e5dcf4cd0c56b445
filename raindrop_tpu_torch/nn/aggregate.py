"""Masked temporal pooling (port of raindrop_tpu/nn/aggregate.py): the
mean over each sample's valid steps, and the per-sensor pool of the
sensor-wise mask."""

from __future__ import annotations

import torch


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] True for padded timesteps (t >= length)."""
    t = torch.arange(max_len, device=lengths.device)
    return t[None, :] >= lengths[:, None]


def masked_mean_pool(r_out: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """sum_t r_out[b,t] * (t < len_b) / (len_b + 1). r_out: [B, T, d] -> [B, d].

    The +1 in the denominator is the reference's (code/models_rd.py:378-379).
    """
    _, T, _ = r_out.shape
    keep = (~padding_mask(lengths, T)).to(r_out.dtype)[:, :, None]
    return (r_out * keep).sum(dim=1) / (lengths[:, None].to(r_out.dtype) + 1.0)


def sensor_wise_pool(r_out: torch.Tensor, observed_mask: torch.Tensor) -> torch.Tensor:
    """Per-sensor pool (reference code/models_rd.py:368-377). r_out
    [B, T, F, C] per-sensor encoder outputs, observed_mask [B, T, F] 1.0
    where the sensor was observed at t -> [B, F*C].

    The reference's quirk is kept: the sum weights the steps by
    (1 - observed) while the denominator is (#observed + 1)."""
    B, _, F, C = r_out.shape
    w = (1.0 - observed_mask)[..., None]                       # [B, T, F, 1]
    lens = observed_mask.sum(dim=1)[..., None]                 # [B, F, 1]
    pooled = (r_out * w).sum(dim=1) / (lens + 1.0)             # [B, F, C]
    return pooled.reshape(B, F * C)
