"""Masked temporal pooling (port of raindrop_tpu/nn/aggregate.py).

`sensor_wise_pool` comes with the capability slice.
"""

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
