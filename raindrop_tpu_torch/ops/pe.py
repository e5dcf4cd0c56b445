"""Time-aware positional encoding (port of raindrop_tpu/ops/pe.py)."""

from __future__ import annotations

import numpy as np
import torch


def pe_timescales(d_pe: int, max_len: int) -> np.ndarray:
    """timescales = max_len ** linspace(0, 1, d_pe//2), in float64."""
    n = d_pe // 2
    return np.asarray(max_len, dtype=np.float64) ** np.linspace(0.0, 1.0, n)


def time_positional_encoding(times: torch.Tensor, d_pe: int, max_len: int,
                             dtype=torch.float32) -> torch.Tensor:
    """[...] timestamps (hours) -> [..., d_pe] = concat(sin(t/tau), cos(t/tau)).

    The float64 timescales are cast to `dtype` before the division, as the
    JAX function does.
    """
    scales = torch.as_tensor(pe_timescales(d_pe, max_len)).to(
        device=times.device, dtype=dtype)
    scaled = times[..., None].to(dtype) / scales
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
