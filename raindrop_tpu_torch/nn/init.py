"""Parameter initializers with the JAX package's distributions.

Same distributions as `raindrop_tpu/nn/init.py` (not the same bits: a
`torch.Generator` and a JAX key give different numbers). Weights are kept
in torch layout [out, in]. Every function draws from an explicit
generator on the generator's device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def generator_on(generator, device) -> Optional[torch.Generator]:
    """The generator an init draws from: None on the meta device (the
    tree's shapes alone), a new one on `device` for an int seed, else
    `generator` itself."""
    if torch.device(device).type == "meta":
        return None
    if isinstance(generator, int):
        return torch.Generator(device=device).manual_seed(generator)
    return generator


def uniform(gen: Optional[torch.Generator], shape, minval: float,
            maxval: float, device="cuda", dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, device=device, dtype=dtype)
    return u * (maxval - minval) + minval


def torch_linear_params(gen, in_features: int, out_features: int,
                        device="cuda", dtype=torch.float32, bias: bool = True):
    """torch.nn.Linear default init: weight, bias ~ U(-1/sqrt(fan_in), +)."""
    bound = 1.0 / math.sqrt(in_features)
    w = uniform(gen, (out_features, in_features), -bound, bound, device, dtype)
    if not bias:
        return {"w": w}
    return {"w": w,
            "b": uniform(gen, (out_features,), -bound, bound, device, dtype)}


def glorot(gen, shape: Tuple[int, ...], device="cuda", dtype=torch.float32):
    """PyG glorot: U(-a, a), a = sqrt(6 / (shape[-2] + shape[-1]))."""
    a = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return uniform(gen, shape, -a, a, device, dtype)


def xavier_uniform(gen, shape: Tuple[int, int], device="cuda",
                   dtype=torch.float32, gain: float = 1.0):
    """torch xavier_uniform_ on a [out, in] matrix."""
    fan_out, fan_in = shape
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(gen, shape, -a, a, device, dtype)


def tiny_uniform(gen, shape, initrange: float = 1e-10, device="cuda",
                 dtype=torch.float32):
    """uniform_(-1e-10, 1e-10) used for the encoder/emb weights."""
    return uniform(gen, shape, -initrange, initrange, device, dtype)
