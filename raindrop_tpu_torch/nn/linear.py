"""Linear and MLP primitives over parameter dicts (torch layout [out, in])."""

from __future__ import annotations

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w.T + b with w in torch layout [out, in]."""
    y = x @ params["w"].T
    if "b" in params:
        y = y + params["b"]
    return y


def mlp_init(gen, dims, device="cuda", dtype=torch.float32):
    """Sequential Linear/ReLU/.../Linear; `dims` = [in, hidden..., out]."""
    return {f"lin{i}": torch_linear_params(gen, dims[i], dims[i + 1],
                                           device, dtype)
            for i in range(len(dims) - 1)}


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = linear_apply(params[f"lin{i}"], x)
        if i < n - 1:
            x = torch.relu(x)
    return x
