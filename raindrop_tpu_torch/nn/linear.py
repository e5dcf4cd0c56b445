"""Linear and MLP primitives over parameter dicts (torch layout [out, in])."""

from __future__ import annotations

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params


def promoted(x: torch.Tensor, w: torch.Tensor):
    """x and w in their promoted dtype: a product of f32 and bf16 runs in
    f32, as `jnp.matmul` promotes (torch's refuses mixed dtypes)."""
    if x.dtype == w.dtype:
        return x, w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w.T + b with w in torch layout [out, in], in the promoted
    dtype of x and w."""
    x, w = promoted(x, params["w"])
    y = x @ w.T
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
