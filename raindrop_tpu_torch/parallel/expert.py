"""The mixture-of-experts FFN (port of moe_ffn_init and moe_ffn_apply in
raindrop_tpu/parallel/expert.py): top-1 (switch) gating with a dense
one-hot dispatch, every expert running every token and the one-hot
selecting, with the Switch Transformer's load-balancing loss.

Expert parallelism (experts sharded over a mesh axis: the JAX package's
`mesh` argument, `expert_parallel_specs`, `shard_moe_params`) comes with
the scale-out slice; passing a mesh raises.
"""

from __future__ import annotations

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params


def moe_ffn_init(gen, d_model: int, ffn_dim: int, n_experts: int,
                 device="cuda", dtype=torch.float32):
    """The gate and the experts' weights stacked [E, ...] in torch layout
    ([E, out, in]), each expert with torch.nn.Linear's init."""
    gate = torch_linear_params(gen, d_model, n_experts, device, dtype)
    e1 = [torch_linear_params(gen, d_model, ffn_dim, device, dtype)
          for _ in range(n_experts)]
    e2 = [torch_linear_params(gen, ffn_dim, d_model, device, dtype)
          for _ in range(n_experts)]
    return {
        "gate": gate,
        "w1": torch.stack([p["w"] for p in e1]),     # [E, ffn, d]
        "b1": torch.stack([p["b"] for p in e1]),     # [E, ffn]
        "w2": torch.stack([p["w"] for p in e2]),     # [E, d, ffn]
        "b2": torch.stack([p["b"] for p in e2]),     # [E, d]
    }


def moe_ffn_apply(params, x: torch.Tensor, *, mesh=None, activation=torch.relu):
    """Top-1 routed MoE FFN on x [B, T, d]. Returns ([B, T, d], aux), aux
    the load-balancing loss E * sum_e (fraction routed to e) * (mean
    probability of e)."""
    if mesh is not None:
        raise NotImplementedError("expert parallelism over a mesh comes with the "
                                  "scale-out slice")
    E = params["w1"].shape[0]
    logits = x @ params["gate"]["w"].T + params["gate"]["b"]      # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(probs.argmax(dim=-1), E).to(x.dtype)
    gate = (probs * onehot).sum(dim=-1)                           # [B, T]
    h = activation(torch.einsum("btd,efd->btef", x, params["w1"]) + params["b1"])
    y = torch.einsum("btef,edf->bted", h, params["w2"]) + params["b2"]
    out = torch.einsum("bted,bte->btd", y, onehot) * gate[..., None]
    frac = onehot.reshape(-1, E).mean(dim=0)
    mean_prob = probs.reshape(-1, E).mean(dim=0)
    return out, E * (frac * mean_prob).sum()
