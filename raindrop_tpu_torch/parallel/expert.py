"""The mixture-of-experts FFN and expert parallelism (port of
raindrop_tpu/parallel/expert.py): top-1 (switch) gating with a dense
one-hot dispatch, every expert running every token and the one-hot
selecting, with the Switch Transformer's load-balancing loss.

Expert parallelism: the stacked experts [E, ...] split over a mesh axis
(`expert_parallel_specs`, `shard_moe_params`), the gate replicated. With a
`mesh`, each rank of the axis runs its E / n experts on every token (the
gate, the routing and the aux loss it computes whole), and one all_reduce
over the axis sums their selected outputs; the backward all_reduces the
gradient of the experts' input (parallel/tensor.py). Where GSPMD
partitions the JAX function's einsums, the port runs those collectives
explicitly.
"""

from __future__ import annotations

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params
from raindrop_tpu_torch.parallel import tensor as tp
from raindrop_tpu_torch.parallel.mesh import AXES, group


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


def expert_parallel_specs(axis: str = "model"):
    """The split dim of each moe_ffn leaf over `axis`: the stacked experts
    on dim 0, the gate replicated (None)."""
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}")
    return {"gate": {"w": None, "b": None}, "w1": 0, "b1": 0, "w2": 0, "b2": 0}


def _experts(mesh, axis, E):
    """(first expert, count, group) of this rank's experts of E."""
    g = group(mesh, axis)
    if g is None:
        return 0, E, None
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks of {axis!r}")
    return mesh.get_local_rank(axis) * (E // n), E // n, g


def shard_moe_params(params, mesh, axis: str = "model"):
    """This rank's part of moe_ffn params: its experts' slices of w1, b1,
    w2, b2, and the whole gate."""
    e0, n, g = _experts(mesh, axis, params["w1"].shape[0])
    if g is None:
        return params
    out = {"gate": params["gate"]}
    for k in ("w1", "b1", "w2", "b2"):
        out[k] = params[k][e0:e0 + n].contiguous()
    return out


def moe_ffn_apply(params, x: torch.Tensor, *, mesh=None, axis: str = "model",
                  activation=torch.relu):
    """Top-1 routed MoE FFN on x [B, T, d]. Returns ([B, T, d], aux), aux
    the load-balancing loss E * sum_e (fraction routed to e) * (mean
    probability of e). With `mesh`, `params` are the full tree or this
    rank's part of it (shard_moe_params); either way the rank runs its
    experts of `axis` and the outputs are summed over the axis."""
    E = params["gate"]["w"].shape[0]
    logits = x @ params["gate"]["w"].T + params["gate"]["b"]      # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(probs.argmax(dim=-1), E).to(x.dtype)
    gate = (probs * onehot).sum(dim=-1)                           # [B, T]
    e0, n, g = _experts(mesh, axis, E)
    ws = {k: params[k] for k in ("w1", "b1", "w2", "b2")}
    if params["w1"].shape[0] == E and n < E:                      # the full tree
        ws = {k: v[e0:e0 + n] for k, v in ws.items()}
    xe = tp.copy_to(x, g)
    h = activation(torch.einsum("btd,efd->btef", xe, ws["w1"]) + ws["b1"])
    y = torch.einsum("btef,edf->bted", h, ws["w2"]) + ws["b2"]
    picked = tp.reduce_from(torch.einsum("bted,bte->btd", y, onehot[..., e0:e0 + n]), g)
    out = picked * gate[..., None]
    frac = onehot.reshape(-1, E).mean(dim=0)
    mean_prob = probs.reshape(-1, E).mean(dim=0)
    return out, E * (frac * mean_prob).sum()
