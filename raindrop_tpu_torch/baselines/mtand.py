"""mTAND, the multi-time attention network's classifier (port of
raindrop_tpu/baselines/mtand.py; reference code/baselines/mTAND/models.py).

`multiTimeAttention` (:9-51) attends from a learned time embedding of the
reference points (queries) to the observation timeline (keys), masked per
channel: the scores are repeated over the 2F value channels and set to
-1e9 where a channel is unobserved (:28-33); `enc_mtan_classif` (:54-109)
runs the attended [B, R, nhidden] sequence through a GRU and its final
hidden state through a 300-300 MLP. Inputs: x = [values | mask] [B, T, 2F]
(the mask doubled to 2F channels inside, :95-97) and times in [0, 1]. The
GRU is a Python loop over the R reference points (host-bound on the
card); the masked scores are [B, heads, R, T, 2F], as in the JAX function.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from raindrop_tpu_torch.nn.init import generator_on, torch_linear_params, uniform
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init


def mtand_init(generator, input_dim: int, *, nhidden: int = 16, embed_time: int = 16,
               num_heads: int = 1, n_classes: int = 2, n_ref: int = 128,
               device="cuda"):
    """input_dim = 2F (the value and mask channels)."""
    if embed_time % num_heads:
        raise ValueError("embed_time % num_heads != 0 (mTAND/models.py:14)")
    gen = generator_on(generator, device)
    return {
        "att_q": torch_linear_params(gen, embed_time, embed_time, device),
        "att_k": torch_linear_params(gen, embed_time, embed_time, device),
        "att_out": torch_linear_params(gen, input_dim * num_heads, nhidden, device),
        "periodic": torch_linear_params(gen, 1, embed_time - 1, device),
        "linear": torch_linear_params(gen, 1, 1, device),
        "classifier": mlp_init(gen, [nhidden, 300, 300, n_classes], device),
        "gru": gru_init(gen, nhidden, nhidden, device),
        "query_points": torch.linspace(0.0, 1.0, n_ref, device=device),
    }


def gru_init(gen, in_dim: int, hidden: int, device="cuda"):
    """torch.nn.GRU's weights U(-1/sqrt(hidden), +), zero biases (the JAX
    `_gru_init`)."""
    s = 1.0 / math.sqrt(float(hidden))
    return {
        "w_ih": uniform(gen, (3 * hidden, in_dim), -s, s, device),
        "w_hh": uniform(gen, (3 * hidden, hidden), -s, s, device),
        "b_ih": torch.zeros((3 * hidden,), device=device),
        "b_hh": torch.zeros((3 * hidden,), device=device),
    }


def gru_scan(p, xs: torch.Tensor) -> torch.Tensor:
    """A torch.nn.GRU cell over xs [B, L, in] from zeros, one step at a
    time (reference mTAND/models.py:82 self.enc) -> the last hidden state
    [B, hidden]."""
    hidden = p["w_hh"].shape[1]
    gi_all = linear_apply({"w": p["w_ih"], "b": p["b_ih"]}, xs)   # [B, L, 3h]
    h = xs.new_zeros((xs.shape[0], hidden))
    for t in range(xs.shape[1]):
        ir, iz, inn = gi_all[:, t].split(hidden, dim=-1)
        hr, hz, hnn = (h @ p["w_hh"].T + p["b_hh"]).split(hidden, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hnn)
        h = (1 - z) * n + z * h
    return h


def time_embedding(params, tt: torch.Tensor) -> torch.Tensor:
    """The learned time embedding [linear(t) | sin(periodic(t))]
    (mTAND/models.py:84-89): tt [..., L] -> [..., L, embed_time]."""
    tt = tt[..., None]
    return torch.cat([linear_apply(params["linear"], tt),
                      torch.sin(linear_apply(params["periodic"], tt))], dim=-1)


def mtand_apply(params, x: torch.Tensor, times: torch.Tensor, *, num_heads: int = 1,
                train: bool = False, seeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, 2F] values | observed mask; times [B, T] in [0, 1] ->
    (logits, 0)."""
    B, T, D2 = x.shape
    F = D2 // 2
    mask2 = torch.cat([x[:, :, F:], x[:, :, F:]], dim=2)           # [B, T, 2F]
    key_emb = time_embedding(params, times)                         # [B, T, E]
    query_emb = time_embedding(params, params["query_points"][None])  # [1, R, E]
    E = key_emb.shape[-1]
    hd = E // num_heads

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], num_heads, hd).transpose(1, 2)

    q = heads(linear_apply(params["att_q"], query_emb))             # [1, h, R, hd]
    k = heads(linear_apply(params["att_k"], key_emb))               # [B, h, T, hd]
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(float(hd))       # [B, h, R, T]
    # per-channel masking: the scores repeated over the channels, -1e9
    # where a channel is unobserved, the softmax over T (models.py:28-33)
    scores = torch.where(mask2[:, None, None] == 0, -1e9, scores[..., None])
    p_attn = torch.softmax(scores, dim=-2)                          # [B, h, R, T, 2F]
    attended = (p_attn * x[:, None, None]).sum(dim=-2)              # [B, h, R, 2F]
    attended = attended.transpose(1, 2).reshape(B, -1, num_heads * D2)
    out = linear_apply(params["att_out"], attended)                 # [B, R, nhidden]
    h = gru_scan(params["gru"], out)
    logits = mlp_apply(params["classifier"], h)
    return logits, logits.new_zeros(())
