"""GRU-D, a decay-gated diagonal GRU over (x, mask, delta) (port of
raindrop_tpu/baselines/grud.py; reference code/baselines/models.py:337-655).

Every gate weight is a vector (the hidden width is the input width, the
reference's own simplification), with input and hidden decay:

  gamma_x = exp(-relu(w_dg_x * delta + b_dg_x))
  gamma_h = exp(-relu(w_dg_h * delta + b_dg_h))
  x_t     = m*x + (1-m)*(gamma_x*x + (1-gamma_x)*x_mean)
  h       = gamma_h * h; the elementwise GRU gates (z, r, h_tilde)
  out     = W_hy h + b_y

`x_mean` is a trainable parameter (models.py:346). The JAX package scans
over time; here what depends on no hidden state (the decays, the imputed
inputs, the gates' input terms) is computed for all steps at once and the
recurrence is a Python loop over the T steps, about a dozen launches a
step each way (host-bound on the card). The four dropout
variants (Moon / Gal / mloss / none, models.py:584-646) keep the JAX
`dropout_type` switch, each step dropping with its own seed.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from raindrop_tpu_torch.nn.init import generator_on, uniform
from raindrop_tpu_torch.utils.dropout import dropout

GATES = ("w_dg_x", "w_dg_h", "w_xz", "w_hz", "w_mz", "w_xr", "w_hr", "w_mr",
         "w_xh", "w_hh", "w_mh", "b_dg_x", "b_dg_h", "b_z", "b_r", "b_h")


def grud_init(generator, input_size: int, output_size: int, x_mean=None,
              device="cuda"):
    """Every weight U(-1/sqrt(hidden), 1/sqrt(hidden)) (reference
    models.py:600-603 reset_parameters); x_mean zeros unless given."""
    gen = generator_on(generator, device)
    s = 1.0 / math.sqrt(float(input_size))
    params = {n: uniform(gen, (input_size,), -s, s, device) for n in GATES}
    params["w_hy"] = uniform(gen, (output_size, input_size), -s, s, device)
    params["b_y"] = uniform(gen, (output_size,), -s, s, device)
    params["x_mean"] = (torch.zeros((input_size,), device=device) if x_mean is None
                        else torch.as_tensor(x_mean, dtype=torch.float32,
                                             device=device).reshape(-1))
    return params


def grud_apply(
    params,
    x: torch.Tensor,          # [B, T, F] values
    mask: torch.Tensor,       # [B, T, F] observed mask
    delta: torch.Tensor,      # [B, T, F] time since the last observation
    *,
    dropout_rate: float = 0.0,
    dropout_type: str = "mloss",
    train: bool = False,
    seeds: Optional[Sequence[int]] = None,
    apply_sigmoid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (output [B, n_out], final hidden [B, F]). `seeds` (train): one
    per time step."""
    B, T, F = x.shape
    p = params
    drop = train and dropout_rate > 0.0 and seeds is not None
    if drop and len(seeds) < T:
        raise ValueError(f"{len(seeds)} step seeds for {T} steps")
    # the decays, the imputed inputs and the gates' input terms depend on
    # no hidden state: computed for all T steps at once, so the loop holds
    # only the recurrence
    gamma_x = torch.exp(-torch.relu(p["w_dg_x"] * delta + p["b_dg_x"]))
    gamma_h = torch.exp(-torch.relu(p["w_dg_h"] * delta + p["b_dg_h"]))
    x = mask * x + (1 - mask) * (gamma_x * x + (1 - gamma_x) * p["x_mean"])
    z_in = p["w_xz"] * x + p["w_mz"] * mask + p["b_z"]
    r_in = p["w_xr"] * x + p["w_mr"] * mask + p["b_r"]
    h_in = p["w_xh"] * x + p["w_mh"] * mask + p["b_h"]
    h = x.new_zeros((B, F))
    for t in range(T):
        if drop and dropout_type == "Gal":
            h = dropout(seeds[t], h, dropout_rate)
        h = gamma_h[:, t] * h
        z = torch.sigmoid(z_in[:, t] + p["w_hz"] * h)
        r = torch.sigmoid(r_in[:, t] + p["w_hr"] * h)
        h_tilde = torch.tanh(h_in[:, t] + p["w_hh"] * (r * h))
        if drop and dropout_type == "mloss":
            h_tilde = dropout(seeds[t], h_tilde, dropout_rate)
        h = (1 - z) * h + z * h_tilde
        if drop and dropout_type == "Moon":
            h = dropout(seeds[t], h, dropout_rate)
    out = h @ p["w_hy"].T + p["b_y"]
    if apply_sigmoid:   # binary datasets squash with sigmoid + BCE (models.py:653)
        out = torch.sigmoid(out)
    return out, h


def build_delta(mask: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """The GRU-D delta tensor: the time since the sensor was last observed,
    accumulating through missing steps (reference
    GRU-D_data_preparation.py:142-148):

      delta[0] = 0; delta[t] = gap(t) + (1 - m[t-1]) * delta[t-1]

    mask [B, T, F]; times [B, T]."""
    B, T, F = mask.shape
    gaps = torch.diff(times, dim=1, prepend=times[:, :1])     # [B, T]
    d = mask.new_zeros((B, F))
    deltas = []
    for t in range(T):
        m_prev = mask[:, t - 1] if t else torch.ones_like(d)
        d = gaps[:, t, None] + (1 - m_prev) * d
        deltas.append(d)
    out = torch.stack(deltas, dim=1)
    out[:, 0] = 0.0
    return out
