"""DGM2-O, an ODE-RNN with cluster emission (port of
raindrop_tpu/baselines/dgm2.py; reference code/baselines/models.py:983-1462
with the driver's configuration, DGM2_baseline.py:304-323): latent_dim 10,
cluster_num 20, the Euler solver, GRU_unit_cluster with 10 units,
use_mask=False; the classifier Linear(T * 10 + d_static, n_classes) over
the flattened latent states (models.py:1235-1242).

The shared uniform timeline the driver feeds (evaluate_DGM2,
utils_phy12.py:480-482) always takes one Euler increment an observation,
so each step is one Euler step (`euler_substeps` refines it) and a GRU
update, in a Python loop over the T steps (host-bound on the card). The
cluster emission chain (models.py:1264-1289) comes back as the second
output, which the classifier ignores, as in the reference; with
`emission=False` it is not computed (the adapter's path, whose loss never
reads it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.nn.init import generator_on, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply


@dataclass(frozen=True)
class DGM2Spec:
    """The JAX tree's `_meta`."""
    latent_dim: int = 10
    cluster_num: int = 20


def dgm2_init(generator, input_dim: int, seq_len: int, n_classes: int, *,
              spec: DGM2Spec = DGM2Spec(), d_static: int = 0, ode_units: int = 10,
              device="cuda"):
    gen = generator_on(generator, device)
    L, C = spec.latent_dim, spec.cluster_num

    def lin(i, o):
        return torch_linear_params(gen, i, o, device)

    return {
        # the ODE function: Linear(L, units) > Tanh > Linear(units, L)
        # (DGM2_baseline.py:74-84, :305-308)
        "ode_l1": lin(L, ode_units),
        "ode_l2": lin(ode_units, L),
        # GRU_unit_cluster's gates (models.py:985-1053), use_mask=False
        "update_gate": lin(L + input_dim, L),
        "reset_gate": lin(L + input_dim, L),
        "new_state": lin(L + input_dim, L),
        # the emission (models.py:1180-1197)
        "infer_emitter_z": lin(L + C, C),
        "decayed_layer": lin(1, 1),
        "mlp": lin(seq_len * L + d_static, n_classes),
    }


def _ode_func(p, y):
    return linear_apply(p["ode_l2"], torch.tanh(linear_apply(p["ode_l1"], y)))


def _gru_update(p, y, x):
    """GRU_unit_cluster.forward (models.py:1036-1053)."""
    cat = torch.cat([y, x], dim=-1)
    z = torch.sigmoid(linear_apply(p["update_gate"], cat))
    r = torch.sigmoid(linear_apply(p["reset_gate"], cat))
    n = linear_apply(p["new_state"], torch.cat([y * r, x], dim=-1))
    return (1 - z) * n + z * y


def dgm2_apply(
    params, spec: DGM2Spec,
    data: torch.Tensor,           # [B, T, F] values (the use_mask=False path)
    time_steps: torch.Tensor,     # [T] the shared timeline
    static: Optional[torch.Tensor] = None,
    *,
    euler_substeps: int = 1,
    train: bool = False,
    seeds=None,
    emission: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (logits, the emission chain's cluster probabilities [B, T, C], or
    None without `emission`)."""
    p = params
    B, T, F = data.shape
    # step 0 takes the reference's fictitious 0.01 lead-in (models.py:1352)
    gaps = torch.cat([time_steps.new_full((1,), 0.01), torch.diff(time_steps)])
    y = data.new_zeros((B, spec.latent_dim))
    states = []
    for t in range(T):
        dt = gaps[t] / euler_substeps
        for _ in range(euler_substeps):
            y = y + _ode_func(p, y) * dt
        y = _gru_update(p, y, data[:, t])
        states.append(y)
    states = torch.stack(states, dim=1)                 # [B, T, L]
    vec = states.reshape(B, T * spec.latent_dim)
    if static is not None:
        vec = torch.cat([vec, static], dim=1)
    logits = linear_apply(p["mlp"], vec)
    if not emission:
        return logits, None
    # the cluster emission chain (models.py:1423-1436); the concat_data
    # path ignores the decay (models.py:1281-1284), so it is not computed
    prob = data.new_zeros((B, spec.cluster_num))
    latent_ys = []
    for t in range(T):
        prob = torch.softmax(linear_apply(
            p["infer_emitter_z"], torch.cat([prob, states[:, t]], dim=-1)), dim=-1)
        latent_ys.append(prob)
    return logits, torch.stack(latent_ys, dim=1)
