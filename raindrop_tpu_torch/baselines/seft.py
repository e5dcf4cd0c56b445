"""SeFT, Set Functions for Time Series (port of raindrop_tpu/baselines/
seft.py; reference code/baselines/models.py:219-334).

Each observed (time, value, sensor) triple becomes a 48-wide tuple [time
PE | value linear (16) | sensor-index PE (16)]; a sample is the mean over
its set of tuples, taken twice (the reference concatenates f_prime with
the per-tuple mean, both the set mean after its outer mean, :319-325),
then lin_map -> 128, the static embedding concatenated, an MLP head. The
set mean is a masked mean over the dense [B, T, F] grid, one batched op,
as in the JAX function. Kept: the tuples are the entries whose value is
not 0 (torch .nonzero), not those of the missingness mask. No dropout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.nn.init import (
    generator_on, tiny_uniform, torch_linear_params, xavier_uniform)
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.ops.pe import time_positional_encoding


def seft_init(generator, cfg: RaindropConfig, device="cuda"):
    gen = generator_on(generator, device)
    d_K = 2 * (cfg.d_pe + 16 + 16)          # 96 (models.py:248)
    d_fi = 128 + (cfg.d_pe if cfg.static else 0)
    params = {
        "linear_value": {
            "w": tiny_uniform(gen, (16, 1), cfg.init_range, device),
            "b": torch_linear_params(gen, 1, 16, device)["b"],
        },
        "lin_map": {
            "w": tiny_uniform(gen, (128, d_K), cfg.init_range, device),
            "b": torch_linear_params(gen, d_K, 128, device)["b"],
        },
        # created and never read (:259), as in the reference
        "proj_weight": xavier_uniform(gen, (d_K, 128), device),
        "mlp": mlp_init(gen, [d_fi, d_fi, cfg.n_classes], device),
    }
    if cfg.static:
        params["emb"] = {
            "w": tiny_uniform(gen, (16, cfg.d_static), cfg.init_range, device),
            "b": torch_linear_params(gen, cfg.d_static, 16, device)["b"],
        }
    return params


def seft_apply(
    params, cfg: RaindropConfig,
    src: torch.Tensor,                  # [T, B, 2F]
    static: Optional[torch.Tensor],
    times: torch.Tensor,                # [T, B]
    lengths: torch.Tensor,
    *, train: bool = False, seeds=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    T, B, _ = src.shape
    F = cfg.d_inp
    values = src[:, :, :F].transpose(0, 1)               # [B, T, F]
    obs = (values != 0).to(values.dtype)
    # the time PE of each entry's step (the same for all F sensors)
    pe_t = time_positional_encoding(times, cfg.d_pe, cfg.max_len).transpose(0, 1)
    pe_t = pe_t[:, :, None, :].expand(B, T, F, cfg.d_pe)
    # the sensor-index PE (models.py:313: pos_encoder_sensor on the id)
    ids = torch.arange(F, dtype=values.dtype, device=values.device)
    pe_s = time_positional_encoding(ids, 16, cfg.max_len).expand(B, T, F, 16)
    val_emb = linear_apply(params["linear_value"], values[..., None])  # [B, T, F, 16]
    unit = torch.cat([pe_t, val_emb, pe_s], dim=-1)                     # [B, T, F, 48]
    count = obs.sum(dim=(1, 2))
    set_mean = ((unit * obs[..., None]).sum(dim=(1, 2))
                / torch.clamp(count, min=1.0)[:, None])                 # [B, 48]
    rep = torch.cat([set_mean, set_mean], dim=-1)                       # [B, 96]
    # a sample with no observation contributes zeros (models.py:299-300)
    rep = torch.where(count[:, None] > 0, rep, torch.zeros_like(rep))
    out = linear_apply(params["lin_map"], rep)
    if cfg.static and static is not None:
        out = torch.cat([out, linear_apply(params["emb"], static)], dim=1)
    logits = mlp_apply(params["mlp"], out)
    return logits, logits.new_zeros(())
