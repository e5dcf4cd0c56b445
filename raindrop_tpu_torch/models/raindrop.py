"""Raindrop (v2) eval forward (port of raindrop_tpu/models/raindrop.py).

The serving path of the shipped config: the complete all-ones sensor
graph (graph propagation reduces to relu(lin_value(x)) twice), the time
PE, the temporal encoder, masked mean pooling, the static embedding and
the MLP head. Parameters are nested dicts of tensors with the JAX
package's tree and layouts (nn/*, bridge.py).

Input contract, as the JAX function's:
  src     [T, B, 2F]  z-scored values (cols :F) ++ observed mask (cols F:2F)
  static  [B, d_static] or None
  times   [T, B]      timestamps in hours (0 = padding)
  lengths [B]         number of non-zero timestamps per sample

What this slice does not serve raises NotImplementedError naming the
slice that brings it: training, use_beta, sensor_wise_mask,
compute_dtype, the coo/pallas propagation backends, a custom global_adj
and the scale-out routes.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.graph.propagate import (
    alpha_pairwise_distance, ob_propagate_dense_complete, ob_propagation_init)
from raindrop_tpu_torch.nn.aggregate import masked_mean_pool, padding_mask
from raindrop_tpu_torch.nn.init import glorot, tiny_uniform, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.nn.transformer import (
    transformer_encoder_apply, transformer_encoder_init)
from raindrop_tpu_torch.ops.pe import time_positional_encoding


def _dtype(cfg: RaindropConfig) -> torch.dtype:
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"param dtype {cfg.dtype!r}: the port serves float32 params; "
            f"other storage dtypes come with the mixed-precision slice")
    return torch.float32


def raindrop_init(generator: Union[torch.Generator, int, None],
                  cfg: RaindropConfig, device="cuda"):
    """All parameters, with the JAX package's tree, shapes and
    distributions. `generator` is a torch.Generator on `device`, or an int
    seed for a new one. device="meta" gives the tree's shapes alone."""
    device = torch.device(device)
    if device.type == "meta":
        gen = None
    elif isinstance(generator, int):
        gen = torch.Generator(device=device).manual_seed(generator)
    else:
        gen = generator
    dtype = _dtype(cfg)
    d_model = cfg.d_model
    in_ch = cfg.max_len * cfg.d_ob
    params = {
        "R_u": glorot(gen, (1, d_model), device, dtype),
        # exists but unused in the reference forward; kept so checkpoints
        # round-trip
        "encoder": {
            "w": tiny_uniform(gen, (d_model, d_model), cfg.init_range, device, dtype),
            "b": torch_linear_params(gen, d_model, d_model, device, dtype)["b"],
        },
        "ob_propagation": ob_propagation_init(
            gen, in_ch, in_ch, cfg.d_inp, cfg.d_ob, device=device, dtype=dtype),
        "ob_propagation_layer2": ob_propagation_init(
            gen, in_ch, in_ch, cfg.d_inp, cfg.d_ob, device=device, dtype=dtype),
        "transformer_encoder": transformer_encoder_init(
            gen, cfg.d_transformer, cfg.nhead, cfg.ffn_dim, cfg.nlayers,
            device, dtype),
        "mlp_static": mlp_init(gen, [cfg.d_final, cfg.d_final, cfg.n_classes],
                               device, dtype),
    }
    if cfg.static:
        params["emb"] = {
            "w": tiny_uniform(gen, (cfg.d_inp, cfg.d_static), cfg.init_range,
                              device, dtype),
            "b": torch_linear_params(gen, cfg.d_static, cfg.d_inp, device,
                                     dtype)["b"],
        }
    return params


def _to_node_features(h: torch.Tensor, F: int, d_ob: int) -> torch.Tensor:
    """[B, T, F*d_ob] -> [B, F, T*d_ob]."""
    B, T, _ = h.shape
    return h.reshape(B, T, F, d_ob).permute(0, 2, 1, 3).reshape(B, F, T * d_ob)


def _from_node_features(x: torch.Tensor, T: int, d_ob: int) -> torch.Tensor:
    """[B, F, T*d_ob] -> [B, T, F*d_ob]."""
    B, F, _ = x.shape
    return x.reshape(B, F, T, d_ob).permute(0, 2, 1, 3).reshape(B, T, F * d_ob)


def _refuse(cfg: RaindropConfig, train: bool, global_adj, scale_out: bool):
    if train:
        raise NotImplementedError("train=True comes with the training slice")
    if scale_out:
        raise NotImplementedError(
            "context_parallel, pipeline_parallel and edge_partition come "
            "with the scale-out slice")
    if cfg.use_beta or cfg.sensor_wise_mask:
        raise NotImplementedError(
            "use_beta and sensor_wise_mask come with the capability slice")
    if cfg.compute_dtype is not None and cfg.compute_dtype != cfg.dtype:
        raise NotImplementedError(
            "compute_dtype comes with the mixed-precision slice")
    if cfg.prop_backend != "auto" or global_adj is not None:
        raise NotImplementedError(
            "the coo/pallas propagation backends and a custom global_adj "
            "come with the graph-kernel slice")


@torch.no_grad()
def raindrop_apply(
    params,
    cfg: RaindropConfig,
    src: torch.Tensor,                      # [T, B, 2F]
    static: Optional[torch.Tensor],         # [B, d_static] or None
    times: torch.Tensor,                    # [T, B]
    lengths: torch.Tensor,                  # [B]
    *,
    train: bool = False,
    global_adj: Optional[torch.Tensor] = None,
    context_parallel: str = "none",
    pipeline_parallel: int = 0,
    edge_partition: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval forward. Returns (logits [B, n_classes], distance scalar)."""
    _refuse(cfg, train, global_adj,
            context_parallel != "none" or bool(pipeline_parallel) or edge_partition)
    F_, d_ob, T = cfg.d_inp, cfg.d_ob, cfg.max_len
    dtype = _dtype(cfg)
    values = src[:, :, :F_].to(dtype)                     # [T, B, F]
    B = values.shape[1]

    # sensor-level gated embedding: repeat_interleave by d_ob, times R_u
    h = torch.relu(values.repeat_interleave(d_ob, dim=-1) * params["R_u"])
    pe = time_positional_encoding(times, cfg.d_pe, T, dtype)   # [T, B, d_pe]
    h_b = h.transpose(0, 1)                                # [B, T, F*d_ob]
    pe_b = pe.transpose(0, 1)                              # [B, T, d_pe]

    # two propagation layers on the complete all-ones graph; layer 2's
    # edge weights are layer 1's pre-softmax alpha, the same ones
    x_nodes = _to_node_features(h_b, F_, d_ob)             # [B, F, T*d_ob]
    adj = torch.ones((F_, F_), dtype=dtype, device=src.device)
    out1, alpha1 = ob_propagate_dense_complete(
        params["ob_propagation"], x_nodes, adj, uniform=True)
    out2, alpha_all = ob_propagate_dense_complete(
        params["ob_propagation_layer2"], out1, alpha1.reshape(B, F_, F_),
        uniform=True)
    distance = alpha_pairwise_distance(alpha_all)
    output = _from_node_features(out2, T, d_ob)            # [B, T, F*d_ob]
    output = torch.cat([output, pe_b], dim=-1)             # [B, T, F*d_ob+d_pe]

    mask = padding_mask(lengths, T)                        # [B, T] True = pad
    r_out = transformer_encoder_apply(
        params["transformer_encoder"], output, mask, cfg.nhead,
        dropout_rate=cfg.dropout, train=False,
        backend=cfg.attention_backend,
        score_dtype=cfg.attention_score_dtype)

    pooled = masked_mean_pool(r_out, lengths)
    if cfg.static and static is not None:
        emb = linear_apply(params["emb"], static.to(dtype))
        pooled = torch.cat([pooled, emb], dim=1)
    return mlp_apply(params["mlp_static"], pooled), distance
