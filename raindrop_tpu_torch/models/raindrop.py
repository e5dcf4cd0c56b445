"""Raindrop (v2) forward (port of raindrop_tpu/models/raindrop.py).

The serving and training path of the shipped config: the complete
all-ones sensor graph (graph propagation reduces to relu(lin_value(x))
twice), the time PE, the temporal encoder, masked mean pooling, the static
embedding and the MLP head. Parameters are nested dicts of tensors with the JAX
package's tree and layouts (nn/*, bridge.py).

Input contract, as the JAX function's:
  src     [T, B, 2F]  z-scored values (cols :F) ++ observed mask (cols F:2F)
  static  [B, d_static] or None
  times   [T, B]      timestamps in hours (0 = padding)
  lengths [B]         number of non-zero timestamps per sample

With train=True and a `DropoutSeeds` the embedding, the propagation's
softmax weights (when prop_dropout > 0) and every encoder layer drop with
the counter-hash masks of utils/dropout.py. The function records a graph
for autograd; callers that only infer run it under torch.no_grad().

What the port does not run yet raises NotImplementedError naming the
slice that brings it: use_beta, sensor_wise_mask, compute_dtype, the
coo/pallas propagation backends, a custom global_adj and the scale-out
routes.
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
from raindrop_tpu_torch.utils.dropout import DropoutSeeds, dropout


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


def raindrop_param_mask(cfg: RaindropConfig):
    """True for every parameter the forward uses (the tree of
    raindrop_init). The dead ones (the unused `encoder`, and all of a
    propagation layer but lin_value when use_beta is off) get no gradient,
    so the optimizer must never touch them."""
    def prop_mask():
        dead = {"w": False, "b": False}
        beta = {"w": cfg.use_beta, "b": cfg.use_beta}
        return {"lin_key": dict(dead), "lin_query": dict(dead),
                "lin_value": {"w": True, "b": True}, "lin_skip": dict(dead),
                "weight": False, "bias": False, "nodewise_weights": False,
                "increase_dim": beta, "map_weights": cfg.use_beta}

    def like(tree, value):
        if isinstance(tree, dict):
            return {k: like(v, value) for k, v in tree.items()}
        return value

    params = raindrop_init(None, cfg, device="meta")
    mask = {
        "R_u": True,
        "encoder": like(params["encoder"], False),
        "ob_propagation": prop_mask(),
        "ob_propagation_layer2": prop_mask(),
        "transformer_encoder": like(params["transformer_encoder"], True),
        "mlp_static": like(params["mlp_static"], True),
    }
    if cfg.static:
        mask["emb"] = like(params["emb"], True)
    return mask


def _refuse(cfg: RaindropConfig, global_adj, scale_out: bool):
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


def raindrop_apply(
    params,
    cfg: RaindropConfig,
    src: torch.Tensor,                      # [T, B, 2F]
    static: Optional[torch.Tensor],         # [B, d_static] or None
    times: torch.Tensor,                    # [T, B]
    lengths: torch.Tensor,                  # [B]
    *,
    train: bool = False,
    seeds: Optional[DropoutSeeds] = None,
    global_adj: Optional[torch.Tensor] = None,
    context_parallel: str = "none",
    pipeline_parallel: int = 0,
    edge_partition: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass. Returns (logits [B, n_classes], distance scalar).
    train=True needs `seeds` when the config has any dropout."""
    _refuse(cfg, global_adj,
            context_parallel != "none" or bool(pipeline_parallel) or edge_partition)
    if train and seeds is None and (cfg.dropout > 0.0 or cfg.prop_dropout > 0.0):
        raise ValueError("train=True with dropout needs seeds=DropoutSeeds "
                         "(DropoutSeeds.draw(generator, cfg.nlayers))")
    if not train:
        seeds = None
    F_, d_ob, T = cfg.d_inp, cfg.d_ob, cfg.max_len
    dtype = _dtype(cfg)
    values = src[:, :, :F_].to(dtype)                     # [T, B, F]
    B = values.shape[1]

    # sensor-level gated embedding: repeat_interleave by d_ob, times R_u
    h = torch.relu(values.repeat_interleave(d_ob, dim=-1) * params["R_u"])
    pe = time_positional_encoding(times, cfg.d_pe, T, dtype)   # [T, B, d_pe]
    if seeds is not None:   # on the time-major tensor, as the hash indexes it
        h = dropout(seeds.embed, h, cfg.dropout, train)
    h_b = h.transpose(0, 1)                                # [B, T, F*d_ob]
    pe_b = pe.transpose(0, 1)                              # [B, T, d_pe]

    # two propagation layers on the complete all-ones graph; layer 2's
    # edge weights are layer 1's pre-softmax alpha, the same ones
    x_nodes = _to_node_features(h_b, F_, d_ob)             # [B, F, T*d_ob]
    adj = torch.ones((F_, F_), dtype=dtype, device=src.device)
    prop = dict(dropout_rate=cfg.prop_dropout, train=train, uniform=True)
    out1, alpha1 = ob_propagate_dense_complete(
        params["ob_propagation"], x_nodes, adj,
        seed=None if seeds is None else seeds.prop1, **prop)
    out2, alpha_all = ob_propagate_dense_complete(
        params["ob_propagation_layer2"], out1, alpha1.reshape(B, F_, F_),
        seed=None if seeds is None else seeds.prop2, **prop)
    distance = alpha_pairwise_distance(alpha_all)
    output = _from_node_features(out2, T, d_ob)            # [B, T, F*d_ob]
    output = torch.cat([output, pe_b], dim=-1)             # [B, T, F*d_ob+d_pe]

    mask = padding_mask(lengths, T)                        # [B, T] True = pad
    r_out = transformer_encoder_apply(
        params["transformer_encoder"], output, mask, cfg.nhead,
        dropout_rate=cfg.dropout, train=train,
        backend=cfg.attention_backend,
        score_dtype=cfg.attention_score_dtype,
        seeds=None if seeds is None else seeds.layers)

    pooled = masked_mean_pool(r_out, lengths)
    if cfg.static and static is not None:
        emb = linear_apply(params["emb"], static.to(dtype))
        pooled = torch.cat([pooled, emb], dim=1)
    return mlp_apply(params["mlp_static"], pooled), distance
