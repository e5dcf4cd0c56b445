"""Raindrop (v2) forward (port of raindrop_tpu/models/raindrop.py).

The serving and training path: the sensor-level embedding, two layers of
graph propagation, the time PE, the temporal encoder, masked mean pooling,
the static embedding and the MLP head. Parameters are nested dicts of
tensors with the JAX package's tree and layouts (nn/*, bridge.py).

Graph propagation runs on the complete sensor graph with per-edge weights
`global_adj` [F, F] (default all ones; a zero is a logit of 0, not a
missing edge), by one of three branches (`prop_branch`):
  * 'dense'  (prop_backend 'auto', no global_adj): with all-ones weights
    the layer reduces to relu(lin_value(x));
  * 'pallas' (prop_backend 'pallas'): the sparse-graph kernels of
    ops/sparse.py, on the card the hand-written CUDA SpMM + segment
    softmax; softmax-weight dropout in training is not in the kernel, so
    such a step falls through to 'dense' (no global_adj) or 'coo';
  * 'coo'    (prop_backend 'coo', or a global_adj without 'pallas'): the
    segment ops of ops/segment.py over the edge list.

With `sensor_wise_mask` the time PE joins each sensor's embedding (the
encoder runs at d_inp * (d_ob + d_pe)) and the pooling is per sensor,
weighted by the observed mask (nn/aggregate.sensor_wise_pool).

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
slice that brings it: use_beta, compute_dtype and the scale-out routes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.graph.propagate import (
    alpha_pairwise_distance, ob_propagate_coo, ob_propagate_dense_complete,
    ob_propagation_init)
from raindrop_tpu_torch.graph.structure import complete_graph_edges
from raindrop_tpu_torch.nn.aggregate import (
    masked_mean_pool, padding_mask, sensor_wise_pool)
from raindrop_tpu_torch.nn.init import glorot, tiny_uniform, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.nn.transformer import (
    transformer_encoder_apply, transformer_encoder_init)
from raindrop_tpu_torch.ops.pe import time_positional_encoding
from raindrop_tpu_torch.ops.sparse import spmm_segment_softmax, topology
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
    so the optimizer must never touch them. Built from the config alone: no
    tensor is made (a tree of shapes on the meta device would be the first
    meta arithmetic of a process, which on some torch builds keeps the
    frames then on the stack, and so the first Trainer, alive)."""
    def linear(value):
        return {"w": value, "b": value}

    def prop_mask():
        beta = linear(cfg.use_beta)
        return {"lin_key": linear(False), "lin_query": linear(False),
                "lin_value": linear(True), "lin_skip": linear(False),
                "weight": False, "bias": False, "nodewise_weights": False,
                "increase_dim": beta, "map_weights": cfg.use_beta}

    def layer_mask():   # nn/transformer._layer_init's tree
        return {"in_proj_w": True, "in_proj_b": True, "out_proj": linear(True),
                "lin1": linear(True), "lin2": linear(True),
                "ln1": {"scale": True, "bias": True},
                "ln2": {"scale": True, "bias": True}}

    mask = {
        "R_u": True,
        "encoder": linear(False),
        "ob_propagation": prop_mask(),
        "ob_propagation_layer2": prop_mask(),
        "transformer_encoder": {f"layer{i}": layer_mask() for i in range(cfg.nlayers)},
        "mlp_static": {f"lin{i}": linear(True) for i in range(2)},
    }
    if cfg.static:
        mask["emb"] = linear(True)
    return mask


def _complete_edges(F_: int, device):
    """(src, dst) [F*F] int64 of the complete graph in source-major order,
    the same two tensors on every call so ops/sparse.py sorts them once."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:   # 'cuda' is 'cuda:N'
        device = torch.device("cuda", torch.cuda.current_device())
    return _complete_edges_on(F_, device)


@functools.lru_cache(maxsize=16)
def _complete_edges_on(F_: int, device: torch.device):
    edge_index, _ = complete_graph_edges(F_)
    ei = torch.from_numpy(edge_index).to(device, torch.int64)
    return ei[0].contiguous(), ei[1].contiguous()


def _edge_list(F_: int, global_adj, dtype, device):
    """The complete graph's (src, dst) and per-edge weights [F*F]: from
    global_adj when given, else ones. Shared by the COO and kernel
    branches, so their inputs are the same by construction."""
    src, dst = _complete_edges(F_, device)
    if global_adj is not None:
        if tuple(global_adj.shape) != (F_, F_):
            raise ValueError(f"global_adj must be [{F_}, {F_}], got "
                             f"{tuple(global_adj.shape)}")
        return src, dst, global_adj[src, dst].to(dtype)
    return src, dst, torch.ones((F_ * F_,), dtype=dtype, device=device)


def prop_branch(cfg: RaindropConfig, train: bool, has_global_adj: bool) -> str:
    """Which propagation branch a forward takes: 'pallas', 'dense' or 'coo'."""
    if cfg.prop_backend not in ("auto", "coo", "pallas"):
        raise ValueError(f"prop_backend must be 'auto', 'coo' or 'pallas', "
                         f"got {cfg.prop_backend!r}")
    if cfg.prop_backend == "pallas" and not (train and cfg.prop_dropout > 0.0):
        return "pallas"
    if not has_global_adj and cfg.prop_backend != "coo":
        return "dense"
    return "coo"


def warm_propagation(cfg: RaindropConfig, device) -> None:
    """Sort the sensor graph for the kernels now (ops/sparse.topology: two
    sorts and one host sync, cached) and not inside the first forward.
    Nothing to do off the card or off the kernel branch."""
    device = torch.device(device)
    if device.type == "cuda" and prop_branch(cfg, False, False) == "pallas":
        topology(*_complete_edges(cfg.d_inp, device), cfg.d_inp)


def _refuse(cfg: RaindropConfig, scale_out: bool):
    if scale_out:
        raise NotImplementedError(
            "context_parallel, pipeline_parallel and edge_partition come "
            "with the scale-out slice")
    if cfg.use_beta:
        raise NotImplementedError(
            "use_beta (time-conditioned edge attention and pruning) comes "
            "with a later capability slice")
    if cfg.compute_dtype is not None and cfg.compute_dtype != cfg.dtype:
        raise NotImplementedError(
            "compute_dtype comes with the mixed-precision slice")


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
    train=True needs `seeds` when the config has any dropout; `global_adj`
    [F, F] is a tensor on the parameters' device."""
    _refuse(cfg, context_parallel != "none" or bool(pipeline_parallel) or edge_partition)
    if train and seeds is None and (cfg.dropout > 0.0 or cfg.prop_dropout > 0.0):
        raise ValueError("train=True with dropout needs seeds=DropoutSeeds "
                         "(DropoutSeeds.draw(generator, cfg.nlayers))")
    if not train:
        seeds = None
    F_, d_ob, T = cfg.d_inp, cfg.d_ob, cfg.max_len
    dtype = _dtype(cfg)
    values = src[:, :, :F_].to(dtype)                     # [T, B, F]
    observed = src[:, :, F_:2 * F_].to(dtype)             # [T, B, F]
    B = values.shape[1]

    # sensor-level gated embedding: repeat_interleave by d_ob, times R_u
    h = torch.relu(values.repeat_interleave(d_ob, dim=-1) * params["R_u"])
    pe = time_positional_encoding(times, cfg.d_pe, T, dtype)   # [T, B, d_pe]
    if seeds is not None:   # on the time-major tensor, as the hash indexes it
        h = dropout(seeds.embed, h, cfg.dropout, train)
    h_b = h.transpose(0, 1)                                # [B, T, F*d_ob]
    pe_b = pe.transpose(0, 1)                              # [B, T, d_pe]

    # two propagation layers; layer 2's edge weights are layer 1's
    # pre-softmax alpha, which are the input edge weights again
    x_nodes = _to_node_features(h_b, F_, d_ob)             # [B, F, T*d_ob]
    branch = prop_branch(cfg, train, global_adj is not None)
    p1, p2 = params["ob_propagation"], params["ob_propagation_layer2"]
    if branch == "pallas":
        # each layer is the use_beta=False step on the kernel: messages
        # gather the TARGET's features, the softmax groups by target
        e_src, e_dst, edge_weights = _edge_list(F_, global_adj, dtype, src.device)
        gamma = edge_weights[None].expand(B, -1)            # read in place
        v1 = torch.relu(linear_apply(p1["lin_value"], x_nodes))
        out1, _ = spmm_segment_softmax(v1, gamma, e_src, e_dst, n_nodes=F_,
                                       gather_target=True)
        v2 = torch.relu(linear_apply(p2["lin_value"], out1))
        out2, _ = spmm_segment_softmax(v2, gamma, e_src, e_dst, n_nodes=F_,
                                       gather_target=True)
        alpha_all = gamma                                   # pre-softmax alpha
    elif branch == "dense":
        adj = torch.ones((F_, F_), dtype=dtype, device=src.device)
        prop = dict(dropout_rate=cfg.prop_dropout, train=train, uniform=True)
        out1, alpha1 = ob_propagate_dense_complete(
            p1, x_nodes, adj, seed=None if seeds is None else seeds.prop1, **prop)
        out2, alpha_all = ob_propagate_dense_complete(
            p2, out1, alpha1.reshape(B, F_, F_),
            seed=None if seeds is None else seeds.prop2, **prop)
    else:
        e_src, e_dst, edge_weights = _edge_list(F_, global_adj, dtype, src.device)
        rows1 = rows2 = None
        if seeds is not None and cfg.prop_dropout > 0.0:
            rows1, rows2 = seeds.prop1_rows, seeds.prop2_rows
            if len(rows1) != B or len(rows2) != B:
                raise ValueError(
                    f"the COO branch drops softmax weights with one seed per "
                    f"sample: DropoutSeeds.draw(generator, nlayers, rows={B})")
        prop = dict(ob_dim=d_ob, n_nodes=F_, dropout_rate=cfg.prop_dropout,
                    train=train)
        edge_index = torch.stack([e_src, e_dst])
        out1, (_, a1) = ob_propagate_coo(p1, x_nodes, None, edge_index,
                                         edge_weights, seed=rows1, **prop)
        out2, (_, a2) = ob_propagate_coo(p2, out1, None, edge_index,
                                         a1[..., 0], seed=rows2, **prop)
        alpha_all = a2[..., 0]                              # [B, F*F]
    distance = alpha_pairwise_distance(alpha_all)
    output = _from_node_features(out2, T, d_ob)            # [B, T, F*d_ob]
    if cfg.sensor_wise_mask:
        # the time PE beside each sensor's embedding: [B, T, F*(d_ob+d_pe)]
        ext_pe = pe_b[:, :, None, :].expand(B, T, F_, cfg.d_pe)
        output = torch.cat([output.reshape(B, T, F_, d_ob), ext_pe],
                           dim=-1).reshape(B, T, F_ * (d_ob + cfg.d_pe))
    else:
        output = torch.cat([output, pe_b], dim=-1)         # [B, T, F*d_ob+d_pe]

    mask = padding_mask(lengths, T)                        # [B, T] True = pad
    r_out = transformer_encoder_apply(
        params["transformer_encoder"], output, mask, cfg.nhead,
        dropout_rate=cfg.dropout, train=train,
        backend=cfg.attention_backend,
        score_dtype=cfg.attention_score_dtype,
        seeds=None if seeds is None else seeds.layers)

    if cfg.sensor_wise_mask:
        pooled = sensor_wise_pool(r_out.reshape(B, T, F_, d_ob + cfg.d_pe),
                                  observed.transpose(0, 1))
    else:
        pooled = masked_mean_pool(r_out, lengths)
    if cfg.static and static is not None:
        emb = linear_apply(params["emb"], static.to(dtype))
        pooled = torch.cat([pooled, emb], dim=1)
    return mlp_apply(params["mlp_static"], pooled), distance
