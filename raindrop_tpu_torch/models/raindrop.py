"""Raindrop (v2) forward (port of raindrop_tpu/models/raindrop.py).

The serving and training path: the sensor-level embedding, two layers of
graph propagation, the time PE, the temporal encoder, masked mean pooling,
the static embedding and the MLP head. Parameters are nested dicts of
tensors with the JAX package's tree and layouts (nn/*, bridge.py).

Graph propagation runs on the complete sensor graph with per-edge weights
`global_adj` [F, F] (default all ones; a zero is a logit of 0, not a
missing edge), by one of three branches (`prop_branch`):
  * 'dense'  (no global_adj, prop_backend other than 'coo'): with all-ones
    weights the layer reduces to relu(lin_value(x)); with use_beta the
    whole two-layer block of graph/propagate.raindrop_propagate_beta_dense
    (time-conditioned edge attention, top-50% pruning);
  * 'pallas' (prop_backend 'pallas', no use_beta): the sparse-graph
    kernels of ops/sparse.py, on the card the hand-written CUDA SpMM +
    segment softmax, in f32 whatever the compute dtype; softmax-weight
    dropout in training is not in the kernel, so such a step falls through
    to 'dense' (no global_adj) or 'coo'; use_beta's per-sample pruned
    edges do not fit the kernel's shared topology and take the same way;
  * 'coo'    (prop_backend 'coo', or a global_adj without 'pallas'): the
    segment ops of ops/segment.py over the edge list (use_beta: each
    sample's kept edges).

Precision: parameters are stored in `cfg.dtype`; with `compute_dtype` the
forward casts the live leaves to it (`compute_params`: the gradient of the
cast casts back, so master parameters and gradients stay in `cfg.dtype`)
and returns logits and distance in `cfg.dtype`. A product of two dtypes
runs in the promoted one, as in JAX: after the flash kernels' f32 output
an unfused encoder layer continues in f32.

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

On a mesh (`mesh`, parallel/mesh.py) each rank runs its rows of the
global batch: every dropout mask hashes at the rows' global coordinates
(the per-sample seeds of the COO branch are the global batch's, cut to
the rank's rows), and the alpha distance is taken over the global batch
(the rows' alphas gathered over the data axis). On a model axis the
encoder runs Megatron's split (nn/transformer.py) and each propagation
layer's lin_value is column-parallel, its output gathered whole. The
logits are the rank's rows.

The scale-out routes (the JAX package's, over the mesh's model axis; each
needs a mesh, world size 1 included): `context_parallel` 'sp' | 'ring'
splits the temporal attention's T axis (parallel/sequence.py),
`pipeline_parallel` > 0 runs the encoder layers as GPipe stages with that
many microbatches (parallel/pipeline.py), `edge_partition` splits the
propagation's edges (parallel/edge_partition.py: two layers of
relu(lin_value) and the segment softmax over the rank's edges in f32,
alpha the pre-softmax edge weights, the encoder on its rung; not with
use_beta or with propagation dropout in training, which take the other
branches). Under a route tensor parallelism's split is off: the
parameters are whole on every rank and everything outside the route runs
as on one device on the rank's rows.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.graph.propagate import (
    alpha_pairwise_distance, lin_value, ob_propagate_coo, ob_propagate_dense_complete,
    ob_propagation_init, raindrop_propagate_beta_dense)
from raindrop_tpu_torch.graph.structure import complete_graph_edges
from raindrop_tpu_torch.nn.aggregate import (
    masked_mean_pool, padding_mask, sensor_wise_pool)
from raindrop_tpu_torch.nn.init import glorot, tiny_uniform, torch_linear_params
from raindrop_tpu_torch.nn.linear import linear_apply, mlp_apply, mlp_init
from raindrop_tpu_torch.nn.transformer import (
    transformer_encoder_apply, transformer_encoder_init)
from raindrop_tpu_torch.ops.pe import time_positional_encoding
from raindrop_tpu_torch.ops.sparse import spmm_segment_softmax, topology
from raindrop_tpu_torch.parallel import tensor as tp
from raindrop_tpu_torch.parallel.edge_partition import (
    edge_shard, spmm_segment_softmax_sharded)
from raindrop_tpu_torch.parallel.mesh import Shard, data_only
from raindrop_tpu_torch.parallel.pipeline import pipeline_transformer_encoder
from raindrop_tpu_torch.utils.dropout import DropoutSeeds, dropout


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (config.FLOAT_DTYPES)."""
    return _TORCH_DTYPES[name]


def compute_dtype(cfg: RaindropConfig) -> torch.dtype:
    """The dtype the forward runs in: compute_dtype, else the storage dtype."""
    return torch_dtype(cfg.compute_dtype or cfg.dtype)


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
    dtype = torch_dtype(cfg.dtype)
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
    propagation layer but lin_value, and with use_beta the first layer's
    increase_dim and map_weights too: the second layer runs without beta,
    as in the reference) get no gradient, so the optimizer must never
    touch them. The JAX package's mask marks the second layer's beta
    weights live; their gradient is zero there, so Adam leaves them as they
    are and the two trainers agree. Built from the config alone: no tensor
    is made (a tree of shapes on the meta device would be the first meta
    arithmetic of a process, which on some torch builds keeps the frames
    then on the stack, and so the first Trainer, alive)."""
    def linear(value):
        return {"w": value, "b": value}

    def prop_mask(beta):
        return {"lin_key": linear(False), "lin_query": linear(False),
                "lin_value": linear(True), "lin_skip": linear(False),
                "weight": False, "bias": False, "nodewise_weights": False,
                "increase_dim": linear(beta), "map_weights": beta}

    def layer_mask():   # nn/transformer._layer_init's tree
        return {"in_proj_w": True, "in_proj_b": True, "out_proj": linear(True),
                "lin1": linear(True), "lin2": linear(True),
                "ln1": {"scale": True, "bias": True},
                "ln2": {"scale": True, "bias": True}}

    mask = {
        "R_u": True,
        "encoder": linear(False),
        "ob_propagation": prop_mask(cfg.use_beta),
        "ob_propagation_layer2": prop_mask(False),
        "transformer_encoder": {f"layer{i}": layer_mask() for i in range(cfg.nlayers)},
        "mlp_static": {f"lin{i}": linear(True) for i in range(2)},
    }
    if cfg.static:
        mask["emb"] = linear(True)
    return mask


def compute_params(params, cfg: RaindropConfig):
    """The tree the forward reads: the live leaves (`raindrop_param_mask`)
    cast to the compute dtype, the dead ones as they are. The JAX forward
    casts the whole tree and its compiler drops the dead casts; eager
    PyTorch would read and copy them (most of the tree at a 2048-step
    window). A leaf already in the compute dtype is itself, so a tree cast
    once (as `InferenceServer` keeps it) passes through unchanged."""
    dt = compute_dtype(cfg)
    if dt == torch_dtype(cfg.dtype):
        return params

    def walk(tree, mask):
        if isinstance(tree, dict):
            return {k: walk(v, mask[k]) for k, v in tree.items()}
        return tree.to(dt) if mask and tree.is_floating_point() else tree

    return walk(params, raindrop_param_mask(cfg))


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
    """Which propagation branch a forward takes: 'pallas', 'dense' or 'coo'
    (with use_beta, 'dense' is the dense beta block)."""
    if cfg.prop_backend not in ("auto", "coo", "pallas"):
        raise ValueError(f"prop_backend must be 'auto', 'coo' or 'pallas', "
                         f"got {cfg.prop_backend!r}")
    if (cfg.prop_backend == "pallas" and not cfg.use_beta
            and not (train and cfg.prop_dropout > 0.0)):
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


def check_routes(context_parallel: str, pipeline_parallel: int,
                 edge_partition: bool, mesh) -> bool:
    """The JAX package's refusals of a combination of scale-out routes;
    True when any route is on."""
    if context_parallel not in ("none", "sp", "ring"):
        raise ValueError(f"context_parallel must be 'none', 'sp' or 'ring', "
                         f"got {context_parallel!r}")
    if context_parallel != "none" and pipeline_parallel:
        raise ValueError("context_parallel and pipeline_parallel both "
                         "claim the temporal transformer; pick one")
    route = context_parallel != "none" or bool(pipeline_parallel) or edge_partition
    if route and mesh is None:
        raise ValueError("scale-out routes need a mesh "
                         "(parallel.make_mesh(n_data, n_model))")
    return route


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
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass. Returns (logits [B, n_classes], distance scalar).
    train=True needs `seeds` when the config has any dropout; `global_adj`
    [F, F] is a tensor on the parameters' device. On a `mesh` the inputs
    are this rank's rows of the global batch and `params` its part of the
    tree (parallel/mesh.shard_params), or under a scale-out route the
    whole tree."""
    route = check_routes(context_parallel, pipeline_parallel, edge_partition, mesh)
    if train and seeds is None and (cfg.dropout > 0.0 or cfg.prop_dropout > 0.0):
        raise ValueError("train=True with dropout needs seeds=DropoutSeeds "
                         "(DropoutSeeds.draw(generator, cfg.nlayers))")
    if not train:
        seeds = None
    F_, d_ob, T = cfg.d_inp, cfg.d_ob, cfg.max_len
    params = compute_params(params, cfg)
    dtype = compute_dtype(cfg)
    values = src[:, :, :F_].to(dtype)                     # [T, B, F]
    observed = src[:, :, F_:2 * F_].to(dtype)             # [T, B, F]
    B = values.shape[1]
    shard = Shard.of(mesh, B)
    if route:
        # the route's model axis (of one rank at world size 1); the rest of
        # the forward runs whole on every model rank, on the rank's rows
        axis, shard = shard or Shard(0, B), data_only(shard)
    rows = None if shard is None else (shard.b0, shard.batch)
    if shard is not None and shard.n_model > 1:
        # propagation's lin_value column-parallel, its output gathered
        def column(p):
            return {**p, "lin_value": lambda x, w=p["lin_value"]:
                    tp.column_parallel_linear(w, x, shard)}
        params = {**params, "ob_propagation": column(params["ob_propagation"]),
                  "ob_propagation_layer2": column(params["ob_propagation_layer2"])}

    # sensor-level gated embedding: repeat_interleave by d_ob, times R_u
    h = torch.relu(values.repeat_interleave(d_ob, dim=-1) * params["R_u"])
    pe = time_positional_encoding(times, cfg.d_pe, T, dtype)   # [T, B, d_pe]
    if seeds is not None:   # on the time-major tensor, as the hash indexes it
        if rows is None:
            h = dropout(seeds.embed, h, cfg.dropout, train)
        else:
            h = dropout(seeds.embed, h, cfg.dropout, train, origin=(0, rows[0], 0),
                        full_shape=(T, rows[1], h.shape[2]))
    h_b = h.transpose(0, 1)                                # [B, T, F*d_ob]
    pe_b = pe.transpose(0, 1)                              # [B, T, d_pe]

    # two propagation layers; layer 2's edge weights are layer 1's
    # pre-softmax alpha, which are the input edge weights again
    x_nodes = _to_node_features(h_b, F_, d_ob)             # [B, F, T*d_ob]
    branch = prop_branch(cfg, train, global_adj is not None)
    if edge_partition and not cfg.use_beta and not (train and cfg.prop_dropout > 0.0):
        branch = "edge_partition"
    p1, p2 = params["ob_propagation"], params["ob_propagation_layer2"]
    if branch == "edge_partition":
        # the sensor graph's edges split over the model axis: each rank's
        # segment softmax and partial sums, combined by collectives
        f32 = torch.float32
        e_src, e_dst, edge_weights = _edge_list(F_, global_adj, dtype, src.device)
        gamma = edge_weights[None].expand(B, -1).to(f32)
        e_src, e_dst, gamma_loc = edge_shard(e_src, e_dst, gamma, axis)
        v1 = torch.relu(lin_value(p1, x_nodes)).to(f32)
        out1, _ = spmm_segment_softmax_sharded(v1, gamma_loc, e_src, e_dst, axis,
                                               gather_target=True)
        v2 = torch.relu(lin_value(p2, out1.to(dtype))).to(f32)
        out2, _ = spmm_segment_softmax_sharded(v2, gamma_loc, e_src, e_dst, axis,
                                               gather_target=True)
        out2 = out2.to(dtype)
        alpha_all = gamma.to(dtype)                         # pre-softmax alpha
    elif branch == "pallas":
        # each layer is the use_beta=False step on the kernel: messages
        # gather the TARGET's features, the softmax groups by target; the
        # kernel runs in f32, cast around it as the JAX model does
        f32 = torch.float32
        e_src, e_dst, edge_weights = _edge_list(F_, global_adj, dtype, src.device)
        gamma = edge_weights[None].expand(B, -1).to(f32)    # read in place
        v1 = torch.relu(lin_value(p1, x_nodes)).to(f32)
        out1, _ = spmm_segment_softmax(v1, gamma, e_src, e_dst, n_nodes=F_,
                                       gather_target=True)
        v2 = torch.relu(lin_value(p2, out1.to(dtype))).to(f32)
        out2, _ = spmm_segment_softmax(v2, gamma, e_src, e_dst, n_nodes=F_,
                                       gather_target=True)
        out2 = out2.to(dtype)
        alpha_all = gamma.to(dtype)                         # pre-softmax alpha
    elif branch == "dense" and cfg.use_beta:
        # the whole beta block at once, its softmax factored on the
        # all-ones graph (the [B, s, t, D] grid only under prop dropout)
        beta_seeds = None
        if seeds is not None and cfg.prop_dropout > 0.0:
            if len(seeds.beta) != 2:
                raise ValueError(
                    "the dense use_beta block drops softmax weights with two "
                    "seeds: DropoutSeeds.draw(generator, nlayers, beta=True)")
            beta_seeds = seeds.beta
        adj = torch.ones((F_, F_), dtype=dtype, device=src.device)
        out2, alpha_all = raindrop_propagate_beta_dense(
            p1, p2, x_nodes, pe_b, adj, ob_dim=d_ob,
            dropout_rate=cfg.prop_dropout, seeds=beta_seeds, train=train,
            uniform_adj=True, rows=rows)
    elif branch == "dense":
        adj = torch.ones((F_, F_), dtype=dtype, device=src.device)
        prop = dict(dropout_rate=cfg.prop_dropout, train=train, uniform=True,
                    rows=rows)
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
            Bg = B if shard is None else shard.batch
            if len(rows1) != Bg or len(rows2) != Bg:
                raise ValueError(
                    f"the COO branch drops softmax weights with one seed per "
                    f"sample: DropoutSeeds.draw(generator, nlayers, rows={Bg})")
            if shard is not None:       # the global batch's seeds, these rows'
                rows1 = rows1[shard.b0:shard.b0 + B]
                rows2 = rows2[shard.b0:shard.b0 + B]
        prop = dict(ob_dim=d_ob, n_nodes=F_, dropout_rate=cfg.prop_dropout,
                    train=train)
        edge_index = torch.stack([e_src, e_dst])
        # with use_beta, layer 1 prunes each sample to its own E//2 edges
        # and hands layer 2 their edge lists and mean gamma [B, E//2]
        out1, (ei2, a1) = ob_propagate_coo(p1, x_nodes, pe_b, edge_index,
                                           edge_weights, use_beta=cfg.use_beta,
                                           seed=rows1, **prop)
        out2, (_, a2) = ob_propagate_coo(p2, out1, pe_b, ei2,
                                         a1 if cfg.use_beta else a1[..., 0],
                                         seed=rows2, **prop)
        alpha_all = a2[..., 0]                              # [B, E or E//2]
    if shard is not None and shard.data_group is not None:
        # over the global batch; each rank's copy of the distance reaches
        # its own rows' alphas only, so their gradient counts n_data times
        alpha_all = tp.gather_dim(alpha_all, shard.data_rank, shard.n_data,
                                  shard.data_group, 0, grad_scale=shard.n_data)
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
    if pipeline_parallel:
        r_out = pipeline_transformer_encoder(
            params["transformer_encoder"], output, mask, cfg.nhead, pipeline_parallel,
            axis, dropout_rate=cfg.dropout, train=train,
            seeds=None if seeds is None else seeds.pipeline)
    else:
        cp = context_parallel != "none"
        r_out = transformer_encoder_apply(
            params["transformer_encoder"], output, mask, cfg.nhead,
            dropout_rate=cfg.dropout, train=train,
            backend=context_parallel if cp else cfg.attention_backend,
            score_dtype=cfg.attention_score_dtype,
            seeds=None if seeds is None else seeds.layers,
            shard=axis if cp else shard)

    if cfg.sensor_wise_mask:
        pooled = sensor_wise_pool(r_out.reshape(B, T, F_, d_ob + cfg.d_pe),
                                  observed.transpose(0, 1))
    else:
        pooled = masked_mean_pool(r_out, lengths)
    if cfg.static and static is not None:
        emb = linear_apply(params["emb"], static.to(dtype))
        dt = torch.promote_types(pooled.dtype, emb.dtype)  # as jnp.concatenate
        pooled = torch.cat([pooled.to(dt), emb.to(dt)], dim=1)
    logits = mlp_apply(params["mlp_static"], pooled)
    if cfg.compute_dtype is not None:
        # loss and metrics in the storage dtype whatever the compute dtype
        out_dtype = torch_dtype(cfg.dtype)
        logits, distance = logits.to(out_dtype), distance.to(out_dtype)
    return logits, distance
