"""Temporal transformer encoder (port of raindrop_tpu/nn/transformer.py).

Post-LN torch TransformerEncoderLayer semantics, built by hand over a
parameter dict: `torch.nn.TransformerEncoder` gives NaN on samples whose
keys are all padded, where this encoder gives zero attention. Layout
[B, T, d] inside the encoder. In training each layer takes a `LayerSeeds`
(utils/dropout.py): the dense rung drops the attention probabilities
[B, H, T, T] and the three sites of the unfused layer with the counter-hash
dropout, the flash and fused-layer rungs hand their int32 seed to the
kernels. Without seeds, or in eval, the rate is 0.

The context-parallel backends 'sp' and 'ring' (parallel/sequence.py) split
the attention's T axis over the model axis of the rank's `Shard`: the
rank projects its T rows of q, k and v from the input (whole on every
model rank, entering through `copy_to`), runs sequence-parallel or ring
attention on them with the JAX package's seed draw (LayerSeeds.kernel,
the flash rung's), and the output is gathered over T before out_proj; the
LayerNorms and the FFN run as on one device, on the rank's rows of the
batch. Under these backends tensor parallelism's split is off: the
layer's parameters are whole on every rank. Without a shard they raise,
as the JAX package does without a mesh.

On a mesh (parallel/mesh.py) a layer takes its rank's `Shard`: the
rank's rows b0.. of the global batch, and on a model axis of n ranks its
part of the heads and of the FFN, Megatron's split:
  * in_proj (column-parallel, this rank's heads' rows of q, k and v) ->
    attention on its nhead / n heads -> out_proj (row-parallel) and one
    all_reduce; lin1 (column-parallel) -> relu -> lin2 (row-parallel)
    and one all_reduce; each column-parallel input all_reduces its
    gradient in the backward (parallel/tensor.py). The packed rung
    launches flash_mha_packed on the rank's heads, the dense rung runs
    them in PyTorch;
  * the fused rung does attention, both LayerNorms and the FFN in one
    kernel, with no point between its products at which partial sums
    could be reduced. There every model rank gathers the layer's split
    weights and runs the fused kernel whole, as GSPMD runs a pallas_call
    under sharded inputs: the forward is the one-device layer's on the
    rank's rows, and the gradient a rank keeps of a split weight is its
    slice of the full weight's gradient (which every rank computes).
Every dropout mask hashes its elements at their global coordinates (the
batch row, the head, the FFN column), so the ranks together drop what
the one-device layer drops.

Encoder ladder. `backend="auto"` on a CUDA tensor keeps the JAX package's
structure and thresholds: the fused-layer kernel when d % nhead == 0,
T >= 384 and T (padded to 8) <= 1024; flash attention at every other
T >= 128; dense below. The flash rung runs the packed-heads kernel while
T (padded to 8) <= 1024 and the split-head `flash_mha` beyond ('flash_mha'
in `encoder_rung`'s words). The thresholds are the JAX package's, measured
on a TPU v5e, not on the H100: the card's own crossover is an open
question (PERF.md). On a CPU tensor `auto` is dense, as the JAX ladder is
off the TPU. An explicit "dense" | "flash" | "fused_layer" works on both
devices (on the CPU the kernels' plain versions run); "fused_layer" beyond
T = 1024 raises, as in the JAX package. The fused rung takes every width
the JAX kernel takes: its kernels' launch plan has a route for any d
divisible by nhead, any ffn and head dim (ops/fused_encoder.py
fused_plan; P12's sensor-wise d = 720 at T = 600 on its "stream" route).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from raindrop_tpu_torch.nn.init import torch_linear_params, xavier_uniform
from raindrop_tpu_torch.nn.linear import linear_apply, promoted
from raindrop_tpu_torch.ops.flash_attention import (
    MAX_FUSED_T, flash_mha, flash_mha_packed)
from raindrop_tpu_torch.ops.fused_encoder import fused_encoder_layer
from raindrop_tpu_torch.parallel import tensor as tp
from raindrop_tpu_torch.parallel.mesh import Shard, data_only, shard_blocks
from raindrop_tpu_torch.parallel.sequence import (
    ring_attention, sequence_parallel_attention, time_shard)
from raindrop_tpu_torch.utils.dropout import LayerSeeds, dropout

CONTEXT_PARALLEL = ("sp", "ring")
BACKENDS = ("auto", "dense", "flash", "fused_layer") + CONTEXT_PARALLEL


def _layer_init(gen, d_model: int, ffn_dim: int, device="cuda",
                dtype=torch.float32):
    out_proj = torch_linear_params(gen, d_model, d_model, device, dtype)
    out_proj["b"] = torch.zeros((d_model,), dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones((d_model,), dtype=dtype, device=device),
                "bias": torch.zeros((d_model,), dtype=dtype, device=device)}

    return {
        "in_proj_w": xavier_uniform(gen, (3 * d_model, d_model), device, dtype),
        "in_proj_b": torch.zeros((3 * d_model,), dtype=dtype, device=device),
        "out_proj": out_proj,
        "lin1": torch_linear_params(gen, d_model, ffn_dim, device, dtype),
        "lin2": torch_linear_params(gen, ffn_dim, d_model, device, dtype),
        "ln1": ln(),
        "ln2": ln(),
    }


def transformer_encoder_init(gen, d_model: int, nhead: int, ffn_dim: int,
                             num_layers: int, device="cuda",
                             dtype=torch.float32):
    if d_model % nhead:
        raise ValueError(f"d_model={d_model} not divisible by nhead={nhead}")
    return {f"layer{i}": _layer_init(gen, d_model, ffn_dim, device, dtype)
            for i in range(num_layers)}


def _layer_norm(p, x, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _lengths(key_padding_mask, B, T, device):
    # key_padding_mask marks t >= length (a contiguous suffix), so the
    # kernels take the prefix lengths
    if key_padding_mask is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return (~key_padding_mask).sum(dim=1).to(torch.int32)


def _score_dtype(score_dtype):
    return None if score_dtype in (None, "float32") else str(score_dtype)


def _refuse(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}")


def _drop(seed, x, rate, shard: Optional[Shard], split_axis=None):
    """dropout on a batch-major x of this rank: its rows at shard.b0 of
    shard.batch and, with split_axis, its part of that axis of the
    model-axis split; the one-device mask without a shard."""
    if shard is None:
        return dropout(seed, x, rate)
    origin, full = [0] * x.dim(), list(x.shape)
    origin[0], full[0] = shard.b0, shard.batch
    if split_axis is not None:
        origin[split_axis] = shard.model_rank * x.shape[split_axis]
        full[split_axis] = x.shape[split_axis] * shard.n_model
    return dropout(seed, x, rate, origin=origin, full_shape=full)


def _tp(shard: Optional[Shard]) -> bool:
    return shard is not None and shard.n_model > 1


def _kernel_origin(shard: Optional[Shard], nhead: int):
    """The kernels' dropout origin (b0, h0, H) of this rank's rows and
    heads (None off a mesh: the launch's own)."""
    if shard is None:
        return None
    if _tp(shard):
        h0, _ = shard.part(nhead)
        return shard.b0, h0, nhead
    return shard.b0, 0, nhead


def gathered_layer(p, shard: Shard):
    """The whole layer's weights from this rank's parts (the fused rung's
    input on a model axis): every split leaf gathered over the model
    group, its backward the rank's blocks of the full gradient."""
    n, m, g = shard.n_model, shard.model_rank, shard.model_group

    def whole(path, w, dim):
        shape = [s * n if a == dim else s for a, s in enumerate(w.shape)]
        return tp.gather(w, shard_blocks(path, shape, dim, n, m), dim, shape, g)

    out = dict(p)
    out["in_proj_w"] = whole(["in_proj_w"], p["in_proj_w"], 0)
    out["in_proj_b"] = whole(["in_proj_b"], p["in_proj_b"], 0)
    out["out_proj"] = {**p["out_proj"], "w": whole(["w"], p["out_proj"]["w"], 1)}
    out["lin1"] = {"w": whole(["w"], p["lin1"]["w"], 0),
                   "b": whole(["b"], p["lin1"]["b"], 0)}
    out["lin2"] = {**p["lin2"], "w": whole(["w"], p["lin2"]["w"], 1)}
    return out


def _fits(T: int) -> bool:
    return -(-T // 8) * 8 <= MAX_FUSED_T


def _attention_rung(backend: str, T: int, on_cuda: bool) -> str:
    """The attention of an unfused layer: 'flash' (the packed-heads
    kernel), 'flash_mha' (the split-head one, beyond the packed kernel's
    T), 'dense', or the context-parallel backend itself."""
    _refuse(backend)
    if backend in CONTEXT_PARALLEL:
        return backend
    if backend == "flash" or (backend == "auto" and on_cuda and T >= 128):
        return "flash" if _fits(T) else "flash_mha"
    return "dense"


def encoder_rung(backend: str, T: int, d: int, nhead: int, on_cuda: bool) -> str:
    """The rung of the ladder one layer takes: 'fused_layer', 'flash',
    'flash_mha', 'dense', 'sp' or 'ring'."""
    _refuse(backend)
    if d % nhead == 0 and (backend == "fused_layer" or (
            backend == "auto" and on_cuda and T >= 384 and _fits(T))):
        return "fused_layer"
    return _attention_rung(backend, T, on_cuda)


def _context_parallel(p, x, key_padding_mask, nhead, rate, seeds, backend,
                      shard: Optional[Shard]):
    """Attention with T split over the model axis (backend 'sp' | 'ring'):
    this rank's T rows of q, k, v, the attention of parallel/sequence.py,
    the output gathered over T, then out_proj."""
    if shard is None:
        raise ValueError(f"backend {backend!r} needs a mesh")
    B, T, d = x.shape
    hd = d // nhead
    t0, t_loc = time_shard(T, shard)
    xs = tp.copy_to(x, shard.model_group)[:, t0:t0 + t_loc]
    xw, w_in = promoted(xs, p["in_proj_w"])
    qkv = xw @ w_in.T + p["in_proj_b"]                      # [B, t_loc, 3d]

    def heads(t):  # [B, t_loc, d] -> [B, nhead, t_loc, hd]
        return t.reshape(B, t_loc, nhead, hd).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
    fn = sequence_parallel_attention if backend == "sp" else ring_attention
    out = fn(q, k, v, _lengths(key_padding_mask, B, T, x.device), shard,
             dropout_rate=rate, seed=seeds.kernel if rate > 0.0 else None)
    out = out.transpose(1, 2).reshape(B, t_loc, d)
    out = tp.gather_dim(out, shard.model_rank, shard.n_model, shard.model_group, 1)
    return linear_apply(p["out_proj"], out)


def multihead_self_attention(
    p,
    x: torch.Tensor,                 # [B, T, d]
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    dropout_rate: float = 0.0,
    train: bool = False,
    backend: str = "auto",
    score_dtype: Optional[str] = "bfloat16",
    seeds: Optional[LayerSeeds] = None,
    shard: Optional[Shard] = None,
) -> torch.Tensor:
    """On a model axis (`shard`) the rank's heads: qkv from its rows of
    in_proj (q, k, v of its heads), out_proj row-parallel; under 'sp' or
    'ring' the rank's T rows instead."""
    B, T, d = x.shape
    hd = d // nhead
    rung = _attention_rung(backend, T, x.is_cuda)
    rate = dropout_rate if (train and seeds is not None) else 0.0
    if rung in CONTEXT_PARALLEL:
        return _context_parallel(p, x, key_padding_mask, nhead, rate, seeds, rung,
                                 shard)
    origin = _kernel_origin(shard, nhead)
    if _tp(shard):
        # this rank's heads: its parts of q, k and v, d / n columns each
        _, n_local = shard.part(nhead)
        d_out = n_local * hd
        x = tp.copy_to(x, shard.model_group)
    else:
        n_local, d_out = nhead, d
    xw, w_in = promoted(x, p["in_proj_w"])
    qkv = xw @ w_in.T + p["in_proj_b"]                      # [B, T, 3 d_out]
    q, k, v = qkv.split(d_out, dim=-1)

    def project(out):
        if _tp(shard):
            return tp.row_parallel_linear(p["out_proj"], out, shard)
        return linear_apply(p["out_proj"], out)

    def heads(t):  # [B, T, d_out] -> [B, n_local, T, hd], a view
        return t.reshape(B, T, n_local, hd).transpose(1, 2)

    if rung in ("flash", "flash_mha"):
        lengths = _lengths(key_padding_mask, B, T, x.device)
        seed = seeds.kernel if rate > 0.0 else None
        cd = _score_dtype(score_dtype)
        if rung == "flash":
            out = flash_mha_packed(q, k, v, lengths, seed, rate, cd, n_local,
                                   origin=origin)
        else:
            # the kernels read the head views in place and write o merged,
            # so neither side of the call copies
            out = flash_mha(heads(q), heads(k), heads(v), lengths, seed, rate,
                            cd, origin=origin).transpose(1, 2).reshape(B, T, d_out)
        return project(out)

    q, k, v = heads(q) * (hd ** -0.5), heads(k), heads(v)
    logits = q @ k.transpose(-1, -2)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    float("-inf"))
    attn = torch.softmax(logits, dim=-1)
    if key_padding_mask is not None:
        # an all-padded sample softmaxes over all -inf (NaN): give it zeros
        all_pad = key_padding_mask.all(dim=-1)[:, None, None, None]
        attn = torch.where(all_pad, torch.zeros_like(attn), attn)
    if rate > 0.0:
        attn = _drop(seeds.attn, attn, rate, shard, 1 if _tp(shard) else None)
    out = (attn @ v).transpose(1, 2).reshape(B, T, d_out)
    return project(out)


def transformer_encoder_layer_apply(
    p,
    x: torch.Tensor,                # [B, T, d]
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    dropout_rate: float = 0.0,
    train: bool = False,
    backend: str = "auto",
    score_dtype: Optional[str] = "bfloat16",
    seeds: Optional[LayerSeeds] = None,
    shard: Optional[Shard] = None,
) -> torch.Tensor:
    """One post-LN encoder layer; backend 'fused_layer' (and 'auto' on CUDA
    at T >= 384) runs the whole layer through ops/fused_encoder.py. On a
    mesh `shard` places the rank's rows and, on a model axis, its part of
    the layer (see the module's docstring)."""
    B, T, d = x.shape
    rate = dropout_rate if (train and seeds is not None) else 0.0
    if encoder_rung(backend, T, d, nhead, x.is_cuda) == "fused_layer":
        return fused_encoder_layer(
            gathered_layer(p, shard) if _tp(shard) else p, x,
            _lengths(key_padding_mask, B, T, x.device),
            seeds.kernel if rate > 0.0 else None, rate, _score_dtype(score_dtype),
            nhead, origin=None if shard is None else (shard.b0, 0, nhead))
    attn = multihead_self_attention(p, x, key_padding_mask, nhead,
                                    dropout_rate, train, backend, score_dtype,
                                    seeds, shard)
    if backend in CONTEXT_PARALLEL:     # the rest of the layer: no model split
        shard = data_only(shard)
    if rate > 0.0:
        attn = _drop(seeds.post_attn, attn, rate, shard)
    x = _layer_norm(p["ln1"], x + attn)
    if _tp(shard):
        h = torch.relu(linear_apply(p["lin1"], tp.copy_to(x, shard.model_group)))
    else:
        h = torch.relu(linear_apply(p["lin1"], x))
    if rate > 0.0:
        h = _drop(seeds.ffn, h, rate, shard, 2 if _tp(shard) else None)
    h = (tp.row_parallel_linear(p["lin2"], h, shard) if _tp(shard)
         else linear_apply(p["lin2"], h))
    if rate > 0.0:
        h = _drop(seeds.post_ffn, h, rate, shard)
    return _layer_norm(p["ln2"], x + h)


def transformer_encoder_apply(
    params,
    x: torch.Tensor,                # [B, T, d]
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    dropout_rate: float = 0.0,
    train: bool = False,
    backend: str = "auto",
    score_dtype: Optional[str] = "bfloat16",
    seeds: Optional[Sequence[LayerSeeds]] = None,
    shard: Optional[Shard] = None,
) -> torch.Tensor:
    """`seeds`: one LayerSeeds per layer (DropoutSeeds.layers) for
    training with dropout; `shard`: this rank's place on a mesh."""
    if seeds is not None and len(seeds) != len(params):
        raise ValueError(f"{len(seeds)} layer seeds for {len(params)} layers")
    for i in range(len(params)):
        x = transformer_encoder_layer_apply(
            params[f"layer{i}"], x, key_padding_mask, nhead, dropout_rate,
            train, backend, score_dtype, None if seeds is None else seeds[i],
            shard)
    return x
