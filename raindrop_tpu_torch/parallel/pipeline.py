"""Pipeline parallelism, GPipe (port of raindrop_tpu/parallel/pipeline.py)
over the mesh's model axis: stage s, model rank s, holds its stage's
parameters and runs M microbatches through the classic fill / steady /
drain schedule of M + S - 1 ticks. At tick t stage s works on microbatch
t - s (stage 0 ingests it), the last stage records microbatch t - (S - 1),
and every stage's output moves to the next by a shift over the model group
(`shift_blocks`, no wrap-around); the outputs are then given to every rank
by a masked all_reduce.

Where the JAX package expresses the schedule as one differentiable scan,
the port runs it as one autograd function whose backward is the same
schedule in reverse (each tick's stage graph kept from the forward,
differentiated at its turn, the gradients shifted back a stage), so every
rank meets the schedule's collectives in the same order. A stage idle at
a tick (t - s outside 0..M-1) computes nothing and sends zeros.

For Raindrop's temporal encoder the staging is one encoder layer a stage
(`pipeline_transformer_encoder`), each on the dense rung; the model axis
must hold one rank per layer. JAX feeds every data rank the global batch
(its data_specs are P()) and cuts the microbatches from it; the port
gathers the global batch over the data axis, runs the same microbatches
(so each (microbatch, stage) draws its dropout masks as JAX's does), and
keeps its rows of the output. Under this route the leaves of the layers a
rank does not run are the ones it computes in part (zero): the trainer
sums the encoder's gradients over the model axis (train/trainer.py). The
inputs are whole on every rank (JAX's replicated xs) and stage 0 alone
computes their gradient: the backward ends with an all_reduce of it over
the group, as `copy_to`'s would, so every rank has the whole.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from raindrop_tpu_torch.parallel import tensor as tp
from raindrop_tpu_torch.parallel.mesh import Shard
from raindrop_tpu_torch.utils.dropout import LayerSeeds


def _flatten(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def stack_stage_params(stage_list):
    """Per-stage parameter trees (one structure, one shape a leaf) stacked
    on a new leading stage axis: the JAX package's layout, whose row s is
    what stage s holds here (pipeline_apply takes a rank's own stage)."""
    first = stage_list[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in stage_list]) for k in first}
    return torch.stack(list(stage_list))


def _schedule(stage_fn, tree, leaves, xs, group, stage, n_stages, keep_graph):
    """The forward schedule: (outputs [M, mb, ...] of the last stage, zeros
    elsewhere; per computed tick (tick, microbatch, input, output))."""
    M = xs.shape[0]
    params = _unflatten(tree, leaves)
    outs = torch.zeros_like(xs)
    saved = []
    state = None
    for t in range(M + n_stages - 1):
        j = t - stage
        if 0 <= j < M:
            src = xs[j] if stage == 0 else state
            if keep_graph:
                inp = src.detach().requires_grad_(True)
                out = stage_fn(params, inp, j)
                saved.append((t, j, inp, out))
                send = out.detach()
            else:
                send = stage_fn(params, src, j)
            if stage == n_stages - 1:
                outs[j] = send
        else:
            send = torch.zeros_like(xs[0])
        if t < M + n_stages - 2:
            state = tp.shift_blocks(send, group, 1, wrap=False)
    if n_stages > 1:
        outs = tp.all_reduce(outs, group)   # masked psum: the last stage's
    return outs, saved


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, tree, group, stage, n_stages, xs, *leaves):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
            outs, saved = _schedule(stage_fn, tree, ps, xs, group, stage, n_stages, True)
        ctx.args = (group, stage, n_stages, xs.shape, xs.dtype, xs.device)
        ctx.x_grad = xs.requires_grad
        ctx.ps, ctx.saved = ps, saved
        return outs

    @staticmethod
    def backward(ctx, g_out):
        group, stage, n_stages, shape, dtype, device = ctx.args
        ps, saved = ctx.ps, {t: rec for t, rec in ((r[0], r[1:]) for r in ctx.saved)}
        ctx.ps = ctx.saved = None
        M = shape[0]
        want = [i for i, p in enumerate(ps) if p.requires_grad]
        grads = [None] * len(ps)
        dxs = torch.zeros(shape, dtype=dtype, device=device)
        zeros = torch.zeros(shape[1:], dtype=dtype, device=device)
        g_recv = zeros      # the gradient of what this rank received at tick t + 1
        for t in reversed(range(M + n_stages - 1)):
            # the gradient of what this rank sent at tick t, from the next stage
            g_sent = (tp.shift_blocks(g_recv, group, -1, wrap=False)
                      if t < M + n_stages - 2 else zeros)
            g_recv = zeros
            if t not in saved:
                continue
            j, inp, out = saved.pop(t)
            g = g_out[j] + g_sent if stage == n_stages - 1 else g_sent
            res = torch.autograd.grad(out, [inp] + [ps[i] for i in want], g,
                                      allow_unused=True)
            for i, gp in zip(want, res[1:]):
                if gp is not None:
                    grads[i] = gp if grads[i] is None else grads[i] + gp
            if stage == 0:
                dxs[j] = res[0]
            else:
                g_recv = res[0]
        if ctx.x_grad and n_stages > 1:
            dxs = tp.all_reduce(dxs, group)
        return (None, None, None, None, None, dxs, *grads)


def pipeline_apply(stage_fn: Callable, stage_params, xs: torch.Tensor,
                   group=None, stage: int = 0, n_stages: int = 1) -> torch.Tensor:
    """Run microbatches through an n_stages pipeline, this rank being stage
    `stage` of `group` (None: one stage).

    stage_fn(params, x, m) -> a tensor of x's shape: the stage's function
    of microbatch m; stage_params: this stage's parameter tree (tensors);
    xs [M, microbatch, ...]. Returns the last stage's outputs
    [M, microbatch, ...] on every rank of the group."""
    leaves = _flatten(stage_params, [])
    if not torch.is_grad_enabled() or not (
            xs.requires_grad or any(p.requires_grad for p in leaves)):
        outs, _ = _schedule(stage_fn, stage_params, leaves, xs, group, stage,
                            n_stages, False)
        return outs
    return _GPipe.apply(stage_fn, stage_params, group, stage, n_stages, xs, *leaves)


def pipeline_transformer_encoder(
    params,                          # transformer_encoder_init tree
    x: torch.Tensor,                 # [B, T, d] this data rank's rows
    key_padding_mask: Optional[torch.Tensor],  # [B, T] True = padded
    nhead: int,
    n_microbatches: int,
    shard: Optional[Shard] = None,
    dropout_rate: float = 0.0,
    train: bool = False,
    seeds: Optional[Sequence[Sequence[LayerSeeds]]] = None,
) -> torch.Tensor:
    """The temporal encoder as a layer-a-stage pipeline over the model axis
    of `shard`: equal to transformer_encoder_apply on the dense rung in
    eval and at dropout 0. In training each (microbatch m, stage s) drops
    with seeds[m][s] (DropoutSeeds.pipeline: the JAX package's
    fold_in(fold_in(rng, m), s) split in 4). Returns this rank's rows."""
    from raindrop_tpu_torch.nn.transformer import transformer_encoder_layer_apply

    shard = shard or Shard(0, x.shape[0])
    L, n = len(params), shard.n_model
    if n != L:
        raise ValueError(f"need one pipeline stage per layer: mesh 'model'={n} "
                         f"but encoder has {L} layers")
    b_loc, T, d = x.shape
    if key_padding_mask is None:
        key_padding_mask = torch.zeros((b_loc, T), dtype=torch.bool, device=x.device)
    # the global batch, as JAX's replicated data specs give every rank
    if shard.data_group is not None:
        x = tp.gather_dim(x, shard.data_rank, shard.n_data, shard.data_group, 0)
        key_padding_mask = tp.gather_dim(key_padding_mask.to(torch.int32),
                                         shard.data_rank, shard.n_data,
                                         shard.data_group, 0).bool()
    B = x.shape[0]
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    drop = train and seeds is not None and dropout_rate > 0.0
    if drop and (len(seeds) != M or any(len(s) != L for s in seeds)):
        raise ValueError(f"the pipeline drops with one LayerSeeds a microbatch and "
                         f"stage: DropoutSeeds.draw(..., pipeline={M}) for {M} x {L}")
    s = shard.model_rank
    masks = key_padding_mask.reshape(M, B // M, T)

    def stage_fn(p, h, m):
        return transformer_encoder_layer_apply(
            p, h, masks[m], nhead, dropout_rate, drop, backend="dense",
            seeds=seeds[m][s] if drop else None)

    xs = x.reshape(M, B // M, T, d)
    out = pipeline_apply(stage_fn, params[f"layer{s}"], xs, shard.model_group, s, n)
    out = out.reshape(B, T, d)
    if shard.data_group is not None:
        out = out[shard.b0:shard.b0 + b_loc]
    return out
