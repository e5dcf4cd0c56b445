"""Collectives of the mesh as autograd functions, and the Megatron
products built on them (the port's counterpart of the all-reduces GSPMD
inserts for raindrop_tpu/parallel/mesh.py's shardings).

  copy_to(x, g)        forward the identity, backward an all_reduce of the
                       gradient over g: the input of a column-parallel
                       product, which every rank of g reads whole;
  reduce_from(x, g)    forward an all_reduce over g, backward the
                       identity: the output of a row-parallel product;
  gather(x, ...)       forward the full tensor from each rank's blocks
                       (an all_reduce into a zeroed buffer), backward the
                       rank's blocks of the gradient, scaled by `grad_scale`;
  gather_scatter(x, ...)  forward `gather_dim`'s, backward the true
                       transpose of an all-gather, a reduce-scatter (an
                       all_reduce of the gradient, then the rank's block):
                       for a gathered tensor each rank uses only in part
                       (sequence parallelism's keys and values);
  psum(x, g)           forward and backward an all_reduce: a sum each rank
                       uses only in part (edge partitioning's softmax
                       denominators);
  ppermute(x, g, shift)  rank r receives rank r - shift's block (mod the
                       group's size), backward the reverse shift; built on
                       shift_blocks, which also shifts without wrap-around
                       (the first ranks receive zeros: the pipeline's);
  all_reduce_max(x, g) the element-wise maximum over g, outside autograd.

Every collective is an all_reduce or a broadcast, the two that gloo takes
on CUDA tensors, so the same code runs over NCCL and over gloo ranks that
share one card. A group of None is one rank: each of these is then the
identity.

A collective in a backward runs when autograd reaches its node, and
autograd orders independent branches as it likes; the ranks must meet in
the same collectives in the same order, so every caller chains its
backward collectives through data dependence (one collective for keys and
values together, each ring hop's input the previous hop's output).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from raindrop_tpu_torch.nn.linear import linear_apply, promoted


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the ranks of `group`, in place; x itself for None."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


Blocks = Sequence[Tuple[Tuple[int, ...], Tuple[slice, ...]]]


def _cut(full: torch.Tensor, blocks: Blocks, dim: int) -> torch.Tensor:
    return torch.cat([full[sl] for _, sl in blocks], dim=dim)


def _place(local: torch.Tensor, blocks: Blocks, dim: int, shape) -> torch.Tensor:
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    start = 0
    for _, sl in blocks:
        n = sl[dim].stop - sl[dim].start
        full[sl] = local.narrow(dim, start, n)
        start += n
    return full


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, blocks, dim, shape, group, grad_scale):
        ctx.args = (blocks, dim, grad_scale)
        return all_reduce(_place(local.detach(), blocks, dim, shape), group)

    @staticmethod
    def backward(ctx, g):
        blocks, dim, grad_scale = ctx.args
        out = _cut(g, blocks, dim)
        if grad_scale != 1:
            out = out * grad_scale
        return out, None, None, None, None, None


def gather(local: torch.Tensor, blocks: Blocks, dim: int, shape, group,
           grad_scale: float = 1.0) -> torch.Tensor:
    """The full tensor of `shape` whose blocks (origin, slices) along `dim`
    this rank holds as `local` (concatenated in that order), the others'
    from the ranks of `group`. The backward gives the rank its blocks of
    the gradient, which every rank computes whole, times grad_scale."""
    if group is None:
        return local
    return _Gather.apply(local, list(blocks), dim, tuple(shape), group, grad_scale)


def gather_dim(local: torch.Tensor, rank: int, n: int, group, dim: int,
               grad_scale: float = 1.0) -> torch.Tensor:
    """`gather` of contiguous equal parts of `dim`."""
    if group is None:
        return local
    size = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = size * n
    sl = tuple(slice(rank * size, (rank + 1) * size) if a == dim else slice(0, m)
               for a, m in enumerate(shape))
    return gather(local, [(None, sl)], dim, shape, group, grad_scale)


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, rank, n, group, dim):
        ctx.args = (rank, n, group, dim)
        shape = list(local.shape)
        size = shape[dim]
        shape[dim] = size * n
        full = torch.zeros(shape, dtype=local.dtype, device=local.device)
        full.narrow(dim, rank * size, size).copy_(local)
        return all_reduce(full, group)

    @staticmethod
    def backward(ctx, g):
        rank, n, group, dim = ctx.args
        full = all_reduce(g.contiguous().clone(), group)
        size = full.shape[dim] // n
        return full.narrow(dim, rank * size, size).contiguous(), None, None, None, None


def gather_scatter(local: torch.Tensor, rank: int, n: int, group, dim: int) -> torch.Tensor:
    """The full tensor from every rank's equal contiguous part of `dim`
    (this rank's at `rank`), whose gradient each rank computes only in
    part: the backward sums the ranks' gradients and gives this rank its
    block (a reduce-scatter), where `gather`'s gives the rank its block of
    a gradient every rank computes whole."""
    if group is None:
        return local
    return _GatherScatter.apply(local, rank, n, group, dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` where each rank uses the sum only for its
    own part of the work: the gradient is the sum of the ranks' too."""
    return x if group is None else _PSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The element-wise maximum of x over `group` (a new tensor, no
    gradient)."""
    out = x.detach().contiguous().clone()
    if group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _source(rank: int, n: int, shift: int, wrap: bool):
    src = rank - shift
    if wrap:
        return src % n
    return src if 0 <= src < n else None


def shift_blocks(x: torch.Tensor, group, shift: int = 1, wrap: bool = True) -> torch.Tensor:
    """Rank r's result is rank (r - shift)'s x (all of one shape and
    dtype); without wrap-around a rank with no such source gets zeros.
    Built from one broadcast per sending rank: each rank keeps only its
    source's block, so at most one block besides its own and the result
    is alive. No autograd (`ppermute` is the differentiable form)."""
    if group is None:
        return x.clone() if wrap else torch.zeros_like(x)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    mine = _source(rank, n, shift, wrap)
    # a copy: gloo's broadcast of a CUDA tensor writes the result back into
    # the sender's tensor too, which would bump the version of x (and of
    # every view autograd saved of it)
    x = x.detach().clone(memory_format=torch.contiguous_format)
    out = torch.zeros_like(x)
    scratch = None
    for src in range(n):
        if _source((src + shift) % n, n, shift, wrap) != src:
            continue        # no rank receives this block (no wrap-around)
        if src == rank:
            buf = x
        elif src == mine:
            buf = out
        else:
            if scratch is None:
                scratch = torch.empty_like(x)
            buf = scratch
        dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.args = (group, shift)
        return shift_blocks(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        group, shift = ctx.args
        return shift_blocks(g, group, -shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """jax.lax.ppermute with the permutation r -> r + shift mod the group's
    size: rank r receives rank r - shift's x. The backward sends the
    gradient the reverse way."""
    return x if group is None else _PPermute.apply(x, group, shift)


def column_parallel_linear(p, x: torch.Tensor, shard) -> torch.Tensor:
    """x @ w.T + b with w [out, in] split on its rows over the model axis
    (this rank holds `p`'s [out / n, in] and [out / n]), the output
    gathered whole: the column-parallel product whose output the next
    layer reads whole (propagation's lin_value)."""
    y = linear_apply(p, copy_to(x, shard.model_group))
    return gather_dim(y, shard.model_rank, shard.n_model, shard.model_group, y.dim() - 1)


def row_parallel_linear(p, x: torch.Tensor, shard) -> torch.Tensor:
    """x @ w.T + b with w [out, in] split on its columns (this rank holds
    [out, in / n] and reads its part of x's last dim); the partial
    products summed over the model axis, then the (replicated) bias."""
    xw, w = promoted(x, p["w"])
    y = reduce_from(xw @ w.T, shard.model_group)
    return y + p["b"] if "b" in p else y


def barrier(group=None, device="cpu") -> None:
    """Wait for every rank of `group` (the world for None, when a group
    is up), by an all_reduce of one element on `device`."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    dist.all_reduce(torch.zeros(1, device=device), group=group)
