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
                       rank's blocks of the gradient, scaled by `grad_scale`.

Every collective is an all_reduce, one of the two that gloo takes on
CUDA tensors (with broadcast), so the same code runs over NCCL and over
gloo ranks that share one card. A group of None is one rank: each of these is
then the identity.
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
