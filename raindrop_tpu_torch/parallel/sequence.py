"""Sequence (time-axis) parallel attention (port of
raindrop_tpu/parallel/sequence.py): the temporal attention's T axis split
over the mesh's model axis, each rank holding T / n contiguous rows of q,
k and v of its data rank's samples.

  sequence_parallel_attention  the keys and values gathered whole (one
        collective for both), each rank's queries against every key: the
        attention memory of a rank divides by n;
  ring_attention  the key/value blocks stay split and travel round the
        ring one hop a step (`ppermute`), each rank folding the visiting
        block into its queries with the online softmax (running max, sum
        and accumulator), in f32: a rank holds its own block and the
        visiting one, O(T / n) of keys and values.

Both mask padded keys by their global column (bias -1e30), give zeros on
a fully padded query row, and drop attention probabilities with
`_dropout_keep`, a hash of the (sample, head, query, key) coordinates in
the global tensor, so the mask does not depend on the sharding or on
which hop brings a block: at the same seed the two compute the same
function to floating-point tolerance, and each the one-rank function.

Gradients. A rank's query rows get their gradient on the rank. The keys
and values of SP are gathered for queries each rank holds only in part, so
the backward of the gather is a reduce-scatter (parallel/tensor.
gather_scatter: the ranks' gradients summed, the rank's block cut); the
ring's blocks take theirs back round the ring (the reverse shift). Where
the JAX package runs these in shard_map with GSPMD, the port calls them on
each rank's shard (a `Shard`, parallel/mesh.py) and runs the collectives
explicitly, all of them all_reduce or broadcast.

In the encoder (nn/transformer.py, backend 'sp' | 'ring') a rank projects
its T rows of q, k and v from the layer's input, which every model rank
holds whole, and the attention's output is gathered over T before
out_proj; the rest of the layer runs as on one device. So the in_proj
weight and bias are the leaves a rank computes only in part: the trainer
sums their gradient over the model axis (train/trainer.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raindrop_tpu_torch.parallel import tensor as tp
from raindrop_tpu_torch.parallel.mesh import Shard
from raindrop_tpu_torch.utils.dropout import M32, finalize32, threshold32


def _coord(n: int, off: int, dim: int, mult: int, device) -> torch.Tensor:
    shape = [1, 1, 1, 1]
    shape[dim] = n
    c = (torch.arange(n, dtype=torch.int64, device=device) + int(off)) & M32
    return (((c + 1) & M32) * mult & M32).reshape(shape)


def _dropout_keep(seed: int, sample0: int, n_b: int, n_h: int, t_q: int, t_k: int,
                  q_off: int, k_off: int, rate: float, device=None) -> torch.Tensor:
    """float32 [n_b, n_h, t_q, t_k]: 1 where the attention probability at
    global coordinates (sample0 + b, h, q_off + i, k_off + j) is kept. The
    JAX package's counter hash bit for bit, in int64 masked to 32 bits."""
    x = ((int(seed) & M32) * 0x9E3779B9) & M32
    x = (x ^ _coord(n_b, sample0, 0, 0x85EBCA6B, device)
         ^ _coord(n_h, 0, 1, 0xC2B2AE35, device)
         ^ _coord(t_q, q_off, 2, 0x27D4EB2F, device)
         ^ _coord(t_k, k_off, 3, 0x165667B1, device))
    return (finalize32(x) >= threshold32(rate)).to(torch.float32)


def time_shard(T: int, shard: Shard, axis: str = "model") -> Tuple[int, int]:
    """(offset, size) of this rank's rows of a T axis split over the model
    axis; ValueError when T does not divide (the JAX functions' shard_map
    refuses such a shape)."""
    n = shard.n_model
    if T % n:
        raise ValueError(f"T={T} must divide the '{axis}' axis size {n}")
    t_loc = T // n
    return shard.model_rank * t_loc, t_loc


def _seed(seed) -> int:
    return 0 if seed is None else int(seed)


def sequence_parallel_attention(
    q: torch.Tensor,          # [b_loc, H, t_loc, D] this rank's rows
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,    # [b_loc] valid key counts
    shard: Optional[Shard] = None,
    *,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """softmax(q K^T / sqrt(D) + padmask) V for this rank's query rows
    against the keys and values gathered over the model axis, in q's
    dtype; dropout_rate / seed: attention-probability dropout from the
    coordinate hash. Returns the rank's rows [b_loc, H, t_loc, D]."""
    shard = shard or Shard(0, q.shape[0])
    b_loc, H, t_loc, D = q.shape
    n = shard.n_model
    T = t_loc * n
    scale = 1.0 / math.sqrt(D)
    # keys and values in one collective, so their backward is one too
    kv = tp.gather_scatter(torch.stack([k, v]), shard.model_rank, n,
                           shard.model_group, 3)
    kf, vf = kv[0], kv[1]
    s = (q * scale) @ kf.transpose(-1, -2)
    ls = lengths.to(torch.int64)[:, None, None, None]
    col = torch.arange(T, device=q.device)[None, None, None, :]
    valid = col < ls
    s = torch.where(valid, s, torch.full((), -1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    # fully padded query rows -> zeros
    p = torch.where(ls == 0, torch.zeros((), dtype=p.dtype, device=p.device), p)
    if dropout_rate > 0.0:
        keep = _dropout_keep(_seed(seed), shard.b0, b_loc, H, t_loc, T,
                             shard.model_rank * t_loc, 0, dropout_rate, q.device)
        p = p * keep / (1.0 - dropout_rate)
    return p @ vf


def ring_attention(
    q: torch.Tensor,          # [b_loc, H, t_loc, D] this rank's rows
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,    # [b_loc] valid key counts
    shard: Optional[Shard] = None,
    *,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """Ring attention over the model axis: the rank's own key/value block
    and then each visiting one folded into its queries by the online
    softmax in f32, n - 1 hops with a rotation each and the last block
    folded without one. Dropout after the denominator accumulates. Returns
    the rank's rows [b_loc, H, t_loc, D] in q's dtype."""
    shard = shard or Shard(0, q.shape[0])
    b_loc, H, t_loc, D = q.shape
    n, idx = shard.n_model, shard.model_rank
    f32 = torch.float32
    scale = 1.0 / math.sqrt(D)
    qsf = q.to(f32) * scale
    ls = lengths.to(torch.int64)[:, None, None, None]
    m = torch.full((b_loc, H, t_loc, 1), float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros((b_loc, H, t_loc, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b_loc, H, t_loc, D), dtype=f32, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    kv = torch.stack([k, v])       # one rotation a hop carries both
    for i in range(n):
        # after i hops the visiting block started on rank idx - i
        src = (idx - i) % n
        col = torch.arange(t_loc, device=q.device)[None, None, None, :] + src * t_loc
        bias = torch.where(col < ls, zero, torch.full((), -1e30, dtype=f32,
                                                      device=q.device))
        kb, vb = kv[0].to(f32), kv[1].to(f32)
        s = qsf @ kb.transpose(-1, -2) + bias
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # masked columns underflow to exact zeros; the min and re-bias
        # guard the corner where every column so far was masked
        p = torch.exp(torch.minimum(s - m_new, zero) + bias)
        corr = torch.exp(torch.minimum(m - m_new, zero))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if dropout_rate > 0.0:
            keep = _dropout_keep(_seed(seed), shard.b0, b_loc, H, t_loc, t_loc,
                                 idx * t_loc, src * t_loc, dropout_rate, q.device)
            p = p * keep / (1.0 - dropout_rate)
        acc = acc * corr + p @ vb
        m = m_new
        if i < n - 1:
            kv = tp.ppermute(kv, shard.model_group, 1)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(q.dtype)
