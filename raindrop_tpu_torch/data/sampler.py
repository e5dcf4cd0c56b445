"""Class-balanced batch sampling (the port's own copy of
raindrop_tpu/data/sampler.py; numpy only, on the host).

Three strategies, seeded:

  1: per-batch balanced resample without replacement
  2: epoch-shuffled pools; positives expanded 3x; each batch = B/2
     negatives ++ B/2 positives (binary datasets: P12, P19, eICU)
  3: uniform random batches without replacement, fixed 30 per epoch (PAM)

and `balanced_sample_per_class`, one batch with as many indices of each
class (the reference's unused 8-class sampler for PAM).

Given the same numpy Generator state, both packages draw the same index
sequence. For data parallelism over several ranks `balanced_batches`
takes (shard_id, num_shards): every rank draws the same global index
sequence from the same seed and keeps its own contiguous slice of each
batch, deterministic and disjoint.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def n_batches_per_epoch(y: np.ndarray, batch_size: int, strategy: int,
                        n_batches_strategy3: int = 30,
                        n_batches_strategy1: int = 10) -> int:
    """Batches per epoch (reference code/Raindrop.py:273-285)."""
    if strategy == 1:
        return n_batches_strategy1
    if strategy == 2:
        n0 = int(np.sum(y == 0))
        n1 = 3 * int(np.sum(y == 1))
        half = batch_size // 2
        return int(min(n0 // half, n1 // half))
    if strategy == 3:
        return n_batches_strategy3
    raise ValueError(f"unknown strategy {strategy}")


def balanced_batches(
    y: np.ndarray,
    batch_size: int,
    strategy: int,
    rng: np.random.Generator,
    *,
    n_batches: Optional[int] = None,
    shard_id: int = 0,
    num_shards: int = 1,
) -> Iterator[np.ndarray]:
    """Yield one epoch of batch index arrays: shard `shard_id`'s slice of
    each when num_shards > 1.

    Strategy 2: reshuffle the negative pool and the 3x-expanded positive
    pool each epoch, then walk them in half-batch strides. Strategy 3:
    uniform choice without replacement per batch. Strategy 1: a balanced
    random sample per batch.
    """
    y = np.asarray(y).reshape(-1)
    if batch_size % num_shards:
        raise ValueError(f"batch_size {batch_size} not divisible by {num_shards} shards")
    if n_batches is None:
        n_batches = n_batches_per_epoch(y, batch_size, strategy)
    half = batch_size // 2

    if strategy == 2:
        idx_0 = np.where(y == 0)[0]
        idx_1 = np.where(y == 1)[0]
        I0 = rng.permutation(idx_0)
        I1 = rng.permutation(np.concatenate([idx_1] * 3))
        for n in range(n_batches):
            yield _shard(np.concatenate([I0[n * half:(n + 1) * half],
                                         I1[n * half:(n + 1) * half]]),
                         shard_id, num_shards)
    elif strategy == 3:
        for _ in range(n_batches):
            yield _shard(rng.choice(len(y), size=batch_size, replace=False),
                         shard_id, num_shards)
    elif strategy == 1:
        idx_0 = np.where(y == 0)[0]
        idx_1 = np.where(y == 1)[0]
        for _ in range(n_batches):
            yield _shard(np.concatenate([rng.choice(idx_0, size=half, replace=False),
                                         rng.choice(idx_1, size=half, replace=False)]),
                         shard_id, num_shards)
    else:
        raise ValueError(f"unknown strategy {strategy}")


def balanced_sample_per_class(y: np.ndarray, batch_size: int,
                              rng: np.random.Generator,
                              n_classes: int = 8,
                              replace: bool = False) -> np.ndarray:
    """One batch of batch_size // n_classes indices of each class, the
    reference's dormant 8-class balanced sampler for PAM
    (utils_phy12.py:403-415, random_sample_8; commented out in its
    drivers, e.g. Transformer_baseline.py:334)."""
    y = np.asarray(y).reshape(-1)
    per = batch_size // n_classes
    return np.concatenate([
        rng.choice(np.where(y == c)[0], size=per, replace=replace)
        for c in range(n_classes)])


def _shard(idx: np.ndarray, shard_id: int, num_shards: int) -> np.ndarray:
    # the data axis's rule (parallel/mesh.batch_rows); strategy 2's
    # batches hold 2 * (batch_size // 2) rows, which must divide too
    from raindrop_tpu_torch.parallel.mesh import batch_rows

    return idx if num_shards == 1 else idx[batch_rows(len(idx), shard_id, num_shards)]
