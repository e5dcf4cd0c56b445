"""Class-balanced batch sampling (the port's own copy of
raindrop_tpu/data/sampler.py; numpy only, on the host).

Three strategies, seeded:

  1: per-batch balanced resample without replacement
  2: epoch-shuffled pools; positives expanded 3x; each batch = B/2
     negatives ++ B/2 positives (binary datasets: P12, P19, eICU)
  3: uniform random batches without replacement, fixed 30 per epoch (PAM)

Given the same numpy Generator state, both packages draw the same index
sequence.
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
) -> Iterator[np.ndarray]:
    """Yield one epoch of batch index arrays.

    Strategy 2: reshuffle the negative pool and the 3x-expanded positive
    pool each epoch, then walk them in half-batch strides. Strategy 3:
    uniform choice without replacement per batch. Strategy 1: a balanced
    random sample per batch. (The per-host sharding of the JAX package's
    sampler comes with the scale-out slice.)
    """
    y = np.asarray(y).reshape(-1)
    if n_batches is None:
        n_batches = n_batches_per_epoch(y, batch_size, strategy)
    half = batch_size // 2

    if strategy == 2:
        idx_0 = np.where(y == 0)[0]
        idx_1 = np.where(y == 1)[0]
        I0 = rng.permutation(idx_0)
        I1 = rng.permutation(np.concatenate([idx_1] * 3))
        for n in range(n_batches):
            yield np.concatenate([I0[n * half:(n + 1) * half],
                                  I1[n * half:(n + 1) * half]])
    elif strategy == 3:
        for _ in range(n_batches):
            yield rng.choice(len(y), size=batch_size, replace=False)
    elif strategy == 1:
        idx_0 = np.where(y == 0)[0]
        idx_1 = np.where(y == 1)[0]
        for _ in range(n_batches):
            yield np.concatenate([rng.choice(idx_0, size=half, replace=False),
                                  rng.choice(idx_1, size=half, replace=False)])
    else:
        raise ValueError(f"unknown strategy {strategy}")
