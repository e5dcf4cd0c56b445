"""Synthetic irregular-series generators and timepoint subsampling (the
port's own numpy copy of raindrop_tpu/data/toy.py).

The mTAND tier's toy-data machinery (reference code/baselines/mTAND/
utils.py:678-817, 920-937) without the torch DataLoader plumbing: each
generator returns the packed ``[N, L, 2D+1]`` (values ‖ mask ‖ time)
arrays the mTAND models consume, split 80/20 with a fixed shuffle like
the reference's ``model_selection.train_test_split(random_state=42)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _train_test_split(data: np.ndarray, train_size: float = 0.8,
                      seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled split replicating sklearn ShuffleSplit ordering: the TEST
    indices come from the FRONT of the permutation (n_test = ceil of the
    test fraction, n_train = floor of the train fraction), train follows —
    so split membership matches the reference's
    model_selection.train_test_split(random_state=42) given the same RNG
    stream. (numpy's RandomState.permutation is what sklearn's
    check_random_state(42) bottoms out in.)"""
    n = data.shape[0]
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(np.ceil(n * (1.0 - train_size)))
    n_train = int(np.floor(n * train_size))
    return data[perm[n_test:n_test + n_train]], data[perm[:n_test]]


def irregularly_sampled_data_gen(n: int = 10, length: int = 20,
                                 seed: int = 0):
    """Three chirp/sine channels observed at independent random times
    (reference mTAND/utils.py:678-701). Returns (obs_values [N, 3, L],
    ground_truth [N, 3, 100], obs_times [N, 3, L])."""
    rng = np.random.RandomState(seed)
    obs_values, ground_truth, obs_times = [], [], []
    for _ in range(n):
        t1, t2, t3 = (np.sort(rng.uniform(0.0, 1.0, size=length))
                      for _ in range(3))
        a = 10 * rng.randn()
        b = 10 * rng.rand()
        f1 = 0.8 * np.sin(20 * (t1 + a) + np.sin(20 * (t1 + a))) \
            + 0.01 * rng.randn()
        f2 = -0.5 * np.sin(20 * (t2 + a + 20) + np.sin(20 * (t2 + a + 20))) \
            + 0.01 * rng.randn()
        f3 = np.sin(12 * (t3 + b)) + 0.01 * rng.randn()
        obs_times.append(np.stack((t1, t2, t3)))
        obs_values.append(np.stack((f1, f2, f3)))
        t = np.linspace(0, 1, 100)
        ground_truth.append(np.stack((
            0.8 * np.sin(20 * (t + a) + np.sin(20 * (t + a))),
            -0.5 * np.sin(20 * (t + a + 20) + np.sin(20 * (t + a + 20))),
            np.sin(12 * (t + b)))))
    return (np.asarray(obs_values), np.asarray(ground_truth),
            np.asarray(obs_times))


def sine_wave_data(n: int, length: int, seed: int = 0) -> Dict:
    """Single noisy sine channel on a quantized [0,1] grid
    (reference sine_wave_data_gen, mTAND/utils.py:702-739)."""
    rng = np.random.RandomState(seed)
    obs_values, ground_truth, obs_times = [], [], []
    grid = np.linspace(0, 1.0, 101)
    for _ in range(n):
        t = np.sort(rng.choice(grid, size=length, replace=True))
        b = 10 * rng.rand()
        obs_times.append(t)
        obs_values.append(np.sin(12 * (t + b)) + 0.1 * rng.randn())
        tc = np.linspace(0, 1, 100)
        ground_truth.append(np.sin(12 * (tc + b)))
    obs_values = np.asarray(obs_values)
    obs_times = np.asarray(obs_times)
    mask = np.ones_like(obs_values)
    combined = np.stack([obs_values, mask, obs_times], axis=2)
    train, test = _train_test_split(combined)
    return {"dataset_obj": combined, "train": train.astype(np.float32),
            "test": test.astype(np.float32), "input_dim": 1,
            "ground_truth": np.asarray(ground_truth)}


def kernel_smoother_data(n: int, length: int, alpha: float = 100.0,
                         seed: int = 0, ref_points: int = 10) -> Dict:
    """RBF-kernel-smoothed random reference values sampled at random query
    times (reference kernel_smoother_data_gen, mTAND/utils.py:740-786)."""
    rng = np.random.RandomState(seed)
    obs_values, ground_truth, obs_times = [], [], []
    key_points = np.linspace(0, 1, ref_points)
    grid = np.linspace(0, 1.0, 101)

    def smooth(query, key_values):
        w = np.exp(-alpha * (query[:, None] - key_points[None, :]) ** 2)
        w /= w.sum(1, keepdims=True)
        return w @ key_values

    for _ in range(n):
        key_values = rng.randn(ref_points)
        q = np.sort(rng.choice(grid, size=length, replace=True))
        obs_values.append(smooth(q, key_values))
        obs_times.append(q)
        ground_truth.append(smooth(np.linspace(0, 1, 100), key_values))
    obs_values = np.asarray(obs_values)
    obs_times = np.asarray(obs_times)
    mask = np.ones_like(obs_values)
    combined = np.stack([obs_values, mask, obs_times], axis=2)
    train, test = _train_test_split(combined)
    return {"dataset_obj": combined, "train": train.astype(np.float32),
            "test": test.astype(np.float32), "input_dim": 1,
            "ground_truth": np.asarray(ground_truth)}


def toy_data(n: int, length: int, seed: int = 0) -> Dict:
    """Pack the 3-channel irregular toy set into the mTAND block layout
    (reference get_toy_data, mTAND/utils.py:787-817): each channel's
    observations occupy their own contiguous [i*L, (i+1)*L) slot of a
    3L-long union timeline; the shared time row is the flattened per-
    channel times (a reference quirk — kept)."""
    dim = 3
    obs_values, ground_truth, obs_times = irregularly_sampled_data_gen(
        n, length, seed=seed)
    obs_times = obs_times.reshape(n, -1)                 # [N, 3L]
    L_total = obs_times.shape[-1]
    values = np.zeros((n, dim, L_total))
    mask = np.zeros((n, dim, L_total))
    for i in range(dim):
        values[:, i, i * length:(i + 1) * length] = obs_values[:, i]
        mask[:, i, i * length:(i + 1) * length] = 1.0
    combined = np.concatenate(
        [values, mask, obs_times[:, None, :]], axis=1).transpose(0, 2, 1)
    train, test = _train_test_split(combined)
    return {"dataset_obj": combined, "train": train.astype(np.float32),
            "test": test.astype(np.float32), "input_dim": dim,
            "ground_truth": ground_truth}


def subsample_timepoints(data: np.ndarray, time_steps: np.ndarray,
                         mask: np.ndarray,
                         percentage_tp_to_sample: float,
                         rng: Optional[np.random.Generator] = None):
    """Keep a random fraction of each sample's observed timepoints and
    zero the rest (reference subsample_timepoints, mTAND/utils.py:920-937).
    Operates on copies; returns (data, time_steps, mask)."""
    if rng is None:
        rng = np.random.default_rng(0)
    data = np.array(data)
    mask = np.array(mask)
    for i in range(data.shape[0]):
        non_missing = np.where(mask[i].sum(-1) > 0)[0]
        n_keep = int(len(non_missing) * percentage_tp_to_sample)
        keep = np.sort(rng.choice(non_missing, n_keep, replace=False))
        drop = np.setdiff1d(non_missing, keep)
        data[i, drop] = 0.0
        mask[i, drop] = 0.0
    return data, time_steps, mask
