"""Splits for the trainer protocol (of raindrop_tpu/data/datasets.py: the
`Split` container, `prepare_split` and the synthetic data).

`synthetic_split` generates data with the published datasets' schema and
shapes and runs it through the real normalization, so the protocol runs
with no file from outside the repository; from the same seed it gives the
arrays the JAX package's function gives. Batch-major [N, T, ...] layout
throughout; the trainer transposes at the model's time-major boundary.

Reading the real .npy artifacts (`load_split`), the demographic splits and
the imputers come with the data slice and raise until then.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from raindrop_tpu_torch.config import DATASETS
from raindrop_tpu_torch.data.normalize import (
    get_stats, get_stats_static, tensorize_normalize,
    tensorize_normalize_no_static)


@dataclasses.dataclass
class Split:
    """One normalized train/val/test split, batch-major numpy arrays."""

    # P*: [N, T, 2F] values ++ mask; P*_time: [N, T] hours; P*_static:
    # [N, S] or None
    Ptrain: np.ndarray
    Pval: np.ndarray
    Ptest: np.ndarray
    Ptrain_time: np.ndarray
    Pval_time: np.ndarray
    Ptest_time: np.ndarray
    Ptrain_static: Optional[np.ndarray]
    Pval_static: Optional[np.ndarray]
    Ptest_static: Optional[np.ndarray]
    ytrain: np.ndarray
    yval: np.ndarray
    ytest: np.ndarray


def load_split(*args, **kwargs):
    raise NotImplementedError(
        "load_split (the real .npy artifacts, split files and demographic "
        "splits) comes with the data slice; synthetic_split needs no file")


def _unpack_dicts(P):
    """Per-sample dict list -> dense [N, T, F] / [N, T] / [N, S] arrays."""
    arrs = np.stack([p["arr"] for p in P])
    times = np.stack([np.asarray(p["time"]).reshape(-1) for p in P])
    statics = np.stack([p["extended_static"] for p in P])
    return arrs, times, statics


def prepare_split(Pdict_list, y, idx_train, idx_val, idx_test, *,
                  dataset: str, static_compat: bool = True,
                  imputation: Optional[str] = None) -> Split:
    """Statistics from the train portion only, then all three portions
    normalized with them."""
    if imputation:
        raise NotImplementedError(
            f"imputation={imputation!r} comes with the data slice")
    portions = (("train", idx_train), ("val", idx_val), ("test", idx_test))
    if dataset != "PAM":
        a_tr, t_tr, s_tr = _unpack_dicts(Pdict_list[idx_train])
        mf, stdf = get_stats(a_tr)
        ms, ss = get_stats_static(s_tr, dataset, compat=static_compat)
        parts = {}
        for name, idx in portions:
            a, t, s = ((a_tr, t_tr, s_tr) if name == "train"
                       else _unpack_dicts(Pdict_list[idx]))
            parts[name] = tensorize_normalize(a, t, s, y[idx], mf, stdf, ms, ss)
    else:
        # PAM: raw [N, T, F] arrays, synthetic timeline, no statics
        arrs = (np.stack(list(Pdict_list)) if Pdict_list.dtype == object
                else np.asarray(Pdict_list))
        mf, stdf = get_stats(arrs[idx_train])
        parts = {name: tensorize_normalize_no_static(arrs[idx], y[idx], mf, stdf)
                 for name, idx in portions}
    tr, va, te = parts["train"], parts["val"], parts["test"]
    return Split(
        Ptrain=tr[0], Pval=va[0], Ptest=te[0],
        Ptrain_time=tr[2], Pval_time=va[2], Ptest_time=te[2],
        Ptrain_static=tr[1], Pval_static=va[1], Ptest_static=te[1],
        ytrain=tr[3], yval=va[3], ytest=te[3])


def synthetic_raw(dataset: str = "PAM", n: int = 512, seed: int = 0, *,
                  T: Optional[int] = None, class_signal: float = 1.0,
                  positive_rate: float = 0.25):
    """Synthetic data with the dataset's schema and a learnable class
    signal: the labels shift a random subset of the sensor means. Returns
    (Pdict_list, y) as the raw artifacts hold them. `positive_rate`: the
    binary datasets' class imbalance."""
    spec = DATASETS[dataset]
    F, S = spec["d_inp"], spec["d_static"]
    T = T or spec["max_len"]
    C = spec["n_classes"]
    rng = np.random.default_rng(seed)

    y = rng.integers(0, C, size=n)
    if C == 2:
        y = (rng.uniform(size=n) < positive_rate).astype(np.int64)
    class_dirs = rng.normal(size=(C, F)) * class_signal

    obs_rate = 0.4 if dataset != "PAM" else 0.6
    base_mean = rng.uniform(1.0, 5.0, size=F)

    if dataset == "PAM":
        vals = np.abs(rng.normal(loc=base_mean, scale=1.0, size=(n, T, F))
                      + class_dirs[y][:, None, :])
        mask = rng.uniform(size=(n, T, F)) < obs_rate
        return (vals * mask).astype(np.float32), y.astype(np.int64)

    samples = []
    for i in range(n):
        n_obs = rng.integers(max(2, T // 4), T + 1)
        vals = np.abs(rng.normal(loc=base_mean, scale=1.0, size=(T, F))
                      + class_dirs[y[i]][None])
        mask = rng.uniform(size=(T, F)) < obs_rate
        mask[n_obs:] = False
        t = np.zeros((T, 1), np.float32)
        t[:n_obs, 0] = np.sort(rng.uniform(1.0, 48 * 60.0, size=n_obs))  # minutes
        static = np.abs(rng.normal(size=S)) + 0.1
        samples.append({
            "id": i,
            "arr": (vals * mask).astype(np.float32),
            "time": t,
            "extended_static": static.astype(np.float32),
        })
    arr = np.empty(n, dtype=object)
    arr[:] = samples
    return arr, y.astype(np.int64)


def synthetic_split(dataset: str = "PAM", n: int = 512, seed: int = 0, *,
                    T: Optional[int] = None, class_signal: float = 1.0,
                    static_compat: bool = True,
                    imputation: Optional[str] = None,
                    positive_rate: float = 0.25) -> Split:
    """An 8:1:1 synthetic split through the real normalization."""
    P, y = synthetic_raw(dataset, n, seed, T=T, class_signal=class_signal,
                         positive_rate=positive_rate)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(n)
    n_tr, n_va = round(n * 0.8), round(n * 0.1)
    return prepare_split(
        P, y, perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:],
        dataset=dataset, static_compat=static_compat, imputation=imputation)
