"""Dataset ingestion (the port's own copy of raindrop_tpu/data/datasets.py):
the reference's .npy artifacts, or synthetic data in their schema.

The layout of a dataset root, as the reference reads it (reference
code/utils_rd.py:23-146; written by the JAX package's data/preprocess.py):
  <base>/processed_data/PTdict_list.npy   per-sample dicts {'arr' [T, F],
      'time' [T, 1], 'extended_static' [S]} (P12 and eICU; P19 reads
      PT_dict_list_6.npy); PAM stores raw [N, T, F] value arrays
  <base>/processed_data/arr_outcomes*.npy the outcome table
  <base>/splits/<name>.npy                (idx_train, idx_val, idx_test)

`load_split` reads them, splits (the split file, a seeded 8:1:1 resplit, or
Setting 4's demographic groups), optionally imputes, and normalizes with
the train portion's statistics. `synthetic_split` generates data with the
published datasets' schema and shapes and runs it through the same
normalization, so the protocol runs with no file from outside the
repository. From the same files or seed both give the arrays the JAX
package's functions give. Batch-major [N, T, ...] layout throughout; the
trainer transposes at the model's time-major boundary.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from raindrop_tpu_torch.config import DATASETS
from raindrop_tpu_torch.data.imputation import features_mean, impute
from raindrop_tpu_torch.data.normalize import (
    get_stats, get_stats_static, tensorize_normalize,
    tensorize_normalize_no_static)
from raindrop_tpu_torch.data.settings import demographic_indices

# Split-file name patterns, reference code/Raindrop.py:163-174.
SPLIT_PATTERNS = {
    "P12": "splits/phy12_split{k}.npy",
    "P19": "splits/phy19_split{k}_new.npy",
    "eICU": "splits/eICU_split{k}.npy",
    "PAM": "splits/PAM_split_{k}.npy",
}

PT_FILES = {
    "P12": ("PTdict_list.npy", "arr_outcomes.npy"),
    "P19": ("PT_dict_list_6.npy", "arr_outcomes_6.npy"),
    "eICU": ("PTdict_list.npy", "arr_outcomes.npy"),
    "PAM": ("PTdict_list.npy", "arr_outcomes.npy"),
}


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


def _select_label(arr_outcomes: np.ndarray, dataset: str, predictive_label: str):
    """Outcome column selection (reference code/utils_rd.py:134-141)."""
    if dataset == "eICU":
        return np.asarray(arr_outcomes).reshape(-1)
    if predictive_label == "mortality":
        return np.asarray(arr_outcomes)[:, -1].reshape(-1)
    if predictive_label == "LoS":  # P12 only: length of stay > 3 days
        los = np.asarray(arr_outcomes)[:, 3].reshape(-1)
        return (los > 3).astype(np.int64)
    raise ValueError(f"unknown predictive_label {predictive_label!r}")


def load_raw(base_path: str, dataset: str):
    """(Pdict_list, arr_outcomes) of a dataset root."""
    pt, oc = PT_FILES[dataset]
    Pdict_list = np.load(os.path.join(base_path, "processed_data", pt),
                         allow_pickle=True)
    arr_outcomes = np.load(os.path.join(base_path, "processed_data", oc),
                           allow_pickle=True)
    return Pdict_list, arr_outcomes


def load_split_indices(base_path: str, dataset: str,
                       split_idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    path = os.path.join(base_path, SPLIT_PATTERNS[dataset].format(k=split_idx))
    idx_train, idx_val, idx_test = np.load(path, allow_pickle=True)
    return np.asarray(idx_train), np.asarray(idx_val), np.asarray(idx_test)


def load_split(
    base_path: str,
    dataset: str = "P12",
    split_idx: int = 1,
    *,
    split_type: str = "random",          # 'random' | 'age' | 'gender'
    reverse: bool = False,
    predictive_label: str = "mortality",
    static_compat: bool = True,
    rng: Optional[np.random.Generator] = None,
    resplit_seed: Optional[int] = None,
    imputation: Optional[str] = None,
) -> Split:
    """Load, split and normalize a dataset root (reference
    code/utils_rd.py:23-146 and code/Raindrop.py:181-211).

    Setting 4 (split_type 'age' / 'gender') partitions by the demographics
    of extended_static (settings.demographic_indices); val and test are
    the shuffled halves of the held-out group (`rng`, default seeded by
    split_idx); `reverse` swaps the groups.

    resplit_seed: instead of the split file, a fresh seeded 8:1:1
    permutation (the mTAND per-run resplit protocol,
    code/baselines/mTAND/mTAND_baseline.py:72-88); the normalization
    statistics come from the new train portion.
    """
    Pdict_list, arr_outcomes = load_raw(base_path, dataset)
    y = _select_label(arr_outcomes, dataset, predictive_label)

    if resplit_seed is not None:
        if split_type != "random":
            raise ValueError("resplit_seed only applies to split_type='random'")
        n = len(y)
        perm = np.random.default_rng(resplit_seed).permutation(n)
        n_tr, n_va = round(n * 0.8), round(n * 0.1)
        idx_train, idx_val, idx_test = (
            perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:])
    elif split_type == "random":
        idx_train, idx_val, idx_test = load_split_indices(base_path, dataset, split_idx)
    else:
        if dataset == "PAM":
            raise ValueError("PAM has no demographics; Setting 4 unsupported")
        statics_all = np.stack([p["extended_static"] for p in Pdict_list])
        grp_a, grp_b = demographic_indices(statics_all, dataset, split_type)
        idx_train, idx_vt = (grp_b, grp_a) if reverse else (grp_a, grp_b)
        rng = rng or np.random.default_rng(split_idx)
        idx_vt = rng.permutation(idx_vt)
        half = round(len(idx_vt) / 2)
        idx_val, idx_test = idx_vt[:half], idx_vt[half:]

    return prepare_split(
        Pdict_list, y, idx_train, idx_val, idx_test,
        dataset=dataset, static_compat=static_compat, imputation=imputation)


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
    normalized with them (reference code/Raindrop.py:181-211).

    imputation: the name of a Trans-mean family imputer (mean, forward,
    cubic_spline, knn, mice; data/imputation.py) applied to each portion's
    RAW values before the statistics and the normalization, where the
    reference applies it (Transformer_baseline.py:155-204), the train
    portion's means reused for val and test in 'mean' mode. PAM has no
    timestamps: it imputes on the reference's uniform timeline arange(1,
    T + 1) (Transformer_baseline.py:166-171).
    """
    portions = (("train", idx_train), ("val", idx_val), ("test", idx_test))
    if dataset != "PAM":
        a_tr, t_tr, s_tr = _unpack_dicts(Pdict_list[idx_train])
        means = features_mean(a_tr) if imputation == "mean" else None
        if imputation:
            a_tr = impute(a_tr, t_tr, imputation, means)
        mf, stdf = get_stats(a_tr)
        ms, ss = get_stats_static(s_tr, dataset, compat=static_compat)
        parts = {}
        for name, idx in portions:
            a, t, s = ((a_tr, t_tr, s_tr) if name == "train"
                       else _unpack_dicts(Pdict_list[idx]))
            if imputation and name != "train":
                a = impute(a, t, imputation, means)
            parts[name] = tensorize_normalize(a, t, s, y[idx], mf, stdf, ms, ss)
    else:
        # PAM: raw [N, T, F] arrays, synthetic timeline, no statics
        arrs = (np.stack(list(Pdict_list)) if Pdict_list.dtype == object
                else np.asarray(Pdict_list))
        if imputation:
            T = arrs.shape[1]
            tgrid = np.broadcast_to(np.arange(1, T + 1, dtype=np.float64),
                                    arrs.shape[:2]).copy()
            means = (features_mean(arrs[idx_train])
                     if imputation == "mean" else None)
            arrs = np.array(arrs, dtype=np.float64, copy=True)
            for _, idx in portions:
                arrs[idx] = impute(arrs[idx], tgrid[idx], imputation, means)
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
