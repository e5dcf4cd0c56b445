"""Imputation for the Trans-mean baseline family (the port's own numpy
copy of raindrop_tpu/data/imputation.py).

Reference code/baselines/utils_phy12.py:175-287 (mean / forward /
cubic-spline) and code/baselines/imputations.py:72-123 (kNN / MICE).
Applied to raw [N, T, F] value arrays BEFORE tensorize/normalize, exactly
where Transformer_baseline.py:155-204 applies them. Missing entries are 0
(the repo-wide convention); imputation only touches timesteps within each
sample's observed time range (rows with a timestamp).

All host-side numpy; mean and forward are vectorized, cubic-spline loops
per (sample, channel) like the reference (scipy CubicSpline is inherently
per-series). knn and mice import scikit-learn when called; without it they
raise ImportError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _time_lengths(X_time: np.ndarray) -> np.ndarray:
    """Per-sample observed length from the timestamp array [N, T] (first
    zero after the initial step — utils_phy12.py:184-191).

    One guarded case the reference mishandles: a fully-observed sample
    whose only zero timestamp is the legitimate t=0 first observation.
    The reference indexes zeros[1] unconditionally there and CRASHES with
    IndexError; we return the full length T (the sample has no padding),
    so such samples are imputed rather than skipped or crashed on.
    """
    N, T = X_time.shape
    lengths = np.full(N, T, np.int64)
    for i in range(N):
        zeros = np.where(X_time[i] == 0)[0]
        if zeros.size == 0:
            continue
        if zeros[0] == 0:
            lengths[i] = zeros[1] if zeros.size > 1 else T
        else:
            lengths[i] = zeros[0]
    return lengths


def mean_imputation(X: np.ndarray, X_time: np.ndarray,
                    mean_features: np.ndarray) -> np.ndarray:
    """Missing entries <- per-feature train means (utils_phy12.py:175-205)."""
    X = X.copy()
    lengths = _time_lengths(X_time)
    t_idx = np.arange(X.shape[1])[None, :, None]
    in_range = t_idx < lengths[:, None, None]
    missing = (X == 0) & in_range
    X[missing] = np.broadcast_to(mean_features[None, None], X.shape)[missing]
    return X


def forward_imputation(X: np.ndarray, X_time: np.ndarray) -> np.ndarray:
    """Missing entries <- last observed value of the channel
    (utils_phy12.py:208-240); leading missing stay 0."""
    X = X.copy()
    lengths = _time_lengths(X_time)
    N, T, F = X.shape
    t_in = np.arange(T)[None, :, None] < lengths[:, None, None]
    obs = (X != 0) & t_in
    # last-observed index per step via cummax of observed positions
    idx = np.where(obs, np.arange(T)[None, :, None], -1)
    idx = np.maximum.accumulate(idx, axis=1)
    filled = np.take_along_axis(X, np.maximum(idx, 0), axis=1)
    out = np.where((X == 0) & t_in & (idx >= 0), filled, X)
    return out


def cubic_spline_imputation(X: np.ndarray, X_time: np.ndarray) -> np.ndarray:
    """Cubic-spline interpolation per channel with flat extrapolation
    (utils_phy12.py:243-287)."""
    from scipy.interpolate import CubicSpline

    X = X.copy()
    lengths = _time_lengths(X_time)
    N, T, F = X.shape
    for i in range(N):
        L = lengths[i]
        t = X_time[i, :L]
        for j in range(F):
            ts = X[i, :L, j]
            nz = np.nonzero(ts)[0]
            if len(nz) <= 1:
                continue
            zeros = np.where(ts == 0)[0]
            cs = CubicSpline(t[nz], ts[nz])
            ts[zeros] = cs(t[zeros])
            ts[: nz[0]] = ts[nz[0]]
            ts[nz[-1]:] = ts[nz[-1]]
            X[i, :L, j] = ts
    return X


def knn_imputation(X: np.ndarray, X_time: Optional[np.ndarray] = None,
                   n_neighbors: int = 10) -> np.ndarray:
    """sklearn KNNImputer (imputations.py:72-98).

    Reference semantics when X_time [N, T] is given: only zeros inside each
    sample's observed window become NaN, samples are flattened to
    [N, T*F] rows (patients are the kNN population), n_neighbors=10, and
    residual NaNs are zeroed. (The reference keeps the imputed values via
    KNNImputer(copy=False) mutating its input in place and discarding the
    return value — numerically identical to using the returned array.)
    Without X_time, falls back to per-observation [N*T, F] imputation.
    """
    from sklearn.impute import KNNImputer

    N, T, F = X.shape
    if X_time is not None:
        X = X.astype(np.float64).copy()
        lengths = _time_lengths(X_time)
        for i in range(N):
            w = X[i, :lengths[i], :]
            w[w == 0] = np.nan
        flat = X.reshape(N, T * F)
        out = KNNImputer(n_neighbors=n_neighbors, weights="uniform",
                         metric="nan_euclidean").fit_transform(flat)
        # fit_transform drops all-NaN columns; restore full width
        full = flat.copy()
        full[:, ~np.all(np.isnan(flat), axis=0)] = out
        return np.nan_to_num(full).reshape(N, T, F).astype(np.float32)
    flat = X.reshape(N * T, F).astype(np.float64)
    flat[flat == 0] = np.nan
    out = KNNImputer(n_neighbors=n_neighbors).fit_transform(flat)
    return np.nan_to_num(out).reshape(N, T, F).astype(X.dtype)


def mice_imputation(X: np.ndarray, max_iter: int = 10) -> np.ndarray:
    """sklearn IterativeImputer (MICE) (imputations.py:101-123).

    Deviation, deliberate: the reference DISCARDS IterativeImputer's return
    value and (unlike its kNN path) has no copy=False in-place side effect,
    so its MICE output is the input with NaNs written into the missing
    positions — a latent bug that would poison downstream tensorization.
    Here the imputed result is actually used.
    """
    from sklearn.experimental import enable_iterative_imputer  # noqa: F401
    from sklearn.impute import IterativeImputer

    N, T, F = X.shape
    flat = X.reshape(N * T, F).astype(np.float64)
    flat[flat == 0] = np.nan
    out = IterativeImputer(max_iter=max_iter,
                           random_state=0).fit_transform(flat)
    return np.nan_to_num(out).reshape(N, T, F).astype(X.dtype)


def features_mean(X: np.ndarray) -> np.ndarray:
    """Per-feature mean over POSITIVE entries of the training set
    (reference get_features_mean, utils_phy12.py:159-172) — the means fed
    to mean_imputation for train/val/test alike."""
    flat = X.reshape(-1, X.shape[-1])
    with np.errstate(invalid="ignore"):
        sums = np.where(flat > 0, flat, 0.0).sum(axis=0)
        counts = (flat > 0).sum(axis=0)
    return np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)


def impute(X: np.ndarray, X_time: np.ndarray, method: str,
           train_means: Optional[np.ndarray] = None) -> np.ndarray:
    """Dispatch one named imputation over raw [N, T, F] values — the
    Trans-mean family switch (reference Transformer_baseline.py:178-191,
    applied per split portion BEFORE tensorize/normalize, with TRAIN means
    reused for val/test in 'mean' mode).

    The reference parameterizes missing_value_num (-1 for eICU,
    Transformer_baseline.py:173-176); this module implements the
    0-is-missing convention of the shipped datasets — eICU's raw tensors
    are not distributed with the reference, so its -1 path is untestable
    and intentionally unimplemented.
    """
    if method == "mean":
        if train_means is None:
            train_means = features_mean(X)
        return mean_imputation(X, X_time, np.asarray(train_means))
    if method == "forward":
        return forward_imputation(X, X_time)
    if method == "cubic_spline":
        return cubic_spline_imputation(X, X_time)
    if method == "knn":
        return knn_imputation(X, X_time)
    if method == "mice":
        return mice_imputation(X)
    raise ValueError(f"unknown imputation {method!r}; options: mean, "
                     f"forward, cubic_spline, knn, mice")
