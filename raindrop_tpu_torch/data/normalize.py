"""Host-side normalization with the reference's semantics, vectorised
(the port's own numpy copy of raindrop_tpu/data/normalize.py; the JAX
package's optional C++ host runtime is not carried over).

Conventions:
  * a value is "observed" iff it is > 0;
  * z-score with the train portion's statistics, missing entries zeroed
    again, then the observed mask concatenated -> [N, T, 2F];
  * static statistics: the reference's loop over them never runs, so with
    `compat=True` (default) the means stay 0 and the stds 1 and
    mask_normalize_static only zeroes entries <= 0; `compat=False` gives
    the intended z-score of the continuous features;
  * P12/P19/eICU times are minutes / 60 -> hours; PAM gets a synthetic
    linspace(0, T, T) / 60 timeline.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Which static features are categorical, per dataset.
STATIC_CATEGORICAL = {
    "P12": np.array([0, 1, 1, 0, 1, 1, 1, 1, 0], bool),
    "P19": np.array([0, 1, 0, 0, 0, 0], bool),
    "eICU": np.array([1] * 397 + [0] * 2, bool),
}


def get_stats(P: np.ndarray, eps: float = 1e-7) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sensor mean and std over the strictly positive entries of
    P [N, T, F]. Returns (mf [F], stdf [F]); stdf floored at eps."""
    F = P.shape[-1]
    flat = P.reshape(-1, F)
    obs = flat > 0
    cnt = obs.sum(axis=0)
    safe = np.maximum(cnt, 1)
    mf = np.where(cnt > 0, (flat * obs).sum(axis=0) / safe, np.nan)
    var = (((flat - mf[None]) * obs) ** 2).sum(axis=0) / safe
    stdf = np.maximum(np.sqrt(var), eps)
    return mf, stdf


def mask_normalize(P: np.ndarray, mf: np.ndarray, stdf: np.ndarray) -> np.ndarray:
    """z-score, zero the missing entries, concatenate the mask -> [N, T, 2F]."""
    M = (P > 0).astype(P.dtype)
    Pn = (P - mf[None, None]) / (stdf[None, None] + 1e-18) * M
    return np.concatenate([Pn, M], axis=2)


def get_stats_static(Ps: np.ndarray, dataset: str = "P12", compat: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Static-feature statistics (see the module docstring for `compat`)."""
    S = Ps.shape[1]
    ms = np.zeros(S)
    ss = np.ones(S)
    if compat:
        return ms, ss
    cat = STATIC_CATEGORICAL[dataset]
    obs = Ps > 0
    cnt = obs.sum(axis=0)
    safe = np.maximum(cnt, 1)
    mean = (Ps * obs).sum(axis=0) / safe
    std = np.sqrt((((Ps - mean[None]) * obs) ** 2).sum(axis=0) / safe)
    return np.where(cat, 0.0, mean), np.where(cat, 1.0, std)


def mask_normalize_static(Ps: np.ndarray, ms: np.ndarray, ss: np.ndarray) -> np.ndarray:
    """z-score the statics, then zero the entries that END UP <= 0 (the
    reference zeroes after normalising, not the entries missing before)."""
    Pn = (Ps - ms[None]) / (ss[None] + 1e-18)
    return np.where(Pn <= 0, 0.0, Pn)


def tensorize_normalize(arrs, times, statics, y, mf, stdf, ms, ss):
    """P12/P19/eICU: arrs [N, T, F] raw values, times [N, T] minutes,
    statics [N, S] -> (P [N, T, 2F] f32, Pstatic [N, S] f32, Ptime [N, T]
    hours f32, y [N] int32)."""
    P = mask_normalize(arrs.astype(np.float64), mf, stdf).astype(np.float32)
    Pt = (times.astype(np.float64) / 60.0).astype(np.float32)
    Ps = mask_normalize_static(statics.astype(np.float64), ms, ss).astype(np.float32)
    return P, Ps, Pt, np.asarray(y).reshape(-1).astype(np.int32)


def tensorize_normalize_no_static(arrs: np.ndarray, y: np.ndarray, mf, stdf):
    """PAM: no statics, a synthetic uniform timeline."""
    N, T, _ = arrs.shape
    P = mask_normalize(arrs.astype(np.float64), mf, stdf).astype(np.float32)
    tim = (np.linspace(0, T, T) / 60.0).astype(np.float32)
    Pt = np.broadcast_to(tim[None], (N, T)).copy()
    return P, None, Pt, np.asarray(y).reshape(-1).astype(np.int32)
