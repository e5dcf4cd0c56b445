"""Experimental Settings 2-4 (the port's own numpy copy of
raindrop_tpu/data/settings.py): sensor removal and the demographic splits.

Setting 2 (leave-fixed-sensors-out): zero the n most informative sensors in
val and test, ranked from an information-gain file or array (reference
code/Raindrop.py:227-231; the ranking's producer is
code/baselines/RF_information_gain.py).

Setting 3 (leave-random-sensors-out): a random sensor subset per sample,
zeroed in val and test (reference code/Raindrop.py:218-226).

Setting 4 (group-wise): a demographic train / eval partition (the producer
logic of the commented block at reference code/utils_rd.py:44-72).

Every transform is seeded, runs on the host and touches the raw value
columns only (columns :F of the [N, T, 2F] tensor), as the reference does
when it zeroes Pval_tensor[:, :, idx] with idx < F: the mask columns F: are
left as they were (a reference quirk: the model still sees the "observed"
flags of a removed sensor's original observations). Given the same numpy
Generator state both packages zero the same entries.

`information_gain_ranking` imports scikit-learn when called; without it
that call raises ImportError.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def remove_sensors_fixed(P: np.ndarray, ranked_sensor_idx: np.ndarray,
                         missing_ratio: float) -> np.ndarray:
    """Setting 2: zero the top `round(ratio*F)` ranked sensors' value columns
    (reference code/Raindrop.py:227-231). P: [N, T, 2F]; returns a copy."""
    F = P.shape[2] // 2
    n_missing = round(missing_ratio * F)
    out = P.copy()
    idx = np.asarray(ranked_sensor_idx)[:n_missing].astype(int)
    out[:, :, idx] = 0.0
    return out


def remove_sensors_random(P: np.ndarray, missing_ratio: float,
                          rng: np.random.Generator) -> np.ndarray:
    """Setting 3: per-sample random sensor subset zeroed
    (reference code/Raindrop.py:218-226). P: [N, T, 2F]; returns a copy."""
    F = P.shape[2] // 2
    n_missing = round(missing_ratio * F)
    out = P.copy()
    for i in range(P.shape[0]):  # per-sample numpy RNG, host-side by design
        idx = rng.choice(F, n_missing, replace=False)
        out[i][:, idx] = 0.0
    return out


def information_gain_ranking(X: np.ndarray, y: np.ndarray,
                             seed: int = 0) -> np.ndarray:
    """Rank sensors by single-sensor RandomForest AUROC, descending — the
    Setting-2 ranking producer (reference code/baselines/RF_information_gain.py:47-98,
    which fits one RF per sensor on its [T]-flattened values and argsorts the
    val AUROCs descending).

    X: [N, T, F] normalized values; y: [N] binary labels.
    Returns [F] sensor indices, most informative first.
    """
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.metrics import roc_auc_score
    from sklearn.model_selection import train_test_split

    N, T, F = X.shape
    scores = np.zeros(F)
    for f in range(F):
        Xf = X[:, :, f]
        Xtr, Xte, ytr, yte = train_test_split(
            Xf, y, test_size=0.2, random_state=seed, stratify=y)
        clf = RandomForestClassifier(n_estimators=20, random_state=seed, n_jobs=-1)
        clf.fit(Xtr, ytr)
        prob = clf.predict_proba(Xte)
        scores[f] = roc_auc_score(yte, prob[:, 1]) if prob.shape[1] == 2 else 0.5
    return np.argsort(-scores)


def demographic_indices(statics: np.ndarray, dataset: str,
                        split_type: str) -> Tuple[np.ndarray, np.ndarray]:
    """Setting-4 group membership from extended_static rows.

    P12 layout ['Age','Gender=0','Gender=1','Height','ICUType=1..4','Weight']
    (reference code/utils_rd.py:59); P19 layout ['Age','Gender','Unit1',
    'Unit2','HospAdmTime','ICULOS'] (code/utils_rd.py:188).

    Returns (group_a, group_b) index arrays:
      age    -> (under_65, over_65)   [age>0 required, reference :60-65]
      gender -> (male, female)        [reference trains on male by default,
                                       code/utils_rd.py:119]
    """
    statics = np.asarray(statics)
    if split_type == "age":
        age = statics[:, 0]
        known = age > 0
        return (np.where(known & (age < 65))[0], np.where(known & (age >= 65))[0])
    if split_type == "gender":
        if dataset == "P12":
            female = statics[:, 1] == 1   # Gender=0 one-hot column
            male = statics[:, 2] == 1     # Gender=1 one-hot column
        elif dataset == "P19":
            male = statics[:, 1] == 1
            female = statics[:, 1] == 0
        else:
            raise ValueError(f"no gender layout for dataset {dataset!r}")
        return np.where(male)[0], np.where(female)[0]
    raise ValueError(f"unknown split_type {split_type!r}")
