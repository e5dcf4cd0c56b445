"""mTAND-style ragged-record data stack, the padding collate (the port's own
numpy copy of raindrop_tpu/data/collate.py).

The reference's mTAND baseline carries its own data pipeline next to the
shared one: per-patient *ragged* (record_id, tt, vals, mask, label) tuples
(reference code/baselines/mTAND/utils.py:196-299, preprocess_P19/eICU/PAM),
dataset-wide per-feature min/max over observed values
(mTAND/physionet.py:10-44, get_data_min_max), and a padding collate that
min-max-normalizes values and scales timestamps into [0, 1]
(mTAND/utils.py:569-622, variable_time_collate_fn). Here everything is
host-side numpy producing fixed-shape arrays, which the caller moves to the
card; the quirks of the reference normalization are kept verbatim:

  * values are normalized (x - min) / max — divided by the raw maximum, NOT
    (max - min) (mTAND/utils.py:51-58, normalize_masked_data);
  * per-feature max == 0 is replaced by 1 before dividing (physionet-style);
  * missing entries are re-zeroed after normalization;
  * timestamps are divided by the BATCH max time (utils.py:613-614), so the
    time scale is collate-batch dependent;
  * the model input is the concat [vals ‖ mask ‖ tt] of width 2D+1
    (utils.py:616-617).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class RaggedRecord(NamedTuple):
    """One sample's irregular observations (reference mTAND tuple minus the
    torch tensors): times [L], values [L, D], mask [L, D], integer label."""
    record_id: str
    tt: np.ndarray
    vals: np.ndarray
    mask: np.ndarray
    label: int


def records_from_dense(values: np.ndarray, times: np.ndarray,
                       labels: np.ndarray,
                       lengths: Optional[np.ndarray] = None
                       ) -> List[RaggedRecord]:
    """Dense padded artifacts -> ragged records.

    Mirrors reference preprocess_P19 (mTAND/utils.py:196-207): trim each
    sample to its length (default: number of nonzero timestamps, the shared
    lengths convention, code/Raindrop.py:317), mask = (value != 0).

    values: [N, T, D] raw (un-normalized) observations, 0 = missing.
    times:  [N, T] or [N, T, 1] timestamps.
    """
    times = np.asarray(times)
    if times.ndim == 3:
        times = times[..., 0]
    values = np.asarray(values, np.float32)
    if lengths is None:
        lengths = np.maximum((times > 0).sum(axis=1), 1)
    out = []
    for i in range(values.shape[0]):
        L = int(lengths[i])
        v = values[i, :L]
        out.append(RaggedRecord(str(i), times[i, :L].astype(np.float32),
                                v, (v != 0).astype(np.float32),
                                int(labels[i])))
    return out


def data_min_max(records: Sequence[RaggedRecord]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature min/max over OBSERVED values across the whole dataset
    (reference mTAND/physionet.py:10-44). Features never observed get
    (+inf, -inf), later neutralized by the max==0 -> 1 guard."""
    D = records[0].vals.shape[-1]
    dmin = np.full((D,), np.inf, np.float32)
    dmax = np.full((D,), -np.inf, np.float32)
    for r in records:
        dmin = np.minimum(dmin, np.where(r.mask > 0, r.vals, np.inf).min(0))
        dmax = np.maximum(dmax, np.where(r.mask > 0, r.vals, -np.inf).max(0))
    return dmin, dmax


def variable_time_collate(records: Sequence[RaggedRecord],
                          data_min: Optional[np.ndarray] = None,
                          data_max: Optional[np.ndarray] = None,
                          normalize: bool = True,
                          max_len: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a batch of ragged records to a common length and pack the mTAND
    model input (reference mTAND/utils.py:569-622).

    Returns (combined [B, L, 2D+1], labels [B]): values min-max normalized
    with the reference's (x - min) / max rule and re-zeroed where missing,
    then concatenated with the mask and the batch-max-scaled timestamps.
    `max_len` pins L to a fixed shape; default is the batch's max
    length (the reference behavior).
    """
    B = len(records)
    D = records[0].vals.shape[-1]
    L = max_len if max_len is not None else max(r.tt.shape[0] for r in records)
    tt = np.zeros((B, L), np.float32)
    vals = np.zeros((B, L, D), np.float32)
    mask = np.zeros((B, L, D), np.float32)
    labels = np.zeros((B,), np.int64)
    for b, r in enumerate(records):
        n = min(r.tt.shape[0], L)
        tt[b, :n] = r.tt[:n]
        vals[b, :n] = r.vals[:n]
        mask[b, :n] = r.mask[:n]
        labels[b] = r.label
    if normalize:
        if data_min is None or data_max is None:
            data_min, data_max = data_min_max(records)
        dmax = np.where(np.asarray(data_max) == 0.0, 1.0, data_max)
        vals = (vals - np.where(np.isfinite(data_min), data_min, 0.0)) / dmax
        vals = vals * mask                     # re-zero missing (utils.py:64)
    tmax = tt.max()
    if tmax != 0.0:
        tt = tt / tmax                          # batch-max scaling (:613-614)
    combined = np.concatenate([vals, mask, tt[..., None]], axis=-1)
    return combined.astype(np.float32), labels
