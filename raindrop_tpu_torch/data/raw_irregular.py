"""Raw irregular-series parsers, the mTAND data stack's dataset classes (the
port's own numpy copy of raindrop_tpu/data/raw_irregular.py).

The reference's two self-contained dataset loaders:

  * PhysioNet challenge-2012 raw records
    (reference code/baselines/mTAND/physionet.py:42-230): per-patient
    ``HH:MM,param,value`` text files parsed into quantized time bins with
    in-bin averaging of repeated observations, plus the Outcomes-*.txt
    label table (mortality = column 4).
  * UCI "Localization Data for Person Activity"
    (reference code/baselines/mTAND/person_activity.py:11-231): 4 body
    tags x 3 coordinate axes, 100 ms quantization, per-timestep activity
    labels with the reference's 11->7 class merge, and sliding-window
    chunking into fixed-length sub-records.

Differences from the reference, by design: no network downloaders (the
parsers read local files or line iterables; ``acquire_physionet`` raises
with the URL list when asked to download), host-side numpy only, and the
output is ``RaggedRecord``, so everything downstream (``data/collate.py``'s
min/max normalization and padding collate, ``baselines/mtand.py``) applies
unchanged. The union-timeline batch collate
(person_activity.py:234-291, ``variable_time_collate_fn_activity``) is
``union_time_collate`` below.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from raindrop_tpu_torch.data.collate import RaggedRecord

# ---------------------------------------------------------------------------
# PhysioNet challenge-2012 (reference physionet.py)
# ---------------------------------------------------------------------------

# reference physionet.py:50-56
PHYSIONET_PARAMS = [
    "Age", "Gender", "Height", "ICUType", "Weight", "Albumin", "ALP", "ALT",
    "AST", "Bilirubin", "BUN", "Cholesterol", "Creatinine", "DiasABP", "FiO2",
    "GCS", "Glucose", "HCO3", "HCT", "HR", "K", "Lactate", "Mg", "MAP",
    "MechVent", "Na", "NIDiasABP", "NIMAP", "NISysABP", "PaCO2", "PaO2", "pH",
    "Platelets", "RespRate", "SaO2", "SysABP", "Temp", "TroponinI",
    "TroponinT", "Urine", "WBC",
]
_PHYSIONET_PARAM_IDX = {k: i for i, k in enumerate(PHYSIONET_PARAMS)}

# reference physionet.py:61
PHYSIONET_OUTCOME_LABELS = [
    "SAPS-I", "SOFA", "Length_of_stay", "Survival", "In-hospital_death",
]


def parse_physionet_outcomes(lines: Iterable[str]) -> Dict[str, np.ndarray]:
    """Outcomes-*.txt -> {record_id: float label vector [5]}.

    Reference physionet.py:117-124: header line skipped, comma-split,
    first field is the record id. Mortality is ``labels[4]``
    (physionet.py:190-192).
    """
    lines = list(lines)
    outcomes: Dict[str, np.ndarray] = {}
    for line in lines[1:]:
        parts = line.rstrip().split(",")
        outcomes[parts[0]] = np.asarray(parts[1:], np.float64)
    return outcomes


def parse_physionet_record(
    record_id: str,
    lines: Iterable[str],
    quantization: float = 0.1,
    reduce: str = "average",
    label: int = -1,
) -> RaggedRecord:
    """One raw patient file -> RaggedRecord with quantized time bins.

    Reproduces reference physionet.py:141-185 exactly:

      * line format ``HH:MM,param,value``; header (first line) skipped;
        time in hours = HH + MM/60 (physionet.py:156-157);
      * timestamps rounded to multiples of ``quantization`` hours
        (``round(t/q)*q``, Python round-half-to-even — physionet.py:159);
      * the sequence STARTS with an all-zero t=0 bin even when nothing is
        observed at t=0 (physionet.py:148-151);
      * a new bin opens whenever the quantized time differs from the
        PREVIOUS line's (consecutive comparison — out-of-order files
        produce duplicate bins, as in the reference) (physionet.py:161-167);
      * repeated observations of one param inside a bin are averaged when
        ``reduce == 'average'`` (running mean via per-bin observation
        counts), else last-write-wins (physionet.py:169-179);
      * any param name outside the table must be ``RecordID``
        (physionet.py:180-181).
    """
    F = len(PHYSIONET_PARAMS)
    lines = list(lines)
    prev_time = 0.0
    tt: List[float] = [0.0]
    vals: List[np.ndarray] = [np.zeros(F, np.float32)]
    mask: List[np.ndarray] = [np.zeros(F, np.float32)]
    nobs: List[np.ndarray] = [np.zeros(F, np.float32)]
    for line in lines[1:]:
        time_s, param, val = line.strip().split(",")
        hh, mm = time_s.split(":")
        time = float(hh) + float(mm) / 60.0
        time = round(time / quantization) * quantization
        if time != prev_time:
            tt.append(time)
            vals.append(np.zeros(F, np.float32))
            mask.append(np.zeros(F, np.float32))
            nobs.append(np.zeros(F, np.float32))
            prev_time = time
        if param in _PHYSIONET_PARAM_IDX:
            j = _PHYSIONET_PARAM_IDX[param]
            n = nobs[-1][j]
            if reduce == "average" and n > 0:
                vals[-1][j] = (vals[-1][j] * n + float(val)) / (n + 1)
            else:
                vals[-1][j] = float(val)
            mask[-1][j] = 1.0
            nobs[-1][j] += 1.0
        elif param != "RecordID":
            raise ValueError(f"Read unexpected param {param!r}")
    return RaggedRecord(record_id, np.asarray(tt, np.float32),
                        np.stack(vals), np.stack(mask), label)


PHYSIONET_URLS = [
    # the acquisition manifest of the reference downloader
    # (code/baselines/mTAND/physionet.py:46-50,104-133): raw record
    # tarballs + outcome tables, extracted then parsed + cached as
    # processed .pt files
    "https://physionet.org/files/challenge-2012/1.0.0/set-a.tar.gz",
    "https://physionet.org/files/challenge-2012/1.0.0/set-b.tar.gz",
    "https://physionet.org/files/challenge-2012/1.0.0/Outcomes-a.txt",
    "https://physionet.org/files/challenge-2012/1.0.0/Outcomes-b.txt",
]


def acquire_physionet(root: str, quantization: float = 0.1,
                      download: bool = False):
    """The reference mTAND stack's dataset-acquisition layer
    (code/baselines/mTAND/physionet.py:104-233: URL fetch -> tarball
    extract -> parse -> processed-file cache), over local files only.

    Looks for ALREADY-EXTRACTED set directories under ``root``
    (``set-a/``, ``set-b/`` with ``Outcomes-*.txt`` beside them — the
    layout the reference's extractor produces) and parses whatever is
    present via :func:`load_physionet_dir`. ``download=True`` raises with
    the exact URL manifest: nothing here fetches from the network, so
    acquisition is a documented manual step.

    Returns {"set-a": [RaggedRecord...], "set-b": [...]} for the sets
    found (missing sets are absent from the dict).
    """
    if download:
        raise RuntimeError(
            "network acquisition is disabled (nothing is downloaded); "
            "manually download + extract into " + repr(root) + ": "
            + ", ".join(PHYSIONET_URLS))
    out = {}
    for set_name, outcome_name in (("set-a", "Outcomes-a.txt"),
                                   ("set-b", "Outcomes-b.txt")):
        set_dir = os.path.join(root, set_name)
        if not os.path.isdir(set_dir) or not os.listdir(set_dir):
            continue
        outcomes = None
        opath = os.path.join(root, outcome_name)
        if os.path.exists(opath):
            with open(opath) as f:
                outcomes = parse_physionet_outcomes(f)
        out[set_name] = load_physionet_dir(
            set_dir, outcomes, quantization=quantization)
    if not out:
        raise FileNotFoundError(
            "no extracted PhysioNet set directories under " + repr(root)
            + " (expected set-a/ / set-b/); acquire manually from: "
            + ", ".join(PHYSIONET_URLS))
    return out


def load_physionet_dir(
    dirname: str,
    outcomes: Optional[Dict[str, np.ndarray]] = None,
    quantization: float = 0.1,
    reduce: str = "average",
    n_samples: Optional[int] = None,
) -> List[RaggedRecord]:
    """Parse a directory of raw ``<RecordID>.txt`` files (a set-a/set-b
    extraction, reference physionet.py:140-196). ``outcomes`` maps record
    ids to label vectors; records without outcomes get label -1 (the
    reference's ``labels=None`` for the unlabeled test set)."""
    records = []
    for txtfile in sorted(os.listdir(dirname)):
        if not txtfile.endswith(".txt"):
            continue
        record_id = txtfile.split(".")[0]
        with open(os.path.join(dirname, txtfile)) as f:
            lines = f.readlines()
        label = -1
        if outcomes is not None and record_id in outcomes:
            label = int(outcomes[record_id][4])    # In-hospital_death
        records.append(parse_physionet_record(
            record_id, lines, quantization=quantization,
            reduce=reduce, label=label))
        if n_samples is not None and len(records) >= n_samples:
            break
    return records


# ---------------------------------------------------------------------------
# UCI Person Activity (reference person_activity.py)
# ---------------------------------------------------------------------------

# reference person_activity.py:16-23
ACTIVITY_TAG_IDS = [
    "010-000-024-033",   # ANKLE_LEFT
    "010-000-030-096",   # ANKLE_RIGHT
    "020-000-033-111",   # CHEST
    "020-000-032-221",   # BELT
]
_ACTIVITY_TAG_IDX = {k: i for i, k in enumerate(ACTIVITY_TAG_IDS)}

# reference person_activity.py:25-37
ACTIVITY_LABEL_NAMES = [
    "walking", "falling", "lying down", "lying", "sitting down", "sitting",
    "standing up from lying", "on all fours", "sitting on the ground",
    "standing up from sitting", "standing up from sit on grnd",
]

# the reference's 11 -> 7 class merge (person_activity.py:41-54); the
# per-timestep label vector keeps length 11, only indices 0..6 are used —
# a reference quirk preserved here.
ACTIVITY_LABEL_DICT = {
    "walking": 0,
    "falling": 1,
    "lying": 2,
    "lying down": 2,
    "sitting": 3,
    "sitting down": 3,
    "standing up from lying": 4,
    "standing up from sitting": 4,
    "standing up from sit on grnd": 4,
    "on all fours": 5,
    "sitting on the ground": 6,
}


def person_id(record_id: str) -> int:
    """First letter of the record id, A=0 (person_activity.py:226-230)."""
    return ord(record_id[0]) - ord("A")


def _chunk_record(records, record_id, tt, vals, mask, labels,
                  max_seq_length: int):
    """save_record (person_activity.py:88-112): flatten tag x axis to 12
    features and slide a half-overlapping window of ``max_seq_length``
    timesteps; the tail shorter than a full window is DROPPED (so a series
    with <= max_seq_length bins yields no records — reference behavior)."""
    tt = np.asarray(tt, np.float32)
    vals = np.stack(vals).reshape(len(tt), -1)
    mask = np.stack(mask).reshape(len(tt), -1)
    labels = np.stack(labels)
    offset, slide = 0, max_seq_length // 2
    while offset + max_seq_length < len(tt):
        idx = slice(offset, offset + max_seq_length)
        records.append((record_id, tt[idx] - tt[idx][0],
                        vals[idx].astype(np.float32),
                        mask[idx].astype(np.float32),
                        labels[idx].astype(np.float32)))
        offset += slide


def parse_person_activity(
    lines: Iterable[str],
    max_seq_length: int = 50,
    reduce: str = "average",
) -> List[tuple]:
    """ConfLongDemo_JSI.txt -> list of chunked activity records.

    Reference person_activity.py:113-189: lines are
    ``record_id,tag_id,timestamp,date,x,y,z,label``; per contiguous
    record-id run, timestamps are re-based to the first observation and
    quantized by 1e5 (100 ms, person_activity.py:149-155); each quantized
    bin holds a [4 tags, 3 axes] value block (averaged per tag when
    ``reduce='average'``), a mask row per tag, and an 11-wide label vector
    set once per bin via the 11->7 merge table. Records are flattened to
    12 features and chunked by ``_chunk_record``.
    """
    records: List[tuple] = []
    T, A = len(ACTIVITY_TAG_IDS), 3
    L = len(ACTIVITY_LABEL_NAMES)
    record_id = None
    tt: List[float] = []
    vals: List[np.ndarray] = []
    mask: List[np.ndarray] = []
    nobs: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    first_tp = 0.0
    prev_time = -1.0
    for line in lines:
        cur_id, tag_id, time_s, _date, v1, v2, v3, label = \
            line.strip().split(",")
        value_vec = np.asarray([float(v1), float(v2), float(v3)], np.float32)
        time = float(time_s)
        if cur_id != record_id:
            if record_id is not None:
                _chunk_record(records, record_id, tt, vals, mask, labels,
                              max_seq_length)
            record_id = cur_id
            tt = [0.0]
            vals = [np.zeros((T, A), np.float32)]
            mask = [np.zeros((T, A), np.float32)]
            nobs = [np.zeros(T, np.float32)]
            labels = [np.zeros(L, np.float32)]
            first_tp = time
            time = round((time - first_tp) / 10 ** 5)
            prev_time = time
        else:
            time = round((time - first_tp) / 10 ** 5)   # 100 ms bins
        if time != prev_time:
            tt.append(time)
            vals.append(np.zeros((T, A), np.float32))
            mask.append(np.zeros((T, A), np.float32))
            nobs.append(np.zeros(T, np.float32))
            labels.append(np.zeros(L, np.float32))
            prev_time = time
        if tag_id in _ACTIVITY_TAG_IDX:
            j = _ACTIVITY_TAG_IDX[tag_id]
            n = nobs[-1][j]
            if reduce == "average" and n > 0:
                vals[-1][j] = (vals[-1][j] * n + value_vec) / (n + 1)
            else:
                vals[-1][j] = value_vec
            mask[-1][j] = 1.0
            nobs[-1][j] += 1.0
            if label in ACTIVITY_LABEL_DICT:
                k = ACTIVITY_LABEL_DICT[label]
                if labels[-1][k] == 0:
                    labels[-1][k] = 1.0
        elif tag_id != "RecordID":
            raise ValueError(f"Read unexpected tag id {tag_id!r}")
    if record_id is not None:
        _chunk_record(records, record_id, tt, vals, mask, labels,
                      max_seq_length)
    return records


def load_person_activity(path: str, max_seq_length: int = 50,
                         reduce: str = "average") -> List[tuple]:
    with open(path) as f:
        return parse_person_activity(f, max_seq_length=max_seq_length,
                                     reduce=reduce)


def union_time_collate(batch: Sequence[tuple]) -> Dict[str, np.ndarray]:
    """Union-timeline batch collate for per-timestep-labeled records
    (reference person_activity.py:234-291,
    ``variable_time_collate_fn_activity``).

    combined time axis = sorted union of every record's timestamps; each
    record's observations scatter to their union positions (same-time
    collisions overwrite, as in the reference); timestamps divided by the
    batch max. Returns {"data" [B,L,D], "time_steps" [L],
    "mask" [B,L,D], "labels" [B,L,N]}.
    """
    D = batch[0][2].shape[1]
    N = batch[0][4].shape[1]
    all_tt = np.concatenate([np.asarray(ex[1], np.float32) for ex in batch])
    combined_tt, inverse = np.unique(all_tt, return_inverse=True)
    Lc = combined_tt.shape[0]
    B = len(batch)
    combined_vals = np.zeros((B, Lc, D), np.float32)
    combined_mask = np.zeros((B, Lc, D), np.float32)
    combined_labels = np.zeros((B, Lc, N), np.float32)
    offset = 0
    for b, (_rid, tt, vals, mask, labels) in enumerate(batch):
        idx = inverse[offset:offset + len(tt)]
        offset += len(tt)
        combined_vals[b, idx] = vals
        combined_mask[b, idx] = mask
        combined_labels[b, idx] = labels
    if combined_tt.max(initial=0.0) != 0.0:
        combined_tt = combined_tt / combined_tt.max()
    return {"data": combined_vals, "time_steps": combined_tt,
            "mask": combined_mask, "labels": combined_labels}
