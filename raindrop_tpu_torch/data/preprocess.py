"""Offline dataset preprocessing: raw PhysioNet text -> .npy artifacts (the
port of raindrop_tpu/data/preprocess.py).

Reimplements the reference's one-shot scripts as a CLI (reference
P12data/process_scripts/: ParseData.py, IrregularSampling.py,
remove_outliers.py, Generate_splitID.py, sanity_check.py; the PAM and P19
splits follow the same 8:1:1 recipe), writing the artifact schema that
`data/datasets.load_split` reads:

  processed_data/arr_outcomes.npy    [N, 6] outcome table
  processed_data/ts_params.npy       the 36 time-series parameter names
  processed_data/static_params.npy / extended_static_params.npy
  processed_data/PTdict_list.npy     per-patient dicts {'id', 'static',
      'extended_static', 'arr' [215, 36], 'time' [215, 1], 'length'}
  splits/phy12_split{1..5}.npy       (idx_train, idx_val, idx_test)

Usage:
  python -m raindrop_tpu_torch.data.preprocess parse   --raw P12data/rawdata --out P12data/processed_data
  python -m raindrop_tpu_torch.data.preprocess splits  --n 11988 --out P12data/splits --prefix phy12_split
  python -m raindrop_tpu_torch.data.preprocess sanity  --root P12data
  python -m raindrop_tpu_torch.data.preprocess grud    --root P12data --out saved/
  python -m raindrop_tpu_torch.data.preprocess ig      --root P12data --dataset P12 --out ig.npy

No pandas: the reference scripts (and the JAX package) read the text
files with `pandas.read_csv`, which the card's machine does not have.
`read_table` reads them with the standard `csv` module and gives the
values pandas gives (the lines it consumes, its missing-value strings and
its column types), so the artifacts are the same array for array. Values
are the raw files' short decimals and integers: one with more than 15
digits, in exponent form, or a word among decimals raises ValueError
rather than risk another value than pandas'.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from typing import List, Optional, Sequence

import numpy as np

# Static descriptor layout (reference ParseData.py:82, IrregularSampling.py:36)
STATIC_PARAMS = ["Age", "Gender", "Height", "ICUType", "Weight"]
EXTENDED_STATIC_PARAMS = ["Age", "Gender=0", "Gender=1", "Height",
                          "ICUType=1", "ICUType=2", "ICUType=3", "ICUType=4",
                          "Weight"]
# 12 blacklisted patients (reference remove_outliers.py:8; README.md:75)
P12_BLACKLIST = {"140501", "150649", "140936", "143656", "141264", "145611",
                 "142998", "147514", "142731", "150309", "155655", "156254"}
MAX_TMINS = 48 * 60            # 48h window (IrregularSampling.py:18)
P12_MAX_LEN = 215
OUTCOME_NAMES = ["RecordID", "SAPS-I", "SOFA", "Length_of_stay", "Survival",
                 "In-hospital_death"]

# ------------------------------------------------- pandas.read_csv's values
# the strings read_csv takes for a missing value by default
# (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_SPACE = " \t\n\v\f\r"     # isspace_ascii: read_csv skips no other space
_INT = re.compile(rf"[{_SPACE}]*[-+]?[0-9]+[{_SPACE}]*\Z")
_PLAIN = re.compile(rf"[{_SPACE}]*[-+]?([0-9]*)\.?([0-9]*)[{_SPACE}]*\Z")
# past 15 digits pandas' converter (precise_xstrtod) may read a decimal one
# bit away from float(): '0.30000000000000004' reads 0.3
MAX_DIGITS = 15


def read_float(s: str) -> Optional[float]:
    """The double read_csv reads from a plain decimal `s` (sign, digits, a
    point, no exponent) of at most MAX_DIGITS digits: the correctly rounded
    one, float(s). None where `s` is no plain decimal; ValueError past
    MAX_DIGITS digits, where read_csv's value may differ from float(s)."""
    m = _PLAIN.match(s)
    if not m or not m[1] + m[2]:
        return None
    if len(m[1]) + len(m[2]) > MAX_DIGITS:
        raise ValueError(f"{s!r}: more than {MAX_DIGITS} digits, where "
                         "pandas.read_csv may read another value than float()")
    return float(s)


def _column(cells: Sequence[Optional[str]]) -> list:
    """One column's values as read_csv types them: int64 when every cell is
    an integer and none is missing, else float64 when every present cell is
    a plain decimal (missing ones NaN), else strings when none is (missing
    ones NaN). Numbers come out as Python int and float, as `np.array(df)`
    boxes them. A column mixing decimals with other text, or an integer
    past int64, raises ValueError."""
    present = [c for c in cells if c is not None]
    if len(present) == len(cells) and all(_INT.match(c) for c in present):
        ints = [int(c) for c in present]
        if any(not -2 ** 63 <= v < 2 ** 63 for v in ints):
            raise ValueError("an integer past int64")
        return ints
    floats = [read_float(c) for c in present]
    text = [c for c, f in zip(present, floats) if f is None]
    if text and len(text) < len(present):
        raise ValueError(f"a column of decimals holds {text[0]!r}")
    it = iter(present if text else floats)
    return [float("nan") if c is None else next(it) for c in cells]


def read_table(path: str, header: int, ncols: int) -> List[list]:
    """The columns `pandas.read_csv(path, sep=",", header=header,
    names=<ncols names>)` reads, each a list of its typed values
    (`_column`). Blank lines are skipped before anything is counted, the
    first header + 1 lines are consumed (the header line and every line
    before it), a short row is filled with missing values, and a cell that
    is one of NA_STRINGS is missing. A row with more than `ncols` fields,
    or a value `_column` refuses, raises ValueError (pandas would make
    index columns of a row's first fields)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    rows = rows[header + 1:]
    cols: List[List[Optional[str]]] = [[] for _ in range(ncols)]
    for r in rows:
        if len(r) > ncols:
            raise ValueError(f"{path}: a row of {len(r)} fields, expected {ncols}")
        for j in range(ncols):
            c = r[j] if j < len(r) else ""
            cols[j].append(None if c in NA_STRINGS else c)
    try:
        return [_column(c) for c in cols]
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _frame_array(cols: List[list]) -> np.ndarray:
    """`np.array(df)` of the columns: int64 when every column is, float64
    when every column is numeric, else an object array."""
    def kind(col):
        if all(type(v) is int for v in col):
            return "i"
        return "f" if all(type(v) is float for v in col) else "O"

    kinds = {kind(c) for c in cols}
    dtype = np.int64 if kinds == {"i"} else np.float64 if "O" not in kinds else object
    out = np.empty((len(cols[0]) if cols else 0, len(cols)), dtype=dtype)
    for j, c in enumerate(cols):
        out[:, j] = c
    return out


# ------------------------------------------------------------- the pipeline
def parse_outcomes(raw_dir: str) -> np.ndarray:
    """Outcomes-{a,b,c}.txt -> [N, 6] array (ParseData.py:7-37)."""
    frames = []
    for s in "abc":
        path = os.path.join(raw_dir, f"Outcomes-{s}.txt")
        if os.path.exists(path):
            frames.append(_frame_array(read_table(path, 0, len(OUTCOME_NAMES))))
    return np.concatenate(frames, axis=0)


def _record_rows(path: str) -> list:
    """(time, param, value) rows of one record file, as the reference's
    `np.array(pd.read_csv(path, header=1, names=[...]))` holds them: the
    header line and the line after it (RecordID in the real files) are
    consumed."""
    return list(zip(*read_table(path, 1, 3)))


def parse_patients(raw_dir: str, ts_params: Optional[List[str]] = None):
    """Per-patient record files -> P_list dicts (ParseData.py:88-122).

    When ts_params is None the parameter vocabulary is extracted from the
    data, excluding the 5 static fields (ParseData.py:59-75).
    """
    set_dirs = sorted(d for d in os.listdir(raw_dir)
                      if d.startswith("set-")
                      and os.path.isdir(os.path.join(raw_dir, d)))
    records = []
    for d in set_dirs:
        for f in sorted(os.listdir(os.path.join(raw_dir, d))):
            if f.endswith(".txt"):
                records.append(os.path.join(raw_dir, d, f))

    if ts_params is None:
        vocab = set()
        for path in records:
            # df["param"].dropna(): a missing name is a float NaN
            vocab.update(str(p) for _, p, _ in _record_rows(path) if p == p)
        vocab -= set(STATIC_PARAMS) | {"nan"}
        ts_params = sorted(vocab)

    P_list = []
    for path in records:
        rows = _record_rows(path)
        static = tuple(rows[i][2] for i in range(5))  # first 5 rows = statics
        ts_list = []
        for t, param, value in rows[5:]:
            if param in ts_params:
                hrs, mins = float(str(t)[0:2]), float(str(t)[3:5])
                ts_list.append((hrs, mins, 60.0 * hrs + mins, param, value))
        P_list.append({"id": os.path.splitext(os.path.basename(path))[0],
                       "static": static, "ts": ts_list})
    return P_list, ts_params


def extended_static(static) -> list:
    """One-hot Gender/ICUType (IrregularSampling.py:53-66)."""
    ext = [static[0], 0, 0, static[2], 0, 0, 0, 0, static[4]]
    if static[1] == 0:
        ext[1] = 1
    elif static[1] == 1:
        ext[2] = 1
    icu = static[3]
    if icu in (1, 2, 3, 4):
        ext[3 + int(icu)] = 1
    return ext


def irregular_sampling(P_list, ts_params, max_len: int = P12_MAX_LEN,
                       max_tmins: float = MAX_TMINS):
    """P_list -> PTdict_list dense arrays (IrregularSampling.py:40-89):
    unique timestamps under the 48h cap index the rows; multiple params at
    one timestamp share a row; later duplicates overwrite."""
    ts_index = {p: i for i, p in enumerate(ts_params)}
    F = len(ts_params)
    out = []
    for p in P_list:
        unq = []
        for s in p["ts"]:
            if s[2] < max_tmins and s[2] not in unq:
                unq.append(s[2])
        unq = np.asarray(unq)
        Parr = np.zeros((max_len, F))
        Tarr = np.zeros((max_len, 1))
        for hrs, mins, tmins, param, value in p["ts"]:
            if tmins < max_tmins:
                ti = int(np.where(unq == tmins)[0][0])
                Parr[ti, ts_index[param]] = value
                Tarr[ti, 0] = tmins
        out.append({"id": p["id"], "static": p["static"],
                    "extended_static": extended_static(p["static"]),
                    "arr": Parr, "time": Tarr, "length": len(unq)})
    return out


def remove_outliers(PTdict_list, arr_outcomes, blacklist=P12_BLACKLIST):
    """Drop blacklisted patients (remove_outliers.py:8-21)."""
    keep = [i for i, p in enumerate(PTdict_list)
            if str(p["id"]) not in blacklist]
    arr = np.empty(len(keep), dtype=object)
    arr[:] = [PTdict_list[i] for i in keep]
    return arr, arr_outcomes[keep]


def generate_splits(n: int, out_dir: str, prefix: str, n_splits: int = 5,
                    seed: Optional[int] = None):
    """5x random 8:1:1 permutation splits (Generate_splitID.py:1-21).

    Deviation: an optional seed for reproducibility (the reference uses
    the unseeded global numpy RNG)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    n_train, n_val = round(n * 0.8), round(n * 0.1)
    for j in range(n_splits):
        p = rng.permutation(n)
        # a ragged tuple as an explicit object array (numpy >= 1.24 makes
        # no implicit ragged arrays; the artifact layout is the same)
        split = np.empty(3, dtype=object)
        split[0], split[1], split[2] = (p[:n_train],
                                        p[n_train:n_train + n_val],
                                        p[n_train + n_val:])
        np.save(os.path.join(out_dir, f"{prefix}{j + 1}.npy"), split,
                allow_pickle=True)


def sanity_check(root: str) -> dict:
    """Shape report of the processed artifacts (sanity_check.py:1-10)."""
    report = {}
    pd_dir = os.path.join(root, "processed_data")
    for name in os.listdir(pd_dir):
        if name.endswith(".npy"):
            a = np.load(os.path.join(pd_dir, name), allow_pickle=True)
            report[name] = getattr(a, "shape", None)
    return report


def grud_tensors(PTdict_list):
    """GRU-D (x, mask, delta) tensors [N, 3, F, T]
    (reference GRU-D_data_preparation.py:55-200 df_to_x_m_d). The deltas
    come from the C++ host runtime (native.build_delta, as in the JAX
    package); under RAINDROP_TPU_NATIVE=0 from the port's
    `baselines/grud.build_delta` on the CPU in float32."""
    from raindrop_tpu_torch import native

    arrs = np.stack([p["arr"] for p in PTdict_list])        # [N, T, F]
    times = np.stack([np.asarray(p["time"]).reshape(-1)
                      for p in PTdict_list]) / 60.0          # hours
    mask = (arrs > 0).astype(np.float32)
    if native.enabled():
        delta = native.build_delta(mask, times)
    else:
        import torch

        from raindrop_tpu_torch.baselines.grud import build_delta

        delta = build_delta(torch.from_numpy(mask),
                            torch.from_numpy(times.astype(np.float32))).numpy()
    x = arrs.transpose(0, 2, 1)
    return np.stack([x, mask.transpose(0, 2, 1),
                     delta.transpose(0, 2, 1)], axis=1).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser("raindrop_tpu_torch.data.preprocess")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("parse")
    p1.add_argument("--raw", required=True)
    p1.add_argument("--out", required=True)
    p1.add_argument("--max-len", type=int, default=P12_MAX_LEN)
    p2 = sub.add_parser("splits")
    p2.add_argument("--n", type=int, required=True)
    p2.add_argument("--out", required=True)
    p2.add_argument("--prefix", default="phy12_split")
    p2.add_argument("--seed", type=int, default=None)
    p3 = sub.add_parser("sanity")
    p3.add_argument("--root", required=True)
    p4 = sub.add_parser("grud")
    p4.add_argument("--root", required=True)
    p4.add_argument("--out", required=True)
    # Setting 2's sensor ranking (the reference's standalone
    # code/baselines/RF_information_gain.py, which writes the
    # IG_density_scores_<ds>.npy files read at Raindrop.py:227-231)
    p5 = sub.add_parser("ig")
    p5.add_argument("--root", required=True, help="dataset root")
    # binary datasets only: the ranking scores one RF AUROC per sensor
    # (settings.py), undefined for PAM's 8 classes, as in the reference
    p5.add_argument("--dataset", default="P12",
                    choices=["P12", "P19", "eICU"])
    p5.add_argument("--split", type=int, default=1)
    p5.add_argument("--out", required=True, help="output .npy ranking path")
    p5.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.cmd == "parse":
        os.makedirs(args.out, exist_ok=True)
        outcomes = parse_outcomes(args.raw)
        P_list, ts_params = parse_patients(args.raw)
        pt = irregular_sampling(P_list, ts_params, max_len=args.max_len)
        pt, outcomes = remove_outliers(pt, outcomes)
        np.save(os.path.join(args.out, "arr_outcomes.npy"), outcomes)
        np.save(os.path.join(args.out, "ts_params.npy"), ts_params)
        np.save(os.path.join(args.out, "static_params.npy"), STATIC_PARAMS)
        np.save(os.path.join(args.out, "extended_static_params.npy"),
                EXTENDED_STATIC_PARAMS)
        np.save(os.path.join(args.out, "PTdict_list.npy"), pt)
        print(f"wrote {len(pt)} patients, {len(ts_params)} params -> {args.out}")
    elif args.cmd == "splits":
        generate_splits(args.n, args.out, args.prefix, seed=args.seed)
        print(f"wrote 5 splits -> {args.out}")
    elif args.cmd == "sanity":
        for k, v in sanity_check(args.root).items():
            print(f"{k}: shape {v}")
    elif args.cmd == "grud":
        pt = np.load(os.path.join(args.root, "processed_data",
                                  "PTdict_list.npy"), allow_pickle=True)
        xmd = grud_tensors(pt)
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, "grud_dataset.npy"), xmd)
        print(f"wrote {xmd.shape} -> {args.out}/grud_dataset.npy")
    elif args.cmd == "ig":
        from raindrop_tpu_torch.data.datasets import load_split
        from raindrop_tpu_torch.data.settings import information_gain_ranking

        sp = load_split(args.root, args.dataset, args.split)
        F = sp.Ptrain.shape[2] // 2
        ranking = information_gain_ranking(sp.Ptrain[:, :, :F], sp.ytrain,
                                           seed=args.seed)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        np.save(args.out, ranking)
        print(f"wrote sensor ranking {ranking[:5]}... -> {args.out}")


if __name__ == "__main__":
    main()
