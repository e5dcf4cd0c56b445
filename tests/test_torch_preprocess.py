"""The port's offline preprocessing (data/preprocess.py) against the JAX
package's, on raw PhysioNet text the tests write.

The JAX package reads the text with pandas.read_csv; the port reads it
with the csv module (pandas is not on the card's machine). Here, where
pandas is installed, the JAX functions are the oracle: the parsed tables,
the patient lists, the dense arrays and every artifact of `parse`,
`splits` and `grud` are equal element by element (object arrays item by
item, Python types included). The raw files follow
tests/test_preprocess.py's layout (statics first, no RecordID line, where
read_csv's header=1 consumes the Age line) and the real one (a RecordID
line after the header), with repeated times, values of 0-3 decimals,
missing fields, missing-value strings and blank lines. Values read_csv may
read otherwise than float() (past 15 digits) and words among decimals are
refused with ValueError.
"""

import os
import sys

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from raindrop_tpu import native as jnative  # noqa: E402
from raindrop_tpu.data import preprocess as jpre  # noqa: E402

from raindrop_tpu_torch.data import preprocess as pre  # noqa: E402
from test_torch_mtand_extras import assert_same  # noqa: E402

TS = ["HR", "Temp", "Glucose", "NIMAP", "pH"]


def _value(rng):
    r = rng.uniform()
    if r < 0.5:
        return f"{rng.uniform(0, 200):.{int(rng.integers(0, 4))}f}"
    if r < 0.9:
        return str(int(rng.integers(-1, 300)))
    return rng.choice(["", "NA", "nan", " 7.5", "-0.25 "])


def write_raw(root, seed=0, n=12, sets="ab"):
    """Raw PhysioNet-2012 text under root: set-<s>/<RecordID>.txt and
    Outcomes-<s>.txt. Odd records carry the real files' RecordID line, even
    ones start with the statics; one id is on the blacklist."""
    rng = np.random.default_rng(seed)
    ids = []
    for s in sets:
        os.makedirs(os.path.join(root, f"set-{s}"))
        with open(os.path.join(root, f"Outcomes-{s}.txt"), "w") as f:
            f.write("RecordID,SAPS-I,SOFA,Length_of_stay,Survival,In-hospital_death\n")
            for i in range(n):
                rid = 140000 + 100 * ord(s) + i if i != 3 else 140501
                ids.append(rid)
                saps = int(rng.integers(1, 30)) if i != 5 else ""
                f.write(f"{rid},{saps},{rng.integers(0, 15)},{rng.integers(1, 40)},-1,"
                        f"{rng.integers(0, 2)}\n")
                if i == 2:
                    f.write("\n")
        for rid in ids[-n:]:
            lines = ["Time,Parameter,Value"]
            if rid % 2:
                lines.append(f"00:00,RecordID,{rid}")
            lines += [f"00:00,Age,{rng.integers(20, 90)}",
                      f"00:00,Gender,{rng.integers(0, 2) if rid % 5 else -1}",
                      f"00:00,Height,{rng.choice(['170', '-1', '162.6'])}",
                      f"00:00,ICUType,{rng.integers(1, 5)}",
                      f"00:00,Weight,{rng.uniform(40, 120):.1f}"]
            t = 0
            for _ in range(int(rng.integers(5, 40))):
                t += int(rng.integers(0, 200))
                hh, mm = divmod(min(t, 50 * 60), 60)
                lines.append(f"{hh:02d}:{mm:02d},{rng.choice(TS)},{_value(rng)}")
            if rid % 3 == 0:
                lines.insert(6, "")
                lines.append("00:05,NA,3")
            with open(os.path.join(root, f"set-{s}", f"{rid}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return ids


@pytest.fixture
def raw(tmp_path):
    root = str(tmp_path / "rawdata")
    write_raw(root)
    return root


def test_read_table_equals_read_csv(raw):
    for name in sorted(os.listdir(os.path.join(raw, "set-a"))):
        path = os.path.join(raw, "set-a", name)
        want = np.array(pd.read_csv(path, sep=",", header=1,
                                    names=["time", "param", "value"]))
        got = np.empty((len(want), 3), dtype=object)
        got[:] = pre._record_rows(path)
        assert_same(got, want)
    path = os.path.join(raw, "Outcomes-a.txt")
    assert_same(pre._frame_array(pre.read_table(path, 0, 6)),
                np.array(pd.read_csv(path, sep=",", header=0, names=pre.OUTCOME_NAMES)))


def _decimal(rng, digits):
    d = "".join(rng.choice(list("0123456789"), size=digits))
    pos = int(rng.integers(0, digits + 1))
    return ("-" if rng.uniform() < 0.3 else "") + d[:pos] + "." + d[pos:]


def test_read_float_is_read_csvs_value_or_refuses(tmp_path):
    """Random decimals of 1-15 digits: the value read_csv gives, bit for
    bit. Past 15 digits (where read_csv and float() part for some) and
    exponents, words among decimals or integers past int64 in a record
    file: ValueError naming the file."""
    rng = np.random.default_rng(1)
    cells = [_decimal(rng, int(rng.integers(1, 16))) for _ in range(400)]
    path = tmp_path / "floats.csv"
    path.write_text("x\nh\n" + "\n".join(cells) + "\n")
    want = pd.read_csv(path, header=1, names=["v"])["v"].to_numpy()
    got = np.array([pre.read_float(c) for c in cells])
    assert want.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    long = [_decimal(rng, int(rng.integers(16, 26))) for _ in range(100)]
    path.write_text("x\nh\n" + "\n".join(long) + "\n")
    want = pd.read_csv(path, header=1, names=["v"])["v"].to_numpy()
    assert (want != np.array([float(c) for c in long])).any()
    for c in long:
        with pytest.raises(ValueError, match="more than 15 digits"):
            pre.read_float(c)
    for bad in ("1e2", "inf", "7.5.1", "HR", str(2 ** 63)):
        rec = tmp_path / "rec.txt"
        rec.write_text(f"Time,Parameter,Value\n00:00,Age,54\n00:01,HR,{bad}\n"
                       "00:02,HR,70\n")
        with pytest.raises(ValueError, match="rec.txt"):
            pre._record_rows(str(rec))


def test_parse_equals_the_jax_package(raw):
    assert_same(pre.parse_outcomes(raw), jpre.parse_outcomes(raw))
    P_list, ts_params = pre.parse_patients(raw)
    jP_list, jts_params = jpre.parse_patients(raw)
    assert ts_params == jts_params and set(ts_params) == set(TS)
    assert_same(P_list, jP_list)
    assert_same(pre.parse_patients(raw, TS[:3]), jpre.parse_patients(raw, TS[:3]))
    pt = pre.irregular_sampling(P_list, ts_params, max_len=40)
    assert_same(pt, jpre.irregular_sampling(jP_list, jts_params, max_len=40))
    out = pre.parse_outcomes(raw)
    assert_same(pre.remove_outliers(pt, out), jpre.remove_outliers(pt, out))
    assert len(pre.remove_outliers(pt, out)[0]) == len(pt) - 2
    for static in [(45.0, 1, 170.0, 3, 80.0), (45.0, 0, 170.0, -1, 80.0), (3, -1, 1, 4, 2)]:
        assert pre.extended_static(static) == jpre.extended_static(static)


def test_the_cli_artifacts_equal_the_jax_package(raw, tmp_path, monkeypatch):
    """parse, splits (seeded), sanity and grud through both packages' main;
    the port's with pandas blocked. grud's deltas: both packages' numpy
    paths (tests/test_torch_native.py holds their C++ host runtimes)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    out = {}
    for name, main in (("port", pre.main), ("jax", jpre.main)):
        root = tmp_path / name
        with monkeypatch.context() as m:
            if name == "port":
                m.setitem(sys.modules, "pandas", None)
            main(["parse", "--raw", raw, "--out", str(root / "processed_data"),
                  "--max-len", "48"])
            main(["splits", "--n", "22", "--out", str(root / "splits"), "--seed", "3"])
            main(["sanity", "--root", str(root)])
            main(["grud", "--root", str(root), "--out", str(root / "saved")])
        out[name] = {os.path.relpath(os.path.join(d, f), root): np.load(
            os.path.join(d, f), allow_pickle=True)
            for d, _, fs in os.walk(root) for f in fs}
    assert sorted(out["port"]) == sorted(out["jax"])
    assert len(out["port"]) == 5 + 5 + 1
    for k in out["jax"]:
        assert_same(out["port"][k], out["jax"][k], k)
    assert out["port"]["saved/grud_dataset.npy"].shape == (22, 3, 5, 48)
    assert pre.sanity_check(str(tmp_path / "port")) == jpre.sanity_check(
        str(tmp_path / "jax"))


def test_grud_tensors_equal_the_jax_numpy_path(raw, monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    P_list, ts = pre.parse_patients(raw)
    pt = pre.irregular_sampling(P_list, ts, max_len=60)
    got = pre.grud_tensors(pt)
    assert_same(got, jpre.grud_tensors(pt))
    assert (got[:, 2, :, 0] == 0).all() and got.dtype == np.float32


def test_ig_ranking_equals_the_jax_package(tmp_path, monkeypatch):
    """Setting 2's ranking producer on a P12 root built by parse and splits
    (scikit-learn's random forests in both packages; the JAX package on its
    numpy path)."""
    pytest.importorskip("sklearn")
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    raw = str(tmp_path / "rawdata")
    write_raw(raw, seed=2, n=40)
    root = tmp_path / "P12"
    pre.main(["parse", "--raw", raw, "--out", str(root / "processed_data")])
    pre.main(["splits", "--n", "78", "--out", str(root / "splits"), "--seed", "0"])
    got, want = tmp_path / "ig_port.npy", tmp_path / "ig_jax.npy"
    pre.main(["ig", "--root", str(root), "--out", str(got)])
    jpre.main(["ig", "--root", str(root), "--out", str(want)])
    assert_same(np.load(got), np.load(want))
    assert sorted(np.load(got).tolist()) == list(range(5))


def test_the_port_reads_the_parsed_root_as_the_jax_package_does(tmp_path, monkeypatch):
    """load_split on a root written by the port's parse and splits: the
    arrays the JAX load_split gives on the same root (on its numpy path)."""
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    from raindrop_tpu.data.datasets import load_split as jload

    from raindrop_tpu_torch.data.datasets import load_split

    raw = str(tmp_path / "rawdata")
    write_raw(raw, seed=3, n=30)
    root = tmp_path / "P12"
    pre.main(["parse", "--raw", raw, "--out", str(root / "processed_data"),
              "--max-len", "40"])
    pre.main(["splits", "--n", "58", "--out", str(root / "splits"), "--seed", "1"])
    got, want = load_split(str(root), "P12", 2), jload(str(root), "P12", 2)
    for f in ("Ptrain", "Pval", "Ptest", "Ptrain_time", "Ptest_static", "ytrain"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
