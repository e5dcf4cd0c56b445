"""The port's C++ host runtime (raindrop_tpu_torch/native.py over
csrc/host/raindrop_host.cpp) against the JAX package's (raindrop_tpu/native.py
over native/raindrop_host.cpp: the same source and compile flags, so
bit-equal) and against the numpy functions both packages run under
RAINDROP_TPU_NATIVE=0 (bit-equal, except get_stats at 1e-12 relative and
build_delta at 2e-6 against the JAX package's float32 recurrence). Also
where the data layer calls it, that a failed build raises, and where the
library is built.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from raindrop_tpu import native as jnative
from raindrop_tpu.data import normalize as jnorm
from raindrop_tpu.data import prefetch as jprefetch
from raindrop_tpu.data import settings as jsettings
from test_torch_load_split import assert_splits_equal, write_root

from raindrop_tpu_torch import native
from raindrop_tpu_torch.data import normalize as norm
from raindrop_tpu_torch.data import prefetch
from raindrop_tpu_torch.data import preprocess as pre
from raindrop_tpu_torch.data import settings
from raindrop_tpu_torch.kernels import build


@pytest.fixture
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's host runtime could not be built")
    return jnative


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")


def _values(rng, shape, keep=0.5):
    P = np.abs(rng.normal(3.0, 2.0, size=shape))
    return P * (rng.uniform(size=shape) > keep)


def _stats_pair(rng):
    P = _values(rng, (60, 17, 9))
    P[:, :, 4] = 0.0                        # a sensor never observed
    return P


def test_get_stats(jax_native, numpy_path):
    P = _stats_pair(np.random.default_rng(0))
    got = native.get_stats(P)
    for a, b in zip(got, jax_native.get_stats(P)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, jnorm.get_stats(P)):
        fin = np.isfinite(b)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=0)
    assert np.isnan(got[0][4]) and np.isnan(got[1][4])


def test_mask_normalize(jax_native, numpy_path):
    rng = np.random.default_rng(1)
    P = _values(rng, (40, 13, 7))
    mf, stdf = np.nan_to_num(jnorm.get_stats(P)[0]), jnorm.get_stats(P)[1]
    got = native.mask_normalize(P, mf, stdf)
    assert got.dtype == np.float32 and got.shape == (40, 13, 14)
    np.testing.assert_array_equal(got, jax_native.mask_normalize(P, mf, stdf))
    np.testing.assert_array_equal(got, jnorm.mask_normalize(P, mf, stdf).astype(np.float32))


@pytest.mark.parametrize("compat", [True, False])
def test_mask_normalize_static(jax_native, numpy_path, compat):
    Ps = np.random.default_rng(2).normal(1.0, 2.0, size=(50, 9))
    ms, ss = jnorm.get_stats_static(Ps, "P12", compat=compat)
    got = native.mask_normalize_static(Ps, ms, ss)
    np.testing.assert_array_equal(got, jax_native.mask_normalize_static(Ps, ms, ss))
    np.testing.assert_array_equal(got, jnorm.mask_normalize_static(Ps, ms, ss)
                                  .astype(np.float32))


def test_build_delta(jax_native):
    import jax.numpy as jnp

    from raindrop_tpu.baselines.grud import build_delta

    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(12, 25, 7)) > 0.6).astype(np.float32)
    times = np.cumsum(rng.uniform(0.1, 1.5, size=(12, 25)), axis=1)
    got = native.build_delta(mask, times)
    np.testing.assert_array_equal(got, jax_native.build_delta(mask, times))
    want = np.asarray(build_delta(jnp.asarray(mask), jnp.asarray(times, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert (got[:, 0] == 0).all()


def test_zero_sensors(jax_native):
    rng = np.random.default_rng(4)
    P = rng.normal(size=(16, 11, 2 * 9)).astype(np.float32)
    ranked = rng.permutation(9)
    want = jsettings.remove_sensors_fixed(P, ranked, 0.4)
    idx = ranked[:round(0.4 * 9)]
    got = native.zero_sensors(P.copy(), idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, settings.remove_sensors_fixed(P, ranked, 0.4))
    np.testing.assert_array_equal(got, jax_native.zero_sensors(P.copy(), idx))
    with pytest.raises(ValueError):
        native.zero_sensors(P.astype(np.float64), idx)


def test_gather_rows(jax_native):
    rng = np.random.default_rng(5)
    idx = np.array([9, 4, 4, 31, 0])
    for shape in ((32, 6, 10), (32, 6), (32,)):
        P = rng.normal(size=shape).astype(np.float32)
        got = native.gather_rows(P, idx)
        np.testing.assert_array_equal(got, P[idx])
        np.testing.assert_array_equal(got, jax_native.gather_rows(P, idx))


def test_gather_time_major(jax_native):
    rng = np.random.default_rng(6)
    P = rng.normal(size=(20, 7, 5)).astype(np.float32)
    idx = np.array([3, 19, 0, 3])
    got = native.gather_time_major(P, idx)
    assert got.shape == (7, 4, 5)
    np.testing.assert_array_equal(got, np.moveaxis(P[idx], 0, 1))
    np.testing.assert_array_equal(got, jax_native.gather_time_major(P, idx))
    data = {"P": P, "time": rng.normal(size=(20, 7)).astype(np.float32)}
    want = jprefetch.assemble_batch(data, idx, time_major=True, use_native=False)
    np.testing.assert_array_equal(got, want["P"])


@pytest.mark.parametrize("fn", [native.gather_rows, native.gather_time_major])
@pytest.mark.parametrize("bad", [[0, 20], [-1, 2]])
def test_a_gather_out_of_range_raises(fn, bad):
    P = np.zeros((20, 3, 2), np.float32)
    with pytest.raises(IndexError, match="size 20"):
        fn(P, np.array(bad))


def test_normalize_dispatches_on_the_variable(monkeypatch):
    rng = np.random.default_rng(7)
    arrs = _values(rng, (30, 12, 6))
    times = np.cumsum(rng.uniform(1, 20, size=(30, 12)), axis=1)
    statics = rng.normal(size=(30, 9))
    y = rng.integers(0, 2, size=30)
    runs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("RAINDROP_TPU_NATIVE", flag)
        before = [f.calls for f in (native.get_stats, native.mask_normalize,
                                    native.mask_normalize_static)]
        mf, sd = norm.get_stats(arrs)
        ms, ss = norm.get_stats_static(statics, "P12")
        runs[flag] = norm.tensorize_normalize(arrs, times, statics, y,
                                              np.nan_to_num(mf), sd, ms, ss)
        calls = [f.calls - b for f, b in zip(
            (native.get_stats, native.mask_normalize, native.mask_normalize_static),
            before)]
        assert calls == ([1, 1, 1] if flag == "1" else [0, 0, 0])
    for a, b in zip(runs["1"], runs["0"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_preprocess_grud_dispatches_on_the_variable(monkeypatch):
    rng = np.random.default_rng(8)
    pt = [{"arr": _values(rng, (15, 5)).astype(np.float32),
           "time": np.cumsum(rng.integers(0, 90, size=(15, 1)), axis=0)}
          for _ in range(6)]
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("RAINDROP_TPU_NATIVE", flag)
        before = native.build_delta.calls
        out[flag] = pre.grud_tensors(pt)
        assert native.build_delta.calls - before == (flag == "1")
    assert out["1"].shape == (6, 3, 5, 15)
    np.testing.assert_array_equal(out["1"][:, :2], out["0"][:, :2])
    np.testing.assert_allclose(out["1"][:, 2], out["0"][:, 2], rtol=0, atol=2e-6)


def test_prefetch_dispatches_on_the_variable(monkeypatch):
    rng = np.random.default_rng(9)
    data = {"P": rng.normal(size=(24, 5, 6)).astype(np.float32),
            "time": rng.normal(size=(24, 5)).astype(np.float32),
            "y": rng.integers(0, 2, size=24).astype(np.int32)}
    idx = np.array([5, 0, 23, 5])
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("RAINDROP_TPU_NATIVE", flag)
        before = native.gather_rows.calls
        out[flag] = prefetch.assemble_batch(data, idx)
        assert native.gather_rows.calls - before == (2 if flag == "1" else 0)
    want = jprefetch.assemble_batch(data, idx, use_native=False)
    for k in want:
        assert out["1"][k].flags.c_contiguous and out["1"][k].dtype == want[k].dtype
        np.testing.assert_array_equal(out["1"][k], want[k])
        np.testing.assert_array_equal(out["0"][k], want[k])


def test_a_failing_compiler_raises(monkeypatch, tmp_path):
    """A fresh build directory and a compiler that fails: every entry point
    raises with the variable's name, and nothing returns numpy's results."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "false")
    monkeypatch.delenv("RAINDROP_TPU_NATIVE", raising=False)
    P = _values(np.random.default_rng(10), (4, 3, 2))
    with pytest.raises(RuntimeError, match="RAINDROP_TPU_NATIVE=0"):
        norm.get_stats(P)
    with pytest.raises(RuntimeError, match="exit 1"):
        prefetch.assemble_batch({"P": P.astype(np.float32)}, np.array([0]))
    assert not list((tmp_path / "_build").glob("*"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="building the host runtime failed"):
        native.build_delta(np.zeros((1, 2, 2), np.float32), np.zeros((1, 2)))
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")
    assert norm.get_stats(P)[0].shape == (2,)      # numpy needs no compiler


def test_the_library_lies_in_the_build_directory():
    native.load()
    path = native.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.parent.parts[-3:] == ("raindrop_tpu_torch", "kernels", "_build")
    assert path.name.startswith("librdhost-") and path.exists()
    with open("/proc/self/maps") as f:
        mapped = {line.split()[-1] for line in f if line.rstrip().endswith(".so")}
    assert str(path) in mapped
    assert not any(p.endswith("native/librdhost.so") for p in mapped if "_torch" in p)


def test_one_openmp_runtime_in_the_process():
    """The library links the libgomp torch loads (its wheel's, by path):
    a fresh process that imports torch and loads the library maps one
    OpenMP runtime (another package may bring its own, as scikit-learn's
    wheel does, so the test's own process is not asked)."""
    code = ("import json\n"
            "from raindrop_tpu_torch import native\n"
            "native.load()\n"
            "print(json.dumps(sorted({l.split()[-1] for l in open('/proc/self/maps')\n"
            "                         if 'libgomp' in l})))\n"
            "print(native.gomp_link()[0])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    gomp, link = out.stdout.strip().splitlines()
    gomp = json.loads(gomp)
    assert len(gomp) == 1, gomp
    if link != "-lgomp":
        assert gomp == [os.path.realpath(link)]


def test_load_split_equals_the_jax_package(tmp_path, jax_native, monkeypatch):
    """load_split with both runtimes on: every array equal (get_stats'
    sums agree bit for bit between the two builds of one source)."""
    from raindrop_tpu.data.datasets import load_split as jload

    from raindrop_tpu_torch.data.datasets import load_split

    monkeypatch.delenv("RAINDROP_TPU_NATIVE", raising=False)
    before = native.get_stats.calls
    for dataset in ("P12", "PAM"):
        root = write_root(tmp_path / dataset, dataset)
        assert_splits_equal(load_split(root, dataset, 1), jload(root, dataset, 1))
    assert native.get_stats.calls - before == 2


def test_preprocess_grud_equals_the_jax_package(tmp_path, jax_native, monkeypatch):
    """`preprocess grud` through both packages' main, each on its C++
    runtime: the same artifact bit for bit."""
    from raindrop_tpu.data import preprocess as jpre
    from test_torch_preprocess import write_raw

    monkeypatch.delenv("RAINDROP_TPU_NATIVE", raising=False)
    raw = str(tmp_path / "rawdata")
    write_raw(raw, seed=4, n=8)
    out = {}
    for name, main in (("port", pre.main), ("jax", jpre.main)):
        root = tmp_path / name
        main(["parse", "--raw", raw, "--out", str(root / "processed_data"),
              "--max-len", "40"])
        main(["grud", "--root", str(root), "--out", str(root / "saved")])
        out[name] = np.load(os.path.join(root, "saved", "grud_dataset.npy"))
    assert out["port"].shape == (14, 3, 5, 40)
    np.testing.assert_array_equal(out["port"], out["jax"])
