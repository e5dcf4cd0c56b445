"""The port's synthetic splits and normalization against the JAX
package's: the same seed gives the same arrays.

The JAX package hands its large-array loops to an optional C++ host
runtime whose results differ from numpy's in the last float32 digits; the
port is numpy throughout. So the comparison runs the JAX package on its
numpy path (RAINDROP_TPU_NATIVE=0), where the arrays are equal, and once
with the runtime on (where it is built), within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

from raindrop_tpu.data import datasets as jds
from raindrop_tpu.data import normalize as jnorm

from raindrop_tpu_torch.data import datasets as ds
from raindrop_tpu_torch.data import normalize as norm


@pytest.fixture
def numpy_path(monkeypatch):
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")


def _fields(split):
    return {f.name: getattr(split, f.name) for f in dataclasses.fields(split)}


@pytest.mark.parametrize("dataset,n,T,kw", [
    ("PAM", 60, 24, {}),
    ("PAM", 40, 1040, {}),                       # the long-window shape
    ("P12", 50, 30, {}),
    ("P19", 50, None, {"positive_rate": 0.1}),
    ("eICU", 30, 20, {"static_compat": False}),
    ("P12", 40, 16, {"class_signal": 0.2, "static_compat": False}),
])
def test_synthetic_split_equals_the_jax_package(numpy_path, dataset, n, T, kw):
    want = _fields(jds.synthetic_split(dataset, n, 3, T=T, **kw))
    got = _fields(ds.synthetic_split(dataset, n, 3, T=T, **kw))
    assert got.keys() == want.keys()
    for name, w in want.items():
        if w is None:
            assert got[name] is None, name
            continue
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_synthetic_split_with_the_native_runtime_on():
    want = _fields(jds.synthetic_split("P12", 40, 1, T=20))
    got = _fields(ds.synthetic_split("P12", 40, 1, T=20))
    for name, w in want.items():
        if w is None:
            assert got[name] is None, name
            continue
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dataset", ["PAM", "P19"])
def test_synthetic_raw_equals_the_jax_package(dataset):
    (P, y), (jP, jy) = (m.synthetic_raw(dataset, 12, 5, T=9) for m in (ds, jds))
    np.testing.assert_array_equal(y, jy)
    if dataset == "PAM":
        np.testing.assert_array_equal(P, jP)
    else:
        for a, b in zip(P, jP):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("compat", [True, False])
def test_normalization_functions_equal(numpy_path, compat):
    rng = np.random.default_rng(0)
    P = rng.normal(size=(6, 5, 4)) * (rng.uniform(size=(6, 5, 4)) > 0.4)
    P[..., 3] = 0.0                       # a sensor that is never observed
    for a, b in zip(norm.get_stats(P), jnorm.get_stats(P)):
        np.testing.assert_array_equal(a, b)
    mf, stdf = np.nan_to_num(norm.get_stats(P)[0]), norm.get_stats(P)[1]
    np.testing.assert_array_equal(norm.mask_normalize(P, mf, stdf),
                                  jnorm.mask_normalize(P, mf, stdf))
    Ps = rng.normal(size=(7, 9))
    stats, jstats = (m.get_stats_static(Ps, "P12", compat=compat) for m in (norm, jnorm))
    for a, b in zip(stats, jstats):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(norm.mask_normalize_static(Ps, *stats),
                                  jnorm.mask_normalize_static(Ps, *jstats))


def test_what_the_data_slice_brings_raises():
    with pytest.raises(NotImplementedError, match="data slice"):
        ds.load_split("/nowhere", "P12")
    with pytest.raises(NotImplementedError, match="data slice"):
        ds.synthetic_split("PAM", 20, 0, T=8, imputation="mean")
