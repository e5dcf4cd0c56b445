"""The port's imputers (data/imputation.py) against the JAX package's on
the same raw [N, T, F] arrays: mean, forward and features_mean exactly
(both numpy), cubic_spline exactly (scipy on both sides), knn and mice
within 1e-6 (scikit-learn on both sides; equal here). Also the guarded
case the reference crashes on: a fully observed sample whose only zero
timestamp is its t=0 first observation."""

import numpy as np
import pytest

from raindrop_tpu.data import imputation as jimp

from raindrop_tpu_torch.data import imputation as imp

TOL = 1e-6


def _raw(seed=0, N=12, T=10, F=4):
    """Values with zeros for missing entries, per-sample lengths with a
    zero timestamp tail; sample 0 fully observed with its first time 0."""
    rng = np.random.default_rng(seed)
    X = np.abs(rng.normal(1.0, 1.0, size=(N, T, F))) + 0.1
    X *= rng.uniform(size=(N, T, F)) > 0.5
    times = np.zeros((N, T))
    for i in range(N):
        L = T if i == 0 else int(rng.integers(2, T + 1))
        times[i, :L] = np.sort(rng.uniform(1.0, 48.0, size=L))
        X[i, L:] = 0.0
    times[0, 0] = 0.0
    return X.astype(np.float32), times


@pytest.mark.parametrize("method", ["mean", "forward", "cubic_spline"])
def test_numpy_and_scipy_imputers_are_exact(method):
    X, t = _raw()
    means = imp.features_mean(X) if method == "mean" else None
    got = imp.impute(X, t, method, means)
    want = jimp.impute(X, t, method, means)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, X)


@pytest.mark.parametrize("method", ["knn", "mice"])
def test_sklearn_imputers_match(method):
    X, t = _raw(1, N=16)
    got = imp.impute(X, t, method)
    want = jimp.impute(X, t, method)
    assert got.dtype == want.dtype and got.shape == X.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.isfinite(got).all()


def test_features_mean_is_exact():
    X, _ = _raw(2)
    np.testing.assert_array_equal(imp.features_mean(X), jimp.features_mean(X))
    X[:, :, 1] = 0.0                                 # a feature never observed
    got = imp.features_mean(X)
    np.testing.assert_array_equal(got, jimp.features_mean(X))
    assert got[1] == 0.0


def test_time_lengths_guard_a_fully_observed_sample_starting_at_zero():
    """Sample 0 is observed at every step and its first time is 0: the
    reference would index a second zero that does not exist; the length is
    T, so it is imputed like the others."""
    X, t = _raw(3)
    lengths = imp._time_lengths(t)
    np.testing.assert_array_equal(lengths, jimp._time_lengths(t))
    assert lengths[0] == t.shape[1]
    X[0, 2, :] = [1.0, 2.0, 3.0, 4.0]
    X[0, 3:, :] = 0.0
    out = imp.forward_imputation(X, t)
    assert (out[0, 3:] == X[0, 2]).all()


def test_unknown_method_raises_as_jax_does():
    X, t = _raw()
    with pytest.raises(ValueError, match="unknown imputation"):
        imp.impute(X, t, "median")
