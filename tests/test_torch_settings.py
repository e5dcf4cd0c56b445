"""The port's Settings 2-4 (data/settings.py) against the JAX package's:
both sensor removals and the demographic groups exactly equal from the
same inputs and Generator state, the information-gain ranking equal
(scikit-learn's RandomForest from the same seed on both sides)."""

import numpy as np
import pytest

from raindrop_tpu.data import settings as jset

from raindrop_tpu_torch.data import settings as st


def _P(seed=0, N=30, T=12, F=7):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(N, T, F)) * (rng.uniform(size=(N, T, F)) > 0.4)
    return np.concatenate([vals, (vals != 0).astype(float)], -1).astype(np.float32)


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.3, 0.5, 1.0])
def test_remove_sensors_fixed_is_exact(ratio):
    P = _P()
    ranking = np.random.default_rng(1).permutation(7)
    got = st.remove_sensors_fixed(P, ranking, ratio)
    np.testing.assert_array_equal(got, jset.remove_sensors_fixed(P, ranking, ratio))
    np.testing.assert_array_equal(got[..., 7:], P[..., 7:])   # mask columns kept
    assert got is not P


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5])
def test_remove_sensors_random_is_exact_and_draws_the_same_stream(ratio):
    P = _P(2)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    got = st.remove_sensors_random(P, ratio, r1)
    want = jset.remove_sensors_random(P, ratio, r2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 7:], P[..., 7:])
    # the generators are left in the same state
    assert r1.integers(1 << 30) == r2.integers(1 << 30)


def _statics(dataset, n=40, seed=3):
    rng = np.random.default_rng(seed)
    if dataset == "P12":
        s = np.zeros((n, 9))
        s[:, 0] = rng.integers(-1, 95, n)        # age, -1 unknown
        g = rng.integers(0, 3, n)                # 0 female, 1 male, 2 unknown
        s[:, 1] = g == 0
        s[:, 2] = g == 1
        return s
    s = np.zeros((n, 6))
    s[:, 0] = rng.integers(-1, 95, n)
    s[:, 1] = rng.integers(0, 2, n)
    return s


@pytest.mark.parametrize("dataset", ["P12", "P19"])
@pytest.mark.parametrize("split_type", ["age", "gender"])
def test_demographic_indices_are_exact(dataset, split_type):
    s = _statics(dataset)
    got = st.demographic_indices(s, dataset, split_type)
    want = jset.demographic_indices(s, dataset, split_type)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 0 and len(got[1]) > 0


def test_demographic_indices_refuse_as_jax_does():
    with pytest.raises(ValueError, match="gender layout"):
        st.demographic_indices(_statics("P12"), "eICU", "gender")
    with pytest.raises(ValueError, match="split_type"):
        st.demographic_indices(_statics("P12"), "P12", "height")


def test_information_gain_ranking_equals_the_jax_package():
    rng = np.random.default_rng(4)
    N, T, F = 60, 5, 4
    y = (rng.uniform(size=N) < 0.4).astype(int)
    X = rng.normal(size=(N, T, F))
    X[:, :, 2] += 2.0 * y[:, None]                # sensor 2 carries the label
    got = st.information_gain_ranking(X, y, seed=0)
    np.testing.assert_array_equal(got, jset.information_gain_ranking(X, y, seed=0))
    assert sorted(got.tolist()) == list(range(F)) and got[0] == 2
