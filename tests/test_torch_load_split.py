"""The port's load_split (data/datasets.py) against the JAX package's on
tiny dataset roots written in tmp_path in the reference's schema: every
array of the Split exactly equal, for P12, P19, eICU and PAM, the split
file, Setting 4's age and gender groups (with `reverse`), a seeded
resplit, the LoS label and each imputer.

Both sides run numpy (and scipy / scikit-learn for cubic_spline, knn and
mice) on the same arrays; the JAX package runs on its numpy path
(RAINDROP_TPU_NATIVE=0: its optional C++ runtime differs from numpy in
the last float32 digits, tests/test_torch_datasets.py), so the tolerance
is 0.
"""

import dataclasses
import os

import numpy as np
import pytest

from raindrop_tpu.data import datasets as jds

from raindrop_tpu_torch.data import datasets as ds

T_LEN = {"P12": 12, "P19": 10, "eICU": 8, "PAM": 16}


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    monkeypatch.setenv("RAINDROP_TPU_NATIVE", "0")


def write_root(root, dataset, n=40, seed=0):
    """A dataset root: processed_data/<PT file> and <outcomes file>,
    splits/<split 1 and 2>. P12's and P19's statics carry an age (some
    unknown, -1) and a gender in their layouts."""
    P, y = ds.synthetic_raw(dataset, n, seed, T=T_LEN[dataset])
    rng = np.random.default_rng(seed + 1)
    if dataset in ("P12", "P19"):
        for p in P:
            s = p["extended_static"]
            s[0] = rng.integers(-1, 95)
            g = rng.integers(0, 2)
            if dataset == "P12":
                s[1], s[2] = g == 0, g == 1
            else:
                s[1] = g
    pt, oc = ds.PT_FILES[dataset]
    os.makedirs(os.path.join(root, "processed_data"))
    os.makedirs(os.path.join(root, "splits"))
    np.save(os.path.join(root, "processed_data", pt), P, allow_pickle=True)
    if dataset == "eICU":
        outcomes = y.reshape(-1, 1)
    else:
        outcomes = np.zeros((n, 6))
        outcomes[:, 3] = rng.integers(1, 8, n)            # length of stay
        outcomes[:, -1] = y
    np.save(os.path.join(root, "processed_data", oc), outcomes)
    for k in (1, 2):
        perm = rng.permutation(n)
        parts = np.empty(3, dtype=object)
        parts[:] = [perm[:32], perm[32:36], perm[36:]]
        np.save(os.path.join(root, ds.SPLIT_PATTERNS[dataset].format(k=k)), parts,
                allow_pickle=True)
    return str(root)


def assert_splits_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("dataset", ["P12", "P19", "eICU", "PAM"])
@pytest.mark.parametrize("kw", [{}, {"split_idx": 2}, {"resplit_seed": 11},
                                {"static_compat": False}])
def test_random_splits_equal_the_jax_package(tmp_path, dataset, kw):
    root = write_root(tmp_path, dataset)
    assert_splits_equal(ds.load_split(root, dataset, **kw),
                        jds.load_split(root, dataset, **kw))


@pytest.mark.parametrize("dataset", ["P12", "P19"])
@pytest.mark.parametrize("split_type", ["age", "gender"])
@pytest.mark.parametrize("reverse", [False, True])
def test_demographic_splits_equal_the_jax_package(tmp_path, dataset, split_type,
                                                  reverse):
    root = write_root(tmp_path, dataset)
    kw = dict(split_type=split_type, reverse=reverse)
    got = ds.load_split(root, dataset, 1, **kw)
    assert_splits_equal(got, jds.load_split(root, dataset, 1, **kw))
    # an explicit Generator for the held-out halves, drawn the same way
    kw["rng"] = np.random.default_rng(9)
    want = jds.load_split(root, dataset, 1, **{**kw, "rng": np.random.default_rng(9)})
    assert_splits_equal(ds.load_split(root, dataset, 1, **kw), want)


@pytest.mark.parametrize("dataset", ["P12", "eICU", "PAM"])
@pytest.mark.parametrize("imputation", ["mean", "forward", "cubic_spline", "knn",
                                        "mice"])
def test_imputed_splits_equal_the_jax_package(tmp_path, dataset, imputation):
    root = write_root(tmp_path, dataset)
    got = ds.load_split(root, dataset, imputation=imputation)
    assert_splits_equal(got, jds.load_split(root, dataset, imputation=imputation))
    plain = ds.load_split(root, dataset)
    F = plain.Ptrain.shape[2] // 2
    assert not np.array_equal(got.Ptrain[..., :F], plain.Ptrain[..., :F])


def test_los_label_and_raw_loaders_equal_the_jax_package(tmp_path):
    root = write_root(tmp_path, "P12")
    assert_splits_equal(ds.load_split(root, "P12", predictive_label="LoS"),
                        jds.load_split(root, "P12", predictive_label="LoS"))
    for a, b in zip(ds.load_split_indices(root, "P12", 2),
                    jds.load_split_indices(root, "P12", 2)):
        np.testing.assert_array_equal(a, b)
    (P, oc), (jP, joc) = ds.load_raw(root, "P12"), jds.load_raw(root, "P12")
    np.testing.assert_array_equal(oc, joc)
    assert len(P) == len(jP) == 40


def test_refusals_match_the_jax_package(tmp_path):
    root = write_root(tmp_path, "PAM")
    for mod in (ds, jds):
        with pytest.raises(ValueError, match="PAM has no demographics"):
            mod.load_split(root, "PAM", split_type="age")
        with pytest.raises(ValueError, match="resplit_seed"):
            mod.load_split(root, "PAM", split_type="gender", resplit_seed=1)
        with pytest.raises(ValueError, match="predictive_label"):
            mod.load_split(root, "PAM", predictive_label="stay")


@pytest.mark.parametrize("dataset,imputation", [("P19", "mean"), ("PAM", "forward"),
                                                ("P12", "cubic_spline")])
def test_synthetic_split_imputes_as_the_jax_package(dataset, imputation):
    kw = dict(T=T_LEN[dataset], imputation=imputation)
    assert_splits_equal(ds.synthetic_split(dataset, 40, 2, **kw),
                        jds.synthetic_split(dataset, 40, 2, **kw))
