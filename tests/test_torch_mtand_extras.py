"""The port's mTAND extras against the JAX package's, on the same inputs.

nn/losses.py (held to 1e-6 relative to max(1, |JAX|)), data/toy.py,
data/collate.py, data/raw_irregular.py and data/sampler.py's
balanced_sample_per_class (numpy in both packages: equal element by
element, dtypes included), and a collated batch through the port's
mtand_apply against JAX's (1e-5). Every input is made from a seed with
numpy; the raw text files are written by the tests.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raindrop_tpu.data as jdata
from raindrop_tpu.baselines.mtand import mtand_apply as jax_mtand_apply
from raindrop_tpu.data import collate as jcollate
from raindrop_tpu.data import raw_irregular as jraw
from raindrop_tpu.data import toy as jtoy
from raindrop_tpu.data.sampler import balanced_sample_per_class as jax_balanced
from raindrop_tpu.nn import losses as jlosses

import raindrop_tpu_torch.data as tdata
from raindrop_tpu_torch.baselines.mtand import mtand_apply, mtand_init
from raindrop_tpu_torch.bridge import params_to_numpy
from raindrop_tpu_torch.data import collate, raw_irregular, toy
from raindrop_tpu_torch.data.sampler import balanced_sample_per_class
from raindrop_tpu_torch.nn import losses

LOSS_TOL = 1e-6
MTAND_TOL = 1e-5


def assert_same(got, want, path="out"):
    """Equal element by element, with the same types and dtypes, through
    dicts, lists, tuples and object arrays."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, (
            path, got.dtype, want.dtype, got.shape, want.shape)
        if want.dtype == object:
            for i, (g, w) in enumerate(zip(got.ravel(), want.ravel())):
                assert_same(g, w, f"{path}.flat[{i}]")
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and want != want:
        assert isinstance(got, float) and got != got, path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= LOSS_TOL * scale


# ------------------------------------------------------------------ losses
def _loss_inputs(seed=0, B=4, L=7, D=3, C=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    mask = (rng.uniform(size=(B, L, D)) > 0.5).astype(np.float32)
    mask[0, :2] = 0.0          # timesteps with no observation at all
    onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(B, L))]
    return dict(x=f(B, L, D), mean=f(B, L, D), logvar=f(B, L, D), mask=mask,
                mu2=f(B, L, D), lv2=f(B, L, D), batch=np.concatenate(
                    [f(B, L, D), mask, f(B, L, 1)], -1),
                qm=f(B, 2, 6), qlv=f(B, 2, 6), pred=f(B, L, D), logits=f(B, L, C),
                onehot=onehot)


LOSSES = {
    "log_normal_pdf": lambda m, a: m.log_normal_pdf(a["x"], a["mean"], a["logvar"],
                                                    a["mask"]),
    "normal_kl": lambda m, a: m.normal_kl(a["mean"], a["logvar"], a["mu2"], a["lv2"]),
    "masked_mse": lambda m, a: m.masked_mse(a["x"], a["mean"], a["mask"]),
    "vae_elbo_terms": lambda m, a: m.vae_elbo_terms(3, a["batch"], a["qm"], a["qlv"],
                                                    a["pred"], 0.01),
    "vae_elbo_terms_normalized": lambda m, a: m.vae_elbo_terms(
        3, a["batch"], a["qm"], a["qlv"], a["pred"], 0.5, normalize=True),
    "per_timestep_ce": lambda m, a: m.per_timestep_ce(a["logits"], a["onehot"],
                                                      a["mask"]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    a = _loss_inputs()
    want = LOSSES[name](jlosses, {k: jnp.asarray(v) for k, v in a.items()})
    got = LOSSES[name](losses, {k: torch.from_numpy(v) for k, v in a.items()})
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_per_timestep_ce_is_the_masked_mean_and_differentiable():
    """The intended masked mean (not the reference's broadcast), and its
    gradient reaches the logits of observed timesteps only."""
    a = _loss_inputs(seed=1)
    logits = torch.from_numpy(a["logits"]).requires_grad_(True)
    loss = losses.per_timestep_ce(logits, torch.from_numpy(a["onehot"]),
                                  torch.from_numpy(a["mask"]))
    loss.backward()
    valid = a["mask"].sum(-1) > 0
    assert (logits.grad[torch.from_numpy(~valid)] == 0).all()
    assert logits.grad[torch.from_numpy(valid)].abs().sum() > 0


# --------------------------------------------------------------------- toy
@pytest.mark.parametrize("name,args", [
    ("irregularly_sampled_data_gen", (6, 9, 3)),
    ("sine_wave_data", (11, 8, 2)),
    ("kernel_smoother_data", (11, 8, 50.0, 1)),
    ("toy_data", (10, 5, 4)),
])
def test_toy_generators_equal_the_jax_package(name, args):
    assert_same(getattr(toy, name)(*args), getattr(jtoy, name)(*args))


def test_subsample_timepoints_equals_the_jax_package():
    data = toy.toy_data(8, 6, 0)["train"]
    D = 3
    vals, mask, tt = data[..., :D], data[..., D:2 * D], data[..., -1]
    got = toy.subsample_timepoints(vals, tt, mask, 0.5, np.random.default_rng(3))
    want = jtoy.subsample_timepoints(vals, tt, mask, 0.5, np.random.default_rng(3))
    assert_same(got, want)
    assert (got[2].sum() < mask.sum()) and (vals == data[..., :D]).all()


# ----------------------------------------------------------------- collate
def _dense(seed=4, N=8, T=12, D=5):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.1, 1, size=(N, T)), 1).astype(np.float32)
    lengths = rng.integers(2, T, size=N)
    vals = rng.normal(size=(N, T, D)).astype(np.float32)
    vals[rng.uniform(size=vals.shape) < 0.4] = 0.0
    vals[:, :, -1] = 0.0                     # a feature never observed
    for i in range(N):
        times[i, lengths[i]:] = 0.0
        vals[i, lengths[i]:] = 0.0
    return vals, times, rng.integers(0, 2, size=N), lengths


@pytest.mark.parametrize("kw", [{}, {"normalize": False}, {"max_len": 16},
                                {"stats": True}])
def test_collate_equals_the_jax_package(kw):
    vals, times, labels, lengths = _dense()
    recs = collate.records_from_dense(vals, times[..., None], labels)
    jrecs = jcollate.records_from_dense(vals, times[..., None], labels)
    assert_same([tuple(r) for r in recs], [tuple(r) for r in jrecs])
    assert all(isinstance(r, collate.RaggedRecord) for r in recs)
    assert_same(collate.data_min_max(recs), jcollate.data_min_max(jrecs))
    kw = dict(kw)
    if kw.pop("stats", False):
        kw["data_min"], kw["data_max"] = jcollate.data_min_max(jrecs)
    assert_same(collate.variable_time_collate(recs, **kw),
                jcollate.variable_time_collate(jrecs, **kw))
    explicit = collate.records_from_dense(vals, times, labels, lengths=lengths)
    assert_same([tuple(r) for r in explicit],
                [tuple(r) for r in jcollate.records_from_dense(vals, times, labels,
                                                               lengths=lengths)])


def test_the_collated_batch_through_mtand_matches_jax():
    """variable_time_collate's [B, L, 2D+1] is mTAND's input (values and
    mask, then the time): the port's mtand_apply against JAX's on it."""
    vals, times, labels, _ = _dense(seed=6, N=6, T=10, D=3)
    combined, _ = collate.variable_time_collate(
        collate.records_from_dense(np.abs(vals), times, labels))
    params = mtand_init(0, 6, nhidden=8, embed_time=16, n_ref=12, device="cpu")
    x, tt = combined[..., :6], combined[..., -1]
    got, _ = mtand_apply(params, torch.from_numpy(x), torch.from_numpy(tt))
    jparams = params_to_numpy(params)
    want, _ = jax_mtand_apply(jparams, jnp.asarray(x), jnp.asarray(tt))
    want = np.asarray(want)
    assert got.shape == want.shape == (6, 2)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.detach().numpy() - want).max()) <= MTAND_TOL * scale


# ------------------------------------------------------------- raw parsers
def _physionet_lines(rng, n=30, record_id=None):
    params = [p for p in jraw.PHYSIONET_PARAMS]
    lines = ["Time,Parameter,Value\n"]
    if record_id is not None:
        lines.append(f"00:00,RecordID,{record_id}\n")
    t = 0
    for _ in range(n):
        t += int(rng.integers(0, 9))            # repeats land in one bin
        if rng.uniform() < 0.1:
            t -= int(rng.integers(0, 5))        # out of order: a new bin
        t = max(t, 0)
        v = (f"{rng.uniform(-5, 200):.{int(rng.integers(0, 4))}f}"
             if rng.uniform() < 0.8 else str(int(rng.integers(-1, 300))))
        lines.append(f"{t // 60:02d}:{t % 60:02d},{rng.choice(params)},{v}\n")
    return lines


@pytest.mark.parametrize("quant,reduce", [(0.1, "average"), (0.05, "last"),
                                          (1.0, "average")])
def test_physionet_record_equals_the_jax_package(quant, reduce):
    rng = np.random.default_rng(7)
    for k in range(4):
        lines = _physionet_lines(rng, record_id=132540 + k if k % 2 else None)
        assert_same(tuple(raw_irregular.parse_physionet_record(
            f"r{k}", lines, quantization=quant, reduce=reduce, label=k)),
            tuple(jraw.parse_physionet_record(f"r{k}", lines, quantization=quant,
                                              reduce=reduce, label=k)))
    with pytest.raises(ValueError, match="unexpected param"):
        raw_irregular.parse_physionet_record("x", ["h\n", "00:01,Bogus,1\n"])


def _write_physionet_root(root, rng, n=5):
    os.makedirs(os.path.join(root, "set-a"))
    ids = [str(132540 + i) for i in range(n)]
    with open(os.path.join(root, "Outcomes-a.txt"), "w") as f:
        f.write("RecordID,SAPS-I,SOFA,Length_of_stay,Survival,In-hospital_death\n")
        for rid in ids[:-1]:              # the last record has no outcome
            f.write(f"{rid},{rng.integers(1, 30)},{rng.integers(0, 15)},"
                    f"{rng.integers(1, 40)},-1,{rng.integers(0, 2)}\n")
    for rid in ids:
        with open(os.path.join(root, "set-a", rid + ".txt"), "w") as f:
            f.writelines(_physionet_lines(rng, record_id=rid))
    with open(os.path.join(root, "set-a", "notes.md"), "w") as f:
        f.write("not a record\n")


def test_physionet_dirs_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(8)
    root = str(tmp_path)
    _write_physionet_root(root, rng)
    with open(os.path.join(root, "Outcomes-a.txt")) as f:
        lines = f.readlines()
    outcomes = raw_irregular.parse_physionet_outcomes(lines)
    assert_same(outcomes, jraw.parse_physionet_outcomes(lines))
    for kw in ({}, {"n_samples": 3, "reduce": "last", "quantization": 0.5}):
        got = raw_irregular.load_physionet_dir(os.path.join(root, "set-a"), outcomes, **kw)
        want = jraw.load_physionet_dir(os.path.join(root, "set-a"), outcomes, **kw)
        assert_same([tuple(r) for r in got], [tuple(r) for r in want])
    got = raw_irregular.acquire_physionet(root)
    want = jraw.acquire_physionet(root)
    assert sorted(got) == sorted(want) == ["set-a"]
    assert_same([tuple(r) for r in got["set-a"]], [tuple(r) for r in want["set-a"]])
    assert got["set-a"][-1].label == -1


def test_acquire_physionet_never_downloads(tmp_path):
    with pytest.raises(RuntimeError) as e:
        raw_irregular.acquire_physionet(str(tmp_path), download=True)
    for url in jraw.PHYSIONET_URLS:
        assert url in str(e.value)
    assert raw_irregular.PHYSIONET_URLS == jraw.PHYSIONET_URLS
    with pytest.raises(FileNotFoundError):
        raw_irregular.acquire_physionet(str(tmp_path))


def _activity_lines(rng, n_records=3, n=160):
    lines = []
    tags = jraw.ACTIVITY_TAG_IDS + ["RecordID"]
    for r in range(n_records):
        t = 633790226051280000 + int(rng.integers(0, 10 ** 9))
        for _ in range(n + 40 * r):
            t += int(rng.integers(0, 3)) * 10 ** 5 + int(rng.integers(0, 3000))
            tag = tags[int(rng.integers(0, 4 if rng.uniform() < 0.95 else 5))]
            xyz = ",".join(f"{v:.6f}" for v in rng.normal(size=3))
            label = jraw.ACTIVITY_LABEL_NAMES[int(rng.integers(0, 11))]
            lines.append(f"{chr(65 + r)}01,{tag},{t},27.05.2009 14:03:25:127,"
                         f"{xyz},{label}\n")
    return lines


@pytest.mark.parametrize("max_seq_length,reduce", [(50, "average"), (24, "last")])
def test_person_activity_and_union_collate_equal_the_jax_package(
        tmp_path, max_seq_length, reduce):
    lines = _activity_lines(np.random.default_rng(9))
    got = raw_irregular.parse_person_activity(lines, max_seq_length, reduce)
    want = jraw.parse_person_activity(lines, max_seq_length, reduce)
    assert len(got) > 3
    assert_same(got, want)
    path = tmp_path / "ConfLongDemo_JSI.txt"
    path.write_text("".join(lines))
    assert_same(raw_irregular.load_person_activity(str(path), max_seq_length, reduce),
                want)
    assert_same(raw_irregular.union_time_collate(got[:4]), jraw.union_time_collate(want[:4]))
    assert [raw_irregular.person_id(r[0]) for r in got] == [
        jraw.person_id(r[0]) for r in want]
    for name in ("ACTIVITY_TAG_IDS", "ACTIVITY_LABEL_NAMES", "ACTIVITY_LABEL_DICT",
                 "PHYSIONET_PARAMS", "PHYSIONET_OUTCOME_LABELS"):
        assert getattr(raw_irregular, name) == getattr(jraw, name)
    with pytest.raises(ValueError, match="unexpected tag"):
        raw_irregular.parse_person_activity(["A01,bogus,1,d,0,0,0,walking\n"])


# ----------------------------------------------------------------- sampler
@pytest.mark.parametrize("n_classes,replace", [(8, False), (4, True)])
def test_balanced_sample_per_class_equals_the_jax_package(n_classes, replace):
    y = np.random.default_rng(10).integers(0, n_classes, size=(300, 1))
    for seed in range(3):
        got = balanced_sample_per_class(y, 64, np.random.default_rng(seed), n_classes,
                                        replace)
        want = jax_balanced(y, 64, np.random.default_rng(seed), n_classes, replace)
        assert_same(got, want)
        assert len(got) == (64 // n_classes) * n_classes


def test_the_data_package_exports_what_the_jax_one_does_from_these_modules():
    names = {n for n in dir(jdata)
             if getattr(getattr(jdata, n), "__module__", "") in (
                 "raindrop_tpu.data.collate", "raindrop_tpu.data.raw_irregular")}
    assert names and names <= set(dir(tdata))
