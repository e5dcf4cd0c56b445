"""The port's checkpoint import (migrate.py) against the JAX package's, on
.pt files the tests write with torch.save.

Bare state dicts and the reference's {'rec_state_dict': ...} wrappers,
float32 and float64 leaves: the port's import_params trees are bit-equal
to JAX's import_params, leaf by leaf; the imported Raindrop's eval logits
(P12's widths, max_len cut to 24, 2 layers) within 1e-5 of JAX's
raindrop_apply on the same imported parameters; torch.load is weights-only
unless the caller opts in (a full-module pickle raises without it and
loads with it); the CLI's .npz loads into the port's trees (raindrop_init's
at every preset's widths, the baselines') and serves and trains. The
state dicts' names come from the inverse of the importer
(torch_port_util.raindrop_state_dict, mtand_state_dict). The reference's
own artifacts are read only where reference_source's directory has them.
"""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raindrop_tpu import migrate as jmigrate
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply

from raindrop_tpu_torch import migrate
from raindrop_tpu_torch.baselines.adapters import make_baseline
from raindrop_tpu_torch.bridge import _check_tree, params_to_numpy
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply, raindrop_init
from raindrop_tpu_torch.serve import InferenceServer
from raindrop_tpu_torch.train.checkpoint import flatten_params, load_checkpoint
from raindrop_tpu_torch.train.trainer import Trainer

from tests import reference_source
from tests.torch_port_util import (linear_sd, model_batch, mtand_state_dict,
                                  raindrop_state_dict)

LOGIT_TOL = 1e-5
SMALL = {"max_len": 24}


def _numpy_sd(sd, seed, f64=()):
    """The state dict's names with random values from `seed` (float64 where
    a name contains one of `f64`), as torch tensors."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        a = rng.normal(size=tuple(v.shape)) * 0.2
        dt = np.float64 if any(s in k for s in f64) else np.float32
        out[k] = torch.from_numpy(a.astype(dt))
    return out


def _raindrop_sd(seed=0, static=True, **kw):
    cfg = dataset_config("P12", static=static, **kw)
    sd = raindrop_state_dict(raindrop_init(seed, cfg, device="cpu"))
    sd = _numpy_sd(sd, seed + 1, f64=("lin_value", "mlp_static.2"))
    # the reference's dead head (models_rd.py:260-264) and a buffer: dropped
    sd["mlp.0.weight"] = torch.zeros(3, 3)
    sd["pos_encoder.pe"] = torch.zeros(5)
    return sd


def _grud_sd(seed=0, F=7, x_mean=True):
    rng = np.random.default_rng(seed)
    sd = {theirs: torch.from_numpy(rng.normal(size=(1, F) if ours == "w_hy" else
                                              (1,) if ours == "b_y" else (F,))
                                   .astype(np.float32))
          for ours, theirs in migrate.GRUD_MAP.items()}
    if x_mean:
        sd["x_mean"] = torch.from_numpy(rng.normal(size=(1, F)).astype(np.float64))
    return sd


def _mtand_init(seed=0):
    return make_baseline("mtand", dataset_config("P19"),
                         {"rec_hidden": 8, "embed_time": 16, "num_ref_points": 12},
                         device="cpu").init_fn(seed)


def _mtand_sd(seed=0, query=False):
    sd = _numpy_sd(mtand_state_dict(_mtand_init(seed)), seed + 1,
                   f64=("enc.bias",))
    if query:
        sd["att.query"] = torch.linspace(0.0, 1.0, 12) ** 2
    return sd


def _encoder_sd(seed=0, nested=True):
    cfg = dataset_config("P19", **SMALL)
    layer = raindrop_init(seed, cfg, device="cpu")["transformer_encoder"]["layer0"]
    pre = "encoder_layer." if nested else ""
    sd = {}
    linear_sd(sd, pre + "self_attn.out_proj", layer["out_proj"])
    linear_sd(sd, pre + "linear1", layer["lin1"])
    linear_sd(sd, pre + "linear2", layer["lin2"])
    sd[pre + "self_attn.in_proj_weight"] = layer["in_proj_w"]
    sd[pre + "self_attn.in_proj_bias"] = layer["in_proj_b"]
    for i in (1, 2):
        sd[pre + f"norm{i}.weight"] = layer[f"ln{i}"]["scale"]
        sd[pre + f"norm{i}.bias"] = layer[f"ln{i}"]["bias"]
    return _numpy_sd(sd, seed + 1, f64=("linear2",))


STATE_DICTS = {
    "raindrop": lambda: _raindrop_sd(**SMALL),
    "raindrop_no_static": lambda: _raindrop_sd(static=False, **SMALL),
    "grud": _grud_sd,
    "grud_bare": lambda: _grud_sd(x_mean=False),
    "mtand": _mtand_sd,
    "mtand_query": lambda: _mtand_sd(query=True),
    "encoder_layer": _encoder_sd,
    "encoder_layer_bare": lambda: _encoder_sd(nested=False),
}


def _assert_bit_equal(got, want):
    fg, fw = flatten_params(got), flatten_params(want)
    assert [k for k, _ in fg] == [k for k, _ in fw]
    for (k, a), (_, b) in zip(fg, fw):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("wrapper", ["bare", "rec_state_dict"])
@pytest.mark.parametrize("name", sorted(STATE_DICTS))
def test_import_params_is_bit_equal_to_jax(tmp_path, name, wrapper):
    sd = STATE_DICTS[name]()
    path = str(tmp_path / "model.pt")
    torch.save(sd if wrapper == "bare" else {"rec_state_dict": sd, "epoch": 7}, path)
    model = name.split("_")[0] if not name.startswith("encoder") else "encoder_layer"
    kw = {"n_ref": 12} if model == "mtand" else {}
    got = migrate.import_params(model, path, **kw)
    want = jmigrate.import_params(model, path, **kw)
    _assert_bit_equal(got, want)
    flat = migrate.load_torch_artifact(path)
    assert sorted(flat) == sorted(jmigrate.load_torch_artifact(path))
    assert all(a.dtype != np.float64 for a in flat.values())


def test_the_imported_raindrop_is_the_source_tree():
    """The inverse names, imported: the very tree they came from."""
    cfg = dataset_config("P12", **SMALL)
    params = raindrop_init(3, cfg, device="cpu")
    sd = {k: v.numpy() for k, v in raindrop_state_dict(params).items()}
    _assert_bit_equal(migrate.import_raindrop(sd), params_to_numpy(params))
    m = _mtand_init(4)
    sd = {k: v.numpy() for k, v in mtand_state_dict(m).items()}
    got = migrate.import_mtand(sd, n_ref=12)
    want = params_to_numpy(m)
    want["query_points"] = np.linspace(0.0, 1.0, 12, dtype=np.float32)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("preset", ["P19", "P12", "eICU", "PAM"])
def test_the_imported_raindrop_fits_the_port_template_at_every_preset(preset):
    """At the published widths: every key of raindrop_init's tree and no
    other, every shape (broadcast arrays: no memory is written)."""
    cfg = dataset_config(preset)
    template = raindrop_init(None, cfg, device="meta")
    sd = {k: np.broadcast_to(np.float32(0.5), tuple(v.shape))
          for k, v in raindrop_state_dict(template).items()}
    tree = migrate.import_raindrop(sd)
    _check_tree(tree, template)
    jtree = jmigrate.import_raindrop(sd)
    assert [k for k, _ in flatten_params(jtree)] == [k for k, _ in flatten_params(template)]


def test_imported_logits_match_jax(tmp_path):
    """P12's widths, 2 layers, max_len 24 (the dense rung in both packages),
    eval mode: the port's raindrop_apply on the imported tree against JAX's
    on JAX's import of the same file."""
    kw = dict(SMALL, attention_score_dtype="float32")
    cfg, jcfg = dataset_config("P12", **kw), jax_dataset_config("P12", **kw)
    assert cfg.nlayers == 2
    path = str(tmp_path / "p12.pt")
    torch.save({"rec_state_dict": _raindrop_sd(seed=5, **SMALL)}, path)
    params = migrate.import_params("raindrop", path)
    jparams = jax.tree.map(jnp.asarray, jmigrate.import_params("raindrop", path))
    src, static, times, lengths = model_batch(cfg, 4)
    got, _ = raindrop_apply(
        load_tree(params), cfg, torch.from_numpy(src),
        torch.from_numpy(static), torch.from_numpy(times), torch.from_numpy(lengths))
    want, _ = jax_raindrop_apply(jparams, jcfg, jnp.asarray(src), jnp.asarray(static),
                                 jnp.asarray(times), jnp.asarray(lengths))
    want = np.asarray(want)
    assert got.shape == want.shape == (4, 2)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * scale


def load_tree(tree):
    if isinstance(tree, dict):
        return {k: load_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _full_pickle(tmp_path):
    """torch.save of a whole module whose class lives in a module named
    'models' (as the reference's pickles), with a tensor attribute outside
    its state dict; the class is gone by the time it is loaded."""
    mod = types.ModuleType("models")
    cls = type("GRUD", (torch.nn.Module,), {"__module__": "models"})
    mod.GRUD = cls
    sys.modules["models"] = mod
    try:
        m = cls()
        for k, v in _grud_sd(seed=9, x_mean=False).items():
            m.register_parameter(k, torch.nn.Parameter(v))
        m.x_mean = torch.arange(7, dtype=torch.float64)
        path = str(tmp_path / "grud_model_best.pt")
        torch.save(m, path)
    finally:
        del sys.modules["models"]
    return path


def test_full_module_pickles_load_only_when_asked(tmp_path):
    path = _full_pickle(tmp_path)
    with pytest.raises(pickle.UnpicklingError, match="allow_full_pickle"):
        migrate.load_torch_artifact(path)
    with pytest.raises(pickle.UnpicklingError):
        migrate.import_params("grud", path)
    with pytest.raises(pickle.UnpicklingError):
        migrate.main(["--model", "grud", "--torch", path, "--out", str(tmp_path / "x")])
    assert "models" not in sys.modules
    got = migrate.import_params("grud", path, allow_full_pickle=True)
    _assert_bit_equal(got, jmigrate.import_params("grud", path))
    np.testing.assert_array_equal(got["x_mean"], np.arange(7, dtype=np.float32))
    assert "models" not in sys.modules
    migrate.main(["--model", "grud", "--torch", path, "--out", str(tmp_path / "g.npz"),
                  "--allow-full-pickle"])
    assert (tmp_path / "g.npz").exists()


def test_the_cli_checkpoint_loads_serves_and_trains(tmp_path, capsys):
    """`python -m raindrop_tpu_torch.migrate` writes the .npz JAX's CLI
    writes, array for array; load_checkpoint puts it into raindrop_init's
    tree (another seed's), and the server and a Trainer take it."""
    cfg = dataset_config("P12", **SMALL)
    source = raindrop_init(0, cfg, device="cpu")
    path = str(tmp_path / "p12.pt")
    torch.save(raindrop_state_dict(source), path)
    assert migrate.main(["--model", "raindrop", "--torch", path,
                         "--out", str(tmp_path / "port")]) == 0
    jmigrate.main(["--model", "raindrop", "--torch", path, "--out", str(tmp_path / "jax")])
    assert "imported raindrop" in capsys.readouterr().out
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    params, _, meta = load_checkpoint(str(tmp_path / "port"), raindrop_init(1, cfg, "cpu"))
    assert meta == {"source": path, "model": "raindrop"}
    _assert_bit_equal(params_to_numpy(params), params_to_numpy(source))
    src, static, times, lengths = model_batch(cfg, 3)
    server = InferenceServer(cfg, params, buckets=(4,), device="cpu")
    try:
        probs = server.predict(src.transpose(1, 0, 2), times.T, static)
    finally:
        server.close()
    assert probs.shape == (3, 2) and np.isfinite(probs).all()
    trainer = Trainer(cfg, TrainConfig(dataset="P12", batch_size=3), device="cpu",
                      params=params)
    batch = {"P": torch.from_numpy(src.transpose(1, 0, 2).copy()),
             "time": torch.from_numpy(times.T.copy()),
             "static": torch.from_numpy(static), "y": torch.tensor([0, 1, 1])}
    loss, _ = trainer.train_step(batch)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("name", ["grud", "mtand"])
def test_baseline_imports_load_into_the_baselines_trees(tmp_path, name):
    cfg = dataset_config("P19")
    if name == "grud":
        fam = make_baseline("grud", cfg, device="cpu")
        sd = _grud_sd(F=cfg.d_inp)
        sd["weight_hy"] = sd["weight_hy"].repeat(cfg.n_classes, 1)
        sd["bias_y"] = sd["bias_y"].repeat(cfg.n_classes)
        extra = []
    else:
        fam = make_baseline("mtand", cfg, {"rec_hidden": 8, "embed_time": 16,
                                           "num_ref_points": 12}, device="cpu")
        sd = _mtand_sd()
        extra = ["--mtand-n-ref", "12"]
    path = str(tmp_path / f"{name}.pt")
    torch.save({"rec_state_dict": sd}, path)
    migrate.main(["--model", name, "--torch", path, "--out", str(tmp_path / name), *extra])
    params, _, _ = load_checkpoint(str(tmp_path / name), fam.init_fn(0))
    _assert_bit_equal(params_to_numpy(params), migrate.import_params(name, path, **(
        {"n_ref": 12} if name == "mtand" else {})))
    src, static, times, lengths = model_batch(dataset_config("P19", max_len=cfg.max_len), 2)
    logits, _ = fam.apply_fn(params, torch.from_numpy(src), torch.from_numpy(static),
                             torch.from_numpy(times), torch.from_numpy(lengths), False, None)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("model,rel", [
    ("grud", "saved/grud_model_best.pt"),
    ("grud", "saved/grud_mean_grud_para.pt"),
    ("mtand", "mTAND/best_model_val_aupr.pt"),
    ("encoder_layer", "saved/best_model.pt"),
])
def test_the_reference_artifacts_import_as_in_jax(model, rel):
    """The reference's shipped files (three full-module pickles: trusted,
    loaded with the opt-in) where they are present."""
    path = os.path.join(reference_source.REFERENCE_BASELINES, rel)
    if not os.path.exists(path):
        pytest.skip(f"{path} is not here")
    _assert_bit_equal(migrate.import_params(model, path, allow_full_pickle=True),
                      jmigrate.import_params(model, path))
