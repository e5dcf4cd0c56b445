"""Parameter bridge and checkpoint import: JAX trees into the port and back."""

import numpy as np
import pytest
import torch

import jax

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.train.checkpoint import save_checkpoint

from raindrop_tpu_torch.bridge import params_from_jax, params_to_numpy
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_init
from raindrop_tpu_torch.train.checkpoint import load_checkpoint

PRESETS = ["P19", "P12", "eICU", "PAM"]
# the propagation weights are [max_len*d_ob]^2, so the trees are cut in T
MAX_LEN = 16


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("preset", PRESETS)
def test_jax_tree_round_trips_exactly(preset):
    tree = jax.device_get(jax_raindrop_init(
        jax.random.PRNGKey(3), jax_dataset_config(preset, max_len=MAX_LEN)))
    cfg = dataset_config(preset, max_len=MAX_LEN)
    params = params_from_jax(tree, cfg, device="cpu")
    back = _flat(params_to_numpy(params))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("preset", PRESETS)
def test_port_init_matches_jax_tree_and_ranges(preset):
    jtree = _flat(jax.device_get(jax_raindrop_init(
        jax.random.PRNGKey(0), jax_dataset_config(preset, max_len=MAX_LEN))))
    cfg = dataset_config(preset, max_len=MAX_LEN)
    a = _flat(params_to_numpy(raindrop_init(7, cfg, device="cpu")))
    b = _flat(params_to_numpy(raindrop_init(
        torch.Generator().manual_seed(7), cfg, device="cpu")))
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in jtree.items()}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])       # seeded: reproducible
        if k.endswith("/encoder/w") or k.endswith("/emb/w"):
            assert np.abs(a[k]).max() <= cfg.init_range
        elif a[k].size >= 1000 and np.abs(jtree[k]).max() > 0:
            # same uniform range: with >= 1000 draws both samples reach
            # within 1% of the range's edge
            np.testing.assert_allclose(np.abs(a[k]).max(),
                                       np.abs(jtree[k]).max(), rtol=0.02,
                                       err_msg=k)


def test_bridge_rejects_a_tree_of_another_config():
    tree = jax.device_get(jax_raindrop_init(
        jax.random.PRNGKey(0), jax_dataset_config("P19", max_len=MAX_LEN)))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, dataset_config("P19", max_len=MAX_LEN + 8),
                        device="cpu")
    del tree["R_u"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, dataset_config("P19", max_len=MAX_LEN),
                        device="cpu")


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jcfg = jax_dataset_config("P12", max_len=MAX_LEN)
    jparams = jax_raindrop_init(jax.random.PRNGKey(5), jcfg)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, jparams, meta={"epoch": 3})
    cfg = dataset_config("P12", max_len=MAX_LEN)
    params, opt, meta = load_checkpoint(path, raindrop_init(0, cfg, device="cpu"))
    assert opt is None and meta == {"epoch": 3}
    got, want = _flat(params_to_numpy(params)), _flat(jax.device_get(jparams))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the optimizer state is restored now; a key the file lacks is named
    with pytest.raises(KeyError, match="opt/count"):
        load_checkpoint(path, params, opt_state_template={"count": np.zeros(())})
