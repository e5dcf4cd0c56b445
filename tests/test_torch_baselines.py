"""The baseline families of the port (baselines/, models/raindrop_v1.py)
against the JAX package's on the CPU: the eval forward, the train-mode
forward with the seeds read off JAX's key (tests/torch_port_util.
baseline_seeds_from_jax_key: the same dropout masks, MTGNN's graph noise
JAX's own draw), and the gradients leaf by leaf, every family through its
adapter (baselines/adapters.make_baseline). The parameters are the port's
init laid on JAX's tree (torch_port_util.jax_baseline_params) and bridged
back.

Sizes: eICU's widths (F=14, 399 statics: the transformer at d=30, hd 15;
v1 at d=70, hd 35) cut to max_len 16, one encoder layer, B=5 with lengths
[16, 9, 0, 16, 9]; MTGNN at 2 layers (receptive field 19, the published 5
pad T to 187). The JAX side runs jitted.

Tolerances: logits and aux 1e-5 (f32, another summation order); each
gradient element 1e-4 of its leaf's largest JAX gradient plus 1e-9, the
floor below which a gradient is rounding noise (mTAND's key bias: a
softmax does not see a shift of its keys, so its true gradient is 0 and
JAX's is 4e-10).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.baselines import adapters as jadapters
from raindrop_tpu.baselines.grud import build_delta as jax_build_delta
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.parallel import expert as jexpert

from raindrop_tpu_torch.baselines import adapters
from raindrop_tpu_torch.baselines.grud import build_delta
from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.parallel import expert
from raindrop_tpu_torch.train.checkpoint import flatten_params

from tests.torch_port_util import (
    baseline_seeds_from_jax_key, jax_baseline_params, model_batch, without_meta)

NAMES = adapters.BASELINES + ("grud_bce",)
HP = {"mtgnn": {"layers": 2}}
KW = dict(max_len=16, nlayers=1)
B = 5
LOGIT_TOL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-9


def _batch(cfg):
    lengths = np.array([16, 9, 0, 16, 9], np.int32)
    return model_batch(cfg, B, seed=2, lengths=lengths)


def port_params(name, cfg, tree, hp=None):
    """The JAX tree (numpy) bridged into the port's tree of this family."""
    template = adapters.make_baseline(name, cfg, hp, device="meta").init_fn(None)
    return params_from_jax(tree, cfg, device="cpu", template=template)


@pytest.fixture(scope="module", params=NAMES)
def family(request):
    """Both packages' outputs for one family: eval, train (JAX key 7) and
    the gradient of sum(logits * g) + sum(aux) in train mode."""
    name = request.param
    hp = HP.get(name)
    jcfg, cfg = jax_dataset_config("eICU", **KW), dataset_config("eICU", **KW)
    _, japply = jadapters.make_baseline(name, jcfg, dict(hp or {}))
    port = adapters.make_baseline(name, cfg, hp, device="cpu")
    jparams = jax_baseline_params(name, hp, **KW)
    params = port_params(name, cfg, jparams, hp)
    src, static, times, lengths = _batch(cfg)
    jargs = tuple(jnp.asarray(a) for a in (src, static, times, lengths))
    targs = (torch.from_numpy(src), torch.from_numpy(static),
             torch.from_numpy(times), torch.from_numpy(lengths).long())
    key = jax.random.PRNGKey(7)
    g = np.random.default_rng(3).normal(size=(B, cfg.n_classes)).astype(np.float32)

    def objective(p):
        logits, aux = japply(p, *jargs, True, key)
        return jnp.sum(logits * g) + jnp.sum(aux), (logits, aux)

    # one compiled program for the three (a compile a family is most of the
    # file's time)
    j_eval, (_, j_train), grads = jax.jit(lambda p: (
        japply(p, *jargs, False, None),
        *jax.value_and_grad(objective, has_aux=True)(p)))(jparams)
    j_grads = dict(flatten_params(without_meta(jax.device_get(grads))))
    return dict(name=name, hp=hp, cfg=cfg, port=port, params=params, targs=targs,
                seeds=baseline_seeds_from_jax_key(name, key, cfg, hp), g=g,
                j_eval=[np.asarray(x) for x in j_eval],
                j_train=[np.asarray(x) for x in j_train], j_grads=j_grads)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL, err_msg=what)


def test_eval_forward_matches_jax(family):
    with torch.no_grad():
        logits, aux = family["port"].apply_fn(family["params"], *family["targs"],
                                               False, None)
    _close(logits, family["j_eval"][0], f"{family['name']} logits")
    _close(aux, family["j_eval"][1], f"{family['name']} aux")


def test_train_forward_matches_jax(family):
    """The same dropout masks (and MTGNN's graph noise) on both sides."""
    with torch.no_grad():
        logits, aux = family["port"].apply_fn(family["params"], *family["targs"],
                                               True, family["seeds"])
    _close(logits, family["j_train"][0], f"{family['name']} train logits")
    _close(aux, family["j_train"][1], f"{family['name']} train aux")
    if family["seeds"] is not None and family["cfg"].dropout > 0:
        # the masks matter: the eval logits differ
        assert not np.allclose(family["j_train"][0], family["j_eval"][0])


def test_gradients_match_jax(family):
    params = family["params"]
    leaves = flatten_params(params)
    for _, t in leaves:
        t.requires_grad_(True)
    logits, aux = family["port"].apply_fn(params, *family["targs"], True,
                                          family["seeds"])
    ((logits * torch.from_numpy(family["g"])).sum() + aux.sum()).backward()
    assert {p for p, _ in leaves} == set(family["j_grads"])
    for path, t in leaves:
        want = np.asarray(family["j_grads"][path])
        # a leaf the forward never reads gets no .grad; JAX's is exactly 0
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        tol = GRAD_REL * float(np.abs(want).max()) + GRAD_FLOOR
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{family['name']} {path}")
        t.grad = None
        t.requires_grad_(False)


def test_build_delta_matches_jax():
    rng = np.random.default_rng(0)
    mask = (rng.uniform(size=(3, 11, 4)) > 0.5).astype(np.float32)
    times = np.cumsum(rng.uniform(0.1, 2.0, size=(3, 11)), 1).astype(np.float32)
    got = build_delta(torch.from_numpy(mask), torch.from_numpy(times)).numpy()
    want = np.asarray(jax_build_delta(jnp.asarray(mask), jnp.asarray(times)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[:, 0] == 0).all()


def test_grud_bce_is_the_logit_pair_zero_z():
    """grud_bce's logits are [0, z] with z GRU-D's one output, so the
    softmax cross-entropy is BCE-with-logits on z; its init has one output
    (the logits against JAX's: test_eval_forward_matches_jax[grud_bce])."""
    cfg = dataset_config("eICU", **KW)
    params = port_params("grud_bce", cfg, jax_baseline_params("grud_bce", **KW))
    assert tuple(params["w_hy"].shape) == (1, cfg.d_inp)
    src, static, times, lengths = _batch(cfg)
    with torch.no_grad():
        logits, _ = adapters.make_baseline("grud_bce", cfg, device="cpu").apply_fn(
            params, torch.from_numpy(src), None, torch.from_numpy(times),
            torch.from_numpy(lengths).long(), False, None)
    assert (logits[:, 0] == 0).all() and (logits[:, 1] != 0).all()
    y = torch.tensor([0, 1, 1, 0, 1])
    z = logits[:, 1]
    np.testing.assert_allclose(
        float(torch.nn.functional.cross_entropy(logits, y)),
        float(torch.nn.functional.binary_cross_entropy_with_logits(z, y.float())),
        rtol=1e-6)


@pytest.mark.parametrize("name", ["transformer", "transformer_moe", "transformer_ctx",
                                  "raindrop_v1"])
def test_pam_refusals_in_both_packages(name):
    """At PAM (d_inp 17, no statics) these families raise in the JAX
    package, at init or at the first forward; the port raises as well."""
    jcfg, cfg = jax_dataset_config("PAM", max_len=24), dataset_config("PAM", max_len=24)
    src, static, times, lengths = model_batch(cfg, 2)
    with pytest.raises((ValueError, TypeError, ZeroDivisionError)):
        jinit, japply = jadapters.make_baseline(name, jcfg)
        jax.jit(lambda k, *a: japply(jinit(k), *a, None, False, None))(
            jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(times),
            jnp.asarray(lengths))
    with pytest.raises((ValueError, ZeroDivisionError)):
        b = adapters.make_baseline(name, cfg, device="cpu")
        b.apply_fn(b.init_fn(0), torch.from_numpy(src), None, torch.from_numpy(times),
                   torch.from_numpy(lengths).long(), False, None)


def test_baselines_and_hyperparameters_as_in_jax():
    assert adapters.BASELINES == jadapters.BASELINES
    cfg, jcfg = dataset_config("P19", max_len=8), jax_dataset_config("P19", max_len=8)
    for name in NAMES:
        assert adapters.make_baseline(name, cfg, device="meta").init_fn(None)
    for name, hp in (("mtand", {"rec_hidden": 8, "nope": 1}), ("transformer", {"x": 1}),
                     ("mtgnn", {"layer": 2}), ("ipnet", {"hid": 4, "q": 0})):
        with pytest.raises(ValueError, match="unknown hyperparameters"):
            jadapters.make_baseline(name, jcfg, dict(hp))
        with pytest.raises(ValueError, match="unknown hyperparameters"):
            adapters.make_baseline(name, cfg, dict(hp), device="cpu")
    for pkg, c in ((adapters, dataset_config("PAM")), (jadapters, jax_dataset_config("PAM"))):
        with pytest.raises(ValueError, match="grud_bce"):
            pkg.make_baseline("grud_bce", c)
    with pytest.raises(ValueError, match="unknown baseline"):
        adapters.make_baseline("nope", cfg)


def test_dgm2_emission_chain_matches_jax():
    """dgm2_apply's second output, the cluster emission chain the
    classifier ignores (the adapter skips it: emission=False)."""
    from raindrop_tpu.baselines import dgm2 as jdgm2

    from raindrop_tpu_torch.baselines import dgm2

    jp = jax.jit(lambda k: jdgm2.dgm2_init(k, 6, 9, 3, d_static=2))(jax.random.PRNGKey(5))
    p = port_params_of(jp)
    rng = np.random.default_rng(6)
    data = rng.normal(size=(4, 9, 6)).astype(np.float32)
    static = rng.normal(size=(4, 2)).astype(np.float32)
    tl = np.linspace(0.0, 9.0, 9).astype(np.float32)
    jl, jy = jax.jit(jdgm2.dgm2_apply)(jp, jnp.asarray(data), jnp.asarray(tl),
                                       jnp.asarray(static))
    with torch.no_grad():
        logits, ys = dgm2.dgm2_apply(p, dgm2.DGM2Spec(), torch.from_numpy(data),
                                     torch.from_numpy(tl), torch.from_numpy(static))
        skipped, none = dgm2.dgm2_apply(p, dgm2.DGM2Spec(), torch.from_numpy(data),
                                        torch.from_numpy(tl), torch.from_numpy(static),
                                        emission=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    assert none is None and torch.equal(skipped, logits)


def port_params_of(jtree):
    return without_meta(jax.device_get(jtree), lambda a: torch.tensor(np.asarray(a)))


def test_moe_ffn_matches_jax():
    rng = np.random.default_rng(4)
    jp = jax.device_get(jax.jit(lambda k: jexpert.moe_ffn_init(k, 12, 20, 4))(
        jax.random.PRNGKey(2)))
    x = rng.normal(size=(3, 7, 12)).astype(np.float32)
    jout, jaux = jax.jit(jexpert.moe_ffn_apply)(jp, jnp.asarray(x))
    p = port_params_of(jp)
    out, aux = expert.moe_ffn_apply(p, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # expert parallelism runs since the mesh's slice (its parity over two
    # ranks: tests/test_torch_expert_parallel.py); off a mesh the experts stay whole
    assert expert.shard_moe_params(p, None) is p
    assert {k for k, v in flatten_params(expert.expert_parallel_specs())
            if v is not None} == {"w1", "b1", "w2", "b2"}
    got = expert.moe_ffn_init(torch.Generator().manual_seed(0), 12, 20, 4, device="cpu")
    assert {k: tuple(np.shape(v)) for k, v in flatten_params(got)} == {
        k: tuple(np.shape(v)) for k, v in flatten_params(jp)}
