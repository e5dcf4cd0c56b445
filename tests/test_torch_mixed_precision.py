"""Mixed precision (compute_dtype) and bf16 parameter storage (dtype) of
the port against the JAX package on the CPU, at P12's width with a short
window (max_len 12, B = 4, 2 layers). The JAX side runs its Pallas
kernels in interpret mode; the port's kernel wrappers run their plain
versions on CPU tensors.

Tolerances:
  * the forward at compute_dtype="bfloat16" (dense, flash and fused-layer
    rungs, and prop_backend 'pallas'): logits and distance f32; logits
    within 2e-2 of JAX's at the same compute_dtype; the port's error
    against the JAX f32 forward at most twice JAX's own bf16 error against
    it, plus 1e-3;
  * gradients under compute_dtype: f32 and finite; each live leaf against
    JAX's bf16 gradient, cosine similarity >= 0.99 and norm within 5%. On
    the dense rung JAX's own bf16 gradient is only about 0.98 from its f32
    one (the port's 0.999): a leaf short of those bounds passes only if the
    port's gradient is at least as close to JAX's f32 gradient as JAX's
    bf16 one is, in cosine and in norm (printed as the witness);
  * three trainer steps against the JAX trainer at compute_dtype: the
    bounds of tests/test_torch_trainer.py scaled from f32's rounding to
    bf16's: losses and logits 2e-2 (the bf16 limit of PERF.md section 2);
    parameters within 6 * lr of JAX's (three Adam steps, each at most about
    lr: a gradient element whose sign the bf16 rounding flips moves the
    two sides apart by 2 * lr a step), and a tensor's mean difference
    under lr / 5 (most elements' steps agree; measured up to 0.14 lr),
    the attention's key bias apart (its true gradient is zero: what Adam
    normalises there is rounding noise on both sides);
  * dtype="bfloat16": the bridged parameters, the checkpoints both ways
    and the optimizer state bit for bit; served logits in bf16, within
    2e-2 of JAX's.
"""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raindrop_tpu.config import TrainConfig as JaxTrainConfig
from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.models.raindrop import raindrop_param_mask as jax_param_mask
from raindrop_tpu.train import checkpoint as jax_checkpoint
from raindrop_tpu.train.trainer import Trainer as JaxTrainer

from raindrop_tpu_torch.bridge import (
    BF16_NUMPY, array_to_tensor, params_from_jax, params_to_numpy, tensor_to_array)
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.models.raindrop import (
    compute_params, raindrop_apply, raindrop_init, raindrop_param_mask)
from raindrop_tpu_torch.serve import InferenceServer
from raindrop_tpu_torch.train.checkpoint import (
    flatten_params, load_checkpoint, save_checkpoint)
from raindrop_tpu_torch.train.trainer import Trainer

from tests.test_torch_trainer import _batch_np, _split, _torch_batch
from tests.torch_port_util import model_batch, seeds_from_jax_key

MAX_LEN, B, LR = 12, 4, 1e-3
BF16_TOL = 2e-2
MIXED = {"compute_dtype": "bfloat16"}


def _cfgs(**kw):
    kw = dict(max_len=MAX_LEN, **kw)
    return jax_dataset_config("P12", **kw), dataset_config("P12", **kw)


def _tree(jcfg, seed=0):
    """A JAX parameter tree (numpy leaves) with the encoder's biases random,
    so logits are not about constant."""
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    for layer in tree["transformer_encoder"].values():
        b = layer["in_proj_b"]
        layer["in_proj_b"] = rng.normal(size=b.shape).astype(b.dtype)
    return tree


def _inputs(cfg, seed=2):
    return model_batch(cfg, B, seed)


def _jax_apply(tree, jcfg, inputs, **kw):
    src, static, times, lengths = inputs
    return jax_raindrop_apply(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(src),
                              jnp.asarray(static), jnp.asarray(times),
                              jnp.asarray(lengths), **kw)


def _port_apply(params, cfg, inputs, **kw):
    return raindrop_apply(params, cfg, *(torch.from_numpy(a) for a in inputs), **kw)


@pytest.mark.parametrize("name,field", [
    ("float32", "dtype"), ("bfloat16", "dtype"), ("float16", "dtype"),
    ("bfloat16", "compute_dtype"), ("float16", "compute_dtype")])
def test_the_config_takes_the_float_dtypes(name, field):
    cfg = dataset_config("P12", **{field: name})
    assert getattr(cfg, field) == name


@pytest.mark.parametrize("name,error,match", [
    ("int8", ValueError, "float dtype"), ("floaty", TypeError, "not understood"),
    ("float64", ValueError, "stores and computes")])
def test_the_config_refuses_other_dtypes(name, error, match):
    """int8 and an unknown name with the JAX package's own errors (its init
    refuses int8, numpy the name); float64, which the JAX package stores as
    float32 without x64, with the port's."""
    if name != "float64":
        with pytest.raises(error):
            jax_raindrop_init(jax.random.PRNGKey(0),
                              jax_dataset_config("P12", max_len=8, dtype=name))
    for field in ("dtype", "compute_dtype"):
        with pytest.raises(error, match=match):
            dataset_config("P12", **{field: name})


@pytest.mark.parametrize("backend,prop_backend", [
    ("dense", "auto"), ("flash", "auto"), ("fused_layer", "auto"), ("dense", "pallas")])
def test_bf16_forward_matches_jax(backend, prop_backend):
    kw = dict(attention_backend=backend, prop_backend=prop_backend)
    jcfg32, cfg32 = _cfgs(**kw)
    jcfg16, cfg16 = _cfgs(**kw, **MIXED)
    tree = _tree(jcfg32)
    params = params_from_jax(tree, cfg32, device="cpu")
    inputs = _inputs(cfg32)
    j32, _ = _jax_apply(tree, jcfg32, inputs)
    j16, _ = _jax_apply(tree, jcfg16, inputs)
    logits, dist = _port_apply(params, cfg16, inputs)
    assert logits.dtype == dist.dtype == torch.float32
    got, j16, j32 = logits.numpy(), np.asarray(j16), np.asarray(j32)
    assert np.abs(got - j16).max() <= BF16_TOL
    jax_err = np.abs(j16 - j32).max()
    assert np.abs(got - j32).max() <= 2 * jax_err + 1e-3, (np.abs(got - j32).max(), jax_err)
    # the master parameters stay f32 and untouched
    assert all(t.dtype == torch.float32 for _, t in flatten_params(params))


def _cos_ratio(a, b):
    """(cosine similarity, norm of a over norm of b)."""
    a = (a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb)), float(na / nb)


@pytest.mark.parametrize("field", ["compute_dtype", "dtype"])
def test_f16_forward_matches_jax(field):
    """float16, which the JAX config takes too, as compute or storage dtype
    on the flash rung: logits in the JAX package's dtype and within 2e-2
    of its own."""
    kw = dict(attention_backend="flash")
    jcfg32, cfg32 = _cfgs(**kw)
    jcfg, cfg = _cfgs(**kw, **{field: "float16"})
    tree = _tree(jcfg32, 7)
    if field == "dtype":
        tree = jax.tree.map(lambda a: np.asarray(a, np.float16), tree)
    params = params_from_jax(tree, cfg if field == "dtype" else cfg32, device="cpu")
    inputs = _inputs(cfg32, 8)
    jlogits, _ = _jax_apply(tree, jcfg, inputs)
    logits, _ = _port_apply(params, cfg, inputs)
    assert str(logits.dtype) == f"torch.{jlogits.dtype}"
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits, np.float32),
                               rtol=0, atol=BF16_TOL)


def _ce(logits, y):
    return torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long())


@pytest.mark.parametrize("backend", ["dense", "flash", "fused_layer"])
def test_bf16_gradients_match_jax(backend):
    """Train mode, dropout 0.2 on the same masks: every live leaf's
    gradient f32 and finite, and against JAX's bf16 gradient cosine >= 0.99,
    norm within 5%."""
    jcfg, cfg = _cfgs(attention_backend=backend, **MIXED)
    tree = _tree(jcfg, 3)
    params = params_from_jax(tree, cfg, device="cpu")
    inputs = _inputs(cfg, 4)
    y = np.arange(B) % cfg.n_classes
    key = jax.random.PRNGKey(5)

    def jax_grads(c):
        def loss(p):
            lg, _ = _jax_apply(p, c, inputs, train=True, rng=key)
            return optax.softmax_cross_entropy_with_integer_labels(
                lg, jnp.asarray(y)).mean()
        return dict(flatten_params(jax.device_get(jax.grad(loss)(
            jax.tree.map(jnp.asarray, tree)))))

    jgrads = jax_grads(jcfg)
    j32 = []            # JAX's f32 gradient, made when a witness needs it
    mask = dict(flatten_params(raindrop_param_mask(cfg)))
    leaves = dict(flatten_params(params))
    for path, t in leaves.items():
        t.requires_grad_(mask[path])
    logits, _ = _port_apply(params, cfg, inputs, train=True,
                            seeds=seeds_from_jax_key(key, cfg.nlayers, rows=B))
    assert logits.dtype == torch.float32
    _ce(logits, y).backward()
    for path, t in leaves.items():
        if not mask[path]:
            assert t.grad is None, path
            continue
        g = t.grad
        assert g is not None and g.dtype == torch.float32, path
        assert torch.isfinite(g).all(), path
        cos, ratio = _cos_ratio(g, jgrads[path])
        if cos >= 0.99 and abs(ratio - 1.0) <= 0.05:
            continue
        if not j32:
            j32.append(jax_grads(dataclasses.replace(jcfg, compute_dtype=None)))
        mine, jax_own = _cos_ratio(g, j32[0][path]), _cos_ratio(jgrads[path], j32[0][path])
        print(f"{backend} {path}: cosine {cos:.4f}, norm ratio {ratio:.4f} against "
              f"JAX bf16; against JAX f32 the port's {mine[0]:.4f} / {mine[1]:.4f}, "
              f"JAX bf16's {jax_own[0]:.4f} / {jax_own[1]:.4f}")
        assert mine[0] >= jax_own[0], path
        assert abs(mine[1] - 1.0) <= max(0.05, abs(jax_own[1] - 1.0)), path


def _assert_params_bf16_close(tr, want, lr=LR):
    for path, t in flatten_params(tr.params):
        got, ref = t.detach().float().numpy(), np.asarray(want[path], np.float32)
        np.testing.assert_allclose(got, ref, rtol=0, atol=6 * lr, err_msg=path)
        if path.endswith("in_proj_b"):
            d = got.shape[0] // 3
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        assert np.abs(got - ref).mean() <= lr / 5, (path, float(np.abs(got - ref).mean()))


def _jax_and_port_trainers(preset, lr=LR, B_=6, **cfg_kw):
    kw = dict(max_len=16, dropout=0.2, **cfg_kw)
    jcfg, cfg = jax_dataset_config(preset, **kw), dataset_config(preset, **kw)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(dataset=preset, learning_rate=lr,
                                          batch_size=B_))
    jparams = jtr._init(jax.random.PRNGKey(0))
    tr = Trainer(cfg, TrainConfig(dataset=preset, learning_rate=lr, batch_size=B_),
                 device="cpu", params=params_from_jax(jax.device_get(jparams), cfg,
                                                      device="cpu"))
    return jtr, jparams, tr, cfg


@pytest.mark.parametrize("backend", ["flash", "fused_layer"])
def test_three_bf16_steps_match_the_jax_trainer(backend):
    jtr, jparams, tr, cfg = _jax_and_port_trainers(
        "P12", attention_backend=backend, **MIXED)
    split = _split(cfg, 24)
    opt_state = jtr.optimizer.init(jparams)
    rng = np.random.default_rng(5)
    for step in range(3):
        idx = rng.permutation(24)[:6]
        key = jax.random.PRNGKey(100 + step)
        b = _batch_np(split, idx)
        jparams, opt_state, jloss, jlogits = jtr._train_step(
            jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        loss, logits = tr.train_step(_torch_batch(b),
                                     seeds_from_jax_key(key, cfg.nlayers, rows=6))
        assert logits.dtype == torch.float32
        assert abs(float(loss) - float(jloss)) <= BF16_TOL * abs(float(jloss))
        assert np.abs(logits.numpy() - np.asarray(jlogits)).max() <= BF16_TOL
    assert all(t.dtype == torch.float32 for _, t in flatten_params(tr.params))
    assert all(st["exp_avg"].dtype == torch.float32
               for st in tr.optimizer.state.values())
    _assert_params_bf16_close(tr, dict(flatten_params(jax.device_get(jparams))))


def test_the_server_casts_its_live_leaves_once_with_the_same_bits():
    jcfg, cfg = _cfgs(attention_backend="flash", **MIXED)
    params = params_from_jax(_tree(jcfg), cfg, device="cpu")
    server = InferenceServer(cfg, params, buckets=(4,), device="cpu")
    mask = dict(flatten_params(raindrop_param_mask(cfg)))
    for path, t in flatten_params(server._params):
        assert t.dtype == (torch.bfloat16 if mask[path] else torch.float32), path
    assert server.params is params or all(
        torch.equal(a, b) for (_, a), (_, b) in zip(flatten_params(server.params),
                                                    flatten_params(params)))
    src, static, times, lengths = _inputs(cfg)
    probs = server.predict(src.transpose(1, 0, 2), times.T, static)
    server.close()
    with torch.no_grad():
        logits, _ = _port_apply(params, cfg, (src, static, times, lengths))
    want = torch.softmax(logits, dim=-1).numpy()
    assert probs.dtype == np.float32
    np.testing.assert_array_equal(probs, want)
    # a tree already cast passes through compute_params unchanged
    again = compute_params(server._params, cfg)
    assert all(a is b for (_, a), (_, b) in zip(flatten_params(again),
                                                 flatten_params(server._params)))


# ------------------------------------------------------------ bf16 storage
def _bits(a):
    if isinstance(a, torch.Tensor):
        return tensor_to_array(a).view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _bf16_tree(seed=0, **kw):
    jcfg, cfg = _cfgs(dtype="bfloat16", **kw)
    return jcfg, cfg, jax.device_get(jax_raindrop_init(jax.random.PRNGKey(seed), jcfg))


def test_bf16_params_cross_the_bridge_bit_for_bit():
    """ml_dtypes bfloat16 arrays (as JAX hands them over) and raw |V2 ones
    (as np.savez stores them) give the same bf16 tensors, and back."""
    _, cfg, tree = _bf16_tree()
    for form in ("ml_dtypes", "V2"):
        src = tree if form == "ml_dtypes" else jax.tree.map(
            lambda a: np.asarray(a).view(BF16_NUMPY), tree)
        params = params_from_jax(src, cfg, device="cpu")
        want = dict(flatten_params(tree))
        for path, t in flatten_params(params):
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(_bits(t), _bits(want[path]), err_msg=path)
    back = dict(flatten_params(params_to_numpy(params)))
    for path, a in flatten_params(tree):
        assert back[path].dtype == BF16_NUMPY
        np.testing.assert_array_equal(back[path].view(ml_dtypes.bfloat16), a)
    # the port's own init in bf16 stores bf16 leaves of the same tree
    mine = raindrop_init(0, cfg, device="cpu")
    assert all(t.dtype == torch.bfloat16 for _, t in flatten_params(mine))
    f32 = torch.tensor([1.5, -2.25])
    assert array_to_tensor(tensor_to_array(f32)).dtype == torch.float32


@pytest.mark.parametrize("backend", ["dense", "flash", "fused_layer"])
def test_bf16_storage_forward_and_server_match_jax(backend):
    jcfg, cfg, tree = _bf16_tree(attention_backend=backend)
    params = params_from_jax(tree, cfg, device="cpu")
    inputs = _inputs(cfg, 6)
    jlogits, jdist = _jax_apply(tree, jcfg, inputs)
    logits, dist = _port_apply(params, cfg, inputs)
    # logits in JAX's dtype: bf16, but after the flash kernels' f32 output,
    # which the rest of the model promotes to, f32
    want_dtype = torch.float32 if backend == "flash" else torch.bfloat16
    assert str(jlogits.dtype) == str(want_dtype).replace("torch.", "")
    assert logits.dtype == want_dtype and dist.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(jlogits, np.float32), rtol=0, atol=BF16_TOL)
    src, static, times, _ = inputs
    server = InferenceServer(cfg, params, buckets=(4,), device="cpu")
    probs = server.predict(src.transpose(1, 0, 2), times.T, static)
    server.close()
    want = np.asarray(jax.nn.softmax(jlogits.astype(jnp.float32), axis=-1))
    assert probs.dtype == np.float32
    np.testing.assert_allclose(probs, want, rtol=0, atol=BF16_TOL)


def test_a_jax_bf16_checkpoint_loads_bit_for_bit(tmp_path):
    _, cfg, tree = _bf16_tree(1)
    path = os.path.join(tmp_path, "jax_ckpt")
    jax_checkpoint.save_checkpoint(path, tree, meta={"from": "jax"})
    with np.load(path + ".npz") as z:
        assert z["params/R_u"].dtype == BF16_NUMPY      # what np.savez writes
    params, _, meta = load_checkpoint(path, raindrop_init(0, cfg, device="cpu"))
    assert meta == {"from": "jax"}
    want = dict(flatten_params(tree))
    for p, t in flatten_params(params):
        assert t.dtype == torch.bfloat16, p
        np.testing.assert_array_equal(_bits(t), _bits(want[p]), err_msg=p)


def test_a_port_bf16_checkpoint_reads_as_the_jax_tree(tmp_path):
    """Parameters and the optimizer state of a bf16 trainer after a step:
    plain np.load viewed as ml_dtypes.bfloat16 gives the JAX tree, and the
    port's load_checkpoint gives every leaf back bit for bit."""
    _, cfg, tree = _bf16_tree(2)
    tr = Trainer(cfg, TrainConfig(dataset="P12", learning_rate=LR, batch_size=B),
                 device="cpu", params=params_from_jax(tree, cfg, device="cpu"))
    path = os.path.join(tmp_path, "port_ckpt")
    save_checkpoint(path, params_from_jax(tree, cfg, device="cpu"))
    with np.load(path + ".npz") as z:
        for p, a in flatten_params(tree):
            np.testing.assert_array_equal(z[f"params/{p}"].view(ml_dtypes.bfloat16), a)
    split = _split(cfg, 8)
    tr.train_step(_torch_batch(_batch_np(split, np.arange(B))))
    state = tr.opt_state()
    mu = dict(flatten_params(state["mu"]))
    assert mu and all(a.dtype == BF16_NUMPY for a in mu.values())
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in tr.optimizer.state.values())
    save_checkpoint(path, tr.params, state)
    params, state2, _ = load_checkpoint(path, raindrop_init(0, cfg, device="cpu"), state)
    for (p, a), (_, b) in zip(flatten_params(tr.params), flatten_params(params)):
        np.testing.assert_array_equal(_bits(a.detach()), _bits(b), err_msg=p)
    for (p, a), (_, b) in zip(flatten_params(state), flatten_params(state2)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, p
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), p
    # and into a fresh trainer: the moments keep their dtype and bits
    tr2 = Trainer(cfg, tr.tcfg, device="cpu", params=params)
    tr2.load_opt_state(state2)
    for (_, t), (_, t2) in zip(tr.live, tr2.live):
        a, b = tr.optimizer.state[t], tr2.optimizer.state[t2]
        assert b["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(a["exp_avg"], b["exp_avg"])


def test_bf16_grad_microbatches_average_in_f32():
    """With bf16 parameters the chunks' gradients add in f32 and their mean
    is rounded once to bf16, as the JAX trainer's accumulator does: one
    step at grad_microbatches=2 against the JAX trainer's."""
    jtr, jparams, tr, cfg = _jax_and_port_trainers(
        "P19", dtype="bfloat16", attention_backend="dense")
    jtr2 = JaxTrainer(jtr.cfg, dataclasses.replace(jtr.tcfg, grad_microbatches=2))
    tr2 = Trainer(cfg, dataclasses.replace(tr.tcfg, grad_microbatches=2),
                  device="cpu", params=tr.params)
    split = _split(cfg, 12)
    b = _batch_np(split, np.arange(6))
    key = jax.random.PRNGKey(7)
    jkeys = jax.random.split(key, 2)
    opt_state = jtr2.optimizer.init(jparams)
    jparams, _, jloss, _ = jtr2._train_step(
        jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()}, key)
    loss, _ = tr2.train_step(_torch_batch(b), [
        seeds_from_jax_key(k, cfg.nlayers) for k in jkeys])
    assert abs(float(loss) - float(jloss)) <= BF16_TOL * abs(float(jloss))
    assert all(t.dtype == torch.bfloat16 for _, t in tr2.live)
    _assert_params_bf16_close(tr2, dict(flatten_params(jax.device_get(jparams))))
    # without use_beta the two trainers' masks are the same
    assert (dict(flatten_params(raindrop_param_mask(cfg)))
            == dict(flatten_params(jax_param_mask(jtr.cfg))))
