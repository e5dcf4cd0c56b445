"""The fused encoder layer past the widths the tile-resident routes take,
on the CPU: P12's sensor-wise width (d 720, ffn 288) at 2 heads (hd 360)
and at 1 (hd 720), and P19's (d 680, ffn 272, hd 340), which the card
runs on the "stream" route (csrc/rows_stream.cuh; past hd 368 its
attention on "tc_cluster" in bf16, "hd_stream" in f32). The port's wrappers run their plain versions
here (a CPU tensor never reaches CUDA); the JAX kernel runs in Pallas
interpret mode, as its own tests run it off the TPU. Inputs from a numpy
seed, B=2, T=16, one sample shorter than T.

Checked: out, attn and lse of the forward, dx and all 12 weight gradients
(jax.vjp) at dropout 0 and 0.2 (the same counter-hash masks at all four
sites), and P12's sensor-wise model (`dataset_config("P12",
sensor_wise_mask=True, max_len=16)`, 2 layers) on the fused rung, eval
and train-mode logits, loss and every parameter's gradient through the
parameter bridge. Tolerances, as tests/test_torch_fused_encoder_bwd.py
and tests/test_torch_wide_heads.py: 2e-5 in f32 (gradients relative to
max(1, their largest |value|)), 2e-2 with bf16 compute; the model's
logits 1e-4, its loss 1e-5 relative, each gradient leaf 1e-4 of max(1,
its largest |value|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.ops import fused_encoder as jfe

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply
from raindrop_tpu_torch.nn.transformer import encoder_rung
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.train.trainer import flatten_params

from tests.test_torch_model import _batch
from tests.torch_port_util import random_layer, seeds_from_jax_key, to_torch

B, T, SEED = 2, 16, 4242
TOL = {None: 2e-5, "bfloat16": 2e-2}
# (d, ffn, nhead): P12-sw at 2 heads and at 1, P19-sw at 2
WIDTHS = [(720, 288, 2), (720, 288, 1), (680, 272, 2)]


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("d,ffn,nhead", WIDTHS)
def test_the_card_takes_these_widths_on_the_stream_route(d, ffn, nhead):
    """Past hd 368 the attention runs on "tc_cluster" in bf16 and on
    "hd_stream" in f32; below it on two warpgroups of tensor cores in bf16
    and on the scalar kernels in f32."""
    for od in (torch.float32, torch.bfloat16):
        plan = fe.fused_plan(d, ffn, nhead, od)
        assert plan.route == "stream"
        bf = od == torch.bfloat16
        assert plan.attn_route == (("tc_cluster" if bf else "hd_stream") if d // nhead > 368
                                   else "tc_wide" if bf else "scalar")


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("d,ffn,nhead", WIDTHS)
def test_layer_matches_jax(d, ffn, nhead, cd, rate):
    """out, attn and lse against the JAX kernel's forward; dx and the 12
    weight gradients against jax.vjp. In f32 the port's gradients come
    through autograd from its own forward. With bf16 compute the two
    forwards' attention outputs differ by bf16 rounding (about 1.4e-3 at d
    720), and a relu pre-activation within that of zero (146 of the 9216
    here lie within 1e-2) takes the other branch on the two sides, moving
    single gradient elements by O(1): there the port's backward
    (`_fused_bwd_plain`, what its kernels compute) runs on JAX's saved
    attention output and lse, so that both recompute one forward."""
    p = random_layer(d + nhead, d, ffn)
    rng = np.random.default_rng(d + nhead)
    x, g = (rng.normal(size=(B, T, d)).astype(np.float32) for _ in range(2))
    lengths = np.array([T, T - 5], np.int32)
    jseed = jnp.asarray([SEED], jnp.int32)
    _, res = jfe._fused_fwd(p, jnp.asarray(x), jnp.asarray(lengths), jseed, rate, cd, nhead)
    fn = lambda p, x: jfe.fused_encoder_layer(  # noqa: E731
        p, x, jnp.asarray(lengths), jseed, rate, cd, nhead)
    jout, vjp = jax.vjp(fn, p, jnp.asarray(x))
    jdp, jdx = vjp(jnp.asarray(g))

    tp = to_torch(p, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    tlen = torch.from_numpy(lengths)
    with torch.no_grad():
        _, attn, lse = fe._fused_fwd(tp, tx, tlen, SEED, rate, cd, nhead)
    out = fe.fused_encoder_layer(tp, tx, tlen, SEED, rate, cd, nhead)
    tol = TOL[cd]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=tol)
    jattn = torch.from_numpy(np.array(res[4])[:, :T])
    jlse = torch.from_numpy(np.array(res[5])[:, :, :T])
    np.testing.assert_allclose(attn.numpy(), jattn.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(lse.numpy(), jlse.numpy(), rtol=0, atol=tol)
    if cd is None:
        out.backward(torch.from_numpy(g))
        dx = tx.grad
        dws = [_leaf(tp, path).grad for path in fe._WEIGHTS]
    else:
        dx, dws = fe._fused_bwd_plain(
            to_torch(p), torch.from_numpy(x), tlen, SEED, rate, nhead,
            torch.bfloat16, jattn, jlse, torch.from_numpy(g))

    def close(name, got, want):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max())
        assert np.isfinite(want).all() and err <= tol, (name, err)

    close("dx", dx, jdx)
    for path, got in zip(fe._WEIGHTS, dws):
        close("/".join(path), got, _leaf(jdp, path))


def test_p12_sensor_wise_model_on_the_fused_rung_matches_jax():
    """P12-sw (d 720, 2 heads of 360, ffn 288, 2 layers) at max_len 16 with
    the fused rung forced (the ladder takes it at T=600 on the card), B=3
    with a sample of length 0, dropout 0.2: eval logits, and in train mode
    with the JAX key's masks the logits, the loss and every parameter's
    gradient."""
    kw = dict(sensor_wise_mask=True, max_len=16, attention_backend="fused_layer",
              attention_score_dtype="float32")
    jcfg, cfg = jax_dataset_config("P12", **kw), dataset_config("P12", **kw)
    assert (cfg.d_transformer, cfg.nhead, cfg.ffn_dim, cfg.nlayers) == (720, 2, 288, 2)
    assert encoder_rung(cfg.attention_backend, 600, 720, 2, True) == "fused_layer"
    assert fe.fused_plan(720, 288, 2, torch.bfloat16).route == "stream"
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(7)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    src, static, times, lengths = _batch(cfg)
    y = np.array([1, 0, 1])
    key = jax.random.PRNGKey(29)
    jargs = [jnp.asarray(a) for a in (src, static, times, lengths)]

    def jax_loss(params, train):
        logits, _ = jax_raindrop_apply(params, jcfg, *jargs, train=train, rng=key)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(3), jnp.asarray(y)]), logits

    jtree = jax.tree.map(jnp.asarray, tree)
    (jl, jlogits), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(jtree, True)
    _, jeval = jax_loss(jtree, False)
    params = params_from_jax(tree, cfg, device="cpu")
    leaves = dict(flatten_params(params))
    for t in leaves.values():
        t.requires_grad_()
    targs = [torch.from_numpy(a) for a in (src, static, times, lengths)]
    calls = fe.fused_encoder_layer.launches
    with torch.no_grad():
        logits_eval, _ = raindrop_apply(params, cfg, *targs, train=False)
    np.testing.assert_allclose(logits_eval.numpy(), np.asarray(jeval), rtol=1e-4, atol=1e-4)
    logits, _ = raindrop_apply(params, cfg, *targs, train=True,
                               seeds=seeds_from_jax_key(key, cfg.nlayers))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    # the plain versions ran (no kernel launched on the CPU)
    assert fe.fused_encoder_layer.launches == calls
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(flatten_params(jax.device_get(jgrad)))
    assert set(want) == set(leaves)
    for path, t in leaves.items():
        w = np.asarray(want[path])
        got = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        err = np.abs(got - w).max() / max(1.0, np.abs(w).max())
        assert err <= 1e-4, (path, err)
