"""Attention past head dim 368 and calls past 65535 samples, on the CPU.

Past MAX_HEAD_DIM (368) flash_mha_packed and flash_mha take the
"hd_stream" route on the card (csrc/attention_hd_stream.cuh) with f32
operands, and with bf16 on request (impl="hd_stream", the previous design;
bf16 takes the tensor-core route "tc_cluster" by default,
tests/test_torch_tc_cluster.py): its launch plan is held here at every hd
369-1024, its shared bytes (a mirror of the header's sizes) are the same
at every hd and fit a block. The functions the kernels compute, the plain versions,
are held against the JAX kernels (Pallas in interpret mode) at hd 400:
the packed pair, flash_mha in both JAX regimes, and a one-head sensor-wise
model (d_inp 20 x (d_ob 4 + d_pe 16) = 400) on the packed rung: eval
logits, train-mode logits, loss and gradients with the JAX key's masks.

A call over more than MAX_BATCH samples runs as launches at their sample
origins (batch_chunks): the chunks cover [0, B), and the hash at a sample
index past 65535 is JAX's at that uint32 bh, so a chunk draws the masks
of the whole call. The card tests (tests/test_torch_kernels_cuda.py) hold
the kernels against these plain versions at hd 372, 720, 1024 and
B=70000.

Tolerances, as the narrower tests of each module: the attention 2e-5 in
f32 and 2e-2 with bf16 operands (tests/test_torch_sensor_wise.py); the
model's logits 1e-4 (tests/test_torch_model.py), its loss 1e-5 relative
and each gradient leaf 1e-4 of max(1, its largest |value|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_apply as jax_raindrop_apply
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.ops import flash_attention as jfa

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.models.raindrop import raindrop_apply
from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.train.trainer import flatten_params

from tests.test_torch_model import _batch
from tests.test_torch_fused_plan import _as_previous, _previous_plan
from tests.test_torch_split_plan import hd_stream_smem
from tests.torch_port_util import seeds_from_jax_key

BF16, F32 = torch.bfloat16, torch.float32
SEED = 777
TOL = {None: 2e-5, "bfloat16": 2e-2}
SMEM = 232448        # a block's shared bytes on the H100


@pytest.mark.parametrize("hd", range(fa.MAX_HEAD_DIM + 1, 1025))
def test_every_head_dim_past_368_takes_the_new_route(hd):
    """Both plans, both dtypes (bf16 on request, impl="hd_stream"; by
    default it takes "tc_cluster"), one and three heads: the route, its
    rows, the grid (the 32-row blocks times the 256-column slices along
    x), one element a copy; the shared bytes the same at every hd."""
    slices = -(-hd // fa.HD_STREAM_SLICE)
    for od in (BF16, F32):
        impl = "hd_stream" if od == BF16 else "auto"
        assert fa.packed_plan(7, 215, hd, 1, od).route == (
            "tc_cluster" if od == BF16 else "hd_stream")
        for nhead in (1, 3):
            p = fa.packed_plan(7, 215, nhead * hd, nhead, od, impl)
            assert (p.route, p.hd, p.hd_pad, p.rows, p.copy_bytes, p.threads) == (
                "hd_stream", hd, hd, 32, od.itemsize, (256,) * 3)
            assert p.grid == (7 * slices, nhead, 7) == p.dkv_grid
            assert tuple(p.as_ints) == (3, hd, od.itemsize, 32, 256, 256, 256,
                                        7 * slices, nhead, 7)
        s = fa.split_plan(5, 2, 2048, hd, od, ((2048 * 2 * hd, hd, 2 * hd),), 16, impl)
        assert (s.route, s.hd_pad, s.rows, s.copy_bytes, s.cols) == (
            "hd_stream", hd, 32, od.itemsize, hd)
        assert s.grid == (64 * slices, 2, 5)
    assert hd_stream_smem() == (45568, 54016, 91392)
    assert max(hd_stream_smem()) <= SMEM


def test_below_369_the_routes_are_unchanged():
    """impl="hd_stream" reaches the new route at any hd (its bits are the
    scalar Wide kernels', a check on the card); "auto" below 369 keeps
    every earlier route."""
    assert fa.packed_plan(4, 64, 360, 1, BF16).route == "tc_wide"
    assert fa.packed_plan(4, 64, 360, 1, F32).route == "scalar"
    assert fa.split_plan(4, 1, 64, 42, BF16).route == "tc"
    p = fa.packed_plan(4, 64, 2 * 200, 2, F32, "hd_stream")
    assert (p.route, p.grid) == ("hd_stream", (2, 2, 4))
    assert fa.packed_plan(4, 64, 2 * 200, 2, F32).grid == (2, 2, 4)   # Wide, 32 rows
    x = torch.zeros(1, 1, 4, 400)
    (y,), cols = fa._flash_operands((x,), BF16)
    # the tensor-core routes' padded cast: 400 columns are a multiple of 8
    assert cols == 400 and y.shape == x.shape and y.dtype == BF16


def _packed(q, k, v, g, lengths, rate, cd, nhead, port):
    if port:
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = fa.flash_mha_packed(tq, tk, tv, torch.from_numpy(lengths), SEED, rate, cd, nhead)
        o.backward(torch.from_numpy(g))
        return o.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]
    fn = lambda q, k, v: jfa.flash_mha_packed(  # noqa: E731
        q, k, v, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, cd, nhead)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("nhead", [1, 2])
def test_packed_pair_at_hd_400_matches_jax(nhead, cd, rate):
    hd, T = 400, 21
    rng = np.random.default_rng(nhead)
    q, k, v, g = (rng.normal(size=(3, T, nhead * hd)).astype(np.float32) for _ in range(4))
    lengths = np.array([T, T - 6, 0], np.int32)
    o, grads = _packed(q, k, v, g, lengths, rate, cd, nhead, True)
    jo, jgrads = _packed(q, k, v, g, lengths, rate, cd, nhead, False)
    np.testing.assert_allclose(o, jo, rtol=0, atol=TOL[cd])
    assert (o[2] == 0).all()
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[cd])
        assert (got[2] == 0).all()


def _split(q, k, v, g, lengths, rate, cd, port):
    if port:
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = fa.flash_mha(tq, tk, tv, torch.from_numpy(lengths), SEED, rate, cd)
        o.backward(torch.from_numpy(g))
        return o.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]
    fn = lambda q, k, v: jfa.flash_mha(  # noqa: E731
        q, k, v, jnp.asarray(lengths), jnp.asarray([SEED], jnp.int32), rate, cd)
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("regime", ["one program", "streaming"])
@pytest.mark.parametrize("rate,cd", [(0.0, None), (0.2, None), (0.2, "bfloat16")])
def test_flash_mha_at_hd_400_matches_jax(monkeypatch, regime, rate, cd):
    """The JAX one-program regime at T=40, the streaming one at T=192 with
    its MAX_FUSED_T patched down to 64 (the port has one regime). A length-0
    sample is compared where JAX's one-program backward is finite
    (tests/test_torch_flash_mha.py says why)."""
    T = 40
    if regime == "streaming":
        monkeypatch.setattr(jfa, "MAX_FUSED_T", 64)
        T = 192
    rng = np.random.default_rng(T)
    q, k, v, g = (rng.normal(size=(2, 2, T, 400)).astype(np.float32) for _ in range(4))
    lengths = np.array([T - 3, 0], np.int32)
    o, grads = _split(q, k, v, g, lengths, rate, cd, True)
    jo, jgrads = _split(q, k, v, g, lengths, rate, cd, False)
    np.testing.assert_allclose(o, jo, rtol=0, atol=TOL[cd])
    for got, want in zip(grads, jgrads):
        ok = np.isfinite(want)
        assert ok[0].all() and (got[1] == 0).all()
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=TOL[cd])


def _one_head_cfgs(**kw):
    kw = dict(sensor_wise_mask=True, nhead=1, d_inp=20, d_ob=4, d_pe=16, max_len=24,
              nlayers=1, attention_backend="flash", attention_score_dtype="float32", **kw)
    return jax_dataset_config("P12", **kw), dataset_config("P12", **kw)


def test_one_head_sensor_wise_model_past_368_matches_jax():
    """P12's sensor-wise model at one head, narrowed to hd 400 (d_inp 20),
    T=24, B=3 (one sample of length 0), 1 layer, dropout 0.2, on the packed
    rung: eval logits, and in train mode with the JAX key's masks the
    logits, the loss and every parameter's gradient."""
    jcfg, cfg = _one_head_cfgs()
    assert cfg.d_transformer == 400 and cfg.nhead == 1
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(5)
    for layer in tree["transformer_encoder"].values():
        layer["in_proj_b"] = rng.normal(size=layer["in_proj_b"].shape).astype(np.float32)
    src, static, times, lengths = _batch(cfg)
    y = np.array([1, 0, 1])
    key = jax.random.PRNGKey(23)
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
    with torch.no_grad():
        logits_eval, _ = raindrop_apply(params, cfg, *targs, train=False)
    np.testing.assert_allclose(logits_eval.numpy(), np.asarray(jeval), rtol=1e-4, atol=1e-4)
    logits, _ = raindrop_apply(params, cfg, *targs, train=True,
                               seeds=seeds_from_jax_key(key, cfg.nlayers))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
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


@pytest.mark.parametrize("B", [1, 100, fa.MAX_BATCH, fa.MAX_BATCH + 1, 70000, 200000])
def test_the_chunks_cover_the_batch(B):
    chunks = fa.batch_chunks(B)
    assert chunks[0][0] == 0 and chunks[-1][1] == B
    assert all(a < b <= a + fa.MAX_BATCH for a, b in chunks)
    assert all(b == c for (_, b), (c, _) in zip(chunks, chunks[1:]))
    assert len(chunks) == -(-B // fa.MAX_BATCH)
    heads = fa._head_chunks(B, 70000)
    assert len(heads) == len(chunks) * 2
    assert {(b0, b1) for b0, b1, _, _ in heads} == set(chunks)
    assert {(h0, h1) for _, _, h0, h1 in heads} == {(0, 65535), (65535, 70000)}


@pytest.mark.parametrize("bh", [65535, 65536, 70000 * 2 + 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
def test_the_hash_past_sample_65535_is_jax_s(bh):
    """The port's _dropout_keep_hash at a (sample, head) index past the
    old grid limit equals the JAX package's at that uint32 bh."""
    for iq, ik, shape in ((0, 0, (24, 24)), (3, 5, (128, 128)), (101, 0, (16, 400))):
        got = fa._dropout_keep_hash(SEED, bh, iq, ik, shape, 0.2)
        want = jfa._dropout_keep_hash(jnp.asarray([SEED], jnp.int32),
                                      jnp.asarray(bh, jnp.uint32), iq, ik, shape, 0.2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(bool))


def test_a_chunk_at_its_origin_draws_the_whole_call_s_masks():
    """The masks of samples 65530.. at origin (65530, 0, 3): the whole
    call's rows, JAX's hash at bh = b * 3 + h, and the fused layer's site
    masks at sample b; the limit is the uint32 bh."""
    b0, B, H, T = 65530, 12, 3, 13
    keep = fa._attn_keep(SEED, B, T, H, 0.2, "cpu", (b0, 0, H))
    for b in (0, 5, 6, 11):
        for h in range(H):
            want = jfa._dropout_keep_hash(jnp.asarray([SEED], jnp.int32),
                                          jnp.asarray((b0 + b) * H + h, jnp.uint32),
                                          0, 0, (16, 16), 0.2)
            np.testing.assert_array_equal(keep[b, h].numpy(),
                                          np.asarray(want)[:T, :T].astype(bool))
    site = fe._site_keep(SEED, B, fe.SITE_FFN_MID, T, 7, 0.2, "cpu", b0)
    whole = fe._site_keep(SEED, 2, fe.SITE_FFN_MID, T, 7, 0.2, "cpu", b0 + 10)
    assert torch.equal(site[10:], whole)
    assert fa.drop_origin((2 ** 32 // H - B, 0, H), B, H) == (2 ** 32 // H - B, 0, H)
    with pytest.raises(ValueError, match="32 bits"):
        fa.drop_origin((2 ** 32 // H - B + 1, 0, H), B, H)
    with pytest.raises(ValueError, match="32 bits"):
        fa.drop_origin(None, 2 ** 31 + 1, 2)
    assert fa.drop_origin(None, 70000, 1) == (0, 0, 1)


def test_the_plain_version_at_an_origin_past_65535_is_the_whole_call_s_rows():
    """flash_mha_packed's plain forward and backward over samples 65533..
    65538 at their origin equal rows 3.. of a call at origin 65530 (what a
    second launch of a split call computes), within 1e-6: the same masks,
    the CPU's batched products summing in another order at another batch."""
    rng = np.random.default_rng(8)
    B, T, hd, H = 9, 11, 400, 1
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, T, H * hd)).astype(np.float32))
                  for _ in range(4))
    lengths = torch.tensor([11, 4, 0, 11, 9, 1, 6, 11, 2], dtype=torch.int32)
    od = torch.float32
    o, lse = fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, 0.2, (65530, 0, H))
    grads = fa._packed_bwd_plain(q, k, v, lengths, SEED, 0.2, H, od, o, lse, g,
                                 (65530, 0, H))
    rows = slice(3, B)
    o_s, lse_s = fa._packed_fwd_plain(q[rows], k[rows], v[rows], lengths[rows], H, od,
                                      SEED, 0.2, (65533, 0, H))
    torch.testing.assert_close(o_s, o[rows], rtol=0, atol=1e-6)
    torch.testing.assert_close(lse_s, lse[rows], rtol=0, atol=1e-6)
    g_s = fa._packed_bwd_plain(q[rows], k[rows], v[rows], lengths[rows], SEED, 0.2, H, od,
                               o_s, lse_s, g[rows], (65533, 0, H))
    for a, b in zip(g_s, grads):
        torch.testing.assert_close(a, b[rows], rtol=0, atol=1e-6)


# the fused layer's widest layers (ROADMAP queue 2): every d up to these is
# taken, the next multiple of nhead is refused, in f32 and bf16 alike
FUSED_WIDEST = {(1, "136"): 361, (2, "136"): 360, (4, "136"): 360,
                (1, "2d"): 226, (2, "2d"): 226, (4, "2d"): 224}


@pytest.mark.parametrize("od", [F32, BF16])
@pytest.mark.parametrize("nhead,ffn", list(FUSED_WIDEST))
def test_the_fused_layer_s_widest_layers(nhead, ffn, od):
    """The widest widths the fused layer's tile-resident routes fit, all
    below hd 368: up to them the plan is the one those routes took before
    the "stream" route (tests/test_torch_fused_plan.py `_previous_plan`,
    field for field); past them, where fused_plan raised and the JAX
    package's fused kernel takes any width, the "stream" route takes the
    width (ROADMAP queue 2, closed)."""
    widest = FUSED_WIDEST[(nhead, ffn)]
    for d in range(nhead, widest + 1, nhead):
        width = (d, 136 if ffn == "136" else 2 * d, nhead)
        assert _as_previous(fe.fused_plan(*width, od)) == _previous_plan(*width, od)
    d = widest + nhead
    width = (d, 136 if ffn == "136" else 2 * d, nhead)
    assert _previous_plan(*width, od) is None
    assert fe.fused_plan(*width, od).route == "stream"
