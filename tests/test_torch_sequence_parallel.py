"""The port's sequence-parallel and ring attention (parallel/sequence.py)
against the JAX package's on meshes of the same shape: the port's ranks
are four gloo processes (raindrop_tpu_torch.parallel.launch.run_ranks) on
a 2 x 2 mesh, whose model groups also serve as two 1 x 2 meshes on the
whole batch; JAX's run under shard_map on make_mesh(n_data, n_model) over
the first n_data * n_model of the 8 virtual devices. Ragged lengths with a
length-0 sample and one ending inside a rank's block, dropout 0 and 0.3
(the coordinate hash, the same seed both sides): every rank's output rows
and the gradients of its rows of q, k and v, gathered, within 1e-5 of
JAX's (jax.vjp with the same cotangent). The keys' and values' gradients
hold only when each rank's share of them is summed over the model axis.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raindrop_tpu.parallel import make_mesh as jax_make_mesh
from raindrop_tpu.parallel import sequence as jseq

from raindrop_tpu_torch.parallel.launch import run_ranks
from raindrop_tpu_torch.parallel.mesh import Shard
from raindrop_tpu_torch.parallel.sequence import _dropout_keep, time_shard

from tests import torch_route_workers as workers

B, H, T, D = 4, 2, 16, 8
LENGTHS = np.asarray([16, 11, 0, 3], np.int32)     # 11 and 3 end inside a block
SEED = 12345
TOL = 1e-5


def test_dropout_keep_is_the_jax_hash_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(3):
        seed = int(rng.integers(0, 2 ** 31 - 1))
        n_b, n_h, t_q, t_k = (int(v) for v in rng.integers(1, 7, size=4))
        s0, q_off, k_off = (int(v) for v in rng.integers(0, 5000, size=3))
        rate = float(rng.choice([0.1, 0.3, 0.5]))
        want = jseq._dropout_keep(jnp.int32(seed), jnp.int32(s0), n_b, n_h, t_q, t_k,
                                  jnp.int32(q_off), jnp.uint32(k_off), rate)
        got = _dropout_keep(seed, s0, n_b, n_h, t_q, t_k, q_off, k_off, rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < float(got.mean()) < 1


def test_a_time_axis_the_model_axis_does_not_divide_raises():
    with pytest.raises(ValueError, match="divide"):
        time_shard(30, Shard(0, 2, 1, 4))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4)]


def _jax(name, shape, rate, q, k, v, g):
    mesh = jax_make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    fn = jseq.sequence_parallel_attention if name == "sp" else jseq.ring_attention

    def f(q, k, v):
        return fn(mesh, q, k, v, jnp.asarray(LENGTHS), dropout_rate=rate,
                  seed=SEED if rate else None)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(g)

    return tuple(np.asarray(x) for x in run(*(jnp.asarray(a) for a in (q, k, v, g))))


def _assemble(results, case, shape):
    """(out, dq, dk, dv) [B, H, T, D] from the ranks' rows of a case (a
    (1, 2) case's two model groups each hold it whole: the first one's)."""
    full = [np.full((B, H, T, D), np.nan, np.float32) for _ in range(4)]
    b_loc, t_loc = B // shape[0], T // shape[1]
    for r, res in enumerate(results):
        if shape[0] == 1 and r >= 2:
            continue
        *arrays, (b0, m) = res[case]
        for dst, a in zip(full, arrays):
            dst[b0:b0 + b_loc, :, m * t_loc:(m + 1) * t_loc] = a
    assert not any(np.isnan(a).any() for a in full)
    return full


CASES = [(shape, name, rate) for shape in ((1, 2), (2, 2)) for name in ("sp", "ring")
         for rate in (0.0, 0.3)]


@pytest.fixture(scope="module")
def port():
    """Every case on one group of four ranks: {case: (out, dq, dk, dv)}."""
    q, k, v, g = _inputs(0)
    results = run_ranks(workers.sequence, 4,
                        [(shape, name, rate, SEED if rate else None, q, k, v, LENGTHS, g)
                         for shape, name, rate in CASES], timeout_s=240)
    out = {}
    for i, (shape, name, rate) in enumerate(CASES):
        if shape == (1, 2):     # the two model groups give the same numbers
            for a, b in zip(results[0][i][:4], results[2][i][:4]):
                np.testing.assert_array_equal(a, b)
        out[(shape, name, rate)] = _assemble(results, i, shape)
    return (q, k, v, g), out


@pytest.mark.parametrize("shape,name,rate", CASES)
def test_sp_and_ring_match_jax(port, shape, name, rate):
    """Outputs and q/k/v gradients within 1e-5 of JAX's; the length-0
    sample's rows zeros."""
    (q, k, v, g), got = port
    want = _jax(name, shape, rate, q, k, v, g)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got[(shape, name, rate)], want):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                   err_msg=f"{name} {shape} rate {rate} {what}")
    assert not got[(shape, name, rate)][0][2].any()


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sp_and_ring_agree_at_dropout(port, shape):
    """At dropout 0.3 the two draw one mask at the same global coordinates,
    so they compute the same function."""
    _, got = port
    for a, b in zip(got[(shape, "sp", 0.3)], got[(shape, "ring", 0.3)]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
