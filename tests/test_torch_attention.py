"""flash_mha_packed forward: the port's plain version against the JAX
kernel (Pallas, interpret mode on the CPU).

Tolerances: o and lse at 2e-5 in f32 (the same arithmetic, summed in
another order); o at 2e-2 with bf16 operands (bf16 keeps 8 bits, and the
two sides round the probabilities at other points of the sum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raindrop_tpu.ops import flash_attention as jfa

from raindrop_tpu_torch.ops import flash_attention as fa

B, D, NHEAD = 3, 16, 2


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(3))
    lengths = np.array([T, T - 5, 0], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("T", [13, 24])
def test_packed_fwd_f32_matches_jax(T):
    q, k, v, lengths = _inputs(T)
    o, lse = fa._packed_fwd(*map(torch.from_numpy, (q, k, v, lengths)),
                            None, 0.0, None, NHEAD)
    jo, res = jfa._packed_fwd(*map(jnp.asarray, (q, k, v, lengths)),
                              None, 0.0, None, NHEAD)
    jlse = np.asarray(res[6])[:, :, :T]
    assert o.shape == (B, T, D) and lse.shape == (B, NHEAD, T)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=2e-5, atol=2e-5)
    # a sample with no valid key: o = 0 and lse = NEG_INF, as on the TPU
    assert (o[2] == 0).all() and (lse[2] == fa.NEG_INF).all()
    o2 = fa.flash_mha_packed(*map(torch.from_numpy, (q, k, v, lengths)),
                             nhead=NHEAD)
    assert torch.equal(o2, o)


@pytest.mark.parametrize("T", [13, 24])
def test_packed_fwd_bf16_matches_jax(T):
    q, k, v, lengths = _inputs(T, seed=1)
    o = fa.flash_mha_packed(*map(torch.from_numpy, (q, k, v, lengths)),
                            None, 0.0, "bfloat16", NHEAD)
    jo = jfa.flash_mha_packed(*map(jnp.asarray, (q, k, v, lengths)),
                              None, 0.0, "bfloat16", NHEAD)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=2e-2)


def test_packed_fwd_refuses_what_this_slice_does_not_serve():
    q = torch.zeros((1, 8, 4))
    lengths = torch.tensor([8])
    with pytest.raises(NotImplementedError, match="training slice"):
        fa.flash_mha_packed(q, q, q, lengths, None, 0.1, None, 2)
    big = torch.zeros((1, 1025, 4))
    with pytest.raises(NotImplementedError, match="later slice"):
        fa.flash_mha_packed(big, big, big, lengths, None, 0.0, None, 2)
    with pytest.raises(ValueError):
        fa.flash_mha_packed(q, q, q, lengths, None, 0.0, "float16", 2)
