"""The port's counter-hash dropout against the JAX package's, bit for bit.

Both sides are integer hashes of (seed, element index), so every
comparison here is exact equality: the bits of `_hash_bits`, the output of
`dropout`, and the kernels' keep masks (`_dropout_keep_hash`), including a
site mask whose padded row count t8 differs from T.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.ops import flash_attention as jfa
from raindrop_tpu.utils import dropout as jdrop

from raindrop_tpu_torch.ops import flash_attention as fa
from raindrop_tpu_torch.ops import fused_encoder as fe
from raindrop_tpu_torch.utils import dropout as drop

from tests.torch_port_util import seed32


@pytest.mark.parametrize("shape", [(7,), (5, 3, 11), (37, 4, 12), (2, 2, 16, 16)])
@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 2 ** 32 - 1])
def test_hash_bits_equal_jax(seed, shape):
    want = np.asarray(jdrop._hash_bits(jnp.uint32(seed), shape))
    got = drop._hash_bits(seed, shape).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("key_seed,shape", [(0, (16, 3, 8)), (7, (37, 2, 20)),
                                            (123, (2, 2, 9, 9))])
def test_dropout_equals_jax(key_seed, shape, rate):
    key = jax.random.PRNGKey(key_seed)
    x = np.random.default_rng(key_seed).normal(size=shape).astype(np.float32)
    want = np.asarray(jdrop.dropout(key, jnp.asarray(x), rate, True))
    got = drop.dropout(seed32(key), torch.from_numpy(x), rate, True).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0).mean() < 2 * rate + 0.1


def test_dropout_is_the_identity_in_eval_and_without_a_seed():
    x = torch.randn(4, 5)
    assert drop.dropout(3, x, 0.2, train=False) is x
    assert drop.dropout(3, x, 0.0) is x
    assert drop.dropout(None, x, 0.2) is x


def _jax_keep(seed, bh, iq, ik, shape, rate):
    return np.asarray(jfa._dropout_keep_hash(
        jnp.asarray([seed], jnp.int32), jnp.int32(bh), iq, ik, shape, rate))


@pytest.mark.parametrize("rate", [0.2, 0.5])
@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2])
def test_attention_keep_mask_equals_jax(seed, rate):
    B, H, T = 2, 2, 13                       # t8 = 16 != T
    got = fa._attn_keep(seed, B, T, H, rate, None).numpy()
    for b in range(B):
        for h in range(H):
            want = _jax_keep(seed, b * H + h, 0, 0, (16, 16), rate)[:T, :T]
            np.testing.assert_array_equal(got[b, h], want.astype(bool))


@pytest.mark.parametrize("T", [16, 37])
@pytest.mark.parametrize("site,n", [(101, 12), (102, 20), (103, 12)])
def test_site_keep_mask_equals_jax(site, n, T):
    seed, rate, B = 991, 0.2, 3
    t8 = -(-T // 8) * 8
    got = fe._site_keep(seed, B, site, T, n, rate, None).numpy()
    assert got.shape == (B, T, n)
    for b in range(B):
        want = _jax_keep(seed, b, site, 0, (t8, n), rate)[:T]
        np.testing.assert_array_equal(got[b], want.astype(bool))
    if t8 != T:
        # hashing with the unpadded row count gives another mask: the
        # padded shape is part of the key
        other = fa._dropout_keep_hash(seed, torch.arange(B), site, 0, (T, n), rate)
        assert not np.array_equal(other.numpy(), got)


def test_draw_fills_every_field_and_repeats_from_a_seed():
    a = drop.DropoutSeeds.draw(torch.Generator().manual_seed(5), 2)
    b = drop.DropoutSeeds.draw(torch.Generator().manual_seed(5), 2)
    assert a == b and len(a.layers) == 2
    flat = [a.embed, a.prop1, a.prop2] + [v for l in a.layers for v in
                                          (l.attn, l.post_attn, l.ffn, l.post_ffn)]
    assert all(0 <= v < 2 ** 32 for v in flat) and len(set(flat)) == len(flat)
    assert all(0 <= l.kernel < 2 ** 31 - 1 for l in a.layers)
