"""The port's segment ops against raindrop_tpu.ops.segment on the CPU.

Inputs from a numpy seed; ids unsorted, some segments empty. Tolerance
1e-6: the same f32 sums over at most a few dozen terms, possibly in another
order. The card's route of segment_sum (a product with the one-hot matrix)
is run here on the CPU too, against the index_add route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raindrop_tpu.ops import segment as jseg

from raindrop_tpu_torch.ops import segment as seg

N, E = 9, 40


def _ids(rng, empty=True):
    ids = rng.integers(0, N, size=E)
    if empty:                       # segments 2 and 7 get no edge
        ids = np.where((ids == 2) | (ids == 7), 3, ids)
    return ids.astype(np.int32)


@pytest.mark.parametrize("trailing", [(), (5,), (3, 4)])
@pytest.mark.parametrize("op", ["segment_sum", "segment_max", "segment_softmax"])
def test_segment_op_matches_jax(op, trailing):
    rng = np.random.default_rng(len(trailing) + 7)
    ids = _ids(rng)
    data = rng.normal(size=(E,) + trailing).astype(np.float32)
    got = getattr(seg, op)(torch.from_numpy(data), torch.from_numpy(ids), N)
    want = np.asarray(getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), N))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if op == "segment_sum":
        assert (got[2] == 0).all() and (got[7] == 0).all()
    if op == "segment_max":
        assert torch.isinf(got[2]).all()


def test_softmax_sums_to_one_per_segment_and_zero_denominator_divides_by_one():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(_ids(rng))
    w = seg.segment_softmax(torch.from_numpy(rng.normal(size=(E, 3)).astype(np.float32)),
                            ids, N)
    sums = seg.segment_sum(w, ids, N)
    live = torch.bincount(ids.long(), minlength=N) > 0
    np.testing.assert_allclose(sums[live].numpy(), 1.0, rtol=1e-6)
    assert (sums[~live] == 0).all()
    # logits of -inf: exp gives 0, the denominator 0 divides by 1
    dead = seg.segment_softmax(torch.full((E,), float("-inf")), ids, N)
    assert (dead == 0).all()


def test_softmax_gradient_matches_autograd_of_the_dense_form():
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(_ids(rng, empty=False))
    logits = torch.from_numpy(rng.normal(size=(E,)).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.normal(size=(E,)).astype(np.float32))
    (seg.segment_softmax(logits, ids, N) * cot).sum().backward()
    ref = logits.detach().clone().requires_grad_()
    member = ids.long()[None, :] == torch.arange(N)[:, None]          # [N, E]
    dense = torch.softmax(torch.where(member, ref[None, :], float("-inf")), dim=1)
    (torch.where(member, dense, 0.0).sum(0) * cot).sum().backward()
    np.testing.assert_allclose(logits.grad.numpy(), ref.grad.numpy(), atol=1e-6)


def test_the_one_hot_route_of_the_card_equals_index_add():
    """segment_sum's CUDA route, run on CPU tensors."""
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(_ids(rng))
    data = torch.from_numpy(rng.normal(size=(E, 4, 3)).astype(np.float32))
    want = seg.segment_sum(data, ids, N)
    got = seg._segment_sum_onehot(data, ids.long(), N)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
