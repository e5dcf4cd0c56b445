"""The port's own copy of graph/structure.py against the JAX package's:
the five numpy functions give the same arrays, bit for bit."""

import numpy as np
import pytest

from raindrop_tpu.graph import structure as jst

from raindrop_tpu_torch.graph import structure as st


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 17, 36])
def test_complete_graph_edges(n):
    _same(st.complete_graph_edges(n), jst.complete_graph_edges(n))
    ei, w = st.complete_graph_edges(n)
    assert ei.shape == (2, n * n) and (w == 1).all()
    if n > 1:       # source-major: the destinations are not sorted
        assert (np.diff(ei[0]) >= 0).all() and not (np.diff(ei[1]) >= 0).all()


@pytest.mark.parametrize("force_self_loops", [True, False])
def test_edges_from_adjacency(force_self_loops):
    rng = np.random.default_rng(0)
    adj = rng.uniform(size=(9, 9)) * (rng.uniform(size=(9, 9)) > 0.6)
    before = adj.copy()
    _same(st.edges_from_adjacency(adj, force_self_loops),
          jst.edges_from_adjacency(adj, force_self_loops))
    np.testing.assert_array_equal(adj, before)          # the input is not written


def test_masked_softmax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(8, 8)) * (rng.uniform(size=(8, 8)) > 0.4)
    _same(st.masked_softmax(A), jst.masked_softmax(A))


@pytest.mark.parametrize("compat", [True, False])
def test_generate_global_structure(compat):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(5, 20, 14)).astype(np.float32)
    data[:, :, 3] = 0.0                                   # a silent sensor
    kw = dict(K=4, n_sensors=12, compat=compat)
    _same(st.generate_global_structure(data, **kw),
          jst.generate_global_structure(data, **kw))


@pytest.mark.parametrize("shape,N", [((4, 57), 10), ((2, 3, 40), 8)])
def test_diffuse(shape, N):
    unit = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    _same(st.diffuse(unit, N), jst.diffuse(unit, N))
