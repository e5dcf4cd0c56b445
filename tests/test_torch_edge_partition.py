"""The port's edge-partitioned aggregation (parallel/edge_partition.py) on
two gloo ranks (raindrop_tpu_torch.parallel.launch.run_ranks, a 1 x 2
mesh, each rank its contiguous half of the edges) against the JAX
package's spmm_segment_softmax_sharded on make_mesh(1, 2) over two of the
8 virtual devices: the aggregate, the softmax weights (the ranks' halves
joined) and the gradient of the node features (jax.vjp with the same
cotangent), gathering at the source and at the target; and a gamma with
-inf edges, a destination whose every edge is -inf and one without edges
(zero denominators); the gradient of gamma (which JAX's pmax does not
differentiate) against ops/segment's one-device softmax and sum; the
refusal of an edge count the axis does not divide."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.parallel import make_mesh as jax_make_mesh
from raindrop_tpu.parallel.edge_partition import spmm_segment_softmax_sharded as jax_sharded

from raindrop_tpu_torch.ops.segment import segment_softmax, segment_sum
from raindrop_tpu_torch.parallel.edge_partition import edge_shard
from raindrop_tpu_torch.parallel.launch import run_ranks
from raindrop_tpu_torch.parallel.mesh import Shard

from tests import torch_route_workers as workers

B, N, D, E = 4, 6, 16, 32
TOL = 1e-6


def _case(seed, gather_target, inf_edges=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, size=E).astype(np.int32)
    # node N - 1 has no incoming edge: a zero denominator
    dst = np.sort(rng.integers(0, N - 1, size=E)).astype(np.int32)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    gamma = rng.normal(size=(B, E)).astype(np.float32)
    if inf_edges:
        gamma[:, ::5] = -np.inf
        gamma[:, dst == dst[0]] = -np.inf      # a destination with every edge -inf
    g = rng.normal(size=(B, N, D)).astype(np.float32)
    return x, gamma, src, dst, gather_target, g


CASES = [("source", _case(0, False)), ("target", _case(1, True)),
         ("inf-edges", _case(2, True, inf_edges=True))]


@pytest.fixture(scope="module")
def port():
    return run_ranks(workers.edge, 2, [c for _, c in CASES], timeout_s=180)


def _jax(x, gamma, src, dst, gather_target, g):
    mesh = jax_make_mesh(1, 2, devices=jax.devices()[:2])

    @jax.jit
    def run(x, g):
        def f(x):
            return jax_sharded(mesh, x, jnp.asarray(gamma), jnp.asarray(src),
                               jnp.asarray(dst), gather_target=gather_target)
        (out, w), vjp = jax.vjp(f, x)
        return out, w, vjp((g, jnp.zeros_like(w)))[0]

    return tuple(np.asarray(a) for a in run(jnp.asarray(x), jnp.asarray(g)))


@pytest.mark.parametrize("case", range(len(CASES)), ids=[n for n, _ in CASES])
def test_edge_partitioned_matches_jax(port, case):
    out, w, gx = _jax(*CASES[case][1])
    assert np.isfinite(out).all() and np.isfinite(w).all()
    for r in range(2):
        got_out, _, got_gx, _ = port[r][case]
        np.testing.assert_allclose(got_out, out, rtol=TOL, atol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got_gx, gx, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
    got_w = np.concatenate([port[0][case][1], port[1][case][1]], axis=1)
    np.testing.assert_allclose(got_w, w, rtol=TOL, atol=TOL)
    if CASES[case][0] == "inf-edges":
        assert (got_w[:, CASES[case][1][1][0] == -np.inf] == 0).all()


@pytest.mark.parametrize("case", range(len(CASES)), ids=[n for n, _ in CASES])
def test_the_gradient_of_gamma_matches_one_device(port, case):
    """Each rank uses the softmax's denominators for its own edges only, so
    their gradient is summed over the edge shards (tensor.psum)."""
    x, gamma, src, dst, gather_target, g = CASES[case][1]
    gt = torch.tensor(gamma, requires_grad=True)
    idx = torch.tensor(dst if gather_target else src).long()
    d = torch.tensor(dst).long()
    w = segment_softmax(gt.T, d, N)                                   # [E, B]
    out = segment_sum(torch.tensor(x).transpose(0, 1)[idx] * w[..., None], d, N)
    (out.transpose(0, 1) * torch.tensor(g)).sum().backward()
    got = np.concatenate([port[0][case][3], port[1][case][3]], axis=1)
    np.testing.assert_allclose(got, gt.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_an_edge_count_the_axis_does_not_divide_raises():
    e = torch.arange(33)
    with pytest.raises(ValueError, match="must divide the edge count 33"):
        edge_shard(e, e, torch.zeros(2, 33), Shard(0, 2, 0, 2))
