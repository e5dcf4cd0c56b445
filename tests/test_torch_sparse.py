"""spmm_segment_softmax and sddmm of the port (their plain PyTorch versions:
the tensors lie on the CPU) against the JAX package's, whose Pallas kernels
run in interpret mode.

Inputs from a numpy seed; edges in shuffled order, some nodes without an
incoming edge. Tolerances: 1e-5 on values, 1e-4 on gradients, relative to
max(1, |reference|): the same f32 arithmetic summed in another order (the
JAX kernel sums through one-hot matrix products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raindrop_tpu.graph.structure import complete_graph_edges
from raindrop_tpu.ops import sparse_pallas as jsp

from raindrop_tpu_torch.ops import sparse as sp


def _graph(kind, rng):
    """(src, dst, N): edges in an order that sorts neither end."""
    if kind == "random":
        N, E = 7, 30
        src, dst = rng.integers(0, N, size=E), rng.integers(0, N, size=E)
        dst = np.where(dst == 4, 5, dst)           # node 4: no incoming edge
    elif kind == "knn":
        N, k = 12, 3
        dst = np.repeat(np.arange(N - 2), k)       # nodes 10, 11: none
        src = rng.integers(0, N, size=dst.size)
        order = rng.permutation(dst.size)
        src, dst = src[order], dst[order]
    else:                                          # the model's P19 graph
        N = 34
        ei, _ = complete_graph_edges(N)            # source-major: dst unsorted
        src, dst = ei[0], ei[1]
    return src.astype(np.int32), dst.astype(np.int32), N


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


CASES = [("random", 16, False), ("random", 16, True), ("knn", 24, False),
         ("knn", 24, True), ("complete", 240, True), ("complete", 240, False)]


@pytest.mark.parametrize("kind,D,gather_target", CASES)
def test_spmm_value_and_gradient_match_jax(kind, D, gather_target):
    rng = np.random.default_rng(D + gather_target)
    src, dst, N = _graph(kind, rng)
    B, E = 3, src.size
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    gamma = rng.normal(size=(B, E)).astype(np.float32)
    c_out = rng.normal(size=(B, N, D)).astype(np.float32)
    c_w = rng.normal(size=(B, E)).astype(np.float32)

    (jout, jw), vjp = jax.vjp(
        lambda a, g: jsp.spmm_segment_softmax(
            a, g, jnp.asarray(src), jnp.asarray(dst), n_nodes=N,
            gather_target=gather_target), jnp.asarray(x), jnp.asarray(gamma))
    jdx, jdg = vjp((jnp.asarray(c_out), jnp.asarray(c_w)))

    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    out, w = sp.spmm_segment_softmax(tx, tg, torch.from_numpy(src),
                                     torch.from_numpy(dst), n_nodes=N,
                                     gather_target=gather_target)
    _close(out.detach(), jout, 1e-5)
    _close(w.detach(), jw, 1e-5)
    empty = np.setdiff1d(np.arange(N), dst)
    assert (out.detach()[:, empty] == 0).all()
    torch.autograd.backward([out, w], [torch.from_numpy(c_out), torch.from_numpy(c_w)])
    _close(tx.grad, jdx, 1e-4)
    _close(tg.grad, jdg, 1e-4)


def test_spmm_backward_takes_either_cotangent_alone_and_a_broadcast_gamma():
    rng = np.random.default_rng(5)
    src, dst, N = _graph("random", rng)
    B, D, E = 2, 8, src.size
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32))
    row = torch.from_numpy(rng.normal(size=(E,)).astype(np.float32))

    def grads(use_out, use_w, fn):
        tx, tr = x.clone().requires_grad_(), row.clone().requires_grad_()
        out, w = fn(tx, tr[None].expand(B, -1), s, d)
        loss = (out.square().sum() if use_out else 0.0) + (w.sin().sum() if use_w else 0.0)
        loss.backward()
        return tx.grad, tr.grad

    def kernel_form(tx, g, s, d):
        return sp.spmm_segment_softmax(tx, g, s, d, n_nodes=N)

    def autograd_form(tx, g, s, d):
        return sp._spmm_fwd_plain(tx, g, s, d, N, False)

    for use_out, use_w in ((True, False), (False, True), (True, True)):
        got, want = grads(use_out, use_w, kernel_form), grads(use_out, use_w, autograd_form)
        if use_out:
            _close(got[0], want[0], 1e-5)
        else:
            assert got[0] is None or (got[0] == 0).all()
        _close(got[1], want[1], 1e-5)
    # gamma without a gradient: the weights are constants, dx alone comes back
    tx = x.clone().requires_grad_()
    out, _ = sp.spmm_segment_softmax(tx, row[None].expand(B, -1), s, d, n_nodes=N)
    out.sum().backward()
    assert tx.grad is not None and not row.requires_grad


@pytest.mark.parametrize("kind,D", [("random", 12), ("knn", 24), ("complete", 120)])
def test_sddmm_value_and_gradient_match_jax(kind, D):
    rng = np.random.default_rng(D)
    src, dst, N = _graph(kind, rng)
    B, E = 3, src.size
    q = rng.normal(size=(B, N, D)).astype(np.float32)
    k = rng.normal(size=(B, N, D)).astype(np.float32)
    cot = rng.normal(size=(B, E)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    jalpha, vjp = jax.vjp(
        lambda a, b: jsp.sddmm(a, b, jnp.asarray(src), jnp.asarray(dst), scale),
        jnp.asarray(q), jnp.asarray(k))
    jdq, jdk = vjp(jnp.asarray(cot))
    tq, tk = torch.from_numpy(q).requires_grad_(), torch.from_numpy(k).requires_grad_()
    alpha = sp.sddmm(tq, tk, torch.from_numpy(src), torch.from_numpy(dst), scale)
    assert alpha.shape == (B, E)
    _close(alpha.detach(), jalpha, 1e-5)
    alpha.backward(torch.from_numpy(cot))
    _close(tq.grad, jdq, 1e-4)
    _close(tk.grad, jdk, 1e-4)


@pytest.mark.parametrize("kind", ["random", "knn", "complete"])
def test_topology_groups_the_edges_in_stable_order(kind):
    src, dst, N = _graph(kind, np.random.default_rng(3))
    topo = sp.build_topology(torch.from_numpy(src), torch.from_numpy(dst), N)
    for ids, perm, ptr in ((dst, topo.dst_perm, topo.dst_ptr),
                           (src, topo.src_perm, topo.src_ptr)):
        perm, ptr = perm.numpy(), ptr.numpy()
        assert perm.dtype == np.int32 and ptr.dtype == np.int32
        assert sorted(perm.tolist()) == list(range(ids.size))
        assert ptr[0] == 0 and ptr[-1] == ids.size and len(ptr) == N + 1
        for n in range(N):
            seg = perm[ptr[n]:ptr[n + 1]]
            assert (ids[seg] == n).all() and (np.diff(seg) > 0).all()


def test_topology_is_cached_on_the_index_tensors_and_checks_them():
    src, dst, N = _graph("random", np.random.default_rng(4))
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    first = sp.topology(s, d, N)
    assert sp.topology(s, d, N) is first
    both = torch.stack([s, d])
    view = sp.topology(both[0], both[1], N)
    assert sp.topology(both[0], both[1], N) is view      # new views, same storage
    s[0] = (s[0] + 1) % N                                # a write: a new version
    assert sp.topology(s, d, N) is not first
    with pytest.raises(ValueError, match="outside"):
        sp.build_topology(s, d, 3)
    with pytest.raises(ValueError, match="integer"):
        sp.build_topology(s.float(), d, N)
    with pytest.raises(ValueError):
        sp.spmm_segment_softmax(torch.zeros(2, N + 1, 4), torch.zeros(2, s.numel()),
                                s, d, n_nodes=N)
    with pytest.raises(ValueError):
        sp.spmm_segment_softmax(torch.zeros(2, N, 4), torch.zeros(2, 3), s, d,
                                n_nodes=N)
