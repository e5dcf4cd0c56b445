"""Graph containers: edge lists built on the host (the port's own copy of
raindrop_tpu/graph/structure.py, numpy only).

The reference materializes edges with torch.nonzero over a dense adjacency
(reference code/models_rd.py:307-311). Edge construction depends on the
data, so it lives on the host and produces COO arrays that the propagation
layers and the CUDA kernels consume. Complete graphs (the shipped
configuration: global_structure = ones, code/Raindrop.py:212) get a
row-major (source-major) edge list, so edge ordering matches torch.nonzero.
"""

from __future__ import annotations

import numpy as np


def complete_graph_edges(n_nodes: int):
    """All n^2 (src, tgt) pairs in torch.nonzero row-major order.

    Returns (edge_index [2, n^2] int32, edge_weights [n^2] float32).
    edge_index[0] = source, edge_index[1] = target (PyG source_to_target flow).
    """
    src, tgt = np.meshgrid(np.arange(n_nodes), np.arange(n_nodes), indexing="ij")
    edge_index = np.stack([src.reshape(-1), tgt.reshape(-1)]).astype(np.int32)
    return edge_index, np.ones((n_nodes * n_nodes,), np.float32)


def edges_from_adjacency(adj: np.ndarray, force_self_loops: bool = True):
    """COO edges of a weighted adjacency, reference code/models_rd.py:307-311.

    adj[i, j] != 0 creates edge (src=i, tgt=j) with weight adj[i, j]; the
    diagonal is forced to 1 first (self-loops), matching
    `adj[torch.eye(F).byte()] = 1`.
    """
    adj = np.array(adj, dtype=np.float32, copy=True)
    if force_self_loops:
        np.fill_diagonal(adj, 1.0)
    src, tgt = np.nonzero(adj)
    edge_index = np.stack([src, tgt]).astype(np.int32)
    return edge_index, adj[src, tgt]


def masked_softmax(A: np.ndarray, epsilon: float = 1e-9) -> np.ndarray:
    """Softmax over nonzero entries, reference code/utils_rd.py:260-265.

    Reproduces the reference's axis asymmetry verbatim: the stabilizing max
    is taken over dim=1 (rows) while the normalizing sum runs over dim=0
    (columns), and exact zeros are masked out of the numerator only.
    """
    A = np.asarray(A, np.float32)
    A_max = A.max(axis=1, keepdims=True)
    A_exp = np.exp(A - A_max) * (A != 0)
    return A_exp / (A_exp.sum(axis=0, keepdims=True) + epsilon)


def generate_global_structure(data: np.ndarray, K: int = 10,
                              n_sensors: int = 36,
                              compat: bool = True) -> np.ndarray:
    """Data-driven global adjacency from mean inter-sensor cosine similarity
    (reference code/Raindrop.py:35-48; unused by the reference script, which
    passes ones(F,F) at :212, but part of the public capability surface).

    data: [N, T, >=n_sensors] dense padded values. Per sample, the cosine
    similarity between sensor time series is computed; similarities are
    averaged over samples, sparsified with the reference's ``argsort < K``
    mask and passed through masked_softmax.

    compat=True keeps the reference's quirk: ``argsort(ave, dim=0) < K``
    marks positions i where the rank-i element of each column ORIGINALLY sat
    at row < K — a rank/position misalignment (the intended top-K mask would
    be ``argsort(argsort(ave)) < K``). compat=False applies the intended
    per-column K-smallest-rank mask.
    """
    obs = np.asarray(data, np.float32)[:, :, :n_sensors]
    # cosine similarity between sensor rows, per sample (batched, no loop)
    x = np.transpose(obs, (0, 2, 1))                     # [N, F, T]
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    norms = np.where(norms == 0, 1.0, norms)
    xn = x / norms
    ave_sim = np.einsum("nft,ngt->fg", xn, xn) / obs.shape[0]
    order = np.argsort(ave_sim, axis=0, kind="stable")
    if compat:
        mask = order < K
    else:
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.arange(n_sensors)[:, None]
                          .repeat(n_sensors, 1), axis=0)
        mask = rank < K
    return masked_softmax(mask * ave_sim)


def diffuse(unit: np.ndarray, N: int = 10) -> np.ndarray:
    """Temporal max-pool downsampling (reference code/Raindrop.py:51-55,
    unused by the reference script): chop the time axis into windows of N and
    keep the per-window max, dropping the final partial window AND one full
    window (keep = T//N - 1, a reference quirk preserved verbatim).
    """
    unit = np.asarray(unit)
    n_time = unit.shape[-1]
    keep = n_time // N - 1
    return unit[..., :keep * N].reshape(unit.shape[:-1] + (keep, N)).max(-1)
