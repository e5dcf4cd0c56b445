"""The port's mesh helpers against the JAX package's: the tensor-parallel
split of every parameter leaf, the per-rank blocks and the sampler's
shards, all exact."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.data import sampler as jsampler
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.parallel import mesh as jmesh
from raindrop_tpu.parallel import multihost as jmultihost

from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.data import sampler
from raindrop_tpu_torch.models.raindrop import raindrop_init
from raindrop_tpu_torch.parallel import mesh, multihost
from raindrop_tpu_torch.train.checkpoint import flatten_params


def _jax_dim(spec):
    """The split dim of a JAX PartitionSpec over 'model', or None."""
    dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return dims[0] if dims else None


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("preset,kw", [("P19", {}), ("P12", {}), ("PAM", {}),
                                       ("P12", {"sensor_wise_mask": True})])
def test_tensor_parallel_specs_split_the_leaves_jax_splits(preset, kw, n_model):
    shapes = jax.eval_shape(lambda k: jax_raindrop_init(k, jax_dataset_config(preset, **kw)),
                            jax.random.PRNGKey(0))
    want = {path: _jax_dim(s) for path, s in flatten_params(
        jax.tree.map(lambda x: x, jmesh.tensor_parallel_specs(shapes, n_model),
                     is_leaf=lambda x: isinstance(x, P)))}
    port = raindrop_init(None, dataset_config(preset, **kw), device="meta")
    got = dict(flatten_params(mesh.tensor_parallel_specs(port, n_model)))
    assert got == want
    split = {p for p, d in got.items() if d is not None}
    assert "transformer_encoder/layer0/in_proj_w" in split
    assert "ob_propagation/lin_value/w" in split
    assert got["mlp_static/lin1/w"] is None and got["R_u"] is None


def test_tensor_parallel_specs_replicate_when_indivisible():
    tree = {"transformer_encoder": {"lin1": {"w": np.zeros((7, 5)), "b": np.zeros((7,))}}}
    assert dict(flatten_params(mesh.tensor_parallel_specs(tree, 2))) == {
        "transformer_encoder/lin1/b": None, "transformer_encoder/lin1/w": None}
    want = jmesh.tensor_parallel_specs(tree, n_model=2)
    assert want["transformer_encoder"]["lin1"]["w"] == P()


def test_a_rank_holds_its_heads_rows_of_q_k_v():
    """in_proj_w [3d, d]: rank m holds rows m*d/n .. of each of q, k and v,
    three blocks; the parts of all ranks cover the leaf once."""
    d, n = 8, 2
    w = torch.arange(3 * d * 3, dtype=torch.float32).reshape(3 * d, 3)
    path = ["transformer_encoder", "layer0", "in_proj_w"]
    parts = [mesh.local_leaf(path, w, n, m) for m in range(n)]
    assert parts[0].shape == (3 * d // n, 3)
    assert torch.equal(parts[1][:4], w[4:8]) and torch.equal(parts[1][4:8], w[12:16])
    cover = torch.zeros(3 * d, dtype=torch.int64)
    for m in range(n):
        for origin, sl in mesh.shard_blocks(path, tuple(w.shape), 0, n, m):
            assert origin == (sl[0].start, 0)
            cover[sl[0]] += 1
    assert torch.equal(cover, torch.ones_like(cover))
    lin = mesh.local_leaf(["transformer_encoder", "layer0", "lin2", "w"],
                          torch.ones(6, 8), n, 1)
    assert lin.shape == (6, 4)


def test_make_mesh_refuses_a_mesh_without_its_ranks():
    # no process group here: a mesh of several ranks needs one
    with pytest.raises(ValueError, match="process group"):
        mesh.make_mesh(2, 1)


def test_batch_rows_and_local_indices_equal_jax():
    idx = np.arange(1000, 1128)
    for n in (1, 2, 4, 8):
        parts = [multihost.local_batch_indices(idx, p, n) for p in range(n)]
        for p in range(n):
            np.testing.assert_array_equal(parts[p], jmultihost.local_batch_indices(idx, p, n))
            np.testing.assert_array_equal(parts[p], idx[mesh.batch_rows(128, p, n)])
        np.testing.assert_array_equal(np.concatenate(parts), idx)
    with pytest.raises(ValueError):
        multihost.local_batch_indices(np.arange(10), 0, 3)
    with pytest.raises(ValueError):
        mesh.batch_rows(10, 0, 3)


@pytest.mark.parametrize("strategy", [1, 2, 3])
@pytest.mark.parametrize("num_shards", [2, 4])
def test_sampler_shards_equal_jax_and_cover_the_global_batch(strategy, num_shards):
    y = (np.arange(200) % 4 == 0).astype(np.int64)
    full = list(sampler.balanced_batches(y, 32, strategy, np.random.default_rng(5),
                                         n_batches=4))
    shards = []
    for s in range(num_shards):
        mine = list(multihost.sharded_balanced_batches(
            y, 32, strategy, np.random.default_rng(5), n_batches=4,
            process_index=s, process_count=num_shards))
        want = list(jsampler.balanced_batches(
            y, 32, strategy, np.random.default_rng(5), n_batches=4,
            shard_id=s, num_shards=num_shards))
        assert len(mine) == len(want) == 4
        for a, b in zip(mine, want):
            np.testing.assert_array_equal(a, b)
        shards.append(mine)
    for bi, gidx in enumerate(full):
        parts = [shards[s][bi] for s in range(num_shards)]
        np.testing.assert_array_equal(np.concatenate(parts), gidx)
        if strategy != 2:      # strategy 2's positives repeat by design
            assert len(set(np.concatenate(parts))) == len(gidx)


def test_sampler_refuses_unequal_shards():
    y = (np.arange(40) % 2).astype(np.int64)
    with pytest.raises(ValueError, match="divisible"):
        next(sampler.balanced_batches(y, 10, 3, np.random.default_rng(0), n_batches=1,
                                      shard_id=0, num_shards=4))
    # strategy 2 holds 2 * (9 // 2) = 8 rows, which 3 shards do not divide
    with pytest.raises(ValueError, match="equal shards"):
        next(sampler.balanced_batches(y, 9, 2, np.random.default_rng(0), n_batches=1,
                                      shard_id=0, num_shards=3))
