"""Per-rank sharded checkpoints across the two packages: the JAX
package's save_sharded_checkpoint files (written from its 8-virtual-device
mesh) read by the port's loader, the port's files (written by each rank
of a 1 x 2 and a 2 x 2 mesh, the ranks' places given) read by JAX's, and
the loaders' refusals. Every comparison is exact."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from raindrop_tpu.config import dataset_config as jax_dataset_config
from raindrop_tpu.models.raindrop import raindrop_init as jax_raindrop_init
from raindrop_tpu.parallel import make_mesh as jax_make_mesh
from raindrop_tpu.parallel import multihost as jmultihost
from raindrop_tpu.parallel.mesh import shard_params as jax_shard_params

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import dataset_config
from raindrop_tpu_torch.parallel import mesh
from raindrop_tpu_torch.parallel.multihost import (
    load_sharded_checkpoint, save_sharded_checkpoint)
from raindrop_tpu_torch.train.checkpoint import flatten_params


@pytest.fixture(scope="module")
def p19():
    cfg = jax_dataset_config("P19", max_len=8)
    tree = jax.device_get(jax_raindrop_init(jax.random.PRNGKey(0), cfg))
    return tree, params_from_jax(tree, dataset_config("P19", max_len=8), device="cpu")


def test_the_port_reads_jax_shard_files(p19, tmp_path):
    tree, port = p19
    path = str(tmp_path / "jax")
    jmultihost.save_sharded_checkpoint(
        path, jax_shard_params(jax_make_mesh(n_data=4, n_model=2), tree))
    flat = load_sharded_checkpoint(path)
    want = dict(flatten_params(tree))
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)
    back = load_sharded_checkpoint(path, like=port)
    for (k, a), (_, b) in zip(flatten_params(back), flatten_params(port)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_jax_reads_the_ports_shard_files(p19, tmp_path, n_data, n_model):
    """Each rank writes its part (in_proj_w and in_proj_b as three blocks
    each, the other split leaves one); JAX's loader reassembles the tree."""
    tree, port = p19
    specs = mesh.tensor_parallel_specs(port, n_model)
    path = str(tmp_path / "port")
    names = []
    for d in range(n_data):
        for m in range(n_model):
            local = mesh.shard_params(port, n_model=n_model, model_rank=m)
            names.append(save_sharded_checkpoint(
                path, local, specs=specs, n_model=n_model, model_rank=m, data_rank=d,
                process_count=n_data * n_model))
    assert [os.path.basename(n) for n in names] == [
        f"port.shard{i}-of{n_data * n_model}.npz" for i in range(n_data * n_model)]
    with np.load(names[0]) as z:
        blocks = [k for k in z.files
                  if k.startswith("transformer_encoder/layer0/in_proj_w@")]
    assert len(blocks) == 3                   # rank 0's rows of q, k and v
    back = jmultihost.load_sharded_checkpoint(path, like=tree)
    for (k, a), (_, b) in zip(flatten_params(back), flatten_params(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)
    flat = load_sharded_checkpoint(path)
    for k, v in flatten_params(tree):
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)


def test_missing_coverage_and_mixed_generations_raise(tmp_path):
    x = jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
                       NamedSharding(jax_make_mesh(n_data=1, n_model=8), P(None, "model")))
    path = str(tmp_path / "c")
    jmultihost.save_sharded_checkpoint(path, {"w": x})
    f = path + ".shard0-of1.npz"
    with np.load(f) as z:
        kept = {k: z[k] for k in z.files if not k.endswith("@0,7")}
    np.savez(f, **kept)
    with pytest.raises(ValueError, match="cover"):
        load_sharded_checkpoint(path)
    # a port file of a two-rank run beside a one-process file
    w = {"transformer_encoder": {"lin1": {"w": torch.arange(16.0).reshape(4, 4)}}}
    specs = mesh.tensor_parallel_specs(w, 2)
    local = mesh.shard_params(w, n_model=2, model_rank=0)
    path2 = str(tmp_path / "d")
    save_sharded_checkpoint(path2, local, specs=specs, n_model=2, model_rank=0,
                            process_count=2)
    stale = path2 + ".shard0-of1.npz"
    shutil.copy(path2 + ".shard0-of2.npz", stale)
    with pytest.raises(ValueError, match="mixed shard generations"):
        load_sharded_checkpoint(path2)
    with pytest.raises(ValueError, match="mixed shard generations"):
        jmultihost.load_sharded_checkpoint(path2)
    # rank 1's file alone leaves its half uncovered
    os.remove(stale)
    with pytest.raises(ValueError, match="cover"):
        load_sharded_checkpoint(path2)
    # a fresh save of the other rank removes the stale generation first
    shutil.copy(path2 + ".shard0-of2.npz", stale)
    save_sharded_checkpoint(path2, mesh.shard_params(w, n_model=2, model_rank=1),
                            specs=specs, n_model=2, model_rank=1, process_count=2)
    assert not os.path.exists(stale)
    out = load_sharded_checkpoint(path2)
    np.testing.assert_array_equal(out["transformer_encoder/lin1/w"], np.arange(16.0).reshape(4, 4))
    with pytest.raises(FileNotFoundError):
        load_sharded_checkpoint(str(tmp_path / "none"))
    with pytest.raises(ValueError, match="specs"):
        save_sharded_checkpoint(path2, local, n_model=2, model_rank=0)
