"""The scale-out routes through the port's Trainer on gloo ranks
(raindrop_tpu_torch.parallel.launch.run_ranks) against the JAX package's
Trainer step on a mesh of the same shape over the 8 virtual devices:
tests/test_scale_out_routes.py's setup (P19, max_len 8, B=8), the same
parameters, batch and seeds (read off JAX's key: every route's masks hash
at global coordinates, the pipeline's at each microbatch and stage).

  1 x 2 (two ranks): sequence-parallel and ring attention at dropout 0;
  2 x 2 (four ranks): ring attention at dropout 0.3 (JAX's train logits
      too), the GPipe route at dropout 0.2 (its microbatches are cut from
      the global batch, as JAX's are, though each data rank holds half of
      it) and edge partitioning at the preset's dropout 0.2.

Held as tests/test_torch_data_parallel.py holds the mesh steps: the loss,
the logits and every parameter after the step at JAX's mesh tolerances,
and the step's gradient through Adam's first moment, every element within
1e-4 of its leaf's largest; every rank holds the same loss, parameters and
moments bit for bit (the parameters are whole on every rank under a
route). Then, on the two ranks, a short train_split under sequence
parallelism and the CLI's three route flags.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax

from raindrop_tpu.data import synthetic_split as jax_synthetic_split
from raindrop_tpu.parallel import make_mesh as jax_make_mesh

from raindrop_tpu_torch.parallel.launch import run_ranks

from tests import torch_mesh_workers as mesh_workers
from tests import torch_route_workers as workers
from tests.test_torch_data_parallel import _assert_close, _gathered, _jax_step, _setup
from tests.torch_port_util import seeds_from_jax_key

PRESET = "P19"
TCFG = dict(batch_size=8, num_epochs=1, batching_strategy=2)
KEY = 1
# (name, mesh shape, cfg overrides, route)
RUNS = {
    (1, 2): [("sp", dict(max_len=8, dropout=0.0), dict(context_parallel="sp")),
             ("ring", dict(max_len=8, dropout=0.0), dict(context_parallel="ring"))],
    (2, 2): [("ring 0.3", dict(max_len=8, dropout=0.3), dict(context_parallel="ring")),
             ("pipeline 0.2", dict(max_len=8), dict(pipeline_microbatches=2)),
             ("edge partition", dict(max_len=8), dict(edge_partition=True))],
}
CASES = [(shape, i) for shape, runs in RUNS.items() for i in range(len(runs))]


@functools.lru_cache(maxsize=1)
def _params_and_batch():
    return _setup(PRESET, dict(max_len=8), TCFG, 32, 8)


def _inputs(route):
    """The JAX parameters and batch (the dropout rate does not change
    them) and the seeds of the key."""
    cfg, jparams, batch = _params_and_batch()
    seeds = seeds_from_jax_key(jax.random.PRNGKey(KEY), cfg.nlayers, rows=8,
                               pipeline=route.get("pipeline_microbatches", 0))
    return jparams, batch, seeds


def _argv(tmp, *flags):
    return ["--dataset", PRESET, "--synthetic", "40", "--max-len", "8", "--epochs", "1",
            "--batch-size", "8", "--n-splits", "1", "--device", "cpu",
            "--data-parallel", "1", "--model-parallel", "2",
            "--checkpoint-dir", str(tmp), *flags]


CLI_FLAGS = (("--context-parallel", "ring"), ("--pipeline-microbatches", "2"),
             ("--edge-partition", "true"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The ranks' results ({shape: one_step's}), the two-rank group's
    protocol run (train_split under SP, the CLI's three flags) and JAX's
    steps ({(shape, i): _jax_step's}). The two rank groups run while this
    process computes JAX's steps."""
    tmp = tmp_path_factory.mktemp("routes")
    args, jax_args = {}, {}
    for shape, runs in RUNS.items():
        arg = []
        for i, (_, cfg_kw, route) in enumerate(runs):
            jparams, batch, seeds = _inputs(route)
            arg.append((PRESET, cfg_kw, {**TCFG, **route}, jparams, batch, seeds))
            jax_args[(shape, i)] = (cfg_kw, {**TCFG, **route}, jparams, batch)
        args[shape] = [(shape, arg)]
    split = jax_synthetic_split(PRESET, n=64, seed=3, T=8)
    argvs = [_argv(tmp / f"cli{i}", *flags) for i, flags in enumerate(CLI_FLAGS)]
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(run_ranks, workers.steps_and_protocol, 2, args[(1, 2)], split,
                          str(tmp), argvs, timeout_s=300)
        four = pool.submit(run_ranks, mesh_workers.one_step, 4, args[(2, 2)],
                           timeout_s=300)
        want = {}
        for (shape, i), (cfg_kw, tcfg_kw, jparams, batch) in jax_args.items():
            mesh = jax_make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
            want[(shape, i)] = _jax_step(mesh, PRESET, cfg_kw, tcfg_kw, jparams, batch,
                                         jax.random.PRNGKey(KEY))
        two, four = two.result(), four.result()
    out = {(1, 2): [r[0][(1, 2)] for r in two], (2, 2): [r[(2, 2)] for r in four]}
    return out, [r[1] for r in two], want


@pytest.mark.parametrize("shape,i", CASES,
                         ids=[f"{s[0]}x{s[1]}-{RUNS[s][i][0]}" for s, i in CASES])
def test_route_step_matches_jax_on_the_same_mesh(port, shape, i):
    ranks = port[0][shape]
    got = _gathered([r[0][i] for r in ranks])
    _assert_close(got, port[2][(shape, i)], f"{RUNS[shape][i][0]} on {shape}")
    preds = [r[1] for r in ranks]
    for p in preds[1:]:
        np.testing.assert_array_equal(p, preds[0])
    assert np.isfinite(preds[0]).all() and preds[0].shape == (8, 2)


def test_train_split_under_sequence_parallelism(port):
    """Two epochs of the protocol through the SP route on two ranks (a
    checkpointed best epoch read back from the shard files for the test):
    finite losses and parameters, metrics in [0, 1], both ranks the same."""
    protocol = port[1]
    (test, losses, total, _), other = protocol[0], protocol[1]
    assert np.isfinite(losses).all() and len(losses) == 2 and np.isfinite(total)
    assert all(0.0 <= v <= 1.0 for v in test.values()), test
    assert other[0] == test and other[1] == losses and other[2] == total


@pytest.mark.parametrize("flag", range(len(CLI_FLAGS)),
                         ids=[f[0].lstrip("-") for f in CLI_FLAGS])
def test_cli_route_flags_on_two_ranks(port, flag):
    protocol = port[1]
    assert [r[3][flag] for r in protocol] == [0, 0]
