"""The port's GPipe (parallel/pipeline.py) on gloo ranks
(raindrop_tpu_torch.parallel.launch.run_ranks, one group of four whose
pairs also serve as two-stage pipelines), as tests/test_pipeline.py holds
the JAX one: pipeline_apply against the stages run in sequence for JAX's
(S, M) cases, and its gradients; pipeline_transformer_encoder against
JAX's on a two-device 'pipe' mesh, in eval and in training at dropout 0.2
with each (microbatch, stage)'s seeds read off JAX's key (the output and
the gradients of the input and of each stage's layer, against jax.vjp);
the stage-count refusal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from raindrop_tpu.nn.transformer import transformer_encoder_init
from raindrop_tpu.parallel.pipeline import pipeline_transformer_encoder as jax_pipe

from raindrop_tpu_torch.parallel.launch import run_ranks
from raindrop_tpu_torch.parallel.mesh import Shard
from raindrop_tpu_torch.parallel.pipeline import pipeline_transformer_encoder

from tests import torch_route_workers as workers
from tests.torch_port_util import pipeline_seeds

APPLY = [(1, 3), (2, 1), (2, 4), (4, 8)]
D_AFF, MB = 6, 5
B, T, D, NHEAD, L = 8, 10, 12, 2, 2
ENCODER = [(1, 0.0), (4, 0.0), (2, 0.2)]       # (microbatches, dropout)


def _affine_stages(S, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(D_AFF, D_AFF)).astype(np.float32) / D_AFF,
             rng.normal(size=(D_AFF,)).astype(np.float32)) for _ in range(S)]


def _sequential(stages, xs):
    h = torch.from_numpy(xs)
    for w, b in stages:
        h = torch.tanh(h @ torch.from_numpy(w) + torch.from_numpy(b))
    return h


def _apply_cases():
    cases = []
    for S, M in APPLY:
        xs = np.random.default_rng(1).normal(size=(M, MB, D_AFF)).astype(np.float32)
        cases.append((S, _affine_stages(S), xs, False))
    xs = np.random.default_rng(3).normal(size=(3, 4, D_AFF)).astype(np.float32)
    cases.append((2, _affine_stages(2, seed=2), xs, True))
    return cases


def _encoder_inputs():
    params = jax.device_get(transformer_encoder_init(jax.random.PRNGKey(0), D, NHEAD,
                                                     2 * D, L))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = rng.integers(3, T + 1, size=(B,))
    lengths[1] = 0
    mask = np.arange(T)[None, :] >= lengths[:, None]
    g = rng.normal(size=(B, T, D)).astype(np.float32)
    return params, x, mask, g


@pytest.fixture(scope="module")
def port():
    params, x, mask, g = _encoder_inputs()
    key = jax.random.PRNGKey(7)
    enc = [(params, x, mask, NHEAD, M, rate,
            pipeline_seeds(key, L, M) if rate else None, g) for M, rate in ENCODER]
    return run_ranks(workers.pipeline, 4, _apply_cases(), enc, timeout_s=240)


@pytest.mark.parametrize("case", range(len(APPLY)), ids=[f"S{s}-M{m}" for s, m in APPLY])
def test_pipeline_apply_matches_sequential(port, case):
    S, stages, xs, _ = _apply_cases()[case]
    want = _sequential(stages, xs).numpy()
    for r, (res_apply, _) in enumerate(port):
        out, _, _ = res_apply[case]
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")


def test_pipeline_apply_differentiable(port):
    """The gradients of sum(out ** 2) for the inputs and each stage's
    parameters equal the sequential program's."""
    S, stages, xs, _ = _apply_cases()[-1]
    ps = [tuple(torch.from_numpy(a).requires_grad_() for a in st) for st in stages]
    x = torch.from_numpy(xs).requires_grad_()
    h = x
    for w, b in ps:
        h = torch.tanh(h @ w + b)
    (h ** 2).sum().backward()
    for r, (res_apply, _) in enumerate(port):
        _, stage, (gx, gw, gb) = res_apply[-1]
        np.testing.assert_allclose(gx, x.grad.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gw, ps[stage][0].grad.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gb, ps[stage][1].grad.numpy(), rtol=1e-4, atol=1e-5)


def _jax_encoder(M, rate):
    params, x, mask, g = _encoder_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:L]), axis_names=("pipe",))
    key = jax.random.PRNGKey(7)

    @jax.jit
    def run(params, x, g):
        def f(params, x):
            return jax_pipe(mesh, params, x, jnp.asarray(mask), NHEAD, M,
                            dropout_rate=rate, rng=key if rate else None,
                            train=rate > 0.0)
        out, vjp = jax.vjp(f, params, x)
        return out, vjp(g)

    out, (gp, gx) = run(params, jnp.asarray(x), jnp.asarray(g))
    return np.asarray(out), np.asarray(gx), jax.device_get(gp)


@pytest.mark.parametrize("case", range(len(ENCODER)),
                         ids=[f"M{m}-rate{r}" for m, r in ENCODER])
def test_pipeline_transformer_encoder_matches_jax(port, case):
    """Output, the input's gradient and each stage's layer's gradients, on
    both pipelines of the group, within 2e-5 of JAX's."""
    out, gx, gp = _jax_encoder(*ENCODER[case])
    for r, (_, res_enc) in enumerate(port):
        got, got_gx, stage, lg = res_enc[case]
        np.testing.assert_allclose(got, out, rtol=2e-5, atol=2e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got_gx, gx, rtol=2e-5, atol=2e-5, err_msg=f"rank {r}")
        want = gp[f"layer{stage}"]
        for k, v in lg.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_allclose(vv, want[k][kk], rtol=2e-5, atol=2e-5,
                                               err_msg=f"rank {r} {k}/{kk}")
            else:
                np.testing.assert_allclose(v, want[k], rtol=2e-5, atol=2e-5,
                                           err_msg=f"rank {r} {k}")


def test_pipeline_stage_count_mismatch_raises():
    params, x, _, _ = _encoder_inputs()
    tree = {n: {k: (torch.tensor(v) if not isinstance(v, dict) else
                    {kk: torch.tensor(vv) for kk, vv in v.items()})
                for k, v in layer.items()} for n, layer in params.items()}
    with pytest.raises(ValueError, match="stage per layer"):
        pipeline_transformer_encoder(tree, torch.tensor(x), None, NHEAD, 2,
                                     Shard(0, B, 0, 4))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_transformer_encoder(tree, torch.tensor(x), None, NHEAD, 3,
                                     Shard(0, B, 0, 2))
