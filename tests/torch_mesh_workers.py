"""What the ranks of the mesh tests run (each in a process of its own,
started by raindrop_tpu_torch.parallel.launch.run_ranks over gloo). This
module imports no JAX: the tests compute the JAX side in their own
process and hand the ranks numpy arrays."""

import numpy as np
import torch

from raindrop_tpu_torch.bridge import params_from_jax
from raindrop_tpu_torch.config import TrainConfig, dataset_config
from raindrop_tpu_torch.parallel.mesh import batch_rows, coords, make_mesh
from raindrop_tpu_torch.train.checkpoint import flatten_params
from raindrop_tpu_torch.train.trainer import Trainer


def _numpy_tree(tree):
    return {path: t.detach().numpy().copy() for path, t in flatten_params(tree)}


def one_step(rank, shapes):
    """For each (n_data, n_model) of `shapes` and each of its runs
    (preset, cfg overrides, tcfg overrides, the JAX parameter tree, the
    global batch, the seeds): one train_step of this rank's rows on that
    mesh of the group's ranks. Returns {shape: ([per run (loss, this
    rank's logits, the full parameters after the step, the rank's
    coords, Adam's first moment of the full parameters)], the gathered
    predict of the last run on its batch, the error of a mesh the world
    does not hold)}."""
    results = {}
    for (n_data, n_model), runs in shapes:
        mesh = make_mesh(n_data, n_model)
        c = coords(mesh)
        out = []
        for preset, cfg_kw, tcfg_kw, jtree, batch, seeds in runs:
            cfg = dataset_config(preset, **cfg_kw)
            tr = Trainer(cfg, TrainConfig(dataset=preset, **tcfg_kw), device="cpu",
                         params=params_from_jax(jtree, cfg, device="cpu"), mesh=mesh)
            rows = batch_rows(len(batch["y"]), c.data_rank, c.n_data)
            local = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                     for k, v in batch.items()}
            loss, logits = tr.train_step(local, seeds)
            mu = {path: np.asarray(v) for path, v in
                  flatten_params(tr.full_opt_state()["mu"])}
            out.append((float(loss), logits.detach().numpy(),
                        _numpy_tree(tr.full_params()), c, mu))
        pred = tr.predict(None, batch["P"], batch["time"], batch.get("static"),
                          batch_size=5)
        try:
            make_mesh(n_data + 1, n_model)
            size_error = None
        except ValueError as e:
            size_error = str(e)
        results[(n_data, n_model)] = (out, pred, size_error)
    return results


def expert(rank, moe_args, transformer_args):
    """`moe` and `transformer_moe` on one group of two ranks."""
    return moe(rank, *moe_args), transformer_moe(rank, *transformer_args)


def moe(rank, full, x, g_out):
    """moe_ffn_apply over a 1 x 2 mesh with the rank's experts
    (shard_moe_params) and with the full tree: (out, aux, the gradients of
    x, of the expert leaves it was given and of the gate's weight) each."""
    from raindrop_tpu_torch.parallel.expert import moe_ffn_apply, shard_moe_params

    mesh = make_mesh(1, 2)
    res = []
    for local in (True, False):
        p = {"gate": {k: torch.from_numpy(v).requires_grad_()
                      for k, v in full["gate"].items()}}
        for k in ("w1", "b1", "w2", "b2"):
            p[k] = torch.from_numpy(full[k])
        if local:
            p = shard_moe_params(p, mesh)
        for k in ("w1", "b1", "w2", "b2"):
            p[k] = p[k].clone().requires_grad_()
        xt = torch.from_numpy(x).requires_grad_()
        out, aux = moe_ffn_apply(p, xt, mesh=mesh)
        (out * torch.from_numpy(g_out)).sum().add(aux).backward()
        grads = {k: p[k].grad.numpy().copy() for k in ("w1", "b1", "w2", "b2")}
        grads["gate_w"] = p["gate"]["w"].grad.numpy().copy()
        res.append((out.detach().numpy(), float(aux.detach()), xt.grad.numpy().copy(), grads))
    return res


def transformer_moe(rank, cfg_kw, params_np, src, static, times, lengths):
    """transformer_moe_apply (eval) over a 1 x 2 mesh: (logits, aux)."""
    from raindrop_tpu_torch.baselines.transformer_moe import transformer_moe_apply

    mesh = make_mesh(1, 2)
    cfg = dataset_config("P19", **cfg_kw)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return torch.from_numpy(t)

    with torch.no_grad():
        logits, aux = transformer_moe_apply(
            tree(params_np), cfg, *(torch.from_numpy(a) for a in (src, static, times, lengths)),
            mesh=mesh)
    return logits.numpy(), float(aux)


def elastic(rank, n_data, split, runs):
    """train_split on a n_data x 1 mesh through run_elastic, for each
    (checkpoint path, epoch of the fault or None) of `runs`; per run (test
    metrics, the history's epochs, restarts, the full parameters)."""
    from raindrop_tpu_torch.parallel.elastic import FaultInjector, run_elastic

    mesh = make_mesh(n_data, 1)
    cfg = dataset_config("PAM", max_len=12, nlayers=1, nhead=1)
    tcfg = TrainConfig(dataset="PAM", num_epochs=3, learning_rate=1e-3,
                       batch_size=24, batching_strategy=3, n_batches_strategy3=3,
                       seed=3)
    out = []
    for ckpt, fail_at in runs:
        tr = Trainer(cfg, tcfg, device="cpu", mesh=mesh)
        result, restarts = run_elastic(
            tr, split, checkpoint_path=ckpt, max_restarts=2,
            fault_injector=None if fail_at is None else FaultInjector([fail_at]))
        out.append((result.test_metrics, [r["epoch"] for r in result.history],
                    restarts, _numpy_tree(tr.full_params())))
    return out


def cli(rank, argv):
    """raindrop_tpu_torch.run.main(argv) on every rank of the group."""
    from raindrop_tpu_torch import run

    return run.main(argv)
