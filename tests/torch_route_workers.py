"""What the ranks of the scale-out route tests run (each in a process of its
own, started by raindrop_tpu_torch.parallel.launch.run_ranks over gloo).
This module imports no JAX: the tests compute the JAX side in their own
process and hand the ranks numpy arrays."""

import numpy as np
import torch
import torch.distributed as dist

from raindrop_tpu_torch.parallel.mesh import Shard, coords, group, make_mesh


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _grad(t):
    return None if t.grad is None else t.grad.numpy().copy()


def _shard_of(mesh, shape, rows):
    """This rank's Shard on `mesh` for a (n_data, n_model) layout of its
    ranks: (2, 2) the mesh itself; (1, 2) each model group alone, on the
    whole batch."""
    c = coords(mesh)
    if shape[0] == c.n_data:
        return Shard.of(mesh, rows // c.n_data)
    return Shard(0, rows, c.model_rank, c.n_model, group(mesh, "model"))


def sequence(rank, cases):
    """On a 2 x 2 mesh of four ranks, for each (layout, "sp" | "ring",
    rate, seed, q, k, v [B, H, T, D], lengths [B], cotangent): this rank's
    output rows and the gradients of its rows of q, k, v, and its Shard's
    (b0, model_rank)."""
    from raindrop_tpu_torch.parallel.sequence import (
        ring_attention, sequence_parallel_attention, time_shard)

    mesh = make_mesh(2, 2)
    out = []
    for shape, name, rate, seed, q, k, v, lengths, g in cases:
        B, _, T, _ = q.shape
        shard = _shard_of(mesh, shape, B)
        b_loc = B // shape[0]
        t0, t_loc = time_shard(T, shard)
        rows = (slice(shard.b0, shard.b0 + b_loc), slice(None), slice(t0, t0 + t_loc))
        ql, kl, vl = (_t(a[rows], True) for a in (q, k, v))
        fn = sequence_parallel_attention if name == "sp" else ring_attention
        o = fn(ql, kl, vl, _t(lengths[rows[0]]), shard, dropout_rate=rate, seed=seed)
        (o * _t(g[rows])).sum().backward()
        out.append((o.detach().numpy(), _grad(ql), _grad(kl), _grad(vl),
                    (shard.b0, shard.model_rank)))
    return out


def _pipe_groups():
    """{stages: (the group of this rank's pipeline of that many stages over
    a world of four, consecutive ranks; its stage)}; new_group is
    collective."""
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    rank = dist.get_rank()
    return {1: (None, 0), 2: (pairs[rank // 2], rank % 2), 4: (dist.group.WORLD, rank)}


def pipeline(rank, apply_cases, encoder_cases):
    """Four ranks. `apply_cases`: (S, stages [(w, b)], xs [M, mb, d],
    differentiate): pipeline_apply of tanh(x @ w + b) stages on S of the
    ranks (this rank's stage); its outputs and, when asked, the gradients
    of sum(out ** 2) for xs and its stage's w, b. `encoder_cases`: (params
    tree of numpy leaves, x [B, T, d], key padding mask, nhead, M, rate,
    seeds or None, cotangent): pipeline_transformer_encoder over two
    stages, its output and the gradients of x and of this stage's layer."""
    from raindrop_tpu_torch.parallel.pipeline import (
        pipeline_apply, pipeline_transformer_encoder)

    groups = _pipe_groups()
    res_apply = []
    for S, stages, xs, diff in apply_cases:
        grp, stage = groups[S]
        w, b = (_t(a, diff) for a in stages[stage])
        x = _t(xs, diff)
        out = pipeline_apply(lambda p, h, m: torch.tanh(h @ p["w"] + p["b"]),
                             {"w": w, "b": b}, x, grp, stage, S)
        grads = None
        if diff:
            (out ** 2).sum().backward()
            grads = (_grad(x), _grad(w), _grad(b))
        res_apply.append((out.detach().numpy(), stage, grads))
    res_enc = []
    grp, stage = groups[2]
    for tree, x, mask, nhead, M, rate, seeds, g in encoder_cases:
        params = {name: {k: ({kk: _t(vv, True) for kk, vv in v.items()}
                             if isinstance(v, dict) else _t(v, True))
                         for k, v in layer.items()}
                  for name, layer in tree.items()}
        xt = _t(x, True)
        shard = Shard(0, x.shape[0], stage, 2, grp)
        out = pipeline_transformer_encoder(params, xt, _t(mask), nhead, M, shard,
                                           dropout_rate=rate, train=rate > 0.0,
                                           seeds=seeds)
        (out * _t(g)).sum().backward()
        mine = params[f"layer{stage}"]
        lg = {k: ({kk: _grad(vv) for kk, vv in v.items()} if isinstance(v, dict)
                  else _grad(v)) for k, v in mine.items()}
        res_enc.append((out.detach().numpy(), _grad(xt), stage, lg))
    return res_apply, res_enc


def edge(rank, cases):
    """On a 1 x 2 mesh, for each (x [B, N, D], gamma [B, E], src, dst,
    gather_target, cotangent): spmm_segment_softmax_sharded on this rank's
    edges: (out, its edges' weights, the gradients of x and of its edges'
    gamma)."""
    from raindrop_tpu_torch.parallel.edge_partition import (
        edge_shard, spmm_segment_softmax_sharded)

    mesh = make_mesh(1, 2)
    shard = Shard(0, 0, coords(mesh).model_rank, 2, group(mesh, "model"))
    out = []
    for x, gamma, src, dst, gather_target, g in cases:
        xt = _t(x, True)
        s, d, gm = edge_shard(_t(src), _t(dst), _t(gamma), shard)
        gm = gm.detach().requires_grad_()
        o, w = spmm_segment_softmax_sharded(xt, gm, s, d, shard,
                                            gather_target=gather_target)
        (o * _t(g)).sum().backward()
        out.append((o.detach().numpy(), w.detach().numpy(), _grad(xt), _grad(gm)))
    return out


def steps_and_protocol(rank, shapes, split, tmp, argvs):
    """tests/torch_mesh_workers.one_step(rank, shapes), then `protocol`, on
    one group."""
    from tests.torch_mesh_workers import one_step

    return one_step(rank, shapes), protocol(rank, split, tmp, argvs)


def protocol(rank, split, tmp, argvs):
    """On a 1 x 2 mesh: train_split under sequence parallelism (P19,
    max_len 8, 2 epochs) -> (test metrics, the history's losses, the full
    parameters' sum); then raindrop_tpu_torch.run.main for each argv."""
    from raindrop_tpu_torch import run
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(1, 2)
    cfg = dataset_config("P19", max_len=8)
    tcfg = TrainConfig(dataset="P19", batch_size=8, num_epochs=2, batching_strategy=2,
                       context_parallel="sp")
    tr = Trainer(cfg, tcfg, device="cpu", mesh=mesh)
    result = tr.train_split(split, checkpoint_path=f"{tmp}/sp", verbose=False)
    total = float(sum(float(t.detach().double().sum())
                      for t in _leaves(tr.full_params())))
    clis = [run.main(argv) for argv in argvs]
    return result.test_metrics, [r["train_loss"] for r in result.history], total, clis


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
