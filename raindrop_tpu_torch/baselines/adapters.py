"""Trainer adapters: every baseline family behind the Trainer's pluggable
model (port of raindrop_tpu/baselines/adapters.py).

Each adapter maps the batch contract of the flagship,

    apply(params, src [T, B, 2F], static, times [T, B], lengths, train, seeds)
        -> (logits, aux),

onto the family's own inputs, so one Trainer, sampler, protocol and
InferenceServer run them all. `seeds` is what the family's `draw_seeds`
returned (utils/dropout.ModelSeeds: the seeds its JAX `apply` derives from
its key, in the same split order), or None (no dropout).

Losses: cross-entropy on n_classes logits for every family. 'grud_bce'
reproduces the reference's P12/P19 GRU-D objective (a scalar sigmoid with
BCELoss, GRU-D_baseline.py:289) through the logit pair [0, z]: the
softmax cross-entropy of that pair is BCE-with-logits on z. IP-Net returns
its reconstruction loss as `aux`, weighted into the loss by
TrainConfig.aux_loss_weight; MoE its load-balancing loss; Raindrop v1 its
alpha distance.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from raindrop_tpu_torch.config import RaindropConfig
from raindrop_tpu_torch.utils.dropout import DropoutSeeds, ModelSeeds

BASELINES = ("transformer", "transformer_ctx", "transformer_moe", "seft",
             "raindrop_v1", "grud", "mtand", "mtgnn", "dgm2", "ipnet")

# the families whose encoder runs the attention kernels on the card
KERNEL_FAMILIES = ("transformer", "transformer_ctx", "transformer_moe", "raindrop_v1")


class ModelFns(NamedTuple):
    """init_fn(seed) -> parameters on the device the model was made for;
    apply_fn as above; draw_seeds(generator, rows) -> the seeds of one
    training forward, or None for a model that drops nothing;
    update_mask: a tree of bools over the parameters, False for a leaf the
    optimizer leaves alone, or None: every leaf live."""
    init_fn: Callable
    apply_fn: Callable
    draw_seeds: Optional[Callable]
    update_mask: Any = None


def make_flagship(cfg: RaindropConfig, device="cuda", mesh=None, *,
                  context_parallel: str = "none", pipeline_parallel: int = 0,
                  edge_partition: bool = False) -> ModelFns:
    """Raindrop (models/raindrop.py) in the adapters' form: the Trainer's
    and the InferenceServer's model when they are given no apply_fn. Its
    update mask is raindrop_param_mask's (the leaves the forward never
    reads stay dead); only the COO propagation branch with prop_dropout
    reads per-sample seeds, only the dense use_beta block the two of its
    own, and only the pipeline route its per-microbatch ones. The sensor
    graph is sorted for the kernels here, not in the first forward
    (warm_propagation). `mesh`: the forward runs this rank's rows and part
    of the model (raindrop_apply's mesh); the routes are raindrop_apply's."""
    from raindrop_tpu_torch.models.raindrop import (
        check_routes, prop_branch, raindrop_apply, raindrop_init, raindrop_param_mask,
        warm_propagation)

    check_routes(context_parallel, pipeline_parallel, edge_partition, mesh)
    warm_propagation(cfg, device)
    drops = cfg.prop_dropout > 0.0
    branch = prop_branch(cfg, True, False)
    per_sample = drops and branch == "coo"
    beta = drops and branch == "dense" and cfg.use_beta
    routes = dict(context_parallel=context_parallel, pipeline_parallel=pipeline_parallel,
                  edge_partition=edge_partition)

    def draw_seeds(gen, rows):
        return DropoutSeeds.draw(gen, cfg.nlayers, rows if per_sample else 0, beta,
                                 pipeline_parallel)

    return ModelFns(
        lambda seed: raindrop_init(seed, cfg, device=device),
        lambda p, src, st, tm, ln, train, seeds: raindrop_apply(
            p, cfg, src, st, tm, ln, train=train, seeds=seeds, mesh=mesh, **routes),
        draw_seeds if cfg.dropout > 0.0 or drops else None,
        raindrop_param_mask(cfg))


def make_baseline(name: str, cfg: RaindropConfig, hp: dict = None,
                  device="cuda") -> ModelFns:
    """(init_fn, apply_fn, draw_seeds) for
    Trainer(cfg, tcfg, init_fn=..., apply_fn=..., draw_seeds=...).

    hp: the family's hyperparameters under the reference drivers' flag
    names (underscored), defaults their published values: mTAND
    `mTAND_baseline.py:21-52` (rec-hidden 32, embed-time 128, 1 head, 128
    reference points), MTGNN `MTGNN_baseline.py:281-289`, DGM2
    `DGM2_baseline.py:74-84,305-308` (20 clusters, latent 10, ODE units
    10), IP-Net `IP_Net_baseline.py` (192 reference points, hid 100, 48 h).
    An unknown key raises ValueError, as in the JAX package. device="meta"
    gives init_fn(None) the tree's shapes alone.
    """
    hp = dict(hp or {})
    F = cfg.d_inp

    def done():
        if hp:
            raise ValueError(f"unknown hyperparameters for baseline {name!r}: "
                             f"{sorted(hp)}")

    def encoder_seeds(gen, rows):       # `embed` and a LayerSeeds a layer
        return ModelSeeds.draw(gen, cfg.nlayers)

    if name == "transformer":
        done()
        from raindrop_tpu_torch.baselines.transformer import (
            transformer2_apply, transformer2_init)
        return ModelFns(
            lambda seed: transformer2_init(seed, cfg, device),
            lambda p, src, st, tm, ln, train, seeds: transformer2_apply(
                p, cfg, src, st, tm, ln, train=train, seeds=seeds),
            encoder_seeds)

    if name == "transformer_ctx":
        done()
        from raindrop_tpu_torch.baselines.transformer_ctx import (
            transformer_ctx_apply, transformer_ctx_init)
        return ModelFns(
            lambda seed: transformer_ctx_init(seed, cfg, device=device),
            lambda p, src, st, tm, ln, train, seeds: transformer_ctx_apply(
                p, cfg, src, st, tm, ln, train=train, seeds=seeds),
            encoder_seeds)

    if name == "transformer_moe":
        done()
        from raindrop_tpu_torch.baselines.transformer_moe import (
            transformer_moe_apply, transformer_moe_init)
        return ModelFns(
            lambda seed: transformer_moe_init(seed, cfg, device=device),
            lambda p, src, st, tm, ln, train, seeds: transformer_moe_apply(
                p, cfg, src, st, tm, ln, train=train, seeds=seeds),
            encoder_seeds)

    if name == "seft":
        done()
        from raindrop_tpu_torch.baselines.seft import seft_apply, seft_init
        return ModelFns(
            lambda seed: seft_init(seed, cfg, device),
            lambda p, src, st, tm, ln, train, seeds: seft_apply(
                p, cfg, src, st, tm, ln, train=train),
            None)

    if name == "raindrop_v1":
        done()
        from raindrop_tpu_torch.models.raindrop_v1 import (
            raindrop_v1_apply, raindrop_v1_init)
        return ModelFns(
            lambda seed: raindrop_v1_init(seed, cfg, device),
            lambda p, src, st, tm, ln, train, seeds: raindrop_v1_apply(
                p, cfg, src, st, tm, ln, train=train, seeds=seeds),
            encoder_seeds)

    if name in ("grud", "grud_bce"):
        done()
        from raindrop_tpu_torch.baselines.grud import build_delta, grud_apply, grud_init

        # 'grud_bce': the reference's P12/P19 objective exactly, a single
        # sigmoid output trained with BCELoss (GRU-D_baseline.py:289), as
        # the logit pair [0, z] (softmax([0, z])[1] = sigmoid(z)); plain
        # 'grud' keeps the n-class head of every baseline
        bce = name == "grud_bce"
        if bce and cfg.n_classes != 2:
            raise ValueError(
                f"grud_bce is the binary sigmoid+BCE objective; "
                f"{cfg.n_classes}-class datasets need --model grud")

        def apply(p, src, st, tm, ln, train, seeds):
            x = src[:, :, :F].transpose(0, 1)             # [B, T, F]
            m = src[:, :, F:2 * F].transpose(0, 1)
            out, _ = grud_apply(p, x, m, build_delta(m, tm.transpose(0, 1)),
                                dropout_rate=cfg.dropout, train=train,
                                seeds=None if seeds is None else seeds.steps)
            if bce:
                out = torch.cat([torch.zeros_like(out), out], dim=-1)
            return out, out.new_zeros(())

        return ModelFns(
            lambda seed: grud_init(seed, F, 1 if bce else cfg.n_classes, device=device),
            apply,
            lambda gen, rows: ModelSeeds.draw(gen, steps=cfg.max_len))

    if name == "mtand":
        from raindrop_tpu_torch.baselines.mtand import mtand_apply, mtand_init

        nhidden = hp.pop("rec_hidden", 32)
        embed_time = hp.pop("embed_time", 128)
        num_heads = hp.pop("num_heads", 1)
        n_ref = hp.pop("num_ref_points", 128)
        done()

        def apply(p, src, st, tm, ln, train, seeds):
            # mTAND puts the timeline in [0, 1] by the 48 h maximum
            # (reference mTAND/utils.py:516-518)
            return mtand_apply(p, src.transpose(0, 1), tm.transpose(0, 1) / 48.0,
                               num_heads=num_heads, train=train)

        return ModelFns(
            lambda seed: mtand_init(seed, 2 * F, nhidden=nhidden, embed_time=embed_time,
                                    num_heads=num_heads, n_ref=n_ref,
                                    n_classes=cfg.n_classes, device=device),
            apply, None)

    if name == "mtgnn":
        from raindrop_tpu_torch.baselines.mtgnn import MTGNNSpec, mtgnn_apply, mtgnn_init

        spec = MTGNNSpec(F, cfg.max_len, cfg.n_classes,
                         d_static=cfg.d_static if cfg.static else 0,
                         **{k: hp.pop(k, d) for k, d in (
                             ("gcn_depth", 2), ("conv_channels", 16),
                             ("residual_channels", 16), ("skip_channels", 32),
                             ("end_channels", 64), ("layers", 5),
                             ("dilation_exponential", 2), ("subgraph_size", 20),
                             ("tanhalpha", 3.0), ("propalpha", 0.05))})
        done()

        def apply(p, src, st, tm, ln, train, seeds):
            return mtgnn_apply(p, spec, src[:, :, :F].transpose(0, 1),
                               st if cfg.static else None, dropout_rate=cfg.dropout,
                               train=train, seeds=seeds)

        return ModelFns(
            lambda seed: mtgnn_init(seed, spec, device),
            apply,
            lambda gen, rows: ModelSeeds.draw(gen, steps=spec.layers,
                                              noise_shape=(F, F)))

    if name == "dgm2":
        from raindrop_tpu_torch.baselines.dgm2 import DGM2Spec, dgm2_apply, dgm2_init

        spec = DGM2Spec(hp.pop("latent_dim", 10), hp.pop("cluster_num", 20))
        ode_units = hp.pop("ode_units", 10)
        done()

        def apply(p, src, st, tm, ln, train, seeds):
            # the shared uniform timeline of evaluate_DGM2
            # (reference code/baselines/utils_phy12.py:480-482)
            timeline = torch.linspace(0.0, float(cfg.max_len), cfg.max_len,
                                      device=src.device)
            logits, _ = dgm2_apply(p, spec, src[:, :, :F].transpose(0, 1), timeline,
                                   st if cfg.static else None, train=train,
                                   emission=False)
            return logits, logits.new_zeros(())

        return ModelFns(
            lambda seed: dgm2_init(seed, F, cfg.max_len, cfg.n_classes, spec=spec,
                                   d_static=cfg.d_static if cfg.static else 0,
                                   ode_units=ode_units, device=device),
            apply, None)

    if name == "ipnet":
        from raindrop_tpu_torch.baselines.ipnet import (
            IPNetSpec, ipnet_apply, ipnet_init, ipnet_reconstruction_loss)

        spec = IPNetSpec(hp.pop("ref_points", 192), hp.pop("hours_look_ahead", 48.0))
        hid = hp.pop("hid", 100)
        done()

        def apply(p, src, st, tm, ln, train, seeds):
            vals = src[:, :, :F].permute(1, 2, 0)           # [B, F, T]
            mask = src[:, :, F:2 * F].permute(1, 2, 0)
            ts = tm.transpose(0, 1)[:, None, :].expand_as(mask)
            x4 = torch.cat([vals, mask, ts, torch.zeros_like(mask)], dim=1)
            logits, reconst = ipnet_apply(p, spec, x4, train=train)
            # the reconstruction of the OBSERVED entries as the aux objective
            # (the reference holds out 20%, IP_Net_baseline.py:156-162; with
            # no held-out set the masked loss covers every observed entry)
            aux = ipnet_reconstruction_loss(x4, reconst, src.new_ones((F,)))
            return logits, aux

        return ModelFns(
            lambda seed: ipnet_init(seed, F, hid=hid, n_classes=cfg.n_classes,
                                    device=device),
            apply, None)

    raise ValueError(f"unknown baseline {name!r}")
