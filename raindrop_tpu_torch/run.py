"""Experiment CLI: the reference driver's flags, training Raindrop v2, v1
or a baseline family on the H100 (the port of raindrop_tpu/run.py).

Reference: python code/Raindrop.py --dataset P12 --withmissingratio False
--splittype random --reverse False --feature_removal_level no_removal
--predictive_label mortality (code/Raindrop.py:60-70; README.md:196-208).

Usage:
  python -m raindrop_tpu_torch.run --dataset P12 --data-root /path/to/P12data
  python -m raindrop_tpu_torch.run --dataset PAM --synthetic 2000   # no data files
  python -m raindrop_tpu_torch.run --dataset P19 --synthetic 500 --device cpu
  python -m raindrop_tpu_torch.run --dataset P12 --model transformer ...

The flags and their defaults are the JAX package's, so one command line
gives both packages the same model and training configurations and the
same splits; `--device` (default cuda) is the port's own. Without a CUDA
device the run stops unless --device cpu is given. `--model` takes the
flagship (raindrop) and every baseline family (baselines/adapters.py),
with the hyperparameter groups --mtand-*, --mtgnn-*, --dgm2-* and
--ipnet-*; a baseline runs the JAX CLI's own loop (n_runs per split, the
best run by AUPRC, the tracker's start, epoch and finish events, no
checkpoints). --data-parallel and --model-parallel lay the ranks out
as a ("data", "model") mesh (parallel/mesh.py) and --distributed true
starts the process group from torchrun's environment (NCCL on the card):

  torchrun --nproc_per_node 2 -m raindrop_tpu_torch.run --distributed true \
      --data-parallel 2 --dataset P12 --data-root ROOT

Every rank writes its shard of the best parameters under
--checkpoint-dir; only rank 0 prints and writes --out-json. A mesh of
several ranks trains the flagship model. The scale-out routes ride the
mesh's model axis (parallel/): --context-parallel sp|ring splits the
temporal attention's T axis (T must divide by --model-parallel),
--pipeline-microbatches N runs the encoder layers as GPipe stages
(--model-parallel must equal nlayers, 2; the global batch must divide by
N), --edge-partition true splits the propagation's edges (the d_inp^2
edges must divide by --model-parallel); each needs a mesh, and the errors
where one does not apply are the JAX CLI's (the Trainer's):

  torchrun --nproc_per_node 2 -m raindrop_tpu_torch.run --distributed true \
      --data-parallel 1 --model-parallel 2 --context-parallel ring --dataset PAM ...

The knn and mice
imputers and the information-gain ranking of --feature_removal_level set
(without --ig-scores) need scikit-learn.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

MODELS = ("raindrop", "raindrop_v1", "transformer", "transformer_ctx",
          "transformer_moe", "seft", "grud", "grud_bce", "mtand", "mtgnn", "dgm2",
          "ipnet")


def str2bool(v: str) -> bool:
    return str(v).lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("raindrop_tpu_torch")
    # the reference's six flags (code/Raindrop.py:61-70)
    p.add_argument("--dataset", default="P12",
                   choices=["P12", "P19", "eICU", "PAM"])
    p.add_argument("--withmissingratio", type=str2bool, default=False,
                   help="sweep missing ratios 0.1..0.5 (code/Raindrop.py:96-100)")
    p.add_argument("--splittype", default="random",
                   choices=["random", "age", "gender"])
    p.add_argument("--reverse", type=str2bool, default=False)
    p.add_argument("--feature_removal_level", default="no_removal",
                   choices=["no_removal", "set", "sample"])
    p.add_argument("--predictive_label", default="mortality",
                   choices=["mortality", "LoS"])
    # the Trans-mean family (reference Transformer_baseline.py:38-39,
    # 155-204): impute raw values before tensorize/normalize
    p.add_argument("--imputation", default="no_imputation",
                   choices=["no_imputation", "mean", "forward",
                            "cubic_spline", "knn", "mice"])
    # explicit versions of the reference's hidden knobs
    p.add_argument("--model", default="raindrop", choices=list(MODELS))
    p.add_argument("--use-beta", type=str2bool, default=False)
    p.add_argument("--sensor-wise-mask", type=str2bool, default=False)
    p.add_argument("--max-len", type=int, default=None,
                   help="override the dataset's max sequence length "
                        "(synthetic data is generated at this length; real "
                        "data is truncated)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n-splits", type=int, default=5)
    p.add_argument("--n-runs", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--data-root", default=None,
                   help="dataset root (P12data/ etc.); omit with --synthetic")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use N synthetic samples instead of real data")
    p.add_argument("--device", default="cuda",
                   help="the device to train on; without CUDA the run stops "
                        "unless this is 'cpu'")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="ranks on the mesh 'data' axis (0 = no mesh)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks on the mesh 'model' axis (Megatron tensor "
                        "parallelism, or the scale-out route's split)")
    p.add_argument("--distributed", type=str2bool, default=False,
                   help="start the process group from torchrun's environment "
                        "(NCCL on CUDA, gloo on the CPU)")
    p.add_argument("--context-parallel", choices=["none", "sp", "ring"],
                   default="none",
                   help="shard the temporal attention's T axis over the mesh "
                        "'model' axis: 'sp' gathers K/V, 'ring' rotates K/V "
                        "blocks (parallel/sequence.py)")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="run the encoder layers as GPipe stages over the "
                        "'model' axis with N microbatches (parallel/pipeline.py); "
                        "needs model-parallel == nlayers")
    p.add_argument("--edge-partition", type=str2bool, default=False,
                   help="shard the propagation layer's edge set over the "
                        "'model' axis (parallel/edge_partition.py)")
    p.add_argument("--grad-microbatches", type=int, default=1,
                   help="gradient accumulation: split each batch into N "
                        "chunks, average their gradients, one Adam update "
                        "(numerically the full-batch step)")
    p.add_argument("--resplit-per-run", type=str2bool, default=False,
                   help="re-randomize the 8:1:1 partition for every run "
                        "(the mTAND protocol, mTAND_baseline.py:72-88)")
    p.add_argument("--diag-frozen-params", type=str2bool, default=False,
                   help="print params unchanged by the first epoch "
                        "(GRU-D_baseline.py:355-363)")
    p.add_argument("--resume-from", default=None, metavar="CKPT",
                   help="resume from a <ckpt>_last full-state checkpoint "
                        "(parameters, optimizer, scheduler, RNG states, "
                        "epoch); applies to the first split and run trained")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--input-pipeline", default="resident",
                   choices=["resident", "streaming"],
                   help="'resident' keeps the split on the device; "
                        "'streaming' gathers batches on the host and copies "
                        "them ahead of the step (data/prefetch.py), for a "
                        "split larger than device memory; the same results")
    p.add_argument("--prop-backend", default="auto",
                   choices=["auto", "coo", "pallas"],
                   help="graph-propagation backend (config.py): 'pallas' "
                        "runs the hand-written CUDA SpMM kernel")
    p.add_argument("--missing-ratio", type=float, default=None,
                   help="run ONE sensor-removal ratio instead of "
                        "--withmissingratio's 0.1-0.5 sweep")
    p.add_argument("--ig-scores", default=None, metavar="NPY",
                   help="precomputed Setting-2 sensor ranking ([F, 2] rows "
                        "of (index, name), most informative first: the "
                        "reference's saved/IG_density_scores_<dataset>.npy, "
                        "read at code/Raindrop.py:228-229); default computes "
                        "the RandomForest ranking from the training split "
                        "(scikit-learn)")
    p.add_argument("--dropout", type=float, default=None,
                   help="override the model dropout (0 makes training "
                        "deterministic)")
    p.add_argument("--measure-mfu", type=str2bool, default=False,
                   help="add the achieved model TFLOP/s and the MFU (against "
                        "the card's dense bf16 peak) to every epoch record "
                        "(utils/diagnostics.py)")
    p.add_argument("--track-jsonl", default=None, metavar="PATH",
                   help="append start/epoch/finish events as JSON lines "
                        "(utils/tracking.JSONLTracker)")
    p.add_argument("--log-path", default=None)
    p.add_argument("--out-json", default=None,
                   help="write the summary dict as JSON here")
    p.add_argument("--compare-golden", default=None, metavar="NPY",
                   help="compare per-split accuracy/AUPRC/AUROC against a "
                        "reference golden-results array ([3, n_splits] "
                        "percent rows acc/auprc/auroc, the format of "
                        "code/results/standard_phy12.npy)")

    # ---- per-baseline hyperparameter groups: every knob the reference
    # driver scripts expose, at their published defaults
    g = p.add_argument_group(
        "mTAND", "reference code/baselines/mTAND/mTAND_baseline.py:21-52")
    g.add_argument("--mtand-rec-hidden", type=int, default=32)
    g.add_argument("--mtand-embed-time", type=int, default=128)
    g.add_argument("--mtand-num-heads", type=int, default=1)
    g.add_argument("--mtand-num-ref-points", type=int, default=128)
    g = p.add_argument_group(
        "MTGNN", "reference code/baselines/MTGNN_baseline.py:281-289 "
                 "model construction")
    g.add_argument("--mtgnn-subgraph-size", type=int, default=20)
    g.add_argument("--mtgnn-gcn-depth", type=int, default=2)
    g.add_argument("--mtgnn-conv-channels", type=int, default=16)
    g.add_argument("--mtgnn-residual-channels", type=int, default=16)
    g.add_argument("--mtgnn-skip-channels", type=int, default=32)
    g.add_argument("--mtgnn-end-channels", type=int, default=64)
    g.add_argument("--mtgnn-layers", type=int, default=5)
    g.add_argument("--mtgnn-dilation-exponential", type=int, default=2)
    g.add_argument("--mtgnn-tanhalpha", type=float, default=3.0)
    g.add_argument("--mtgnn-propalpha", type=float, default=0.05)
    g = p.add_argument_group(
        "DGM2-O", "reference code/baselines/DGM2_baseline.py:74-84,305-308")
    g.add_argument("--dgm2-cluster-num", type=int, default=20)
    g.add_argument("--dgm2-latent-dim", type=int, default=10)
    g.add_argument("--dgm2-ode-units", type=int, default=10)
    g = p.add_argument_group(
        "IP-Net", "reference code/baselines/IP_Net_baseline.py model args")
    g.add_argument("--ipnet-ref-points", type=int, default=192)
    g.add_argument("--ipnet-hid", type=int, default=100)
    g.add_argument("--ipnet-hours-look-ahead", type=float, default=48.0)
    return p


_HP_PREFIXES = {"mtand": "mtand_", "mtgnn": "mtgnn_", "dgm2": "dgm2_",
                "ipnet": "ipnet_"}


def baseline_hp(args) -> dict:
    """The selected family's --<family>-* flags as the adapter's hp dict
    (the reference's flag names, underscored)."""
    pre = _HP_PREFIXES.get(args.model)
    if not pre:
        return {}
    return {k[len(pre):]: v for k, v in vars(args).items() if k.startswith(pre)}


def make_model_fns(args, cfg, device="cuda"):
    """The selected model family's functions (baselines/adapters.ModelFns:
    init_fn, apply_fn, draw_seeds, update_mask)."""
    from raindrop_tpu_torch.baselines.adapters import make_baseline, make_flagship
    if args.model == "raindrop":
        return make_flagship(cfg, device)
    return make_baseline(args.model, cfg, baseline_hp(args), device)


def start_mesh(args, device):
    """The process group (--distributed: torchrun's environment; each rank
    on its card, LOCAL_RANK modulo the cards) and the ("data", "model")
    mesh of --data-parallel / --model-parallel, or None."""
    import torch

    from raindrop_tpu_torch.parallel.mesh import (
        default_backend, initialize_distributed, make_mesh)

    backend = default_backend(device)
    if args.distributed:
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local % torch.cuda.device_count())
        initialize_distributed(auto=True, backend=backend)
    if not (args.data_parallel or args.model_parallel > 1):
        return None
    mesh = make_mesh(args.data_parallel or None, args.model_parallel, backend)
    if mesh.size() > 1 and args.model != "raindrop":
        raise ValueError("a mesh of several ranks trains the flagship model "
                         "(--model raindrop)")
    return mesh


def configs(args):
    """(RaindropConfig, [TrainConfig per missing ratio]) of a parsed
    command line, field for field the JAX package's."""
    from raindrop_tpu_torch.config import TrainConfig, dataset_config

    cfg_kw = {}
    if args.max_len is not None:
        cfg_kw["max_len"] = args.max_len
    if args.dropout is not None:
        cfg_kw["dropout"] = args.dropout
    cfg = dataset_config(args.dataset, use_beta=args.use_beta,
                         sensor_wise_mask=args.sensor_wise_mask,
                         prop_backend=args.prop_backend, **cfg_kw)
    missing_ratios = ([0.1, 0.2, 0.3, 0.4, 0.5] if args.withmissingratio
                      else [0.0])
    if args.missing_ratio is not None:
        missing_ratios = [args.missing_ratio]
    tcfgs = [TrainConfig(
        dataset=args.dataset, num_epochs=args.epochs,
        learning_rate=args.lr, batch_size=args.batch_size,
        n_splits=args.n_splits, n_runs=args.n_runs,
        batching_strategy=3 if args.dataset == "PAM" else 2,
        split_type=args.splittype, reverse=args.reverse,
        feature_removal_level=args.feature_removal_level,
        missing_ratio=mr, predictive_label=args.predictive_label,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        input_pipeline=args.input_pipeline,
        measure_mfu=args.measure_mfu,
        log_path=args.log_path,
        resplit_per_run=args.resplit_per_run,
        diag_frozen_params=args.diag_frozen_params,
        context_parallel=args.context_parallel,
        pipeline_microbatches=args.pipeline_microbatches,
        edge_partition=args.edge_partition,
        grad_microbatches=args.grad_microbatches) for mr in missing_ratios]
    return cfg, tcfgs


def make_split(args, cfg, k, missing_ratio=0.0, run=0):
    """The Split of split k (1-based) and run `run`, as the JAX CLI makes
    it: synthetic or from --data-root, imputed, truncated to --max-len,
    with sensors removed from val and test at `missing_ratio`."""
    from raindrop_tpu_torch.data.datasets import load_split, synthetic_split
    from raindrop_tpu_torch.data.settings import (
        remove_sensors_fixed, remove_sensors_random)

    imput = None if args.imputation == "no_imputation" else args.imputation
    # the per-run seed moves the partition only under --resplit-per-run
    resplit = (args.seed * 1000 + 101 * run + k if args.resplit_per_run
               else None)
    if args.synthetic:
        sp = synthetic_split(args.dataset, n=args.synthetic,
                             seed=(resplit if resplit is not None
                                   else args.seed * 1000 + k),
                             T=cfg.max_len, imputation=imput)
    else:
        if not args.data_root:
            raise SystemExit("--data-root or --synthetic required")
        sp = load_split(args.data_root, args.dataset, k,
                        split_type=args.splittype, reverse=args.reverse,
                        predictive_label=args.predictive_label,
                        resplit_seed=resplit, imputation=imput)
        if args.max_len is not None:  # truncate the time axis
            if sp.Ptrain.shape[1] < cfg.max_len:
                raise SystemExit(
                    f"--max-len {cfg.max_len} exceeds the dataset's sequence "
                    f"length {sp.Ptrain.shape[1]}: only truncation is "
                    f"supported")
            for f in ("Ptrain", "Pval", "Ptest",
                      "Ptrain_time", "Pval_time", "Ptest_time"):
                setattr(sp, f, getattr(sp, f)[:, :cfg.max_len])
    if missing_ratio > 0:
        rng = np.random.default_rng(args.seed * 100 + k)
        if args.feature_removal_level == "sample":
            sp.Pval = remove_sensors_random(sp.Pval, missing_ratio, rng)
            sp.Ptest = remove_sensors_random(sp.Ptest, missing_ratio, rng)
        elif args.feature_removal_level == "set":
            F = sp.Ptrain.shape[2] // 2
            if args.ig_scores:
                # the reference's precomputed ranking (code/Raindrop.py:
                # 228-229: np.load, column 0)
                arr = np.load(args.ig_scores, allow_pickle=True)
                ranking = arr[:, 0].astype(int)
                if sorted(ranking.tolist()) != list(range(F)):
                    raise SystemExit(
                        f"--ig-scores {args.ig_scores}: column 0 is not a "
                        f"permutation of range({F})")
            else:
                from raindrop_tpu_torch.data.settings import (
                    information_gain_ranking)
                ranking = information_gain_ranking(
                    sp.Ptrain[:, :, :F], sp.ytrain, seed=args.seed)
            sp.Pval = remove_sensors_fixed(sp.Pval, ranking, missing_ratio)
            sp.Ptest = remove_sensors_fixed(sp.Ptest, ranking, missing_ratio)
    return sp


def compare_golden(path, summary) -> dict:
    """Print our per-split accuracy / AUPRC / AUROC beside a golden array
    ([3, n_splits] percent rows acc/auprc/auroc) and return the mean deltas.
    A split-count mismatch compares the overlapping prefix, with a
    warning."""
    golden = np.asarray(np.load(path), np.float64)
    print(f"--- golden comparison vs {path} ---")
    print(f"{'metric':>9} {'ours mean':>10} {'golden mean':>12} "
          f"{'delta':>8}  per-split deltas")
    deltas = {}
    for row, name in enumerate(("accuracy", "auprc", "auroc")):
        if name not in summary or row >= golden.shape[0]:
            continue
        ours = np.asarray(summary[name].get("per_split", [summary[name]["mean"]]),
                          np.float64)
        gold = np.atleast_1d(golden[row])
        m = min(len(ours), len(gold))
        if m < max(len(ours), len(gold)):
            print(f"  [warn] {name}: comparing first {m} splits "
                  f"(ours {len(ours)} vs golden {len(gold)})")
        d = ours[:m] - gold[:m]
        deltas[name] = float(np.mean(d))
        print(f"{name:>9} {ours[:m].mean():>10.2f} {gold[:m].mean():>12.2f} "
              f"{np.mean(d):>+8.2f}  " + " ".join(f"{v:+.2f}" for v in d))
    return deltas


def run_baseline(args, cfg, tcfg, split_fn, device, tracker=None):
    """The JAX CLI's loop for a baseline family: a Trainer with the family's
    functions, n_runs per split (a new partition each under
    --resplit-per-run), the best run of a split by test AUPRC, the mean and
    std over the splits in percent; the tracker's start (with the model's
    name), epoch and finish events as run_splits gives them."""
    from raindrop_tpu_torch.train.trainer import Trainer
    from raindrop_tpu_torch.utils.tracking import _SafeTracker

    tracker = _SafeTracker(tracker)
    tracker.start({"dataset": tcfg.dataset, "model": args.model,
                   "model_config": dict(vars(cfg)),
                   "train_config": dict(vars(tcfg))})
    fam = make_model_fns(args, cfg, device)
    trainer = Trainer(cfg, tcfg, device=device, init_fn=fam.init_fn,
                      apply_fn=fam.apply_fn, draw_seeds=fam.draw_seeds,
                      update_mask=fam.update_mask)
    per_split = []
    for k in range(1, tcfg.n_splits + 1):
        base = None if tcfg.resplit_per_run else split_fn(k)
        runs = [trainer.train_split(
                    split_fn(k, run=m) if tcfg.resplit_per_run else base,
                    seed=tcfg.seed + m,
                    resume_from=args.resume_from if k == 1 and m == 0 else None,
                    tracker=tracker)
                for m in range(tcfg.n_runs)]
        per_split.append(max(runs, key=lambda r: r.test_metrics["auprc"]).test_metrics)
    summary = {
        name: {"mean": float(np.mean([m[name] for m in per_split]) * 100),
               "std": float(np.std([m[name] for m in per_split]) * 100),
               "per_split": [m[name] * 100 for m in per_split]}
        for name in per_split[0]}
    tracker.finish(summary)
    return {"summary": summary, "per_split": per_split}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from raindrop_tpu_torch.serve import resolve_device
    from raindrop_tpu_torch.train.trainer import run_splits
    from raindrop_tpu_torch.utils.tracking import JSONLTracker

    device = resolve_device(args.device)   # no CUDA: raises, never the CPU
    mesh = start_mesh(args, device)
    rank0 = mesh is None or mesh.get_rank() == 0
    cfg, tcfgs = configs(args)
    all_results = {}
    for tcfg in tcfgs:
        mr = tcfg.missing_ratio

        def split_fn(k, run=0, _mr=mr):
            return make_split(args, cfg, k, _mr, run)

        tracker = JSONLTracker(args.track_jsonl) if args.track_jsonl else None
        if args.model == "raindrop":
            results = run_splits(split_fn, cfg, tcfg, device=device,
                                 resume_from=args.resume_from, tracker=tracker,
                                 mesh=mesh)
        else:
            results = run_baseline(args, cfg, tcfg, split_fn, device, tracker)
        all_results[f"missing_{mr}"] = results["summary"]
        for name, s in results["summary"].items():
            if rank0:
                print(f"[mr={mr}] {name:>9} = {s['mean']:.1f} +/- {s['std']:.1f}")

    if args.compare_golden:
        # against the reference's saved results: only the standard
        # (missing ratio 0.0) run, the setting the golden arrays record;
        # the out-json below is written either way
        if "missing_0.0" not in all_results:
            print("--compare-golden skipped: no missing_ratio=0.0 run in "
                  "this sweep (golden results are the standard setting)")
        else:
            all_results["golden_delta"] = compare_golden(
                args.compare_golden, all_results["missing_0.0"])

    if args.out_json and rank0:
        with open(args.out_json, "w") as f:
            json.dump(all_results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
