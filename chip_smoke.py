#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py [--out details.json]

Phases, each of which fails the run (non-zero exit, no result line) when a
check does not hold:

  1. set-up: TF32 off for matmuls and cuDNN (the reference semantics are
     full f32), the card's name and power limit, the kernels built from
     raindrop_tpu_torch/csrc/ with nvcc (build seconds printed); the data
     layer's C++ host runtime built with g++ and its seven functions held
     against numpy on the host, bit-equal (get_stats within 1e-12
     relative), the producer's gather of one PAM-2048 batch and load_split's
     normalization at P12's size timed both ways (host_runtime_phase); then
     the SASS check: cuobjdump -sass on the flash_packed library and the fused
     layer's two must find HGMMA (wgmma) instructions in each tensor-core
     kernel family (SASS_FAMILIES: the attention's three on one warpgroup
     and three on two (past hd_pad 144), which flash_mha_packed and
     flash_mha both launch, and every bf16 row product of the fused layer
     with its attention on one warpgroup and on two);
  2. flash_mha_packed forward, kernel against its plain PyTorch version at
     the P12 (B=128, T=215, d=160) and eICU (T=300, d=72) shapes, f32 and
     bf16 operands, ragged lengths including 0, 1 and T, bit-equal on a
     repeat and for 8 samples launched alone, exact zeros for the
     length-0 sample; in bf16 the
     tensor-core kernel is held against the previous design (the scalar
     kernel) and timed in turns with it (prev_ms), and each time's share of
     the bound printed;
  3. fused_encoder_layer forward, the same at the PAM shape (B=128, T=600,
     d=84, ffn=136): out and attn sample by sample, lse (attn zero for the
     length-0 sample, 8 samples alone bit-equal); in bf16 the tensor-core
     route (every row product on wgmma, the attention too at hd 42) timed
     in turns with the previous design (the scalar kernels);
  4. flash_mha_packed backward at the same shapes, dropout 0 and 0.2: the
     forward with dropout, then dq, dk, dv of the two backward kernels
     against the plain backward, finite, zero on the length-0 sample,
     bit-equal on a repeat and for 8 samples launched alone, in bf16 also
     against the scalar kernels sample by sample (prev_ms as in phase 2);
  5. flash_mha_packed in bf16 at the edge shapes, B=4, 2 heads: head dims
     3 and 13 (odd: 2-byte plain loads, unpaired stores), 8, 42 (4-byte
     copies), 84, 128, 129, 140 and 144 (tensor cores on one warpgroup up
     to a padded 144), 160, 170, 192, 193 (odd), 256, 360 and 368 (on two
     warpgroups past it), T = 64, 65 and 1024, dropout 0 and 0.2: the
     plan's route forward and backward against the plain version and
     against the scalar kernels (the previous design), bit-equal on a
     repeat, exact zeros for the length-0 sample;
  6. fused_encoder_layer backward at the PAM shape, the same grid: dx (sample
     by sample) and the 12 weight gradients against the plain backward,
     bit-equal on a repeat, a zero attention gradient for the length-0
     sample, the tensor-core route timed in turns with the previous design;
 6a. the fused layer at an edge shape, B=4, T=100 (ending inside a 64-row
     tile), lengths 0, 1, 45 and 100, PAM's and PAM-sw's widths, f32 and
     bf16, dropout 0 and 0.2: forward and backward against the plain
     version and (bf16) the previous design, bit-equal on a repeat, exact
     zeros for the length-0 sample; every fused run's routes checked (bf16
     tensor cores, the attention on two warpgroups, "tc_wide", at PAM-sw's
     hd 170; f32 scalar);
 6b. phases 2, 4, 3 and 6 at the sensor-wise widths (sensor_wise_mask:
     d = d_inp * (d_ob + d_pe), 2 heads), B=128: P12-sw (T=215, d=720, hd
     360: the two-warpgroup tensor-core route "tc_wide" in bf16, timed in
     turns with the previous design, the scalar route in f32) and eICU-sw
     (T=300, d=280, hd 140: tensor cores in bf16) forward and backward, PAM-sw's fused
     layer (T=600, d=340, ffn=136, hd 170) forward and backward; each
     route checked; then the fused layer's three attention launches on
     "tc_wide" alone at PAM-sw, dropout 0 and 0.2 (fused_wide_attn_phase:
     attn, lse, dq, dk and dv against the plain attention on the very qkv,
     d_attn and delta the launches read; each launcher's device time in
     the layer's calls, the plain attention's and SDPA's);
  7. an InferenceServer for PAM at full width (random weights from a seed)
     answering predict on 1, 5, 128 and 200 rows, submit from 4 threads,
     predict_stream and the bf16 wire format, held against the same server
     on the dense plain path; a row's probabilities across batches within
     1e-5 on the kernel path with f32 operands too, and within the same
     limit on the kernels' plain versions in bf16 (each server's own batch
     dependence printed); it must have gone through the fused-layer kernel;
  8. the same for P12, which must have gone through flash_mha_packed,
     every launch on the tensor-core route (bf16 operands);
  9. a Trainer for PAM at full width and depth (B=128, lr 1e-4, shipped
     dropout 0.2) on a synthetic split resident on the card: one epoch and
     a padded predict; finite losses, backward launches of the preset's
     kernel, dead parameters bit-identical and live ones changed, the same
     epoch twice bit-equal, the first step's loss and gradient norm against
     the dense path at dropout 0, a falling loss on a fixed batch, and on
     that batch at lr 1e-3 and dropout 0 ten steps beside the dense path's,
     the loss before and after the first one held to it (f32 and bf16
     operands);
 10. the same for P12 (every flash_mha_packed launch, forward and
     backward, on the tensor-core route);
 10a. compute_dtype='bfloat16' (mixed precision: f32 master parameters,
     the forward in bf16) for PAM and P12 at full width and depth
     (mixed_phase): served on 1, 5, 128 and 200 rows and trained for an
     epoch, every fused_encoder_layer / flash_mha_packed launch forward and
     backward on the tensor cores; served probabilities (f32) and the
     first step's loss and gradient norm (dropout 0) held to 2e-2 against
     the same configuration on the kernels' plain versions, logits and
     every gradient f32; request latency by bucket, step ms and samples/s
     beside the f32 path's in the same run, and the two propagation GEMMs'
     device time in f32 and bf16 (prop_gemm_phase);
 10b. phases 7 and 8 with sensor_wise_mask for P19 (the dense rung at
     T=60: no kernel launched), P12 (every flash_mha_packed launch on the
     two-warpgroup tensor-core route), eICU (every launch on the tensor
     cores) and PAM (the
     fused layer), a row's probabilities held across batches to
     BATCH_LIMIT_SW with bf16 operands, on the kernels and on their plain
     versions; and phase 9 for P12, eICU and PAM
     with it, the falling-loss check at the rate FIT_LR_SW gives; PAM and
     PAM-sw served and trained with every fused_encoder_layer launch on the
     tensor-core route, PAM-sw's every one with its attention on "tc_wide";
 11. spmm_segment_softmax, kernels against their plain PyTorch versions,
     forward (out, w) and backward (dx, dgamma, cotangents on both
     outputs): the complete sensor graphs of P12 (B=128, N=36, E=1296,
     D=860) and PAM (N=17, E=289, D=2400) with the messages gathered at
     the target (every launch on the launch plan's "row" route) and at the
     source ("tile"), and a kNN graph (N=128, k=6, E=768, D=240, edges
     shuffled, one node without an incoming edge); zero rows exact,
     bit-equal on a repeat;
 12. sddmm forward and backward on the same graphs at D=860 and D=120, at
     the shape the self-attention phase gives it (B=2: its heads on the
     batch axis) and at B=1, every launch on "tile"; then both sides of
     the plan's cut-over from "tile" to "csr" in N (graph_edge_phase);
 13. an InferenceServer for P12 with prop_backend='pallas' (every check of
     phase 8, held against the dense plain path: dense attention and dense
     propagation), which must launch the SpMM kernel twice per forward,
     every launch on the "row" route;
     and one raindrop_apply with a random global_adj in [0.5, 2],
     'pallas' against 'coo';
 14. a Trainer for P12 with prop_backend='pallas' (every check of phase 10;
     the SpMM backward must have been launched; every SpMM launch on
     "row");
 14a. use_beta (the time-conditioned edge attention with top-50%
     pruning) at P12 with prop_backend='pallas': phases 8 and 10 on that
     configuration, held against the dense plain path (dense attention,
     the dense beta block), every flash_mha_packed launch on the tensor
     cores and no sparse-graph kernel launched (beta routes off the SpMM
     kernel); then (beta_graph_phase) the dense beta block against two COO
     layers on the all-ones graph at B=32 (equal kept-edge masks, out and
     alpha within GRAPH_TOL) and one raindrop_apply with a random
     global_adj in [0.5, 2] (the COO beta branch) on the kernels against
     the plain path, 1e-4 with f32 attention operands;
 14b. dtype='bfloat16' (parameters and Adam's moments stored in bf16) at
     P12 (bf16_storage_phase): an epoch (finite losses, every packed launch
     on the tensor cores), the loss falling on a fixed batch at lr 1e-3, a
     checkpoint of parameters and optimizer state read back bit-equal, a
     served request (f32 probabilities summing to 1 within the bf16
     softmax's 1e-2);
 14c. the experiment CLI, raindrop_tpu_torch.run.main, through dataset
     files: a P12 root in the reference's schema (640 samples from --seed,
     T=215, 36 sensors, 9 statics, a split file and a Setting-2 ranking,
     write_p12_root), forward imputation, sensors removed at ratio 0.3 by
     the ranking (--ig-scores), 2 epochs of one split with --measure-mfu:
     rc 0, finite metrics, every flash_mha_packed launch (forward and
     backward) on the tensor cores, every epoch record's MFU in (0, 1);
 14d. the CLI on synthetic PAM (640 samples, 1 epoch) through
     the streaming input pipeline with --measure-mfu: the fused layer's
     tensor-core launches counted both ways, every epoch record's MFU in
     (0, 1), its batches gathered by the C++ host runtime (counted); the
     summary and the epoch record equal to those of the same command line
     with the resident pipeline; the same command on the numpy path
     (RAINDROP_TPU_NATIVE=0) beside, the two streaming runs profiled (wall
     and device ms a step, the idle share);
 14e. train_split at P12 (2560 samples, ~22 batches an epoch) and PAM (640,
     30 batches), 3 epochs, resident and streaming, with measure_mfu off and
     on, from the same parameters and seed: parameters, best parameters,
     history and test metrics bit-equal (streaming_phase);
 14f. one training step's model FLOPs at P12, PAM and PAM-2048 (B=128),
     counted with the kernels (FlopCounterMode plus the kernels' credit)
     and with the plain versions (the dense rung) on the same rows (16 at
     PAM-2048), held within MFU_TOL (2%); the step's time by CUDA events,
     its MFU against the card's dense bf16 peak, and the epoch record's MFU
     of a 1-epoch train_split (mfu_phase);
 14g. the baseline families (baselines_phase): each of the ten at P12
     (published widths, B=128, dropout 0.2, random weights from seed 0)
     served through InferenceServer(apply_fn=...) on buckets 1 and 128,
     held against the same server on the kernels' plain versions (2e-2
     with bf16 attention), and trained for 5 steps (finite losses, the
     first step twice bit-equal); the transformer, the context-token
     transformer, the MoE transformer and Raindrop v1 must launch
     flash_mha_packed forward and backward, every launch on the tensor
     cores, the six others no kernel; the transformer and v1 again at eICU
     (hd 15 and 35: 2-byte copies); a transformer step's FLOPs with the
     kernels against the dense rung's count (MFU_TOL); the CLI with
     --model transformer on synthetic P12 (640 samples, 2 epochs,
     --measure-mfu); the packed pair in bf16 at hd 15, 26, 32, 35 and 90,
     B=128, at the families' T (215, 216, 300), forward and backward
     against the plain versions (sample_err), timed beside SDPA;
 14h. reference checkpoints imported (migrate_phase): P12 and PAM at full
     width and depth, a seeded init written as a reference Raindrop_v2
     state dict (torch.save), imported by the migrate CLI's main and loaded
     with load_checkpoint, served on 128 rows: bit-equal to the seeded
     model's server, within 2e-2 of the dense plain attention, every
     flash_mha_packed (P12) / fused_encoder_layer (PAM) launch on the
     tensor cores; 3 Trainer steps of the imported P12 model (the packed
     backward launched, finite losses); an mTAND state dict in the
     reference's {'rec_state_dict': ...} wrapper imported the same way and
     mtand_apply run on variable_time_collate's batch of
     records_from_dense records, the card against the CPU within 1e-5;
 14i. raw PhysioNet-2012 text for RAW_PATIENTS (400) patients from --seed
     through `preprocess parse` and `splits` (the csv module, no pandas)
     into the CLI: 1 epoch of P12 at full width and depth, finite loss and
     metrics, the packed pair launched forward and backward, every launch
     on the tensor cores, the epoch record's MFU in (0, 1);
 15. ob_propagate_selfattention (N=36, D=860, 2 heads) on a kNN and on the
     complete graph, score_backend 'sddmm' against 'gather', value and
     gradient w.r.t. x; one sddmm launch a graph each way;
 16. flash_mha (split heads, any T) forward and backward, kernels against
     their plain PyTorch versions, f32 and bf16 operands, dropout 0 and
     0.2, ragged lengths including 0, at B=128, H=2, D=42 and T=600 (the
     JAX package's one-program regime) and T=2048 (its streaming regime),
     on the strided head views the model hands it; finite, zero on the
     length-0 sample, bit-equal on a repeat. In bf16 the launch plan's
     tensor-core route (every launch counted there) on the
     model's padded cast, held against the scalar kernels (the previous
     design) sample by sample and bit-equal on a plain cast's dense heads,
     timed in turns with both (prev_ms, dense_ms), device times by the
     profiler at T=600, SDPA with a key mask beside; the route printed. At T=2048
     the plain version runs on 8 samples at a time (its [B, H, T, T] int64
     mask would take 8.6 GB at B=128);
 17. the public op at T=600 with dropout 0.2 through autograd, held against
     flash_mha_packed on the same [B, T, d] tensors and seed (both hash
     b * H + h, the global row and column): output and gradients, within
     1e-5 with f32 operands, bit-equal with bf16 (the same device routine);
 18. an InferenceServer for PAM's width on a 2048-step window
     (dataset_config("PAM", max_len=2048), full width and depth; every
     check of phase 7, held against the dense plain path), which must
     launch flash_mha twice per forward, every launch on the tensor-core
     route (hd 42);
 18a. that server at compute_dtype='bfloat16' (mixed_long_phase): two
     flash_mha launches a forward and no other kernel, all on the tensor
     cores; DENSE_ROWS rows held to 2e-2 against the kernels' plain
     versions; the top bucket's latency and device time beside phase 18's
     f32 ones, the propagation GEMMs in both dtypes, and the training step
     (B=128, 3 batches) in bf16 and f32;
 19. the trainer protocol on that configuration: train_split on
     synthetic_split("PAM", T=2048) (B=128, sampler strategy 3, dropout
     0.2) for 1 epoch with checkpoints, resumed from the `_last` file for
     a second, and the uninterrupted 2-epoch run, whose history the resumed
     one must equal bit for bit; finite records, metrics in [0, 1], the
     best file reloads, forward launches = 2 x (steps + predict chunks),
     backward launches = 2 x steps, all on the tensor-core route; the first
     step's loss and gradient norm against the dense path at dropout 0 on
     DENSE_ROWS (16) samples; step ms, samples/s and the idle share;
 20. run_splits, 2 splits of 1 epoch, for the summary's shape, at PAM's own
     window (600 steps; a cut: at 2048 steps its checkpoints took most of a
     minute);
 21. flash_mha past hd 128 as phase 16 does it at T=2048: PAM-sw's head
     (hd 170, d_inp * (d_ob + d_pe) = 340 over 2 heads) and hd 360, in
     bf16 on the two-warpgroup tensor-core route ("tc_wide", padded to 176
     and 368), in f32 on the scalar kernels (the Narrow geometry at 170,
     Wide at 360), dropout 0 and 0.2, timed in turns with the previous
     design, SDPA with a key mask beside; then the edge shapes, B=5, hd 8,
     13, 42, 128, 144 (one warpgroup in bf16) and 129, 170, 192, 193, 200,
     360 and 368 x T 65, 1025 and 2048 x dropout 0 and 0.2, both operand
     dtypes, one length ending 45 rows into a 64-row block: forward and
     backward against the plain version and (bf16) the scalar kernels,
     bit-equal on a repeat and on a plain cast, exact zeros for the
     length-0 sample;
 22. phase 18 for PAM with sensor_wise_mask at max_len 2048 (PAM-sw-2048,
     hd 170): exactly two flash_mha launches per forward and no other
     kernel, every one on "tc_wide", a row's probabilities across batches
     held to phase 18's 1e-5 (in bf16 and f32, and on the kernels' plain
     versions in bf16: plain_kernels swaps flash_mha's in);
 23. phase 9 on that configuration (B=128; the checks against the dense
     path and the falling-loss check at FIT_LR_SW on the first batch's
     first DENSE_ROWS rows, as past 1024 steps always), through flash_mha
     forward and backward, every launch on "tc_wide";
 24. phase 19 on that configuration, 1 epoch with checkpoints and a second
     resumed, bit-equal to the uninterrupted 2-epoch run (a cut from 2 + 1:
     the script's time), the launch counts (all on "tc_wide"), the first
     step against the dense path, step ms, samples/s and the idle share;
 25. the device mesh (shard_origin_phase): rows 1-2 at P12 (bf16
     and f32) and rows 3-4 at PAM (bf16), dropout 0.2, launched on a batch
     shard at its origin (b0, 0, H) and on one head at (b0, h, H): every
     output and gradient bit-equal to those rows and heads of the full
     launch, and held to the plain version at the origin (SAMPLE_TOL);
 26. mesh_phase: a process group of one rank over NCCL and make_mesh(1, 1);
     P12 and PAM, 3 steps each at full width (B=128) through
     Trainer(mesh=...), bit-equal to the Trainer without a mesh (losses,
     every parameter), every launch on the tensor cores (this slice's
     launch counts), step ms with and without the mesh in turns; a
     sharded checkpoint written and read back; then the scale-out routes
     on that mesh (route_one_rank_runs): sequence-parallel and ring
     attention and edge partitioning at P12, 3 steps at B=128, dropout 0,
     against the one-device Trainer on the same rung (the dense rung for
     SP and ring, the packed pair with f32 operands for edge
     partitioning), loss, logits and parameters within 1e-4;
 27. two_rank_phase: two gloo ranks sharing the card (NCCL refuses two
     ranks on one GPU; gloo takes all_reduce and broadcast on CUDA
     tensors, all the port uses): P12 DP 2x1 and TP 1x2 (one head a rank,
     flash_mha_packed's launches counted on each), 3 steps with f32
     attention operands, held to the one-rank steps at the JAX package's
     mesh tolerances and the first step's gradient (Adam's first moment)
     at TWO_RANK_TOL; TP 1x2 at P12's bf16 operands (the tensor-core
     route), its first step's loss, logits and gradient at
     TWO_RANK_BF16_TOL; run_elastic with a fault at epoch 1 bit-equal to
     the uninterrupted run;
 27a. scale_out_phase: the scale-out routes on two gloo ranks sharing the
     card, one group, full model width: (a) SP 1x2 and ring 1x2 at PAM
     (T=600, hd 42), 3 steps at B=128, dropout 0, against the one-rank
     dense step at the JAX package's mesh tolerances (loss rtol 2e-4;
     logits and parameters rtol 1e-3, atol 1e-4) and the first step's
     gradient at TWO_RANK_TOL; (b) at dropout 0.2 SP 1x2 against ring 1x2
     and against SP on make_mesh(1, 1), the same limits; (c) PAM at
     max_len 2048 through ring 1x2 against SP 1x2, one step and a predict
     at B=32 (a cut: the 128-row scores of a 2048-step window are 4 GB a
     tensor), dropout 0.2; (d) the pipeline 1x2 at P12, 2 microbatches,
     against the one-rank dense step, then at dropout 0.2 finite with a
     falling loss on a fixed batch; (e) edge partitioning 1x2 at P12
     (1296 edges) against the one-rank packed step in bf16, the first
     step at TWO_RANK_BF16_TOL, flash_mha_packed launched forward and
     backward on every rank, all on the tensor cores; every error and
     step ms printed, the ranks bit-equal;
 28. torchrun_cli_phase: the CLI through torchrun (one process, NCCL,
     --distributed true --data-parallel 1), P12 for 1 epoch from dataset
     files written from --seed;
 29. wide_head_phase, attention past head dim 368 (routes "tc_cluster" in
     bf16, "hd_stream" in f32): flash_mha_packed at hd 372, 720 and 1023
     (B=8, T=215) and flash_mha at hd 720 and 1024 on T=600 and 2048 (B=8),
     forward and backward, f32 and bf16, dropout 0 and 0.2, against the
     plain versions, every launch on its dtype's route, a bf16 repeat
     bit-equal; impl="hd_stream" at hd 360 bit-equal to the scalar Wide
     kernels; the clusters the card holds at once; P12-sw at one head (hd
     720) served at buckets 1, 8, 32 and 128 and trained 3 steps (B=128),
     with f32 attention operands (every packed launch on "hd_stream") and
     with compute_dtype='bfloat16' (on "tc_cluster"), served probabilities
     and the first step's loss and gradient norm held to the plain path
     (1e-4 f32, 2e-2 bf16); in bf16 the new route timed in turns with the
     previous design (impl="hd_stream") at that shape and at T=2048 beside
     the plain versions and SDPA (its backend named); the public op
     flash_mha through autograd at hd 720 and 1024 in bf16 and f32;
 30. big_batch_phase: every kernel row at B=70000 (two launches a call, the
     second at sample origin 65535), dropout 0.2 where the op has it, f32
     and bf16: flash_mha_packed, flash_mha (and 70000 heads), the fused
     layer at PAM's width, spmm_segment_softmax and sddmm, against the plain
     versions (so the masks past sample 65535 are compared);
 31. fused_wide_phase, the fused layer past the widths its tile-resident
     routes take (route "stream"): P12-sw on a 600-step window (d 720, ffn
     288) at 2 heads (hd 360) and at 1 (hd 720, its attention on
     "tc_cluster" in bf16, "hd_stream" in f32), B=128, f32 and bf16: phases
     3 and 6 there (dropout 0.2
     in 6), then the model served at buckets 1-128 and trained 3 steps at
     B=128 with f32 attention operands and in bf16 compute, served
     probabilities and the first step against the plain path (1e-4 / 2e-2),
     and the CLI for one epoch of one split on 256 synthetic samples; every
     fused launch counted on "stream", the one-head bf16 model's on
     "tc_cluster" too.

Every phase's seconds are printed as `[phase] name: s` and kept under
"phase_s" in the --out file.

Times are CUDA-event means over repeated launches after a warm-up. Bounds
use the H100 SXM data-sheet peaks (3.35 TB/s; 67 TFLOP/s f32 outside the
tensor cores, 989 TFLOP/s dense bf16); the card's power limit is printed
beside them. Outputs are held to max_abs_err 1e-4 with f32 operands
(another summation order) and 2e-2 with bf16 operands. The attention
kernels' gradients, flash_mha's o, and the fused layer's out, attn and dx
are held sample by sample to SAMPLE_TOL (1e-5 f32, 5e-3 bf16) of each
sample's largest plain value (sample_err); the fused layer's weight
gradients, sums over every row, to TOL relative to max(1, the plain
gradient's largest value), its plain backward taking the kernel's relu
branches (fused_bwd_phase says why). The sparse-graph kernels are
f32 throughout and are held to 1e-5 relative to max(1, |plain|).
The line before the last is the kernels' JSON record (thirty-three
records: twelve kernels at the main paths' shapes, the packed pair and the
fused layer again at the sensor-wise widths, the fused layer's three
attention launchers on "tc_wide" at PAM-sw, flash_mha forward and
backward at PAM-sw-2048's hd 170, both ops' forward and backward on
"tc_cluster" and on "hd_stream" past hd 368, and the fused layer's forward
and backward on "stream" at P12-sw T=600 (phase 31), rows 1-11 with the
launches of their B=70000
call under "big_batch_launches"; the fused layer's list the CUDA kernels
of its tensor-core route and of the previous design, and its launches, and
flash_mha's, are the tensor-core ones; rows 1 and 2 also carry the
baseline families' launches and the errors at their head dims, and rows
1-3 the launches of phases 14h and 14i under "import_launches", rows 1-4
those of phase 26 under "mesh_launches", rows 1-2 the TP run's of phase
27 a rank under "tp_launches_a_rank", the bf16 TP run's tensor-core
launches a rank under "tp_bf16_tc_launches_a_rank" and the edge
partitioning run's of phase 27a under "edge_partition_tc_launches_a_rank"),
the last line the result. `--out PATH` also
writes every number to PATH as JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# sample_err's limits for the attention kernels' gradients (and
# flash_mha's o), f32 / bf16 operands. The largest readings on an H100,
# here and in chip_ab.py's task sample_err (the card tests' inputs):
# gradients 1.1e-6 / 4.4e-3 (flash_mha's dq at T=600, hd 42, B=128,
# dropout 0, on the tensor-core route, against the plain version and the
# scalar kernels alike; flash_mha_packed's dv at P12-sw 3.8e-3), o 2.3e-6 /
# 2.6e-3. chip_ab.py's task ds_rounding traces the 4.4e-3 to the tensor
# cores' f32 accumulation: the plain backward run on cuBLAS's TF32
# tensor-core kernels reads the same against an f64 evaluation, the f32
# evaluation 9.4e-4.
SAMPLE_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def attention_bytes(lengths, T, d, H, esize, backward=False) -> float:
    """Bytes an attention kernel must move over [B, T, d] operands: q (and
    do) of the samples with a live key, k and v below each length only (the
    kernels never read past it), the f32 outputs over all of T (o; or dq,
    dk and dv), the backward's f32 o of the live samples (its delta is
    summed from do and o), the [B, H, T] f32 lse (written for every sample,
    read for the live ones) and the lengths."""
    B = lengths.numel()
    live, keys = int((lengths > 0).sum()), float(lengths.sum())
    if backward:
        return (2 * live * T * d * esize + 2 * keys * d * esize + live * T * d * 4
                + 3 * B * T * d * 4 + live * H * T * 4 + B * 4)
    return live * T * d * esize + 2 * keys * d * esize + B * T * d * 4 + B * H * T * 4 + B * 4


def ragged_lengths(gen, B, T, device):
    import torch

    lengths = torch.randint(0, T + 1, (B,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[2] = 0, 1, T
    return lengths


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def time_designs(run, dtype, reps=20, previous=True):
    """Times of run(impl): the plan's route ("auto") and, in bf16, the
    previous design (the scalar kernels, "scalar"), timed in turns scalar,
    tc, tc, scalar so that the card's clocks favour neither. f32 takes the
    scalar route either way, and where no previous design takes the width
    (previous=False: the "stream" route) there is none to time: prev_ms is
    None. ms are CUDA-event means over `reps` calls; device_ms the
    profiler's device time of a call (the kernels alone, without the
    host's gaps between launches)."""
    if dtype != "bfloat16" or not previous:
        return dict(ms=time_ms(lambda: run("auto"), reps), prev_ms=None,
                    device_ms=device_ms(lambda: run("auto")), prev_device_ms=None)
    t = {"auto": [], "scalar": []}
    for impl in ("scalar", "auto", "auto", "scalar"):
        t[impl].append(time_ms(lambda: run(impl), reps))
    return dict(ms=sum(t["auto"]) / 2, prev_ms=sum(t["scalar"]) / 2,
                device_ms=device_ms(lambda: run("auto")),
                prev_device_ms=device_ms(lambda: run("scalar")))


def device_ms(fn, reps=20) -> float:
    """Device time of one fn() call by torch.profiler, after a warm-up."""
    fn()
    return profile_device(lambda: [fn() for _ in range(reps)], reps)[1]


def device_line(times) -> str:
    parts = [f"kernel {times['device_ms']:.4f} ms"]
    if times["prev_device_ms"] is not None:
        parts.append(f"previous design {times['prev_device_ms']:.4f} ms")
    parts.append(f"library {times['library_device_ms']:.4f} ms")
    return ", ".join(parts)


def design_line(ms, prev_ms, bound_ms) -> str:
    """The shares of the bound, and the previous design's time beside."""
    line = f"{bound_ms / ms:.1%} of the bound"
    if prev_ms is not None:
        line += (f"; previous design {prev_ms:.4f} ms ({bound_ms / prev_ms:.1%} of "
                 f"the bound, {prev_ms / ms:.2f}x)")
    return line


@contextlib.contextmanager
def phase(seconds, name):
    """Time one phase of main by the host clock: print its seconds and keep
    them in the dict `seconds` under `name`."""
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0
    print(f"[phase] {name}: {seconds[name]:.1f} s", flush=True)


# ----------------------------------------------------------------- kernels
def flash_phase(label, B, T, d, H, dtype, device="cuda", seed=0):
    """Kernel vs plain for flash_mha_packed's forward at one shape."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, T, d), generator=gen, device=device)
               for _ in range(3))
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    o_k, lse_k = fa._packed_fwd(q, k, v, lengths, None, 0.0, cd, H)
    o_k2, lse_k2 = fa._packed_fwd(q, k, v, lengths, None, 0.0, cd, H)
    o_p, lse_p = fa._packed_fwd_plain(q, k, v, lengths, H, od)
    torch.cuda.synchronize()
    route = fa.packed_plan(B, T, d, H, od).route
    err = max(max_err(o_k, o_p), max_err(lse_k, lse_p))
    ok = err <= TOL[dtype] and bool(torch.isfinite(o_k).all())
    print(f"[flash] {label} {dtype} B={B} T={T} d={d} H={H} ({route} route): "
          f"max_abs_err {err:.3e} (tol {TOL[dtype]:g})", flush=True)
    if not ok:
        raise AssertionError(f"flash_mha_packed kernel disagrees at {label} {dtype}")
    if not (torch.equal(o_k, o_k2) and torch.equal(lse_k, lse_k2)):
        raise AssertionError(f"flash forward not bit-equal on a repeat at {label} {dtype}")
    if not (bool((o_k[0] == 0).all()) and bool((lse_k[0] == fa.NEG_INF).all())):
        raise AssertionError(f"flash forward: the length-0 sample is not zero at {label}")
    # a sample's bits do not depend on the batch it is launched in
    o_s, lse_s = fa._packed_fwd(q[:8], k[:8], v[:8], lengths[:8], None, 0.0, cd, H)
    if not (torch.equal(o_s, o_k[:8]) and torch.equal(lse_s, lse_k[:8])):
        raise AssertionError(f"flash forward: 8 samples alone differ from the same "
                             f"samples in a batch of {B} at {label} {dtype}")
    vs_prev = None
    if dtype == "bfloat16":       # the plan's route against the previous design
        o_v, lse_v = fa._packed_fwd_cuda(q, k, v, lengths, 0, 0.0, H, od, "scalar")
        vs_prev = max(max_err(o_k, o_v), max_err(lse_k, lse_v))
        print(f"[flash] {label} {dtype}: against the scalar kernels max_abs_err "
              f"{vs_prev:.3e} (tol {TOL[dtype]:g}); o sample_err against the plain "
              f"version {sample_err(o_k, o_p, lengths):.3e}", flush=True)
        if vs_prev > TOL[dtype]:
            raise AssertionError(f"flash forward disagrees with the scalar kernels at "
                                 f"{label}")

    # inputs already in the operand dtype, so the timed call is the launch
    qo, ko, vo = (x.to(od) for x in (q, k, v))
    times = time_designs(
        lambda impl: fa._packed_fwd_cuda(qo, ko, vo, lengths, 0, 0.0, H, od, impl), dtype)
    ms, prev_ms = times["ms"], times["prev_ms"]
    plain_ms = time_ms(lambda: fa._packed_fwd_plain(qo, ko, vo, lengths, H, od))
    live = lengths > 0
    hd = d // H
    qh, kh, vh = (x[live].reshape(-1, T, H, hd).transpose(1, 2).contiguous()
                  for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep))
    times["library_device_ms"] = device_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep))
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = attention_bytes(lengths, T, d, H, esize)
    flops = 4.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    print(f"[flash] {label} {dtype}: kernel {ms:.4f} ms, {design_line(ms, prev_ms, bound_ms)}, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); device time {device_line(times)}", flush=True)
    return dict(label=label, dtype=dtype, route=route, max_abs_err=err,
                vs_prev_max_abs_err=vs_prev, **times, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)


def random_layer(gen, d, ffn, device):
    """A layer dict like nn/transformer._layer_init's, with every bias and
    LayerNorm parameter random so the kernels' use of each is checked."""
    import torch
    from raindrop_tpu_torch.nn.transformer import _layer_init

    p = _layer_init(gen, d, ffn, device)

    def r(n, base=0.0):
        return base + 0.1 * torch.randn((n,), generator=gen, device=device)

    p["in_proj_b"] = r(3 * d)
    p["out_proj"]["b"] = r(d)
    p["ln1"] = {"scale": r(d, 1.0), "bias": r(d)}
    p["ln2"] = {"scale": r(d, 1.0), "bias": r(d)}
    return p


def fused_phase(label, B, T, d, ffn, H, dtype, device="cuda", seed=0):
    """Kernel vs plain for fused_encoder_layer's forward at one shape: out
    and attn held sample by sample (sample_err) to SAMPLE_TOL, lse to TOL;
    in bf16 the tensor-core route timed in turns with the previous design
    (the scalar kernels)."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    x = torch.randn((B, T, d), generator=gen, device=device)
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    plan = fe.fused_plan(d, ffn, H, od)
    got = fe._fused_fwd(p, x, lengths, None, 0.0, cd, H)
    again = fe._fused_fwd(p, x, lengths, None, 0.0, cd, H)
    want = fe._fused_fwd_plain(p, x, lengths, H, od)
    torch.cuda.synchronize()
    errs = {"out": sample_err(got[0], want[0], lengths),
            "attn": sample_err(got[1], want[1], lengths),
            "lse": max_err(got[2], want[2])}
    err = max(max_err(a, b) for a, b in zip(got, want))
    print(f"[fused] {label} {dtype} B={B} T={T} d={d} ffn={ffn} H={H} ({plan.route} "
          f"route, attention {plan.attn_route}): sample_err out {errs['out']:.3e}, attn "
          f"{errs['attn']:.3e} (tol {SAMPLE_TOL[dtype]:g}), lse max_abs_err "
          f"{errs['lse']:.3e} (tol {TOL[dtype]:g}); max_abs_err {err:.3e}", flush=True)
    if (max(errs["out"], errs["attn"]) > SAMPLE_TOL[dtype] or errs["lse"] > TOL[dtype]
            or not bool(torch.isfinite(got[0]).all())):
        raise AssertionError(f"fused_encoder_layer kernel disagrees at {label} {dtype}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"fused forward not bit-equal on a repeat at {label} {dtype}")
    # the length-0 sample attends to nothing: attention output 0, lse NEG_INF
    if not (bool((got[1][0] == 0).all()) and bool((got[2][0] == -1e30).all())):
        raise AssertionError(f"fused forward: the length-0 sample's attention is not "
                             f"zero at {label}")
    alone = fe._fused_fwd(p, x[:8], lengths[:8], None, 0.0, cd, H)
    if not all(torch.equal(a, b[:8]) for a, b in zip(alone, got)):
        raise AssertionError(f"fused forward: 8 samples alone differ from the same "
                             f"samples in a batch of {B} at {label} {dtype}")

    ws = fe._flatten(p)
    times = time_designs(
        lambda impl: fe._fused_fwd_cuda(ws, x, lengths, 0, 0.0, H, od, impl), dtype,
        previous=plan.route != "stream")
    ms, prev_ms = times["ms"], times["prev_ms"]
    plain_ms = time_ms(lambda: fe._fused_fwd_plain(p, x, lengths, H, od))
    layer = torch.nn.TransformerEncoderLayer(
        d, H, ffn, dropout=0.0, batch_first=True, device=device).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(p["in_proj_w"])
        layer.self_attn.in_proj_bias.copy_(p["in_proj_b"])
        layer.self_attn.out_proj.weight.copy_(p["out_proj"]["w"])
        layer.self_attn.out_proj.bias.copy_(p["out_proj"]["b"])
        for mod, key in ((layer.linear1, "lin1"), (layer.linear2, "lin2")):
            mod.weight.copy_(p[key]["w"])
            mod.bias.copy_(p[key]["b"])
        for mod, key in ((layer.norm1, "ln1"), (layer.norm2, "ln2")):
            mod.weight.copy_(p[key]["scale"])
            mod.bias.copy_(p[key]["bias"])
    live = lengths > 0
    xl = x[live].to(od)
    layer = layer.to(od)
    pad = (torch.arange(T, device=device)[None, :] >= lengths[live][:, None])
    with torch.no_grad():
        library_ms = time_ms(lambda: layer(xl, src_key_padding_mask=pad))
        times["library_device_ms"] = device_ms(lambda: layer(xl, src_key_padding_mask=pad))
    hd = d // H
    esize = 2 if dtype == "bfloat16" else 4
    weights = (4 * d * d + 2 * d * ffn) * esize + (3 * d + 6 * d + ffn) * 4
    nbytes = B * T * d * 4 * 3 + B * H * T * 4 + B * 4 + weights
    dense = 2.0 * B * T * (3 * d * d + d * d + 2 * d * ffn)
    flops = dense + 4.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    # the qkv intermediate A writes and B reads back (bf16 where the
    # attention runs on the tensor cores)
    qkv_bytes = 2 * B * T * 3 * d * (
        2 if plan.attn_route in ("tc", "tc_wide", "tc_cluster") else 4)
    print(f"[fused] {label} {dtype}: kernel {ms:.4f} ms, {design_line(ms, prev_ms, bound_ms)}, "
          f"plain {plain_ms:.4f} ms, TransformerEncoderLayer {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); device time {device_line(times)}; qkv round "
          f"trip {qkv_bytes / 1e6:.1f} MB", flush=True)
    return dict(label=label, dtype=dtype, route=plan.route, attn_route=plan.attn_route,
                max_abs_err=err, errs=errs, **times, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, qkv_roundtrip_bytes=qkv_bytes)


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1.0))


def sample_err(got, want, lengths) -> float:
    """An attention output or gradient [B, ...] against its plain version,
    sample by sample: the largest max |got - want| over that sample's max
    |want|. A sample of length 0 or 1 is held to the largest max |want| of
    all: with one key p = 1, so its dq and dk are rounding noise about 0
    (and its dv the sum of T rows of do, which would set the scale of
    every sample if the scale were one max over the batch)."""
    import torch

    B = got.shape[0]
    diff = (got.float() - want.float()).abs().reshape(B, -1).amax(1)
    scale = want.float().abs().reshape(B, -1).amax(1)
    scale = torch.where(lengths.to(scale.device) > 1, scale, scale.max())
    return float((diff / scale.clamp(min=torch.finfo(torch.float32).tiny)).max())


SEED = 20231


def flash_bwd_phase(label, B, T, d, H, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for flash_mha_packed's forward with dropout and its
    backward at one shape."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device=device)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    o_k, lse_k = fa._packed_fwd(q, k, v, lengths, SEED, rate, cd, H)
    o_p, lse_p = fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, rate)
    fwd_err = max(max_err(o_k, o_p), max_err(lse_k, lse_p))
    args = (q, k, v, lengths, SEED, rate, H, od, o_k, lse_k, g)
    got = fa._packed_bwd_cuda(*args)
    again = fa._packed_bwd_cuda(*args)
    want = fa._packed_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {n: sample_err(a, b, lengths) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    err = max(errs.values())
    print(f"[flash_bwd] {label} {dtype} dropout {rate}: forward max_abs_err "
          f"{fwd_err:.3e} (tol {TOL[dtype]:g}), gradients sample_err {errs} (tol "
          f"{SAMPLE_TOL[dtype]:g})", flush=True)
    if fwd_err > TOL[dtype] or err > SAMPLE_TOL[dtype]:
        raise AssertionError(f"flash_mha_packed backward disagrees at {label} {dtype}")
    for a, a2 in zip(got, again):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"flash backward not finite or not bit-equal "
                                 f"on a repeat at {label} {dtype}")
        if not bool((a[0] == 0).all()):
            raise AssertionError("flash backward: the length-0 sample is not zero")
    alone = fa._packed_bwd_cuda(*(x[:8] for x in args[:4]), *args[4:8],
                                *(x[:8] for x in args[8:]))
    if not all(torch.equal(a, b[:8]) for a, b in zip(alone, got)):
        raise AssertionError(f"flash backward: 8 samples alone differ from the same "
                             f"samples in a batch of {B} at {label} {dtype}")
    if dtype == "bfloat16":       # the plan's route against the previous design
        prev = fa._packed_bwd_cuda(*args, "scalar")
        errs.update({f"{n}_vs_prev": sample_err(a, b, lengths)
                     for n, a, b in zip(("dq", "dk", "dv"), got, prev)})
        print(f"[flash_bwd] {label} {dtype} dropout {rate}: against the scalar kernels "
              f"sample_err {errs} (tol {SAMPLE_TOL[dtype]:g})", flush=True)
        if max(errs.values()) > SAMPLE_TOL[dtype]:
            raise AssertionError(f"flash backward disagrees with the scalar kernels at "
                                 f"{label} {dtype}")

    qo, ko, vo = (x.to(od) for x in (q, k, v))
    targs = (qo, ko, vo, lengths, SEED, rate, H, od, o_k, lse_k, g)
    times = time_designs(lambda impl: fa._packed_bwd_cuda(*targs, impl), dtype)
    ms, prev_ms = times["ms"], times["prev_ms"]
    plain_ms = time_ms(lambda: fa._packed_bwd_plain(*targs), reps=5, warmup=1)
    live = lengths > 0
    hd = d // H
    qh, kh, vh = (x[live].reshape(-1, T, H, hd).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=keep, dropout_p=rate)
    gh = g[live].to(od).reshape(-1, T, H, hd).transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                     retain_graph=True))
    times["library_device_ms"] = device_ms(
        lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True))
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = attention_bytes(lengths, T, d, H, esize, backward=True)
    flops = 10.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    print(f"[flash_bwd] {label} {dtype} dropout {rate}: kernels {ms:.4f} ms, "
          f"{design_line(ms, prev_ms, bound_ms)}, plain {plain_ms:.4f} ms, sdpa backward "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); device time "
          f"{device_line(times)}", flush=True)
    return dict(label=label, dtype=dtype, rate=rate, max_abs_err=err,
                fwd_max_abs_err=fwd_err, errs=errs, **times, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)


def flash_edge_phase(hd, T, rate, B=4, H=2, device="cuda", seed=0):
    """flash_mha_packed in bf16 at an edge shape (head dims 3, 8, 13, 42,
    84, 128, and 129-368 of the sensor-wise widths; T = 64, 65, 1024): the
    plan's route (the tensor-core kernels on one warpgroup up to hd_pad 144,
    on two beyond) against the plain version and against the scalar
    kernels, forward and backward, bit-equal on a repeat, exact zeros for
    the length-0 sample."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    d, od, tol = H * hd, torch.bfloat16, TOL["bfloat16"]
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device=device)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)
    plan = fa.packed_plan(B, T, d, H, od)
    fwd = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, H, od)
    fwd2 = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, H, od)
    prev = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, H, od, "scalar")
    plain = fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, rate)
    args = (q, k, v, lengths, SEED, rate, H, od, *fwd, g)
    got = fa._packed_bwd_cuda(*args)
    again = fa._packed_bwd_cuda(*args)
    prev_b = fa._packed_bwd_cuda(*args, "scalar")
    plain_b = fa._packed_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = {"fwd_vs_plain": max(max_err(a, b) for a, b in zip(fwd, plain)),
            "fwd_vs_prev": max(max_err(a, b) for a, b in zip(fwd, prev)),
            "bwd_vs_plain": max(sample_err(a, b, lengths) for a, b in zip(got, plain_b)),
            "bwd_vs_prev": max(sample_err(a, b, lengths) for a, b in zip(got, prev_b))}
    limits = {"fwd_vs_plain": tol, "fwd_vs_prev": tol,
              "bwd_vs_plain": SAMPLE_TOL["bfloat16"], "bwd_vs_prev": SAMPLE_TOL["bfloat16"]}
    print(f"[flash_edge] hd={hd} T={T} dropout {rate} ({plan.route} route, copy "
          f"{plan.copy_bytes} B, hd padded {plan.hd_pad}, {plan.rows}-row blocks): "
          f"{errs} (limits {limits})", flush=True)
    if any(errs[n] > limits[n] for n in errs):
        raise AssertionError(f"flash_mha_packed tc kernels disagree at hd={hd} T={T}")
    want = "tc" if -(-hd // 16) * 16 <= fa.TC_MAX_HD_PAD else "tc_wide"
    if plan.route != want:
        raise AssertionError(f"flash_mha_packed bf16 at hd={hd} took the {plan.route} "
                             f"route, expected {want}")
    for a, a2 in zip((*fwd, *got), (*fwd2, *again)):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"flash tc kernels not finite or not bit-equal on a "
                                 f"repeat at hd={hd} T={T}")
    zero = [fwd[0][0], *(x[0] for x in got)]
    if not all(bool((z == 0).all()) for z in zero) or not bool((fwd[1][0] == fa.NEG_INF).all()):
        raise AssertionError(f"flash tc kernels: the length-0 sample is not zero at "
                             f"hd={hd} T={T}")
    return dict(hd=hd, T=T, rate=rate, route=plan.route, copy_bytes=plan.copy_bytes,
                **errs)


# the tensor-core kernel families of each library whose SASS must hold
# HGMMA (wgmma): the attention's three on one warpgroup and three on two
# (past hd_pad 144), which flash_mha_packed and flash_mha both launch and,
# on the fused layer's bf16 route, every row
# product (qkv, the forward's tail, the backward's row kernel, dx, the
# weight gradients) and the attention on one warpgroup (PAM's head dim) and
# on two (PAM-sw's), and the "stream" route's bf16 products
SASS_FAMILIES = {
    "flash_packed": ("packed_fwd_tc", "packed_dq_tc", "packed_dkv_tc",
                     "packed_fwd_wide", "packed_dq_wide", "packed_dkv_wide",
                     "packed_fwd_tcc", "packed_dq_tcc", "packed_dkv_tcc"),
    "fused_encoder": ("qkv_rows_tc_kernel", "layer_tail_tc", "fused_attn_fwd_tc",
                      "fused_attn_fwd_wide", "stream_rows_tc", "packed_fwd_tcc"),
    "fused_encoder_bwd": ("qkv_rows_tc_kernel", "layer_bwd_rows_tc", "dx_rows_tc",
                          "wgrad_tc", "fused_dq_tc", "fused_dkv_tc", "fused_dq_wide",
                          "fused_dkv_wide", "stream_rows_tc", "packed_dq_tcc",
                          "packed_dkv_tcc"),
}


# the CUDA kernels a fused-layer call launches on the bf16 tensor-core route
# (the kernels' JSON record lists them beside the wrapper's); the previous
# design's, timed in turns with them as prev_ms, stay on the f32 route
FUSED_FWD_KERNELS = {
    "sources_also": ["raindrop_tpu_torch/csrc/rows_tc.cuh",
                     "raindrop_tpu_torch/csrc/fused_encoder_attn_tc.cu",
                     "raindrop_tpu_torch/csrc/attention_tc.cuh",
                     "raindrop_tpu_torch/csrc/fused_encoder_attn_wide.cu",
                     "raindrop_tpu_torch/csrc/attention_tc_wide.cuh"],
    "kernels_tc": ["pack_weights_kernel", "qkv_rows_tc_kernel",
                   "fused_attn_fwd_tc (hd_pad <= 144; fused_attn_fwd_wide beyond)",
                   "layer_tail_tc"],
    "kernels_previous": ["qkv_rows_kernel", "attn_rows_kernel", "layer_tail_kernel"]}
FUSED_BWD_KERNELS = {
    "sources_also": ["raindrop_tpu_torch/csrc/rows_tc.cuh",
                     "raindrop_tpu_torch/csrc/fused_encoder_dq_tc.cu",
                     "raindrop_tpu_torch/csrc/fused_encoder_dkv_tc.cu",
                     "raindrop_tpu_torch/csrc/attention_tc.cuh",
                     "raindrop_tpu_torch/csrc/fused_encoder_dq_wide.cu",
                     "raindrop_tpu_torch/csrc/fused_encoder_dkv_wide.cu",
                     "raindrop_tpu_torch/csrc/attention_tc_wide.cuh"],
    "kernels_tc": ["pack_weights_kernel", "qkv_rows_tc_kernel", "layer_bwd_rows_tc",
                   "fused_dq_tc, fused_dkv_tc (hd_pad <= 144; fused_dq_wide, "
                   "fused_dkv_wide beyond)", "dx_rows_tc", "wgrad_tc",
                   "reduce_kernel"],
    "kernels_previous": ["qkv_rows_kernel", "layer_bwd_rows_kernel", "fused_dq_kernel",
                         "fused_dkv_kernel", "dx_rows_kernel", "wgrad_kernel",
                         "reduce_kernel"]}


def sass_phase():
    """Count the tensor-core instructions in the built libraries (cuobjdump
    -sass): HGMMA (wgmma) and HMMA (mma.sync) per kernel family. Fails when
    a kernel of SASS_FAMILIES has none; without cuobjdump on the machine it
    says so and checks nothing."""
    import re
    import shutil
    from raindrop_tpu_torch.kernels import build

    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("[sass] cuobjdump is not on this machine: the SASS check did not run",
              flush=True)
        return None
    out_counts = {}
    procs = {}
    tmp = tempfile.TemporaryDirectory()
    # one cuobjdump a library, all at once, each into a file (a pipe would
    # stall the others until its reader came)
    for name in SASS_FAMILIES:
        build.load(name)
        with open(os.path.join(tmp.name, name), "w") as sink:
            procs[name] = subprocess.Popen([tool, "-sass", str(build._lib_path(name))],
                                           stdout=sink)
    try:
        for name, families in SASS_FAMILIES.items():
            lib = str(build._lib_path(name))
            if procs[name].wait(timeout=300) != 0:
                raise RuntimeError(f"cuobjdump -sass failed on {lib}")
            with open(os.path.join(tmp.name, name)) as f:
                out = f.read()
            alts = [r"packed_\w+?_(?:tcc|tc|wide|kernel)"] + [f for f in families
                                                      if not f.startswith("packed")]
            pattern = re.compile(r"Function : \S*?(" + "|".join(alts) + ")")
            counts, fam = {}, None
            # the regular expressions only on the lines that can match them
            # (a dump holds millions of lines)
            for line in out.splitlines():
                if "Function : " in line:
                    m = pattern.search(line)
                    fam = None
                    if m:
                        fam = counts.setdefault(m.group(1),
                                                {"functions": 0, "HGMMA": 0, "HMMA": 0})
                        fam["functions"] += 1
                elif fam is not None and "MMA" in line:
                    for op in ("HGMMA", "HMMA"):
                        if re.search(rf"\b{op}\.", line):
                            fam[op] += 1
            print(f"[sass] {os.path.basename(lib)}: {counts}", flush=True)
            for fam_name in families:
                if counts.get(fam_name, {}).get("HGMMA", 0) <= 0:
                    raise AssertionError(f"no HGMMA instruction in {fam_name} ({name}): "
                                         f"{counts.get(fam_name)}")
            out_counts[name] = counts
    finally:                        # no dump outlives the phase
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    return out_counts


def fused_bwd_phase(label, B, T, d, ffn, H, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for fused_encoder_layer's forward with dropout and
    its backward at one shape: dx held sample by sample (sample_err) to
    SAMPLE_TOL, the 12 weight gradients (sums over every row) to TOL
    relative to max(1, the plain gradient's largest value); in bf16 the
    tensor-core route timed in turns with the previous design."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    x, g = (torch.randn((B, T, d), generator=gen, device=device) for _ in range(2))
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    plan = fe.fused_plan(d, ffn, H, od)
    fwd_k = fe._fused_fwd(p, x, lengths, SEED, rate, cd, H)
    fwd_p = fe._fused_fwd_plain(p, x, lengths, H, od, SEED, rate)
    fwd_err = max(sample_err(fwd_k[0], fwd_p[0], lengths),
                  sample_err(fwd_k[1], fwd_p[1], lengths))
    lse_err = max_err(fwd_k[2], fwd_p[2])
    _, attn, lse = fwd_k
    ws = fe._flatten(p)
    args = (x, lengths, SEED, rate, H, od, attn, lse, g)
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, *args, scratch_out=scratch)
    dx2, dws2 = fe._fused_bwd_cuda(ws, *args)
    # The layer has a relu. A pre-activation within rounding of zero can
    # fall on either side in the kernel and in the plain version, and the
    # branch moves single gradient elements by O(1) whatever the
    # arithmetic's precision (at this shape about one of 10.4 million
    # elements does). So the plain backward is given the kernel's branches,
    # which makes the comparison one of arithmetic; the branches themselves
    # are held to differ only where the plain pre-activation is within the
    # tolerance of zero, and so for no more than that share of the elements.
    ffn_on = scratch["f"].reshape(B, T, ffn) > 0
    if not bool((scratch["dqkv"].reshape(B, T, 3 * d)[0] == 0).all()):
        raise AssertionError(f"fused backward: the length-0 sample's attention "
                             f"gradient is not zero at {label} {dtype}")
    scratch.clear()
    f_pre = fe._recompute(
        p, x, fwd_p[1], lambda t: t.to(od).to(torch.float32),
        fe._site_keeps(SEED, rate, B, T, d, ffn, device))[4]
    if rate > 0.0:
        kept = fe._site_keep(SEED, B, fe.SITE_FFN_MID, T, ffn, rate, device)
    else:
        kept = torch.ones_like(ffn_on)
    flips = ffn_on != ((f_pre > 0) & kept)
    n_flips = int(flips.sum())
    flip_pre = float(f_pre[flips].abs().max()) if n_flips else 0.0
    del f_pre, kept
    pdx, pdws = fe._fused_bwd_plain(p, *args, relu_on=ffn_on)
    torch.cuda.synchronize()
    names = ["/".join(path) for path in fe._WEIGHTS]
    errs = {"dx": sample_err(dx, pdx, lengths)}
    errs.update({n: rel_err(a, b) for n, a, b in zip(names, dws, pdws)})
    werr = max(errs[n] for n in names)
    err = max(max_err(a, b) for a, b in zip([dx, *dws], [pdx, *pdws]))
    print(f"[fused_bwd] {label} {dtype} dropout {rate} ({plan.route} route, attention "
          f"{plan.attn_route}): forward sample_err {fwd_err:.3e}, lse {lse_err:.3e}; dx "
          f"sample_err {errs['dx']:.3e} (tol {SAMPLE_TOL[dtype]:g}), weight gradients rel "
          f"err {werr:.3e} (tol {TOL[dtype]:g}) {errs}; relu branches that differ from the "
          f"plain version's: {n_flips} of {flips.numel()}, largest |pre-activation| "
          f"among them {flip_pre:.3e}", flush=True)
    if (fwd_err > SAMPLE_TOL[dtype] or lse_err > TOL[dtype]
            or errs["dx"] > SAMPLE_TOL[dtype] or werr > TOL[dtype]
            or flip_pre > TOL[dtype] or n_flips > TOL[dtype] * flips.numel()):
        raise AssertionError(f"fused_encoder_layer backward disagrees at {label} {dtype}")
    for name, a, a2 in zip(["dx"] + names, [dx, *dws], [dx2, *dws2]):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"fused backward {name} not finite or not "
                                 f"bit-equal on a repeat at {label} {dtype}")
    del pdx, pdws, fwd_p

    times = time_designs(lambda impl: fe._fused_bwd_cuda(ws, *args, impl=impl), dtype,
                         reps=10, previous=plan.route != "stream")
    ms, prev_ms = times["ms"], times["prev_ms"]
    plain_ms = time_ms(lambda: fe._fused_bwd_plain(p, *args), reps=3, warmup=1)
    layer = torch.nn.TransformerEncoderLayer(
        d, H, ffn, dropout=rate, batch_first=True, device=device, dtype=od).train()
    live = lengths > 0
    xl = x[live].to(od).requires_grad_()
    pad = (torch.arange(T, device=device)[None, :] >= lengths[live][:, None])
    out = layer(xl, src_key_padding_mask=pad)
    wrt = (xl, *layer.parameters())
    gl = g[live].to(od)
    library_ms = time_ms(lambda: torch.autograd.grad(out, wrt, gl, retain_graph=True),
                         reps=10, warmup=2)
    times["library_device_ms"] = device_ms(
        lambda: torch.autograd.grad(out, wrt, gl, retain_graph=True), reps=10)
    hd = d // H
    esize = 2 if dtype == "bfloat16" else 4
    n_w = 4 * d * d + 2 * d * ffn
    n_v = 9 * d + ffn
    nbytes = (B * T * d * 4 * 4 + B * H * T * 4 + B * 4
              + n_w * esize + n_v * 4 + (n_w + n_v) * 4)
    # every forward product is recomputed and has two backward products;
    # the attention has five against the forward's two
    dense = 3 * 2.0 * B * T * (4 * d * d + 2 * d * ffn)
    flops = dense + 10.0 * T * hd * H * float(lengths.sum())
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    scratch = fe.bwd_scratch_floats(B, T, d, ffn, H, plan)
    scratch_mb = {k: 4 * n / 1e6 for k, n in scratch.items()}
    print(f"[fused_bwd] {label} {dtype} dropout {rate}: kernels {ms:.4f} ms, "
          f"{design_line(ms, prev_ms, bound_ms)}, plain {plain_ms:.4f} ms, "
          f"TransformerEncoderLayer backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); device time {device_line(times)}; intermediates in device "
          f"memory {sum(scratch_mb.values()):.1f} MB", flush=True)
    return dict(label=label, dtype=dtype, rate=rate, route=plan.route,
                attn_route=plan.attn_route, max_abs_err=err, fwd_sample_err=fwd_err,
                errs=errs, relu_flips=n_flips, **times, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, scratch_mb=scratch_mb)


def fused_edge_phase(label, d, ffn, H, dtype, rate, T=100, device="cuda", seed=0):
    """fused_encoder_layer at an edge shape: T = 100 ends 36 rows into a
    64-row tile, lengths 0, 1, 45 (inside a tile) and T; forward and
    backward against the plain version (out, attn and dx by sample_err,
    the weight gradients by rel_err; the plain backward takes the kernel's
    relu branches), in bf16 also against the previous design (the scalar
    kernels), bit-equal on a repeat, exact zeros for the length-0 sample."""
    import torch
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops.flash_attention import operand_dtype

    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    B = 4
    x, g = (torch.randn((B, T, d), generator=gen, device=device) for _ in range(2))
    lengths = torch.tensor([0, 1, 45, T], dtype=torch.int32, device=device)
    cd = None if dtype == "float32" else dtype
    od = operand_dtype(cd)
    plan = fe.fused_plan(d, ffn, H, od)
    ws = fe._flatten(p)
    fwd = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od)
    fwd2 = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od)
    plain = fe._fused_fwd_plain(p, x, lengths, H, od, SEED, rate)
    args = (x, lengths, SEED, rate, H, od, fwd[1], fwd[2], g)
    scratch = {}
    dx, dws = fe._fused_bwd_cuda(ws, *args, scratch_out=scratch)
    dx2, dws2 = fe._fused_bwd_cuda(ws, *args)
    pdx, pdws = fe._fused_bwd_plain(p, *args,
                                    relu_on=scratch["f"].reshape(B, T, ffn) > 0)
    errs = {"out": sample_err(fwd[0], plain[0], lengths),
            "attn": sample_err(fwd[1], plain[1], lengths),
            "dx": sample_err(dx, pdx, lengths),
            "weights": max(rel_err(a, b) for a, b in zip(dws, pdws))}
    limits = {"out": SAMPLE_TOL[dtype], "attn": SAMPLE_TOL[dtype],
              "dx": SAMPLE_TOL[dtype], "weights": TOL[dtype]}
    if dtype == "bfloat16":
        prev = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od, "scalar")
        pdx_s, pdws_s = fe._fused_bwd_cuda(ws, *args, impl="scalar")
        errs["out_vs_prev"] = sample_err(fwd[0], prev[0], lengths)
        errs["dx_vs_prev"] = sample_err(dx, pdx_s, lengths)
        errs["weights_vs_prev"] = max(rel_err(a, b) for a, b in zip(dws, pdws_s))
        limits.update(out_vs_prev=SAMPLE_TOL[dtype], dx_vs_prev=SAMPLE_TOL[dtype],
                      weights_vs_prev=TOL[dtype])
    torch.cuda.synchronize()
    print(f"[fused_edge] {label} {dtype} dropout {rate} T={T} lengths 0, 1, 45, {T} "
          f"({plan.route} route, attention {plan.attn_route}): {errs} (limits {limits})",
          flush=True)
    if any(errs[n] > limits[n] for n in errs):
        raise AssertionError(f"fused_encoder_layer disagrees at the edge shape {label} "
                             f"{dtype} dropout {rate}")
    for a, a2 in zip((*fwd, dx, *dws), (*fwd2, dx2, *dws2)):
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"fused layer not finite or not bit-equal on a repeat "
                                 f"at the edge shape {label} {dtype}")
    if not (bool((fwd[1][0] == 0).all()) and bool((fwd[2][0] == -1e30).all())
            and bool((scratch["dqkv"].reshape(B, T, 3 * d)[0] == 0).all())):
        raise AssertionError(f"fused layer: the length-0 sample's attention is not zero "
                             f"at the edge shape {label} {dtype}")
    return dict(label=label, dtype=dtype, rate=rate, T=T, route=plan.route,
                attn_route=plan.attn_route, **errs)


def fused_wide_attn_phase(label, B, T, d, ffn, H, rate, device="cuda", seed=0):
    """The fused layer's three attention launches on "tc_wide" (bf16, hd past
    hd_pad 144) held alone against the plain attention on the very operands
    they read: attn and lse of a forward against _packed_fwd_plain on the
    bf16 qkv of a backward (the same qkv launch on the same x: the same
    bits), and dq, dk, dv (the backward's dqkv) against _attention_bwd_plain
    on that qkv, its d_attn and delta and the forward's lse, by sample_err.
    Times: each launcher's device time within layer calls (torch.profiler,
    by kernel name), the plain attention's by events, SDPA's with a key
    mask (the forward; its backward computes dq, dk and dv in one call).
    Returns (forward, dq, dk/dv) records."""
    import math

    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa
    from raindrop_tpu_torch.ops import fused_encoder as fe

    od = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(seed)
    p = random_layer(gen, d, ffn, device)
    x, g = (torch.randn((B, T, d), generator=gen, device=device) for _ in range(2))
    lengths = ragged_lengths(gen, B, T, device)
    plan = fe.fused_plan(d, ffn, H, od)
    if plan.attn_route != "tc_wide":
        raise AssertionError(f"{label}: the fused attention took {plan.attn_route}, "
                             f"expected tc_wide")
    ws = fe._flatten(p)
    _, attn, lse = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od)
    scratch = {}
    fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, H, od, attn, lse, g, scratch_out=scratch)
    q, k, v = scratch["qkv"].reshape(B, T, 3 * d).float().split(d, dim=-1)
    d_attn = scratch["d_attn"].reshape(B, T, d).float()
    delta = scratch["delta"].reshape(B, H, T)
    dq, dk, dv = scratch["dqkv"].reshape(B, T, 3 * d).split(d, dim=-1)
    scratch.clear()
    scale = 1.0 / math.sqrt(d // H)
    want_o, want_lse = fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, rate)
    want_g = fa._attention_bwd_plain(q, k, v, d_attn, delta, lengths, SEED, rate, H, od,
                                     lse, scale)
    torch.cuda.synchronize()
    errs = {"attn": sample_err(attn, want_o, lengths), "lse": max_err(lse, want_lse)}
    errs.update({n: sample_err(a, b, lengths) for n, a, b in zip(("dq", "dk", "dv"),
                                                                 (dq, dk, dv), want_g)})
    abs_errs = {"fwd": max(max_err(attn, want_o), errs["lse"]),
                "dq": max_err(dq, want_g[0]),
                "dkv": max(max_err(dk, want_g[1]), max_err(dv, want_g[2]))}
    print(f"[fused_wide] {label} bf16 B={B} T={T} d={d} H={H} dropout {rate} "
          f"({plan['attn_fwd'].copy_bytes}-byte copies): sample_err "
          f"{errs} (tol {SAMPLE_TOL['bfloat16']:g}, lse max_abs_err tol "
          f"{TOL['bfloat16']:g}); max_abs_err {abs_errs}", flush=True)
    if (max(errs[n] for n in ("attn", "dq", "dk", "dv")) > SAMPLE_TOL["bfloat16"]
            or errs["lse"] > TOL["bfloat16"]):
        raise AssertionError(f"the fused layer's tc_wide attention disagrees with the "
                             f"plain attention at {label} dropout {rate}")
    del want_o, want_lse, want_g

    names = ("fused_attn_fwd_wide", "fused_dq_wide", "fused_dkv_wide")
    dev = {}
    for fn, reps in ((lambda: fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od), 10),
                     (lambda: fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, H, od, attn,
                                                 lse, g), 5)):
        fn()
        top = profile_device(lambda: [fn() for _ in range(reps)], reps)[3]
        dev.update({n: sum(ms for key, ms in top.items() if n in key) for n in names
                    if any(n in key for key in top)})
    if not all(dev.get(n, 0.0) > 0 for n in names):
        raise AssertionError(f"{label}: the profiler read no device time of a tc_wide "
                             f"launcher: {dev}")
    plain_ms = time_ms(lambda: fa._packed_fwd_plain(q, k, v, lengths, H, od, SEED, rate),
                       reps=3, warmup=1)
    bwd_plain_ms = time_ms(lambda: fa._attention_bwd_plain(
        q, k, v, d_attn, delta, lengths, SEED, rate, H, od, lse, scale), reps=2, warmup=1)
    live = lengths > 0
    hd = d // H

    def heads(t):
        return t[live].reshape(-1, T, H, hd).transpose(1, 2).to(od).contiguous()

    qh, kh, vh = (heads(t).requires_grad_() for t in (q, k, v))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep, dropout_p=rate))
    out = sdpa(qh, kh, vh, attn_mask=keep, dropout_p=rate)
    gh = heads(d_attn)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                         retain_graph=True), reps=10)
    del out, qh, kh, vh, gh
    n_live, keys = int(live.sum()), float(lengths.sum())
    # bytes each launch must move: its bf16 inputs once (q and dO over the
    # live samples' T rows, k and v below each length), lse and delta, its
    # f32 outputs over all of T; operations: 2 hd per (query, live key)
    # pair of a head for each product it needs, two in the forward (S, PV),
    # three for dq (S, dP, dQ), four for dk/dv (S, dP, dV, dK)
    stats = n_live * H * T * 4
    fwd_bytes = attention_bytes(lengths, T, d, H, 2)
    dq_bytes = 2 * n_live * T * d * 2 + 2 * keys * d * 2 + 2 * stats + B * T * d * 4 + B * 4
    dkv_bytes = 2 * keys * d * 2 + 2 * n_live * T * d * 2 + 2 * stats + 2 * B * T * d * 4 + B * 4
    per = 2.0 * T * hd * H * keys       # one [T, L] x hd product of every head
    work = {"fwd": (fwd_bytes, 2 * per), "dq": (dq_bytes, 3 * per), "dkv": (dkv_bytes, 4 * per)}
    recs = []
    for name, key, plain, lib in (("fused_attn_fwd_wide", "fwd", plain_ms, library_ms),
                                  ("fused_dq_wide", "dq", bwd_plain_ms, None),
                                  ("fused_dkv_wide", "dkv", bwd_plain_ms, None)):
        nbytes, flops = work[key]
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        recs.append(dict(label=label, dtype="bfloat16", rate=rate, kernel=name,
                         max_abs_err=abs_errs[key], errs=errs, ms=dev[name],
                         plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                         bound_by=bound_by, bound_share=bound_ms / dev[name],
                         bytes=nbytes, flops=flops, route=plan.attn_route))
    print(f"[fused_wide] {label} dropout {rate}: device ms a call {dev} (bounds "
          f"{[round(r['bound_ms'], 4) for r in recs]} ms); plain attention {plain_ms:.4f} / "
          f"backward {bwd_plain_ms:.4f} ms; SDPA with a key mask {library_ms:.4f} ms, its "
          f"backward (dq, dk and dv) {bwd_library_ms:.4f} ms", flush=True)
    for r in recs[1:]:
        r["library_pair_ms"] = bwd_library_ms
    return recs


def _head_views(gen, B, H, T, D, n, device):
    """n [B, H, T, D] views of one [B, T, n*H*D] projection: the strides
    nn/transformer.py hands flash_mha."""
    import torch

    proj = torch.randn((B, T, n * H * D), generator=gen, device=device)
    return [t.reshape(B, T, H, D).transpose(1, 2) for t in proj.split(H * D, dim=-1)]


def _in_chunks(fn, B, step):
    """fn(slice) over the batch in chunks of `step` samples."""
    return [fn(slice(b0, min(b0 + step, B))) for b0 in range(0, B, step)]


def _split_counts():
    from raindrop_tpu_torch.ops import flash_attention as fa

    return {a: getattr(fa.flash_mha, a) for a in COUNTS if hasattr(fa.flash_mha, a)}


def _check_split_launches(before, route, fwd, bwd, what):
    """fwd forward and bwd backward flash_mha launches since `before`, every
    one counted on `route` (none on a tensor-core route for "scalar")."""
    got = {a: n - before[a] for a, n in _split_counts().items()}
    want = {a: 0 for a in got}
    want.update(launches=fwd, bwd_launches=bwd)
    if route != "scalar":
        want.update({f"{route}_launches": fwd, f"{route}_bwd_launches": bwd})
    if got != want:
        raise AssertionError(f"flash_mha at {what}: launches {got}, expected {want}")


def check_flash_mha(q, k, v, g, lengths, dtype, rate, n_plain, what):
    """flash_mha's kernels at one shape, forward and backward, each twice,
    on the launch plan's route (split_route: bf16 on the tensor cores, the
    operands in the padded cast the model's path makes), against the plain
    version on the first `n_plain` samples (b * H + h keys the dropout
    mask, so a slice's plain masks are the kernel's only from sample 0): o
    and lse to TOL, o and each gradient to SAMPLE_TOL by sample_err;
    bit-equal on a repeat and finite; exact zeros for sample 0, of length
    0. In bf16 also against the scalar kernels (the previous design; its
    backward on the same o and lse) on every sample by sample_err, and the
    same kernels on a plain cast of the operands (dense heads: the copy
    width their strides allow, 2 bytes at odd hd, 4 at hd 42 and 170)
    bit-equal to the padded cast's. Returns (o, lse, forward max_abs_err,
    the sample_err of o, dq, dk and dv, and in bf16 of each against the
    scalar kernels, "<name>_vs_prev")."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    c = slice(0, n_plain)
    route = split_route(q.shape[-1], dtype)
    before = _split_counts()
    o, lse = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    o2, lse2 = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
    args = (q, k, v, lengths, SEED, rate, od, o, lse, g)
    got = fa._flash_bwd_cuda(*args)
    again = fa._flash_bwd_cuda(*args)
    _check_split_launches(before, route, 2, 2, what)
    o_p, lse_p = fa._flash_fwd_plain(q[c], k[c], v[c], lengths[c], od, SEED, rate)
    want = fa._flash_bwd_plain(q[c], k[c], v[c], lengths[c], SEED, rate, od,
                               o[c], lse[c], g[c])
    torch.cuda.synchronize()
    fwd_err = max(max_err(o[c], o_p), max_err(lse[c], lse_p))
    errs = {n: sample_err(a[c], b, lengths[c])
            for n, a, b in zip(("o", "dq", "dk", "dv"), (o, *got), (o_p, *want))}
    del o_p, lse_p, want
    if cd is not None:
        prev_o, _ = fa._flash_fwd_cuda(q, k, v, lengths, SEED, rate, od, "scalar")
        prev = fa._flash_bwd_cuda(*args, "scalar")
        dense = [x.to(od) for x in (q, k, v, g)]
        d_o, d_lse = fa._flash_fwd_cuda(*dense[:3], lengths, SEED, rate, od)
        d_grads = fa._flash_bwd_cuda(*dense[:3], lengths, SEED, rate, od, o, lse, dense[3])
        torch.cuda.synchronize()
        errs.update({f"{n}_vs_prev": sample_err(a, b, lengths) for n, a, b in
                     zip(("o", "dq", "dk", "dv"), (o, *got), (prev_o, *prev))})
        if not all(torch.equal(a, b) for a, b in zip((o, lse, *got),
                                                      (d_o, d_lse, *d_grads))):
            raise AssertionError(f"flash_mha at {what}: the plain cast's operands give "
                                 f"other bits than the padded cast's")
        del prev_o, prev, dense, d_o, d_lse, d_grads
    if fwd_err > TOL[dtype] or max(errs.values()) > SAMPLE_TOL[dtype]:
        raise AssertionError(
            f"flash_mha kernels disagree at {what}: forward max_abs_err {fwd_err:.3e} "
            f"(tol {TOL[dtype]:g}), sample_err {errs} (tol {SAMPLE_TOL[dtype]:g})")
    _equal_and_finite([("o", o, o2), ("lse", lse, lse2)]
                      + [(n, a, a2) for n, a, a2 in zip(("dq", "dk", "dv"), got, again)],
                      f"flash_mha {what}")
    if not all(bool((a[0] == 0).all()) for a in (o, *got)):
        raise AssertionError(f"flash_mha: the length-0 sample is not zero at {what}")
    return o, lse, fwd_err, errs


def flash_mha_phase(label, B, H, T, D, dtype, rate, device="cuda", seed=0):
    """Kernels vs plain for flash_mha, forward (with dropout when rate > 0)
    and backward, at one shape (check_flash_mha; the plain version on the
    first `chunk` samples, which hold the lengths 0, 1 and T), then their
    times. In bf16 the plan's tensor-core route on the padded cast the
    model makes is timed in turns with the previous design (the scalar
    kernels on a plain cast, prev_ms) and with the same route on the plain
    cast (dense_ms: the copy width the dense heads allow), order scalar,
    tc, dense, dense, tc, scalar; device times by the profiler up to T=1024;
    SDPA with a key mask beside. Returns (forward run, backward run)."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = _head_views(gen, B, H, T, D, 4, device)
    lengths = ragged_lengths(gen, B, T, device)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    chunk = B if T <= 1024 else 8
    route = split_route(D, dtype)
    o, lse, fwd_err, errs = check_flash_mha(q, k, v, g, lengths, dtype, rate, chunk,
                                            f"{label} {dtype} dropout {rate}")
    err = max(errs[n] for n in ("dq", "dk", "dv"))
    print(f"[flash_mha] {label} {dtype} B={B} H={H} T={T} D={D} dropout {rate} ({route} "
          f"route): forward max_abs_err {fwd_err:.3e} (tol {TOL[dtype]:g}), sample_err "
          f"{errs} (tol {SAMPLE_TOL[dtype]:g}; plain version on the first {chunk} "
          f"samples, the scalar kernels on all)", flush=True)

    # inputs already in the operand dtype, so the timed calls are the
    # launches: the tensor-core route on the model's padded cast ("tc"), the
    # same on a plain cast ("dense"), the previous design ("scalar")
    plain_cast = [x.to(od) for x in (q, k, v, g)]
    padded, pad_cols = fa._flash_operands((q, k, v, g), od)
    ops = {"tc": padded, "dense": plain_cast, "scalar": plain_cast}
    cols = {"tc": pad_cols, "dense": None, "scalar": None}
    impl = {"tc": "auto", "dense": "auto", "scalar": "scalar"}
    names = ("scalar", "tc", "dense") if cd is not None else ("tc",)
    reps = dict(reps=20, warmup=3) if T <= 1024 else dict(reps=5, warmup=1)

    def fwd_run(n):
        qo, ko, vo, _ = ops[n]
        return fa._flash_fwd_cuda(qo, ko, vo, lengths, SEED, rate, od, impl[n], cols[n])

    def bwd_run(n):
        qo, ko, vo, go = ops[n]
        return fa._flash_bwd_cuda(qo, ko, vo, lengths, SEED, rate, od, o, lse, go, impl[n],
                                  cols[n], cols[n])

    def in_turns(run):
        t = {n: [] for n in names}
        for n in (*names, *reversed(names)):
            t[n].append(time_ms(lambda: run(n), **reps))
        means = {n: sum(x) / len(x) for n, x in t.items()}
        # past 1024 steps a launch takes a millisecond or more, so the
        # events time the device; there the profiler has lost kernel
        # records (readings of 0 or two launches in three), so it is not read
        dev = ({n: device_ms(lambda: run(n)) for n in names if n != "dense"}
               if T <= 1024 else {})
        return dict(ms=means["tc"], prev_ms=means.get("scalar"), dense_ms=means.get("dense"),
                    device_ms=dev.get("tc"), prev_device_ms=dev.get("scalar"))

    ft, bt = in_turns(fwd_run), in_turns(bwd_run)
    qo, ko, vo, go = ops["tc"]
    plain_ms = time_ms(lambda: _in_chunks(
        lambda c: fa._flash_fwd_plain(qo[c], ko[c], vo[c], lengths[c], od, SEED, rate),
        B, chunk), reps=2, warmup=1)
    bwd_plain_ms = time_ms(lambda: _in_chunks(
        lambda c: fa._flash_bwd_plain(qo[c], ko[c], vo[c], lengths[c], SEED, rate, od,
                                      o[c], lse[c], g[c]), B, chunk), reps=2, warmup=1)
    del ops, plain_cast
    live = lengths > 0
    qh, kh, vh = (x[live].contiguous().requires_grad_() for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep, dropout_p=rate),
                             **reps)
    out = sdpa(qh, kh, vh, attn_mask=keep, dropout_p=rate)
    gh = g[live].to(od)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                         retain_graph=True), **reps)
    del out, qh, kh, vh, qo, ko, vo, go
    esize = 2 if dtype == "bfloat16" else 4
    total = float(lengths.sum())
    fwd_bytes = attention_bytes(lengths, T, H * D, H, esize)
    fwd_flops = 4.0 * T * D * H * total
    bwd_bytes = attention_bytes(lengths, T, H * D, H, esize, backward=True)
    bwd_flops = 10.0 * T * D * H * total
    bound_ms, bound_by = bound(fwd_bytes, fwd_flops, dtype)
    bwd_bound_ms, bwd_bound_by = bound(bwd_bytes, bwd_flops, dtype)
    print(f"[flash_mha] {label} {dtype} dropout {rate} ({route} route): forward "
          f"{ft['ms']:.4f} ms (device {ft['device_ms']}; {design_line(ft['ms'], ft['prev_ms'], bound_ms)}"
          + (f"; plain cast {ft['dense_ms']:.4f} ms" if ft["dense_ms"] else "")
          + f"), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); backward {bt['ms']:.4f} ms (device {bt['device_ms']}; "
          f"{design_line(bt['ms'], bt['prev_ms'], bwd_bound_ms)}"
          + (f"; plain cast {bt['dense_ms']:.4f} ms" if bt["dense_ms"] else "")
          + f"), plain {bwd_plain_ms:.4f} ms, sdpa backward {bwd_library_ms:.4f} ms, bound "
          f"{bwd_bound_ms:.4f} ms ({bwd_bound_by}); {fwd_flops / 1e9:.1f} / "
          f"{bwd_flops / 1e9:.1f} GFLOP", flush=True)
    shape = dict(label=label, dtype=dtype, rate=rate, B=B, H=H, T=T, D=D, route=route)
    fwd = dict(**shape, max_abs_err=fwd_err, **ft, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ft["ms"], bytes=fwd_bytes, flops=fwd_flops)
    bwd = dict(**shape, max_abs_err=err, errs=errs, **bt, plain_ms=bwd_plain_ms,
               library_ms=bwd_library_ms, bound_ms=bwd_bound_ms,
               bound_by=bwd_bound_by, bound_share=bwd_bound_ms / bt["ms"],
               bytes=bwd_bytes, flops=bwd_flops)
    return fwd, bwd


def flash_mha_op_phase(wrappers, device="cuda", seed=0, B=128, T=600, H=2, D=42,
                       rate=0.2):
    """The public op through autograd at a length the packed kernel also
    takes, dropout on: flash_mha on the head views against
    flash_mha_packed on the same [B, T, d] tensors and seed. Both hash
    b * H + h, the global row and the global column, so they draw the same
    masks: with f32 operands (the scalar kernels of both) they agree to
    rounding (1e-5); with bf16 operands both run attention_tc.cuh's
    routines at the same padded head dim on the same values, and o and the
    gradients are bit-equal. Returns flash_mha's bf16 forward and backward
    launch counts (every one on the tensor-core route) and the
    differences."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed + 7)
    q, k, v, g = (torch.randn((B, T, H * D), generator=gen, device=device)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)

    def heads(x):
        return x.reshape(B, T, H, D).transpose(1, 2)

    checks, counts = {}, {}
    for cd in (None, "bfloat16"):
        reset_counts(wrappers)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fa.flash_mha(*(heads(x) for x in leaves), lengths, SEED, rate, cd)
        o.backward(heads(g))
        counts[cd] = _split_counts()
        p_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_p = fa.flash_mha_packed(*p_leaves, lengths, SEED, rate, cd, H)
        o_p.backward(g)
        torch.cuda.synchronize()
        merged = o.detach().transpose(1, 2).reshape(B, T, H * D)
        name = cd or "float32"
        if cd is None:
            checks["float32"] = {"o": max_err(merged, o_p.detach())}
            for n, a, b in zip(("dq", "dk", "dv"), leaves, p_leaves):
                checks["float32"][n] = rel_err(a.grad, b.grad)
        else:
            checks[name] = {n: bool(torch.equal(a, b)) for n, a, b in zip(
                ("o", "dq", "dk", "dv"), (merged, *(x.grad for x in leaves)),
                (o_p.detach(), *(x.grad for x in p_leaves)))}
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"flash_mha public op: o not finite ({name})")
    print(f"[flash_mha] public op at B={B} T={T} H={H} D={D} dropout {rate}: against "
          f"flash_mha_packed {checks} (f32 tol 1e-5, bf16 bit-equal); launches "
          f"{counts}", flush=True)
    bad = {n: x for n, x in checks["float32"].items() if not x <= 1e-5}
    bad.update({n: x for n, x in checks["bfloat16"].items() if not x})
    if bad:
        raise AssertionError(f"flash_mha and flash_mha_packed disagree: {bad}")
    f32, bf = counts[None], counts["bfloat16"]
    if (f32["launches"], f32["bwd_launches"], f32["tc_launches"]) != (1, 1, 0):
        raise AssertionError(f"flash_mha f32: expected one scalar launch each way: {f32}")
    if (bf["launches"], bf["bwd_launches"], bf["tc_launches"], bf["tc_bwd_launches"]) != (
            1, 1, 1, 1):
        raise AssertionError(f"flash_mha bf16: expected one tensor-core launch each way: {bf}")
    return bf["tc_launches"], bf["tc_bwd_launches"], checks


def flash_mha_edge_phase(hd, T, rate, B=5, H=2, device="cuda", seed=0):
    """flash_mha at an edge shape (hd 8, 13 (odd: 2-byte loads on a plain
    cast), 42, 128 and 144 on the one-warpgroup tensor-core route in bf16;
    129 too, and 170, 192, 193, 200, 360 and 368 on two warpgroups past
    hd_pad 144; the scalar kernels' Narrow geometry to hd 192 and Wide past
    it in f32; T = 65, 1025, 2048) on the projection's head views, f32 and
    bf16 operands, by check_flash_mha on every sample; one length ends 45
    rows into a 64-row block."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed + hd + T)
    q, k, v, g = _head_views(gen, B, H, T, hd, 4, device)
    lengths = ragged_lengths(gen, B, T, device)
    lengths[3] = min(T, 64 * (T // 128) + 45)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        _, _, fwd_err, rel = check_flash_mha(q, k, v, g, lengths, dtype, rate, B,
                                             f"hd={hd} T={T} {dtype} dropout {rate}")
        errs[dtype] = {"fwd": fwd_err, **rel}
    rows = fa.scalar_rows(hd)
    route = split_route(hd, "bfloat16")
    print(f"[flash_mha_edge] hd={hd} T={T} dropout {rate} (bf16 {route} route, f32 "
          f"scalar in {rows}-row blocks): {errs} (tol: fwd {TOL}, sample_err "
          f"{SAMPLE_TOL})", flush=True)
    return dict(hd=hd, T=T, rate=rate, rows=rows, route=route, errs=errs)


# ------------------------------------------------------------ graph kernels
GRAPH_TOL = 1e-5    # f32 throughout, another summation order


def graph_topology(kind, device="cuda", seed=0):
    """(src, dst, N, complete) int64 on the card. 'P12' and 'PAM': the
    model's complete sensor graph in source-major order, so the
    destinations are not sorted. 'kNN': each of N=128 random points sends
    an edge to its 6 nearest neighbours (E=768), the edges into the last
    node redirected so it has no incoming edge, in shuffled order. 'kNN36'
    the same with 36 points."""
    import torch

    if kind in ("P12", "PAM"):
        N = 36 if kind == "P12" else 17
        idx = torch.arange(N, device=device)
        return idx.repeat_interleave(N), idx.repeat(N), N, True
    N, k = (128, 6) if kind == "kNN" else (36, 6)
    gen = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand((N, 2), generator=gen, device=device)
    dist = torch.cdist(pts, pts) + 10.0 * torch.eye(N, device=device)
    dst = dist.topk(k, largest=False).indices.reshape(-1)
    src = torch.arange(N, device=device).repeat_interleave(k)
    dst = torch.where(dst == N - 1, torch.zeros_like(dst), dst)
    order = torch.randperm(N * k, generator=gen, device=device)
    return src[order], dst[order], N, False


def _equal_and_finite(pairs, what):
    import torch

    for name, a, a2 in pairs:
        if not bool(torch.isfinite(a).all()) or not torch.equal(a, a2):
            raise AssertionError(f"{what}: {name} not finite or not bit-equal "
                                 f"on a repeat")


def _graph_counts(fn):
    """A sparse-graph wrapper's launch counts, by route too (GRAPH_COUNTS)."""
    return {a: getattr(fn, a) for a in GRAPH_COUNTS}


def _check_graph_route(fn, before, route, fwd, bwd, what, bwd_route=None):
    """fwd forward and bwd backward launches of `fn` since `before`
    (_graph_counts), every forward on `route`, every backward on
    `bwd_route` (default: `route`)."""
    got = {a: n - before[a] for a, n in _graph_counts(fn).items()}
    want = {a: 0 for a in GRAPH_COUNTS}
    want.update({"launches": fwd, "bwd_launches": bwd, f"{route}_launches": fwd,
                 f"{bwd_route or route}_bwd_launches": bwd})
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _spmm_library(x, gamma, N, gather_target, src=None, dst=None):
    """The dense form: one softmax over the [N, N] grid of logits and one
    bmm. Returns (out, w). A complete graph in source-major order is the
    grid itself; any other graph gives `src` and `dst`, and its logits are
    scattered into a grid of -inf first (a masked softmax; a node without
    incoming edges softmaxes to NaN and is set to 0; duplicate edges would
    overwrite each other, so the caller compares only without them)."""
    import torch

    B = x.shape[0]
    if src is None:
        W = torch.softmax(gamma.reshape(B, N, N), dim=1)           # [b, s, n]
    else:
        grid = torch.full((B, N, N), float("-inf"), dtype=x.dtype, device=x.device)
        grid[:, src, dst] = gamma
        W = torch.nan_to_num(torch.softmax(grid, dim=1), nan=0.0)
    A = torch.diag_embed(W.sum(1)) if gather_target else W.transpose(1, 2)
    w = W.reshape(B, N * N) if src is None else W[:, src, dst]
    return torch.bmm(A, x), w


def spmm_phase(label, B, D, gather_target, device="cuda", seed=0):
    """Kernels vs plain for spmm_segment_softmax, forward and backward, on
    one graph. Returns (forward run, backward run)."""
    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    src, dst, N, complete = graph_topology(label, device, seed)
    E = src.numel()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x, g_out = (torch.randn((B, N, D), generator=gen, device=device) for _ in range(2))
    gamma, g_w = (torch.randn((B, E), generator=gen, device=device) for _ in range(2))
    topo = sp.topology(src, dst, N)
    what = f"spmm {label} gather_target={gather_target}"
    # the model's form gathers each segment's own row: "row"; else "tile"
    route = "row" if gather_target else "tile"
    before = _graph_counts(sp.spmm_segment_softmax)

    out, w = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
    out2, w2 = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
    dx, dgamma = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
    dx2, dgamma2 = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
    # the model's form: constant edge weights, no cotangent on them
    dx_only, _ = sp._spmm_bwd_cuda(g_out, None, x, w, topo, gather_target,
                                   need_dgamma=False)
    _check_graph_route(sp.spmm_segment_softmax, before, route, 2, 3, what)
    p_out, p_w = sp._spmm_fwd_plain(x, gamma, src, dst, N, gather_target)
    p_dx, p_dgamma = sp._spmm_bwd_plain(g_out, g_w, x, w, src, dst, N, gather_target)
    torch.cuda.synchronize()
    errs = {"out": rel_err(out, p_out), "w": rel_err(w, p_w)}
    bwd_errs = {"dx": rel_err(dx, p_dx), "dgamma": rel_err(dgamma, p_dgamma)}
    empty = torch.bincount(dst, minlength=N) == 0
    print(f"[spmm] {label} B={B} N={N} E={E} D={D} gather_target={gather_target}, "
          f"route {route}: forward rel err {errs}, backward rel err {bwd_errs} "
          f"(tol {GRAPH_TOL:g}); "
          f"{int(empty.sum())} nodes without an incoming edge", flush=True)
    if max(*errs.values(), *bwd_errs.values()) > GRAPH_TOL:
        raise AssertionError(f"{what}: the kernels disagree with the plain version")
    _equal_and_finite([("out", out, out2), ("w", w, w2), ("dx", dx, dx2),
                       ("dgamma", dgamma, dgamma2), ("dx alone", dx_only, dx)], what)
    if not bool((out[:, empty] == 0).all()):
        raise AssertionError(f"{what}: a node without incoming edges is not zero")
    if not complete and int(empty.sum()) < 1:
        raise AssertionError(f"{what}: the graph has no empty segment")
    del p_out, p_w, p_dx, p_dgamma

    ms = time_ms(lambda: sp._spmm_fwd_cuda(x, gamma, topo, gather_target))
    plain_ms = time_ms(lambda: sp._spmm_fwd_plain(x, gamma, src, dst, N, gather_target),
                       reps=5, warmup=1)
    bwd_ms = time_ms(lambda: sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target))
    dx_ms = time_ms(lambda: sp._spmm_bwd_cuda(g_out, None, x, w, topo, gather_target,
                                              need_dgamma=False))
    bwd_plain_ms = time_ms(lambda: sp._spmm_bwd_plain(g_out, g_w, x, w, src, dst, N,
                                                      gather_target), reps=5, warmup=1)
    # the library yardstick: the dense [N, N] form, masked for a sparse graph
    lib_edges = () if complete else (src, dst)
    dups = E - int(torch.unique(src * N + dst).numel())
    l_out, l_w = _spmm_library(x, gamma, N, gather_target, *lib_edges)
    lib_err = max(rel_err(out, l_out), rel_err(w, l_w))
    if dups == 0 and lib_err > GRAPH_TOL:
        raise AssertionError(f"{what}: the dense softmax + bmm form differs "
                             f"by {lib_err}")
    if dups:
        print(f"[spmm] {label}: {dups} duplicate edges, which the dense form "
              f"merges: it is timed, not compared", flush=True)
    library_ms = time_ms(lambda: _spmm_library(x, gamma, N, gather_target, *lib_edges))
    xr, gr = x.clone().requires_grad_(), gamma.clone().requires_grad_()
    outs = _spmm_library(xr, gr, N, gather_target, *lib_edges)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        outs, (xr, gr), (g_out, g_w), retain_graph=True))
    del outs, xr, gr, l_out, l_w
    # bytes: each array once; of x only the rows some edge gathers
    gidx = dst if gather_target else src
    rows = int(torch.unique(gidx).numel())
    index_bytes = (3 * E + N + 1) * 4
    fwd_bytes = (B * rows * D + B * N * D + 2 * B * E) * 4 + index_bytes
    fwd_flops = 2.0 * B * E * D + 4.0 * B * E
    bound_ms, bound_by = bound(fwd_bytes, fwd_flops, "float32")
    # backward: g_out, x, w, g_w in; dx, dgamma out
    bwd_bytes = (B * N * D + B * rows * D + 2 * B * E + B * N * D + B * E) * 4 + 2 * index_bytes
    bwd_bound_ms, bwd_bound_by = bound(bwd_bytes, 4.0 * B * E * D + 4.0 * B * E, "float32")
    # dx alone: g_out and w in, dx out
    dx_bytes = (2 * B * N * D + B * E) * 4 + index_bytes
    dx_bound_ms, dx_bound_by = bound(dx_bytes, 2.0 * B * E * D, "float32")
    print(f"[spmm] {label} gather_target={gather_target}: forward {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, softmax+bmm {library_ms}, bound {bound_ms:.4f} ms "
          f"({bound_by}); backward {bwd_ms:.4f} ms (dx alone {dx_ms:.4f} ms, bound "
          f"{dx_bound_ms:.4f}), plain {bwd_plain_ms:.4f} ms, softmax+bmm backward "
          f"{bwd_library_ms}, bound {bwd_bound_ms:.4f} ms ({bwd_bound_by})", flush=True)
    shape = dict(label=label, gather_target=gather_target, B=B, N=N, E=E, D=D,
                 route=route)
    fwd = dict(**shape, max_abs_err=max(errs.values()), errs=errs, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=fwd_bytes, flops=fwd_flops)
    bwd = dict(**shape, max_abs_err=max(bwd_errs.values()), errs=bwd_errs, ms=bwd_ms,
               plain_ms=bwd_plain_ms, library_ms=bwd_library_ms,
               bound_ms=bwd_bound_ms, bound_by=bwd_bound_by, bytes=bwd_bytes,
               dx_only_ms=dx_ms, dx_only_bound_ms=dx_bound_ms,
               dx_only_bound_by=dx_bound_by)
    return fwd, bwd


def sddmm_phase(label, B, D, device="cuda", seed=0):
    """Kernels vs plain for sddmm, forward and backward, on one graph.
    Returns (forward run, backward run)."""
    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    src, dst, N, complete = graph_topology(label, device, seed)
    E = src.numel()
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    q, k = (torch.randn((B, N, D), generator=gen, device=device) for _ in range(2))
    d_alpha = torch.randn((B, E), generator=gen, device=device)
    topo = sp.topology(src, dst, N)
    scale = D ** -0.5
    what = f"sddmm {label} B={B} D={D}"
    before = _graph_counts(sp.sddmm)
    alpha = sp._sddmm_fwd_cuda(q, k, topo, scale)
    alpha2 = sp._sddmm_fwd_cuda(q, k, topo, scale)
    dq, dk = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    dq2, dk2 = sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale)
    _check_graph_route(sp.sddmm, before, "tile", 2, 2, what)
    p_alpha = sp._sddmm_fwd_plain(q, k, src, dst, scale)
    p_dq, p_dk = sp._sddmm_bwd_plain(d_alpha, q, k, src, dst, scale)
    torch.cuda.synchronize()
    err = rel_err(alpha, p_alpha)
    bwd_errs = {"dq": rel_err(dq, p_dq), "dk": rel_err(dk, p_dk)}
    print(f"[sddmm] {label} B={B} N={N} E={E} D={D}: forward rel err {err:.3e}, "
          f"backward rel err {bwd_errs} (tol {GRAPH_TOL:g})", flush=True)
    if max(err, *bwd_errs.values()) > GRAPH_TOL:
        raise AssertionError(f"{what}: the kernels disagree with the plain version")
    _equal_and_finite([("alpha", alpha, alpha2), ("dq", dq, dq2), ("dk", dk, dk2)], what)
    del p_alpha, p_dq, p_dk

    ms = time_ms(lambda: sp._sddmm_fwd_cuda(q, k, topo, scale))
    plain_ms = time_ms(lambda: sp._sddmm_fwd_plain(q, k, src, dst, scale),
                       reps=5, warmup=1)
    bwd_ms = time_ms(lambda: sp._sddmm_bwd_cuda(d_alpha, q, k, topo, scale))
    bwd_plain_ms = time_ms(lambda: sp._sddmm_bwd_plain(d_alpha, q, k, src, dst, scale),
                           reps=5, warmup=1)
    # the library yardstick, one bmm over all N x N pairs: on the complete
    # graph in source-major order alpha[b, s * N + n] = scale * k[b, s] . q[b, n]
    # is the product itself, on a sparse graph its E entries are read out
    def lib(q_, k_):
        grid = torch.bmm(k_, q_.transpose(1, 2)) * scale
        return grid.reshape(B, E) if complete else grid[:, src, dst]

    if rel_err(alpha, lib(q, k)) > GRAPH_TOL:
        raise AssertionError(f"{what}: the dense bmm form differs")
    library_ms = time_ms(lambda: lib(q, k))
    qr, kr = q.clone().requires_grad_(), k.clone().requires_grad_()
    a = lib(qr, kr)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(a, (qr, kr), d_alpha,
                                                         retain_graph=True))
    del a, qr, kr
    q_rows, k_rows = int(torch.unique(dst).numel()), int(torch.unique(src).numel())
    index_bytes = 2 * E * 4
    fwd_bytes = (B * (q_rows + k_rows) * D + B * E) * 4 + index_bytes
    bound_ms, bound_by = bound(fwd_bytes, 2.0 * B * E * D, "float32")
    bwd_bytes = (B * (q_rows + k_rows) * D + B * E + 2 * B * N * D) * 4 \
        + 2 * index_bytes + 2 * (E + N + 1) * 4
    bwd_bound_ms, bwd_bound_by = bound(bwd_bytes, 4.0 * B * E * D, "float32")
    print(f"[sddmm] {label} D={D}: forward {ms:.4f} ms, plain {plain_ms:.4f} ms, bmm "
          f"{library_ms}, bound {bound_ms:.4f} ms ({bound_by}); backward {bwd_ms:.4f} "
          f"ms, plain {bwd_plain_ms:.4f} ms, bmm backward {bwd_library_ms}, bound "
          f"{bwd_bound_ms:.4f} ms ({bwd_bound_by})", flush=True)
    shape = dict(label=label, B=B, N=N, E=E, D=D, route="tile")
    fwd = dict(**shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=fwd_bytes)
    bwd = dict(**shape, max_abs_err=max(bwd_errs.values()), errs=bwd_errs, ms=bwd_ms,
               plain_ms=bwd_plain_ms, library_ms=bwd_library_ms,
               bound_ms=bwd_bound_ms, bound_by=bwd_bound_by, bytes=bwd_bytes)
    return fwd, bwd


def graph_edge_phase(device="cuda", seed=0, B=3, D=36, k=6):
    """Both sides of the launch plan's cut-over from "tile" to "csr" in N:
    for the weighted sums (spmm_segment_softmax forward and backward with
    the source gathered, sddmm's backward) and for sddmm's forward (edge
    dot products, no staged CSR), the largest N whose rows fit a tile at 32
    columns (the shared bytes at their largest) and the next, on graphs of
    k incoming edges a node from random sources, shuffled (E = k N, past
    the sums' staging of 1024 CSR positions, the dot products' positions
    in several parts). Each kernel held against its plain version within GRAPH_TOL and
    bit-equal on a repeat, the route of every launch checked. Returns one
    record a graph."""
    import torch
    from raindrop_tpu_torch.ops import sparse as sp

    def cut(kind):
        n = 1
        while sp.graph_plan(B, n, k * n, D, kind).route == "tile":
            n += 1
        return n

    sums, dots = cut("fwd_source"), cut("sddmm_fwd")
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    runs = []
    for N in sorted({sums - 1, sums, dots - 1, dots}):
        E = k * N
        dst = torch.arange(N, device=device).repeat_interleave(k)
        src = torch.randint(0, N, (E,), generator=gen, device=device)
        order = torch.randperm(E, generator=gen, device=device)
        src, dst = src[order], dst[order]
        x, g_out, q, kk = (torch.randn((B, N, D), generator=gen, device=device)
                           for _ in range(4))
        gamma, g_w, d_alpha = (torch.randn((B, E), generator=gen, device=device)
                               for _ in range(3))
        topo = sp.topology(src, dst, N)
        routes = {kind: sp.graph_plan(B, N, E, D, kind).route
                  for kind in ("fwd_source", "bwd_source", "sddmm_fwd", "sddmm_bwd")}
        # the backward with the source gathered runs dot products and a sum
        cuts = {"fwd_source": sums, "sddmm_bwd": sums, "sddmm_fwd": dots,
                "bwd_source": min(sums, dots)}
        want = {kind: "tile" if N < cuts[kind] else "csr" for kind in routes}
        what = f"graph edge N={N} E={E}"
        if routes != want:
            raise AssertionError(f"{what}: plan routes {routes}, expected {want}")
        b_spmm, b_sddmm = _graph_counts(sp.spmm_segment_softmax), _graph_counts(sp.sddmm)
        outs = [sp._spmm_fwd_cuda(x, gamma, topo, False) for _ in range(2)]
        w = outs[0][1]
        grads = [sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, False) for _ in range(2)]
        alphas = [sp._sddmm_fwd_cuda(q, kk, topo, 0.5) for _ in range(2)]
        dqk = [sp._sddmm_bwd_cuda(d_alpha, q, kk, topo, 0.5) for _ in range(2)]
        _check_graph_route(sp.spmm_segment_softmax, b_spmm, routes["fwd_source"], 2, 2,
                           what, routes["bwd_source"])
        _check_graph_route(sp.sddmm, b_sddmm, routes["sddmm_fwd"], 2, 2, what,
                           routes["sddmm_bwd"])
        p_out, p_w = sp._spmm_fwd_plain(x, gamma, src, dst, N, False)
        p_dx, p_dgamma = sp._spmm_bwd_plain(g_out, g_w, x, w, src, dst, N, False)
        p_alpha = sp._sddmm_fwd_plain(q, kk, src, dst, 0.5)
        p_dq, p_dk = sp._sddmm_bwd_plain(d_alpha, q, kk, src, dst, 0.5)
        torch.cuda.synchronize()
        got = {"out": outs[0][0], "w": w, "dx": grads[0][0], "dgamma": grads[0][1],
               "alpha": alphas[0], "dq": dqk[0][0], "dk": dqk[0][1]}
        again = {"out": outs[1][0], "w": outs[1][1], "dx": grads[1][0],
                 "dgamma": grads[1][1], "alpha": alphas[1], "dq": dqk[1][0],
                 "dk": dqk[1][1]}
        plain = {"out": p_out, "w": p_w, "dx": p_dx, "dgamma": p_dgamma,
                 "alpha": p_alpha, "dq": p_dq, "dk": p_dk}
        errs = {name: rel_err(got[name], plain[name]) for name in got}
        print(f"[graph edge] B={B} N={N} E={E} D={D}: routes {routes}; rel err {errs} "
              f"(tol {GRAPH_TOL:g})", flush=True)
        if max(errs.values()) > GRAPH_TOL:
            raise AssertionError(f"{what}: the kernels disagree with the plain version")
        _equal_and_finite([(name, got[name], again[name]) for name in got], what)
        runs.append(dict(B=B, N=N, E=E, D=D, routes=routes, errs=errs,
                         max_abs_err=max(errs.values())))
    return runs


def global_adj_phase(wrappers, device="cuda", seed=0, B=32):
    """raindrop_apply at P12 full width with random edge weights in
    [0.5, 2]: prop_backend 'pallas' (the SpMM kernel) against 'coo' (the
    segment ops), f32 attention operands, logits within 1e-4."""
    import torch
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_apply, raindrop_init
    from raindrop_tpu_torch.ops.sparse import spmm_segment_softmax

    cfgs = {b: dataset_config("P12", prop_backend=b, attention_score_dtype="float32")
            for b in ("pallas", "coo")}
    cfg = cfgs["pallas"]
    params = raindrop_init(seed, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    W = 0.5 + 1.5 * torch.rand((cfg.d_inp, cfg.d_inp), generator=gen, device=device)
    P, times, static = (torch.from_numpy(a).to(device)
                        for a in make_requests(cfg, B, seed + 4))
    src, tm = P.transpose(0, 1), times.transpose(0, 1)
    lengths = (tm > 0).sum(dim=0)
    out = {}
    with torch.no_grad():
        for name, c in cfgs.items():
            for fn in wrappers:
                fn.launches = 0
            logits, dist = raindrop_apply(params, c, src, static, tm, lengths,
                                          global_adj=W)
            out[name] = (logits, float(dist), spmm_segment_softmax.launches)
    torch.cuda.synchronize()
    diff = max_err(out["pallas"][0], out["coo"][0])
    print(f"[global_adj] P12 B={B}, weights in [0.5, 2]: pallas vs coo logits max "
          f"abs diff {diff:.3e} (tol 1e-4), distance {out['pallas'][1]:.6f} vs "
          f"{out['coo'][1]:.6f}; SpMM launches {out['pallas'][2]} (pallas), "
          f"{out['coo'][2]} (coo)", flush=True)
    if not diff <= 1e-4 or not bool(torch.isfinite(out["pallas"][0]).all()):
        raise AssertionError("raindrop_apply(global_adj): pallas and coo disagree")
    if out["pallas"][2] != 2 or out["coo"][2] != 0:
        raise AssertionError("raindrop_apply(global_adj): 'pallas' must launch the "
                             "SpMM kernel twice, 'coo' never")
    return dict(max_abs_diff=diff, launches=out["pallas"][2])


def selfattention_phase(wrappers, device="cuda", seed=0, N=36, D=860, heads=2):
    """ob_propagate_selfattention with score_backend 'sddmm' (the kernel,
    once a call with the heads on its batch axis: B = heads, D = D / heads)
    against 'gather', value and gradient w.r.t. x, on a kNN graph and on the
    complete one. Returns sddmm's forward and backward launch counts."""
    import torch
    from raindrop_tpu_torch.graph.propagate import (
        ob_propagate_selfattention, ob_propagation_init)
    from raindrop_tpu_torch.ops.sparse import sddmm

    gen = torch.Generator(device=device).manual_seed(seed + 5)
    params = ob_propagation_init(gen, D, D // heads, N, 4, heads=heads, device=device)
    x0 = torch.randn((N, D), generator=gen, device=device)
    cot = torch.randn((N, D), generator=gen, device=device)
    reset_counts(wrappers)
    checks = {}
    for kind in ("kNN36", "P12"):
        src, dst, n, _ = graph_topology(kind, device, seed)
        assert n == N
        ei = torch.stack([src, dst])
        res = {}
        for backend in ("sddmm", "gather"):
            x = x0.clone().requires_grad_()
            out, (_, alpha) = ob_propagate_selfattention(
                params, x, ei, heads=heads, n_nodes=N, score_backend=backend)
            out.backward(cot)
            res[backend] = (out.detach(), alpha.detach(), x.grad)
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "alpha", "dx"), res["sddmm"], res["gather"]):
            checks[f"{kind}_{name}"] = rel_err(a, b)
    counts = (sddmm.launches, sddmm.bwd_launches)
    print(f"[selfattention] N={N} D={D} heads={heads}: sddmm vs gather rel err "
          f"{checks} (tol {GRAPH_TOL:g}); sddmm launches {counts[0]} forward, "
          f"{counts[1]} backward ({sddmm.tile_launches}, {sddmm.tile_bwd_launches} "
          f"on route tile)", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= GRAPH_TOL}
    if bad:
        raise AssertionError(f"selfattention: sddmm and gather disagree: {bad}")
    # one call a graph each way, the heads on sddmm's batch axis
    if counts != (2, 2) or (sddmm.tile_launches, sddmm.tile_bwd_launches) != (2, 2):
        raise AssertionError(f"selfattention: expected 2 sddmm launches each way, "
                             f"all on route tile, got {counts}")
    return counts[0], counts[1], checks


# ----------------------------------------------------------------- serving
def make_requests(cfg, n, seed):
    """Synthetic batch-major requests: ragged lengths in 1..T, zero times
    past each length, z-scored values where observed."""
    rng = np.random.default_rng(seed)
    T, F = cfg.max_len, cfg.d_inp
    lengths = rng.integers(1, T + 1, size=n)
    live = np.arange(T)[None, :] < lengths[:, None]
    mask = ((rng.uniform(size=(n, T, F)) > 0.6) & live[..., None]).astype(np.float32)
    P = np.concatenate(
        [rng.normal(size=(n, T, F)).astype(np.float32) * mask, mask], -1)
    times = (np.cumsum(rng.uniform(0.1, 1.0, size=(n, T)), 1) * live).astype(np.float32)
    static = (rng.normal(size=(n, cfg.d_static)).astype(np.float32)
              if cfg.static else None)
    return P, times, static


def _rows(x, sl):
    return None if x is None else x[sl]


PLAIN_ATTENTION = {"attention_backend": "dense"}
# Samples in the dense-path checks past MAX_FUSED_T steps: the dense rung
# keeps [B, H, T, T] f32 scores for its backward, 4.3 GB a tensor at
# B=128, H=2, T=2048.
DENSE_ROWS = 16
# The served rows' batch-composition limit with sensor_wise_mask and bf16
# attention operands. Another bucket gives cuBLAS another GEMM algorithm
# upstream of the encoder; a last-bit difference there can flip a bf16
# rounding of an attention operand (the kernels give a sample the same
# bits in any batch: flash_phase and fused_phase check it), and the
# sensor-wise pool weighs a sensor's steps by up to T (600 at PAM), so a
# row's probabilities move up to T times further than without the mask.
# serve_phase holds the kernel path with f32 operands to 1e-5, and the
# kernels' plain versions in bf16 (plain_kernels) to this limit: at PAM-sw
# on an H100 their rows move as far as the kernels' (4.6e-5 against 4.7e-5).
BATCH_LIMIT_SW = 1e-4
# The fixed-batch falling-loss check's rate with sensor_wise_mask. The
# reference's sensor-wise pool sums the unobserved steps over (#observed +
# 1), so a sensor never observed in a sample weighs up to T (215 at P12)
# and the head sees inputs of that size; Adam's first, sign-like steps then
# overshoot: at lr 1e-3 the loss on one batch jumps within the first steps
# and need not end below where it started. train_phase fits the dense
# path at 1e-3 on the same batch beside the kernel path (dropout 0): its
# loss does the same.
FIT_LR_SW = 1e-5
PLAIN_ALL = {"attention_backend": "dense", "prop_backend": "auto"}


COUNTS = ("launches", "bwd_launches", "tc_launches", "tc_bwd_launches",
          "tc_wide_launches", "tc_wide_bwd_launches", "tc_cluster_launches",
          "tc_cluster_bwd_launches", "hd_stream_launches", "hd_stream_bwd_launches",
          "stream_launches", "stream_bwd_launches")
# the sparse-graph wrappers' routes (ops/sparse.py graph_plan), counted apart
GRAPH_ROUTES = ("row", "tile", "csr")
GRAPH_COUNTS = ("launches", "bwd_launches",
                *(f"{r}_{a}" for r in GRAPH_ROUTES for a in ("launches", "bwd_launches")))
# the routes a wrapper counts apart: "<name>.tc" from tc_<attr>; and
# flash_mha_packed's and flash_mha's two-warpgroup route past hd_pad 144,
# "<name>.tc_wide", and their routes past hd 368, "<name>.tc_cluster" (bf16)
# and "<name>.hd_stream" (f32; the fused layer's attention past it too);
# the fused layer's "stream" route, "<name>.stream"; spmm_segment_softmax's
# and sddmm's "<name>.row", "<name>.tile", "<name>.csr"
ROUTE_COUNTS = ("tc", "tc_wide", "tc_cluster", "hd_stream", "stream", *GRAPH_ROUTES)


def reset_counts(wrappers):
    """Set every launch count of the wrappers to 0 (flash_mha_packed and
    flash_mha also count their tensor-core launches apart, as tc_launches /
    tc_bwd_launches and tc_wide_launches / tc_wide_bwd_launches; the
    sparse-graph wrappers each route's)."""
    for fn in wrappers:
        for attr in (*COUNTS, *GRAPH_COUNTS):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_counts(wrappers, attr):
    """{wrapper name: count}, plus "<name>.<route>" where the wrapper counts
    its launches on that route apart (ROUTE_COUNTS)."""
    out = {fn.__name__: getattr(fn, attr) for fn in wrappers}
    out.update({f"{fn.__name__}.{r}": getattr(fn, f"{r}_{attr}") for fn in wrappers
                for r in ROUTE_COUNTS if hasattr(fn, f"{r}_{attr}")})
    return out


def check_tc(what, *counts):
    """Every flash_mha_packed launch in these counts took the tensor-core
    route (the model's attention operands are bf16)."""
    for c in counts:
        if c["flash_mha_packed"] <= 0 or c["flash_mha_packed.tc"] != c["flash_mha_packed"]:
            raise AssertionError(f"{what}: flash_mha_packed launches off the "
                                 f"tensor-core route: {c}")


def check_fused_tc(what, *counts):
    """Every fused_encoder_layer launch in these counts took the
    tensor-core route (bf16 operands: PAM's and PAM-sw's widths)."""
    for c in counts:
        if (c["fused_encoder_layer"] <= 0
                or c["fused_encoder_layer.tc"] != c["fused_encoder_layer"]):
            raise AssertionError(f"{what}: fused_encoder_layer launches off the "
                                 f"tensor-core route: {c}")


def check_fused_tc_wide(what, *counts):
    """Every fused_encoder_layer launch in these counts ran its attention
    on two warpgroups ("tc_wide": bf16 past hd_pad 144, PAM-sw's hd 170)."""
    check_fused_tc(what, *counts)
    for c in counts:
        if c["fused_encoder_layer.tc_wide"] != c["fused_encoder_layer"]:
            raise AssertionError(f"{what}: fused_encoder_layer attention launches off "
                                 f"the tc_wide route: {c}")


def check_graph_row(what, *counts):
    """Every spmm_segment_softmax launch in these counts took the "row"
    route (the model's gather_target=True: each segment's own row)."""
    for c in counts:
        n = c["spmm_segment_softmax"]
        if n <= 0 or c["spmm_segment_softmax.row"] != n:
            raise AssertionError(f"{what}: spmm_segment_softmax launches off the row "
                                 f"route: {c}")


def check_tc_wide(what, *counts):
    """Every flash_mha_packed launch in these counts took the two-warpgroup
    tensor-core route (bf16 operands past hd_pad 144: P12's sensor-wise hd
    360)."""
    for c in counts:
        if (c["flash_mha_packed"] <= 0
                or c["flash_mha_packed.tc_wide"] != c["flash_mha_packed"]):
            raise AssertionError(f"{what}: flash_mha_packed launches off the "
                                 f"tc_wide route: {c}")


@contextlib.contextmanager
def plain_kernels():
    """The encoder's kernel rungs run their wrappers' plain versions on the
    card, operands rounded as the kernels round them: the plain path at the
    kernels' precision (the dense rung attends in f32), which serve_phase
    serves beside the kernels to see how far its rows move across batches."""
    from raindrop_tpu_torch.nn import transformer as tr
    from raindrop_tpu_torch.ops import flash_attention as fa
    from raindrop_tpu_torch.ops import fused_encoder as fe

    saved = tr.flash_mha_packed, tr.fused_encoder_layer, tr.flash_mha
    tr.flash_mha_packed = lambda q, k, v, lengths, seed, rate, cd, nhead, origin=None: (
        fa._packed_fwd_plain(q, k, v, lengths, nhead, fa.operand_dtype(cd),
                             fa._seed_int(seed), rate, origin)[0])
    tr.fused_encoder_layer = lambda p, x, lengths, seed, rate, cd, nhead, origin=None: (
        fe._fused_fwd_plain(p, x, lengths, nhead, fa.operand_dtype(cd),
                            fa._seed_int(seed), rate, origin)[0])
    tr.flash_mha = lambda q, k, v, lengths, seed, rate, cd, origin=None: (
        fa._flash_fwd_plain(q, k, v, lengths, fa.operand_dtype(cd),
                            fa._seed_int(seed), rate, origin)[0])
    try:
        yield
    finally:
        tr.flash_mha_packed, tr.fused_encoder_layer, tr.flash_mha = saved


def serve_phase(dataset, kernel_fns, wrappers, device="cuda", seed=0,
                cfg_overrides=None, plain_overrides=PLAIN_ATTENTION,
                buckets=(1, 8, 32, 128), batch_limit=1e-5):
    """Serve one preset at full width and check it. Every wrapper's launch
    count is set to 0 just before the served requests and read just after;
    returns those counts by wrapper name. `kernel_fns` are the wrappers
    this path must go through; `plain_overrides` turn its config into the
    plain path it is held against; `batch_limit` bounds how far a row's
    probabilities may move with the batch it is served in (other buckets
    give cuBLAS other GEMM algorithms: the last bits move). The dense plain
    server's own stream-against-predict difference is printed beside."""
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer

    kw = dict(cfg_overrides or {})
    cfg = dataset_config(dataset, **kw)
    params = raindrop_init(seed, cfg, device=device)
    server = InferenceServer(cfg, params, buckets=buckets, device=device)
    top = buckets[-1]
    P, times, static = make_requests(cfg, top + 72, seed + 1)

    t0 = time.perf_counter()
    reset_counts(wrappers)
    outs = {n: server.predict(P[:n], times[:n], _rows(static, slice(0, n)))
            for n in (1, 5, top, top + 72)}
    results = [None] * 4

    def client(i):
        sl = slice(10 * i, 10 * i + 7)
        results[i] = server.submit(P[sl], times[sl], _rows(static, sl),
                                   timeout=300)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"{dataset}: submit from 4 threads did not finish")
    reqs = [(P[s:s + 8], times[s:s + 8], _rows(static, slice(s, s + 8)))
            for s in range(0, 48, 8)]
    streamed = list(server.predict_stream(reqs, depth=3))
    wire = InferenceServer(cfg, server.params, buckets=buckets, device=device,
                           transfer_dtype="bfloat16")
    wire_probs = wire.predict(P[:top], times[:top], _rows(static, slice(0, top)))
    launches = read_counts(wrappers, "launches")
    served_s = time.perf_counter() - t0
    # model forwards behind those requests, for the launches-per-forward checks
    forwards = server.health()["batches"] + wire.health()["batches"]
    wire.close()
    print(f"[serve] {dataset}: served in {served_s:.3f} s, launches "
          f"{launches}; health {server.health()}", flush=True)

    full = outs[top + 72]
    all_probs = [*outs.values(), *results, *streamed, wire_probs]
    for pr in all_probs:
        if not np.isfinite(pr).all() or np.abs(pr.sum(-1) - 1).max() > 1e-5:
            raise AssertionError(f"{dataset}: probabilities not finite or not "
                                 f"summing to 1")
    checks = {
        "alone_vs_full_bucket": float(np.abs(outs[1][0] - outs[top][0]).max()),
        "predict_vs_chunked": float(np.abs(outs[top] - full[:top]).max()),
        "submit_vs_predict": max(float(np.abs(results[i] - full[10 * i:10 * i + 7]).max())
                                 for i in range(4)),
        "stream_vs_predict": float(np.abs(np.concatenate(streamed) - full[:48]).max()),
        "bf16_wire_vs_f32": float(np.abs(wire_probs - outs[top]).max()),
    }
    limits = {"alone_vs_full_bucket": batch_limit, "predict_vs_chunked": batch_limit,
              "submit_vs_predict": batch_limit, "stream_vs_predict": batch_limit,
              "bf16_wire_vs_f32": 5e-2}
    batch = {}

    # the same params on the dense plain path, and the kernel path with
    # f32 attention operands; each one's rows streamed 8 at a time against
    # the same rows in the top bucket (its own batch dependence), and the
    # kernels' plain versions in bf16 beside
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        c_k = dataset_config(dataset, **{**kw, "attention_score_dtype": score})
        c_d = dataset_config(dataset, **{**kw, **plain_overrides,
                                         "attention_score_dtype": score})
        s_k = InferenceServer(c_k, server.params, buckets=buckets, device=device)
        s_d = InferenceServer(c_d, server.params, buckets=buckets, device=device)
        a = s_k.predict(P[:top], times[:top], _rows(static, slice(0, top)))
        b = s_d.predict(P[:top], times[:top], _rows(static, slice(0, top)))
        checks[f"kernel_vs_dense_{score}"] = float(np.abs(a - b).max())
        limits[f"kernel_vs_dense_{score}"] = tol
        for path, srv, top_probs in (("kernel", s_k, a), ("dense", s_d, b)):
            batch[f"{path}_{score}"] = float(np.abs(np.concatenate(
                list(srv.predict_stream(reqs, depth=3))) - top_probs[:48]).max())
        if score == "bfloat16":
            with plain_kernels():
                c = s_k.predict(P[:top], times[:top], _rows(static, slice(0, top)))
                batch["plain_bfloat16"] = float(np.abs(np.concatenate(
                    list(s_k.predict_stream(reqs, depth=3))) - c[:48]).max())
            batch["kernel_vs_plain_bfloat16"] = float(np.abs(a - c).max())
        s_k.close()
        s_d.close()
    checks["kernel_float32_stream_vs_predict"] = batch["kernel_float32"]
    limits["kernel_float32_stream_vs_predict"] = 1e-5
    # the plain path at the kernels' precision holds the batch limit too
    checks["plain_bfloat16_stream_vs_predict"] = batch["plain_bfloat16"]
    limits["plain_bfloat16_stream_vs_predict"] = batch_limit
    print(f"[serve] {dataset}: checks {checks}; stream_vs_predict by path and "
          f"operand dtype {batch}", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{dataset}: checks over their limits: {bad} "
                             f"(limits {limits})")
    for fn in kernel_fns:
        if launches[fn.__name__] <= 0:
            raise AssertionError(f"{dataset}: the served path never launched "
                                 f"{fn.__name__}")
    timing = serve_timing(dataset, server, P, times, static)
    server.close()
    return launches, dict(served_s=served_s, forwards=forwards, checks=checks,
                          limits=limits, stream_vs_predict_by_path=batch, **timing)


def split_route(hd, dtype):
    """The route of flash_mha's launch plan at head dim hd: the tensor cores
    in bf16 (one warpgroup to hd_pad 144, "tc"; two past it, "tc_wide"),
    the scalar kernels in f32."""
    from raindrop_tpu_torch.ops import flash_attention as fa

    if dtype != "bfloat16":
        return "scalar"
    return "tc" if -(-hd // 16) * 16 <= fa.TC_MAX_HD_PAD else "tc_wide"


def check_split_route(what, route, *counts):
    """Every flash_mha launch in these counts (forward or backward; the
    model's operands are bf16) took `route`: no bf16 launch on another."""
    for c in counts:
        if c["flash_mha"] <= 0 or c[f"flash_mha.{route}"] != c["flash_mha"]:
            raise AssertionError(f"{what}: flash_mha launches off the {route} route: {c}")


def check_two_a_forward(label, launches, serve):
    """A served 2048-step path launched flash_mha twice a forward (once a
    layer) and no other kernel (its route counts, flash_mha.tc and
    flash_mha.tc_wide, are those launches again)."""
    if launches["flash_mha"] != 2 * serve["forwards"]:
        raise AssertionError(
            f"{label}: two flash_mha launches per forward expected, got "
            f"{launches['flash_mha']} for {serve['forwards']} forwards")
    others = {k: v for k, v in launches.items()
              if k != "flash_mha" and not k.startswith("flash_mha.") and v}
    if others:
        raise AssertionError(f"{label}: the served path launched other kernels: {others}")


def profile_device(fn, n):
    """Run fn() under torch.profiler: (wall ms, device ms, idle share, top
    device operations), all per one of the `n` units of work fn does."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    kernels = {}
    for evt in prof.key_averages():
        # kernels and copies only: an annotation such as the optimizer's
        # step is mirrored on the device timeline and would count twice
        if (getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.key.startswith("Optimizer.")):
            us = getattr(evt, "self_device_time_total", 0.0)
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / (1e3 * n)
    device_ms = sum(kernels.values())
    top_k = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    idle = 1.0 - device_ms / wall_ms if device_ms > 0 else None
    return wall_ms, device_ms, idle, top_k


def serve_timing(dataset, server, P, times, static, reps=7):
    """Request latency by bucket (host clock around predict, which ends in
    the device-to-host copy) and a profile of the top bucket: device time
    by kernel and the device's idle share of the request's wall time."""
    latency = {}
    for n in server.buckets:
        args = (P[:n], times[:n], _rows(static, slice(0, n)))
        server.predict(*args)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            server.predict(*args)
            ts.append(1e3 * (time.perf_counter() - t0))
        latency[n] = float(np.median(ts))
    top = server.buckets[-1]
    args = (P[:top], times[:top], _rows(static, slice(0, top)))
    wall_ms, device_ms, idle, top_k = profile_device(
        lambda: [server.predict(*args) for _ in range(3)], 3)
    print(f"[serve] {dataset}: predict latency ms by bucket {latency}; top "
          f"bucket profiled: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"idle share {idle}", flush=True)
    for name, ms in top_k.items():
        print(f"[serve] {dataset}:   {ms:8.4f} ms  {name[:100]}", flush=True)
    return dict(latency_ms=latency, profile_wall_ms=wall_ms,
                profile_device_ms=device_ms, idle_share=idle,
                device_ms_by_kernel=top_k)


# ---------------------------------------------------------------- training
def make_split(cfg, n, seed, device):
    """A synthetic labelled split resident on `device`, batch-major:
    make_requests plus labels cycling through the classes."""
    import torch

    P, times, static = make_requests(cfg, n, seed)
    y = (np.arange(n) % cfg.n_classes).astype(np.int64)
    data = {"P": torch.from_numpy(P), "time": torch.from_numpy(times),
            "y": torch.from_numpy(y)}
    if static is not None:
        data["static"] = torch.from_numpy(static)
    return {k: v.to(device) for k, v in data.items()}, y


def grad_norm(trainer):
    import torch

    return float(torch.sqrt(sum((t.grad.double() ** 2).sum()
                                for _, t in trainer.live)))


def train_phase(dataset, kernel_fns, wrappers, device="cuda", seed=0, batch=128,
                cfg_overrides=None, plain_overrides=PLAIN_ATTENTION, fit_lr=1e-3):
    """Train one preset at full width and depth and check it. Every
    wrapper's counts are set to 0 just before the epoch and the predict and
    read just after; returns the forward and backward counts by wrapper
    name. `kernel_fns` are the wrappers this training must go through,
    forward and backward; `plain_overrides` turn its config into the plain
    path its first step and its steps at lr 1e-3 on one batch are held
    against; `fit_lr` is the learning rate of the falling-loss check on
    that batch, cut to its first DENSE_ROWS rows past MAX_FUSED_T steps."""
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.nn.transformer import encoder_rung
    from raindrop_tpu_torch.ops.flash_attention import MAX_FUSED_T
    from raindrop_tpu_torch.train.trainer import Trainer, flatten_params
    from raindrop_tpu_torch.utils.dropout import DropoutSeeds

    kw = dict(cfg_overrides or {})
    cfg = dataset_config(dataset, **kw)
    strategy = 3 if cfg.n_classes > 2 else 2
    tcfg = TrainConfig(dataset=dataset, learning_rate=1e-4, batch_size=batch,
                       batching_strategy=strategy, seed=seed + 1)
    rung = encoder_rung(cfg.attention_backend, cfg.max_len, cfg.d_transformer,
                        cfg.nhead, True)
    n = 5 * batch
    data, y = make_split(cfg, n, seed + 2, device)
    idx_np = np.stack(list(balanced_batches(
        y, batch, strategy, np.random.default_rng(seed),
        n_batches=6 if strategy == 3 else None)))
    idx = torch.from_numpy(idx_np).to(device)
    steps = idx.shape[0]
    print(f"[train] {dataset}: T={cfg.max_len} d={cfg.d_transformer} "
          f"ffn={cfg.ffn_dim} nlayers={cfg.nlayers} dropout={cfg.dropout} "
          f"operands {cfg.attention_score_dtype}; encoder rung: {rung}; "
          f"{steps} steps of {batch} from {n} samples (strategy {strategy})",
          flush=True)
    if steps < 5:
        raise AssertionError(f"{dataset}: an epoch of {steps} steps, need 5")

    trainer = Trainer(cfg, tcfg, device=device)
    before = {path: t.detach().clone() for path, t in flatten_params(trainer.params)}
    t0 = time.perf_counter()
    reset_counts(wrappers)
    losses, _ = trainer.train_epoch(data, idx)
    n_pred = min(200, n)    # two chunks of 100: the second is a padded tail
    P_host, time_host = (data[k][:n_pred].cpu().numpy() for k in ("P", "time"))
    static_host = data["static"][:n_pred].cpu().numpy() if "static" in data else None
    logits = trainer.predict(None, P_host, time_host, static_host)
    launches = read_counts(wrappers, "launches")
    bwd_launches = read_counts(wrappers, "bwd_launches")
    train_s = time.perf_counter() - t0
    print(f"[train] {dataset}: epoch + predict in {train_s:.3f} s; losses "
          f"{[round(float(x), 6) for x in losses]}; forward launches {launches}, "
          f"backward launches {bwd_launches}", flush=True)
    if not bool(torch.isfinite(losses).all()) or not np.isfinite(logits).all():
        raise AssertionError(f"{dataset}: a loss or a predicted logit is not finite")
    if logits.shape != (n_pred, cfg.n_classes):
        raise AssertionError(f"{dataset}: predict gave {logits.shape}")
    for fn in kernel_fns:
        if bwd_launches[fn.__name__] <= 0 or launches[fn.__name__] <= 0:
            raise AssertionError(f"{dataset}: training never launched "
                                 f"{fn.__name__} forward and backward")
    live = {path for path, _ in trainer.live}
    for path, t in flatten_params(trainer.params):
        same = torch.equal(t.detach(), before[path])
        if same == (path in live):
            raise AssertionError(f"{dataset}: parameter {path} is "
                                 f"{'unchanged' if same else 'changed'} after an epoch")
    if len(trainer.optimizer.state) != len(trainer.live):
        raise AssertionError(f"{dataset}: optimizer state for a dead parameter")

    # the same epoch from the same seeds: bit-equal losses
    again, _ = Trainer(cfg, tcfg, device=device).train_epoch(data, idx)
    if not torch.equal(again, losses):
        raise AssertionError(f"{dataset}: the same epoch twice gave {losses} "
                             f"and {again}")

    # first step's loss and gradient norm against the dense path, dropout 0
    rows = DENSE_ROWS if cfg.max_len > MAX_FUSED_T else None
    first = {k: v[idx[0][:rows]] for k, v in data.items()}
    checks, limits = {}, {}
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        pair = []
        for plain in ({}, plain_overrides):
            c = dataset_config(dataset, **{**kw, "dropout": 0.0, **plain,
                                           "attention_score_dtype": score})
            tr_ = Trainer(c, tcfg, device=device, params=trainer.params)
            loss, _ = tr_._backward(first, None)
            pair.append((float(loss), grad_norm(tr_)))
            del tr_
        (lk, gk), (ld, gd) = pair
        checks[f"loss_vs_dense_{score}"] = abs(lk - ld) / abs(ld)
        checks[f"grad_norm_vs_dense_{score}"] = abs(gk - gd) / gd
        limits[f"loss_vs_dense_{score}"] = limits[f"grad_norm_vs_dense_{score}"] = tol
        print(f"[train] {dataset}: first step, {score} operands, dropout 0: loss "
              f"{lk:.7f} (dense {ld:.7f}), gradient norm {gk:.7f} (dense {gd:.7f})",
              flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{dataset}: against the dense path: {bad} "
                             f"(limits {limits})")

    # fit_lr on one fixed batch: the loss falls over 10 steps (measured
    # before and after under one fixed set of masks)
    fixed = DropoutSeeds.draw(torch.Generator().manual_seed(seed), cfg.nlayers)

    def fit_batch(lr):
        fit = Trainer(cfg, tcfg, device=device, params=trainer.params)
        fit.learning_rate = lr
        with torch.no_grad():
            before = float(fit.loss_fn(first, fixed)[0])
        steps = [float(fit.train_step(first)[0]) for _ in range(10)]
        with torch.no_grad():
            after = float(fit.loss_fn(first, fixed)[0])
        print(f"[train] {dataset}: fixed batch at lr {lr:g}: loss {before:.6f} -> "
              f"{after:.6f} after 10 steps; step losses "
              f"{[round(x, 5) for x in steps]}", flush=True)
        return before, after, steps

    loss0, loss1, fit_losses = fit_batch(fit_lr)
    if not loss1 < loss0:
        raise AssertionError(f"{dataset}: the loss did not fall: {loss0} -> {loss1}")

    # lr 1e-3 on that batch at dropout 0, ten steps on the kernel path and
    # on the dense one: the loss before and after the first step agree (the
    # first-step tolerances); past a jump of the loss the two part as the
    # JAX trainer parts from itself (tests/test_torch_sensor_wise.py), and
    # whether the dense path's loss falls there is FIT_LR_SW's witness
    follow = {}
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        runs = []
        for plain in ({}, plain_overrides):
            c = dataset_config(dataset, **{**kw, "dropout": 0.0, **plain,
                                           "attention_score_dtype": score})
            fit = Trainer(c, tcfg, device=device, params=trainer.params)
            fit.learning_rate = 1e-3
            runs.append([float(fit.train_step(first)[0]) for _ in range(10)])
            del fit
        (lk, ld) = runs
        follow[score] = dict(kernel=lk, dense=ld, first_two=max(
            abs(a - b) / abs(b) for a, b in zip(lk[:2], ld[:2])), limit=tol)
        print(f"[train] {dataset}: lr 1e-3, dropout 0, {score} operands, step "
              f"losses {[round(x, 5) for x in lk]}, dense {[round(x, 5) for x in ld]}: "
              f"the first two {follow[score]['first_two']:.3e} apart (limit {tol:g})",
              flush=True)
    bad = {k: v["first_two"] for k, v in follow.items() if not v["first_two"] <= v["limit"]}
    if bad:
        raise AssertionError(f"{dataset}: at lr 1e-3 the first step's losses part "
                             f"from the dense path's: {bad}")

    timing = train_timing(dataset, Trainer(cfg, tcfg, device=device,
                                           params=trainer.params), data, idx, batch)
    return launches, bwd_launches, dict(
        rung=rung, steps=steps, train_s=train_s, losses=[float(x) for x in losses],
        checks=checks, limits=limits, fixed_batch=(loss0, loss1),
        fixed_batch_losses=fit_losses, fit_lr=fit_lr, lr_1e3_vs_dense=follow,
        **timing)


def train_timing(label, timed, data, idx, batch):
    """Step ms by CUDA events around each step of an epoch (median), the
    epoch's samples/s by the host clock, then a profiled epoch: device ms
    a step, the idle share and the top kernels."""
    import torch

    steps = idx.shape[0]
    timed.train_epoch(data, idx[:2])
    step_ms = []
    for k in range(steps):
        b = {name: t[idx[k]] for name, t in data.items()}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        timed.train_step(b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    timed.train_epoch(data, idx)
    epoch_ms = 1e3 * (time.perf_counter() - t0)
    wall_ms, device_ms, idle, top_k = profile_device(
        lambda: timed.train_epoch(data, idx), steps)
    step_med = float(np.median(step_ms))
    sps = batch * steps / (epoch_ms / 1e3)
    print(f"[train] {label}: step {step_med:.3f} ms (median of {steps}, CUDA "
          f"events; all {[round(x, 3) for x in step_ms]}); epoch of {steps} steps "
          f"{epoch_ms:.3f} ms by the host clock = {sps:.1f} samples/s; profiled: "
          f"wall {wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, idle "
          f"share {idle}", flush=True)
    for name, ms in top_k.items():
        print(f"[train] {label}:   {ms:8.4f} ms/step  {name[:100]}", flush=True)
    return dict(step_ms=step_ms, step_ms_median=step_med, epoch_ms=epoch_ms,
                samples_per_s=sps, profile_wall_ms=wall_ms,
                profile_device_ms=device_ms, idle_share=idle,
                device_ms_by_kernel=top_k)


# ----------------------------------------------------------------- protocol
LONG = {"max_len": 2048}


def _history(result):
    return [{k: v for k, v in rec.items() if k != "elapsed_s"}
            for rec in result.history]


def _check_result(what, result, cfg, epochs):
    if len(result.history) != epochs:
        raise AssertionError(f"{what}: {len(result.history)} records for {epochs} epochs")
    for rec in result.history:
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{what}: a record is not finite: {rec}")
        if not (0.0 <= rec["val_auroc"] <= 1.0 and 0.0 <= rec["val_auprc"] <= 1.0):
            raise AssertionError(f"{what}: validation metrics outside [0, 1]: {rec}")
    if not all(0.0 <= v <= 1.0 for v in result.test_metrics.values()):
        raise AssertionError(f"{what}: test metrics outside [0, 1]: {result.test_metrics}")
    if result.test_confusion.shape != (cfg.n_classes, cfg.n_classes):
        raise AssertionError(f"{what}: confusion matrix {result.test_confusion.shape}")


def protocol_phase(wrappers, device="cuda", seed=0, batch=128, n=320, n_batches=3,
                   overrides=LONG, label="PAM-2048", epochs=3, route="tc"):
    """train_split with checkpoints, resume and the uninterrupted run on
    PAM's width with `overrides` (max_len 2048; with sensor_wise_mask too):
    epochs - 1 epochs with checkpoints, the last epoch resumed from the
    `_last` file, the uninterrupted run of `epochs`; the first step against
    the dense path; the step's time. Every flash_mha launch of the
    checkpointed run, forward and backward, must take `route` (the bf16
    operands' tensor-core route at the configuration's head dim). Returns
    flash_mha's forward and backward launch counts over the checkpointed
    run, and the details (route_launches: those on `route`)."""
    import dataclasses
    import tempfile

    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.nn.transformer import encoder_rung
    from raindrop_tpu_torch.ops.flash_attention import flash_mha
    from raindrop_tpu_torch.train.checkpoint import load_checkpoint
    from raindrop_tpu_torch.train.trainer import Trainer, flatten_params

    cfg = dataset_config("PAM", **overrides)
    tcfg = TrainConfig(dataset="PAM", num_epochs=epochs, learning_rate=1e-4,
                       batch_size=batch, batching_strategy=3,
                       n_batches_strategy3=n_batches, seed=seed + 1)
    T, d, H = cfg.max_len, cfg.d_transformer, cfg.nhead
    rung = encoder_rung(cfg.attention_backend, T, d, H, True)
    trainer = Trainer(cfg, tcfg, device=device)
    n_all = sum(t.numel() for _, t in flatten_params(trainer.params))
    n_live = sum(t.numel() for _, t in trainer.live)
    side = T * cfg.d_ob
    print(f"[protocol] {label}: PAM at max_len {T}, sensor_wise_mask "
          f"{cfg.sensor_wise_mask}: d={d}, ffn={cfg.ffn_dim}, {H} heads of "
          f"{d // H}, {cfg.nlayers} layers, {cfg.n_classes} classes; each propagation "
          f"layer holds 13 matrices' worth of {side}^2 f32 = "
          f"{13 * side * side * 4 / 1e9:.2f} GB; {n_all / 1e6:.1f} M parameters "
          f"({4 * n_all / 1e9:.2f} GB), {n_live / 1e6:.1f} M live, Adam moments "
          f"{8 * n_live / 1e9:.2f} GB; attention: B*H = {batch * H} heads of {T} x {T}; "
          f"encoder rung: {rung}", flush=True)
    if rung != "flash_mha":
        raise AssertionError(f"max_len {T} must take the flash_mha rung, got {rung}")
    t0 = time.perf_counter()
    split = synthetic_split("PAM", n, seed, T=T)
    n_train, n_val, n_test = len(split.ytrain), len(split.yval), len(split.ytest)
    print(f"[protocol] {label}: synthetic_split: {n_train} train, {n_val} val, {n_test} test, "
          f"made in {time.perf_counter() - t0:.1f} s; {n_batches} batches of {batch} "
          f"an epoch (sampler strategy 3), dropout {cfg.dropout}, operands "
          f"{cfg.attention_score_dtype}", flush=True)

    def chunks(m):          # predict's chunks of 100 rows
        return -(-m // 100)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, label)
        # epochs - 1 epochs with checkpoints: the run that gets interrupted
        cut_epochs = epochs - 1
        trainer.tcfg = dataclasses.replace(tcfg, num_epochs=cut_epochs)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        cut = trainer.train_split(split, checkpoint_path=path, verbose=False)
        cut_s = time.perf_counter() - t0
        fwd, bwd = flash_mha.launches, flash_mha.bwd_launches
        on_route = (getattr(flash_mha, f"{route}_launches"),
                    getattr(flash_mha, f"{route}_bwd_launches"))
        _check_result(f"{label} train_split, {cut_epochs} epochs", cut, cfg, cut_epochs)
        steps = cut_epochs * n_batches
        want_fwd = cfg.nlayers * (steps + cut_epochs * chunks(n_val) + chunks(n_test))
        sizes = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        print(f"[protocol] {label}: {cut_epochs} epochs + test in {cut_s:.1f} s: "
              f"history {_history(cut)}; "
              f"test {cut.test_metrics}; flash_mha launches {fwd} forward (expected "
              f"{want_fwd}), {bwd} backward (expected {cfg.nlayers * steps}); "
              f"files {sizes}", flush=True)
        if fwd != want_fwd or bwd != cfg.nlayers * steps:
            raise AssertionError(f"{label} train_split: flash_mha launch counts are off")
        if on_route != (fwd, bwd):
            raise AssertionError(f"{label} train_split: flash_mha launches off the {route} "
                                 f"route: {on_route} of {(fwd, bwd)}")
        best, _, meta = load_checkpoint(path, trainer.params)
        for (name, a), (_, b) in zip(flatten_params(best), flatten_params(cut.params)):
            if not torch.equal(a, b.detach()):
                raise AssertionError(f"the best file does not reload: {name}")
        if meta["config"]["max_len"] != T:
            raise AssertionError("the best file's sidecar lost its config")
        del best, cut
        # a fresh trainer picks the run up for its last epoch
        del trainer
        torch.cuda.empty_cache()
        trainer = Trainer(cfg, tcfg, device=device)
        t0 = time.perf_counter()
        resumed = trainer.train_split(split, checkpoint_path=path,
                                      resume_from=path + "_last", verbose=False)
        resume_s = time.perf_counter() - t0
    _check_result(f"{label} train_split, resumed", resumed, cfg, epochs)
    # the same trainer, from scratch again, uninterrupted and without files
    t0 = time.perf_counter()
    full = trainer.train_split(split, verbose=False)
    full_s = time.perf_counter() - t0
    _check_result(f"{label} train_split, {epochs} epochs", full, cfg, epochs)
    print(f"[protocol] {label}: resumed last epoch in {resume_s:.1f} s, uninterrupted "
          f"{epochs} epochs in {full_s:.1f} s ({full.samples_per_sec:.1f} samples/s with "
          f"validation): history {_history(full)}; test {full.test_metrics}", flush=True)
    if _history(resumed) != _history(full) or resumed.test_metrics != full.test_metrics:
        raise AssertionError(f"{label}: the resumed run differs from the uninterrupted one: "
                             f"{_history(resumed)} vs {_history(full)}")
    del resumed

    # first step's loss and gradient norm against the dense path, dropout 0,
    # on DENSE_ROWS samples
    data = {"P": torch.from_numpy(split.Ptrain[:DENSE_ROWS]).to(device),
            "time": torch.from_numpy(split.Ptrain_time[:DENSE_ROWS]).to(device),
            "y": torch.from_numpy(split.ytrain[:DENSE_ROWS]).to(device).long()}
    checks, limits = {}, {}
    for score, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        pair = []
        for plain in ({}, PLAIN_ATTENTION):
            c = dataset_config("PAM", **{**overrides, "dropout": 0.0, **plain,
                                        "attention_score_dtype": score})
            tr_ = Trainer(c, tcfg, device=device, params=trainer.params)
            loss, _ = tr_._backward(data, None)
            pair.append((float(loss), grad_norm(tr_)))
            del tr_
        (lk, gk), (ld, gd) = pair
        checks[f"loss_vs_dense_{score}"] = abs(lk - ld) / abs(ld)
        checks[f"grad_norm_vs_dense_{score}"] = abs(gk - gd) / gd
        limits[f"loss_vs_dense_{score}"] = limits[f"grad_norm_vs_dense_{score}"] = tol
        print(f"[protocol] {label}: first step on {DENSE_ROWS} samples, {score} operands, "
              f"dropout 0: loss "
              f"{lk:.7f} (dense {ld:.7f}), gradient norm {gk:.7f} (dense {gd:.7f})",
              flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{label} against the dense path: {bad} (limits {limits})")
    torch.cuda.empty_cache()

    # timings: CUDA events around each step, then an epoch, then a profile
    train_dev = {"P": torch.from_numpy(split.Ptrain).to(device),
                 "time": torch.from_numpy(split.Ptrain_time).to(device),
                 "y": torch.from_numpy(split.ytrain).to(device).long()}
    idx = torch.stack([torch.randperm(n_train, generator=torch.Generator().manual_seed(i))
                       [:batch] for i in range(n_batches)]).to(device)
    trainer.train_epoch(train_dev, idx[:1])
    step_ms = []
    for k in range(n_batches):
        b = {name: t[idx[k]] for name, t in train_dev.items()}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_step(b)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    trainer.train_epoch(train_dev, idx)
    epoch_ms = 1e3 * (time.perf_counter() - t0)
    wall_ms, device_ms, idle, top_k = profile_device(
        lambda: trainer.train_epoch(train_dev, idx), n_batches)
    step_med = float(np.median(step_ms))
    sps = batch * n_batches / (epoch_ms / 1e3)
    print(f"[protocol] {label}: step {step_med:.3f} ms (median of {n_batches}, CUDA "
          f"events; all {[round(x, 3) for x in step_ms]}); epoch of {n_batches} steps "
          f"{epoch_ms:.3f} ms by the host clock = {sps:.1f} samples/s; profiled: wall "
          f"{wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, idle share {idle}",
          flush=True)
    for name, ms in top_k.items():
        print(f"[protocol] {label}:   {ms:8.4f} ms/step  {name[:100]}", flush=True)
    return fwd, bwd, dict(
        label=label, epochs=epochs, rung=rung, route=route, route_launches=on_route,
        params=n_all, live_params=n_live,
        split=(n_train, n_val, n_test),
        cut_s=cut_s, resume_s=resume_s, full_s=full_s, files=sizes,
        history=_history(full), test=full.test_metrics, checks=checks, limits=limits,
        step_ms=step_ms, step_ms_median=step_med, epoch_ms=epoch_ms,
        samples_per_s=sps, profile_wall_ms=wall_ms, profile_device_ms=device_ms,
        idle_share=idle, device_ms_by_kernel=top_k)


def run_splits_phase(device="cuda", seed=0, batch=128, n=320, n_batches=2):
    """run_splits, 2 splits of 1 epoch, for the summary's shape, at PAM's
    own window (600 steps: the 2048-step window's 7 GB checkpoint files,
    two a split, took most of a minute and more; protocol_phase trains and
    checkpoints that window)."""
    import tempfile

    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.train.trainer import run_splits

    cfg = dataset_config("PAM")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(dataset="PAM", num_epochs=1, learning_rate=1e-4,
                           batch_size=batch, batching_strategy=3,
                           n_batches_strategy3=n_batches, n_splits=2, seed=seed + 1,
                           checkpoint_dir=tmp)
        out = run_splits(lambda k: synthetic_split("PAM", n, seed + k, T=cfg.max_len),
                         cfg, tcfg, device=device, verbose=False)
        files = sorted(os.listdir(tmp))
    took = time.perf_counter() - t0
    print(f"[protocol] run_splits, 2 splits of 1 epoch, in {took:.1f} s: summary "
          f"{out['summary']}; files {files}", flush=True)
    names = {"accuracy", "auroc", "auprc", "precision", "recall", "f1"}
    if set(out["summary"]) != names or len(out["per_split"]) != 2:
        raise AssertionError(f"run_splits: summary {sorted(out['summary'])}")
    for name, s_ in out["summary"].items():
        if len(s_["per_split"]) != 2 or not (0.0 <= s_["mean"] <= 100.0
                                             and np.isfinite(s_["std"])):
            raise AssertionError(f"run_splits: {name} = {s_}")
    if len([f for f in files if f.endswith("_last.npz")]) != 2:
        raise AssertionError(f"run_splits: checkpoints {files}")
    return dict(seconds=took, summary=out["summary"])


# --------------------------------------------------------------------- main

# ------------------------------------------- mixed precision and use_beta
MIXED = {"compute_dtype": "bfloat16"}
# use_beta's dense block with prop_backend='pallas' asked for: the SpMM
# kernel's shared topology cannot hold each sample's pruned edges, so the
# model routes beta off it (models/raindrop.prop_branch)
BETA = {"use_beta": True, "prop_backend": "pallas"}


def _is_gemm(name):
    low = name.lower()
    return any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma"))


def prop_gemm_phase(label, cfg, params, B, device="cuda", seed=0, reps=5):
    """The forward's two propagation products (each layer's relu(lin_value
    x) at [B*F, T*d_ob] x [T*d_ob, T*d_ob], the dense branch) under the
    profiler, with the weights and x in f32 and in bf16: device ms a
    forward of the GEMM kernels and of every kernel, by dtype."""
    import torch
    from raindrop_tpu_torch.nn.linear import linear_apply

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, cfg.d_inp, cfg.max_len * cfg.d_ob), generator=gen,
                    device=device)
    out = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ws = [{k: v.detach().to(dt) for k, v in params[layer]["lin_value"].items()}
              for layer in ("ob_propagation", "ob_propagation_layer2")]
        xd = x.to(dt)

        @torch.no_grad()
        def forward():
            for _ in range(reps):
                h = xd
                for w in ws:
                    h = torch.relu(linear_apply(w, h))

        forward()
        _, device_ms, _, top_k = profile_device(forward, reps)
        gemm = sum(ms for k, ms in top_k.items() if _is_gemm(k))
        out[name] = dict(gemm_ms=gemm, device_ms=device_ms, kernels=top_k)
        print(f"[prop] {label} {name}: the two propagation GEMMs {gemm:.4f} ms "
              f"device a forward (all kernels {device_ms:.4f}): "
              f"{ {k[:60]: round(v, 4) for k, v in top_k.items()} }", flush=True)
        del ws, xd
    return out


def _probs_ok(what, probs, tol=1e-5):
    """f32 probabilities, finite, summing to 1 within `tol` (a softmax
    taken in bf16 sums to 1 within its rounding: 1e-2)."""
    if probs.dtype != np.float32:
        raise AssertionError(f"{what}: probabilities are {probs.dtype}, not float32")
    if not np.isfinite(probs).all() or np.abs(probs.sum(-1) - 1).max() > tol:
        raise AssertionError(f"{what}: probabilities not finite or not summing to 1")


def _first_step(cfg, tcfg, params, first, device, plain):
    """One step's loss, gradient norm and logits' dtype at dropout 0, on the
    kernels or on their plain versions; every live gradient must be f32
    (the master parameters' dtype) and finite."""
    import torch
    from raindrop_tpu_torch.train.trainer import Trainer

    tr_ = Trainer(cfg, tcfg, device=device, params=params)
    with plain_kernels() if plain else contextlib.nullcontext():
        loss, logits = tr_._backward(first, None)
    for path, t in tr_.live:
        g = t.grad
        if g is None or g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{cfg.compute_dtype}: the gradient of {path} is "
                                 f"{None if g is None else g.dtype}, or not finite")
    out = (float(loss), grad_norm(tr_), logits.dtype)
    del tr_
    return out


def mixed_phase(dataset, kernel_fns, wrappers, check_route, device="cuda", seed=0,
                batch=128, buckets=(1, 8, 32, 128)):
    """compute_dtype='bfloat16' at a preset's full width and depth, served
    and trained (f32 master parameters, the forward in bf16). Counts are
    set to 0 just before the served requests and before the epoch and read
    just after; every launch must take the tensor-core route
    (`check_route`). Served probabilities and the first step's loss and
    gradient norm (dropout 0) are held to 2e-2 against the same
    configuration on the kernels' plain versions; logits and gradients
    must be f32. Latency by bucket, step ms and samples/s are measured
    beside the f32 path's, and the propagation GEMMs' device time in both
    dtypes."""
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer
    from raindrop_tpu_torch.train.trainer import Trainer

    label = f"{dataset}-bf16"
    cfg32 = dataset_config(dataset)
    cfg16 = dataset_config(dataset, **MIXED)
    params = raindrop_init(seed, cfg32, device=device)
    top = buckets[-1]
    P, times, static = make_requests(cfg32, top + 72, seed + 1)
    s16 = InferenceServer(cfg16, params, buckets=buckets, device=device)
    s32 = InferenceServer(cfg32, params, buckets=buckets, device=device)
    reset_counts(wrappers)
    outs = {n: s16.predict(P[:n], times[:n], _rows(static, slice(0, n)))
            for n in (1, 5, top, top + 72)}
    launches = read_counts(wrappers, "launches")
    check_route(f"{label} serving", launches)
    for fn in kernel_fns:
        if launches[fn.__name__] <= 0:
            raise AssertionError(f"{label}: serving never launched {fn.__name__}")
    for n, pr in outs.items():
        _probs_ok(f"{label} served {n}", pr)
    with plain_kernels():
        plain = s16.predict(P[:top], times[:top], _rows(static, slice(0, top)))
    f32 = s32.predict(P[:top], times[:top], _rows(static, slice(0, top)))
    checks = {"kernel_vs_plain": float(np.abs(outs[top] - plain).max()),
              "alone_vs_full_bucket": float(np.abs(outs[1][0] - outs[top][0]).max()),
              "predict_vs_chunked": float(np.abs(outs[top] - outs[top + 72][:top]).max()),
              "bf16_vs_f32": float(np.abs(outs[top] - f32).max())}
    limits = {"kernel_vs_plain": 2e-2, "alone_vs_full_bucket": 2e-2,
              "predict_vs_chunked": 2e-2, "bf16_vs_f32": 5e-2}
    print(f"[mixed] {label}: served launches {launches}; checks {checks}", flush=True)
    serve16 = serve_timing(label, s16, P, times, static)
    serve32 = serve_timing(f"{dataset}-f32", s32, P, times, static)
    s16.close()
    s32.close()

    strategy = 3 if cfg32.n_classes > 2 else 2
    tcfg = TrainConfig(dataset=dataset, learning_rate=1e-4, batch_size=batch,
                       batching_strategy=strategy, seed=seed + 1)
    n = 5 * batch
    data, y = make_split(cfg32, n, seed + 2, device)
    idx = torch.from_numpy(np.stack(list(balanced_batches(
        y, batch, strategy, np.random.default_rng(seed),
        n_batches=6 if strategy == 3 else None)))).to(device)
    trainer = Trainer(cfg16, tcfg, device=device, params=params)
    reset_counts(wrappers)
    losses, _ = trainer.train_epoch(data, idx)
    P_host, time_host = (data[k][:200].cpu().numpy() for k in ("P", "time"))
    static_host = data["static"][:200].cpu().numpy() if "static" in data else None
    logits = trainer.predict(None, P_host, time_host, static_host)
    tf = read_counts(wrappers, "launches")
    tb = read_counts(wrappers, "bwd_launches")
    check_route(f"{label} training", tf, tb)
    for fn in kernel_fns:
        if tf[fn.__name__] <= 0 or tb[fn.__name__] <= 0:
            raise AssertionError(f"{label}: training never launched {fn.__name__} "
                                 f"forward and backward")
    if not bool(torch.isfinite(losses).all()) or not np.isfinite(logits).all():
        raise AssertionError(f"{label}: a loss or a predicted logit is not finite")
    if any(t.dtype != torch.float32 for _, t in trainer.live):
        raise AssertionError(f"{label}: a master parameter left float32")
    print(f"[mixed] {label}: epoch losses {[round(float(x), 6) for x in losses]}; "
          f"forward launches {tf}, backward {tb}", flush=True)
    del trainer

    first = {k: v[idx[0]] for k, v in data.items()}
    c0 = dataset_config(dataset, dropout=0.0, **MIXED)
    (lk, gk, dk), (lp, gp, _) = (_first_step(c0, tcfg, params, first, device, plain)
                                 for plain in (False, True))
    if dk != torch.float32:
        raise AssertionError(f"{label}: logits are {dk}, not float32")
    checks["loss_vs_plain"] = abs(lk - lp) / abs(lp)
    checks["grad_norm_vs_plain"] = abs(gk - gp) / gp
    limits["loss_vs_plain"] = limits["grad_norm_vs_plain"] = 2e-2
    print(f"[mixed] {label}: first step, dropout 0: loss {lk:.7f} (plain {lp:.7f}), "
          f"gradient norm {gk:.7f} (plain {gp:.7f}), logits {dk}, gradients f32",
          flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{label}: checks over their limits: {bad} (limits {limits})")

    train16 = train_timing(label, Trainer(cfg16, tcfg, device=device, params=params),
                           data, idx, batch)
    train32 = train_timing(f"{dataset}-f32", Trainer(cfg32, tcfg, device=device,
                                                     params=params), data, idx, batch)
    gemm = prop_gemm_phase(dataset, cfg32, params, batch, device, seed)
    print(f"[mixed] {dataset}: bf16 against f32 in this run: step "
          f"{train16['step_ms_median']:.3f} / {train32['step_ms_median']:.3f} ms, "
          f"{train16['samples_per_s']:.1f} / {train32['samples_per_s']:.1f} samples/s, "
          f"top bucket {serve16['latency_ms'][top]:.3f} / {serve32['latency_ms'][top]:.3f} "
          f"ms (device {serve16['profile_device_ms']:.3f} / "
          f"{serve32['profile_device_ms']:.3f}), propagation GEMMs "
          f"{gemm['bfloat16']['gemm_ms']:.4f} / {gemm['float32']['gemm_ms']:.4f} ms "
          f"device a forward", flush=True)
    return dict(serve_launches=launches, train_launches=tf, train_bwd_launches=tb,
                checks=checks, limits=limits, losses=[float(x) for x in losses],
                serve_bf16=serve16, serve_f32=serve32, train_bf16=train16,
                train_f32=train32, prop_gemm=gemm)


def mixed_long_phase(wrappers, f32_serve, device="cuda", seed=0,
                     buckets=(1, 8, 32, 128), steps=3):
    """The PAM-2048 server at compute_dtype='bfloat16': two flash_mha
    launches a forward and no other kernel, every one on the tensor cores;
    DENSE_ROWS rows held to 2e-2 against the kernels' plain versions; the
    top bucket's latency and device time beside phase 18's f32 ones
    (`f32_serve`), the propagation GEMMs' device time in both dtypes, and
    the training step (B=128, `steps` batches) in bf16 and f32."""
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer
    from raindrop_tpu_torch.train.trainer import Trainer

    label = "PAM-2048-bf16"
    cfg32 = dataset_config("PAM", **LONG)
    params = raindrop_init(seed, cfg32, device=device)
    server = InferenceServer(dataset_config("PAM", **LONG, **MIXED), params,
                             buckets=buckets, device=device)
    top = buckets[-1]
    P, times, static = make_requests(cfg32, top, seed + 1)
    reset_counts(wrappers)
    outs = {n: server.predict(P[:n], times[:n], _rows(static, slice(0, n)))
            for n in (1, 5, top)}
    launches = read_counts(wrappers, "launches")
    forwards = server.health()["batches"]
    check_two_a_forward(label, launches, {"forwards": forwards})
    check_split_route(f"{label} serving", "tc", launches)
    for n, pr in outs.items():
        _probs_ok(f"{label} served {n}", pr)
    rows = slice(0, DENSE_ROWS)
    a = server.predict(P[rows], times[rows], _rows(static, rows))
    with plain_kernels():
        b = server.predict(P[rows], times[rows], _rows(static, rows))
    checks = {"kernel_vs_plain": float(np.abs(a - b).max()),
              "alone_vs_full_bucket": float(np.abs(outs[1][0] - outs[top][0]).max())}
    limits = {"kernel_vs_plain": 2e-2, "alone_vs_full_bucket": 2e-2}
    print(f"[mixed] {label}: launches {launches} for {forwards} forwards; checks "
          f"{checks}", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{label}: checks over their limits: {bad} (limits {limits})")
    timing = serve_timing(label, server, P, times, static)
    server.close()
    del server
    gemm = prop_gemm_phase("PAM-2048", cfg32, params, top, device, seed)
    tcfg = TrainConfig(dataset="PAM", learning_rate=1e-4, batch_size=top,
                       batching_strategy=3, seed=seed + 1)
    data, y = make_split(cfg32, steps * top, seed + 2, device)
    idx = torch.from_numpy(np.stack(list(balanced_batches(
        y, top, 3, np.random.default_rng(seed), n_batches=steps)))).to(device)
    train = {}
    for name, c in (("bfloat16", dataset_config("PAM", **LONG, **MIXED)),
                    ("float32", cfg32)):
        timed = Trainer(c, tcfg, device=device, params=params)
        train[name] = train_timing(f"PAM-2048 {name}", timed, data, idx, top)
        del timed
        torch.cuda.empty_cache()
    print(f"[mixed] {label}: top bucket {timing['latency_ms'][top]:.3f} ms (device "
          f"{timing['profile_device_ms']:.3f}) against f32 "
          f"{f32_serve['latency_ms'][top]:.3f} ms (device "
          f"{f32_serve['profile_device_ms']:.3f}, phase 18); step "
          f"{train['bfloat16']['step_ms_median']:.3f} against "
          f"{train['float32']['step_ms_median']:.3f} ms", flush=True)
    return dict(launches=launches, forwards=forwards, checks=checks, limits=limits,
                prop_gemm=gemm, train=train, **timing)


def check_no_graph_kernel(what, *counts):
    """use_beta never reaches the sparse-graph kernels, 'pallas' or not."""
    for c in counts:
        if c["spmm_segment_softmax"] or c["sddmm"]:
            raise AssertionError(f"{what}: a sparse-graph kernel was launched: {c}")


def beta_graph_phase(wrappers, device="cuda", seed=0, B=32):
    """use_beta's two propagation forms at P12's width (B=32): the dense
    block (raindrop_propagate_beta_dense, factored on the all-ones graph)
    against two COO layers on the complete graph's edge list, the kept-edge
    masks equal and out and alpha within GRAPH_TOL; then one raindrop_apply
    with a random global_adj in [0.5, 2] (the COO beta branch) on the
    kernels beside the same global_adj on the plain path (dense
    attention), 1e-4 apart in f32 attention operands, and no sparse-graph
    kernel launched."""
    import torch
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.graph import propagate as prop
    from raindrop_tpu_torch.models.raindrop import (
        _complete_edges, raindrop_apply, raindrop_init)

    cfg = dataset_config("P12", **BETA)
    params = raindrop_init(seed, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    F, T = cfg.d_inp, cfg.max_len
    x = torch.randn((B, F, T * cfg.d_ob), generator=gen, device=device)
    pe = torch.randn((B, T, cfg.d_pe), generator=gen, device=device)
    p1, p2 = params["ob_propagation"], params["ob_propagation_layer2"]
    with torch.no_grad():
        adj = torch.ones((F, F), device=device)
        out_d, alpha_d, mask = prop.raindrop_propagate_beta_dense(
            p1, p2, x, pe, adj, ob_dim=cfg.d_ob, uniform_adj=True, return_mask=True)
        ei = torch.stack(_complete_edges(F, device))
        kw = dict(ob_dim=cfg.d_ob, n_nodes=F)
        out1, (ei2, a1) = prop.ob_propagate_coo(p1, x, pe, ei, adj.reshape(-1),
                                                use_beta=True, **kw)
        out_c, (_, a2) = prop.ob_propagate_coo(p2, out1, pe, ei2, a1, **kw)
    kept = torch.zeros((B, F * F), dtype=torch.bool, device=device)
    kept.scatter_(1, ei2[:, 0] * F + ei2[:, 1], True)
    same_mask = bool(torch.equal(kept.reshape(B, F, F), mask))
    err_out = rel_err(out_d, out_c)
    err_alpha = rel_err(alpha_d, a2[..., 0])
    print(f"[beta] dense block against COO at B={B}: kept-edge masks equal "
          f"{same_mask}, out {err_out:.3e}, alpha {err_alpha:.3e}", flush=True)
    if not same_mask or not err_out <= GRAPH_TOL or not err_alpha <= GRAPH_TOL:
        raise AssertionError("use_beta: the dense block and COO disagree")

    src, times, static = make_requests(cfg, B, seed + 3)
    src_t = torch.from_numpy(src).to(device).transpose(0, 1)
    times_t = torch.from_numpy(times).to(device).transpose(0, 1)
    static_t = torch.from_numpy(static).to(device)
    lengths = (times_t > 0).sum(dim=0)
    w = torch.rand((F, F), generator=gen, device=device) * 1.5 + 0.5
    outs = {}
    for name, over in (("kernels", {}), ("plain", PLAIN_ATTENTION)):
        c = dataset_config("P12", **BETA, **over, attention_score_dtype="float32")
        reset_counts(wrappers)
        with torch.no_grad():
            logits, dist = raindrop_apply(params, c, src_t, static_t, times_t,
                                          lengths, global_adj=w)
        counts = read_counts(wrappers, "launches")
        check_no_graph_kernel(f"use_beta global_adj {name}", counts)
        if name == "kernels" and counts["flash_mha_packed"] <= 0:
            raise AssertionError("use_beta global_adj: the encoder's kernel never ran")
        outs[name] = logits
    err = max_err(outs["kernels"], outs["plain"])
    print(f"[beta] raindrop_apply with a random global_adj (COO beta): kernels "
          f"against the plain path {err:.3e}", flush=True)
    if not err <= 1e-4 or not bool(torch.isfinite(outs["kernels"]).all()):
        raise AssertionError(f"use_beta global_adj: {err} against the plain path")
    return dict(masks_equal=same_mask, out_err=err_out, alpha_err=err_alpha,
                global_adj_err=err)


def bf16_storage_phase(wrappers, device="cuda", seed=0, batch=128):
    """dtype='bfloat16' at P12: parameters and Adam's moments stored in
    bf16. An epoch (finite losses, every packed launch on the tensor
    cores), the loss falling on a fixed batch over 10 steps at lr 1e-3, a
    checkpoint of parameters and optimizer state written and read back
    bit-equal, and a served request (f32 probabilities)."""
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer
    from raindrop_tpu_torch.train.checkpoint import (
        flatten_params, load_checkpoint, save_checkpoint)
    from raindrop_tpu_torch.train.trainer import Trainer
    from raindrop_tpu_torch.utils.dropout import DropoutSeeds

    label = "P12-bf16-storage"
    cfg = dataset_config("P12", dtype="bfloat16")
    tcfg = TrainConfig(dataset="P12", learning_rate=1e-4, batch_size=batch,
                       batching_strategy=2, seed=seed + 1)
    data, y = make_split(cfg, 5 * batch, seed + 2, device)
    idx = torch.from_numpy(np.stack(list(balanced_batches(
        y, batch, 2, np.random.default_rng(seed))))).to(device)
    trainer = Trainer(cfg, tcfg, device=device)
    if any(t.dtype != torch.bfloat16 for _, t in flatten_params(trainer.params)):
        raise AssertionError(f"{label}: a parameter is not stored in bf16")
    reset_counts(wrappers)
    losses, _ = trainer.train_epoch(data, idx)
    tf = read_counts(wrappers, "launches")
    tb = read_counts(wrappers, "bwd_launches")
    check_tc(f"{label} training", tf, tb)
    if not bool(torch.isfinite(losses.float()).all()):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    moments = [st[k].dtype for st in trainer.optimizer.state.values()
               for k in ("exp_avg", "exp_avg_sq")]
    if not moments or any(d != torch.bfloat16 for d in moments):
        raise AssertionError(f"{label}: Adam's moments are {set(moments)}, not bf16")

    first = {k: v[idx[0]] for k, v in data.items()}
    fixed = DropoutSeeds.draw(torch.Generator().manual_seed(seed), cfg.nlayers)
    fit = Trainer(cfg, tcfg, device=device, params=trainer.params)
    fit.learning_rate = 1e-3
    with torch.no_grad():
        before = float(fit.loss_fn(first, fixed)[0])
    steps = [float(fit.train_step(first)[0]) for _ in range(10)]
    with torch.no_grad():
        after = float(fit.loss_fn(first, fixed)[0])
    print(f"[bf16] {label}: epoch losses {[round(float(x), 5) for x in losses]}; "
          f"fixed batch at lr 1e-3: {before:.5f} -> {after:.5f} "
          f"({[round(x, 4) for x in steps]})", flush=True)
    if not after < before:
        raise AssertionError(f"{label}: the loss did not fall: {before} -> {after}")
    del fit

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        state = trainer.opt_state()
        save_checkpoint(path, trainer.params, state)
        params2, state2, _ = load_checkpoint(
            path, raindrop_init(seed, cfg, device=device), state)
    same = all(torch.equal(a.detach(), b) for (_, a), (_, b) in
               zip(flatten_params(trainer.params), flatten_params(params2)))
    same_opt = all(np.asarray(a).dtype == np.asarray(b).dtype
                   and np.asarray(a).tobytes() == np.asarray(b).tobytes()
                   for (_, a), (_, b) in zip(flatten_params(state), flatten_params(state2)))
    if not same or not same_opt:
        raise AssertionError(f"{label}: the checkpoint did not read back bit-equal "
                             f"(params {same}, optimizer {same_opt})")
    server = InferenceServer(cfg, params2, device=device)
    P, times, static = make_requests(cfg, 32, seed + 1)
    probs = server.predict(P, times, static)
    server.close()
    _probs_ok(f"{label} served", probs, 1e-2)
    print(f"[bf16] {label}: checkpoint bit-equal (params and Adam state), "
          f"served 32 rows", flush=True)
    return dict(train_launches=tf, train_bwd_launches=tb,
                losses=[float(x) for x in losses], fixed_batch=(before, after),
                fixed_batch_losses=steps, checkpoint_bit_equal=True)


# ------------------------------------------------- the experiment CLI (PR 14)
CLI_N = 640          # samples of the dataset files and the synthetic runs
CLI_EPOCHS = 2
# the streaming CLI phase's epochs: one of 30 batches, as it runs a third,
# profiled command (a cut for the script's time)
CLI_STREAM_EPOCHS = 1
MFU_TOL = 0.02       # step FLOPs with the kernels against the plain count


def write_p12_root(root, seed, n=CLI_N):
    """A P12 dataset root in the schema the reference reads (and the JAX
    package's data/preprocess.py writes): processed_data/PTdict_list.npy
    (per-sample dicts: 'arr' [215, 36] values with 0 for missing, 'time'
    [215, 1] minutes, 'extended_static' [9]), processed_data/
    arr_outcomes.npy ([n, 6]: length of stay in column 3, in-hospital death
    last), splits/phy12_split1.npy (idx_train, idx_val, idx_test, 8:1:1) and
    ig.npy, a Setting-2 ranking ([36, 2] rows of index and name). Every
    array comes from `seed` with numpy. Returns the ranking's path."""
    from raindrop_tpu_torch.data.datasets import synthetic_raw

    P, y = synthetic_raw("P12", n, seed, T=215)
    rng = np.random.default_rng(seed + 1)
    os.makedirs(os.path.join(root, "processed_data"))
    os.makedirs(os.path.join(root, "splits"))
    np.save(os.path.join(root, "processed_data", "PTdict_list.npy"), P,
            allow_pickle=True)
    outcomes = np.zeros((n, 6), np.float64)
    outcomes[:, 0] = 132539 + np.arange(n)
    outcomes[:, 3] = rng.integers(1, 30, size=n)
    outcomes[:, -1] = y
    np.save(os.path.join(root, "processed_data", "arr_outcomes.npy"), outcomes)
    perm = rng.permutation(n)
    n_tr, n_va = round(n * 0.8), round(n * 0.1)
    parts = np.empty(3, dtype=object)
    parts[:] = [perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:]]
    np.save(os.path.join(root, "splits", "phy12_split1.npy"), parts, allow_pickle=True)
    ranking = rng.permutation(36)
    ig = np.array([[int(i), f"sensor{i}"] for i in ranking], dtype=object)
    ig_path = os.path.join(root, "ig.npy")
    np.save(ig_path, ig, allow_pickle=True)
    return ig_path


def run_cli(wrappers, argv, label):
    """raindrop_tpu_torch.run.main(argv) with --out-json and --track-jsonl in
    a temporary directory (checkpoints there too), every launch count set
    to 0 just before and read just after. Returns (summary, epoch records,
    forward counts, backward counts, seconds)."""
    from raindrop_tpu_torch import run

    with tempfile.TemporaryDirectory() as tmp:
        argv = [a.replace("{tmp}", tmp) for a in argv]
        out, track = os.path.join(tmp, "out.json"), os.path.join(tmp, "track.jsonl")
        argv += ["--out-json", out, "--track-jsonl", track,
                 "--checkpoint-dir", os.path.join(tmp, "ckpt")]
        print(f"[cli] {label}: python -m raindrop_tpu_torch.run {' '.join(argv)}",
              flush=True)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        rc = run.main(argv)
        took = time.perf_counter() - t0
        fwd, bwd = (read_counts(wrappers, a) for a in ("launches", "bwd_launches"))
        if rc != 0:
            raise AssertionError(f"{label}: the CLI returned {rc}")
        with open(out) as f:
            summary = json.load(f)
        with open(track) as f:
            events = [json.loads(line) for line in f]
    records = [e for e in events if e["event"] == "epoch"]
    return summary, records, fwd, bwd, took


def check_cli(label, summary, records, key, epochs=CLI_EPOCHS):
    """Finite metrics in [0, 100] under `key`; `epochs` epoch records, each
    with an MFU in (0, 1) and finite TFLOP/s."""
    metrics = summary.get(key)
    if not metrics:
        raise AssertionError(f"{label}: no {key} in the summary {sorted(summary)}")
    for name, s in metrics.items():
        if not (np.isfinite(s["mean"]) and 0.0 <= s["mean"] <= 100.0
                and np.isfinite(s["std"])):
            raise AssertionError(f"{label}: {name} = {s}")
    if len(records) != epochs:
        raise AssertionError(f"{label}: {len(records)} epoch records for {epochs} epochs")
    for rec in records:
        m, tf = rec.get("mfu"), rec.get("train_tflops_per_sec")
        if m is None or not 0.0 < m < 1.0 or not np.isfinite(tf):
            raise AssertionError(f"{label}: an epoch record's MFU is not in (0, 1): {rec}")
    print(f"[cli] {label}: " + ", ".join(
        f"{n} {s['mean']:.2f}" for n, s in metrics.items()) + "; epochs: " + "; ".join(
        f"loss {r['train_loss']:.4f}, {r['train_tflops_per_sec']:.3f} TFLOP/s, "
        f"MFU {r['mfu']:.5f}" for r in records), flush=True)


def cli_files_phase(wrappers, seed=0):
    """The CLI through dataset files at P12's full width and depth: a P12
    root written by write_p12_root (640 samples), then forward imputation,
    Setting 2 at missing ratio 0.3 with the written ranking (--ig-scores),
    2 epochs of one split with MFU telemetry. Checks: rc 0, finite metrics,
    the packed pair's tensor-core launches counted forward and backward,
    every epoch record's MFU in (0, 1)."""
    with tempfile.TemporaryDirectory() as root:
        ig = write_p12_root(root, seed)
        summary, records, fwd, bwd, took = run_cli(wrappers, [
            "--dataset", "P12", "--data-root", root, "--n-splits", "1",
            "--epochs", str(CLI_EPOCHS), "--imputation", "forward",
            "--feature_removal_level", "set", "--missing-ratio", "0.3",
            "--ig-scores", ig, "--measure-mfu", "true", "--seed", str(seed + 1)],
            "P12 files")
    check_cli("P12 files", summary, records, "missing_0.3")
    check_tc("P12 files (CLI)", fwd, bwd)
    print(f"[cli] P12 files in {took:.1f} s; launches {fwd}, backward {bwd}", flush=True)
    return dict(seconds=took, summary=summary, records=records, launches=fwd,
                bwd_launches=bwd)


def cli_stream_phase(wrappers, seed=0):
    """The CLI on synthetic PAM (640 samples, full width and depth) through
    the streaming input pipeline with MFU telemetry, CLI_STREAM_EPOCHS
    epochs of one split (30 batches each), then the same command line with
    the resident
    pipeline, and the streaming one again on the numpy gathers
    (RAINDROP_TPU_NATIVE=0). Checks: rc 0, finite metrics, the fused layer's
    tensor-core launches counted forward and backward, every epoch record's
    MFU in (0, 1); the streaming run's batches gathered by the C++ host
    runtime (native.gather_rows' calls counted) and the numpy run's not;
    the streaming and resident runs' summaries and epoch records (but
    their wall-clock and MFU fields) equal. (The variable switches the
    normalization to numpy too, whose stats are 1e-15 apart from the
    runtime's: that run's losses part from the others' in the fourth or
    fifth digit, printed.) The two streaming runs are profiled: the CLI's
    wall ms and device ms a training step, and the device's idle share."""
    from raindrop_tpu_torch import native

    argv = ["--dataset", "PAM", "--synthetic", str(CLI_N), "--measure-mfu", "true",
            "--epochs", str(CLI_STREAM_EPOCHS), "--n-splits", "1", "--seed", str(seed + 1)]
    steps = 30 * CLI_STREAM_EPOCHS
    runs = {}
    for name, flag in (("streaming", None), ("streaming_numpy", "0")):
        calls = native.gather_rows.calls
        box = []
        with native_flag(flag) if flag else contextlib.nullcontext():
            prof = profile_device(lambda: box.append(run_cli(
                wrappers, argv + ["--input-pipeline", "streaming"], f"PAM {name}")), steps)
        runs[name] = (*box[0], native.gather_rows.calls - calls, prof)
    summary, records, fwd, bwd, took, gathers, prof = runs["streaming"]
    check_cli("PAM streaming", summary, records, "missing_0.0", CLI_STREAM_EPOCHS)
    check_fused_tc("PAM streaming (CLI)", fwd, bwd)
    np_gathers = runs["streaming_numpy"][5]
    if gathers < steps or np_gathers:
        raise AssertionError(f"PAM streaming (CLI): {gathers} C++ gathers for {steps} "
                             f"steps, {np_gathers} under RAINDROP_TPU_NATIVE=0")
    res_summary, res_records, _, _, res_took = run_cli(
        wrappers, argv + ["--input-pipeline", "resident"], "PAM resident")
    timing = ("elapsed_s", "train_tflops_per_sec", "mfu")

    def untimed(recs):
        return [{k: v for k, v in r.items() if k not in timing} for r in recs]

    if summary != res_summary or untimed(records) != untimed(res_records):
        raise AssertionError(f"PAM streaming (CLI): not equal to the resident run: "
                             f"{summary} against {res_summary}; "
                             f"{untimed(records)} against {untimed(res_records)}")
    np_losses = [r["train_loss"] for r in runs["streaming_numpy"][1]]
    profiled = {name: dict(wall_ms_a_step=r[6][0], device_ms_a_step=r[6][1],
                           idle_share=r[6][2], seconds=r[4]) for name, r in runs.items()}
    print(f"[cli] PAM streaming in {took:.1f} s (resident {res_took:.1f} s, summary "
          f"and epoch records equal); launches {fwd}, backward {bwd}; C++ gathers "
          f"{gathers}; epoch losses {[r['train_loss'] for r in records]}, on the numpy "
          f"path {np_losses}; profiled, C++ / numpy path: "
          + ", ".join(f"{k} {profiled['streaming'][k]} / {profiled['streaming_numpy'][k]}"
                      for k in ("wall_ms_a_step", "device_ms_a_step", "idle_share")),
          flush=True)
    return dict(seconds=took, resident_seconds=res_took, summary=summary,
                records=records, launches=fwd, bwd_launches=bwd, cpp_gathers=gathers,
                numpy_path_losses=np_losses, profiled=profiled)


def _train_config(dataset, **kw):
    from raindrop_tpu_torch.config import TrainConfig

    return TrainConfig(dataset=dataset, batching_strategy=3 if dataset == "PAM" else 2,
                       **kw)


def streaming_phase(device="cuda", seed=0, epochs=3):
    """At P12 (2560 synthetic samples: about 22 batches an epoch by the
    sampler's strategy 2) and PAM (640, 30 batches an epoch), full width and depth,
    one train_split of `epochs` epochs resident and streaming, each with
    measure_mfu off and on, from the same parameters and seed: the final
    parameters, the best ones, the history (but its wall-clock and MFU
    fields) and the test metrics of all four bit-equal. Each streaming run
    goes through the depth-2 executor's buffers some 70 to 90 times."""
    import torch
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.data.sampler import n_batches_per_epoch
    from raindrop_tpu_torch.train.checkpoint import flatten_params
    from raindrop_tpu_torch.train.trainer import Trainer

    timing = ("elapsed_s", "train_tflops_per_sec", "mfu")
    out = {}
    for dataset, n in (("P12", 4 * CLI_N), ("PAM", CLI_N)):
        cfg = dataset_config(dataset)
        split = synthetic_split(dataset, n, seed + 7)
        runs = {}
        for name, kw in (("resident", {}), ("streaming", {"input_pipeline": "streaming"}),
                         ("resident_mfu", {"measure_mfu": True}),
                         ("streaming_mfu", {"input_pipeline": "streaming",
                                            "measure_mfu": True})):
            tcfg = _train_config(dataset, num_epochs=epochs, seed=seed + 1, **kw)
            trainer = Trainer(cfg, tcfg, device=device)
            t0 = time.perf_counter()
            res = trainer.train_split(split, verbose=False)
            took = time.perf_counter() - t0
            runs[name] = dict(
                seconds=took,
                history=[{k: v for k, v in r.items() if k not in timing}
                         for r in res.history],
                mfu=[r.get("mfu") for r in res.history],
                test=res.test_metrics,
                final=[t.detach().clone() for _, t in flatten_params(trainer.params)],
                best=[t.detach().clone() for _, t in flatten_params(res.params)])
            del trainer, res
        ref = runs["resident"]
        for name, r in runs.items():
            same = (r["history"] == ref["history"] and r["test"] == ref["test"]
                    and all(torch.equal(a, b) for a, b in zip(r["final"], ref["final"]))
                    and all(torch.equal(a, b) for a, b in zip(r["best"], ref["best"])))
            if not same:
                raise AssertionError(f"streaming {dataset}: the {name} run is not "
                                     f"bit-equal to the resident one")
        for name in ("resident_mfu", "streaming_mfu"):
            if any(m is None or not 0.0 < m < 1.0 for m in runs[name]["mfu"]):
                raise AssertionError(f"streaming {dataset}: {name} MFU {runs[name]['mfu']}")
        steps = epochs * n_batches_per_epoch(split.ytrain, tcfg.batch_size,
                                             tcfg.batching_strategy,
                                             tcfg.n_batches_strategy3)
        print(f"[streaming] {dataset}: resident, streaming and both with measure_mfu "
              f"bit-equal over {epochs} epochs, {steps} steps (parameters, best "
              f"parameters, history, test metrics); seconds " + ", ".join(
                  f"{k} {v['seconds']:.2f}" for k, v in runs.items()), flush=True)
        out[dataset] = {k: dict(seconds=v["seconds"], mfu=v["mfu"], history=v["history"],
                                steps=steps)
                        for k, v in runs.items()}
        del runs
        torch.cuda.empty_cache()
    return out


def mfu_phase(wrappers, card, device="cuda", seed=0, batch=128, reps=5):
    """One training step's model FLOPs at P12 (the packed pair), PAM (the
    fused layer) and PAM-2048 (flash_mha), full width and depth, B=128,
    dropout 0.2: counted with the kernels (FlopCounterMode plus the
    kernels' credit, Trainer.step_flops; the credit must have launched)
    and with the plain versions on the card (PLAIN_ATTENTION: the dense
    rung, every matmul seen by the counter), on the same rows (at PAM-2048
    on DENSE_ROWS of them: the dense rung's [B, H, T, T] scores), held
    within MFU_TOL; then the step's CUDA-event time (median of `reps`), its
    MFU, and the MFU of the epoch record of a 1-epoch train_split with
    measure_mfu, beside the card's name and power limit."""
    import dataclasses

    import torch
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.train.trainer import Trainer
    from raindrop_tpu_torch.utils.diagnostics import device_peak_flops

    peak = device_peak_flops(device)
    if not peak:
        raise AssertionError(f"no bf16 peak for {torch.cuda.get_device_name(0)}: "
                             f"add it to utils/diagnostics.PEAK_BF16_FLOPS")
    out = {}
    for label, dataset, over, rows in (("P12", "P12", {}, batch),
                                       ("PAM", "PAM", {}, batch),
                                       ("PAM-2048", "PAM", LONG, DENSE_ROWS)):
        cfg = dataset_config(dataset, **over)
        tcfg = _train_config(dataset, num_epochs=1, n_batches_strategy3=3,
                             measure_mfu=True, seed=seed + 1)
        split = synthetic_split(dataset, 320, seed + 3, T=cfg.max_len)
        trainer = Trainer(cfg, tcfg, device=device)
        idx = next(balanced_batches(split.ytrain, batch, tcfg.batching_strategy,
                                    np.random.default_rng(seed)))
        host = {"P": split.Ptrain, "time": split.Ptrain_time, "y": split.ytrain}
        if split.Ptrain_static is not None:
            host["static"] = split.Ptrain_static
        dev = {k: torch.as_tensor(np.ascontiguousarray(a[idx])).to(
            device, torch.int64 if k == "y" else torch.float32) for k, a in host.items()}
        sub = {k: v[:rows] for k, v in dev.items()}
        reset_counts(wrappers)
        step_flops = trainer.step_flops(dev)
        kernel_flops = step_flops if rows == batch else trainer.step_flops(sub)
        launched = {fn.__name__: (fn.launches, fn.bwd_launches) for fn in wrappers}
        if not any(f > 0 and b > 0 for f, b in launched.values()):
            raise AssertionError(f"mfu {label}: no kernel launched in the count: {launched}")
        plain_flops = Trainer(dataclasses.replace(cfg, **PLAIN_ATTENTION), tcfg,
                              device=device, params=trainer.params).step_flops(sub)
        rel = abs(kernel_flops - plain_flops) / plain_flops
        times = []
        for _ in range(reps + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            trainer.train_step(dev)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        step_ms = float(np.median(times[1:]))
        step_mfu = step_flops / (step_ms / 1e3) / peak
        res = trainer.train_split(split, verbose=False)
        epoch_mfu = res.history[0]["mfu"]
        print(f"[mfu] {label} ({card}): step {step_flops / 1e9:.3f} GFLOP at B={batch} "
              f"(kernels {launched}); on {rows} rows kernels {kernel_flops / 1e9:.4f} "
              f"against plain {plain_flops / 1e9:.4f} GFLOP ({rel:.2e}); step "
              f"{step_ms:.3f} ms by events, MFU {step_mfu:.5f}; epoch record "
              f"{res.history[0]['train_tflops_per_sec']:.3f} TFLOP/s, MFU "
              f"{epoch_mfu:.5f}", flush=True)
        if not rel <= MFU_TOL:
            raise AssertionError(f"mfu {label}: kernels {kernel_flops} against plain "
                                 f"{plain_flops} FLOPs ({rel:.3e} > {MFU_TOL})")
        if epoch_mfu is None or not 0.0 < epoch_mfu < 1.0 or not 0.0 < step_mfu < 1.0:
            raise AssertionError(f"mfu {label}: MFU outside (0, 1): step {step_mfu}, "
                                 f"epoch {epoch_mfu}")
        out[label] = dict(step_flops=step_flops, compared_rows=rows,
                          kernel_flops=kernel_flops, plain_flops=plain_flops,
                          rel_diff=rel, step_ms=step_ms, step_ms_all=times,
                          step_mfu=step_mfu, epoch_mfu=epoch_mfu,
                          epoch_tflops_per_sec=res.history[0]["train_tflops_per_sec"],
                          launches=launched, peak_flops=peak, card=card)
        del trainer, res, dev, sub
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- baselines
# (label, T, hd) the four kernel families hand the packed pair at their
# presets (2 heads): the transformer and MoE at P12 (d 52) and eICU (d 30),
# the context-token transformer at T + 1 (d 64), Raindrop v1 (d 180, d 70)
BASELINE_HEADS = (("transformer P12", 215, 26), ("transformer_ctx P12", 216, 32),
                  ("raindrop_v1 P12", 215, 90), ("transformer eICU", 300, 15),
                  ("raindrop_v1 eICU", 300, 35))
BASELINE_STEPS = 5


def baseline_packed_phase(label, T, hd, B=128, H=2, device="cuda", seed=0):
    """flash_mha_packed in bf16 (the families' operand dtype) at one
    baseline head dim and T, B=128: the served forward (dropout 0) and the
    trained backward (0.2) against the plain versions (o and lse to TOL,
    gradients sample by sample to SAMPLE_TOL), on the "tc" route,
    bit-equal on a repeat, zeros for the length-0 sample; each timed by
    CUDA events beside SDPA (a key mask; its backward by autograd) and the
    bound."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    d, od = H * hd, torch.bfloat16
    q, k, v, g = (torch.randn((B, T, d), generator=gen, device=device)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)
    plan = fa.packed_plan(B, T, d, H, od)
    if plan.route != "tc":
        raise AssertionError(f"{label}: the packed pair took the {plan.route} route")
    o, lse = fa._packed_fwd_cuda(q, k, v, lengths, 0, 0.0, H, od)
    o2, _ = fa._packed_fwd_cuda(q, k, v, lengths, 0, 0.0, H, od)
    po, plse = fa._packed_fwd_plain(q, k, v, lengths, H, od)
    fo, flse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.2, H, od)
    args = (q, k, v, lengths, SEED, 0.2, H, od, fo, flse, g)
    got = fa._packed_bwd_cuda(*args)
    again = fa._packed_bwd_cuda(*args)
    want = fa._packed_bwd_plain(*args)
    torch.cuda.synchronize()
    fwd_err = max(max_err(o, po), max_err(lse, plse))
    o_sample = sample_err(o, po, lengths)
    bwd_err = max(sample_err(a, b, lengths) for a, b in zip(got, want))
    print(f"[baseline heads] {label} T={T} hd={hd} ({plan.route} route, hd padded "
          f"{plan.hd_pad}, copy {plan.copy_bytes} B): forward max_abs_err {fwd_err:.3e} "
          f"(tol {TOL['bfloat16']:g}), o sample_err {o_sample:.3e}; backward (dropout "
          f"0.2) sample_err {bwd_err:.3e} (tol {SAMPLE_TOL['bfloat16']:g})", flush=True)
    if fwd_err > TOL["bfloat16"] or bwd_err > SAMPLE_TOL["bfloat16"]:
        raise AssertionError(f"the packed pair disagrees with its plain version at {label}")
    if not torch.equal(o, o2) or not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"the packed pair is not bit-equal on a repeat at {label}")
    if not (bool((o[0] == 0).all()) and all(bool((a[0] == 0).all()) for a in got)
            and all(bool(torch.isfinite(a).all()) for a in (o, *got))):
        raise AssertionError(f"the packed pair: not finite, or the length-0 sample is "
                             f"not zero at {label}")
    qo, ko, vo = (x.to(od) for x in (q, k, v))
    fwd_ms = time_ms(lambda: fa._packed_fwd_cuda(qo, ko, vo, lengths, 0, 0.0, H, od))
    targs = (qo, ko, vo, lengths, SEED, 0.2, H, od, fo, flse, g)
    bwd_ms = time_ms(lambda: fa._packed_bwd_cuda(*targs))
    plain_fwd_ms = time_ms(lambda: fa._packed_fwd_plain(qo, ko, vo, lengths, H, od),
                           reps=5, warmup=1)
    plain_bwd_ms = time_ms(lambda: fa._packed_bwd_plain(*targs), reps=5, warmup=1)
    live = lengths > 0
    qh, kh, vh = (x[live].reshape(-1, T, H, hd).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (qo, ko, vo))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=keep))
    out = sdpa(qh, kh, vh, attn_mask=keep, dropout_p=0.2)
    gh = g[live].to(od).reshape(-1, T, H, hd).transpose(1, 2)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                      retain_graph=True))
    keys = float(lengths.sum())
    fwd_bound = bound(attention_bytes(lengths, T, d, H, 2), 4.0 * T * d * keys,
                      "bfloat16")
    bwd_bound = bound(attention_bytes(lengths, T, d, H, 2, backward=True),
                      10.0 * T * d * keys, "bfloat16")
    print(f"[baseline heads] {label}: forward {fwd_ms:.4f} ms (bound {fwd_bound[0]:.4f} "
          f"ms, {fwd_bound[1]}; plain {plain_fwd_ms:.4f}, SDPA {sdpa_fwd_ms:.4f}); "
          f"backward {bwd_ms:.4f} ms (bound {bwd_bound[0]:.4f} ms, {bwd_bound[1]}; "
          f"plain {plain_bwd_ms:.4f}, SDPA backward {sdpa_bwd_ms:.4f})", flush=True)
    return dict(label=label, T=T, hd=hd, hd_pad=plan.hd_pad,
                copy_bytes=plan.copy_bytes, fwd_max_abs_err=fwd_err,
                o_sample_err=o_sample, bwd_sample_err=bwd_err, fwd_ms=fwd_ms,
                bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
                sdpa_fwd_ms=sdpa_fwd_ms, sdpa_bwd_ms=sdpa_bwd_ms,
                fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])


def baseline_family_phase(name, dataset, wrappers, device="cuda", seed=0, batch=128,
                          steps=BASELINE_STEPS):
    """One baseline family (baselines/adapters.py) at its preset's
    published widths, random weights from `seed`, dropout 0.2: served
    through InferenceServer(apply_fn=...) on buckets 1 and `batch` (the
    counts set to 0 just before the two requests and read just after),
    the top bucket's probabilities held against the same server on the
    kernels' plain versions (plain_kernels: TOL with bf16 attention; 1e-5
    for a family without kernels, whose two runs are the same code),
    latency by bucket (host clock, median of 5); then trained: the same
    first step twice bit-equal (parameters and loss), `steps` steps of
    B=`batch` with finite losses (counts set to 0 just before, read just
    after), step ms by CUDA events and a profile of one step (device ms,
    idle share: the recurrences are host-bound). A kernel
    family (KERNEL_FAMILIES) must launch flash_mha_packed forward and
    backward, every launch on the tensor-core route; the others none."""
    import torch
    from raindrop_tpu_torch.baselines.adapters import KERNEL_FAMILIES, make_baseline
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.serve import InferenceServer
    from raindrop_tpu_torch.train.trainer import Trainer

    label = f"{name} {dataset}"
    cfg = dataset_config(dataset)
    fam = make_baseline(name, cfg, device=device)
    params = fam.init_fn(seed)
    kernels = name in KERNEL_FAMILIES
    P, times, static = make_requests(cfg, batch, seed + 1)
    requests = {n: (P[:n], times[:n], _rows(static, slice(0, n))) for n in (1, batch)}

    def serve_fn(p, src, st, tm, ln):
        return fam.apply_fn(p, src, st, tm, ln, False, None)[0]

    server = InferenceServer(cfg, params, buckets=(1, batch), apply_fn=serve_fn,
                             device=device)
    try:
        for req in requests.values():
            server.predict(*req)
        reset_counts(wrappers)
        probs = {n: server.predict(*req) for n, req in requests.items()}
        served = read_counts(wrappers, "launches")
        with plain_kernels():
            plain = server.predict(*requests[batch])
        latency = {}
        for n, req in requests.items():
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                server.predict(*req)
                ts.append(1e3 * (time.perf_counter() - t0))
            latency[n] = float(np.median(ts))
    finally:
        server.close()
    top = probs[batch]
    plain_err = float(np.abs(top - plain).max())
    tol = TOL["bfloat16"] if kernels else 1e-5
    row_shift = float(np.abs(probs[1][0] - top[0]).max())
    print(f"[baselines] {label}: served {served}; against the plain kernels "
          f"{plain_err:.3e} (tol {tol:g}); row 0 alone against in the top bucket "
          f"{row_shift:.3e}; latency ms by bucket {latency}", flush=True)
    if not (np.isfinite(top).all() and np.abs(top.sum(1) - 1.0).max() <= 1e-5
            and plain_err <= tol):
        raise AssertionError(f"{label}: served probabilities not finite, not summing "
                             f"to 1, or off the plain path ({plain_err:.3e})")

    tcfg = TrainConfig(dataset=dataset, batch_size=batch, learning_rate=1e-4)
    data, _ = make_split(cfg, 2 * batch, seed + 2, device)
    order = np.random.default_rng(seed).permutation(2 * batch)
    batches = [{k: t[torch.from_numpy(order[(i % 2) * batch:(i % 2 + 1) * batch]).to(
        device)] for k, t in data.items()} for i in range(steps)]

    def trainer():
        return Trainer(cfg, tcfg, device=device, params=params, init_fn=fam.init_fn,
                       apply_fn=fam.apply_fn, draw_seeds=fam.draw_seeds)

    seeds = (fam.draw_seeds(torch.Generator().manual_seed(seed), batch)
             if fam.draw_seeds else None)
    twice = [trainer() for _ in range(2)]
    first = [tr.train_step(batches[0], seeds)[0] for tr in twice]
    same = torch.equal(first[0], first[1]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(twice[0].live, twice[1].live))
    del twice
    tr = trainer()
    reset_counts(wrappers)
    losses, step_ms = [], []
    for b in batches:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss, _ = tr.train_step(b)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
    tf, tb = (read_counts(wrappers, a) for a in ("launches", "bwd_launches"))
    t_wall, t_dev, t_idle, t_top = profile_device(lambda: tr.train_step(batches[1]), 1)
    med = float(np.median(step_ms[1:]))
    print(f"[baselines] {label}: the first step twice bit-equal {same}; losses "
          f"{[round(x, 5) for x in losses]}; step {med:.3f} ms (median of steps "
          f"2-{steps}, CUDA events; all {[round(x, 3) for x in step_ms]}); profiled: wall "
          f"{t_wall:.3f} ms/step, device {t_dev:.3f} ms/step, idle share {t_idle}; "
          f"launches forward {tf}, backward {tb}", flush=True)
    for k, ms in list(t_top.items())[:4]:
        print(f"[baselines] {label}:   {ms:8.4f} ms/step  {k[:100]}", flush=True)
    if not same or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: the same step twice differs, or a loss is not "
                             f"finite: {losses}")
    if kernels:
        check_tc(f"{label} serving and training", served, tf, tb)
        if tb["flash_mha_packed"] <= 0:
            raise AssertionError(f"{label}: no backward launch: {tb}")
    elif any(served.values()) or any(tf.values()) or any(tb.values()):
        raise AssertionError(f"{label}: a kernel launched: {served} {tf} {tb}")
    del tr
    torch.cuda.empty_cache()
    return dict(served=served, train_fwd=tf, train_bwd=tb, plain_err=plain_err,
                row_shift=row_shift, latency_ms=latency, losses=losses,
                step_ms=step_ms, step_ms_median=med, train_wall_ms=t_wall,
                train_device_ms=t_dev, train_idle_share=t_idle,
                train_device_ms_by_kernel=t_top, bit_equal=same)


def baselines_phase(wrappers, card, device="cuda", seed=0, batch=128):
    """The ten baseline families at P12 (baseline_family_phase), the
    transformer and Raindrop v1 at eICU (hd 15 and 35, 2-byte copies); a
    transformer step's FLOPs counted with the kernels against the dense
    rung's count (MFU_TOL); the CLI with --model transformer on synthetic
    P12 for CLI_EPOCHS epochs with --measure-mfu (every packed launch on
    the tensor cores); the packed pair at the families' head dims
    (baseline_packed_phase)."""
    import dataclasses

    import torch
    from raindrop_tpu_torch.baselines.adapters import BASELINES, make_baseline

    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.train.trainer import Trainer

    out = {"families": {}, "seconds": {}}
    for name, dataset, steps in ([(n, "P12", BASELINE_STEPS) for n in BASELINES]
                                 + [("transformer", "eICU", 3), ("raindrop_v1", "eICU", 3)]):
        t0 = time.perf_counter()
        out["families"][f"{name} {dataset}"] = baseline_family_phase(
            name, dataset, wrappers, device, seed, batch, steps)
        out["seconds"][f"{name} {dataset}"] = took = time.perf_counter() - t0
        print(f"[baselines] {name} {dataset}: {took:.1f} s", flush=True)

    cfg = dataset_config("P12")
    tcfg = TrainConfig(dataset="P12", batch_size=batch)
    data, _ = make_split(cfg, batch, seed + 3, device)
    counts = {}
    for label, c in (("kernels", cfg), ("plain", dataclasses.replace(cfg, **PLAIN_ATTENTION))):
        fam = make_baseline("transformer", c, device=device)
        tr = Trainer(c, tcfg, device=device, init_fn=fam.init_fn, apply_fn=fam.apply_fn,
                     draw_seeds=fam.draw_seeds)
        reset_counts(wrappers)
        counts[label] = tr.step_flops(data)
        launched = read_counts(wrappers, "launches")["flash_mha_packed"]
        if (launched > 0) != (label == "kernels"):
            raise AssertionError(f"transformer FLOPs ({label}): {launched} launches")
        del tr
    rel = abs(counts["kernels"] - counts["plain"]) / counts["plain"]
    print(f"[baselines] transformer P12 ({card}): a step's FLOPs with the kernels "
          f"{counts['kernels'] / 1e9:.4f} GFLOP, the dense rung's "
          f"{counts['plain'] / 1e9:.4f} ({rel:.2e})", flush=True)
    if not rel <= MFU_TOL:
        raise AssertionError(f"transformer step FLOPs: kernels {counts['kernels']}, "
                             f"plain {counts['plain']}")
    out["step_flops"] = dict(counts, rel_diff=rel)
    torch.cuda.empty_cache()

    summary, records, fwd, bwd, took = run_cli(
        wrappers, ["--model", "transformer", "--dataset", "P12", "--synthetic",
                   str(CLI_N), "--epochs", str(CLI_EPOCHS), "--n-splits", "1",
                   "--measure-mfu", "true", "--seed", str(seed)], "transformer P12")
    check_cli("transformer P12", summary, records, "missing_0.0")
    check_tc("the transformer CLI run", fwd, bwd)
    print(f"[cli] transformer P12: {took:.1f} s, launches forward {fwd}, backward {bwd}",
          flush=True)
    out["cli"] = dict(summary=summary, records=records, launches=fwd, bwd_launches=bwd,
                      seconds=took)
    out["seconds"]["cli"] = took
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["heads"] = [baseline_packed_phase(label, T, hd, batch, seed=seed)
                    for label, T, hd in BASELINE_HEADS]
    out["seconds"]["heads"] = time.perf_counter() - t0
    return out


# ---------------------------------------- checkpoint import and raw text
def _linear_sd(sd, name, p):
    sd[name + ".weight"] = p["w"]
    if "b" in p:
        sd[name + ".bias"] = p["b"]


def raindrop_state_dict(params):
    """The reference Raindrop_v2 state dict (code/models_rd.py:208-276) of
    the port's parameter tree: the inverse of migrate.import_raindrop's
    names (this script keeps its own copy), the leaves as they are."""
    sd = {"R_u": params["R_u"]}
    _linear_sd(sd, "encoder", params["encoder"])
    for layer in ("ob_propagation", "ob_propagation_layer2"):
        p = params[layer]
        for lin in ("lin_key", "lin_query", "lin_value", "lin_skip", "increase_dim"):
            _linear_sd(sd, f"{layer}.{lin}", p[lin])
        for k in ("weight", "bias", "nodewise_weights", "map_weights"):
            sd[f"{layer}.{k}"] = p[k]
    for name, p in params["transformer_encoder"].items():
        pre = f"transformer_encoder.layers.{int(name[len('layer'):])}."
        sd[pre + "self_attn.in_proj_weight"] = p["in_proj_w"]
        sd[pre + "self_attn.in_proj_bias"] = p["in_proj_b"]
        _linear_sd(sd, pre + "self_attn.out_proj", p["out_proj"])
        _linear_sd(sd, pre + "linear1", p["lin1"])
        _linear_sd(sd, pre + "linear2", p["lin2"])
        for i in (1, 2):
            sd[pre + f"norm{i}.weight"] = p[f"ln{i}"]["scale"]
            sd[pre + f"norm{i}.bias"] = p[f"ln{i}"]["bias"]
    _linear_sd(sd, "mlp_static.0", params["mlp_static"]["lin0"])
    _linear_sd(sd, "mlp_static.2", params["mlp_static"]["lin1"])
    if "emb" in params:
        _linear_sd(sd, "emb", params["emb"])
    return sd


def mtand_state_dict(params):
    """The reference enc_mtan_classif state dict (code/baselines/mTAND/
    models.py:54-100) of the port's mTAND tree: the inverse of
    migrate.import_mtand's names; the query points are the constructor's
    linspace, not a state-dict entry."""
    sd = {}
    for ours, theirs in (("att_q", "att.linears.0"), ("att_k", "att.linears.1"),
                         ("att_out", "att.linears.2"), ("periodic", "periodic"),
                         ("linear", "linear")):
        _linear_sd(sd, theirs, params[ours])
    for i, j in ((0, 0), (1, 2), (2, 4)):
        _linear_sd(sd, f"classifier.{j}", params["classifier"][f"lin{i}"])
    for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
        sd[f"enc.{k.replace('w_', 'weight_').replace('b_', 'bias_')}_l0"] = params["gru"][k]
    return sd


def _tree_equal(a, b):
    import torch
    from raindrop_tpu_torch.train.checkpoint import flatten_params

    fa, fb = flatten_params(a), flatten_params(b)
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def migrate_phase(wrappers, device="cuda", seed=0, batch=128, steps=3, mtand_rows=16):
    """Reference checkpoints imported and served (python -m
    raindrop_tpu_torch.migrate). For P12 and PAM at full width and depth:
    a seeded init written as a reference Raindrop_v2 state dict
    (raindrop_state_dict, torch.save), imported with the migrate CLI,
    loaded with load_checkpoint into another seed's init (the parameters
    bit-equal to the seeded ones), and served on `batch` requests: the
    probabilities bit-equal to the seeded model's server (the same
    parameters through the same kernels) and within TOL['bfloat16'] of
    the dense plain attention; flash_mha_packed (P12) and
    fused_encoder_layer (PAM) launched, every launch on the tensor cores.
    Then `steps` Trainer steps of the imported P12 model (finite losses,
    flash_mha_packed's backward launched on the tensor cores). Last, an
    mTAND state dict in the reference's {'rec_state_dict': ...} wrapper
    imported the same way, and mtand_apply on the card on
    variable_time_collate's batch of records_from_dense records
    (`mtand_rows` of P12's requests), held to the CPU's logits within 1e-5
    relative to max(1, |CPU|). Returns the launch counts and the errors."""
    import torch
    from raindrop_tpu_torch import migrate
    from raindrop_tpu_torch.baselines.adapters import make_baseline
    from raindrop_tpu_torch.baselines.mtand import mtand_apply
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.collate import records_from_dense, variable_time_collate
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer
    from raindrop_tpu_torch.train.checkpoint import load_checkpoint
    from raindrop_tpu_torch.train.trainer import Trainer

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        def imported(model, state, template, *extra):
            pt, base = os.path.join(tmp, f"{model}.pt"), os.path.join(tmp, model)
            torch.save(state, pt)
            rc = migrate.main(["--model", model, "--torch", pt, "--out", base, *extra])
            if rc != 0:
                raise AssertionError(f"migrate --model {model} returned {rc}")
            return load_checkpoint(base, template)[0]

        for dataset, check in (("P12", check_tc), ("PAM", check_fused_tc)):
            cfg = dataset_config(dataset)
            seeded = raindrop_init(seed, cfg, device=device)
            sd = {k: v.detach().cpu() for k, v in raindrop_state_dict(seeded).items()}
            params = imported("raindrop", sd, raindrop_init(seed + 1, cfg, device=device))
            if not _tree_equal(params, seeded):
                raise AssertionError(f"imported {dataset}: the parameters are not the "
                                     f"seeded ones")
            P, times, static = make_requests(cfg, batch, seed + 1)
            servers = [InferenceServer(c, p, buckets=(batch,), device=device)
                       for c, p in ((cfg, seeded), (cfg, params),
                                    (dataset_config(dataset, **PLAIN_ATTENTION), params))]
            try:
                want = servers[0].predict(P, times, static)
                reset_counts(wrappers)
                got = servers[1].predict(P, times, static)
                launches = read_counts(wrappers, "launches")
                plain = servers[2].predict(P, times, static)
            finally:
                for srv in servers:
                    srv.close()
            check(f"imported {dataset} serving", launches)
            plain_err = float(np.abs(got - plain).max())
            rec = dict(launches=launches, bit_equal=bool(np.array_equal(got, want)),
                       plain_err=plain_err)
            print(f"[migrate] {dataset}: served {batch} rows, bit-equal to the seeded "
                  f"model {rec['bit_equal']}, against the plain attention "
                  f"{plain_err:.3e}; launches {launches}", flush=True)
            if not (rec["bit_equal"] and np.isfinite(got).all()
                    and plain_err <= TOL["bfloat16"]):
                raise AssertionError(f"imported {dataset}: served probabilities off "
                                     f"the seeded model's or the plain path's: {rec}")
            if dataset == "P12":
                tcfg = TrainConfig(dataset=dataset, batch_size=batch, learning_rate=1e-4)
                data, _ = make_split(cfg, batch, seed + 2, device)
                trainer = Trainer(cfg, tcfg, device=device, params=params)
                reset_counts(wrappers)
                losses = [float(trainer.train_step(data)[0]) for _ in range(steps)]
                tf, tb = (read_counts(wrappers, a) for a in ("launches", "bwd_launches"))
                del trainer
                check_tc("imported P12 training", tf, tb)
                print(f"[migrate] P12: {steps} steps of the imported model, losses "
                      f"{[round(x, 5) for x in losses]}; launches forward {tf}, backward "
                      f"{tb}", flush=True)
                if not all(np.isfinite(losses)) or tb["flash_mha_packed"] <= 0:
                    raise AssertionError(f"imported P12 training: losses {losses}, "
                                         f"backward launches {tb}")
                rec.update(losses=losses, train_launches=tf, train_bwd_launches=tb)
            out[dataset] = rec
            torch.cuda.empty_cache()

        # mTAND at P12's published widths (the adapter's defaults)
        cfg = dataset_config("P12")
        fam = make_baseline("mtand", cfg, device="cpu")
        source = fam.init_fn(seed)
        n_ref = int(source["query_points"].shape[0])
        params = imported("mtand", {"rec_state_dict": mtand_state_dict(source), "epoch": 3},
                          make_baseline("mtand", cfg, device=device).init_fn(seed + 1),
                          "--mtand-n-ref", str(n_ref))
        P, times, _ = make_requests(cfg, mtand_rows, seed + 3)
        F = cfg.d_inp
        combined, _ = variable_time_collate(records_from_dense(
            np.abs(P[..., :F]), times, np.arange(mtand_rows) % 2))
        x, tt = torch.from_numpy(combined[..., :2 * F]), torch.from_numpy(combined[..., -1])
        cpu = load_checkpoint(os.path.join(tmp, "mtand"), fam.init_fn(seed + 1))[0]
        with torch.no_grad():
            on_card = mtand_apply(params, x.to(device), tt.to(device))[0].cpu()
            on_cpu = mtand_apply(cpu, x, tt)[0]
        err = float((on_card - on_cpu).abs().max() / on_cpu.abs().max().clamp(min=1.0))
        # a state dict carries no query points: the import's linspace
        want = {**source, "query_points": torch.from_numpy(
            np.linspace(0.0, 1.0, n_ref, dtype=np.float32))}
        same = _tree_equal(cpu, want)
        print(f"[migrate] mTAND ({mtand_rows} records, L={combined.shape[1]}, "
              f"{2 * F}+1 channels): imported tree equal to the source {same}; logits "
              f"on the card against the CPU {err:.3e} (limit 1e-5)", flush=True)
        if not (same and torch.isfinite(on_card).all() and err <= 1e-5):
            raise AssertionError(f"imported mTAND: tree equal {same}, card against CPU "
                                 f"{err:.3e}")
        out["mtand"] = dict(card_vs_cpu=err, tree_equal=same)
    return out


RAW_PATIENTS = 400


def write_physionet_raw(root, seed, n=RAW_PATIENTS):
    """Raw PhysioNet-2012 text for `n` patients from `seed`, in the
    challenge's layout: root/set-a/<RecordID>.txt (the header, the RecordID
    line, the 5 statics at 00:00, then 30-180 observations of the 36
    time-series parameters within 48 h, each parameter at least once
    across the set) and root/Outcomes-a.txt (in-hospital death for about a
    third)."""
    from raindrop_tpu_torch.data.preprocess import STATIC_PARAMS
    from raindrop_tpu_torch.data.raw_irregular import PHYSIONET_PARAMS

    ts = [p for p in PHYSIONET_PARAMS if p not in STATIC_PARAMS]
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "set-a"))
    ids = 132539 + np.arange(n)
    with open(os.path.join(root, "Outcomes-a.txt"), "w") as f:
        f.write("RecordID,SAPS-I,SOFA,Length_of_stay,Survival,In-hospital_death\n")
        for rid in ids:
            f.write(f"{rid},{rng.integers(5, 30)},{rng.integers(0, 15)},"
                    f"{rng.integers(1, 60)},-1,{int(rng.uniform() < 0.35)}\n")
    for i, rid in enumerate(ids):
        lines = ["Time,Parameter,Value", f"00:00,RecordID,{rid}",
                 f"00:00,Age,{rng.integers(18, 90)}", f"00:00,Gender,{rng.integers(0, 2)}",
                 f"00:00,Height,{rng.uniform(150, 195):.1f}",
                 f"00:00,ICUType,{rng.integers(1, 5)}",
                 f"00:00,Weight,{rng.uniform(45, 130):.1f}"]
        k = int(rng.integers(30, 181))
        minutes = np.sort(rng.integers(1, 48 * 60, size=k))
        params = rng.choice(ts, size=k)
        if i < len(ts):
            params[0] = ts[i]
        for t, p in zip(minutes, params):
            lines.append(f"{t // 60:02d}:{t % 60:02d},{p},{rng.uniform(0.1, 200):.2f}")
        with open(os.path.join(root, "set-a", f"{rid}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def raw_physionet_phase(wrappers, seed=0):
    """Raw PhysioNet-2012 text to training: RAW_PATIENTS patients written
    from `seed` (write_physionet_raw), `python -m
    raindrop_tpu_torch.data.preprocess parse` and `splits` on them (no
    pandas), then the CLI on the result for 1 epoch of one split at P12's
    full width and depth (load_split on the written root) with MFU
    telemetry. Checks: the processed arrays' shapes (T=215, 36 sensors, 9
    statics), rc 0, finite metrics and loss, flash_mha_packed launched
    forward and backward, every launch on the tensor cores, the epoch
    record's MFU in (0, 1)."""
    from raindrop_tpu_torch.data import preprocess

    with tempfile.TemporaryDirectory() as tmp:
        raw, root = os.path.join(tmp, "rawdata"), os.path.join(tmp, "P12data")
        t0 = time.perf_counter()
        write_physionet_raw(raw, seed)
        t1 = time.perf_counter()
        preprocess.main(["parse", "--raw", raw, "--out", os.path.join(root, "processed_data")])
        preprocess.main(["splits", "--n", str(RAW_PATIENTS), "--out",
                         os.path.join(root, "splits"), "--seed", str(seed)])
        parse_s = time.perf_counter() - t1
        pt = np.load(os.path.join(root, "processed_data", "PTdict_list.npy"),
                     allow_pickle=True)
        shapes = {(p["arr"].shape, p["time"].shape, len(p["extended_static"])) for p in pt}
        if len(pt) != RAW_PATIENTS or shapes != {((215, 36), (215, 1), 9)}:
            raise AssertionError(f"preprocess parse: {len(pt)} patients, shapes {shapes}")
        summary, records, fwd, bwd, took = run_cli(wrappers, [
            "--dataset", "P12", "--data-root", root, "--n-splits", "1", "--epochs", "1",
            "--measure-mfu", "true", "--seed", str(seed + 1)], "P12 from raw text")
    check_cli("P12 from raw text", summary, records, "missing_0.0", epochs=1)
    check_tc("P12 from raw text (CLI)", fwd, bwd)
    loss = records[0]["train_loss"]
    if not np.isfinite(loss) or bwd["flash_mha_packed"] <= 0:
        raise AssertionError(f"P12 from raw text: loss {loss}, backward launches {bwd}")
    print(f"[raw] P12 from raw text: {RAW_PATIENTS} patients written in {t1 - t0:.1f} s, "
          f"parse and splits {parse_s:.1f} s, the CLI {took:.1f} s; loss {loss:.5f}; "
          f"launches forward {fwd}, backward {bwd}", flush=True)
    return dict(write_s=t1 - t0, parse_s=parse_s, cli_s=took, summary=summary,
                records=records, launches=fwd, bwd_launches=bwd)


# ------------------------------------------------------------ the mesh
def shard_origin_phase(device="cuda", seed=0, rate=0.2):
    """Rows 1-4 launched on a shard at its origin: the packed pair at P12
    (B=128, T=215, d=160, 2 heads; bf16 and f32) on rows [64:128] at
    (64, 0, 2) and on rows [32:96], head 1, at (32, 1, 2), the fused layer
    at PAM (B=128, T=600, d=84, ffn=136; bf16) on rows [64:128] at
    (64, 0, 2), dropout `rate`: every output and gradient bit-equal to the
    matching rows (and head) of the full launch, the fused layer's out,
    attn, lse and dx; and each shard's launch against its plain version at
    its origin, sample by sample (SAMPLE_TOL). Launches made here are
    comparisons, not the main path's."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa
    from raindrop_tpu_torch.ops import fused_encoder as fe

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"packed": [], "fused": []}
    B, T, d, H = 128, 215, 160, 2
    hd = d // H
    for dtype in ("bfloat16", "float32"):
        od = getattr(torch, dtype)
        q, k, v, g = (torch.randn(B, T, d, generator=gen, device=device)
                      for _ in range(4))
        lengths = ragged_lengths(gen, B, T, device)
        o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, rate, H, od)
        grads = fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate, H, od, o, lse, g)
        for b0, n, h in ((64, 64, None), (32, 64, 1)):
            rows = slice(b0, b0 + n)
            cols = slice(None) if h is None else slice(h * hd, (h + 1) * hd)
            heads = slice(None) if h is None else slice(h, h + 1)
            nh, origin = (H, (b0, 0, H)) if h is None else (1, (b0, h, H))
            args = [x[rows][..., cols].contiguous() for x in (q, k, v)]
            o_s, lse_s = fa._packed_fwd_cuda(*args, lengths[rows], SEED, rate, nh, od,
                                             origin=origin)
            g_s = fa._packed_bwd_cuda(*args, lengths[rows], SEED, rate, nh, od, o_s,
                                      lse_s, g[rows][..., cols].contiguous(),
                                      origin=origin)
            torch.cuda.synchronize()
            equal = (torch.equal(o_s, o[rows][..., cols])
                     and torch.equal(lse_s, lse[rows][:, heads])
                     and all(torch.equal(a, w[rows][..., cols])
                             for a, w in zip(g_s, grads)))
            if not equal:
                raise AssertionError(f"P12 {dtype} packed pair at origin {origin}: "
                                     f"not the full launch's bits")
            # the plain backward from the kernel's o and lse, as flash_bwd_phase
            p_o, _ = fa._packed_fwd_plain(*args, lengths[rows], nh, od, SEED, rate,
                                          origin)
            p_g = fa._packed_bwd_plain(*args, lengths[rows], SEED, rate, nh, od, o_s,
                                       lse_s, g[rows][..., cols].contiguous(), origin)
            errs = [sample_err(a, w, lengths[rows]) for a, w in zip((o_s, *g_s),
                                                                     (p_o, *p_g))]
            if max(errs) > SAMPLE_TOL[dtype]:
                raise AssertionError(f"P12 {dtype} packed pair at origin {origin}: "
                                     f"{errs} against the plain version "
                                     f"(limit {SAMPLE_TOL[dtype]})")
            out["packed"].append({"dtype": dtype, "origin": list(origin), "rows": n,
                                  "heads": nh, "bit_equal": True,
                                  "plain_sample_err": max(errs)})
    B, T, d, ffn = 128, 600, 84, 136
    p = random_layer(gen, d, ffn, device)
    ws = fe._flatten(p)
    x, g = (torch.randn(B, T, d, generator=gen, device=device) for _ in range(2))
    lengths = ragged_lengths(gen, B, T, device)
    od = torch.bfloat16
    full_o, attn, lse = fe._fused_fwd_cuda(ws, x, lengths, SEED, rate, H, od)
    dx, _ = fe._fused_bwd_cuda(ws, x, lengths, SEED, rate, H, od, attn, lse, g)
    rows, origin = slice(64, 128), (64, 0, H)
    o_s, a_s, l_s = fe._fused_fwd_cuda(ws, x[rows], lengths[rows], SEED, rate, H, od,
                                       origin=origin)
    dx_s, _ = fe._fused_bwd_cuda(ws, x[rows], lengths[rows], SEED, rate, H, od, a_s, l_s,
                                 g[rows], origin=origin)
    torch.cuda.synchronize()
    if not (torch.equal(o_s, full_o[rows]) and torch.equal(a_s, attn[rows])
            and torch.equal(l_s, lse[rows]) and torch.equal(dx_s, dx[rows])):
        raise AssertionError(f"PAM bf16 fused layer at origin {origin}: not the full "
                             f"launch's bits")
    p_o, p_a, _ = fe._fused_fwd_plain(p, x[rows], lengths[rows], H, od, SEED, rate, origin)
    errs = [sample_err(o_s, p_o, lengths[rows]), sample_err(a_s, p_a, lengths[rows])]
    if max(errs) > SAMPLE_TOL["bfloat16"]:
        raise AssertionError(f"PAM fused layer at origin {origin}: {errs} against the "
                             f"plain version (limit {SAMPLE_TOL['bfloat16']})")
    out["fused"].append({"dtype": "bfloat16", "origin": list(origin), "rows": 64,
                         "bit_equal": True, "plain_sample_err": max(errs)})
    print(f"[origin] rows 1-2 at P12 (bf16, f32) and rows 3-4 at PAM (bf16), dropout "
          f"{rate}: every shard bit-equal to the full launch; against the plain "
          f"version {max(r['plain_sample_err'] for r in out['packed']):.3e} / "
          f"{out['fused'][0]['plain_sample_err']:.3e}", flush=True)
    return out


MESH_STEPS = 3
MESH_REPEATS = 4     # further turns of the runs with and without the mesh, timed


def _mesh_run(cfg, tcfg, params, data, idx, seeds, device, mesh=None, first=False):
    """MESH_STEPS train_epoch steps of a Trainer (on `mesh`) from `params`:
    (losses, the trainer, ms a step by the host clock around the
    synchronised steps, and with `first` the first step's logits and
    Adam's first moment of the full parameters after it, mu = (1 - b1) *
    the step's gradient, averaged over the data axis and gathered over
    the model axis: {"logits": [rows, classes], "mu": {path: array}})."""
    import torch
    from raindrop_tpu_torch.train.checkpoint import flatten_params
    from raindrop_tpu_torch.train.trainer import Trainer

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    tr = Trainer(cfg, tcfg, device=device, params=params, mesh=mesh)
    parts = (slice(0, 1), slice(1, None)) if first else (slice(None),)
    losses, took, out = [], 0.0, None
    for i, part in enumerate(parts):
        if not seeds[part]:     # one step: no steps after the first
            continue
        sync()
        t0 = time.perf_counter()
        got, logits = tr.train_epoch(data, idx[part], seeds[part])
        sync()
        took += time.perf_counter() - t0
        losses.append(got)
        if first and i == 0:
            out = {"logits": logits.float().cpu().numpy(),
                   "mu": {path: np.asarray(v, np.float32) for path, v in
                          flatten_params(tr.full_opt_state()["mu"])}}
    return torch.cat(losses), tr, took * 1e3 / len(seeds), out


def _mesh_inputs(dataset, device, seed, batch, overrides=None, n_batches=MESH_STEPS,
                 pipeline=0):
    """(cfg, tcfg, params, split on the device, idx [steps, batch], seeds)
    at full width, from `seed`; `pipeline` > 0 draws the GPipe route's
    seeds of that many microbatches too."""
    import torch
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.utils.dropout import DropoutSeeds

    cfg = dataset_config(dataset, **(overrides or {}))
    tcfg = _train_config(dataset, learning_rate=1e-4, batch_size=batch)
    params = raindrop_init(seed, cfg, device=device)
    data, _ = make_split(cfg, 2 * batch, seed, device)
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(np.stack([rng.permutation(2 * batch)[:batch]
                                     for _ in range(n_batches)]))
    gen = torch.Generator().manual_seed(seed + 7)
    seeds = [DropoutSeeds.draw(gen, cfg.nlayers, pipeline=pipeline)
             for _ in range(n_batches)]
    return cfg, tcfg, params, data, idx, seeds


def mesh_phase(wrappers, device="cuda", seed=0, batch=128):
    """The mesh through NCCL at world size 1: a process group of one rank
    (initialize_distributed, NCCL) and make_mesh(1, 1); P12 (the packed
    pair) and PAM (the fused layer), each MESH_STEPS steps at full width
    (B=128, dropout 0.2) through Trainer(mesh=...) against the Trainer
    without a mesh from the same parameters, batches and seeds: the
    losses and every parameter bit-equal. Every launch count is set to 0
    just before the mesh runs and read just after (the counts of this
    slice's path; all on the tensor cores). The step ms with and without
    the mesh are taken in turns, MESH_REPEATS + 1 of each after a warm-up
    run. Then the P12 run's parameters through save_sharded_checkpoint and
    back, bit-equal; then the scale-out routes on the same mesh
    (route_one_rank_runs). Returns ({dataset: (forward counts, backward
    counts)}, details)."""
    import torch
    import torch.distributed as dist
    from raindrop_tpu_torch.parallel.mesh import (
        free_port, initialize_distributed, make_mesh)
    from raindrop_tpu_torch.parallel.multihost import (
        load_sharded_checkpoint, save_sharded_checkpoint)
    from raindrop_tpu_torch.train.checkpoint import flatten_params

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                           timeout_s=300)
    try:
        mesh = make_mesh(1, 1)
        counts, details = {}, {"backend": dist.get_backend()}
        for dataset in ("P12", "PAM"):
            cfg, tcfg, params, data, idx, seeds = _mesh_inputs(dataset, device, seed,
                                                               batch)
            # the run without a mesh first (it warms the card up), the mesh
            # run, then the two in turns for their times
            want, plain_tr, _, _ = _mesh_run(cfg, tcfg, params, data, idx, seeds, device)
            reset_counts(wrappers)
            got, tr, ms, _ = _mesh_run(cfg, tcfg, params, data, idx, seeds, device, mesh)
            counts[dataset] = tuple(read_counts(wrappers, a)
                                    for a in ("launches", "bwd_launches"))
            times = {"mesh": [ms], "plain": []}
            for _ in range(MESH_REPEATS + 1):
                times["plain"].append(
                    _mesh_run(cfg, tcfg, params, data, idx, seeds, device)[2])
                if len(times["mesh"]) <= MESH_REPEATS:
                    times["mesh"].append(
                        _mesh_run(cfg, tcfg, params, data, idx, seeds, device, mesh)[2])
            if not torch.equal(got, want):
                raise AssertionError(f"{dataset} mesh(1, 1): losses {got.tolist()} "
                                     f"against {want.tolist()} without the mesh")
            theirs = dict(flatten_params(plain_tr.params))
            for path, t in flatten_params(tr.params):
                if not torch.equal(t, theirs[path]):
                    raise AssertionError(f"{dataset} mesh(1, 1): parameter {path} "
                                         f"differs from the run without the mesh")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{dataset} mesh(1, 1): losses {got.tolist()}")
            details[dataset] = {"losses": got.tolist(),
                                "step_ms": float(np.median(times["mesh"])),
                                "step_ms_without_mesh": float(np.median(times["plain"])),
                                "step_ms_turns": times,
                                "launches": counts[dataset][0],
                                "bwd_launches": counts[dataset][1]}
            if dataset == "P12":
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "best")
                    name = save_sharded_checkpoint(path, tr.params, mesh)
                    back = load_sharded_checkpoint(path, like=tr.params)
                    for (p_, a), (_, b) in zip(flatten_params(back),
                                               flatten_params(tr.params)):
                        if not torch.equal(a, b):
                            raise AssertionError(f"sharded checkpoint: {p_} differs")
                    details["checkpoint"] = os.path.basename(name)
            del plain_tr, tr, params, data
            torch.cuda.empty_cache()
        check_tc("mesh P12", *counts["P12"])
        check_fused_tc("mesh PAM", *counts["PAM"])
        details["routes"] = route_one_rank_runs(mesh, device, seed, batch)
    finally:
        dist.destroy_process_group()
    print(f"[mesh] NCCL world size 1, make_mesh(1, 1): P12 and PAM {MESH_STEPS} steps "
          f"bit-equal to the Trainer without a mesh (losses, every parameter); "
          f"step ms, the median of {MESH_REPEATS + 1} turns each, P12 "
          f"{details['P12']['step_ms']:.3f} (without the mesh "
          f"{details['P12']['step_ms_without_mesh']:.3f}), PAM "
          f"{details['PAM']['step_ms']:.3f} ({details['PAM']['step_ms_without_mesh']:.3f}); "
          f"turns {[details[d]['step_ms_turns'] for d in ('P12', 'PAM')]}; "
          f"launches P12 {counts['P12']}, PAM {counts['PAM']}; sharded checkpoint "
          f"{details['checkpoint']} read back bit-equal", flush=True)
    return counts, details


# The two-rank phase holds DP and TP over MESH_STEPS steps with f32
# attention operands: a data rank's projections run cuBLAS on half the
# rows (another algorithm, a last bit apart), and with bf16 operands such
# a bit can flip an operand's rounding; those steps are held at JAX's
# tolerances for its mesh steps (loss, parameters), and the first step's
# gradient (Adam's first moment after it, each element against its
# leaf's largest one-rank |mu|) at "grad". TP at P12's own bf16 operands
# (the tensor-core route) is held on its first step: the loss, the
# logits and the gradient at TWO_RANK_BF16_TOL. The limits sit between
# the sound runs' readings and the planted faults' (chip_ab.py's
# mesh_faults task, on an H100): gradient 1.0e-6 (DP), 4.0e-4 (TP) and
# 3.6e-4 (TP bf16) sound, 0.15 to 0.82 under a fault; bf16 TP's first
# logits 3.4e-6 sound, 1.9e-2 with every rank's dropout hashed as head 0.
TWO_RANK = {"attention_score_dtype": "float32"}
TWO_RANK_TOL = {"loss": 2e-5, "params": 2e-4, "grad": 2e-3}
TWO_RANK_BF16_TOL = {"loss": 2e-5, "logits": 2e-4, "grad": 2e-3}
# (name, mesh shape, configuration overrides, MESH_STEPS steps held or the first)
TWO_RANK_RUNS = (("2x1", (2, 1), TWO_RANK, True),
                 ("1x2", (1, 2), TWO_RANK, True),
                 ("1x2 bf16", (1, 2), {}, False))


def _two_rank_steps(device, seed, batch, runs=TWO_RANK_RUNS):
    """On each rank of a group of two: for each run of `runs`, P12
    MESH_STEPS steps on its mesh (_mesh_run with the first step's logits
    and moment), flash_mha_packed's launches counted around it. Returns
    {name: details}."""
    import torch
    from raindrop_tpu_torch.ops.flash_attention import flash_mha_packed
    from raindrop_tpu_torch.parallel.mesh import coords, make_mesh
    from raindrop_tpu_torch.train.checkpoint import flatten_params

    out = {}
    for name, shape, overrides, _ in runs:
        cfg, tcfg, params, data, idx, seeds = _mesh_inputs("P12", device, seed, batch,
                                                           overrides)
        mesh = make_mesh(*shape)
        reset_counts([flash_mha_packed])
        losses, tr, ms, first = _mesh_run(cfg, tcfg, params, data, idx, seeds, device,
                                          mesh, first=True)
        full = {p: t.detach().cpu().numpy() for p, t in flatten_params(tr.full_params())}
        out[name] = {"losses": losses.tolist(), "params": full, "step_ms": ms,
                     "first": first, "coords": coords(mesh),
                     "launches": read_counts([flash_mha_packed], "launches"),
                     "bwd_launches": read_counts([flash_mha_packed], "bwd_launches")}
        del tr, params, data
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def _two_rank_worker(rank, device, seed, batch, split_dir):
    """One of two gloo ranks sharing the card: _two_rank_steps (DP 2x1,
    TP 1x2 in f32 and in bf16: one head a rank, flash_mha_packed on its
    head), then run_elastic on DP 2x1 over a small P12 split,
    uninterrupted and with a fault at epoch 1."""
    import torch
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.data.datasets import synthetic_split
    from raindrop_tpu_torch.parallel.elastic import FaultInjector, run_elastic
    from raindrop_tpu_torch.parallel.mesh import make_mesh
    from raindrop_tpu_torch.train.checkpoint import flatten_params
    from raindrop_tpu_torch.train.trainer import Trainer

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = _two_rank_steps(device, seed, batch)
    mesh = make_mesh(2, 1)
    cfg = dataset_config("P12", **TWO_RANK)
    split = synthetic_split("P12", 400, seed, T=215)
    tcfg = _train_config("P12", learning_rate=1e-4, batch_size=batch, num_epochs=3,
                         seed=seed + 3)
    runs = {}
    for name, fail_at in (("full", None), ("hit", 1)):
        tr = Trainer(cfg, tcfg, device=device, mesh=mesh)
        t0 = time.perf_counter()
        result, restarts = run_elastic(
            tr, split, checkpoint_path=os.path.join(split_dir, name), max_restarts=2,
            fault_injector=None if fail_at is None else FaultInjector([fail_at]))
        runs[name] = {"test": result.test_metrics, "restarts": restarts,
                      "epochs": [r["epoch"] for r in result.history],
                      "seconds": time.perf_counter() - t0,
                      "params": {p: t.detach().cpu().numpy()
                                 for p, t in flatten_params(tr.full_params())}}
        del tr
    out["elastic"] = runs
    return out


def two_rank_reference(device="cuda", seed=0, batch=128, runs=TWO_RANK_RUNS):
    """The one-rank runs the two-rank ones are held to: for each
    configuration of `runs`, _mesh_run without a mesh (the first
    step's logits and moment too) -> {overrides key: (losses, parameters,
    first, ms a step)}."""
    import torch
    from raindrop_tpu_torch.train.checkpoint import flatten_params

    refs = {}
    for _, _, overrides, _ in runs:
        key = json.dumps(overrides, sort_keys=True)
        if key in refs:
            continue
        cfg, tcfg, params, data, idx, seeds = _mesh_inputs("P12", device, seed, batch,
                                                           overrides)
        losses, tr, ms, first = _mesh_run(cfg, tcfg, params, data, idx, seeds, device,
                                          first=True)
        refs[key] = (losses.numpy(), {p: t.detach().cpu().numpy()
                                      for p, t in flatten_params(tr.params)}, first, ms)
        del tr, params, data
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return refs


def two_rank_errors(refs, ranks, lr=1e-4, runs=TWO_RANK_RUNS):
    """For each run of `runs` in the ranks' results (a list of
    _two_rank_steps' dicts, one a rank) against its one-rank reference:
    whether the ranks agree (losses, parameters, the first step's moment
    bit for bit; the logits of TP ranks too), the largest loss error over
    the steps and of the first step, the largest parameter error after the
    steps (the key bias apart: its true gradient is zero, Adam normalises
    its noise, held to 3 * lr), the first step's largest logit error
    (the TP runs: every rank holds every row) and its gradient error, the
    largest |mu - mu_ref| of a leaf over that leaf's largest |mu_ref|.
    Nothing is asserted here: two_rank_phase holds these to the limits."""
    out = {}
    for name, _, overrides, _ in runs:
        want, ref_params, ref_first, _ = refs[json.dumps(overrides, sort_keys=True)]
        res = [r[name] for r in ranks]
        agree = all(
            r["losses"] == res[0]["losses"]
            and all(np.array_equal(v, res[0]["params"][p]) for p, v in r["params"].items())
            and all(np.array_equal(v, res[0]["first"]["mu"][p])
                    for p, v in r["first"]["mu"].items())
            for r in res[1:])
        tp = res[0]["coords"].n_model > 1
        if tp:
            agree = agree and all(np.array_equal(r["first"]["logits"],
                                                 res[0]["first"]["logits"]) for r in res)
        got = np.asarray(res[0]["losses"])
        p_err, key_err = 0.0, 0.0
        for path, v in ref_params.items():
            g = res[0]["params"][path]
            if path.endswith("in_proj_b"):
                d = v.shape[0] // 3
                key_err = max(key_err, float(np.abs(g[d:2 * d] - v[d:2 * d]).max()))
                g, v = np.delete(g, np.s_[d:2 * d]), np.delete(v, np.s_[d:2 * d])
            p_err = max(p_err, float(np.abs(g - v).max()))
        grad, grad_leaf = 0.0, None
        for path, m in ref_first["mu"].items():
            rel = float(np.abs(res[0]["first"]["mu"][path] - m).max()) / max(
                float(np.abs(m).max()), 1e-30)
            if rel > grad:
                grad, grad_leaf = rel, path
        out[name] = {
            "ranks_agree": bool(agree),
            "loss_err": float(np.abs(got - want).max()),
            "ref_losses": np.asarray(want).tolist(),
            "first_loss_err": float(abs(got[0] - want[0])),
            "param_err": p_err, "key_bias_err": key_err, "key_bias_limit": 3 * lr,
            "logit_err": (float(np.abs(res[0]["first"]["logits"]
                                       - ref_first["logits"]).max()) if tp else None),
            "grad_rel_err": grad, "grad_worst_leaf": grad_leaf,
            "step_ms": [r["step_ms"] for r in res],
            "launches": [r["launches"] for r in res],
            "bwd_launches": [r["bwd_launches"] for r in res]}
    return out


def _hold_two_rank(name, e, held):
    """Raise unless the run's errors (two_rank_errors) are within limits."""
    if not e["ranks_agree"]:
        raise AssertionError(f"mesh {name}: the ranks disagree")
    if held:
        tol = TWO_RANK_TOL
        # JAX's rtol and atol: |got - want| <= atol + rtol * |want|
        checks = (("loss", e["loss_err"], tol["loss"] * (1 + max(np.abs(e["ref_losses"])))),
                  ("params", e["param_err"], tol["params"]),
                  ("key bias", e["key_bias_err"], e["key_bias_limit"]),
                  ("grad", e["grad_rel_err"], tol["grad"]))
    else:
        tol = TWO_RANK_BF16_TOL
        checks = (("first loss", e["first_loss_err"], tol["loss"]),
                  ("logits", e["logit_err"], tol["logits"]),
                  ("grad", e["grad_rel_err"], tol["grad"]))
    for what, err, limit in checks:
        if not err <= limit:
            raise AssertionError(f"mesh {name}: {what} error {err:.3e} over {limit:.3e}: {e}")


def two_rank_phase(device="cuda", seed=0, batch=128):
    """Two gloo ranks sharing the card (parallel/launch.run_ranks: NCCL
    refuses two ranks on one GPU): P12 at full width (B=128, dropout 0.2)
    on DP 2x1 and TP 1x2 with TWO_RANK's f32 attention operands,
    MESH_STEPS steps each against the one-rank steps from the same
    parameters, batches and seeds, at JAX's mesh tolerances (loss rtol
    and atol 2e-5, parameters 2e-4; the key bias, whose true gradient is
    zero, 3 * lr) and the first step's gradient at TWO_RANK_TOL["grad"];
    TP 1x2 at P12's bf16 operands held on its first step (loss, logits,
    gradient) at TWO_RANK_BF16_TOL, its launches all on the tensor-core
    route; the ranks agree; the TP runs launch flash_mha_packed forward
    and backward on every rank (counted there). Then run_elastic on DP
    2x1 with a fault at epoch 1 restarts once and ends bit-equal to the
    uninterrupted run (test metrics, every parameter), each rank's shard
    of the best parameters on disk where an epoch raised the val AUROC.
    Returns the details."""
    import torch
    from raindrop_tpu_torch.parallel.launch import run_ranks

    refs = two_rank_reference(device, seed, batch)
    one_ms = refs[json.dumps(TWO_RANK, sort_keys=True)][3]
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(_two_rank_worker, 2, device, seed, batch, tmp,
                          backend="gloo", timeout_s=900, threads=4)
        shards = sorted(f for f in os.listdir(tmp) if ".shard" in f)
    took = time.perf_counter() - t0
    details = {"one_rank_step_ms": one_ms, "seconds": took}
    errors = two_rank_errors(refs, ranks)
    for name, _, _, held in TWO_RANK_RUNS:
        e = errors[name]
        print(f"[two ranks] {name}: ranks agree {e['ranks_agree']}, loss error "
              f"{e['loss_err']:.3e} (first step {e['first_loss_err']:.3e}), parameter "
              f"error {e['param_err']:.3e}, key bias {e['key_bias_err']:.3e}, first "
              f"step's logit error {e['logit_err']}, gradient error {e['grad_rel_err']:.3e} "
              f"of the leaf's largest ({e['grad_worst_leaf']})", flush=True)
        details[name.replace(" ", "_")] = {
            **e, "losses": ranks[0][name]["losses"],
            "launches": [c["flash_mha_packed"] for c in e["launches"]],
            "tc_launches": [c["flash_mha_packed.tc"] for c in e["launches"]],
            "bwd_launches": [c["flash_mha_packed"] for c in e["bwd_launches"]],
            "tc_bwd_launches": [c["flash_mha_packed.tc"] for c in e["bwd_launches"]]}
    for name, _, _, held in TWO_RANK_RUNS:
        _hold_two_rank(name, errors[name], held)
    for name in ("1x2", "1x2_bf16"):
        tp = details[name]
        if min(tp["launches"]) <= 0 or min(tp["bwd_launches"]) <= 0:
            raise AssertionError(f"TP {name}: flash_mha_packed launches {tp}")
    bf = details["1x2_bf16"]
    if bf["tc_launches"] != bf["launches"] or bf["tc_bwd_launches"] != bf["bwd_launches"]:
        raise AssertionError(f"TP 1x2 bf16: launches off the tensor-core route {bf}")
    el = [r["elastic"] for r in ranks]
    for e in el:
        full, hit = e["full"], e["hit"]
        if full["restarts"] != 0 or hit["restarts"] != 1:
            raise AssertionError(f"run_elastic restarts {full['restarts']}, {hit['restarts']}")
        if full["epochs"] != [0, 1, 2] or hit["epochs"] != [0, 1, 2]:
            raise AssertionError(f"run_elastic epochs {full['epochs']}, {hit['epochs']}")
        if hit["test"] != full["test"] or any(
                not np.array_equal(v, full["params"][p]) for p, v in hit["params"].items()):
            raise AssertionError("run_elastic after a fault: not the uninterrupted run")
    details["elastic"] = {"test": el[0]["full"]["test"], "restarts": 1,
                          "seconds": [el[0]["full"]["seconds"], el[0]["hit"]["seconds"]]}
    dp, tp = details["2x1"], details["1x2"]
    print(f"[two ranks] gloo, 2 ranks on one card, P12: DP 2x1 (f32 attention operands) "
          f"loss / parameter / gradient error {dp['loss_err']:.3e} / {dp['param_err']:.3e} / "
          f"{dp['grad_rel_err']:.3e}, TP 1x2 {tp['loss_err']:.3e} / {tp['param_err']:.3e} / "
          f"{tp['grad_rel_err']:.3e} (limits {TWO_RANK_TOL}); TP 1x2 bf16 first step: loss "
          f"{bf['first_loss_err']:.3e}, logits {bf['logit_err']:.3e}, gradient "
          f"{bf['grad_rel_err']:.3e} (limits {TWO_RANK_BF16_TOL}); step ms one rank "
          f"{one_ms:.3f}, DP {dp['step_ms']}, TP {tp['step_ms']}, TP bf16 {bf['step_ms']}; "
          f"flash_mha_packed launches a rank: TP {tp['launches']} forward, "
          f"{tp['bwd_launches']} backward, TP bf16 {bf['tc_launches']} / "
          f"{bf['tc_bwd_launches']} on the tensor cores; run_elastic restarted "
          f"once, bit-equal to the uninterrupted run; best-parameter shards {shards}",
          flush=True)
    if "hit.shard0-of2.npz" not in shards and "full.shard0-of2.npz" not in shards:
        # a best epoch writes both ranks' shards; a split whose val AUROC
        # never rises above 0 writes none
        print("[two ranks] no epoch improved the val AUROC: no shard file", flush=True)
    return details


# ------------------------------------------------------- the model-axis routes
# The routes' limits. World size 1 (make_mesh(1, 1), route_one_rank_runs):
# loss, the first step's logits and the parameters after MESH_STEPS steps
# within ROUTE_ONE_RANK_TOL of the one-device Trainer on the same rung. Two
# ranks (scale_out_phase): the JAX package's mesh tolerances
# (tests/test_scale_out_routes.py: loss rtol 2e-4; logits and parameters
# rtol 1e-3, atol 1e-4). The step's gradient (Adam's first moment after the
# first step) is held by each leaf's relative norm |mu - mu_ref| / |mu_ref|
# at TWO_RANK_TOL["grad"]. Two allowances, both from Adam's normalisation,
# which turns a gradient's rounding noise into whole steps of lr: the
# attention's key bias (the middle third of in_proj_b, whose true
# gradient is zero) is held to 3 * lr; and at most ROUTE_FLIP_FRAC of a
# leaf's elements may pass the parameter limit, each within 2 * lr a step
# (an element whose gradient the two runs round to opposite signs). The
# readings they rest on, on an H100: edge partitioning at world size 1
# against the dense propagation, loss and logits within 1.2e-7, 7 parameter
# elements over 1e-4 (at most 8.1e-6 of a leaf, the largest 2.198e-4), the
# gradient's largest element 2.4e-3 of its leaf's largest, its relative
# norm 7.5e-4; on two ranks (chip_ab.py's route_faults task) the sound runs'
# relative norms at most 3.3e-4 (elements up to 1.8e-3, parameters past the
# limit at most 5.4e-6 of a leaf), and the planted faults' (a key/value
# gradient not summed, the partial leaves not summed, the ring's rotation
# passing no gradient, edge partitioning's input gradient not summed)
# 0.31 to 1.0.
ROUTE_ONE_RANK_TOL = 1e-4
ROUTE_TOL = {"loss_rtol": 2e-4, "rtol": 1e-3, "atol": 1e-4}
ROUTE_FLIP_FRAC = 1e-4
ROUTE_STEPS_LR = 1e-4
CP_LONG_BATCH = 32      # the 2048-step window's batch (a cut: see scale_out_phase)


def _route_result(losses, tr, ms, first):
    """A _mesh_run's result as numpy: losses, the live parameters (whole on
    every rank under a route; a dead one never changes), the first step's
    logits and Adam's first moment, ms a step."""
    return {"losses": np.asarray(losses.tolist(), np.float64),
            "params": {p: t.detach().float().cpu().numpy() for p, t in tr.live},
            "first": first, "step_ms": ms}


def step_errors(got, ref, lr=ROUTE_STEPS_LR):
    """The largest errors of a run against its reference (_route_result's
    dicts): the losses (absolute, and relative to |loss|), the first step's
    logits and the parameters after the steps (absolute, and the ratio to
    atol + rtol |ref| of ROUTE_TOL), the key bias apart (absolute), and the
    first step's gradient: the largest |mu - mu_ref| of a leaf over that
    leaf's largest |mu_ref|. Nothing is asserted here."""
    tol = ROUTE_TOL

    def ratio(a, b):
        return float((np.abs(a - b) / (tol["atol"] + tol["rtol"] * np.abs(b))).max())

    d_loss = np.abs(got["losses"] - ref["losses"])
    out = {"loss_err": float(d_loss.max()),
           "loss_rel_err": float((d_loss / np.abs(ref["losses"])).max()),
           "first_loss_err": float(d_loss[0])}
    lg, lr_ = got["first"]["logits"], ref["first"]["logits"]
    out["logit_err"] = float(np.abs(lg - lr_).max())
    out["logit_ratio"] = ratio(lg, lr_)
    p_err, p_ratio, key_err = 0.0, 0.0, 0.0
    over = {"abs": [0, 0.0], "ratio": [0, 0.0]}     # elements past each limit
    for path, want in ref["params"].items():
        have = got["params"][path]
        if path.endswith("in_proj_b"):
            d = want.shape[0] // 3
            key_err = max(key_err, float(np.abs(have[d:2 * d] - want[d:2 * d]).max()))
            have, want = np.delete(have, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
        diff = np.abs(have - want)
        p_err = max(p_err, float(diff.max()))
        p_ratio = max(p_ratio, ratio(have, want))
        for kind, past in (("abs", diff > ROUTE_ONE_RANK_TOL),
                           ("ratio", diff > tol["atol"] + tol["rtol"] * np.abs(want))):
            n = int(past.sum())
            over[kind][0] += n
            over[kind][1] = max(over[kind][1], n / diff.size)
    steps = len(got["losses"])
    out.update(param_err=p_err, param_ratio=p_ratio, key_bias_err=key_err,
               key_bias_limit=3 * lr, flip_limit=2 * lr * steps,
               params_over=over["abs"][0], params_over_frac=over["abs"][1],
               params_over_ratio=over["ratio"][0],
               params_over_ratio_frac=over["ratio"][1])
    grad, leaf, fro, fro_leaf = 0.0, None, 0.0, None
    for path, m in ref["first"]["mu"].items():
        d = got["first"]["mu"][path] - m
        rel = float(np.abs(d).max()) / max(float(np.abs(m).max()), 1e-30)
        if rel > grad:
            grad, leaf = rel, path
        rf = float(np.linalg.norm(d)) / max(float(np.linalg.norm(m)), 1e-30)
        if rf > fro:
            fro, fro_leaf = rf, path
    out.update(grad_rel_err=grad, grad_worst_leaf=leaf, grad_fro_err=fro,
               grad_fro_leaf=fro_leaf)
    return out


def hold_route(name, e, how):
    """Raise unless the errors (step_errors) are within the limits: how =
    "one rank" (ROUTE_ONE_RANK_TOL, world size 1), "mesh" (ROUTE_TOL) or
    "bf16 first step" (TWO_RANK_BF16_TOL on the first step's loss and
    logits, the losses of every step at ROUTE_TOL's loss rtol, the
    parameters at ROUTE_TOL); the gradient's relative norm, the key bias and
    the elements past the parameter limit as the comment above
    ROUTE_ONE_RANK_TOL says."""
    grad = ("grad", e["grad_fro_err"], TWO_RANK_TOL["grad"])
    key = ("key bias", e["key_bias_err"], e["key_bias_limit"])
    flips = ("parameters past the limit, within 2 lr a step", e["param_err"],
             e["flip_limit"])
    if how == "one rank":
        checks = (("loss", e["loss_err"], ROUTE_ONE_RANK_TOL),
                  ("logits", e["logit_err"], ROUTE_ONE_RANK_TOL),
                  ("parameters past 1e-4, share of a leaf", e["params_over_frac"],
                   ROUTE_FLIP_FRAC), flips, key, grad)
    else:
        params = (("parameters past the limit, share of a leaf",
                   e["params_over_ratio_frac"], ROUTE_FLIP_FRAC), flips, key, grad)
        if how == "mesh":
            checks = (("loss", e["loss_rel_err"], ROUTE_TOL["loss_rtol"]),
                      ("logits", e["logit_ratio"], 1.0), *params)
        else:
            tol = TWO_RANK_BF16_TOL
            checks = (("first loss", e["first_loss_err"], tol["loss"]),
                      ("logits", e["logit_err"], tol["logits"]),
                      ("loss", e["loss_rel_err"], ROUTE_TOL["loss_rtol"]), *params)
    for what, err, limit in checks:
        if not err <= limit:
            raise AssertionError(f"route {name}: {what} error {err:.3e} over "
                                 f"{limit:.3e}: {e}")


def _route_line(tag, name, e, ms=None):
    print(f"[{tag}] {name}: loss error {e['loss_err']:.3e} (relative "
          f"{e['loss_rel_err']:.3e}, first step {e['first_loss_err']:.3e}), first "
          f"logits {e['logit_err']:.3e} (ratio to atol + rtol |ref| "
          f"{e['logit_ratio']:.3f}), parameters {e['param_err']:.3e} (ratio "
          f"{e['param_ratio']:.3f}; {e['params_over']} elements over "
          f"{ROUTE_ONE_RANK_TOL}, at most {e['params_over_frac']:.2e} of a leaf; "
          f"{e['params_over_ratio']} past atol + rtol |ref|, at most "
          f"{e['params_over_ratio_frac']:.2e} of a leaf), key "
          f"bias {e['key_bias_err']:.3e}, gradient {e['grad_rel_err']:.3e} of the "
          f"leaf's largest ({e['grad_worst_leaf']}), its relative norm "
          f"{e['grad_fro_err']:.3e} ({e['grad_fro_leaf']})"
          + ("" if ms is None else f"; step ms {ms}"), flush=True)


# (name, TrainConfig route, configuration overrides) at P12, world size 1:
# sequence-parallel and ring attention held to the dense rung, edge
# partitioning to the packed pair's rung (f32 operands, so 1e-4 can hold)
ROUTES_ONE_RANK = (
    ("sp", {"context_parallel": "sp"}, {"dropout": 0.0, "attention_backend": "dense"}),
    ("ring", {"context_parallel": "ring"}, {"dropout": 0.0, "attention_backend": "dense"}),
    ("edge partition", {"edge_partition": True},
     {"dropout": 0.0, "attention_score_dtype": "float32"}))


def route_one_rank_runs(mesh, device="cuda", seed=0, batch=128):
    """The routes on make_mesh(1, 1) (the caller's process group of one
    rank): each of ROUTES_ONE_RANK at P12, MESH_STEPS steps at full width
    (B=128, dropout 0) through Trainer(mesh=...) against the Trainer
    without a mesh on the same rung, from the same parameters, batches and
    seeds, held at ROUTE_ONE_RANK_TOL. Returns {name: errors and step ms}."""
    import dataclasses

    import torch

    out = {}
    for name, route, overrides in ROUTES_ONE_RANK:
        cfg, tcfg, params, data, idx, seeds = _mesh_inputs("P12", device, seed, batch,
                                                           overrides)
        ref = _route_result(*_mesh_run(cfg, tcfg, params, data, idx, seeds, device,
                                       first=True))
        got = _route_result(*_mesh_run(cfg, dataclasses.replace(tcfg, **route), params,
                                       data, idx, seeds, device, mesh, first=True))
        e = step_errors(got, ref)
        _route_line("routes, world size 1", f"P12 {name}", e,
                    f"{got['step_ms']:.3f} (without the route {ref['step_ms']:.3f})")
        out[name] = {**e, "step_ms": got["step_ms"], "ref_step_ms": ref["step_ms"]}
        del params, data, ref, got
        torch.cuda.empty_cache()
    for name, _, _ in ROUTES_ONE_RANK:
        hold_route(name, out[name], "one rank")
    return out


def _digest(res):
    """A hash of a run's losses, parameters and first moment: the ranks of
    a route hold the same ones bit for bit."""
    import hashlib

    h = hashlib.sha1(res["losses"].tobytes())
    for tree in (res["params"], res["first"]["mu"]):
        for path in sorted(tree):
            h.update(np.ascontiguousarray(tree[path]).tobytes())
    return h.hexdigest()


def _route_run(dataset, route, overrides, mesh, device, seed, batch, n_batches=MESH_STEPS,
               lr=ROUTE_STEPS_LR, pipeline=0, fixed=False, predict=False):
    """n_batches steps of a route (TrainConfig fields `route`) at full width
    on `mesh` (None: the one-rank run without a mesh): a _route_result;
    `fixed` repeats the first batch and its seeds (one objective), `predict`
    adds the trained model's predict on `batch` rows of new requests."""
    import dataclasses

    cfg, tcfg, params, data, idx, seeds = _mesh_inputs(dataset, device, seed, batch,
                                                       overrides, n_batches, pipeline)
    if fixed:
        idx, seeds = idx[:1].repeat(n_batches, 1), seeds[:1] * n_batches
    tcfg = dataclasses.replace(tcfg, learning_rate=lr, **route)
    losses, tr, ms, first = _mesh_run(cfg, tcfg, params, data, idx, seeds, device, mesh,
                                      first=True)
    out = _route_result(losses, tr, ms, first)
    if predict:
        P, times, static = make_requests(cfg, batch, seed + 5)
        out["predict"] = tr.predict(None, P, times, static, batch_size=batch)
    return out


PAM_0 = {"dropout": 0.0}
# the pipeline at dropout 0.2 on one batch and one set of masks at lr 1e-3,
# as train_phase's fit: P12's loss there moves up and down over the first
# steps (it fell from 0.703 to 0.693 over 5 steps, on an H100)
PIPELINE_FIT_STEPS = 10
P12_0 = {"dropout": 0.0, "attention_backend": "dense"}
LONG_CP = {"max_len": 2048}


def scale_out_reference(device="cuda", seed=0, batch=128):
    """The one-rank runs scale_out_phase holds the two-rank ones to: PAM on
    the dense rung at dropout 0 (for SP and ring), PAM through SP on
    make_mesh(1, 1) at dropout 0.2 (a process group of one rank, NCCL), P12
    on the dense rung at dropout 0 (the pipeline) and P12 on the packed
    pair at dropout 0.2 (edge partitioning)."""
    import torch
    import torch.distributed as dist
    from raindrop_tpu_torch.parallel.mesh import (
        default_backend, free_port, initialize_distributed, make_mesh)

    refs = {"PAM dense": _route_run("PAM", {}, {**PAM_0, "attention_backend": "dense"},
                                    None, device, seed, batch),
            "P12 dense": _route_run("P12", {}, P12_0, None, device, seed, batch),
            "P12 packed": _route_run("P12", {}, {}, None, device, seed, batch)}
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                           backend=default_backend(device), timeout_s=300)
    try:
        refs["PAM sp one rank"] = _route_run("PAM", {"context_parallel": "sp"}, {},
                                             make_mesh(1, 1), device, seed, batch)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return refs


def _scale_out_worker(rank, device, seed, batch, refs, keys=None):
    """One of two gloo ranks sharing the card, a 1 x 2 mesh: (a) SP and ring
    at PAM, dropout 0, against the one-rank dense run; (b) SP and ring at
    dropout 0.2, SP against ring and against SP on one rank; (c) PAM at
    max_len 2048 through ring and SP, one step and a predict of
    CP_LONG_BATCH rows at dropout 0.2, ring against SP; (d) the pipeline
    at P12 (2 microbatches) at dropout 0 against the one-rank dense run,
    then at dropout 0.2 PIPELINE_FIT_STEPS steps on one batch and one set
    of masks at lr 1e-3; (e) edge partitioning at
    P12 (the packed pair in bf16, dropout 0.2) against the one-rank run,
    flash_mha_packed's launches counted. `keys`: only those runs (None:
    all). Every comparison is made here (step_errors); the parent gets the
    errors, the step ms and each run's digest."""
    import torch
    from raindrop_tpu_torch.ops.flash_attention import flash_mha_packed
    from raindrop_tpu_torch.parallel.mesh import make_mesh

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, 2)
    out = {}

    def want(key):
        return keys is None or key in keys

    def run(key, *args, **kw):
        t0 = time.perf_counter()
        res = _route_run(*args, mesh=mesh, device=device, seed=seed, **kw)
        out[key] = {"digest": _digest(res), "step_ms": res["step_ms"],
                    "losses": res["losses"].tolist(),
                    "seconds": time.perf_counter() - t0}
        return res

    sp = {"context_parallel": "sp"}
    ring = {"context_parallel": "ring"}
    for name, route in (("sp", sp), ("ring", ring)):
        if want(f"a {name}"):
            res = run(f"a {name}", "PAM", route, PAM_0, batch=batch)
            out[f"a {name}"]["errors"] = step_errors(res, refs["PAM dense"])
    if want("b sp"):
        got_sp = run("b sp", "PAM", sp, {}, batch=batch)
        got_ring = run("b ring", "PAM", ring, {}, batch=batch)
        out["b ring"]["errors"] = step_errors(got_ring, got_sp)
        out["b sp"]["errors"] = step_errors(got_sp, refs["PAM sp one rank"])
        del got_sp, got_ring
        torch.cuda.empty_cache()
    if want("c ring"):
        long_sp = run("c sp", "PAM", sp, LONG_CP, batch=CP_LONG_BATCH, n_batches=1,
                      predict=True)
        long_ring = run("c ring", "PAM", ring, LONG_CP, batch=CP_LONG_BATCH,
                        n_batches=1, predict=True)
        out["c ring"]["errors"] = step_errors(long_ring, long_sp)
        a, b = long_ring["predict"], long_sp["predict"]
        out["c predict"] = {
            "logit_err": float(np.abs(a - b).max()),
            "logit_ratio": float((np.abs(a - b) / (ROUTE_TOL["atol"]
                                                   + ROUTE_TOL["rtol"] * np.abs(b))).max()),
            "finite": bool(np.isfinite(a).all() and np.isfinite(b).all())}
        del long_sp, long_ring
        torch.cuda.empty_cache()
    if want("d pipeline"):
        res = run("d pipeline", "P12", {"pipeline_microbatches": 2}, P12_0, batch=batch)
        out["d pipeline"]["errors"] = step_errors(res, refs["P12 dense"])
        run("d pipeline 0.2", "P12", {"pipeline_microbatches": 2}, {}, batch=batch,
            n_batches=PIPELINE_FIT_STEPS, lr=1e-3, pipeline=2, fixed=True)
    if want("e edge partition"):
        reset_counts([flash_mha_packed])
        res = run("e edge partition", "P12", {"edge_partition": True}, {}, batch=batch)
        out["e edge partition"]["errors"] = step_errors(res, refs["P12 packed"])
        out["e edge partition"]["launches"] = {
            a: read_counts([flash_mha_packed], a) for a in ("launches", "bwd_launches")}
    return out


# (result key, what it is held to, how)
SCALE_OUT_HELD = (("a sp", "the one-rank dense run", "mesh"),
                  ("a ring", "the one-rank dense run", "mesh"),
                  ("b sp", "SP on make_mesh(1, 1)", "mesh"),
                  ("b ring", "SP 1x2", "mesh"),
                  ("c ring", "SP 1x2", "mesh"),
                  ("d pipeline", "the one-rank dense run", "mesh"),
                  ("e edge partition", "the one-rank packed run", "bf16 first step"))


def scale_out_phase(device="cuda", seed=0, batch=128):
    """The model-axis routes on two gloo ranks sharing the card
    (parallel/launch.run_ranks: NCCL refuses two ranks on one GPU; gloo
    takes all_reduce and broadcast on CUDA tensors, all the routes use), in
    one group, at full model width (_scale_out_worker's runs (a)-(e)): SP
    1x2 and ring 1x2 at PAM (T=600, hd 42), MESH_STEPS steps at B=128,
    dropout 0, against the one-rank dense step; at dropout 0.2 SP against
    ring and against SP on one rank (the coordinate hash does not depend on
    the sharding); PAM at max_len 2048 through ring against SP, one step
    and a predict at B=CP_LONG_BATCH (32, not 128: a cut, the dense scores
    of a 2048-step window take 4 GB a tensor at 128 rows), dropout 0.2; the
    pipeline 1x2 at P12 (2 microbatches) against the one-rank dense step,
    then at dropout 0.2 finite with a falling loss on a fixed batch; edge
    partitioning 1x2 at P12 (1296 edges, 648 a rank) against the one-rank
    packed step, flash_mha_packed launched forward and backward on every
    rank, all on the tensor cores. Held at SCALE_OUT_HELD's limits
    (hold_route); the ranks agree bit for bit. Returns the details."""
    import torch
    from raindrop_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    refs = scale_out_reference(device, seed, batch)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(_scale_out_worker, 2, device, seed, batch, refs, backend="gloo",
                      timeout_s=900, threads=4)
    took = time.perf_counter() - t0
    details = {"reference_seconds": ref_s, "ranks_seconds": took,
               "one_rank_step_ms": {k: v["step_ms"] for k, v in refs.items()}}
    r0 = ranks[0]
    for key, res in r0.items():
        if key == "c predict":
            continue
        if any(r[key]["digest"] != res["digest"] for r in ranks[1:]):
            raise AssertionError(f"route {key}: the ranks disagree")
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"route {key}: losses {res['losses']}")
    for key, against, how in SCALE_OUT_HELD:
        e = r0[key]["errors"]
        _route_line("scale out", f"{key} against {against}", e,
                    [r[key]["step_ms"] for r in ranks])
    pred = r0["c predict"]
    print(f"[scale out] c predict, PAM-2048 ring against SP on {CP_LONG_BATCH} rows: "
          f"logit error {pred['logit_err']:.3e} (ratio {pred['logit_ratio']:.3f})",
          flush=True)
    pipe = r0["d pipeline 0.2"]["losses"]
    print(f"[scale out] d pipeline at dropout 0.2, lr 1e-3, one batch and one set of "
          f"masks: losses {pipe}; "
          f"step ms {[r['d pipeline 0.2']['step_ms'] for r in ranks]}", flush=True)
    edge = [r["e edge partition"]["launches"] for r in ranks]
    print(f"[scale out] e edge partition: flash_mha_packed launches a rank {edge}",
          flush=True)
    print(f"[scale out] one-rank step ms {details['one_rank_step_ms']}; the references "
          f"{ref_s:.1f} s, the two ranks {took:.1f} s "
          f"({ {k: round(v['seconds'], 1) for k, v in r0.items() if 'seconds' in v} })",
          flush=True)
    for key, _, how in SCALE_OUT_HELD:
        hold_route(key, r0[key]["errors"], how)
    if not (pred["finite"] and pred["logit_ratio"] <= 1.0):
        raise AssertionError(f"route c predict: {pred}")
    if not pipe[-1] < pipe[0]:
        raise AssertionError(f"route d pipeline at dropout 0.2: losses {pipe} do not fall")
    for c in edge:
        check_tc("edge partition", c["launches"], c["bwd_launches"])
    details.update({k: v for k, v in r0.items()})
    details["edge_launches"] = edge
    del refs
    torch.cuda.empty_cache()
    return details


def torchrun_cli_phase(seed=0):
    """The CLI through torchrun, one process (`--distributed true`: the
    group from torchrun's environment, NCCL; `--data-parallel 1`), P12 for
    1 epoch at full width from dataset files written from `seed`: exit 0,
    finite metrics in [0, 100]. Returns (summary, seconds)."""
    from raindrop_tpu_torch.parallel.mesh import free_port

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "P12data")
        write_p12_root(root, seed)
        out = os.path.join(tmp, "out.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
               "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
               "-m", "raindrop_tpu_torch.run", "--distributed", "true",
               "--data-parallel", "1", "--dataset", "P12", "--data-root", root,
               "--epochs", "1", "--n-splits", "1", "--batch-size", "128",
               "--seed", str(seed), "--checkpoint-dir", os.path.join(tmp, "ckpt"),
               "--out-json", out]
        print(f"[cli] torchrun: {' '.join(cmd[1:])}", flush=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                              timeout=600)
        took = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun CLI exit {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(out) as f:
            summary = json.load(f)["missing_0.0"]
    for name, s in summary.items():
        if not (np.isfinite(s["mean"]) and 0.0 <= s["mean"] <= 100.0):
            raise AssertionError(f"torchrun CLI: {name} = {s}")
    print(f"[cli] torchrun P12, 1 epoch: {took:.1f} s, "
          + ", ".join(f"{k} {v['mean']:.2f}" for k, v in summary.items()), flush=True)
    return summary, took


# ------------------------------------------------------------- host runtime
PAM_2048_BATCH = (128, 2048, 34)   # one PAM-2048 batch: B, T, 2F (float32)
P12_SIZE = (11988, 215, 36, 9)     # P12's samples, steps, sensors, statics


def _delta_numpy(mask, times):
    """The GRU-D deltas in float64 numpy, rounded to float32 at each step as
    the host runtime's loop rounds them (data/preprocess.py's deltas)."""
    N, T, F = mask.shape
    d = np.zeros((N, T, F), np.float32)
    for t in range(1, T):
        gap = (times[:, t] - times[:, t - 1])[:, None]
        d[:, t] = (gap + (1.0 - mask[:, t - 1].astype(np.float64))
                   * d[:, t - 1].astype(np.float64)).astype(np.float32)
    return d


@contextlib.contextmanager
def native_flag(value):
    """RAINDROP_TPU_NATIVE set to `value` in the scope ("0": the numpy
    functions), restored after."""
    old = os.environ.get("RAINDROP_TPU_NATIVE")
    os.environ["RAINDROP_TPU_NATIVE"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RAINDROP_TPU_NATIVE")
        else:
            os.environ["RAINDROP_TPU_NATIVE"] = old


def _host_ms(fn, reps):
    """Median host-clock ms of fn() over `reps` calls after one warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def host_runtime_phase(seed=0):
    """The C++ host runtime (raindrop_tpu_torch/native.py over
    csrc/host/raindrop_host.cpp) on the card's host: built once with g++
    (seconds printed), each of its seven functions held against the numpy
    path on the same arrays (bit-equal; get_stats within 1e-12 relative;
    build_delta against the float64 recurrence it computes, and beside the
    port's float32 torch deltas), the OpenMP runtimes mapped in the
    process, and the times of the producer's gather of one PAM-2048 batch
    and of load_split's normalization at P12's size, numpy against C++."""
    import torch
    from raindrop_tpu_torch import native
    from raindrop_tpu_torch.baselines.grud import build_delta as torch_delta
    from raindrop_tpu_torch.data import normalize as norm
    from raindrop_tpu_torch.data.settings import remove_sensors_fixed

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    with open("/proc/self/maps") as f:
        gomp = sorted({line.split()[-1] for line in f if "gomp" in line})
    print(f"[host] built {native.library_path().name} in {build_s:.2f} s; OpenMP "
          f"runtimes mapped: {gomp}", flush=True)
    rng = np.random.default_rng(seed)
    P = np.abs(rng.normal(3.0, 2.0, size=(300, 60, 17))) * (rng.uniform(size=(300, 60, 17)) > 0.5)
    P[:, :, 4] = 0.0
    Ps = rng.normal(1.0, 2.0, size=(300, 9))
    with native_flag("0"):
        mf_n, sd_n = norm.get_stats(P)
        mf0 = np.nan_to_num(mf_n)
        norm_n = norm.mask_normalize(P.astype(np.float64), mf0, sd_n).astype(np.float32)
        ms, ss = norm.get_stats_static(Ps, "P12", compat=False)
        stat_n = norm.mask_normalize_static(Ps, ms, ss).astype(np.float32)
    mf_c, sd_c = native.get_stats(P)
    fin = np.isfinite(mf_n)
    stats_err = float(max(np.abs(mf_c[fin] / mf_n[fin] - 1).max(),
                          np.abs(sd_c[fin] / sd_n[fin] - 1).max()))
    mask = (P > 0).astype(np.float32)
    times = np.cumsum(rng.uniform(0.1, 1.5, size=(300, 60)), axis=1)
    delta = native.build_delta(mask, times)
    torch_err = float((torch.from_numpy(delta) - torch_delta(
        torch.from_numpy(mask), torch.from_numpy(times.astype(np.float32)))).abs().max())
    X = rng.normal(size=(300, 60, 34)).astype(np.float32)
    ranked = rng.permutation(17)
    idx = rng.integers(0, 300, size=128)
    # bit-equal, NaN where numpy gives NaN (the never-observed sensor's std)
    equal = {
        "mask_normalize": np.array_equal(native.mask_normalize(P, mf0, sd_n), norm_n,
                                         equal_nan=True),
        "mask_normalize_static": np.array_equal(native.mask_normalize_static(Ps, ms, ss),
                                                stat_n),
        "build_delta": np.array_equal(delta, _delta_numpy(mask, times)),
        "zero_sensors": np.array_equal(native.zero_sensors(X.copy(), ranked[:5]),
                                       remove_sensors_fixed(X, ranked, 5 / 17)),
        "gather_rows": np.array_equal(native.gather_rows(X, idx), X[idx]),
        "gather_time_major": np.array_equal(native.gather_time_major(X, idx),
                                            np.moveaxis(X[idx], 0, 1)),
        "get_stats_nan": bool(np.isnan(mf_c[4]) and np.isnan(sd_c[4])),
    }
    print(f"[host] against numpy: get_stats {stats_err:.3e} relative (limit 1e-12); "
          f"bit-equal {equal}; build_delta against the float32 torch recurrence "
          f"{torch_err:.3e}", flush=True)
    if stats_err > 1e-12 or not all(equal.values()):
        raise AssertionError(f"the host runtime disagrees with numpy: get_stats "
                             f"{stats_err}, {equal}")

    # the producer's gather of one PAM-2048 batch from a split on the host
    B, T, C = PAM_2048_BATCH
    src = rng.normal(size=(4 * B, T, C)).astype(np.float32)
    rows = rng.permutation(4 * B)[:B]
    gather = {"numpy": _host_ms(lambda: np.ascontiguousarray(src[rows]), 10),
              "cpp": _host_ms(lambda: native.gather_rows(src, rows), 10)}
    del src
    # load_split's normalization at P12's size: the train portion's stats,
    # then every sample normalized (data/normalize.tensorize_normalize)
    N, T12, F, S = P12_SIZE
    arrs = np.abs(rng.normal(2.0, 1.0, size=(N, T12, F)))   # float64, as parse writes
    arrs *= rng.uniform(size=arrs.shape) > 0.8
    tms = np.cumsum(rng.uniform(1, 20, size=(N, T12)), axis=1)
    statics = rng.normal(size=(N, S))
    y = rng.integers(0, 2, size=N)
    train = int(0.8 * N)

    def normalize():
        mf, sd = norm.get_stats(arrs[:train])
        ms_, ss_ = norm.get_stats_static(statics[:train], "P12")
        return norm.tensorize_normalize(arrs, tms, statics, y, np.nan_to_num(mf), sd,
                                        ms_, ss_)

    with native_flag("0"):
        t0 = time.perf_counter()
        want = normalize()
        numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = normalize()
    cpp_s = time.perf_counter() - t0
    # numpy's pairwise sums and the runtime's compensated ones give stats
    # 1e-15 apart, which move the last float32 digits of the z-scores
    diff = max(float(np.abs(a.astype(np.float64) - b).max()) / max(1.0, float(np.abs(b).max()))
               for a, b in zip(got, want))
    same = diff <= 1e-6
    mb = B * T * C * 4 / 1e6
    print(f"[host] gather of one PAM-2048 batch ({B} x {T} x {C} float32, {mb:.1f} MB): "
          f"numpy {gather['numpy']:.3f} ms, C++ {gather['cpp']:.3f} ms (medians of 10); "
          f"load_split's normalization at P12's size ({N} x {T12} x {F}): numpy "
          f"{numpy_s:.3f} s, C++ {cpp_s:.3f} s, the arrays {diff:.3e} apart relative "
          f"(limit 1e-6)", flush=True)
    if not same:
        raise AssertionError(f"load_split's normalization: numpy and C++ {diff} apart")
    del arrs, got, want
    return dict(build_s=build_s, library=native.library_path().name, openmp=gomp,
                get_stats_rel_err=stats_err, bit_equal=equal,
                delta_vs_torch_f32=torch_err, gather_ms=gather, gather_mb=mb,
                normalize_s={"numpy": numpy_s, "cpp": cpp_s}, normalize_rel_diff=diff)


# ------------------------------------------------------------ past hd 368
WIDE_HEAD = {"sensor_wise_mask": True, "nhead": 1}   # P12-sw at one head: hd 720
HD_STREAM_PACKED = (372, 720, 1023)
HD_STREAM_SPLIT = (720, 1024)


def _route_counts(fn, route):
    return {a: getattr(fn, a) for a in ("launches", "bwd_launches", f"{route}_launches",
                                         f"{route}_bwd_launches")}


def _check_route_launches(what, fn, route, before, fwd, bwd):
    """fwd forward and bwd backward launches of `fn` since `before`
    (_route_counts), every one on `route`."""
    now = _route_counts(fn, route)
    got = {a: now[a] - before[a] for a in now}
    want = {"launches": fwd, "bwd_launches": bwd, f"{route}_launches": fwd,
            f"{route}_bwd_launches": bwd}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _check_packed_route(what, route, counts):
    for c in counts:
        n = c["flash_mha_packed"]
        if n <= 0 or c[f"flash_mha_packed.{route}"] != n:
            raise AssertionError(f"{what}: flash_mha_packed launches off the {route} "
                                 f"route: {c}")


def check_hd_stream(what, *counts):
    """Every flash_mha_packed launch in these counts past hd 368 took the
    "hd_stream" route (f32 attention operands)."""
    _check_packed_route(what, "hd_stream", counts)


def check_tc_cluster(what, *counts):
    """Every flash_mha_packed launch in these counts past hd 368 took the
    "tc_cluster" route (bf16 attention operands)."""
    _check_packed_route(what, "tc_cluster", counts)


def sdpa_backend(q, k, v, mask):
    """The first of PyTorch's SDPA backends (flash, memory-efficient,
    cuDNN, math) that takes these operands with a key mask and dropout,
    forward and backward: (its name, a callable running SDPA on it)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                out = sdpa(q, k, v, attn_mask=mask, dropout_p=0.2)
                torch.autograd.grad(out.sum(), (q, k, v))
        except RuntimeError:
            continue

        def run(dropout_p=0.0, b=b):
            with sdpa_kernel([b]):
                return sdpa(q, k, v, attn_mask=mask, dropout_p=dropout_p)
        return b.name, run
    raise AssertionError("no SDPA backend takes these operands")


def hd_stream_kernel_phase(device="cuda", seed=0):
    """The routes past hd 368 against the plain versions: flash_mha_packed
    at hd 372, 720 and 1023 (B=8, T=215, one head) and flash_mha at hd 720
    and 1024 on T=600 and T=2048 (B=8, H=1), forward and backward, f32 and
    bf16, dropout 0 and 0.2, ragged lengths with 0 and 1 (zeros for the
    length-0 sample); every bf16 launch counted on "tc_cluster", every f32
    one on "hd_stream"; each bf16 call at dropout 0.2 repeated, bit-equal;
    at hd 360 impl="hd_stream" bit-equal to the scalar Wide kernels it
    mirrors; and the clusters of the new route the card holds at once."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    runs = []
    for kind, dims, Ts in (("packed", HD_STREAM_PACKED, (215,)),
                           ("split", HD_STREAM_SPLIT, (600, 2048))):
        fn = fa.flash_mha_packed if kind == "packed" else fa.flash_mha
        for hd in dims:
            for T in Ts:
                B = 8
                shape = (B, T, hd) if kind == "packed" else (B, 1, T, hd)
                q, k, v, g = (torch.randn(shape, generator=gen, device=device)
                              for _ in range(4))
                lengths = ragged_lengths(gen, B, T, device)
                for dtype, rate in [(dt, r) for dt in ("float32", "bfloat16")
                                    for r in (0.0, 0.2)]:
                    cd = None if dtype == "float32" else dtype
                    od = fa.operand_dtype(cd)
                    route = "hd_stream" if dtype == "float32" else "tc_cluster"
                    before = _route_counts(fn, route)

                    def run():
                        if kind == "packed":
                            o, lse = fa._packed_fwd(q, k, v, lengths, SEED, rate, cd, 1)
                            return o, lse, *fa._packed_bwd_cuda(q, k, v, lengths, SEED, rate,
                                                                1, od, o, lse, g)
                        o, lse = fa._flash_fwd(q, k, v, lengths, SEED, rate, cd)
                        return o, lse, *fa._flash_bwd_cuda(q, k, v, lengths, SEED, rate, od,
                                                           o, lse, g)
                    o, lse, *grads = run()
                    _check_route_launches(f"{kind} hd {hd} T={T} {dtype}", fn, route, before,
                                          1, 1)
                    if kind == "packed":
                        po, plse = fa._packed_fwd_plain(q, k, v, lengths, 1, od, SEED, rate)
                        want = fa._packed_bwd_plain(q, k, v, lengths, SEED, rate, 1, od, o,
                                                    lse, g)
                    else:
                        po, plse = fa._flash_fwd_plain(q, k, v, lengths, od, SEED, rate)
                        want = fa._flash_bwd_plain(q, k, v, lengths, SEED, rate, od, o, lse,
                                                   g)
                    torch.cuda.synchronize()
                    fwd_err = max(max_err(o, po), max_err(lse, plse))
                    errs = [sample_err(a, b, lengths) for a, b in zip(grads, want)]
                    zero = all(bool((x[0] == 0).all()) for x in (o, *grads))
                    finite = all(bool(torch.isfinite(x).all()) for x in (o, *grads))
                    repeat = None
                    if dtype == "bfloat16" and rate > 0:
                        again = run()
                        repeat = all(torch.equal(a, b) for a, b in zip((o, lse, *grads),
                                                                       again))
                    ok = (fwd_err <= TOL[dtype] and max(errs) <= SAMPLE_TOL[dtype]
                          and zero and finite and repeat is not False)
                    runs.append(dict(kind=kind, hd=hd, T=T, dtype=dtype, rate=rate,
                                     route=route, max_abs_err=fwd_err,
                                     grad_sample_err=max(errs), grad_errs=errs,
                                     bit_equal_repeat=repeat))
                    print(f"[past hd 368] {kind} hd {hd} T={T} {dtype} dropout {rate} "
                          f"({route}): forward max_abs_err {fwd_err:.3e} (tol "
                          f"{TOL[dtype]:g}), gradients sample_err dq/dk/dv "
                          f"{', '.join(f'{e:.3e}' for e in errs)} (tol "
                          f"{SAMPLE_TOL[dtype]:g})"
                          + ("" if repeat is None else f", repeat bit-equal {repeat}"),
                          flush=True)
                    if not ok:
                        raise AssertionError(f"{route} {kind} disagrees at hd {hd} T={T} "
                                             f"{dtype} {rate} (zeros {zero}, finite {finite}, "
                                             f"repeat {repeat})")
    # below 369 the route is the scalar Wide kernels' bits
    q, k, v, g = (torch.randn((8, 215, 720), generator=gen, device=device) for _ in range(4))
    lengths = ragged_lengths(gen, 8, 215, device)
    for cd in (None, "bfloat16"):
        od = fa.operand_dtype(cd)
        outs = []
        for impl in ("scalar", "hd_stream"):
            o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.2, 2, od, impl)
            outs.append((o, lse, *fa._packed_bwd_cuda(q, k, v, lengths, SEED, 0.2, 2, od,
                                                      o, lse, g, impl)))
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"hd_stream at hd 360 ({cd}) is not the scalar Wide "
                                 f"kernels' bits")
    print("[past hd 368] hd 360, dropout 0.2: impl='hd_stream' bit-equal to the scalar Wide "
          "kernels in f32 and bf16 (o, lse, dq, dk, dv)", flush=True)
    occupancy = {}
    for hd in (372, 720, 1024, 2048):
        n, W = fa.tc_cluster_size(hd)
        occ = fa.tc_cluster_occupancy(hd)
        occupancy[hd] = dict(cluster=n, slice=W, smem=fa.tc_cluster_smem(W),
                             max_active_clusters=occ)
        print(f"[past hd 368] tc_cluster at hd {hd}: clusters of {n} CTAs x {W} columns, "
              f"shared bytes {fa.tc_cluster_smem(W)}; the card holds {occ} clusters of the "
              f"forward, dq and dk/dv at once (cudaOccupancyMaxActiveClusters)", flush=True)
        if min(occ) <= 0:
            raise AssertionError(f"tc_cluster at hd {hd}: a cluster does not fit the card")
    return dict(runs=runs, occupancy=occupancy)


def hd_stream_timing(label, kind, B, T, hd, dtype, device="cuda", seed=0, reps=5):
    """The forward and backward past hd 368 at one shape (one head, dropout
    0.2 in the backward, the model's): CUDA-event ms of the plan's route
    ("tc_cluster" in bf16) and, in bf16, of the previous design
    (impl="hd_stream"), timed in turns previous, new, new, previous; the
    plain versions', SDPA's with a key mask on the first backend that takes
    the head dim (named), and the bounds (bytes of attention_bytes; 4 and
    10 T hd FLOPs a live key)."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    cd = None if dtype == "float32" else dtype
    od = fa.operand_dtype(cd)
    shape = (B, T, hd) if kind == "packed" else (B, 1, T, hd)
    q, k, v, g = (torch.randn(shape, generator=gen, device=device).to(od)
                  for _ in range(4))
    lengths = ragged_lengths(gen, B, T, device)

    def calls(impl):
        if kind == "packed":
            o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.2, 1, od, impl)
            return (lambda: fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.0, 1, od, impl),
                    lambda: fa._packed_bwd_cuda(q, k, v, lengths, SEED, 0.2, 1, od, o, lse,
                                                g, impl))
        o, lse = fa._flash_fwd_cuda(q, k, v, lengths, SEED, 0.2, od, impl)
        return (lambda: fa._flash_fwd_cuda(q, k, v, lengths, SEED, 0.0, od, impl),
                lambda: fa._flash_bwd_cuda(q, k, v, lengths, SEED, 0.2, od, o, lse, g, impl))

    route = fa.packed_plan(B, T, hd, 1, od).route
    impls = ("hd_stream", "auto", "auto", "hd_stream") if dtype == "bfloat16" else ("auto",)
    t = {}
    for impl in impls:
        fwd, bwd = calls(impl)
        t.setdefault(impl, []).append((time_ms(fwd, reps, 1), time_ms(bwd, reps, 1)))
    ms, bwd_ms = (sum(x[i] for x in t["auto"]) / len(t["auto"]) for i in (0, 1))
    prev = t.get("hd_stream")
    prev_ms, prev_bwd_ms = ((sum(x[i] for x in prev) / len(prev) for i in (0, 1)) if prev
                            else (None, None))
    if kind == "packed":
        o, lse = fa._packed_fwd_cuda(q, k, v, lengths, SEED, 0.2, 1, od)
        plain_fwd = lambda: fa._packed_fwd_plain(q, k, v, lengths, 1, od)  # noqa: E731
        plain_bwd = lambda: fa._packed_bwd_plain(  # noqa: E731
            q, k, v, lengths, SEED, 0.2, 1, od, o, lse, g)
    else:
        o, lse = fa._flash_fwd_cuda(q, k, v, lengths, SEED, 0.2, od)
        plain_fwd = lambda: fa._flash_fwd_plain(q, k, v, lengths, od)  # noqa: E731
        plain_bwd = lambda: fa._flash_bwd_plain(  # noqa: E731
            q, k, v, lengths, SEED, 0.2, od, o, lse, g)
    plain_ms, bwd_plain_ms = time_ms(plain_fwd, 3, 1), time_ms(plain_bwd, 3, 1)
    live = lengths > 0
    qh, kh, vh = (x[live].reshape(-1, T, 1, hd).transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    keep = (torch.arange(T, device=device)[None, :]
            < lengths[live][:, None])[:, None, None, :]
    backend, sdpa = sdpa_backend(qh, kh, vh, keep)
    library_ms = time_ms(sdpa, reps, 1)
    out = sdpa(0.2)
    gh = g[live].reshape(-1, T, 1, hd).transpose(1, 2)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                         retain_graph=True), reps, 1)
    esize = 2 if dtype == "bfloat16" else 4
    keys = float(lengths.sum())
    fb = bound(attention_bytes(lengths, T, hd, 1, esize), 4.0 * T * hd * keys, dtype)
    bb = bound(attention_bytes(lengths, T, hd, 1, esize, backward=True),
               10.0 * T * hd * keys, dtype)
    prev_line = ("" if prev is None else
                 f"; previous design (hd_stream) {prev_ms:.4f} / {prev_bwd_ms:.4f} ms, "
                 f"{prev_ms / ms:.2f}x / {prev_bwd_ms / bwd_ms:.2f}x")
    print(f"[past hd 368] {label} {kind} B={B} T={T} hd {hd} {dtype} ({route}): forward "
          f"{ms:.4f} ms (bound {fb[0]:.4f} ms, {fb[1]}; plain {plain_ms:.4f}; SDPA "
          f"({backend}) {library_ms:.4f}); backward, dropout 0.2 {bwd_ms:.4f} ms (bound "
          f"{bb[0]:.4f} ms, {bb[1]}; plain {bwd_plain_ms:.4f}; SDPA backward "
          f"{bwd_library_ms:.4f}){prev_line}; turns {t}", flush=True)
    return dict(label=label, kind=kind, B=B, T=T, hd=hd, dtype=dtype, route=route, ms=ms,
                bwd_ms=bwd_ms, prev_ms=prev_ms, prev_bwd_ms=prev_bwd_ms, turns=t,
                plain_ms=plain_ms, bwd_plain_ms=bwd_plain_ms, library_ms=library_ms,
                bwd_library_ms=bwd_library_ms, sdpa_backend=backend, bound_ms=fb[0],
                bound_by=fb[1], bwd_bound_ms=bb[0], bwd_bound_by=bb[1])


def wide_head_model(wrappers, overrides, label, device="cuda", seed=0, batch=128,
                    buckets=(1, 8, 32, 128), steps=3, base=WIDE_HEAD,
                    check=check_hd_stream):
    """P12-sw at one head (`base`; d = hd = 720, T=215, 2 layers, dropout
    0.2) with `overrides`: served at the four buckets, then trained `steps`
    steps at B=128; the counts set to 0 before each and read after, every
    launch on the route `check` holds them to (flash_mha_packed's on
    "hd_stream"; check_tc_cluster: on "tc_cluster"). Served probabilities
    and the first step's loss and gradient norm (dropout 0) held against
    the same configuration on the kernels' plain versions: 1e-4 with f32
    attention operands, 2e-2 with bf16. Another `base` (P12-sw at T=600: the fused layer) and `check`
    drive another path the same way."""
    import torch
    from raindrop_tpu_torch.config import TrainConfig, dataset_config
    from raindrop_tpu_torch.data.sampler import balanced_batches
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer
    from raindrop_tpu_torch.train.trainer import Trainer

    cfg = dataset_config("P12", **base, **overrides)
    if (cfg.d_transformer, cfg.nhead) != (720, base["nhead"]):
        raise AssertionError(f"{label}: d {cfg.d_transformer}, {cfg.nhead} heads")
    tol = 2e-2 if "bfloat16" in (cfg.compute_dtype, cfg.attention_score_dtype) else 1e-4
    params = raindrop_init(seed, cfg, device=device)
    server = InferenceServer(cfg, params, buckets=buckets, device=device)
    top = buckets[-1]
    P, times, static = make_requests(cfg, top, seed + 1)
    reset_counts(wrappers)
    outs = {n: server.predict(P[:n], times[:n], _rows(static, slice(0, n)))
            for n in buckets}
    launches = read_counts(wrappers, "launches")
    check(f"{label} serving", launches)
    for n, pr in outs.items():
        _probs_ok(f"{label} served {n}", pr)
    with plain_kernels():
        plain = server.predict(P[:top], times[:top], _rows(static, slice(0, top)))
    checks = {"kernel_vs_plain": float(np.abs(outs[top] - plain).max()),
              "alone_vs_full_bucket": float(np.abs(outs[1][0] - outs[top][0]).max())}
    latency = {}
    for n in buckets:
        args = (P[:n], times[:n], _rows(static, slice(0, n)))
        latency[n] = _host_ms(lambda: server.predict(*args), 3)
    server.close()

    tcfg = TrainConfig(dataset="P12", learning_rate=1e-4, batch_size=batch,
                       batching_strategy=2, seed=seed + 1)
    data, y = make_split(cfg, 4 * batch, seed + 2, device)
    idx = torch.from_numpy(np.stack(list(balanced_batches(
        y, batch, 2, np.random.default_rng(seed)))[:steps])).to(device)
    trainer = Trainer(cfg, tcfg, device=device, params=params)
    reset_counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, _ = trainer.train_epoch(data, idx)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    tf, tb = (read_counts(wrappers, a) for a in ("launches", "bwd_launches"))
    check(f"{label} training", tf, tb)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{label}: a training loss is not finite: {losses}")
    del trainer
    first = {k: v[idx[0]] for k, v in data.items()}
    c0 = dataset_config("P12", **base, **overrides, dropout=0.0)
    (lk, gk, _), (lp, gp, _) = (_first_step(c0, tcfg, params, first, device, plain)
                                for plain in (False, True))
    checks["loss_vs_plain"] = abs(lk - lp) / abs(lp)
    checks["grad_norm_vs_plain"] = abs(gk - gp) / gp
    print(f"[wide head] {label}: served launches {launches}; trained {steps} steps, "
          f"losses {[round(float(x), 6) for x in losses]}, {step_ms:.1f} ms a step (host "
          f"clock), launches {tf}, backward {tb}; latency ms by bucket {latency}; first "
          f"step at dropout 0: loss {lk:.7f} (plain {lp:.7f}), gradient norm {gk:.7f} "
          f"(plain {gp:.7f}); checks {checks} (limit {tol:g})", flush=True)
    bad = {k: v for k, v in checks.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{label}: checks over {tol:g}: {bad}")
    return dict(serve_launches=launches, train_launches=tf, train_bwd_launches=tb,
                checks=checks, limit=tol, losses=[float(x) for x in losses],
                step_ms=step_ms, latency_ms=latency)


def wide_head_phase(wrappers, device="cuda", seed=0):
    """Attention past head dim 368: the routes' kernel checks
    (hd_stream_kernel_phase); P12-sw at one head (hd 720) served and
    trained with f32 attention operands ("hd_stream") and with
    compute_dtype='bfloat16' ("tc_cluster") (wide_head_model); the bf16
    route's times at the model's shape (B=128, T=215, hd 720) in turns with
    the previous design, the f32 route's there, and flash_mha's at T=2048,
    hd 720 (B=8); and the public op flash_mha at hd 720 and 1024 through
    autograd in bf16 and f32, the counts set to 0 before and read after
    (its launches in the record)."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa

    kernels = hd_stream_kernel_phase(device, seed)
    models = {"float32": wide_head_model(wrappers, {"attention_score_dtype": "float32"},
                                         "P12-sw-1h f32", device, seed),
              "bfloat16": wide_head_model(wrappers, MIXED, "P12-sw-1h bf16", device, seed,
                                          check=check_tc_cluster)}
    torch.cuda.empty_cache()
    timing = {"packed": hd_stream_timing("P12-sw-1h", "packed", 128, 215, 720, "bfloat16",
                                         device, seed),
              "packed_f32": hd_stream_timing("P12-sw-1h", "packed", 128, 215, 720,
                                             "float32", device, seed),
              "split": hd_stream_timing("hd720-2048", "split", 8, 2048, 720, "bfloat16",
                                        device, seed, reps=3)}
    # the public op through autograd at hd 720 and 1024, T=600, B=8, 2 heads
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    reset_counts(wrappers)
    for cd in ("bfloat16", None):
        for D in HD_STREAM_SPLIT:
            q, k, v = (torch.randn((8, 600, 2 * D), generator=gen, device=device)
                       .reshape(8, 600, 2, D).transpose(1, 2).requires_grad_()
                       for _ in range(3))
            lengths = ragged_lengths(gen, 8, 600, device)
            o = fa.flash_mha(q, k, v, lengths, SEED, 0.2, cd)
            o.backward(torch.ones_like(o))
            if not all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v)):
                raise AssertionError(f"flash_mha at hd {D} ({cd}): a gradient is not finite")
    op = {a: getattr(fa.flash_mha, a) for a in (
        "launches", "bwd_launches", "tc_cluster_launches", "tc_cluster_bwd_launches",
        "hd_stream_launches", "hd_stream_bwd_launches")}
    if op != {"launches": 4, "bwd_launches": 4, "tc_cluster_launches": 2,
              "tc_cluster_bwd_launches": 2, "hd_stream_launches": 2,
              "hd_stream_bwd_launches": 2}:
        raise AssertionError(f"flash_mha past hd 368 through autograd: launches {op}")
    print(f"[wide head] flash_mha through autograd at hd 720 and 1024, bf16 and f32: "
          f"launches {op}", flush=True)
    return dict(kernels=kernels["runs"], occupancy=kernels["occupancy"], models=models,
                timing=timing, op_launches=op)


# ------------------------------------------------------- past 65535 samples
BIG_B = 70000


def big_batch_phase(wrappers, device="cuda", seed=0):
    """Every kernel row at B=70000 samples (two launches a call, the second
    at sample origin 65535), dropout 0.2 where the op has it: flash_mha_packed
    (T=16, 2 heads of 32) and flash_mha (T=16, 2 heads of 32; and 2
    samples of 70000 heads), the fused layer at PAM's width (d=84, ffn=136,
    2 heads) and T=16, f32 and bf16, and spmm_segment_softmax (both
    gathers) and sddmm on P12's sensor graph (N=36, E=1296, D=8), forward
    and backward. Each call must launch twice forward and twice backward
    (the counts set to 0 before it), its second launch's rows must equal,
    bit for bit, those of a call over the last 4465 samples alone at their
    origin, and it is held against the plain versions (so the masks past
    sample 65535 are compared): the attention's outputs and gradients and
    the fused layer's out, attn and dx sample by sample at SAMPLE_TOL, in
    f32 over every sample, in bf16 over the 128 samples at each end of
    either launch (SAMPLE_TOL is set from B=128 readings; the largest over
    all 70000 and the count past it are printed), lse at TOL, the fused
    weight gradients at TOL relative to max(1, |plain|), the graph kernels
    at GRAPH_TOL relative."""
    import torch
    from raindrop_tpu_torch.ops import flash_attention as fa
    from raindrop_tpu_torch.ops import fused_encoder as fe
    from raindrop_tpu_torch.ops import sparse as sp
    from raindrop_tpu_torch.nn.transformer import _layer_init

    gen = torch.Generator(device=device).manual_seed(seed)
    B, T, S = BIG_B, 16, fa.MAX_BATCH
    lengths = ragged_lengths(gen, B, T, device)
    lengths[S], lengths[S + 1] = 0, T
    ends = torch.cat([torch.arange(0, 128), torch.arange(S - 128, S + 128),
                      torch.arange(B - 128, B)]).to(device)
    out = {}

    def rel(a, b):
        return max_err(a, b) / max(1.0, float(b.abs().max()))

    def per_sample(a, b, ls, dtype):
        """sample_err over every sample (f32) or the launches' ends (bf16),
        and (the largest over all, how many samples pass SAMPLE_TOL)."""
        errs = ((a - b).abs().reshape(a.shape[0], -1).amax(1)
                / b.abs().reshape(b.shape[0], -1).amax(1).clamp(min=1e-30))
        tail = (float(errs[ls > 1].max()), int((errs[ls > 1] > SAMPLE_TOL[dtype]).sum()))
        if dtype == "float32" or a.shape[0] < B:
            return sample_err(a, b, ls), tail
        return sample_err(a[ends], b[ends], ls[ends]), tail

    def held(name, n, errs, tails, same):
        """errs: {what: (error, limit)}; n the call's (forward, backward)
        launches, two each; `same` the second launch's rows bit-equal to a
        call over them alone."""
        out[name] = dict(errs={k: e for k, (e, _) in errs.items()}, launches=n,
                         all_samples=tails, second_launch_bit_equal=same)
        print(f"[big batch] {name}: launches {n}; the second launch's rows bit-equal "
              f"alone: {same}; " + ", ".join(
                  f"{k} {e:.3e} (limit {lim:g})" for k, (e, lim) in errs.items())
              + (f"; over all samples (largest, count past SAMPLE_TOL) {tails}"
                 if tails else ""), flush=True)
        if n != (2, 2) or not same or any(not e <= lim for e, lim in errs.values()):
            raise AssertionError(f"{name} at B={B}: launches {n}, alone {same}, "
                                 f"errors {errs}")

    for dtype in ("float32", "bfloat16"):
        cd = None if dtype == "float32" else dtype
        od = fa.operand_dtype(cd)
        st, tl = SAMPLE_TOL[dtype], TOL[dtype]
        q, k, v, g = (torch.randn((B, T, 64), generator=gen, device=device) for _ in range(4))
        reset_counts(wrappers)
        o, lse = fa._packed_fwd(q, k, v, lengths, SEED, 0.2, cd, 2)
        grads = fa._packed_bwd_cuda(q, k, v, lengths, SEED, 0.2, 2, od, o, lse, g)
        n = (fa.flash_mha_packed.launches, fa.flash_mha_packed.bwd_launches)
        tail_args = [x[S:].contiguous() for x in (q, k, v, lengths)]
        o2, lse2 = fa._packed_fwd_cuda(*tail_args, SEED, 0.2, 2, od, origin=(S, 0, 2))
        g2 = fa._packed_bwd_cuda(*tail_args, SEED, 0.2, 2, od, o2, lse2, g[S:].contiguous(),
                                 origin=(S, 0, 2))
        same = (torch.equal(o2, o[S:]) and torch.equal(lse2, lse[S:])
                and all(torch.equal(a, b[S:]) for a, b in zip(g2, grads)))
        po, plse = fa._packed_fwd_plain(q, k, v, lengths, 2, od, SEED, 0.2)
        want = fa._packed_bwd_plain(q, k, v, lengths, SEED, 0.2, 2, od, o, lse, g)
        res = {n_: per_sample(a, b, lengths, dtype)
               for n_, a, b in zip(("o", "dq", "dk", "dv"), (o, *grads), (po, *want))}
        held(f"flash_mha_packed {dtype}", n,
             {**{k_: (e, st) for k_, (e, _) in res.items()}, "lse": (max_err(lse, plse), tl)},
             {k_: t for k_, (_, t) in res.items()}, same)
        del q, k, v, g, o, lse, grads, po, plse, want, o2, lse2, g2, tail_args

        for Bs, H in ((B, 2), (2, B)):
            ls = lengths if Bs == B else torch.tensor([T, 5], dtype=torch.int32,
                                                      device=device)
            q, k, v = (torch.randn((Bs, T, H * 32), generator=gen, device=device)
                       .reshape(Bs, T, H, 32).transpose(1, 2) for _ in range(3))
            g = torch.randn((Bs, H, T, 32), generator=gen, device=device)
            reset_counts(wrappers)
            o, lse = fa._flash_fwd(q, k, v, ls, SEED, 0.2, cd)
            grads = fa._flash_bwd_cuda(q, k, v, ls, SEED, 0.2, od, o, lse, g)
            n = (fa.flash_mha.launches, fa.flash_mha.bwd_launches)
            if Bs == B:
                sl = [x[S:] for x in (q, k, v)]
                origin = (S, 0, H)
            else:
                sl = [x[:, S:] for x in (q, k, v)]
                origin = (0, S, H)
            o2, lse2 = fa._flash_fwd_cuda(*sl, ls[S:] if Bs == B else ls, SEED, 0.2, od,
                                          origin=origin)
            rows = (slice(S, None),) if Bs == B else (slice(None), slice(S, None))
            g2 = fa._flash_bwd_cuda(*sl, ls[S:] if Bs == B else ls, SEED, 0.2, od, o2, lse2,
                                    g[rows], origin=origin)
            same = (torch.equal(o2, o[rows]) and torch.equal(lse2, lse[rows])
                    and all(torch.equal(a, b[rows]) for a, b in zip(g2, grads)))
            po, plse = fa._flash_fwd_plain(q, k, v, ls, od, SEED, 0.2)
            want = fa._flash_bwd_plain(q, k, v, ls, SEED, 0.2, od, o, lse, g)
            res = {n_: per_sample(a, b, ls, dtype)
                   for n_, a, b in zip(("o", "dq", "dk", "dv"), (o, *grads), (po, *want))}
            held(f"flash_mha B={Bs} H={H} {dtype}", n,
                 {**{k_: (e, st) for k_, (e, _) in res.items()},
                  "lse": (max_err(lse, plse), tl)},
                 {k_: t for k_, (_, t) in res.items()} if Bs == B else None, same)
            del q, k, v, g, o, lse, grads, po, plse, want, o2, lse2, g2, sl

        d, ffn = 84, 136
        p = _layer_init(gen, d, ffn, device)
        ws = fe._flatten(p)
        x, g = (torch.randn((B, T, d), generator=gen, device=device) for _ in range(2))
        reset_counts(wrappers)
        fo, attn, flse = fe._fused_fwd_cuda(ws, x, lengths, SEED, 0.2, 2, od)
        scratch = {}
        dx, dws = fe._fused_bwd_cuda(ws, x, lengths, SEED, 0.2, 2, od, attn, flse, g,
                                     scratch_out=scratch)
        n = (fe.fused_encoder_layer.launches, fe.fused_encoder_layer.bwd_launches)
        fo2, attn2, flse2 = fe._fused_fwd_cuda(ws, x[S:], lengths[S:], SEED, 0.2, 2, od,
                                               origin=(S, 0, 2))
        dx2, _ = fe._fused_bwd_cuda(ws, x[S:], lengths[S:], SEED, 0.2, 2, od, attn2, flse2,
                                    g[S:], origin=(S, 0, 2))
        same = (torch.equal(fo2, fo[S:]) and torch.equal(attn2, attn[S:])
                and torch.equal(flse2, flse[S:]) and torch.equal(dx2, dx[S:]))
        pout, pattn, plse = fe._fused_fwd_plain(p, x, lengths, 2, od, SEED, 0.2)
        # the plain backward takes the kernel's relu branches (fused_bwd_phase)
        pdx, pdws = fe._fused_bwd_plain(p, x, lengths, SEED, 0.2, 2, od, attn, flse, g,
                                        relu_on=scratch["f"].reshape(B, T, ffn) > 0)
        res = {n_: per_sample(a, b, lengths, dtype)
               for n_, a, b in (("out", fo, pout), ("attn", attn, pattn), ("dx", dx, pdx))}
        held(f"fused_encoder_layer {dtype}", n,
             {**{k_: (e, st) for k_, (e, _) in res.items()},
              "lse": (max_err(flse, plse), tl),
              "weights": (max(rel(a, b) for a, b in zip(dws, pdws)), tl)},
             {k_: t for k_, (_, t) in res.items()}, same)
        del x, g, fo, attn, flse, dx, dws, pout, pattn, plse, pdx, pdws, scratch
        del fo2, attn2, flse2, dx2
        torch.cuda.empty_cache()

    N, D = 36, 8
    src = torch.arange(N, device=device).repeat_interleave(N)
    dst = torch.arange(N, device=device).repeat(N)
    x, k_, g_out = (torch.randn((B, N, D), generator=gen, device=device) for _ in range(3))
    gamma, g_w = (torch.randn((B, N * N), generator=gen, device=device) for _ in range(2))
    topo = sp.topology(src, dst, N)
    for gather_target in (True, False):
        reset_counts(wrappers)
        o, w = sp._spmm_fwd_cuda(x, gamma, topo, gather_target)
        dx, dgamma = sp._spmm_bwd_cuda(g_out, g_w, x, w, topo, gather_target)
        n = (sp.spmm_segment_softmax.launches, sp.spmm_segment_softmax.bwd_launches)
        o2, w2 = sp._spmm_fwd_cuda(x[S:], gamma[S:], topo, gather_target)
        dx2, dg2 = sp._spmm_bwd_cuda(g_out[S:], g_w[S:], x[S:], w2, topo, gather_target)
        same = all(torch.equal(a, b[S:]) for a, b in ((o2, o), (w2, w), (dx2, dx),
                                                      (dg2, dgamma)))
        po, pw = sp._spmm_fwd_plain(x, gamma, src, dst, N, gather_target)
        pdx, pdg = sp._spmm_bwd_plain(g_out, g_w, x, w, src, dst, N, gather_target)
        held(f"spmm_segment_softmax gather_target={gather_target}", n,
             {n_: (rel(a, b), GRAPH_TOL) for n_, a, b in (
                 ("out", o, po), ("w", w, pw), ("dx", dx, pdx), ("dgamma", dgamma, pdg))},
             None, same)
    reset_counts(wrappers)
    alpha = sp._sddmm_fwd_cuda(x, k_, topo, D ** -0.5)
    dq, dk = sp._sddmm_bwd_cuda(gamma, x, k_, topo, D ** -0.5)
    n = (sp.sddmm.launches, sp.sddmm.bwd_launches)
    alpha2 = sp._sddmm_fwd_cuda(x[S:], k_[S:], topo, D ** -0.5)
    dq2, dk2 = sp._sddmm_bwd_cuda(gamma[S:], x[S:], k_[S:], topo, D ** -0.5)
    same = all(torch.equal(a, b[S:]) for a, b in ((alpha2, alpha), (dq2, dq), (dk2, dk)))
    pa = sp._sddmm_fwd_plain(x, k_, src, dst, D ** -0.5)
    pdq, pdk = sp._sddmm_bwd_plain(gamma, x, k_, src, dst, D ** -0.5)
    held("sddmm", n, {n_: (rel(a, b), GRAPH_TOL) for n_, a, b in (
        ("alpha", alpha, pa), ("dq", dq, pdq), ("dk", dk, pdk))}, None, same)
    return out


# ------------------------------------------- the fused layer past its tiles
# P12-sw at a 600-step window (d 720 = 36 x (4 + 16), ffn 288, 2 layers): the
# fused rung at 2 heads (hd 360) and at 1 (hd 720), past the widths the
# tile-resident routes take: the "stream" route
FUSED_WIDE = {"sensor_wise_mask": True, "max_len": 600}
FUSED_WIDE_HEADS = ((2, "P12-sw"), (1, "P12-sw-1h"))


def check_fused_stream(what, *counts):
    """Every fused_encoder_layer launch in these counts took the "stream"
    route."""
    for c in counts:
        n = c["fused_encoder_layer"]
        if n <= 0 or c["fused_encoder_layer.stream"] != n:
            raise AssertionError(f"{what}: fused_encoder_layer launches off the stream "
                                 f"route: {c}")


def check_fused_tc_cluster(what, *counts):
    """check_fused_stream, and every launch's attention on "tc_cluster"."""
    check_fused_stream(what, *counts)
    for c in counts:
        if c["fused_encoder_layer.tc_cluster"] != c["fused_encoder_layer"]:
            raise AssertionError(f"{what}: fused_encoder_layer attention off the "
                                 f"tc_cluster route: {c}")


def fused_wide_phase(wrappers, device="cuda", seed=0, seed_cli=0):
    """The fused layer at P12-sw's width on a 600-step window, 2 heads and
    1, f32 and bf16 operands (B=128): the kernels against their plain
    versions (fused_phase: the forward, timed as served; fused_bwd_phase:
    forward and backward at dropout 0.2, timed as trained, with
    nn.TransformerEncoderLayer's times beside); the model served at buckets
    1-128 and trained 3 steps at B=128 with f32 attention operands and with
    compute_dtype='bfloat16' (wide_head_model, every fused launch on the
    "stream" route, at one head in bf16 its attention on "tc_cluster");
    the CLI for one epoch of one split on 256 synthetic samples, its
    launches counted there."""
    layers = {}
    for H, label in FUSED_WIDE_HEADS:
        for dtype in ("float32", "bfloat16"):
            layers[(label, dtype, "fwd")] = fused_phase(label, 128, 600, 720, 288, H, dtype,
                                                        device, seed)
            layers[(label, dtype, "bwd")] = fused_bwd_phase(label, 128, 600, 720, 288, H,
                                                            dtype, 0.2, device, seed)
    for (label, dtype, _), r in layers.items():
        bf = dtype == "bfloat16"
        if r["route"] != "stream" or r["attn_route"] != (
                ("tc_cluster" if bf else "hd_stream") if label.endswith("1h") else
                "tc_wide" if bf else "scalar"):
            raise AssertionError(f"fused layer {label} {dtype} took the {r['route']}/"
                                 f"{r['attn_route']} routes")
    models = {}
    for H, label in FUSED_WIDE_HEADS:
        base = {**FUSED_WIDE, "nhead": H}
        models[f"{label} f32"] = wide_head_model(
            wrappers, {"attention_score_dtype": "float32"}, f"{label} f32", device, seed,
            base=base, check=check_fused_stream)
        models[f"{label} bf16"] = wide_head_model(
            wrappers, MIXED, f"{label} bf16", device, seed, base=base,
            check=check_fused_tc_cluster if H == 1 else check_fused_stream)
    argv = ["--dataset", "P12", "--sensor-wise-mask", "true", "--max-len", "600",
            "--synthetic", "256", "--epochs", "1", "--n-splits", "1", "--measure-mfu",
            "true", "--seed", str(seed_cli + 1)]
    summary, records, fwd, bwd, took = run_cli(wrappers, argv, "P12-sw T=600")
    check_cli("P12-sw T=600", summary, records, "missing_0.0", 1)
    check_fused_stream("P12-sw T=600 (CLI)", fwd, bwd)
    print(f"[fused wide] the CLI in {took:.1f} s; launches {fwd}, backward {bwd}",
          flush=True)
    return dict(layers=[{**r, "way": k[2]} for k, r in layers.items()], models=models,
                cli=dict(seconds=took, summary=summary, records=records, launches=fwd,
                         bwd_launches=bwd))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number measured to this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the CLI phases' dataset files and runs")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from raindrop_tpu_torch.kernels import build
        from raindrop_tpu_torch.ops.flash_attention import flash_mha, flash_mha_packed
        from raindrop_tpu_torch.ops.fused_encoder import fused_encoder_layer
        from raindrop_tpu_torch.ops.sparse import (
            sddmm, spmm_segment_softmax, topology)
    except ImportError as e:
        print(f"chip_smoke: the raindrop_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("set-up: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False", flush=True)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s for {list(build.SOURCES)}", flush=True)
    phase_s = {}
    # the data layer's C++ host runtime: its g++ build and its seven
    # functions against numpy, then the gather and normalization times
    with phase(phase_s, "host runtime"):
        host = host_runtime_phase(args.seed)
    with phase(phase_s, "sass"):
        sass = sass_phase()

    grid = [(dt, rate) for dt in ("float32", "bfloat16") for rate in (0.0, 0.2)]
    with phase(phase_s, "packed and fused-layer kernels"):
        flash = [flash_phase("P12", 128, 215, 160, 2, dt) for dt in ("float32", "bfloat16")]
        flash += [flash_phase("eICU", 128, 300, 72, 2, dt) for dt in ("float32", "bfloat16")]
        fused = [fused_phase("PAM", 128, 600, 84, 136, 2, dt)
                 for dt in ("float32", "bfloat16")]
        flash_bwd = [flash_bwd_phase("P12", 128, 215, 160, 2, dt, rate) for dt, rate in grid]
        flash_bwd += [flash_bwd_phase("eICU", 128, 300, 72, 2, dt, rate) for dt, rate in grid]
        edges = [flash_edge_phase(hd, T, rate)
                 for hd in (3, 8, 13, 42, 84, 128, 129, 140, 144, 160, 170, 192, 193,
                            256, 360, 368)
                 for T in (64, 65, 1024) for rate in (0.0, 0.2)]
        fused_bwd = [fused_bwd_phase("PAM", 128, 600, 84, 136, 2, dt, rate)
                     for dt, rate in grid]
    torch.cuda.empty_cache()
    # the fused layer at an edge shape (T and a length ending inside a
    # 64-row tile, lengths 0 and 1) at PAM's width and its sensor-wise one
    with phase(phase_s, "fused-layer edge shapes"):
        fused_edges = [fused_edge_phase(label, d, 136, 2, dt, rate)
                       for label, d in (("PAM", 84), ("PAM-sw", 340))
                       for dt, rate in grid]
    # the sensor-wise widths (d_inp * (d_ob + d_pe), 2 heads): P12 hd 360 on
    # the two-warpgroup tensor cores in bf16 (scalar in f32), eICU hd 140 on
    # the one-warpgroup tensor cores in bf16, PAM's fused layer at d=340,
    # hd 170
    with phase(phase_s, "packed and fused-layer kernels, sensor-wise widths"):
        sw_shapes = (("P12-sw", 215, 720), ("eICU-sw", 300, 280))
        sw_flash = [flash_phase(label, 128, T, d, 2, dt) for label, T, d in sw_shapes
                    for dt in ("float32", "bfloat16")]
        sw_flash_bwd = [flash_bwd_phase(label, 128, T, d, 2, dt, rate)
                        for label, T, d in sw_shapes for dt, rate in grid]
        sw_fused = [fused_phase("PAM-sw", 128, 600, 340, 136, 2, dt)
                    for dt in ("float32", "bfloat16")]
        sw_fused_bwd = [fused_bwd_phase("PAM-sw", 128, 600, 340, 136, 2, dt, rate)
                        for dt, rate in grid]
        sw_wide = [fused_wide_attn_phase("PAM-sw", 128, 600, 340, 136, 2, rate)
                   for rate in (0.0, 0.2)]
    for r in sw_flash:
        want = ("scalar" if r["dtype"] != "bfloat16" else
                "tc" if r["label"] == "eICU-sw" else "tc_wide")
        if r["route"] != want:
            raise AssertionError(f"{r['label']} {r['dtype']} took the {r['route']} "
                                 f"route, expected {want}")
    # the fused layer: bf16 row products on the tensor cores at both widths,
    # the attention too, on one warpgroup at PAM's hd 42 and on two at
    # PAM-sw's 170; f32 scalar
    for r in (*fused, *fused_bwd, *sw_fused, *sw_fused_bwd, *fused_edges):
        bf = r["dtype"] == "bfloat16"
        want = ("tc" if bf else "scalar",
                "scalar" if not bf else "tc_wide" if r["label"].endswith("-sw") else "tc")
        if (r["route"], r["attn_route"]) != want:
            raise AssertionError(f"fused layer {r['label']} {r['dtype']} took the "
                                 f"{r['route']}/{r['attn_route']} routes, expected {want}")
    torch.cuda.empty_cache()
    with phase(phase_s, "graph kernels"):
        spmm_runs = [spmm_phase(label, 128, D, gt)
                     for label, D in (("P12", 860), ("PAM", 2400), ("kNN", 240))
                     for gt in (True, False)]
        spmm_fwd, spmm_bwd = ([r[i] for r in spmm_runs] for i in (0, 1))
        # B=2, N=36, D=430: what ob_propagate_selfattention hands the kernel
        # (its 2 heads on the batch axis); B=1, its one call per head before
        # the heads were folded; the others are batch-scale shapes
        sddmm_runs = [sddmm_phase("P12", 2, 430), sddmm_phase("P12", 1, 430)]
        sddmm_runs += [sddmm_phase(label, 128, D) for label in ("P12", "PAM", "kNN")
                       for D in (860, 120)]
        sddmm_fwd, sddmm_bwd = ([r[i] for r in sddmm_runs] for i in (0, 1))
        graph_edges = graph_edge_phase()
    torch.cuda.empty_cache()

    wrappers = (flash_mha_packed, fused_encoder_layer, spmm_segment_softmax, sddmm,
                flash_mha)
    with phase(phase_s, "serve and train PAM, P12"):
        pam_launches, pam = serve_phase("PAM", [fused_encoder_layer], wrappers)
        p12_launches, p12 = serve_phase("P12", [flash_mha_packed], wrappers)
        pam_tf, pam_tb, pam_train = train_phase("PAM", [fused_encoder_layer], wrappers)
        p12_tf, p12_tb, p12_train = train_phase("P12", [flash_mha_packed], wrappers)
    check_tc("P12 serving and training", p12_launches, p12_tf, p12_tb)
    check_fused_tc("PAM serving and training", pam_launches, pam_tf, pam_tb)
    torch.cuda.empty_cache()
    with phase(phase_s, "mixed precision PAM, P12"):
        mixed = {"PAM": mixed_phase("PAM", [fused_encoder_layer], wrappers,
                                    check_fused_tc),
                 "P12": mixed_phase("P12", [flash_mha_packed], wrappers, check_tc)}
    torch.cuda.empty_cache()

    # sensor_wise_mask on every preset: P19 stays on the dense rung (T=60),
    # P12 and eICU take flash_mha_packed (tensor cores on two warpgroups at
    # hd 360, on one at hd 140), PAM the fused layer at d=340
    sw = {"sensor_wise_mask": True}
    with phase(phase_s, "serve and train, sensor-wise"):
        sw_serve = {
            name: serve_phase(name, fns, wrappers, cfg_overrides=sw,
                              batch_limit=BATCH_LIMIT_SW)
            for name, fns in (("P19", []), ("P12", [flash_mha_packed]),
                              ("eICU", [flash_mha_packed]),
                              ("PAM", [fused_encoder_layer]))}
        if any(sw_serve["P19"][0].values()):
            raise AssertionError(f"P19-sw serving launched a kernel: {sw_serve['P19'][0]}")
        sw_train = {
            name: train_phase(name, [fn], wrappers, cfg_overrides=sw, fit_lr=FIT_LR_SW)
            for name, fn in (("P12", flash_mha_packed), ("eICU", flash_mha_packed),
                             ("PAM", fused_encoder_layer))}
    check_tc_wide("P12-sw serving and training", sw_serve["P12"][0],
                  *sw_train["P12"][:2])
    check_tc("eICU-sw serving and training", sw_serve["eICU"][0], *sw_train["eICU"][:2])
    check_fused_tc_wide("PAM-sw serving and training", sw_serve["PAM"][0],
                        *sw_train["PAM"][:2])
    torch.cuda.empty_cache()

    # the sparse-graph path: P12 with prop_backend='pallas', held against
    # the plain path with dense attention and dense propagation
    graph = {"prop_backend": "pallas"}
    graph_fns = [flash_mha_packed, spmm_segment_softmax]
    builds = topology.builds
    with phase(phase_s, "graph paths"):
        g12_launches, g12 = serve_phase("P12", graph_fns, wrappers, cfg_overrides=graph,
                                        plain_overrides=PLAIN_ALL)
        check_tc("P12 pallas serving", g12_launches)
        if g12_launches["spmm_segment_softmax"] != g12_launches["flash_mha_packed"]:
            raise AssertionError(f"P12 pallas: two SpMM launches per forward expected, "
                                 f"as many as flash launches: {g12_launches}")
        check_graph_row("P12 pallas serving", g12_launches)
        adj = global_adj_phase(wrappers)
        g12_tf, g12_tb, g12_train = train_phase("P12", graph_fns, wrappers,
                                                cfg_overrides=graph,
                                                plain_overrides=PLAIN_ALL)
        check_tc("P12 pallas training", g12_tf, g12_tb)
        check_graph_row("P12 pallas training", g12_tf, g12_tb)
        # every server and trainer above shares the model's edge tensors: the
        # graph was sorted for the kernels once, when the first was built
        builds = topology.builds - builds
        print(f"[graph] the model's sensor graph was sorted {builds} time(s) over "
              f"the P12 pallas serving, global_adj and training phases", flush=True)
        if builds != 1:
            raise AssertionError(f"the topology cache missed: {builds} builds")
        sd_f, sd_b, selfatt = selfattention_phase(wrappers)
    torch.cuda.empty_cache()

    # long sequences: the split-head flash_mha at the one-program regime's
    # shape (T=600) and the streaming regime's (T=2048), then the paths
    with phase(phase_s, "use_beta P12"):
        beta_launches, beta_serve = serve_phase(
            "P12", [flash_mha_packed], wrappers, cfg_overrides=BETA,
            plain_overrides=PLAIN_ALL)
        beta_tf, beta_tb, beta_train = train_phase(
            "P12", [flash_mha_packed], wrappers, cfg_overrides=BETA,
            plain_overrides=PLAIN_ALL)
        beta_graph = beta_graph_phase(wrappers)
    check_tc("P12 use_beta serving and training", beta_launches, beta_tf, beta_tb)
    check_no_graph_kernel("P12 use_beta serving and training", beta_launches,
                          beta_tf, beta_tb)
    with phase(phase_s, "bf16 storage P12"):
        storage = bf16_storage_phase(wrappers)
    torch.cuda.empty_cache()

    # the experiment CLI (python -m raindrop_tpu_torch.run): P12 from
    # dataset files, PAM synthetic through the streaming pipeline; the
    # streaming pipeline and the MFU telemetry bit-equal to the resident
    # run without it; one step's FLOPs with the kernels against the plain count
    with phase(phase_s, "CLI P12 files"):
        cli_files = cli_files_phase(wrappers, args.seed)
    torch.cuda.empty_cache()
    with phase(phase_s, "CLI PAM streaming"):
        cli_stream = cli_stream_phase(wrappers, args.seed)
    torch.cuda.empty_cache()
    with phase(phase_s, "streaming and measure_mfu bit-equal"):
        streaming = streaming_phase(seed=args.seed)
    torch.cuda.empty_cache()
    with phase(phase_s, "step FLOPs and MFU"):
        mfu_runs = mfu_phase(wrappers, card, seed=args.seed)
    torch.cuda.empty_cache()
    # the baseline families (baselines/adapters.py): the ten at P12 served
    # and trained, the four with an attention encoder on the packed pair
    with phase(phase_s, "baselines"):
        baselines = baselines_phase(wrappers, card, seed=args.seed)
    torch.cuda.empty_cache()
    # reference checkpoints through the migrate CLI, served and trained; raw
    # PhysioNet text through preprocess into the experiment CLI
    with phase(phase_s, "migrate and serve"):
        migrated = migrate_phase(wrappers, seed=args.seed)
    torch.cuda.empty_cache()
    with phase(phase_s, "raw PhysioNet to training"):
        raw_text = raw_physionet_phase(wrappers, seed=args.seed)
    torch.cuda.empty_cache()
    import_launches = {
        "flash_mha_packed": {"P12 served": migrated["P12"]["launches"]["flash_mha_packed"],
                             "P12 steps": migrated["P12"]["train_launches"]["flash_mha_packed"],
                             "raw text CLI": raw_text["launches"]["flash_mha_packed"]},
        "flash_mha_packed_bwd": {
            "P12 steps": migrated["P12"]["train_bwd_launches"]["flash_mha_packed"],
            "raw text CLI": raw_text["bwd_launches"]["flash_mha_packed"]},
        "fused_encoder_layer": {
            "PAM served": migrated["PAM"]["launches"]["fused_encoder_layer.tc"]}}
    print(f"[slice 16] migrate and serve {phase_s['migrate and serve']:.1f} s, raw "
          f"PhysioNet to training {phase_s['raw PhysioNet to training']:.1f} s; launches "
          f"{import_launches}; largest errors: served against the plain attention "
          f"{max(migrated[d]['plain_err'] for d in ('P12', 'PAM')):.3e} (limit "
          f"{TOL['bfloat16']}), against the seeded model 0 (bit-equal), mTAND card "
          f"against CPU {migrated['mtand']['card_vs_cpu']:.3e} (limit 1e-5)", flush=True)
    with phase(phase_s, "flash_mha kernels"):
        mha_runs = [flash_mha_phase(label, 128, 2, T, 42, dt, rate)
                    for label, T in (("PAM-600", 600), ("PAM-2048", 2048))
                    for dt, rate in grid]
        mha_fwd, mha_bwd = ([r[i] for r in mha_runs] for i in (0, 1))
        op_f, op_b, op_checks = flash_mha_op_phase(wrappers)
    torch.cuda.empty_cache()
    with phase(phase_s, "serve PAM-2048"):
        long_launches, long_serve = serve_phase("PAM", [flash_mha], wrappers,
                                                cfg_overrides=LONG)
    check_two_a_forward("PAM-2048", long_launches, long_serve)
    check_split_route("PAM-2048 serving", "tc", long_launches)
    torch.cuda.empty_cache()
    with phase(phase_s, "serve PAM-2048 bf16"):
        long_mixed = mixed_long_phase(wrappers, long_serve)
    torch.cuda.empty_cache()
    with phase(phase_s, "protocol PAM-2048"):
        # two epochs, the second resumed (three before PAM-sw-2048's run
        # joined the script: the 7 GB checkpoint files take most of it)
        long_tf, long_tb, long_train = protocol_phase(wrappers, epochs=2, route="tc")
    torch.cuda.empty_cache()
    with phase(phase_s, "run_splits PAM"):
        splits = run_splits_phase()
    torch.cuda.empty_cache()

    # flash_mha past hd 128: PAM-sw's head (170, the Narrow geometry at 48
    # columns a thread) and 360 (Wide) on a 2048-step window, the edge
    # shapes of both geometries, then PAM-sw at max_len 2048 served,
    # trained and run through train_split
    with phase(phase_s, "flash_mha kernels past hd 128"):
        sw_mha_runs = [flash_mha_phase(label, 128, 2, 2048, D, dt, rate)
                       for label, D in (("PAM-sw-2048", 170), ("hd360-2048", 360))
                       for dt, rate in grid]
        sw_mha_fwd, sw_mha_bwd = ([r[i] for r in sw_mha_runs] for i in (0, 1))
        mha_edges = [flash_mha_edge_phase(hd, T, rate)
                     for hd in (8, 13, 42, 128, 144, 129, 170, 192, 193, 200, 360, 368)
                     for T in (65, 1025, 2048) for rate in (0.0, 0.2)]
    torch.cuda.empty_cache()
    sw_long = {**sw, **LONG}
    with phase(phase_s, "serve PAM-sw-2048"):
        sw_long_launches, sw_long_serve = serve_phase(
            "PAM", [flash_mha], wrappers, cfg_overrides=sw_long)
    check_two_a_forward("PAM-sw-2048", sw_long_launches, sw_long_serve)
    check_split_route("PAM-sw-2048 serving", "tc_wide", sw_long_launches)
    torch.cuda.empty_cache()
    with phase(phase_s, "train PAM-sw-2048"):
        sw_long_tf, sw_long_tb, sw_long_train = train_phase(
            "PAM", [flash_mha], wrappers, cfg_overrides=sw_long, fit_lr=FIT_LR_SW)
    check_split_route("PAM-sw-2048 training", "tc_wide", sw_long_tf, sw_long_tb)
    torch.cuda.empty_cache()
    with phase(phase_s, "protocol PAM-sw-2048"):
        # two epochs, the second resumed, as PAM-2048's (a cut: at three the
        # whole script ran past 1080 s on a slower card host; the 7 GB
        # checkpoint files take most of each epoch)
        sw_long_pf, sw_long_pb, sw_long_protocol = protocol_phase(
            wrappers, overrides=sw_long, label="PAM-sw-2048", epochs=2,
            route="tc_wide")
    torch.cuda.empty_cache()

    # the mesh: rows 1-4 at shard origins, the NCCL world-size-1
    # mesh (this slice's path: its launch counts), two gloo ranks sharing
    # the card, the CLI through torchrun
    with phase(phase_s, "shard origins"):
        origins = shard_origin_phase()
    torch.cuda.empty_cache()
    with phase(phase_s, "mesh NCCL world size 1"):
        mesh_counts, mesh_runs = mesh_phase(wrappers)
    torch.cuda.empty_cache()
    with phase(phase_s, "two gloo ranks"):
        two_ranks = two_rank_phase()
    torch.cuda.empty_cache()
    with phase(phase_s, "model-axis routes, two gloo ranks"):
        scale_out = scale_out_phase()
    torch.cuda.empty_cache()
    with phase(phase_s, "CLI torchrun"):
        torchrun_summary, torchrun_s = torchrun_cli_phase(args.seed)
    torch.cuda.empty_cache()

    # attention past head dim 368 (P12-sw at one head, the public op) and
    # every kernel row at 70000 samples
    with phase(phase_s, "attention past hd 368"):
        wide = wide_head_phase(wrappers)
    torch.cuda.empty_cache()
    with phase(phase_s, "calls past 65535 samples"):
        big = big_batch_phase(wrappers)
    torch.cuda.empty_cache()
    # the fused layer past its tiles: P12-sw at T=600, 2 heads and 1, on
    # the "stream" route
    with phase(phase_s, "fused layer P12-sw T=600"):
        fused_wide = fused_wide_phase(wrappers, seed_cli=args.seed)
    torch.cuda.empty_cache()
    print(f"[fused wide] the phase took {phase_s['fused layer P12-sw T=600']:.1f} s",
          flush=True)
    print(f"[slice 19] host runtime {phase_s['host runtime']:.1f} s, attention past hd "
          f"368 {phase_s['attention past hd 368']:.1f} s, calls past 65535 samples "
          f"{phase_s['calls past 65535 samples']:.1f} s", flush=True)
    print(f"[mesh phases] shard origins {phase_s['shard origins']:.1f} s, mesh "
          f"{phase_s['mesh NCCL world size 1']:.1f} s (of it the routes at world size 1), "
          f"two gloo ranks {phase_s['two gloo ranks']:.1f} s, the routes on two gloo "
          f"ranks {phase_s['model-axis routes, two gloo ranks']:.1f} s, CLI torchrun "
          f"{phase_s['CLI torchrun']:.1f} s", flush=True)

    # the kernels' record at the main paths' shapes and operand dtype
    # (attention_score_dtype defaults to bfloat16; training runs the shipped
    # dropout 0.2, serving none); flash_mha_packed's also carry prev_ms, the
    # previous design (scalar kernels) timed in turns with it, and the
    # profiler's device times of the kernel, the previous design and the
    # library call (CUDA events around a short call time the host too)
    def record(name, source, replaces, launches, runs, label, rate=None):
        main_run = next(r for r in runs if r["label"] == label
                        and r["dtype"] == "bfloat16" and r.get("rate") == rate)
        extra = {k: main_run[k] for k in ("prev_ms", "device_ms", "prev_device_ms",
                                          "library_device_ms", "attn_route", "dense_ms",
                                          "bound_share")
                 if k in main_run}
        if "route" in main_run:     # the launch plan's; "route" below is the language's
            extra["plan_route"] = main_run["route"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in runs),
                "ms": main_run["ms"], **extra, "plain_ms": main_run["plain_ms"],
                "bound_ms": main_run["bound_ms"],
                "bound_by": main_run["bound_by"],
                "library_ms": main_run["library_ms"]}

    # rows 1-2 also carry the baseline families' launches (the served
    # requests and the training steps, all on the tensor cores) and the
    # errors at their head dims, which max_abs_err takes in
    fams = baselines["families"]
    heads = baselines["heads"]

    def with_baselines(rec, counts, key):
        launches = {f: sum(r[c]["flash_mha_packed"] for c in counts)
                    for f, r in fams.items()}
        err = max(h[key] for h in heads)
        return {**rec, "max_abs_err": max(rec["max_abs_err"], err),
                "baseline_launches": {f: n for f, n in launches.items() if n},
                "baseline_max_abs_err": err}

    # rows 1-3 also carry the launches of the imported models and of the
    # CLI on the preprocessed raw text (migrate_phase, raw_physionet_phase)
    # rows 1-4 also carry the mesh path's launches (mesh_phase, NCCL world
    # size 1: the counts set to 0 before and read after), rows 1-2 those
    # of the TP 1x2 run on each of two gloo ranks (one head a rank), and
    # each its largest error against the plain version at a shard origin
    p12_mesh, pam_mesh = mesh_counts["P12"], mesh_counts["PAM"]
    tp_runs = two_ranks["1x2"]
    packed_origin_err = max(r["plain_sample_err"] for r in origins["packed"])
    fused_origin_err = origins["fused"][0]["plain_sample_err"]
    kernels = [
        {**with_baselines(record(
            "flash_mha_packed_fwd", "raindrop_tpu_torch/csrc/flash_packed.cu",
            "raindrop_tpu/ops/flash_attention.py:566",
            p12_launches["flash_mha_packed"], flash, "P12"),
            ("served", "train_fwd"), "fwd_max_abs_err"),
         "import_launches": import_launches["flash_mha_packed"],
         "mesh_launches": p12_mesh[0]["flash_mha_packed"],
         "tp_launches_a_rank": tp_runs["launches"],
         "tp_bf16_tc_launches_a_rank": two_ranks["1x2_bf16"]["tc_launches"],
         "edge_partition_tc_launches_a_rank": [
             c["launches"]["flash_mha_packed.tc"] for c in scale_out["edge_launches"]],
         "origin_sample_err": packed_origin_err},
        {**with_baselines(record(
            "flash_mha_packed_bwd", "raindrop_tpu_torch/csrc/flash_packed.cu",
            "raindrop_tpu/ops/flash_attention.py:610",
            p12_tb["flash_mha_packed"], flash_bwd, "P12", 0.2),
            ("train_bwd",), "bwd_sample_err"),
         "import_launches": import_launches["flash_mha_packed_bwd"],
         "mesh_launches": p12_mesh[1]["flash_mha_packed"],
         "tp_launches_a_rank": tp_runs["bwd_launches"],
         "tp_bf16_tc_launches_a_rank": two_ranks["1x2_bf16"]["tc_bwd_launches"],
         "edge_partition_tc_launches_a_rank": [
             c["bwd_launches"]["flash_mha_packed.tc"] for c in scale_out["edge_launches"]],
         "origin_sample_err": packed_origin_err},
        {**record("fused_encoder_layer_fwd", "raindrop_tpu_torch/csrc/fused_encoder.cu",
                  "raindrop_tpu/ops/fused_encoder.py:131",
                  pam_launches["fused_encoder_layer.tc"], fused, "PAM"),
         **FUSED_FWD_KERNELS, "import_launches": import_launches["fused_encoder_layer"],
         "mesh_launches": pam_mesh[0]["fused_encoder_layer.tc"],
         "origin_sample_err": fused_origin_err},
        {**record("fused_encoder_layer_bwd",
                  "raindrop_tpu_torch/csrc/fused_encoder_bwd.cu",
                  "raindrop_tpu/ops/fused_encoder.py:183",
                  pam_tb["fused_encoder_layer.tc"], fused_bwd, "PAM", 0.2),
         **FUSED_BWD_KERNELS, "mesh_launches": pam_mesh[1]["fused_encoder_layer.tc"]},
    ]

    csrc = "raindrop_tpu_torch/csrc"
    split_src = f"{csrc}/flash_split.cu"
    jax_flash = "raindrop_tpu/ops/flash_attention.py"
    tc_fwd = {"sources_also": [f"{csrc}/attention_tc.cuh", split_src]}
    tc_bwd = {"sources_also": [f"{csrc}/flash_packed_dkv_tc.cu", f"{csrc}/attention_tc.cuh",
                               split_src]}
    # the served 2048 path runs no dropout, the trained one the shipped 0.2;
    # the public op at T=600 ran 0.2 both ways; every bf16 launch on the
    # tensor-core route (the launches counted there)
    kernels += [
        {**record("flash_mha_fwd", f"{csrc}/flash_packed_fwd_tc.cu", f"{jax_flash}:191",
                  long_launches["flash_mha.tc"], mha_fwd, "PAM-2048", 0.0), **tc_fwd},
        {**record("flash_mha_bwd", f"{csrc}/flash_packed_dq_tc.cu", f"{jax_flash}:237",
                  long_train["route_launches"][1], mha_bwd, "PAM-2048", 0.2),
         "replaces_also": [f"{jax_flash}:275"], **tc_bwd},
        {**record("flash_mha_fused_regime_fwd", f"{csrc}/flash_packed_fwd_tc.cu",
                  f"{jax_flash}:121", op_f, mha_fwd, "PAM-600", 0.2), **tc_fwd},
        {**record("flash_mha_fused_regime_bwd", f"{csrc}/flash_packed_dq_tc.cu",
                  f"{jax_flash}:146", op_b, mha_bwd, "PAM-600", 0.2), **tc_bwd},
    ]

    def graph_record(name, line, launches, runs, ms_key="ms", bound_key="bound"):
        """The run at the main path's shape: the first of `runs`."""
        r = runs[0]
        return {"name": name, "route": "cuda",
                "source": "raindrop_tpu_torch/csrc/sparse_graph.cu",
                "replaces": f"raindrop_tpu/ops/sparse_pallas.py:{line}",
                "launches": launches,
                "max_abs_err": max(x["max_abs_err"] for x in runs),
                "ms": r[ms_key], "plan_route": r["route"], "plain_ms": r["plain_ms"],
                "bound_ms": r[f"{bound_key}_ms"], "bound_by": r[f"{bound_key}_by"],
                "library_ms": r["library_ms"]}

    # SpMM at the P12 model shape with the target's features gathered; its
    # backward as the model runs it (constant edge weights: dx alone), the
    # plain and library times beside it being those of the full backward
    kernels += [
        graph_record("spmm_segment_softmax_fwd", 64,
                     g12_launches["spmm_segment_softmax"], spmm_fwd),
        graph_record("spmm_segment_softmax_bwd", 110,
                     g12_tb["spmm_segment_softmax"], spmm_bwd, "dx_only_ms",
                     "dx_only_bound"),
        graph_record("sddmm_fwd", 195, sd_f, sddmm_fwd),
        graph_record("sddmm_bwd", 230, sd_b, sddmm_bwd),
    ]
    # the same kernels at the sensor-wise widths, launch counts from those
    # serving (forward) and training (backward) runs; P12-sw's on the
    # two-warpgroup route (launches counted there), its previous design the
    # scalar Wide kernels (prev_ms)
    sw_src = "raindrop_tpu_torch/csrc/flash_packed.cu"
    wide_src = "raindrop_tpu_torch/csrc/attention_tc_wide.cuh"
    kernels += [
        {**record("flash_mha_packed_fwd_P12_sw",
                  "raindrop_tpu_torch/csrc/flash_packed_fwd_wide.cu",
                  "raindrop_tpu/ops/flash_attention.py:566",
                  sw_serve["P12"][0]["flash_mha_packed.tc_wide"], sw_flash, "P12-sw"),
         "sources_also": [wide_src, sw_src]},
        {**record("flash_mha_packed_bwd_P12_sw",
                  "raindrop_tpu_torch/csrc/flash_packed_dq_wide.cu",
                  "raindrop_tpu/ops/flash_attention.py:610",
                  sw_train["P12"][1]["flash_mha_packed.tc_wide"], sw_flash_bwd, "P12-sw",
                  0.2),
         "sources_also": ["raindrop_tpu_torch/csrc/flash_packed_dkv_wide.cu", wide_src,
                          sw_src]},
        record("flash_mha_packed_fwd_eICU_sw", sw_src,
               "raindrop_tpu/ops/flash_attention.py:566",
               sw_serve["eICU"][0]["flash_mha_packed"], sw_flash, "eICU-sw"),
        record("flash_mha_packed_bwd_eICU_sw", sw_src,
               "raindrop_tpu/ops/flash_attention.py:610",
               sw_train["eICU"][1]["flash_mha_packed"], sw_flash_bwd, "eICU-sw", 0.2),
        {**record("fused_encoder_layer_fwd_PAM_sw",
                  "raindrop_tpu_torch/csrc/fused_encoder.cu",
                  "raindrop_tpu/ops/fused_encoder.py:131",
                  sw_serve["PAM"][0]["fused_encoder_layer.tc"], sw_fused, "PAM-sw"),
         **FUSED_FWD_KERNELS},
        {**record("fused_encoder_layer_bwd_PAM_sw",
                  "raindrop_tpu_torch/csrc/fused_encoder_bwd.cu",
                  "raindrop_tpu/ops/fused_encoder.py:183",
                  sw_train["PAM"][1]["fused_encoder_layer.tc"], sw_fused_bwd, "PAM-sw", 0.2),
         **FUSED_BWD_KERNELS},
    ]
    # the fused layer's three attention launchers on "tc_wide" at PAM-sw:
    # the forward's served (dropout 0), dq's and dk/dv's trained (0.2), the
    # launches those paths counted there; max_abs_err over both rates
    def wide_record(i, launches, rate, src):
        r = next(x[i] for x in sw_wide if x[i]["rate"] == rate)
        return {"name": r["kernel"], "route": "cuda", "source": f"{csrc}/{src}",
                "replaces": ("raindrop_tpu/ops/fused_encoder.py:131" if i == 0 else
                             "raindrop_tpu/ops/fused_encoder.py:183"),
                "launches": launches,
                "max_abs_err": max(x[i]["max_abs_err"] for x in sw_wide),
                "ms": r["ms"], "plan_route": r["route"], "bound_share": r["bound_share"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **({"library_pair_ms": r["library_pair_ms"]} if i else {}),
                "sources_also": [f"{csrc}/attention_tc_wide.cuh"]}

    fwd_wide = sw_serve["PAM"][0]["fused_encoder_layer.tc_wide"]
    bwd_wide = sw_train["PAM"][1]["fused_encoder_layer.tc_wide"]
    kernels += [wide_record(0, fwd_wide, 0.0, "fused_encoder_attn_wide.cu"),
                wide_record(1, bwd_wide, 0.2, "fused_encoder_dq_wide.cu"),
                wide_record(2, bwd_wide, 0.2, "fused_encoder_dkv_wide.cu")]
    # flash_mha past hd 128 at PAM-sw's head dim (170) on its 2048-step
    # window: launches from that configuration's server (forward) and its
    # train_split run (backward); max_abs_err over hd 170 and 360
    kernels += [
        {**record("flash_mha_fwd_PAM_sw", f"{csrc}/flash_packed_fwd_wide.cu",
                  f"{jax_flash}:191", sw_long_launches["flash_mha.tc_wide"], sw_mha_fwd,
                  "PAM-sw-2048", 0.0),
         "sources_also": [f"{csrc}/attention_tc_wide.cuh", split_src]},
        {**record("flash_mha_bwd_PAM_sw", f"{csrc}/flash_packed_dq_wide.cu",
                  f"{jax_flash}:237", sw_long_protocol["route_launches"][1], sw_mha_bwd,
                  "PAM-sw-2048", 0.2),
         "replaces_also": [f"{jax_flash}:275"],
         "sources_also": [f"{csrc}/flash_packed_dkv_wide.cu", f"{csrc}/attention_tc_wide.cuh",
                          split_src]},
    ]
    # past hd 368: the packed pair's launches from P12-sw at one head
    # (served forward, trained forward and backward; bf16 on "tc_cluster",
    # f32 on "hd_stream"), flash_mha's from the public op at hd 720 and 1024
    # (bf16 and f32); times at the model's shape (B=128, T=215, hd 720) and
    # at T=2048, hd 720 (B=8), in bf16, the new route and the previous
    # design ("hd_stream", impl="hd_stream") in turns; max_abs_err the
    # forward's, the backward's the gradients' sample_err, over every
    # checked hd of the record's dtype
    hds = wide["kernels"]
    models = wide["models"]

    def past_record(name, route, replaces, launches, kind, t, bwd, also=()):
        runs = [r for r in hds if r["kind"] == kind and r["route"] == route]
        pre = "bwd_" if bwd else ""
        ms = t[f"{pre}ms"] if route == "tc_cluster" else t[f"prev_{pre}ms"]
        unit = ("flash_packed_hds.cu" if route == "hd_stream" else
                f"flash_packed_{'dq' if bwd else 'fwd'}_tcc.cu")
        header = f"attention_{'hd_stream' if route == 'hd_stream' else 'tc_cluster'}.cuh"
        timed = ({"timed": "bf16 operands on impl='hd_stream' (the previous design), in "
                           "turns with tc_cluster; the main path's launches are f32"}
                 if route == "hd_stream" else {})
        return {"name": name, "route": "cuda", "source": f"{csrc}/{unit}",
                "replaces": f"{jax_flash}:{replaces}", "launches": launches, **timed,
                "max_abs_err": max(r["grad_sample_err" if bwd else "max_abs_err"]
                                   for r in runs),
                "ms": ms, "plan_route": route,
                "plain_ms": t[f"{pre}plain_ms"], "bound_ms": t[f"{pre}bound_ms"],
                "bound_by": t[f"{pre}bound_by"], "library_ms": t[f"{pre}library_ms"],
                "library": f"SDPA, {t['sdpa_backend']} backend", "shape": {
                    k: t[k] for k in ("B", "T", "hd", "dtype")},
                **({"replaces_also": [f"{jax_flash}:{x}" for x in also]} if also else {}),
                "sources_also": ([f"{csrc}/flash_packed_dkv_tcc.cu"] if bwd and route ==
                                 "tc_cluster" else []) + [
                    f"{csrc}/{header}", f"{csrc}/flash_packed.cu", split_src]}

    t_packed, t_split = wide["timing"]["packed"], wide["timing"]["split"]
    bf, f32 = models["bfloat16"], models["float32"]
    op = wide["op_launches"]
    kernels += [
        {**past_record("flash_mha_packed_fwd_tc_cluster", "tc_cluster", 566,
                       bf["serve_launches"]["flash_mha_packed.tc_cluster"]
                       + bf["train_launches"]["flash_mha_packed.tc_cluster"], "packed",
                       t_packed, False),
         "fused_launches": fused_wide["models"]["P12-sw-1h bf16"]["train_launches"][
             "fused_encoder_layer.tc_cluster"], "occupancy": wide["occupancy"]},
        {**past_record("flash_mha_packed_bwd_tc_cluster", "tc_cluster", 610,
                       bf["train_bwd_launches"]["flash_mha_packed.tc_cluster"], "packed",
                       t_packed, True),
         "fused_launches": fused_wide["models"]["P12-sw-1h bf16"]["train_bwd_launches"][
             "fused_encoder_layer.tc_cluster"]},
        past_record("flash_mha_fwd_tc_cluster", "tc_cluster", 191, op["tc_cluster_launches"],
                    "split", t_split, False, (121,)),
        past_record("flash_mha_bwd_tc_cluster", "tc_cluster", 237,
                    op["tc_cluster_bwd_launches"], "split", t_split, True, (275, 146)),
        {**past_record("flash_mha_packed_fwd_hd_stream", "hd_stream", 566,
                       f32["serve_launches"]["flash_mha_packed.hd_stream"]
                       + f32["train_launches"]["flash_mha_packed.hd_stream"], "packed",
                       t_packed, False), "f32_ms": wide["timing"]["packed_f32"]["ms"]},
        {**past_record("flash_mha_packed_bwd_hd_stream", "hd_stream", 610,
                       f32["train_bwd_launches"]["flash_mha_packed.hd_stream"], "packed",
                       t_packed, True), "f32_ms": wide["timing"]["packed_f32"]["bwd_ms"]},
        past_record("flash_mha_fwd_hd_stream", "hd_stream", 191, op["hd_stream_launches"],
                    "split", t_split, False, (121,)),
        past_record("flash_mha_bwd_hd_stream", "hd_stream", 237, op["hd_stream_bwd_launches"],
                    "split", t_split, True, (275, 146)),
    ]
    # the fused layer past its tiles ("stream"): launches from P12-sw at
    # T=600 served (forward) and trained (forward and backward), 2 heads
    # and 1, f32 and bf16 operands; times at the model's shape (B=128, 2
    # heads, bf16), the one-head times beside; max_abs_err over all four
    fw_models = fused_wide["models"].values()
    fw_runs = {way: [r for r in fused_wide["layers"] if r["way"] == way]
               for way in ("fwd", "bwd")}
    stream_srcs = [f"{csrc}/fused_encoder.cu", f"{csrc}/fused_encoder_bwd.cu",
                   f"{csrc}/fused_plan.cuh", f"{csrc}/fused_encoder_attn_hds.cu",
                   f"{csrc}/fused_encoder_bwd_hds.cu", f"{csrc}/attention_hd_stream.cuh",
                   f"{csrc}/attention_tc_cluster.cuh"]

    def one_head(way):
        r = next(x for x in fw_runs[way] if x["label"] == "P12-sw-1h"
                 and x["dtype"] == "bfloat16")
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "attn_route")}

    kernels += [
        {**record("fused_encoder_layer_fwd_stream", f"{csrc}/rows_stream.cuh",
                  "raindrop_tpu/ops/fused_encoder.py:131",
                  sum(m["serve_launches"]["fused_encoder_layer.stream"]
                      + m["train_launches"]["fused_encoder_layer.stream"] for m in fw_models),
                  fw_runs["fwd"], "P12-sw"),
         "one_head": one_head("fwd"), "shape": {"B": 128, "T": 600, "d": 720, "ffn": 288},
         "sources_also": stream_srcs},
        {**record("fused_encoder_layer_bwd_stream", f"{csrc}/rows_stream.cuh",
                  "raindrop_tpu/ops/fused_encoder.py:183",
                  sum(m["train_bwd_launches"]["fused_encoder_layer.stream"]
                      for m in fw_models), fw_runs["bwd"], "P12-sw", 0.2),
         "one_head": one_head("bwd"), "shape": {"B": 128, "T": 600, "d": 720, "ffn": 288},
         "cli_launches": [fused_wide["cli"]["launches"]["fused_encoder_layer.stream"],
                          fused_wide["cli"]["bwd_launches"]["fused_encoder_layer.stream"]],
         "sources_also": stream_srcs},
    ]
    # rows 1-11 at 70000 samples: the launches of each row's bf16 call there
    # (forward or backward), two a call
    big_rows = {"flash_mha_packed": "flash_mha_packed bfloat16",
                "fused_encoder_layer": "fused_encoder_layer bfloat16",
                "flash_mha": f"flash_mha B={BIG_B} H=2 bfloat16",
                "flash_mha_fused_regime": f"flash_mha B={BIG_B} H=2 bfloat16",
                "spmm_segment_softmax": "spmm_segment_softmax gather_target=True",
                "sddmm": "sddmm"}
    for rec in kernels:
        op, _, way = rec["name"].rpartition("_")
        if op in big_rows and way in ("fwd", "bwd"):
            rec["big_batch_launches"] = big[big_rows[op]]["launches"][way == "bwd"]
    for rec in kernels:
        if rec["launches"] <= 0 or rec.get("mesh_launches", 1) <= 0:
            raise AssertionError(f"{rec['name']} was never launched on its path")
    detail = {"card": card, "build_s": build_s, "sass": sass, "flash": flash,
              "fused": fused, "flash_bwd": flash_bwd, "flash_edge": edges,
              "fused_bwd": fused_bwd, "fused_edge": fused_edges,
              "sensor_wise": {
                  "flash": sw_flash, "flash_bwd": sw_flash_bwd, "fused": sw_fused,
                  "fused_bwd": sw_fused_bwd, "fused_wide_attention": sw_wide,
                  "serve": {k: {"launches": v[0], **v[1]} for k, v in sw_serve.items()},
                  "train": {k: {"launches": v[0], "bwd_launches": v[1], **v[2]}
                            for k, v in sw_train.items()}},
              "spmm_fwd": spmm_fwd, "spmm_bwd": spmm_bwd,
              "sddmm_fwd": sddmm_fwd, "sddmm_bwd": sddmm_bwd, "graph_edge": graph_edges,
              "serve": {"PAM": {"launches": pam_launches, **pam},
                        "P12": {"launches": p12_launches, **p12},
                        "P12_pallas": {"launches": g12_launches, **g12}},
              "train": {"PAM": {"launches": pam_tf, "bwd_launches": pam_tb,
                                **pam_train},
                        "P12": {"launches": p12_tf, "bwd_launches": p12_tb,
                                **p12_train},
                        "P12_pallas": {"launches": g12_tf, "bwd_launches": g12_tb,
                                       **g12_train}},
              "global_adj": adj,
              "mixed_precision": {**mixed, "PAM-2048": long_mixed},
              "use_beta": {"serve": {"launches": beta_launches, **beta_serve},
                           "train": {"launches": beta_tf, "bwd_launches": beta_tb,
                                     **beta_train},
                           "graph": beta_graph},
              "bf16_storage": storage,
              "cli": {"P12_files": cli_files, "PAM_streaming": cli_stream},
              "streaming": streaming, "mfu": mfu_runs, "baselines": baselines,
              "migrate": migrated, "raw_physionet": raw_text,
              "selfattention": {"launches": sd_f, "bwd_launches": sd_b,
                                "checks": selfatt},
              "flash_mha_fwd": mha_fwd, "flash_mha_bwd": mha_bwd,
              "flash_mha_op": {"launches": op_f, "bwd_launches": op_b,
                               "checks": op_checks},
              "long": {"serve": {"launches": long_launches, **long_serve},
                       "train": {"launches": long_tf, "bwd_launches": long_tb,
                                 **long_train},
                       "run_splits": splits},
              "long_sensor_wise": {
                  "flash_mha_fwd": sw_mha_fwd, "flash_mha_bwd": sw_mha_bwd,
                  "flash_mha_edge": mha_edges,
                  "serve": {"launches": sw_long_launches, **sw_long_serve},
                  "train": {"launches": sw_long_tf, "bwd_launches": sw_long_tb,
                            **sw_long_train},
                  "protocol": {"launches": sw_long_pf, "bwd_launches": sw_long_pb,
                               **sw_long_protocol}},
              "mesh": {"origins": origins, "mesh": mesh_runs, "two_ranks": two_ranks,
                       "scale_out": scale_out,
                       "torchrun_cli": {"summary": torchrun_summary,
                                        "seconds": torchrun_s}},
              "host_runtime": host, "wide_heads": wide, "big_batch": big,
              "fused_wide": fused_wide,
              "phase_s": phase_s, "total_s": time.perf_counter() - t_start,
              "kernels": kernels}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)

    name = torch.cuda.get_device_name(0)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build "
          f"{build_s:.1f} s of it", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
