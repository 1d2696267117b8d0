#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ecg_denoise_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases, each of which fails the run on error (no phase catches a failure,
and nothing falls back to the CPU):

1. Device and build: the card's name and power limit, then nvcc builds the
   seven kernel sources (B1-B5, the null copy and the precision probes)
   from the checkout at once and prints their ptxas reports (registers,
   shared memory, spills by kernel instantiation). Where the parent
   commit's tree is unpacked under _archive/parent (by `git archive`; a
   plain checkout has none), its B1-B5, P1 and P2 are built beside them as
   yardsticks, never on a path. ECG_ATTN_DENSE is cleared: phases
   1-13 drive the default route.
2. Kernel vs plain version on the card, at the five RA-LENet stage shapes,
   with and without bias, float32 (tolerance 1e-5, TF32 off for this phase
   only) and bfloat16
   (3 * 2^-8 of max|v|, see BF16_TOL_OF_MAX_V), plus a ragged batch, shapes
   that cut across B1's row tiles and batch groups (RAGGED: L = 203, 7,
   1; B = 1, 3, 37, 1000) and logits near 200; every case's lse against
   attention_reference's (LSE_TOL) and a second call bit-identical; and,
   where the parent's tree is there, every case's output equal to the
   parent's B1 bit for bit (the D = 4 kernel is unchanged beside D = 32).
2b. Within phase 2's loop, B1 on its mma template: at head_dim 32
   (Transformer1d's heads) against its plain version, at Transformer1d's
   four stage shapes (L, H) = (256, 4), (128, 8), (64, 16), (32, 32) at
   B = 256 (the served batch of phase 24) and B = 64 (its training batch)
   and a ragged (B, L) = (3, 203), with and without bias, f32 and bf16, q
   scaled by 32^-1/2 as the model scales it, at phase 2's bars, with the
   lse and a second call bit-identical; then the first stage at B = 64
   with q unscaled (logits up to about 35) at LARGE_LOGIT_TOL; then at
   head_dim 8, 16, 24 (padded to 32) and 64 at shapes that cut across its
   tiles and packed heads, and at D = 4 past 256 keys (MMA_D_CASES).
3. Model: RA-LENet 'full' at full width and depth, seeded weights with
   random nonzero rel-pos tables and BN stats; the card's forward against
   the same model on the CPU (float32, 1e-4) and 18 kernel launches per
   forward. The package, not this script, turns TF32 off for the model.
4. Serving, the main path: `cli.serve --model ralenet`'s HTTP server
   (built by the CLI's own `build`, run in a thread) answers /healthz,
   naming the path torch+attn-cuda:cuda, /denoise for 1, 37 and 1024
   windows and /denoise_record, each answer equal to its Denoiser called
   directly. The kernel's launch count is set to 0 just before and read
   just after.
5. Times on the card: Denoiser windows/s at batch 1024 and 2048 in float32
   and bfloat16, the device time of one forward by kernel in each
   (torch.profiler), and per stage shape the kernel's time (CUDA graph
   replays, and issued from Python), its bound, the plain version's time,
   scaled_dot_product_attention's and, where its tree is there, the
   parent's B1 on the same operands in turns (parent, this, this, parent),
   as yardsticks (the port never calls them). A call from a fresh thread,
   as the HTTP server makes, is timed and profiled by operator.
6. Backward kernel vs plain versions on the card: the autograd Function's
   dq, dk, dv and dbias at the five stage shapes, with and without bias,
   f32 and bf16, B = 256, plus a ragged B = 3, the ragged shapes of phase 2
   (RAGGED) and every stage shape with its logits shifted by +190 (f32 and
   bf16), against autograd through the plain forward (f32) and against the
   plain flash backward on the kernel forward's own o and lse (f32 and
   bf16); two calls give bit-identical gradients; and, where the parent's
   tree is there, dq, dk, dv and the float32 dbias equal the parent's B2
   bit for bit on the same o, lse and g.
6b. Within phase 6's loop, B2 at phase 2b's B = 64, ragged and
   MMA_D_CASES cases through the autograd Function,
   against the plain flash backward on B1's own o and lse and, in f32,
   autograd through the plain forward: each gradient within 1e-4 of its
   max (f32; bf16 2^-7 of it), dbias too; a second call bit-identical.
7. Training step: RA-LENet 'full' at full width and depth, f32, batch 32,
   one `train_step` on the card against the same step on the CPU (loss
   1e-5 relative, BN running stats 1e-5, params after Adam 1e-4), with
   exactly 18 forward and 18 backward kernel launches. Four more identical
   steps on the card are compared bit for bit with the first, and the
   state tensors that differ are named (reported, not required).
7b. Training, the main path: `python -m ecg_denoise_tpu_torch.cli.main`
   (run in this process through runpy, so the launch counts are readable)
   trains 10 bf16 epochs on a small dict_data cache written to a temp dir,
   checkpoints, writes output.txt; the test loss must fall, and
   `Denoiser.from_checkpoint` serves the checkpoint. The counts are set to
   0 just before and read just after.
8. Training times on the card: `train_epoch` windows/s at batch 32 and 256
   in f32 and bf16 over three whole epochs of the CLI's default length
   (8,000 windows; each epoch's rate printed), one step's time on the card's clock (CUDA events), a
   profiler breakdown of one f32 step at 256 (device kernels, idle share,
   host operators by self CPU time), and per stage shape the backward
   kernel's time (CUDA graph replays, in turns with the parent's B2 where
   its tree is there, and the wrapper issued from Python), each pass's
   device time for both (torch.profiler), its bound, the plain backward's
   and the backward of scaled_dot_product_attention with a grad-requiring
   mask as a yardstick.
9. B3 (attention_rpos_fwd.cu) against its plain version at the four
   biased stage shapes (L, W, H), B = 1024, R peaks at 0, 5, L/2, L - 1 and
   random ones (windows hanging off both ends), f32 (1e-5) and bf16
   (3 * 2^-8 of max|v|), plus a ragged B = 3, the ragged shapes of
   RAGGED_RPOS (B = 1, 17, 37, 1000; L = 203, 7, 1, W cut to fit) and
   logits near 200; two calls bit-identical; and, where the parent's tree
   is there, the output and lse equal the parent's B3 bit for bit.
10. B4 (attention_rpos_bwd.cu) through its autograd Function against the
   plain flash backward on B3's own o and lse and, in f32, against autograd
   through the plain forward, B = 256, at the limits of phase 6 (dtoep as
   dbias) and phase 9's cases; two calls bit-identical; and, where the
   parent's tree is there, dq, dk, dv and the float32 dtoep equal the
   parent's B4 bit for bit on the same o, lse and g.
11. The r_pos serving path: the model with detected R peaks on the card
   against the CPU (1e-4), the card's detected positions equal to the
   CPU's, 14 B3 and 4 B1 launches per forward; then `cli.serve --r_pos
   detect`'s server answers /healthz, /denoise and /denoise_record equal
   to its Denoiser called directly, the counts set to 0 just before and
   read just after.
12. The r_pos training path: one f32 step with detection on the card
   against the CPU (the bars of phase 7) with 14 + 4 launches each way;
   12b: `cli.main --r_pos detect` trains 10 bf16 epochs, the test loss
   falls, and its checkpoint serves with r_pos="detect".
13. r_pos times: per stage shape B3 (B = 1024, no lse) and B4 (B = 256)
   from CUDA graph replays, in turns with the parent's B3 and B4 where its
   tree is there, and the wrappers issued from Python; B4's passes' device
   times for both (torch.profiler); their bounds, plain versions and
   scaled_dot_product_attention with the materialised (B, H, L, L) mask
   (forward, and backward with the mask requiring grad); Denoiser
   windows/s with and without r_pos, in turns; the r_pos forward's and
   training step's device breakdown and idle share.

14. B5 (attention_dense_fwd.cu) against B1 and its plain version on the
   same operands: the four stage shapes the dense route takes in RA-LENet
   and five small ones it admits (L = 2 and 8, P = 6), with and without
   bias, f32 and bf16, B = 1024 and batches that cut across B5's groups of
   elements (B = 3, 1, 17, 37, 1000): equal to B1 without lse bit for bit,
   within 1e-5 (f32) and 3 * 2^-8 of max|v| (bf16) of the plain version
   and, where its tree is there, of the parent's B5; two calls
   bit-identical; heads whose row maxima sit more than 110 logits apart,
   and logits near 200, within 1e-4 of attention_reference.
15. The dense serving path, with ECG_ATTN_DENSE=1: the model on the card
   against the CPU (1e-4) with 12 B5 and 6 B1 launches per forward, and
   with detected R peaks 4 B5 and 14 B3; then `cli.serve`'s server
   answers /denoise and /denoise_record equal to its Denoiser, and
   `StreamingDenoiser` fed a record in chunks of 1, 100 and 777 samples
   equals denoise_record, the counts set to 0 just before and read just
   after.
16. Dense times: B5's registers, stack and local memory by kernel
   instantiation (cuobjdump -res-usage; a spill fails the run) and its
   shared memory a block; per stage shape, and at (64, 4) (RA-LENet with
   half the heads), B5 (B = 1024) from CUDA graph replays in turns with
   the parent's B5 where its tree is there, beside B1 without lse, its
   bound, the plain version and scaled_dot_product_attention; Denoiser
   windows/s with and without ECG_ATTN_DENSE=1, in turns; the dense
   forward's device breakdown and idle share.
17. P2: null_copy and, where its tree is there, the parent's P2 equal to
   clone() bit for bit at 1, 3, 1,023, 1,024, 1,025 values and a q's, each
   aligned and as a view 4 bytes off; its time at a (64, 8) call's q at
   B = 1024 from HBM, settled (`settle`: 20 rounds in turns, level, slower,
   faster or unsettled) against copy_ and the parent's, the parent's also at the dma floor's batches (256, 1024, 2048) and the
   null tile; then the probes `ecg_denoise_tpu_torch.probes.floor` and
   `.chain` (the null launch, the dma floor, B1 and B5 by batch, K calls
   from Python against one CUDA graph), their counts set to 0 just before
   and read just after.
18. P1, the precision probes (precision_probe.cu): probe_dot at each
   precision (ieee, tf32, tf32x3, bf16) within c K 2^-24 (|A_r| . |B_r|)
   of its plain version elementwise, probe_fold at each precision and
   probe_tree within 1e-5 of max|out|, probe_div bit for bit against
   torch.div, numpy and, where its tree is there, the parent's, its operands aligned and off by 1-4 values, alike and not
   (PRECISION_DIV_OFFSETS), at the probe's shapes and ragged ones (the
   softmax probes also at shapes that cut across their blocks: L = 1, 7,
   129, 1024), two calls bit-identical, and, where the parent's tree is
   there, the dot, the fold and the tree bit for bit the parent's; SDPA
   with zero q and k and the logits as its mask (the fold's and the tree's
   library call) within 1e-5 of max|out| of tree_plain, and the backend it
   took; then the probe `ecg_denoise_tpu_torch.probes.precision`,
   the counts set to 0 just before and read just after (the four probe
   kernels launched, the six others not), its f32-accurate paths within
   1e-5 of float64, and its four dot and four fold readings equal to those
   of the first versions, within 1e-3 relative (PROBE_DOT_READINGS,
   PROBE_FOLD_READINGS); then each kernel's time from CUDA graph replays
   beside its bound, its plain version and the library call, the dot in
   turns with torch.matmul, the fold and the tree with SDPA, and, where
   its tree is there, each with the parent's; the divide settled against
   torch.div and the parent's divide (`settle`, as
   P2 in phase 17, at LAUNCH_FLOOR_CALLS calls a reading).

19. The denoiser families without attention: UNet, DANet (Seq2Seq2) and
   ACDAE at their own widths, seeded weights with nonzero BN affine
   parameters and stats. For each: the card's f32 forward against the CPU
   (1e-4) with no kernel launch; `cli.serve --model <name>`'s server (built
   by the CLI's own flag parser) answers /healthz, naming the path
   torch:cuda, /denoise for 1, 37 and 1024 windows and /denoise_record,
   each equal to its Denoiser; one f32 step at batch 32 against the CPU at
   the bars of phase 7, and each tensor's gradients to 1e-4 of its largest
   against the same step in float64 on the CPU, except where that gradient
   is at the rounding floor, 1e-6 of the largest: there the gradient is
   held to the floor and the parameter not at all (`step_bars`: Adam's
   first step moves such an element, a bias before a training-mode
   BatchNorm, by lr times a rounding's sign; only a bias may sit at the
   floor whole); `cli.main` (no --model_index for UNet, the CLI's default;
   1 and 5) trains 10 bf16 epochs as in 7b, the test loss falls and the
   checkpoint serves; then Denoiser windows/s at batch 1024 and train_epoch
   windows/s at 256, f32 and bf16, and the f32 forward's device breakdown
   and idle share. The counts of the serving and training paths
   (serve_families, train_families) are all 0.
20. 12-lead transfer: NewRale with a seeded RA-LENet core. The forward on
   the card against the CPU (1e-4) with 18 B1 launches; one f32 step with
   the core frozen against the CPU (loss 1e-5, adapters as `step_bars`
   holds phase 19's, the core's parameters and BN stats unchanged bit for
   bit on both sides) with 18 B1 and 18 B2 launches; B2 with a bias and no
   dbias (the frozen core's case) at the four biased stage shapes, f32 and
   bf16, B = 256, against the plain flash backward (the bars of phase 6),
   dq, dk, dv bit for bit the same call's with dbias, and its time beside
   the call with dbias (graph replays in turns); `python -m
   ecg_denoise_tpu_torch.cli.transfer_learning` trains 10 bf16 epochs on a
   synthetic 12-lead cache with phase 7b's checkpoint as --core_ckpt: the
   test loss falls and the core comes out bit for bit as it went in
   (train_newrale: 18 B1 a forward, 18 B2 a step); `cli.serve --model
   newrale` serves (N, 12, 256) equal to its Denoiser, /healthz naming
   torch+attn-cuda:cuda (serve_newrale: 72 B1); windows/s served and
   trained, and the forward's breakdown.
21. The data path: `python -m ecg_denoise_tpu_torch.cli.build_data`
   (through runpy) builds four caches from the checkout, each build's wall
   seconds printed: dict_data from the WFDB fixture tests/data/mini_physionet
   (128 windows), a synthetic dict_data from 1 record (2,528 windows of
   (2, 256)), `--cls` at its defaults (2,048 + 512 beats a class) and
   `--external`, the 12-lead cache, at 1 record; each loads through
   `EcgDataset` / `load_cls_arrays` with its shapes. `snr_noise_add` on the
   card equals `snr_noise_add_at` on the CPU at the same offsets within 1e-6
   of max|out|, each window within 1e-3 dB of its target at -4, 0 and 4 dB.
   `make_augmented_epoch_fn` trains RA-LENet 'full' (f32, batch 32) for 3
   epochs on the synthetic cache's clean windows, mixing a synthetic 'bw'
   record (650,000 x 2, f32) on the card at 0 dB: the loss falls, with
   exactly 18 B1 and 18 B2 launches a step (train_augmented); `cli.main
   --model_index 4` trains 10 bf16 epochs on the port-built synthetic cache,
   the test loss falls and the checkpoint serves (build_train). Times: the
   augmented epoch against `train_epoch` on the cache's pre-mixed windows,
   f32, batch 256, in turns, in windows/s, and the mixer's device time a
   batch.
22. The DWT baseline: `wavelet_denoise_device` on the card within 1e-4 of
   the numpy `wavelet_denoise` at 4,096 rows of 256 and 512 rows of a
   ragged L = 203, TF32 off, a second call bit-identical; `python -m
   ecg_denoise_tpu_torch.cli.dwt_dn` on the synthetic cache writes its line
   on the card and with `--host`, the two SNRs within 1e-3 dB, no port
   kernel launched (baseline_dwt); rows/s on the card and on the host at
   4,096 and 65,536 rows, and the device pyramid's launches and idle share
   (torch.profiler).

23. The beat classifier: ResNetCls (seeded, nonzero BN stats) on the card
   against the CPU (1e-4); `python -m ecg_denoise_tpu_torch.cli.train_cls`
   trains 3 epochs on phase 21's cls cache (the last epoch's train loss
   below the untrained classifier's on the same split, the checkpoint
   loads, no port kernel: train_cls); `python -m
   ecg_denoise_tpu_torch.cli.test_cls` with that classifier and phase 7b's
   RA-LENet checkpoint prints every condition (clean, noisy, the six
   denoisers, five skipped, dwt, fft), the ralenet condition with 18 B1
   launches a batch of 128 and nothing else (test_cls); then ResNetCls
   windows/s trained at 32 and 256 and evaluated at 1,024, f32 and bf16,
   and the f32 step's breakdown and idle share at 256.
24. Transformer1d at its defaults (47,478,153 parameters, every head 32
   wide), 256-sample inputs, seeded weights: the forward on the card
   against the CPU at B = 8 (1e-4) with 12 B1 launches; one f32 step
   through `cls_epoch` at B = 4 against the CPU's (loss 1e-5, `step_bars`)
   with 12 B1 and 12 B2; served at 256 (serve_transformer1d: 12 B1) and
   two steps at 64 through `make_cls_epoch_fns` (train_transformer1d: 24 +
   24), windows/s served and step ms, f32 and bf16, the f32 step's
   breakdown; B1's and B2's mma kernels' registers, spills and HMMA
   instructions by instantiation (cuobjdump; a kernel without HMMA fails
   the run); per stage shape B1 (B = 256) and B2 (B = 64) from CUDA graph
   replays, in turns with the parent's where its tree is there, beside
   their bounds (3xTF32 on the tensor cores, and the CUDA cores' of the
   first design), plain versions and scaled_dot_product_attention (no
   mask); Transformer1d's served windows/s and step ms, f32 and bf16, with
   this tree's B1 and B2 and the parent's in turns.
25. B5's mma template (attention_dense_fwd.cu, head_dim 8, 16, 32, 64):
   its registers, spills and HMMA count by instantiation (cuobjdump; a
   spill or no HMMA fails the run) and its launch (blocks, threads, ring
   stages, shared memory a block) at Transformer1d's packable stages;
   against its plain version and B1 without lse at D = 4, 8, 16, 24 (padded
   to 32), 32 and 64, at those stages, (L, H) = (64, 16) and (32, 32), and
   at the others of DENSE_OTHER, B = 256 and 37, with and without bias,
   f32 (1e-5) and bf16 (3 * 2^-8 of max|v|), q scaled by D^-1/2, a second
   call bit-identical, and, where its tree is there, the parent's B5 (at D
   = 4 bit for bit, at D = 32 within the bars); Transformer1d at its
   defaults served at 256 with ECG_ATTN_DENSE=1 (serve_transformer1d_dense:
   4 B1 and 8 B5), its first 8 windows within 1e-4 of the CPU; the 8 dense
   calls' times, f32 and bf16, B5 in turns with B1 without lse and the
   parent's B5 from CUDA graph replays, beside the bound (3xTF32 or bf16 on
   the tensor cores, or the bytes), the plain version and SDPA; B5 at D =
   8, 16 and 64 at (64, 16) in turns with B1; served windows/s dense and
   default, in turns.
26. B1 and B2 at head_dim 32 past 256 keys, at the four stages of a
   1,000-sample record and B = 2, 4, 32 (D32_LONG), with and without
   bias, f32 and bf16, at the bars of phases
   2b and 6b (the lse too; B2 against the plain flash backward and, in f32,
   autograd through the plain forward); Transformer1d at its defaults on
   1,000-sample inputs (stages at L = 1000, 500, 250, 125): the forward at
   4 within 1e-4 of the CPU with 12 B1, one step at 2 against the CPU's at
   `step_bars` (train_transformer1d_long: 12 + 12), served at 32
   (serve_transformer1d_long: 12 B1), windows/s f32 and bf16; per stage B1
   and B2 at B = 32 from CUDA graph replays, in turns with the parent's,
   beside their bounds, plain versions and SDPA, and the served and
   trained rates against the parent's, as in phase 24.
27. A JAX checkpoint: the UNet TrainState the JAX package wrote
   (tests/data/jax_ckpt) served by `Denoiser.from_checkpoint` on the card
   within 1e-4 of JAX's committed output, by `cli.serve --model unet
   --ckpt` (serve_jax_ckpt: one POST equal to its Denoiser, no launch),
   and resumed by `load_checkpoint` (Adam at step 1) for one finite step
   on the card (train_jax_ckpt, no launch).

28. Data parallelism (`ecg_denoise_tpu_torch.parallel`). (a) NCCL at
   world size 1: `python -m ecg_denoise_tpu_torch.cli.main --model_index 4
   --epochs 1` on phase 21's port-built cache, single process and with
   `--n_data 1`, each in a directory of its own: one output.txt line and
   one train_log.jsonl record each, the same launches (train_dp); one f32
   step at DP_BATCH under `make_mesh(1)` against the single-process step
   on the card (loss 1e-5 relative, BN stats 1e-5, `step_bars`), 18 + 18
   launches. (b) Two processes on the one card (NCCL refuses two ranks on
   one device, so gloo carries their all-reduces), spawned with a file
   store: RA-LENet 'full' f32, 16 of a global batch of 32 a rank, one step
   of `make_epoch_fns(mesh=...)` each, without and with `--r_pos detect`,
   against the single-process step on the card at the same bars, the
   ranks' states bit for bit alike, each rank 18 B1 + 18 B2 (train_dp) or
   4 + 4 and 14 B3 + 14 B4 (train_dp_rpos). (c) `Denoiser(n_data=2,
   devices=["cuda:0", "cuda:0"])` at 1,024 windows within 1e-5 of
   n_data=1, its path torch+attn-cuda+dp2:cuda, 18 B1 a replica
   (serve_dp). Then the DP step's ms at world 1 (in turns with the single
   process's) and at world 2 on one card against the single process's:
   findings, not claims.
29. Tensor parallelism (`parallel.shard_state_dp_tp`, Megatron column and
   row shards of the transformer projections over a model group), every
   rank a process on the one card over gloo, spawned with a file store.
   (a) The (n_data, n_model) = (1, 2) grid: RA-LENet 'full' f32 at
   DP_BATCH, one step of `make_epoch_fns(mesh=...)` with each rank's
   shard, without and with `--r_pos detect`, gathered to one process's
   layout (`gather_named`) and held against the single-process step on the
   card at phase 28's bars (`dp_bars`: loss 1e-5 relative, BN stats 1e-5,
   every parameter 1e-4, the gradients by `step_bars`), the two ranks'
   replicated tensors bit for bit alike, each rank 18 B1 + 18 B2
   (train_tp) or 4 + 4 and 14 B3 + 14 B4 (train_tp_rpos), on its 1 to 16
   local heads. (b) The (2, 2) grid, four processes, 16 rows a data
   index: one plain step at the same bars; the ranks of one data index
   hold the same replicated tensors, those of one model index the same
   shards (train_tp). (c) (a)'s checkpoint, gathered (`gather_state`) and
   written by rank 0: `Denoiser.from_checkpoint` holds the gathered
   state bit for bit and serves TP_SERVE_WINDOWS within 1e-5 of the
   single-process model after the same step, with 18 B1 (serve_tp_ckpt);
   `fit(resume_path=...)` under (1, 2) takes one more step, at the same
   bars as one process resumed from it. (d) The eval epoch over 40
   windows under (1, 2), with ECG_ATTN_DENSE=1 (12 B5 and 6 B1 a batch on
   each rank's local heads, eval_tp_dense) and without (18 B1), within
   1e-5 of the single process's, metrics and the first batch's forward.
   (e) The step's ms at (1, 2) and (2, 2) against the single process's
   before and after the spawns: ranks sharing one card and its host
   measure sharing, not scaling; findings, not claims.

30. B1, B2 and B5 past head_dim 64 (the wide kernels, one design for
   every D that is a multiple of 64; others zero-padded up to one; B1's and
   B2's on thread-block clusters along D). (a) Their
   registers, stack, local memory and HMMA by instantiation (cuobjdump;
   spills reported), B1's and B2's stack against the parent's where its
   tree is there (none may be larger), and their clusters: size and the
   clusters the card holds at once (cudaOccupancyMaxActiveClusters) at D =
   128, 256, 320, 576. (b) Each against its plain version at head_dim 72,
   128, 200, 256, 320, 512 and 576 (WIDE_DIMS), f32 and bf16,
   with and without a bias, at phase 2's and 6's bars: B1 with its lse
   and B2 through the autograd Function at (B, L, H) = (2, 32, 3), (3, 64,
   2), (2, 256, 1), (1, 1000, 1); B5 against its plain version and B1 at
   (3, 64, 2), (3, 32, 4), (3, 8, 16), (5, 16, 2); every call a launch.
   (c) Transformer1d at its published widths with num_heads (1, 1, 2, 4)
   (heads 128 wide at the first stage, 256 after): the forward on the card
   against the CPU (MODEL_TOL) with 12 B1 launches, one step against the
   CPU's at `step_bars` with 12 + 12, the dense forward (4 B1 + 8 B5,
   serve_transformer1d_wide_dense) within 1e-5 of the default route,
   served at 256 (serve_transformer1d_wide: 12 B1) and trained at 64
   (train_transformer1d_wide: 24 + 24 over two steps), windows/s and step
   ms f32 and bf16. (d) Per stage shape, B1, B2 and B5's ms from CUDA
   graph replays against their bounds, plain versions and SDPA, B1 and B2
   in turns with the parent's where its tree is there (`against_parent`:
   close pairs settled): times, no bar.

31. B3 and B4 at every head dim and length: D = 4 at L <= 256 stays on
   their D = 4 kernels (phases 9-13). B3 takes D = 4 past 256 keys
   unpadded and D = 8-64 on its window kernel
   (`csrc/attention_rpos_fwd_mma.cuh`), past 64 B1's wide kernel in its
   window mode; B4 the same way, D = 4 past 256 keys unpadded and D = 8-64
   on its window kernel (`csrc/attention_rpos_bwd_mma.cuh`), past 64 B2's
   wide passes in their window mode, the operands zero-padded to the
   kernel's head dim; past its D = 4 kernel B4's dq pass leaves the
   windowed ds in a scratch that a second kernel sums into dtoep. (a) The
   33 r-pos instantiations' registers, stack, local memory and HMMA
   (cuobjdump; neither window kernel may spill, and every one must issue
   HMMA), beside B2's wide dk/dv pass; each one's stack against the
   parent's (none may be larger) and the wide ones' clusters. (b) B3 and
   B4 against their plain versions at RPOS_ANY_D_CASES (head_dim 8, 16,
   32, 64, 128, 256, 320, 576 at L = 256, a ragged 203 and packed heads at
   32; D = 4 at L = 300 and 1000), B = 8, f32 and bf16, at phase 30's bars
   for the forward and phase 10's for the gradients (f32 also against
   float64 gradients, past D = 512 against those alone), every call a
   launch, repeated calls bit-identical; and, where the parent's tree is
   there, B1's and B2's templates and wide kernels
   (B12_TEMPLATE_PARENT_CASES), B3 and B4 on the wide kernels (o, lse; dq,
   dk, dv from this tree's forward; RPOS_PARENT_CASES) bit for bit the
   parent's, the two window kernels within their bars there. (c) The layer path:
   `RelativePositionEmbedding(W, L, H)` on R peaks detected on the card
   (equal to the CPU's), then `BasicLayer(H * D, depth 2, H)` as RA-LENet's
   stages use it, at RPOS_LAYERS, served at 1,024 (f32 within MODEL_TOL of
   the CPU on the first 32 windows, bf16 finite; 2 B3 launches a forward)
   and trained at 256 for 3 Adam steps (2 + 2 a step), one step on 32
   windows against the CPU's at `step_bars`; paths serve_rpos_d32,
   train_rpos_d32, ... (counted apart). (d) B3 at 1,024 and B4 at 256 per
   layer, f32 and bf16, from CUDA graph replays, against their bounds (the
   largest of the products, one exp a (row, key) on the special-function
   units, and the bytes: the exps set it at D = 4), plain versions and SDPA on the materialised mask, each in
   turns with the parent's where its tree is there (D = 4 past 256 keys on
   unpadded operands, the parent's padded to 8 or 16), B4's passes by
   torch.profiler (dq, dk/dv and the dtoep sum, f32 and bf16), and B3 at
   1,024 and B4 at 256 at head dims 8, 16, 64 in turns with the parent's;
   B3's output at 1,024 and B4's gradients at 256 held there to their
   plain versions at their bars (the parent's B4 errors beside them).

The last lines are one JSON object listing the ten kernels, the three
wide kernels (`attention_fwd_wide`, `attention_bwd_wide`,
`attention_dense_fwd_wide`, their launches those of phase 30's paths) and
B3's and B4's window kernel rows (`attention_rpos_fwd_mma`,
`_wide`, `attention_rpos_bwd_mma`, `_wide`, their launches those of phase
31's paths)
(with their launches on each of the thirty-three paths: serve, train, serve_rpos,
train_rpos, serve_dense, probes, probes_precision, serve_families,
train_families, train_newrale, serve_newrale, train_augmented,
build_train, baseline_dwt, train_cls, test_cls, serve_transformer1d,
train_transformer1d, serve_transformer1d_dense, train_transformer1d_long,
serve_transformer1d_long, serve_jax_ckpt, train_jax_ckpt, train_dp,
train_dp_rpos, serve_dp, train_tp, train_tp_rpos, serve_tp_ckpt,
eval_tp_dense, serve_transformer1d_wide_dense, serve_transformer1d_wide,
train_transformer1d_wide; B2's entry also holds the DP step's ms under
"data_parallel" and the TP step's under "tensor_parallel"; B1's and B2's
entries also hold their head_dim 32 case under "d32" and its 1,000-sample
case under "d32_long", B5's its head_dim 32 case under "d32" (with its
other head dims), B2's its frozen-bias case),
the card's name and power limit, and `{"ok": true, "device": {...}}`.
Without a card, or outside a checkout of the repository, it exits nonzero
and prints no result.
"""

import contextlib
import copy
import ctypes
import functools
import io
import json
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

STAGES = [(256, 2), (128, 4), (64, 8), (32, 16), (16, 32)]
# Attention calls of one RA-LENet 'full' forward, by (L, H, with bias).
FORWARD_CALLS = {(256, 2, True): 2, (128, 4, True): 4, (64, 8, True): 4,
                 (32, 16, True): 4, (16, 32, False): 4}
# With per-window R peaks (`--r_pos detect`) the 14 biased calls go to the
# r-pos kernels, by (L, W, H): each encoder stage's bias, and the decoder
# stage that reuses it; the 4 bias-free calls at (16, 32) stay on B1.
RPOS_CALLS = {(256, 32, 2): 2, (128, 16, 4): 4, (64, 8, 8): 4, (32, 4, 16): 4}
# With ECG_ATTN_DENSE=1 the no-grad calls at the packable stages go to B5,
# by (L, H, with bias); the 6 calls at L = 256 and 128 stay on B1.
DENSE_CALLS = {(64, 8, True): 4, (32, 16, True): 4, (16, 32, False): 4}
# The stage shapes the dense route takes in RA-LENet (and (64, 4), RA-LENet
# with half the heads), then small ones it admits: L = 2 and 8, 64 heads
# at L = 2, more than one warp's 32, and (8, 6), a pack factor of 6 that
# leaves B5's blocks two elements of 48 rows side by side.
DENSE_SHAPES = [(64, 8), (32, 16), (16, 32), (64, 4), (2, 2), (2, 64), (8, 4), (8, 32), (8, 6)]
HEADS_APART = 110.0  # row maxima of two packed heads at least this far apart
PRECISION_KERNELS = ("probe_dot", "probe_fold", "probe_tree", "probe_div")
KERNELS = ("attention_fwd", "attention_bwd", "attention_rpos_fwd", "attention_rpos_bwd",
           "attention_dense_fwd", "null_copy") + PRECISION_KERNELS
F32_TOL = 1e-5
# bf16, as a fraction of max|v|: the plain version rounds the probabilities
# to bf16 before the pv product and the kernel does not (up to 2^-8 of
# max|v|), and each side rounds its output once to bf16 (up to 2^-8 of
# |out| <= max|v| each).
BF16_TOL_OF_MAX_V = 3 * 2 ** -8
LARGE_LOGIT_TOL = 1e-4  # an f32 logit near 200 carries a rounding of up to 1.5e-5
MODEL_TOL = 1e-4
# StreamingDenoiser against denoise_record on the card: the same windows
# and taper, but batched in other buckets, and cuBLAS and cuDNN pick their
# f32 kernels by shape, so the sums run in other orders; the bar of the
# card's forward against the CPU's.
STREAM_TOL = MODEL_TOL
# Backward, f32: dq, dk, dv to 1e-4 (the JAX package's gradient bar,
# tests/test_pallas_attention.py:125). dbias sums B = 256 float32 terms, in
# order here and by a tree in the plain versions, each with about 1e-6 of
# relative error from its recomputed p: 1e-4 of max|dbias|. With logits
# near 200 each side's logits and lse carry roundings of up to 1.5e-5, so
# p is off by up to ~3e-5 relative: 1e-4 of max|grad|.
GRAD_TOL = 1e-4
DBIAS_TOL_OF_MAX = 1e-4
LARGE_LOGIT_GRAD_TOL_OF_MAX = 1e-4
# bf16, against the flash backward on the same o and lse: both compute in
# f32 and round once to bf16, at most half a bf16 step (2^-8 of |x|) each.
BF16_GRAD_TOL_OF_MAX = 2 ** -7
TRAIN_BATCH = 32  # the CLI's default and the reference's
REPEAT_STEPS = 4  # identical steps compared bit for bit with the first
TIMING_BATCH = 256
EPOCH_WINDOWS = 8000  # the training split of the CLI's default --n_select
EPOCH_REPEATS = 3
# Phases 19-20: the denoiser families without attention, and 12-lead transfer.
FAMILIES = ("unet", "DANet", "ACDAE")
# A family's step on the card (`step_bars`): each tensor's gradients within
# 1e-4 of its largest reference gradient (the kernels' gradient bar,
# relative). The reference is the same step in float64 on the CPU where the
# model computes in float64 (`float64_grads`): a float32 step is a
# different sum wherever a pre-activation within its rounding of 0 takes
# the other branch of a clamp, a ReLU or a max, and the CPU's own float32
# gradients then lie further from exact than the bar (phase 19 logs how
# far). An element whose reference gradient is at most 1e-6 of the largest
# is at the rounding floor, where its parameter is not held: a float32
# gradient that is 0 in exact arithmetic (a bias before a training-mode
# BatchNorm) comes out far below that floor, and above it Adam's first
# step resolves a rounding of up to the floor itself within PARAM_TOL (lr
# eps / g^2 times it, at lr 1e-3 and eps 1e-8).
STEP_GRAD_TOL_OF_MAX = 1e-4
GRAD_FLOOR_OF_MAX = 1e-6
# Adam step on the card against the CPU (the bars of __graft_entry__.py:120-129).
LOSS_RTOL = 1e-5
BN_STATS_TOL = 1e-5
PARAM_TOL = 1e-4
BATCH = 1024  # the serving default max_batch: the shapes the main path runs
# B5's batches: the serving default, then batches that cut across its
# blocks' groups of elements (up to 16 a block, fewer at small B).
DENSE_BATCHES = (BATCH, 3, 1, 17, 37, 1000)
# Phases 21-22: the data path and the DWT baseline. The WFDB fixture the
# data path builds from; the windows of one synthetic record's cache.
MINI_PHYSIONET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                              "mini_physionet")
CACHE_WINDOWS = 2528
AUG_EPOCHS = 3
# The mixer on the card against the CPU at the same offsets: a gather and
# two means over 512 values, summed in other orders.
MIX_RTOL = 1e-6
SNR_TARGETS = (-4.0, 0.0, 4.0)
SNR_DB_TOL = 1e-3
# The DWT on the card against the numpy path (tests/test_dwt.py:101-110),
# at the rows the rates are read at and at a ragged length of 203.
DWT_TOL = 1e-4
DWT_ROWS = (4096, 65536)
DWT_RAGGED_ROWS = 512
DWT_DN_SNR_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): f32 on the CUDA
# cores (the kernel's arithmetic, also for bf16 operands) and HBM3; dense
# TF32 and bf16 on the tensor cores (the precision probes' mma paths).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
# The exps' floor of a softmax (phase 31's bounds): ex2 on the special-function
# units, 16 a clock an SM (NVIDIA's throughput table for compute capability 9.0),
# 132 SMs, at the H100 SXM's 1.98 GHz boost clock.
SFU_EXPS_PER_S = 16 * 132 * 1.98e9
# The precision probes (phase 18): (M, K, N) of the dot, (L, D) of the
# softmax probes and the divide's shape; the probe's own, then ragged ones
# that fit no mma tile.
PRECISION_DOT_SHAPES = [(256, 256, 256), (203, 141, 77), (1, 8, 1), (65, 264, 33)]
# The softmax probes also at shapes that cut across their blocks (8 query
# rows), their row buckets (L <= 64, 256, 1024), their k-steps (8, 16) and
# 16-byte loads (L % 4), and at the largest L and D they take.
PRECISION_SOFTMAX_SHAPES = [(256, 4), (203, 3), (1, 1), (7, 2), (1024, 15), (129, 5)]
PRECISION_DIV_SHAPES = [(8, 256), (203, 77)]
# The probe's dot readings on the card, max|got - exact| / max|exact| and
# the median elementwise relative error, by precision, as the dot's first
# version gave them on an H100 (PERF.md): a redesign of the dot must leave
# them where they were, within 1e-3 relative (they are kept to four digits).
PROBE_DOT_READINGS = {"ieee": (6.554e-07, 2.362e-07), "tf32": (3.578e-04, 2.956e-04),
                      "tf32x3": (2.604e-06, 1.764e-06), "bf16": (2.986e-03, 2.366e-03)}
# The same for the fold, as its first version gave them on an H100
# (max_abs/max|exact| as PERF.md records them; med_rel as that version
# gave them beside its redesign): the redesign keeps each output's
# roundings.
PROBE_FOLD_READINGS = {"ieee": (6.636e-07, 3.058e-07), "tf32": (2.817e-04, 2.175e-04),
                       "tf32x3": (1.942e-06, 9.898e-07), "bf16": (2.121e-03, 1.677e-03)}
PROBE_READING_RTOL = 1e-3
# B1 and B2 at shapes that cut across their row tiles (32 rows), batch
# groups (16 elements, and 32 / L elements side by side in a warp at
# L < 32) and B2's dbias tiles (4 to 32 key columns, stages of 16
# elements): (B, L, H).
RAGGED = [(1, 256, 2), (37, 128, 4), (1000, 64, 8), (3, 203, 2), (37, 203, 1),
             (1000, 7, 3), (1, 7, 2), (3, 1, 2), (1000, 1, 5), (37, 16, 32)]
# B3 and B4 at shapes that cut across B3's and B4's blocks (256 rows at
# even L, 128 at odd L), B4's dtoep stages (16 elements) and lists (512),
# with W cut to fit: (B, L, W, H).
RAGGED_RPOS = [(1, 256, 32, 2), (17, 128, 16, 4), (37, 64, 8, 8), (1000, 32, 4, 16),
               (37, 203, 25, 2), (1000, 7, 3, 3), (17, 1, 1, 2)]
# B1 and B2 at head_dim 32 (phases 2b, 6b, 24): Transformer1d's (L, H) at a
# 256-sample input, the calls of one forward by stage (its depths, 2, 2, 6,
# 2), the training batch (phases 2b and 6b; phase 2b also runs the stages
# at T1D_SERVE_BATCH, the served batch), and a ragged batch and length that
# cut across the template's 64-row tiles and 64-key stages.
D32_STAGES = [(256, 4), (128, 8), (64, 16), (32, 32)]
D32_CALLS = dict(zip(D32_STAGES, (2, 2, 6, 2)))
D32_BATCH = 64
D32_RAGGED = [(3, 203, 2)]
# B1 and B2's mma template at its other head dims (phases 2b and 6b): each
# instantiated D and one it pads (24), at shapes that cut across its 64-row
# tiles and 64-key stages (256, 203, 33) and the heads it packs (L <= 32);
# then D = 4 past the D = 4 kernels' 256 keys (padded to 8): (D, B, L, H).
MMA_D_CASES = [(D, B, L, H) for D in (8, 16, 24, 64)
               for B, L, H in ((4, 256, 2), (3, 203, 2), (5, 33, 3), (7, 16, 5))] + [
    (4, 3, 300, 2)]
# q arrives scaled by head_dim^-1/2, as MSAttention scales it: logits of
# unit spread, as at D = 4. Unscaled (logits up to about 35) the f32
# roundings of the logits reach 1e-5 of the output on both sides: that case
# is held at LARGE_LOGIT_TOL.
D32_Q_SCALE = 32 ** -0.5
# At D = 32 dq, dk and dv sum 32 products a term: f32 gradients to 1e-4
# of their max.
D32_GRAD_TOL_OF_MAX = 1e-4
# Phases 23-24: the classifier and Transformer1d. ResNetCls trains 3 epochs
# (the CLI's default is 20) on phase 21's cls cache; test_cls denoises the
# test split (2 x 512 beats) in batches of 128, 18 B1 calls a batch through
# RA-LENet; Transformer1d (47,478,153 parameters) is served at 256 and
# trains at 64, its step against the CPU's at 4.
CLS_EPOCHS = 3
CLS_TEST_BEATS = 1024
CLS_EVAL_BATCH = 128
T1D_SERVE_BATCH = 256
T1D_TRAIN_BATCH = 64
T1D_CHECK_BATCH = 4
# Phase 25: Transformer1d's lane-packable stages at 256 samples, (L, H),
# with their calls in one forward: B5 at D = 32 takes them with
# ECG_ATTN_DENSE=1 (8 of the 12), B1 the other 4. Its checks at the served
# batch and a ragged one, at those stages and at others (DENSE_OTHER: L =
# 2, 8 and 16, an m-tile of 8, 2 and 1 heads; then groups of 4, 48 and 96
# rows against the 64-row units: one short unit, and two, the second of
# 32 rows),
# at every head dim of B5: 4 (the D = 4 kernel, bit for bit the parent's),
# 8, 16, 32, 64 (the mma template) and 24 (padded to 32). DENSE_TIMED_D:
# the template's other head dims, timed at Transformer1d's first packable
# stage.
T1D_DENSE_CALLS = {(64, 16): 6, (32, 32): 2}
DENSE_D32_BATCHES = (T1D_SERVE_BATCH, 37)
DENSE_OTHER = [(2, 64), (8, 16), (16, 8), (2, 2), (8, 6), (32, 3)]
DENSE_CHECK_DIMS = (4, 8, 16, 24, 32, 64)
DENSE_TIMED_D = (8, 16, 64)
# Phase 26: Transformer1d at its defaults on 10-second records at PTB-XL's
# 100 Hz; its stages run at (L, H) = (1000, 4), (500, 8), (250, 16), (125,
# 32), three of them ragged against the 64-row tiles and 32-key chunks. The
# model's forward is checked against the CPU at batch 4, one step at 2, and
# it is served and its kernels timed at 32. B1 and B2 at D = 32 are held
# against their plain versions at every stage and each of those batches
# (D32_LONG).
T1D_LONG = 1000
T1D_LONG_CALLS = dict(zip([(1000, 4), (500, 8), (250, 16), (125, 32)], (2, 2, 6, 2)))
T1D_LONG_CHECK_BATCH = 4
T1D_LONG_STEP_BATCH = 2
T1D_LONG_SERVE_BATCH = 32
D32_LONG = [(B, L, H) for (L, H) in T1D_LONG_CALLS
            for B in (T1D_LONG_STEP_BATCH, T1D_LONG_CHECK_BATCH, T1D_LONG_SERVE_BATCH)]
# Phase 27: a UNet TrainState the JAX package wrote after one Adam step, and
# JAX's eval output on 8 seeded windows (tests/test_torch_port_msgpack.py).
JAX_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                            "jax_ckpt")
JAX_CKPT = os.path.join(JAX_CKPT_DIR, "unet", "unet_1_bw_intensity-4.msgpack")
JAX_EVAL = os.path.join(JAX_CKPT_DIR, "unet_eval.npz")
# lse against attention_reference's logsumexp: both take the f32 logits;
# the kernel's row sum uses __expf and is summed in another order (1e-6
# relative), and |lse| stays below about 20: 1e-5 of max(1, max|lse|).
LSE_TOL = 1e-5
# Rounds in turns that settle two timings (`settle`): P2 against copy_ and
# the parent's, P1's divide against torch.div and the parent's.
SETTLE_ROUNDS = 20
# P2 against clone(): one value, three, one vector short of the null tile,
# the tile, one over, and a (64, 8) call's q at B = 1024; each also 4 bytes
# past a 16-byte boundary (a view base[1:]).
NULL_COPY_SIZES = (1, 3, 1023, 1024, 1025, BATCH * 8 * 64 * 4)
# Calls a reading replays from one graph where a call sits at the launch
# floor (P1's divide): at 20 the graph's own start, spread over the calls,
# adds 0.3-0.7 us a call, and spreads of 0.3 us and more hide a 0.1 us
# difference; at 200 the spreads fall to 0.05-0.3 us.
LAUNCH_FLOOR_CALLS = 200
# P1's divide at (numerator, denominator) offsets in values from a 16-byte
# boundary: all aligned (16-byte accesses), one operand off, both off alike,
# and 4 values (16 bytes) off.
PRECISION_DIV_OFFSETS = [(0, 0), (1, 0), (0, 3), (2, 2), (4, 0)]
# A timing yardstick: the parent commit's tree, unpacked by `git archive`
# under the git-ignored _archive/ (absent from a plain checkout).
PARENT_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_archive",
                           "parent", "ecg_denoise_tpu_torch", "kernels", "csrc")
# fold and tree against their plain versions: both sides take the card's
# expf on the same f32 logits, and the sums run in other orders.
SOFTMAX_TOL_OF_MAX = 1e-5
# The head dim of SDPA's zero q and k (softmax_pv_sdpa): a multiple of 8,
# which PyTorch's fused attention kernels take.
SDPA_QK_DIM = 8
# The probe's f32-accurate paths (ieee and tf32x3 dot and fold, the tree)
# against float64: the port's kernel bar.
PROBE_F32_TOL_OF_MAX = 1e-5
# Phase 30: B1, B2 and B5 past head_dim 64 (the wide kernels), and
# Transformer1d at its published widths with num_heads (1, 1, 2, 4): its
# attention calls on 256 samples by (L, H, head_dim), with their calls in
# one forward (or one step's backward); with ECG_ATTN_DENSE=1 the last two
# stages' 8 calls pack (P = 2 and 4) and go to B5.
WIDE_HEADS = (1, 1, 2, 4)
WIDE_CALLS = {(256, 1, 128): 2, (128, 1, 256): 2, (64, 2, 256): 6, (32, 4, 256): 2}
WIDE_DENSE_CALLS = {(64, 2, 256): 6, (32, 4, 256): 2}
# The checks' head dims: two padded up (72 to 128, 200 to 256), the model's
# 128 and 256, and 320, 512 and 576: clusters of five and eight blocks, and
# nine 64-wide chunks on a cluster of five blocks, two chunks a block (all
# but the last). B1 and B2 at
# (B, L, H): packed heads (L <= 32), one row tile, four, and 1,000 keys; B5
# at Transformer1d's two packable shapes, L = 8 (P = 16) and a unit of 32
# rows (L = 16, P = 2).
WIDE_DIMS = (72, 128, 200, 256, 320, 512, 576)
WIDE_B12_SHAPES = [(2, 32, 3), (3, 64, 2), (2, 256, 1), (1, 1000, 1)]
WIDE_B5_SHAPES = [(3, 64, 2), (3, 32, 4), (3, 8, 16), (5, 16, 2)]
# Phase 28: data parallelism. Two ranks share the one card over gloo (NCCL
# refuses two ranks on one device); the global batch splits 16 a rank.
DP_WORLD = 2
DP_BATCH = 32
DP_TIMED_STEPS = 10
DP_SERVE_TOL = 1e-5
# Phase 29: tensor parallelism on the grids (n_data, n_model) = (1, 2) and
# JAX's DPxTP test's (2, 2), every rank on the one card over gloo.
TP_GRIDS = ((1, 2), (2, 2))
TP_PATHS = ("train_tp", "train_tp_rpos", "eval_tp_dense")
TP_EVAL_WINDOWS = 40  # two eval batches at DP_BATCH, the last ragged
TP_SERVE_WINDOWS = 64
TP_SERVE_TOL = 1e-5
TP_EVAL_TOL = 1e-5
# Phase 31: B3 and B4 at every head dim and length (their window kernels,
# B1's and B2's wide kernels in their window mode). The layer path, by
# path tag: the per-window
# RelativePositionEmbedding(W, L, H) on detected R peaks, then
# BasicLayer(H * D, depth 2, H) as RA-LENet's stages use it, at (L, W, H,
# D) with RA-LENet's W = L / 8: its first stage with 32-wide heads,
# Transformer1d's published head widths (128 and 256), and D = 4 past 256
# keys (PTB-XL's 10 s at 100 Hz; both window kernels take it unpadded).
# Served at BATCH, trained at
# TIMING_BATCH for RPOS_TRAIN_STEPS Adam steps; each held against the CPU on
# its first RPOS_CHECK_WINDOWS windows (a (B, H, L, L) bias at B = 1,024
# and L = 1,000 would take 8 GB there).
RPOS_LAYERS = {"rpos_d32": (256, 32, 2, 32), "rpos_d128": (256, 32, 1, 128),
               "rpos_d256": (128, 16, 1, 256), "rpos_long": (1000, 125, 2, 4)}
RPOS_LAYER_DEPTH = 2
# The window kernels at the head dims no layer of RPOS_LAYERS reaches,
# timed in turns with the parent's at (L, W, H) = RPOS_CHECKED_SHAPE, B3 at
# BATCH and B4 at TIMING_BATCH (phase 31d): the redesigns may be no slower
# there.
RPOS_CHECKED_DIMS = (8, 16, 64)
RPOS_CHECKED_SHAPE = (256, 32, 2)
RPOS_TRAIN_STEPS = 3
RPOS_CHECK_WINDOWS = 32
RPOS_LR = 1e-3
# The kernel checks, at B = RPOS_CHECK_BATCH: every head dim class at (L, W,
# H) = a row tile of four, a ragged L and packed heads (L <= 32, five heads,
# so that one block holds heads of two batch elements), then D = 4 past the
# D = 4 kernels' 256 keys.
RPOS_CHECK_BATCH = 8
RPOS_ANY_D_CASES = [(D, L, W, H) for D in (8, 16, 32, 64, 128, 256, 320, 576)
                    for (L, W, H) in ((256, 32, 2), (203, 25, 3), (32, 4, 5))] + [
    (4, 300, 37, 2), (4, 1000, 125, 2)]
# Past this head dim the float32 plain versions' own rounding nears the
# f32 gradient bar (at D = 576 the flash form's dq lies 9.5e-05 and
# autograd's 5.6e-05 from float64, the kernel's 2.1e-05, on an H100), so
# B4's f32 gradients are held there to float64 gradients alone, at
# the same bar; below it to those as well as to both float32 versions.
RPOS_F64_ONLY_PAST = 512
# B1 and B2 on their templates and wide kernels against the parent's, bit
# for bit, at every head dim of the template and two of the wide kernel's:
# (D, B, L, H). B3 and B4 on the wide kernels the same way, B4's dq, dk and
# dv from this tree's forward (its dtoep is formed anew), at
# RPOS_PARENT_CASES: (D, B, L, W, H), windows cut at both ends. The window
# kernels (D <= 64; D = 4 past 256 keys on the parent's padded operands)
# are new arithmetic: held there to their bars.
B12_TEMPLATE_PARENT_CASES = [(D, B, L, H) for D in (8, 16, 32, 64, 128, 320)
                             for (B, L, H) in ((3, 203, 2), (5, 32, 3))]
RPOS_PARENT_CASES = [(D, 5, L, W, H) for D in (8, 16, 32, 64, 128, 320)
                     for (L, W, H) in ((203, 25, 3), (32, 4, 5))] + [(4, 3, 300, 37, 2)]
# Phases 30 and 31 time each redesigned kernel against the parent's in
# turns; a pair whose means lie within this share of each other is settled
# (`settle`, SETTLE_CLOSE_ROUNDS rounds) to tell level from slower.
SETTLE_CLOSE = 0.1
SETTLE_CLOSE_ROUNDS = 5


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_launches():
    """Set every kernel's launch count to 0."""
    from ecg_denoise_tpu_torch.kernels import precision
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import fused_attention_dense
    from ecg_denoise_tpu_torch.kernels.attention_rpos import fused_attention_rpos
    from ecg_denoise_tpu_torch.kernels.null_copy import null_copy

    fused_attention.launches = fused_attention.bwd_launches = 0
    fused_attention_rpos.launches = fused_attention_rpos.bwd_launches = 0
    fused_attention_dense.launches = null_copy.launches = 0
    for kernel in PRECISION_KERNELS:
        getattr(precision, kernel).launches = 0


def read_launches():
    """Every kernel's launch count, by kernel name."""
    from ecg_denoise_tpu_torch.kernels import precision
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import fused_attention_dense
    from ecg_denoise_tpu_torch.kernels.attention_rpos import fused_attention_rpos
    from ecg_denoise_tpu_torch.kernels.null_copy import null_copy

    return dict(zip(KERNELS, (fused_attention.launches, fused_attention.bwd_launches,
                              fused_attention_rpos.launches,
                              fused_attention_rpos.bwd_launches,
                              fused_attention_dense.launches, null_copy.launches,
                              *(getattr(precision, k).launches for k in PRECISION_KERNELS))))


def expected_launches(fwd=0, bwd=0, rpos_fwd=0, rpos_bwd=0, dense=0, null=0):
    """The counts of a path that launches no precision probe."""
    return dict(zip(KERNELS, (fwd, bwd, rpos_fwd, rpos_bwd, dense, null, 0, 0, 0, 0)))


@contextlib.contextmanager
def dense_route(on=True):
    """ECG_ATTN_DENSE=1 (or 0) in the environment for the block, as a user
    sets it; the previous value is put back after."""
    saved = os.environ.get("ECG_ATTN_DENSE")
    os.environ["ECG_ATTN_DENSE"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["ECG_ATTN_DENSE"]
        else:
            os.environ["ECG_ATTN_DENSE"] = saved


def smi_name_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def tf32_flags():
    """PyTorch's (matmul, cuDNN) TF32 switches."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` back-to-back runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def operands(B, H, L, with_bias, dtype, gen, D=4, q_scale=1.0):
    """q (times q_scale), k, v and the bias on the card, standard normal."""
    q, k, v = (torch.randn(B, H, L, D, generator=gen) for _ in range(3))
    q = q * q_scale
    bias = torch.randn(1, H, L, L, generator=gen) if with_bias else None
    return [None if t is None else t.to("cuda", dtype)
            for t in (q, k, v, bias)]


def bwd_bound_terms(B, H, L, with_bias, elt, D=4):
    """(operations, bytes) lower bounds in ms for one backward call: the
    JAX cost estimate's flops (attention_pallas.py:774) over the f32 peak,
    and the function's inputs and outputs each moved once over HBM
    bandwidth: q, k, v, g, o, dq, dk, dv in the operand dtype, lse in f32,
    and the bias and dbias. c = sum_d g*o is not counted: it comes from g
    and o, which are."""
    flops = 2 * B * H * (5 * L * L * D + 3 * L * L)
    rows = B * H * L
    nbytes = 8 * rows * D * elt + rows * 4 + (2 * H * L * L * elt if with_bias else 0)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_terms(B, H, L, with_bias, elt, D=4):
    """(operations, bytes) lower bounds in ms for one call: its flops over
    the f32 peak, and q, k, v, o and the bias, each moved once, over HBM
    bandwidth. The call's bound is the larger."""
    flops = 2 * B * H * (2 * L * L * D + L * L)
    nbytes = (4 * B * H * L * D + (H * L * L if with_bias else 0)) * elt
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


@functools.cache
def parent_libs():
    """The parent commit's B1-B5, P1 and P2 libraries, built at once
    (one nvcc each) from its sources under _archive/parent, or None where
    that tree is not there. Timing yardsticks only: nothing on a path calls
    them, and no count moves."""
    if not os.path.isdir(PARENT_CSRC):
        return None
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels.attention import bind

    csrc = Path(PARENT_CSRC)
    libs = {"attention_fwd": ("ecg_attention_fwd", 6, 6),
            "attention_bwd": ("ecg_attention_bwd", 12, 6),
            "attention_rpos_fwd": ("ecg_attention_rpos_fwd", 7, 7),
            "attention_rpos_bwd": ("ecg_attention_rpos_bwd", 14, 7),  # with the ds scratch
            "attention_dense_fwd": ("ecg_attention_dense_fwd", 5, 7),
            "precision_probe": ("ecg_probe_dot", 3, 5),
            "null_copy": ("ecg_null_copy", 2, 2)}
    with ThreadPoolExecutor(len(libs)) as pool:
        futures = {name: pool.submit(bind, name, *sig, csrc=csrc) for name, sig in libs.items()}
        built = {name: future.result() for name, future in futures.items()}
    dtoep_sum = built["attention_rpos_bwd"].ecg_attention_rpos_dtoep_sum  # as _bwd_library
    dtoep_sum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dtoep_sum.restype = ctypes.c_int
    bind("precision_probe", "ecg_probe_fold", 3, 4, csrc=csrc)  # L, D, precision, device
    bind("precision_probe", "ecg_probe_tree", 3, 3, csrc=csrc)  # L, D, device
    bind("precision_probe", "ecg_probe_div", 3, 2, csrc=csrc)  # count, device
    return built


def parent_b1(q, k, v, bias):
    """The parent's B1 on the same operands (no lse)."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on

    lib = parent_libs()["attention_fwd"]
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    err = lib.ecg_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o), None, B, H, L, D,
                                DTYPE_CODES[q.dtype], q.device.index,
                                torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's attention forward")
    return o


def b2_call(lib, q, k, v, bias, o, lse, g, want_dbias):
    """One B2 library's kernels on the same operands, allocated as
    `_launch_bwd` allocates: (dq, dk, dv, dbias), dbias float32 (not cast
    to the bias dtype) and None unless asked. No count moves."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on

    B, H, L, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    c = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    dbias = (torch.empty(1, H, L, L, dtype=torch.float32, device=q.device)
             if want_dbias and bias is not None else None)
    err = lib.ecg_attention_bwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(g), ptr(o), ptr(lse),
                                ptr(c), ptr(dq), ptr(dk), ptr(dv), ptr(dbias), B, H, L, D,
                                DTYPE_CODES[q.dtype], q.device.index,
                                torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "attention backward (yardstick call)")
    return dq, dk, dv, dbias


def parent_b2(*args):
    """The parent's B2 on the same operands (`b2_call`'s arguments)."""
    return b2_call(parent_libs()["attention_bwd"], *args)


def parent_dot(a, b, precision):
    """The parent's P1 dot on the same operands."""
    from ecg_denoise_tpu_torch.kernels.attention import ptr, raise_on
    from ecg_denoise_tpu_torch.kernels.precision import PRECISIONS

    lib = parent_libs()["precision_probe"]
    (M, K), N = a.shape, b.shape[1]
    c = torch.empty(M, N, device=a.device)
    err = lib.ecg_probe_dot(ptr(a), ptr(b), ptr(c), M, N, K, PRECISIONS.index(precision),
                            a.device.index, torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's precision probe dot")
    return c


def parent_fold(logits, v, precision):
    """The parent's P1 fold on the same operands."""
    from ecg_denoise_tpu_torch.kernels.attention import ptr, raise_on
    from ecg_denoise_tpu_torch.kernels.precision import PRECISIONS

    lib = parent_libs()["precision_probe"]
    D, L = v.shape
    o = torch.empty(D, L, device=v.device)
    err = lib.ecg_probe_fold(ptr(logits), ptr(v), ptr(o), L, D, PRECISIONS.index(precision),
                             v.device.index, torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's precision probe fold")
    return o


def parent_tree(logits, v):
    """The parent's P1 tree on the same operands."""
    from ecg_denoise_tpu_torch.kernels.attention import ptr, raise_on

    lib = parent_libs()["precision_probe"]
    D, L = v.shape
    o = torch.empty(D, L, device=v.device)
    err = lib.ecg_probe_tree(ptr(logits), ptr(v), ptr(o), L, D, v.device.index,
                             torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's precision probe tree")
    return o


def parent_div(n, d):
    """The parent's P1 divide on the same operands."""
    from ecg_denoise_tpu_torch.kernels.attention import ptr, raise_on

    lib = parent_libs()["precision_probe"]
    o = torch.empty_like(n)
    err = lib.ecg_probe_div(ptr(n), ptr(d), ptr(o), n.numel(), n.device.index,
                            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's precision probe divide")
    return o


def parent_null_copy(x):
    """The parent's P2 on the same operand."""
    from ecg_denoise_tpu_torch.kernels.attention import ptr, raise_on

    lib = parent_libs()["null_copy"]
    o = torch.empty_like(x)
    err = lib.ecg_null_copy(ptr(x), ptr(o), x.numel(), x.device.index,
                            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "the parent's null copy")
    return o


def softmax_pv_sdpa(logits, v):
    """A function computing (D, L) softmax(logits) . v^T by one PyTorch
    call, the fold's and the tree's library yardstick:
    scaled_dot_product_attention with zero q and k (so q . k^T = 0), the
    (L, L) logits as its additive mask and v^T, laid out once as the call
    takes it, as its values. The port never calls it."""
    D, L = v.shape
    z = torch.zeros(1, 1, L, SDPA_QK_DIM, device=v.device)
    vt = v.T.contiguous()[None, None]
    return lambda: F.scaled_dot_product_attention(z, z, vt, attn_mask=logits)[0, 0].T


def b3_call(lib, q, k, v, toep, W, offsets, with_lse=True):
    """One B3 library's kernel on the same operands: (o, lse), lse float32
    or None. No count moves."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on

    B, H, L, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device) if with_lse else None
    err = lib.ecg_attention_rpos_fwd(ptr(q), ptr(k), ptr(v), ptr(toep), ptr(offsets), ptr(o),
                                     ptr(lse), B, H, L, D, W, DTYPE_CODES[q.dtype],
                                     q.device.index, torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "attention r-pos forward (yardstick call)")
    return o, lse


def b5_call(lib, q, k, v, bias):
    """One B5 library's kernel on the same operands, at the route's pack
    factor. No count moves."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on
    from ecg_denoise_tpu_torch.kernels.attention_dense import dense_pack_factor

    B, H, L, D = q.shape
    o = torch.empty_like(q)
    err = lib.ecg_attention_dense_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o), B, H, L, D,
                                      dense_pack_factor(H, L), DTYPE_CODES[q.dtype],
                                      q.device.index, torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "dense attention forward (yardstick call)")
    return o


def b4_call(lib, q, k, v, toep, W, offsets, o, lse, g):
    """One B4 library's kernels on the same operands, allocated as
    `attention_rpos._launch_bwd_kernel` allocates: (dq, dk, dv, dtoep),
    dtoep float32 (not cast to toep's dtype). Past the D = 4 kernel (L <=
    256) the dq pass fills the ds scratch and the library's second kernel
    sums it into dtoep (this tree's and the parent's alike). No count
    moves."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, MAX_LEN, ptr, raise_on

    B, H, L, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    c = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    dtoep = torch.empty(1, H, L, L, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    ds = (torch.empty(B, H, min(W, L), min(W, L), dtype=torch.float32, device=q.device)
          if not (D == 4 and L <= MAX_LEN) else None)
    ptrs = [q, k, v, toep, offsets, g, o, lse, c, dq, dk, dv, dtoep, ds]
    err = lib.ecg_attention_rpos_bwd(*map(ptr, ptrs), B, H, L, D, W, DTYPE_CODES[q.dtype],
                                     q.device.index, stream)
    raise_on(lib, err, "attention r-pos backward (yardstick call)")
    if ds is not None:
        err = lib.ecg_attention_rpos_dtoep_sum(ptr(ds), ptr(offsets), ptr(dtoep), B, H, L, W,
                                               q.device.index, stream)
        raise_on(lib, err, "attention r-pos dtoep sum (yardstick call)")
    return dq, dk, dv, dtoep


def turns(fns, calls=20):
    """µs per call of each function from CUDA graph replays, in turns (in
    order, then in reverse): the two readings of each."""
    from ecg_denoise_tpu_torch.probes.floor import graph_us

    got = [[] for _ in fns]
    for i in [*range(len(fns)), *reversed(range(len(fns)))]:
        got[i].append(graph_us(fns[i], calls))
    return got


def in_turns(first, second, calls=20):
    """`turns` of two functions (first, second, second, first)."""
    return tuple(turns((first, second), calls))


def settle_verdict(first_us, second_us):
    """The first of two functions against the second from their readings
    (µs per call): their medians and spreads (max - min), the gap of the
    medians, and the verdict: level where the gap is inside both spreads,
    slower or faster where it is beyond both, else unsettled."""
    med = [statistics.median(first_us), statistics.median(second_us)]
    spread = [max(first_us) - min(first_us), max(second_us) - min(second_us)]
    gap = med[0] - med[1]
    verdict = ("level" if abs(gap) <= min(spread) else
               "slower" if gap > max(spread) else
               "faster" if -gap > max(spread) else "unsettled")
    return {"median_us": med, "min_us": [min(first_us), min(second_us)],
            "max_us": [max(first_us), max(second_us)], "spread_us": spread, "gap_us": gap,
            "verdict": verdict}


def settle(first, second, reading, rounds=SETTLE_ROUNDS):
    """Two (name, fn) settled over `rounds` rounds in turns (first, second,
    second, first), each reading `reading(fn)` µs per call: settle_verdict
    of the first against the second, with the names and the rounds."""
    runs = {0: [], 1: []}
    for _ in range(rounds):
        for i in (0, 1, 1, 0):
            runs[i].append(reading((first, second)[i][1]))
    return {"names": [first[0], second[0]], "rounds": rounds,
            **settle_verdict(runs[0], runs[1])}


def against_parent(this, parent, calls=10):
    """This kernel's and the parent's ms per call from CUDA graph replays in
    turns (parent, this, this, parent; means of the two readings each) and,
    where the two lie within SETTLE_CLOSE of each other, `settle`'s verdict
    over SETTLE_CLOSE_ROUNDS rounds (this against the parent); else the
    verdict the turns give (faster or slower)."""
    from ecg_denoise_tpu_torch.probes.floor import graph_us

    parent_us, this_us = in_turns(parent, this, calls)
    ms, parent_ms = statistics.mean(this_us) / 1e3, statistics.mean(parent_us) / 1e3
    if abs(ms - parent_ms) <= SETTLE_CLOSE * parent_ms:
        verdict = settle(("this", this), ("parent", parent), lambda fn: graph_us(fn, calls),
                         rounds=SETTLE_CLOSE_ROUNDS)["verdict"]
    else:
        verdict = "faster" if ms < parent_ms else "slower"
    return ms, parent_ms, verdict


def settled_text(got, what):
    """One log line's worth of a `settle` result."""
    names = got["names"]
    return (f"{names[0]} against {names[1]} {what} over {got['rounds']} rounds in turns, "
            f"{2 * got['rounds']} readings each: " + "; ".join(
                f"{names[i]} median {got['median_us'][i]:.3f} us, min {got['min_us'][i]:.3f}, "
                f"max {got['max_us'][i]:.3f}, spread {got['spread_us'][i]:.3f}"
                for i in (0, 1))
            + f"; gap {got['gap_us']:.3f} us: {got['verdict']} (level: the gap inside both "
              "spreads; slower or faster: beyond both)")


def phase_device_and_build():
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name}; nvidia-smi name, power.limit: {smi_name_power()}")
    from ecg_denoise_tpu_torch.kernels import (
        attention,
        attention_dense,
        attention_rpos,
        null_copy,
        precision,
    )

    if os.environ.pop("ECG_ATTN_DENSE", None) is not None:
        log("[1] ECG_ATTN_DENSE cleared: phases 1-13 drive the default route")
    t0 = time.perf_counter()
    # nvcc from the checkout's sources, one process per kernel, all at once;
    # ptxas reports
    loads = (attention._library, attention._bwd_library,
             attention_rpos._library, attention_rpos._bwd_library,
             attention_dense._library, null_copy._library, precision._library)
    if os.path.isdir(PARENT_CSRC):
        loads += (parent_libs,)
    with ThreadPoolExecutor(len(loads)) as pool:
        for future in [pool.submit(load) for load in loads]:
            future.result()
    log(f"[1] {len(loads)} kernel sources built and loaded in {time.perf_counter() - t0:.1f} s"
        + ("" if parent_libs() is None else " (the last: the parent's B1-B5, P1 and P2, built "
           f"from {PARENT_CSRC}, yardsticks)"))
    return name


def phase_kernel_vs_plain():
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention import (
        attention_reference,
        fused_attention,
    )

    # The plain version's float32 matmuls in full float32 for this phase
    # only: phase 3 checks that the package's entry points set it.
    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(0)
    max_err = {4: 0.0, 32: 0.0}  # f32, by head dim (others added as met)
    cases = [(BATCH, L, H, b, dt, 4, 1.0) for (L, H) in STAGES
             for b in (True, False) for dt in (torch.float32, torch.bfloat16)]
    cases += [(3, L, H, True, torch.float32, 4, 1.0) for (L, H) in STAGES]
    cases += [(B, L, H, b, dt, 4, 1.0) for (B, L, H) in RAGGED
              for b in (True, False) for dt in (torch.float32, torch.bfloat16)]
    # Phase 2b: head_dim 32 at Transformer1d's served batch, then d32_cases.
    cases += [(T1D_SERVE_BATCH, L, H, b, dt, 32, D32_Q_SCALE) for (L, H) in D32_STAGES
              for b in (True, False) for dt in (torch.float32, torch.bfloat16)]
    cases += d32_cases()
    for B, L, H, with_bias, dtype, D, q_scale in cases:
        q, k, v, bias = operands(B, H, L, with_bias, dtype, gen, D=D, q_scale=q_scale)
        out = fused_attention(q, k, v, bias)
        again, lse = attention._launch(q, k, v, bias, with_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = attention_reference(q, k, v, bias, return_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        lse_tol = LSE_TOL * max(1.0, ref_lse.abs().max().item())
        same = torch.equal(out, again)
        wide = D == 32 and q_scale == 1.0  # unscaled q: logits up to about 35
        tol = (BF16_TOL_OF_MAX_V * v.float().abs().max().item() if dtype == torch.bfloat16
               else LARGE_LOGIT_TOL if wide else F32_TOL)
        parent = ""
        if not on_mma(D, L) and parent_libs():
            # The D = 4 kernel is unchanged beside the mma template.
            as_parent = torch.equal(out, parent_b1(q, k, v, bias))
            parent = f"; bit-identical to the parent's B1: {as_parent}"
            check(as_parent, "B1 at D = 4 is not the parent's B1 bit for bit")
        shape = (f"[2b] D={D} B={B}" if on_mma(D, L) else
                 f"[2] B={B}") + f" L={L} H={H} bias={with_bias} {str(dtype)[6:]}"
        if on_mma(D, L):
            shape += f" q {'unscaled' if q_scale == 1.0 else 'scaled'}"
        log(f"{shape}: max_abs_err={err:.3e} (tol {tol:.3e}), lse {lse_err:.3e} (tol "
            f"{lse_tol:.3e}); a second call, with lse, bit-identical: {same}{parent}")
        check(out.shape == q.shape and out.dtype == dtype, "kernel output shape or dtype")
        check(err <= tol, f"B1 at D = {D} disagrees with its plain version")
        check(lse.shape == q.shape[:3] and lse_err <= lse_tol,
              f"B1's lse at D = {D} disagrees with the plain version's")
        check(same, "two forward calls differ")
        if dtype == torch.float32 and not wide:
            max_err[D] = max(max_err.get(D, 0.0), err)
    if not parent_libs():
        log("[2] the parent's B1 not compared (no tree under _archive/parent)")
    # Trained logits reach 191.5 at the L=16 stage: without the row max,
    # exp(190) overflows float32.
    q, k, v, bias = operands(BATCH, 32, 16, True, torch.float32, gen)
    bias = bias + 190.0
    peak = (torch.einsum("bhld,bhmd->bhlm", q, k) + bias).max().item()
    out = fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    err = (out - attention_reference(q, k, v, bias)).abs().max().item()
    log(f"[2] large logits (max {peak:.1f}) L=16 H=32: max_abs_err={err:.3e} "
        f"(tol {LARGE_LOGIT_TOL:.0e})")
    check(peak > 180 and bool(torch.isfinite(out).all()) and err <= LARGE_LOGIT_TOL,
          "kernel fails at large logits")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return max_err


def seeded_model(seed, name="ralenet"):
    """Model `name` on the CPU from a seed, with random nonzero BN affine
    parameters and running stats in every BatchNorm and, where it has them,
    random rel-pos tables."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    gen = random_seed(seed)
    return seed_module(build_model(name, device="cpu").eval(), gen)


def seed_module(model, gen):
    """`model` with random nonzero BN affine parameters and running stats
    in every BatchNorm and random rel-pos tables, drawn from `gen`."""
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "relative_position_bias_table" in pname:
                p.copy_(torch.randn(p.shape, generator=gen))
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return model


def _post(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    with urllib.request.urlopen(urllib.request.Request(url, buf.getvalue()),
                                timeout=300) as r:
        return np.load(io.BytesIO(r.read())), json.loads(
            r.headers.get("X-Denoise-Timing", "{}"))


def _timed(fn, *args):
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def device_kernels(prof, iters):
    """(ms per iteration, launches per iteration, name) of every device
    kernel in a torch.profiler run, longest first; user annotations (such
    as the optimizer's step range) are spans, not kernels, and are left out."""
    return sorted(((e.self_device_time_total / 1e3 / iters, e.count // iters, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation), reverse=True)


def profile_forward(forward, what, fwd_ms, card, iters=3, tag="5"):
    """Device time of one forward by kernel name (torch.profiler), and the
    card's busy share of the unprofiled forward time `fwd_ms`."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
    kernels = device_kernels(prof, iters)
    if not kernels:
        log(f"[{tag}] the profiler recorded no device kernels: breakdown not measured")
        return
    busy = sum(k[0] for k in kernels)
    log(f"[{tag}] {card}: profiled {what} (torch.profiler, "
        f"mean of {iters}): {sum(k[1] for k in kernels)} launches of "
        f"{len(kernels)} kernels, device busy {busy:.3f} ms of the unprofiled "
        f"{fwd_ms:.3f} ms forward (idle {100 * (1 - busy / fwd_ms):.1f} %)")
    for ms, n, name in kernels[:15]:
        log(f"[{tag}]   {ms:8.3f} ms {100 * ms / busy:5.1f} % x{n:<4d} {name[:100]}")


def profile_fresh_thread(denoiser, x, card):
    """Where a call from a fresh thread spends its host time: the operators
    by self CPU time (torch.profiler), for a call on this thread and one on
    a new thread."""
    from torch.profiler import ProfilerActivity, profile

    def run(into):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            into["ms"] = _timed(denoiser, x) * 1e3
        into["ops"] = sorted(prof.key_averages(), reverse=True,
                             key=lambda e: e.self_cpu_time_total)
    here, fresh = {}, {}
    run(here)
    thread = threading.Thread(target=run, args=(fresh,))
    thread.start()
    thread.join()
    for where, got in (("this thread", here), ("a new thread", fresh)):
        total = sum(e.self_cpu_time_total for e in got["ops"]) / 1e3
        log(f"[5] {card}: profiled 37-window call on {where}: {got['ms']:.3f} ms, "
            f"operators' self CPU time {total:.3f} ms; the top 6:")
        for e in got["ops"][:6]:
            log(f"[5]   {e.self_cpu_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:80]}")


def phase_times(gpu_model, cpu_model, card):
    from ecg_denoise_tpu_torch.kernels.attention import (
        attention_reference,
        fused_attention,
    )
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.probes.floor import graph_us
    from ecg_denoise_tpu_torch.serving import Denoiser

    bf16_model = build_model("ralenet", dtype=torch.bfloat16).eval()
    bf16_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(3)
    for dtype, model in ((torch.float32, gpu_model), (torch.bfloat16, bf16_model)):
        denoiser = Denoiser(model, max_batch=2048)
        for batch in (1024, 2048):
            x = rng.standard_normal((batch, 2, 256)).astype(np.float32)
            y = denoiser(x)
            check(np.isfinite(y).all(), "non-finite Denoiser output")
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                denoiser(x)  # ends in torch.cuda.synchronize
                walls.append(time.perf_counter() - t0)
            xd = torch.from_numpy(x).cuda()
            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: model(xd), 10)
            med = statistics.median(walls)
            log(f"[5] {card}: Denoiser {str(dtype)[6:]} batch {batch}: "
                f"{batch / med:.1f} windows/s (median of 10 calls, host clock, "
                f"min {batch / max(walls):.1f} max {batch / min(walls):.1f}); "
                f"device-resident forward {fwd_ms:.3f} ms = "
                f"{batch / fwd_ms * 1e3:.1f} windows/s (CUDA events, mean of 10)")
            if batch == BATCH:
                profile_forward(lambda: model(xd), f"{str(dtype)[6:]} forward B={batch}",
                                fwd_ms, card)

    # The HTTP front end calls Denoiser from a new thread per connection:
    # the same request timed on this thread and on fresh threads.
    denoiser = Denoiser(gpu_model, max_batch=BATCH)
    x = rng.standard_normal((37, 2, 256)).astype(np.float32)
    denoiser(x)
    walls = {"this thread": [], "a new thread each": []}
    for _ in range(5):
        walls["this thread"].append(_timed(denoiser, x))
        thread = threading.Thread(target=lambda: walls["a new thread each"].append(
            _timed(denoiser, x)))
        thread.start()
        thread.join()
    log(f"[5] {card}: Denoiser float32, 37 windows (bucket 64), median of 5 "
        f"calls, host clock: " + ", ".join(
            f"{k} {statistics.median(v) * 1e3:.3f} ms" for k, v in walls.items()))
    profile_fresh_thread(denoiser, x, card)

    gen = torch.Generator().manual_seed(4)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "eager_ms": 0.0, "parent_ms": 0.0 if parent_libs() else None}
    limits = {"operations": 0.0, "bytes": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for (L, H, with_bias), calls in FORWARD_CALLS.items():
            q, k, v, bias = operands(BATCH, H, L, with_bias, dtype, gen)

            def b1():
                return fused_attention(q, k, v, bias)

            # The card's time: 20 calls replayed from one CUDA graph, in turns
            # with the parent's B1 on the same operands where its tree is there.
            if parent_libs():
                old, new = in_turns(lambda: parent_b1(q, k, v, bias), b1)
                ms, parent = statistics.mean(new) / 1e3, statistics.mean(old) / 1e3
                same = torch.equal(b1(), parent_b1(q, k, v, bias))
                turns = (f", the parent's B1 {parent:.4f} ms (graph replays in turns, "
                         f"parent {old[0]:.1f} / {old[1]:.1f} us, this {new[0]:.1f} / "
                         f"{new[1]:.1f} us; outputs bit-identical: {same})")
            else:
                ms, parent = graph_us(b1, 20) / 1e3, None
                turns = ", the parent's B1 not measured (no tree under _archive/parent)"
            eager = cuda_ms(b1, 20)
            plain = cuda_ms(lambda: attention_reference(q, k, v, bias), 5)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=1.0), 20)
            t_ops, t_bytes = bound_terms(BATCH, H, L, with_bias, q.element_size())
            bnd = max(t_ops, t_bytes)
            # What the bias costs: the same operands without the bias.
            no_bias = (f", kernel without the bias {graph_us(lambda: fused_attention(q, k, v), 20) / 1e3:.4f} ms"
                       if with_bias else "")
            log(f"[5] {card}: attention_fwd {str(dtype)[6:]} B={BATCH} L={L} "
                f"H={H} bias={with_bias}: kernel {ms:.4f} ms (graph replays; issued "
                f"from Python {eager:.4f} ms), bound {bnd:.4f} ms "
                f"(operations {t_ops:.4f} at the f32 CUDA-core peak, bytes "
                f"{t_bytes:.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms"
                f"{no_bias}{turns}; {calls} calls per forward")
            if dtype == torch.float32 and calls:
                for key, t in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                               ("library_ms", lib), ("eager_ms", eager), ("parent_ms", parent)):
                    if totals[key] is not None:
                        totals[key] += calls * t
                limits["operations"] += calls * t_ops
                limits["bytes"] += calls * t_bytes
    by = max(limits, key=limits.get)
    parent = ("not measured" if totals["parent_ms"] is None
              else f"{totals['parent_ms']:.4f} ms")
    log(f"[5] {card}: attention_fwd float32, one forward's 18 calls at "
        f"B={BATCH}: kernel {totals['ms']:.4f} ms (graph replays; issued from Python "
        f"{totals['eager_ms']:.4f} ms), the parent's B1 {parent}, bound "
        f"{totals['bound_ms']:.4f} ms ({by}), plain {totals['plain_ms']:.4f} ms, sdpa "
        f"{totals['library_ms']:.4f} ms")
    return totals, by


def kernel_grads(q, k, v, bias, g):
    """fused_attention's gradients on the card through its autograd
    Function, for q, k, v and (if given) the bias; and the output."""
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention

    ins = [t.detach().requires_grad_() for t in (q, k, v, bias) if t is not None]
    out = fused_attention(*ins[:3], ins[3] if bias is not None else None)
    return out.detach(), torch.autograd.grad(out, ins, g)


def plain_autograd_grads(q, k, v, bias, g):
    from ecg_denoise_tpu_torch.kernels.attention import attention_reference

    ins = [t.detach().requires_grad_() for t in (q, k, v, bias) if t is not None]
    out = attention_reference(*ins[:3], ins[3] if bias is not None else None)
    return torch.autograd.grad(out, ins, g)


def phase_backward_vs_plain():
    """The backward kernel, through the autograd Function, against the
    plain flash backward on the forward kernel's own o and lse and, in
    float32, against autograd through the plain forward; a second call
    bit-identical; and, where its tree is there, bit-identical to the
    parent's B2 on the same o, lse and g."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention

    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(5)
    max_err = {4: 0.0, 32: 0.0}
    cases = [(TIMING_BATCH, L, H, b, dt, 0.0, 4, 1.0) for (L, H) in STAGES
             for b in (True, False) for dt in (torch.float32, torch.bfloat16)]
    cases += [(3, L, H, True, torch.float32, 0.0, 4, 1.0) for (L, H) in STAGES]
    cases += [(B, L, H, b, dt, 0.0, 4, 1.0) for (B, L, H) in RAGGED
              for b in (True, False) for dt in (torch.float32, torch.bfloat16)]
    # Trained logits reach 191.5 at the L=16 stage: every stage shape with
    # its logits shifted by +190 through the bias.
    cases += [(TIMING_BATCH, L, H, True, dt, 190.0, 4, 1.0) for (L, H) in STAGES
              for dt in (torch.float32, torch.bfloat16)]
    # Phase 6b: head_dim 32 at the training batch.
    cases += [(B, L, H, b, dt, 0.0, 32, q_scale)
              for B, L, H, b, dt, _, q_scale in d32_cases()]
    for B, L, H, with_bias, dtype, shift, D, q_scale in cases:
        q, k, v, bias = operands(B, H, L, with_bias, dtype, gen, D=D, q_scale=q_scale)
        if shift:
            bias = bias + shift
        wide = D == 32 and q_scale == 1.0
        g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
        out, grads = kernel_grads(q, k, v, bias, g)
        _, lse = attention._launch(q, k, v, bias, with_lse=True)
        refs = {"flash": attention.attention_backward_reference(
            q, k, v, bias, out, lse, g)}
        if dtype == torch.float32:
            refs["autograd"] = plain_autograd_grads(q, k, v, bias, g)
        torch.cuda.synchronize()
        check([t.dtype for t in grads] == [dtype] * len(grads)
              and [t.shape for t in grads] == [q.shape] * 3 + ([bias.shape] if with_bias else []),
              "backward output shape or dtype")
        check(all(bool(torch.isfinite(t).all()) for t in grads), "non-finite gradient")
        errs = []
        for ref_name, ref in refs.items():
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, ref):
                scale = b.float().abs().max().item()
                if L == 1 and name != "dv":
                    # A softmax over one key is constant: the exact dq, dk
                    # and dbias are 0 and both sides return the rounding of
                    # the cancelled g.v - g.o, so their bars are taken of
                    # max|dv| (= max|g|), the one gradient that does not vanish.
                    scale = ref[2].float().abs().max().item()
                err = (a.float() - b.float()).abs().max().item()
                if dtype == torch.bfloat16:
                    tol = BF16_GRAD_TOL_OF_MAX * scale
                elif shift:
                    tol = LARGE_LOGIT_GRAD_TOL_OF_MAX * scale
                elif on_mma(D, L):
                    tol = D32_GRAD_TOL_OF_MAX * scale
                else:
                    tol = DBIAS_TOL_OF_MAX * scale if name == "dbias" else GRAD_TOL
                errs.append(f"{name} vs {ref_name} {err:.2e}/{tol:.2e}")
                check(err <= tol, f"B2 at D = {D}: {name} disagrees with the "
                                  f"plain {ref_name} backward")
                if dtype == torch.float32 and ref_name == "flash" and not (shift or wide):
                    max_err[D] = max(max_err.get(D, 0.0), err)
        _, again = kernel_grads(q, k, v, bias, g)
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        parent = ""
        if not on_mma(D, L) and parent_libs():
            # The raw kernels' outputs, dbias in float32 before any cast.
            args = (q, k, v, bias, out, lse, g, with_bias)
            new, old = b2_call(attention._bwd_library(), *args), parent_b2(*args)
            equal = [name for name, a, b in zip(("dq", "dk", "dv", "dbias"), new, old)
                     if a is not None and torch.equal(a, b)]
            parent = f"; bit-identical to the parent's B2: {', '.join(equal) or 'none'}"
            check(len(equal) == 3 + with_bias, "B2 is not the parent's B2 bit for bit")
        shape = (f"[6b] D={D} B={B}" if on_mma(D, L) else
                 f"[6] B={B}") + f" L={L} H={H} bias={with_bias} {str(dtype)[6:]}"
        if on_mma(D, L):
            shape += f" q {'unscaled' if q_scale == 1.0 else 'scaled'}"
        log(f"{shape}{f' logits+{shift:.0f}' if shift else ''}: " + ", ".join(errs)
            + f"; a second call bit-identical: {same}{parent}")
        check(same, "two backward calls differ")
    if not parent_libs():
        log("[6] the parent's B2 not compared (no tree under _archive/parent)")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return max_err


def state_max_diff(model, ref_sd):
    """Max |difference| of parameters and of BN running stats against a
    CPU state_dict."""
    params = stats = 0.0
    for key, val in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        d = (val.float().cpu() - ref_sd[key].float()).abs().max().item()
        if key.endswith(("running_mean", "running_var")):
            stats = max(stats, d)
        else:
            params = max(params, d)
    return params, stats


def phase_train_step(cpu_model):
    """One Adam step of RA-LENet 'full' (float32, batch 32) on the card
    against the same step on the CPU, with 18 + 18 kernel launches."""
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.train import create_train_state, train_step

    rng = np.random.default_rng(6)
    noisy, clean = (torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, 2, 256)).astype(np.float32)) for _ in range(2))
    cpu_state = create_train_state(copy.deepcopy(cpu_model), device="cpu")
    gpu_states = []
    for _ in range(1 + REPEAT_STEPS):
        model = build_model("ralenet")
        model.load_state_dict(cpu_model.state_dict())
        gpu_states.append(create_train_state(model))
    fused_attention.launches = fused_attention.bwd_launches = 0
    loss = train_step(gpu_states[0], noisy.cuda(), clean.cuda())[0].item()
    torch.cuda.synchronize()
    launches = (fused_attention.launches, fused_attention.bwd_launches)
    first = gpu_states[0].model.state_dict()
    differ = {}  # state tensor -> in how many of the repeated steps it differs
    for state in gpu_states[1:]:
        train_step(state, noisy.cuda(), clean.cuda())
        for key, val in state.model.state_dict().items():
            if not torch.equal(val, first[key]):
                differ[key] = differ.get(key, 0) + 1
    ref = train_step(cpu_state, noisy, clean)[0].item()
    params, stats = state_max_diff(gpu_states[0].model, cpu_state.model.state_dict())
    log(f"[7] RaleNet 'full' depth 2, float32, batch {TRAIN_BATCH}: one Adam step "
        f"on the card vs the CPU: loss {loss:.7f} vs {ref:.7f} (rel "
        f"{abs(loss - ref) / abs(ref):.2e}, tol {LOSS_RTOL:.0e}), BN stats max diff "
        f"{stats:.2e} (tol {BN_STATS_TOL:.0e}), params max diff {params:.2e} "
        f"(tol {PARAM_TOL:.0e}); launches forward {launches[0]}, backward "
        f"{launches[1]}")
    log(f"[7] {REPEAT_STEPS} more identical steps on the card against the first: "
        f"{len(differ)} of {len(first)} state tensors differ in some bit, "
        f"{{tensor: steps that differ}} = {differ}")
    check(launches == (18, 18), "the training step did not make 18 forward and "
                                "18 backward kernel launches")
    check(abs(loss - ref) <= LOSS_RTOL * abs(ref) and stats <= BN_STATS_TOL
          and params <= PARAM_TOL, "the card's training step disagrees with the CPU's")


def write_dict_data(path, n, seed, channels=2):
    """A small dict_data cache: clean windows in ecg.npy, the 'bw' noise
    at -4 dB in m4/bw.npy, each (n, channels, 256) float32 (12 channels:
    the 12-lead ExternalData layout)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6 * np.pi, 256)
    clean = np.sin(t + rng.uniform(0, 6, (n, channels, 1))).astype(np.float32)
    noisy = (clean + 0.5 * rng.standard_normal(clean.shape)
             + np.linspace(-1, 1, 256) * rng.standard_normal((n, channels, 1))
             ).astype(np.float32)
    os.makedirs(os.path.join(path, "m4"))
    np.save(os.path.join(path, "ecg.npy"), clean)
    np.save(os.path.join(path, "m4", "bw.npy"), noisy)


def mse_of(denoiser, noisy, clean):
    return float(np.mean((denoiser(noisy) - clean) ** 2))


def run_module(module, argv, tag, out=None):
    """`python -m module argv`, run in this process through runpy (so the
    launch counts stay readable) and synchronised; its wall seconds on the
    host clock. `out`: a stream that takes the module's standard output."""
    log(f"[{tag}] python -m {module} {' '.join(argv)}")
    saved = sys.argv
    sys.argv = [module, *argv]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out) if out else contextlib.nullcontext():
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
    finally:
        sys.argv = saved
    return time.perf_counter() - t0


def phase_train_cli(card, r_pos=None, tag="7b", name="ralenet", keep=None, data=None):
    """The training main path: the port's CLI, as a user runs it (with
    `--r_pos detect` when r_pos is "detect"), training model `name` (UNet
    with no --model_index, the CLI's default). `keep`: a path to copy the
    checkpoint to; `data`: the dict_data cache to train on (default: a small
    one written by `write_dict_data`)."""
    from ecg_denoise_tpu_torch import MODEL_NAMES
    from ecg_denoise_tpu_torch.data.dataset import load_split_arrays
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.serving import Denoiser
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    # Ten epochs: the CLI checkpoints every 10th. 512 training windows an
    # epoch (16 steps) keep the test loss falling well clear of its start.
    epochs, n_select, seed = 10, 640, 2023
    with tempfile.TemporaryDirectory() as tmp:
        if data is None:
            data = os.path.join(tmp, "dict_data")
            write_dict_data(data, 1600, seed=7)
        out_file = os.path.join(tmp, "output.txt")
        save_dir = os.path.join(tmp, "model_save")
        argv = [] if name == "unet" else ["--model_index", str(MODEL_NAMES.index(name))]
        argv += ["--noise_type_index", "0", "--intensity_index", "0",
                 "--epochs", str(epochs), "--batch_size", str(TRAIN_BATCH),
                 "--n_select", str(n_select), "--seed", str(seed), "--data_path", data,
                 "--model_save_dir", save_dir, "--output_file", out_file]
        if r_pos:
            argv += ["--r_pos", r_pos]
        # The weights the CLI starts from: it seeds, then builds the model.
        random_seed(seed)
        initial = Denoiser(build_model(name), max_batch=256, r_pos=r_pos)
        _, _, te_n, te_c = load_split_arrays("bw", -4, path=data,
                                             n_select=n_select, seed=seed)
        reset_launches()  # the main path
        wall = run_module("ecg_denoise_tpu_torch.cli.main", argv, tag)
        launches = read_launches()
        with open(out_file) as f:
            line = f.read()
        ckpt = os.path.join(save_dir, name, f"{name}_{epochs - 1}_bw_intensity-4.pth")
        check(os.path.exists(ckpt), "the CLI wrote no checkpoint")
        trained = Denoiser.from_checkpoint(name, ckpt, max_batch=256, r_pos=r_pos)
        before, after = mse_of(initial, te_n, te_c), mse_of(trained, te_n, te_c)
        if keep:
            shutil.copy(ckpt, keep)
    n_train = int(0.8 * n_select)
    steps = epochs * (n_train // TRAIN_BATCH)
    evals = epochs * -(-(n_select - n_train) // TRAIN_BATCH)
    log(f"[{tag}] {card}: {name}, {epochs} bf16 epochs of {n_train} windows in {wall:.1f} s "
        f"(host clock, start-up included); output.txt: {line.strip()}")
    log(f"[{tag}] launches on the main path ({steps} steps, {evals} eval batches): "
        f"{launches}")
    log(f"[{tag}] the checkpoint served by Denoiser.from_checkpoint(r_pos={r_pos!r}): "
        f"test MSE {before:.5f} with the initial weights -> {after:.5f} trained")
    check(re.fullmatch(rf"{name}_{epochs - 1}_bw_intensity-4:snr:\S+, rmse:\S+\n",
                       line) is not None, "the output.txt line is malformed")
    forwards = steps + evals
    want = (expected_launches() if name in FAMILIES else
            expected_launches(fwd=18 * forwards, bwd=18 * steps) if not r_pos else
            expected_launches(fwd=4 * forwards, bwd=4 * steps,
                              rpos_fwd=14 * forwards, rpos_bwd=14 * steps))
    check(launches == want, "the CLI's training did not go through its kernels")
    check(np.isfinite(after) and after < before, "the test loss did not fall")
    return launches


def profile_step(step, card, step_ms, iters=3, tag="8", what="float32 training step",
                 batch=TIMING_BATCH):
    """Device time of one training step by kernel (torch.profiler), the
    card's idle share of the unprofiled step time `step_ms`, and where the
    host's time goes: the operators by self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    kernels = device_kernels(prof, iters)
    if not kernels:
        log(f"[{tag}] the profiler recorded no device kernels: breakdown not measured")
        return
    busy = sum(k[0] for k in kernels)
    log(f"[{tag}] {card}: profiled {what} B={batch} "
        f"(torch.profiler, mean of {iters}): {sum(k[1] for k in kernels)} launches "
        f"of {len(kernels)} kernels, device busy {busy:.3f} ms of the unprofiled "
        f"{step_ms:.3f} ms step (idle {100 * (1 - busy / step_ms):.1f} %)")
    # The top 15, and the attention kernels wherever they rank.
    for ms, n, name in [k for i, k in enumerate(kernels) if i < 15 or "attention_" in k[2]]:
        log(f"[{tag}]   {ms:8.3f} ms {100 * ms / busy:5.1f} % x{n:<4d} {name[:100]}")
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
    host = sum(e.self_cpu_time_total for e in ops) / 1e3 / iters
    log(f"[{tag}] {card}: the same step's operators' self CPU time {host:.3f} ms "
        f"(profiled); the top 10:")
    for e in ops[:10]:
        log(f"[{tag}]   {e.self_cpu_time_total / 1e3 / iters:8.3f} ms "
            f"x{e.count // iters:<5d} {e.key[:80]}")


def pass_ms(fn, iters=5):
    """Device ms per call of each kernel that fn() launches, by B2's or
    B4's pass name (dq, dkdv, dbias, dtoep, and dtoep_sum, B4's second
    kernel past D = 4) or kernel name (torch.profiler). A reading in
    which some kernel was not recorded `iters` times is taken again, up to
    three readings (on an H100 some readings recorded one call in five);
    empty (not measured) if all three are short."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.self_device_time_total / 1e3 / iters, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        if kernels and all(count == iters for _, count, _ in kernels):
            break
    else:
        return {}
    got = {}
    for ms, _, name in kernels:
        key = ("dtoep_sum" if "dtoep_sum" in name else
               next((p for p in ("dq", "dkdv", "dbias", "dtoep") if f"_bwd_{p}_" in name),
                    name[:60]))
        got[key] = got.get(key, 0.0) + ms
    return got


def phase_train_times(cpu_model, card):
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.probes.floor import graph_us
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns, train_step

    # Whole epochs of the CLI's default length: the training split of
    # n_select = 10,000 windows, 250 steps at batch 32 and 31 at 256. One
    # epoch at 32: its three had differed by under 6 % on an H100 and took
    # about 190 s of the script's 1,200 s on a slow host.
    rng = np.random.default_rng(8)
    noisy, clean = (torch.from_numpy(rng.standard_normal(
        (EPOCH_WINDOWS, 2, 256)).astype(np.float32)).cuda() for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (TRAIN_BATCH, TIMING_BATCH):
            model = build_model("ralenet", dtype=dtype)
            model.load_state_dict(cpu_model.state_dict())
            state = create_train_state(model)
            train_epoch, _ = make_epoch_fns(state.model, state.optimizer)
            gen = torch.Generator(device="cuda").manual_seed(0)
            train_epoch(noisy[:4 * batch], clean[:4 * batch], gen, batch)  # warm-up
            n = EPOCH_WINDOWS // batch * batch
            repeats = EPOCH_REPEATS if batch == TIMING_BATCH else 1
            walls = [_timed(train_epoch, noisy, clean, gen, batch) for _ in range(repeats)]
            rates = ", ".join(f"{n / w:.1f}" for w in walls)
            nb, cb = noisy[:batch], clean[:batch]
            step_ms = cuda_ms(lambda: train_step(state, nb, cb), 5)
            log(f"[8] {card}: train_epoch {str(dtype)[6:]} batch {batch}: "
                f"{n / statistics.median(walls):.1f} windows/s (median of "
                f"{repeats} epochs of {n // batch} steps, host clock ending in "
                f"the epoch's one fetch; each epoch: {rates}); one step "
                f"{step_ms:.3f} ms on the card's clock (CUDA events, mean of 5)")
            if dtype == torch.float32 and batch == TIMING_BATCH:
                profile_step(lambda: train_step(state, nb, cb), card, step_ms)

    gen = torch.Generator().manual_seed(9)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "eager_ms": 0.0, "parent_ms": 0.0 if parent_libs() else None}
    limits = {"operations": 0.0, "bytes": 0.0}
    passes = {"this": {}, "parent": {}}  # device ms per step by pass (profiler)
    for dtype in (torch.float32, torch.bfloat16):
        for (L, H, with_bias), calls in FORWARD_CALLS.items():
            q, k, v, bias = operands(TIMING_BATCH, H, L, with_bias, dtype, gen)
            g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
            o, lse = attention._launch(q, k, v, bias, with_lse=True)
            args = (q, k, v, bias, o, lse, g, with_bias)
            this = functools.partial(b2_call, attention._bwd_library(), *args)
            # The card's time: 20 calls replayed from one CUDA graph, in turns
            # with the parent's B2 on the same operands where its tree is there.
            kernels = {"this": this}
            if parent_libs():
                kernels["parent"] = functools.partial(parent_b2, *args)
                old, new = in_turns(kernels["parent"], this)
                ms, parent = statistics.mean(new) / 1e3, statistics.mean(old) / 1e3
                turns = (f", the parent's B2 {parent:.4f} ms (graph replays in turns, "
                         f"parent {old[0]:.1f} / {old[1]:.1f} us, this {new[0]:.1f} / "
                         f"{new[1]:.1f} us)")
            else:
                ms, parent = graph_us(this, 20) / 1e3, None
                turns = ", the parent's B2 not measured (no tree under _archive/parent)"
            eager = cuda_ms(lambda: attention._launch_bwd(
                q, k, v, bias, o, lse, g, want_dbias=with_bias), 20)
            plain = cuda_ms(lambda: attention.attention_backward_reference(
                q, k, v, bias, o, lse, g), 5)
            ins = [t.detach().requires_grad_() for t in (q, k, v, bias) if t is not None]

            def sdpa():
                return F.scaled_dot_product_attention(
                    *ins[:3], attn_mask=ins[3] if with_bias else None, scale=1.0)

            lib_fwd = cuda_ms(sdpa, 20)
            lib = cuda_ms(lambda: torch.autograd.grad(sdpa(), ins, g), 20) - lib_fwd
            t_ops, t_bytes = bwd_bound_terms(TIMING_BATCH, H, L, with_bias, q.element_size())
            bnd = max(t_ops, t_bytes)
            by_pass = ""
            if dtype == torch.float32:
                for who, fn in kernels.items():
                    got = pass_ms(fn)
                    by_pass += f"; {who} by pass " + (", ".join(
                        f"{name} {t:.4f}" for name, t in got.items()) or "not measured")
                    for name, t in got.items():
                        passes[who][name] = passes[who].get(name, 0.0) + calls * t
            log(f"[8] {card}: attention_bwd {str(dtype)[6:]} B={TIMING_BATCH} L={L} "
                f"H={H} dbias={with_bias}: kernel {ms:.4f} ms (graph replays; the wrapper "
                f"issued from Python {eager:.4f} ms), bound {bnd:.4f} ms "
                f"(operations {t_ops:.4f} at the f32 CUDA-core peak, bytes "
                f"{t_bytes:.4f}), plain {plain:.4f} ms, sdpa backward {lib:.4f} ms "
                f"((fwd+bwd) - fwd){turns}{by_pass} (device ms, torch.profiler); "
                f"{calls} calls per step")
            if dtype == torch.float32 and calls:
                for key, t in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                               ("library_ms", lib), ("eager_ms", eager), ("parent_ms", parent)):
                    if totals[key] is not None:
                        totals[key] += calls * t
                limits["operations"] += calls * t_ops
                limits["bytes"] += calls * t_bytes
    by = max(limits, key=limits.get)
    parent = ("not measured" if totals["parent_ms"] is None
              else f"{totals['parent_ms']:.4f} ms")
    log(f"[8] {card}: attention_bwd float32, one step's 18 calls at "
        f"B={TIMING_BATCH}: kernel {totals['ms']:.4f} ms (graph replays; the wrapper issued "
        f"from Python {totals['eager_ms']:.4f} ms), the parent's B2 {parent}, bound "
        f"{totals['bound_ms']:.4f} ms ({by}), plain {totals['plain_ms']:.4f} ms, sdpa "
        f"backward {totals['library_ms']:.4f} ms")
    for who, got in passes.items():
        if got:
            log(f"[8] {card}: attention_bwd float32, {who}'s device ms per step by pass "
                f"(torch.profiler): " + ", ".join(f"{n} {t:.4f}" for n, t in got.items()))
    totals["passes_ms"] = {who: got for who, got in passes.items() if got}
    return totals, by


def rpos_operands(B, L, W, H, dtype, gen, D=4, q_scale=1.0):
    """q (times q_scale), k, v, toep (the Toeplitz expansion of a random
    (2W-1, H) table) on the card in `dtype`, and float32 window starts of R
    peaks at 0, 5, L/2, L - 1 and random positions, so that windows hang
    off both ends."""
    q, k, v = (torch.randn(B, H, L, D, generator=gen) for _ in range(3))
    q = q * q_scale
    table = torch.randn(2 * W - 1, H, generator=gen)
    pos = torch.arange(L)
    rel = pos[:, None] - pos[None, :]
    toep = (table[(rel + W - 1).clamp(0, 2 * W - 2)]
            * (rel.abs() < W)[..., None]).permute(2, 0, 1)[None].contiguous()
    r_pos = torch.randint(0, L, (B,), generator=gen)
    r_pos[:4] = torch.tensor([0, 5, L // 2, L - 1])[:B]
    offsets = (r_pos - W // 2).float().cuda()
    return [t.to("cuda", dtype) for t in (q, k, v, toep)], offsets


def toep_reach(offsets, W, L):
    """How many (l, m) entries of toep some window of the batch reaches:
    the entries the r-pos kernels must read (per head)."""
    from ecg_denoise_tpu_torch.kernels.attention_rpos import window_mask

    m = window_mask(offsets, W, L).float()
    return int(((m.T @ m) > 0).sum().item())


def rpos_bound_terms(B, H, L, W, elt, offsets, D=4):
    """(operations, bytes) lower bounds in ms for one B3 call: B1's flops
    over the f32 peak, and q, k, v, o, the toep entries the windows reach
    and the offsets, each moved once, over HBM bandwidth."""
    flops = 2 * B * H * (2 * L * L * D + L * L)
    nbytes = 4 * B * H * L * D * elt + H * toep_reach(offsets, W, L) * elt + B * 4
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def rpos_bwd_bound_terms(B, H, L, W, elt, offsets, D=4):
    """(operations, bytes) lower bounds in ms for one B4 call: B2's flops
    over the f32 peak, and q, k, v, g, o, dq, dk, dv, lse, the toep entries
    the windows reach, the offsets and the whole dtoep, each moved once."""
    flops = 2 * B * H * (5 * L * L * D + 3 * L * L)
    rows = B * H * L
    nbytes = (8 * rows * D * elt + rows * 4 + H * toep_reach(offsets, W, L) * elt
              + B * 4 + H * L * L * elt)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def rpos_cases(B_stage):
    """Phases 9 and 10's cases, (B, L, W, H, dtype, shift): the four biased
    stage shapes at B_stage in f32 and bf16, a ragged B = 3 at each in f32,
    the ragged shapes of RAGGED_RPOS in both, and the logits lifted to
    about 190 (trained logits reach 191.5) at the L = 32 stage."""
    both = (torch.float32, torch.bfloat16)
    cases = [(B_stage, L, W, H, dt, 0.0) for (L, W, H) in RPOS_CALLS for dt in both]
    cases += [(3, L, W, H, torch.float32, 0.0) for (L, W, H) in RPOS_CALLS]
    cases += [(B, L, W, H, dt, 0.0) for (B, L, W, H) in RAGGED_RPOS for dt in both]
    return cases + [(B_stage, 32, 4, 16, torch.float32, 190.0)]


def phase_rpos_kernel_vs_plain():
    """B3 against its plain version at the four biased stage shapes and
    ragged ones; a second call bit-identical; and, where its tree is there,
    the output and lse bit for bit the parent's B3's."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention_rpos as ar

    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(10)
    max_err = 0.0
    for B, L, W, H, dtype, shift in rpos_cases(BATCH):
        (q, k, v, toep), offsets = rpos_operands(B, L, W, H, dtype, gen)
        toep = toep + shift
        out = ar.fused_attention_rpos(q, k, v, toep, W, offsets)
        torch.cuda.synchronize()
        ref = ar.attention_rpos_reference(q, k, v, toep, W, offsets)
        err = (out.float() - ref.float()).abs().max().item()
        if shift:
            tol = LARGE_LOGIT_TOL
        elif dtype == torch.float32:
            tol = F32_TOL
            max_err = max(max_err, err)
        else:
            tol = BF16_TOL_OF_MAX_V * v.float().abs().max().item()
        again = ar.fused_attention_rpos(q, k, v, toep, W, offsets)
        same = torch.equal(out, again)
        parent = ""
        if parent_libs():
            args = (q, k, v, toep, W, offsets)
            new, old = b3_call(ar._library(), *args), b3_call(parent_libs()["attention_rpos_fwd"],
                                                              *args)
            equal = [name for name, a, b in zip(("o", "lse"), new, old) if torch.equal(a, b)]
            parent = f"; bit-identical to the parent's B3: {', '.join(equal) or 'none'}"
            check(len(equal) == 2 and torch.equal(new[0], out),
                  "B3 is not the parent's B3 bit for bit")
        log(f"[9] B3 B={B} L={L} W={W} H={H} {str(dtype)[6:]}"
            f"{f' toep+{shift:.0f}' if shift else ''}: max_abs_err={err:.3e} (tol {tol:.3e}); "
            f"a second call bit-identical: {same}{parent}")
        check(out.shape == q.shape and out.dtype == dtype, "B3 output shape or dtype")
        check(bool(torch.isfinite(out).all()) and err <= tol,
              "B3 disagrees with its plain version")
        check(same, "two B3 calls differ")
    if not parent_libs():
        log("[9] the parent's B3 not compared (no tree under _archive/parent)")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return max_err


def phase_rpos_backward_vs_plain():
    """B4, through the autograd Function, against the plain flash backward
    on B3's own o and lse and, in float32, against autograd through the
    plain forward; two calls bit-identical; and, where its tree is there,
    dq, dk, dv and the float32 dtoep bit for bit the parent's B4's on the
    same o, lse and g."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention_rpos as ar

    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(11)
    max_err = 0.0
    for B, L, W, H, dtype, shift in rpos_cases(TIMING_BATCH):
        ops, offsets = rpos_operands(B, L, W, H, dtype, gen)
        ops[3] = ops[3] + shift
        g = torch.randn(ops[0].shape, generator=gen).to("cuda", dtype)

        def grads():
            ins = [t.detach().requires_grad_() for t in ops]
            out = ar.fused_attention_rpos(*ins, W, offsets)
            return out.detach(), torch.autograd.grad(out, ins, g)

        out, got = grads()
        _, lse = ar._launch(*ops, W, offsets, with_lse=True)
        refs = {"flash": ar.attention_rpos_backward_reference(*ops, W, offsets, out, lse, g)}
        if dtype == torch.float32:
            ins = [t.detach().requires_grad_() for t in ops]
            refs["autograd"] = torch.autograd.grad(
                ar.attention_rpos_reference(*ins, W, offsets), ins, g)
        torch.cuda.synchronize()
        check([t.dtype for t in got] == [dtype] * 4
              and [t.shape for t in got] == [t.shape for t in ops],
              "B4 output shape or dtype")
        check(all(bool(torch.isfinite(t).all()) for t in got), "non-finite B4 gradient")
        errs = []
        for ref_name, ref in refs.items():
            for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, ref):
                scale = b.float().abs().max().item()
                if L == 1 and name != "dv":
                    # As in phase 6: over one key the exact dq, dk and dtoep
                    # are 0, and both sides return the rounding of the
                    # cancelled g.v - g.o; their bars are taken of max|dv|.
                    scale = ref[2].float().abs().max().item()
                err = (a.float() - b.float()).abs().max().item()
                if shift:
                    tol = LARGE_LOGIT_GRAD_TOL_OF_MAX * scale
                elif dtype == torch.bfloat16:
                    tol = BF16_GRAD_TOL_OF_MAX * scale
                else:
                    tol = DBIAS_TOL_OF_MAX * scale if name == "dtoep" else GRAD_TOL
                errs.append(f"{name} vs {ref_name} {err:.2e}/{tol:.2e}")
                check(err <= tol, f"B4 {name} disagrees with the plain {ref_name} backward")
                if dtype == torch.float32 and ref_name == "flash" and not shift:
                    max_err = max(max_err, err)
        _, again = grads()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        parent = ""
        if parent_libs():
            # The raw kernels' outputs, dtoep in float32 before any cast.
            args = (*ops, W, offsets, out, lse, g)
            new = b4_call(ar._bwd_library(), *args)
            old = b4_call(parent_libs()["attention_rpos_bwd"], *args)
            equal = [name for name, a, b in zip(("dq", "dk", "dv", "dtoep"), new, old)
                     if torch.equal(a, b)]
            parent = f"; bit-identical to the parent's B4: {', '.join(equal) or 'none'}"
            check(len(equal) == 4, "B4 is not the parent's B4 bit for bit")
        log(f"[10] B4 B={B} L={L} W={W} H={H} {str(dtype)[6:]}"
            f"{f' toep+{shift:.0f}' if shift else ''}: " + ", ".join(errs)
            + f"; a second call bit-identical: {same}{parent}")
        check(same, "two B4 calls differ")
    if not parent_libs():
        log("[10] the parent's B4 not compared (no tree under _archive/parent)")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return max_err


def beat_windows(n, seed, length=256):
    """(n, 2, length) float32 windows, each holding one QRS-like beat at a
    seeded position, with noise and baseline wander."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    centres = rng.integers(0, length, (n, 1, 1))
    x = (1.5 * np.exp(-0.5 * ((t - centres) / 4.0) ** 2)
         + 0.2 * rng.standard_normal((n, 2, length))
         + np.linspace(-1, 1, length) * rng.standard_normal((n, 2, 1)))
    return x.astype(np.float32)


def phase_rpos_serving(cpu_model, gpu_model):
    """The r_pos serving path: the model with detected R peaks on the card
    against the CPU, then `cli.serve --r_pos detect` answering over HTTP,
    the counts set to 0 just before and read just after."""
    from ecg_denoise_tpu_torch.cli.serve import build
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks

    x = torch.from_numpy(beat_windows(64, seed=12))
    r_cpu = detect_r_peaks(x)
    r_gpu = detect_r_peaks(x.cuda())
    with torch.no_grad():
        reset_launches()
        y = gpu_model(x.cuda(), r_pos=r_gpu)
        torch.cuda.synchronize()
        per_forward = read_launches()
        err = (y.cpu() - cpu_model(x, r_pos=r_cpu)).abs().max().item()
    same = torch.equal(r_gpu.cpu(), r_cpu)
    log(f"[11] detected R peaks on the card equal the CPU's: {same} "
        f"(64 windows, {len(set(r_cpu.tolist()))} distinct positions)")
    log(f"[11] RaleNet 'full' depth 2, batch 64, float32, r_pos detected: card vs "
        f"CPU max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}); launches per forward "
        f"{per_forward}")
    check(same, "the card's detected R peaks differ from the CPU's")
    check(bool(torch.isfinite(y).all()) and err <= MODEL_TOL,
          "the card's r_pos forward disagrees with the CPU's")
    check(per_forward == expected_launches(fwd=4, rpos_fwd=14),
          "an r_pos forward did not make 14 B3 and 4 B1 launches")

    rng = np.random.default_rng(13)
    requests = {n: beat_windows(n, seed=n) for n in (1, 37, BATCH)}
    record = (np.tile(beat_windows(1, seed=14)[0], (1, 20))[:, :5000]
              + 0.1 * rng.standard_normal((2, 5000))).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ralenet.pt")
        torch.save(cpu_model.state_dict(), ckpt)
        server, denoiser = build(["--model", "ralenet", "--ckpt", ckpt, "--port", "0",
                                  "--max_batch", str(BATCH), "--warmup_max", str(BATCH),
                                  "--r_pos", "detect"])
    direct = {n: denoiser(x) for n, x in requests.items()}
    direct_record = denoiser.denoise_record(record, stride=128)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_launches()  # the main path
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        log(f"[11] cli.serve --r_pos detect: /healthz: {health}")
        check(health["inference_path"] == "torch+attn-cuda+rpos:cuda", "inference path")
        for n, x in requests.items():
            y, timing = _post(url + "/denoise", x)
            err = float(np.abs(y - direct[n]).max())
            log(f"[11] /denoise N={n}: max_abs_err vs Denoiser={err:.3e}; {timing}")
            check(y.shape == x.shape and np.isfinite(y).all() and err <= 1e-6,
                  "/denoise with r_pos disagrees with Denoiser")
        y, _ = _post(url + "/denoise_record?stride=128", record)
        err = float(np.abs(y - direct_record).max())
        log(f"[11] /denoise_record T={record.shape[1]}: max_abs_err vs Denoiser={err:.3e}")
        check(y.shape == record.shape and err <= 1e-6,
              "/denoise_record with r_pos disagrees with Denoiser")
        launches = read_launches()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[11] kernel launches on the r_pos serving path: {launches}")
    check(launches == expected_launches(fwd=4 * 4, rpos_fwd=4 * 14),
          "the r_pos serving path did not go through B3 and B1")
    check(not thread.is_alive(), "the server thread did not stop")
    return launches


def phase_rpos_train_step(cpu_model):
    """One f32 Adam step with detected R peaks on the card against the same
    step on the CPU, with 14 + 4 forward and 14 + 4 backward launches."""
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.train import create_train_state, train_step

    noisy = torch.from_numpy(beat_windows(TRAIN_BATCH, seed=15))
    clean = torch.from_numpy(beat_windows(TRAIN_BATCH, seed=16))
    cpu_state = create_train_state(copy.deepcopy(cpu_model), device="cpu")
    model = build_model("ralenet")
    model.load_state_dict(cpu_model.state_dict())
    gpu_state = create_train_state(model)
    reset_launches()
    nc = noisy.cuda()
    loss = train_step(gpu_state, nc, clean.cuda(), detect_r_peaks(nc))[0].item()
    torch.cuda.synchronize()
    launches = read_launches()
    ref = train_step(cpu_state, noisy, clean, detect_r_peaks(noisy))[0].item()
    params, stats = state_max_diff(gpu_state.model, cpu_state.model.state_dict())
    log(f"[12] RaleNet 'full' depth 2, float32, batch {TRAIN_BATCH}, r_pos detected: "
        f"one Adam step on the card vs the CPU: loss {loss:.7f} vs {ref:.7f} (rel "
        f"{abs(loss - ref) / abs(ref):.2e}, tol {LOSS_RTOL:.0e}), BN stats max diff "
        f"{stats:.2e} (tol {BN_STATS_TOL:.0e}), params max diff {params:.2e} "
        f"(tol {PARAM_TOL:.0e}); launches {launches}")
    check(launches == expected_launches(fwd=4, bwd=4, rpos_fwd=14, rpos_bwd=14),
          "the r_pos training step did not make 14 + 4 launches each way")
    check(abs(loss - ref) <= LOSS_RTOL * abs(ref) and stats <= BN_STATS_TOL
          and params <= PARAM_TOL, "the card's r_pos training step disagrees with the CPU's")


def serve_rates(denoiser, x, n=5):
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        denoiser(x)  # ends in torch.cuda.synchronize
        walls.append(time.perf_counter() - t0)
    return walls


def phase_rpos_times(gpu_model, cpu_model, card):
    """Times on the card: B3 and B4 per stage shape beside their bounds,
    plain versions and SDPA on the materialised mask; Denoiser windows/s
    with and without r_pos; the r_pos training step and its idle share."""
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks
    from ecg_denoise_tpu_torch.kernels import attention_rpos as ar
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.probes.floor import graph_us
    from ecg_denoise_tpu_torch.serving import Denoiser
    from ecg_denoise_tpu_torch.train import create_train_state, train_step

    gen = torch.Generator().manual_seed(17)
    has_parent = parent_libs() is not None
    fwd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "eager_ms": 0.0,
           "parent_ms": 0.0 if has_parent else None}
    bwd = dict(fwd)
    limits = {"fwd": {"operations": 0.0, "bytes": 0.0},
              "bwd": {"operations": 0.0, "bytes": 0.0}}
    passes = {"this": {}, "parent": {}}  # B4's device ms per step by pass (profiler)

    def kernel_times(name, this, parent):
        """(this ms, parent ms or None, a note): CUDA graph replays of 20
        calls, in turns with the parent's kernel where its tree is there."""
        if parent is None:
            return graph_us(this, 20) / 1e3, None, (
                f", the parent's {name} not measured (no tree under _archive/parent)")
        old, new = in_turns(parent, this)
        return statistics.mean(new) / 1e3, statistics.mean(old) / 1e3, (
            f", the parent's {name} {statistics.mean(old) / 1e3:.4f} ms (graph replays in "
            f"turns, parent {old[0]:.1f} / {old[1]:.1f} us, this {new[0]:.1f} / {new[1]:.1f} us)")

    def add(totals, key_times, calls):
        for key, t in key_times:
            if totals[key] is not None:
                totals[key] += calls * t

    for dtype in (torch.float32, torch.bfloat16):
        for (L, W, H), calls in RPOS_CALLS.items():
            (q, k, v, toep), offsets = rpos_operands(BATCH, L, W, H, dtype, gen)
            args = (q, k, v, toep, W, offsets)
            # The serving path's call: no lse.
            ms, parent, turns = kernel_times(
                "B3", functools.partial(b3_call, ar._library(), *args, with_lse=False),
                functools.partial(b3_call, parent_libs()["attention_rpos_fwd"], *args,
                                  with_lse=False) if has_parent else None)
            eager = cuda_ms(lambda: ar.fused_attention_rpos(q, k, v, toep, W, offsets), 20)
            no_bias = cuda_ms(lambda: fused_attention(q, k, v), 20)
            plain = cuda_ms(lambda: ar.attention_rpos_reference(q, k, v, toep, W, offsets), 5)
            mask = ar.materialize_rpos_bias(toep, W, offsets)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0), 20)
            t_ops, t_bytes = rpos_bound_terms(BATCH, H, L, W, q.element_size(), offsets)
            bnd = max(t_ops, t_bytes)
            log(f"[13] {card}: B3 attention_rpos_fwd {str(dtype)[6:]} B={BATCH} L={L} "
                f"W={W} H={H}: kernel {ms:.4f} ms (graph replays; the wrapper issued from "
                f"Python {eager:.4f} ms), bound {bnd:.4f} ms (operations {t_ops:.4f} at the "
                f"f32 CUDA-core peak, bytes {t_bytes:.4f}), plain {plain:.4f} ms, sdpa with "
                f"the (B, H, L, L) mask {lib:.4f} ms, B1 without any bias {no_bias:.4f} ms"
                f"{turns}; {calls} calls per forward")
            if dtype == torch.float32:
                add(fwd, (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                          ("library_ms", lib), ("eager_ms", eager), ("parent_ms", parent)),
                    calls)
                limits["fwd"]["operations"] += calls * t_ops
                limits["fwd"]["bytes"] += calls * t_bytes
            del mask

            B = TIMING_BATCH
            ops, offsets = rpos_operands(B, L, W, H, dtype, gen)
            g = torch.randn(ops[0].shape, generator=gen).to("cuda", dtype)
            o, lse = ar._launch(*ops, W, offsets, with_lse=True)
            args = (*ops, W, offsets, o, lse, g)
            kernels = {"this": functools.partial(b4_call, ar._bwd_library(), *args)}
            if has_parent:
                kernels["parent"] = functools.partial(
                    b4_call, parent_libs()["attention_rpos_bwd"], *args)
            ms, parent, turns = kernel_times("B4", kernels["this"], kernels.get("parent"))
            eager = cuda_ms(lambda: ar._launch_bwd(*args), 20)
            plain = cuda_ms(lambda: ar.attention_rpos_backward_reference(*args), 5)
            qkv = [t.detach().requires_grad_() for t in ops[:3]]
            mask = ar.materialize_rpos_bias(ops[3], W, offsets).requires_grad_()

            def sdpa():
                return F.scaled_dot_product_attention(*qkv, attn_mask=mask, scale=1.0)

            lib_fwd = cuda_ms(sdpa, 20)
            lib = cuda_ms(lambda: torch.autograd.grad(sdpa(), qkv + [mask], g), 20) - lib_fwd
            t_ops, t_bytes = rpos_bwd_bound_terms(B, H, L, W, ops[0].element_size(), offsets)
            bnd = max(t_ops, t_bytes)
            by_pass = ""
            if dtype == torch.float32:
                for who, fn in kernels.items():
                    got = pass_ms(fn)
                    by_pass += f"; {who} by pass " + (", ".join(
                        f"{name} {t:.4f}" for name, t in got.items()) or "not measured")
                    for name, t in got.items():
                        passes[who][name] = passes[who].get(name, 0.0) + calls * t
            log(f"[13] {card}: B4 attention_rpos_bwd {str(dtype)[6:]} B={B} L={L} W={W} "
                f"H={H}: kernel {ms:.4f} ms (graph replays; the wrapper issued from Python "
                f"{eager:.4f} ms), bound {bnd:.4f} ms (operations {t_ops:.4f}, bytes "
                f"{t_bytes:.4f}), plain {plain:.4f} ms, sdpa backward with a grad-requiring "
                f"(B, H, L, L) mask {lib:.4f} ms ((fwd+bwd) - fwd){turns}{by_pass} (device "
                f"ms, torch.profiler); {calls} calls per step")
            if dtype == torch.float32:
                add(bwd, (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                          ("library_ms", lib), ("eager_ms", eager), ("parent_ms", parent)),
                    calls)
                limits["bwd"]["operations"] += calls * t_ops
                limits["bwd"]["bytes"] += calls * t_bytes
            del mask
    by = {k: max(v, key=v.get) for k, v in limits.items()}
    for what, t, b, n, lib_name in (("B3", fwd, by["fwd"], f"one forward's 14 calls at B={BATCH}",
                                     "sdpa"),
                                    ("B4", bwd, by["bwd"],
                                     f"one step's 14 calls at B={TIMING_BATCH}", "sdpa backward")):
        parent = "not measured" if t["parent_ms"] is None else f"{t['parent_ms']:.4f} ms"
        log(f"[13] {card}: {what} float32, {n}: kernel {t['ms']:.4f} ms (graph replays; the "
            f"wrapper issued from Python {t['eager_ms']:.4f} ms), the parent's {what} {parent} "
            f"(in turns), bound {t['bound_ms']:.4f} ms ({b}), plain {t['plain_ms']:.4f} ms, "
            f"{lib_name} {t['library_ms']:.4f} ms")
    for who, got in passes.items():
        if got:
            overlap = "; the passes run side by side, so these overlap" if who == "this" else ""
            log(f"[13] {card}: B4 float32, {who}'s device ms per step by pass "
                f"(torch.profiler{overlap}): " + ", ".join(f"{n} {t:.4f}" for n, t in got.items()))
    bwd["passes_ms"] = {who: got for who, got in passes.items() if got}

    # Serving, in turns: without r_pos, with, with, without.
    bf16_model = build_model("ralenet", dtype=torch.bfloat16).eval()
    bf16_model.load_state_dict(cpu_model.state_dict())
    for dtype, model in ((torch.float32, gpu_model), (torch.bfloat16, bf16_model)):
        plain_d = Denoiser(model, max_batch=2048)
        rpos_d = Denoiser(model, max_batch=2048, r_pos="detect")
        for batch in (1024, 2048):
            x = beat_windows(batch, seed=batch)
            check(np.isfinite(rpos_d(x)).all() and np.isfinite(plain_d(x)).all(),
                  "non-finite Denoiser output")
            walls = {"without": [], "with": []}
            for key in ("without", "with", "with", "without"):
                walls[key] += serve_rates(plain_d if key == "without" else rpos_d, x)
            xd = torch.from_numpy(x).cuda()

            def forward():
                return model(xd, r_pos=detect_r_peaks(xd))

            with torch.no_grad():
                fwd_ms = cuda_ms(forward, 10)
            log(f"[13] {card}: Denoiser {str(dtype)[6:]} batch {batch}: r_pos detect "
                f"{batch / statistics.median(walls['with']):.1f} windows/s, without "
                f"{batch / statistics.median(walls['without']):.1f} (medians of 10 calls "
                f"each, in turns, host clock); device-resident forward with detection "
                f"{fwd_ms:.3f} ms (CUDA events, mean of 10)")
            if batch == BATCH:
                profile_forward(forward, f"{str(dtype)[6:]} r_pos forward B={batch} "
                                "with detection", fwd_ms, card, tag="13")

    # The r_pos training step, f32, B = 256, beside the step without r_pos.
    model = build_model("ralenet")
    model.load_state_dict(cpu_model.state_dict())
    state = create_train_state(model)
    nb = torch.from_numpy(beat_windows(TIMING_BATCH, seed=18)).cuda()
    cb = torch.from_numpy(beat_windows(TIMING_BATCH, seed=19)).cuda()

    def step():
        return train_step(state, nb, cb, detect_r_peaks(nb))

    step_ms = cuda_ms(step, 5)
    plain_ms = cuda_ms(lambda: train_step(state, nb, cb), 5)
    log(f"[13] {card}: training step float32 B={TIMING_BATCH}: with r_pos detect "
        f"{step_ms:.3f} ms, without {plain_ms:.3f} ms (CUDA events, mean of 5)")
    profile_step(step, card, step_ms, tag="13", what="float32 r_pos training step")
    return fwd, by["fwd"], bwd, by["bwd"]


def phase_dense_kernel_vs_plain():
    """B5 against B1 without lse (bit for bit), its plain version and, where
    its tree is there, the parent's B5 on the same operands."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        attention_dense_reference,
        fused_attention_dense,
    )

    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(14)
    parent = parent_libs()["attention_dense_fwd"] if parent_libs() else None
    max_err = 0.0
    cases = [(B, L, H, b, dt) for (L, H) in DENSE_SHAPES for B in DENSE_BATCHES
             for b in (True, False) for dt in (torch.float32, torch.bfloat16)]
    for B, L, H, with_bias, dtype in cases:
        q, k, v, bias = operands(B, H, L, with_bias, dtype, gen)
        out = fused_attention_dense(q, k, v, bias)
        again = fused_attention_dense(q, k, v, bias)
        b1 = attention._launch(q, k, v, bias)
        old = None if parent is None else b5_call(parent, q, k, v, bias)
        torch.cuda.synchronize()
        err = (out.float() - attention_dense_reference(q, k, v, bias).float()).abs().max().item()
        err_old = None if old is None else (out.float() - old.float()).abs().max().item()
        if dtype == torch.float32:
            tol = F32_TOL
            max_err = max(max_err, err)
        else:
            tol = BF16_TOL_OF_MAX_V * v.float().abs().max().item()
        same, same_b1 = torch.equal(out, again), torch.equal(out, b1)
        log(f"[14] B5 B={B} L={L} H={H} bias={with_bias} {str(dtype)[6:]}: equal to B1 "
            f"without lse: {same_b1}; max_abs_err vs plain {err:.3e}, vs the parent's B5 "
            + ("not measured" if err_old is None else f"{err_old:.3e}")
            + f" (tol {tol:.3e}); a second call bit-identical: {same}")
        check(out.shape == q.shape and out.dtype == dtype, "B5 output shape or dtype")
        check(same_b1, "B5 differs from B1 without lse")
        check(bool(torch.isfinite(out).all()) and err <= tol
              and (err_old is None or err_old <= tol),
              "B5 disagrees with its plain version or with the parent's B5")
        check(same, "two B5 calls differ")
    # One max per head, not per packed row: head 0 about 130 logits above
    # head 1 in one packed group of (16, 32); then logits near 200.
    q, k, v, bias = operands(BATCH, 32, 16, True, torch.float32, gen)
    apart = bias.clone()
    apart[0, 0] += 65.0
    apart[0, 1] -= 65.0
    for what, b in (("heads apart", apart), ("large logits", bias + 190.0)):
        logits = torch.einsum("bhld,bhmd->bhlm", q, k) + b
        row_max = logits.amax(-1)
        gap = (row_max[:, 0] - row_max[:, 1]).min().item()
        out = fused_attention_dense(q, k, v, b)
        torch.cuda.synchronize()
        err = (out - attention.attention_reference(q, k, v, b)).abs().max().item()
        log(f"[14] B5 {what} L=16 H=32: head 0's row max minus head 1's at least "
            f"{gap:.1f}, largest logit {logits.max().item():.1f}; max_abs_err vs "
            f"attention_reference {err:.3e} (tol {LARGE_LOGIT_TOL:.0e})")
        check(bool(torch.isfinite(out).all()) and err <= LARGE_LOGIT_TOL,
              f"B5 fails with {what}")
        check(gap > HEADS_APART if what == "heads apart" else logits.max().item() > 180,
              f"the {what} case is not what it claims")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return max_err


def phase_dense_serving(cpu_model, gpu_model, card):
    """The serving path with ECG_ATTN_DENSE=1: the model on the card against
    the CPU, then `cli.serve`'s server and `StreamingDenoiser`, the counts
    set to 0 just before and read just after."""
    from ecg_denoise_tpu_torch.cli.serve import build
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks

    with dense_route():
        x = torch.from_numpy(np.random.default_rng(22).standard_normal(
            (8, 2, 256)).astype(np.float32))
        xb = torch.from_numpy(beat_windows(64, seed=23))
        with torch.no_grad():
            reset_launches()
            y = gpu_model(x.cuda())
            torch.cuda.synchronize()
            per_forward = read_launches()
            err = (y.cpu() - cpu_model(x)).abs().max().item()
            r_gpu = detect_r_peaks(xb.cuda())
            reset_launches()
            y_r = gpu_model(xb.cuda(), r_pos=r_gpu)
            torch.cuda.synchronize()
            per_rpos = read_launches()
            err_r = (y_r.cpu() - cpu_model(xb, r_pos=detect_r_peaks(xb))).abs().max().item()
        log(f"[15] ECG_ATTN_DENSE=1, RaleNet 'full' depth 2, batch 8, float32: card vs "
            f"CPU max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}); launches per forward "
            f"{per_forward}")
        log(f"[15] with detected R peaks, batch 64: card vs CPU max_abs_err={err_r:.3e}; "
            f"launches per forward {per_rpos}")
        check(per_forward == expected_launches(fwd=6, dense=12),
              "a dense forward did not make 12 B5 and 6 B1 launches")
        check(per_rpos == expected_launches(rpos_fwd=14, dense=4),
              "a dense r_pos forward did not make 4 B5 and 14 B3 launches")
        check(bool(torch.isfinite(y).all()) and err <= MODEL_TOL
              and bool(torch.isfinite(y_r).all()) and err_r <= MODEL_TOL,
              "the card's dense forward disagrees with the CPU's")

        rng = np.random.default_rng(24)
        requests = {n: rng.standard_normal((n, 2, 256)).astype(np.float32)
                    for n in (1, 37, BATCH)}
        record = rng.standard_normal((2, 5000)).astype(np.float32)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "ralenet.pt")
            torch.save(cpu_model.state_dict(), ckpt)
            server, denoiser = build(["--model", "ralenet", "--ckpt", ckpt, "--port", "0",
                                      "--max_batch", str(BATCH), "--warmup_max", str(BATCH)])
        direct = {n: denoiser(x) for n, x in requests.items()}
        direct_record = denoiser.denoise_record(record, stride=128)
        forwards = []  # the Denoiser's forwards in the counted run
        forward = denoiser._forward

        def counted_forward(batch):
            forwards.append(batch.shape[0])
            return forward(batch)

        denoiser._forward = counted_forward
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            reset_launches()  # the main path
            for n, x in requests.items():
                y, timing = _post(url + "/denoise", x)
                err = float(np.abs(y - direct[n]).max())
                log(f"[15] /denoise N={n}: max_abs_err vs Denoiser={err:.3e}; {timing}")
                check(y.shape == x.shape and np.isfinite(y).all() and err <= 1e-6,
                      "/denoise on the dense route disagrees with Denoiser")
            y, _ = _post(url + "/denoise_record?stride=128", record)
            err = float(np.abs(y - direct_record).max())
            log(f"[15] /denoise_record T={record.shape[1]}: max_abs_err vs Denoiser={err:.3e}")
            check(y.shape == record.shape and err <= 1e-6,
                  "/denoise_record on the dense route disagrees with Denoiser")
            for chunk in (1, 100, 777):
                stream = denoiser.streaming(stride=128)
                t0 = time.perf_counter()
                pieces = [stream.push(record[:, i:i + chunk])
                          for i in range(0, record.shape[1], chunk)]
                out = np.concatenate(pieces + [stream.flush()], axis=1)
                wall = time.perf_counter() - t0
                err = float(np.abs(out - direct_record).max())
                log(f"[15] {card}: StreamingDenoiser, chunks of {chunk}: {len(pieces)} "
                    f"pushes in {wall:.3f} s (host clock), max_abs_err vs denoise_record "
                    f"{err:.3e} (tol {STREAM_TOL:.0e})")
                check(out.shape == record.shape and err <= STREAM_TOL,
                      "StreamingDenoiser disagrees with denoise_record")
            launches = read_launches()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            denoiser._forward = forward
    n = len(forwards)
    log(f"[15] kernel launches on the dense serving path ({n} forwards): {launches}")
    check(n > 0 and launches == expected_launches(fwd=6 * n, dense=12 * n),
          "the dense serving path did not go through B5 and B1")
    check(not thread.is_alive(), "the server thread did not stop")
    return launches


def log_b5_resources():
    """B5's resources by kernel instantiation as ptxas left them in the
    built library (cuobjdump -res-usage: registers, stack, static shared and
    local memory; a spill shows as stack or local memory), and the dynamic
    shared memory of a block at the route's shapes. Fails on a spill in an
    instantiation that RA-LENet's dense calls take (L = 64, 32, 16)."""
    from ecg_denoise_tpu_torch.kernels.attention_dense import dense_pack_factor, smem_bytes
    from ecg_denoise_tpu_torch.kernels.build import CSRC, _nvcc, _target

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(_target("attention_dense_fwd", CSRC))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    found = re.findall(r"Function \S*attention_dense_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)"
                       r"ELb([01])\S*:\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", text)
    for dt, L, bias, reg, stack, shared, local in sorted(found, key=lambda f: (f[0], int(f[1]))):
        log(f"[16] B5 ptxas, {'float32' if dt == 'f' else 'bfloat16'} L={L} "
            f"bias={bias == '1'}: {reg} registers, stack {stack} bytes, local {local} bytes, "
            f"static shared {shared} bytes")
    check(len(found) == 2 * 7 * 2, "B5's 28 kernel instantiations not all found")
    route = {str(L) for (L, _, _) in DENSE_CALLS}
    check(all(f[4] == "0" and f[6] == "0" for f in found if f[1] in route),
          "a B5 instantiation of RA-LENet's dense calls spills")
    for (L, H, with_bias) in DENSE_CALLS:
        P = dense_pack_factor(H, L)
        log(f"[16] B5 dynamic shared memory a block at L={L} H={H} (P={P}) bias={with_bias}: "
            f"{smem_bytes(L, 4, P, torch.float32, with_bias)} bytes float32, "
            f"{smem_bytes(L, 4, P, torch.bfloat16, with_bias)} bfloat16 (from the library)")


def phase_dense_times(gpu_model, cpu_model, card):
    """B5 per stage shape beside B1 without lse, its bound, its plain
    version and SDPA; Denoiser windows/s with and without the dense route;
    the dense forward's device breakdown."""
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        attention_dense_reference,
        fused_attention_dense,
    )
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.probes.floor import graph_us
    from ecg_denoise_tpu_torch.serving import Denoiser

    log_b5_resources()
    gen = torch.Generator().manual_seed(25)
    parent = parent_libs()["attention_dense_fwd"] if parent_libs() else None
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "b1_ms": 0.0,
              "parent_ms": 0.0 if parent else None}
    limits = {"operations": 0.0, "bytes": 0.0}
    # The forward's dense calls, then (64, 4), RA-LENet with half the heads
    # (no call of the forward: timed, not added to its totals).
    shapes = list(DENSE_CALLS.items()) + [((64, 4, True), 0)]
    for dtype in (torch.float32, torch.bfloat16):
        for (L, H, with_bias), calls in shapes:
            q, k, v, bias = operands(BATCH, H, L, with_bias, dtype, gen)

            def b5():
                return fused_attention_dense(q, k, v, bias)

            def b1():
                return attention._launch(q, k, v, bias)

            # The card's time: 20 calls replayed from one CUDA graph, in
            # turns with the parent's B5 where its tree is there; issued one
            # by one from Python a call this short times the host too.
            if parent is None:
                ms, old_ms = graph_us(b5, 20) / 1e3, None
                turns = ", the parent's B5 not measured (no tree under _archive/parent)"
            else:
                old, new = in_turns(functools.partial(b5_call, parent, q, k, v, bias), b5)
                ms, old_ms = statistics.mean(new) / 1e3, statistics.mean(old) / 1e3
                turns = (f", the parent's B5 {old_ms:.4f} ms (graph replays in turns, parent "
                         f"{old[0]:.1f} / {old[1]:.1f} us, this {new[0]:.1f} / {new[1]:.1f} us)")
            b1_ms = graph_us(b1, 20) / 1e3
            eager, b1_eager = (cuda_ms(f, 20) for f in (b5, b1))
            plain = cuda_ms(lambda: attention_dense_reference(q, k, v, bias), 5)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=1.0), 20)
            t_ops, t_bytes = bound_terms(BATCH, H, L, with_bias, q.element_size())
            bnd = max(t_ops, t_bytes)
            log(f"[16] {card}: B5 attention_dense_fwd {str(dtype)[6:]} B={BATCH} L={L} "
                f"H={H} bias={with_bias}: kernel {ms:.4f} ms, B1 without lse {b1_ms:.4f} ms "
                f"(graph replays; issued from Python {eager:.4f} and {b1_eager:.4f} ms), "
                f"bound {bnd:.4f} ms (operations {t_ops:.4f} at the f32 CUDA-core peak, "
                f"bytes {t_bytes:.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms{turns}; "
                + (f"{calls} calls per forward" if calls else "RA-LENet with half the heads"))
            if dtype == torch.float32 and calls:
                for key, t in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                               ("library_ms", lib), ("b1_ms", b1_ms), ("parent_ms", old_ms)):
                    if totals[key] is not None:
                        totals[key] += calls * t
                limits["operations"] += calls * t_ops
                limits["bytes"] += calls * t_bytes
    by = max(limits, key=limits.get)
    log(f"[16] {card}: B5 float32, one forward's 12 dense-routed calls at B={BATCH}: "
        f"kernel {totals['ms']:.4f} ms (B1 on the same calls {totals['b1_ms']:.4f} ms, the "
        "parent's B5 in turns " + ("not measured" if parent is None
                                    else f"{totals['parent_ms']:.4f} ms") + "), "
        f"bound {totals['bound_ms']:.4f} ms ({by}), plain {totals['plain_ms']:.4f} ms, "
        f"sdpa {totals['library_ms']:.4f} ms")

    # Serving, in turns: default route, dense, dense, default.
    bf16_model = build_model("ralenet", dtype=torch.bfloat16).eval()
    bf16_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(26)
    for dtype, model in ((torch.float32, gpu_model), (torch.bfloat16, bf16_model)):
        denoiser = Denoiser(model, max_batch=2048)
        for batch in (1024, 2048):
            x = rng.standard_normal((batch, 2, 256)).astype(np.float32)
            walls = {"default": [], "dense": []}
            for key in ("default", "dense", "dense", "default"):
                with dense_route(key == "dense"):
                    check(np.isfinite(denoiser(x)).all(), "non-finite Denoiser output")
                    walls[key] += serve_rates(denoiser, x)
            xd = torch.from_numpy(x).cuda()
            fwd_ms = {}
            with torch.no_grad():
                for key in ("default", "dense"):
                    with dense_route(key == "dense"):
                        fwd_ms[key] = cuda_ms(lambda: model(xd), 10)
            log(f"[16] {card}: Denoiser {str(dtype)[6:]} batch {batch}: "
                f"ECG_ATTN_DENSE=1 {batch / statistics.median(walls['dense']):.1f} "
                f"windows/s, default {batch / statistics.median(walls['default']):.1f} "
                f"(medians of 10 calls each, in turns, host clock); device-resident "
                f"forward dense {fwd_ms['dense']:.3f} ms, default {fwd_ms['default']:.3f} ms "
                f"(CUDA events, mean of 10)")
            if batch == BATCH:
                with dense_route():
                    profile_forward(lambda: model(xd), f"{str(dtype)[6:]} dense forward "
                                    f"B={batch}", fwd_ms["dense"], card, tag="16")
    return totals, by


def phase_probes(card):
    """P2: null_copy and, where its tree is there, the parent's P2 equal to
    clone() bit for bit at NULL_COPY_SIZES, aligned and 4 bytes off; its
    times at a q's size settled against copy_ and the parent's (also at the
    dma floor's batches and the null tile); then the probes, the counts set
    to 0 just before and read just after."""
    from ecg_denoise_tpu_torch.kernels.null_copy import null_copy
    from ecg_denoise_tpu_torch.probes import chain, floor
    from ecg_denoise_tpu_torch.probes.floor import cold_copy_us, graph_us

    gen = torch.Generator().manual_seed(27)
    max_err = 0.0
    yardsticks = {"parent": parent_null_copy} if parent_libs() else {}
    for n in NULL_COPY_SIZES:
        for offset in (0, 1):
            x = torch.randn(n + offset, generator=gen).cuda()[offset:]
            want = x.clone()
            got = {"null_copy": null_copy(x), **{k: f(x) for k, f in yardsticks.items()}}
            torch.cuda.synchronize()
            same = {k: torch.equal(y, want) and y.data_ptr() != x.data_ptr()
                    for k, y in got.items()}
            max_err = max(max_err, (got["null_copy"] - want).abs().max().item())
            log(f"[17] {n} float32 values, {x.data_ptr() % 16} bytes past a 16-byte boundary, "
                "equal to clone() bit for bit: " + ", ".join(f"{k} {v}" for k, v in same.items()))
            check(all(same.values()), f"a copy of {n} values is not clone()")

    # Times at the q of a (64, 8) call at B = 1024, the dma floor of B5's
    # shape, on the card's clock (50 calls replayed from one CUDA graph a
    # reading), from copies of q that outgrow the L2 into outputs that are
    # kept: the bytes move to and from HBM. Each comparison is settled over
    # SETTLE_ROUNDS rounds in turns.
    def cold(x):
        return lambda f: cold_copy_us(f, x, 50)

    def copy_(t):
        return torch.empty_like(t).copy_(t)

    q = torch.randn(BATCH, 8, 64, 4, generator=gen).cuda()
    nbytes = 2 * q.numel() * q.element_size()
    settled = {"copy_": settle(("null_copy", null_copy), ("copy_", copy_), cold(q))}
    what = (f"at a (64, 8) call's q, B={BATCH} ({nbytes / 1e6:.1f} MB read and written; 50 "
            "graph replays a reading, copies cycled past the L2)")
    log(f"[17] {card}: " + settled_text(settled["copy_"], what))
    if parent_libs():
        # The parent's P2 in turns at the dma floor's q (probes.floor's
        # (256, 2) stage at each batch; B = 1024 is the q above) and at the
        # null tile (NULL_CALLS replays a reading).
        for B in floor.BATCHES:
            x = torch.randn(B, 2, 256, 4, generator=gen).cuda()
            settled[f"parent_B{B}"] = got = settle(
                ("null_copy", null_copy), ("parent", parent_null_copy), cold(x))
            log(f"[17] {card}: " + settled_text(
                got, f"at the dma floor's q, (L, H) = (256, 2), B={B} ({x.numel()} values)"))
        tile = torch.ones(8, 128, device="cuda")
        settled["parent_null_tile"] = got = settle(
            ("null_copy", null_copy), ("parent", parent_null_copy),
            lambda f: graph_us(lambda: f(tile), floor.NULL_CALLS))
        log(f"[17] {card}: " + settled_text(
            got, f"at the null tile, (8, 128) ({floor.NULL_CALLS} graph replays a reading)"))
    times = {"ms": settled["copy_"]["median_us"][0] / 1e3,
             "plain_ms": cold_copy_us(torch.clone, q, 50) / 1e3,
             "library_ms": settled["copy_"]["median_us"][1] / 1e3,
             "bound_ms": nbytes / PEAK_BYTES * 1e3, "settled": settled}
    eager = cuda_ms(lambda: null_copy(q), 50)
    log(f"[17] {card}: null_copy {what}: kernel {times['ms']:.5f} ms (median), bound "
        f"{times['bound_ms']:.5f} ms (bytes), plain clone() {times['plain_ms']:.5f} ms, copy_ "
        f"{times['library_ms']:.5f} ms (median); issued from Python {eager:.4f} ms per call")
    reset_launches()  # the probes' path
    floor_result = floor.main()
    chain_result = chain.main()
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[17] kernel launches on the probes' path: {launches}")
    check(launches["null_copy"] > 0 and launches["attention_dense_fwd"] > 0
          and launches["attention_fwd"] > 0, "the probes did not launch their kernels")
    times["max_abs_err"] = max_err
    times["null_launch_host_us"] = floor_result["null"]["host_us"]
    times["null_launch_graph_us"] = floor_result["null"]["graph_us"]
    times["dma_floor_us"] = {f"L{r['L']}_H{r['H']}_B{r['batch']}": r["dma_us"]
                             for r in floor_result["rows"]}
    return launches, times


def precision_bound_terms(kernel, precision, shape):
    """(operations, bytes) lower bounds in ms for one precision-probe call:
    the products' flops over the peak of the path (f32 CUDA cores for ieee,
    TF32 or bf16 tensor cores; three TF32 passes for tf32x3) plus the
    elementwise work (row max, subtract, exp, sum, divide: one operation
    each) over the f32 peak; each input read once and each output written
    once, in f32, over HBM bandwidth."""
    peak = {"ieee": PEAK_F32_FLOPS, "tf32": PEAK_TF32_FLOPS, "tf32x3": PEAK_TF32_FLOPS,
            "bf16": PEAK_BF16_FLOPS, None: PEAK_F32_FLOPS}[precision]
    passes = 3 if precision == "tf32x3" else 1
    if kernel == "probe_dot":
        M, K, N = shape
        t_ops = passes * 2 * M * K * N / peak
        nbytes = 4 * (M * K + K * N + M * N)
    elif kernel == "probe_fold":
        L, D = shape
        t_ops = passes * 2 * (D + 1) * L * L / peak + (3 * L * L + D * L) / PEAK_F32_FLOPS
        nbytes = 4 * (L * L + 2 * D * L)
    elif kernel == "probe_tree":
        L, D = shape
        t_ops = (5 * L * L + 2 * D * L * L) / PEAK_F32_FLOPS
        nbytes = 4 * (L * L + 2 * D * L)
    else:
        n = shape[0] * shape[1]
        t_ops, nbytes = n / PEAK_F32_FLOPS, 12 * n
    return t_ops * 1e3, nbytes / PEAK_BYTES * 1e3


def sdpa_backend(sdpa):
    """The SDPA backends that take the call `sdpa` and give the default
    call's output bit for bit: the one PyTorch's dispatch chose is among
    them."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    want = sdpa()
    same = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # why each other backend declines
                got = sdpa()
        except RuntimeError:  # the backend does not take these operands
            continue
        if torch.equal(got, want):
            same.append(backend.name)
    check(len(same) > 0, "no SDPA backend gives the default call's output")
    return same


def matmul_tf32(a, b, allow):
    """torch.matmul with TF32 allowed or not for this call only."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def phase_precision(card):
    """P1: the precision probes against their plain versions, the probe
    itself with the counts set to 0 just before and read just after, and
    each kernel's time beside its bound, plain version and library call."""
    from ecg_denoise_tpu_torch.kernels import precision as probes
    from ecg_denoise_tpu_torch.probes import precision as probe
    from ecg_denoise_tpu_torch.probes.floor import graph_us

    rng = np.random.default_rng(28)

    def on_card(*shapes):
        return [torch.from_numpy(rng.standard_normal(s, np.float32)).cuda() for s in shapes]

    max_err = dict.fromkeys(PRECISION_KERNELS, 0.0)
    for M, K, N in PRECISION_DOT_SHAPES:
        a, b = on_card((M, K), (K, N))
        for p in probes.PRECISIONS:
            got, again = probes.probe_dot(a, b, p), probes.probe_dot(a, b, p)
            torch.cuda.synchronize()
            err = (got.double() - probes.dot_plain(a, b, p).double()).abs()
            tol = probes.dot_tolerance(a, b, p)
            log(f"[18] probe_dot {p} (M, K, N)=({M}, {K}, {N}): max_abs_err={err.max().item():.3e}, "
                f"at most {(err / tol).max().item():.3e} of its bound c K 2^-24 (|A_r| . |B_r|)")
            if parent_libs():
                log(f"[18] probe_dot {p} (M, K, N)=({M}, {K}, {N}): bit-identical to the "
                    f"parent's dot: {torch.equal(got, parent_dot(a, b, p))}")
            check(got.shape == (M, N) and torch.equal(got, again), "probe_dot calls differ")
            check(bool((err <= tol).all()), "probe_dot disagrees with its plain version")
            max_err["probe_dot"] = max(max_err["probe_dot"], err.max().item())
    for L, D in PRECISION_SOFTMAX_SHAPES:
        logits, v = on_card((L, L), (D, L))
        logits = 2.0 * logits
        cases = [(p, "probe_fold", functools.partial(probes.probe_fold, logits, v, p),
                  probes.fold_plain(logits, v, p),
                  parent_libs() and functools.partial(parent_fold, logits, v, p))
                 for p in probes.PRECISIONS]
        cases.append(("f32", "probe_tree", functools.partial(probes.probe_tree, logits, v),
                      probes.tree_plain(logits, v),
                      parent_libs() and functools.partial(parent_tree, logits, v)))
        for p, kernel, run, ref, parent in cases:
            got, again = run(), run()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = SOFTMAX_TOL_OF_MAX * ref.abs().max().item()
            identical = parent and torch.equal(got, parent())
            log(f"[18] {kernel} {p} (L, D)=({L}, {D}): max_abs_err={err:.3e} (tol {tol:.3e})"
                + (f"; bit-identical to the parent's: {identical}" if parent else ""))
            check(got.shape == (D, L) and torch.equal(got, again), f"{kernel} calls differ")
            check(err <= tol, f"{kernel} disagrees with its plain version")
            check(identical is not False, f"{kernel} is not the parent's bit for bit")
            max_err[kernel] = max(max_err[kernel], err)
        # The fold's and the tree's library call, against tree_plain.
        ref = probes.tree_plain(logits, v)
        err = (softmax_pv_sdpa(logits, v)() - ref).abs().max().item()
        tol = SOFTMAX_TOL_OF_MAX * ref.abs().max().item()
        log(f"[18] SDPA (zero q and k, the logits as its mask) (L, D)=({L}, {D}): "
            f"max_abs_err against tree_plain {err:.3e} (tol {tol:.3e})")
        check(err <= tol, "SDPA with zero q and k is not softmax(logits) . v^T")
    for shape in PRECISION_DIV_SHAPES:
        num = rng.standard_normal(shape).astype(np.float32)
        den = (0.5 + rng.random(shape)).astype(np.float32)
        for offsets in PRECISION_DIV_OFFSETS:
            n, d = (torch.from_numpy(np.concatenate([np.zeros(off, np.float32), x.ravel()]))
                    .cuda()[off:].view(shape) for x, off in zip((num, den), offsets))
            got, again = probes.probe_div(n, d), probes.probe_div(n, d)
            host = got.cpu().numpy()
            same = (torch.equal(got, torch.div(n, d)) and torch.equal(got, again)
                    and np.array_equal(host.view(np.uint32), (num / den).view(np.uint32)))
            parent = parent_libs() and torch.equal(got, parent_div(n, d))
            log(f"[18] probe_div {shape}, operands {n.data_ptr() % 16} and {d.data_ptr() % 16} "
                f"bytes past a 16-byte boundary: bit for bit torch.div, numpy and itself: {same}"
                + ("" if parent is None else f"; bit-identical to the parent's: {parent}"))
            check(same, "probe_div is not IEEE division")
            check(parent is not False, "probe_div is not the parent's bit for bit")

    reset_launches()  # the precision probe's path
    result = probe.main()
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[18] kernel launches on the precision probe's path: {launches}")
    check(all(launches[k] > 0 for k in PRECISION_KERNELS)
          and all(n == 0 for k, n in launches.items() if k not in PRECISION_KERNELS),
          "the precision probe did not launch exactly its four kernels")
    f32_paths = [result["dot"]["ieee"], result["dot"]["tf32x3"], result["fold"]["ieee"],
                 result["fold"]["tf32x3"], result["tree"]]
    numbers = [x for case in [result["host_bf16"], result["tree"], result["div"],
                              *result["dot"].values(), *result["fold"].values()]
               for x in (case["max_rel"], case["abs_of_max"])]
    check(all(np.isfinite(numbers)), "the precision probe printed a non-finite error")
    check(all(case["abs_of_max"] <= PROBE_F32_TOL_OF_MAX for case in f32_paths),
          "an f32-accurate path of the probe is off float64")
    check(result["div"]["bit_exact"], "the probe's divide is not numpy's")
    for case, readings in (("dot", PROBE_DOT_READINGS), ("fold", PROBE_FOLD_READINGS)):
        for p, want in readings.items():
            got = (result[case][p]["abs_of_max"], result[case][p]["med_rel"])
            same = all(abs(g - w) <= PROBE_READING_RTOL * w for g, w in zip(got, want))
            log(f"[18] the probe's {case} {p}: max_abs/max|exact| {got[0]:.4e}, med_rel "
                f"{got[1]:.4e}; the first version's {want[0]:.3e}, {want[1]:.3e}: equal within "
                f"{PROBE_READING_RTOL:.0e} relative: {same}")
            check(same, f"the probe's {p} {case} readings moved")

    # Times at the probe's own operands, each from 20 calls replayed from
    # one CUDA graph (CUDA events): a call this short, issued from Python,
    # would time the host.
    ops = {k: torch.from_numpy(x).cuda() for k, x in probe.operands().items()}
    a, b, logits, v, num, den = (ops[k] for k in ("a", "b", "logits", "v", "num", "den"))
    abf, bbf = a.to(torch.bfloat16), b.to(torch.bfloat16)
    exact = a.double() @ b.double()
    library = {  # tf32x3 has no PyTorch call: cuBLAS's f32 product stands in
        "ieee": lambda: matmul_tf32(a, b, False), "tf32": lambda: matmul_tf32(a, b, True),
        "tf32x3": lambda: matmul_tf32(a, b, False), "bf16": lambda: torch.matmul(abf, bbf)}
    rows = []
    for p in probes.PRECISIONS:
        lib_err = ((library[p]().double() - exact).abs().max() / exact.abs().max()).item()
        log(f"[18] library {p} matmul: max_abs/max|exact|={lib_err:.3e}")
        rows.append(("probe_dot", p, (probe.L, probe.L, probe.L),
                     functools.partial(probes.probe_dot, a, b, p),
                     functools.partial(probes.dot_plain, a, b, p), library[p]))
    sdpa = softmax_pv_sdpa(logits, v)
    log(f"[18] SDPA at the probe's operands: the backends that give its output bit for bit: "
        f"{', '.join(sdpa_backend(sdpa))}")
    for p in probes.PRECISIONS:
        rows.append(("probe_fold", p, (probe.L, probe.D),
                     functools.partial(probes.probe_fold, logits, v, p),
                     functools.partial(probes.fold_plain, logits, v, p), sdpa))
    rows.append(("probe_tree", None, (probe.L, probe.D),
                 functools.partial(probes.probe_tree, logits, v),
                 functools.partial(probes.tree_plain, logits, v), sdpa))
    parents = {"probe_dot": lambda p: functools.partial(parent_dot, a, b, p),
               "probe_fold": lambda p: functools.partial(parent_fold, logits, v, p),
               "probe_tree": lambda p: functools.partial(parent_tree, logits, v)}
    rows.append(("probe_div", None, tuple(num.shape), functools.partial(probes.probe_div, num, den),
                 functools.partial(probes.div_plain, num, den),
                 functools.partial(torch.div, num, den)))
    times = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                 "operations": 0.0, "bytes": 0.0, "by_precision": {}} for k in PRECISION_KERNELS}
    for kernel, p, shape, run, plain, lib in rows:
        t_ops, t_bytes = precision_bound_terms(kernel, p, shape)
        row = {"ms": graph_us(run, 20) / 1e3, "plain_ms": graph_us(plain, 20) / 1e3,
               "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes
               else "bytes", "library_ms": None if lib is None else graph_us(lib, 20) / 1e3}
        turns = ""
        if kernel in parents:
            # In turns with the library call (torch.matmul, SDPA) and, where
            # its tree is there, with the parent's kernel on the same operands.
            lib_us, new_us = in_turns(lib, run)
            turns = (f"; in turns: {'torch.matmul' if kernel == 'probe_dot' else 'SDPA'} "
                     f"{lib_us[0]:.2f} / {lib_us[1]:.2f} us, this {new_us[0]:.2f} / "
                     f"{new_us[1]:.2f} us")
            if parent_libs():
                old_us, more = in_turns(parents[kernel](p), run)
                new_us += more
                row["parent_ms"] = statistics.mean(old_us) / 1e3
                turns += (f"; the parent's {kernel[6:]} {old_us[0]:.2f} / {old_us[1]:.2f} us, "
                          f"this {more[0]:.2f} / {more[1]:.2f} us")
            row["ms"] = statistics.mean(new_us) / 1e3
            row["library_ms"] = statistics.mean(lib_us) / 1e3
        log(f"[18] {card}: {kernel} {p or 'f32'} {shape}: kernel {row['ms']:.5f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}: operations {t_ops:.5f}, bytes "
            f"{t_bytes:.5f}), plain {row['plain_ms']:.5f} ms, library "
            + ("none" if lib is None else f"{row['library_ms']:.5f} ms")
            + " (20 calls replayed from one CUDA graph, CUDA events)" + turns)
        total = times[kernel]
        for key in ("ms", "plain_ms", "bound_ms"):
            total[key] += row[key]
        total["operations"] += t_ops
        total["bytes"] += t_bytes
        total["library_ms"] = None if lib is None else total["library_ms"] + row["library_ms"]
        if p is not None:
            total["by_precision"][p] = row
    # P1's divide settled against torch.div and, where its tree is there,
    # the parent's divide, each reading LAUNCH_FLOOR_CALLS replays of one
    # graph.
    div = ("probe_div", functools.partial(probes.probe_div, num, den))
    others = {"torch.div": functools.partial(torch.div, num, den)}
    if parent_libs():
        others["parent"] = functools.partial(parent_div, num, den)
    settled = {key: settle(div, (key, f), lambda f: graph_us(f, LAUNCH_FLOOR_CALLS))
               for key, f in others.items()}
    for got in settled.values():
        log(f"[18] {card}: " + settled_text(
            got, f"on the probe's {tuple(num.shape)} operands ({LAUNCH_FLOOR_CALLS} graph "
                 "replays a reading)"))
    times["probe_div"].update(ms=settled["torch.div"]["median_us"][0] / 1e3,
                              library_ms=settled["torch.div"]["median_us"][1] / 1e3,
                              settled=settled)
    for kernel, total in times.items():
        total["bound_by"] = "operations" if total.pop("operations") > total.pop("bytes") else "bytes"
        total["max_abs_err"] = max_err[kernel]
    return launches, times


def phase_family_model(name, cpu_model, tag, want):
    """The model's f32 forward on the card against the CPU (MODEL_TOL),
    with the kernel launches `want`."""
    from ecg_denoise_tpu_torch.models import build_model

    before = tf32_flags()
    gpu_model = build_model(name).eval()  # default device: the card
    log(f"[{tag}] TF32 (matmul, cuDNN) before build_model: {before}, after: {tf32_flags()}")
    check(tf32_flags() == (False, False), "the package left TF32 on for the card")
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, cpu_model.in_channels, 256)).astype(np.float32))
    reset_launches()
    with torch.no_grad():
        y = gpu_model(x.cuda())
        torch.cuda.synchronize()
        launches = read_launches()
        err = (y.cpu() - cpu_model(x)).abs().max().item()
    log(f"[{tag}] {name}, batch 8, float32: card vs CPU max_abs_err={err:.3e} (tol "
        f"{MODEL_TOL:.0e}); kernel launches per forward "
        f"{ {k: n for k, n in launches.items() if n} or 'none'}")
    check(launches == want, f"{name}'s forward launched other kernels than {want}")
    check(bool(torch.isfinite(y).all()) and err <= MODEL_TOL,
          f"{name}'s forward on the card disagrees with the CPU's")
    return gpu_model


def phase_serve_cli(name, cpu_model, tag, want, path):
    """`cli.serve --model name`'s server (built by the CLI's own `build`
    from a checkpoint of `cpu_model`) answers /healthz, naming the
    inference path `path`, /denoise for 1, 37 and BATCH windows and
    /denoise_record, each answer equal to its Denoiser called directly; the
    counts set to 0 just before and read just after must be `want`."""
    from ecg_denoise_tpu_torch.cli.serve import build

    c = cpu_model.in_channels
    rng = np.random.default_rng(2)
    requests = {n: rng.standard_normal((n, c, 256)).astype(np.float32)
                for n in (1, 37, BATCH)}
    record = rng.standard_normal((c, 5000)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, f"{name}.pt")
        torch.save(cpu_model.state_dict(), ckpt)
        server, denoiser = build(["--model", name, "--ckpt", ckpt, "--port", "0",
                                  "--max_batch", str(BATCH), "--warmup_max", str(BATCH)])
    direct = {n: denoiser(x) for n, x in requests.items()}
    direct_record = denoiser.denoise_record(record, stride=128)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_launches()  # the main path
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        log(f"[{tag}] /healthz: {health}")
        check(health["model"] == name and denoiser.channels == c, "the served model")
        check(health["inference_path"] == denoiser.inference_path == path,
              f"inference path: {health['inference_path']!r}, not {path!r}")
        for n, x in requests.items():
            y, timing = _post(url + "/denoise", x)
            err = float(np.abs(y - direct[n]).max())
            log(f"[{tag}] {name} /denoise N={n}: max_abs_err vs Denoiser={err:.3e}; {timing}")
            check(y.shape == x.shape and np.isfinite(y).all() and err <= 1e-6,
                  "/denoise disagrees with Denoiser")
        y, _ = _post(url + "/denoise_record?stride=128", record)
        err = float(np.abs(y - direct_record).max())
        log(f"[{tag}] {name} /denoise_record {record.shape}: max_abs_err vs Denoiser={err:.3e}")
        check(y.shape == record.shape and err <= 1e-6,
              "/denoise_record disagrees with Denoiser")
        launches = read_launches()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    log(f"[{tag}] {name}: kernel launches on the serving path: {launches}")
    check(launches == want, f"{name}'s serving path launched other kernels than {want}")
    check(not thread.is_alive(), "the server thread did not stop")
    return launches


def phase_family_step(name, cpu_model, tag, want, frozen=()):
    """One f32 Adam step at TRAIN_BATCH on the card against the same step
    on the CPU, with the kernel launches `want`: the loss (LOSS_RTOL), the
    BN running stats (BN_STATS_TOL), and, as `step_bars` holds them, the
    gradients against the same step in float64 (the CPU's, for NewRale) and
    the parameters against the CPU's; the parameters named in `frozen`
    and their modules' BN stats stay as they were, bit for bit, on both
    sides."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.train import create_train_state, train_step

    rng = np.random.default_rng(6)
    noisy, clean = (torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, cpu_model.in_channels, 256)).astype(np.float32)) for _ in range(2))
    before = {k: t.clone() for k, t in cpu_model.state_dict().items()}
    cpu_state = create_train_state(copy.deepcopy(cpu_model), device="cpu", frozen=frozen)
    model = build_model(name)
    model.load_state_dict(cpu_model.state_dict())
    state = create_train_state(model, frozen=frozen)
    reset_launches()
    loss = train_step(state, noisy.cuda(), clean.cuda())[0].item()
    torch.cuda.synchronize()
    launches = read_launches()
    ref = train_step(cpu_state, noisy, clean)[0].item()
    cpu_params = dict(cpu_state.model.named_parameters())
    trained = {k: p for k, p in state.model.named_parameters() if p.grad is not None}
    # The card's gradients against the exact (float64) ones where the model
    # computes in float64; NewRale's core runs the attention kernels, which
    # take float32 and bfloat16 only, so its adapters' are held against the
    # CPU's.
    cpu_grads = {k: cpu_params[k].grad for k in trained}
    if name in FAMILIES:
        ref_grads = float64_grads(cpu_model, noisy, clean)
        cpu_reading = step_bars(cpu_grads, ref_grads, before, before)["grads"]
        against = (f"float64 on the CPU (the CPU's float32 gradients: at most "
                   f"{cpu_reading:.3f} of the same bars)")
    else:
        ref_grads, against = cpu_grads, "the CPU's"
    bars = step_bars({k: p.grad.cpu() for k, p in trained.items()}, ref_grads,
                     {k: p.detach().cpu() for k, p in trained.items()},
                     {k: cpu_params[k].detach() for k in trained})
    cpu_sd = cpu_state.model.state_dict()
    stats = max([(val.cpu() - cpu_sd[key]).abs().max().item()
                 for key, val in state.model.state_dict().items()
                 if key.endswith(("running_mean", "running_var"))], default=0.0)
    frozen_prefixes = tuple(n.rsplit(".", 1)[0] + "." for n in frozen)
    n_frozen = 0
    for key, val in state.model.state_dict().items():
        if key.startswith(frozen_prefixes):
            n_frozen += 1
            check(torch.equal(val.cpu(), before[key])
                  and torch.equal(cpu_sd[key], before[key]),
                  f"the frozen {key} changed")
    log(f"[{tag}] {name}, float32, batch {TRAIN_BATCH}: one Adam step on the card vs the "
        f"CPU: loss {loss:.7f} vs {ref:.7f} (rel {abs(loss - ref) / abs(ref):.2e}, tol "
        f"{LOSS_RTOL:.0e}), BN stats max diff {stats:.2e} (tol {BN_STATS_TOL:.0e}), "
        f"gradients against {against}; {describe_bars(bars)}; {n_frozen} frozen state "
        f"tensors unchanged bit for bit on both sides; launches "
        f"{ {k: n for k, n in launches.items() if n} or 'none'}")
    check(launches == want, f"{name}'s step launched other kernels than {want}")
    check(abs(loss - ref) <= LOSS_RTOL * abs(ref) and stats <= BN_STATS_TOL and bars["ok"],
          f"{name}'s training step on the card disagrees with the CPU's")
    check(bool(frozen) == (n_frozen > 0), "the frozen parameters were not found")


def step_bars(grads, ref_grads, params, ref_params):
    """One Adam step's gradients and parameters (dicts of host tensors by
    parameter name, over the names of `grads`) against a reference's
    gradients and parameters.

    The gradients are held per tensor: within STEP_GRAD_TOL_OF_MAX of the
    tensor's largest reference gradient (`grads` is the worst ratio of an
    error to that bar). An element is at the rounding floor when its
    reference gradient is at most GRAD_FLOOR_OF_MAX of the largest
    reference gradient, `floor`; the reference alone decides it. There the
    gradient's bar is `floor` where that is larger, and the parameter is
    not held: Adam's first step moves it by lr g / (|g| + eps), lr times
    the sign of a rounding error where the exact gradient is 0 (a bias
    before a training-mode BatchNorm). Every other element's parameter is
    held to PARAM_TOL (`params`). A tensor may sit at the floor whole only
    if it is a bias (`whole`); `at_floor` counts the elements at the floor
    per tensor. `ok` says whether every bar held."""
    scale = max(g.abs().max().item() for g in ref_grads.values())
    out = {"floor": GRAD_FLOOR_OF_MAX * scale, "grad_scale": scale, "grads": 0.0,
           "params": 0.0, "kept": 0, "at_floor": {}, "whole": []}
    for key, g in grads.items():
        g_ref = ref_grads[key]
        err = (g.to(g_ref.dtype) - g_ref).abs()
        bar = STEP_GRAD_TOL_OF_MAX * g_ref.abs().max().item()
        low = g_ref.abs() <= out["floor"]
        if low.all():
            out["whole"].append(key)
        if low.any():
            out["at_floor"][key] = int(low.sum())
            out["grads"] = max(out["grads"], err[low].max().item() / max(bar, out["floor"]))
        if not low.all():
            kept = ~low
            out["kept"] += int(kept.sum())
            out["grads"] = max(out["grads"], err[kept].max().item() / bar)
            out["params"] = max(out["params"], (
                params[key] - ref_params[key])[kept].abs().max().item())
    out["ok"] = (out["grads"] <= 1 and out["params"] <= PARAM_TOL
                 and all(k.endswith("bias") for k in out["whole"]))
    return out


def describe_bars(bars):
    """`step_bars`' reading in one line."""
    partial = {k: n for k, n in bars["at_floor"].items() if k not in bars["whole"]}
    return (f"gradients at most {bars['grads']:.3f} of their bars ({STEP_GRAD_TOL_OF_MAX:.0e} "
            f"of each tensor's largest), params max diff {bars['params']:.2e} (tol "
            f"{PARAM_TOL:.0e}) over {bars['kept']} elements; at the rounding floor "
            f"({GRAD_FLOOR_OF_MAX:.0e} of max|grad| {bars['grad_scale']:.3e} = "
            f"{bars['floor']:.2e}): {sum(bars['at_floor'].values())} elements, the whole of "
            f"{len(bars['whole'])} biases ({sum(bars['at_floor'][k] for k in bars['whole'])} "
            f"elements) and {sum(partial.values())} in {len(partial)} other tensors "
            f"{partial or ''}")


def float64_grads(model, noisy, clean):
    """The gradients of one step's loss, as `train_step` computes it, for a
    float64 copy of `model` on the CPU: exact, to float32's eye. The port
    computes its norms and means in float32 by `.float()` and casts its
    input to a module's `dtype`; here `.float()` leaves a float64 tensor
    as it is and every such `dtype` is float64."""
    from ecg_denoise_tpu_torch.models import apply

    m = copy.deepcopy(model).double().train()
    for mod in m.modules():
        if getattr(mod, "dtype", None) == torch.float32:
            mod.dtype = torch.float64
    real = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else real(t, *a, **k)
    try:
        pred = apply(m, noisy.double())
        torch.mean((pred - clean.double()) ** 2).backward()
    finally:
        torch.Tensor.float = real
    check(pred.dtype == torch.float64, "the float64 step computed in another dtype")
    return {k: p.grad for k, p in m.named_parameters()}


def phase_family_times(name, cpu_model, card, tag, frozen=(), repeats=EPOCH_REPEATS):
    """Denoiser windows/s at BATCH and train_epoch windows/s at
    TIMING_BATCH, f32 and bf16, over EPOCH_WINDOWS-window epochs; the
    device-resident forward's and a step's time on the card's clock; the
    f32 forward's device breakdown and idle share."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.serving import Denoiser
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns, train_step

    c = cpu_model.in_channels
    rng = np.random.default_rng(12)
    x = rng.standard_normal((BATCH, c, 256)).astype(np.float32)
    noisy, clean = (torch.from_numpy(rng.standard_normal(
        (EPOCH_WINDOWS, c, 256)).astype(np.float32)).cuda() for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        model = build_model(name, dtype=dtype).eval()
        model.load_state_dict(cpu_model.state_dict())
        denoiser = Denoiser(model, max_batch=BATCH)
        check(np.isfinite(denoiser(x)).all(), "non-finite Denoiser output")
        walls = [_timed(denoiser, x) for _ in range(10)]
        xd = torch.from_numpy(x).cuda()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(xd), 10)
        log(f"[{tag}] {card}: {name} Denoiser {dt} batch {BATCH}: "
            f"{BATCH / statistics.median(walls):.1f} windows/s (median of 10 calls, host "
            f"clock, min {BATCH / max(walls):.1f} max {BATCH / min(walls):.1f}); "
            f"device-resident forward {fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.1f} "
            f"windows/s (CUDA events, mean of 10)")
        if dtype == torch.float32:
            profile_forward(lambda: model(xd), f"{name} {dt} forward B={BATCH}", fwd_ms,
                            card, tag=tag)
        model = build_model(name, dtype=dtype)
        model.load_state_dict(cpu_model.state_dict())
        state = create_train_state(model, frozen=frozen)
        train_epoch, _ = make_epoch_fns(state.model, state.optimizer)
        gen = torch.Generator(device="cuda").manual_seed(0)
        b = TIMING_BATCH
        train_epoch(noisy[:4 * b], clean[:4 * b], gen, b)  # warm-up
        n = EPOCH_WINDOWS // b * b
        walls = [_timed(train_epoch, noisy, clean, gen, b) for _ in range(repeats)]
        step_ms = cuda_ms(lambda: train_step(state, noisy[:b], clean[:b]), 5)
        log(f"[{tag}] {card}: {name} train_epoch {dt} batch {b}: "
            f"{n / statistics.median(walls):.1f} windows/s (median of {repeats} epochs of "
            f"{n // b} steps, host clock ending in the epoch's one fetch; each epoch: "
            + ", ".join(f"{n / w:.1f}" for w in walls) + f"); one step {step_ms:.3f} ms on "
            "the card's clock (CUDA events, mean of 5)")


def phase_frozen_bias_backward(card):
    """B2 with a bias and no dbias (the frozen core of 12-lead transfer: its
    rel-pos tables do not require grad) at the five stage shapes, f32 and
    bf16, B = TIMING_BATCH: through the autograd Function and through the
    wrapper with want_dbias=False, dq, dk and dv against the plain flash
    backward on the forward kernel's own o and lse (GRAD_TOL; bf16
    BF16_GRAD_TOL_OF_MAX of max|grad|) and bit for bit those of the same
    call with dbias; then, in f32, the kernel's time without dbias beside
    its time with it (graph replays in turns). Returns the f32 max error
    and one step's 14 biased calls' times both ways."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention import fused_attention

    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(13)
    max_err = 0.0
    totals = {"without_dbias_ms": 0.0, "with_dbias_ms": 0.0}
    for (L, H, with_bias), calls in FORWARD_CALLS.items():
        if not with_bias:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = operands(TIMING_BATCH, H, L, True, dtype, gen)
            g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            before = fused_attention.bwd_launches
            grads = torch.autograd.grad(fused_attention(*ins, bias), ins, g)
            torch.cuda.synchronize()
            check(fused_attention.bwd_launches == before + 1, "the backward kernel did not run")
            o, lse = attention._launch(q, k, v, bias, with_lse=True)
            bare = attention._launch_bwd(q, k, v, bias, o, lse, g, want_dbias=False)
            full = attention._launch_bwd(q, k, v, bias, o, lse, g, want_dbias=True)
            ref = attention.attention_backward_reference(q, k, v, bias, o, lse, g)
            check(bare[3] is None and full[3] is not None, "dbias where none was asked")
            same = all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(grads, bare, full))
            errs = []
            for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
                scale = b.float().abs().max().item()
                tol = BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16 else GRAD_TOL
                err = (a.float() - b.float()).abs().max().item()
                errs.append(f"{name} {err:.2e}/{tol:.2e}")
                check(err <= tol, f"B2 without dbias: {name} disagrees with the plain backward")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
            timing = ""
            if dtype == torch.float32:
                lib = attention._bwd_library()
                args = (q, k, v, bias, o, lse, g)
                without, with_ = in_turns(lambda: b2_call(lib, *args, False),
                                          lambda: b2_call(lib, *args, True))
                ms = statistics.mean(without) / 1e3, statistics.mean(with_) / 1e3
                totals["without_dbias_ms"] += calls * ms[0]
                totals["with_dbias_ms"] += calls * ms[1]
                timing = (f"; {card}: without dbias {ms[0]:.4f} ms, with dbias {ms[1]:.4f} ms "
                          f"(graph replays in turns: without {without[0]:.1f} / "
                          f"{without[1]:.1f} us, with {with_[0]:.1f} / {with_[1]:.1f} us)")
            log(f"[20] B2 with a frozen bias, B={TIMING_BATCH} L={L} H={H} {str(dtype)[6:]}: "
                + ", ".join(errs) + f" against the plain flash backward; dq, dk, dv of "
                f"autograd, of want_dbias=False and of want_dbias=True bit-identical: "
                f"{same}{timing}")
            check(same, "B2's dq, dk, dv differ with and without dbias")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log(f"[20] {card}: B2, one NewRale step's 14 biased calls at B={TIMING_BATCH}, f32: "
        f"without dbias {totals['without_dbias_ms']:.4f} ms, with dbias "
        f"{totals['with_dbias_ms']:.4f} ms (graph replays in turns)")
    return max_err, totals


def phase_transfer_cli(card, core_ckpt):
    """The 12-lead training path: `python -m
    ecg_denoise_tpu_torch.cli.transfer_learning` (through runpy, as phase
    7b runs cli.main) for 10 bf16 epochs on a synthetic 12-lead cache, the
    core from `core_ckpt`: the test loss falls, the trained checkpoint's
    core is the core checkpoint's bit for bit, and the counts set to 0
    just before and read just after are 18 B1 launches a forward and 18 B2
    a step."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.serving import Denoiser
    from ecg_denoise_tpu_torch.train import load_model_weights
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    epochs, n, seed = 10, 400, 2023
    n_train = int(0.8 * n)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "ExternalData", "dict_data")
        write_dict_data(data, n, seed=9, channels=12)
        out_file = os.path.join(tmp, "output.txt")
        save_dir = os.path.join(tmp, "model_save")
        argv = ["--noise_type_index", "0", "--intensity_index", "0", "--epochs", str(epochs),
                "--batch_size", str(TRAIN_BATCH), "--seed", str(seed),
                "--external_path", data, "--core_ckpt", core_ckpt,
                "--model_save_dir", save_dir, "--output_file", out_file]
        # The weights the CLI starts from: it seeds, builds, loads the core.
        random_seed(seed)
        start = build_model("newrale")
        load_model_weights(core_ckpt, start.rale)
        initial = Denoiser(start, max_batch=256)
        te = np.random.default_rng(seed).permutation(n)[n_train:]
        te_n = np.load(os.path.join(data, "m4", "bw.npy"))[te]
        te_c = np.load(os.path.join(data, "ecg.npy"))[te]
        reset_launches()  # the main path
        wall = run_module("ecg_denoise_tpu_torch.cli.transfer_learning", argv, "20")
        launches = read_launches()
        with open(out_file) as f:
            line = f.read()
        ckpt = os.path.join(save_dir, "newrale", f"newrale_{epochs - 1}_bw_intensity-4.pth")
        check(os.path.exists(ckpt), "the transfer CLI wrote no checkpoint")
        trained = Denoiser.from_checkpoint("newrale", ckpt, max_batch=256)
        before, after = mse_of(initial, te_n, te_c), mse_of(trained, te_n, te_c)
        core = torch.load(core_ckpt, map_location="cpu", weights_only=True)["model"]
        got = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
        same_core = all(torch.equal(got[f"rale.{k}"], t) for k, t in core.items())
    steps = epochs * (n_train // TRAIN_BATCH)
    evals = epochs * -(-(n - n_train) // TRAIN_BATCH)
    log(f"[20] {card}: newrale, {epochs} bf16 epochs of {n_train} 12-lead windows in "
        f"{wall:.1f} s (host clock, start-up included); output.txt: {line.strip()}")
    log(f"[20] launches on the transfer path ({steps} steps, {evals} eval batches): "
        f"{launches}")
    log(f"[20] the checkpoint served by Denoiser.from_checkpoint('newrale'): test MSE "
        f"{before:.5f} with the initial adapters -> {after:.5f} trained; its core equals "
        f"the core checkpoint bit for bit: {same_core}")
    check(re.fullmatch(rf"newrale_{epochs - 1}_bw_intensity-4:snr:\S+, rmse:\S+\n",
                       line) is not None, "the output.txt line is malformed")
    forwards = steps + evals
    check(launches == expected_launches(fwd=18 * forwards, bwd=18 * steps),
          "the transfer CLI's training did not go through its kernels")
    check(same_core, "the frozen core changed in training")
    check(np.isfinite(after) and after < before, "the test loss did not fall")
    return launches


def phase_families(card):
    """Phase 19: UNet, DANet and ACDAE at their own widths, each through
    the forward, the serving CLI, a training step, the training CLI and
    its times; no attention kernel on any of their paths."""
    t0 = time.perf_counter()
    launches = {"serve_families": expected_launches(),
                "train_families": expected_launches()}
    for i, name in enumerate(FAMILIES):
        cpu_model = seeded_model(20 + i, name)
        phase_family_model(name, cpu_model, "19", expected_launches())
        served = phase_serve_cli(name, cpu_model, "19", expected_launches(), "torch:cuda")
        phase_family_step(name, cpu_model, "19", expected_launches())
        trained = phase_train_cli(card, tag="19", name=name)
        for path, got in (("serve_families", served), ("train_families", trained)):
            launches[path] = {k: launches[path][k] + n for k, n in got.items()}
        phase_family_times(name, cpu_model, card, "19")
    log(f"chip_smoke: phase 19 took {time.perf_counter() - t0:.1f} s")
    return launches


def phase_newrale(card, core_ckpt):
    """Phase 20: NewRale (12 leads) on a seeded RA-LENet core, its frozen
    step, B2 with a frozen bias, the transfer CLI with phase 7b's RA-LENet
    checkpoint as its core, the serving CLI, and times."""
    t0 = time.perf_counter()
    cpu_model = seeded_model(31, "newrale")  # the adapters, and a seeded core
    cpu_model.rale.load_state_dict(seeded_model(30).state_dict())
    phase_family_model("newrale", cpu_model, "20", expected_launches(fwd=18))
    phase_family_step("newrale", cpu_model, "20", expected_launches(fwd=18, bwd=18),
                      frozen=cpu_model.frozen_parameters())
    err, frozen_ms = phase_frozen_bias_backward(card)
    launches = {"train_newrale": phase_transfer_cli(card, core_ckpt)}
    # 4 forwards (buckets 1, 64, 1024 and the record's 39 windows in 64).
    launches["serve_newrale"] = phase_serve_cli("newrale", cpu_model, "20",
                                                expected_launches(fwd=4 * 18),
                                                "torch+attn-cuda:cuda")
    phase_family_times("newrale", cpu_model, card, "20",
                       frozen=cpu_model.frozen_parameters(), repeats=2)
    log(f"chip_smoke: phase 20 took {time.perf_counter() - t0:.1f} s")
    return launches, err, frozen_ms



def phase_build_caches(card, work):
    """Phase 21's builds: `cli.build_data` makes the WFDB, synthetic, cls
    and 12-lead caches from the checkout; each loads with its shapes."""
    from ecg_denoise_tpu_torch import NOISE_INTENSITIES, NOISE_TYPES
    from ecg_denoise_tpu_torch.data.cls_cache import load_cls_arrays
    from ecg_denoise_tpu_torch.data.dataset import EcgDataset

    no_records = os.path.join(work, "no_records")  # the synthetic fallback
    paths = {k: os.path.join(work, k) for k in ("wfdb", "synthetic", "cls", "external")}
    builds = {"wfdb": ["--data_root", MINI_PHYSIONET],
              "synthetic": ["--data_root", no_records, "--n_synth_records", "1"],
              "cls": ["--cls", "--data_root", no_records],
              "external": ["--external", "--n_synth_records", "1"]}
    for kind, argv in builds.items():
        wall = run_module("ecg_denoise_tpu_torch.cli.build_data",
                          ["--out", paths[kind], *argv], "21")
        log(f"[21] {card}: built the {kind} cache in {wall:.2f} s (host clock; numpy "
            "on the host, no device work)")
    for kind, n, c in (("wfdb", 128, 2), ("synthetic", CACHE_WINDOWS, 2),
                       ("external", CACHE_WINDOWS, 12)):
        for k in NOISE_INTENSITIES:
            ds = EcgDataset(NOISE_TYPES, k, path=paths[kind])
            want = (len(NOISE_TYPES) * n, c, 256)
            check(ds.data.shape == ds.ground_data.shape == want
                  and ds.data.dtype == np.float32 and np.isfinite(ds.data).all(),
                  f"the {kind} cache at {k} dB holds {ds.data.shape}, not {want}")
    for train, n in ((True, 2048), (False, 512)):
        for noised in (False, True):
            x, label = load_cls_arrays(train, noised, path=paths["cls"])
            check(x.shape == (2 * n, 2, 256) and np.isfinite(x).all()
                  and (label == 0).sum() == (label == 1).sum() == n,
                  f"the cls cache's {'train' if train else 'test'} split holds {x.shape}")
    log(f"[21] caches load: wfdb 128, synthetic and 12-lead {CACHE_WINDOWS} windows at "
        "every intensity and noise type, cls 2048 + 512 beats a class, clean and noised")
    return paths


def phase_mixer(card, clean, record):
    """Phase 21's mixer: `snr_noise_add` on the card against
    `snr_noise_add_at` on the CPU at the same offsets, each window at its
    target SNR; then its device time per batch."""
    from ecg_denoise_tpu_torch.data.noise import snr_noise_add, snr_noise_add_at

    x, rec = clean[:TIMING_BATCH], record
    L, n = x.shape[-1], rec.shape[0]
    worst_rel = worst_db = 0.0
    for snr in SNR_TARGETS:
        got = snr_noise_add(x, rec, snr, torch.Generator(device="cuda").manual_seed(3))
        starts = torch.randint(0, n - L - 1, (x.shape[0],),
                               generator=torch.Generator(device="cuda").manual_seed(3),
                               device="cuda")
        ref = snr_noise_add_at(x.cpu(), rec.cpu(), snr, starts.cpu())
        rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        xd, noise = x.double(), got.double() - x.double()
        db = 10 * torch.log10((xd ** 2).mean((1, 2)) / (noise ** 2).mean((1, 2)))
        off = (db - snr).abs().max().item()
        check(rel <= MIX_RTOL, f"the card's mix differs from the CPU's by {rel:.2e} relative")
        check(off <= SNR_DB_TOL, f"a window's SNR is {off:.2e} dB off its {snr} dB target")
        worst_rel, worst_db = max(worst_rel, rel), max(worst_db, off)
    log(f"[21] snr_noise_add on the card against snr_noise_add_at on the CPU at its offsets, "
        f"B={x.shape[0]}, record {tuple(rec.shape)}: within {worst_rel:.2e} of max|out| (bar "
        f"{MIX_RTOL:.0e}); every window within {worst_db:.2e} dB of its target at "
        f"{', '.join(f'{t:g}' for t in SNR_TARGETS)} dB (bar {SNR_DB_TOL:.0e})")
    starts = torch.randint(0, n - L - 1, (x.shape[0],), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    at_ms = cuda_ms(lambda: snr_noise_add_at(x, rec, 0.0, starts), 50)
    gen_ms = cuda_ms(lambda: snr_noise_add(x, rec, 0.0, gen), 50)
    log(f"[21] {card}: the mixer at B={x.shape[0]}, f32: snr_noise_add_at {at_ms:.4f} ms, "
        f"snr_noise_add (with the offsets' draw) {gen_ms:.4f} ms a batch (CUDA events, "
        "mean of 50)")
    return at_ms


def phase_augmented(card, paths):
    """Phase 21's training: the augmented epoch trains RA-LENet on the
    synthetic cache's clean windows with a synthetic 'bw' record on the
    card; `cli.main` trains on the port-built cache; then the augmented
    epoch against train_epoch on pre-mixed windows, in turns."""
    from ecg_denoise_tpu_torch.data.synth import synth_noise_record
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.train import (
        create_train_state,
        make_augmented_epoch_fn,
        make_epoch_fns,
    )
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    clean = torch.from_numpy(np.load(os.path.join(paths["synthetic"], "ecg.npy"))).cuda()
    record = torch.from_numpy(synth_noise_record("bw", 3023).astype(np.float32)).cuda()
    check(tuple(record.shape) == (650_000, 2), f"the noise record is {tuple(record.shape)}")
    mix_ms = phase_mixer(card, clean, record)

    random_seed(0)
    state = create_train_state(build_model("ralenet"))
    train_epoch = make_augmented_epoch_fn(state.model, state.optimizer, record, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = AUG_EPOCHS * (clean.shape[0] // TRAIN_BATCH)
    t0 = time.perf_counter()
    reset_launches()  # the augmented path
    losses = [train_epoch(clean, gen, TRAIN_BATCH)["loss"] for _ in range(AUG_EPOCHS)]
    torch.cuda.synchronize()
    launches = {"train_augmented": read_launches()}
    wall = time.perf_counter() - t0
    log(f"[21] {card}: make_augmented_epoch_fn, RA-LENet 'full' f32, batch {TRAIN_BATCH}, "
        f"{AUG_EPOCHS} epochs of {clean.shape[0]} clean windows at 0 dB in {wall:.1f} s "
        f"(host clock): losses {', '.join(f'{v:.5f}' for v in losses)}; launches "
        f"({steps} steps) {launches['train_augmented']}")
    check(launches["train_augmented"] == expected_launches(fwd=18 * steps, bwd=18 * steps),
          "the augmented epoch did not take 18 B1 and 18 B2 launches a step")
    check(np.isfinite(losses).all() and losses[-1] < losses[0], "the loss did not fall")

    launches["build_train"] = phase_train_cli(card, tag="21", data=paths["synthetic"])

    # Time: the augmented epoch against train_epoch on the cache's pre-mixed
    # windows (0 dB, 'bw'), f32, batch 256, in turns.
    noisy = torch.from_numpy(np.load(os.path.join(paths["synthetic"], "0", "bw.npy"))).cuda()
    b = TIMING_BATCH
    n = clean.shape[0] // b * b
    fns = []
    for augmented in (True, False):
        random_seed(0)
        st = create_train_state(build_model("ralenet"))
        g = torch.Generator(device="cuda").manual_seed(1)
        if augmented:
            fn = make_augmented_epoch_fn(st.model, st.optimizer, record, 0.0)
            fns.append(functools.partial(fn, clean, g, b))
        else:
            fn, _ = make_epoch_fns(st.model, st.optimizer)
            fns.append(functools.partial(fn, noisy, clean, g, b))
        fns[-1]()  # warm-up
    rates = {0: [], 1: []}
    for _ in range(2):
        for i in (0, 1, 1, 0):
            rates[i].append(n / _timed(fns[i]))
    log(f"[21] {card}: training windows/s, RA-LENet 'full' f32, batch {b}, epochs of {n} "
        f"windows in turns (augmented, pre-mixed, pre-mixed, augmented) x 2, host clock "
        f"ending in the epoch's one fetch: augmented (mixing on the card) median "
        f"{statistics.median(rates[0]):.1f} (" + ", ".join(f"{r:.1f}" for r in rates[0])
        + f"); train_epoch on pre-mixed windows median {statistics.median(rates[1]):.1f} ("
        + ", ".join(f"{r:.1f}" for r in rates[1]) + f"); the mix {mix_ms:.4f} ms a batch")
    return launches


def phase_data(card, work):
    """Phase 21: the data path, from raw records to training on the card."""
    t0 = time.perf_counter()
    paths = phase_build_caches(card, work)
    launches = phase_augmented(card, paths)
    log(f"chip_smoke: phase 21 took {time.perf_counter() - t0:.1f} s")
    return launches, paths


def phase_baseline(card, paths):
    """Phase 22: the DWT baseline on the card against the numpy path, the
    CLI on the card and on the host, and rows/s."""
    from ecg_denoise_tpu_torch.baselines.dwt import wavelet_denoise
    from ecg_denoise_tpu_torch.kernels.dwt import wavelet_denoise_device

    t0 = time.perf_counter()
    noisy = np.load(os.path.join(paths["synthetic"], "0", "emb.npy"))
    rows = noisy.reshape(-1, 256)
    check(rows.shape[0] >= DWT_ROWS[0], f"the cache holds {rows.shape[0]} rows")
    host_s = {}
    for x in (rows[:DWT_ROWS[0]], np.ascontiguousarray(rows[:DWT_RAGGED_ROWS, :203])):
        L = x.shape[-1]
        xd = torch.from_numpy(x).cuda()
        got = wavelet_denoise_device(xd)
        again = wavelet_denoise_device(xd)
        torch.cuda.synchronize()
        check(tf32_flags() == (False, False), "TF32 is on for the DWT's convolutions")
        t = time.perf_counter()
        ref = wavelet_denoise(x.astype(np.float64))[:, :L]
        host_s[x.shape] = time.perf_counter() - t
        err = float(np.abs(got.cpu().numpy() - ref).max())
        check(got.shape == x.shape and err <= DWT_TOL,
              f"wavelet_denoise_device at {x.shape} is {err:.2e} off the numpy path")
        check(torch.equal(got, again), "a second DWT call is not bit-identical")
        log(f"[22] wavelet_denoise_device on the card at {x.shape}: within {err:.2e} of the "
            f"numpy wavelet_denoise (bar {DWT_TOL:.0e}), a second call bit-identical, TF32 off")

    snrs = {}
    for extra in ([], ["--host"]):
        out = os.path.join(paths["synthetic"], f"dwt_dn{'_host' if extra else ''}.txt")
        reset_launches()  # the baseline's path
        wall = run_module("ecg_denoise_tpu_torch.cli.dwt_dn",
                          ["--noise_type_index", "0", "--intensity_index", "2",
                           "--data_path", paths["synthetic"], "--result_file", out, *extra],
                          "22")
        if not extra:
            launches = read_launches()
        with open(out) as f:
            line = f.read()
        m = re.fullmatch(r"dwt_bw_intensity0: snr:(\S+), rmse:(\S+)\n", line)
        check(m is not None, f"cli.dwt_dn wrote {line!r}")
        snrs["host" if extra else "card"] = float(m.group(1))
        log(f"[22] {card}: cli.dwt_dn {'--host' if extra else 'on the card'} in {wall:.2f} s "
            f"(host clock, loading included): {line.strip()}")
    gap = abs(snrs["card"] - snrs["host"])
    check(gap <= DWT_DN_SNR_TOL, f"cli.dwt_dn's SNRs differ by {gap:.2e} dB")
    log(f"[22] cli.dwt_dn on the card and with --host: SNRs {gap:.2e} dB apart (bar "
        f"{DWT_DN_SNR_TOL:.0e}); launches on the card's run {launches}")
    check(launches == expected_launches(), "the DWT baseline launched a port kernel")

    for n in DWT_ROWS:
        x = np.ascontiguousarray(np.resize(rows, (n, 256)))  # the cache's rows, repeated
        xd = torch.from_numpy(x).cuda()
        dev_ms = cuda_ms(lambda: wavelet_denoise_device(xd), 10)
        walls = [_timed(lambda: wavelet_denoise_device(torch.from_numpy(x).cuda()).cpu())
                 for _ in range(5)]
        host = host_s.get(x.shape) or _timed(lambda: wavelet_denoise(x.astype(np.float64)))
        log(f"[22] {card}: DWT baseline at {n} rows of 256: the card {n / dev_ms * 1e3:.1f} "
            f"rows/s device-resident ({dev_ms:.3f} ms, CUDA events, mean of 10), "
            f"{n / statistics.median(walls):.1f} rows/s numpy in and out (host clock, median "
            f"of 5); the host's numpy path {n / host:.1f} rows/s ({host:.2f} s, one call)")
        if n == DWT_ROWS[0]:
            profile_forward(lambda: wavelet_denoise_device(xd),
                            f"wavelet_denoise_device at {n} rows", dev_ms, card, tag="22")
    log(f"chip_smoke: phase 22 took {time.perf_counter() - t0:.1f} s")
    return {"baseline_dwt": launches}


def d32_cases():
    """Phases 2b and 6b: (B, L, H, with bias, dtype, D, q scale) at
    Transformer1d's stage shapes at the training batch and the ragged
    ones, then its first stage with q unscaled (wide logits), f32; then
    the mma template's other head dims (MMA_D_CASES), q scaled by D^-1/2
    (D = 4 unscaled, as RA-LENet's)."""
    return [(B, L, H, b, dt, 32, D32_Q_SCALE) for B, L, H in
            [(D32_BATCH, L, H) for L, H in D32_STAGES] + D32_RAGGED
            for b in (True, False) for dt in (torch.float32, torch.bfloat16)] + [
        (D32_BATCH, *D32_STAGES[0], b, torch.float32, 32, 1.0) for b in (True, False)] + [
        (B, L, H, b, dt, D, 1.0 if D == 4 else D ** -0.5) for D, B, L, H in MMA_D_CASES
        for b in (True, False) for dt in (torch.float32, torch.bfloat16)]


def on_mma(D, L):
    """Whether B1 and B2 take a (D, L) call on the mma template (not the D
    = 4 kernels)."""
    from ecg_denoise_tpu_torch.kernels.attention import HEAD_DIM, kernel_head_dim

    return kernel_head_dim(D, L, torch.float32) != HEAD_DIM


def run_module_lines(module, argv, tag):
    """`run_module`, with the module's standard output captured and logged:
    (its lines, its wall seconds)."""
    buf = io.StringIO()
    wall = run_module(module, argv, tag, out=buf)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[{tag}]   {line}")
    return lines, wall


def phase_classifier(card, cls_cache, core_ckpt):
    """Phase 23: ResNetCls on the card against the CPU, `cli.train_cls` on
    phase 21's cls cache, `cli.test_cls` with that classifier and phase 7b's
    RA-LENet checkpoint, then the classifier's rates."""
    from ecg_denoise_tpu_torch import MODEL_NAMES
    from ecg_denoise_tpu_torch.data.cls_cache import load_cls_arrays
    from ecg_denoise_tpu_torch.models import ResNetCls
    from ecg_denoise_tpu_torch.train import (
        cls_step,
        create_train_state,
        load_checkpoint,
        make_cls_epoch_fns,
    )
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    t0 = time.perf_counter()
    launches = {}
    cpu_model = seed_module(ResNetCls().eval(), random_seed(23))
    gpu_model = create_train_state(copy.deepcopy(cpu_model)).model.eval()
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (8, 2, 256)).astype(np.float32))
    with torch.no_grad():
        err = (gpu_model(x.cuda()).cpu() - cpu_model(x)).abs().max().item()
    log(f"[23] ResNetCls (445,122 parameters), batch 8, float32: card vs CPU "
        f"max_abs_err={err:.3e} (tol {MODEL_TOL:.0e})")
    check(err <= MODEL_TOL, "ResNetCls on the card disagrees with the CPU")

    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "cls_model.pth")
        reset_launches()  # the classifier's training path
        lines, wall = run_module_lines(
            "ecg_denoise_tpu_torch.cli.train_cls",
            ["--epochs", str(CLS_EPOCHS), "--data_path", cls_cache, "--save", save], "23")
        launches["train_cls"] = read_launches()
        found = [m.groups() for m in map(
            re.compile(r".* train_loss=(\S+) train_acc=(\S+) ").match, lines) if m]
        losses, accs = ([float(x[i]) for x in found] for i in (0, 1))
        # The CLI's untrained classifier (its --seed) on the same split: the
        # loss training must get below, whatever one epoch's noise (the
        # first epoch's accuracy is already 0.98-0.99).
        random_seed(2023)
        untrained = create_train_state(ResNetCls())
        _, untrained_eval = make_cls_epoch_fns(untrained.model, untrained.optimizer)
        tr_x, tr_y = (torch.from_numpy(a).cuda() for a in load_cls_arrays(True, path=cls_cache))
        loss0 = untrained_eval(tr_x, tr_y)[0]["loss"]
        log(f"[23] {card}: cli.train_cls, {CLS_EPOCHS} epochs in {wall:.1f} s (host clock, "
            f"start-up included); train loss by epoch {losses}, accuracy {accs}; the untrained "
            f"classifier's loss on the split {loss0:.4f}; launches {launches['train_cls']}")
        check(len(losses) == CLS_EPOCHS and losses[-1] < loss0,
              "the last epoch's train loss is not below the untrained classifier's")
        check(launches["train_cls"] == expected_launches(), "train_cls launched a kernel")
        state = load_checkpoint(save, create_train_state(ResNetCls()))
        check(state.step > 0, "the classifier checkpoint did not load its training state")

        model_dir = os.path.join(tmp, "model_save")
        os.makedirs(os.path.join(model_dir, "ralenet"))
        shutil.copy(core_ckpt, os.path.join(model_dir, "ralenet",
                                            "ralenet_9_emb_intensity-4.pth"))
        reset_launches()  # the downstream-utility benchmark
        lines, wall = run_module_lines(
            "ecg_denoise_tpu_torch.cli.test_cls",
            ["--cls_ckpt", save, "--model_save_dir", model_dir, "--data_path", cls_cache],
            "23")
        launches["test_cls"] = read_launches()
    batches = -(-CLS_TEST_BEATS // CLS_EVAL_BATCH)
    log(f"[23] {card}: cli.test_cls in {wall:.1f} s (host clock); launches "
        f"{launches['test_cls']} (ralenet: {batches} batches of {CLS_EVAL_BATCH})")
    names = [line.split()[0] for line in lines]
    check(names == ["clean", "noisy", *MODEL_NAMES, "dwt", "fft"],
          f"test_cls reported {names}")
    check(all("acc=" in line for line in lines
              if line.split()[0] not in MODEL_NAMES or line.startswith("ralenet ")),
          "a condition's line has no metrics")
    check(launches["test_cls"] == expected_launches(fwd=18 * batches),
          "the ralenet condition did not take 18 B1 launches a batch, and nothing else")

    # Rates: training windows/s over one epoch of the cls train split, at
    # batch 32 and 256, f32 and bf16; one f32 step's breakdown; eval at 1024.
    te_x, te_y = (torch.from_numpy(a).cuda() for a in load_cls_arrays(False, path=cls_cache))
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for batch in (TRAIN_BATCH, TIMING_BATCH):
            state = create_train_state(seed_module(ResNetCls(dtype=dtype), random_seed(24)))
            train_epoch, eval_epoch = make_cls_epoch_fns(state.model, state.optimizer)
            gen = torch.Generator(device="cuda").manual_seed(0)
            train_epoch(tr_x[:4 * batch], tr_y[:4 * batch], gen, batch)  # warm-up
            n = tr_x.shape[0] // batch * batch
            walls = [_timed(train_epoch, tr_x, tr_y, gen, batch) for _ in range(2)]
            xb, yb = tr_x[:batch], tr_y[:batch].long()
            step_ms = cuda_ms(lambda: cls_step(state, xb, yb), 5)
            log(f"[23] {card}: ResNetCls train_epoch {dt} batch {batch}: "
                f"{n / statistics.median(walls):.1f} windows/s (median of 2 epochs of "
                f"{n // batch} steps, host clock ending in the epoch's one fetch); one step "
                f"{step_ms:.3f} ms on the card's clock (CUDA events, mean of 5)")
            if dtype == torch.float32 and batch == TIMING_BATCH:
                profile_step(lambda: cls_step(state, xb, yb), card, step_ms, tag="23",
                             what="ResNetCls float32 step")
        eval_epoch(te_x, te_y, CLS_TEST_BEATS)  # warm-up
        walls = [_timed(eval_epoch, te_x, te_y, CLS_TEST_BEATS) for _ in range(10)]
        log(f"[23] {card}: ResNetCls eval_epoch {dt}, {CLS_TEST_BEATS} beats in one batch: "
            f"{CLS_TEST_BEATS / statistics.median(walls):.1f} windows/s (median of 10, host "
            "clock ending in the one fetch)")
    log(f"chip_smoke: phase 23 took {time.perf_counter() - t0:.1f} s")
    return launches


def mma_bound_terms(B, H, L, elt, products, D=32):
    """(operations, bytes) lower bounds in ms for one call on the mma
    template at f32: `products` (L, L, D) products (2 a forward: q.k and
    p.v; 5 a backward) at three TF32 passes each (3xTF32) over the dense
    TF32 peak, and the function's inputs and outputs, each moved once,
    over HBM bandwidth (`bound_terms`, `bwd_bound_terms`). The exps and
    elementwise products, on the CUDA cores beside them, are not counted."""
    flops = 3 * 2 * B * H * L * L * D * products
    t_bytes = (bound_terms if products == 2 else bwd_bound_terms)(B, H, L, False, elt, D=D)[1]
    return flops / PEAK_TF32_FLOPS * 1e3, t_bytes


def d32_kernel_times(card, stage_calls=D32_CALLS, fwd_batch=T1D_SERVE_BATCH,
                     bwd_batch=T1D_TRAIN_BATCH, tag="24"):
    """Phase 24's kernel rows (and phase 26's, at its length): per
    Transformer1d stage shape, B1 at the served batch and B2 at the
    training batch, f32, from CUDA graph replays, in turns with the
    parent's where its tree is there (parent, this, this, parent), beside
    the bound on the tensor cores (`mma_bound_terms`), the first design's
    bound on the CUDA cores, the plain versions and SDPA (no mask); summed
    over one forward's and one step's 12 calls."""
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.probes.floor import graph_us

    gen = torch.Generator().manual_seed(24)
    keys = ("ms", "plain_ms", "bound_ms", "bound_cuda_core_ms", "library_ms", "parent_ms",
            "bf16_ms", "bf16_parent_ms")
    totals = {w: dict.fromkeys(keys, 0.0) for w in ("fwd", "bwd")}
    limits = {w: {"operations": 0.0, "bytes": 0.0} for w in ("fwd", "bwd")}
    for (L, H), calls in stage_calls.items():
        for what, B in (("fwd", fwd_batch), ("bwd", bwd_batch)):
            q, k, v, _ = operands(B, H, L, False, torch.float32, gen, D=32,
                                  q_scale=D32_Q_SCALE)
            if what == "fwd":
                def this():
                    return attention.fused_attention(q, k, v)

                def parent():
                    return parent_b1(q, k, v, None)

                plain = cuda_ms(lambda: attention.attention_reference(q, k, v), 5)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 20)
                core = bound_terms(B, H, L, False, 4, D=32)
                t_ops, t_bytes = mma_bound_terms(B, H, L, 4, 2)
            else:
                g = torch.randn(q.shape, generator=gen).cuda()
                o, lse = attention._launch(q, k, v, None, with_lse=True)

                def this():
                    return attention._launch_bwd(q, k, v, None, o, lse, g, want_dbias=False)

                def parent():
                    return parent_b2(q, k, v, None, o, lse, g, False)

                plain = cuda_ms(lambda: attention.attention_backward_reference(
                    q, k, v, None, o, lse, g), 5)
                ins = [t.detach().requires_grad_() for t in (q, k, v)]

                def sdpa():
                    return F.scaled_dot_product_attention(*ins, scale=1.0)

                lib = cuda_ms(lambda: torch.autograd.grad(sdpa(), ins, g), 20) - cuda_ms(sdpa, 20)
                core = bwd_bound_terms(B, H, L, False, 4, D=32)
                t_ops, t_bytes = mma_bound_terms(B, H, L, 4, 5)
            if parent_libs():
                parent_us, this_us = in_turns(parent, this)
                ms, parent_ms = statistics.mean(this_us) / 1e3, statistics.mean(parent_us) / 1e3
                turns = (f" in turns with the parent's {parent_ms:.4f} ms (this "
                         f"{this_us[0]:.1f} / {this_us[1]:.1f} us, parent {parent_us[0]:.1f} / "
                         f"{parent_us[1]:.1f} us)")
            else:
                ms, parent_ms, turns = graph_us(this, 20) / 1e3, None, ""
            bf16 = bf16_parent = None
            if parent_libs():
                # The same call on bf16 operands, this against the parent's.
                args = [t.bfloat16() for t in (q, k, v)]
                if what == "fwd":
                    pair = (lambda: parent_b1(*args, None),
                            lambda: attention.fused_attention(*args))
                else:
                    o16, lse16 = attention._launch(*args, None, with_lse=True)
                    g16 = g.bfloat16()
                    pair = (lambda: parent_b2(*args, None, o16, lse16, g16, False),
                            lambda: attention._launch_bwd(*args, None, o16, lse16, g16,
                                                          want_dbias=False))
                bf16_parent, bf16 = (statistics.mean(us) / 1e3 for us in in_turns(*pair))
            bnd, core_bnd = max(t_ops, t_bytes), max(core)
            log(f"[{tag}] {card}: attention_{what} D=32 float32 B={B} L={L} H={H}: kernel "
                f"{ms:.4f} ms (graph replays){turns}, bound {bnd:.4f} ms (operations "
                f"{t_ops:.4f} at 3xTF32 on the tensor cores, bytes {t_bytes:.4f}), the CUDA "
                f"cores' bound {core_bnd:.4f} ms, plain {plain:.4f} ms, sdpa"
                f"{' backward ((fwd+bwd) - fwd)' if what == 'bwd' else ''} {lib:.4f} ms; "
                f"{calls} calls per {'forward' if what == 'fwd' else 'step'}"
                + ("" if bf16 is None else f"; on bf16 operands {bf16:.4f} ms, the parent's "
                   f"{bf16_parent:.4f} (in turns)"))
            for key, t in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                           ("bound_cuda_core_ms", core_bnd), ("library_ms", lib),
                           ("parent_ms", parent_ms), ("bf16_ms", bf16),
                           ("bf16_parent_ms", bf16_parent)):
                totals[what][key] = None if t is None else totals[what][key] + calls * t
            limits[what]["operations"] += calls * t_ops
            limits[what]["bytes"] += calls * t_bytes
    for what, t in totals.items():
        t["bound_by"] = max(limits[what], key=limits[what].get)
        parent = "" if t["parent_ms"] is None else (
            f" (the parent's, in turns, {t['parent_ms']:.4f}; on bf16 operands "
            f"{t['bf16_ms']:.4f} against the parent's {t['bf16_parent_ms']:.4f})")
        log(f"[{tag}] {card}: attention_{what} D=32 float32, the 12 calls of one "
            f"{'forward' if what == 'fwd' else 'step'}: kernel {t['ms']:.4f} ms{parent}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; the CUDA cores' "
            f"{t['bound_cuda_core_ms']:.4f}), "
            f"plain {t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms")
    return totals


@contextlib.contextmanager
def parent_attention():
    """B1 and B2 from the parent's libraries for the block: the model's
    calls go through the same wrappers, with the parent's kernels behind
    them (a yardstick; the counts move as on any call)."""
    from ecg_denoise_tpu_torch.kernels import attention

    libs, saved = parent_libs(), (attention._library, attention._bwd_library)
    attention._library = lambda: libs["attention_fwd"]
    attention._bwd_library = lambda: libs["attention_bwd"]
    try:
        yield
    finally:
        attention._library, attention._bwd_library = saved


def t1d_rates_in_turns(card, length, serve_batch, train_batch, tag):
    """Transformer1d at its defaults on `length`-sample inputs, f32 and
    bf16: windows/s served at serve_batch (median of 5 forwards, host
    clock ending in a synchronize) and one training step's ms at
    train_batch (CUDA events, mean of 3), with this tree's B1 and B2 and,
    where its tree is there, the parent's, in turns (parent, this, this,
    parent); each the mean of its two turns."""
    from ecg_denoise_tpu_torch.models import Transformer1d
    from ecg_denoise_tpu_torch.train import create_train_state, make_cls_epoch_fns
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    rng = np.random.default_rng(28)
    xs = torch.from_numpy(rng.standard_normal((serve_batch, 32, length)).astype(
        np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, 9, serve_batch)).cuda()
    order = ("parent", "this", "this", "parent") if parent_libs() else ("this",)
    rates = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        random_seed(24)
        state = create_train_state(Transformer1d(dtype=dtype))
        train_epoch, _ = make_cls_epoch_fns(state.model, state.optimizer)
        gen = torch.Generator(device="cuda").manual_seed(0)
        got = {who: {"windows_per_s": [], "step_ms": []} for who in order}
        for who in order:
            with parent_attention() if who == "parent" else contextlib.nullcontext():
                state.model.eval()
                with torch.no_grad():
                    state.model(xs)  # warm-up
                    torch.cuda.synchronize()
                    walls = []
                    for _ in range(5):
                        t1 = time.perf_counter()
                        state.model(xs)
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t1)
                got[who]["windows_per_s"].append(serve_batch / statistics.median(walls))
                xb, yb = xs[:train_batch], ys[:train_batch]
                train_epoch(xb, yb, gen, train_batch)  # warm-up
                got[who]["step_ms"].append(cuda_ms(lambda: train_epoch(xb, yb, gen, train_batch),
                                                   3))
        rates[dt] = {who: {k: statistics.mean(v) for k, v in r.items()} for who, r in got.items()}
        log(f"[{tag}] {card}: Transformer1d {dt} at {length} samples: served at {serve_batch} "
            + ", ".join(f"{who} {r['windows_per_s']:.1f} windows/s" for who, r in
                        rates[dt].items())
            + f"; training step at {train_batch} "
            + ", ".join(f"{who} {r['step_ms']:.3f} ms" for who, r in rates[dt].items())
            + (" (in turns: parent, this, this, parent)" if len(order) > 1 else ""))
    return rates


def log_mma_resources():
    """B1's and B2's mma kernels as the compiler left them, by
    instantiation: registers, stack and local memory (cuobjdump
    -res-usage) and the tensor-core instructions in their SASS (HMMA, from
    cuobjdump -sass). A kernel of the template with no HMMA fails the run;
    spills are reported."""
    from ecg_denoise_tpu_torch.kernels.build import CSRC, _nvcc, _target

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    found = {}
    for name in ("attention_fwd", "attention_bwd"):
        lib = str(_target(name, CSRC))
        usage = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                               timeout=300, check=True).stdout
        sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        hmma = {}
        for part in sass.split("Function : ")[1:]:
            fn = part.split(None, 1)[0]
            if "_mma_kernel" in fn:
                hmma[fn] = sum("HMMA" in line for line in part.splitlines())
                kinds = sorted(set(re.findall(r"HMMA\.\S+", part)))
                found[fn] = {"hmma": hmma[fn], "kinds": kinds}
        for fn, reg, stack, local in re.findall(
                r"Function (\S*_mma_kernel\S*):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ "
                r"LOCAL:(\d+)", usage):
            if fn in found:
                found[fn].update(registers=int(reg), stack=int(stack), local=int(local))
    for fn, r in sorted(found.items()):
        log(f"[24] {fn}: {r.get('registers')} registers, stack {r.get('stack')} bytes, local "
            f"{r.get('local')} bytes; {r['hmma']} HMMA instructions ({', '.join(r['kinds'])})")
    # 16 B1 (D 8-64 f32, 16-64 bf16, with and without a bias: 14), 16 dq,
    # 16 dk/dv, 8 dbias.
    check(len(found) == 14 + 16 + 16 + 8, f"{len(found)} mma kernel instantiations found")
    check(all(r["hmma"] > 0 for r in found.values()), "an mma kernel issues no HMMA")
    return found


def transformer1d_step_vs_cpu(cpu_model, xs, ys, tag, what):
    """One f32 Adam step of Transformer1d through `cls_epoch` on the card
    against the same step on the CPU (loss LOSS_RTOL, `step_bars`), with 12
    B1 and 12 B2 launches on the card: the card's launches."""
    from ecg_denoise_tpu_torch.train import cls_epoch, create_train_state

    b = len(xs)
    states = {dev: create_train_state(copy.deepcopy(cpu_model), device=dev)
              for dev in ("cuda", "cpu")}
    losses = {}
    for dev, st in states.items():
        reset_launches()  # one training step
        losses[dev] = cls_epoch(st, xs.to(dev), ys.to(dev), torch.arange(b, device=dev),
                                b)["loss"]
        if dev == "cuda":
            launches = read_launches()
    params = {dev: dict(st.model.named_parameters()) for dev, st in states.items()}
    bars = step_bars({k: p.grad.cpu() for k, p in params["cuda"].items()},
                     {k: p.grad for k, p in params["cpu"].items()},
                     {k: p.detach().cpu() for k, p in params["cuda"].items()},
                     {k: p.detach() for k, p in params["cpu"].items()})
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"[{tag}] Transformer1d{what}, float32, batch {b}: one Adam step through cls_epoch "
        f"on the card vs the CPU: loss {losses['cuda']:.7f} vs {losses['cpu']:.7f} (rel "
        f"{rel:.2e}, tol {LOSS_RTOL:.0e}), gradients against the CPU's: "
        f"{describe_bars(bars)}; launches { {k: n for k, n in launches.items() if n} }")
    check(rel <= LOSS_RTOL and bars["ok"], f"Transformer1d's step{what} disagrees with the CPU's")
    check(launches == expected_launches(fwd=12, bwd=12),
          f"the step{what} did not take 12 B1 and 12 B2 launches")
    return launches


def phase_transformer1d(card):
    """Phase 24: Transformer1d at its defaults (embed 128, depths 2/2/6/2,
    heads 4-32, every head 32 wide) on 256-sample inputs, seeded weights:
    the forward on the card against the CPU with 12 B1 launches, one step
    against the CPU's at `step_bars` with 12 + 12, served and trained on
    the card with the counts of those paths, rates and the kernel rows."""
    from ecg_denoise_tpu_torch.models import Transformer1d
    from ecg_denoise_tpu_torch.train import create_train_state, make_cls_epoch_fns
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    t0 = time.perf_counter()
    log_mma_resources()
    random_seed(24)
    cpu_model = Transformer1d().eval()
    n_params = sum(p.numel() for p in cpu_model.parameters())
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((8, 32, 256)).astype(np.float32))
    gpu_model = create_train_state(copy.deepcopy(cpu_model)).model.eval()
    reset_launches()
    with torch.no_grad():
        y = gpu_model(x.cuda())
        torch.cuda.synchronize()
        fwd_launches = read_launches()
        err = (y.cpu() - cpu_model(x)).abs().max().item()
    log(f"[24] Transformer1d ({n_params:,} parameters), batch 8, float32: card vs CPU "
        f"max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}); launches per forward "
        f"{ {k: n for k, n in fwd_launches.items() if n} }")
    check(err <= MODEL_TOL and bool(torch.isfinite(y).all()),
          "Transformer1d on the card disagrees with the CPU")
    check(fwd_launches == expected_launches(fwd=12), "the forward did not take 12 B1 launches")

    # One step on the card against the same step on the CPU.
    b = T1D_CHECK_BATCH
    transformer1d_step_vs_cpu(cpu_model, x[:b], torch.from_numpy(rng.integers(0, 9, b)),
                              "24", "")

    # Served and trained on the card: the paths' counts, then the rates.
    launches = {}
    xs = torch.from_numpy(rng.standard_normal(
        (T1D_SERVE_BATCH, 32, 256)).astype(np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, 9, T1D_SERVE_BATCH)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        random_seed(24)
        state = create_train_state(Transformer1d(dtype=dtype))
        model = state.model.eval()
        with torch.no_grad():
            model(xs)  # warm-up
            torch.cuda.synchronize()
            if dtype == torch.float32:
                reset_launches()  # the served forward
                model(xs)
                torch.cuda.synchronize()
                launches["serve_transformer1d"] = read_launches()
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                model(xs)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            fwd_ms = cuda_ms(lambda: model(xs), 5)
        log(f"[24] {card}: Transformer1d served {dt} batch {T1D_SERVE_BATCH}: "
            f"{T1D_SERVE_BATCH / statistics.median(walls):.1f} windows/s (median of 5 "
            f"forwards, host clock ending in a synchronize); forward {fwd_ms:.3f} ms on the "
            "card's clock (CUDA events, mean of 5)")
        train_epoch, _ = make_cls_epoch_fns(state.model, state.optimizer)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tb = T1D_TRAIN_BATCH
        train_epoch(xs[:tb], ys[:tb], gen, tb)  # warm-up
        torch.cuda.synchronize()
        if dtype == torch.float32:
            reset_launches()  # two training steps through train_epoch
            got = train_epoch(xs[:2 * tb], ys[:2 * tb], gen, tb)
            launches["train_transformer1d"] = read_launches()
            check(np.isfinite(got["loss"]), "non-finite Transformer1d training loss")
        step_ms = cuda_ms(lambda: train_epoch(xs[:tb], ys[:tb], gen, tb), 3)
        log(f"[24] {card}: Transformer1d {dt} training step at batch {tb}: {step_ms:.3f} ms "
            f"(CUDA events around train_epoch of one step, mean of 3) = "
            f"{tb / step_ms * 1e3:.1f} windows/s")
        if dtype == torch.float32:
            profile_step(lambda: train_epoch(xs[:tb], ys[:tb], gen, tb), card, step_ms,
                         tag="24", what="Transformer1d float32 step", batch=tb)
    log(f"[24] launches: serve_transformer1d {launches['serve_transformer1d']}, "
        f"train_transformer1d {launches['train_transformer1d']}")
    check(launches["serve_transformer1d"] == expected_launches(fwd=12),
          "the served forward did not take 12 B1 launches")
    check(launches["train_transformer1d"] == expected_launches(fwd=24, bwd=24),
          "two training steps did not take 24 B1 and 24 B2 launches")
    times = d32_kernel_times(card)
    times["transformer1d"] = t1d_rates_in_turns(card, 256, T1D_SERVE_BATCH, T1D_TRAIN_BATCH,
                                                "24")
    log(f"chip_smoke: phase 24 took {time.perf_counter() - t0:.1f} s")
    return launches, times, cpu_model


def log_b5_mma_resources(card):
    """B5's mma template as the compiler left it, by instantiation:
    registers, stack, static shared and local memory (cuobjdump
    -res-usage) and its tensor-core instructions (HMMA, cuobjdump -sass);
    a spill or a kernel with no HMMA fails the run. Then its launch at
    Transformer1d's two packable stages, from the library: blocks, threads
    a block, ring stages and dynamic shared memory a block."""
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        dense_pack_factor,
        launch_shape,
        smem_bytes,
    )
    from ecg_denoise_tpu_torch.kernels.build import CSRC, _nvcc, _target

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    lib = str(_target("attention_dense_fwd", CSRC))
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                           timeout=120, check=True).stdout
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hmma = {part.split(None, 1)[0]: sum("HMMA" in line for line in part.splitlines())
            for part in sass.split("Function : ")[1:] if "_mma_kernel" in part.split(None, 1)[0]}
    found = re.findall(r"Function (\S*attention_dense_fwd_mma_kernelI(f|13__nv_bfloat16)Li(\d+)"
                       r"ELb([01])ELi(\d+)E\S*):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) "
                       r"LOCAL:(\d+)", usage)
    for fn, dt, D, bias, span, reg, stack, shared, local in sorted(
            found, key=lambda f: (f[1], int(f[2]), f[3], int(f[4]))):
        log(f"[25] B5 mma template ptxas, {'float32' if dt == 'f' else 'bfloat16'} D={D} "
            f"bias={bias == '1'} key span {span}: {reg} registers, stack {stack} bytes, local "
            f"{local} bytes, static shared {shared} bytes; {hmma.get(fn, 0)} HMMA instructions")
    # D 8-64 at f32, 16-64 at bf16, with and without a bias, at key spans
    # 16, 32 and 64.
    check(len(found) == 42, f"{len(found)} of B5's 42 mma kernel instantiations found")
    check(all(f[6] == "0" and f[8] == "0" for f in found), "a B5 mma instantiation spills")
    check(all(hmma.get(f[0], 0) > 0 for f in found), "a B5 mma kernel issues no HMMA")
    for L, H in T1D_DENSE_CALLS:
        P = dense_pack_factor(H, L)
        for dt in (torch.float32, torch.bfloat16):
            for b in (False, True):
                shape = launch_shape(T1D_SERVE_BATCH, H, L, 32, dt, b)
                log(f"[25] {card}: B5 D=32 {str(dt)[6:]} B={T1D_SERVE_BATCH} L={L} H={H} "
                    f"(P={P}) bias={b}: {shape['blocks']} blocks of {shape['threads']} threads, "
                    f"a ring of {shape['stages']} stages, {smem_bytes(L, 32, P, dt, b)} bytes "
                    "of dynamic shared memory a block (from the library)")


def dense_cases():
    """Phase 25's B5 cases: (B, L, H, with bias, dtype, D) at every head
    dim of DENSE_CHECK_DIMS, Transformer1d's packable stages and the short
    ones, the served batch and a ragged one."""
    return [(B, L, H, b, dt, D) for D in DENSE_CHECK_DIMS
            for (L, H) in [*T1D_DENSE_CALLS, *DENSE_OTHER] for B in DENSE_D32_BATCHES
            for b in (True, False) for dt in (torch.float32, torch.bfloat16)]


def phase_dense_d32(card, cpu_model):
    """Phase 25: B5 at every head dim (DENSE_CHECK_DIMS) against its plain
    version, B1 without lse and, where its tree is there, the parent's B5
    (at D = 4 bit for bit, at D = 32 within the bars: the parent's B5
    takes no other D); Transformer1d served
    with ECG_ATTN_DENSE=1 (4 B1 and 8 B5 a forward) against the CPU; the 8
    dense calls' times in turns with the parent's B5 and B1's; served
    windows/s dense and default, in turns."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        attention_dense_reference,
        fused_attention_dense,
    )
    from ecg_denoise_tpu_torch.train import create_train_state

    t0 = time.perf_counter()
    log_b5_mma_resources(card)
    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(25)
    parent = parent_libs()
    max_err, max_err_parent, d4_parent_equal = 0.0, 0.0, True if parent else None
    for B, L, H, with_bias, dtype, D in dense_cases():
        q, k, v, bias = operands(B, H, L, with_bias, dtype, gen, D=D,
                                 q_scale=1.0 if D == 4 else D ** -0.5)
        out = fused_attention_dense(q, k, v, bias)
        again = fused_attention_dense(q, k, v, bias)
        b1 = attention._launch(q, k, v, bias)
        # The parent's B5 takes D = 4 and 32 only.
        old = (None if parent is None or D not in (4, 32)
               else b5_call(parent["attention_dense_fwd"], q, k, v, bias))
        torch.cuda.synchronize()
        err = (out.float() - attention_dense_reference(q, k, v, bias).float()).abs().max().item()
        err_b1 = (out.float() - b1.float()).abs().max().item()
        err_old = None if old is None else (out.float() - old.float()).abs().max().item()
        tol = (F32_TOL if dtype == torch.float32
               else BF16_TOL_OF_MAX_V * v.float().abs().max().item())
        if dtype == torch.float32:
            max_err = max(max_err, err)
            max_err_parent = max(max_err_parent, err_old or 0.0)
        same = torch.equal(out, again)
        as_parent = "" if old is None else (
            f"; vs the parent's B5 {err_old:.3e}"
            + (f", bit for bit: {torch.equal(out, old)}" if D == 4 else ""))
        if old is not None and D == 4:
            d4_parent_equal &= torch.equal(out, old)
        log(f"[25] B5 D={D} B={B} L={L} H={H} bias={with_bias} {str(dtype)[6:]}: max_abs_err "
            f"vs plain {err:.3e}, vs B1 without lse {err_b1:.3e}{as_parent} (tol {tol:.3e}); "
            f"a second call bit-identical: {same}")
        check(out.shape == q.shape and out.dtype == dtype, f"B5 D={D} output shape or dtype")
        check(bool(torch.isfinite(out).all()) and err <= tol and err_b1 <= tol,
              f"B5 at D = {D} disagrees with its plain version or with B1")
        check(same, f"two B5 D={D} calls differ")
        # The D = 4 kernel is unchanged; the mma template computes D = 32
        # with other arithmetic than the parent's B5 (3xTF32 on the tensor
        # cores, one softmax pass), so within the bars.
        check(old is None or (torch.equal(out, old) if D == 4 else err_old <= tol),
              f"B5 at D = {D} is not the parent's B5"
              + (" bit for bit" if D == 4 else " within the bars"))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log("[25] B5 against the parent's B5: "
        + ("not compared (no tree under _archive/parent)" if parent is None
           else f"D = 4 bit for bit in every case: {d4_parent_equal}; D = 32 within the bars, "
                f"largest float32 difference {max_err_parent:.3e}"))

    # Transformer1d at its defaults, served at T1D_SERVE_BATCH with the dense
    # route; the first 8 windows against the CPU (eval: windows independent).
    rng = np.random.default_rng(25)
    xs = torch.from_numpy(rng.standard_normal(
        (T1D_SERVE_BATCH, 32, 256)).astype(np.float32)).cuda()
    model = create_train_state(copy.deepcopy(cpu_model)).model.eval()
    with torch.no_grad(), dense_route():
        model(xs)  # warm-up
        torch.cuda.synchronize()
        reset_launches()  # the dense served forward
        y = model(xs)
        torch.cuda.synchronize()
        launches = read_launches()
        err = (y[:8].cpu() - cpu_model(xs[:8].cpu())).abs().max().item()
    log(f"[25] Transformer1d served with ECG_ATTN_DENSE=1, batch {T1D_SERVE_BATCH}, float32: "
        f"the first 8 windows vs the CPU max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}); "
        f"launches per forward { {k: n for k, n in launches.items() if n} }")
    check(bool(torch.isfinite(y).all()) and err <= MODEL_TOL,
          "the dense Transformer1d forward disagrees with the CPU")
    check(launches == expected_launches(fwd=4, dense=8),
          "the dense Transformer1d forward did not make 4 B1 and 8 B5 launches")

    times = dense_d32_times(card)
    times["other_head_dims"] = dense_other_d_times(card)
    # Served windows/s, in turns: default, dense, dense, default.
    walls = {"default": [], "dense": []}
    fwd_ms = {}
    with torch.no_grad():
        for key in ("default", "dense", "dense", "default"):
            with dense_route(key == "dense"):
                model(xs)
                torch.cuda.synchronize()
                for _ in range(5):
                    t1 = time.perf_counter()
                    model(xs)
                    torch.cuda.synchronize()
                    walls[key].append(time.perf_counter() - t1)
                fwd_ms.setdefault(key, []).append(cuda_ms(lambda: model(xs), 5))
    log(f"[25] {card}: Transformer1d served float32 batch {T1D_SERVE_BATCH}: ECG_ATTN_DENSE=1 "
        f"{T1D_SERVE_BATCH / statistics.median(walls['dense']):.1f} windows/s, default "
        f"{T1D_SERVE_BATCH / statistics.median(walls['default']):.1f} (medians of 10 forwards "
        f"each, in turns, host clock ending in a synchronize); forward dense "
        f"{statistics.mean(fwd_ms['dense']):.3f} ms, default "
        f"{statistics.mean(fwd_ms['default']):.3f} ms (CUDA events, mean of 2 x 5)")
    log(f"chip_smoke: phase 25 took {time.perf_counter() - t0:.1f} s")
    return {"serve_transformer1d_dense": launches}, max_err, times, d4_parent_equal


def dense_bound_terms(B, H, L, D, dtype):
    """(operations, bytes) lower bounds in ms for one B5 call on the mma
    template, no bias: the products at 3xTF32 on the tensor cores (f32,
    `mma_bound_terms`) or one bf16 pass, and q, k, v and o moved once."""
    if dtype == torch.float32:
        return mma_bound_terms(B, H, L, 4, 2, D=D)
    return (2 * 2 * B * H * L * L * D / PEAK_BF16_FLOPS * 1e3,
            bound_terms(B, H, L, False, 2, D=D)[1])


def dense_d32_times(card):
    """Phase 25's kernel rows: per packable Transformer1d stage, B5 at D =
    32 (B = T1D_SERVE_BATCH, no bias), f32 and bf16, from CUDA graph
    replays in turns with the parent's B5 (where its tree is there) and B1
    without lse, beside its bound (`dense_bound_terms`), the plain version
    and SDPA; summed over a forward's 8 dense calls."""
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        attention_dense_reference,
        fused_attention_dense,
    )

    gen = torch.Generator().manual_seed(26)
    B = T1D_SERVE_BATCH
    parent = parent_libs()
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "b1_ms", "parent_ms")
    totals, limits = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        tot = totals[dt] = dict.fromkeys(keys, 0.0)
        lim = limits[dt] = {"operations": 0.0, "bytes": 0.0}
        for (L, H), calls in T1D_DENSE_CALLS.items():
            q, k, v, _ = operands(B, H, L, False, dtype, gen, D=32, q_scale=D32_Q_SCALE)
            fns = [lambda: fused_attention_dense(q, k, v), lambda: attention._launch(q, k, v, None)]
            if parent:
                fns.append(lambda: b5_call(parent["attention_dense_fwd"], q, k, v, None))
            got = turns(fns)
            ms, b1_ms = (statistics.mean(us) / 1e3 for us in got[:2])
            parent_ms = statistics.mean(got[2]) / 1e3 if parent else None
            plain = cuda_ms(lambda: attention_dense_reference(q, k, v), 5)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 20)
            t_ops, t_bytes = dense_bound_terms(B, H, L, 32, dtype)
            bnd = max(t_ops, t_bytes)
            readings = "; ".join(f"{who} {us[0]:.1f} / {us[1]:.1f} us" for who, us in zip(
                ("B5", "B1", "the parent's B5"), got))
            log(f"[25] {card}: B5 attention_dense_fwd D=32 {dt} B={B} L={L} H={H}: kernel "
                f"{ms:.4f} ms, B1 without lse {b1_ms:.4f} ms, the parent's B5 "
                + ("not measured" if parent_ms is None else f"{parent_ms:.4f} ms")
                + f" (graph replays in turns: {readings}), bound {bnd:.4f} ms (operations "
                f"{t_ops:.4f} {'at 3xTF32' if dtype == torch.float32 else 'in bf16'} on the "
                f"tensor cores, bytes {t_bytes:.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms; "
                f"{calls} calls per forward")
            for key, t in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                           ("library_ms", lib), ("b1_ms", b1_ms), ("parent_ms", parent_ms)):
                tot[key] = None if t is None or tot[key] is None else tot[key] + calls * t
            lim["operations"] += calls * t_ops
            lim["bytes"] += calls * t_bytes
        tot["bound_by"] = max(lim, key=lim.get)
        log(f"[25] {card}: B5 D=32 {dt}, the 8 dense calls of one Transformer1d forward at "
            f"B={B}: kernel {tot['ms']:.4f} ms (B1 on the same calls {tot['b1_ms']:.4f} ms, the "
            "parent's B5 " + ("not measured" if tot["parent_ms"] is None
                              else f"{tot['parent_ms']:.4f} ms")
            + f"), bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}), plain "
            f"{tot['plain_ms']:.4f} ms, sdpa {tot['library_ms']:.4f} ms")
    return {**totals["float32"], "bf16": totals["bfloat16"]}


def dense_other_d_times(card):
    """B5's mma template at its other head dims (DENSE_TIMED_D) at
    Transformer1d's first packable stage, (L, H) = (64, 16), B =
    T1D_SERVE_BATCH, f32, no bias: in turns with B1 without lse, beside the
    bound, the plain version and SDPA; one call each."""
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        attention_dense_reference,
        fused_attention_dense,
    )

    gen = torch.Generator().manual_seed(27)
    B, (L, H) = T1D_SERVE_BATCH, next(iter(T1D_DENSE_CALLS))
    rows = {}
    for D in DENSE_TIMED_D:
        q, k, v, _ = operands(B, H, L, False, torch.float32, gen, D=D, q_scale=D ** -0.5)
        b5_us, b1_us = in_turns(lambda: fused_attention_dense(q, k, v),
                                lambda: attention._launch(q, k, v, None))
        t_ops, t_bytes = dense_bound_terms(B, H, L, D, torch.float32)
        row = rows[D] = {
            "ms": statistics.mean(b5_us) / 1e3, "b1_ms": statistics.mean(b1_us) / 1e3,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "plain_ms": cuda_ms(lambda: attention_dense_reference(q, k, v), 5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0),
                                  20)}
        log(f"[25] {card}: B5 attention_dense_fwd D={D} float32 B={B} L={L} H={H}: kernel "
            f"{row['ms']:.4f} ms, B1 without lse {row['b1_ms']:.4f} ms (graph replays in turns, "
            f"B5 {b5_us[0]:.1f} / {b5_us[1]:.1f} us, B1 {b1_us[0]:.1f} / {b1_us[1]:.1f} us), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: operations {t_ops:.4f} at "
            f"3xTF32, bytes {t_bytes:.4f}), plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms")
    return rows


def phase_long(card, cpu_model):
    """Phase 26: B1 and B2 at D = 32 past 256 keys against their plain
    versions at every stage and batch below (D32_LONG); Transformer1d on
    T1D_LONG-sample inputs against the CPU (forward and one step); served
    windows/s; per-stage B1 and B2 times. The errors returned are the f32
    ones at the timed batch, T1D_LONG_SERVE_BATCH."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.models import Transformer1d
    from ecg_denoise_tpu_torch.train import create_train_state
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    t0 = time.perf_counter()
    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(27)
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for B, L, H in D32_LONG:
        for with_bias in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias = operands(B, H, L, with_bias, dtype, gen, D=32,
                                         q_scale=D32_Q_SCALE)
                out, lse = attention._launch(q, k, v, bias, with_lse=True)
                again, _ = attention._launch(q, k, v, bias, with_lse=True)
                ref, ref_lse = attention.attention_reference(q, k, v, bias, return_lse=True)
                g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
                o2, grads = kernel_grads(q, k, v, bias, g)
                _, grads2 = kernel_grads(q, k, v, bias, g)
                same = torch.equal(out, again) and all(
                    torch.equal(a, b) for a, b in zip(grads, grads2))
                refs = {"flash": attention.attention_backward_reference(
                    q, k, v, bias, o2, lse, g)}
                if dtype == torch.float32:
                    refs["autograd"] = plain_autograd_grads(q, k, v, bias, g)
                torch.cuda.synchronize()
                f32 = dtype == torch.float32
                timed = f32 and B == T1D_LONG_SERVE_BATCH
                err = (out.float() - ref.float()).abs().max().item()
                tol = F32_TOL if f32 else BF16_TOL_OF_MAX_V * v.float().abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                lse_tol = LSE_TOL * max(1.0, ref_lse.abs().max().item())
                errs = []
                for ref_name, gref in refs.items():
                    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, gref):
                        bar = (D32_GRAD_TOL_OF_MAX if f32 else BF16_GRAD_TOL_OF_MAX) * \
                            b.float().abs().max().item()
                        e = (a.float() - b.float()).abs().max().item()
                        errs.append(f"{name} vs {ref_name} {e:.2e}/{bar:.2e}")
                        check(e <= bar, f"B2 at D = 32, L = {L}: {name} disagrees with the "
                                        f"plain {ref_name} backward")
                        if timed and ref_name == "flash":
                            max_err["bwd"] = max(max_err["bwd"], e)
                if timed:
                    max_err["fwd"] = max(max_err["fwd"], err)
                log(f"[26] D=32 B={B} L={L} H={H} bias={with_bias} {str(dtype)[6:]}: B1 "
                    f"max_abs_err={err:.3e} (tol {tol:.3e}), lse {lse_err:.3e} (tol "
                    f"{lse_tol:.3e}); B2 " + ", ".join(errs) + "; a second call of each "
                    f"bit-identical: {same}")
                check(out.shape == q.shape and out.dtype == dtype, "B1 output shape or dtype")
                check(bool(torch.isfinite(out).all()) and err <= tol and lse_err <= lse_tol,
                      f"B1 at D = 32, L = {L} disagrees with its plain version")
                check(same, f"two calls of B1 or B2 at D = 32, L = {L} differ")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    # Transformer1d at its defaults on T1D_LONG samples: stages at L = 1000,
    # 500, 250, 125.
    rng = np.random.default_rng(26)
    x = torch.from_numpy(rng.standard_normal((T1D_LONG_CHECK_BATCH, 32, T1D_LONG)).astype(
        np.float32))
    launches = {}
    gpu_model = create_train_state(copy.deepcopy(cpu_model)).model.eval()
    with torch.no_grad():
        reset_launches()
        y = gpu_model(x.cuda())
        torch.cuda.synchronize()
        fwd_launches = read_launches()
        err = (y.cpu() - cpu_model(x)).abs().max().item()
    log(f"[26] Transformer1d, {T1D_LONG} samples, batch {T1D_LONG_CHECK_BATCH}, float32: card "
        f"vs CPU max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}); launches per forward "
        f"{ {k: n for k, n in fwd_launches.items() if n} }")
    check(bool(torch.isfinite(y).all()) and err <= MODEL_TOL,
          f"Transformer1d at {T1D_LONG} samples disagrees with the CPU")
    check(fwd_launches == expected_launches(fwd=12), "the long forward did not take 12 B1")
    b = T1D_LONG_STEP_BATCH
    launches["train_transformer1d_long"] = transformer1d_step_vs_cpu(
        cpu_model, x[:b], torch.from_numpy(rng.integers(0, 9, b)), "26",
        f" at {T1D_LONG} samples")

    # Served windows/s at T1D_LONG_SERVE_BATCH, f32 and bf16.
    xs = torch.from_numpy(rng.standard_normal(
        (T1D_LONG_SERVE_BATCH, 32, T1D_LONG)).astype(np.float32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        random_seed(26)
        model = create_train_state(Transformer1d(dtype=dtype)).model.eval()
        with torch.no_grad():
            model(xs)  # warm-up
            torch.cuda.synchronize()
            if dtype == torch.float32:
                reset_launches()  # the served forward at T1D_LONG samples
                model(xs)
                torch.cuda.synchronize()
                launches["serve_transformer1d_long"] = read_launches()
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                model(xs)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            fwd_ms = cuda_ms(lambda: model(xs), 5)
        log(f"[26] {card}: Transformer1d served {str(dtype)[6:]} batch {T1D_LONG_SERVE_BATCH} "
            f"at {T1D_LONG} samples: {T1D_LONG_SERVE_BATCH / statistics.median(walls):.1f} "
            f"windows/s (median of 5 forwards, host clock ending in a synchronize); forward "
            f"{fwd_ms:.3f} ms on the card's clock (CUDA events, mean of 5)")
    check(launches["serve_transformer1d_long"] == expected_launches(fwd=12),
          "the long served forward did not take 12 B1 launches")
    times = d32_kernel_times(card, T1D_LONG_CALLS, T1D_LONG_SERVE_BATCH,
                             T1D_LONG_SERVE_BATCH, "26")
    times["transformer1d"] = t1d_rates_in_turns(card, T1D_LONG, T1D_LONG_SERVE_BATCH,
                                                T1D_LONG_SERVE_BATCH, "26")
    log(f"chip_smoke: phase 26 took {time.perf_counter() - t0:.1f} s")
    return launches, max_err, times


def phase_jax_checkpoint(card):
    """Phase 27: the JAX package's UNet checkpoint (tests/data/jax_ckpt),
    served by `Denoiser.from_checkpoint` and `cli.serve --ckpt` on the card
    against JAX's committed output, and resumed for one training step."""
    from ecg_denoise_tpu_torch.cli.serve import build
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.serving import Denoiser
    from ecg_denoise_tpu_torch.train import create_train_state, load_checkpoint, make_epoch_fns

    t0 = time.perf_counter()
    launches = {}
    ev = np.load(JAX_EVAL)
    denoiser = Denoiser.from_checkpoint("unet", JAX_CKPT, max_batch=BATCH)
    y = denoiser(ev["x"])
    err = float(np.abs(y - ev["y"]).max())
    log(f"[27] Denoiser.from_checkpoint('unet', {os.path.relpath(JAX_CKPT)}) on the card: "
        f"{len(ev['x'])} windows vs JAX's committed output max_abs_err={err:.3e} (tol "
        f"{MODEL_TOL:.0e})")
    check(np.isfinite(y).all() and err <= MODEL_TOL,
          "the JAX checkpoint served on the card disagrees with JAX's output")

    server, cli_denoiser = build(["--model", "unet", "--ckpt", JAX_CKPT, "--port", "0"])
    direct = cli_denoiser(ev["x"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reset_launches()  # the CLI's server on a JAX checkpoint
        got, timing = _post(f"http://127.0.0.1:{server.server_address[1]}/denoise", ev["x"])
        launches["serve_jax_ckpt"] = read_launches()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    err_cli = float(np.abs(got - direct).max())
    log(f"[27] cli.serve --model unet --ckpt <the JAX checkpoint>: /denoise N={len(ev['x'])} "
        f"max_abs_err vs its Denoiser {err_cli:.3e}, vs Denoiser.from_checkpoint "
        f"{float(np.abs(got - y).max()):.3e}; {timing}; launches {launches['serve_jax_ckpt']}")
    check(got.shape == y.shape and err_cli <= 1e-6, "cli.serve disagrees with its Denoiser")
    check(launches["serve_jax_ckpt"] == expected_launches(), "UNet's serving launched a kernel")
    check(not thread.is_alive(), "the server thread did not stop")

    state = load_checkpoint(JAX_CKPT, create_train_state(build_model("unet")))
    step0 = state.step
    train_epoch, _ = make_epoch_fns(state.model, state.optimizer)
    noisy = torch.from_numpy(ev["x"][:4]).cuda()
    reset_launches()  # one training step resumed from the JAX checkpoint
    got = train_epoch(noisy, 0.5 * noisy, torch.Generator(device="cuda").manual_seed(0), 4)
    launches["train_jax_ckpt"] = read_launches()
    log(f"[27] load_checkpoint of the JAX TrainState: Adam step {step0} -> {state.step} after "
        f"one step on the card, loss {got['loss']:.6f}; launches {launches['train_jax_ckpt']}")
    check(step0 == 1 and state.step == 2 and np.isfinite(got["loss"]),
          "the resumed JAX checkpoint did not take one finite step")
    check(launches["train_jax_ckpt"] == expected_launches(), "UNet's step launched a kernel")
    log(f"chip_smoke: phase 27 took {time.perf_counter() - t0:.1f} s")
    return launches


def dp_step_result(state, metrics, mesh=None):
    """A step's loss, gradients, parameters and state_dict on the host, in
    one process's layout (gathered over the model group under tensor
    parallelism), and this rank's own state_dict ("local")."""
    from ecg_denoise_tpu_torch.parallel import gather_named

    def host(tensors):
        if mesh is not None:
            tensors = gather_named(tensors, state.model, mesh)
        return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}

    params = dict(state.model.named_parameters())
    local = state.model.state_dict()
    return {"loss": metrics["loss"],
            "grads": host({k: p.grad for k, p in params.items() if p.grad is not None}),
            "params": host(params), "state": host(local),
            "local": {k: v.to("cpu", copy=True) for k, v in local.items()}}


def dp_bars(got, ref):
    """One step's result against another's at phase 7's bars: the loss's
    relative error, the BN stats' max difference and every parameter's
    (`all_params`, the elements at the rounding floor too), with the
    gradients held by `step_bars`. Its rule that only a bias may sit at the
    floor whole is not applied: every parameter is held here, a whole
    tensor at the floor too (a partial conv's 3-tap weight deep in the r_pos
    model has gradients below 1e-6 of the largest, alike in both runs)."""
    bars = step_bars(got["grads"], ref["grads"], got["params"], ref["params"])
    # A run through `fit` reports no loss: then the loss is not held.
    bars["loss_rel"] = (abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) if "loss" in ref
                        else None)
    bars["stats"] = max((got["state"][k] - v).abs().max().item()
                        for k, v in ref["state"].items()
                        if k.endswith(("running_mean", "running_var")))
    bars["all_params"] = max((got["params"][k] - v).abs().max().item()
                             for k, v in ref["params"].items())
    bars["ok"] = (bars["grads"] <= 1 and bars["all_params"] <= PARAM_TOL
                  and (bars["loss_rel"] is None or bars["loss_rel"] <= LOSS_RTOL)
                  and bars["stats"] <= BN_STATS_TOL)
    return bars


def describe_dp_bars(bars):
    loss = ("loss not reported" if bars["loss_rel"] is None
            else f"loss rel {bars['loss_rel']:.2e} (tol {LOSS_RTOL:.0e})")
    return (f"{loss}, BN stats max diff "
            f"{bars['stats']:.2e} (tol {BN_STATS_TOL:.0e}), every parameter's max diff "
            f"{bars['all_params']:.2e}, whole tensors at the floor {bars['whole']}; "
            f"{describe_bars(bars)}")


def dp_step(weights, noisy, clean, r_pos, device, mesh=None):
    """RA-LENet 'full' f32 from `weights`, one step of `make_epoch_fns` on
    the whole global batch (a rank's share of it under `mesh`, its shard of
    the model where the mesh has a model group); returns (state,
    train_epoch, the step's result, its launches)."""
    from ecg_denoise_tpu_torch.parallel import shard_state_dp_tp
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns

    state = create_train_state(ralenet_from(weights, device), device=device)
    if mesh is not None and mesh.n_model > 1:
        shard_state_dp_tp(state, mesh)
    train_epoch, _ = make_epoch_fns(state.model, state.optimizer,
                                    detect_r_pos=r_pos == "detect", mesh=mesh)
    x, y = torch.from_numpy(noisy).to(device), torch.from_numpy(clean).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches()
    metrics = train_epoch(x, y, gen, noisy.shape[0])
    launches = read_launches()
    return state, functools.partial(train_epoch, x, y, gen, noisy.shape[0]), \
        dp_step_result(state, metrics, mesh), launches


def ralenet_from(weights, device):
    """RA-LENet 'full' f32 on `device` holding `weights` (a state_dict)."""
    from ecg_denoise_tpu_torch.models import build_model

    model = build_model("ralenet", device=device)
    model.load_state_dict(weights)
    return model


def dp_batch(r_pos):
    """Phase 28's global batch: DP_BATCH random windows, or beat windows
    with r_pos."""
    if r_pos:
        return beat_windows(DP_BATCH, seed=41), beat_windows(DP_BATCH, seed=42)
    rng = np.random.default_rng(40)
    return tuple(rng.standard_normal((DP_BATCH, 2, 256)).astype(np.float32)
                 for _ in range(2))


def step_ms(step, device, reps=DP_TIMED_STEPS):
    """Host ms a step on `device`, each ending in a synchronize of the card,
    after one untimed."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
        sync()
    return (time.perf_counter() - t0) / reps * 1e3


def dp_rank(rank, store, workdir, device):
    """A rank of phase 28b: two processes on one card, over gloo. Each
    steps RA-LENet once on its half of the global batch, without and with
    r_pos, with its launches counted, then times DP_TIMED_STEPS more."""
    from ecg_denoise_tpu_torch.parallel import make_mesh

    torch.distributed.init_process_group("gloo", init_method=f"file://{store}",
                                         world_size=DP_WORLD, rank=rank)
    try:
        mesh = make_mesh(DP_WORLD, device=device, backend="gloo")
        weights = torch.load(os.path.join(workdir, "ralenet.pt"))
        out = {}
        for r_pos in (None, "detect"):
            _, step, result, launches = dp_step(weights, *dp_batch(r_pos), r_pos, device,
                                                mesh)
            out[r_pos] = {**result, "launches": launches, "ms": step_ms(step, device)}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_dp_cli(card, cache, tmp):
    """Phase 28a's CLI runs: `cli.main --model_index 4 --epochs 1` on the
    port-built cache, single process and with --n_data 1 (a process group
    of one, NCCL), each in a directory of its own: one result line each,
    one train_log.jsonl record, the same B1 and B2 launches."""
    counts = {}
    for argv in ([], ["--n_data", "1"]):
        run_dir = os.path.join(tmp, "dp" if argv else "single")
        os.makedirs(run_dir)
        reset_launches()  # the main path
        with contextlib.chdir(run_dir):
            wall = run_module("ecg_denoise_tpu_torch.cli.main",
                              ["--model_index", "4", "--epochs", "1", "--data_path", cache,
                               *argv], "28a", out=io.StringIO())
            with open("output.txt") as f:
                lines = f.read().splitlines()
            with open("train_log.jsonl") as f:
                records = [json.loads(line) for line in f]
        counts[bool(argv)] = read_launches()
        log(f"[28a] {card}: cli.main --model_index 4 --epochs 1 {' '.join(argv)} in "
            f"{wall:.1f} s (host clock): output.txt {lines}; train_log.jsonl "
            f"{[(r['fn'], r['status']) for r in records]}; launches {counts[bool(argv)]}")
        check(len(lines) == 1 and lines[0].startswith("ralenet_0_bw_intensity-4:snr:"),
              f"the CLI {argv} did not write its result line once")
        check(len(records) == 1 and records[0]["status"] == "ok",
              f"the CLI {argv} did not record its run once")
        check(not torch.distributed.is_initialized(), "the CLI left its process group")
    check(counts[True] == counts[False] and counts[True]["attention_fwd"] > 0
          and counts[True]["attention_bwd"] > 0,
          "cli.main --n_data 1 launched other kernels than the single process")
    return counts[True]


def phase_data_parallel(card, cpu_model, cache, device="cuda"):
    """Phase 28: data parallelism. (a) NCCL at world size 1: `cli.main
    --n_data 1` against the single-process CLI, and one step under
    make_mesh(1) against the single-process step; (b) two processes on the
    one card over gloo, each stepping its half of the global batch,
    without and with r_pos, against the single-process step; (c) serving
    on two replicas on the one card. The DP step's ms at world 1 and 2
    against the single process's. (`device` is the card but where the
    phase is rehearsed on the CPU.)"""
    from ecg_denoise_tpu_torch.parallel import make_mesh
    from ecg_denoise_tpu_torch.serving import Denoiser

    t0 = time.perf_counter()
    weights = cpu_model.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = phase_dp_cli(card, cache, tmp)

        # (a) one step under make_mesh(1) against the single process's.
        noisy, clean = dp_batch(None)
        _, single_step, single, single_launches = dp_step(weights, noisy, clean, None,
                                                          device)
        mesh = make_mesh(1, device=device)
        try:
            _, dp1_step, dp1, dp1_launches = dp_step(weights, noisy, clean, None, device,
                                                     mesh)
            bars = dp_bars(dp1, single)
            times = {"single": [], "dp1": []}
            for name in ("single", "dp1", "dp1", "single"):
                times[name].append(step_ms(single_step if name == "single" else dp1_step,
                                           device))
        finally:
            torch.distributed.destroy_process_group()
        log(f"[28a] {card}: one step at world 1 (NCCL, make_mesh(1)) vs the single "
            f"process, f32, batch {DP_BATCH}: {describe_dp_bars(bars)}; launches "
            f"{dp1_launches} (single {single_launches})")
        check(bars["ok"], "the step under make_mesh(1) disagrees with the single process's")
        check(dp1_launches == single_launches == expected_launches(fwd=18, bwd=18),
              "the step under make_mesh(1) did not make 18 + 18 launches")

        # (b) two processes on the one card, over gloo.
        torch.save(weights, os.path.join(tmp, "ralenet.pt"))
        singles = {}
        for r_pos in (None, "detect"):
            _, step, singles[r_pos], _ = dp_step(weights, *dp_batch(r_pos), r_pos, device)
            singles[r_pos]["ms"] = step_ms(step, device)
        t_spawn = time.perf_counter()
        rank_device = "cuda:0" if device == "cuda" else device  # both ranks on one card
        torch.multiprocessing.spawn(dp_rank, args=(os.path.join(tmp, "store"), tmp,
                                                   rank_device), nprocs=DP_WORLD)
        spawn_s = time.perf_counter() - t_spawn
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(DP_WORLD)]
        single_after = step_ms(single_step, device)
    launches = {"train_dp": dict(cli_launches)}
    world2_ms = {}
    for r_pos in (None, "detect"):
        path = "train_dp_rpos" if r_pos else "train_dp"
        want = (expected_launches(fwd=4, bwd=4, rpos_fwd=14, rpos_bwd=14) if r_pos
                else expected_launches(fwd=18, bwd=18))
        counts = launches.setdefault(path, dict.fromkeys(KERNELS, 0))
        for r, rank in enumerate(ranks):
            got = rank[r_pos]
            bars = dp_bars(got, singles[r_pos])
            log(f"[28b] {card}: rank {r} of {DP_WORLD} on cuda:0 (gloo), r_pos={r_pos!r}, "
                f"f32, {DP_BATCH // DP_WORLD} of a global batch of {DP_BATCH}: vs the single "
                f"process's step on the card: {describe_dp_bars(bars)}; launches "
                f"{got['launches']}")
            check(bars["ok"], f"rank {r}'s DP step (r_pos={r_pos!r}) disagrees with the "
                              "single process's")
            check(got["launches"] == want, f"rank {r}'s DP step (r_pos={r_pos!r}) did not "
                                           f"launch {want}")
            check(all(torch.equal(v, ranks[0][r_pos]["state"][k])
                      for k, v in got["state"].items()),
                  "the ranks' states differ after the step")
            for k, n in got["launches"].items():
                counts[k] += n
        world2_ms["rpos" if r_pos else "plain"] = [rank[r_pos]["ms"] for rank in ranks]
    log(f"[28] {card}: RA-LENet 'full' f32 step ms at global batch {DP_BATCH} (host clock "
        f"to a synchronize, mean of {DP_TIMED_STEPS}): single process "
        f"{', '.join(f'{v:.3f}' for v in times['single'])} (in turns with) world 1 NCCL "
        f"{', '.join(f'{v:.3f}' for v in times['dp1'])}; world 2 on one card over gloo "
        f"({DP_BATCH // DP_WORLD} a rank), rank 0 / 1: "
        f"{' / '.join(f'{v:.3f}' for v in world2_ms['plain'])} "
        f"against the single process's {singles[None]['ms']:.3f} before and "
        f"{single_after:.3f} after; r_pos: world 2 "
        f"{' / '.join(f'{v:.3f}' for v in world2_ms['rpos'])} against "
        f"{singles['detect']['ms']:.3f}; the spawn of both ranks {spawn_s:.1f} s")

    # (c) serving on two replicas on the one card.
    x = np.random.default_rng(43).standard_normal((BATCH, 2, 256)).astype(np.float32)
    one = Denoiser(copy.deepcopy(cpu_model), max_batch=BATCH, device=device)
    two = Denoiser(copy.deepcopy(cpu_model), max_batch=BATCH, n_data=DP_WORLD,
                   devices=[rank_device] * DP_WORLD)
    ref = one(x)
    reset_launches()  # the served path
    got = two(x)  # its fetch synchronises the card
    launches["serve_dp"] = read_launches()
    err = float(np.abs(got - ref).max())
    log(f"[28c] {card}: Denoiser(n_data={DP_WORLD}, devices=['cuda:0'] * {DP_WORLD}) at "
        f"{BATCH} windows, inference_path {two.inference_path}: max |diff| {err:.2e} "
        f"against n_data=1 (tol {DP_SERVE_TOL:.0e}); launches {launches['serve_dp']}")
    check(err <= DP_SERVE_TOL, "two replicas disagree with one")
    check(two.inference_path == "torch+attn-cuda+dp2:cuda",
          f"the DP path is named {two.inference_path}")
    check(launches["serve_dp"] == expected_launches(fwd=18 * DP_WORLD),
          "the two replicas did not make 18 B1 launches each")
    log(f"chip_smoke: phase 28 took {time.perf_counter() - t0:.1f} s")
    return launches, {"world1_ms": times, "world2_ms": world2_ms,
                      "single_ms": {"plain": singles[None]["ms"], "after": single_after,
                                    "rpos": singles["detect"]["ms"]}}


def tp_eval_windows():
    """Phase 29d's eval split: TP_EVAL_WINDOWS random windows (the last
    batch at DP_BATCH ragged)."""
    rng = np.random.default_rng(44)
    return tuple(rng.standard_normal((TP_EVAL_WINDOWS, 2, 256)).astype(np.float32)
                 for _ in range(2))


def tp_fit_resume(ckpt, out, device, mesh=None):
    """`fit(resume_path=ckpt)` for one epoch of one step on phase 28's
    global batch (the eval on tp_eval_windows), under `mesh` or in one
    process: the step's result (`dp_step_result`) with its epoch's lists."""
    from ecg_denoise_tpu_torch.models import build_model
    from ecg_denoise_tpu_torch.train import fit

    state, lists = fit(build_model("ralenet", device=device), *dp_batch(None),
                       *tp_eval_windows(), epochs=1, batch_size=DP_BATCH,
                       model_name="ralenet", model_save_dir=os.path.join(out, "model_save"),
                       output_file=os.path.join(out, "output.txt"), checkpoint_every=1,
                       resume_path=ckpt, verbose=False, device=device, mesh=mesh)
    result = dp_step_result(state, {"loss": None}, mesh)
    del result["loss"]  # fit returns the epoch's SNR and RMSE, not its loss
    return {**result, "lists": lists, "step": state.step}


def tp_eval(weights, device, mesh=None):
    """The eval epoch of `weights` over tp_eval_windows at DP_BATCH, with
    ECG_ATTN_DENSE=1 and without (under `mesh`: on this rank's shard),
    each with its launches and the first batch's forward."""
    from ecg_denoise_tpu_torch.parallel import shard_state_dp_tp
    from ecg_denoise_tpu_torch.train import create_train_state, make_epoch_fns

    state = create_train_state(ralenet_from(weights, device), device=device)
    if mesh is not None:
        shard_state_dp_tp(state, mesh)
    _, eval_epoch = make_epoch_fns(state.model, state.optimizer, mesh=mesh)
    x, y = (torch.from_numpy(a).to(device) for a in tp_eval_windows())
    out = {}
    for dense in (True, False):
        with dense_route(dense):
            reset_launches()  # the eval path
            metrics = eval_epoch(x, y, DP_BATCH)
            launches = read_launches()
            with torch.no_grad():
                pred = state.model.eval()(x[:DP_BATCH]).to("cpu")
        out[dense] = {"metrics": metrics, "launches": launches, "pred": pred}
    return out


def tp_rank(rank, store, workdir, device, n_data, n_model):
    """A rank of phase 29: n_data * n_model processes on one card, over
    gloo, on the (n_data, n_model) grid. Each steps RA-LENet once on its
    data index's rows with its model rank's shard, with its launches
    counted (with and without r_pos at n_data = 1), then times
    DP_TIMED_STEPS more. At n_data = 1 the ranks also write the plain
    step's gathered checkpoint (rank 0), resume it through `fit`, and run
    the eval epoch with and without ECG_ATTN_DENSE=1."""
    from ecg_denoise_tpu_torch.parallel import gather_state, make_mesh
    from ecg_denoise_tpu_torch.train import save_checkpoint

    torch.distributed.init_process_group("gloo", init_method=f"file://{store}",
                                         world_size=n_data * n_model, rank=rank)
    try:
        mesh = make_mesh(n_data, n_model, device=device, backend="gloo")
        weights = torch.load(os.path.join(workdir, "ralenet.pt"))
        out = {}
        for r_pos in (None, "detect") if n_data == 1 else (None,):
            state, step, result, launches = dp_step(weights, *dp_batch(r_pos), r_pos, device,
                                                    mesh)
            if r_pos is None and n_data == 1:
                contents = gather_state(state, mesh)  # every rank: the all-gathers
                if mesh.is_primary:
                    save_checkpoint(os.path.join(workdir, "tp.pth"), state, contents)
            out[r_pos] = {**result, "launches": launches, "ms": step_ms(step, device)}
        if n_data == 1:
            torch.distributed.barrier()  # rank 0's checkpoint is written
            out["resume"] = tp_fit_resume(os.path.join(workdir, "tp.pth"),
                                          os.path.join(workdir, "resume"), device, mesh)
            out["eval"] = tp_eval(weights, device, mesh)
        torch.save(out, os.path.join(workdir, f"tp{n_data}x{n_model}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def check_tp_replicas(ranks, n_model, key):
    """The ranks of one data index hold the same replicated tensors, and the
    ranks of one model index the same shards, bit for bit."""
    full = ranks[0][key]["state"]
    for name, val in ranks[0][key]["local"].items():
        sharded = val.shape != full[name].shape
        for r, rank in enumerate(ranks):
            same = ranks[r % n_model] if sharded else ranks[0]
            check(torch.equal(rank[key]["local"][name], same[key]["local"][name]),
                  f"rank {r}'s {'shard' if sharded else 'replica'} of {name} differs "
                  f"({key!r})")


def check_tp_step(card, grid, r, got, ref, want, what):
    """One rank's gathered step against the single process's (`dp_bars`)
    and its launches against `want`."""
    bars = dp_bars(got, ref)
    log(f"[29] {card}: grid {grid}, rank {r} (data {r // grid[1]}, model {r % grid[1]}) on "
        f"cuda:0 (gloo), {what}, f32, a global batch of {DP_BATCH}: the gathered step vs the "
        f"single process's on the card: {describe_dp_bars(bars)}; launches {got['launches']}")
    check(bars["ok"], f"rank {r} of grid {grid} ({what}) disagrees with the single process")
    check(got["launches"] == want, f"rank {r} of grid {grid} ({what}) did not launch {want}")


def phase_tensor_parallel(card, cpu_model, device="cuda"):
    """Phase 29: tensor parallelism. (a) the (1, 2) grid, two processes on
    the one card over gloo: one step without and with r_pos against the
    single process's; (b) the (2, 2) grid, four processes: one step; (c)
    (a)'s gathered checkpoint served by `Denoiser.from_checkpoint` and
    resumed by `fit` under (1, 2); (d) the eval epoch under (1, 2), dense
    and default; (e) the step's ms at (1, 2) and (2, 2) against the single
    process's. (`device` is the card but where the phase is rehearsed on
    the CPU.)"""
    from ecg_denoise_tpu_torch.serving import Denoiser

    t0 = time.perf_counter()
    weights = cpu_model.state_dict()
    rank_device = "cuda:0" if device == "cuda" else device  # every rank on one card
    launches = {path: dict.fromkeys(KERNELS, 0) for path in TP_PATHS}

    def add(path, counts):
        for k, n in counts.items():
            launches[path][k] += n

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(weights, os.path.join(tmp, "ralenet.pt"))
        singles, steps = {}, {}
        for r_pos in (None, "detect"):
            _, steps[r_pos], singles[r_pos], _ = dp_step(weights, *dp_batch(r_pos), r_pos,
                                                         device)
            singles[r_pos]["ms"] = step_ms(steps[r_pos], device)
        ranks, spawn_s = {}, {}
        for grid in TP_GRIDS:
            t_spawn = time.perf_counter()
            torch.multiprocessing.spawn(
                tp_rank, args=(os.path.join(tmp, f"store{grid[0]}x{grid[1]}"), tmp,
                               rank_device, *grid), nprocs=grid[0] * grid[1])
            spawn_s[grid] = time.perf_counter() - t_spawn
            ranks[grid] = [torch.load(os.path.join(tmp, f"tp{grid[0]}x{grid[1]}_rank{r}.pt"))
                           for r in range(grid[0] * grid[1])]
        single_after = step_ms(steps[None], device)

        # (a), (b): the steps.
        for grid, results in ranks.items():
            for r_pos in (None, "detect") if grid[0] == 1 else (None,):
                path = "train_tp_rpos" if r_pos else "train_tp"
                want = (expected_launches(fwd=4, bwd=4, rpos_fwd=14, rpos_bwd=14) if r_pos
                        else expected_launches(fwd=18, bwd=18))
                for r, result in enumerate(results):
                    check_tp_step(card, grid, r, result[r_pos], singles[r_pos], want,
                                  f"r_pos={r_pos!r}")
                    add(path, result[r_pos]["launches"])
                check_tp_replicas(results, grid[1], r_pos)

        # (c) the gathered checkpoint of (1, 2): served, and resumed.
        ckpt = os.path.join(tmp, "tp.pth")
        x = np.random.default_rng(45).standard_normal((TP_SERVE_WINDOWS, 2, 256)).astype(
            np.float32)
        served = Denoiser.from_checkpoint("ralenet", ckpt, max_batch=TP_SERVE_WINDOWS,
                                          device=device)
        one = Denoiser(ralenet_from(singles[None]["state"], device),
                       max_batch=TP_SERVE_WINDOWS, device=device)
        ref = one(x)
        reset_launches()  # the served path
        got = served(x)  # its fetch synchronises the card
        launches["serve_tp_ckpt"] = read_launches()
        err = float(np.abs(got - ref).max())
        gathered = ranks[(1, 2)][0][None]["state"]
        same = all(torch.equal(v.cpu(), gathered[k])
                   for k, v in served.model.state_dict().items())
        log(f"[29c] {card}: the (1, 2) step's gathered checkpoint served by "
            f"Denoiser.from_checkpoint at {TP_SERVE_WINDOWS} windows: its weights equal to the "
            f"gathered state bit for bit {same}; max |diff| {err:.2e} against the single "
            f"process's model after the same step (tol {TP_SERVE_TOL:.0e}); launches "
            f"{launches['serve_tp_ckpt']}")
        check(same, "the served checkpoint is not the gathered state")
        check(err <= TP_SERVE_TOL, "the served TP checkpoint disagrees with the single process")
        check(launches["serve_tp_ckpt"] == expected_launches(fwd=18),
              "serving the TP checkpoint did not make 18 B1 launches")
        resumed = tp_fit_resume(ckpt, os.path.join(tmp, "single_resume"), device)
        for r, result in enumerate(ranks[(1, 2)]):
            got = result["resume"]
            bars = dp_bars(got, resumed)
            log(f"[29c] {card}: rank {r} of (1, 2), fit(resume_path=...) one more step (step "
                f"{got['step']}): vs one process resumed from the same checkpoint: "
                f"{describe_dp_bars(bars)}; lists {got['lists']} against {resumed['lists']}")
            check(bars["ok"] and got["step"] == resumed["step"] == 2,
                  f"rank {r}'s resumed step disagrees with one process's")
            check(all(abs(a[0] - b[0]) <= TP_EVAL_TOL * max(1.0, abs(b[0]))
                      for a, b in zip(got["lists"], resumed["lists"])),
                  f"rank {r}'s resumed epoch's metrics disagree with one process's")

    # (d) the eval epoch under (1, 2), dense and default.
    single_eval = tp_eval(weights, device)
    for dense in (True, False):
        batches = -(-TP_EVAL_WINDOWS // DP_BATCH)
        want = (expected_launches(fwd=6 * batches, dense=12 * batches) if dense
                else expected_launches(fwd=18 * batches))
        for r, result in enumerate(ranks[(1, 2)]):
            got, ref = result["eval"][dense], single_eval[dense]
            pred_err = (got["pred"] - ref["pred"]).abs().max().item()
            metric_err = max(abs(got["metrics"][k] - ref["metrics"][k]) for k in ref["metrics"])
            log(f"[29d] {card}: rank {r} of (1, 2), eval epoch over {TP_EVAL_WINDOWS} windows at "
                f"{DP_BATCH}, ECG_ATTN_DENSE={int(dense)}: metrics {got['metrics']} against the "
                f"single process's {ref['metrics']} (max |diff| {metric_err:.2e}), the first "
                f"batch's forward max |diff| {pred_err:.2e} (tol {TP_EVAL_TOL:.0e}); launches "
                f"{got['launches']}")
            check(pred_err <= TP_EVAL_TOL and metric_err <= TP_EVAL_TOL,
                  f"rank {r}'s eval (dense={dense}) disagrees with the single process's")
            check(got["launches"] == want == ref["launches"],
                  f"rank {r}'s eval (dense={dense}) did not launch {want}")
            if dense:
                add("eval_tp_dense", got["launches"])

    tp_ms = {f"{d}x{m}": {"plain": [rank[None]["ms"] for rank in ranks[(d, m)]]}
             for d, m in TP_GRIDS}
    tp_ms["1x2"]["rpos"] = [rank["detect"]["ms"] for rank in ranks[(1, 2)]]
    log(f"[29e] {card}: RA-LENet 'full' f32 step ms at a global batch of {DP_BATCH} (host "
        f"clock to a synchronize, mean of {DP_TIMED_STEPS}), every rank on cuda:0 over gloo: "
        f"single process {singles[None]['ms']:.3f} before the spawns and {single_after:.3f} "
        f"after; (1, 2) ranks {' / '.join(f'{v:.3f}' for v in tp_ms['1x2']['plain'])}; (2, 2) "
        f"ranks {' / '.join(f'{v:.3f}' for v in tp_ms['2x2']['plain'])}; r_pos: single "
        f"{singles['detect']['ms']:.3f}, (1, 2) "
        f"{' / '.join(f'{v:.3f}' for v in tp_ms['1x2']['rpos'])}; the spawns "
        f"{', '.join(f'{g}: {v:.1f} s' for g, v in spawn_s.items())}. Two or four ranks "
        "sharing one card and its host measure sharing, not scaling.")
    log(f"chip_smoke: phase 29 took {time.perf_counter() - t0:.1f} s")
    return launches, {"ranks_ms": tp_ms,
                      "single_ms": {"plain": singles[None]["ms"], "after": single_after,
                                    "rpos": singles["detect"]["ms"]}}


def kernel_resources(name, pick, csrc=None):
    """The kernels of library `name` whose mangled names hold one of `pick`,
    as the compiler left them: {function: {library, registers, stack, local,
    hmma}} (cuobjdump -res-usage, and the HMMA instructions of -sass). This
    tree's library, or the one built from `csrc` (the parent's)."""
    from pathlib import Path

    from ecg_denoise_tpu_torch.kernels.build import CSRC, _nvcc, _target

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    lib = str(_target(name, Path(csrc) if csrc else CSRC))
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                           timeout=300, check=True).stdout
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split(None, 1)[0]
        if any(p in fn for p in pick):
            found[fn] = {"library": name,
                         "hmma": sum("HMMA" in line for line in part.splitlines())}
    for fn, reg, stack, local in re.findall(
            r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", usage):
        if fn in found:
            found[fn].update(registers=int(reg), stack=int(stack), local=int(local))
    return found


def kernel_key(fn):
    """A kernel instantiation's family, from its mangled name: (kernel name,
    element type, the template's flags, and the head dim of a D-templated
    mma kernel), alike in this tree and the parent's where the template is
    (B2's dbias passes lost their window flag: their flags are left out)."""
    m = re.search(r"\d+(attention_\w+?_kernel)I(.*?)EEv", fn)
    if m is None:
        return fn, "", ""
    flags = "" if "dbias" in m.group(1) else "".join(re.findall(
        r"Li\d+E|Lb[01]E" if "_mma_kernel" in m.group(1) else r"Lb[01]E", m.group(2)))
    return m.group(1), "bf16" if "bfloat16" in m.group(2) else "f32", flags


def stack_against_parent(found, pick, tag):
    """Each instantiation's stack here (those of `pick`; in phase 30 the
    wide ones) against the parent's same family (`kernel_key`), where the
    parent's tree is there: logged, and none may be larger; a family the
    parent has not may have none. {family: [this, parent]}; empty without
    the parent's tree."""
    if not parent_libs():
        log(f"[{tag}] the parent's stack not compared (no tree under _archive/parent)")
        return {}
    theirs = {}
    for name in sorted({r["library"] for r in found.values()}):
        for fn, r in kernel_resources(name, pick, csrc=PARENT_CSRC).items():
            key = (name, *kernel_key(fn))
            theirs[key] = max(theirs.get(key, 0), r.get("stack", 0) + r.get("local", 0))
    out = {}
    for fn, r in sorted(found.items()):
        key = (r["library"], *kernel_key(fn))
        mine = r.get("stack", 0) + r.get("local", 0)
        out[" ".join(k for k in key if k)] = [mine, theirs.get(key)]
        log(f"[{tag}] {' '.join(k for k in key if k)}: stack {mine} bytes, the parent's "
            f"{theirs.get(key)}")
        check(mine <= theirs.get(key, 0),
              f"{' '.join(key)}: more stack than the parent's ({mine} > {theirs.get(key)})")
    return out


def log_wide_clusters(tag, name, dims):
    """The wide kernels' clusters of library `name` at each head dim: the
    size in blocks and the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters) by instantiation (f32 and bf16, with
    and without a bias where the library has both), for the forward's
    kernel, or the backward's dq and dk/dv passes in turn. {D:
    {instantiation: [size, clusters, ...]}}."""
    import ctypes

    from ecg_denoise_tpu_torch.kernels.build import load

    f = load(name).ecg_wide_clusters
    f.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    window = "rpos" in name
    got = {}
    for D in dims:
        for dtype, dt in ((0, "f32"), (1, "bf16")):
            for bias in ((1,) if window else (0, 1)):
                out = (ctypes.c_int * 4)()
                err = f(D, dtype, bias, torch.cuda.current_device(), out)
                check(err == 0, f"{name}: cudaOccupancyMaxActiveClusters failed ({err}) at D={D}")
                n = 2 if name.endswith("fwd") else 4
                got.setdefault(D, {})[f"{dt}{'' if window else f' bias={bias}'}"] = list(out)[:n]
    log(f"[{tag}] {name} wide clusters by D (size in blocks, then the clusters the card holds "
        f"at once{'; the dq pass, then the dk/dv pass' if not name.endswith('fwd') else ''}): "
        f"{got}")
    return got


def log_wide_resources():
    """The wide kernels of B1, B2 and B5 (head_dim past 64) as the compiler
    left them, by instantiation: registers, stack and local memory
    (cuobjdump -res-usage) and the tensor-core instructions in their SASS
    (HMMA); B1's and B2's stack against the parent's where its tree is there
    (none may be larger), and their clusters (size, and the clusters the card
    holds at once, at D = 128, 256, 320, 576). A kernel with no HMMA fails
    the run; spills are reported (a spilling kernel that is right is kept,
    its numbers in PERF.md)."""
    found = {}
    for name in ("attention_fwd", "attention_bwd", "attention_dense_fwd"):
        found.update(kernel_resources(name, ("_wide_kernel",)))
    for fn, r in sorted(found.items()):
        log(f"[30] {fn}: {r.get('registers')} registers, stack {r.get('stack')} bytes, local "
            f"{r.get('local')} bytes; {r['hmma']} HMMA instructions")
    # B1: f32 and bf16, with and without a bias (4); B2: dq and dk/dv 4
    # each, dbias 2; B5: 4 at each key span 16, 32, 64.
    check(len(found) == 4 + 10 + 12, f"{len(found)} of the 26 wide kernel instantiations found")
    check(all(r["hmma"] > 0 for r in found.values()), "a wide kernel issues no HMMA")
    check(all("registers" in r for r in found.values()), "a wide kernel's resources not read")
    out = {lib: {"registers": max(r["registers"] for r in found.values()
                                  if r["library"] == lib),
                 "stack_bytes": max(r["stack"] for r in found.values() if r["library"] == lib),
                 "spills": any(r["local"] or r["stack"] for r in found.values()
                               if r["library"] == lib)}
           for lib in ("attention_fwd", "attention_bwd", "attention_dense_fwd")}
    mine = {fn: r for fn, r in found.items() if r["library"] != "attention_dense_fwd"}
    stacks = stack_against_parent(mine, ("_wide_kernel",), "30")
    for lib in ("attention_fwd", "attention_bwd"):
        out[lib]["stack_against_parent"] = {k: v for k, v in stacks.items() if k.startswith(lib)}
        out[lib]["clusters"] = log_wide_clusters("30", lib, (128, 256, 320, 576))
    return out


def wide_bars(name, got, ref, dtype, L):
    """(err, tol) of one gradient of B2 against a plain backward: f32 1e-4
    of its max (dbias too), bf16 2^-7 of it; at L = 1 dq, dk and dbias are
    0 and their bars are taken of max|dv| (`phase_backward_vs_plain`)."""
    i = ("dq", "dk", "dv", "dbias").index(name)
    scale = ref[2 if L == 1 and name != "dv" else i].float().abs().max().item()
    tol = (BF16_GRAD_TOL_OF_MAX if dtype == torch.bfloat16 else D32_GRAD_TOL_OF_MAX) * scale
    return (got.float() - ref[i].float()).abs().max().item(), tol


def phase_wide_kernels():
    """Phase 30a: the wide kernels (head_dim past 64) against their plain
    versions at every WIDE_DIMS, f32 and bf16, with and without a bias: B1
    (its output and lse, a second call bit-identical) and B2 (through the
    autograd Function, against the plain flash backward on the kernel's
    own o and lse and, in f32, autograd through the plain forward) at
    WIDE_B12_SHAPES; B5 against its plain version and B1 without lse at
    WIDE_B5_SHAPES. Every call launches its kernel: the counts move by
    exactly the calls made."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        attention_dense_reference,
        fused_attention_dense,
    )

    fused = attention.fused_attention
    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(30)
    max_err = {"fwd": 0.0, "bwd": 0.0, "dense": 0.0}
    for D in WIDE_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            for with_bias in (True, False):
                for B, L, H in WIDE_B12_SHAPES:
                    q, k, v, bias = operands(B, H, L, with_bias, dtype, gen, D=D,
                                             q_scale=D ** -0.5)
                    g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
                    before = (fused.launches, fused.bwd_launches)
                    out, lse = attention._launch(q, k, v, bias, with_lse=True)
                    again = attention._launch(q, k, v, bias)
                    out2, grads = kernel_grads(q, k, v, bias, g)
                    ref, ref_lse = attention.attention_reference(q, k, v, bias, return_lse=True)
                    refs = {"flash": attention.attention_backward_reference(
                        q, k, v, bias, out2, lse, g)}
                    if dtype == torch.float32:
                        refs["autograd"] = plain_autograd_grads(q, k, v, bias, g)
                    torch.cuda.synchronize()
                    launched = (fused.launches - before[0], fused.bwd_launches - before[1])
                    tol = (F32_TOL if dtype == torch.float32
                           else BF16_TOL_OF_MAX_V * v.float().abs().max().item())
                    err = (out.float() - ref.float()).abs().max().item()
                    lse_err = (lse - ref_lse).abs().max().item()
                    lse_tol = LSE_TOL * max(1.0, ref_lse.abs().max().item())
                    errs = []
                    ok = True
                    for ref_name, r in refs.items():
                        for name, a in zip(("dq", "dk", "dv", "dbias"), grads):
                            e, t = wide_bars(name, a, r, dtype, L)
                            ok &= e <= t
                            errs.append(f"{name}/{ref_name} {e:.2e}/{t:.2e}")
                            if dtype == torch.float32 and ref_name == "flash":
                                max_err["bwd"] = max(max_err["bwd"], e)
                    if dtype == torch.float32:
                        max_err["fwd"] = max(max_err["fwd"], err)
                    same = torch.equal(out, again) and torch.equal(out, out2)
                    log(f"[30] B1/B2 D={D} B={B} L={L} H={H} bias={with_bias} {dt}: out "
                        f"{err:.2e}/{tol:.2e}, lse {lse_err:.2e}/{lse_tol:.2e}; "
                        + ", ".join(errs) + f"; launches {launched}, the forward's three "
                        f"calls bit-identical: {same}")
                    check(out.shape == q.shape and out.dtype == dtype
                          and [t.dtype for t in grads] == [dtype] * len(grads),
                          f"B1/B2 at D = {D}: output shape or dtype")
                    check(bool(torch.isfinite(out).all()) and err <= tol and lse_err <= lse_tol,
                          f"B1 at D = {D} disagrees with its plain version")
                    check(ok and all(bool(torch.isfinite(t).all()) for t in grads),
                          f"B2 at D = {D} disagrees with its plain backward")
                    check(launched == (3, 1), f"B1/B2 at D = {D} made {launched} launches, "
                                              "not (3, 1)")
                    check(same, f"B1 at D = {D}: calls differ")
                for B, L, H in WIDE_B5_SHAPES:
                    q, k, v, bias = operands(B, H, L, with_bias, dtype, gen, D=D,
                                             q_scale=D ** -0.5)
                    before = fused_attention_dense.launches
                    out = fused_attention_dense(q, k, v, bias)
                    again = fused_attention_dense(q, k, v, bias)
                    b1 = attention._launch(q, k, v, bias)
                    torch.cuda.synchronize()
                    launched = fused_attention_dense.launches - before
                    err = (out.float() - attention_dense_reference(
                        q, k, v, bias).float()).abs().max().item()
                    err_b1 = (out.float() - b1.float()).abs().max().item()
                    tol = (F32_TOL if dtype == torch.float32
                           else BF16_TOL_OF_MAX_V * v.float().abs().max().item())
                    if dtype == torch.float32:
                        max_err["dense"] = max(max_err["dense"], err)
                    same = torch.equal(out, again)
                    log(f"[30] B5 D={D} B={B} L={L} H={H} bias={with_bias} {dt}: vs plain "
                        f"{err:.2e}, vs B1 without lse {err_b1:.2e} (tol {tol:.2e}); launches "
                        f"{launched}; a second call bit-identical: {same}")
                    check(out.shape == q.shape and out.dtype == dtype, f"B5 D={D} shape or dtype")
                    check(bool(torch.isfinite(out).all()) and err <= tol and err_b1 <= tol,
                          f"B5 at D = {D} disagrees with its plain version or with B1")
                    check(launched == 2, f"B5 at D = {D} made {launched} launches, not 2")
                    check(same, f"two B5 D={D} calls differ")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log(f"[30] the wide kernels within their bars at D = {WIDE_DIMS}: largest f32 errors B1 "
        f"{max_err['fwd']:.3e}, B2 {max_err['bwd']:.3e}, B5 {max_err['dense']:.3e}")
    return max_err


def wide_kernel_times(card):
    """Phase 30's kernel rows: per Transformer1d (1, 1, 2, 4) stage shape,
    B1 (no lse) at the served batch, B2 at the training batch and, at the
    packable stages, B5 at the served batch, f32 and bf16, from CUDA graph
    replays (B1 and B2 in turns with the parent's where its tree is there,
    `against_parent`), beside the bound (`mma_bound_terms`; bf16 one pass
    at its peak), the plain versions and SDPA (no mask); summed over one
    forward's and one step's calls. Times only: no bar."""
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels.attention_dense import (
        attention_dense_reference,
        fused_attention_dense,
    )
    from ecg_denoise_tpu_torch.probes.floor import graph_us

    gen = torch.Generator().manual_seed(31)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "parent_ms")
    totals = {(w, dt): dict.fromkeys(keys, 0.0 if parent_libs() and w != "dense" else None)
              for w in ("fwd", "bwd", "dense") for dt in ("float32", "bfloat16")}
    for t in totals.values():
        t.update(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    limits = {key: {"operations": 0.0, "bytes": 0.0} for key in totals}
    rows = []
    for (L, H, D), calls in WIDE_CALLS.items():
        for dtype in (torch.float32, torch.bfloat16):
            dt, elt = str(dtype)[6:], torch.finfo(dtype).bits // 8
            for what in ("fwd", "bwd", "dense"):
                if what == "dense" and (L, H, D) not in WIDE_DENSE_CALLS:
                    continue
                B = T1D_TRAIN_BATCH if what == "bwd" else T1D_SERVE_BATCH
                q, k, v, _ = operands(B, H, L, False, dtype, gen, D=D, q_scale=D ** -0.5)
                if what == "bwd":
                    g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
                    o, lse = attention._launch(q, k, v, None, with_lse=True)

                    def this():
                        return attention._launch_bwd(q, k, v, None, o, lse, g, want_dbias=False)

                    def parent():
                        return parent_b2(q, k, v, None, o, lse, g, False)

                    plain = cuda_ms(lambda: attention.attention_backward_reference(
                        q, k, v, None, o, lse, g), 3)
                    ins = [t.detach().requires_grad_() for t in (q, k, v)]

                    def sdpa():
                        return F.scaled_dot_product_attention(*ins, scale=1.0)

                    lib = (cuda_ms(lambda: torch.autograd.grad(sdpa(), ins, g), 10)
                           - cuda_ms(sdpa, 10))
                    products, n_bytes = 5, bwd_bound_terms(B, H, L, False, elt, D=D)[1]
                else:
                    parent = None  # B5's wide kernel is the parent's
                    if what == "fwd":
                        def this():
                            return attention._launch(q, k, v, None)

                        def parent():
                            return parent_b1(q, k, v, None)

                        plain = cuda_ms(lambda: attention.attention_reference(q, k, v), 3)
                    else:
                        def this():
                            return fused_attention_dense(q, k, v)

                        plain = cuda_ms(lambda: attention_dense_reference(q, k, v), 3)
                    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 10)
                    products, n_bytes = 2, bound_terms(B, H, L, False, elt, D=D)[1]
                if parent is not None and parent_libs():
                    ms, parent_ms, verdict = against_parent(this, parent)
                    turns = (f" in turns with the parent's {parent_ms:.4f} ms: {verdict}")
                else:
                    ms, parent_ms, verdict, turns = graph_us(this, 10) / 1e3, None, None, ""
                t_ops = (mma_bound_terms(B, H, L, 4, products, D=D)[0]
                         if dtype == torch.float32
                         else 2 * B * H * L * L * D * products / PEAK_BF16_FLOPS * 1e3)
                bnd = max(t_ops, n_bytes)
                n_calls = WIDE_DENSE_CALLS[(L, H, D)] if what == "dense" else calls
                log(f"[30] {card}: {'B5' if what == 'dense' else 'B1' if what == 'fwd' else 'B2'}"
                    f" {dt} D={D} B={B} L={L} H={H}: kernel {ms:.4f} ms (graph replays){turns}, bound "
                    f"{bnd:.4f} ms (operations {t_ops:.4f} "
                    f"{'at 3xTF32' if dtype == torch.float32 else 'in bf16'} on the tensor "
                    f"cores, bytes {n_bytes:.4f}), plain {plain:.4f} ms, sdpa"
                    f"{' backward ((fwd+bwd) - fwd)' if what == 'bwd' else ''} {lib:.4f} ms; "
                    f"{n_calls} calls per {'step' if what == 'bwd' else 'forward'}")
                rows.append({"what": what, "dtype": dt, "B": B, "L": L, "H": H, "D": D,
                             "ms": ms, "bound_ms": bnd, "plain_ms": plain, "library_ms": lib,
                             "parent_ms": parent_ms, "against_parent": verdict,
                             "calls": n_calls})
                tot = totals[(what, dt)]
                for key, t in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd),
                               ("library_ms", lib), ("parent_ms", parent_ms)):
                    if tot[key] is not None and t is not None:
                        tot[key] += n_calls * t
                limits[(what, dt)]["operations"] += n_calls * t_ops
                limits[(what, dt)]["bytes"] += n_calls * n_bytes
    for (what, dt), t in totals.items():
        t["bound_by"] = max(limits[(what, dt)], key=limits[(what, dt)].get)
        log(f"[30] {card}: {'B5' if what == 'dense' else 'B1' if what == 'fwd' else 'B2'} "
            f"{dt}, the {'8 dense calls of one forward' if what == 'dense' else '12 calls of one '}"
            f"{'' if what == 'dense' else 'step' if what == 'bwd' else 'forward'}: kernel "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms"
            + ("" if not t["parent_ms"] else f", the parent's in turns {t['parent_ms']:.4f} ms"))
    return totals, rows


def phase_wide_heads(card):
    """Phase 30: B1, B2 and B5 past head_dim 64 (the wide kernels), on
    Transformer1d at its published widths with num_heads (1, 1, 2, 4)
    (heads 128 and 256 wide): the kernels' registers and HMMA, the kernels
    against their plain versions (`phase_wide_kernels`); the forward on the
    card against the CPU with 12 B1 launches, one step against the CPU's
    at `step_bars` with 12 + 12, the dense forward (ECG_ATTN_DENSE=1, 4 B1
    + 8 B5) against the default route; served and trained at 256 and 64
    with the counts of those paths; rates and the kernel rows (times
    only)."""
    from ecg_denoise_tpu_torch.models import Transformer1d
    from ecg_denoise_tpu_torch.train import create_train_state, make_cls_epoch_fns
    from ecg_denoise_tpu_torch.utils.seed import random_seed

    t0 = time.perf_counter()
    resources = log_wide_resources()
    max_err = phase_wide_kernels()
    t_checks = time.perf_counter() - t0
    random_seed(30)
    cpu_model = Transformer1d(num_heads=WIDE_HEADS).eval()
    n_params = sum(p.numel() for p in cpu_model.parameters())
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.standard_normal((8, 32, 256)).astype(np.float32))
    gpu_model = create_train_state(copy.deepcopy(cpu_model)).model.eval()
    reset_launches()
    with torch.no_grad():
        y = gpu_model(x.cuda())
        torch.cuda.synchronize()
        fwd_launches = read_launches()
        err = (y.cpu() - cpu_model(x)).abs().max().item()
    log(f"[30] Transformer1d num_heads {WIDE_HEADS} ({n_params:,} parameters), batch 8, float32: "
        f"card vs CPU max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}); launches per forward "
        f"{ {k: n for k, n in fwd_launches.items() if n} }")
    check(err <= MODEL_TOL and bool(torch.isfinite(y).all()),
          "Transformer1d with wide heads on the card disagrees with the CPU")
    check(fwd_launches == expected_launches(fwd=12), "the forward did not take 12 B1 launches")
    transformer1d_step_vs_cpu(cpu_model, x[:T1D_CHECK_BATCH],
                              torch.from_numpy(rng.integers(0, 9, T1D_CHECK_BATCH)), "30",
                              f" num_heads {WIDE_HEADS}")

    launches = {}
    xs = torch.from_numpy(rng.standard_normal(
        (T1D_SERVE_BATCH, 32, 256)).astype(np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, 9, T1D_SERVE_BATCH)).cuda()
    # The dense route against the default on the same windows.
    with torch.no_grad():
        y_default = gpu_model(xs)
        with dense_route():
            gpu_model(xs)  # warm-up
            torch.cuda.synchronize()
            reset_launches()  # the dense served forward
            y_dense = gpu_model(xs)
            torch.cuda.synchronize()
            launches["serve_transformer1d_wide_dense"] = read_launches()
        err_dense = (y_dense - y_default).abs().max().item()
    log(f"[30] Transformer1d num_heads {WIDE_HEADS} served with ECG_ATTN_DENSE=1, batch "
        f"{T1D_SERVE_BATCH}, float32: vs the default route max_abs_err={err_dense:.3e} (tol "
        f"{F32_TOL:.0e}); launches per forward "
        f"{ {k: n for k, n in launches['serve_transformer1d_wide_dense'].items() if n} }")
    check(bool(torch.isfinite(y_dense).all()) and err_dense <= F32_TOL,
          "the dense wide-head forward disagrees with the default route")
    check(launches["serve_transformer1d_wide_dense"] == expected_launches(fwd=4, dense=8),
          "the dense wide-head forward did not make 4 B1 and 8 B5 launches")

    rates = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        random_seed(30)
        state = create_train_state(Transformer1d(num_heads=WIDE_HEADS, dtype=dtype))
        model = state.model.eval()
        with torch.no_grad():
            model(xs)  # warm-up
            torch.cuda.synchronize()
            if dtype == torch.float32:
                reset_launches()  # the served forward
                model(xs)
                torch.cuda.synchronize()
                launches["serve_transformer1d_wide"] = read_launches()
            walls = []
            for _ in range(3):
                t1 = time.perf_counter()
                model(xs)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
            fwd_ms = cuda_ms(lambda: model(xs), 3)
        train_epoch, _ = make_cls_epoch_fns(state.model, state.optimizer)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tb = T1D_TRAIN_BATCH
        train_epoch(xs[:tb], ys[:tb], gen, tb)  # warm-up
        torch.cuda.synchronize()
        if dtype == torch.float32:
            reset_launches()  # two training steps through train_epoch
            got = train_epoch(xs[:2 * tb], ys[:2 * tb], gen, tb)
            launches["train_transformer1d_wide"] = read_launches()
            check(np.isfinite(got["loss"]), "non-finite wide-head Transformer1d training loss")
        step_ms = cuda_ms(lambda: train_epoch(xs[:tb], ys[:tb], gen, tb), 3)
        rates[dt] = {"windows_per_s": T1D_SERVE_BATCH / statistics.median(walls),
                     "forward_ms": fwd_ms, "step_ms": step_ms}
        log(f"[30] {card}: Transformer1d num_heads {WIDE_HEADS} {dt}: served at batch "
            f"{T1D_SERVE_BATCH} {rates[dt]['windows_per_s']:.1f} windows/s (median of 3 "
            f"forwards, host clock ending in a synchronize), forward {fwd_ms:.3f} ms (CUDA "
            f"events, mean of 3); training step at {tb} {step_ms:.3f} ms (CUDA events, mean "
            f"of 3)")
    log(f"[30] launches: serve_transformer1d_wide {launches['serve_transformer1d_wide']}, "
        f"train_transformer1d_wide {launches['train_transformer1d_wide']}")
    check(launches["serve_transformer1d_wide"] == expected_launches(fwd=12),
          "the served wide-head forward did not take 12 B1 launches")
    check(launches["train_transformer1d_wide"] == expected_launches(fwd=24, bwd=24),
          "two wide-head training steps did not take 24 B1 and 24 B2 launches")
    totals, rows = wide_kernel_times(card)
    log(f"chip_smoke: phase 30 took {time.perf_counter() - t0:.1f} s (the kernel checks "
        f"{t_checks:.1f} s)")
    return launches, max_err, {"totals": totals, "rows": rows, "rates": rates,
                               "resources": resources}


def log_rpos_resources():
    """B3's and B4's window kernels and wide kernels (attention_rpos_fwd.cu,
    attention_rpos_bwd.cu) as the compiler left them, by instantiation:
    registers, stack and local memory (cuobjdump -res-usage) and the HMMA
    count of their SASS, beside B2's wide dk/dv pass without the window
    (attention_bwd.cu); each one's stack against the parent's where its
    tree is there (`stack_against_parent`: none may be larger, and a family
    the parent has not may have none) and the wide ones' clusters. A kernel
    with no HMMA, or a spill in either window kernel, fails the run."""
    found = {}
    for name, pick in (("attention_rpos_fwd", ("_mma_kernel", "_wide_kernel")),
                       ("attention_rpos_bwd", ("_mma_kernel", "_wide_kernel")),
                       ("attention_bwd", ("dkdv_wide_kernel",))):
        found.update(kernel_resources(name, pick))
    for fn, r in sorted(found.items()):
        log(f"[31] {r['library']} {fn}: {r.get('registers')} registers, stack "
            f"{r.get('stack')} bytes, local {r.get('local')} bytes; {r['hmma']} HMMA instructions")
    mine = {fn: r for fn, r in found.items() if r["library"] != "attention_bwd"}
    # B3: the window kernel at f32 D 4-64 and bf16 4, 16-64 (9), the wide
    # kernel f32 and bf16 (2); B4: the window kernel's dq and dk/dv passes at
    # the same 9 (18), the two wide passes in 2 dtypes (4). The dtoep sum is
    # no mma kernel.
    check(len(mine) == 11 + 22, f"{len(mine)} of the 33 r-pos instantiations found")
    check(all(r["hmma"] > 0 for r in found.values()), "an r-pos template kernel issues no HMMA")
    check(all("registers" in r for r in found.values()), "a kernel's resources not read")
    for what, pick, n in (("B3", "rpos_fwd_mma_kernel", 9), ("B4", "rpos_bwd_d", 18)):
        window = [fn for fn in mine if pick in fn and "_mma_kernel" in fn]
        spills = {fn: mine[fn]["stack"] + mine[fn]["local"] for fn in window
                  if mine[fn]["stack"] + mine[fn]["local"]}
        check(len(window) == n and not spills,
              f"{what}'s window kernel spills ({spills}) or an instantiation is missing "
              f"({len(window)} of {n})")
    out = {}
    for lib, kind in (("attention_rpos_fwd", "_mma_kernel"), ("attention_rpos_fwd", "_wide_kernel"),
                      ("attention_rpos_bwd", "_mma_kernel"), ("attention_rpos_bwd", "_wide_kernel"),
                      ("attention_bwd", "_wide_kernel")):
        rs = [r for fn, r in found.items() if r["library"] == lib and kind in fn]
        out[f"{lib}{kind[:-7]}"] = {
            "registers": max(r["registers"] for r in rs),
            "spill_bytes": max(r["local"] + r["stack"] for r in rs)}
    # The wide dk/dv pass, the one nearest the register limit: with the
    # window (B4) against B2's with a bias, by dtype.
    wide = {(r["library"], "bf16" if "bfloat16" in fn else "f32"): r["stack"] + r["local"]
            for fn, r in found.items() if "dkdv_wide" in fn and "Lb1ELb" in fn}
    out["dkdv_wide_stack_bytes"] = {f"{lib}_{dt}": n for (lib, dt), n in sorted(wide.items())}
    out["stack_against_parent"] = stack_against_parent(mine, ("_mma_kernel", "_wide_kernel"),
                                                       "31")
    out["clusters"] = {lib: log_wide_clusters("31", lib, (128, 256, 320, 576))
                       for lib in ("attention_rpos_fwd", "attention_rpos_bwd")}
    log(f"[31] registers and spills (most over the instantiations): "
        f"{ {k: v for k, v in out.items() if k != 'clusters'} }")
    return out


def rpos_exact_grads(ops, W, offsets, g):
    """Float64 gradients of the r-pos attention (the materialised bias,
    softmax and products in float64 on the card, through autograd): the
    yardstick where the float32 plain versions' own rounding nears the
    gradient bar (past D = 512, RPOS_F64_ONLY_PAST)."""
    from ecg_denoise_tpu_torch.kernels import attention_rpos as ar

    ins = [t.detach().double().requires_grad_() for t in ops]
    logits = (torch.einsum("bhld,bhmd->bhlm", ins[0], ins[1])
              + ar.materialize_rpos_bias(ins[3], W, offsets))
    out = torch.einsum("bhlm,bhmd->bhld", torch.softmax(logits, -1), ins[2])
    return torch.autograd.grad(out, ins, g.double())


def rpos_kernel_grads(ops, W, offsets, g):
    """fused_attention_rpos's output and gradients on the card, through its
    autograd Function."""
    from ecg_denoise_tpu_torch.kernels.attention_rpos import fused_attention_rpos

    ins = [t.detach().requires_grad_() for t in ops]
    out = fused_attention_rpos(*ins, W, offsets)
    return out.detach(), torch.autograd.grad(out, ins, g)


def phase_rpos_any_d_kernels():
    """Phase 31a: B3 and B4 at every head dim class and past 256 keys
    (RPOS_ANY_D_CASES), f32 and bf16: B3's output and lse against its plain
    version (f32 1e-5, bf16 3 * 2^-8 of max|v|) with a second call
    bit-identical; B4 through the autograd Function against the plain
    flash backward on B3's own o and lse and, in f32, autograd through the
    plain forward and float64 gradients (`rpos_exact_grads`; past
    RPOS_F64_ONLY_PAST those alone) (dq, dk, dv 1e-4, dtoep 1e-4 of its max;
    bf16 2^-7 of each max), a second call bit-identical. Every call launches its kernel:
    the counts move by exactly the calls made. Then, where the parent's
    tree is there, B1 and B2 on their templates and wide kernels against
    the parent's, bit for bit, B3 and B4 on the wide kernels (o, lse; dq,
    dk, dv from this tree's forward) bit for bit, and the two window
    kernels (new arithmetic) within their bars of their plain versions."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.kernels import attention
    from ecg_denoise_tpu_torch.kernels import attention_rpos as ar

    fused = ar.fused_attention_rpos
    saved = tf32_flags()
    full_float32()
    gen = torch.Generator().manual_seed(31)
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for D, L, W, H in RPOS_ANY_D_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            ops, offsets = rpos_operands(RPOS_CHECK_BATCH, L, W, H, dtype, gen, D=D,
                                         q_scale=D ** -0.5)
            g = torch.randn(ops[0].shape, generator=gen).to("cuda", dtype)
            before = (fused.launches, fused.bwd_launches)
            out, lse = ar._launch(*ops, W, offsets, with_lse=True)
            again = ar._launch(*ops, W, offsets)
            out2, got = rpos_kernel_grads(ops, W, offsets, g)
            _, again_grads = rpos_kernel_grads(ops, W, offsets, g)
            torch.cuda.synchronize()
            launched = (fused.launches - before[0], fused.bwd_launches - before[1])
            ref, ref_lse = ar.attention_rpos_reference(*ops, W, offsets, return_lse=True)
            refs = {"flash": ar.attention_rpos_backward_reference(*ops, W, offsets, out2, lse, g)}
            if dtype == torch.float32:
                ins = [t.detach().requires_grad_() for t in ops]
                refs["autograd"] = torch.autograd.grad(
                    ar.attention_rpos_reference(*ins, W, offsets), ins, g)
                refs["float64"] = rpos_exact_grads(ops, W, offsets, g)
                if D > RPOS_F64_ONLY_PAST:
                    del refs["flash"], refs["autograd"]
            f32 = dtype == torch.float32
            tol = F32_TOL if f32 else BF16_TOL_OF_MAX_V * ops[2].float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            lse_tol = LSE_TOL * max(1.0, ref_lse.abs().max().item())
            errs, ok = [], True
            for ref_name, r in refs.items():
                for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, r):
                    scale = b.float().abs().max().item()
                    t = (DBIAS_TOL_OF_MAX * scale if name == "dtoep" else GRAD_TOL) if f32 else (
                        BF16_GRAD_TOL_OF_MAX * scale)
                    e = (a.float() - b.float()).abs().max().item()
                    ok &= e <= t
                    errs.append(f"{name}/{ref_name} {e:.2e}/{t:.2e}")
                    if f32 and ref_name == ("flash" if "flash" in refs else "float64"):
                        max_err["bwd"] = max(max_err["bwd"], e)
            if f32:
                max_err["fwd"] = max(max_err["fwd"], err)
            same = (torch.equal(out, again) and torch.equal(out, out2)
                    and all(torch.equal(a, b) for a, b in zip(got, again_grads)))
            log(f"[31] B3/B4 D={D} (kernel head dim {ar.rpos_head_dim(D, L, dtype)}) "
                f"B={RPOS_CHECK_BATCH} L={L} W={W} H={H} {str(dtype)[6:]}: out {err:.2e}/{tol:.2e}, "
                f"lse {lse_err:.2e}/{lse_tol:.2e}; " + ", ".join(errs)
                + f"; launches {launched}; repeated calls bit-identical: {same}")
            check(out.shape == ops[0].shape and out.dtype == dtype
                  and [t.dtype for t in got] == [dtype] * 4
                  and [t.shape for t in got] == [t.shape for t in ops],
                  f"B3/B4 at D = {D}, L = {L}: output shape or dtype")
            check(bool(torch.isfinite(out).all()) and err <= tol and lse_err <= lse_tol,
                  f"B3 at D = {D}, L = {L} disagrees with its plain version")
            check(ok and all(bool(torch.isfinite(t).all()) for t in got),
                  f"B4 at D = {D}, L = {L} disagrees with its plain backward")
            check(launched == (4, 2), f"B3/B4 at D = {D}, L = {L} made {launched} launches, "
                                      "not (4, 2)")
            check(same, f"B3/B4 at D = {D}, L = {L}: calls differ")
    log(f"[31] B3 and B4 within their bars at every head dim class and past 256 keys: largest "
        f"f32 errors B3 {max_err['fwd']:.3e}, B4 {max_err['bwd']:.3e}")
    if parent_libs():
        for D, B, L, H in B12_TEMPLATE_PARENT_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                Dk = attention.kernel_head_dim(D, L, dtype)
                for with_bias in (True, False):
                    q, k, v, bias = operands(B, H, L, with_bias, dtype, gen, D=Dk,
                                             q_scale=Dk ** -0.5)
                    g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
                    new, old = (b1_call(lib, q, k, v, bias) for lib in (
                        attention._library(), parent_libs()["attention_fwd"]))
                    args = (q, k, v, bias, new[0], new[1], g, with_bias)
                    new_b, old_b = (b2_call(lib, *args) for lib in (
                        attention._bwd_library(), parent_libs()["attention_bwd"]))
                    equal = [n for n, a, b in zip(("o", "lse", "dq", "dk", "dv", "dbias"),
                                                  (*new, *new_b), (*old, *old_b))
                             if (a is None and b is None) or torch.equal(a, b)]
                    log(f"[31] B1/B2 template D={Dk} B={B} L={L} H={H} bias={with_bias} "
                        f"{str(dtype)[6:]}: bit-identical to the parent's: {', '.join(equal)}")
                    check(len(equal) == 6, f"B1/B2 at D = {Dk} is not the parent's bit for bit")
        for D, B, L, W, H in RPOS_PARENT_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                Dk = attention.kernel_head_dim(D, L, dtype)
                ops, offsets = rpos_operands(B, L, W, H, dtype, gen, D=Dk, q_scale=Dk ** -0.5)
                g = torch.randn(ops[0].shape, generator=gen).to("cuda", dtype)
                new, old = (b3_call(lib, *ops, W, offsets) for lib in (
                    ar._library(), parent_libs()["attention_rpos_fwd"]))
                new_b, old_b = (b4_call(lib, *ops, W, offsets, *new, g)[:3] for lib in (
                    ar._bwd_library(), parent_libs()["attention_rpos_bwd"]))
                equal = [n for n, a, b in zip(("o", "lse", "dq", "dk", "dv"),
                                              (*new, *new_b), (*old, *old_b)) if torch.equal(a, b)]
                want = [] if Dk <= 64 else ["o", "lse", "dq", "dk", "dv"]
                bars = ""
                if Dk <= 64:  # the window kernels: their bars against their plain versions
                    ref, ref_lse = ar.attention_rpos_reference(*ops, W, offsets, return_lse=True)
                    tol = (F32_TOL if dtype == torch.float32
                           else BF16_TOL_OF_MAX_V * ops[2].float().abs().max().item())
                    err = (new[0].float() - ref.float()).abs().max().item()
                    lse_err = (new[1] - ref_lse).abs().max().item()
                    lse_tol = LSE_TOL * max(1.0, ref_lse.abs().max().item())
                    ref_b = ar.attention_rpos_backward_reference(*ops, W, offsets, *new, g)
                    errs, theirs = [], []
                    for name, a, a_old, b in zip(("dq", "dk", "dv"), new_b, old_b, ref_b):
                        scale = b.float().abs().max().item()
                        t = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL_OF_MAX * scale
                        errs.append(((a.float() - b.float()).abs().max().item(), t))
                        theirs.append((a_old.float() - b.float()).abs().max().item())
                    bars = (f"; B3's window kernel out {err:.2e}/{tol:.2e}, lse "
                            f"{lse_err:.2e}/{lse_tol:.2e}; B4's window kernel dq, dk, dv "
                            + ", ".join(f"{e:.2e}/{t:.2e}" for e, t in errs)
                            + " (the parent's " + ", ".join(f"{e:.2e}" for e in theirs) + ")")
                    check(err <= tol and lse_err <= lse_tol,
                          f"B3's window kernel at D = {Dk}, L = {L} disagrees with its plain "
                          "version")
                    check(all(e <= t for e, t in errs),
                          f"B4's window kernel at D = {Dk}, L = {L} disagrees with its plain "
                          "backward")
                log(f"[31] B3/B4 D={Dk} B={B} L={L} W={W} H={H} {str(dtype)[6:]}: "
                    f"bit-identical to the parent's: {', '.join(equal)}{bars}")
                check(all(n in equal for n in want),
                      f"B3/B4 at D = {Dk}: {', '.join(want)} not the parent's bit for bit")
    else:
        log("[31] the parent's B1-B4 templates not compared (no tree under _archive/parent)")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return max_err


def b1_call(lib, q, k, v, bias):
    """One B1 library's kernel on the same operands: (o, float32 lse). No
    count moves."""
    from ecg_denoise_tpu_torch.kernels.attention import DTYPE_CODES, ptr, raise_on

    B, H, L, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    err = lib.ecg_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(o), ptr(lse), B, H, L, D,
                                DTYPE_CODES[q.dtype], q.device.index,
                                torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "attention forward (yardstick call)")
    return o, lse


class RposStage(torch.nn.Module):
    """The slice's layer path: the per-window RelativePositionEmbedding on
    R peaks, then BasicLayer(H * D, depth, H) as RA-LENet's stages use it
    (`local_enhence`, RA-LENet 'full')."""

    def __init__(self, L, W, H, D, depth=RPOS_LAYER_DEPTH):
        super().__init__()
        from ecg_denoise_tpu_torch.ops.attention import BasicLayer, RelativePositionEmbedding

        self.rpe = RelativePositionEmbedding(W, L, H)
        self.layer = BasicLayer(H * D, depth, H, local_enhence=True)

    def forward(self, x, r_pos):
        self.rpe.dtype = x.dtype  # toep in the compute dtype, as RA-LENet builds it
        return self.layer(x, self.rpe(r_pos))


def rpos_stage_step(stage, x, r_pos, target):
    """One f32 Adam step (lr RPOS_LR) of `stage` on an MSE loss: the loss,
    and the gradients and parameters after the step, by name, on the host."""
    opt = torch.optim.Adam(stage.parameters(), lr=RPOS_LR)
    loss = F.mse_loss(stage(x, r_pos), target)
    opt.zero_grad()
    loss.backward()
    opt.step()
    params = dict(stage.named_parameters())
    return (loss.item(), {k: p.grad.detach().cpu() for k, p in params.items()},
            {k: p.detach().cpu() for k, p in params.items()})


def phase_rpos_layers(card):
    """Phase 31b: the layer path of RPOS_LAYERS. For each: R peaks detected
    on the card equal the CPU's; the stage served at BATCH windows, f32 (its
    first RPOS_CHECK_WINDOWS within MODEL_TOL of the CPU's) and bf16
    (finite), 2 B3 launches a forward and nothing else; one f32 Adam step on
    RPOS_CHECK_WINDOWS windows against the CPU's (loss LOSS_RTOL,
    `step_bars`); RPOS_TRAIN_STEPS steps at TIMING_BATCH on the card (2 + 2
    a step). The counts of the served forward (serve_<tag>) and of the
    training steps (train_<tag>) are set to 0 just before and read just
    after."""
    from ecg_denoise_tpu_torch import full_float32
    from ecg_denoise_tpu_torch.data.rpeaks import detect_r_peaks

    saved = tf32_flags()
    full_float32()
    launches = {}
    for tag, (L, W, H, D) in RPOS_LAYERS.items():
        torch.manual_seed(31)
        cpu_stage = RposStage(L, W, H, D)
        seed_module(cpu_stage, torch.Generator().manual_seed(31))
        gpu_stage = copy.deepcopy(cpu_stage).cuda()
        rng = np.random.default_rng(L + D)
        windows = torch.from_numpy(beat_windows(BATCH, seed=L + D, length=L))
        x = torch.from_numpy(rng.standard_normal((BATCH, L, H * D)).astype(np.float32))
        n = RPOS_CHECK_WINDOWS
        r_pos_cpu = detect_r_peaks(windows[:n])
        r_pos = detect_r_peaks(windows.cuda())
        check(torch.equal(r_pos[:n].cpu(), r_pos_cpu),
              f"{tag}: R peaks detected on the card differ from the CPU's")
        xg = x.cuda()
        with torch.no_grad():
            gpu_stage(xg, r_pos)  # warm-up
            torch.cuda.synchronize()
            reset_launches()  # the served forward
            t0 = time.perf_counter()
            y = gpu_stage(xg, r_pos)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[f"serve_{tag}"] = read_launches()
            err = (y[:n].cpu() - cpu_stage(x[:n], r_pos_cpu)).abs().max().item()
            reset_launches()
            y16 = gpu_stage(xg.bfloat16(), r_pos)
            torch.cuda.synchronize()
            bf16_launches = read_launches()
        log(f"[31] {tag}: RelativePositionEmbedding({W}, {L}, {H}) + BasicLayer({H * D}, depth "
            f"{RPOS_LAYER_DEPTH}, {H} heads of {D}) served at {BATCH}, float32: card vs CPU on the "
            f"first {n} max_abs_err={err:.3e} (tol {MODEL_TOL:.0e}), {wall * 1e3:.2f} ms (host "
            f"clock to a synchronize); bfloat16 finite: {bool(torch.isfinite(y16).all())}; "
            f"launches {launches[f'serve_{tag}']} / bf16 {bf16_launches}")
        want = expected_launches(rpos_fwd=RPOS_LAYER_DEPTH)
        check(bool(torch.isfinite(y).all()) and err <= MODEL_TOL,
              f"{tag}: the served stage disagrees with the CPU")
        check(bool(torch.isfinite(y16).all()) and y16.dtype == torch.bfloat16,
              f"{tag}: the bf16 stage is not finite")
        check(launches[f"serve_{tag}"] == want and bf16_launches == want,
              f"{tag}: the served forward did not take {RPOS_LAYER_DEPTH} B3 launches alone")

        target = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        got = rpos_stage_step(copy.deepcopy(gpu_stage), xg[:n], r_pos[:n], target[:n].cuda())
        ref = rpos_stage_step(copy.deepcopy(cpu_stage), x[:n], r_pos_cpu, target[:n])
        bars = step_bars(got[1], ref[1], got[2], ref[2])
        rel = abs(got[0] - ref[0]) / abs(ref[0])
        log(f"[31] {tag}: one f32 Adam step on {n} windows on the card vs the CPU: loss "
            f"{got[0]:.7f} vs {ref[0]:.7f} (rel {rel:.2e}, tol {LOSS_RTOL:.0e}), gradients "
            f"against the CPU's: {describe_bars(bars)}")
        check(rel <= LOSS_RTOL and bars["ok"], f"{tag}: the step disagrees with the CPU's")

        b = TIMING_BATCH
        opt = torch.optim.Adam(gpu_stage.parameters(), lr=RPOS_LR)
        reset_launches()  # the training steps
        losses = []
        for i in range(RPOS_TRAIN_STEPS):
            sl = slice(i * b % BATCH, i * b % BATCH + b)
            loss = F.mse_loss(gpu_stage(xg[sl], r_pos[sl]), target[sl].cuda())
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        launches[f"train_{tag}"] = read_launches()
        log(f"[31] {tag}: {RPOS_TRAIN_STEPS} f32 Adam steps at {b} on the card, losses "
            f"{', '.join(f'{v:.6f}' for v in losses)}; launches {launches[f'train_{tag}']}")
        check(all(np.isfinite(losses)), f"{tag}: non-finite training loss")
        check(launches[f"train_{tag}"] == expected_launches(
            rpos_fwd=RPOS_TRAIN_STEPS * RPOS_LAYER_DEPTH,
            rpos_bwd=RPOS_TRAIN_STEPS * RPOS_LAYER_DEPTH),
            f"{tag}: the training steps did not take {RPOS_LAYER_DEPTH} + {RPOS_LAYER_DEPTH} "
            "r-pos launches a step alone")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return launches


def rpos_any_d_times(card):
    """Phase 31d: per RPOS_LAYERS geometry, B3 (no lse) at BATCH and B4 at
    TIMING_BATCH, f32 and bf16, from CUDA graph replays of the kernels on
    operands padded once to the kernel's head dim (`rpos_head_dim`: D = 4
    unpadded), beside the bound of the unpadded
    call (the largest of the products at 3xTF32 on the tensor cores, bf16
    one pass at its peak; the exps on the special-function units,
    `SFU_EXPS_PER_S`, one a (row, key), what the function needs: B4's two
    passes pay two, a cost of its deterministic design and not of the
    work; the bytes), the plain versions and SDPA with the
    materialised (B, H, L, L) mask (forward, and backward with the mask
    requiring grad: (fwd + bwd) - fwd); B4's passes' device ms
    (torch.profiler: dq, dkdv and the dtoep sum, this tree's and the
    parent's). Where the parent's tree is there, each kernel in turns with
    the parent's (`against_parent`; the parent's on operands padded to
    `kernel_head_dim`, as its wrappers padded them), and B3 and B4 at
    RPOS_CHECKED_DIMS in turns with the parent's at RPOS_CHECKED_SHAPE.
    B3's output at BATCH and B4's gradients at TIMING_BATCH are held to
    their plain versions at their bars (f32 1e-5 and 1e-4, dtoep 1e-4 of
    its max; bf16 3 * 2^-8 of max|v| and 2^-7 of each max); the parent's
    B4 errors against the same plain backward are logged beside them."""
    from ecg_denoise_tpu_torch.kernels import attention_rpos as ar
    from ecg_denoise_tpu_torch.kernels.attention import _pad, kernel_head_dim
    from ecg_denoise_tpu_torch.probes.floor import graph_us

    gen = torch.Generator().manual_seed(32)
    rows = []
    for tag, (L, W, H, D) in RPOS_LAYERS.items():
        for dtype in (torch.float32, torch.bfloat16):
            dt, elt = str(dtype)[6:], torch.finfo(dtype).bits // 8
            for what in ("fwd", "bwd"):
                Dk = ar.rpos_head_dim(D, L, dtype)
                B = BATCH if what == "fwd" else TIMING_BATCH
                ops, offsets = rpos_operands(B, L, W, H, dtype, gen, D=D, q_scale=D ** -0.5)
                padded = [_pad(t, Dk) for t in ops[:3]] + [ops[3]]
                passes = {}
                parent_lib = parent_libs() and parent_libs()[f"attention_rpos_{what}"]
                parent = parent_passes = None
                if what == "fwd":
                    this = functools.partial(b3_call, ar._library(), *padded, W, offsets,
                                             with_lse=False)
                    if parent_lib:
                        theirs = [_pad(t, kernel_head_dim(D, L, dtype)) for t in ops[:3]]
                        parent = functools.partial(b3_call, parent_lib, *theirs, ops[3], W,
                                                   offsets, with_lse=False)
                    ref = ar.attention_rpos_reference(*ops, W, offsets)
                    err = (this()[0][..., :D].float() - ref.float()).abs().max().item()
                    tol = (F32_TOL if dtype == torch.float32
                           else BF16_TOL_OF_MAX_V * ops[2].float().abs().max().item())
                    log(f"[31] B3 {dt} {tag} at B={B} against its plain version: "
                        f"max_abs_err={err:.3e} (tol {tol:.2e})")
                    check(err <= tol, f"B3 at {tag} {dt}, B = {B}, disagrees with its plain "
                                      "version")
                    del ref
                    plain = cuda_ms(lambda: ar.attention_rpos_reference(*ops, W, offsets), 2)
                    mask = ar.materialize_rpos_bias(ops[3], W, offsets)
                    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                        *ops[:3], attn_mask=mask, scale=1.0), 5)
                    t_ops, t_bytes = rpos_bound_terms(B, H, L, W, elt, offsets, D=D)
                else:
                    g = torch.randn(ops[0].shape, generator=gen).to("cuda", dtype)
                    o, lse = b3_call(ar._library(), *padded, W, offsets)
                    this = functools.partial(b4_call, ar._bwd_library(), *padded, W, offsets, o,
                                             lse, _pad(g, Dk))
                    o_u = o[..., :D].contiguous()
                    if parent_lib:
                        Dp = kernel_head_dim(D, L, dtype)
                        theirs = [_pad(t, Dp) for t in (*ops[:3], o_u, g)]
                        parent = functools.partial(b4_call, parent_lib, *theirs[:3], ops[3], W,
                                                   offsets, theirs[3], lse, theirs[4])
                    want = ar.attention_rpos_backward_reference(*ops, W, offsets, o_u, lse, g)

                    def errors(got):
                        out = []
                        for name, a, b in zip(("dq", "dk", "dv", "dtoep"), got, want):
                            scale = b.float().abs().max().item()
                            t = (BF16_GRAD_TOL_OF_MAX * scale if dtype == torch.bfloat16
                                 else DBIAS_TOL_OF_MAX * scale if name == "dtoep" else GRAD_TOL)
                            a = a if name == "dtoep" else a[..., :D]
                            out.append((name, (a.float() - b.float()).abs().max().item(), t))
                        return out

                    errs = errors(this())
                    theirs = (f"; the parent's: " + ", ".join(
                        f"{n} {e:.3e}" for n, e, _ in errors(parent())) if parent else "")
                    log(f"[31] B4 {dt} {tag} at B={B} against its plain backward: "
                        + ", ".join(f"{n} {e:.3e} (tol {t:.2e})" for n, e, t in errs) + theirs)
                    check(all(e <= t for _, e, t in errs),
                          f"B4 at {tag} {dt}, B = {B}, disagrees with its plain backward")
                    del want
                    plain = cuda_ms(lambda: ar.attention_rpos_backward_reference(
                        *ops, W, offsets, o_u, lse, g), 2)
                    qkv = [t.detach().requires_grad_() for t in ops[:3]]
                    mask = ar.materialize_rpos_bias(ops[3], W, offsets).requires_grad_()

                    def sdpa():
                        return F.scaled_dot_product_attention(*qkv, attn_mask=mask, scale=1.0)

                    lib = cuda_ms(lambda: torch.autograd.grad(sdpa(), qkv + [mask], g), 5) - (
                        cuda_ms(sdpa, 5))
                    t_ops, t_bytes = rpos_bwd_bound_terms(B, H, L, W, elt, offsets, D=D)
                    passes = pass_ms(this)
                    if parent is not None:
                        parent_passes = pass_ms(parent)
                del mask
                products = 2 if what == "fwd" else 5
                t_ops = (mma_bound_terms(B, H, L, 4, products, D=D)[0] if dtype == torch.float32
                         else 2 * B * H * L * L * D * products / PEAK_BF16_FLOPS * 1e3)
                if parent is not None:
                    ms, parent_ms, verdict = against_parent(this, parent)
                    turns = f" in turns with the parent's {parent_ms:.4f} ms: {verdict}"
                else:
                    ms, parent_ms, verdict, turns = graph_us(this, 10) / 1e3, None, None, ""
                # One exp a (row, key): the function's P. B4's dq and dk/dv
                # passes each form P again, which the bound does not count.
                t_exps = B * H * L * L / SFU_EXPS_PER_S * 1e3
                bnd = max(t_ops, t_exps, t_bytes)
                by = "bytes" if t_bytes >= max(t_ops, t_exps) else "operations"
                route = "wide" if Dk > 64 else "mma"
                log(f"[31] {card}: {'B3' if what == 'fwd' else 'B4'} {dt} {tag} D={D} (kernel "
                    f"{Dk}, {route}) B={B} L={L} W={W} H={H}: kernel {ms:.4f} ms (graph replays)"
                    f"{turns}, "
                    f"bound {bnd:.4f} ms ({by}: the products {t_ops:.4f} "
                    f"{'at 3xTF32' if dtype == torch.float32 else 'in bf16'} on the tensor cores, "
                    f"the exps {t_exps:.4f} on the SFUs, bytes {t_bytes:.4f}), "
                    f"plain {plain:.4f} ms, sdpa with the (B, H, L, L) mask"
                    f"{' backward ((fwd+bwd) - fwd)' if what == 'bwd' else ''} {lib:.4f} ms"
                    + (f"; by pass " + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
                       if passes else "")
                    + (f"; the parent's by pass " + ", ".join(
                        f"{k} {v:.4f}" for k, v in parent_passes.items())
                       if parent_passes else "") + f"; {RPOS_LAYER_DEPTH} calls per "
                    f"{'step' if what == 'bwd' else 'forward'}")
                rows.append({"what": what, "route": route, "tag": tag, "dtype": dt, "B": B,
                             "L": L, "W": W, "H": H, "D": D, "kernel_head_dim": Dk, "ms": ms,
                             "bound_ms": bnd, "bound_by": by, "plain_ms": plain,
                             "library_ms": lib, "passes_ms": passes,
                             "parent_ms": parent_ms, "against_parent": verdict,
                             "parent_passes_ms": parent_passes, "calls": RPOS_LAYER_DEPTH})
                del ops, padded
    L, W, H = RPOS_CHECKED_SHAPE
    for D in RPOS_CHECKED_DIMS if parent_libs() else ():
        for dtype in (torch.float32, torch.bfloat16):
            for what, B in (("fwd", BATCH), ("bwd", TIMING_BATCH)):
                ops, offsets = rpos_operands(B, L, W, H, dtype, gen, D=D, q_scale=D ** -0.5)
                Dk = ar.rpos_head_dim(D, L, dtype)  # the parent's and this tree's alike
                padded = [_pad(t, Dk) for t in ops[:3]] + [ops[3]]
                if what == "fwd":
                    this, parent = (functools.partial(b3_call, lib, *padded, W, offsets,
                                                      with_lse=False)
                                    for lib in (ar._library(),
                                                parent_libs()["attention_rpos_fwd"]))
                else:
                    o, lse = b3_call(ar._library(), *padded, W, offsets)
                    g = _pad(torch.randn(ops[0].shape, generator=gen).to("cuda", dtype), Dk)
                    this, parent = (functools.partial(b4_call, lib, *padded, W, offsets, o, lse,
                                                      g)
                                    for lib in (ar._bwd_library(),
                                                parent_libs()["attention_rpos_bwd"]))
                ms, parent_ms, verdict = against_parent(this, parent)
                log(f"[31] {card}: {'B3' if what == 'fwd' else 'B4'} {str(dtype)[6:]} D={D} "
                    f"(kernel {Dk}) B={B} L={L} W={W} H={H}: kernel {ms:.4f} ms (graph "
                    f"replays) in turns with the parent's {parent_ms:.4f} ms: {verdict}")
                rows.append({"what": f"{what}_checked", "route": "mma", "tag": f"d{D}",
                             "dtype": str(dtype)[6:], "B": B, "L": L, "W": W, "H": H, "D": D,
                             "kernel_head_dim": Dk, "ms": ms, "parent_ms": parent_ms,
                             "against_parent": verdict, "calls": 0})
                del ops, padded
    for what, route in (("fwd", "mma"), ("fwd", "wide"), ("bwd", "mma"), ("bwd", "wide")):
        for dt in ("float32", "bfloat16"):
            mine = [r for r in rows if (r["what"], r["route"], r["dtype"]) == (what, route, dt)]
            if mine and all(r["parent_ms"] is not None for r in mine):
                log(f"[31] {card}: {'B3' if what == 'fwd' else 'B4'} on the {route} route {dt}, "
                    f"the {sum(r['calls'] for r in mine)} calls of "
                    f"{', '.join(r['tag'] for r in mine)}: "
                    f"{sum(r['calls'] * r['ms'] for r in mine):.4f} ms against the parent's "
                    f"{sum(r['calls'] * r['parent_ms'] for r in mine):.4f} ms (in turns, "
                    f"by call: {', '.join(r['against_parent'] for r in mine)})")
    return rows


def phase_rpos_any_d(card):
    """Phase 31: B3 and B4 at every head dim and length, on the tensor
    cores (their window kernels, and B1's and B2's wide kernels in their
    window mode): their registers, spills and HMMA (`log_rpos_resources`),
    the kernels against their plain versions and what this tree left as it
    was against the parent's (`phase_rpos_any_d_kernels`), the layer path
    served and trained (`phase_rpos_layers`) and the kernel times
    (`rpos_any_d_times`)."""
    t0 = time.perf_counter()
    resources = log_rpos_resources()
    max_err = phase_rpos_any_d_kernels()
    t_checks = time.perf_counter() - t0
    launches = phase_rpos_layers(card)
    t_layers = time.perf_counter() - t0 - t_checks
    rows = rpos_any_d_times(card)
    log(f"chip_smoke: phase 31 took {time.perf_counter() - t0:.1f} s (the kernel checks "
        f"{t_checks:.1f} s, the layer path {t_layers:.1f} s)")
    return launches, max_err, rows, resources


def rpos_any_kernel_rows(launches, max_err, rows, resources):
    """The `kernels` line's rows of B3 and B4 past the D = 4 kernels (phase
    31): their window kernels (`mma`) and B1's and B2's wide kernels in
    their window mode (`wide`), a row per kernel and route, its launches
    those of phase 31's paths on that route, its times summed over one
    forward's (B3, at BATCH) or one step's (B4, at TIMING_BATCH) calls of
    those paths' layers."""
    csrc = "ecg_denoise_tpu_torch/kernels/csrc"
    pallas = "ecg_denoise_tpu/kernels/attention_pallas.py"
    out = []
    for kernel, line, what in (("attention_rpos_fwd", 827, "fwd"),
                               ("attention_rpos_bwd", 859, "bwd")):
        for route in ("mma", "wide"):
            picked = [r for r in rows if r["what"] == what and r["route"] == route]
            tags = sorted({r["tag"] for r in picked})
            totals = {dt: {key: sum(r["calls"] * r[key] for r in picked if r["dtype"] == dt)
                           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
                      for dt in ("float32", "bfloat16")}
            for dt, t in totals.items():
                mine = [r for r in picked if r["dtype"] == dt]
                share = {}
                for r in mine:
                    share[r["bound_by"]] = share.get(r["bound_by"], 0.0) + r["calls"] * r["bound_ms"]
                t["bound_by"] = max(share, key=share.get)
                t["parent_ms"] = (sum(r["calls"] * r["parent_ms"] for r in mine)
                                  if mine and all(r["parent_ms"] is not None for r in mine)
                                  else None)
            f32 = totals["float32"]
            by_path = {f"{kind}_{tag}": launches[f"{kind}_{tag}"][kernel]
                       for tag in tags for kind in ("serve", "train")}
            calls = (f"{RPOS_LAYER_DEPTH} calls each a forward at {BATCH}" if what == "fwd"
                     else f"{RPOS_LAYER_DEPTH} calls each a step at {TIMING_BATCH}")
            out.append({
                "name": f"{kernel}_{route}", "route": "cuda", "source": f"{csrc}/{kernel}.cu",
                "also_source": f"{csrc}/" + (f"attention_rpos_{what}_mma.cuh" if route == "mma"
                                             else f"attention_{what}_mma.cuh"),
                "replaces": f"{pallas}:{line}", "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": max_err[what],
                "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
                "checked_dims": [r for r in rows if r["what"] == f"{what}_checked"
                                 and r["route"] == route],
                "bf16": totals["bfloat16"], "by_case": picked,
                "resources": resources[f"{kernel}_{route}"],
                "max_abs_err_is": "float32, the largest against the plain version over phase "
                                  "31's cases (RPOS_ANY_D_CASES, every route)",
                "times_are": f"the layers {', '.join(tags)} (RPOS_LAYERS), {calls}, float32, "
                             "the kernel from CUDA graph replays on operands padded to its head "
                             "dim (D = 4 unpadded); bound_ms the largest of the products on the "
                             "tensor cores at 3xTF32, the exps on the special-function units "
                             "(one a (row, key)), and the bytes; plain and library "
                             "(scaled_dot_product_attention with the materialised (B, H, L, L) "
                             "mask) called from Python"})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = phase_device_and_build()
    card = smi_name_power()
    max_err = phase_kernel_vs_plain()
    cpu_model = seeded_model(0)
    gpu_model = phase_family_model("ralenet", cpu_model, "3", expected_launches(fwd=18))
    # 4 forwards (buckets 1, 64, 1024 and the record's 39 windows in 64).
    launches = {"serve": phase_serve_cli("ralenet", cpu_model, "4",
                                         expected_launches(fwd=4 * 18),
                                         "torch+attn-cuda:cuda")}
    totals, bound_by = phase_times(gpu_model, cpu_model, card)
    bwd_err = phase_backward_vs_plain()
    phase_train_step(cpu_model)
    # Phase 7b's RA-LENet checkpoint is kept as phase 20's pretrained core.
    work = tempfile.TemporaryDirectory()
    core_ckpt = os.path.join(work.name, "ralenet_core.pth")
    launches["train"] = phase_train_cli(card, keep=core_ckpt)
    bwd_totals, bwd_bound_by = phase_train_times(cpu_model, card)
    rpos_err = phase_rpos_kernel_vs_plain()
    rpos_bwd_err = phase_rpos_backward_vs_plain()
    launches["serve_rpos"] = phase_rpos_serving(cpu_model, gpu_model)
    phase_rpos_train_step(cpu_model)
    launches["train_rpos"] = phase_train_cli(card, r_pos="detect", tag="12b")
    rpos_totals, rpos_by, rpos_bwd_totals, rpos_bwd_by = phase_rpos_times(
        gpu_model, cpu_model, card)
    t_dense = time.perf_counter()
    dense_err = phase_dense_kernel_vs_plain()
    launches["serve_dense"] = phase_dense_serving(cpu_model, gpu_model, card)
    dense_totals, dense_by = phase_dense_times(gpu_model, cpu_model, card)
    launches["probes"], null_times = phase_probes(card)
    log(f"chip_smoke: phases 14-17 took {time.perf_counter() - t_dense:.1f} s")
    t_precision = time.perf_counter()
    launches["probes_precision"], precision_times = phase_precision(card)
    log(f"chip_smoke: phase 18 took {time.perf_counter() - t_precision:.1f} s")
    launches.update(phase_families(card))
    newrale_launches, frozen_err, frozen_ms = phase_newrale(card, core_ckpt)
    launches.update(newrale_launches)
    data_launches, paths = phase_data(card, work.name)
    launches.update(data_launches)
    launches.update(phase_baseline(card, paths))
    launches.update(phase_classifier(card, paths["cls"], core_ckpt))
    t1d_launches, d32_times, t1d_cpu = phase_transformer1d(card)
    launches.update(t1d_launches)
    dense_launches, dense_d32_err, dense_d32_times, dense_d4_parent_equal = phase_dense_d32(
        card, t1d_cpu)
    launches.update(dense_launches)
    long_launches, long_err, long_times = phase_long(card, t1d_cpu)
    launches.update(long_launches)
    launches.update(phase_jax_checkpoint(card))
    dp_launches, dp_times = phase_data_parallel(card, cpu_model, paths["synthetic"])
    launches.update(dp_launches)
    tp_launches, tp_times = phase_tensor_parallel(card, cpu_model)
    launches.update(tp_launches)
    wide_launches, wide_err, wide = phase_wide_heads(card)
    launches.update(wide_launches)
    # Phase 31's paths are counted apart: their launches are the new
    # kernels' (B3's and B4's templates), not the D = 4 kernels'.
    rpos_launches, rpos_any_err, rpos_rows, rpos_resources = phase_rpos_any_d(card)
    work.cleanup()
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    csrc = "ecg_denoise_tpu_torch/kernels/csrc"
    pallas = "ecg_denoise_tpu/kernels/attention_pallas.py"

    def entry(kernel, replaces, err, times, by, times_are, source=None):
        by_path = {path: counts[kernel] for path, counts in launches.items()}
        return {"name": kernel, "route": "cuda", "source": f"{csrc}/{source or kernel}.cu",
                "replaces": replaces if isinstance(replaces, str) else f"{pallas}:{replaces}",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err, "ms": times["ms"],
                "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
                "bound_by": by, "library_ms": times["library_ms"], "times_are": times_are}

    null = entry("null_copy", "scripts/probe_chain.py:58", null_times["max_abs_err"],
                 null_times, "bytes", f"one copy of a (64, 8) call's q, float32, B={BATCH}, "
                 "from HBM (copies cycled past the L2), 50 calls replayed from one CUDA "
                 f"graph a reading; ms and library_ms (copy_) the medians of {SETTLE_ROUNDS} "
                 "rounds in turns, plain_ms one reading")
    null["also_replaces"] = "scripts/probe_floor.py:65"
    dense = entry("attention_dense_fwd", 449, dense_err, dense_totals, dense_by,
                  f"one dense forward's 12 B5 calls, float32, B={BATCH}; kernel and "
                  "b1_ms_same_calls from CUDA graph replays, the kernel in turns with the "
                  "parent's where its tree is there; plain and library issued from Python")
    dense["b1_ms_same_calls"] = dense_totals["b1_ms"]
    dense["parent_ms_same_calls"] = dense_totals["parent_ms"]
    dense["d4_equal_to_parent_b5_bit_for_bit"] = dense_d4_parent_equal
    dense["d32"] = {
        "head_dim": 32, "max_abs_err": dense_d32_err,
        **{k: dense_d32_times[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "bf16")},
        "b1_ms_same_calls": dense_d32_times["b1_ms"],
        "parent_ms_same_calls": dense_d32_times["parent_ms"],
        "other_head_dims": dense_d32_times["other_head_dims"],
        "max_abs_err_is": "float32, the largest against the plain version over phase 25's "
                          "cases at every head dim (DENSE_CHECK_DIMS)",
        "times_are": f"one Transformer1d forward's 8 dense-routed calls, B={T1D_SERVE_BATCH}, "
                     "no bias, float32 (bf16: the same calls on bf16 operands); the mma "
                     "template from CUDA graph replays in turns with B1 without lse "
                     "(b1_ms_same_calls) and the parent's B5 (parent_ms_same_calls) where its "
                     "tree is there; bound_ms on the tensor cores at 3xTF32 (bf16: one pass) "
                     "or the bytes; plain and library (scaled_dot_product_attention, no mask) "
                     "issued from Python; other_head_dims one call at (64, 16) each, in turns "
                     "with B1",
        # The dense Transformer1d path: every B5 launch on it is at D = 32.
        "launches_by_path": {"serve_transformer1d_dense":
                             launches["serve_transformer1d_dense"]["attention_dense_fwd"]}}
    null["null_launch_us"] = {"host": null_times["null_launch_host_us"],
                              "graph": null_times["null_launch_graph_us"]}
    null["dma_floor_us"] = null_times["dma_floor_us"]
    null["against_copy_"] = null_times["settled"].pop("copy_")
    null["against"] = null_times["settled"]
    precision = []
    for kernel, line, what in (
            ("probe_dot", 51, "the probe's four (256, 256, 256) dots, one per precision; "
             "library: torch.matmul with TF32 off (ieee, and tf32x3, which no PyTorch call "
             "computes) and on (tf32), and on bf16 inputs with a bf16 output (bf16)"),
            ("probe_fold", 77, "the probe's four (256, 256) folds, one per precision, in "
             "turns with the parent's where its tree is there; library: "
             "scaled_dot_product_attention with zero q and k and the logits as its mask"),
            ("probe_tree", 89, "the probe's (256, 256) tree, in turns with the parent's where "
             "its tree is there; library: the same SDPA call"),
            ("probe_div", 115, "the probe's (8, 256) divide; library: torch.div; ms and "
             f"library_ms the medians of {SETTLE_ROUNDS} rounds in turns at "
             f"{LAUNCH_FLOOR_CALLS} calls a reading")):
        t = precision_times[kernel]
        e = entry(kernel, f"scripts/probe_precision.py:{line}", t["max_abs_err"], t,
                  t["bound_by"], f"{what}; {'plain_ms' if 'settled' in t else 'every time'} "
                  "from 20 calls replayed from one CUDA graph",
                  source="precision_probe")
        if t["by_precision"]:
            e["by_precision"] = t["by_precision"]
        if "settled" in t:
            e["against_torch_div"] = t["settled"].pop("torch.div")
            e["against"] = t["settled"]
        precision.append(e)

    b1 = entry("attention_fwd", 253, max_err[4], totals, bound_by,
               f"one forward's 18 calls, float32, B={BATCH}, CUDA graph replays; "
               "plain and library issued from Python")
    b1["eager_ms"] = totals["eager_ms"]
    b1["parent_ms_same_calls"] = totals["parent_ms"]
    b2 = entry("attention_bwd", 333, bwd_err[4], bwd_totals, bwd_bound_by,
               f"one training step's 18 calls, float32, B={TIMING_BATCH}, the kernels "
               "from CUDA graph replays in turns with the parent's where its tree is "
               "there; eager_ms the wrapper issued from Python; plain and library "
               "issued from Python; passes_ms by torch.profiler")
    b2["eager_ms"] = bwd_totals["eager_ms"]
    b2["data_parallel"] = {
        **dp_times,
        "times_are": f"RA-LENet 'full' f32 training step ms at a global batch of {DP_BATCH}, "
                     "host clock to a synchronize, mean of "
                     f"{DP_TIMED_STEPS} steps: world1_ms single process and make_mesh(1) "
                     "(NCCL) in turns; world2_ms each rank of two processes on one card over "
                     "gloo, plain and r_pos, against single_ms before and after the spawn"}
    b2["tensor_parallel"] = {
        **tp_times,
        "times_are": f"RA-LENet 'full' f32 training step ms at a global batch of {DP_BATCH}, "
                     f"host clock to a synchronize, mean of {DP_TIMED_STEPS} steps: ranks_ms "
                     "each rank of the (1, 2) grid (two processes) and the (2, 2) grid (four) "
                     "on one card over gloo, plain and r_pos, against single_ms before and "
                     "after the spawns; sharing one card, not scaling"}
    b2["parent_ms_same_calls"] = bwd_totals["parent_ms"]
    b2["passes_ms"] = bwd_totals["passes_ms"]
    for e, what, err, t in (
            (b1, f"one Transformer1d forward's 12 calls, float32, B={T1D_SERVE_BATCH}",
             max_err[32], d32_times["fwd"]),
            (b2, f"one Transformer1d step's 12 calls, float32, B={T1D_TRAIN_BATCH}",
             bwd_err[32], d32_times["bwd"])):
        e["d32"] = {"head_dim": 32, "max_abs_err": err, **t,
                    "times_are": f"{what}, no bias, the kernel from CUDA graph replays, in "
                                 "turns with the parent's (parent_ms) where its tree is there; "
                                 "bound_ms on the tensor cores at 3xTF32, bound_cuda_core_ms "
                                 "the first design's; bf16_ms and bf16_parent_ms the same calls "
                                 "on bf16 operands, in turns; plain and library "
                                 "(scaled_dot_product_attention, no mask) issued from Python",
                    # Transformer1d's paths: every launch on them is at D = 32.
                    "launches_by_path": {path: launches[path][e["name"]] for path in (
                        "serve_transformer1d", "train_transformer1d")}}
    for e, what, err, t, paths in (
            (b1, f"one forward's 12 calls at {T1D_LONG} samples", long_err["fwd"],
             long_times["fwd"], ("serve_transformer1d_long", "train_transformer1d_long")),
            (b2, f"one step's 12 calls at {T1D_LONG} samples", long_err["bwd"],
             long_times["bwd"], ("train_transformer1d_long",))):
        e["d32_long"] = {
            "head_dim": 32, "length": T1D_LONG, "max_abs_err": err, **t,
            "max_abs_err_is": f"float32 at B={T1D_LONG_SERVE_BATCH}, the four stages, with "
                              "and without bias, against the plain version (B2: the plain "
                              "flash backward)",
            "times_are": f"Transformer1d, {what}, float32, B={T1D_LONG_SERVE_BATCH}, no bias, "
                         "the kernel from CUDA graph replays, in turns with the parent's "
                         "(parent_ms) where its tree is there; bound_ms on the tensor cores "
                         "at 3xTF32, bound_cuda_core_ms the first design's; bf16_ms and "
                         "bf16_parent_ms the same calls on bf16 operands, in turns; plain and "
                         "library (scaled_dot_product_attention, no mask) issued from Python",
            "launches_by_path": {path: launches[path][e["name"]] for path in paths}}
    b1["transformer1d_rates"] = {
        "at_256_samples": d32_times["transformer1d"], f"at_{T1D_LONG}_samples":
            long_times["transformer1d"],
        "rates_are": f"Transformer1d at its defaults, windows/s served at {T1D_SERVE_BATCH} "
                     f"(256 samples) and {T1D_LONG_SERVE_BATCH} ({T1D_LONG}), one training "
                     f"step's ms at {T1D_TRAIN_BATCH} and {T1D_LONG_SERVE_BATCH}, this tree's "
                     "B1 and B2 against the parent's in turns"}
    b2["frozen_bias"] = {
        "max_abs_err": frozen_err, **frozen_ms,
        "times_are": f"one NewRale step's 14 biased calls, float32, B={TIMING_BATCH}, "
                     "bias without dbias (the frozen core) and with it, CUDA graph "
                     "replays in turns"}
    b3 = entry("attention_rpos_fwd", 827, rpos_err, rpos_totals, rpos_by,
               f"one r_pos forward's 14 biased calls, float32, B={BATCH}, no lse, the kernels "
               "from CUDA graph replays in turns with the parent's where its tree is there; "
               "eager_ms the wrapper issued from Python; plain and library issued from Python")
    b4 = entry("attention_rpos_bwd", 859, rpos_bwd_err, rpos_bwd_totals, rpos_bwd_by,
               f"one r_pos training step's 14 biased calls, float32, B={TIMING_BATCH}, the "
               "kernels from CUDA graph replays in turns with the parent's where its tree is "
               "there; eager_ms the wrapper issued from Python; plain and library issued from "
               "Python; passes_ms by torch.profiler")
    for e, t in ((b3, rpos_totals), (b4, rpos_bwd_totals)):
        e["eager_ms"] = t["eager_ms"]
        e["parent_ms_same_calls"] = t["parent_ms"]
    b4["passes_ms"] = rpos_bwd_totals["passes_ms"]
    # The wide kernels (head_dim past 64): rows of their own, their
    # launches those of phase 30's paths.
    wide_rows = []
    for kernel, line, what, calls in (
            ("attention_fwd", 253, "fwd", f"one forward's 12 calls, B={T1D_SERVE_BATCH}"),
            ("attention_bwd", 333, "bwd", f"one step's 12 calls, B={T1D_TRAIN_BATCH}"),
            ("attention_dense_fwd", 449, "dense",
             f"one dense forward's 8 B5 calls, B={T1D_SERVE_BATCH}")):
        t = wide["totals"][(what, "float32")]
        e = entry(kernel, line, wide_err[what], t, t["bound_by"],
                  f"Transformer1d num_heads {WIDE_HEADS} (heads 128 and 256 wide), {calls}, "
                  "float32, no bias, the kernel from CUDA graph replays; bound_ms on the tensor "
                  "cores at 3xTF32 or the bytes; plain and library "
                  "(scaled_dot_product_attention, no mask) issued from Python")
        paths = [p for p in launches if "_wide" in p]
        e["name"] = f"{kernel}_wide"
        e["launches_by_path"] = {p: launches[p][kernel] for p in paths}
        e["launches"] = sum(e["launches_by_path"].values())
        e["head_dims"] = "every D > 64: a multiple of 64, others zero-padded up to one"
        e["max_abs_err_is"] = (f"float32, the largest against the plain version over phase "
                               f"30's cases at head_dim {WIDE_DIMS}")
        e["bf16"] = wide["totals"][(what, "bfloat16")]
        e["resources"] = wide["resources"][kernel]
        wide_rows.append(e)
    wide_rows[0]["transformer1d_rates"] = wide["rates"]
    rpos_any_rows = rpos_any_kernel_rows(rpos_launches, rpos_any_err, rpos_rows,
                                         rpos_resources)
    print(json.dumps({"kernels": [
        b1,
        b2,
        b3,
        b4,
        dense,
        null,
        *precision,
        *wide_rows,
        *rpos_any_rows,
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
