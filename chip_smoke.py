#!/usr/bin/env python3
"""Drive the PyTorch port (moco_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a miss:

1. Device: no CUDA device -> exit 2 before anything else. Prints
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. Build: every kernel under moco_tpu_torch/csrc/ is compiled by nvcc for
   sm_90a, one process per source, all started together; ptxas's registers
   and spills are printed per kernel. Then `cuobjdump -sass` of the flash,
   InfoNCE and IVF libraries: every bf16 tensor-core forward, dq and dk/dv
   instantiation (flash_fwd_mma_kernel, flash_dq_mma_kernel,
   flash_dkv_mma_kernel), every split-TF32 InfoNCE forward and backward
   instantiation (infonce_fwd_mma_kernel, infonce_bwd_mma_kernel, padded
   widths 32 / 64 / 128 / 256) and every split-TF32 IVF cell-scan one
   (cell_scores_mma_kernel, padded widths 32 to 512) must hold HMMA/HGMMA
   instructions and the f32 CUDA-core flash ones (flash_fwd_kernel,
   flash_dq_kernel, flash_dkv_kernel) none; the counts are printed.
3. Kernel: each kernel's wrapper against its plain PyTorch version on the
   card at the serving path's shapes (IVF cell scan: d=128, nlist=256,
   cell_cap=512, nprobe=16; uniform probes at m in {1, 8, 32, 128}, and at
   m=128 every pair in one cell, probes drawn from 20 cells (the served
   path's skew) and every 5th id outside [0, nlist)), max |diff| <= 1e-5
   (split-TF32 products at the f32 level, summed over d=128 in another
   order than cuBLAS's, on unit vectors), NaN exactly where a probe is out
   of range, and the same bits on a second call.
4. Path, at full width: ResNet-50 + MLP head (dim 128, 224 px, the
   imagenet_v2 preset) from a seeded numpy init carried in through
   convert.encoder_from_flax; a bf16 InferenceEngine; an EmbeddingIndex of
   K=65536 clustered unit rows with train_ivf(nlist=256, nprobe=16),
   prepared for every bucket in the exact, ivf and ivf_fused tiers; then
   a ServeServer on an ephemeral port answering /embed (n = 1, 5, 32, 100)
   and /neighbors in each tier over HTTP. Every kernel's launch count is
   set to 0 just before this phase and read just after it.
5. Checks: finite unit-norm embeddings; 0 recompiles after warmup on
   engine and index; the kernel launched during the ivf_fused requests;
   ivf_fused against ivf and exact against a float64 host oracle on the
   same features (ids equal except between rows whose true scores lie
   within 1e-5, scores within 1e-5 of the host's); bf16 against an f32
   engine on the card, cosine >= 0.99.
6. Timing: engine ms per bucket; query ms per tier. The IVF kernel's own
   times come last (phase 13).
7. InfoNCE kernels: `infonce_fwd` and `infonce_bwd` (csrc/infonce.cu,
   split-TF32 products on the tensor cores) against their plain versions
   at (B, K, C) in {(8, 4096, 128), (256, 65536, 128), (7, 1000, 20),
   (64, 8192, 256), (300, 5000, 100), (8, 1, 128), (8, 7, 128)}, with the
   width limit raising beyond C=256; and two calls at the path's shape
   giving the same bits. Tolerances: pos <= 1e-5, lse <= 1e-4, dq
   max |diff| <= 1e-4 * max |dq| + 1e-6, and n_above of kernel and plain
   version, on every row, between the float64 count of negatives above
   pos by more than 1e-5 and that count plus the near ties within 1e-5
   (counted).
8. Training path, at full width: the imagenet_v2 preset (ResNet-50 + MLP
   head, K=65536, T=0.2, batch 256, 224 px, bf16 autocast) from seeded
   Flax-layout weights and a seeded unit-row queue carried in through
   convert.state_from_flax; a SyntheticDataset (epochs of 20 steps) through
   the port's TwoCropPipeline on the card. First a 3-step run through the
   prefetch ring from a copy of that state: the step clones each batch it
   is given (on the consumer's stream, no host sync), and afterwards each
   must equal the synchronous batch(0, s) bit for bit. Then
   train(..., device="cuda") for 3 warm-up, 5 timed and 5 untimed steps
   (the ring makes no batch past a run's last step, so its last steps run
   alone; they stay out of the timed window) three times,
   from the same seeded state and data: in sync mode (device_prefetch=False,
   each batch made before its step), in ring mode with the augment's
   transform run eagerly instead of replayed from its CUDA graph (for the
   timings only), and in ring mode (the default: load, H2D copy and the
   graphed augment on a side CUDA stream, depth 2), the InfoNCE launch
   counts set to 0 just before each and read just after. Checks, in each
   mode: finite losses; queue_ptr == steps * 256 mod K; the last 256 written
   rows are the last step's unit-norm keys; after the first step a
   params_k leaf is m * k0 + (1 - m) * q0; each InfoNCE kernel launched
   once per step (the same counts in both modes); and on the last step's
   own (q, k, queue), captured as the step computed them, the loss and dq
   through the kernels agree with the plain versions within the
   tolerances of phase 7, and acc1/acc5 within the percent of rows whose
   count window straddles the accuracy's cut.
8b. Host crops: 256 seeded images of varied geometry (160-400 px a side,
   JPEG and PNG) in a temporary ImageFolder; build_dataset with a cache dir
   decodes them once into the packed RGB cache (PIL); 3 imagenet_v2 steps
   through the ring take host crops from it (the native raw loader where it
   builds, PIL otherwise; the line says which): every batch bit-equal to
   batch(0, s), finite losses, InfoNCE once per step.
9. Timing: step ms, data ms and imgs/s of each mode (the ring's transfer
   stats beside them) and, in sync mode, the data time by stage (host load
   into the pinned slot, H2D copy, augment on the card, the host's time to
   issue it, and its transform run eagerly beside the graph); each InfoNCE
   kernel, its plain version, its bound (the split-TF32 tensor-core work, 3
   x 2BKC forward and 3 x 4BKC backward at the TF32 rate; a line of its
   own gives `f32_fma_bound_ms`, the same products as f32 FMAs on the CUDA
   cores) and one composed PyTorch computation on the path's own inputs; a
   torch.profiler breakdown of one ring-mode iteration's device time.
10. Flash kernels: the forward, dq and dk/dv kernels
   (csrc/flash_attention.cu; bf16 through the tensor-core ones, f32
   through the CUDA-core ones) against their plain versions at
   (B, H, S, D) in {(8, 12, 197, 64) bf16 and f32, (2, 3, 145, 64) f32,
   (1, 2, 1000, 32) f32 and bf16, (4, 4, 65, 128) bf16, the bf16 edges
   (2, 3, 1, 64), (2, 3, 17, 64), (2, 4, 64, 64), (2, 4, 197, 128), and
   (5500, 12, 65, 64) bf16 and f32 (ViT-B at 128 px and a batch of 5500:
   B*H = 66000 heads, past the 65535 a grid's second dimension holds)},
   with a non-zero lse cotangent. f32: out <= 1e-5 max|out| + 1e-6,
   lse <= 1e-5, dq/dk/dv <= 1e-4 max|grad| + 1e-6.
   bf16, against the plain version in f32 on the same bf16 values: lse <=
   1e-5 and each output within 2^-7 of its largest sum of absolute terms
   (+1e-6): rounding p or dS and the output to bf16 (2^-8 relative each)
   moves it by at most that much. A head width, dtype or device mix the kernels do not
   take must raise.
11. v3 path, at full width: the vit_b16_v3 preset (ViT-B/16, 224 px, dim
   256, 4096-wide projector and predictor, AdamW, m = 0.99 on the cosine
   ramp) with vit_flash_attention=True and the one cut, global batch 4096
   -> 256 (one GPU's share of a 16-GPU job), bf16 autocast; seeded
   Flax-layout weights through convert.state_from_flax and a
   SyntheticDataset (epochs of 4 steps, so the ring starts anew at steps
   4, 8 and 12) through the TwoCropPipeline. The 3-step ring check of
   phase 8, then train(..., device="cuda") for 3 warm-up and 5 timed steps
   in sync and in ring mode from the same seeded state and data, the flash
   launch counts set to 0 just before each and read just after. Checks, in
   each mode: finite losses; per step 24 forward launches (12 blocks in each
   encoder) and 12 of dq and of dk/dv, all through their tensor-core
   kernels (none through the CUDA-core ones); the query encoder's patch
   embedding bit-equal to its init; after step 1 a params_k leaf is m(0) k0
   + (1 - m(0)) q0; on the last step's first query-side block (its q, k, v
   and gradient g, captured as the step computed them, g scaled by a power
   of two to a largest |g| near 1) the kernels agree with their plain
   versions within phase 10's bf16 tolerance, each tolerance at most 1/8
   of its output's largest value. Then the attention check, on the seeded
   state and on the ring run's final state: one more step on copies of it
   and one batch, through the kernels and through the port's plain
   attention (`attention_reference` forward and its backward, float64
   logits, p and dS rounded once: the f32-level reference the kernels
   are held to, where the dense path rounds its logits to bf16), gives
   losses within 1.5e-4 (LOSS_REL) of each other and query-encoder features within
   3% of their largest value; two wrong attentions (uniform weights, and
   the kernels without the 1/sqrt(Dh) scale) run as controls: on each
   state each must fail at least one of the two checks, and each check
   must fail on at least one of them.
12. Timing: step ms, data ms and imgs/s of each mode, with the ring's
   transfer stats and sync mode's data time by stage; each flash kernel,
   its plain version, its
   bound and F.scaled_dot_product_attention (forward; its backward through
   autograd for dq and dk/dv together, which computes all three gradients
   in one call and has no lse cotangent) on the captured block, and beside
   each the f32 CUDA-core kernel on the same block in f32 (`f32_ms`); a
   torch.profiler breakdown of one ring-mode iteration with flash_attention
   as its own group.
12b. The closed v2 loop, at full width (imagenet_v2: ResNet-50 + MLP head,
   K = 65536, batch 256, 224 px, bf16) in a temporary workdir, deleted at
   the end. (a) Two epochs of 3 steps on a seeded LearnableSyntheticDataset
   through the prefetch ring, the kNN monitor every epoch (a bank of 512,
   128 held-out queries) and checkpoint_keep=2, the InfoNCE launch counts
   set to 0 just before and read just after: each kernel launched once per
   step; every metrics.jsonl line passes obs/schema.py; one knn_top1 line
   per epoch; checkpoints at steps 3 and 6. A save of the final state is
   timed (its bytes printed), and a restore of step 6 into a fresh state
   must equal the run's final in-memory state bit for bit, tensor by tensor
   (both encoders' parameters and BN statistics, the momentum buffers, the
   queue; queue_ptr and step). Then train again with epochs=3 on the same
   workdir: the driver's own restore must give the same bits and the run
   resumes at step 6, epoch 2 (steps 7-9, InfoNCE once per step); with
   ckpt_truncate on its step-9 checkpoint, restore falls back to step 6
   and the torn file is quarantined. kNN extract and classify are timed on
   the final query backbone, and their top-1 must equal the monitor's last;
   the guard's snapshot copy is timed. (b) The guard: log_every=1,
   nan@step=8 and nan@step=10, threshold 2, from a copy of the final state:
   after step 9 (the NaN is found one step late, as in JAX) the state
   equals step 7's bit for bit while the step counter reads 9; two
   nonfinite_loss lines (nan_steps 1 and 2), each followed by its alert
   line (the default rules, since PR 10); FloatingPointError at step 10's.
   (c) The probe: train_lincls from the workdir (ResNet-50, fc 2048 -> 8,
   batch 256, 1 epoch of 512 images, a val split of 300: a padded, masked
   tail), whose sanity_check holds every backbone weight and BN statistic
   to the checkpoint's bits; evaluate_lincls on model_best gives the best
   epoch's acc1 exactly; the probe and eval steps are timed on one batch;
   convert_pretrain's .pth loads with strict=True into a fresh ResNet-50
   whose features equal the probe backbone's bit for bit. (d) The learning
   signal, tests/test_learning_signal.py's configuration (ResNet-18, CIFAR
   stem, 32 px, dim 64, K 256, m 0.9, T 0.2, MLP, f32, lr 0.12, 4 epochs of
   512 images at batch 64): kNN top-1 (k 32, bank 512, 128 queries) must
   exceed 25%, twice chance; a 10-epoch probe's top-1 is printed beside it.
12c. Fault tolerance and health, at full width (imagenet_v2, epochs of 3
   steps, seeded synthetic data, the ring on) in a temporary workdir,
   deleted at the end. (a) Preemption: preempt@step=4 stops the run after
   step 5 (the signal lands at log step 4's deferred processing, one step
   late); the run returns with its `preempted` flag, one `preempt` line
   (step 5, epoch 1), InfoNCE launched once per step, the previous
   SIGTERM/SIGINT handlers back, and an emergency checkpoint at step 5
   (extras epoch 0, emergency, reason "preempt") that restores bit for bit
   into a fresh state equal to the run's final state; the rerun resumes at
   epoch 1 and ends at step 8 (5 + one redone epoch, moco_tpu's driver
   test). A real SIGTERM from a timer thread during step 3 is timed from
   os.kill to the emergency checkpoint's durable write (`CheckpointManager
   .wait` returning). (c) Async checkpoints, 3 epochs with checkpoint_async:
   the milliseconds each epoch-end save cost the loop (the first allocates
   pinned host buffers, the second reuses them) beside a blocking save and
   two async saves of the same final state; the step-3 file, restored after
   steps 4-9 ran in place, equals the state cloned at save time bit for
   bit; ckpt_truncate on the step-9 file under async still falls back to
   step 6 and quarantines it. (d) Health and alerts: every training line of
   the (a) and (c) runs carries every gauge and passes obs/schema.py, and
   no alert fires on those clean ring runs; on one step's own q, k (head
   outputs) and the queue it read, each gauge within 1e-5 of a float64 host
   recomputation, relative to the larger of its value and its unit (1/T for
   the logit statistics, 1/sqrt(d) for feature_std), feature_dim_active
   equal but for dimensions within 1e-6 of the threshold; the gauges'
   device time (CUDA events) and the v2 sync-mode step ms with
   health_metrics on and off (5 timed steps each from the same state);
   nan@step=5 (log_every=1) under the default rules writes one
   nonfinite_loss alert line and one alerts.jsonl entry, and under
   alerts_fatal raises FatalAlertError after an emergency checkpoint of
   step 4 (reason "alert"). (b) The watchdog, its process started with
   12i and checked after it (its checkpoint, not its time, is held): `python -m
   moco_tpu_torch.train --preset imagenet_v2 --data synthetic --epochs 2
   --steps-per-epoch 3 --watchdog-timeout 8` with
   MOCO_FAULTS=stall@step=6:seconds=120 (the last log step's deferred
   read) exits with code 42, leaves stall_stacks.txt, one `stall` line and
   an emergency checkpoint (reason "stall") of the last log step whose
   loss the deferred read found finite, step 4, not of the live step 6:
   queue_ptr 1024, and the rows steps 5 and 6 wrote still the seeded
   initial queue's; the seconds from the stall to the exit are printed.
12d. The options of the v1/v2 step at full width, each part 2 warm-up
   and 3 timed steps through the prefetch ring from a seeded state, the
   InfoNCE launch counts set to 0 just before and read just after (each
   kernel once per step, finite losses). (a) `imagenet_v2` with
   bn_virtual_groups=8 and shuffle="gather_perm" (the reference's 8 GPUs
   x 32-row BN inside one batch of 256): the last key forward ran on the
   step's batch permuted by the permutation `step_seed` gives; the keys
   enqueued on the last step equal the key encoder's 8-group forward on
   that permuted batch, unpermuted, within 2^-7, and the same forward with
   whole-batch BN (the control) differs by more; step ms and imgs/s
   beside a G = 0 run from the same seeded state and data. (b)
   `imagenet_v2_large_batch` (LARS, momentum-statistics BN, auto_scale
   ref_batch=4096) with its global batch 8192 cut to LARGE_BATCH: the live
   lr is the auto-scaled schedule's and the EMA after step 1 runs at
   0.999 ** kappa; the last step's LARS update equals a float64 LARS on
   the same gradients, parameters and traces within 1e-5 relative; with
   remat off and on, from the same state and data, the first-step losses
   agree within 2^-7 relative; peak GB and step ms of both. (c)
   `imagenet_v2` with shuffle="none" and key_bn_running_stats (EMAN):
   after step 1 the key encoder's running statistics are
   m * k0 + (1 - m) * q1 of the query encoder's, m = min(0.999, 1/10),
   within 1e-6 relative.
12e. Train to serve, at full width, in a temporary workdir deleted at the
   end. (a) train(imagenet_v2, workdir=W) for 3 ring steps from phase 8's
   seeded state and data, a checkpoint at step 3; load_serving_encoder(W)
   (its restore timed) gives the key encoder bit-equal to the trained
   state's and the queue and pointer bit-equal to its; a bf16 engine
   (buckets 1/8/32/128), EmbeddingIndex.from_train_queue with
   train_ivf(nlist=256, nprobe=16), a ServeServer with a JsonlSink (the
   checkpoint's step and params_digest as its identity): /embed, then
   /neighbors in exact, ivf and ivf_fused, the IVF kernel's launch count
   set to 0 just before these requests and required above 0 after them;
   /admin/model gives the step and digest; every metrics.jsonl line passes
   obs/schema.py; ivf_fused against ivf and exact against a float64 host
   oracle as in phase 5 (no recall floor: a 3-step queue is mostly the
   seeded init); bf16 against an f32 engine, cosine >= 0.99. (b) `python
   -m moco_tpu_torch.serve.replica_main --ckpt-dir W --port <free>
   --buckets 1,8,32` as a subprocess on the card, spawned once the
   checkpoint is restored (it boots while (a) serves), timed from spawn to a
   healthy /healthz: its /neighbors rows (exact, its default) within
   cosine 0.999 of (a)'s engine at the same bucket, its ids equal to (a)'s
   exact tier's but where two rows' float64 scores lie within twice the
   rows' embedding gap (a near-tie), its /admin/model digest (a)'s; SIGTERM
   -> exit 0 and "drained (clean)"; its metrics.jsonl valid. (c)
   train(vit_b16_v3, batch 256, vit_flash_attention=True, workdir=W3) for 2
   steps from phase 11's seeded state, a checkpoint at step 2;
   load_serving_encoder(W3) gives queue None and the key encoder bit-equal
   to the trained one; a bf16 engine at 224 px behind a ServeServer
   without an index: /embed answers, /neighbors answers 503; with the flash
   counts set to 0 before the engine's warmup, the forward's launches equal
   12 x the engine's encoder forwards, all flash_fwd_mma_kernel; the ViT
   engine's ms per bucket; its embeddings against an f32 engine whose
   attention is the port's plain attention_reference, cosine >= 0.99. (d)
   train_lincls on W3 (1 epoch of 512 learnable 224-px images at batch 256,
   a val split of 300): finite losses, sanity_check inside, the flash
   forward launched; evaluate_lincls gives the best epoch's acc1; the probe
   and eval steps timed on one batch. (e) convert_pretrain W3 -> .pth: the
   150 timm names of ViT-B/16 with a cls token exactly; block 0's fused
   qkv.weight @ x equals the three projections within 1e-5 of their largest
   value; the export loaded back into a port ViT (qkv split, pos_embed
   equal to its fixed buffer) gives the probe backbone's bf16 features bit
   for bit through the flash kernel. Through (c)-(e) every flash forward
   launch is flash_fwd_mma_kernel and no flash backward launches; the
   phase's IVF and flash forward launches are added to the kernels line.
12f. Observability, at full width, in a temporary workdir deleted at the
   end. (a) train(imagenet_v2) for 3 warm-up and 5 timed ring steps from
   phase 8's seeded state and data with a workdir, log_every=1,
   obs_probe_every=5, sinks jsonl,csv (tensorboard where a writer is
   importable; else its constructor must raise JAX's RuntimeError) and a
   check sink, and metrics_port on a free port, the InfoNCE counts set to
   0 just before and read just after (once per step): every metrics.jsonl
   line passes obs/schema.py and carries t_data, t_step, t_dispatch and
   t_device (sampled from step 0 on), the memory gauges and
   hbm_state_bytes; the last line's hbm_peak_bytes equals
   torch.cuda.max_memory_allocated() as the line is written (no line's
   exceeds it; the ring may allocate between a line's read and its
   write); the CSV's rows
   equal the JSONL's; a scrape of /metrics from the log callback, mid-run,
   holds the loss gauge; trace.json loads, every step, data_wait and
   device_wait span lies inside an epoch span, and device_wait appears on
   the sampled steps only; and the step function, run under
   torch.cuda.set_sync_debug_mode("warn"), raises no synchronization
   warning on its thread. (b) From the same state and data, 15 ring steps
   with obs_probe_every=0 (the in-flight window alone) and twice with
   obs_probe_every=1 (a wait around every step): imgs/s over the 5 timed
   steps (the host clock from the first timed step's dispatch to the
   dispatch after the last's), the medians of t_dispatch and t_device of
   the first every-step run; the losses of the window run within the
   larger of 2^-7 relative and the two every-step runs' gap (printed) of
   the first every-step run's; the final queue_ptr and step equal. (c)
   Phase 4's bf16 engine and K = 65536 IVF index (nlist 256, nprobe 16)
   behind a ServeServer with reqtrace, a JsonlSink, the serve_default
   alerts, slo_ms 100 and recall_sample_every=4: after one request (its
   engine_execute printed), 64 two-image /neighbors?mode=ivf_fused
   requests from 4 client threads, the IVF count
   set to 0 before them and above 0 after them; distinct request ids;
   flushed lines valid, with the five serve/trace_<stage>_ms means, the
   burn rates and serve/recall_estimate; in /debug/flight every request's
   stage sum within 5% (or 1 ms) of its total_ms. Then
   slow@site=serve.engine_execute:ms=200 over the same requests: a burn
   rule fires (after any the warm-up request fired) and its flight_*.json
   holds slowed requests among its slowest, each blaming engine_execute
   for at least 200 ms. The tracing cost:
   /neighbors p50 and p99 of the same requests with reqtrace on and off,
   in turns (on, off, off, on) on one server each way, each warmed by one
   request. The phase's InfoNCE and IVF launches are added to the kernels
   line.
   Earlier phases that read a record's step_ms or a `log` callback's state
   run with obs_probe_every=1: a wait around every step, as the loop did
   before the in-flight window, and each record's `log` call before the
   next step's dispatch.
12g. Serving, the rest, at full width, in a temporary workdir deleted at
   the end. (a) Phase 4's K = 65536 index (its seeded clustered rows, IVF
   nlist 256 / nprobe 16) with enable_int8(), every tier prepared for the
   engine's buckets: exact_i8, ivf_i8 and ivf_fused_i8 on phase 4's
   features at m = 1 / 8 / 32 / 128, k = 5: every score within 0.02 (JAX's
   rescale bound) of the float64 cosine of its pair; the IVF twins' recall@5
   against exact_i8, pooled over the four m, no lower than ivf_fused's
   against exact less 0.02 (each printed, no absolute floor); exact_i8's
   `torch._int_mm` accumulators bit-equal to the float64 product of the same
   int8 values; host ms per tier and m; the rows' bytes at rest. (b) 12e's
   trained v2 checkpoint served in tiers off (bf16), w8 and w8a8, buckets
   1 / 8 / 32 / 128: the calibration from 256 seeded held-out 224-px images,
   written, read back bitwise and validated; every row's cosine to an f32
   engine >= 0.99 (JAX's QUANT_COSINE_FLOOR) and 0 recompiles after every
   bucket; each quantized engine's int8 tensors unchanged (storage and
   checksum) on every bucket; the int8 route against its emulation on one
   bucket-8 batch: every layer's int32 accumulator equal to the float64
   emulation's, the embeddings within 1e-5 of the f32 emulation's; the int8
   bytes at rest; ms per bucket per tier (CUDA events, f32 beside them) and
   the w8a8 forward's extra peak memory at bucket 128 (its im2col). (c) A
   ServeServer with the w8a8 engine over (a)'s index, neighbors_mode
   ivf_fused, recall sampled on every flush: 48 two-image /neighbors
   requests and 12 with ?mode=ivf_fused_i8 from 4 threads (64 and 16
   before phase 12m's legs, which the cut pays for); the recall
   estimate reported, serve/quant_tier 2 and serve/int8 1, 0 recompiles,
   the cell scan launched, the lines schema-valid. Then 3 more v2 ring
   steps from 12e's checkpoint (its copy) write step 6 (InfoNCE once per
   step); `replica_main` serves the step-3 copy with --fresh-max-age-s 20
   and a fault plan that stalls its first /ingest after the ones below by
   90 s; `python -m moco_tpu_torch.serve.serve_ingest --once` sends step
   6's whole queue oldest-first (65536 rows, in blocks of 8192), an
   incremental poll from step
   3's head the 768 rows the trainer enqueued: serve/ingested_rows 66304 and
   serve/ingest_ckpt_step 6; an index in this process that took the same
   blocks answers each of the 768 rows and every 64th slot with its own row
   as top-1 on exact and exact_i8, or with a row whose score lies within
   1e-6 (exact) or 0.02 (exact_i8) of its own: the 768 rows sit at two
   slots, since the incremental block re-sends rows the whole queue
   brought (counted, with the largest gap). The stalled ingest: fresh_burn_fast fires in the
   replica's alerts.jsonl after it began and before it returned, with the
   burn below 14.4 on the last line before it; SIGTERM drains to exit 0.
   (d) During the stall: a fresh thread's first bucket-8 forward after the
   engine's warm-up on this one, and its next 16 (no pass); on other fresh
   threads the cuBLAS handle, a matmul and a tiny convolution before the
   first forwards at buckets 8 and 32, and the batcher's own pass before 17
   forwards; then a fresh ServeServer (bf16 engine, (a)'s index, SLO 100
   ms): the first of 17 sequential /neighbors requests' engine_execute within 3x the
   median of the next 16. The phase's cell-scan and InfoNCE launches are
   added to the kernels line (`launches_12g`; the cell scans of 12m(b)'s
   bursts, which run after them, apart as `launches_12m`).
12h. Data parallelism (moco_tpu_torch/parallel/), each world in child
   processes that import no JAX; (a)'s process runs beside (b)'s ranks,
   and 12i's, 12j's and 12k's ranks spawn while the phase before theirs
   runs, waiting behind a gate file (no check reads a time; (a)'s step ms,
   and so its NCCL-of-one overhead, carry (b)'s load). (a) An NCCL group
   of one: the imagenet_v2
   preset (ResNet-50 + MLP, K = 65536, batch 256, 224 px, bf16) for 4
   steps from phase 8's seeded state on the same batches, on one device,
   through the distributed path (`init_process_group("nccl")`; the
   gradients', BN statistics' and metrics' all-reduces issued), and on one
   device again, with cuDNN's deterministic algorithms: the second
   single-device run repeats the first bit for bit, and the distributed
   run equals it bit for bit (losses, both encoders' parameters and BN
   statistics, the momentum buffers, the queue); InfoNCE once per step;
   the ledger `comms/grad.psum` 0; step ms of each (the overhead: the
   distributed run's steady step against the last single-device run's).
   (b) Two ranks of 128 rows: NCCL on two cards where the machine has
   them, else gloo with both ranks on cuda:0 (printed); each rank first
   reports which collectives its group takes on the card. Per rank, from
   phase 8's seeded state, each rank's batches made by its own ring from
   its rows of the seeded global batch: imagenet_v2 with
   shuffle="gather_perm" for 4 steps (bf16, the preset's dtype; timed), in
   float32 without TF32 with "gather_perm" and "syncbn" for 2 steps each,
   and vit_b16_v3 at 2 x 128 rows (flash attention) for 2 steps. Checks: finite losses; the two ranks'
   states (parameters, BN statistics, optimizer buffers, queue) equal bit
   for bit after every step; each rank's ring batches are its rows of the
   one-process batch(0, s) bit for bit; InfoNCE once per step per rank,
   and per v3 step 24 flash forward, 12 dq and 12 dk/dv launches per
   rank; the `comms/<site>` bytes equal JAX's cost model on the shapes.
   Then on rank 0, one device over the whole batches, in float32 without
   TF32: the float32 gather_perm against bn_virtual_groups=2 with the
   same permutations, syncbn against shuffle="none", and as a control
   whole-batch BN against gather_perm. An oracle must keep every loss
   within DP_LOSS_RTOL relative, the 2-step update
   of all parameters and BN statistics within DP_UPDATE_REL of the
   oracle's (||world - oracle|| / ||oracle - init|| over all of them) and
   every queue row the steps wrote at cosine DP_QUEUE_COS or more; the
   control must fail at least one of these. Elementwise closeness is
   printed, not required: a ReLU input within rounding of zero flips under
   another order of the same sums and BN spreads it (DP_UPDATE_REL's
   note). Step ms, imgs/s and peak memory per rank are printed; the
   launches of (a)'s distributed run and of each rank are added to the
   kernels line (`launches_12h`).
12i. ZeRO (moco_tpu_torch/parallel/zero.py) on 12h(b)'s two ranks (NCCL on
   two cards, else gloo on cuda:0; printed), in child processes that
   import no JAX. Each rank first reports whether its group takes
   `reduce_scatter_tensor` on its device (the port issues it on every
   backend; the phase fails if a rank's group does not). From phase 8's seeded
   state on each rank's 128 rows of the same 2 ring batches: imagenet_v2
   (ResNet-50 + MLP, K = 65536, 224 px) in float32 without TF32 with the
   replicated data-parallel step (12h's) and at stage 1, stage 3 and
   layer-granular; a stage-3 checkpoint (whole tensors gathered onto rank
   0) loaded into a stage-1 state equals the stage-3 state bit for bit;
   then the replicated step and the three layouts in bf16 (the preset's
   dtype; 3 steps over the 2 batches, stages 2/3 with the training loop's hoisted
   gather): step ms (the median of the last 2), imgs/s, peak memory,
   `hbm_state_bytes`, `hbm_model_peak_bytes` and `overlap/zero` per rank,
   beside 12h's peak memory; then the vit_b16_v3_huge_batch_zero3 preset's
   model and parallel settings (its batch of 8192 cut to 2 x 64 rows,
   auto_scale applied, flash attention), replicated and layer-granular, 2
   steps each; then the linear probe on the two ranks from the stage-3
   checkpoint. Checks: finite losses; the ranks' whole states (gathered)
   equal bit for bit after every step; each ZeRO run against the
   replicated one by 12h's oracles (loss DP_LOSS_RTOL, update DP_UPDATE_REL
   in L2, queue cosine DP_QUEUE_COS), and 12h's control (whole-batch BN on
   one device) rejected by each of them against stage 3; InfoNCE once per
   step per rank; per v3 step 24 flash forward, 12 dq and 12 dk/dv
   launches per rank, 36 forward under the layer schedule (its segments
   recompute the query forward in the backward); the `comms/zero.*` and
   other sites' bytes equal JAX's cost model on the layouts' bucket
   tables; the checkpoint's resume; the probe's counts and the same result
   on both ranks. The launches are added to the kernels line
   (`launches_12i`).
12j. The model axis (moco_tpu_torch/parallel/mesh.py, ring_attention.py),
   in child processes that import no JAX: a world of 1 x 2 ranks (its
   model group both; NCCL on two cards, else gloo on cuda:0) and, at the
   same time, one of 8 for the ring alone (NCCL on eight cards, else gloo
   on cuda:0); printed. (a) imagenet_v2 (ResNet-50 + MLP, K = 65536, batch
   256, 224 px) at num_model = 2, in float32 without TF32, 2 steps from
   phase 8's seeded state: each rank holds 32768 rows of the queue and
   runs the InfoNCE kernels on them, the shards' (lse, count) merged over
   the model group; checks: finite losses, the ranks' encoders equal bit
   for bit after every step, InfoNCE once per step per rank, the shard's
   shape and queue_ptr, the `comms/<site>` bytes (`grad.psum` over data x
   model, `queue.stats_gather`) by JAX's cost model, and against the
   replicated one-device step on the same batches 12h's oracles (loss
   DP_LOSS_RTOL, update DP_UPDATE_REL in L2, the written queue rows' cosine
   DP_QUEUE_COS). (b) ring attention alone at the preset's shape (ViT-B/16
   at 448 px: S = 784, H = 12, D = 64, bf16, 2 images) at n = 2 and n = 8
   (98 tokens a rank), with seeded cotangents of out and lse: out, lse, dq,
   dk and dv of every rank against one flash call over the whole sequence
   and against the plain float64 attention (MA_RING_REL, MA_FLASH_REL,
   MA_LSE_TOL). (c) vit_b16_v3_highres_sp through train() at num_model = 2
   (its global batch 1024 and num_model 8 cut to 16 and 2, `reduced`),
   2 steps from phase 11's seeded weights, in float32 without TF32 and in
   bf16 (the preset's dtype): finite losses; the ranks' states equal after
   every step (a fingerprint of every tensor); per rank per step 2 x 12 x 2
   flash forwards and 12 x 2 dq and dk/dv launches; the ring's
   `ring_attention.kv_ppermute` bytes (n calls a step) and
   `grad.seq_psum`; then on rank 0 the dense-flash step on one device on
   the same batches: in float32 each loss within DP_LOSS_RTOL, the first
   step's gradients within MA_GRAD_REL in L2 (the reference's, twice the
   backbone's, must fail that; the later step's printed), the 2-step
   update within MA_UPDATE_REL;
   step ms, imgs/s and peak GB per rank beside the dense step's. Then the
   InfoNCE kernels at a shard's (256, 32768, 128) against their plain
   versions, and the InfoNCE and flash kernels (384 heads of 392 and of 98
   tokens) timed at the model axis's shapes with their plain versions,
   bounds and library calls (`at_12j_shapes`). The launches of (a) and (c)
   are added to the kernels line (`launches_12j`).
12k. The rest of distributed training (moco_tpu_torch/parallel/zero.py on
   a model axis, parallel/elastic.py), in child processes that import no
   JAX: first the InfoNCE kernels against their plain versions at a 2 x 2
   rank's shapes, (B, K, C) = (128, 32768, 128) (phase 7's checks). (a) a
   world of 2 x 2 ranks (NCCL on four cards, else gloo on cuda:0):
   imagenet_v2 (ResNet-50 + MLP, K = 65536, batch 256, 224 px) in float32
   without TF32, 2 steps each replicated and at ZeRO stages 1 and 3 (the
   state sharded over the 2 data ranks, the queue's 32768 rows a rank over
   the model ranks, a data rank's 128 rows on both its model ranks), from
   phase 8's seeded state on the same batches: finite losses, the ranks'
   whole states equal after every step (a fingerprint), InfoNCE once per
   step per rank, the shard's shape and queue_ptr, shards over 2 ranks;
   against the replicated 2 x 2 step and the one-device step on the whole
   batches, 12h's oracles (DP_LOSS_RTOL, DP_UPDATE_REL, DP_QUEUE_COS) for
   each; `hbm_state_bytes` per rank, stage 3 below the replicated step.
   (b) elastic: the same processes as a world of 4 data ranks (64 rows
   each, global 256) run imagenet_v2 (bf16, PyTorch's seeded init) through
   train() with
   `elastic`, heartbeat_timeout ZK_HEARTBEAT_S, a group timeout of
   ZK_GROUP_TIMEOUT_S (the ranks meet first through a file store under
   ZK_TIMEOUT_S: rank 0 comes late from (a)'s oracle) and kill@host=0:at=3 (the writer dies): rank 0 exits
   113 and the 3 survivors 75; one durable checkpoint, step 3's (extras
   `reason: "rescale"`, the plan 4 -> 2 ranks, 256 -> 128 rows), and one
   schema-valid `rescale` line (dead [0], kappa 1/2), both rank 1's; then
   2 new processes relaunch at the plan (global 128, no --auto-scale):
   each loads the checkpoint into a fresh state whose payload equals the
   file's tensor for tensor, bit for bit, then 2 steps through train()
   (4-5, finite, the ranks equal) with InfoNCE once a step, and lr and EMA
   momentum `apply_auto_scale`'s at kappa = 1/2. Printed: the signal to
   the last survivor's exit (host clock, from rank 0's exit) and the
   relaunch's spawn to its first finished step. The launches of (a), (b)'s
   survivors and the relaunch are added to the kernels line
   (`launches_12k`).
12l. The serving fleet (moco_tpu_torch/serve/{router,fleet,promote}.py),
   right after 12g, at full width: a ReplicaSupervisor of two
   `moco_tpu_torch.serve.replica_main --device cuda` processes on the card
   serving 12e's v2 checkpoint (buckets 1 / 8 / 32), FL_WARM_ROWS of its
   queue as the warm rows, `kill@replica=1:at=FL_KILL_AT` in replica 1's
   environment, behind a FleetRouter (breaker threshold 1, hedging off).
   (a) FL_CLIENTS client processes of FL_BURST /embed and /neighbors
   requests of FL_BURST_SIZES images: no client request fails; replica 1 dies once (rc 113), is
   respawned once and warm-replayed (its serve/ingested_rows = the warm
   rows); the router's retries and breaker trips above 0; every answer's
   `replica` matches its `r<i>-` request id; every embedding within cosine
   0.99 of an in-process engine on the same checkpoint; each request's
   stitched hop sum (obs/critpath.py on the router's flight record) within
   FL_HOP_REL or FL_HOP_MS of the client's wall to the answer's last byte.
   Printed: each replica's spawn to healthy, the kill to the first answer
   from the reborn replica through the router, the router's p50 / p99 of
   FL_LAT_N sequential 32-image /embed requests (a full bucket: the batcher
   flushes at once, where a smaller request waits up to half the replicas'
   1000 ms SLO to coalesce) beside replica 0's own. (b) A drain
   of replica 0 (restart through the supervisor) and an undrain under two
   client threads: nothing dropped, the cycle's seconds printed; then
   `serve_ingest --fanout --once` of 12g's step-6 queue through the router:
   K rows more on each replica. (c) `serve_promote` gates a candidate whose
   encoders are re-initialised (rejected, the ledger line naming the gate),
   then, with the router, a compatible one (the live parameters scaled by
   1 + FL_NUDGE, the reference smoke's stand-in for one more epoch; 12g's
   step-6 checkpoint fails compat_cosine: its key encoder's BN statistics
   moved): accepted (its EMA-drift ceiling FL_MAX_EMA_DRIFT and feature_std
   floor FL_FEATURE_STD_FLOOR, the other floors the defaults; the gates the
   defaults would fail printed) and rolled out one replica at a time
   through /admin/promote: `fleet_serve/model_skew` at least 1
   mid-rollout, then 0, both replicas on the candidate's step and digest,
   the ledger schema-valid. (d) During the rollout: the same router
   class in front of two in-process ServeServers over phase 4's index (IVF
   nlist 256, nprobe 16, ivf_fused): FL_NEIGHBORS
   /neighbors?mode=ivf_fused requests of 32 launch cell_scores_mma_kernel
   (`launches_12l` in the kernels line), each answer's ids equal and scores
   within SCORE_TOL of a direct index.query of its own embeddings.
12m. The analysis's runtime arms (moco_tpu_torch/analysis), as legs of
   the phases that already pay for their setup (`python3 chip_smoke_12m.py`
   runs them alone): (a) in 12h(b)'s two-rank world, two SAN_STEPS-step
   imagenet_v2 runs through train() under `sanitize_collectives` in
   workdirs both ranks share: the clean one publishes equal schedule hashes
   (schedule.p<rank>.json) and `collective_schedule_hash` on every record
   and line; with `diverge@site=SAN_DIVERGE_SITE` on rank 1 alone both
   ranks abort with ScheduleDivergenceError at the first log step, the
   site in schedule_diff.json. (b) In 12g, after its replica, bursts of
   TSAN_REQUESTS sequential /neighbors requests to in-process
   ServeServers (the bf16 engine, the IVF index, ivf_fused, SLO
   TSAN_SLO_MS): one without any hook, one started under ThreadSanitizer
   with its profile hook (the clean leg: the serve.index -> serve.metrics
   edge, no cycle, lock_order.json), the first again; the client's p50 of
   each printed. Then `deadlock@site=TSAN_DEADLOCK_LOCK` (the lock taken
   under serve.index) records the inverted order: a cycle,
   lock_order_diff.json with both edges' stacks. (c) 12l's replicas run
   with MOCO_CONTRACT_COVERAGE=1 and a freshness objective
   (FL_FRESH_MAX_AGE_S), this process under a coverage recorder of its own
   (the router's routes, the ledger's and the router's lines' validators,
   each replica's metrics.jsonl validated under it at the end); 12l also
   asks each replica's /admin/model (the candidate's step and digest after
   the rollout) and the router's /stats. Its snapshot and the replicas'
   dumps (contract_coverage.json, one per slot, added up over its respawns
   in this run), merged, pass check_coverage for every declared replica
   and router route, both trace headers, kill@replica, delay@ingest and
   the six stage hooks, and the SERVE, FLEET, QUALITY and PROMOTION gated
   validators, as the reference fleet smoke gates them. (d) Phase 8's ring run under
   `strict_tracing` (recompile_warmup_steps STRICT_WARMUP_STEPS): every log
   record's `compile_cache_misses` (the augment's CUDA-graph captures) at
   least 1 and flat, and the run does not abort.
13. IVF timing, after every other timing (the profiler it uses stays
   attached to the process): the kernel, its plain version, its bound and
   one library call on the path's own inputs. Its `ms` (CUDA events over
   back-to-back wrapper calls: at small m, how fast the host launches it)
   stands beside its `device_ms` (the kernel alone, torch.profiler); it is
   timed with the served features' own probes and with uniform ones, each
   also at buckets 1 / 8 / 32 / 128; its bound is the larger of the bytes
   (each distinct probed cell read once) and the split-TF32 tensor-core
   work (3 x 2 m nprobe cell_cap d at the TF32 rate). A plain-text line
   per probe set gives what is computed rather than measured: the distinct
   cells, the cell bytes a per-pair scan would request, the bound's bytes
   and the f32-FMA bound of the same products.

The last line of stdout is {"ok": true, "device": {...}}; the lines before
it carry the kernel table and the timings as JSON.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import gc
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
SEED = 0
K, DIM, NLIST, NPROBE, TOPK = 65536, 128, 256, 16, 5
IMG = 224
SCORE_TOL = 1e-5
POS_TOL, LSE_TOL, TIE_TOL = 1e-5, 1e-4, 1e-5
TRAIN_WARMUP, TRAIN_TIMED = 3, 5
OPTION_WARMUP, OPTION_TIMED = 2, 3  # phase 12d's runs: the options' step ms beside each other
# untimed steps after the timed ones in the v2 runs: the ring makes no batch
# past the run's last, so in its last steps the step has the card and the
# host to itself; the tail keeps that out of the timed window
V2_TAIL = 5
STRICT_WARMUP_STEPS = 1  # 12m(d): phase 8's ring run under strict_tracing
EPOCH_STEPS = 20  # steps in an epoch of the v2 phase's synthetic data: one ring per run
RING_CHECK_STEPS = 3  # steps of the ring runs whose batches are held against batch(e, s)
V3_BATCH = 256  # vit_b16_v3's global batch 4096 cut to one GPU's share of 16
BF16_REL = 2.0 ** -7  # bf16 tolerance of a flash output, of its absolute-term sum
TOL_SHARE = 0.125  # most a flash tolerance may be of its output's largest value
# flash against the plain attention on one v3 step (bf16 q, k and v, the
# plain version's logits in float64): the loss, relative, and the query
# features, of their largest value. On an H100, over the seeded and the
# trained state, the kernels were at most 4.6e-5 and 0.020 off, the nearer
# of two wrong attentions at least 4.3e-4 (loss) and 0.045 (features)
LOSS_REL, FEAT_REL = 1.5e-4, 0.03
# the closed loop (phase 12b): epochs of 3 steps, a kNN bank of 512 and 128
# held-out queries, a probe val split of 300 (a padded tail of 44 in batches
# of 256)
LOOP_EPOCH_STEPS, KNN_BANK, KNN_TEST, PROBE_VAL = 3, 512, 128, 300
PROBE_EPOCHS = 1  # the probes of 12b(c) and 12e(d): epochs of 512 images
# phase 12c(b): the watchdog's timeout; the first step has its own grace of 900 s
WATCHDOG_TIMEOUT_S = 8.0
# phase 12d: the virtual groups of the reference's 8 GPUs x 32 rows, and the
# large-batch preset's global batch 8192 cut to what one card holds
OPTION_GROUPS, LARGE_BATCH = 8, 1024
# phase 12e: the steps that write the two checkpoints, and the replica's buckets
SERVE_V2_STEPS, SERVE_V3_STEPS, REPLICA_BUCKETS = 3, 2, "1,8,32"
BUCKETS = (1, 8, 32, 128)  # the engine's default buckets
F32_MODES = ("exact", "ivf", "ivf_fused")  # the index's f32 tiers (the int8 ones: 12g)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 50, warm: int = 5) -> float:
    """Mean device time of `fn` in ms over `iters` launches (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, key: str, iters: int = 50, sessions: int = 3) -> float:
    """Mean device time in ms of the CUDA kernels whose name holds `key`
    per call of `fn`, under torch.profiler: the kernel alone, where
    cuda_ms of a short kernel measures how fast the host enqueues it. A
    session that records no such kernel (on an H100, one of ~40 sessions
    late in a process that had profiled before recorded none while the
    kernel ran) is run again, up to `sessions` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key)
        if total > 0:
            return total / iters / 1e3
    check(False, f"{sessions} profiler sessions saw no kernel named like {key!r}")


def host_ms(fn, iters: int = 10) -> float:
    """Median wall time of `fn` in ms, each call ending in a device sync."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def unit_rows(rng, n, d, centers=1024, noise=0.3):
    """Clustered unit rows: the geometry a trained dictionary has."""
    c = rng.standard_normal((centers, d))
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def cell_scan_bound_ms(m, nprobe, cell_cap, d, distinct_cells):
    """Least time for the cell scan: each distinct probed cell read once,
    queries, probe ids and scores once, against the split-TF32 tensor-core
    work (three TF32 products per product, 2 flops per multiply-add).
    Returns (bound ms, "bytes" or "operations", bytes, the same products'
    bound as f32 FMAs on the CUDA cores in ms)."""
    bytes_ = (distinct_cells * cell_cap * d + m * d + m * nprobe + m * nprobe * cell_cap) * 4
    flops = 2 * m * nprobe * cell_cap * d
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, 3 * flops / PEAK_TF32_FLOPS
    t_fma = max(t_bytes, flops / PEAK_F32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), bytes_,
            t_fma * 1e3)


def same_topk(feats, rows, got, want, what):
    """Every reported score is within SCORE_TOL of the float64 host score
    of the id it names, and the two lists' scores agree position by
    position within SCORE_TOL; so where the ids differ, the two rows'
    true scores lie within 3 * SCORE_TOL (a near-tie whose order depends
    on summation order). Returns the number of such swaps."""
    for s, i in (got, want):
        check(np.isfinite(s).all(), f"{what}: non-finite scores")
        true = np.einsum("md,mkd->mk", feats.astype(np.float64), rows[i].astype(np.float64))
        err = np.abs(true - s).max()
        check(err <= SCORE_TOL, f"{what}: score off its row's true score by {err:.3g}")
    (gs, gi), (ws, wi) = got, want
    check(np.abs(gs - ws).max() <= SCORE_TOL, f"{what}: scores differ by {np.abs(gs - ws).max():.3g}")
    return int((gi != wi).sum())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


FLASH_SYMBOL = re.compile(r"(flash_(?:fwd|dq|dkv)(?:_mma)?_kernel)I(\w*?)EE")
SPLIT_TF32_SYMBOL = re.compile(r"((?:infonce_(?:fwd|bwd)|cell_scores)_mma_kernel)ILi(\d+)EE")
INFONCE_WIDTHS = (32, 64, 128, 256)  # the padded widths csrc/infonce.cu is built for
IVF_WIDTHS = (32, 64, 128, 256, 512)  # and csrc/ivf_cell_scores.cu


def short_name(mangled: str) -> str:
    """'flash_fwd_mma_kernel<bf16, 64>' for a flash kernel's mangled name,
    'infonce_fwd_mma_kernel<128>' for an InfoNCE one,
    'cell_scores_mma_kernel<128>' for an IVF one; other names as they are,
    cut to 80 characters."""
    found = SPLIT_TF32_SYMBOL.search(mangled)
    if found:
        return f"{found[1]}<{found[2]}>"
    m = FLASH_SYMBOL.search(mangled)
    if not m:
        return mangled[:80]
    name, args = m.groups()  # args: "Li64"; the _mma kernels take bf16, the others f32
    dtype = "bf16" if "_mma_" in name else "f32"
    head_dim = re.search(r"Li(\d+)", args)[1]
    return f"{name}<{dtype}, {head_dim}>"


def print_ptxas(logs: dict) -> None:
    """ptxas's register, shared-memory and spill lines, each under the
    kernel it is about."""
    for lib, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if found:
                kernel = short_name(found[1])
            elif "registers" in line or "spill" in line:
                print(f"  {lib}: {kernel}: {line.replace('ptxas info    :', '').strip()}")


def tensor_core_check(build) -> dict:
    """HMMA/HGMMA instructions per kernel in the flash, InfoNCE and IVF
    libraries' SASS; fails unless every bf16 flash forward, dq and dk/dv
    kernel, every InfoNCE forward and backward kernel and every IVF
    cell-scan kernel has some and the f32 flash ones have none."""
    def dump(lib):
        return subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=300, check=True).stdout

    counts = {}
    libs = ("flash_attention", "infonce", "ivf_cell_scores")
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one cuobjdump per library
        dumps = list(pool.map(dump, libs))
    for sass in dumps:
        kernel = None
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = short_name(line.split("Function :")[1].strip())
                counts.setdefault(kernel, 0)
            elif kernel and re.search(r"\bH(G)?MMA\b", line):
                counts[kernel] += 1
    print(f"sass: tensor-core instructions per kernel {json.dumps(counts)}", flush=True)
    for cp in INFONCE_WIDTHS:
        for name in ("infonce_fwd_mma_kernel", "infonce_bwd_mma_kernel"):
            check(counts.get(f"{name}<{cp}>", 0) > 0, f"{name}<{cp}> has no HMMA/HGMMA")
    for cp in IVF_WIDTHS:
        check(counts.get(f"cell_scores_mma_kernel<{cp}>", 0) > 0,
              f"cell_scores_mma_kernel<{cp}> has no HMMA/HGMMA")
    for d in (32, 64, 128):
        for name in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel"):
            check(counts.get(f"{name}<bf16, {d}>", 0) > 0, f"{name} D={d} has no HMMA/HGMMA")
        for name in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
            check(counts.get(f"{name}<f32, {d}>") == 0,
                  f"{name}<f32, {d}> missing or on the tensor cores: {counts.get(f'{name}<f32, {d}>')}")
    return counts


def skewed_probes(m, nprobe, gen, cells=20):
    """(m, nprobe) probe ids drawn from `cells` random cells of NLIST: the
    served features probe ~19 of 256."""
    hot = torch.randperm(NLIST, generator=gen, device="cuda")[:cells].int()
    return hot[torch.randint(0, cells, (m, nprobe), generator=gen, device="cuda")].contiguous()


def kernel_phase(ivf_scan):
    """The cell-scan kernel against its plain version at the path's shapes:
    uniform probes at m in {1, 8, 32, 128}; at m=128 every pair in one
    cell, probes from 20 cells, and every 5th id outside [0, NLIST) (NaN
    there, nowhere else); and the same bits on a second call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = torch.randn((NLIST, 2 * K // NLIST, DIM), generator=gen, device="cuda")
    cell_rows = rows / rows.norm(dim=-1, keepdim=True)
    cases = []
    for m in (1, 8, 32, 128):
        cases.append((f"uniform m={m}", m, torch.randint(
            0, NLIST, (m, NPROBE), generator=gen, device="cuda", dtype=torch.int32)))
    cases.append(("one cell m=128", 128,
                  torch.full((128, NPROBE), NLIST // 3, device="cuda", dtype=torch.int32)))
    cases.append(("skewed m=128", 128, skewed_probes(128, NPROBE, gen)))
    invalid = torch.randint(0, NLIST, (128, NPROBE), generator=gen, device="cuda",
                            dtype=torch.int32)
    every5 = torch.arange(0, invalid.numel(), 5, device="cuda")
    invalid.view(-1)[every5] = torch.where(every5 % 2 == 0, -1 - every5, NLIST + every5).int()
    cases.append(("invalid m=128", 128, invalid))
    worst = 0.0
    for what, m, probes in cases:
        q = torch.randn((m, DIM), generator=gen, device="cuda")
        q = q / q.norm(dim=-1, keepdim=True)
        got = ivf_scan.fused_cell_scores(q, cell_rows, probes)
        again = ivf_scan.fused_cell_scores(q, cell_rows, probes)
        torch.cuda.synchronize()
        bad = (probes < 0) | (probes >= NLIST)
        want = ivf_scan.fused_cell_scores_reference(q, cell_rows, probes.clamp(0, NLIST - 1))
        err = (got - want)[~bad].abs().max().item()
        nan_ok = torch.equal(got.isnan(), bad[:, :, None].expand_as(got))
        same = torch.equal(got.view(torch.int32), again.view(torch.int32))
        print(f"kernel ivf_cell_scores {what}: max_abs_err={err:.3g} "
              f"distinct_cells={int(torch.unique(probes[~bad]).numel())} "
              f"nan_exactly_at_invalid={nan_ok} same_bits={same}", flush=True)
        check(err <= SCORE_TOL, f"ivf_cell_scores {what} max |kernel - plain| = {err}")
        check(nan_ok, f"ivf_cell_scores {what}: NaN not exactly where a probe is out of range")
        check(same, f"ivf_cell_scores {what}: a second call gave other bits")
        worst = max(worst, err)
    return worst


def cell_scan_counts(probes, cell_rows):
    """What one cell-scan call must move and do, computed from its probes:
    the bound, the distinct cells and the bytes (for a plain-text line; the
    `kernels` line takes only the bound)."""
    (m, nprobe), (_, cell_cap, d) = probes.shape, cell_rows.shape
    distinct = int(torch.unique(probes).numel())
    bound, bound_by, bytes_, f32_fma = cell_scan_bound_ms(m, nprobe, cell_cap, d, distinct)
    return {"bound_ms": bound, "bound_by": bound_by, "distinct_cells": distinct,
            "bound_bytes": bytes_, "requested_bytes": m * nprobe * cell_cap * d * 4,
            "f32_fma_bound_ms": f32_fma}


def time_cell_scan(ivf_scan, q, cell_rows, probes):
    """The kernel's ms (CUDA events over back-to-back calls) and device ms
    (torch.profiler), the plain version's and the library call's, with the
    bound; and the call's counts."""
    m, nprobe = probes.shape
    _, cell_cap, d = cell_rows.shape
    gathered = cell_rows[probes.long()].reshape(m, nprobe * cell_cap, d)
    run = functools.partial(ivf_scan.fused_cell_scores, q, cell_rows, probes)
    counts = cell_scan_counts(probes, cell_rows)
    return {
        "ms": cuda_ms(run),
        "device_ms": kernel_device_ms(run, "cell_scores"),
        "plain_ms": cuda_ms(lambda: ivf_scan.fused_cell_scores_reference(q, cell_rows, probes)),
        "library_ms": cuda_ms(lambda: torch.bmm(gathered, q[:, :, None])),
        "bound_ms": counts["bound_ms"],
        "bound_by": counts["bound_by"],
    }, counts


def cell_scan_by_bucket(ivf_scan, feats, cell_rows, probes, buckets):
    """The kernel's ms and device ms with the bound at each bucket b (the
    first b rows of queries and probes); and each bucket's counts."""
    times, counts = {}, {}
    for b in buckets:
        bq, bp = feats[:b].contiguous(), probes[:b].contiguous()
        run = functools.partial(ivf_scan.fused_cell_scores, bq, cell_rows, bp)
        counts[b] = cell_scan_counts(bp, cell_rows)
        times[b] = {"ms": cuda_ms(run), "device_ms": kernel_device_ms(run, "cell_scores"),
                    "bound_ms": counts[b]["bound_ms"], "bound_by": counts[b]["bound_by"]}
    return times, counts


def ivf_timing_phase(ivf_scan, feats, cell_rows, probes, buckets, launches, max_err):
    """The cell-scan kernel timed on the served features' own probes and on
    uniform probes, whole and by bucket; its `kernels` entry. Run after every
    timing of the serving and training paths: the profiler it uses stays
    attached to the process."""
    path_timing, path_counts = time_cell_scan(ivf_scan, feats, cell_rows, probes)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    uniform = torch.randint(0, NLIST, probes.shape, generator=gen, device="cuda", dtype=torch.int32)
    uniform_timing, uniform_counts = time_cell_scan(ivf_scan, feats, cell_rows, uniform)
    path_by_bucket, path_bucket_counts = cell_scan_by_bucket(ivf_scan, feats, cell_rows, probes,
                                                             buckets)
    by_bucket, bucket_counts = cell_scan_by_bucket(ivf_scan, feats, cell_rows, uniform, buckets)
    for what, counts, per_bucket in (("path", path_counts, path_bucket_counts),
                                     ("uniform", uniform_counts, bucket_counts)):
        print(f"ivf_cell_scores {what} probes (computed, not measured; f32_fma_bound_ms is the "
              f"same products as f32 FMAs on the CUDA cores, bound_ms counts them split on the "
              f"TF32 tensor cores): {json.dumps(counts)}; by bucket {json.dumps(per_bucket)}",
              flush=True)
    return {
        "name": "ivf_cell_scores",
        "route": "cuda",
        "source": "moco_tpu_torch/csrc/ivf_cell_scores.cu",
        "replaces": "moco_tpu/serve/index.py:273",
        "launches": launches,
        "max_abs_err": max_err,
        "kernel_ms": path_timing["ms"],
        **path_timing,
        "by_bucket": path_by_bucket,
        "uniform_probes": {**uniform_timing, "by_bucket": by_bucket},
        "shape": {"m": probes.shape[0], "d": DIM, "nlist": NLIST, "cell_cap": cell_rows.shape[1],
                  "nprobe": NPROBE},
    }


def count_window(q, k, queue, t):
    """Per row, (lo, hi): the least and most negatives a count of
    `logit > pos` may report. lo counts the logits above pos by more than
    TIE_TOL in float64; hi adds the near ties within TIE_TOL of pos, where
    a float32 count may go either way."""
    pos = (q.double() * k.double()).sum(-1) / t
    diff = q.double() @ queue.double().T / t - pos[:, None]
    lo = (diff > TIE_TOL).sum(1)
    return lo, lo + (diff.abs() <= TIE_TOL).sum(1)


def acc_slack(lo, hi):
    """Per accuracy, the percent of rows whose count window straddles its
    cut (acc1: count == 0, acc5: count < 5): only there may two right
    counts disagree on it."""
    return {name: 100.0 * ((lo < top) & (hi >= top)).float().mean().item()
            for name, top in (("acc1", 1), ("acc5", 5))}


def compare_infonce(fi, q, k, queue, t, g_lse, what):
    """Both InfoNCE kernels against their plain versions on one input; the
    counts of both, on every row, inside the float64 count window."""
    pos, lse, above = fi.infonce_stats(q, k, queue, t)
    dq = fi.infonce_dq(q, queue, lse, g_lse, t)
    torch.cuda.synchronize()
    pos_p, lse_p, above_p = fi.infonce_stats_reference(q, k, queue, t)
    dq_p = fi.infonce_dq_reference(q, queue, lse_p, g_lse, t)
    lo, hi = count_window(q, k, queue, t)
    err = {
        "pos": (pos - pos_p).abs().max().item(), "lse": (lse - lse_p).abs().max().item(),
        "dq": (dq - dq_p).abs().max().item(), "dq_scale": dq_p.abs().max().item(),
        "near_tie_rows": int((hi > lo).sum()), "near_ties_max": int((hi - lo).max()),
        "count_mismatches": int((above != above_p).sum()),
        "count_max_diff": int((above - above_p).abs().max()),
        "outside_window": {"kernel": int(((above < lo) | (above > hi)).sum()),
                           "plain": int(((above_p < lo) | (above_p > hi)).sum())},
        "acc_slack": acc_slack(lo, hi),
    }
    print(f"kernel infonce {what}: {json.dumps(err)}", flush=True)
    check(err["pos"] <= POS_TOL, f"infonce_fwd {what}: pos off by {err['pos']}")
    check(err["lse"] <= LSE_TOL, f"infonce_fwd {what}: lse off by {err['lse']}")
    check(err["outside_window"] == {"kernel": 0, "plain": 0},
          f"infonce_fwd {what}: n_above outside its float64 window: {err['outside_window']}")
    check(err["dq"] <= 1e-4 * err["dq_scale"] + 1e-6, f"infonce_bwd {what}: dq off by {err['dq']}")
    return err


def infonce_kernel_phase(fi):
    """Both InfoNCE kernels against their plain versions: a small shape,
    the path's shape, an odd one, the widest, a width that is no multiple
    of 8 over more than one CTA's rows, and K of 1 and 7 (one partial
    tile); two calls giving the same bits; and the width limit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for b, kk, c in ((8, 4096, DIM), (256, K, DIM), (7, 1000, 20), (64, 8192, fi.MAX_C),
                     (300, 5000, 100), (8, 1, DIM), (8, 7, DIM)):
        q, k, queue = (torch.nn.functional.normalize(
            torch.randn(shape, generator=gen, device="cuda"), dim=-1)
            for shape in ((b, c), (b, c), (kk, c)))
        err = compare_infonce(fi, q, k, queue, 0.2, torch.full((b,), 1.0 / b, device="cuda"),
                              f"B={b} K={kk} C={c}")
        worst["fwd"] = max(worst["fwd"], err["pos"], err["lse"])
        worst["bwd"] = max(worst["bwd"], err["dq"])
        if (b, kk) == (256, K):  # no atomics: a second call gives the same bits
            g = torch.full((b,), 1.0 / b, device="cuda")
            first = fi.infonce_stats(q, k, queue, 0.2)
            again = fi.infonce_stats(q, k, queue, 0.2)
            dq1, dq2 = (fi.infonce_dq(q, queue, first[1], g, 0.2) for _ in range(2))
            check(all(torch.equal(x, y) for x, y in zip(first + (dq1,), again + (dq2,))),
                  "infonce kernels: two calls on the same inputs differ")
    wide = torch.zeros(2, fi.MAX_C + 4, device="cuda")
    try:
        fi.infonce_stats(wide, wide, torch.zeros(64, fi.MAX_C + 4, device="cuda"), 0.2)
    except ValueError as e:
        print(f"kernel infonce: C={fi.MAX_C + 4} refused as it must be ({e})", flush=True)
    else:
        raise RuntimeError(f"infonce_stats accepted C={fi.MAX_C + 4} > {fi.MAX_C}")
    return worst


def infonce_bound_ms(b, kk, c, backward, f32_fma=False):
    """Least time for one InfoNCE call: the bytes it must move (q, k or
    lse and g, the queue once; pos, lse and n_above or dq once) over the
    memory rate, against its products done f32-exact on the TF32 tensor
    cores (three split products each: 3 x 2BKC forward, 3 x 4BKC backward,
    which recomputes the scores) over the TF32 rate. Returns (ms, what
    bounds it); with `f32_fma` the products count once, as f32 FMAs over
    the f32 rate, the bound the CUDA-core kernels of earlier versions were
    held to."""
    if backward:
        bytes_, flops = 4 * (2 * b * c + kk * c + 2 * b), 4 * b * kk * c
    else:
        bytes_, flops = 4 * (2 * b * c + kk * c + 3 * b), 2 * b * kk * c
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS if f32_fma else 3 * flops / PEAK_TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel names it takes), first match wins
    ("flash_attention", ("flash_fwd_kernel", "flash_fwd_mma_kernel", "flash_dq_kernel",
                         "flash_dq_mma_kernel", "flash_dkv_kernel", "flash_dkv_mma_kernel")),
    ("infonce", ("infonce_fwd_mma_kernel", "fwd_merge_kernel", "infonce_bwd_mma_kernel",
                 "bwd_reduce_kernel")),
    ("batch_norm", ("batch_norm",)),
    ("conv_gemm", ("conv", "gemm", "sm90", "cutlass", "xmma", "cudnn", "wgrad", "dgrad",
                   "nvjet")),
)


def profile_step(train, cfg, dataset, state):
    """One whole train iteration (data, augment and step) under
    torch.profiler: the CUDA kernels' summed time by group and the top
    kernels, against the iteration's wall time (the rest is the card's idle
    share); None where the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = train(cfg, dataset=dataset, device="cuda", steps=1, state=state)["history"][0]
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        return None
    busy = sum(r[0] for r in rows)
    groups = {}
    for ms, _, name in rows:
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    return {"wall_ms": wall_ms, "data_ms": rec["data_ms"], "step_ms": rec["step_ms"],
            "kernel_ms": busy, "idle_share": 1.0 - busy / wall_ms, "kernel_ms_by_group": groups,
            "top": [{"ms": ms, "count": n, "kernel": name[:90]} for ms, n, name in rows[:12]]}


def ring_batches_check(cfg, dataset, state, steps=RING_CHECK_STEPS):
    """A short run of `cfg` through the prefetch ring on the card, from a
    copy of `state`: the step records each batch it is given (a clone on
    the consumer's stream, no host sync); afterwards each is held bit for
    bit against the synchronous `batch(epoch, step)` of a fresh pipeline.
    Returns the run's records."""
    import moco_tpu_torch.train as train_module
    from moco_tpu_torch.data.pipeline import TwoCropPipeline

    check(cfg.device_prefetch and state.step == 0, "the ring check runs the ring from step 0")
    got, make = [], train_module.make_train_step

    def recording(*args, **kw):
        step_fn = make(*args, **kw)

        def run(st, batch):
            got.append({k: v.clone() for k, v in batch.items()})
            return step_fn(st, batch)
        return run

    train_module.make_train_step = recording
    try:
        hist = train_module.train(cfg, dataset=dataset, device="cuda", steps=steps,
                                  state=copy.deepcopy(state))["history"]
    finally:
        train_module.make_train_step = make
    check(len(got) == steps, f"the ring delivered {len(got)} batches, want {steps}")
    with TwoCropPipeline(cfg.data, seed=cfg.seed, dataset=dataset, device="cuda") as pipe:
        for s, batch in enumerate(got):
            epoch, step = divmod(s, pipe.steps_per_epoch)
            want = pipe.batch(epoch, step)
            check(batch.keys() == want.keys() and all(torch.equal(batch[k], want[k]) for k in want),
                  f"the ring's batch {s} differs from batch({epoch}, {step})")
    print(f"ring check: {steps} batches delivered by the ring equal batch(epoch, step) bit for "
          f"bit ({'host crops' if pipe.host_crops else 'device crops'}, "
          f"{pipe.steps_per_epoch} steps per epoch)", flush=True)
    return hist


@contextlib.contextmanager
def eager_augment(on: bool):
    """While `on`, the pipeline's augment runs its transform eagerly on the
    card instead of replaying it from a CUDA graph: the ring's other
    design, timed beside it."""
    from moco_tpu_torch.data import pipeline

    call = pipeline._GraphedAugment.__call__
    if on:
        pipeline._GraphedAugment.__call__ = lambda self, *args: self._transform(*args)
    try:
        yield
    finally:
        pipeline._GraphedAugment.__call__ = call


def data_split(cfg, dataset, steps=6):
    """Sync mode's data time by stage, medians over `steps` batches after
    the first: host load (host clock of the loads into the pinned slot),
    H2D copy and augment (CUDA events around each on the current stream),
    the host's time to issue the augment, and beside them the augment's
    transform run eagerly on the same draws instead of replayed from its
    CUDA graph (device and issue ms)."""
    from moco_tpu_torch.data.augment import draw_recipe
    from moco_tpu_torch.data.pipeline import TwoCropPipeline

    def timed(fn):
        """(device ms by CUDA events, host ms to issue) of fn()."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        issue = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        return start.elapsed_time(end), issue

    rows = []
    with TwoCropPipeline(cfg.data, seed=cfg.seed, dataset=dataset, device="cuda") as pipe:
        for s in range(steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hb = pipe.host_batch(*divmod(s, pipe.steps_per_epoch))
            host = (time.perf_counter() - t0) * 1e3
            box = {}
            h2d, _ = timed(lambda: box.setdefault("raw", hb.views.to("cuda", non_blocking=True)))
            raw = box["raw"]
            aug, issue = timed(lambda: pipe.augment(hb, raw))
            gen = torch.Generator(device="cuda").manual_seed(hb.seed)
            recipe = pipe._nocrop if hb.precropped else pipe.recipe
            dq, dk = (draw_recipe(recipe, gen, raw.shape[0]) for _ in range(2))
            torch.cuda.synchronize()
            eager, eager_issue = timed(lambda: pipe._transform(hb.precropped, raw, dq, dk))
            hb.slots.release(hb.slot)
            rows.append((host, h2d, aug, issue, eager, eager_issue))
    med = [float(np.median(c)) for c in zip(*rows[1:])]
    return {"host_load_ms": med[0], "h2d_ms": med[1], "augment_ms": med[2],
            "augment_issue_ms": med[3], "augment_eager_ms": med[4],
            "augment_eager_issue_ms": med[5], "h2d_bytes": int(hb.views.numel()), "steps": steps}


def mode_summary(hist, warmup=TRAIN_WARMUP, timed=TRAIN_TIMED):
    """Medians over the timed steps of one mode's run."""
    timed = hist[warmup:warmup + timed]
    out = {k: float(np.median([r[k] for r in timed])) for k in ("imgs_per_s", "step_ms", "data_ms")}
    if "t_transfer" in timed[0]:
        out.update(t_transfer_ms=float(np.median([r["t_transfer"] for r in timed])) * 1e3,
                   transfer_bytes=timed[-1]["transfer_bytes"],
                   prefetch_depth_live=[r["prefetch_depth_live"] for r in timed])
    return out


def v2_run(fi, cfg, dataset, state, mode):
    """One phase-8 run of TRAIN_WARMUP + TRAIN_TIMED + V2_TAIL steps from `state`,
    with every check of phase 8; returns its history, launches, peak memory
    and the last step's (q, k, queue) with their kernel errors."""
    from moco_tpu_torch.ops.losses import l2_normalize
    from moco_tpu_torch.train import train

    m, t, b = cfg.moco.momentum, cfg.moco.temperature, cfg.data.global_batch
    leaf = "head.fc.2.weight"
    q0 = dict(state.encoder_q.named_parameters())[leaf].detach().clone()
    k0 = dict(state.encoder_k.named_parameters())[leaf].detach().clone()
    ema_err = []
    steps = TRAIN_WARMUP + TRAIN_TIMED + V2_TAIL
    # the last step's own (q, k, queue): the encoders' outputs as the step
    # computed them (hooks keep the latest), and the queue it read
    seen = {}
    hooks = [enc.register_forward_hook(lambda _m, _i, o, name=name: seen.__setitem__(name, o.detach()))
             for name, enc in (("q", state.encoder_q), ("k", state.encoder_k))]

    def on_step(rec):
        print(f"train {mode} step {json.dumps(rec)}", flush=True)
        if rec["step"] == 1:
            k1 = dict(state.encoder_k.named_parameters())[leaf].detach()
            ema_err.append((k1 - (k0 * m + q0 * (1.0 - m))).abs().max().item())
        if rec["step"] == steps - 1:
            seen["queue"] = state.queue.clone()

    torch.cuda.reset_peak_memory_stats()
    fi.infonce_stats.launches = fi.infonce_dq.launches = 0  # counts from here on are the path's
    t0 = time.perf_counter()
    out = train(cfg, dataset=dataset, device="cuda", steps=steps, state=state, log=on_step)
    wall_s = time.perf_counter() - t0
    launches = {"infonce_fwd": fi.infonce_stats.launches, "infonce_bwd": fi.infonce_dq.launches}
    for h in hooks:
        h.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train path ({mode}): {steps} steps in {wall_s:.1f} s; launches {launches}; "
          f"peak memory {peak_gb:.1f} GB", flush=True)

    # -- checks -------------------------------------------------------------
    hist = out["history"]
    check(len(hist) == steps and all(np.isfinite(r["loss"]) for r in hist), f"{mode}: finite losses")
    check(launches == {"infonce_fwd": steps, "infonce_bwd": steps},
          f"{mode}: InfoNCE kernels not launched once per step: {launches} over {steps} steps")
    check(state.queue_ptr == (steps * b) % K, f"{mode}: queue_ptr {state.queue_ptr}")
    check(ema_err and ema_err[0] <= 1e-6, f"{mode}: params_k after step 1 is not the EMA: {ema_err}")
    q_n, k_n, queue_n = l2_normalize(seen["q"].float()), l2_normalize(seen["k"].float()), seen["queue"]
    check(state.queue_ptr >= b, f"{mode}: queue_ptr {state.queue_ptr} wrapped inside the run")
    written = state.queue[state.queue_ptr - b:state.queue_ptr]
    key_err = (written - k_n).abs().max().item()
    norm_err = (written.norm(dim=1) - 1).abs().max().item()
    check(key_err <= 1e-6 and norm_err <= 1e-5,
          f"{mode}: last written queue rows vs the last step's keys: {key_err}, norms {norm_err}")
    # the last step's own inputs, through the kernels and the plain versions
    path_err = compare_infonce(fi, q_n, k_n, queue_n, t, torch.full((b,), 1.0 / b, device="cuda"),
                               f"on the path's last step ({mode})")
    qg = q_n.clone().requires_grad_(True)
    loss, acc = fi.fused_infonce_loss(qg, k_n, queue_n, t)
    loss.backward()
    qd = q_n.clone().requires_grad_(True)
    logits = torch.cat([(qd * k_n).sum(-1, keepdim=True), qd @ queue_n.T], 1) / t
    loss_p = torch.nn.functional.cross_entropy(logits, torch.zeros(b, dtype=torch.long, device="cuda"))
    loss_p.backward()
    rank = (logits[:, 1:] > logits[:, :1]).sum(1)
    slack = path_err["acc_slack"]
    acc_err = {"acc1": abs(acc["acc1"].item() - 100.0 * (rank == 0).float().mean().item()),
               "acc5": abs(acc["acc5"].item() - 100.0 * (rank < 5).float().mean().item())}
    grad_err, grad_scale = (qg.grad - qd.grad).abs().max().item(), qd.grad.abs().max().item()
    print(f"train path kernels vs plain ({mode}): loss {loss.item():.6f} vs {loss_p.item():.6f}, "
          f"acc {acc_err} (slack {slack}), dq {grad_err:.3g} of {grad_scale:.3g}", flush=True)
    check(abs(loss.item() - loss_p.item()) <= LSE_TOL, f"{mode}: path loss through the kernels")
    check(all(acc_err[n] <= slack[n] + 1e-9 for n in acc_err),
          f"{mode}: path accuracies off beyond the rows a near tie can flip: {acc_err}, slack {slack}")
    check(grad_err <= 1e-4 * grad_scale + 1e-6, f"{mode}: path dq through the kernels off by {grad_err}")
    return {"hist": hist, "launches": launches, "peak_gb": peak_gb, "path_err": path_err,
            "q_n": q_n, "k_n": k_n, "queue_n": queue_n, "steps_per_epoch": out["steps_per_epoch"]}


def seeded_encoder(moco, seed: int) -> tuple:
    """convert.random_flax_encoder(moco, seed), drawn once per process for
    the fields it reads (state_from_flax copies, never writes, the arrays)."""
    from moco_tpu_torch.convert import random_flax_encoder

    key = (moco.arch, moco.dim, moco.mlp, moco.v3, moco.cifar_stem, moco.vit_patch_size,
           moco.vit_pool, seed)
    if key not in _SEEDED:
        _SEEDED[key] = random_flax_encoder(moco, seed=seed)
    return _SEEDED[key]


_SEEDED: dict = {}  # seeded_encoder's draws in this process


def seeded_v2_state(cfg, world=None, device="cuda"):
    """A v1/v2 train state of `cfg` on the card from seeded Flax-layout
    weights (the key encoder from the next seed) and a seeded unit-row
    queue, through convert.state_from_flax (SyncBNs over `world`)."""
    from moco_tpu_torch.convert import state_from_flax

    params_q, stats_q = seeded_encoder(cfg.moco, SEED)
    params_k, stats_k = seeded_encoder(cfg.moco, SEED + 1)
    queue = np.random.default_rng(SEED + 2).standard_normal((K, DIM)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=1, keepdims=True)
    return state_from_flax(cfg, {
        "step": 0, "params_q": params_q, "batch_stats_q": stats_q, "params_k": params_k,
        "batch_stats_k": stats_k, "queue": queue, "queue_ptr": 0}, device=device, world=world)


def train_phase(fi):
    """The training path at full width (phase 8), in sync and ring mode, and
    its timings (phase 9)."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS["imagenet_v2"]
    # the probe waits around every step, so each record has its step_ms
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"),
                              obs_probe_every=1)
    t, b = cfg.moco.temperature, cfg.data.global_batch
    check((cfg.moco.arch, cfg.moco.mlp, cfg.moco.num_negatives, cfg.moco.dim, b,
           cfg.data.image_size, cfg.data.aug_plus, cfg.moco.compute_dtype, t, cfg.device_prefetch,
           cfg.prefetch_depth)
          == ("resnet50", True, K, DIM, 256, IMG, True, "bfloat16", 0.2, True, 2), "imagenet_v2 preset")
    state = seeded_v2_state(cfg)
    # what build_dataset("synthetic") gives, with epochs of 20 steps, so a
    # run's 18 steps stay in one epoch's ring
    dataset = SyntheticDataset(num_examples=b * EPOCH_STEPS, image_size=IMG)
    ring_batches_check(cfg, dataset, state)
    host_crop_state = copy.deepcopy(state)
    runs = {}
    for mode in ("sync", "ring_eager", "ring"):  # the same seeded state and data in each
        c = dataclasses.replace(cfg, device_prefetch=mode != "sync")
        if mode == "ring":  # 12m(d): strict tracing on the default path
            c = dataclasses.replace(c, strict_tracing=True,
                                    recompile_warmup_steps=STRICT_WARMUP_STEPS)
        with eager_augment(mode == "ring_eager"):
            runs[mode] = v2_run(fi, c, dataset, state if mode == "ring" else copy.deepcopy(state),
                                mode)
    strict = strict_tracing_check(runs["ring"]["hist"], "8 ring")
    split = data_split(cfg, dataset)
    check(runs["sync"]["launches"] == runs["ring"]["launches"], "launches differ between the modes")
    loss_gap = max(abs(a["loss"] - c["loss"]) for a, c in zip(runs["sync"]["hist"], runs["ring"]["hist"]))
    print(f"train: sync and ring losses differ by at most {loss_gap:.3g} over "
          f"{len(runs['ring']['hist'])} steps", flush=True)
    host_crop = host_crop_phase(fi, cfg, host_crop_state)

    # -- timing (the ring run: the default path) ----------------------------
    ring = runs["ring"]
    hist, launches, path_err = ring["hist"], ring["launches"], ring["path_err"]
    q_n, k_n, queue_n = ring["q_n"], ring["k_n"], ring["queue_n"]
    timed = hist[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
    step_ms = float(np.median([r["step_ms"] for r in timed]))
    data_ms = float(np.median([r["data_ms"] for r in timed]))
    imgs_s = float(np.median([r["imgs_per_s"] for r in timed]))
    lse_n = fi.infonce_stats(q_n, k_n, queue_n, t)[1]
    g = torch.full((b,), 1.0 / b, device="cuda")
    pos_n = (q_n * k_n).sum(-1)

    def library_fwd():
        neg = q_n @ queue_n.T / t
        pos = pos_n[:, None] / t
        return torch.logsumexp(torch.cat([pos, neg], 1), 1), (neg > pos).sum(1)

    def library_bwd():
        logits = torch.cat([pos_n[:, None], q_n @ queue_n.T], 1) / t
        return (torch.softmax(logits, 1)[:, 1:] * g[:, None]) @ queue_n / t

    kernels = []
    for name, fn, plain, lib, backward, err, src_line in (
        ("infonce_fwd", lambda: fi.infonce_stats(q_n, k_n, queue_n, t),
         lambda: fi.infonce_stats_reference(q_n, k_n, queue_n, t), library_fwd, False,
         path_err, 40),
        ("infonce_bwd", lambda: fi.infonce_dq(q_n, queue_n, lse_n, g, t),
         lambda: fi.infonce_dq_reference(q_n, queue_n, lse_n, g, t), library_bwd, True,
         path_err, 71),
    ):
        bound, bound_by = infonce_bound_ms(b, K, DIM, backward)
        print(f"kernel {name}: f32_fma_bound_ms="
              f"{infonce_bound_ms(b, K, DIM, backward, f32_fma=True)[0]} (the same products as"
              f" f32 FMAs on the CUDA cores; bound_ms={bound} counts them split on the TF32"
              f" tensor cores)", flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": "moco_tpu_torch/csrc/infonce.cu",
            "replaces": f"moco_tpu/ops/fused_infonce.py:{src_line}",
            "launches": launches[name],
            "max_abs_err": max(err["dq"] if backward else max(err["pos"], err["lse"]),
                               (runs["sync"]["path_err"]["dq"] if backward else
                                max(runs["sync"]["path_err"]["pos"], runs["sync"]["path_err"]["lse"]))),
            "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain), "bound_ms": bound,
            "bound_by": bound_by, "library_ms": cuda_ms(lib),
            "library": ("logsumexp(cat([pos, q @ queue.T / T])) + (neg > pos).sum" if not backward
                        else "softmax(cat([pos, q @ queue.T]) / T)[:, 1:] @ queue / T"),
            "shape": {"B": b, "K": K, "C": DIM},
        })
    share = (kernels[0]["ms"] + kernels[1]["ms"]) / step_ms
    timing = {"step_ms_median": step_ms, "data_ms_median": data_ms, "imgs_per_s_median": imgs_s,
              "sync": {**mode_summary(runs["sync"]["hist"]), "data_split": split},
              "ring": mode_summary(hist), "sync_ring_loss_max_abs_diff": loss_gap,
              "ring_eager_augment": mode_summary(runs["ring_eager"]["hist"]),
              "infonce_share_of_step": share, "peak_memory_gb": ring["peak_gb"],
              "peak_memory_gb_sync": runs["sync"]["peak_gb"], "steps_timed": len(timed), "batch": b,
              "host_crop": host_crop, "strict_tracing": strict,
              "profile": profile_step(train, cfg, dataset, state)}
    print(f"train timing: {json.dumps(timing)}", flush=True)
    return kernels, timing


def strict_tracing_check(hist, what: str) -> dict:
    """12m(d): a strict_tracing run's `compile_cache_misses` (the augment's
    CUDA-graph captures since the run began) on its log steps' records: at
    least one capture, the same count on every log step (none after the
    warm-up), and the run returned (a capture after the warm-up aborts it)."""
    seen = [(r["step"], r["compile_cache_misses"]) for r in hist if "compile_cache_misses" in r]
    print(f"12m(d) {what}: compile_cache_misses by log step {seen}", flush=True)
    check(len(seen) >= 2 and seen[-1][0] > STRICT_WARMUP_STEPS,
          f"12m(d) {what}: compile_cache_misses on the log steps {seen}")
    check(seen[0][1] >= 1 and len({n for _, n in seen}) == 1,
          f"12m(d) {what}: compile_cache_misses not flat after warm-up: {seen}")
    return {"compile_cache_misses": seen, "recompile_warmup_steps": STRICT_WARMUP_STEPS}


def host_crop_phase(fi, cfg, state, n_images=256, steps=RING_CHECK_STEPS):
    """Phase 8b: seeded images of varied geometry, JPEG and PNG, written to
    a temporary ImageFolder; build_dataset with a cache dir decodes them
    once into the packed RGB cache; `steps` v2 steps through the ring take
    host crops from it (bit-equal to batch(0, s), InfoNCE once per step).
    The crops go through the native raw loader where it builds and through
    PIL otherwise; the line says which."""
    import tempfile

    from PIL import Image

    from moco_tpu_torch.data.cache import PackedRGBCacheDataset
    from moco_tpu_torch.data.datasets import build_dataset
    from moco_tpu_torch.data.native_loader import native_available

    rng = np.random.default_rng(SEED + 3)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "folder")
        for i in range(n_images):
            cls = os.path.join(root, f"class_{i % 4}")
            os.makedirs(cls, exist_ok=True)
            h, w = (int(x) for x in rng.integers(160, 400, 2))
            coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
            img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
            img.save(os.path.join(cls, f"{i}.jpg" if i % 2 else f"{i}.png"), quality=90)
        write_s = time.perf_counter() - t0
        data = dataclasses.replace(cfg.data, dataset="imagefolder", data_dir=root,
                                   cache_dir=os.path.join(tmp, "cache"), num_workers=8)
        hcfg = dataclasses.replace(cfg, data=data)
        t0 = time.perf_counter()
        ds = build_dataset(data.dataset, data.data_dir, data.image_size,
                           num_workers=data.num_workers, cache_dir=data.cache_dir)
        cache_s = time.perf_counter() - t0
        check(isinstance(ds, PackedRGBCacheDataset) and len(ds) == n_images,
              f"the image folder did not build the packed RGB cache: {type(ds).__name__}")
        check(ds.dims(np.arange(n_images)).min() >= 160, "cached image geometry")
        fi.infonce_stats.launches = fi.infonce_dq.launches = 0
        hist = ring_batches_check(hcfg, ds, state, steps)
        launches = {"infonce_fwd": fi.infonce_stats.launches, "infonce_bwd": fi.infonce_dq.launches}
    check(all(np.isfinite(r["loss"]) for r in hist), "host-crop steps: finite losses")
    check(launches == {"infonce_fwd": steps, "infonce_bwd": steps},
          f"host-crop steps: InfoNCE launches {launches} over {steps} steps")
    out = {"images": n_images, "write_s": write_s, "cache_build_s": cache_s,
           "crop_backend": "native" if ds._native is not None else "PIL",
           "native_loader_available": native_available(), "launches": launches,
           "data_ms": [r["data_ms"] for r in hist], "step_ms": [r["step_ms"] for r in hist],
           "losses": [r["loss"] for r in hist]}
    print(f"host-crop path: {json.dumps(out)}", flush=True)
    return out


FLASH = (  # (kernel, wrapper, line of the TPU kernel in moco_tpu/ops/flash_attention.py)
    ("flash_fwd", "flash_forward", 73), ("flash_dq", "flash_dq", 177),
    ("flash_dkv", "flash_dkv", 225))


def flash_launches(fa) -> dict:
    return {name: getattr(fa, fn).launches for name, fn, _ in FLASH}


def flash_kernel_launches(fa) -> dict:
    """Launches by CUDA kernel (each dtype's) of the three wrappers."""
    return {k: n for _, fn, _ in FLASH for k, n in getattr(fa, fn).kernel_launches.items()}


def compare_flash(fa, q, k, v, g, g_lse, what):
    """The three flash kernels against their plain versions on one input
    (the plain versions in f32 on the same values), with phase 10's
    tolerances; returns {output: (max |kernel - plain|, tolerance)}."""
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward(q, k, v, scale)
    coeff = fa.backward_coeff(out, g, g_lse)
    dq = fa.flash_dq(q, k, v, g, lse, coeff, scale)
    dk, dv = fa.flash_dkv(q, k, v, g, lse, coeff, scale)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, g)]
    out_p, lse_p = fa.attention_reference(*f[:3], scale)
    dq_p = fa.flash_dq_reference(*f, lse, coeff, scale)
    dk_p, dv_p = fa.flash_dkv_reference(*f, lse, coeff, scale)
    got = {"out": (out, out_p), "dq": (dq, dq_p), "dk": (dk, dk_p), "dv": (dv, dv_p)}
    if q.dtype == torch.float32:
        tol = {n: (1e-5 if n == "out" else 1e-4) * w.abs().max().item() + 1e-6
               for n, (_, w) in got.items()}
    else:
        tol = {n: BF16_REL * t + 1e-6 for n, t in fa.abs_term_sums(*f, lse, coeff, scale).items()}
    errs = {"lse": ((lse - lse_p).abs().max().item(), 1e-5)}
    errs.update({n: ((a.float() - b).abs().max().item(), tol[n]) for n, (a, b) in got.items()})
    # each tolerance as a share of its output's largest value: a kernel off
    # by more than that share of the output fails
    share = {n: tol[n] / w.abs().max().item() for n, (_, w) in got.items()}
    print(f"kernel flash {what}: " + json.dumps(
        {n: {"err": e, "tol": t, **({"tol_share": share[n]} if n in share else {})}
         for n, (e, t) in errs.items()}), flush=True)
    for name, (err, t) in errs.items():
        check(err <= t, f"flash {what}: {name} off by {err} > {t}")
    for name, s in share.items():
        check(s <= TOL_SHARE, f"flash {what}: {name}'s tolerance is {s:.3g} of its largest value")
    return errs


def flash_worst(errs) -> dict:
    """The largest error of each kernel: forward (out, lse), dq, dk/dv."""
    return {"flash_fwd": max(errs["out"][0], errs["lse"][0]), "flash_dq": errs["dq"][0],
            "flash_dkv": max(errs["dk"][0], errs["dv"][0])}


def flash_kernel_phase(fa):
    """Phase 10: the three flash kernels against their plain versions, and
    what they refuse."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = dict.fromkeys((name for name, _, _ in FLASH), 0.0)
    bf16, f32 = torch.bfloat16, torch.float32
    for b, h, s, d, dtype in ((8, 12, 197, 64, bf16), (8, 12, 197, 64, f32), (2, 3, 145, 64, f32),
                              (1, 2, 1000, 32, f32), (4, 4, 65, 128, bf16),
                              # the tensor-core kernels' edges: one partial 16-row
                              # chunk, a tail of 1, many ring stages, no tail, D = 128
                              (2, 3, 1, 64, bf16), (2, 3, 17, 64, bf16), (1, 2, 1000, 32, bf16),
                              (2, 4, 64, 64, bf16), (2, 4, 197, 128, bf16),
                              # B*H = 66000 > 65535: ViT-B at 128 px, batch 5500
                              (5500, 12, 65, 64, bf16), (5500, 12, 65, 64, f32)):
        q, k, v, g = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        g_lse = torch.randn((b, h, s), generator=gen, device="cuda")
        errs = compare_flash(fa, q, k, v, g, g_lse, f"B={b} H={h} S={s} D={d} {dtype}")
        worst = {n: max(worst[n], e) for n, e in flash_worst(errs).items()}
        del q, k, v, g, g_lse
    torch.cuda.empty_cache()
    x = torch.zeros(1, 2, 8, 64, device="cuda")
    for what, args in (("D=48", [torch.zeros(1, 2, 8, 48, device="cuda")] * 3),
                       ("float16", [x.half()] * 3), ("a CPU/CUDA mix", [x, x.cpu(), x])):
        try:
            fa.flash_forward(*args, 1.0)
        except ValueError as e:
            print(f"kernel flash: {what} refused as it must be ({e})", flush=True)
        else:
            raise RuntimeError(f"flash_forward accepted {what}")
    return worst


def flash_bound_ms(kind, bh, s, d, itemsize):
    """Least time for one flash call at the path's shape: its (B*H, S, D)
    blocks read or written once (forward: q, k, v in, out out; dq: q, k, v,
    g in, dq out; dk/dv: q, k, v, g in, dk and dv out) and its (B*H, S) f32
    rows (lse out; lse and coeff in) over the memory rate, against its
    matrix products (4, 6 and 8 S^2 D flops per head: q.k^T and p.v; plus
    g.v^T and ds.k; plus p^T.g and ds^T.q) over the bf16 tensor rate."""
    blocks, rows, flops = {"flash_fwd": (4, 1, 4), "flash_dq": (5, 2, 6),
                           "flash_dkv": (6, 2, 8)}[kind]
    bytes_ = blocks * bh * s * d * itemsize + rows * bh * s * 4
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops * bh * s * s * d / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def set_flash(encoder, on: bool) -> None:
    """Route every attention of `encoder` through the flash kernels or the
    dense path (the parameters are the same either way)."""
    from moco_tpu_torch.models.vit import MultiHeadAttention

    for m in encoder.modules():
        if isinstance(m, MultiHeadAttention):
            m.use_flash_attention = on


def v3_run(fa, cfg, dataset, state, mode):
    """One phase-11 run of TRAIN_WARMUP + TRAIN_TIMED steps from `state`,
    with the checks of phase 11 that a run makes: finite losses, launches by
    wrapper and by kernel, the frozen patch embedding, the EMA after step 1,
    and the last step's first query-side block through the kernels against
    the plain versions. Returns its history, launches, peak memory, block
    errors and the captured block."""
    from moco_tpu_torch.models import vit
    from moco_tpu_torch.train import train

    m = cfg.moco
    leaf = "head.fc2.weight"
    q0 = dict(state.encoder_q.named_parameters())[leaf].detach().clone()
    k0 = dict(state.encoder_k.named_parameters())[leaf].detach().clone()
    patch0 = state.encoder_q.backbone.patch_embed.weight.detach().clone()
    steps = TRAIN_WARMUP + TRAIN_TIMED
    ema_err, seen = [], {"armed": False}
    kernel_attention = vit.flash_attention

    # the last step's first query-side block: its q, k, v and, in the
    # backward, the gradient g of its output, as the step computed them
    def capture(q, k, v, scale=None):
        out = kernel_attention(q, k, v, scale)
        if seen["armed"] and q.requires_grad:
            seen.update(armed=False, q=q.detach(), k=k.detach(), v=v.detach())
            out.register_hook(lambda g: seen.__setitem__("g", g.detach().contiguous()))
        return out

    def on_step(rec):
        print(f"v3 train {mode} step {json.dumps(rec)}", flush=True)
        if rec["step"] == 1:
            k1 = dict(state.encoder_k.named_parameters())[leaf].detach()
            ema_err.append((k1 - (k0 * m.momentum + q0 * (1.0 - m.momentum))).abs().max().item())
        seen["armed"] = rec["step"] == steps - 1

    vit.flash_attention = capture
    torch.cuda.reset_peak_memory_stats()
    for _, fn, _ in FLASH:  # counts from here on are the path's
        wrapper = getattr(fa, fn)
        wrapper.launches = 0
        wrapper.kernel_launches = dict.fromkeys(wrapper.kernel_launches, 0)
    t0 = time.perf_counter()
    try:
        out = train(cfg, dataset=dataset, device="cuda", steps=steps, state=state, log=on_step)
    finally:
        vit.flash_attention = kernel_attention
    wall_s = time.perf_counter() - t0
    launches, by_kernel = flash_launches(fa), flash_kernel_launches(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"v3 path ({mode}): {steps} steps in {wall_s:.1f} s; launches {launches}, by kernel "
          f"{by_kernel}; peak memory {peak_gb:.1f} GB", flush=True)

    # -- checks -------------------------------------------------------------
    hist = out["history"]
    check(len(hist) == steps and all(np.isfinite(r["loss"]) for r in hist),
          f"v3 {mode}: finite losses")
    depth = len(state.encoder_q.backbone.blocks)
    want = {"flash_fwd": 2 * depth * steps, "flash_dq": depth * steps, "flash_dkv": depth * steps}
    check(launches == want, f"v3 {mode}: flash launches {launches} over {steps} steps, want {want}")
    want_kernels = {"flash_fwd_kernel": 0, "flash_fwd_mma_kernel": want["flash_fwd"],
                    "flash_dq_kernel": 0, "flash_dq_mma_kernel": want["flash_dq"],
                    "flash_dkv_kernel": 0, "flash_dkv_mma_kernel": want["flash_dkv"]}
    check(by_kernel == want_kernels,
          f"v3 {mode}: flash launches by kernel {by_kernel}, want {want_kernels}")
    check(torch.equal(state.encoder_q.backbone.patch_embed.weight, patch0),
          f"v3 {mode}: the frozen patch embedding moved")
    check(ema_err and ema_err[0] <= 1e-6, f"v3 {mode}: params_k after step 1 is not the EMA: {ema_err}")
    check("g" in seen, f"v3 {mode}: the last step's attention block was not captured")
    q, k, v, g = seen["q"], seen["k"], seen["v"], seen["g"]
    # the step's g is tiny (a loss averaged over 512 rows, 12 blocks deep):
    # scaled by a power of two to a largest |g| in [0.5, 1), exactly, so the
    # gradients (linear in g, with a zero lse cotangent) reach the sizes
    # phase 10's tolerances are stated for
    g = g * 2.0 ** -float(np.frexp(g.abs().max().item())[1])
    path_errs = compare_flash(fa, q, k, v, g, torch.zeros(q.shape[:3], device="cuda"),
                              f"on the path's last step ({mode}) {tuple(q.shape)} {q.dtype}")
    return {"hist": hist, "launches": launches, "peak_gb": peak_gb, "errs": flash_worst(path_errs),
            "block": (q, k, v, g), "steps_per_epoch": out["steps_per_epoch"]}


class PlainAttention(torch.autograd.Function):
    """The port's plain attention (ops/flash_attention.py
    `attention_reference` forward, `flash_backward_reference` backward) as
    an autograd function on the card: f64 logits, p and dS, each rounded
    once, only q, k, v, out and lse kept for the backward. The reference of
    the v3 attention check."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        from moco_tpu_torch.ops import flash_attention as fa

        out, lse = fa.attention_reference(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        from moco_tpu_torch.ops import flash_attention as fa

        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_backward_reference(q, k, v, out, lse, g.to(q.dtype),
                                                 torch.zeros_like(lse), ctx.scale)
        return dq, dk, dv, None


def attention_check(fa, cfg, state, batch, steps_per_epoch, label):
    """Phase 11's attention check on one state: one more v3 step on copies of
    `state` and `batch`, with every attention through the kernels, through
    the plain attention (f32-level logits, `PlainAttention`, the reference)
    and through two wrong attentions (controls: every key alike, and the
    kernels without the 1/sqrt(Dh) scale), with the query encoder's
    features on the same images beside each loss. The kernels must agree
    with the reference within LOSS_REL (relative) and FEAT_REL (of the
    features' largest value); every control must fail a check, and every
    check must fail on a control. Returns the losses and gaps."""
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.models import vit

    kernel_attention = vit.flash_attention

    def plain(q, k, v, scale=None):
        return PlainAttention.apply(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)

    variants = {"flash": kernel_attention, "plain": plain,
                "uniform": lambda q, k, v, scale=None: v.mean(2, keepdim=True).expand_as(v),
                "unscaled": lambda q, k, v, scale=None: kernel_attention(q, k, v, 1.0)}
    losses, feats = {}, {}
    for name, attention in variants.items():
        copy_ = copy.deepcopy(state)
        set_flash(copy_.encoder_q, True)
        set_flash(copy_.encoder_k, True)
        vit.flash_attention = attention
        try:
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                feats[name] = copy_.encoder_q.backbone(batch["im_q"]).float()
            losses[name] = make_train_step(cfg, steps_per_epoch, device="cuda")(
                copy_, batch)["loss"].item()
        finally:
            vit.flash_attention = kernel_attention
        del copy_
        torch.cuda.empty_cache()
    scale_f = feats["plain"].abs().max().item()
    rel = {n: {"loss": abs(losses[n] - losses["plain"]) / abs(losses["plain"]),
               "features": (feats[n] - feats["plain"]).abs().max().item() / scale_f}
           for n in variants if n != "plain"}
    print(f"v3 attention check ({label} state, step {state.step}): losses {json.dumps(losses)}; "
          f"against the plain attention, relative {json.dumps(rel)} (tolerances: loss "
          f"{LOSS_REL}, features {FEAT_REL})", flush=True)
    check(rel["flash"]["loss"] <= LOSS_REL,
          f"{label}: flash and plain-attention v3 losses differ by {rel['flash']}")
    check(rel["flash"]["features"] <= FEAT_REL,
          f"{label}: flash and plain-attention v3 features differ by {rel['flash']}")
    caught = {n: {c for c, tol in (("loss", LOSS_REL), ("features", FEAT_REL)) if rel[n][c] > tol}
              for n in ("uniform", "unscaled")}
    check(all(caught.values()), f"{label}: a control passes both checks meant to catch it: {caught}")
    check(set().union(*caught.values()) == {"loss", "features"},
          f"{label}: a check that no control fails: {caught}")
    return {"step": state.step, "losses": losses, "relative_to_plain": rel}


def seeded_v3_state(cfg, world=None, device="cuda"):
    """A v3 train state of `cfg` on the card from seeded Flax-layout weights
    (the key encoder and the predictor from the next seeds), through
    convert.state_from_flax (its heads' SyncBNs over `world`)."""
    from moco_tpu_torch.convert import random_flax_predictor, state_from_flax

    params_q, stats_q = seeded_encoder(cfg.moco, SEED)
    params_k, stats_k = seeded_encoder(cfg.moco, SEED + 1)
    params_p, stats_p = random_flax_predictor(cfg.moco, seed=SEED + 2)
    return state_from_flax(cfg, {
        "step": 0, "params_q": params_q, "batch_stats_q": stats_q, "params_k": params_k,
        "batch_stats_k": stats_k, "params_pred": params_p, "batch_stats_pred": stats_p},
        device=device, world=world)


def v3_phase(fa, flash_err):
    """The v3 path at full width (phase 11), in sync and ring mode, and its
    timings (phase 12)."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    preset = PRESETS["vit_b16_v3"]
    m = preset.moco
    check((m.arch, m.dim, m.v3, m.num_negatives, m.momentum, m.momentum_cos, m.temperature,
           preset.optim.optimizer, preset.data.image_size, preset.data.global_batch, m.compute_dtype)
          == ("vit_b16", 256, True, 0, 0.99, True, 0.2, "adamw", IMG, 4096, "bfloat16"),
          "vit_b16_v3 preset")
    cfg = dataclasses.replace(
        preset, moco=dataclasses.replace(m, vit_flash_attention=True),
        data=dataclasses.replace(preset.data, dataset="synthetic", global_batch=V3_BATCH),
        obs_probe_every=1)  # a wait around every step: each record has its step_ms
    print(f"v3 path: vit_b16_v3 with vit_flash_attention=True; cut: global batch "
          f"{preset.data.global_batch} -> {V3_BATCH}", flush=True)
    state = seeded_v3_state(cfg)
    # the 1024 images of build_dataset("synthetic"), epochs of 4 steps
    dataset = SyntheticDataset(image_size=IMG)
    ring_batches_check(cfg, dataset, state)
    seeded = copy.deepcopy(state)  # the attention check's first state
    runs = {}
    for mode in ("sync", "ring"):  # the same seeded state and data in each
        runs[mode] = v3_run(fa, dataclasses.replace(cfg, device_prefetch=mode == "ring"), dataset,
                            copy.deepcopy(state) if mode == "sync" else state, mode)
        torch.cuda.empty_cache()
    split = data_split(cfg, dataset)
    check(runs["sync"]["launches"] == runs["ring"]["launches"], "v3 launches differ between the modes")
    loss_gap = max(abs(a["loss"] - c["loss"]) for a, c in zip(runs["sync"]["hist"], runs["ring"]["hist"]))
    print(f"v3: sync and ring losses differ by at most {loss_gap:.3g} over "
          f"{len(runs['ring']['hist'])} steps", flush=True)
    for r in runs.values():
        flash_err = {n: max(flash_err[n], e) for n, e in r["errs"].items()}
    ring = runs["ring"]
    hist, launches, (q, k, v, g) = ring["hist"], ring["launches"], ring["block"]
    steps = len(hist)
    with TwoCropPipeline(cfg.data, seed=cfg.seed + 1, dataset=dataset, device="cuda") as pipe:
        batch = pipe.batch(0, 0)
    checks = {label: attention_check(fa, cfg, st, batch, ring["steps_per_epoch"], label)
              for label, st in (("seeded", seeded), ("trained", state))}
    del seeded
    torch.cuda.empty_cache()

    # -- timing (the ring run: the default path) ------------------------------
    timed = hist[TRAIN_WARMUP:]
    step_ms = float(np.median([r["step_ms"] for r in timed]))
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_forward(q, k, v, scale)
    coeff = fa.backward_coeff(o, g, torch.zeros_like(lse))
    qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    library_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g, retain_graph=True),
                          iters=20)
    bh, s, d = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    # the same block in f32, through the CUDA-core kernels
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    o_f, lse_f = fa.flash_forward(qf, kf, vf, scale)
    coeff_f = fa.backward_coeff(o_f, gf, torch.zeros_like(lse_f))
    f32_runs = (lambda: fa.flash_forward(qf, kf, vf, scale),
                lambda: fa.flash_dq(qf, kf, vf, gf, lse_f, coeff_f, scale),
                lambda: fa.flash_dkv(qf, kf, vf, gf, lse_f, coeff_f, scale))
    entry = {"flash_fwd": "flash_attention_fwd", "flash_dq": "flash_attention_dq",
             "flash_dkv": "flash_attention_dkv"}
    kernels = []
    for (name, fn, line), run, plain, library, f32_run in zip(FLASH, (
            lambda: fa.flash_forward(q, k, v, scale),
            lambda: fa.flash_dq(q, k, v, g, lse, coeff, scale),
            lambda: fa.flash_dkv(q, k, v, g, lse, coeff, scale)), (
            lambda: fa.attention_reference(q, k, v, scale),
            lambda: fa.flash_dq_reference(q, k, v, g, lse, coeff, scale),
            lambda: fa.flash_dkv_reference(q, k, v, g, lse, coeff, scale)), (
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), None, None),
            f32_runs):
        bound, bound_by = flash_bound_ms(name, bh, s, d, q.element_size())
        kernels.append({
            "name": name, "route": "cuda", "source": "moco_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"moco_tpu/ops/flash_attention.py:{line}", "launches": launches[name],
            "max_abs_err": flash_err[name], "ms": cuda_ms(run, iters=20),
            "plain_ms": cuda_ms(plain, iters=5, warm=2), "bound_ms": bound, "bound_by": bound_by,
            "library_ms": cuda_ms(library, iters=20) if library else library_bwd,
            "library": ("F.scaled_dot_product_attention forward" if library else
                        "F.scaled_dot_product_attention backward through autograd: dq, dk and "
                        "dv in one call, no lse cotangent"),
            "shape": {"BH": bh, "S": s, "D": d, "dtype": str(q.dtype)},
            "kernel": fa.KERNELS[(entry[name], q.dtype)],
            "f32_kernel": fa.KERNELS[(entry[name], torch.float32)],
            "f32_ms": cuda_ms(f32_run, iters=10),
        })
    share = sum(r["ms"] * launches[r["name"]] / steps for r in kernels) / step_ms
    timing = {"step_ms_median": step_ms,
              "data_ms_median": float(np.median([r["data_ms"] for r in timed])),
              "imgs_per_s_median": float(np.median([r["imgs_per_s"] for r in timed])),
              "sync": {**mode_summary(runs["sync"]["hist"]), "data_split": split},
              "ring": mode_summary(hist), "sync_ring_loss_max_abs_diff": loss_gap,
              "flash_share_of_step": share, "peak_memory_gb": ring["peak_gb"],
              "peak_memory_gb_sync": runs["sync"]["peak_gb"], "steps_timed": len(timed),
              "batch": V3_BATCH, "attention_check": checks,
              "profile": profile_step(train, cfg, dataset, state)}
    print(f"v3 timing: {json.dumps(timing)}", flush=True)
    return kernels, timing


# ------------------------------------------------ the options of the v2 step


def key_rows(enc, x, inv_perm, groups):
    """The keys a copy of key encoder `enc`, its BNs in `groups` virtual
    groups, gives for the permuted batch `x` in train mode (`enc`'s buffers
    left alone), l2-normalized, bf16 autocast, back in the batch's order."""
    from moco_tpu_torch.ops.losses import l2_normalize
    from moco_tpu_torch.parallel.shuffle import unshuffle_gather

    enc = copy.deepcopy(enc).train()
    for bn in (m for m in enc.modules() if hasattr(m, "virtual_groups")):
        bn.virtual_groups = groups
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        k = enc(x)
    return unshuffle_gather(l2_normalize(k.float()), inv_perm)


@contextlib.contextmanager
def last_batch(store: dict):
    """While open, every train step the driver builds records a clone of its
    batch's `im_k` in store["im_k"] (the ring recycles its slots)."""
    import moco_tpu_torch.train as train_module

    make = train_module.make_train_step

    def recording(*args, **kw):
        step_fn = make(*args, **kw)

        def run(st, batch):
            store["im_k"] = batch["im_k"].clone()
            return step_fn(st, batch)
        return run

    train_module.make_train_step = recording
    try:
        yield store
    finally:
        train_module.make_train_step = make


def options_run(fi, cfg, dataset, state, label, log=None):
    """OPTION_WARMUP + OPTION_TIMED steps of `cfg` from `state` through the
    ring, the InfoNCE launch counts set to 0 just before and read just
    after: finite losses and each kernel once per step. Returns the
    history, launches, medians of the timed steps and the peak memory."""
    from moco_tpu_torch.train import train

    steps = OPTION_WARMUP + OPTION_TIMED
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fi.infonce_stats.launches = fi.infonce_dq.launches = 0
    out = train(cfg, dataset=dataset, device="cuda", steps=steps, state=state, log=log)
    launches = {"infonce_fwd": fi.infonce_stats.launches, "infonce_bwd": fi.infonce_dq.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    check(len(hist) == steps and all(np.isfinite(r["loss"]) for r in hist),
          f"12d {label}: finite losses")
    check(launches == {"infonce_fwd": steps, "infonce_bwd": steps},
          f"12d {label}: InfoNCE kernels not launched once per step: {launches}")
    summary = {**mode_summary(hist, OPTION_WARMUP, OPTION_TIMED), "peak_memory_gb": peak_gb,
               "launches": launches, "first_loss": hist[0]["loss"],
               "steps_per_epoch": out["steps_per_epoch"]}
    print(f"12d {label}: {json.dumps(summary)}", flush=True)
    return hist, summary


def lars_reference(before, lr):
    """One LARS update in float64 from the captured parameters, gradients and
    traces (`LARS`'s order: weight decay and the trust ratio where the
    group decays, x -lr, the trace): {param index: (new param, new trace)}."""
    out = {}
    for i, (p, g, trace, group) in before.items():
        p64, u = p.double(), g.double()
        if group["decay"]:
            u = u + group["weight_decay"] * p64
            pn, un = p64.norm().item(), u.norm().item()
            u = u * (1.0 if pn == 0.0 or un == 0.0 else group["trust_coefficient"] * pn / un)
        t = -lr * u + (0.0 if trace is None else group["momentum"] * trace.double())
        out[i] = (p64 + t, t)
    return out


def step_options_phase(fi):
    """Phase 12d: the options of the v1/v2 step at full width (module
    docstring): (a) virtual Shuffle-BN, (b) the large-batch recipe with
    remat on and off, (c) the EMAN key forward."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.parallel.shuffle import make_permutation, step_seed
    from moco_tpu_torch.utils.config import PRESETS, apply_auto_scale
    from moco_tpu_torch.utils.schedules import make_lr_schedule

    out = {}
    base = PRESETS["imagenet_v2"]
    # the probe waits around every step (step_ms on every record)
    base = dataclasses.replace(base, data=dataclasses.replace(base.data, dataset="synthetic"),
                               obs_probe_every=1)
    b = base.data.global_batch
    dataset = SyntheticDataset(num_examples=b * EPOCH_STEPS, image_size=IMG)

    # (a) virtual Shuffle-BN: 8 groups of 32 rows, the keys' forward permuted
    cfg = dataclasses.replace(base, moco=dataclasses.replace(
        base.moco, bn_virtual_groups=OPTION_GROUPS, shuffle="gather_perm"))
    state = seeded_v2_state(cfg)
    seen = {}
    hook = state.encoder_k.register_forward_pre_hook(
        lambda _m, args: seen.__setitem__("x", args[0].detach().clone()))
    with last_batch(seen):
        hist, groups = options_run(fi, cfg, dataset, state, f"virtual groups G={OPTION_GROUPS}")
    hook.remove()
    last = len(hist) - 1
    gen = torch.Generator(device="cuda").manual_seed(step_seed(cfg.seed, last))
    perm, inv_perm = make_permutation(gen, b)
    check(torch.equal(seen["x"], seen["im_k"][perm]),
          "12d: the last key forward did not run on the step's permuted batch")
    enqueued = state.queue[state.queue_ptr - b:state.queue_ptr]
    recomputed = key_rows(state.encoder_k, seen["x"], inv_perm, OPTION_GROUPS)
    whole_bn = key_rows(state.encoder_k, seen["x"], inv_perm, 0)  # the control
    keys = {"recomputed": (enqueued - recomputed).abs().max().item(),
            "whole_batch_bn": (enqueued - whole_bn).abs().max().item(), "tolerance": BF16_REL}
    print(f"12d keys of the last step against their recomputation: {json.dumps(keys)}", flush=True)
    check(keys["recomputed"] <= BF16_REL, f"12d: enqueued keys off their recomputation: {keys}")
    check(keys["whole_batch_bn"] > BF16_REL,
          f"12d: whole-batch BN keys pass as the grouped ones (the groups had no effect): {keys}")
    del state, seen, enqueued, recomputed, whole_bn
    # G = 0 from the same seeded state, on the same data
    cfg0 = dataclasses.replace(cfg, moco=dataclasses.replace(cfg.moco, bn_virtual_groups=0))
    _, whole_run = options_run(fi, cfg0, dataset, seeded_v2_state(cfg0), "whole-batch BN G=0")
    out["virtual_groups"] = {"G": OPTION_GROUPS, "grouped": groups, "whole_batch": whole_run,
                             "keys": keys}

    # (b) the large-batch recipe cut to one card: LARS, momentum-statistics BN, auto_scale
    preset = PRESETS["imagenet_v2_large_batch"]
    check((preset.optim.optimizer, preset.moco.bn_momentum_stats, preset.auto_scale,
           preset.data.global_batch) == ("lars", True, "ref_batch=4096", 8192),
          "imagenet_v2_large_batch preset")
    ref = dataclasses.replace(preset, data=dataclasses.replace(
        preset.data, dataset="synthetic", global_batch=LARGE_BATCH), obs_probe_every=1)
    live, info = apply_auto_scale(ref)
    kappa = LARGE_BATCH / 4096
    check(info["kappa"] == kappa and live.optim.lr == 4.8 * kappa
          and live.moco.momentum == 0.999 ** kappa, f"12d: auto_scale {info}")
    print(f"12d large batch: imagenet_v2_large_batch, cut: global batch "
          f"{preset.data.global_batch} -> {LARGE_BATCH}; auto_scale {json.dumps(info)}", flush=True)
    big = SyntheticDataset(num_examples=LARGE_BATCH * EPOCH_STEPS, image_size=IMG)
    seeded = seeded_v2_state(live)
    large = {}
    for remat in (False, True):
        cfg = dataclasses.replace(ref, moco=dataclasses.replace(ref.moco, remat=remat))
        state = copy.deepcopy(seeded) if not remat else seeded
        leaf = "head.fc.2.weight"
        q0 = dict(state.encoder_q.named_parameters())[leaf].detach().clone()
        k0 = dict(state.encoder_k.named_parameters())[leaf].detach().clone()
        ema_err, lars, calls = [], {}, [0]
        opt, real_step = state.optimizer, state.optimizer.step

        def step(*args, **kw):  # the last step's update is captured
            calls[0] += 1
            if calls[0] != OPTION_WARMUP + OPTION_TIMED:
                return real_step(*args, **kw)
            params = [(p, g) for g in opt.param_groups for p in g["params"]]
            lars["before"] = {i: (p.detach().clone(), p.grad.detach().clone(),
                                  opt.state[p]["trace"].clone() if "trace" in opt.state[p]
                                  else None, g) for i, (p, g) in enumerate(params)}
            lars["lr"] = opt.param_groups[0]["lr"]
            result = real_step(*args, **kw)
            lars["after"] = {i: (p.detach().clone(), opt.state[p]["trace"].clone())
                             for i, (p, _) in enumerate(params)}
            return result

        def on_step(rec, state=state, q0=q0, k0=k0, ema_err=ema_err):
            if rec["step"] == 1:
                k1 = dict(state.encoder_k.named_parameters())[leaf].detach()
                m = live.moco.momentum
                ema_err.append((k1 - (k0 * m + q0 * (1.0 - m))).abs().max().item())

        opt.step = step
        try:
            hist, summary = options_run(fi, cfg, big, state, f"large batch remat={remat}",
                                        log=on_step)
        finally:
            del opt.step
        schedule = make_lr_schedule(live.optim, summary["steps_per_epoch"])
        check(all(r["lr"] == schedule(i) for i, r in enumerate(hist)),
              f"12d remat={remat}: the live lr is not the auto-scaled schedule's")
        check(ema_err and ema_err[0] <= 1e-6,
              f"12d remat={remat}: params_k after step 1 is not the EMA at m**kappa: {ema_err}")
        check(bool(lars), f"12d remat={remat}: the last LARS update was not captured")
        want = lars_reference(lars["before"], lars["lr"])
        rel = {"param": 0.0, "trace": 0.0}
        for i, (p, t) in lars["after"].items():
            wp, wt = want[i]
            rel["param"] = max(rel["param"], (p.double() - wp).abs().max().item()
                               / max(wp.abs().max().item(), 1e-30))
            rel["trace"] = max(rel["trace"], (t.double() - wt).abs().max().item()
                               / max(wt.abs().max().item(), 1e-30))
        summary["lars_vs_float64"] = {**rel, "lr": lars["lr"], "params": len(want)}
        print(f"12d LARS update on the card (remat={remat}) vs float64: {json.dumps(rel)}",
              flush=True)
        check(rel["param"] <= 1e-5 and rel["trace"] <= 1e-5,
              f"12d: LARS off the float64 update: {rel}")
        del lars, want
        large["remat" if remat else "no_remat"] = summary
        del state
        torch.cuda.empty_cache()
    gap = abs(large["remat"]["first_loss"] - large["no_remat"]["first_loss"])
    check(gap <= BF16_REL * abs(large["no_remat"]["first_loss"]),
          f"12d: first-step losses with and without remat differ by {gap}")
    out["large_batch"] = {"batch": LARGE_BATCH, "cut_from": preset.data.global_batch,
                          "auto_scale": info, "first_loss_gap": gap, **large}
    del seeded
    torch.cuda.empty_cache()

    # (c) the EMAN key forward: eval-mode key BN whose statistics trail the query's
    cfg = dataclasses.replace(base, moco=dataclasses.replace(
        base.moco, shuffle="none", key_bn_running_stats=True))
    state = seeded_v2_state(cfg)

    def stats(enc):
        return [t.clone() for n, t in enc.state_dict().items() if "running" in n]

    k0, eman = stats(state.encoder_k), {}

    def on_step(rec):
        if rec["step"] == 1:
            m = float(min(np.float32(cfg.moco.momentum), np.float32(1.0) / np.float32(10.0)))
            got, q1 = stats(state.encoder_k), stats(state.encoder_q)
            eman["max_err"] = max((g - (m * k + (1.0 - m) * q)).abs().max().item()
                                  / max(1.0, (m * k + (1.0 - m) * q).abs().max().item())
                                  for g, k, q in zip(got, k0, q1))
            eman["momentum"] = float(m)

    _, eman_run = options_run(fi, cfg, dataset, state, "EMAN key forward", log=on_step)
    print(f"12d EMAN key statistics after step 1 vs the EMA of the query's: {json.dumps(eman)}",
          flush=True)
    check(eman.get("max_err", 1.0) <= 1e-6, f"12d: EMAN key statistics off the EMA: {eman}")
    out["eman"] = {**eman_run, "stats_check": eman}
    del state
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ the closed loop


def state_tensors(state) -> dict:
    """Every tensor a checkpoint or a rollback brings back, by name: both
    encoders' parameters and BN statistics, the queue, the optimizer's
    buffers."""
    out = {f"q.{k}": v for k, v in state.encoder_q.state_dict().items()}
    out.update({f"k.{k}": v for k, v in state.encoder_k.state_dict().items()})
    if state.queue is not None:
        out["queue"] = state.queue
    for i, p in enumerate(p for g in state.optimizer.param_groups for p in g["params"]):
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"opt.{i}.{k}"] = v
    return out


def same_state(state, want: dict, what: str) -> None:
    """`state`'s tensors equal `want`'s (cloned earlier), tensor by tensor,
    bit for bit."""
    got = state_tensors(state)
    check(set(got) == set(want), f"{what}: tensors differ in name: {sorted(set(got) ^ set(want))[:4]}")
    for k, v in want.items():
        check(torch.equal(got[k], v), f"{what}: {k} differs")


def clone_state(state) -> dict:
    return {k: v.clone() for k, v in state_tensors(state).items()}


def closed_loop_phase(fi, workdir):
    """Phase 12b: the closed v2 loop at full width (module docstring), in
    `workdir`; returns its numbers."""
    from moco_tpu_torch import convert_pretrain, knn, lincls
    from moco_tpu_torch import train as train_module
    from moco_tpu_torch.core.moco import build_encoder, create_state
    from moco_tpu_torch.data.datasets import LearnableSyntheticDataset, SyntheticDataset
    from moco_tpu_torch.models.resnet import create_resnet
    from moco_tpu_torch.obs.schema import read_metrics, validate_file
    from moco_tpu_torch.train import StateSnapshot, train
    from moco_tpu_torch.utils import faults
    from moco_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_payload,
        state_payload,
    )
    from moco_tpu_torch.utils.config import (
        DataConfig,
        MocoConfig,
        OptimConfig,
        ProbeConfig,
        PRESETS,
        TrainConfig,
    )

    out = {}
    phase_t0 = time.perf_counter()
    preset = PRESETS["imagenet_v2"]
    pre = os.path.join(workdir, "pretrain")
    cfg = dataclasses.replace(
        preset, data=dataclasses.replace(preset.data, dataset="synthetic_learnable"),
        optim=dataclasses.replace(preset.optim, epochs=2), steps_per_epoch=LOOP_EPOCH_STEPS,
        workdir=pre, knn_every_epochs=1, checkpoint_keep=2,
        obs_probe_every=1)  # each record's `log` call before the next step, as the guard reads
    train_set = LearnableSyntheticDataset(256 * LOOP_EPOCH_STEPS, IMG)
    knn_sets = (LearnableSyntheticDataset(KNN_BANK, IMG),
                LearnableSyntheticDataset(KNN_TEST, IMG, train=False))

    # (a) pretrain two epochs, checkpoint, resume
    fi.infonce_stats.launches = fi.infonce_dq.launches = 0  # counts from here on are the path's
    t0 = time.perf_counter()
    run = train(cfg, dataset=train_set, device="cuda", knn_datasets=knn_sets)
    out["pretrain_s"] = time.perf_counter() - t0
    steps = 2 * LOOP_EPOCH_STEPS
    launches = {"infonce_fwd": fi.infonce_stats.launches, "infonce_bwd": fi.infonce_dq.launches}
    check(launches == {"infonce_fwd": steps, "infonce_bwd": steps},
          f"closed loop: InfoNCE launches {launches} over {steps} steps")
    final = run["state"]
    check(final.step == steps and all(np.isfinite(r["loss"]) for r in run["history"]),
          "closed loop: steps or losses")
    metrics_path = os.path.join(pre, "metrics.jsonl")
    errors = validate_file(metrics_path)
    check(errors == [], f"metrics.jsonl schema: {errors[:3]}")
    lines = read_metrics(metrics_path)
    knn_lines = [r for r in lines if "knn_top1" in r]
    check([r["epoch"] for r in knn_lines] == [0, 1], f"kNN lines {knn_lines}")
    mgr = CheckpointManager(pre)
    check(mgr.all_steps() == [LOOP_EPOCH_STEPS, steps], f"checkpoints {mgr.all_steps()}")
    out["knn_top1_monitor"] = [r["knn_top1"] for r in knn_lines]
    want = clone_state(final)

    timing_dir = os.path.join(workdir, "timing")
    t0 = time.perf_counter()
    path = CheckpointManager(timing_dir, keep=1).save(steps, state_payload(final, "resnet50", 2))
    out["checkpoint_save_ms"] = (time.perf_counter() - t0) * 1e3
    out["checkpoint_bytes"] = os.path.getsize(path)
    fresh = create_state(cfg, build_encoder(cfg.moco), device="cuda")
    t0 = time.perf_counter()
    payload, _ = mgr.restore(step=steps)
    load_state_payload(fresh, payload)
    torch.cuda.synchronize()
    out["checkpoint_restore_ms"] = (time.perf_counter() - t0) * 1e3
    same_state(fresh, want, "restore into a fresh state")
    check((fresh.step, fresh.queue_ptr) == (final.step, final.queue_ptr), "restored step or ptr")
    del fresh, payload
    shutil.rmtree(timing_dir)

    real_load = train_module.load_state_payload
    resumed = {}

    def load_and_check(state, payload):
        real_load(state, payload)
        same_state(state, want, "the driver's resume")
        resumed["step"] = state.step

    train_module.load_state_payload = load_and_check
    faults.install(f"ckpt_truncate@step={steps + LOOP_EPOCH_STEPS}")
    try:
        fi.infonce_stats.launches = fi.infonce_dq.launches = 0
        again = train(dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, epochs=3)),
                      dataset=train_set, device="cuda", knn_datasets=knn_sets)
    finally:
        faults.clear()
        train_module.load_state_payload = real_load
    check(resumed.get("step") == steps, f"resume step {resumed}")
    check([r["step"] for r in again["history"]] == list(range(steps + 1, steps + 4)),
          f"resumed steps {[r['step'] for r in again['history']]}")
    check(fi.infonce_stats.launches == fi.infonce_dq.launches == LOOP_EPOCH_STEPS,
          "resumed run: InfoNCE launches")
    newest = steps + LOOP_EPOCH_STEPS
    check(mgr.latest_step() == steps, "the truncated newest checkpoint was not passed over")
    check(os.listdir(os.path.join(pre, "quarantine")) == [os.path.basename(mgr.path(newest))],
          "the truncated checkpoint was not quarantined")
    payload, extra = mgr.restore()
    check(payload["step"] == steps and extra["epoch"] == 1, "fallback restore")
    del payload, again

    # kNN monitor timings on the pretrained query backbone
    backbone = final.encoder_q.backbone
    t0 = time.perf_counter()
    bank_f, bank_y = knn.extract_features(backbone, knn_sets[0], image_size=IMG,
                                          compute_dtype="bfloat16")
    test_f, test_y = knn.extract_features(backbone, knn_sets[1], image_size=IMG,
                                          compute_dtype="bfloat16")
    out["knn_extract_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    preds = knn.knn_classify(bank_f, bank_y, test_f, 8, k=cfg.knn_k,
                             temperature=cfg.knn_temperature)
    out["knn_classify_ms"] = (time.perf_counter() - t0) * 1e3
    out["knn_top1"] = float(100.0 * np.mean(preds == test_y))
    check(out["knn_top1"] == out["knn_top1_monitor"][-1], "kNN top-1 differs from the monitor's")
    snap = StateSnapshot(final)
    out["snapshot_ms"] = host_ms(lambda: snap.take(final))
    del snap

    # (b) the non-finite guard: log every step, NaN at k1 and k2, threshold 2
    guard_dir = os.path.join(workdir, "guard")
    k1, k2 = steps + 2, steps + 4
    gcfg = dataclasses.replace(cfg, workdir=guard_dir, log_every=1, nan_guard_threshold=2,
                               knn_every_epochs=0, steps_per_epoch=None)
    seen = {}

    def watch(record):
        if record["step"] == k1 - 1:  # the last finite state before the NaN
            seen["before"] = clone_state(gstate)
        elif record["step"] == k1 + 1:  # found one step late, as in JAX: rolled back by now
            same_state(gstate, seen["before"], "the state after the rollback")
            seen["rolled_back_at"] = gstate.step

    gstate = copy.deepcopy(final)
    faults.install(f"nan@step={k1},nan@step={k2}")
    try:
        train(gcfg, dataset=SyntheticDataset(256 * 16, IMG), device="cuda", steps=6,
              state=gstate, log=watch)
        check(False, "the guard did not abort at its threshold")
    except FloatingPointError as e:
        out["guard_abort"] = str(e)
    finally:
        faults.clear()
    check(seen.get("rolled_back_at") == k1 + 1, f"rollback not seen: {sorted(seen)}")
    events = [r for r in read_metrics(os.path.join(guard_dir, "metrics.jsonl")) if "event" in r]
    check([(r["event"], r["step"], r["nan_steps"]) for r in events
           if r["event"] == "nonfinite_loss"]
          == [("nonfinite_loss", k1, 1), ("nonfinite_loss", k2, 2)], f"guard events {events}")
    # the default alert rules turn each nonfinite_loss event into an alert line
    check([(r["step"], r["alert"]) for r in events if r["event"] == "alert"]
          == [(k1, "nonfinite_loss"), (k2, "nonfinite_loss")], f"guard alert lines {events}")
    del gstate, seen

    # (c) the linear probe at full width from the pretraining checkpoint
    probe_dir = os.path.join(workdir, "probe")
    val = LearnableSyntheticDataset(PROBE_VAL, IMG, train=False)
    probe = ProbeConfig(epochs=PROBE_EPOCHS, num_classes=8)
    t0 = time.perf_counter()
    res = lincls.train_lincls(pre, probe, train_dataset=LearnableSyntheticDataset(512, IMG),
                              val_dataset=val, workdir=probe_dir, device="cuda")
    out["probe_run_s"] = time.perf_counter() - t0  # sanity_check passed inside
    check(res["count"] == PROBE_VAL, f"probe val count {res['count']}")
    out["probe_top1"] = res["best_acc1"]
    best = lincls.evaluate_lincls(pre, workdir=probe_dir, val_dataset=val, device="cuda")
    check(best["acc1"] == res["best_acc1"], f"evaluate_lincls {best['acc1']} != {res['best_acc1']}")
    backbone, pretrained, _ = lincls.load_pretrained_backbone(pre, device="cuda")
    fc = lincls.LinearClassifier(backbone.num_features, 8).cuda()
    optimizer, schedule = lincls._probe_tx(probe, 2, fc.parameters())
    step = lincls.make_probe_step(backbone, fc, optimizer, schedule, "bfloat16")
    evaluate = lincls.make_eval_step(backbone, fc, "bfloat16")
    x = torch.randn(256, IMG, IMG, 3, device="cuda")
    y = torch.randint(0, 8, (256,), device="cuda")
    mask = torch.ones(256, device="cuda")
    out["probe_imgs_per_s"] = 256 / host_ms(lambda: step(0, x, y)) * 1e3
    out["eval_imgs_per_s"] = 256 / host_ms(lambda: evaluate(x, y, mask)) * 1e3
    lincls.sanity_check(backbone, pretrained)  # the timed steps moved no BN statistic either
    pth = os.path.join(workdir, "backbone.pth")
    convert_pretrain.main([pre, pth])
    exported = create_resnet("resnet50")
    exported.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    exported = exported.cuda().to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        check(torch.equal(exported(x), backbone(x)), "convert_pretrain: features differ")
    del backbone, exported, fc, optimizer, pretrained

    # (d) the learning signal: tests/test_learning_signal.py's configuration
    sig = TrainConfig(
        moco=MocoConfig(arch="resnet18", dim=64, num_negatives=256, momentum=0.9,
                        temperature=0.2, mlp=True, shuffle="none", cifar_stem=True,
                        compute_dtype="float32"),
        optim=OptimConfig(lr=0.12, epochs=4, cos=True),
        data=DataConfig(dataset="synthetic_learnable", image_size=32, global_batch=64,
                        aug_plus=True),
        workdir=os.path.join(workdir, "signal"), seed=0)
    t0 = time.perf_counter()
    sig_run = train(sig, dataset=LearnableSyntheticDataset(512, 32, 8, train=True), device="cuda")
    out["signal_pretrain_s"] = time.perf_counter() - t0
    top1 = knn.knn_eval(sig_run["state"].encoder_q.backbone,
                        LearnableSyntheticDataset(512, 32, 8, train=True),
                        LearnableSyntheticDataset(128, 32, 8, train=False),
                        num_classes=8, k=32, image_size=32)
    out["signal_knn_top1"] = top1
    check(top1 > 2 * 100.0 / 8, f"learning signal: kNN top-1 {top1:.2f}% <= 25% (2x chance)")
    sig_probe = lincls.train_lincls(sig.workdir, ProbeConfig(epochs=10, schedule=(6, 8),
                                                             num_classes=8),
                                    train_dataset=LearnableSyntheticDataset(512, 32, 8),
                                    val_dataset=LearnableSyntheticDataset(128, 32, 8, train=False),
                                    device="cuda")
    out["signal_probe_top1"] = sig_probe["best_acc1"]
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"closed loop in {out['phase_s']:.1f} s: pretrain {out['pretrain_s']:.1f} s, checkpoint "
          f"{out['checkpoint_bytes']} bytes, save {out['checkpoint_save_ms']:.1f} ms, restore "
          f"{out['checkpoint_restore_ms']:.1f} ms; kNN extract {out['knn_extract_ms']:.1f} ms, "
          f"classify {out['knn_classify_ms']:.1f} ms, top-1 {out['knn_top1']:.2f}%; probe "
          f"{out['probe_imgs_per_s']:.0f} imgs/s, eval {out['eval_imgs_per_s']:.0f} imgs/s, "
          f"top-1 {out['probe_top1']:.2f}%; learning signal kNN top-1 {top1:.2f}% (probe "
          f"{out['signal_probe_top1']:.2f}%)", flush=True)
    return out


# ------------------------------------------------- fault tolerance and health


class TimedCheckpoints:
    """A CheckpointManager factory for the driver that records what each
    save cost the caller and when each emergency save became durable."""

    def __init__(self):
        from moco_tpu_torch.utils.checkpoint import CheckpointManager

        self.saves, self.durable = [], []
        log = self

        class Manager(CheckpointManager):
            def save(self, step, payload, extra=None, force=False):
                t0 = time.perf_counter()
                path = super().save(step, payload, extra=extra, force=force)
                log.saves.append((step, (time.perf_counter() - t0) * 1e3))
                return path

            def wait(self):
                super().wait()
                log.durable.append(time.perf_counter())

        self.Manager = Manager


def gauge_reference(cfg, state, out_q, out_k, queue, step_before):
    """The v2 gauges in float64 on the host from one step's own head outputs,
    the queue it read and the parameters it left."""
    t = cfg.moco.temperature
    q = out_q.double().cpu()
    q = q / q.norm(dim=1, keepdim=True)
    k = out_k.double().cpu()
    k = k / k.norm(dim=1, keepdim=True)
    pos = (q * k).sum(1) / t
    neg = q @ queue[:1024].double().cpu().T / t
    std = q.std(dim=0, correction=0)
    ref = {"logit_pos_mean": pos.mean(), "logit_pos_std": pos.std(correction=0),
           "logit_neg_mean": neg.mean(), "logit_neg_std": neg.std(correction=0),
           "feature_std": std.mean(), "std": std}
    diff_sq = ref_sq = 0.0
    for group in ("backbone", "head"):
        pq = [p.detach().double().cpu() for p in getattr(state.encoder_q, group).parameters()]
        pk = [p.detach().double().cpu() for p in getattr(state.encoder_k, group).parameters()]
        d = sum(float(((a - b) ** 2).sum()) for a, b in zip(pq, pk))
        r = sum(float((a ** 2).sum()) for a in pq)
        ref[f"ema_drift/{group}"] = d ** 0.5 / (r ** 0.5 + 1e-12)
        diff_sq, ref_sq = diff_sq + d, ref_sq + r
    ref["ema_drift"] = diff_sq ** 0.5 / (ref_sq ** 0.5 + 1e-12)
    depth = cfg.moco.num_negatives // cfg.data.global_batch
    ages = np.minimum(np.arange(1, depth + 1, dtype=np.float64), step_before)
    ref["queue_age_mean"], ref["queue_age_max"] = ages.mean(), ages.max()
    bucket = np.clip(np.searchsorted(np.linspace(0, depth, 9), ages, side="right") - 1, 0, 7)
    ref["queue_age_hist"] = np.bincount(bucket, minlength=8) / depth
    return ref


def fault_health_phase(fi, workdir, preset_name="imagenet_v2", device="cuda"):
    """Phase 12c: the fault-tolerance and health layer at full width (module
    docstring), in `workdir`; returns its numbers. `preset_name` and
    `device` let the phase run a small preset on the CPU, where its
    launch counts and CUDA timings are not checked."""
    import signal
    import threading

    from moco_tpu_torch import train as train_module
    from moco_tpu_torch.core.moco import build_encoder, create_state, make_train_step
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.obs import health
    from moco_tpu_torch.obs.alerts import FatalAlertError, read_alerts
    from moco_tpu_torch.obs.schema import read_metrics, validate_file
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils import faults
    from moco_tpu_torch.utils.checkpoint import CheckpointManager, load_state_payload, state_payload
    from moco_tpu_torch.utils.config import PRESETS

    out = {}
    phase_t0 = time.perf_counter()
    spe = LOOP_EPOCH_STEPS
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    preset = PRESETS[preset_name]
    # the probe waits around every step: step_ms on every record, and each
    # record's `log` call before the next step (the timers below key on it)
    base = dataclasses.replace(preset, data=dataclasses.replace(preset.data, dataset="synthetic"),
                               optim=dataclasses.replace(preset.optim, epochs=2),
                               steps_per_epoch=spe, obs_probe_every=1)
    b, img, kk, dim = (base.data.global_batch, base.data.image_size, base.moco.num_negatives,
                       base.moco.dim)
    data = SyntheticDataset(b * spe, img)
    state0 = create_state(base, build_encoder(base.moco), device=device)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    timed = TimedCheckpoints()
    real_manager = train_module.CheckpointManager
    train_module.CheckpointManager = timed.Manager

    def run(cfg, spec="", state=None, **kw):
        faults.install(spec or None)
        try:
            return train(cfg, dataset=data, device=device,
                         state=copy.deepcopy(state0) if state is None else state, **kw)
        finally:
            faults.clear()

    def fire_count(d):
        return read_alerts(os.path.join(d, "alerts.jsonl"))

    try:
        # (a) preemption: preempt@step=4 on 3-step epochs, the ring on; the
        # log steps are 1, 3, 4 and 6, so the signal lands at step 4's
        # deferred processing, after step 5 ran
        pre = os.path.join(workdir, "preempt")
        cfg = dataclasses.replace(base, workdir=pre)
        fi.infonce_stats.launches = fi.infonce_dq.launches = 0
        first = run(cfg, "preempt@step=4")
        final = first["state"]
        check(first["preempted"] and final.step == 5, f"preempt: stopped at step {final.step}")
        check(not cuda or fi.infonce_stats.launches == fi.infonce_dq.launches == final.step,
              "preempt: InfoNCE launches != steps")
        check({s: signal.getsignal(s) for s in handlers} == handlers, "preempt: handlers not back")
        events = [(r["step"], r["epoch"], r["event"]) for r in read_metrics(
            os.path.join(pre, "metrics.jsonl")) if "event" in r]
        check(events == [(5, 1, "preempt")], f"preempt: event lines {events}")
        mgr = CheckpointManager(pre)
        check(mgr.all_steps() == [spe, 5], f"preempt: checkpoints {mgr.all_steps()}")
        extra = mgr.read_extra(5)
        check((extra["epoch"], extra["emergency"], extra["reason"]) == (0, True, "preempt"),
              f"preempt: extras {extra}")
        fresh = create_state(base, build_encoder(base.moco), device=device)
        load_state_payload(fresh, mgr.restore(step=5)[0])
        same_state(fresh, clone_state(final), "preempt: the emergency checkpoint")
        check((fresh.step, fresh.queue_ptr) == (final.step, final.queue_ptr), "preempt: step, ptr")
        del fresh
        again = run(cfg)  # resumes at epoch 1, redoes it: 5 + 3 = 8 (moco_tpu's driver test)
        check([r["step"] for r in again["history"]] == [6, 7, 8] and mgr.latest_step() == 8,
              f"preempt: resumed steps {[r['step'] for r in again['history']]}")
        check(fire_count(pre) == [], f"preempt: alerts on a clean run {fire_count(pre)}")

        # a real SIGTERM from a timer thread during step 3: signal to durable
        sig_dir = os.path.join(workdir, "sigterm")
        sent = {}

        def kill():
            sent["t"] = time.perf_counter()
            os.kill(os.getpid(), signal.SIGTERM)

        timer = threading.Timer(0.05, kill)
        timed.durable.clear()
        try:
            sig_run = run(dataclasses.replace(base, workdir=sig_dir),
                          log=lambda r: r["step"] == 2 and timer.start())
        finally:
            timer.cancel()
            if timer.ident is not None:
                timer.join()
        check(sig_run["preempted"] and "t" in sent and timed.durable, "SIGTERM: no preemption")
        out["sigterm_to_durable_ms"] = (timed.durable[-1] - sent["t"]) * 1e3
        out["sigterm_saved_step"] = sig_run["state"].step
        extra = CheckpointManager(sig_dir).read_extra(sig_run["state"].step)
        check(extra["reason"] == "preempt", f"SIGTERM: extras {extra}")
        check({s: signal.getsignal(s) for s in handlers} == handlers, "SIGTERM: handlers not back")
        del first, again, sig_run

        # (c) async checkpoints, 3 epochs: the loop's paid save (the first
        # allocates its pinned buffers, the second reuses them), the file's
        # bits against the state at save time, the torn-file fall-back
        async_dir = os.path.join(workdir, "async")
        acfg = dataclasses.replace(base, workdir=async_dir, checkpoint_async=True,
                                   optim=dataclasses.replace(base.optim, epochs=3))
        at_save = {}
        astate = copy.deepcopy(state0)
        timed.saves.clear()
        arun = run(acfg, f"ckpt_truncate@step={3 * spe}", state=astate,
                   log=lambda r: r["step"] == spe and at_save.update(clone_state(astate)))
        paid = dict(timed.saves)
        out["async_save_paid_ms"] = [paid[spe], paid[2 * spe]]
        amgr = CheckpointManager(async_dir)
        check(amgr.latest_step() == 2 * spe, "async: the truncated newest file was not passed over")
        check(os.listdir(os.path.join(async_dir, "quarantine"))
              == [os.path.basename(amgr.path(3 * spe))], "async: the torn file not quarantined")
        fresh = create_state(base, build_encoder(base.moco), device=device)
        load_state_payload(fresh, amgr.restore(step=spe)[0])
        same_state(fresh, at_save, "async: the checkpoint against the state at save time")
        del fresh, at_save
        final = arun["state"]
        blocking = CheckpointManager(os.path.join(workdir, "blocking"), keep=1)
        sync()
        t0 = time.perf_counter()
        blocking.save(final.step, state_payload(final, "resnet50", 2))
        out["blocking_save_ms"] = (time.perf_counter() - t0) * 1e3
        asave = CheckpointManager(os.path.join(workdir, "async_again"), keep=1, async_save=True)
        paid_again = []
        for _ in range(2):  # the first allocates its pinned buffers, the second reuses them
            sync()
            t0 = time.perf_counter()
            asave.save(final.step, state_payload(final, "resnet50", 2))
            paid_again.append((time.perf_counter() - t0) * 1e3)
            asave.wait()
        out["async_save_paid_ms_same_state"] = paid_again

        # (d) health and alerts: every training line carries the gauges
        for d in (pre, async_dir):
            path = os.path.join(d, "metrics.jsonl")
            errors = validate_file(path)
            check(errors == [], f"metrics.jsonl schema ({d}): {errors[:3]}")
            lines = [r for r in read_metrics(path) if "loss" in r]
            missing = [(r["step"], k) for r in lines for k in health.HEALTH_KEYS
                       + ("ema_drift/backbone", "ema_drift/head") if k not in r]
            check(lines and not missing, f"gauges missing from training lines: {missing[:4]}")
        check(fire_count(async_dir) == [], f"alerts on a clean ring run: {fire_count(async_dir)}")

        # the gauges of one step against float64 on its own q, k and queue
        gstate = copy.deepcopy(final)
        seen = {}
        hooks = [enc.register_forward_hook(lambda _m, _i, o, n=n: seen.__setitem__(n, o.detach()))
                 for n, enc in (("q", gstate.encoder_q), ("k", gstate.encoder_k))]
        views = torch.randn(2, b, img, img, 3, device=device,
                            generator=torch.Generator(device=device).manual_seed(SEED))
        queue_before, step_before = gstate.queue.clone(), gstate.step
        metrics = make_train_step(base, spe, device=device)(gstate, {"im_q": views[0],
                                                                     "im_k": views[1]})
        for h in hooks:
            h.remove()
        ref = gauge_reference(base, gstate, seen["q"], seen["k"], queue_before, step_before)
        unit = {"logit_pos_mean": 1 / base.moco.temperature, "logit_pos_std": 1 / base.moco.temperature,
                "logit_neg_mean": 1 / base.moco.temperature, "logit_neg_std": 1 / base.moco.temperature,
                "feature_std": 1 / dim ** 0.5}
        worst = 0.0
        for key, want in ref.items():
            if key == "std":
                continue
            got = metrics[key].double().cpu().numpy()
            want = np.asarray(want, np.float64)
            err = float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))),
                                                          unit.get(key, 0.0), 1e-30))
            worst = max(worst, err)
            out.setdefault("gauge_rel_err", {})[key] = err
            check(err <= 1e-5, f"gauge {key}: {got} against float64 {want} ({err:.2e} relative)")
        threshold = 0.1 / dim ** 0.5
        near = int((ref["std"] - threshold).abs().le(1e-6).sum())
        want_active = int((ref["std"] > threshold).sum())
        check(abs(float(metrics["feature_dim_active"]) - want_active) <= near,
              f"feature_dim_active {float(metrics['feature_dim_active'])} != {want_active}")
        out["gauge_max_rel_err"] = worst
        gauges = functools.partial(
            health.health_summary, health.module_groups(gstate.encoder_q),
            health.module_groups(gstate.encoder_k), seen["q"].float(),
            (seen["q"].float() * seen["k"].float()).sum(-1),
            seen["q"].float() @ gstate.queue[:1024].T, gstate.step, kk, b)
        if cuda:
            out["gauge_ms"] = cuda_ms(gauges, iters=20)
        else:  # the host's clock, once: a smoke of the phase, not a number to keep
            t0 = time.perf_counter()
            gauges()
            out["gauge_ms"] = (time.perf_counter() - t0) * 1e3
        del gstate, seen, views, astate, arun

        # the gauges' cost end to end: sync-mode step ms, on against off
        step_ms = {}
        for on in (True, False):
            hcfg = dataclasses.replace(base, health_metrics=on, device_prefetch=False,
                                       steps_per_epoch=None)
            hist = train(hcfg, dataset=SyntheticDataset(b * 16, img), device=device,
                         steps=TRAIN_WARMUP + TRAIN_TIMED, state=copy.deepcopy(final))["history"]
            step_ms[on] = float(np.median([r["step_ms"] for r in hist[TRAIN_WARMUP:]]))
        out["step_ms_health_on"], out["step_ms_health_off"] = step_ms[True], step_ms[False]

        # nan@step=5 under the default rules: one alert line, one alerts.jsonl entry
        nan_dir = os.path.join(workdir, "nan")
        run(dataclasses.replace(base, workdir=nan_dir, log_every=1), "nan@step=5")
        alerts = [(r["step"], r["alert"]) for r in read_metrics(
            os.path.join(nan_dir, "metrics.jsonl")) if r.get("event") == "alert"]
        check(alerts == [(5, "nonfinite_loss")], f"nan: alert lines {alerts}")
        check([a["rule"] for a in fire_count(nan_dir)] == ["nonfinite_loss"], "nan: alerts.jsonl")
        # ... and under alerts_fatal: an emergency checkpoint, then FatalAlertError
        fatal_dir = os.path.join(workdir, "fatal")
        try:
            run(dataclasses.replace(base, workdir=fatal_dir, log_every=1, alerts_fatal=True),
                "nan@step=5")
            check(False, "alerts_fatal: no FatalAlertError")
        except FatalAlertError as e:
            out["fatal"] = str(e)[:80]
        fmgr = CheckpointManager(fatal_dir)
        check(fmgr.all_steps() == [spe, 4], f"alerts_fatal: checkpoints {fmgr.all_steps()}")
        extra = fmgr.read_extra(4)
        check((extra["reason"], extra["alert"], extra["emergency"]) == ("alert", "nonfinite_loss",
                                                                         True),
              f"alerts_fatal: extras {extra}")
    finally:
        train_module.CheckpointManager = real_manager
    del final, state0
    if cuda:
        torch.cuda.empty_cache()

    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"fault tolerance and health in {out['phase_s']:.1f} s: SIGTERM to durable checkpoint "
          f"{out['sigterm_to_durable_ms']:.1f} ms (step {out['sigterm_saved_step']}); save paid by "
          f"the loop, async {out['async_save_paid_ms'][0]:.1f} / {out['async_save_paid_ms'][1]:.1f}"
          f" ms (same state {out['async_save_paid_ms_same_state'][0]:.1f} / "
          f"{out['async_save_paid_ms_same_state'][1]:.1f}) against blocking "
          f"{out['blocking_save_ms']:.1f} ms; gauges {out['gauge_ms']:.3f} ms of device time, "
          f"v2 sync step {out['step_ms_health_on']:.2f} ms on, {out['step_ms_health_off']:.2f} ms "
          f"off, worst relative error {out['gauge_max_rel_err']:.2e}", flush=True)
    return out


def watchdog_start(workdir, preset_name="imagenet_v2", device="cuda") -> dict:
    """Phase 12c(b), started: the watchdog's training process (module
    docstring) in `workdir`, left running beside what follows (12i's
    processes) until `watchdog_finish`."""
    wd_dir = os.path.join(workdir, "watchdog")
    # the stall lands at the last log step's deferred read (step 6, after
    # the loop): the good snapshot is then step 4's, promoted at step 5
    env = {**os.environ, "MOCO_FAULTS": "stall@step=6:seconds=120"}
    cmd = [sys.executable, "-m", "moco_tpu_torch.train", "--preset", preset_name, "--data",
           "synthetic", "--workdir", wd_dir, "--epochs", "2", "--steps-per-epoch",
           str(LOOP_EPOCH_STEPS), "--watchdog-timeout", f"{WATCHDOG_TIMEOUT_S:g}", "--device",
           device]
    h = {"dir": wd_dir, "preset": preset_name, "device": device, "stalled": {}, "tail": [],
         "t0": time.perf_counter()}
    h["proc"] = proc = subprocess.Popen(
        cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def read():
        for line in proc.stdout:
            h["tail"].append(line.rstrip())
            if line.startswith("injected fault: stalling"):
                h["stalled"]["t"] = time.perf_counter()

    def wait():  # the exit's time, however long after it this process looks
        h["rc"] = proc.wait()
        h["t_exit"] = time.perf_counter()

    h["reader"] = threading.Thread(target=read, daemon=True)
    h["waiter"] = threading.Thread(target=wait, daemon=True)
    h["reader"].start()
    h["waiter"].start()
    return h


def watchdog_finish(h) -> dict:
    """Phase 12c(b), checked: a stalled training process exits with 42
    after saving the last finite log step's state (module docstring)."""
    from moco_tpu_torch.core.queue import init_queue
    from moco_tpu_torch.obs.schema import read_metrics
    from moco_tpu_torch.utils.checkpoint import CheckpointManager
    from moco_tpu_torch.utils.config import PRESETS
    from moco_tpu_torch.utils.contracts import STALL_EXIT_CODE

    proc, stalled, tail, wd_dir, device = h["proc"], h["stalled"], h["tail"], h["dir"], h["device"]
    base = PRESETS[h["preset"]]
    spe, b, kk, dim = (LOOP_EPOCH_STEPS, base.data.global_batch, base.moco.num_negatives,
                       base.moco.dim)
    out = {}
    h["waiter"].join(timeout=max(300 - (time.perf_counter() - h["t0"]), 1.0))
    rc = h.get("rc")
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    h["waiter"].join(timeout=30)
    h["reader"].join(timeout=30)
    check(rc == STALL_EXIT_CODE and "t" in stalled,
          f"watchdog: exit code {rc}, stalled {stalled}; output {tail[-12:]}")
    out["watchdog_exit_s"] = h["t_exit"] - stalled["t"]
    out["watchdog_process_s"] = h["t_exit"] - h["t0"]
    check("Thread" in open(os.path.join(wd_dir, "stall_stacks.txt")).read(), "watchdog: no stacks")
    stall = [r for r in read_metrics(os.path.join(wd_dir, "metrics.jsonl"))
             if r.get("event") == "stall"]
    check(len(stall) == 1 and stall[0]["watchdog_timeout"] == WATCHDOG_TIMEOUT_S,
          f"watchdog: stall lines {stall}")
    wmgr = CheckpointManager(wd_dir)
    check(wmgr.all_steps() == [spe, 4], f"watchdog: checkpoints {wmgr.all_steps()}")
    payload, extra = wmgr.restore(step=4)
    check((extra["reason"], extra["epoch"], extra["emergency"]) == ("stall", 0, True),
          f"watchdog: extras {extra}")
    # the snapshot of step 4, not the live state of step 6: pointer at 4 batches, and
    # the rows steps 5 and 6 wrote still hold the seeded initial queue
    queue = payload["state_dict"]["module.queue"].t().to(device)
    init = init_queue(torch.Generator(device=device).manual_seed(base.seed), kk, dim,
                      device=device)
    ptr = int(payload["state_dict"]["module.queue_ptr"][0])
    check(ptr == 4 * b % kk, f"watchdog: queue_ptr {ptr}")
    check(torch.equal(queue[4 * b:6 * b], init[4 * b:6 * b])
          and not torch.equal(queue[3 * b:4 * b], init[3 * b:4 * b]),
          "watchdog: the checkpoint is not the state of step 4")
    print(f"12c(b) watchdog: exit {out['watchdog_exit_s']:.1f} s after the stall "
          f"({out['watchdog_process_s']:.1f} s process, beside 12i's processes)", flush=True)
    return out


# ------------------------------------------------------------ train to serve


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def count_forwards(engine) -> dict:
    """Counts `engine`'s encoder forwards (one per padded bucket executed)
    in the returned dict's "n"."""
    counter = {"n": 0}
    forward = engine.forward

    def counted(raw):
        counter["n"] += 1
        return forward(raw)

    engine.forward = counted
    return counter


def zero_flash(fa) -> None:
    for _, fn, _ in FLASH:
        wrapper = getattr(fa, fn)
        wrapper.launches = 0
        wrapper.kernel_launches = dict.fromkeys(wrapper.kernel_launches, 0)


def same_weights(a, b, what: str) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    check(list(sa) == list(sb), f"{what}: names differ")
    for k in sa:
        check(torch.equal(sa[k], sb[k].to(sa[k].device)), f"{what}: {k} differs")


def ids_agree(emb_a, ids_a, emb_b, ids_b, rows, what):
    """Top-k ids of two embeddings of the same images against the same rows
    (a replica's and the in-process engine's): where they differ, the two
    rows' float64 scores under `emb_a` lie within twice the largest
    |emb_a - emb_b| (a unit row's score moves by at most that norm, and so
    does the k-th largest) plus SCORE_TOL: a near-tie. Returns the number
    of such swaps."""
    a = emb_a.astype(np.float64)
    delta = float(np.linalg.norm(a - emb_b.astype(np.float64), axis=1).max())
    swaps = 0
    for m, j in zip(*np.nonzero(ids_a != ids_b)):
        gap = abs(a[m] @ rows[ids_a[m, j]].astype(np.float64)
                  - a[m] @ rows[ids_b[m, j]].astype(np.float64))
        check(gap <= 2 * delta + SCORE_TOL, f"{what}: ids differ at ({m}, {j}) with a score gap "
              f"{gap:.3g} > 2 x {delta:.3g} + {SCORE_TOL}")
        swaps += 1
    return swaps


def timm_to_vit(sd: dict) -> dict:
    """The export's timm names back into the port's ViT names (the fused
    qkv split into its [q; k; v] rows); `pos_embed` is the port's fixed
    buffer, not a parameter, and is left out."""
    out = {}
    for k, v in sd.items():
        if k == "pos_embed":
            continue
        if ".attn.qkv." in k:
            for name, part in zip(("query", "key", "value"), v.chunk(3)):
                out[k.replace("qkv", name)] = part
            continue
        k = k.replace("patch_embed.proj.", "patch_embed.").replace("attn.proj.", "attn.out.")
        out["final_norm." + k[5:] if k.startswith("norm.") else k] = v
    return out


def vit_timm_names(depth: int) -> set:
    """The names `vit_to_timm` gives a ViT of `depth` blocks with a cls
    token: 12 per block and 6 more, 150 for ViT-B/16."""
    names = {"patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token", "pos_embed",
             "norm.weight", "norm.bias"}
    for i in range(depth):
        names |= {f"blocks.{i}.{m}.{leaf}" for leaf in ("weight", "bias") for m in (
            "norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")}
    return names


def host_topk(feats, rows):
    """(scores, ids) of the TOPK rows of each feature by float64 host cosine."""
    sims = feats.astype(np.float64) @ rows.T.astype(np.float64)
    ids = np.argsort(-sims, axis=1)[:, :TOPK]
    return np.take_along_axis(sims, ids, 1), ids


def train_to_serve_phase(ivf_scan, fa, workdir):
    """Phase 12e: train to serve at full width (module docstring), in
    `workdir`; returns (its numbers, this phase's launches by kernel)."""
    from moco_tpu_torch import convert_pretrain, lincls
    from moco_tpu_torch.data.datasets import LearnableSyntheticDataset, SyntheticDataset
    from moco_tpu_torch.models import vit
    from moco_tpu_torch.obs.quality import encoder_digest
    from moco_tpu_torch.obs.schema import read_metrics, validate_file
    from moco_tpu_torch.obs.sinks import JsonlSink
    from moco_tpu_torch.serve.engine import InferenceEngine, load_serving_encoder
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.checkpoint import CheckpointManager
    from moco_tpu_torch.utils.config import PRESETS, ProbeConfig

    out, launches = {}, {}
    phase_t0 = time.perf_counter()

    def lap(what: str) -> None:
        print(f"12e: {what} at {time.perf_counter() - phase_t0:.1f} s", flush=True)

    imgs = np.random.default_rng(SEED + 12).integers(0, 256, (32, IMG, IMG, 3), np.uint8)

    # (a) a v2 checkpoint from the seeded state and data of phase 8, served
    preset = PRESETS["imagenet_v2"]
    v2_dir = os.path.join(workdir, "v2")
    cfg = dataclasses.replace(preset, data=dataclasses.replace(preset.data, dataset="synthetic"),
                              steps_per_epoch=SERVE_V2_STEPS, workdir=v2_dir, knn_every_epochs=0)
    b = cfg.data.global_batch
    run = train(cfg, dataset=SyntheticDataset(num_examples=b * EPOCH_STEPS, image_size=IMG),
                device="cuda", steps=SERVE_V2_STEPS, state=seeded_v2_state(cfg))
    trained = run["state"]
    check(trained.step == SERVE_V2_STEPS and all(np.isfinite(r["loss"]) for r in run["history"]),
          "12e: v2 steps or losses")
    check(CheckpointManager(v2_dir).all_steps() == [SERVE_V2_STEPS], "12e: v2 checkpoint")
    lap("(a) v2 trained and checkpointed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoder, queue, ptr, _ = load_serving_encoder(v2_dir, device="cuda")
    torch.cuda.synchronize()
    out["v2_restore_ms"] = (time.perf_counter() - t0) * 1e3
    same_weights(encoder, trained.encoder_k, "12e: restored key encoder")
    check(torch.equal(queue, trained.queue.cpu()) and ptr == trained.queue_ptr
          == SERVE_V2_STEPS * b, "12e: restored queue or pointer")
    # (b)'s replica process on the same checkpoint, spawned now: it boots
    # beside (a)'s serving, which times nothing of it
    port = free_port()
    log_path = os.path.join(workdir, "replica.log")
    cmd = [sys.executable, "-m", "moco_tpu_torch.serve.replica_main", "--ckpt-dir", v2_dir,
           "--port", str(port), "--buckets", REPLICA_BUCKETS, "--device", "cuda",
           "--workdir", os.path.join(workdir, "replica")]
    log = open(log_path, "w")
    t0_replica = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=log, stderr=subprocess.STDOUT, text=True)
    try:
        del run, trained
        torch.cuda.empty_cache()
        rows = queue.numpy()
        model_step = CheckpointManager(v2_dir).latest_step()
        digest = encoder_digest(encoder)
        engine = InferenceEngine(encoder, IMG, device="cuda")  # bf16, buckets 1/8/32/128
        engine.warmup()
        index = EmbeddingIndex.from_train_queue(queue, ptr, device="cuda")
        out["ivf"] = index.train_ivf(nlist=NLIST, nprobe=NPROBE)
        index.prepare(engine.buckets, TOPK, modes=F32_MODES)
        index.freeze()
        lap("(a) engine warm, IVF trained and prepared")
        sink = JsonlSink(os.path.join(v2_dir, "serve"))
        server = ServeServer(engine, index=index, slo_ms=1000, neighbors_k=TOPK, warmup=False,
                             sink=sink, metrics_flush_s=0.5, workdir=os.path.join(v2_dir, "serve"),
                             model_step=model_step, model_digest=digest)
        try:
            embedded = {n: np.asarray(post(server.port, "/embed", imgs[:n])["embedding"], np.float32)
                        for n in (1, 8, 32)}
            ivf_scan.fused_cell_scores.launches = 0  # the requests' launches from here
            neighbors = {mode: post(server.port, f"/neighbors?mode={mode}", imgs)
                         for mode in F32_MODES}
            launches["ivf_cell_scores"] = ivf_scan.fused_cell_scores.launches
            model = get(server.port, "/admin/model")
            stats = get(server.port, "/stats")
        finally:
            server.close()
            sink.close()
        check(launches["ivf_cell_scores"] > 0, "12e: the ivf_fused requests did not launch the kernel")
        check(model == {"model_step": SERVE_V2_STEPS, "model_digest": digest,
                        "ingest_ckpt_step": None, "replica": 0}, f"12e: /admin/model {model}")
        check(stats["serve/recompiles_after_warmup"] == 0, "12e: recompiles after warmup")
        metrics_path = os.path.join(v2_dir, "serve", "metrics.jsonl")
        errors = validate_file(metrics_path)
        check(errors == [] and read_metrics(metrics_path), f"12e: serve metrics.jsonl {errors[:3]}")
        for n, emb in embedded.items():
            check(np.isfinite(emb).all() and np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-3,
                  f"12e: /embed n={n}")
        feats = engine.forward(torch.from_numpy(imgs).cuda()).cpu().numpy()
        _, per_mode, _ = engine.embed_and_query_modes(imgs, index, TOPK, modes=F32_MODES)
        out["swaps_fused_vs_ivf"] = same_topk(feats, rows, per_mode["ivf_fused"], per_mode["ivf"],
                                              "12e: ivf_fused vs ivf")
        out["swaps_exact_vs_oracle"] = same_topk(feats, rows, per_mode["exact"],
                                                 host_topk(feats, rows), "12e: exact vs host oracle")
        # the HTTP answer against the oracle of its own embeddings: the batcher's
        # thread may round the bf16 forward otherwise than this one
        http_emb = np.asarray(neighbors["exact"]["embedding"], np.float32)
        out["swaps_http_exact_vs_oracle"] = same_topk(
            http_emb, rows, (np.asarray(neighbors["exact"]["scores"]),
                             np.asarray(neighbors["exact"]["indices"])),
            host_topk(http_emb, rows), "12e: /neighbors exact vs host oracle")
        out["http_vs_in_process_max_abs"] = float(np.abs(http_emb - feats).max())
        out["ivf_recall_vs_exact"] = float(np.mean(
            [len(set(a) & set(b)) / TOPK for a, b in zip(per_mode["ivf"][1], per_mode["exact"][1])]))
        f32_feats, _ = InferenceEngine(encoder, IMG, device="cuda", dtype=torch.float32).embed(imgs)
        out["bf16_vs_f32_min_cosine"] = float((f32_feats * feats).sum(1).min())
        check(out["bf16_vs_f32_min_cosine"] >= 0.99, f"12e: bf16 vs f32 engine {out}")
        emb8, _, ids8, _ = engine.embed_and_query(imgs[:8], index, TOPK)  # bucket 8, as the replica
        del index, engine
        torch.cuda.empty_cache()
        lap("(a) served and checked")

        # (b) the replica process on the same checkpoint
        while True:
            check(proc.poll() is None, "12e: the replica exited before it served")
            check(time.perf_counter() - t0_replica < 300, "12e: the replica never became healthy")
            try:
                health = get(port, "/healthz", timeout=2)
                break
            except OSError:
                time.sleep(0.1)
        out["replica_spawn_to_healthy_s"] = time.perf_counter() - t0_replica
        lap("(b) replica healthy")
        check(health["ok"] and health["warm"], f"12e: replica /healthz {health}")
        rep = post(port, "/neighbors", imgs[:8])  # the replica's default tier: exact
        rep_emb = np.asarray(rep["embedding"], np.float32)
        out["replica_min_cosine"] = float((rep_emb * emb8).sum(1).min())
        check(out["replica_min_cosine"] >= 0.999, f"12e: replica /embed rows {out}")
        out["replica_exact_swaps"] = ids_agree(rep_emb, np.asarray(rep["indices"]), emb8,
                                               ids8, rows, "12e: replica exact ids")
        check(get(port, "/admin/model")["model_digest"] == digest, "12e: replica digest")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    with open(log_path) as f:
        replica_log = f.read()
    check(rc == 0 and "drained (clean)" in replica_log, f"12e: replica exit {rc}: "
          f"{replica_log[-2000:]}")
    errors = validate_file(os.path.join(workdir, "replica", "metrics.jsonl"))
    check(errors == [], f"12e: replica metrics.jsonl {errors[:3]}")
    del encoder, queue, rows
    torch.cuda.empty_cache()
    lap("(b) replica drained")

    # (c) a v3 checkpoint (flash attention), served without a queue
    preset = PRESETS["vit_b16_v3"]
    v3_dir = os.path.join(workdir, "v3")
    cfg3 = dataclasses.replace(
        preset, moco=dataclasses.replace(preset.moco, vit_flash_attention=True),
        data=dataclasses.replace(preset.data, dataset="synthetic", global_batch=V3_BATCH),
        steps_per_epoch=SERVE_V3_STEPS, workdir=v3_dir, knn_every_epochs=0)
    run = train(cfg3, dataset=SyntheticDataset(image_size=IMG), device="cuda",
                steps=SERVE_V3_STEPS, state=seeded_v3_state(cfg3))
    trained = run["state"]
    check(trained.step == SERVE_V3_STEPS and all(np.isfinite(r["loss"]) for r in run["history"]),
          "12e: v3 steps or losses")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoder, queue, ptr, _ = load_serving_encoder(v3_dir, device="cuda")
    torch.cuda.synchronize()
    out["v3_restore_ms"] = (time.perf_counter() - t0) * 1e3
    check(queue is None and ptr == 0, "12e: a v3 checkpoint gave a queue")
    same_weights(encoder, trained.encoder_k, "12e: restored v3 key encoder")
    del run, trained
    torch.cuda.empty_cache()
    lap("(c) v3 trained, checkpointed and restored")
    depth = len(encoder.backbone.blocks)
    engine = InferenceEngine(encoder, IMG, device="cuda")
    forwards = count_forwards(engine)
    zero_flash(fa)  # the phase's flash launches from here: serving, probe, export
    engine.warmup()
    server = ServeServer(engine, index=None, slo_ms=1000, warmup=False)
    try:
        vit_emb = np.asarray(post(server.port, "/embed", imgs[:8])["embedding"], np.float32)
        try:
            post(server.port, "/neighbors", imgs[:8])
            status = 200
        except urllib.error.HTTPError as e:
            status = e.code
            e.close()
    finally:
        server.close()
    check(status == 503, f"12e: v3 /neighbors answered {status}, not 503")
    check(np.isfinite(vit_emb).all() and vit_emb.shape == (8, cfg3.moco.dim), "12e: v3 /embed")
    out["vit_engine_ms"] = {b: host_ms(lambda b=b: engine.embed(imgs[:b])) for b in (1, 8, 32)}
    served = flash_kernel_launches(fa)
    check(fa.flash_forward.launches == depth * forwards["n"]
          and served["flash_fwd_mma_kernel"] == fa.flash_forward.launches
          and sum(served.values()) == fa.flash_forward.launches,
          f"12e: ViT serving flash launches {served} over {forwards['n']} forwards")
    out["vit_serving"] = {"forwards": forwards["n"], "flash_fwd_launches": served}
    kernel_attention = vit.flash_attention
    vit.flash_attention = lambda q, k, v, scale=None: fa.attention_reference(
        q, k, v, q.shape[-1] ** -0.5)[0]
    try:
        plain, _ = InferenceEngine(encoder, IMG, buckets=(8,), device="cuda",
                                   dtype=torch.float32).embed(imgs[:8])
    finally:
        vit.flash_attention = kernel_attention
    out["vit_vs_plain_f32_min_cosine"] = float((plain * vit_emb).sum(1).min())
    check(out["vit_vs_plain_f32_min_cosine"] >= 0.99, f"12e: ViT vs plain attention {out}")
    del engine, encoder
    torch.cuda.empty_cache()
    lap("(c) ViT served and checked")

    # (d) the ViT probe and its evaluation
    probe_dir = os.path.join(workdir, "v3_probe")
    val = LearnableSyntheticDataset(PROBE_VAL, IMG, train=False)
    probe = ProbeConfig(epochs=PROBE_EPOCHS, num_classes=8)
    before = fa.flash_forward.launches
    t0 = time.perf_counter()
    res = lincls.train_lincls(v3_dir, probe, train_dataset=LearnableSyntheticDataset(512, IMG),
                              val_dataset=val, workdir=probe_dir, device="cuda")
    out["vit_probe_run_s"] = time.perf_counter() - t0  # sanity_check passed inside
    losses = [r["loss"] for r in read_metrics(os.path.join(probe_dir, "metrics.jsonl"))
              if r.get("split") == "train"]
    check(losses and all(np.isfinite(losses)) and np.isfinite(res["loss"])
          and res["count"] == PROBE_VAL, f"12e: ViT probe {res}, train losses {losses}")
    best = lincls.evaluate_lincls(v3_dir, workdir=probe_dir, val_dataset=val, device="cuda")
    check(best["acc1"] == res["best_acc1"], f"12e: evaluate_lincls {best} vs {res}")
    out["vit_probe_top1"] = res["best_acc1"]
    backbone, pretrained, _ = lincls.load_pretrained_backbone(v3_dir, device="cuda")
    fc = lincls.LinearClassifier(backbone.num_features, 8).cuda()
    optimizer, schedule = lincls._probe_tx(probe, 2, fc.parameters())
    step = lincls.make_probe_step(backbone, fc, optimizer, schedule, "bfloat16")
    evaluate = lincls.make_eval_step(backbone, fc, "bfloat16")
    x = torch.randn(256, IMG, IMG, 3, device="cuda")
    y = torch.randint(0, 8, (256,), device="cuda")
    out["vit_probe_imgs_per_s"] = 256 / host_ms(lambda: step(0, x, y)) * 1e3
    out["vit_eval_imgs_per_s"] = 256 / host_ms(lambda: evaluate(x, y, torch.ones(256, device="cuda"))) * 1e3
    lincls.sanity_check(backbone, pretrained)
    probe_launches = fa.flash_forward.launches - before
    check(probe_launches > 0, "12e: the ViT probe launched no flash forward")
    lap("(d) ViT probed")

    # (e) the ViT export to timm names
    pth = os.path.join(workdir, "vit_b16.pth")
    convert_pretrain.main([v3_dir, pth])
    sd = torch.load(pth, weights_only=True)
    names = vit_timm_names(depth)
    check(set(sd) == names and (cfg3.moco.arch != "vit_b16" or len(sd) == 150),
          f"12e: export names {sorted(set(sd) ^ names)[:6]}")
    out["export_tensors"] = len(sd)
    block = backbone.blocks[0].attn
    xt = torch.randn(64, backbone.hidden_dim, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(SEED))
    fused = xt @ sd["blocks.0.attn.qkv.weight"].cuda().T + sd["blocks.0.attn.qkv.bias"].cuda()
    with torch.no_grad():
        parts = torch.cat([p(xt) for p in (block.query, block.key, block.value)], dim=1)
    out["export_qkv_max_abs_diff"] = (fused - parts).abs().max().item()
    check(out["export_qkv_max_abs_diff"] <= 1e-5 * parts.abs().max().item() + 1e-6,
          f"12e: export qkv {out['export_qkv_max_abs_diff']}")
    exported = vit.create_vit(cfg3.moco.arch, image_size=IMG, use_flash_attention=True,
                              patch_size=backbone.patch_size)
    exported.load_state_dict(timm_to_vit(sd), strict=True)
    check(torch.equal(sd["pos_embed"], exported.pos_embed), "12e: exported pos_embed")
    exported = exported.to("cuda", memory_format=torch.channels_last).eval()
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        check(torch.equal(exported(x[:8]), backbone(x[:8])), "12e: the export's features differ")
    launches["flash_fwd"] = fa.flash_forward.launches
    totals = flash_kernel_launches(fa)
    check(totals["flash_fwd_mma_kernel"] == launches["flash_fwd"]
          and fa.flash_dq.launches == fa.flash_dkv.launches == 0,
          f"12e: flash launches {totals}, dq {fa.flash_dq.launches}, dkv {fa.flash_dkv.launches}")
    out["flash_fwd_launches"] = {"serving": served, "probe_and_eval": probe_launches,
                                 "all": totals}
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"train to serve in {out['phase_s']:.1f} s: restore v2 {out['v2_restore_ms']:.1f} ms, "
          f"v3 {out['v3_restore_ms']:.1f} ms; replica healthy after "
          f"{out['replica_spawn_to_healthy_s']:.1f} s; ViT engine ms {out['vit_engine_ms']}; "
          f"ViT probe {out['vit_probe_imgs_per_s']:.0f} imgs/s; launches {launches}", flush=True)
    return out, launches


# ------------------------------------------------------------ observability

OBS_PROBE_EVERY = 5  # 12f(a): a probe sample every 5 steps
OBS_REQUESTS, OBS_CLIENTS, OBS_SLO_MS = 64, 4, 100.0  # 12f(c)
BURN_ALERTS = ("alert:slo_burn_fast", "alert:slo_burn_slow")  # obs/slo.py's burn rules


def sync_warnings_in(step_fn, seen: list):
    """`step_fn` with CUDA's sync debug mode on ("warn") around each call:
    every synchronizing call inside it warns, and the warnings raised on
    the calling thread while it runs are appended to `seen`."""
    import threading
    import warnings

    def run(state, batch):
        me = threading.current_thread()
        shown = warnings.showwarning

        def record(message, category, filename, lineno, file=None, line=None):
            if threading.current_thread() is me:
                seen.append(f"{filename}:{lineno}: {message}")
            else:
                shown(message, category, filename, lineno, file, line)

        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                return step_fn(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def timed_dispatches(step_fn, stamps: list):
    """`step_fn` that appends the host clock at each call's start."""
    def run(state, batch):
        stamps.append(time.perf_counter())
        return step_fn(state, batch)
    return run


def observability_phase(fi, ivf_scan, workdir):
    """Phase 12f: training telemetry, the in-flight window against a wait
    after every step, and the serving request waterfall (module docstring),
    in `workdir`; returns (its readings, its kernel launches)."""
    import threading

    from moco_tpu_torch import train as train_module
    from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
    from moco_tpu_torch.core.moco import build_encoder
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.obs import sinks as obs_sinks
    from moco_tpu_torch.obs.flight import read_flight_dumps
    from moco_tpu_torch.obs.reqtrace import STAGES
    from moco_tpu_torch.obs.schema import read_metrics, validate_file
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.utils import faults
    from moco_tpu_torch.utils.config import PRESETS

    out, launches = {}, {}
    phase_t0 = time.perf_counter()
    preset = PRESETS["imagenet_v2"]
    base = dataclasses.replace(preset, data=dataclasses.replace(preset.data, dataset="synthetic"))
    b = base.data.global_batch
    dataset = SyntheticDataset(num_examples=b * EPOCH_STEPS, image_size=IMG)
    seeded = seeded_v2_state(base)
    steps = TRAIN_WARMUP + TRAIN_TIMED

    # (a) the run's telemetry: sinks, /metrics, the probe, the trace
    a_dir = os.path.join(workdir, "a")
    try:
        obs_sinks.TensorBoardSink(os.path.join(workdir, "tb_probe")).close()
        tb = True
    except RuntimeError as e:  # no writer on this machine: JAX's error, and no other
        check(str(e).startswith("TensorBoardSink needs `tensorboardX` or `torch`"), f"tb: {e}")
        tb = False
    peaks = []

    class PeakCheck(obs_sinks.Sink):
        """Each training line's hbm_peak_bytes beside the allocator's peak
        read as the line is written."""

        def __init__(self, workdir):
            del workdir

        def write(self, step, payload):
            if "loss" in payload:
                peaks.append((payload["hbm_peak_bytes"], torch.cuda.max_memory_allocated()))

    obs_sinks.register_sink("peakcheck", PeakCheck)
    metrics_port = free_port()
    cfg = dataclasses.replace(
        base, workdir=a_dir, log_every=1, obs_probe_every=OBS_PROBE_EVERY,
        sinks="jsonl,csv" + (",tensorboard" if tb else "") + ",peakcheck",
        metrics_port=metrics_port, steps_per_epoch=EPOCH_STEPS)
    scrape, sync_seen = {}, []

    def on_a(rec):
        if rec["step"] == steps // 2:  # while the run goes, from the log callback's thread
            with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics",
                                        timeout=30) as r:
                scrape["text"] = r.read().decode()

    make = train_module.make_train_step
    train_module.make_train_step = lambda *a, **kw: sync_warnings_in(make(*a, **kw), sync_seen)
    fi.infonce_stats.launches = fi.infonce_dq.launches = 0  # counts from here on are the path's
    try:
        torch.cuda.reset_peak_memory_stats()
        run_a = train_module.train(cfg, dataset=dataset, device="cuda", steps=steps,
                                   state=copy.deepcopy(seeded), log=on_a)
    finally:
        train_module.make_train_step = make
        obs_sinks.SINK_REGISTRY.pop("peakcheck")
    launches["a"] = {"infonce_fwd": fi.infonce_stats.launches,
                     "infonce_bwd": fi.infonce_dq.launches}
    check(launches["a"] == {"infonce_fwd": steps, "infonce_bwd": steps},
          f"12f(a): InfoNCE launches {launches['a']} over {steps} steps")
    check(all(np.isfinite(r["loss"]) for r in run_a["history"]), "12f(a): finite losses")
    metrics_path = os.path.join(a_dir, "metrics.jsonl")
    errors = validate_file(metrics_path)
    check(errors == [], f"12f(a): metrics.jsonl schema: {errors[:3]}")
    lines = [r for r in read_metrics(metrics_path) if "loss" in r]
    check([r["step"] for r in lines] == list(range(1, steps + 1)), "12f(a): one line per step")
    check(all(k in r for r in lines for k in ("t_data", "t_step", "t_dispatch", "t_device",
                                               "hbm_live_bytes", "hbm_state_bytes")),
          "12f(a): a line lacks the probe's or the memory gauges' fields")
    # the ring's thread may allocate between a line's read and its write;
    # at the last line the ring has made its last batch
    check(len(peaks) == steps and all(line <= now for line, now in peaks)
          and peaks[-1][0] == peaks[-1][1],
          f"12f(a): hbm_peak_bytes against max_memory_allocated: {peaks}")
    with open(os.path.join(a_dir, "metrics.csv"), newline="") as f:
        import csv
        rows = list(csv.DictReader(f))
    all_lines = read_metrics(metrics_path)
    check(len(rows) == len(all_lines) and all(
        row[k] == (json.dumps(v) if isinstance(v, (list, dict)) else "" if v is None else str(v))
        for row, line in zip(rows, all_lines) for k, v in line.items() if k != "time"),
        "12f(a): the CSV's rows differ from metrics.jsonl")
    check("moco_loss " in scrape.get("text", ""), "12f(a): /metrics scrape holds no loss gauge")
    with open(os.path.join(a_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    epochs = [e for e in events if e["name"] == "epoch"]
    inner = [e for e in events if e["name"] in ("step", "data_wait", "device_wait")]
    check(all(any(ep["tid"] == e["tid"] and ep["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= ep["ts"] + ep["dur"] + 1.0 for ep in epochs)
              for e in inner), "12f(a): a step span outside every epoch span")
    sampled = sorted({e["args"]["step"] for e in inner if e["name"] == "device_wait"})
    check(sampled == [s for s in range(steps) if s % OBS_PROBE_EVERY == 0],
          f"12f(a): device_wait on steps {sampled}")
    check(sync_seen == [], f"12f(a): the step function synchronized: {sync_seen[:3]}")
    hist = run_a["history"]
    out["a"] = {
        "sinks": cfg.sinks, "tensorboard": tb, "lines": len(lines),
        "t_data_ms_median": float(np.median([r["t_data"] for r in lines])) * 1e3,
        "t_step_ms_median": float(np.median([r["t_step"] for r in lines[TRAIN_WARMUP:]])) * 1e3,
        "t_dispatch_ms_sampled": [r["t_dispatch"] * 1e3 for r in hist if "t_dispatch" in r],
        "t_device_ms_sampled": [r["t_device"] * 1e3 for r in hist if "t_device" in r],
        "hbm_peak_bytes": lines[-1]["hbm_peak_bytes"],
        "hbm_state_bytes": lines[-1]["hbm_state_bytes"],
        "hbm_headroom_bytes": lines[-1]["hbm_headroom_bytes"],
        "step_sync_warnings": len(sync_seen), "trace_spans": len(events)}

    # (b) the window against a wait after every step, from the same state and data
    runs = {}
    fi.infonce_stats.launches = fi.infonce_dq.launches = 0
    for label, every in (("window", 0), ("every", 1), ("every_again", 1)):
        stamps = []
        train_module.make_train_step = lambda *a, _s=stamps, **kw: timed_dispatches(
            make(*a, **kw), _s)
        try:
            rcfg = dataclasses.replace(base, obs_probe_every=every, steps_per_epoch=EPOCH_STEPS)
            run = train_module.train(rcfg, dataset=dataset, device="cuda", steps=steps + 2,
                                     state=copy.deepcopy(seeded))
        finally:
            train_module.make_train_step = make
        runs[label] = run
        # the timed steps: from the first timed step's dispatch to the one
        # after the last's (the window keeps dispatch at the card's pace)
        wall = stamps[TRAIN_WARMUP + TRAIN_TIMED] - stamps[TRAIN_WARMUP]
        out.setdefault("b", {})[f"imgs_per_s_{label}"] = TRAIN_TIMED * b / wall
    launches["b"] = {"infonce_fwd": fi.infonce_stats.launches,
                     "infonce_bwd": fi.infonce_dq.launches}
    check(launches["b"] == {"infonce_fwd": 3 * (steps + 2), "infonce_bwd": 3 * (steps + 2)},
          f"12f(b): InfoNCE launches {launches['b']}")
    loss = {k: np.asarray([r["loss"] for r in run["history"]]) for k, run in runs.items()}
    gap = float(np.max(np.abs(loss["every"] - loss["every_again"])))
    diff = float(np.max(np.abs(loss["window"] - loss["every"])))
    tol = max(2.0 ** -7 * float(np.max(np.abs(loss["every"]))), gap)
    timed_hist = runs["every"]["history"][TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
    out["b"].update({
        "t_dispatch_ms_median": float(np.median([r["t_dispatch"] for r in timed_hist])) * 1e3,
        "t_device_ms_median": float(np.median([r["t_device"] for r in timed_hist])) * 1e3,
        "step_ms_median_every": float(np.median([r["step_ms"] for r in timed_hist])),
        "loss_max_diff_window_vs_every": diff, "loss_max_diff_every_vs_every": gap,
        "loss_tolerance": tol})
    check(diff <= tol, f"12f(b): losses differ by {diff} > {tol} (every-step runs {gap} apart)")
    for k in ("every", "every_again"):
        check((runs[k]["state"].queue_ptr, runs[k]["state"].step)
              == (runs["window"]["state"].queue_ptr, runs["window"]["state"].step),
              f"12f(b): final queue_ptr / step differ ({k})")
    print(f"12f(b): imgs/s window {out['b']['imgs_per_s_window']:.1f}, wait every step "
          f"{out['b']['imgs_per_s_every']:.1f} / {out['b']['imgs_per_s_every_again']:.1f}; "
          f"t_dispatch {out['b']['t_dispatch_ms_median']:.2f} ms, t_device "
          f"{out['b']['t_device_ms_median']:.2f} ms; loss gap {diff:.3g} (every-step runs "
          f"{gap:.3g} apart)", flush=True)
    del runs, run_a, seeded
    torch.cuda.empty_cache()

    # (c) the request waterfall behind phase 4's engine and index
    params, stats = random_flax_encoder(base.moco, seed=SEED)
    model = build_encoder(base.moco)
    model.load_state_dict(encoder_from_flax(params, stats))
    rng = np.random.default_rng(SEED)
    rows = unit_rows(rng, K, DIM)
    engine = InferenceEngine(model, IMG, device="cuda")
    engine.warmup()
    index = EmbeddingIndex(K, DIM, device="cuda")
    index.snapshot(rows)
    index.train_ivf(nlist=NLIST, nprobe=NPROBE)
    index.prepare(engine.buckets, TOPK, modes=F32_MODES)
    index.freeze()
    reqs = [rng.integers(0, 256, (2, IMG, IMG, 3), np.uint8) for _ in range(OBS_REQUESTS)]

    def serve(server, path="/neighbors?mode=ivf_fused"):
        """Every request from OBS_CLIENTS client threads: (responses,
        client-side latencies in ms), in request order."""
        got, lat = [None] * len(reqs), [None] * len(reqs)

        def client(k):
            for j in range(k, len(reqs), OBS_CLIENTS):
                t0 = time.perf_counter()
                got[j] = post(server.port, path, reqs[j])
                lat[j] = (time.perf_counter() - t0) * 1e3

        threads = [threading.Thread(target=client, args=(k,)) for k in range(OBS_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(all(g is not None for g in got), "12f(c): a request went unanswered")
        return got, lat

    c_dir = os.path.join(workdir, "c")
    sink = obs_sinks.JsonlSink(c_dir)
    server = ServeServer(engine, index=index, port=0, slo_ms=OBS_SLO_MS, neighbors_k=TOPK,
                         neighbors_mode="ivf_fused", warmup=False, reqtrace=True, sink=sink,
                         metrics_flush_s=0.25, workdir=c_dir, alert_spec="serve_default",
                         recall_sample_every=4)
    try:
        # one request before the counted ones (the batcher thread warms itself
        # before the port is bound: phase 12g(d))
        warm = post(server.port, "/neighbors?mode=ivf_fused", reqs[0])
        ivf_scan.fused_cell_scores.launches = 0  # counts from here on are the path's
        answers, _ = serve(server)
        launches["c"] = {"ivf_cell_scores": ivf_scan.fused_cell_scores.launches}
        time.sleep(0.6)  # a flush after the last request
        flight = get(server.port, "/debug/flight")
        slow_ms = 2 * OBS_SLO_MS
        # the warm-up request alone may have burned the budget already
        earlier = {path for path, _ in read_flight_dumps(c_dir)}
        faults.install(f"slow@site=serve.engine_execute:ms={slow_ms:g}")
        try:
            slowed, _ = serve(server)
        finally:
            faults.clear()
        deadline = time.time() + 15.0
        while time.time() < deadline and not any(
                path not in earlier and rec.get("reason") in BURN_ALERTS
                for path, rec in read_flight_dumps(c_dir)):
            time.sleep(0.1)
    finally:
        server.close()
        sink.close()
    check(launches["c"]["ivf_cell_scores"] > 0, "12f(c): the requests launched no cell scan")
    ids = [a["request_id"] for a in [warm] + answers + slowed]
    check(len(set(ids)) == len(ids), "12f(c): request ids repeat")
    errors = validate_file(os.path.join(c_dir, "metrics.jsonl"))
    check(errors == [], f"12f(c): metrics.jsonl schema: {errors[:3]}")
    slines = read_metrics(os.path.join(c_dir, "metrics.jsonl"))
    stages = ("queue_wait", "batch_assemble", "engine_execute", "index_query", "scatter")
    traced = [r for r in slines if all(f"serve/trace_{s}_ms" in r for s in stages)]
    check(traced and all(r.get("serve/burn_rate_60s") is not None for r in traced),
          "12f(c): no line with the five stage means and the burn rates")
    recall = [r["serve/recall_estimate"] for r in slines
              if r.get("serve/recall_estimate") is not None]
    check(recall, "12f(c): no recall estimate")
    worst = max(abs(sum(s["dur_ms"] for s in w["stages"]) - w["total_ms"])
                - max(0.05 * w["total_ms"], 1.0) for w in flight["requests"])
    check(len(flight["requests"]) == OBS_REQUESTS + 1 and worst <= 0,
          f"12f(c): a request's stage sum is off its total_ms by {worst:.3f} ms past the limit")
    alerts = [rec for path, rec in read_flight_dumps(c_dir)
              if path not in earlier and rec.get("reason") in BURN_ALERTS]
    check(alerts, "12f(c): no burn alert dumped the flight recorder after the slow fault")
    # the dump's slowest requests include slowed ones, and each of those
    # blames engine_execute for at least the injected time
    slowed_ids = {a["request_id"] for a in slowed}
    blamed = [{s["stage"]: s["dur_ms"] for s in w["stages"]} for w in alerts[0]["slowest"]
              if w["request_id"] in slowed_ids]
    check(blamed and all(max(st, key=st.get) == "engine_execute"
                         and st["engine_execute"] >= slow_ms for st in blamed),
          f"12f(c): the dump's slowed requests do not blame engine_execute: {blamed[:2]}")

    # the tracing cost: the same requests with reqtrace on and off, in turns
    # on two servers (each new batcher thread pays its own warm pass)
    lat, servers = {True: [], False: []}, {}
    try:
        for on in (True, False):
            servers[on] = ServeServer(engine, index=index, port=0, slo_ms=OBS_SLO_MS,
                                      neighbors_k=TOPK, neighbors_mode="ivf_fused", warmup=False,
                                      reqtrace=on, alert_spec="serve_default" if on else "")
            post(servers[on].port, "/neighbors?mode=ivf_fused", reqs[0])  # the thread's warm-up
        for on in (True, False, False, True):
            lat[on] += serve(servers[on])[1]
    finally:
        for server in servers.values():
            server.close()
    pct = {on: (float(np.percentile(v, 50)), float(np.percentile(v, 99))) for on, v in lat.items()}
    out["c"] = {
        "requests": len(ids), "launches": launches["c"]["ivf_cell_scores"],
        # each stage's median over the clean requests (/debug/flight)
        "trace_stage_ms_median": {s: float(np.median([
            sum(x["dur_ms"] for x in w["stages"] if x["stage"] == s)
            for w in flight["requests"][1:]])) for s in STAGES},
        "total_ms_median": float(np.median([w["total_ms"] for w in flight["requests"][1:]])),
        "recall_estimate": recall[-1], "alert": alerts[0]["reason"],
        "warm_up_request_engine_execute_ms": next(
            x["dur_ms"] for x in flight["requests"][0]["stages"]
            if x["stage"] == "engine_execute"),
        "slowest_engine_execute_ms": [st["engine_execute"] for st in blamed[:3]],
        "stage_sum_worst_excess_ms": worst,
        "p50_ms_traced": pct[True][0], "p99_ms_traced": pct[True][1],
        "p50_ms_untraced": pct[False][0], "p99_ms_untraced": pct[False][1],
        "trace_overhead_pct_p50": (pct[True][0] / pct[False][0] - 1.0) * 100.0}
    del server, engine, index, model
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"observability in {out['phase_s']:.1f} s: window {out['b']['imgs_per_s_window']:.1f} "
          f"vs every step {out['b']['imgs_per_s_every']:.1f} imgs/s; /neighbors p50 "
          f"{pct[True][0]:.2f} ms traced, {pct[False][0]:.2f} untraced; launches {launches}",
          flush=True)
    return out, launches


# ------------------------------------------------------------ serving, the rest

I8_MODES = ("exact_i8", "ivf_i8", "ivf_fused_i8")
I8_SCORE_TOL = 0.02  # JAX's rescale bound on an int8 score (tests/test_serve_ivf.py:142-159)
I8_RECALL_SLACK = 0.02  # what the IVF twins may lose in int8 beyond the f32 ivf_fused
QUANT_COSINE_FLOOR = 0.99  # JAX's floor for a quantized tier (scripts/perf_ledger.py:48)
CALIB_N = 256  # 12g(b): held-out images behind the w8a8 calibration
G_REQUESTS, G_RIDERS, G_CLIENTS = 48, 12, 4  # 12g(c): /neighbors requests, int8 riders, threads
INGEST_BLOCK = 8192  # serve_ingest's rows per POST in 12g(c): 9 POSTs for its 66304 rows
# 12g(c): the replica's freshness objective, above its spawn-to-ingest time
# (its rows are stamped at its start), and the stall of an ingest past it
# (the replica is stopped once the burn alert fires, ~1/6 of its 60 s
# window's observations bad past the objective: the stall's end is a bound)
FRESH_MAX_AGE_S, STALL_S = 20.0, 90.0
FIRST_FLUSH_NEXT, FIRST_FLUSH_RATIO = 16, 3.0  # 12g(d)
# 12m(b): the lock-order bursts (module docstring); serve.metrics is taken
# under serve.index, so its inverted edge closes the cycle
TSAN_REQUESTS, TSAN_SLO_MS, TSAN_DEADLOCK_LOCK = 24, 40.0, "serve.metrics"


def on_thread(fn):
    """`fn()` run on a new thread; its result."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in box:
        raise box["error"]
    return box["value"]


def sync_ms(fn) -> float:
    """Wall ms of `fn()` ending in a device sync."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def int8_index_part(feats_t, out):
    """12g(a): the int8 tiers of phase 4's index against its f32 tiers and
    a float64 oracle; returns the index (int8-enabled, every tier prepared
    for the engine's buckets, frozen)."""
    from moco_tpu_torch.ops.int8 import int8_matmul
    from moco_tpu_torch.serve.index import QUERY_MODES, EmbeddingIndex, _quantize_rows_int8

    rows = unit_rows(np.random.default_rng(SEED), K, DIM)  # phase 4's rows
    index = EmbeddingIndex(K, DIM, device="cuda")
    index.snapshot(rows)
    index.train_ivf(nlist=NLIST, nprobe=NPROBE)
    index.enable_int8()
    index.prepare(BUCKETS, TOPK, modes=QUERY_MODES)
    index.freeze()
    feats = feats_t.cpu().numpy()
    sims = feats.astype(np.float64) @ rows.T.astype(np.float64)
    hits = {mode: [] for mode in ("ivf_fused", "ivf_i8", "ivf_fused_i8")}
    err, recall = {}, {}
    for m in BUCKETS:
        got = {mode: index.query(feats_t[:m], TOPK, mode=mode) for mode in QUERY_MODES}
        for mode in I8_MODES:
            s, ids = got[mode]
            check(((ids >= 0) & (ids < K)).all(), f"12g(a): {mode} m={m} ids out of range")
            e = float(np.abs(s - np.take_along_axis(sims[:m], ids, 1)).max())
            err[mode] = max(err.get(mode, 0.0), e)
            check(e <= I8_SCORE_TOL, f"12g(a): {mode} m={m} score {e:.4f} off the f32 cosine")
        for mode, ref in (("ivf_fused", "exact"), ("ivf_i8", "exact_i8"),
                          ("ivf_fused_i8", "exact_i8")):
            hits[mode] += [len(set(a) & set(b)) / TOPK
                           for a, b in zip(got[mode][1], got[ref][1])]
        recall[m] = {mode: float(np.mean(hits[mode][-m:])) for mode in hits}
        recall[m]["exact_i8_vs_exact"] = float(np.mean(
            [len(set(a) & set(b)) / TOPK for a, b in zip(got["exact_i8"][1], got["exact"][1])]))
    pooled = {mode: float(np.mean(v)) for mode, v in hits.items()}
    for mode in ("ivf_i8", "ivf_fused_i8"):
        check(pooled[mode] >= pooled["ivf_fused"] - I8_RECALL_SLACK,
              f"12g(a): {mode} recall {pooled[mode]:.3f} vs ivf_fused {pooled['ivf_fused']:.3f}")
    q8, _ = _quantize_rows_int8(feats_t)
    acc = int8_matmul(q8, index._rows_i8)[:, :K]
    emulated = q8.double() @ index._rows_i8[:K, :DIM].double().T
    check(torch.equal(acc.double(), emulated), "12g(a): exact_i8's _int_mm accumulators "
          "differ from the float64 emulation")
    out["index"] = {
        "score_err_max": err, "recall_by_m": recall, "recall_pooled": pooled,
        "int_mm_accumulators_bit_equal": True, "bytes": index.int8_bytes,
        "host_ms": {mode: {m: host_ms(lambda m=m, mode=mode: index.query(
            feats_t[:m], TOPK, mode=mode)) for m in BUCKETS} for mode in QUERY_MODES},
    }
    print(f"12g(a): recall pooled {pooled}; int8 score error {err}; bytes {index.int8_bytes}; "
          f"host ms {out['index']['host_ms']}", flush=True)
    return index


def capture_accumulators(engine, raw):
    """Each int8 layer's accumulator of one forward of `raw`, in order."""
    from moco_tpu_torch.serve.quant import _Int8Layer

    layers = [m for m in engine.module.modules() if isinstance(m, _Int8Layer)]
    accs: list = []
    for m in layers:
        m.capture = accs
    try:
        engine.forward(raw)
    finally:
        for m in layers:
            m.capture = None
    return accs


def engine_tiers_part(encoder, workdir, out):
    """12g(b): the off, w8 and w8a8 engines against an f32 one; returns
    {tier: engine} (warm, buckets 1/8/32/128)."""
    from moco_tpu_torch.serve import quant
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.serve.quant import _Int8Layer

    held_out = np.random.default_rng(SEED + 14).integers(0, 256, (CALIB_N, IMG, IMG, 3), np.uint8)
    imgs = np.random.default_rng(SEED + 15).integers(0, 256, (128, IMG, IMG, 3), np.uint8)
    t0 = time.perf_counter()
    calib = quant.calibrate_encoder(encoder, held_out, IMG)
    out["calibration_s"] = time.perf_counter() - t0
    path = quant.save_calibration(workdir, calib)
    loaded = quant.load_calibration(path)
    check(loaded == calib and json.dumps(loaded, sort_keys=True) == json.dumps(calib, sort_keys=True),
          "12g(b): the calibration artifact did not read back bitwise")
    quant.validate_calibration(loaded, encoder, IMG)
    f32 = InferenceEngine(encoder, IMG, device="cuda", dtype=torch.float32)
    engines = {"off": InferenceEngine(encoder, IMG, device="cuda"),
               "w8": InferenceEngine(encoder, IMG, device="cuda", engine_quant="w8"),
               "w8a8": InferenceEngine(encoder, IMG, device="cuda", engine_quant="w8a8",
                                       calibration=loaded)}
    check(engines["w8a8"].int8_compute and engines["w8a8"].dtype == torch.float32,
          "12g(b): the w8a8 engine does not run true int8 products in f32")
    ref = {}
    for n in BUCKETS:
        ref[n], _ = f32.embed(imgs[:n])
    cosine = {}
    for tier, eng in engines.items():
        eng.warmup()
        cosine[tier] = {}
        for n in BUCKETS:
            emb, executed = eng.embed(imgs[:n])
            check(executed == [(n, n)] and eng.recompiles_after_warmup == 0,
                  f"12g(b): {tier} bucket {n} executed {executed} or recompiled")
            cosine[tier][n] = float((emb * ref[n]).sum(1).min())
            check(np.isfinite(emb).all() and cosine[tier][n] >= QUANT_COSINE_FLOOR,
                  f"12g(b): {tier} bucket {n} min cosine to f32 {cosine[tier][n]:.5f}")
        if tier != "off":
            check(eng.int8_audit() == {b: True for b in BUCKETS},
                  f"12g(b): {tier} int8 tensors moved or changed: {eng.int8_audit()}")
    # the int8 route against its emulation: float64 sums bit for bit, f32 within 1e-5
    raw8 = torch.from_numpy(imgs[:8]).cuda()
    emu = {dt: InferenceEngine(encoder, IMG, buckets=(8,), device="cuda", engine_quant="w8a8",
                               calibration=loaded, int8_compute=False) for dt in ("f64", "f32")}
    for m in emu["f64"].module.modules():
        if isinstance(m, _Int8Layer):
            m.emulation_dtype = torch.float64
    got, want = capture_accumulators(engines["w8a8"], raw8), capture_accumulators(emu["f64"], raw8)
    check(len(got) == len(want) == len(calib["amax"]) and all(
        a.dtype == torch.int32 and torch.equal(a.double(), b) for a, b in zip(got, want)),
        "12g(b): an int8 layer's accumulator differs from the float64 emulation")
    del got, want
    route_err = float((engines["w8a8"].forward(raw8) - emu["f32"].forward(raw8)).abs().max())
    check(route_err <= 1e-5, f"12g(b): int8 route vs f32 emulation {route_err}")
    del emu
    torch.cuda.empty_cache()
    raws = {b: torch.from_numpy(imgs[:b]).cuda() for b in BUCKETS}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engines["w8a8"].forward(raws[128])
    torch.cuda.synchronize()
    out["w8a8_bucket128_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    out["engine"] = {
        "layers": len(calib["amax"]), "cosine_min": cosine, "int8_route_vs_f32_emulation": route_err,
        "accumulators_bit_equal_f64": True,
        "bytes": {tier: eng.int8_bytes for tier, eng in engines.items()},
        "ms": {tier: {b: cuda_ms(lambda b=b, eng=eng: eng.forward(raws[b]), iters=10, warm=2)
                      for b in BUCKETS} for tier, eng in ({"f32": f32} | engines).items()},
    }
    print(f"12g(b): min cosine to f32 {cosine}; device ms per bucket {out['engine']['ms']}; "
          f"w8a8 peak at bucket 128 +{out['w8a8_bucket128_peak_extra_bytes'] / 1e6:.1f} MB; "
          f"bytes {out['engine']['bytes']}", flush=True)
    return engines


def first_flush_anatomy(engine, imgs):
    """What the first forward on a new thread pays after the engine's
    warm-up on another: (i) a fresh thread's first bucket-8 forward and the
    next 16; (ii) on another fresh thread, the cuBLAS handle and a tiny
    matmul, then a tiny convolution (the cuDNN handle), then the first and
    second forward at bucket 8 and at bucket 32; (iii) a fresh thread that
    first runs its own pass over the buckets (`warm_bucket`), then 17
    forwards at bucket 8."""
    raw8 = torch.from_numpy(imgs[:8]).cuda()
    raw32 = torch.from_numpy(imgs[:32]).cuda()

    def forwards(n):
        return [sync_ms(lambda: engine.forward(raw8)) for _ in range(n)]

    def handles_first():
        a = torch.randn(64, 64, device="cuda")
        x = torch.randn(1, 8, 8, 8, device="cuda")
        w = torch.randn(8, 8, 3, 3, device="cuda")
        return {"blas_handle_ms": sync_ms(torch.cuda.current_blas_handle),
                "matmul_ms": sync_ms(lambda: a @ a),
                "conv_ms": sync_ms(lambda: torch.nn.functional.conv2d(x, w)),
                "bucket8_ms": forwards(2),
                "bucket32_ms": [sync_ms(lambda: engine.forward(raw32)) for _ in range(2)]}

    def pass_first():
        t0 = time.perf_counter()
        for b in engine.buckets:
            engine.warm_bucket(b)
        return {"pass_ms": (time.perf_counter() - t0) * 1e3, "bucket8_ms": forwards(17)}

    cold = on_thread(lambda: forwards(1 + FIRST_FLUSH_NEXT))
    return {"no_pass": {"first_ms": cold[0], "next_median_ms": float(np.median(cold[1:]))},
            "handles_first": on_thread(handles_first),
            "own_pass": on_thread(pass_first)}


def serving_rest_phase(fi, ivf_scan, feats_t, v2_dir, workdir):
    """Phase 12g: serving, the rest (module docstring), in `workdir`, from
    phase 4's features and 12e's v2 checkpoint under `v2_dir`; returns (its
    numbers, this phase's launches by kernel)."""
    import threading

    from moco_tpu_torch.obs.alerts import read_alerts
    from moco_tpu_torch.obs.schema import read_metrics, validate_file
    from moco_tpu_torch.obs.sinks import JsonlSink
    from moco_tpu_torch.serve import serve_ingest
    from moco_tpu_torch.serve.engine import load_serving_encoder
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.train import train
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.utils.checkpoint import CheckpointManager
    from moco_tpu_torch.utils.config import PRESETS

    out, launches = {}, {}
    phase_t0 = time.perf_counter()

    def lap(what: str) -> None:
        print(f"12g: {what} at {time.perf_counter() - phase_t0:.1f} s", flush=True)

    ivf_scan.fused_cell_scores.launches = 0  # counts from here on are the phase's
    index = int8_index_part(feats_t, out)
    lap("(a) int8 index tiers")
    encoder, queue3, ptr3, _ = load_serving_encoder(v2_dir, device="cuda")
    engines = engine_tiers_part(encoder, workdir, out)
    lap("(b) engine tiers")

    # (c) serve: the w8a8 engine over the int8-enabled IVF index
    rng = np.random.default_rng(SEED + 16)
    reqs = [rng.integers(0, 256, (2, IMG, IMG, 3), np.uint8) for _ in range(G_REQUESTS + G_RIDERS)]
    paths = ["/neighbors"] * G_REQUESTS + ["/neighbors?mode=ivf_fused_i8"] * G_RIDERS
    c_dir = os.path.join(workdir, "serve")
    sink = JsonlSink(c_dir)
    server = ServeServer(engines["w8a8"], index=index, port=0, slo_ms=1000, neighbors_k=TOPK,
                         neighbors_mode="ivf_fused", warmup=False, recall_sample_every=1,
                         sink=sink, metrics_flush_s=0.25, workdir=c_dir)
    got = [None] * len(reqs)
    try:
        before = ivf_scan.fused_cell_scores.launches

        def client(k):
            for j in range(k, len(reqs), G_CLIENTS):
                got[j] = post(server.port, paths[j], reqs[j])

        threads = [threading.Thread(target=client, args=(k,)) for k in range(G_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        served_launches = ivf_scan.fused_cell_scores.launches - before
        time.sleep(0.6)  # a flush after the last request
        stats = get(server.port, "/stats")
    finally:
        server.close()
        sink.close()
    check(all(g is not None for g in got), "12g(c): a request went unanswered")
    check([g["mode"] for g in got] == ["ivf_fused"] * G_REQUESTS + ["ivf_fused_i8"] * G_RIDERS,
          "12g(c): the replies' modes")
    check(stats["serve/quant_tier"] == 2 and stats["serve/int8"] == 1,
          f"12g(c): quant gauges {stats['serve/quant_tier']}, {stats['serve/int8']}")
    check(stats["serve/recompiles_after_warmup"] == 0, "12g(c): recompiles after warmup")
    check(stats["serve/recall_estimate"] is not None, "12g(c): no recall estimate")
    check(served_launches > 0, "12g(c): the ivf_fused requests launched no cell scan")
    errors = validate_file(os.path.join(c_dir, "metrics.jsonl"))
    check(errors == [], f"12g(c): serve metrics.jsonl {errors[:3]}")
    out["serve"] = {"requests": len(got), "recall_estimate": stats["serve/recall_estimate"],
                    "ivf_launches": served_launches, "p50_ms": stats["serve/p50_ms"],
                    "p99_ms": stats["serve/p99_ms"]}
    lap("(c) served")

    # (c) ingest: 3 more ring steps write a newer checkpoint; the replica
    # serves the older one and takes the newer one's rows over /ingest
    preset = PRESETS["imagenet_v2"]
    t_dir, g_dir = os.path.join(workdir, "train"), os.path.join(workdir, "replica_ckpt")
    shutil.copytree(v2_dir, t_dir)
    shutil.copytree(v2_dir, g_dir)
    cfg = dataclasses.replace(preset, data=dataclasses.replace(preset.data, dataset="synthetic"),
                              steps_per_epoch=SERVE_V2_STEPS, workdir=t_dir, knn_every_epochs=0,
                              obs_probe_every=1)
    b = cfg.data.global_batch
    fi.infonce_stats.launches = fi.infonce_dq.launches = 0
    run = train(cfg, dataset=SyntheticDataset(num_examples=b * EPOCH_STEPS, image_size=IMG),
                device="cuda", steps=SERVE_V2_STEPS)
    launches["infonce"] = {"infonce_fwd": fi.infonce_stats.launches,
                           "infonce_bwd": fi.infonce_dq.launches}
    new_step = 2 * SERVE_V2_STEPS
    check(run["state"].step == new_step and CheckpointManager(t_dir).latest_step() == new_step
          and launches["infonce"] == {"infonce_fwd": SERVE_V2_STEPS,
                                      "infonce_bwd": SERVE_V2_STEPS},
          f"12g(c): resumed training {run['state'].step}, launches {launches['infonce']}")
    del run
    torch.cuda.empty_cache()
    lap("(c) a newer checkpoint written")
    queue6, ptr6 = serve_ingest.read_queue(t_dir)
    enqueued = SERVE_V2_STEPS * b
    check(ptr6 == (ptr3 + enqueued) % K, f"12g(c): heads {ptr3} -> {ptr6}")
    posts = -(-K // INGEST_BLOCK) + -(-enqueued // INGEST_BLOCK)
    port = free_port()
    rep_dir = os.path.join(workdir, "replica")
    log_path = os.path.join(workdir, "replica.log")
    cmd = [sys.executable, "-m", "moco_tpu_torch.serve.replica_main", "--ckpt-dir", g_dir,
           "--port", str(port), "--buckets", REPLICA_BUCKETS, "--device", "cuda",
           "--workdir", rep_dir, "--metrics-flush-s", "0.25",
           "--fresh-max-age-s", f"{FRESH_MAX_AGE_S:g}"]
    env = dict(os.environ, MOCO_FAULTS=f"delay@site=ingest:seconds={STALL_S:g}:at={posts + 1}")
    here = os.path.dirname(os.path.abspath(__file__))
    url = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT,
                                text=True)
        try:
            while True:
                check(proc.poll() is None, "12g(c): the replica exited before it served")
                check(time.perf_counter() - t0 < 300, "12g(c): the replica never became healthy")
                try:
                    health = get(port, "/healthz", timeout=2)
                    break
                except OSError:
                    time.sleep(0.1)
            check(health["ok"] and health["warm"], f"12g(c): replica /healthz {health}")
            out["replica_spawn_to_healthy_s"] = time.perf_counter() - t0
            lap(f"(c) replica healthy {out['replica_spawn_to_healthy_s']:.1f} s after its spawn")
            t1 = time.perf_counter()
            ing = subprocess.run(
                [sys.executable, "-m", "moco_tpu_torch.serve.serve_ingest", "--ckpt-dir", t_dir,
                 "--server", url, "--once", "--block", str(INGEST_BLOCK)],
                cwd=here, capture_output=True, text=True, timeout=300)
            out["serve_ingest_once_s"] = time.perf_counter() - t1
            check(ing.returncode == 0 and f"step {new_step}: ingested {K} fresh rows" in ing.stdout,
                  f"12g(c): serve_ingest --once rc {ing.returncode}: {ing.stdout[-500:]} "
                  f"{ing.stderr[-2000:]}")
            print(f"12g(c): serve_ingest --once in {out['serve_ingest_once_s']:.1f} s: "
                  f"{ing.stdout.strip()}", flush=True)
            seen = {"step": SERVE_V2_STEPS, "ptr": ptr3}  # the replica's own checkpoint
            fresh = serve_ingest.poll_once(t_dir, url, seen, block=INGEST_BLOCK)
            check(fresh == enqueued and seen == {"step": new_step, "ptr": ptr6},
                  f"12g(c): the incremental poll sent {fresh} rows, not {enqueued}")
            rstats = get(port, "/stats")
            check(rstats["serve/ingested_rows"] == K + enqueued
                  and rstats["serve/ingest_ckpt_step"] == new_step
                  and get(port, "/admin/model")["ingest_ckpt_step"] == new_step,
                  f"12g(c): replica ingested {rstats['serve/ingested_rows']} rows, step "
                  f"{rstats['serve/ingest_ckpt_step']}")
            out["ingest"] = {"rows_once": K, "rows_enqueued": enqueued,
                             "replica_row_age_max_s": rstats["serve/row_age_max_s"]}
            lap("(c) ingested")

            # the stall: one more block waits STALL_S in the replica's /ingest
            t_stall = time.time()
            stalled = {}

            def stalled_post():
                # one POST, no retries: the replica may be stopped while it waits
                req = urllib.request.Request(url + "/ingest", data=queue6[:128].tobytes(),
                                             headers={"X-Rows-Shape": f"128,{DIM}"})
                try:
                    with urllib.request.urlopen(req, timeout=STALL_S + 60.0) as r:
                        stalled["reply"] = json.loads(r.read())
                except OSError as e:
                    stalled["error"] = repr(e)
                stalled["t"] = time.time()

            stall_thread = threading.Thread(target=stalled_post, daemon=True)
            stall_thread.start()

            # meanwhile: each ingested row is its own top-1 through an index
            # in this process that took the same blocks in the same order
            mirror = EmbeddingIndex.from_train_queue(queue3, ptr3, device="cuda")
            mirror.add(serve_ingest.fresh_rows(queue6, None, ptr6))
            mirror.add(serve_ingest.fresh_rows(queue6, ptr3, ptr6))
            mirror.enable_int8()
            slots = np.concatenate([(ptr3 + np.arange(enqueued)) % K,
                                    np.arange(0, K, 64)])
            stored = mirror.rows[torch.from_numpy(slots).cuda()]
            # the incremental block re-sends rows the whole queue already
            # brought, so 768 rows sit at two slots: either answers
            swaps, gap_max = {}, {}
            for mode, tol in (("exact", 1e-6), ("exact_i8", I8_SCORE_TOL)):
                swaps[mode], gap_max[mode] = 0, 0.0
                for lo in range(0, len(slots), 128):
                    q, want = stored[lo : lo + 128], slots[lo : lo + 128]
                    pad = 128 - q.shape[0]
                    if pad:
                        q = torch.cat([q, torch.zeros(pad, DIM, device="cuda")])
                    ids = mirror.query(q, 1, mode=mode)[1][: len(want), 0]
                    for r in np.nonzero(ids != want)[0]:  # a near-duplicate row
                        qr = stored[lo + r].double()
                        gap = float(qr @ qr - qr @ mirror.rows[int(ids[r])].double())
                        check(gap <= tol, f"12g(c): ingested row at slot {want[r]} answers "
                              f"{ids[r]} on {mode}, score gap {gap:.3g} > {tol}")
                        swaps[mode] += 1
                        gap_max[mode] = max(gap_max[mode], gap)
            out["ingest"]["own_top1_rows"] = int(len(slots))
            out["ingest"]["answered_by_another_slot"] = swaps
            out["ingest"]["their_score_gap_max"] = gap_max
            del mirror, stored
            torch.cuda.empty_cache()
            lap("(c) own top-1 checked")

            # (d) the batcher's first flush, while the replica's ingest stalls
            d_imgs = np.random.default_rng(SEED + 17).integers(
                0, 256, (2 * (1 + FIRST_FLUSH_NEXT), IMG, IMG, 3), np.uint8)
            out["first_flush"] = {"anatomy": first_flush_anatomy(engines["off"], d_imgs)}
            d_dir = os.path.join(workdir, "first_flush")
            # a 100 ms SLO: each sequential request waits half of it to
            # coalesce, and the check reads engine_execute alone
            d_server = ServeServer(engines["off"], index=index, port=0, slo_ms=100,
                                   neighbors_k=TOPK, neighbors_mode="ivf_fused", warmup=False,
                                   workdir=d_dir, alert_spec="")
            try:
                check(get(d_server.port, "/healthz")["warm"], "12g(d): not warm")
                for j in range(1 + FIRST_FLUSH_NEXT):
                    post(d_server.port, "/neighbors", d_imgs[2 * j : 2 * j + 2])
                flight = get(d_server.port, "/debug/flight")
                warm_pass_s = d_server.batcher.warm_s
            finally:
                d_server.close()
            # the ring holds the requests in the order they completed: one at a time
            execs = [next(x["dur_ms"] for x in w["stages"] if x["stage"] == "engine_execute")
                     for w in flight["requests"]]
            check(len(execs) == 1 + FIRST_FLUSH_NEXT, f"12g(d): {len(execs)} requests traced")
            first, median = execs[0], float(np.median(execs[1:]))
            out["first_flush"].update({"first_engine_execute_ms": first,
                                       "next_median_ms": median, "warm_pass_s": warm_pass_s})
            print(f"12g(d): first request's engine_execute {first:.2f} ms, median of the next "
                  f"{FIRST_FLUSH_NEXT} {median:.2f} ms (batcher pass {warm_pass_s:.2f} s); "
                  f"anatomy {out['first_flush']['anatomy']}", flush=True)
            check(first <= FIRST_FLUSH_RATIO * median, f"12g(d): the first request's "
                  f"engine_execute {first:.2f} ms > {FIRST_FLUSH_RATIO} x {median:.2f} ms")
            lap("(d) first flush")

            # the stall's burn alert, in the replica's alerts.jsonl
            alerts_path = os.path.join(rep_dir, "alerts.jsonl")
            deadline = time.time() + STALL_S + 30.0
            fired = []
            while time.time() < deadline and not fired and "t" not in stalled:
                fired = [a for a in read_alerts(alerts_path)
                         if a["rule"] == "fresh_burn_fast" and a["time"] > t_stall]
                time.sleep(0.25)
            check(fired, f"12g(c): no fresh_burn_fast in the replica's alerts after the stall "
                  f"({read_alerts(alerts_path)[-3:]}; the stalled ingest {stalled})")
            check("t" not in stalled or stalled["t"] > fired[0]["time"],
                  f"12g(c): the stalled ingest returned before the alert: {stalled}")
            lines = read_metrics(os.path.join(rep_dir, "metrics.jsonl"))
            before_stall = [r for r in lines if r["time"] < t_stall
                            and r.get("serve/fresh_burn_rate_60s") is not None]
            check(before_stall and before_stall[-1]["serve/fresh_burn_rate_60s"] < 14.4,
                  "12g(c): the freshness budget was burning before the stall")
            out["stall"] = {"fired_after_s": fired[0]["time"] - t_stall,
                            "burn_before": before_stall[-1]["serve/fresh_burn_rate_60s"],
                            "fired_value": fired[0]["value"]}
            lap("(c) stall alert")
            proc.send_signal(signal.SIGTERM)  # the stalled ingest still waits in its handler
            rc = proc.wait(timeout=60)
            stall_thread.join(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        replica_log = f.read()
    check(rc == 0 and "drained (clean)" in replica_log, f"12g(c): replica exit {rc}: "
          f"{replica_log[-2000:]}")
    errors = validate_file(os.path.join(rep_dir, "metrics.jsonl"))
    check(errors == [], f"12g(c): replica metrics.jsonl {errors[:3]}")
    launches["ivf_cell_scores"] = ivf_scan.fused_cell_scores.launches
    check(launches["ivf_cell_scores"] > 0, "12g: the phase launched no cell scan")
    ivf_scan.fused_cell_scores.launches = 0  # 12m(b)'s bursts count apart
    out["lock_order"] = lock_order_part(engines["off"], index, workdir)
    lap("12m(b) lock order")
    launches["ivf_cell_scores_12m"] = ivf_scan.fused_cell_scores.launches
    check(launches["ivf_cell_scores_12m"] > 0, "12m(b): the bursts launched no cell scan")
    del engines, index, encoder
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"serving, the rest in {out['phase_s']:.1f} s: launches {launches}", flush=True)
    return out, launches


def lock_order_part(engine, index, workdir: str) -> dict:
    """12m(b) (module docstring): sequential /neighbors bursts of `engine`
    over `index` to in-process servers: server A without a hook, server B
    started under ThreadSanitizer with its profile hook (every thread of B
    and this one profiled: the clean leg), A again, then a /stats request
    to A (its gauges read under serve.index) under
    deadlock@site=TSAN_DEADLOCK_LOCK with the recorder alone. Two
    servers, not four: each new batcher thread pays its own warm pass
    (~6 s on an H100, its cuDNN and cuBLAS handles). Returns the p50s, the
    recorded edges and blocking ops, and the cycle."""
    from moco_tpu_torch.analysis import tsan
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.utils import faults

    imgs = np.random.default_rng(SEED + 18).integers(
        0, 256, (TSAN_REQUESTS, 2, IMG, IMG, 3), np.uint8)

    def server():
        return ServeServer(engine, index=index, port=0, slo_ms=TSAN_SLO_MS, neighbors_k=TOPK,
                           neighbors_mode="ivf_fused", warmup=False, alert_spec="")

    def p50(srv, n=TSAN_REQUESTS) -> float:
        """The client's median ms over `n` sequential requests, the first
        two (the server's first flushes) left out."""
        ms = []
        for j in range(n):
            t0 = time.perf_counter()
            post(srv.port, "/neighbors", imgs[j])
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms[2:]))

    clean_dir, dl_dir = os.path.join(workdir, "tsan_clean"), os.path.join(workdir, "tsan_deadlock")
    server_a = server()
    try:
        off1 = p50(server_a)
        san = tsan.ThreadSanitizer(workdir=clean_dir, strict=False, profile=True)
        try:
            server_b = server()
            try:
                on = p50(server_b)
                get(server_b.port, "/stats")  # stats() reads the metrics under serve.index
            finally:
                server_b.close()
        finally:
            clean = san.close()
        off2 = p50(server_a)
        faults.install(f"deadlock@site={TSAN_DEADLOCK_LOCK}")
        san = tsan.ThreadSanitizer(workdir=dl_dir, strict=False, profile=False)
        try:
            get(server_a.port, "/stats")
        finally:
            dl = san.close()
            faults.clear()
    finally:
        server_a.close()
    edges = {(e["held"], e["acquired"]) for e in clean["edges"]}
    check(clean["cycles"] == [] and ("serve.index", TSAN_DEADLOCK_LOCK) in edges
          and os.path.exists(os.path.join(clean_dir, "lock_order.json")),
          f"12m(b): the clean leg's edges {sorted(edges)}, cycles {clean['cycles'][:1]}")
    with open(os.path.join(dl_dir, "lock_order_diff.json")) as f:
        diff = json.load(f)
    pair = {"serve.index", TSAN_DEADLOCK_LOCK}
    check(dl["cycles"] and set(diff["cycle"]) == pair
          and {(e["held"], e["acquired"], e["injected"]) for e in diff["edges"]}
          == {("serve.index", TSAN_DEADLOCK_LOCK, False), (TSAN_DEADLOCK_LOCK, "serve.index", True)}
          and all(e["stack"] for e in diff["edges"]),
          f"12m(b): the deadlock leg's cycle {diff.get('cycle')}, edges {diff.get('edges')}")
    ops: dict = {}
    for b in clean["blocking_ops_under_lock"]:
        key = f"{b['op']} under {','.join(b['held'])}"
        ops[key] = ops.get(key, 0) + 1
    out = {"p50_ms_off": [off1, off2], "p50_ms_profile_hook": on, "requests": TSAN_REQUESTS,
           "slo_ms": TSAN_SLO_MS, "acquisitions": clean["acquisitions"], "edges": sorted(edges),
           "blocking_ops_under_lock": ops, "cycle": diff["cycle"]}
    print(f"12m(b): {json.dumps(out)}", flush=True)
    return out


def post(port, path, imgs):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=imgs.tobytes(),
        headers={"X-Image-Shape": ",".join(map(str, imgs.shape))},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


# phase 12h: data parallelism on the card. A world of one over NCCL beside
# the single-device path, then two ranks of 128 rows (gloo on the one card;
# NCCL when the machine has two)
# the v2 steps held to their oracles, the v2 steps of the bf16 runs (the
# median of those after the first two is their step ms), v3's, the ranks
DP_STEPS, DP_TIMED_STEPS, DP_V3_STEPS, DP_RANKS = 2, 4, 2, 2
DP_TIMEOUT_S = 300.0  # the process groups' timeout, and the children's join budget past it
# 12h(b)'s oracles, in float32 without TF32 (in bf16 the oracle's losses
# drifted as far as whole-batch BN's against per-rank BN): the
# losses' relative deviation; the update of all parameters and BN
# statistics against the oracle's, relative in L2 (||dp - oracle|| /
# ||oracle - init||); the cosine of each queue row the steps wrote. On an
# H100 the oracles gave at most 1.5e-5, 4.7e-3 and 0.999993, the control
# (whole-batch BN against gather_perm) 3.8e-4, 4.3e-2 and 0.975: each
# check alone rejects it. Elementwise closeness (rtol 1e-3 / atol 1e-5, as
# tests/test_train_step.py holds SyncBN on a tiny net) is printed but cannot
# hold for ResNet-50: a ReLU input within rounding of zero flips when the
# same sums run in another order (per rank against per virtual group), and
# BN spreads the flipped unit's gradient over its channel, so some
# elements move by a large share of their tensor's largest in one step
DP_LOSS_RTOL, DP_UPDATE_REL, DP_QUEUE_COS = 1e-4, 1.5e-2, 0.9999
SAN_STEPS, SAN_DIVERGE_SITE = 2, "grad.psum"  # 12m(a)
DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-3, 1e-5


def dp_config(preset, **moco):
    """`preset` on synthetic data (vit_b16_v3 at V3_BATCH), with `moco`'s
    fields replaced."""
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS[preset]
    data = {"dataset": "synthetic"}
    if cfg.moco.v3:
        data["global_batch"] = V3_BATCH
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                               moco=dataclasses.replace(cfg.moco, **moco))


def dp_tensors(state) -> dict:
    """`state_tensors` and the predictor's."""
    out = state_tensors(state)
    if state.predictor is not None:
        out.update({f"pred.{k}": v for k, v in state.predictor.state_dict().items()})
    return out


def tensor_fingerprint(tensors: dict, skip=()) -> str:
    """sha256 over per-tensor position-weighted sums of the bytes of every
    tensor of `tensors` but `skip`'s, by name (on the card, exact in int64):
    equal states give equal prints, and two states that differ anywhere
    differ with overwhelming probability; no copy of the state to the
    host."""
    import hashlib

    names, sums, weights = [], [], {}
    for name, t in sorted(tensors.items()):
        if name in skip:
            continue
        b = t.detach().contiguous().view(-1).view(torch.uint8).to(torch.int64)
        w = weights.get(b.device)
        if w is None or w.numel() < b.numel():
            w = weights[b.device] = torch.arange(max(b.numel(), 1 << 20), device=b.device,
                                                 dtype=torch.int64) % 65521 + 1
        names.append(name)
        sums.append((b * w[:b.numel()]).sum())
    # one host copy per device, not one wait per tensor
    by_device = {}
    for i, x in enumerate(sums):
        by_device.setdefault(x.device, []).append(i)
    values = [0] * len(sums)
    for idx in by_device.values():
        for i, v in zip(idx, torch.stack([sums[i] for i in idx]).tolist()):
            values[i] = v
    h = hashlib.sha256()
    for name, v in zip(names, values):
        h.update(name.encode())
        h.update(int(v).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def dp_digest(state) -> str:
    """`tensor_fingerprint` of every tensor of the state."""
    return tensor_fingerprint(dp_tensors(state))


def dp_sha(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def dp_probe_collectives(world) -> dict:
    """Which collectives the data group takes on this rank's device, each
    "ok" or its error (a report: nothing depends on it)."""
    import torch.distributed as dist

    n, dev = world.world_size, world.device
    x = torch.arange(2 * n, dtype=torch.float32, device=dev) + world.rank
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(n * x.numel(), device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:  # the report is the point; every rank raises alike
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def dp_steps(state, step, batches, dev, rows) -> dict:
    """`step` over `batches`, a wait around each: losses, step ms, the
    state's digest after each, peak memory, imgs/s of `rows` (the median
    step ms after the first step, cuDNN's autotuning, or after the first
    two when there are more than three)."""
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms, digests = [], [], []
    for batch in batches:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = step(state, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        digests.append(dp_digest(state))
    steady = float(np.median(ms[2:] if len(ms) > DP_STEPS else ms[1:]))
    return {"losses": losses, "ms": ms, "step_ms": steady, "imgs_per_s": rows / steady * 1e3,
            "digests": digests, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def dp_one_child(store: str, out_path: str) -> None:
    """12h(a), in its own process: the imagenet_v2 preset's 6 steps from
    phase 8's seeded state on the same batches, on one device and through
    the distributed path over an NCCL group of one (every collective of the
    step issued: the gradients', the BN statistics', the metrics'). Both
    use cuDNN's deterministic algorithms, so that any two runs of one path
    agree bit for bit; the comparison is then bit for bit."""
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline
    from moco_tpu_torch.ops import fused_infonce as fi
    from moco_tpu_torch.parallel.mesh import init_world

    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        world = init_world("nccl", 0, 1, device="cuda:0", store_path=store,
                           timeout_s=DP_TIMEOUT_S)
        try:
            cfg = dp_config("imagenet_v2")
            b = cfg.data.global_batch
            with TwoCropPipeline(cfg.data, seed=cfg.seed, device="cuda",
                                 dataset=SyntheticDataset(b * EPOCH_STEPS, IMG)) as pipe:
                batches = [pipe.batch(0, s) for s in range(DP_TIMED_STEPS)]
            finals = {}
            # the single-device path once more, last: its timing (the first
            # run pays cuDNN's autotuning)
            for mode, w in (("single", None), ("nccl_1", world), ("single_again", None)):
                state = seeded_v2_state(cfg, w)
                step = make_train_step(cfg, EPOCH_STEPS, device="cuda", world=w)
                fi.infonce_stats.launches = fi.infonce_dq.launches = 0
                run = dp_steps(state, step, batches, torch.device("cuda:0"), b)
                run["launches"] = {"infonce_fwd": fi.infonce_stats.launches,
                                   "infonce_bwd": fi.infonce_dq.launches}
                run["queue_ptr"] = state.queue_ptr
                finals[mode] = {k: v.detach().cpu().clone() for k, v in dp_tensors(state).items()}
                out[mode] = run
                del state, step
                torch.cuda.empty_cache()
            out["nccl_1"]["ledger"] = world.ledger.payload()
            a, c = finals["single"], finals["nccl_1"]
            out["same_names"] = set(a) == set(c)
            out["unequal"] = sorted(k for k in a if k in c and not torch.equal(a[k], c[k]))
            out["max_abs_diff"] = max(((a[k].double() - c[k].double()).abs().max().item()
                                       for k in out["unequal"]), default=0.0)
            again = finals["single_again"]
            out["single_repeats"] = all(torch.equal(a[k], again[k]) for k in a)
        finally:
            world.close()
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    with open(out_path, "w") as f:
        json.dump(out, f)


def dp_expected_ledger(sites: dict, n: int) -> dict:
    """`comms/<site>` bytes per step from operand bytes, by JAX's cost model
    (moco_tpu/obs/comms.py): an all_gather moves b(n-1), an all_to_all
    b(n-1)/n, a ring all-reduce 2b(n-1)/n, a host copy b."""
    cost = {"all_gather": lambda b: b * (n - 1), "all_to_all": lambda b: b * (n - 1) // n,
            "psum": lambda b: 2 * b * (n - 1) // n, "device_put": lambda b: b}
    out = {f"comms/{k}": cost[c](b) for k, (c, b) in sites.items()}
    out["comms/total"] = sum(out.values())
    return out


def dp_compare(state, init: dict, final: dict, losses, want_losses, rows: int) -> dict:
    """An oracle's run (`state` after it, `losses`) against the world's
    (`final`, `want_losses`), both from `init`: the worst loss deviation
    (relative); over the parameters and BN statistics the worst update
    error ||final - oracle|| / ||oracle - init|| and the worst elementwise
    share of rtol 1e-3 / atol 1e-5; the least cosine between the two of a
    queue row the steps wrote (the first `rows`) and the largest
    difference anywhere in the queue."""
    return compare_tensors(dp_tensors(state), init, final, losses, want_losses, rows)


def compare_tensors(got: dict, init: dict, final: dict, losses, want_losses, rows: int) -> dict:
    """`dp_compare` with the oracle's tensors `got` (by name) in place of
    its state."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(want_losses, losses))
    upd, upd_name, share, share_name = 0.0, "", 0.0, ""
    err_sq = moved_sq = 0.0
    for k, v in final.items():
        if k == "queue" or k.startswith("opt.") or not v.is_floating_point():
            continue
        ref, mine = got[k].double(), v.to(got[k].device).double()
        moved = (ref - init[k].to(ref.device).double()).norm().item()
        err = (mine - ref).norm().item()
        err_sq, moved_sq = err_sq + err ** 2, moved_sq + moved ** 2
        if moved > 0 and err / moved > upd:
            upd, upd_name = err / moved, k
        elem = ((mine - ref).abs() / (DP_PARAM_ATOL + DP_PARAM_RTOL * ref.abs())).max().item()
        if elem > share:
            share, share_name = elem, k
    q_ref, q_mine = got["queue"].double(), final["queue"].to(got["queue"].device).double()
    cos = (q_ref[:rows] * q_mine[:rows]).sum(1) / (q_ref[:rows].norm(dim=1) * q_mine[:rows].norm(dim=1))
    return {"loss_rel": loss_rel, "update_rel": (err_sq / moved_sq) ** 0.5,
            "tensor_update_rel": upd, "tensor_update_worst": upd_name,
            "elementwise_share_of_tol": share, "elementwise_worst": share_name,
            "queue_min_cos": cos.min().item(), "queue_max_abs": (q_ref - q_mine).abs().max().item()}


@contextlib.contextmanager
def dp_full_f32():
    """Float32 products without TF32 on the card (cuDNN and cuBLAS), for
    the oracle runs: bf16's rounding would hide what they compare.
    cuDNN's autotuning is off inside (a first f32 step spent most of a
    minute in it), so the step's builder must run inside too."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = flags[0].allow_tf32, flags[1].allow_tf32, flags[0].benchmark
    flags[0].allow_tf32 = flags[1].allow_tf32 = False
    try:
        yield
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32, flags[0].benchmark = saved


def dp_make_step(c, dev, world=None):
    """make_train_step, without cuDNN's autotuning under float32 (the step
    builder turns it on for the card)."""
    from moco_tpu_torch.core.moco import make_train_step

    step = make_train_step(c, EPOCH_STEPS, device=dev, world=world)
    if c.moco.compute_dtype == "float32":
        torch.backends.cudnn.benchmark = False
    return step


def dp_rank_child(rank: int, n: int, backend: str, device: str, store: str, out_dir: str) -> None:
    """12h(b), rank `rank` of `n`: the collectives it can issue; on its 128
    rows of each batch, made by its own ring, from phase 8's seeded state:
    imagenet_v2 with gather_perm (6 steps), then in float32 without TF32
    gather_perm and syncbn (2 steps each), and vit_b16_v3 (2 steps, flash
    attention); per run the losses, step ms, the state's digest after each
    step, launches, the ledger and peak memory; then 12m(a)'s two driver
    runs under sanitize_collectives (`dp_sanitize_legs`). Rank 0 then runs the
    oracles on one device on the whole batches, in float32:
    bn_virtual_groups=2 with the same permutations for gather_perm,
    shuffle='none' for syncbn; the latter, whole-batch BN, is also the
    control held against gather_perm."""
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline
    from moco_tpu_torch.ops import flash_attention as fa
    from moco_tpu_torch.ops import fused_infonce as fi
    from moco_tpu_torch.parallel.dist import DataPartition
    from moco_tpu_torch.parallel.mesh import init_world

    out = {"rank": rank, "backend": backend, "device": device}
    try:
        world = init_world(backend, rank, n, device=device, store_path=store,
                           timeout_s=DP_TIMEOUT_S)
        dev = world.device
        finals = {}
        try:
            out["collectives"] = dp_probe_collectives(world)
            cfg = dp_config("imagenet_v2")
            b = cfg.data.global_batch
            dataset = SyntheticDataset(b * EPOCH_STEPS, IMG)
            part = DataPartition.of(world, b)
            lb = part.local_rows
            world.ledger.reset()
            with TwoCropPipeline(cfg.data, seed=cfg.seed, dataset=dataset, device=dev,
                                 partition=part, ledger=world.ledger) as pipe:
                it = pipe.epoch(0, device=True, stop=DP_TIMED_STEPS)
                try:
                    batches = [{k: v.clone() for k, v in bt.items()} for bt in it]
                finally:
                    it.close()
            out["batch_sha"] = [{v: dp_sha(bt[v]) for v in ("im_q", "im_k")}
                                for bt in batches[:DP_STEPS]]
            wire = world.ledger.snapshot()["input.h2d"]
            for name, c in (("gather_perm", cfg),
                            ("gather_perm_f32", dp_config("imagenet_v2", compute_dtype="float32")),
                            ("syncbn_f32", dp_config("imagenet_v2", shuffle="syncbn",
                                                     compute_dtype="float32"))):
                f32 = c.moco.compute_dtype == "float32"
                world.ledger.reset()
                world.ledger.record("input.h2d", wire.collective, wire.operand_bytes, 1)
                with dp_full_f32() if f32 else contextlib.nullcontext():
                    state = seeded_v2_state(c, world, device=dev)
                    if rank == 0 and name == "gather_perm":
                        init = {k: v.detach().cpu().clone() for k, v in dp_tensors(state).items()}
                    step = dp_make_step(c, dev, world)
                    fi.infonce_stats.launches = fi.infonce_dq.launches = 0
                    run = dp_steps(state, step, batches[:DP_STEPS] if f32 else batches, dev, lb)
                run["launches"] = {"infonce_fwd": fi.infonce_stats.launches,
                                   "infonce_bwd": fi.infonce_dq.launches}
                grad = 4 * sum(p.numel() for p in state.encoder_q.parameters() if p.requires_grad)
                sites = {"grad.psum": ("psum", grad),
                         "input.h2d": ("device_put", lb * dataset.load(0)[0].nbytes)}
                if c.moco.shuffle == "gather_perm":
                    sites["shuffle.gather_images"] = ("all_gather", lb * IMG * IMG * 3 * 4)
                    sites["shuffle.gather_keys"] = ("all_gather", lb * DIM * 4)
                else:
                    sites["queue.enqueue_gather"] = ("all_gather", lb * DIM * 4)
                run["ledger"] = world.ledger.payload()
                run["ledger_want"] = dp_expected_ledger(sites, n)
                run["queue_ptr"] = state.queue_ptr
                if rank == 0 and f32:
                    finals[name] = {k: v.detach().cpu().clone()
                                    for k, v in dp_tensors(state).items()}
                out[name] = run
                del state, step
                torch.cuda.empty_cache()
            del batches
            # v3 at 2 x 128 through the flash kernels
            cfg3 = dp_config("vit_b16_v3", vit_flash_attention=True)
            part3 = DataPartition.of(world, cfg3.data.global_batch)
            with TwoCropPipeline(cfg3.data, seed=cfg3.seed, device=dev, partition=part3,
                                 dataset=SyntheticDataset(V3_BATCH * 4, IMG)) as pipe:
                batches = [pipe.batch(0, s) for s in range(DP_V3_STEPS)]
            world.ledger.reset()
            state = seeded_v3_state(cfg3, world, device=dev)
            step = make_train_step(cfg3, 4, device=dev, world=world)
            zero_flash(fa)
            run = dp_steps(state, step, batches, dev, part3.local_rows)
            run["launches"] = flash_launches(fa)
            run["kernel_launches"] = flash_kernel_launches(fa)
            trained = [p for m in (state.encoder_q, state.predictor) for p in m.parameters()
                       if p.requires_grad]
            run["ledger"] = world.ledger.payload()
            run["ledger_want"] = dp_expected_ledger({
                "v3.key_gather": ("all_gather", 2 * part3.local_rows * cfg3.moco.dim * 4),
                "grad.psum": ("psum", 4 * sum(p.numel() for p in trained))}, n)
            out["v3"] = run
            del state, step, batches
            torch.cuda.empty_cache()
            out["sanitize"] = dp_sanitize_legs(world, rank, dev, out_dir)
            world.barrier()
        finally:
            world.close()
        if rank == 0:  # the oracles, one device, the whole batches, float32
            with TwoCropPipeline(cfg.data, seed=cfg.seed, dataset=dataset, device=dev) as pipe:
                whole = [pipe.batch(0, s) for s in range(DP_STEPS)]
            out["oracle"] = {}
            with dp_full_f32():
                for name, c, against in (
                        ("gather_perm", dp_config("imagenet_v2", bn_virtual_groups=2,
                                                  compute_dtype="float32"),
                         ("gather_perm_f32",)),
                        ("syncbn", dp_config("imagenet_v2", shuffle="none",
                                             compute_dtype="float32"),
                         ("syncbn_f32", "gather_perm_f32"))):
                    state = seeded_v2_state(c, device=dev)
                    step = dp_make_step(c, dev)
                    run = dp_steps(state, step, whole, dev, b)
                    for world_run, key in zip(against, (name, "control")):
                        out["oracle"][key] = {
                            "losses": run["losses"], "step_ms": run["step_ms"],
                            **dp_compare(state, init, finals[world_run],
                                         out[world_run]["losses"], run["losses"], DP_STEPS * b)}
                    del state, step
                    torch.cuda.empty_cache()
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_sanitize_legs(world, rank: int, dev, out_dir: str) -> dict:
    """12m(a), one rank of 12h(b): two SAN_STEPS-step imagenet_v2 runs
    through train() on `world` under sanitize_collectives (log_every 1), in
    workdirs every rank shares: "clean" (each record's
    collective_schedule_hash), then "diverge", with
    diverge@site=SAN_DIVERGE_SITE on rank 1 alone (the error each rank must
    raise at its first log step)."""
    from moco_tpu_torch.analysis.sanitizer import ScheduleDivergenceError
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils import faults

    res = {}
    for leg in ("clean", "diverge"):
        cfg = dataclasses.replace(dp_config("imagenet_v2"), log_every=1, obs_probe_every=0,
                                  workdir=os.path.join(out_dir, f"sched_{leg}"),
                                  sanitize_collectives=True)
        data = SyntheticDataset(cfg.data.global_batch * EPOCH_STEPS, IMG)
        if leg == "diverge" and rank == 1:
            faults.install(f"diverge@site={SAN_DIVERGE_SITE}")
        t0 = time.perf_counter()
        try:
            run = train(cfg, dataset=data, state=seeded_v2_state(cfg, world, device=dev),
                        steps=SAN_STEPS, world=world)
            res[leg] = {"hashes": [r.get("collective_schedule_hash") for r in run["history"]]}
            del run
        except ScheduleDivergenceError as e:
            res[leg] = {"error": str(e)}
        finally:
            faults.clear()
        res[leg]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return res


def dp_sanitize_check(results: list, tmp: str) -> dict:
    """12m(a)'s checks over both ranks' `dp_sanitize_legs` (module
    docstring); returns the leg's numbers."""
    from moco_tpu_torch.obs.schema import read_metrics

    clean = [r["clean"] for r in results]
    for r, c in enumerate(clean):
        check("error" not in c and len(c["hashes"]) == SAN_STEPS and len(set(c["hashes"])) == 1
              and c["hashes"][0], f"12m(a) rank {r}: the clean run {c}")
    published = []
    for r in range(len(results)):
        with open(os.path.join(tmp, "sched_clean", f"schedule.p{r}.json")) as f:
            published.append(json.load(f))
    check(len({c["hashes"][0] for c in clean}) == 1
          and all(p["hash"][:12] == clean[0]["hashes"][0] for p in published),
          f"12m(a): the ranks' schedule hashes {[c['hashes'] for c in clean]}, published "
          f"{[p['hash'] for p in published]}")
    lines = [x for x in read_metrics(os.path.join(tmp, "sched_clean", "metrics.jsonl"))
             if "loss" in x]
    check(len(lines) == SAN_STEPS
          and all(x.get("collective_schedule_hash") == clean[0]["hashes"][0] for x in lines),
          "12m(a): collective_schedule_hash on rank 0's training lines")
    div = [r["diverge"] for r in results]
    for r, d in enumerate(div):
        check("collective schedules diverged at step 1" in d.get("error", "")
              and SAN_DIVERGE_SITE in d["error"], f"12m(a) rank {r}: the diverge run {d}")
    with open(os.path.join(tmp, "sched_diverge", "schedule_diff.json")) as f:
        diff = json.load(f)
    check(diff["step"] == 1 and any(SAN_DIVERGE_SITE in line for line in diff["diff"]),
          f"12m(a): schedule_diff.json {diff.get('diff')}")
    out = {"hash": clean[0]["hashes"][0], "sites": [e[0] for e in published[0]["schedule"]],
           "clean_s": [c["s"] for c in clean], "diverge_s": [d["s"] for d in div],
           "diff": [line[:160] for line in diff["diff"]]}
    print(f"12m(a): {json.dumps(out)}", flush=True)
    return out


def gated_child(gate: str, target, *args) -> None:
    """A phase's child process spawned while the phase before it runs: it
    imports the port and torch._dynamo (which the first optimizer imports:
    some seconds of host time), waits for the file `gate`, which its phase
    creates when it starts, then runs target(*args). It returns at once if
    its parent has exited."""
    import multiprocessing

    import torch._dynamo  # noqa: F401

    import moco_tpu_torch.train  # noqa: F401

    parent = multiprocessing.parent_process()
    while not os.path.exists(gate):
        if parent is not None and not parent.is_alive():
            return
        time.sleep(0.05)
    target(*args)


def start_ranks(specs, gate=None) -> list:
    """A process of the spawn context for each (target, args) of `specs`,
    started; each behind `gate` (`gated_child`) when one is given."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=gated_child, args=(gate, target, *args)) if gate
             else ctx.Process(target=target, args=args) for target, args in specs]
    for p in procs:
        p.start()
    return procs


def end_ranks(procs) -> None:
    """Kill whichever of `procs` still runs (a phase that failed, or one
    that never opened its gate)."""
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)


def dp_join(procs, budget: float) -> list:
    """Exit codes of `procs`, joined within `budget` seconds in all (a child
    still alive then is killed and reads None)."""
    end = time.monotonic() + budget
    codes = []
    for p in procs:
        p.join(max(end - time.monotonic(), 1.0))
        if p.is_alive():
            p.kill()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def dp_phase(fi):
    """Phase 12h (module docstring); returns its JSON and the launches of
    its paths, per process."""
    import torch.multiprocessing as mp

    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    procs_all = []
    try:
        # (a) the distributed path over an NCCL group of one, its process
        # beside (b)'s ranks (nothing of either is timed against the other)
        t0 = time.perf_counter()
        path_a = os.path.join(tmp, "one.json")
        proc = ctx.Process(target=dp_one_child, args=(os.path.join(tmp, "store_a"), path_a))
        proc.start()
        # (b) two ranks
        count = torch.cuda.device_count()
        backend, devices = (("nccl", ["cuda:0", "cuda:1"]) if count >= DP_RANKS
                            else ("gloo", ["cuda:0", "cuda:0"]))
        print(f"12h(b): {DP_RANKS} ranks, backend {backend}, devices {devices}", flush=True)
        procs = [ctx.Process(target=dp_rank_child, args=(r, DP_RANKS, backend, devices[r],
                                                         os.path.join(tmp, "store_b"), tmp))
                 for r in range(DP_RANKS)]
        for p in procs:
            p.start()
        procs_all += [proc, *procs]
        codes = dp_join([proc], 2 * DP_TIMEOUT_S)
        with open(path_a) as f:
            a = json.load(f)
        check(codes == [0] and "error" not in a, f"12h(a): exit {codes}: {a.get('error')}")
        one, nccl, again = a["single"], a["nccl_1"], a["single_again"]
        print(f"12h(a): {time.perf_counter() - t0:.1f} s; single-device losses {one['losses']}, "
              f"NCCL world of one {nccl['losses']}; step ms {one['ms']} vs {nccl['ms']} vs "
              f"{again['ms']}; "
              f"tensors unequal {a['unequal'][:4]} ({len(a['unequal'])}), max |diff| "
              f"{a['max_abs_diff']}", flush=True)
        check(one["losses"] == nccl["losses"] == again["losses"],
              "12h(a): NCCL-of-one losses differ from one device")
        check(a["single_repeats"], "12h(a): the single-device path does not repeat itself bit "
                                   "for bit (cuDNN's deterministic algorithms)")
        check(a["same_names"] and not a["unequal"],
              f"12h(a): {len(a['unequal'])} tensors differ, e.g. {a['unequal'][:4]}")
        check(nccl["launches"] == one["launches"] == {"infonce_fwd": DP_TIMED_STEPS,
                                                      "infonce_bwd": DP_TIMED_STEPS},
              f"12h(a): InfoNCE launches {nccl['launches']} / {one['launches']}")
        check(nccl["ledger"] == {"comms/grad.psum": 0, "comms/total": 0},
              f"12h(a): a world of one's ledger {nccl['ledger']}")
        cfg = dp_config("imagenet_v2")
        b = cfg.data.global_batch
        with TwoCropPipeline(cfg.data, seed=cfg.seed, device="cuda",
                             dataset=SyntheticDataset(b * EPOCH_STEPS, IMG)) as pipe:
            lb = b // DP_RANKS
            want_sha = [[{v: dp_sha(batch[v][r * lb:(r + 1) * lb]) for v in ("im_q", "im_k")}
                         for r in range(DP_RANKS)]
                        for batch in (pipe.batch(0, s) for s in range(DP_STEPS))]
        codes = dp_join(procs, 3 * DP_TIMEOUT_S)
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        wall_b = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            print(f"12h(b) rank {r}: collectives on {res['device']}: {res.get('collectives')}",
                  flush=True)
        check(codes == [0] * DP_RANKS and not any("error" in r for r in ranks),
              f"12h(b): exit {codes}: {[r.get('error') for r in ranks]}")
        sanitize = dp_sanitize_check([r["sanitize"] for r in ranks], tmp)
        per_rank = []
        for r, res in enumerate(ranks):
            for name in ("gather_perm", "gather_perm_f32", "syncbn_f32", "v3"):
                run = res[name]
                steps = {"v3": DP_V3_STEPS, "gather_perm": DP_TIMED_STEPS}.get(name, DP_STEPS)
                check(all(np.isfinite(run["losses"])) and len(run["losses"]) == steps,
                      f"12h(b) rank {r} {name}: losses {run['losses']}")
                check(run["ledger"] == run["ledger_want"],
                      f"12h(b) rank {r} {name}: ledger {run['ledger']} != {run['ledger_want']}")
                check(run["digests"] == ranks[0][name]["digests"],
                      f"12h(b) {name}: rank {r} out of lockstep")
            for name in ("gather_perm", "gather_perm_f32", "syncbn_f32"):
                want = DP_TIMED_STEPS if name == "gather_perm" else DP_STEPS
                check(res[name]["launches"] == {"infonce_fwd": want, "infonce_bwd": want},
                      f"12h(b) rank {r} {name}: InfoNCE launches {res[name]['launches']}")
            check(res["v3"]["launches"] == {"flash_fwd": 24 * DP_V3_STEPS,
                                            "flash_dq": 12 * DP_V3_STEPS,
                                            "flash_dkv": 12 * DP_V3_STEPS},
                  f"12h(b) rank {r} v3: flash launches {res['v3']['launches']}")
            check(res["batch_sha"] == [w[r] for w in want_sha],
                  f"12h(b) rank {r}: its ring batches are not its rows of batch(0, s)")
            per_rank.append({name: {k: res[name][k] for k in ("losses", "ms", "step_ms",
                                                              "imgs_per_s", "peak_gb",
                                                              "launches", "ledger")}
                             for name in ("gather_perm", "gather_perm_f32", "syncbn_f32", "v3")})
        oracle = ranks[0]["oracle"]

        def meets(o):
            return (o["loss_rel"] <= DP_LOSS_RTOL and o["update_rel"] <= DP_UPDATE_REL
                    and o["queue_min_cos"] >= DP_QUEUE_COS)

        for name, o in oracle.items():
            print(f"12h(b) oracle {name}: {json.dumps(o)}", flush=True)
        for name in ("gather_perm", "syncbn"):
            check(meets(oracle[name]), f"12h(b) {name} against its oracle: {oracle[name]}")
        control = oracle["control"]
        for key, passes in (("loss_rel", control["loss_rel"] <= DP_LOSS_RTOL),
                            ("update_rel", control["update_rel"] <= DP_UPDATE_REL),
                            ("queue_min_cos", control["queue_min_cos"] >= DP_QUEUE_COS)):
            check(not passes, f"12h(b): the whole-batch-BN control passes the {key} check: "
                              f"{control[key]}")
        return {"a": {"single": one, "nccl_1": nccl, "single_again": again,
                      "max_abs_diff": a["max_abs_diff"],
                      "overhead_ms": nccl["step_ms"] - again["step_ms"]},
                "b": {"backend": backend, "devices": devices, "wall_s": wall_b,
                      "collectives": ranks[0]["collectives"], "ranks": per_rank,
                      "oracle": oracle, "sanitize": sanitize}}, {
            "nccl_1": nccl["launches"],
            "ranks": [{**{k: sum(res[run]["launches"][k] for run in
                                 ("gather_perm", "gather_perm_f32", "syncbn_f32"))
                          for k in ("infonce_fwd", "infonce_bwd")},
                       **res["v3"]["launches"]} for res in ranks]}
    finally:
        for p in procs_all:  # a failed check leaves no rank running
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(tmp)


# phase 12i: ZeRO on the card (module docstring). Two ranks as in 12h(b);
# the layouts are those of ParallelConfig (parallel/zero.py)
ZERO_LAYOUTS = {
    "stage1": {"shard_weight_update": True},
    "stage3": {"shard_weight_update": True, "zero_stage": 3},
    "layer": {"shard_weight_update": True, "zero_stage": 3, "zero_layer_granular": True},
}
ZERO_STEPS = 2  # steps of each float32 imagenet_v2 run (and its ring batches)
ZERO_BF16_STEPS = 3  # steps of each bf16 run, one per batch
ZERO_V3_ROWS, ZERO_V3_STEPS = 64, 2  # the zero3 preset's 8192 cut to 2 x 64
ZERO_PROBE_TRAIN, ZERO_PROBE_VAL, ZERO_PROBE_BATCH = 64, 32, 32


def zero_config(preset, par: dict, **moco):
    """`dp_config` with the parallel fields `par` (the preset's kept)."""
    cfg = dp_config(preset, **moco)
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, **par))


def zero_tensors(state) -> dict:
    """`dp_tensors` with whole tensors under every ZeRO layout: the shards
    and the optimizer's rows gathered (a collective every rank joins)."""
    z = state.zero
    if z is None:
        return dp_tensors(state)
    sds = z.full_state_dicts()
    out = {}
    for side, key, mod in (("q", "q", state.encoder_q), ("k", "k", state.encoder_k),
                           ("pred", "predictor", state.predictor)):
        if mod is not None:
            sd = sds[key] if sds[key] is not None else mod.state_dict()
            out.update({f"{side}.{k}": v for k, v in sd.items()})
    if state.queue is not None:
        out["queue"] = state.queue
    for i, st in z.full_optimizer_state(state.optimizer)["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


def zero_digest(state) -> str:
    return tensor_fingerprint(zero_tensors(state))


def zero_probe_reduce_scatter(world) -> str:
    """Whether this rank's group takes `reduce_scatter_tensor` on its
    device: "ok", a wrong result, or the error. A report: the port's
    `World.reduce_scatter_flat` issues the reduce-scatter on every backend
    (the installed gloo takes it on CUDA tensors), and the check below fails
    the phase when a rank's group does not."""
    import torch.distributed as dist

    n, dev = world.world_size, world.device
    x = torch.arange(2 * n, dtype=torch.float32, device=dev) + world.rank
    out = torch.empty(2, dtype=torch.float32, device=dev)
    try:
        dist.reduce_scatter_tensor(out, x, group=world.group)
        torch.cuda.synchronize(dev)
        want = sum(torch.arange(2 * n, dtype=torch.float32) + r for r in range(n))
        ok = torch.equal(out.cpu(), want[2 * world.rank:2 * world.rank + 2])
        return "ok" if ok else f"wrong result {out.tolist()}"
    except Exception as e:  # the report is the point; every rank raises alike
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def zero_steps(state, step, batches, dev, rows, gatherer=None) -> dict:
    """`dp_steps` with `zero_digest`; with `gatherer` (AsyncParamGather of a
    stage-2/3 step) the next step's gather is issued after each step, as
    the training loop issues it."""
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms, digests = [], [], []
    for batch in batches:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if gatherer is not None:
            m = step.step(state, batch, gatherer.take())
            gatherer.submit(state, state.step)
        else:
            m = step(state, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        digests.append(zero_digest(state))
    steady = float(np.median(ms[2:] if len(ms) > ZERO_STEPS else ms[1:]))
    return {"losses": losses, "ms": ms, "step_ms": steady, "imgs_per_s": rows / steady * 1e3,
            "digests": digests, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def zero_expected_ledger(state, n: int, extra: dict) -> dict:
    """`comms/<site>` bytes by JAX's cost model from the layout's bucket
    tables (`describe`: each bucket's shard bytes) and `extra`'s sites."""
    z = state.zero
    sites = dict(extra)
    if not z.stage23:
        sites["zero.grad_reduce_scatter"] = ("psum_scatter",
                                             sum(lf.size * 4 for lf in z.trainable))
        sites["zero.params_all_gather"] = ("all_gather", z.plan_trainable.shard_bytes())
    elif not z.layer:
        for i, b in enumerate(z.plan_trainable.describe()):
            sites[f"zero.gather_q.b{i}"] = ("all_gather", b["shard_bytes"])
            sites[f"zero.scatter.b{i}"] = ("psum_scatter", n * b["shard_bytes"])
        for i, b in enumerate(z.plan_enc.describe()):
            sites[f"zero.gather_k.b{i}"] = ("all_gather", b["shard_bytes"])
    else:
        for g in z.group_plan.groups:
            for i, b in enumerate(g.plan.describe()):
                for side in "qk":
                    sites[f"zero.gather.{side}.{g.name}.b{i}"] = ("all_gather", b["shard_bytes"])
        if z.pred_plan is not None:
            for i, b in enumerate(z.pred_plan.describe()):
                sites[f"zero.gather.q.pred.b{i}"] = ("all_gather", b["shard_bytes"])
    cost = {"all_gather": lambda b: b * (n - 1), "psum_scatter": lambda b: b * (n - 1) // n,
            "device_put": lambda b: b}
    out = {f"comms/{k}": cost[c](b) for k, (c, b) in sites.items()}
    out["comms/total"] = sum(out.values())
    return out


def zero_state_bytes(state) -> int:
    """The training loop's `hbm_state_bytes`: the state's resident bytes (at stage
    2/3 the shards stand in for the parameters; at stage 1 the optimizer's
    shards come on top)."""
    from moco_tpu_torch.obs.stepstats import tree_shard_bytes
    from moco_tpu_torch.train import StateSnapshot

    resident = StateSnapshot._tensors(state) + StateSnapshot._opt_state(state)[1]
    if state.zero is not None and not state.zero.stage23:
        resident += state.zero.q_shards
    return tree_shard_bytes(resident)


def zero_rank_child(rank: int, n: int, backend: str, device: str, store: str,
                    out_dir: str) -> None:
    """12i, rank `rank` of `n` (module docstring): the reduce-scatter
    report; imagenet_v2 in float32 without TF32, replicated and at each
    ZeRO layout (2 steps each, the same batches); a stage-3 checkpoint
    loaded at stage 1; the bf16 runs at each layout (timed, the launches,
    the ledger, the memory gauges); the zero3 preset's ViT at 2 x 64 rows,
    replicated and layer-granular; the probe on the two ranks from the
    stage-3 checkpoint. Rank 0 then runs 12h's whole-batch-BN control on one
    device."""
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline
    from moco_tpu_torch.lincls import train_lincls
    from moco_tpu_torch.ops import flash_attention as fa
    from moco_tpu_torch.ops import fused_infonce as fi
    from moco_tpu_torch.parallel.dist import DataPartition
    from moco_tpu_torch.parallel.mesh import init_world
    from moco_tpu_torch.parallel.zero import AsyncParamGather
    from moco_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_payload,
        state_payload,
    )
    from moco_tpu_torch.utils.config import ProbeConfig, apply_auto_scale, config_to_dict

    out = {"rank": rank, "backend": backend, "device": device}
    t_start = time.perf_counter()
    ckpt_dir = os.path.join(out_dir, "zero3_ckpt")
    try:
        world = init_world(backend, rank, n, device=device, store_path=store,
                           timeout_s=DP_TIMEOUT_S)
        dev = world.device
        try:
            out["reduce_scatter"] = zero_probe_reduce_scatter(world)
            sections = {}
            cfg = dp_config("imagenet_v2")
            b = cfg.data.global_batch
            dataset = SyntheticDataset(b * EPOCH_STEPS, IMG)
            part = DataPartition.of(world, b)
            lb = part.local_rows
            world.ledger.reset()
            with TwoCropPipeline(cfg.data, seed=cfg.seed, dataset=dataset, device=dev,
                                 partition=part, ledger=world.ledger) as pipe:
                it = pipe.epoch(0, device=True, stop=ZERO_STEPS)
                try:
                    batches = [{k: v.clone() for k, v in bt.items()} for bt in it]
                finally:
                    it.close()
            wire = world.ledger.snapshot()["input.h2d"]
            extra_sites = {"input.h2d": ("device_put", wire.operand_bytes),
                           "shuffle.gather_images": ("all_gather", lb * IMG * IMG * 3 * 4),
                           "shuffle.gather_keys": ("all_gather", lb * DIM * 4)}
            sections["batches"] = time.perf_counter() - t_start
            # (b) float32 without TF32: the replicated step, then each layout
            finals, init = {}, None
            with dp_full_f32():
                for name, par in (("dp", {}), *ZERO_LAYOUTS.items()):
                    c = zero_config("imagenet_v2", par, compute_dtype="float32")
                    state = seeded_v2_state(c, world, device=dev)
                    if init is None:
                        init = {k: v.detach().cpu().clone() for k, v in zero_tensors(state).items()}
                    step = dp_make_step(c, dev, world)
                    run = zero_steps(state, step, batches, dev, lb)
                    finals[name] = {k: v.detach().cpu().clone()
                                    for k, v in zero_tensors(state).items()}
                    out[f"{name}_f32"] = {k: run[k] for k in ("losses", "digests")}
                    if name == "stage3":  # every rank gathers, rank 0 writes
                        payload = state_payload(state, c.moco.arch, 1)
                        if rank == 0:
                            mgr = CheckpointManager(ckpt_dir, keep=0)
                            mgr.save(state.step, payload, extra={"epoch": 0,
                                                                 "config": config_to_dict(c)})
                            mgr.close()
                        del payload
                        world.barrier()
                    del state, step
                    torch.cuda.empty_cache()
                # the stage-3 checkpoint loaded into a stage-1 state
                c1 = zero_config("imagenet_v2", ZERO_LAYOUTS["stage1"], compute_dtype="float32")
                state = seeded_v2_state(c1, world, device=dev)
                load_state_payload(state, CheckpointManager(ckpt_dir).restore()[0])
                got = zero_tensors(state)
                out["resume_stage1_unequal"] = sorted(
                    k for k, v in finals["stage3"].items()
                    if k not in got or not torch.equal(got[k].detach().cpu(), v))
                del state, got
                torch.cuda.empty_cache()
            sections["f32"] = time.perf_counter() - t_start
            out["against_dp"] = {
                name: compare_tensors(finals["dp"], init, finals[name],
                                      out[f"{name}_f32"]["losses"], out["dp_f32"]["losses"],
                                      ZERO_STEPS * b)
                for name in ZERO_LAYOUTS}
            # (c) bf16, the preset's dtype: timed, launches, ledger, memory
            bf16_batches = [batches[i % len(batches)] for i in range(ZERO_BF16_STEPS)]
            for name, par in (("dp", {}), *ZERO_LAYOUTS.items()):
                c = zero_config("imagenet_v2", par)
                world.ledger.reset()
                world.ledger.record("input.h2d", wire.collective, wire.operand_bytes, 1)
                state = seeded_v2_state(c, world, device=dev)
                step = make_train_step(c, EPOCH_STEPS, device=dev, world=world)
                gatherer = None
                if state.zero is not None and state.zero.stage23:
                    gatherer = AsyncParamGather(step.gather)
                    gatherer.submit(state, state.step)
                fi.infonce_stats.launches = fi.infonce_dq.launches = 0
                try:
                    run = zero_steps(state, step, bf16_batches, dev, lb, gatherer)
                finally:
                    if gatherer is not None:
                        gatherer.close()
                run["launches"] = {"infonce_fwd": fi.infonce_stats.launches,
                                   "infonce_bwd": fi.infonce_dq.launches}
                run["ledger"] = world.ledger.payload()
                if state.zero is not None:
                    run["ledger_want"] = zero_expected_ledger(state, n, extra_sites)
                run["hbm_state_bytes"] = zero_state_bytes(state)
                run["hbm_model_peak_bytes"] = (state.zero.hbm_model_peak_bytes
                                               if state.zero is not None else None)
                run["overlap_zero"] = gatherer.last_overlap if gatherer is not None else None
                run["gather_s"] = gatherer.last_duration if gatherer is not None else None
                out[name] = run
                del state, step, gatherer
                torch.cuda.empty_cache()
            del batches, bf16_batches
            sections["bf16"] = time.perf_counter() - t_start
            # (d) the zero3 preset's ViT-B/16 at 2 x 64 rows, flash attention
            c3 = zero_config("vit_b16_v3_huge_batch_zero3", {}, vit_flash_attention=True)
            c3 = dataclasses.replace(c3, data=dataclasses.replace(
                c3.data, global_batch=n * ZERO_V3_ROWS))
            c3, _ = apply_auto_scale(c3)
            part3 = DataPartition.of(world, c3.data.global_batch)
            with TwoCropPipeline(c3.data, seed=c3.seed, device=dev, partition=part3,
                                 dataset=SyntheticDataset(c3.data.global_batch * 4, IMG)) as pipe:
                batches = [pipe.batch(0, s) for s in range(ZERO_V3_STEPS)]
            replicated = dataclasses.replace(c3, parallel=dataclasses.replace(
                c3.parallel, shard_weight_update=False, zero_stage=1,
                zero_layer_granular=False))
            for name, c in (("v3_dp", replicated), ("v3_layer", c3)):
                world.ledger.reset()
                state = seeded_v3_state(c, world, device=dev)
                step = make_train_step(c, 4, device=dev, world=world)
                zero_flash(fa)
                run = zero_steps(state, step, batches, dev, part3.local_rows)
                run["launches"] = flash_launches(fa)
                run["ledger"] = world.ledger.payload()
                if state.zero is not None:
                    run["ledger_want"] = zero_expected_ledger(state, n, {
                        "v3.key_gather": ("all_gather", 2 * part3.local_rows * c.moco.dim * 4)})
                    run["hbm_model_peak_bytes"] = state.zero.hbm_model_peak_bytes
                run["hbm_state_bytes"] = zero_state_bytes(state)
                out[name] = run
                del state, step
                torch.cuda.empty_cache()
            del batches
            sections["v3"] = time.perf_counter() - t_start
            # (e) the probe on the two ranks, from the stage-3 checkpoint
            pdata = dataclasses.replace(cfg.data, dataset="synthetic",
                                        global_batch=ZERO_PROBE_BATCH)
            t0 = time.perf_counter()
            out["probe"] = train_lincls(
                ckpt_dir, ProbeConfig(lr=1.0, epochs=1, num_classes=10), data=pdata,
                workdir=os.path.join(out_dir, f"probe{rank}"),
                train_dataset=SyntheticDataset(ZERO_PROBE_TRAIN, IMG),
                val_dataset=SyntheticDataset(ZERO_PROBE_VAL, IMG), device=dev, world=world)
            out["probe_s"] = time.perf_counter() - t0
            sections["probe"] = time.perf_counter() - t_start
            out["sections"] = sections
            world.barrier()
        finally:
            world.close()
        if rank == 0:  # 12h's control on one device over the whole batches
            with TwoCropPipeline(cfg.data, seed=cfg.seed, dataset=dataset, device=dev) as pipe:
                whole = [pipe.batch(0, s) for s in range(ZERO_STEPS)]
            with dp_full_f32():
                c = dp_config("imagenet_v2", shuffle="none", compute_dtype="float32")
                state = seeded_v2_state(c, device=dev)
                run = dp_steps(state, dp_make_step(c, dev), whole, dev, b)
                out["control"] = compare_tensors(dp_tensors(state), init, finals["stage3"],
                                                 out["stage3_f32"]["losses"], run["losses"],
                                                 ZERO_STEPS * b)
                del state
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    out["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"zero_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def zero_spawn(gated: bool = False) -> dict:
    """12i's ranks in a new temporary directory, started (behind a gate
    when `gated`: spawned while 12h runs)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    count = torch.cuda.device_count()
    backend, devices = (("nccl", ["cuda:0", "cuda:1"]) if count >= DP_RANKS
                        else ("gloo", ["cuda:0", "cuda:0"]))
    gate = os.path.join(tmp, "gate") if gated else None
    return {"tmp": tmp, "backend": backend, "devices": devices, "gate": gate,
            "procs": start_ranks([(zero_rank_child, (r, DP_RANKS, backend, devices[r],
                                                     os.path.join(tmp, "store"), tmp))
                                  for r in range(DP_RANKS)], gate)}


def zero_phase(fi, dp_peak_gb=None, spawned=None):
    """Phase 12i (module docstring); returns its JSON and the launches of
    its paths, per rank. `dp_peak_gb` is 12h's per-rank peak memory (v2,
    v3), printed beside 12i's; `spawned`, `zero_spawn(gated=True)`'s ranks
    (else they start here)."""
    sp = spawned or zero_spawn()
    tmp, backend, devices, procs = sp["tmp"], sp["backend"], sp["devices"], sp["procs"]
    try:
        print(f"12i: {DP_RANKS} ranks, backend {backend}, devices {devices}", flush=True)
        t0 = time.perf_counter()
        if sp["gate"]:
            open(sp["gate"], "w").close()
        codes = dp_join(procs, 3 * DP_TIMEOUT_S)
        ranks = []
        for r in range(DP_RANKS):
            path = os.path.join(tmp, f"zero_rank{r}.json")
            with open(path) as f:
                ranks.append(json.load(f))
        wall = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            print(f"12i rank {r}: reduce_scatter_tensor on {res['device']}: "
                  f"{res.get('reduce_scatter')}; seconds by part {res.get('sections')}",
                  flush=True)
        check(codes == [0] * DP_RANKS and not any("error" in r for r in ranks),
              f"12i: exit {codes}: {[r.get('error') for r in ranks]}")
        check(all(r["reduce_scatter"] == "ok" for r in ranks),
              f"12i: a rank's group does not take the reduce-scatter: "
              f"{[r['reduce_scatter'] for r in ranks]}")
        runs_v2 = [*(f"{k}_f32" for k in ("dp", *ZERO_LAYOUTS)), "dp", *ZERO_LAYOUTS]
        for r, res in enumerate(ranks):
            for name in runs_v2 + ["v3_dp", "v3_layer"]:
                run = res[name]
                steps = (ZERO_V3_STEPS if name.startswith("v3") else
                         ZERO_STEPS if name.endswith("_f32") else ZERO_BF16_STEPS)
                check(all(np.isfinite(run["losses"])) and len(run["losses"]) == steps,
                      f"12i rank {r} {name}: losses {run['losses']}")
                check(run["digests"] == ranks[0][name]["digests"],
                      f"12i {name}: rank {r} out of lockstep")
                if "ledger_want" in run:
                    check(run["ledger"] == run["ledger_want"],
                          f"12i rank {r} {name}: ledger {run['ledger']} != {run['ledger_want']}")
            for name in ("dp", *ZERO_LAYOUTS):
                check(res[name]["launches"] == {"infonce_fwd": ZERO_BF16_STEPS,
                                                "infonce_bwd": ZERO_BF16_STEPS},
                      f"12i rank {r} {name}: InfoNCE launches {res[name]['launches']}")
            # the layer schedule's segments recompute the query forward in
            # the backward (as JAX's jax.checkpoint segments do): 12 more
            # forward launches per step
            for name, fwd in (("v3_dp", 24), ("v3_layer", 36)):
                check(res[name]["launches"] == {"flash_fwd": fwd * ZERO_V3_STEPS,
                                                "flash_dq": 12 * ZERO_V3_STEPS,
                                                "flash_dkv": 12 * ZERO_V3_STEPS},
                      f"12i rank {r} {name}: flash launches {res[name]['launches']}")
            check(not res["resume_stage1_unequal"],
                  f"12i rank {r}: the stage-3 checkpoint at stage 1 differs in "
                  f"{res['resume_stage1_unequal'][:4]}")
            probe = res["probe"]
            check(probe == ranks[0]["probe"] and probe["count"] == ZERO_PROBE_VAL
                  and all(np.isfinite(v) for v in probe.values()),
                  f"12i rank {r}: probe {probe}")

        def meets(o):
            return (o["loss_rel"] <= DP_LOSS_RTOL and o["update_rel"] <= DP_UPDATE_REL
                    and o["queue_min_cos"] >= DP_QUEUE_COS)

        against = ranks[0]["against_dp"]
        for name, o in against.items():
            print(f"12i {name} against the replicated run: {json.dumps(o)}", flush=True)
            check(meets(o), f"12i {name} against the replicated data-parallel run: {o}")
        control = ranks[0]["control"]
        print(f"12i control (whole-batch BN) against stage 3: {json.dumps(control)}", flush=True)
        for key, passes in (("loss_rel", control["loss_rel"] <= DP_LOSS_RTOL),
                            ("update_rel", control["update_rel"] <= DP_UPDATE_REL),
                            ("queue_min_cos", control["queue_min_cos"] >= DP_QUEUE_COS)):
            check(not passes, f"12i: the whole-batch-BN control passes the {key} check: "
                              f"{control[key]}")
        per_rank = []
        for res in ranks:
            per_rank.append({name: {k: res[name].get(k) for k in (
                "losses", "ms", "step_ms", "imgs_per_s", "peak_gb", "launches", "ledger",
                "hbm_state_bytes", "hbm_model_peak_bytes", "overlap_zero", "gather_s")}
                for name in ["dp", *ZERO_LAYOUTS, "v3_dp", "v3_layer"]})
            per_rank[-1]["wall_s"] = res["wall_s"]
            per_rank[-1]["sections"] = res["sections"]
        for r, rec in enumerate(per_rank):
            line = {name: {k: rec[name][k] for k in ("step_ms", "imgs_per_s", "peak_gb",
                                                      "hbm_state_bytes", "hbm_model_peak_bytes",
                                                      "overlap_zero")}
                    for name in ["dp", *ZERO_LAYOUTS, "v3_dp", "v3_layer"]}
            print(f"12i rank {r}: {json.dumps(line)}; 12h's peak GB {dp_peak_gb}", flush=True)
        return {"backend": backend, "devices": devices, "wall_s": wall,
                "reduce_scatter": ranks[0]["reduce_scatter"],
                "against_dp": against, "control": control, "ranks": per_rank,
                "probe": ranks[0]["probe"], "dp_peak_gb": dp_peak_gb}, [
            {**{k: sum(res[name]["launches"][k] for name in ("dp", *ZERO_LAYOUTS))
                for k in ("infonce_fwd", "infonce_bwd")},
             **{k: sum(res[name]["launches"][k] for name in ("v3_dp", "v3_layer"))
                for k in ("flash_fwd", "flash_dq", "flash_dkv")}} for res in ranks]
    finally:
        end_ranks(procs)
        shutil.rmtree(tmp)


# phase 12j: the model axis on the card (module docstring). A world of 1 x 2
# ranks (its model group both: NCCL where the machine has two cards, else
# gloo with both on cuda:0) runs (a), (b) at n = 2 and (c); a world of 8
# ranks (NCCL on eight cards, else gloo on cuda:0) runs (b) at n = 8
MA_RANKS, MA_RING_WIDE = 2, 8
MA_STEPS = 2  # steps of (a) and of each run of (c)
MA_EPOCH_STEPS = 4  # (c)'s epochs: the lr and momentum schedules' steps_per_epoch
MA_SP_BATCH = 16  # vit_b16_v3_highres_sp's global batch 1024 cut to one card's phase
MA_RING_B = 2  # (b): ViT-B/16 at 448 px, S = 784 tokens, H = 12, D = 64, bf16
MA_TIMEOUT_S = 300.0
# (b): the ring's outputs against the plain float64 attention, of each
# output's largest sum of absolute terms (phase 10's bf16 bound, BF16_REL,
# doubled: each ring step's out and its cotangent are rounded to bf16 once
# more than one flash call rounds them), and against one flash call over
# the whole sequence the two bounds added; lse against float64 within
# MA_LSE_TOL (each step's lse within phase 10's 1e-5, merged in float32)
MA_RING_REL, MA_FLASH_REL, MA_LSE_TOL = 2 * BF16_REL, 3 * BF16_REL, 3e-5
# (c): the sequence-parallel preset against its dense-flash oracle in
# float32 without TF32 over 3 steps: each loss relative (12h's
# DP_LOSS_RTOL), the first step's gradient of all trained parameters in L2
# relative (the later steps' are printed: they start from states that
# have already parted), and the 3-step update in L2 relative, the latter
# loose: at step 1 AdamW moves each parameter by lr * sign(gradient), so a
# parameter whose gradient is float32 noise (the key projections' biases,
# the final LayerNorm's bias: the softmax and the heads' BN remove what
# they add) moves either way, and later gradients differ with the states
# (on an H100: 3.5e-6, 6.9e-4 and 1.0e-2 at steps 1-3, the update 4.8e-3).
# A control, the reference's gradient (the backbone's twice the dense
# one, ROADMAP.md queue 3), must fail the gradient check
MA_GRAD_REL, MA_UPDATE_REL = 1e-3, 5e-2


def ma_fingerprint(modules) -> str:
    """`tensor_fingerprint` of every tensor of `modules`, each name prefixed
    by its module's position."""
    return tensor_fingerprint({f"{i}.{name}": t for i, m in enumerate(modules)
                               for name, t in m.state_dict().items()})


def ma_ring_check(fa, ring, dev, label) -> dict:
    """(b) on this rank: ring attention of its S/n rows of seeded bf16
    (B, H, S, D) q, k, v and cotangents over `ring`, against one flash call
    over the whole sequence and the plain float64 attention (both
    backwards with the same cotangents); returns the errors and their
    tolerances."""
    from moco_tpu_torch.parallel.ring_attention import ring_attention_with_lse

    b, h, s, d = MA_RING_B, 12, (IMG * 2 // 16) ** 2, 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    q, k, v, g = (torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    g_lse = torch.randn((b, h, s), generator=gen, device=dev)
    n, r = ring.size, ring.rank
    rows = slice(r * s // n, (r + 1) * s // n)
    scale = d ** -0.5
    mine = [x[:, :, rows].contiguous().requires_grad_(True) for x in (q, k, v)]
    out, lse = ring_attention_with_lse(*mine, ring)
    torch.autograd.backward([out, lse], [g[:, :, rows].contiguous(),
                                         g_lse[:, :, rows].contiguous()])
    whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out_f, lse_f = fa.FlashAttention.apply(*whole, scale)
    torch.autograd.backward([out_f, lse_f], [g, g_lse])
    q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
    out64, lse64 = fa.attention_reference(q64, k64, v64, scale)
    lse64 = lse64.double()
    grads64 = fa.flash_backward_reference(q64, k64, v64, out64, lse64, g64, g_lse.double(),
                                          scale)
    coeff = fa.backward_coeff(out64, g64, g_lse.double())
    terms = fa.abs_term_sums(q64, k64, v64, g64, lse64, coeff, scale)
    got = {"out": out, "dq": mine[0].grad, "dk": mine[1].grad, "dv": mine[2].grad}
    flash = {"out": out_f, "dq": whole[0].grad, "dk": whole[1].grad, "dv": whole[2].grad}
    plain = {"out": out64, "dq": grads64[0], "dk": grads64[1], "dv": grads64[2]}
    errs = {}
    for name, x in got.items():
        x = x.double()
        errs[name] = {
            "plain": (x - plain[name][:, :, rows]).abs().max().item(),
            "plain_tol": MA_RING_REL * terms[name] + 1e-6,
            "flash": (x - flash[name][:, :, rows].double()).abs().max().item(),
            "flash_tol": MA_FLASH_REL * terms[name] + 1e-6,
            "largest": plain[name].abs().max().item()}
    errs["lse"] = {"plain": (lse.double() - lse64[:, :, rows]).abs().max().item(),
                   "plain_tol": MA_LSE_TOL,
                   "flash": (lse - lse_f[:, :, rows]).abs().max().item(),
                   "flash_tol": MA_LSE_TOL + 1e-5}
    ok = all(e["plain"] <= e["plain_tol"] and e["flash"] <= e["flash_tol"]
             for e in errs.values())
    return {"label": label, "n": n, "rank": r, "shape": [b, h, s, d], "errs": errs, "ok": ok}


def ma_ring_child(rank: int, n: int, backend: str, device: str, store: str,
                  out_dir: str) -> None:
    """12j(b) at n = MA_RING_WIDE, rank `rank`: the ring over every rank."""
    from moco_tpu_torch.ops import flash_attention as fa
    from moco_tpu_torch.parallel.mesh import init_world

    out = {"rank": rank}
    try:
        world = init_world(backend, rank, n, device=device, store_path=store,
                           timeout_s=MA_TIMEOUT_S, num_model=n)
        try:
            out["ring"] = ma_ring_check(fa, world.ring(), world.device, f"n={n}")
            torch.cuda.synchronize(world.device)
            world.barrier()
        finally:
            world.close()
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"ring{rank}.json"), "w") as f:
        json.dump(out, f)


def ma_sp_config(dtype: str, sp: bool = True):
    """vit_b16_v3_highres_sp on synthetic data at MA_SP_BATCH images, 2
    model ranks (sp) or dense flash attention on one device."""
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS["vit_b16_v3_highres_sp"]
    par = dataclasses.replace(cfg.parallel, num_model=MA_RANKS if sp else 1)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset="synthetic", global_batch=MA_SP_BATCH),
        moco=dataclasses.replace(cfg.moco, compute_dtype=dtype, vit_sequence_parallel=sp,
                                 vit_flash_attention=True),
        parallel=par, steps_per_epoch=MA_EPOCH_STEPS, obs_probe_every=1, device_prefetch=False,
        knn_every_epochs=0)


def ma_trained(state) -> list:
    return [(f"{side}.{k}", p) for side, m in (("q", state.encoder_q), ("pred", state.predictor))
            for k, p in m.named_parameters() if p.requires_grad]


def ma_grad_rel(got: dict, want: dict, backbone_scale: float = 1.0) -> float:
    """||got - want|| / ||want|| over every trained parameter's gradient,
    `got`'s backbone entries scaled by `backbone_scale`."""
    err = ref = 0.0
    for k, w in want.items():
        g = got[k].double() * (backbone_scale if k.startswith("q.backbone.") else 1.0)
        err += (g - w.double()).square().sum().item()
        ref += w.double().square().sum().item()
    return (err / ref) ** 0.5


def ma_sp_run(fa, world, dtype: str, dataset, keep_grads: bool) -> dict:
    """(c) on this rank: train() of the sequence-parallel preset for
    MA_STEPS steps from the seeded state; per step the loss, step ms, the
    state's fingerprint, the flash launches and (`keep_grads`) a copy of
    the trained parameters' gradients; the final state's parameters."""
    from moco_tpu_torch.train import train

    cfg = ma_sp_config(dtype)
    dev = world.device
    with dp_full_f32() if dtype == "float32" else contextlib.nullcontext():
        state = seeded_v3_state(cfg, world, device=dev)
        init = {k: p.detach().clone() for k, p in ma_trained(state)}
        steps, last = [], {}

        def log(rec):
            launches = flash_launches(fa)
            steps.append({"loss": rec["loss"], "step_ms": rec.get("step_ms"),
                          "imgs_per_s": rec.get("imgs_per_s"),
                          "print": ma_fingerprint([state.encoder_q, state.encoder_k,
                                                   state.predictor]),
                          "launches": {k: launches[k] - last.get(k, 0) for k in launches}})
            last.update(launches)
            if keep_grads:
                steps[-1]["grads"] = {k: p.grad.detach().clone() for k, p in ma_trained(state)}

        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_flash(fa)
        world.ledger.reset()
        t0 = time.perf_counter()
        train(cfg, dataset=dataset, device=dev, steps=MA_STEPS, state=state, log=log,
              world=world)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return {"steps": steps, "init": init, "wall_s": wall,
            "final": {k: p.detach().clone() for k, p in ma_trained(state)},
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "ledger": world.ledger.payload(), "launches": flash_launches(fa)}


def ma_dense_steps(cfg, dev, batches, keep_grads: bool):
    """The dense-flash oracle of (c) on one device: MA_STEPS steps of
    make_train_step on `batches` from the seeded state."""
    from moco_tpu_torch.core.moco import make_train_step

    with dp_full_f32() if cfg.moco.compute_dtype == "float32" else contextlib.nullcontext():
        state = seeded_v3_state(cfg, device=dev)
        step = make_train_step(cfg, MA_EPOCH_STEPS, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = {"losses": [], "ms": [], "grads": []}
        for batch in batches:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out["losses"].append(step(state, batch)["loss"].item())
            torch.cuda.synchronize(dev)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            if keep_grads:
                out["grads"].append({k: p.grad.detach().clone() for k, p in ma_trained(state)})
    out["final"] = {k: p.detach().clone() for k, p in ma_trained(state)}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["step_ms"] = float(np.median(out["ms"][1:]))
    return out


def ma_rank_child(rank: int, n: int, backend: str, device: str, store: str,
                  out_dir: str) -> None:
    """12j, rank `rank` of the world of 1 x 2: (a) the sharded queue, (b) the
    ring at n = 2, (c) the sequence-parallel preset through train() in
    float32 (the oracle's) and bf16 (the preset's dtype); rank 0 then runs
    the oracles on one device."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline
    from moco_tpu_torch.ops import flash_attention as fa
    from moco_tpu_torch.ops import fused_infonce as fi
    from moco_tpu_torch.parallel.mesh import init_world

    out = {"rank": rank, "backend": backend, "device": device, "sections": {}}
    t_start = time.perf_counter()

    def section(name, t0):
        out["sections"][name] = round(time.perf_counter() - t0, 2)

    try:
        world = init_world(backend, rank, n, device=device, store_path=store,
                           timeout_s=MA_TIMEOUT_S, num_model=n)
        dev = world.device
        try:
            # (a) imagenet_v2, its queue sharded over the 2 model ranks, float32
            t0 = time.perf_counter()
            cfg = dp_config("imagenet_v2", compute_dtype="float32")
            cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                         num_model=n))
            b = cfg.data.global_batch
            dataset = SyntheticDataset(b * EPOCH_STEPS, IMG)
            with TwoCropPipeline(cfg.data, seed=cfg.seed, device=dev, dataset=dataset) as pipe:
                batches = [pipe.batch(0, s) for s in range(MA_STEPS)]
            world.ledger.reset()
            run = {"losses": [], "ms": [], "digests": []}
            with dp_full_f32():
                state = seeded_v2_state(cfg, world, device=dev)
                step = dp_make_step(cfg, dev, world)
                fi.infonce_stats.launches = fi.infonce_dq.launches = 0
                for batch in batches:
                    torch.cuda.synchronize(dev)
                    t1 = time.perf_counter()
                    run["losses"].append(step(state, batch)["loss"].item())
                    torch.cuda.synchronize(dev)
                    run["ms"].append((time.perf_counter() - t1) * 1e3)
                    run["digests"].append(ma_fingerprint([state.encoder_q, state.encoder_k]))
            run["launches"] = {"infonce_fwd": fi.infonce_stats.launches,
                               "infonce_bwd": fi.infonce_dq.launches}
            run["queue_shape"] = list(state.queue.shape)
            run["queue_ptr"], run["batch"] = state.queue_ptr, b
            run["ledger"] = world.ledger.payload()
            grad = 4 * sum(p.numel() for p in state.encoder_q.parameters() if p.requires_grad)
            run["ledger_want"] = dp_expected_ledger({
                "grad.psum": ("psum", grad), "queue.stats_gather": ("all_gather", 2 * b * 4)}, n)
            whole_queue = state.full_queue()
            if rank == 0:
                final_a = {k: v.detach().cpu().clone() for k, v in dp_tensors(state).items()}
                final_a["queue"] = whole_queue.cpu().clone()
            out["a"] = run
            del state, step, whole_queue
            torch.cuda.empty_cache()
            section("a", t0)
            # (b) the ring at n = 2 (its launches are not the path's)
            t0 = time.perf_counter()
            out["ring"] = ma_ring_check(fa, world.ring(), dev, f"n={n}")
            torch.cuda.empty_cache()
            section("b", t0)
            # (c) the preset through train(), float32 then bf16
            t0 = time.perf_counter()
            sp_data = SyntheticDataset(MA_SP_BATCH * MA_EPOCH_STEPS, 2 * IMG)
            runs = {dtype: ma_sp_run(fa, world, dtype, sp_data, dtype == "float32")
                    for dtype in ("float32", "bfloat16")}
            section("c", t0)
            world.barrier()
        finally:
            world.close()
        out["c"] = {dtype: {k: v for k, v in r.items()
                            if k not in ("init", "final", "steps")}
                    | {"steps": [{k: v for k, v in s.items() if k != "grads"}
                                 for s in r["steps"]]}
                    for dtype, r in runs.items()}
        if rank == 0:  # the oracles, one device
            t0 = time.perf_counter()
            one = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                         num_model=1))
            with dp_full_f32():
                state = seeded_v2_state(one, device=dev)
                init = {k: v.detach().cpu().clone() for k, v in dp_tensors(state).items()}
                step = dp_make_step(one, dev)
                oracle = dp_steps(state, step, batches, dev, b)
                oracle_tensors = {k: v.detach().cpu() for k, v in dp_tensors(state).items()}
            out["a_oracle"] = {"losses": oracle["losses"], "step_ms": oracle["step_ms"],
                               **compare_tensors(oracle_tensors, init, final_a,
                                                 out["a"]["losses"], oracle["losses"],
                                                 MA_STEPS * b)}
            del state, step, batches
            torch.cuda.empty_cache()
            section("a_oracle", t0)
            t0 = time.perf_counter()
            dense_cfg = {dtype: ma_sp_config(dtype, sp=False) for dtype in runs}
            with TwoCropPipeline(dense_cfg["float32"].data, seed=dense_cfg["float32"].seed,
                                 device=dev, dataset=sp_data) as pipe:
                sp_batches = [pipe.batch(0, s) for s in range(MA_STEPS)]
            dense = {dtype: ma_dense_steps(c, dev, sp_batches, dtype == "float32")
                     for dtype, c in dense_cfg.items()}
            f32, oracle = runs["float32"], dense["float32"]
            grad_rel = [ma_grad_rel(s["grads"], want)
                        for s, want in zip(f32["steps"], oracle["grads"])]
            control = [ma_grad_rel(s["grads"], want, 2.0)
                       for s, want in zip(f32["steps"], oracle["grads"])]
            err = moved = 0.0
            for k, w in oracle["final"].items():
                i = f32["init"][k].double()
                err += (f32["final"][k].double() - w.double()).square().sum().item()
                moved += (w.double() - i).square().sum().item()
            out["c_oracle"] = {
                "losses": oracle["losses"],
                "loss_rel": max(abs(s["loss"] - w) / abs(w)
                                for s, w in zip(f32["steps"], oracle["losses"])),
                "grad_rel": grad_rel, "control_grad_rel": control,
                "update_rel": (err / moved) ** 0.5,
                "dense": {dtype: {k: d[k] for k in ("losses", "ms", "step_ms", "peak_gb")}
                          for dtype, d in dense.items()}}
            section("c_oracle", t0)
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    out["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"ma_rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)


def ma_kernel_shapes(fi, fa) -> dict:
    """The kernels at the model axis's shapes on the card, by kernel: the
    InfoNCE pair at a queue shard of the sharded path, (B, K, C) = (256,
    32768, 128), held to its plain versions (phase 7's compare_infonce) and
    timed; the flash kernels at a rank's (c) blocks, B*H = 2 x 16 x 12 =
    384 heads of 392 tokens (n = 2) and of 98 (n = 8, the preset's axis),
    bf16, timed. Each with its plain version's time, its bound and one
    PyTorch call's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    b, kk, c, t = 256, K // MA_RANKS, DIM, 0.2
    q, k, queue = (torch.nn.functional.normalize(
        torch.randn(shape, generator=gen, device="cuda"), dim=-1)
        for shape in ((b, c), (b, c), (kk, c)))
    g = torch.full((b,), 1.0 / b, device="cuda")
    err = compare_infonce(fi, q, k, queue, t, g, f"B={b} K={kk} C={c} (a queue shard)")
    lse = fi.infonce_stats(q, k, queue, t)[1]
    pos = (q * k).sum(-1)

    def library_fwd():
        neg = q @ queue.T / t
        return torch.logsumexp(torch.cat([pos[:, None] / t, neg], 1), 1), (neg > pos[:, None] / t).sum(1)

    def library_bwd():
        logits = torch.cat([pos[:, None], q @ queue.T], 1) / t
        return (torch.softmax(logits, 1)[:, 1:] * g[:, None]) @ queue / t

    out = {}
    for name, fn, plain, lib, backward, e in (
            ("infonce_fwd", lambda: fi.infonce_stats(q, k, queue, t),
             lambda: fi.infonce_stats_reference(q, k, queue, t), library_fwd, False,
             max(err["pos"], err["lse"])),
            ("infonce_bwd", lambda: fi.infonce_dq(q, queue, lse, g, t),
             lambda: fi.infonce_dq_reference(q, queue, lse, g, t), library_bwd, True, err["dq"])):
        bound, bound_by = infonce_bound_ms(b, kk, c, backward)
        out[name] = [{"shape": {"B": b, "K": kk, "C": c}, "max_abs_err": e, "ms": cuda_ms(fn),
                      "plain_ms": cuda_ms(plain), "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": cuda_ms(lib)}]
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        out[name] = []
    heads = 2 * MA_SP_BATCH * 12
    for s in ((2 * IMG // 16) ** 2 // MA_RANKS, (2 * IMG // 16) ** 2 // MA_RING_WIDE):
        x = [torch.randn((2 * MA_SP_BATCH, 12, s, 64), generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(4)]
        qq, kk2, vv, gg = x
        scale = 64 ** -0.5
        o, lse2 = fa.flash_forward(qq, kk2, vv, scale)
        coeff = fa.backward_coeff(o, gg, torch.zeros_like(lse2))
        qs, ks, vs = (y.clone().requires_grad_(True) for y in (qq, kk2, vv))
        sdpa = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
        library_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), gg,
                                                          retain_graph=True), iters=20)
        for (name, _, _), run, plain, library in zip(FLASH, (
                lambda: fa.flash_forward(qq, kk2, vv, scale),
                lambda: fa.flash_dq(qq, kk2, vv, gg, lse2, coeff, scale),
                lambda: fa.flash_dkv(qq, kk2, vv, gg, lse2, coeff, scale)), (
                lambda: fa.attention_reference(qq, kk2, vv, scale),
                lambda: fa.flash_dq_reference(qq, kk2, vv, gg, lse2, coeff, scale),
                lambda: fa.flash_dkv_reference(qq, kk2, vv, gg, lse2, coeff, scale)), (
                lambda: torch.nn.functional.scaled_dot_product_attention(qq, kk2, vv),
                None, None)):
            bound, bound_by = flash_bound_ms(name, heads, s, 64, 2)
            out[name].append({"shape": {"BH": heads, "S": s, "D": 64, "dtype": "torch.bfloat16"},
                              "ms": cuda_ms(run, iters=20),
                              "plain_ms": cuda_ms(plain, iters=5, warm=2),
                              "bound_ms": bound, "bound_by": bound_by,
                              "library_ms": cuda_ms(library, iters=20) if library
                              else library_bwd})
        del x, qq, kk2, vv, gg, qs, ks, vs, sdpa
        torch.cuda.empty_cache()
    return out


def ma_spawn(gated: bool = False) -> dict:
    """12j's main world's ranks in a new temporary directory, started
    (behind a gate when `gated`: spawned while 12i runs); the ring's eight
    start with the phase."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ma_")
    count = torch.cuda.device_count()
    worlds = {key: (("nccl", [f"cuda:{r}" for r in range(n)]) if count >= n
                    else ("gloo", ["cuda:0"] * n))
              for key, n in (("main", MA_RANKS), ("ring", MA_RING_WIDE))}
    gate = os.path.join(tmp, "gate") if gated else None
    return {"tmp": tmp, "worlds": worlds, "gate": gate,
            "procs": start_ranks([(ma_rank_child, (r, MA_RANKS, worlds["main"][0],
                                                   worlds["main"][1][r],
                                                   os.path.join(tmp, "store"), tmp))
                                  for r in range(MA_RANKS)], gate)}


def model_axis_phase(fi, fa, spawned=None, after_ring=None):
    """Phase 12j (module docstring); returns its JSON, the launches of its
    paths per rank, and the kernels' records at its shapes. `spawned`,
    `ma_spawn(gated=True)`'s ranks (else they start here); `after_ring`,
    called once the ring's eight processes are done (the next phase's
    ranks spawn then)."""
    sp = spawned or ma_spawn()
    tmp, worlds, procs = sp["tmp"], sp["worlds"], list(sp["procs"])
    try:
        for key, n in (("main", MA_RANKS), ("ring", MA_RING_WIDE)):
            print(f"12j {key}: {n} ranks, backend {worlds[key][0]}, devices "
                  f"{sorted(set(worlds[key][1]))}", flush=True)
        t0 = time.perf_counter()
        if sp["gate"]:
            open(sp["gate"], "w").close()
        ring = start_ranks([(ma_ring_child, (
            r, MA_RING_WIDE, worlds["ring"][0], worlds["ring"][1][r],
            os.path.join(tmp, "store_ring"), tmp)) for r in range(MA_RING_WIDE)])
        procs += ring
        ring_codes = dp_join(ring, 2 * MA_TIMEOUT_S)
        if after_ring is not None:
            after_ring()
        codes = dp_join(procs[:MA_RANKS], 2 * MA_TIMEOUT_S) + ring_codes
        ranks, rings = [], []
        for r in range(MA_RANKS):
            with open(os.path.join(tmp, f"ma_rank{r}.json")) as f:
                ranks.append(json.load(f))
        for r in range(MA_RING_WIDE):
            with open(os.path.join(tmp, f"ring{r}.json")) as f:
                rings.append(json.load(f))
        wall = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            print(f"12j rank {r}: seconds by part {res.get('sections')}, wall "
                  f"{res.get('wall_s')}", flush=True)
        check(codes == [0] * len(procs) and not any("error" in r for r in ranks + rings),
              f"12j: exit {codes}: {[r.get('error') for r in ranks + rings]}")
        # (a) the sharded queue
        for r, res in enumerate(ranks):
            a = res["a"]
            check(all(np.isfinite(a["losses"])) and len(a["losses"]) == MA_STEPS,
                  f"12j(a) rank {r}: losses {a['losses']}")
            check(a["digests"] == ranks[0]["a"]["digests"], f"12j(a): rank {r} out of lockstep")
            check(a["launches"] == {"infonce_fwd": MA_STEPS, "infonce_bwd": MA_STEPS},
                  f"12j(a) rank {r}: InfoNCE launches {a['launches']}")
            check(a["queue_shape"] == [K // MA_RANKS, DIM] and
                  a["queue_ptr"] == MA_STEPS * a["batch"] % K,
                  f"12j(a) rank {r}: queue shard {a['queue_shape']}, ptr {a['queue_ptr']}")
            check(a["ledger"] == a["ledger_want"],
                  f"12j(a) rank {r}: ledger {a['ledger']} != {a['ledger_want']}")
        oracle = ranks[0]["a_oracle"]
        print(f"12j(a) against the replicated one-device step: {json.dumps(oracle)}", flush=True)
        check(oracle["loss_rel"] <= DP_LOSS_RTOL and oracle["update_rel"] <= DP_UPDATE_REL
              and oracle["queue_min_cos"] >= DP_QUEUE_COS,
              f"12j(a) against its oracle: {oracle}")
        # (b) the ring alone
        for res in [*ranks, *rings]:
            ring = res["ring"]
            print(f"12j(b) {ring['label']} rank {ring['rank']}: {json.dumps(ring['errs'])}",
                  flush=True)
            check(ring["ok"], f"12j(b) {ring['label']} rank {ring['rank']}: {ring['errs']}")
        # (c) the preset through train()
        for r, res in enumerate(ranks):
            for dtype, run in res["c"].items():
                steps = run["steps"]
                check(len(steps) == MA_STEPS and all(np.isfinite(s["loss"]) for s in steps),
                      f"12j(c) rank {r} {dtype}: losses {[s['loss'] for s in steps]}")
                check([s["print"] for s in steps]
                      == [s["print"] for s in ranks[0]["c"][dtype]["steps"]],
                      f"12j(c) {dtype}: rank {r} out of lockstep")
                for i, s in enumerate(steps):
                    check(s["launches"] == {"flash_fwd": 2 * 12 * MA_RANKS,
                                            "flash_dq": 12 * MA_RANKS,
                                            "flash_dkv": 12 * MA_RANKS},
                          f"12j(c) rank {r} {dtype} step {i}: flash launches {s['launches']}")
                item = 2 if dtype == "bfloat16" else 4
                kv = 2 * (2 * MA_SP_BATCH) * 12 * ((2 * IMG // 16) ** 2 // MA_RANKS) * 64 * item
                ring_bytes = run["ledger"].get("comms/ring_attention.kv_ppermute")
                check(ring_bytes == kv * MA_RANKS and "comms/grad.seq_psum" in run["ledger"],
                      f"12j(c) rank {r} {dtype}: ledger {run['ledger']}")
        c_oracle = ranks[0]["c_oracle"]
        print(f"12j(c) against the dense-flash one-device step (float32): "
              f"{json.dumps({k: v for k, v in c_oracle.items() if k != 'dense'})}", flush=True)
        check(c_oracle["loss_rel"] <= DP_LOSS_RTOL, f"12j(c) loss: {c_oracle['loss_rel']}")
        check(c_oracle["grad_rel"][0] <= MA_GRAD_REL,
              f"12j(c) the first step's gradients: {c_oracle['grad_rel']}")
        check(c_oracle["control_grad_rel"][0] > MA_GRAD_REL,
              f"12j(c): the reference's backbone gradient passes the gradient check: "
              f"{c_oracle['control_grad_rel']}")
        check(c_oracle["update_rel"] <= MA_UPDATE_REL, f"12j(c) update: {c_oracle['update_rel']}")
        timing = {}
        for r, res in enumerate(ranks):
            timing[f"rank{r}"] = {dtype: {
                "step_ms": float(np.median([s["step_ms"] for s in run["steps"][1:]])),
                "imgs_per_s": float(np.median([s["imgs_per_s"] for s in run["steps"][1:]])),
                "peak_gb": run["peak_gb"]} for dtype, run in res["c"].items()}
        timing["dense"] = {dtype: {"step_ms": d["step_ms"],
                                   "imgs_per_s": MA_SP_BATCH / d["step_ms"] * 1e3,
                                   "peak_gb": d["peak_gb"]}
                           for dtype, d in c_oracle["dense"].items()}
        print(f"12j(c) sequence parallel per rank beside dense: {json.dumps(timing)}", flush=True)
        t1 = time.perf_counter()
        shapes = ma_kernel_shapes(fi, fa)
        print(f"12j kernels at the model axis's shapes: {json.dumps(shapes)}; "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        launches = [{**res["a"]["launches"],
                     **{k: sum(run["launches"][k] for run in res["c"].values())
                        for k in ("flash_fwd", "flash_dq", "flash_dkv")}} for res in ranks]
        return {"worlds": worlds, "wall_s": wall, "a": {
                    "ranks": [{k: res["a"][k] for k in ("losses", "ms", "ledger")}
                              for res in ranks], "oracle": oracle},
                "b": [res["ring"] for res in [*ranks, *rings]],
                "c": {"oracle": c_oracle, "timing": timing,
                      "ledger": ranks[0]["c"]["bfloat16"]["ledger"],
                      "reduced": {"global_batch": [1024, MA_SP_BATCH],
                                  "num_model": [8, MA_RANKS]}},
                "sections": [res["sections"] for res in ranks]}, launches, shapes
    finally:
        end_ranks(procs)
        shutil.rmtree(tmp)


# phase 12k: the rest of distributed training on the card (module
# docstring). (a) a world of 2 x 2 (num_data x num_model: NCCL on four cards,
# else gloo with every rank on cuda:0) runs imagenet_v2 replicated and at
# ZeRO stages 1 and 3; (b) the same processes then form a world of 4 data
# ranks that runs imagenet_v2 through train() under elastic with
# kill@host=0, and 2 new processes relaunch the survivors' plan
ZK_NUM_DATA, ZK_NUM_MODEL = 2, 2
ZK_RANKS = ZK_NUM_DATA * ZK_NUM_MODEL
ZK_STEPS = 2  # (a)'s float32 steps per layout, and the relaunch's steps
ZK_LAYOUTS = (("dp", {}), ("stage1", ZERO_LAYOUTS["stage1"]), ("stage3", ZERO_LAYOUTS["stage3"]))
ZK_KILL_AT = 3  # (b): kill@host=0:at=3, rank 0 (the writer) dies at its step-3 log processing
ZK_EPOCH_STEPS = 8  # (b)'s steps_per_epoch: the kill lands mid-epoch
# (b)'s heartbeat_timeout, and its process group's timeout: a survivor
# blocked in a collective on a peer that has left it waits that long (gloo
# keeps a group's sockets open after the abort), so the rescale's
# signal-to-exit is bounded by about the larger of the two
ZK_HEARTBEAT_S, ZK_GROUP_TIMEOUT_S = 4.0, 12.0
ZK_TIMEOUT_S = 300.0


def zk_fingerprint(tensors: dict) -> str:
    """`tensor_fingerprint` but the queue (a model rank holds its own rows)."""
    return tensor_fingerprint(tensors, skip=("queue",))


@functools.lru_cache(maxsize=None)
def zk_tree(moco) -> dict:
    """`seeded_v2_state`'s numpy tree, made once per process."""
    params_q, stats_q = seeded_encoder(moco, SEED)
    params_k, stats_k = seeded_encoder(moco, SEED + 1)
    queue = np.random.default_rng(SEED + 2).standard_normal((K, DIM)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=1, keepdims=True)
    return {"step": 0, "params_q": params_q, "batch_stats_q": stats_q, "params_k": params_k,
            "batch_stats_k": stats_k, "queue": queue, "queue_ptr": 0}


def zk_whole(state) -> dict:
    """`zero_tensors` (whole parameters and optimizer buffers: a collective
    under ZeRO) with the whole queue (a gather over the model group)."""
    out = dict(zero_tensors(state))
    out["queue"] = state.full_queue()
    return out


def zk_fresh_state(cfg, world):
    """A train state of `cfg` from PyTorch's own seeded init (no numpy
    init: (b)'s run and the relaunch, which loads the checkpoint into it)."""
    from moco_tpu_torch.core.moco import build_encoder, create_state

    torch.manual_seed(SEED)
    return create_state(cfg, build_encoder(cfg.moco, world=world), device=world.device,
                        world=world)


def zk_elastic_config(workdir: str, batch: int):
    """imagenet_v2 (bf16) on synthetic data under elastic, a log line and a
    heartbeat every step, ZK_EPOCH_STEPS steps an epoch."""
    cfg = dp_config("imagenet_v2")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, global_batch=batch),
        optim=dataclasses.replace(cfg.optim, epochs=1),
        parallel=dataclasses.replace(cfg.parallel, timeout_s=ZK_GROUP_TIMEOUT_S),
        workdir=workdir, elastic=True, heartbeat_timeout=ZK_HEARTBEAT_S, log_every=1,
        steps_per_epoch=ZK_EPOCH_STEPS, obs_probe_every=0)


def zk_rank_child(rank: int, backend: str, device: str, tmp: str, workdir: str) -> None:
    """12k, rank `rank`: (a) in the 2 x 2 world (ZK_NUM_DATA x
    ZK_NUM_MODEL), imagenet_v2 in float32 without TF32, replicated and at
    ZeRO stages 1 and 3, ZK_STEPS steps each on the same batches (this data
    rank's rows, K / 2 queue rows a rank), rank 0 then the one-device step
    on the whole batches; written to zk_rank<r>_a.json. (b) a world of 4
    data ranks: train() under elastic with kill@host=0 (this process exits
    113 on rank 0, 75 on a survivor); written to zk_rank<r>_b.json."""
    from moco_tpu_torch.convert import state_from_flax
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline
    from moco_tpu_torch.ops import fused_infonce as fi
    from moco_tpu_torch.parallel.dist import DataPartition
    from moco_tpu_torch.parallel.mesh import init_world
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils import faults

    out = {"rank": rank, "backend": backend, "device": device, "sections": {}}
    t_start = time.perf_counter()
    try:
        world = init_world(backend, rank, ZK_RANKS, device=device,
                           store_path=os.path.join(tmp, "store_a"), timeout_s=ZK_TIMEOUT_S,
                           num_model=ZK_NUM_MODEL)
        dev = world.device
        finals, init = {}, None
        try:
            cfg = dp_config("imagenet_v2", compute_dtype="float32")
            b = cfg.data.global_batch
            dataset = SyntheticDataset(b * EPOCH_STEPS, IMG)
            part = DataPartition.of(world, b)
            with TwoCropPipeline(cfg.data, seed=cfg.seed, dataset=dataset, device=dev,
                                 partition=part) as pipe:
                it = pipe.epoch(0, device=True, stop=ZK_STEPS)
                try:
                    batches = [{k: v.clone() for k, v in bt.items()} for bt in it]
                finally:
                    it.close()
            with dp_full_f32():
                for name, par in ZK_LAYOUTS:
                    t0 = time.perf_counter()
                    c = dataclasses.replace(cfg, parallel=dataclasses.replace(
                        cfg.parallel, num_model=ZK_NUM_MODEL, **par))
                    state = state_from_flax(c, zk_tree(c.moco), device=dev, world=world)
                    if init is None:
                        init = {k: v.detach().cpu().clone() for k, v in zk_whole(state).items()}
                    step = dp_make_step(c, dev, world)
                    world.ledger.reset()
                    fi.infonce_stats.launches = fi.infonce_dq.launches = 0
                    run = {"losses": [], "ms": [], "prints": []}
                    for batch in batches:
                        torch.cuda.synchronize(dev)
                        t1 = time.perf_counter()
                        run["losses"].append(step(state, batch)["loss"].item())
                        torch.cuda.synchronize(dev)
                        run["ms"].append((time.perf_counter() - t1) * 1e3)
                        run["prints"].append(zk_fingerprint(zk_whole(state)))
                    run["launches"] = {"infonce_fwd": fi.infonce_stats.launches,
                                       "infonce_bwd": fi.infonce_dq.launches}
                    run["queue_shape"] = list(state.queue.shape)
                    run["queue_ptr"] = state.queue_ptr
                    run["hbm_state_bytes"] = zero_state_bytes(state)
                    run["shard_n"] = None if state.zero is None else state.zero.n
                    run["ledger"] = world.ledger.payload()
                    whole = zk_whole(state)
                    if rank == 0:
                        finals[name] = {k: v.detach().cpu().clone() for k, v in whole.items()}
                    out[name] = run
                    del state, step, whole
                    torch.cuda.empty_cache()
                    out["sections"][name] = round(time.perf_counter() - t0, 2)
            world.barrier()
        finally:
            world.close()
        if rank == 0:  # the one-device oracle on the whole batches, then the comparisons
            # (12h's: per-rank BN as ZK_NUM_DATA virtual groups, the same permutations)
            t0 = time.perf_counter()
            one = dataclasses.replace(cfg, moco=dataclasses.replace(
                cfg.moco, bn_virtual_groups=ZK_NUM_DATA))
            with TwoCropPipeline(one.data, seed=one.seed, dataset=dataset, device=dev) as pipe:
                whole_batches = [pipe.batch(0, s) for s in range(ZK_STEPS)]
            with dp_full_f32():
                state = state_from_flax(one, zk_tree(one.moco), device=dev)
                step = dp_make_step(one, dev)
                oracle = {"losses": [step(state, batch)["loss"].item()
                                     for batch in whole_batches]}
                oracle_tensors = {k: v.detach().cpu() for k, v in dp_tensors(state).items()}
            rows = ZK_STEPS * b
            out["against"] = {
                f"{name}_vs_{ref}": compare_tensors(
                    want, init, finals[name], out[name]["losses"], want_losses, rows)
                for name in ("dp", "stage1", "stage3")
                for ref, want, want_losses in (("one_device", oracle_tensors, oracle["losses"]),
                                               ("dp", finals["dp"], out["dp"]["losses"]))
                if name != ref}
            out["oracle"] = oracle
            del state, step, finals, oracle_tensors, whole_batches
            torch.cuda.empty_cache()
            out["sections"]["oracle"] = round(time.perf_counter() - t0, 2)
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    out["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(tmp, f"zk_rank{rank}_a.json"), "w") as f:
        json.dump(out, f, default=str)
    if "error" in out:
        return
    # (b) elastic: a world of 4 data ranks, rank 0 killed at step ZK_KILL_AT
    res = {"rank": rank}
    code = 0
    try:
        # The group's timeout is short (a survivor waits out the lost rank) and
        # bounds its rendezvous too, while rank 0 comes from (a)'s oracle
        # ~11 s after the others: the ranks first meet under ZK_TIMEOUT_S.
        import datetime

        import torch.distributed as dist

        ready = dist.FileStore(os.path.join(tmp, "store_b_ready"), ZK_RANKS)
        ready.set_timeout(datetime.timedelta(seconds=ZK_TIMEOUT_S))
        ready.set(f"rank{rank}", "1")
        ready.wait([f"rank{r}" for r in range(ZK_RANKS)])
        world = init_world(backend, rank, ZK_RANKS, device=device,
                           store_path=os.path.join(tmp, "store_b"),
                           timeout_s=ZK_GROUP_TIMEOUT_S)
        cfg = zk_elastic_config(workdir, 256)
        state = zk_fresh_state(cfg, world)
        faults.install(f"kill@host=0:at={ZK_KILL_AT}")
        fi.infonce_stats.launches = fi.infonce_dq.launches = 0
        records: list = []
        res["t_train"] = time.time()

        def log(rec):
            rec["t"] = time.time()
            records.append(rec)

        try:
            train(cfg, dataset=SyntheticDataset(256 * ZK_EPOCH_STEPS, IMG), device=world.device,
                  world=world, state=state, log=log)
            res["error"] = "train() returned: no rescale"
        except SystemExit as e:
            code = e.code
        finally:
            world.close()  # aborted by the rescale: no teardown with the lost peer
        res.update(exit=code, t_exit=time.time(), losses=[r["loss"] for r in records],
                   steps=[r["step"] for r in records], t_steps=[r["t"] for r in records],
                   launches={"infonce_fwd": fi.infonce_stats.launches,
                             "infonce_bwd": fi.infonce_dq.launches})
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"zk_rank{rank}_b.json"), "w") as f:
        json.dump(res, f, default=str)
    sys.stdout.flush()
    os._exit(code if isinstance(code, int) and "error" not in res else 1)


def zk_relaunch_child(rank: int, n: int, backend: str, device: str, tmp: str, workdir: str,
                      t_spawn: float) -> None:
    """12k(b)'s relaunch, rank `rank` of `n` at the plan's batch: the
    emergency checkpoint loaded into a fresh state and held to the file bit
    for bit (its `state_payload` against the file's, every tensor), then
    ZK_STEPS steps through train() (which resumes the same file) with the
    live lr and momentum; zk_relaunch<r>.json."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.ops import fused_infonce as fi
    from moco_tpu_torch.parallel.mesh import init_world
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_payload,
        state_payload,
    )

    out = {"rank": rank, "t_spawn": t_spawn, "t_start": time.time()}
    try:
        world = init_world(backend, rank, n, device=device,
                           store_path=os.path.join(tmp, "store_c"), timeout_s=ZK_TIMEOUT_S)
        try:
            batch = 256 * n // ZK_RANKS
            cfg = zk_elastic_config(workdir, batch)
            state = zk_fresh_state(cfg, world)
            mgr = CheckpointManager(workdir)
            payload, extra = mgr.restore()
            mgr.close()
            load_state_payload(state, payload)
            mine = state_payload(state, cfg.moco.arch, payload["epoch"])

            def flat(tree, prefix=""):
                if isinstance(tree, dict):
                    for k, v in tree.items():
                        yield from flat(v, f"{prefix}{k}.")
                elif torch.is_tensor(tree):
                    yield prefix[:-1], tree

            want = dict(flat({"sd": payload["state_dict"], "opt": payload["optimizer"]}))
            got = dict(flat({"sd": mine["state_dict"], "opt": mine["optimizer"]}))
            out["resume_unequal"] = sorted(
                k for k in set(want) | set(got)
                if k not in want or k not in got
                or not torch.equal(want[k].cpu(), got[k].detach().cpu()))
            out["resume_tensors"] = len(want)
            out["ckpt_step"], out["ckpt_extra"] = payload["step"], extra
            fi.infonce_stats.launches = fi.infonce_dq.launches = 0
            records: list = []

            def log(rec):
                if not records:
                    out["t_first_step"] = time.time()
                records.append(rec)

            res = train(cfg, dataset=SyntheticDataset(batch * ZK_EPOCH_STEPS, IMG),
                        device=world.device, world=world, steps=ZK_STEPS, state=state, log=log)
            out.update(losses=[r["loss"] for r in records], steps=[r["step"] for r in records],
                       lr=res["config"].optim.lr, momentum=res["config"].moco.momentum,
                       batch=batch, launches={"infonce_fwd": fi.infonce_stats.launches,
                                              "infonce_bwd": fi.infonce_dq.launches},
                       print=zk_fingerprint(dp_tensors(res["state"])))
            world.barrier()
        finally:
            world.close()
    except BaseException:
        import traceback

        out["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"zk_relaunch{rank}.json"), "w") as f:
        json.dump(out, f, default=str)


def zk_infonce_check(fi) -> dict:
    """The InfoNCE kernels against their plain versions at a 2 x 2 rank's
    shapes: (B, K, C) = (128, 32768, 128), its data rank's rows against its
    queue shard (phase 7's checks)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    b, kk = 256 // ZK_NUM_DATA, K // ZK_NUM_MODEL
    q, k, queue = (torch.nn.functional.normalize(
        torch.randn(shape, generator=gen, device="cuda"), dim=-1)
        for shape in ((b, DIM), (b, DIM), (kk, DIM)))
    g = torch.full((b,), 1.0 / b, device="cuda")
    return compare_infonce(fi, q, k, queue, 0.2, g, f"B={b} K={kk} C={DIM} (a 2 x 2 rank)")


def zk_spawn(gated: bool = False) -> dict:
    """12k's ranks in a new temporary directory, started (behind a gate
    when `gated`: spawned while 12j runs)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zk_")
    workdir = os.path.join(tmp, "elastic")
    count = torch.cuda.device_count()
    backend, devices = (("nccl", [f"cuda:{r}" for r in range(ZK_RANKS)])
                        if count >= ZK_RANKS else ("gloo", ["cuda:0"] * ZK_RANKS))
    gate = os.path.join(tmp, "gate") if gated else None
    return {"tmp": tmp, "workdir": workdir, "backend": backend, "devices": devices,
            "gate": gate,
            "procs": start_ranks([(zk_rank_child, (r, backend, devices[r], tmp, workdir))
                                  for r in range(ZK_RANKS)], gate)}


def zk_phase(fi, spawned=None):
    """Phase 12k (module docstring); returns its JSON and the launches of
    its paths per process. `spawned`, `zk_spawn(gated=True)`'s ranks (else
    they start here)."""
    import torch.multiprocessing as mp

    from moco_tpu_torch.obs.schema import validate_line
    from moco_tpu_torch.utils.checkpoint import CheckpointManager
    from moco_tpu_torch.utils.config import apply_auto_scale
    from moco_tpu_torch.utils.contracts import KILL_EXIT_CODE, RESCALE_EXIT_CODE

    ctx = mp.get_context("spawn")
    sp = spawned or zk_spawn()
    tmp, workdir, backend, devices, procs = (sp["tmp"], sp["workdir"], sp["backend"],
                                             sp["devices"], list(sp["procs"]))
    try:
        t0 = time.perf_counter()
        infonce = zk_infonce_check(fi)
        print(f"12k: {ZK_RANKS} ranks, backend {backend}, devices {sorted(set(devices))}",
              flush=True)
        if sp["gate"]:
            open(sp["gate"], "w").close()
        # each process's exit, on the host clock: (b)'s kill and rescale exits
        exits: dict = {}
        deadline = time.monotonic() + 3 * ZK_TIMEOUT_S
        while len(exits) < ZK_RANKS and time.monotonic() < deadline:
            for r, p in enumerate(procs):
                if r not in exits and p.exitcode is not None:
                    exits[r] = (p.exitcode, time.time())
            time.sleep(0.02)
        codes = dp_join(procs, 10.0)
        ranks = []
        for r in range(ZK_RANKS):
            with open(os.path.join(tmp, f"zk_rank{r}_a.json")) as f:
                ranks.append(json.load(f))
        for r, res in enumerate(ranks):
            print(f"12k(a) rank {r}: seconds by part {res.get('sections')}, wall "
                  f"{res.get('wall_s')}", flush=True)
        check(not any("error" in r for r in ranks),
              f"12k(a): {[r.get('error') for r in ranks]}")
        # (a) ZeRO over the data group of the 2 x 2 world
        b = 256
        for r, res in enumerate(ranks):
            for name, _ in ZK_LAYOUTS:
                run = res[name]
                check(len(run["losses"]) == ZK_STEPS and all(np.isfinite(run["losses"])),
                      f"12k(a) rank {r} {name}: losses {run['losses']}")
                check(run["prints"] == ranks[0][name]["prints"],
                      f"12k(a) {name}: rank {r} out of lockstep")
                check(run["launches"] == {"infonce_fwd": ZK_STEPS, "infonce_bwd": ZK_STEPS},
                      f"12k(a) rank {r} {name}: InfoNCE launches {run['launches']}")
                check(run["queue_shape"] == [K // ZK_NUM_MODEL, DIM]
                      and run["queue_ptr"] == ZK_STEPS * b % K,
                      f"12k(a) rank {r} {name}: queue shard {run['queue_shape']}, "
                      f"ptr {run['queue_ptr']}")
                check(run["shard_n"] in (None, ZK_NUM_DATA),
                      f"12k(a) rank {r} {name}: shards over {run['shard_n']} ranks")

        def meets(o):
            return (o["loss_rel"] <= DP_LOSS_RTOL and o["update_rel"] <= DP_UPDATE_REL
                    and o["queue_min_cos"] >= DP_QUEUE_COS)

        against = ranks[0]["against"]
        for key, o in against.items():
            print(f"12k(a) {key}: {json.dumps(o)}", flush=True)
            check(meets(o), f"12k(a) {key}: {o}")
        state_bytes = {f"rank{r}": {name: res[name]["hbm_state_bytes"] for name, _ in ZK_LAYOUTS}
                       for r, res in enumerate(ranks)}
        print(f"12k(a) hbm_state_bytes per rank: {json.dumps(state_bytes)}", flush=True)
        check(all(s["stage3"] < s["dp"] for s in state_bytes.values()),
              f"12k(a): stage 3 holds no less than the replicated step: {state_bytes}")
        # (b) elastic
        el = {}
        for r in range(ZK_RANKS):
            path = os.path.join(tmp, f"zk_rank{r}_b.json")
            if os.path.exists(path):
                with open(path) as f:
                    el[r] = json.load(f)
        print(f"12k(b) exit codes {codes}", flush=True)
        check(codes == [KILL_EXIT_CODE] + [RESCALE_EXIT_CODE] * (ZK_RANKS - 1),
              f"12k(b): exit codes {codes}: {[el.get(r, {}).get('error') for r in range(4)]}")
        check(sorted(el) == [1, 2, 3] and not any("error" in v for v in el.values()),
              f"12k(b): survivors' records {el}")
        signal_to_exit = max(exits[r][1] for r in (1, 2, 3)) - exits[0][1]
        mgr = CheckpointManager(workdir)
        steps_on_disk = mgr.all_steps()
        extra = mgr.read_extra(steps_on_disk[-1]) if steps_on_disk else {}
        mgr.close()
        check(steps_on_disk == [ZK_KILL_AT] and extra.get("reason") == "rescale"
              and extra.get("emergency") and extra["rescale"]["new_num_data"] == 2
              and extra["rescale"]["new_global_batch"] == 128,
              f"12k(b): checkpoints {steps_on_disk}, extras {extra}")
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        rescale = [ln for ln in lines if ln.get("event") == "rescale"]
        check(len(rescale) == 1 and validate_line(rescale[0]) == []
              and rescale[0]["rescale/dead_hosts"] == [0]
              and rescale[0]["rescale/new_num_data"] == 2
              and rescale[0]["rescale/new_global_batch"] == 128
              and rescale[0]["rescale/kappa"] == 0.5,
              f"12k(b): rescale lines {rescale}")
        # the relaunch at the plan's width
        t_spawn = time.time()
        relaunch = [ctx.Process(target=zk_relaunch_child, args=(
            r, 2, backend, devices[r], tmp, workdir, t_spawn)) for r in range(2)]
        for p in relaunch:
            p.start()
        rcodes = dp_join(relaunch, 2 * ZK_TIMEOUT_S)
        rel = []
        for r in range(2):
            with open(os.path.join(tmp, f"zk_relaunch{r}.json")) as f:
                rel.append(json.load(f))
        check(rcodes == [0, 0] and not any("error" in r for r in rel),
              f"12k(b) relaunch: exit {rcodes}: {[r.get('error') for r in rel]}")
        want, _ = apply_auto_scale(dataclasses.replace(zk_elastic_config(workdir, 128),
                                                       auto_scale="ref_batch=256"))
        for r, res in enumerate(rel):
            check(res["resume_unequal"] == [] and res["ckpt_step"] == ZK_KILL_AT,
                  f"12k(b) relaunch rank {r}: resume differs in {res['resume_unequal'][:5]}")
            check(res["steps"] == [ZK_KILL_AT + i + 1 for i in range(ZK_STEPS)]
                  and all(np.isfinite(res["losses"])) and res["print"] == rel[0]["print"],
                  f"12k(b) relaunch rank {r}: steps {res['steps']}, losses {res['losses']}")
            check(res["launches"] == {"infonce_fwd": ZK_STEPS, "infonce_bwd": ZK_STEPS},
                  f"12k(b) relaunch rank {r}: InfoNCE launches {res['launches']}")
            check(res["lr"] == want.optim.lr and res["momentum"] == want.moco.momentum,
                  f"12k(b) relaunch rank {r}: lr {res['lr']}, momentum {res['momentum']} "
                  f"!= {want.optim.lr}, {want.moco.momentum}")
        relaunch_to_first_step = max(res["t_first_step"] for res in rel) - t_spawn
        b_out = {"exit_codes": codes, "signal_to_exit_s": signal_to_exit,
                 "survivor_exit_s": {r: exits[r][1] - exits[0][1] for r in (1, 2, 3)},
                 "relaunch_to_first_step_s": relaunch_to_first_step,
                 "rescale_line": {k: v for k, v in rescale[0].items()
                                  if k.startswith("rescale/")},
                 "relaunch": [{k: res[k] for k in ("losses", "steps", "lr", "momentum", "batch",
                                                   "resume_tensors")} for res in rel],
                 "survivor_losses": {r: v["losses"] for r, v in el.items()},
                 "survivor_step_s": {r: [t - v["t_train"] for t in v["t_steps"]]
                                     for r, v in el.items()}}
        print(f"12k(b) elastic: {json.dumps(b_out)}", flush=True)
        launches = [{k: sum(res[name]["launches"][k] for name, _ in ZK_LAYOUTS)
                     + el.get(r, {}).get("launches", {}).get(k, 0)
                     for k in ("infonce_fwd", "infonce_bwd")} for r, res in enumerate(ranks)]
        launches += [res["launches"] for res in rel]
        return {"backend": backend, "devices": devices, "wall_s": time.perf_counter() - t0,
                "infonce_at_rank_shapes": infonce,
                "a": {"against": against, "hbm_state_bytes": state_bytes,
                      "ranks": [{name: {k: res[name][k] for k in ("losses", "ms", "ledger")}
                                 for name, _ in ZK_LAYOUTS} for res in ranks],
                      "oracle": ranks[0]["oracle"], "sections": [r["sections"] for r in ranks]},
                "b": b_out}, launches
    finally:
        end_ranks(procs)
        shutil.rmtree(tmp)


# phase 12l: the serving fleet. Two replica processes on the card behind the
# router; a burst from FL_CLIENTS client processes of FL_BURST requests each
# (of FL_BURST_SIZES images, the reference smoke's small requests), whose
# FL_KILL_AT-th data POST on replica 1 kills it; FL_WARM_ROWS warm rows from
# the live checkpoint's queue replayed into a reborn replica; FL_LAT_N
# sequential requests of a full bucket (32 images, no coalescing wait) a
# side for the router's and a replica's latency; FL_NEIGHBORS requests of 32
# through the in-process fleet of (d)
FL_CLIENTS, FL_BURST, FL_KILL_AT, FL_WARM_ROWS, FL_LAT_N, FL_NEIGHBORS = 4, 6, 5, 4096, 20, 4
FL_BURST_SIZES = (1, 2, 4, 8)
# 12m(c): the replicas' freshness objective (the reference fleet smoke's:
# it puts the freshness gauges on their lines, nothing burns in a phase)
FL_FRESH_MAX_AGE_S = 600.0
FL_BOOT_S = 300.0  # a replica's spawn-to-healthy limit
FL_HOP_REL, FL_HOP_MS = 0.05, 2.0  # the stitched hop sum against the client's wall
# the compatible candidate: the live encoders' parameters scaled by 1 +
# FL_NUDGE (the reference smoke's stand-in for one more epoch: a new digest,
# the same embedding space). Its gates: the default compatibility floors;
# the reference smoke's feature_std floor for an untrained encoder; an EMA-
# drift ceiling above the seeded state's (phase 8 starts the key encoder
# from another seed on purpose: its drift is ~1.1, over the default 0.5)
FL_NUDGE, FL_MAX_EMA_DRIFT, FL_FEATURE_STD_FLOOR = 1e-3, 2.0, 0.05


def fl_post(url, path, imgs, timeout=120):
    req = urllib.request.Request(url + path, data=imgs.tobytes(),
                                 headers={"X-Image-Shape": ",".join(map(str, imgs.shape))})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def fl_get(url, path, timeout=30):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.loads(r.read())


def fl_wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < deadline, f"12l: {what} within {timeout:.0f} s")
        time.sleep(0.05)


def fl_burst_images(c: int, img: int) -> list:
    """Client c's FL_BURST request batches of FL_BURST_SIZES seeded images."""
    rng = np.random.default_rng(SEED + 130 + c)
    return [rng.integers(0, 256, (int(n), img, img, 3), np.uint8)
            for n in rng.choice(FL_BURST_SIZES, FL_BURST)]


def fl_timed_post(url, path, imgs) -> tuple:
    """(answer, wall ms, wall clock at the first byte): POST `imgs` on a
    connection opened beforehand; the wall runs from the request's first
    byte to the answer's last, the span the router's trace can account for
    (the connection's setup and the JSON decode stay outside it)."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.connect()
        w0, t0 = time.time(), time.perf_counter()
        conn.request("POST", path, body=imgs.tobytes(),
                     headers={"X-Image-Shape": ",".join(map(str, imgs.shape))})
        resp = conn.getresponse()
        raw = resp.read()
        wall = (time.perf_counter() - t0) * 1e3
        if resp.status != 200:
            raise OSError(f"HTTP {resp.status}: {raw[:200]!r}")
    finally:
        conn.close()
    return json.loads(raw), wall, w0


def fl_burst_client(args) -> dict:
    """One burst client of 12l(a), in a process of its own: one untimed
    /healthz (the process's first request pays its HTTP modules' imports),
    then requests alternating /embed and /neighbors; returns each answer
    with its wall ms and the wall clock of its first byte, and each
    failure."""
    url, c, img = args
    fl_get(url, "/healthz")
    out = {"answers": [], "failures": []}
    for j, imgs in enumerate(fl_burst_images(c, img)):
        path = "/neighbors" if j % 2 else "/embed"
        try:
            body, wall, w0 = fl_timed_post(url, path, imgs)
        except Exception as e:  # a failed client request is what is counted
            out["failures"].append(repr(e))
            continue
        out["answers"].append((path, body, wall, w0))
    return out


def fl_percentiles(ms: list) -> dict:
    a = np.sort(np.asarray(ms))
    pick = lambda p: float(a[min(int(p * (len(a) - 1) + 0.5), len(a) - 1)])  # noqa: E731
    return {"p50_ms": pick(0.50), "p99_ms": pick(0.99), "n": len(ms)}


def fl_candidate(src_dir: str, dst_dir: str, *, nudge=None, reinit_seed=None) -> None:
    """`src_dir`'s newest checkpoint with both encoders changed and saved
    one step later: every parameter (not the BatchNorm statistics) scaled
    by 1 + `nudge`, or every module re-initialised from `reinit_seed`
    (PyTorch's init, BatchNorm statistics reset): a candidate trained from
    nothing."""
    from moco_tpu_torch.lincls import restore_pretrain_state
    from moco_tpu_torch.utils.checkpoint import CheckpointManager, encoder_to_reference

    mgr = CheckpointManager(src_dir)
    payload, extra = mgr.restore()
    restored = restore_pretrain_state(src_dir, sides=("q", "k"), device="cpu")
    sd = payload["state_dict"]
    for side, enc in restored.encoders.items():
        with torch.no_grad():
            if reinit_seed is not None:
                torch.manual_seed(reinit_seed)
                for m in enc.modules():
                    if hasattr(m, "reset_parameters"):
                        m.reset_parameters()
            else:
                for p in enc.parameters():
                    p.mul_(1.0 + nudge)
        for k, v in encoder_to_reference(enc).items():
            name = f"module.encoder_{side}.{k}"
            check(name in sd and sd[name].shape == v.shape, f"12l: candidate key {name}")
            sd[name] = v.detach().clone()
    CheckpointManager(dst_dir).save(mgr.latest_step() + 1, payload, extra=extra)


def fl_noop(x):
    return x


class FlThread(threading.Thread):
    """`fn()` on a thread, started at once; `result()` joins it and returns
    its value or raises its exception."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn, self._out = fn, None
        self.start()

    def run(self):
        try:
            self._out = (self._fn(), None)
        except BaseException as e:  # raised again on the caller's thread
            self._out = (None, e)

    def result(self, timeout=FL_BOOT_S):
        self.join(timeout)
        check(self._out is not None, "12l: a helper thread did not finish")
        value, err = self._out
        if err is not None:
            raise err
        return value


def fleet_phase(ivf_scan, v2_dir, fanout_dir, workdir, device="cuda"):
    """Phase 12l: the serving fleet (module docstring) over 12e's v2
    checkpoint (`v2_dir`), fanning out the queue of 12g's newer one
    (`fanout_dir`), in `workdir`; returns (its numbers, its cell-scan
    launches)."""
    import torch.multiprocessing as mp

    from moco_tpu_torch.analysis import contracts as contract_cov
    from moco_tpu_torch.obs import critpath
    from moco_tpu_torch.obs.schema import validate_line, validate_lines
    from moco_tpu_torch.serve import serve_ingest, serve_promote
    from moco_tpu_torch.serve.engine import InferenceEngine, load_serving_encoder
    from moco_tpu_torch.serve.fleet import ReplicaSupervisor
    from moco_tpu_torch.serve.promote import DEFAULT_FLOORS, PromotionLedger, ledger_record
    from moco_tpu_torch.serve.router import FleetRouter

    out = {}
    phase_t0 = time.perf_counter()

    def lap(what: str) -> None:
        print(f"12l: {what} at {time.perf_counter() - phase_t0:.1f} s", flush=True)

    os.makedirs(workdir, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    env.pop("MOCO_FAULTS", None)
    env["MOCO_CONTRACT_COVERAGE"] = "1"  # 12m(c): each replica dumps its contract coverage
    # 12m(c): this process's own (the router's routes, the ledger's and the
    # lines' validators), from here to the gate
    recorder = contract_cov.install_recorder()
    live_queue, _ = serve_ingest.read_queue(v2_dir)
    warm = np.ascontiguousarray(live_queue[:FL_WARM_ROWS])
    sup = ReplicaSupervisor(
        2, ckpt_dir=v2_dir, workdir=os.path.join(workdir, "fleet"),
        buckets=tuple(int(b) for b in REPLICA_BUCKETS.split(",")), device=device, env=env,
        extra_env={1: {"MOCO_FAULTS": f"kill@replica=1:at={FL_KILL_AT}"}},
        warm_rows_fn=lambda: warm, boot_timeout_s=FL_BOOT_S, monitor_interval_s=0.1,
        restart_backoff_s=0.1, fresh_max_age_s=FL_FRESH_MAX_AGE_S)
    # each replica's spawn to its first healthy answer, polled beside the
    # supervisor's own wait
    healthy_at = {}

    def first_healthy(i):
        while i not in healthy_at:
            try:
                if fl_get(sup.url(i), "/healthz", timeout=2).get("ok"):
                    healthy_at[i] = time.monotonic()
            except OSError:
                time.sleep(0.05)

    try:
        sup_err, router, pool = [], None, None
        try:
            sup_thread = threading.Thread(target=lambda: _fl_start(sup, sup_err))
            sup_thread.start()
            pollers = [threading.Thread(target=first_healthy, args=(i,), daemon=True)
                       for i in (0, 1)]
            for t in pollers:
                t.start()
            # while the replicas boot: the burst's client processes, the
            # in-process engine, and the candidates on a thread of their own
            # (host work, done before the burst)
            pool = concurrent.futures.ProcessPoolExecutor(FL_CLIENTS,
                                                          mp_context=mp.get_context("spawn"))
            clients_up = list(pool.map(fl_noop, range(FL_CLIENTS)))
            reinit_dir, cand_dir = os.path.join(workdir, "reinit"), os.path.join(workdir, "cand")
            cand_thread = FlThread(lambda: (
                fl_candidate(v2_dir, reinit_dir, reinit_seed=SEED + 999),
                fl_candidate(v2_dir, cand_dir, nudge=FL_NUDGE)))
            encoder, _, _, config = load_serving_encoder(v2_dir, device=device)
            img = config.data.image_size
            local = InferenceEngine(encoder, img, buckets=(1, 8, 32), device=device)
            local.warmup()
            sup_thread.join(timeout=FL_BOOT_S + 30)
            check(sup_err == [None] and clients_up == list(range(FL_CLIENTS)),
                  f"12l: the supervisor's start: {sup_err}")
            for t in pollers:
                t.join(timeout=10)
            spawn_t = {e["replica"]: e["t"] for e in sup.events() if e["kind"] == "spawn"}
            out["spawn_to_healthy_s"] = [healthy_at[i] - spawn_t[i] for i in (0, 1)]
            lap(f"(a) 2 replicas healthy, {[round(s, 1) for s in out['spawn_to_healthy_s']]} s "
                "after their spawns")
            router = FleetRouter(supervisor=sup, workdir=os.path.join(workdir, "fleet"),
                                 health_interval_s=0.1, hedge=False, retry_attempts=4,
                                 retry_base_delay_s=0.02, breaker_fail_threshold=1,
                                 breaker_cooldown_s=0.5, breaker_cooldown_cap_s=2.0,
                                 readmit_timeout_s=FL_BOOT_S, metrics_flush_s=0.5)
            url = f"http://127.0.0.1:{router.port}"
            rng = np.random.default_rng(SEED + 121)
            full = rng.integers(0, 256, (32, img, img, 3), np.uint8)  # a full bucket

            # (a) the burst through the kill, each client a process of its own so
            # that its wall clock waits on no thread of the router's process; the
            # candidates' thread done and the heap collected first, so no other
            # work of this process holds the interpreter while the router serves
            cand_thread.result()
            gc.collect()
            done = list(pool.map(fl_burst_client, [(url, c, img) for c in range(FL_CLIENTS)]))
            failures = [f for d in done for f in d["failures"]]
            answers = [(imgs, path, body, wall, w0) for c, d in enumerate(done)
                       for imgs, (path, body, wall, w0) in zip(fl_burst_images(c, img),
                                                               d["answers"])]
            check(failures == [], f"12l(a): {len(failures)} failed client requests: {failures[:3]}")
            check(len(answers) == FL_CLIENTS * FL_BURST, f"12l(a): {len(answers)} answers")
            lap(f"(a) burst of {len(answers)} answered")
            exits = [e for e in sup.events() if e["kind"] == "exit"]
            check([(e["replica"], e["rc"], e["reason"]) for e in exits] == [(1, 113, "crash")],
                  f"12l(a): exits {exits}")
            t_exit = exits[0]["t"]
            # the burst's stitched traces, before the readmission's probes join
            # the fleet flight ring
            flight = {r["trace_id"]: r for r in fl_get(url, "/debug/flight")["requests"]}
            # kill to readmit: the first answer from replica 1 through the router
            # after its exit (full-bucket probes: no coalescing wait), polled on a
            # thread while this one goes on
            readmit = {}

            def wait_readmit():
                while "t" not in readmit and time.monotonic() - t_exit < FL_BOOT_S:
                    try:
                        if fl_post(url, "/embed", full)["replica"] == 1:
                            readmit["t"] = time.monotonic()
                    except OSError as e:
                        readmit.setdefault("errors", []).append(repr(e))
                    time.sleep(0.05)

            readmitter = threading.Thread(target=wait_readmit)
            readmitter.start()
            for imgs, path, body, wall, w0 in answers:
                check(body["request_id"].startswith(f"r{body['replica']}-"),
                      f"12l(a): replica {body['replica']} vs request id {body['request_id']}")
            emb = np.concatenate([np.asarray(b["embedding"], np.float32)
                                  for _, _, b, _, _ in answers])
            want = np.concatenate([local.embed(imgs)[0] for imgs, *_ in answers])
            cosine = float((emb * want).sum(1).min())
            check(cosine >= 0.99, f"12l(a): fleet vs in-process engine cosine {cosine}")
            out["fleet_vs_engine_min_cosine"] = cosine
            # the stitched hop sum against each client's wall (before the
            # router's clock starts: the request's first byte to the handler's
            # entry; after it stops: its last write to the client's last byte)
            worst, gaps, split = 0.0, [], []
            for _, _, body, wall, w0 in answers:
                rec = flight.get(body["trace_id"])
                check(rec is not None, f"12l(a): trace {body['trace_id']} not in the flight ring")
                hops = critpath.attribute(rec)["hops"]
                total = sum(hops.values())
                gaps.append(abs(total - wall))
                worst = max(worst, gaps[-1] / max(wall, 1e-9))
                before = (rec["wall_t0"] - w0) * 1e3
                top = sorted(hops.items(), key=lambda kv: -kv[1])[:3]
                split.append({"wall_ms": round(wall, 3), "hops_ms": round(total, 3),
                              "before_ms": round(before, 3),
                              "after_ms": round(wall - before - rec["total_ms"], 3),
                              "attempts": len(rec["attempts"]),
                              "top_hops": {k: round(v, 2) for k, v in top}})
            out["hop_sum_worst_rel"], out["hop_sum_worst_ms"] = worst, max(gaps)
            out["before_ms_max"] = max(r["before_ms"] for r in split)
            print(f"12l(a): client wall against the stitched hop sum, per request: "
                  f"{json.dumps(split)}", flush=True)
            for rec in split:
                check(abs(rec["hops_ms"] - rec["wall_ms"]) <= max(FL_HOP_REL * rec["wall_ms"],
                                                                  FL_HOP_MS),
                      f"12l(a): hop sum {rec['hops_ms']} ms vs the client's {rec['wall_ms']} ms "
                      f"({rec})")

            # (c) while replica 1 respawns: the re-initialised candidate's gates
            ledger_path = os.path.join(workdir, "promotions.jsonl")
            gate_args = ["--live-dir", v2_dir, "--ledger", ledger_path, "--device", device,
                         "--probes", "32", "--max-ema-drift", f"{FL_MAX_EMA_DRIFT:g}",
                         "--floor-feature-std", f"{FL_FEATURE_STD_FLOOR:g}"]
            rc = serve_promote.main(["--candidate-dir", reinit_dir, *gate_args])
            with open(ledger_path) as f:
                ledger = [json.loads(line) for line in f if line.strip()]
            check(rc == 1 and len(ledger) == 1 and ledger[0]["promotion/verdict"] == "rejected"
                  and ledger[0]["promotion/failed_gate"] is not None,
                  f"12l(c): the re-initialised candidate: rc {rc}, ledger {ledger}")
            out["reinit"] = {k.split("/", 1)[1]: v for k, v in ledger[0].items()
                             if k.startswith("promotion/")}
            lap(f"(c) re-initialised candidate rejected by {ledger[0]['promotion/failed_gate']}")
            # the compatible candidate's gates too, its rollout after (b): the
            # two halves of serve_promote's pass with the router
            floors = {"compat_cosine": 0.90, "recall_overlap": 0.60,
                      "feature_std": FL_FEATURE_STD_FLOOR, "ema_drift_max": FL_MAX_EMA_DRIFT,
                      "live_recall": None}
            gates, cand_digest, cand_step = serve_promote.gate_candidate(
                v2_dir, cand_dir, n_probes=32, floors=floors, device=device)
            PromotionLedger(ledger_path).append(ledger_record(
                cand_step, "accepted" if gates["ok"] else "rejected", "gates", digest=cand_digest,
                failed_gate=gates["failed_gate"], gates=gates["gates"], compat=gates["compat"]))
            out["accepted"] = {name: g["value"] for name, g in gates["gates"].items()}
            # which gates the default floors would have failed
            out["default_floor_fails"] = [
                g for g, floor in DEFAULT_FLOORS.items()
                if floor is not None and out["accepted"].get(g) is not None
                and (out["accepted"][g] > floor if g.endswith("_max") else out["accepted"][g] < floor)]
            print(f"12l(c): the compatible candidate's gates {gates['gates']}; under the default "
                  f"floors it would fail {out['default_floor_fails']}", flush=True)
            check(gates["ok"], f"12l(c): the compatible candidate failed {gates['failed_gate']}")
            lap("(c) the compatible candidate's gates passed")

            readmitter.join(timeout=FL_BOOT_S)
            check("t" in readmit, f"12l(a): replica 1 never answered again: {readmit}")
            out["kill_to_readmit_s"] = readmit["t"] - t_exit
            # the router admits the reborn replica once it answers healthy; the
            # supervisor's warm replay may still be running then
            fl_wait(lambda: ("restart", 1) in [(e["kind"], e["replica"]) for e in sup.events()],
                    FL_BOOT_S, "replica 1's respawn to finish its warm replay")
            r1 = [e for e in sup.events() if e["replica"] == 1]
            check([e["kind"] for e in r1].count("restart") == 1
                  and [e["rows"] for e in r1 if e["kind"] == "warm"] == [len(warm)],
                  f"12l(a): replica 1's events {r1}")
            rows1 = fl_get(sup.url(1), "/stats")["serve/ingested_rows"]
            check(rows1 == len(warm), f"12l(a): reborn replica ingested {rows1} rows")
            st = router.stats()
            check(st["fleet_serve/failed"] == 0 and st["fleet_serve/retries"] > 0
                  and st["fleet_serve/breaker_trips"] > 0,
                  f"12l(a): router failed {st['fleet_serve/failed']}, retries "
                  f"{st['fleet_serve/retries']}, trips {st['fleet_serve/breaker_trips']}")
            out["a"] = {k.split("/", 1)[1]: st[k] for k in (
                "fleet_serve/requests", "fleet_serve/retries", "fleet_serve/breaker_trips",
                "fleet_serve/failed", "fleet_serve/p50_ms", "fleet_serve/p99_ms")}
            lap(f"(a) replica 1 back {out['kill_to_readmit_s']:.1f} s after its exit")

            # latency: the router's against a replica's own, sequential full buckets
            lat = {}
            for name, base in (("replica", sup.url(0)), ("router", url)):
                ms = []
                for _ in range(FL_LAT_N):
                    ms.append(fl_timed_post(base, "/embed", full)[1])
                lat[name] = fl_percentiles(ms)
            out["latency"] = lat
            print(f"12l: /embed of 32 images, router {lat['router']} vs replica 0 direct "
                  f"{lat['replica']}", flush=True)

            # (b) drain and undrain replica 0 under traffic; fanout ingest
            stop, b_failures, lock = threading.Event(), [], threading.Lock()

            def traffic():
                imgs = rng.integers(0, 256, (1, img, img, 3), np.uint8)
                while not stop.is_set():
                    try:
                        fl_post(url, "/embed", imgs)
                    except Exception as e:  # a dropped request is what is counted
                        with lock:
                            b_failures.append(repr(e))
                    time.sleep(0.02)

            feeders = [threading.Thread(target=traffic) for _ in range(2)]
            for t in feeders:
                t.start()
            try:
                t0 = time.monotonic()
                req = urllib.request.Request(url + "/admin/drain?replica=0", data=b"")
                with urllib.request.urlopen(req, timeout=30) as r:
                    check(r.status == 202 and json.loads(r.read())["accepted"], "12l(b): drain")

                def back():
                    snap = fl_get(url, "/admin/replicas")["replicas"][0]
                    return snap["healthy"] and not snap["draining"] and snap["drain_phase"] is None

                time.sleep(0.2)
                fl_wait(back, FL_BOOT_S, "replica 0 back from its drain")
                out["drain_cycle_s"] = time.monotonic() - t0
                req = urllib.request.Request(url + "/admin/undrain?replica=0", data=b"")
                with urllib.request.urlopen(req, timeout=30) as r:
                    check(r.status == 200, "12l(b): undrain")
                time.sleep(0.3)
            finally:
                stop.set()
                for t in feeders:
                    t.join(timeout=60)
            check(b_failures == [], f"12l(b): {len(b_failures)} dropped: {b_failures[:3]}")
            lap(f"(b) drain cycle {out['drain_cycle_s']:.1f} s, nothing dropped")
            before = [fl_get(sup.url(i), "/stats")["serve/ingested_rows"] for i in (0, 1)]
            rc = serve_ingest.main(["--ckpt-dir", fanout_dir, "--server", url, "--fanout",
                                    "--once", "--block", str(INGEST_BLOCK)])
            after = [fl_get(sup.url(i), "/stats")["serve/ingested_rows"] for i in (0, 1)]
            fan_rows = serve_ingest.read_queue(fanout_dir)[0].shape[0]
            check(rc == 0 and [a - b for a, b in zip(after, before)] == [fan_rows] * 2,
                  f"12l(b): fanout rc {rc}, rows {before} -> {after}")
            out["fanout_rows"] = [a - b for a, b in zip(after, before)]
            lap(f"(b) fanout landed {fan_rows} rows on both replicas")

            # (c) the compatible candidate rolls out through /admin/promote; (d)
            # meanwhile in this process, on a thread
            d_thread = FlThread(lambda: fl_kernel_part(ivf_scan, local, device))
            skews, watching = [], threading.Event()

            def watch():
                while not watching.is_set():
                    skews.append(router.stats()["fleet_serve/model_skew"])
                    time.sleep(0.05)

            watcher = threading.Thread(target=watch)
            watcher.start()
            t0 = time.monotonic()
            try:
                rolled = serve_promote.rollout(url, cand_dir, v2_dir, target_digest=cand_digest,
                                               soak_s=0.2, swap_timeout_s=FL_BOOT_S, poll_s=0.1)
            finally:
                watching.set()
                watcher.join(timeout=10)
            out["rollout_s"] = time.monotonic() - t0
            PromotionLedger(ledger_path).append(ledger_record(
                cand_step, rolled["verdict"], "rollout", digest=cand_digest,
                failed_gate=rolled["reason"], replica=rolled["replica"]))
            with open(ledger_path) as f:
                ledger = [json.loads(line) for line in f if line.strip()]
            check(validate_lines([json.dumps(r) for r in ledger]) == [], "12l(c): ledger schema")
            check([r["promotion/verdict"] for r in ledger] == ["rejected", "accepted", "promoted"],
                  f"12l(c): the rollout {rolled}, ledger {ledger[1:]}")
            fl_wait(lambda: router.stats()["fleet_serve/model_skew"] == 0, 30, "skew back to 0")
            snaps = fl_get(url, "/admin/replicas")["replicas"]
            out["skew_max"] = max(s for s in skews if s is not None)
            check(out["skew_max"] >= 1, f"12l(c): model_skew never reached 1: {sorted(set(skews))}")
            check([(s["model_step"], s["model_digest"]) for s in snaps]
                  == [(cand_step, cand_digest)] * 2, f"12l(c): replicas after the rollout {snaps}")
            models = [fl_get(sup.url(i), "/admin/model") for i in (0, 1)]
            check([(m["model_step"], m["model_digest"]) for m in models]
                  == [(cand_step, cand_digest)] * 2, f"12l(c): the replicas' own /admin/model {models}")
            lap(f"(c) rolled out in {out['rollout_s']:.1f} s, skew {out['skew_max']} -> 0")
            out["d"], d_launches = d_thread.result()
            lap(f"(d) ivf_fused through the router: {d_launches} cell-scan launches")
            line = {"step": 1, "time": time.time(), **fl_get(url, "/stats")}
            check(validate_line(line) == [], f"12l: the router's line {validate_line(line)}")
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
            if router is not None:
                router.close()
            sup.close()
        events = sup.events()
        from moco_tpu_torch.utils.contracts import KILL_EXIT_CODE

        check([e["replica"] for e in events
               if e["kind"] == "exit" and e.get("rc") == KILL_EXIT_CODE] == [1],
              f"12l: exits with {KILL_EXIT_CODE} {events}")
        out["events"] = [{k: e[k] for k in ("kind", "replica", "rc", "reason", "rows") if k in e}
                         for e in events]
        out["coverage"] = fl_coverage_check(os.path.join(workdir, "fleet"), recorder)
    finally:
        contract_cov.uninstall_recorder()
    out["phase_s"] = time.perf_counter() - phase_t0
    return out, d_launches


def fl_coverage_check(fleet_dir: str, recorder) -> dict:
    """12m(c), as the reference fleet smoke gates it: each replica's
    metrics.jsonl validated under `recorder` (this process's, installed
    around 12l), its snapshot merged with the replicas' dumps
    (contract_coverage.json, one per slot, added up over its respawns),
    then check_coverage over every declared replica and router route, the
    trace headers, kill@replica, delay@ingest and the stage hooks, and the
    four gated validator tuples."""
    from moco_tpu_torch.analysis import contracts as contract_cov
    from moco_tpu_torch.obs.schema import validate_file
    from moco_tpu_torch.utils import contracts as decl

    snaps = []
    for i in (0, 1):
        errors = validate_file(os.path.join(fleet_dir, f"replica{i}", "metrics.jsonl"))
        check(errors == [], f"12m(c): replica {i}'s metrics.jsonl {errors[:3]}")
        path = os.path.join(fleet_dir, f"replica{i}", "contract_coverage.json")
        check(os.path.exists(path), f"12m(c): replica {i} left no {path}")
        with open(path) as f:
            snaps.append(json.load(f))
    merged = contract_cov.merge_coverage([recorder.snapshot(), *snaps])
    routes = list(dict.fromkeys(contract_cov.declared_route_gates("replica")
                                + contract_cov.declared_route_gates("router")))
    faults = ["kill@replica", "delay@ingest", *(f"slow@{s}" for s in decl.SERVE_STAGE_SITES)]
    validators = (decl.SERVE_GATED_VALIDATORS + decl.FLEET_GATED_VALIDATORS
                  + decl.QUALITY_GATED_VALIDATORS + decl.PROMOTION_GATED_VALIDATORS)
    missing = contract_cov.check_coverage(merged, routes=routes, fault_sites=faults,
                                          validators=validators, headers=decl.TRACE_HEADERS)
    print(f"12m(c): merged coverage {json.dumps(merged)}; missing {missing}", flush=True)
    check(missing == [], f"12m(c): contracts never exercised: {missing}")
    return {**merged, "gated": {"routes": len(routes), "fault_hooks": len(faults),
                                "validators": len(validators),
                                "headers": len(decl.TRACE_HEADERS)}}


def _fl_start(sup, errors):
    try:
        sup.start()
        errors.append(None)
    except Exception as e:  # reported by the caller's check
        errors.append(repr(e))


def fl_kernel_part(ivf_scan, engine, device):
    """12l(d): the router in front of two in-process ServeServers, each over
    phase 4's index (its seeded rows, IVF nlist NLIST / nprobe NPROBE,
    ivf_fused): FL_NEIGHBORS requests of 32 images through the router's
    /neighbors?mode=ivf_fused, the cell-scan launches counted around them,
    each answer equal to a direct index.query of its own embeddings.
    Returns (its numbers, the launches)."""
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.serve.router import FleetRouter
    from moco_tpu_torch.serve.server import ServeServer

    rows = unit_rows(np.random.default_rng(SEED), K, DIM)  # phase 4's rows
    servers, indices, router = [], [], None
    try:
        for i in range(2):
            index = EmbeddingIndex(K, DIM, device=device)
            index.snapshot(rows)
            index.train_ivf(nlist=NLIST, nprobe=NPROBE)
            index.prepare(engine.buckets, TOPK, modes=("exact", "ivf_fused"))
            index.freeze()
            indices.append(index)
            servers.append(ServeServer(engine, index=index, port=0, slo_ms=1000,
                                       neighbors_k=TOPK, neighbors_mode="ivf_fused",
                                       warmup=False, replica_index=i))
        router = FleetRouter(replica_urls=[f"http://127.0.0.1:{s.port}" for s in servers],
                             health_interval_s=0.2, hedge=False)
        url = f"http://127.0.0.1:{router.port}"
        rng = np.random.default_rng(SEED + 140)
        img = engine.image_size
        replies = []
        before = ivf_scan.fused_cell_scores.launches
        for _ in range(FL_NEIGHBORS):
            imgs = rng.integers(0, 256, (32, img, img, 3), np.uint8)
            replies.append(fl_post(url, "/neighbors?mode=ivf_fused", imgs))
        launches = ivf_scan.fused_cell_scores.launches - before
        served = {r["replica"] for r in replies}
    finally:
        if router is not None:
            router.close()
        for s in servers:
            s.close()
    check(launches > 0, "12l(d): the router's ivf_fused requests launched no cell scan")
    check(served == {0, 1}, f"12l(d): replicas served {served}")
    worst = 0.0
    for body in replies:
        check(body["mode"] == "ivf_fused", f"12l(d): mode {body['mode']}")
        emb = np.asarray(body["embedding"], np.float32)
        scores, ids = indices[body["replica"]].query(emb, TOPK, mode="ivf_fused")
        check(np.array_equal(ids, np.asarray(body["indices"])),
              "12l(d): ids differ from a direct index.query")
        err = float(np.abs(scores - np.asarray(body["scores"], np.float32)).max())
        check(err <= SCORE_TOL, f"12l(d): scores {err} off a direct index.query")
        worst = max(worst, err)
    return {"requests": len(replies), "launches": launches, "max_score_err": worst}, launches

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t_main, t_lap = time.perf_counter(), [time.perf_counter()]

    def lap(name: str) -> None:
        """The phase's seconds and the script's so far, on the host clock."""
        now = time.perf_counter()
        print(f"phase {name}: {now - t_lap[0]:.1f} s (script {now - t_main:.1f} s)", flush=True)
        t_lap[0] = now

    from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
    from moco_tpu_torch.core.moco import build_encoder
    from moco_tpu_torch.ops import build, fused_infonce, ivf_scan
    from moco_tpu_torch.ops import flash_attention as fa
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.utils.config import PRESETS

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} kernel(s) in {time.perf_counter() - t0:.2f} s", flush=True)
    # torch._dynamo, which the first optimizer imports (some seconds of host
    # time), loads while cuobjdump reads the libraries
    preload = threading.Thread(target=importlib.import_module, args=("torch._dynamo",))
    preload.start()
    print_ptxas(logs)
    tensor_core_check(build)
    preload.join()
    lap("build")

    # -- kernel vs plain ----------------------------------------------------
    max_err = kernel_phase(ivf_scan)
    infonce_err = infonce_kernel_phase(fused_infonce)
    flash_err = flash_kernel_phase(fa)
    lap("kernels")

    # -- path at full width -------------------------------------------------
    cfg = PRESETS["imagenet_v2"]
    check(cfg.data.image_size == IMG and cfg.moco.arch == "resnet50" and cfg.moco.mlp, "preset")
    params, stats = random_flax_encoder(cfg.moco, seed=SEED)
    model = build_encoder(cfg.moco)
    model.load_state_dict(encoder_from_flax(params, stats))
    rng = np.random.default_rng(SEED)
    rows = unit_rows(rng, K, DIM)
    imgs = rng.integers(0, 256, (128, IMG, IMG, 3), np.uint8)

    ivf_scan.fused_cell_scores.launches = 0  # counts from here on are the path's
    t0 = time.perf_counter()
    engine = InferenceEngine(model, IMG, device="cuda")  # bf16, channels_last
    engine.warmup()
    index = EmbeddingIndex(K, DIM, device="cuda")
    index.snapshot(rows)
    ivf = index.train_ivf(nlist=NLIST, nprobe=NPROBE)
    check(ivf["cell_cap"] == 2 * K // NLIST and ivf["nprobe"] == NPROBE, f"ivf layout {ivf}")
    index.prepare(engine.buckets, TOPK, modes=F32_MODES)
    index.freeze()
    server = ServeServer(engine, index=index, port=0, slo_ms=1000, neighbors_k=TOPK,
                         neighbors_mode="ivf_fused", warmup=False)
    setup_s = time.perf_counter() - t0
    try:
        embedded = {}
        for n in (1, 5, 32, 100):
            out = np.asarray(post(server.port, "/embed", imgs[:n])["embedding"], np.float32)
            check(out.shape == (n, DIM), f"/embed n={n} shape {out.shape}")
            embedded[n] = out
        neighbors = {}
        for mode in ("exact", "ivf"):
            neighbors[mode] = post(server.port, f"/neighbors?mode={mode}", imgs[:32])
        before = ivf_scan.fused_cell_scores.launches
        neighbors["ivf_fused"] = post(server.port, "/neighbors", imgs[:100])
        fused_launches = ivf_scan.fused_cell_scores.launches - before
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
            stats_http = json.loads(r.read())
    finally:
        server.close()
    launches = {"ivf_cell_scores": ivf_scan.fused_cell_scores.launches}
    print(f"path: setup {setup_s:.1f} s; launches {launches}; "
          f"during the ivf_fused requests {fused_launches}", flush=True)

    # -- checks -------------------------------------------------------------
    for n, out in embedded.items():
        check(np.isfinite(out).all(), f"/embed n={n} non-finite")
        check(np.abs(np.linalg.norm(out, axis=1) - 1).max() < 1e-3, f"/embed n={n} not unit-norm")
    agree = float((embedded[5] * embedded[100][:5]).sum(1).min())
    check(agree >= 0.99, f"/embed rows of buckets 8 and 128 disagree: cosine {agree}")
    for mode, out in neighbors.items():
        check(out["mode"] == mode and np.asarray(out["indices"]).shape[1] == TOPK, f"{mode} reply")
    check(engine.recompiles_after_warmup == 0, "engine recompiled after warmup")
    check(index.recompiles_after_warmup == 0, "index recompiled after warmup")
    check(stats_http["serve/recompiles_after_warmup"] == 0, "/stats recompiles")
    check(fused_launches > 0, "the ivf_fused requests did not launch the cell-scan kernel")
    check(launches["ivf_cell_scores"] > 0, "the path did not launch ivf_cell_scores")

    feats_t = engine.forward(torch.from_numpy(imgs).cuda())  # (128, 128) f32 on the card
    feats = feats_t.cpu().numpy()
    _, per_mode, _ = engine.embed_and_query_modes(imgs, index, TOPK, modes=F32_MODES)
    swaps_fused = same_topk(feats, rows, per_mode["ivf_fused"], per_mode["ivf"], "ivf_fused vs ivf")
    sims = feats.astype(np.float64) @ rows.T.astype(np.float64)
    oi = np.argsort(-sims, axis=1)[:, :TOPK]
    oracle = (np.take_along_axis(sims, oi, 1), oi)
    swaps_exact = same_topk(feats, rows, per_mode["exact"], oracle, "exact vs host oracle")
    recall = float(np.mean([len(set(a) & set(b)) / TOPK
                            for a, b in zip(per_mode["ivf"][1], per_mode["exact"][1])]))
    f32_engine = InferenceEngine(model, IMG, device="cuda", dtype=torch.float32)
    f32_feats, _ = f32_engine.embed(imgs)
    cosine = float((f32_feats * feats).sum(1).min())
    print(f"checks: ivf_fused/ivf tie swaps {swaps_fused}, exact/oracle tie swaps {swaps_exact}, "
          f"ivf recall@{TOPK} vs exact {recall:.3f}, bf16 vs f32 min cosine {cosine:.5f}")
    check(cosine >= 0.99, f"bf16 engine vs f32 engine cosine {cosine} < 0.99")

    # -- timing ---------------------------------------------------------------
    engine_ms = {b: host_ms(lambda b=b: engine.embed(imgs[:b])) for b in engine.buckets}
    query_ms = {
        mode: {b: host_ms(lambda b=b, mode=mode: index.query(feats_t[:b], TOPK, mode=mode))
               for b in engine.buckets}
        for mode in F32_MODES
    }
    print(json.dumps({"engine_ms": engine_ms, "query_ms": query_ms, "device": smi}))
    lap("serving path")
    # kept for the kernel's own timing at the end: the cell-major copy of the
    # index and the path's queries and probes
    cell_rows = index._ivf_device_cell_rows()
    probes = torch.topk(feats_t @ index._ivf["centroids"].T, NPROBE).indices.int()
    buckets = engine.buckets
    del server, engine, f32_engine, index, model
    torch.cuda.empty_cache()

    # -- training path at full width ---------------------------------------
    train_kernels, train_timing = train_phase(fused_infonce)
    for rec, worst in zip(train_kernels, (infonce_err["fwd"], infonce_err["bwd"])):
        rec["max_abs_err"] = max(rec["max_abs_err"], worst)
    print(json.dumps({"train": train_timing, "device": smi}))
    lap("8 train")
    torch.cuda.empty_cache()

    # -- v3 path at full width -----------------------------------------------
    v3_kernels, v3_timing = v3_phase(fa, flash_err)
    print(json.dumps({"v3": v3_timing, "device": smi}))
    lap("11 v3")

    # -- the closed loop: checkpoints, resume, guard, kNN, probe ----------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        loop = closed_loop_phase(fused_infonce, workdir)
    finally:
        shutil.rmtree(workdir)
    print(json.dumps({"loop": loop, "device": smi}))
    lap("12b loop")
    torch.cuda.empty_cache()

    # -- fault tolerance and health: preemption, watchdog, async saves, alerts --
    workdir = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        faults_out = fault_health_phase(fused_infonce, workdir)
    finally:
        shutil.rmtree(workdir)
    print(json.dumps({"faults": faults_out, "device": smi}))
    lap("12c faults")
    torch.cuda.empty_cache()

    # -- the options of the v2 step: virtual Shuffle-BN, LARS, remat, EMAN ------
    print(json.dumps({"step_options": step_options_phase(fused_infonce), "device": smi}))
    lap("12d step options")
    torch.cuda.empty_cache()

    # -- train to serve: a v2 and a v3 checkpoint served, the ViT probed, exported --
    # its v2 checkpoint stays for phase 12g
    serve_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        serve_out, serve_launches = train_to_serve_phase(ivf_scan, fa, serve_dir)
    except BaseException:
        shutil.rmtree(serve_dir)
        raise
    print(json.dumps({"train_to_serve": serve_out, "device": smi}))
    lap("12e train to serve")
    torch.cuda.empty_cache()

    # -- observability: the run's telemetry, the window, the request waterfall --
    workdir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        obs_out, obs_launches = observability_phase(fused_infonce, ivf_scan, workdir)
    except BaseException:
        shutil.rmtree(serve_dir)
        raise
    finally:
        shutil.rmtree(workdir)
    print(json.dumps({"observability": obs_out, "device": smi}))
    lap("12f observability")
    torch.cuda.empty_cache()

    # -- serving, the rest: int8 tiers, quantized engines, ingest, freshness ----
    # its newer checkpoint (workdir/train) stays for phase 12l
    workdir = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    try:
        rest_out, rest_launches = serving_rest_phase(
            fused_infonce, ivf_scan, feats_t, os.path.join(serve_dir, "v2"), workdir)
        print(json.dumps({"serving_rest": rest_out, "device": smi}))
        lap("12g serving, the rest")
        torch.cuda.empty_cache()

        # -- the serving fleet: router, supervisor, kill@replica, promotion ------
        fleet_out, fleet_launches = fleet_phase(
            ivf_scan, os.path.join(serve_dir, "v2"), os.path.join(workdir, "train"),
            os.path.join(workdir, "fleet"))
    finally:
        shutil.rmtree(workdir)
        shutil.rmtree(serve_dir)
    print(json.dumps({"fleet": fleet_out, "device": smi}))
    lap("12l serving fleet")
    torch.cuda.empty_cache()

    # -- data parallelism: an NCCL world of one, two ranks on the card --------
    # 12i's, 12j's and 12k's ranks spawn while the phase before theirs runs,
    # and wait behind their gates (`gated_child`)
    early = {}
    try:
        early["zero"] = zero_spawn(gated=True)
        dp_out, dp_launches = dp_phase(fused_infonce)
        print(json.dumps({"data_parallel": dp_out, "device": smi}))
        lap("12h data parallel")

        # -- ZeRO: the sharded update at each layout, two ranks on the card ---
        # 12c(b)'s watchdog process runs beside 12i's ranks (neither is timed)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_watchdog_")
        try:
            watchdog = watchdog_start(workdir)
            early["ma"] = ma_spawn(gated=True)
            try:
                zero_out, zero_launches = zero_phase(fused_infonce, [
                    {"v2": rank["gather_perm"]["peak_gb"], "v3": rank["v3"]["peak_gb"]}
                    for rank in dp_out["b"]["ranks"]], spawned=early["zero"])
            except BaseException:
                watchdog["proc"].kill()
                watchdog["proc"].wait()
                raise
            watchdog_out = watchdog_finish(watchdog)
        finally:
            shutil.rmtree(workdir)
        faults_out.update(watchdog_out)
        print(json.dumps({"zero": zero_out, "watchdog": watchdog_out, "device": smi}))
        lap("12i zero, 12c(b) watchdog")

        # -- the model axis: the sharded queue, ring attention, the SP preset -
        t0 = time.perf_counter()
        ma_out, ma_launches, ma_shapes = model_axis_phase(
            fused_infonce, fa, spawned=early["ma"],
            after_ring=lambda: early.setdefault("zk", zk_spawn(gated=True)))
        ma_out["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"model_axis": ma_out, "device": smi}))
        lap("12j model axis")

        # -- the rest of distributed training: ZeRO on a 2 x 2 world, elastic ----
        t0 = time.perf_counter()
        zk_out, zk_launches = zk_phase(fused_infonce, spawned=early["zk"])
        zk_out["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"zero_model_elastic": zk_out, "device": smi}))
        lap("12k zero on the model axis, elastic")
    finally:
        for sp in early.values():  # a phase that failed before another opened its gate
            end_ranks(sp["procs"])
            shutil.rmtree(sp["tmp"], ignore_errors=True)

    obs_infonce = {k: obs_launches["a"][k] + obs_launches["b"][k]
                   for k in ("infonce_fwd", "infonce_bwd")}
    for rec in train_kernels:
        rec["launches"] += obs_infonce[rec["name"]] + rest_launches["infonce"][rec["name"]]
        rec["launches_12f"] = obs_infonce[rec["name"]]
        rec["launches_12g"] = rest_launches["infonce"][rec["name"]]

    # -- the cell-scan kernel's own times --------------------------------------
    ivf_kernel = ivf_timing_phase(ivf_scan, feats_t, cell_rows, probes, buckets,
                                  launches["ivf_cell_scores"] + serve_launches["ivf_cell_scores"]
                                  + obs_launches["c"]["ivf_cell_scores"]
                                  + rest_launches["ivf_cell_scores"]
                                  + rest_launches["ivf_cell_scores_12m"] + fleet_launches, max_err)
    ivf_kernel["launches_12e"] = serve_launches["ivf_cell_scores"]
    ivf_kernel["launches_12f"] = obs_launches["c"]["ivf_cell_scores"]
    ivf_kernel["launches_12g"] = rest_launches["ivf_cell_scores"]
    ivf_kernel["launches_12m"] = rest_launches["ivf_cell_scores_12m"]
    ivf_kernel["launches_12l"] = fleet_launches
    for rec in v3_kernels:
        if rec["name"] == "flash_fwd":
            rec["launches"] += serve_launches["flash_fwd"]
            rec["launches_12e"] = serve_launches["flash_fwd"]
    for rec in [*train_kernels, *v3_kernels]:  # 12h: per process (the world of one, each rank)
        per = [dp_launches["nccl_1"].get(rec["name"], 0)] + [
            r[rec["name"]] for r in dp_launches["ranks"]]
        rec["launches"] += sum(per)
        rec["launches_12h"] = {"nccl_1": per[0], **{f"rank{i}": n for i, n in enumerate(per[1:])}}
        per = [r[rec["name"]] for r in zero_launches]  # 12i: per rank
        rec["launches"] += sum(per)
        rec["launches_12i"] = {f"rank{i}": n for i, n in enumerate(per)}
        per = [r[rec["name"]] for r in ma_launches]  # 12j: per rank
        rec["launches"] += sum(per)
        rec["launches_12j"] = {f"rank{i}": n for i, n in enumerate(per)}
        rec["at_12j_shapes"] = ma_shapes[rec["name"]]
        if "max_abs_err" in ma_shapes[rec["name"]][0]:
            rec["max_abs_err"] = max(rec["max_abs_err"], ma_shapes[rec["name"]][0]["max_abs_err"])
        per = [r.get(rec["name"], 0) for r in zk_launches]  # 12k: per process
        rec["launches"] += sum(per)
        rec["launches_12k"] = {**{f"rank{i}": n for i, n in enumerate(per[:ZK_RANKS])},
                               **{f"relaunch{i}": n for i, n in enumerate(per[ZK_RANKS:])}}
    for rec, key in zip(train_kernels, ("pos", "dq")):  # 12k's rank shapes
        rec["max_abs_err"] = max(rec["max_abs_err"], zk_out["infonce_at_rank_shapes"][key])
    kernels = [ivf_kernel, *train_kernels, *v3_kernels]
    lap("13 ivf timing")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
