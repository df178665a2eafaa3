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
   train(..., device="cuda") for 3 warm-up, 10 timed and 5 untimed steps
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
   phase 8, then train(..., device="cuda") for 3 warm-up and 10 timed steps
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
   through the prefetch ring, the kNN monitor every epoch (a bank of 1024,
   256 held-out queries) and checkpoint_keep=2, the InfoNCE launch counts
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
   batch 256, 2 epochs of 512 images, a val split of 300: a padded, masked
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
   health_metrics on and off (10 timed steps each from the same state);
   nan@step=5 (log_every=1) under the default rules writes one
   nonfinite_loss alert line and one alerts.jsonl entry, and under
   alerts_fatal raises FatalAlertError after an emergency checkpoint of
   step 4 (reason "alert"). (b) The watchdog, last: `python -m
   moco_tpu_torch.train --preset imagenet_v2 --data synthetic --epochs 2
   --steps-per-epoch 3 --watchdog-timeout 15` with
   MOCO_FAULTS=stall@step=4:seconds=120 exits with code 42, leaves
   stall_stacks.txt, one `stall` line and an emergency checkpoint
   (reason "stall") of the last finite log step, step 4, not of the live
   step 5: queue_ptr 1024, and the rows step 5 wrote still the seeded
   initial queue's; the seconds from the stall to the exit are printed.
12d. The options of the v1/v2 step at full width, each part 3 warm-up
   and 10 timed steps through the prefetch ring from a seeded state, the
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
   --buckets 1,8,32` as a subprocess on the card, timed from spawn to a
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
   train_lincls on W3 (2 epochs of 512 learnable 224-px images at batch 256,
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

import contextlib
import copy
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import signal
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
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
# untimed steps after the timed ones in the v2 runs: the ring makes no batch
# past the run's last, so in its last steps the step has the card and the
# host to itself; the tail keeps that out of the timed window
V2_TAIL = 5
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
# the closed loop (phase 12b): epochs of 3 steps, a kNN bank of 1024 and 256
# held-out queries, a probe val split of 300 (a padded tail of 44 in batches
# of 256)
LOOP_EPOCH_STEPS, KNN_BANK, KNN_TEST, PROBE_VAL = 3, 1024, 256, 300
# phase 12d: the virtual groups of the reference's 8 GPUs x 32 rows, and the
# large-batch preset's global batch 8192 cut to what one card holds
OPTION_GROUPS, LARGE_BATCH = 8, 1024
# phase 12e: the steps that write the two checkpoints, and the replica's buckets
SERVE_V2_STEPS, SERVE_V3_STEPS, REPLICA_BUCKETS = 3, 2, "1,8,32"


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
    counts = {}
    for lib in ("flash_attention", "infonce", "ivf_cell_scores"):
        sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
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


def mode_summary(hist):
    """Medians over the timed steps of one mode's run."""
    timed = hist[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
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


def seeded_v2_state(cfg):
    """A v1/v2 train state of `cfg` on the card from seeded Flax-layout
    weights (the key encoder from the next seed) and a seeded unit-row
    queue, through convert.state_from_flax."""
    from moco_tpu_torch.convert import random_flax_encoder, state_from_flax

    params_q, stats_q = random_flax_encoder(cfg.moco, seed=SEED)
    params_k, stats_k = random_flax_encoder(cfg.moco, seed=SEED + 1)
    queue = np.random.default_rng(SEED + 2).standard_normal((K, DIM)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=1, keepdims=True)
    return state_from_flax(cfg, {
        "step": 0, "params_q": params_q, "batch_stats_q": stats_q, "params_k": params_k,
        "batch_stats_k": stats_k, "queue": queue, "queue_ptr": 0}, device="cuda")


def train_phase(fi):
    """The training path at full width (phase 8), in sync and ring mode, and
    its timings (phase 9)."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS["imagenet_v2"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))
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
        with eager_augment(mode == "ring_eager"):
            runs[mode] = v2_run(fi, dataclasses.replace(cfg, device_prefetch=mode != "sync"),
                                dataset, state if mode == "ring" else copy.deepcopy(state), mode)
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
              "host_crop": host_crop, "profile": profile_step(train, cfg, dataset, state)}
    print(f"train timing: {json.dumps(timing)}", flush=True)
    return kernels, timing


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


def seeded_v3_state(cfg):
    """A v3 train state of `cfg` on the card from seeded Flax-layout weights
    (the key encoder and the predictor from the next seeds), through
    convert.state_from_flax."""
    from moco_tpu_torch.convert import random_flax_encoder, random_flax_predictor, state_from_flax

    params_q, stats_q = random_flax_encoder(cfg.moco, seed=SEED)
    params_k, stats_k = random_flax_encoder(cfg.moco, seed=SEED + 1)
    params_p, stats_p = random_flax_predictor(cfg.moco, seed=SEED + 2)
    return state_from_flax(cfg, {
        "step": 0, "params_q": params_q, "batch_stats_q": stats_q, "params_k": params_k,
        "batch_stats_k": stats_k, "params_pred": params_p, "batch_stats_pred": stats_p},
        device="cuda")


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
        data=dataclasses.replace(preset.data, dataset="synthetic", global_batch=V3_BATCH))
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
    """TRAIN_WARMUP + TRAIN_TIMED steps of `cfg` from `state` through the
    ring, the InfoNCE launch counts set to 0 just before and read just
    after: finite losses and each kernel once per step. Returns the
    history, launches, medians of the timed steps and the peak memory."""
    from moco_tpu_torch.train import train

    steps = TRAIN_WARMUP + TRAIN_TIMED
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
    summary = {**mode_summary(hist), "peak_memory_gb": peak_gb, "launches": launches,
               "first_loss": hist[0]["loss"], "steps_per_epoch": out["steps_per_epoch"]}
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
    base = dataclasses.replace(base, data=dataclasses.replace(base.data, dataset="synthetic"))
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
        preset.data, dataset="synthetic", global_batch=LARGE_BATCH))
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
            if calls[0] != TRAIN_WARMUP + TRAIN_TIMED:
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
        workdir=pre, knn_every_epochs=1, checkpoint_keep=2)
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
    probe = ProbeConfig(epochs=2, num_classes=8)
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
    from moco_tpu_torch.core.queue import init_queue
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
    base = dataclasses.replace(preset, data=dataclasses.replace(preset.data, dataset="synthetic"),
                               optim=dataclasses.replace(preset.optim, epochs=2),
                               steps_per_epoch=spe)
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

    # (b) the watchdog: a stalled training process exits with 42 after
    # saving the last finite log step's state
    wd_dir = os.path.join(workdir, "watchdog")
    env = {**os.environ, "MOCO_FAULTS": "stall@step=4:seconds=120"}
    cmd = [sys.executable, "-m", "moco_tpu_torch.train", "--preset", preset_name, "--data",
           "synthetic", "--workdir", wd_dir, "--epochs", "2", "--steps-per-epoch", str(spe),
           "--watchdog-timeout", "15", "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    stalled, tail = {}, []

    def read():
        for line in proc.stdout:
            tail.append(line.rstrip())
            if line.startswith("injected fault: stalling"):
                stalled["t"] = time.perf_counter()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        t_exit = time.perf_counter()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=30)
    check(rc == 42 and "t" in stalled, f"watchdog: exit code {rc}; output {tail[-12:]}")
    out["watchdog_exit_s"] = t_exit - stalled["t"]
    out["watchdog_process_s"] = t_exit - t0
    check("Thread" in open(os.path.join(wd_dir, "stall_stacks.txt")).read(), "watchdog: no stacks")
    stall = [r for r in read_metrics(os.path.join(wd_dir, "metrics.jsonl"))
             if r.get("event") == "stall"]
    check(len(stall) == 1 and stall[0]["watchdog_timeout"] == 15.0, f"watchdog: stall lines {stall}")
    wmgr = CheckpointManager(wd_dir)
    check(wmgr.all_steps() == [spe, 4], f"watchdog: checkpoints {wmgr.all_steps()}")
    payload, extra = wmgr.restore(step=4)
    check((extra["reason"], extra["epoch"], extra["emergency"]) == ("stall", 0, True),
          f"watchdog: extras {extra}")
    # the snapshot of step 4, not the live state of step 5: pointer at 4 batches, and
    # the rows step 5 wrote still hold the seeded initial queue
    queue = payload["state_dict"]["module.queue"].t().to(device)
    init = init_queue(torch.Generator(device=device).manual_seed(base.seed), kk, dim,
                      device=device)
    ptr = int(payload["state_dict"]["module.queue_ptr"][0])
    check(ptr == 4 * b % kk, f"watchdog: queue_ptr {ptr}")
    check(torch.equal(queue[4 * b:5 * b], init[4 * b:5 * b])
          and not torch.equal(queue[3 * b:4 * b], init[3 * b:4 * b]),
          "watchdog: the checkpoint is not the state of step 4")
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"fault tolerance and health in {out['phase_s']:.1f} s: SIGTERM to durable checkpoint "
          f"{out['sigterm_to_durable_ms']:.1f} ms (step {out['sigterm_saved_step']}); save paid by "
          f"the loop, async {out['async_save_paid_ms'][0]:.1f} / {out['async_save_paid_ms'][1]:.1f}"
          f" ms (same state {out['async_save_paid_ms_same_state'][0]:.1f} / "
          f"{out['async_save_paid_ms_same_state'][1]:.1f}) against blocking "
          f"{out['blocking_save_ms']:.1f} ms; gauges {out['gauge_ms']:.3f} ms of device time, "
          f"v2 sync step {out['step_ms_health_on']:.2f} ms on, {out['step_ms_health_off']:.2f} ms "
          f"off, worst relative error {out['gauge_max_rel_err']:.2e}; watchdog exit "
          f"{out['watchdog_exit_s']:.1f} s after the stall ({out['watchdog_process_s']:.1f} s "
          f"process)", flush=True)
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
    from moco_tpu_torch.serve.index import QUERY_MODES, EmbeddingIndex
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
    del run, trained
    torch.cuda.empty_cache()
    rows = queue.numpy()
    model_step = CheckpointManager(v2_dir).latest_step()
    digest = encoder_digest(encoder)
    engine = InferenceEngine(encoder, IMG, device="cuda")  # bf16, buckets 1/8/32/128
    engine.warmup()
    index = EmbeddingIndex.from_train_queue(queue, ptr, device="cuda")
    out["ivf"] = index.train_ivf(nlist=NLIST, nprobe=NPROBE)
    index.prepare(engine.buckets, TOPK, modes=QUERY_MODES)
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
                     for mode in QUERY_MODES}
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
    _, per_mode, _ = engine.embed_and_query_modes(imgs, index, TOPK, modes=QUERY_MODES)
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
    port = free_port()
    log_path = os.path.join(workdir, "replica.log")
    cmd = [sys.executable, "-m", "moco_tpu_torch.serve.replica_main", "--ckpt-dir", v2_dir,
           "--port", str(port), "--buckets", REPLICA_BUCKETS, "--device", "cuda",
           "--workdir", os.path.join(workdir, "replica")]
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=log, stderr=subprocess.STDOUT, text=True)
        try:
            while True:
                check(proc.poll() is None, "12e: the replica exited before it served")
                check(time.perf_counter() - t0 < 300, "12e: the replica never became healthy")
                try:
                    health = get(port, "/healthz", timeout=2)
                    break
                except OSError:
                    time.sleep(0.1)
            out["replica_spawn_to_healthy_s"] = time.perf_counter() - t0
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
    probe = ProbeConfig(epochs=2, num_classes=8)
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


def post(port, path, imgs):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=imgs.tobytes(),
        headers={"X-Image-Shape": ",".join(map(str, imgs.shape))},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(smi, flush=True)

    from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
    from moco_tpu_torch.core.moco import build_encoder
    from moco_tpu_torch.ops import build, fused_infonce, ivf_scan
    from moco_tpu_torch.ops import flash_attention as fa
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.serve.index import QUERY_MODES, EmbeddingIndex
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.utils.config import PRESETS

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} kernel(s) in {time.perf_counter() - t0:.2f} s", flush=True)
    print_ptxas(logs)
    tensor_core_check(build)

    # -- kernel vs plain ----------------------------------------------------
    max_err = kernel_phase(ivf_scan)
    infonce_err = infonce_kernel_phase(fused_infonce)
    flash_err = flash_kernel_phase(fa)

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
    index.prepare(engine.buckets, TOPK, modes=QUERY_MODES)
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
    _, per_mode, _ = engine.embed_and_query_modes(imgs, index, TOPK, modes=QUERY_MODES)
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
        for mode in QUERY_MODES
    }
    print(json.dumps({"engine_ms": engine_ms, "query_ms": query_ms, "device": smi}))
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
    torch.cuda.empty_cache()

    # -- v3 path at full width -----------------------------------------------
    v3_kernels, v3_timing = v3_phase(fa, flash_err)
    print(json.dumps({"v3": v3_timing, "device": smi}))

    # -- the closed loop: checkpoints, resume, guard, kNN, probe ----------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        loop = closed_loop_phase(fused_infonce, workdir)
    finally:
        shutil.rmtree(workdir)
    print(json.dumps({"loop": loop, "device": smi}))
    torch.cuda.empty_cache()

    # -- fault tolerance and health: preemption, watchdog, async saves, alerts --
    workdir = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        faults_out = fault_health_phase(fused_infonce, workdir)
    finally:
        shutil.rmtree(workdir)
    print(json.dumps({"faults": faults_out, "device": smi}))
    torch.cuda.empty_cache()

    # -- the options of the v2 step: virtual Shuffle-BN, LARS, remat, EMAN ------
    print(json.dumps({"step_options": step_options_phase(fused_infonce), "device": smi}))
    torch.cuda.empty_cache()

    # -- train to serve: a v2 and a v3 checkpoint served, the ViT probed, exported --
    workdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        serve_out, serve_launches = train_to_serve_phase(ivf_scan, fa, workdir)
    finally:
        shutil.rmtree(workdir)
    print(json.dumps({"train_to_serve": serve_out, "device": smi}))
    torch.cuda.empty_cache()

    # -- the cell-scan kernel's own times --------------------------------------
    ivf_kernel = ivf_timing_phase(ivf_scan, feats_t, cell_rows, probes, buckets,
                                  launches["ivf_cell_scores"] + serve_launches["ivf_cell_scores"],
                                  max_err)
    ivf_kernel["launches_12e"] = serve_launches["ivf_cell_scores"]
    for rec in v3_kernels:
        if rec["name"] == "flash_fwd":
            rec["launches"] += serve_launches["flash_fwd"]
            rec["launches_12e"] = serve_launches["flash_fwd"]
    kernels = [ivf_kernel, *train_kernels, *v3_kernels]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
