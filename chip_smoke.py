#!/usr/bin/env python3
"""Drive the PyTorch port (moco_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a miss:

1. Device: no CUDA device -> exit 2 before anything else. Prints
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. Build: every kernel under moco_tpu_torch/csrc/ is compiled by nvcc for
   sm_90a, one process per source, all started together.
3. Kernel: each kernel's wrapper against its plain PyTorch version on the
   card at the serving path's shapes (IVF cell scan: m in {1, 8, 32, 128},
   d=128, nlist=256, cell_cap=512, nprobe=16), max |diff| <= 1e-5 (f32 FMA
   order over d=128 on unit vectors).
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
6. Timing: each kernel, its plain version, its bound and one library call
   on the path's own inputs; engine ms per bucket; query ms per tier.
7. InfoNCE kernels: `infonce_fwd` and `infonce_bwd` (csrc/infonce.cu)
   against their plain versions at (B, K, C) in {(8, 4096, 128),
   (256, 65536, 128), (7, 1000, 20)}, with the width limit raising beyond
   C=256. Tolerances: pos <= 1e-5, lse <= 1e-4, dq max |diff| <=
   1e-4 * max |dq| + 1e-6, and n_above of kernel and plain version, on
   every row, between the float64 count of negatives above pos by more
   than 1e-5 and that count plus the near ties within 1e-5 (counted).
8. Training path, at full width: the imagenet_v2 preset (ResNet-50 + MLP
   head, K=65536, T=0.2, batch 256, 224 px, bf16 autocast) from seeded
   Flax-layout weights and a seeded unit-row queue carried in through
   convert.state_from_flax; a SyntheticDataset through the port's
   TwoCropPipeline on the card; train(..., device="cuda") for 3 warm-up
   and 10 timed steps, the InfoNCE launch counts set to 0 just before and
   read just after. Checks: finite losses; queue_ptr == steps * 256 mod K;
   the last 256 written rows are the last step's unit-norm keys; after the
   first step a params_k leaf is m * k0 + (1 - m) * q0; each InfoNCE
   kernel launched once per step; and on the last step's own (q, k,
   queue), captured as the step computed them, the loss and dq through
   the kernels agree with the plain versions within the tolerances of
   phase 7, and acc1/acc5 within the percent of rows whose count window
   straddles the accuracy's cut.
9. Timing: step ms and imgs/s; each InfoNCE kernel, its plain version, its
   bound and one composed PyTorch computation on the path's own inputs;
   a torch.profiler breakdown of one step's device time.

The last line of stdout is {"ok": true, "device": {...}}; the lines before
it carry the kernel table and the timings as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
SEED = 0
K, DIM, NLIST, NPROBE, TOPK = 65536, 128, 256, 16, 5
IMG = 224
SCORE_TOL = 1e-5
POS_TOL, LSE_TOL, TIE_TOL = 1e-5, 1e-4, 1e-5
TRAIN_WARMUP, TRAIN_TIMED = 3, 10


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
    queries, probe ids and scores once; 2 flops per multiply-add."""
    bytes_ = (distinct_cells * cell_cap * d + m * d + m * nprobe + m * nprobe * cell_cap) * 4
    flops = 2 * m * nprobe * cell_cap * d
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), bytes_


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


def kernel_phase(ivf_scan):
    """The cell-scan kernel against its plain version at the path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = torch.randn((NLIST, 2 * K // NLIST, DIM), generator=gen, device="cuda")
    cell_rows = rows / rows.norm(dim=-1, keepdim=True)
    worst = 0.0
    for m in (1, 8, 32, 128):
        q = torch.randn((m, DIM), generator=gen, device="cuda")
        q = q / q.norm(dim=-1, keepdim=True)
        probes = torch.randint(0, NLIST, (m, NPROBE), generator=gen, device="cuda",
                               dtype=torch.int32)
        got = ivf_scan.fused_cell_scores(q, cell_rows, probes)
        torch.cuda.synchronize()
        err = (got - ivf_scan.fused_cell_scores_reference(q, cell_rows, probes)).abs().max().item()
        print(f"kernel ivf_cell_scores m={m}: max_abs_err={err:.3g}", flush=True)
        check(err <= 1e-5, f"ivf_cell_scores m={m} max |kernel - plain| = {err}")
        worst = max(worst, err)
    return worst


def time_cell_scan(ivf_scan, q, cell_rows, probes):
    m, nprobe = probes.shape
    _, cell_cap, d = cell_rows.shape
    gathered = cell_rows[probes.long()].reshape(m, nprobe * cell_cap, d)
    distinct = int(torch.unique(probes).numel())
    bound, bound_by, bytes_ = cell_scan_bound_ms(m, nprobe, cell_cap, d, distinct)
    return {
        "ms": cuda_ms(lambda: ivf_scan.fused_cell_scores(q, cell_rows, probes)),
        "plain_ms": cuda_ms(lambda: ivf_scan.fused_cell_scores_reference(q, cell_rows, probes)),
        "library_ms": cuda_ms(lambda: torch.bmm(gathered, q[:, :, None])),
        "bound_ms": bound,
        "bound_by": bound_by,
        "distinct_cells": distinct,
        "bound_bytes": bytes_,
        "requested_bytes": m * nprobe * cell_cap * d * 4,
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
    """Both InfoNCE kernels against their plain versions, a small shape,
    the path's shape and an odd one; and the width limit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for b, kk, c in ((8, 4096, DIM), (256, K, DIM), (7, 1000, 20)):
        q, k, queue = (torch.nn.functional.normalize(
            torch.randn(shape, generator=gen, device="cuda"), dim=-1)
            for shape in ((b, c), (b, c), (kk, c)))
        err = compare_infonce(fi, q, k, queue, 0.2, torch.full((b,), 1.0 / b, device="cuda"),
                              f"B={b} K={kk} C={c}")
        worst["fwd"] = max(worst["fwd"], err["pos"], err["lse"])
        worst["bwd"] = max(worst["bwd"], err["dq"])
    wide = torch.zeros(2, fi.MAX_C + 4, device="cuda")
    try:
        fi.infonce_stats(wide, wide, torch.zeros(64, fi.MAX_C + 4, device="cuda"), 0.2)
    except ValueError as e:
        print(f"kernel infonce: C={fi.MAX_C + 4} refused as it must be ({e})", flush=True)
    else:
        raise RuntimeError(f"infonce_stats accepted C={fi.MAX_C + 4} > {fi.MAX_C}")
    return worst


def infonce_bound_ms(b, kk, c, backward):
    """Least time for one InfoNCE call: the bytes it must move (q, k or
    lse and g, the queue once; pos, lse and n_above or dq once) over the
    memory rate, against its f32 multiply-adds (2BKC forward, 4BKC
    backward, which recomputes the scores) over the f32 rate."""
    if backward:
        bytes_, flops = 4 * (2 * b * c + kk * c + 2 * b), 4 * b * kk * c
    else:
        bytes_, flops = 4 * (2 * b * c + kk * c + 3 * b), 2 * b * kk * c
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel names it takes), first match wins
    ("infonce", ("fwd_partial_kernel", "fwd_merge_kernel", "bwd_partial_kernel",
                 "bwd_reduce_kernel")),
    ("batch_norm", ("batch_norm",)),
    ("conv_gemm", ("conv", "gemm", "sm90", "cutlass", "xmma", "cudnn", "wgrad", "dgrad")),
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


def train_phase(fi):
    """The training path at full width (phase 8) and its timings (phase 9)."""
    from moco_tpu_torch.convert import random_flax_encoder, state_from_flax
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.ops.losses import l2_normalize
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS["imagenet_v2"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))
    m, t, b = cfg.moco.momentum, cfg.moco.temperature, cfg.data.global_batch
    check((cfg.moco.arch, cfg.moco.mlp, cfg.moco.num_negatives, cfg.moco.dim, b,
           cfg.data.image_size, cfg.data.aug_plus, cfg.moco.compute_dtype, t)
          == ("resnet50", True, K, DIM, 256, IMG, True, "bfloat16", 0.2), "imagenet_v2 preset")
    params_q, stats_q = random_flax_encoder(cfg.moco, seed=SEED)
    params_k, stats_k = random_flax_encoder(cfg.moco, seed=SEED + 1)
    queue = np.random.default_rng(SEED + 2).standard_normal((K, DIM)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=1, keepdims=True)
    state = state_from_flax(cfg, {
        "step": 0, "params_q": params_q, "batch_stats_q": stats_q, "params_k": params_k,
        "batch_stats_k": stats_k, "queue": queue, "queue_ptr": 0}, device="cuda")
    leaf = "head.fc.2.weight"
    q0 = dict(state.encoder_q.named_parameters())[leaf].detach().clone()
    k0 = dict(state.encoder_k.named_parameters())[leaf].detach().clone()
    ema_err = []
    steps = TRAIN_WARMUP + TRAIN_TIMED
    # the last step's own (q, k, queue): the encoders' outputs as the step
    # computed them (hooks keep the latest), and the queue it read
    seen = {}
    hooks = [enc.register_forward_hook(lambda _m, _i, o, name=name: seen.__setitem__(name, o.detach()))
             for name, enc in (("q", state.encoder_q), ("k", state.encoder_k))]

    def on_step(rec):
        print(f"train step {json.dumps(rec)}", flush=True)
        if rec["step"] == 1:
            k1 = dict(state.encoder_k.named_parameters())[leaf].detach()
            ema_err.append((k1 - (k0 * m + q0 * (1.0 - m))).abs().max().item())
        if rec["step"] == steps - 1:
            seen["queue"] = state.queue.clone()

    dataset = SyntheticDataset(image_size=IMG)  # what build_dataset("synthetic") gives
    torch.cuda.reset_peak_memory_stats()
    fi.infonce_stats.launches = fi.infonce_dq.launches = 0  # counts from here on are the path's
    t0 = time.perf_counter()
    out = train(cfg, dataset=dataset, device="cuda", steps=steps, state=state, log=on_step)
    wall_s = time.perf_counter() - t0
    launches = {"infonce_fwd": fi.infonce_stats.launches, "infonce_bwd": fi.infonce_dq.launches}
    for h in hooks:
        h.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train path: {steps} steps in {wall_s:.1f} s; launches {launches}; "
          f"peak memory {peak_gb:.1f} GB", flush=True)

    # -- checks -------------------------------------------------------------
    hist = out["history"]
    check(len(hist) == steps and all(np.isfinite(r["loss"]) for r in hist), "finite losses")
    check(launches == {"infonce_fwd": steps, "infonce_bwd": steps},
          f"InfoNCE kernels not launched once per step: {launches} over {steps} steps")
    check(state.queue_ptr == (steps * b) % K, f"queue_ptr {state.queue_ptr}")
    check(ema_err and ema_err[0] <= 1e-6, f"params_k after step 1 is not the EMA: {ema_err}")
    q_n, k_n, queue_n = l2_normalize(seen["q"].float()), l2_normalize(seen["k"].float()), seen["queue"]
    check(state.queue_ptr >= b, f"queue_ptr {state.queue_ptr} wrapped inside the run")
    written = state.queue[state.queue_ptr - b:state.queue_ptr]
    key_err = (written - k_n).abs().max().item()
    norm_err = (written.norm(dim=1) - 1).abs().max().item()
    check(key_err <= 1e-6 and norm_err <= 1e-5,
          f"last written queue rows vs the last step's keys: {key_err}, norms {norm_err}")
    # the last step's own inputs, through the kernels and the plain versions
    path_err = compare_infonce(fi, q_n, k_n, queue_n, t, torch.full((b,), 1.0 / b, device="cuda"),
                               "on the path's last step")
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
    print(f"train path kernels vs plain: loss {loss.item():.6f} vs {loss_p.item():.6f}, "
          f"acc {acc_err} (slack {slack}), dq {grad_err:.3g} of {grad_scale:.3g}", flush=True)
    check(abs(loss.item() - loss_p.item()) <= LSE_TOL, "path loss through the kernels")
    check(all(acc_err[n] <= slack[n] + 1e-9 for n in acc_err),
          f"path accuracies off beyond the rows a near tie can flip: {acc_err}, slack {slack}")
    check(grad_err <= 1e-4 * grad_scale + 1e-6, f"path dq through the kernels off by {grad_err}")

    # -- timing -------------------------------------------------------------
    timed = hist[TRAIN_WARMUP:]
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
        kernels.append({
            "name": name, "route": "cuda", "source": "moco_tpu_torch/csrc/infonce.cu",
            "replaces": f"moco_tpu/ops/fused_infonce.py:{src_line}",
            "launches": launches[name],
            "max_abs_err": err["dq"] if backward else max(err["pos"], err["lse"]),
            "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain), "bound_ms": bound,
            "bound_by": bound_by, "library_ms": cuda_ms(lib),
            "library": ("logsumexp(cat([pos, q @ queue.T / T])) + (neg > pos).sum" if not backward
                        else "softmax(cat([pos, q @ queue.T]) / T)[:, 1:] @ queue / T"),
            "shape": {"B": b, "K": K, "C": DIM},
        })
    share = (kernels[0]["ms"] + kernels[1]["ms"]) / step_ms
    timing = {"step_ms_median": step_ms, "data_ms_median": data_ms, "imgs_per_s_median": imgs_s,
              "infonce_share_of_step": share, "peak_memory_gb": peak_gb,
              "steps_timed": len(timed), "batch": b, "profile": profile_step(train, cfg, dataset, state)}
    print(f"train timing: {json.dumps(timing)}", flush=True)
    return kernels, timing


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
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.serve.index import QUERY_MODES, EmbeddingIndex
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.utils.config import PRESETS

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} kernel(s) in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- kernel vs plain ----------------------------------------------------
    max_err = kernel_phase(ivf_scan)
    infonce_err = infonce_kernel_phase(fused_infonce)

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
    cell_rows = index._ivf_device_cell_rows()
    probes = torch.topk(feats_t @ index._ivf["centroids"].T, NPROBE).indices.int()
    path_timing = time_cell_scan(ivf_scan, feats_t, cell_rows, probes)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    uniform = torch.randint(0, NLIST, probes.shape, generator=gen, device="cuda", dtype=torch.int32)
    uniform_timing = time_cell_scan(ivf_scan, feats_t, cell_rows, uniform)
    by_bucket = {}
    for b in engine.buckets:
        bq, bp = feats_t[:b].contiguous(), uniform[:b].contiguous()
        bound, _, _ = cell_scan_bound_ms(b, NPROBE, cell_rows.shape[1], DIM,
                                         int(torch.unique(bp).numel()))
        by_bucket[b] = {"ms": cuda_ms(lambda: ivf_scan.fused_cell_scores(bq, cell_rows, bp)),
                        "bound_ms": bound}
    kernels = [{
        "name": "ivf_cell_scores",
        "route": "cuda",
        "source": "moco_tpu_torch/csrc/ivf_cell_scores.cu",
        "replaces": "moco_tpu/serve/index.py:273",
        "launches": launches["ivf_cell_scores"],
        "max_abs_err": max_err,
        "kernel_ms": path_timing["ms"],
        **path_timing,
        "uniform_probes": {**uniform_timing, "by_bucket": by_bucket},
        "shape": {"m": 128, "d": DIM, "nlist": NLIST, "cell_cap": 2 * K // NLIST,
                  "nprobe": NPROBE},
    }]
    engine_ms = {b: host_ms(lambda b=b: engine.embed(imgs[:b])) for b in engine.buckets}
    query_ms = {
        mode: {b: host_ms(lambda b=b, mode=mode: index.query(feats_t[:b], TOPK, mode=mode))
               for b in engine.buckets}
        for mode in QUERY_MODES
    }
    print(json.dumps({"engine_ms": engine_ms, "query_ms": query_ms, "device": smi}))
    del server, engine, f32_engine, index, model, feats_t, cell_rows
    torch.cuda.empty_cache()

    # -- training path at full width ---------------------------------------
    train_kernels, train_timing = train_phase(fused_infonce)
    for rec, worst in zip(train_kernels, (infonce_err["fwd"], infonce_err["bwd"])):
        rec["max_abs_err"] = max(rec["max_abs_err"], worst)
    kernels += train_kernels
    print(json.dumps({"train": train_timing, "device": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
