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

The last line of stdout is {"ok": true, "device": {...}}; the lines before
it carry the kernel table and the timings as JSON.
"""

from __future__ import annotations

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
    from moco_tpu_torch.ops import build, ivf_scan
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
