"""The serving driver: `POST /neighbors` against a `ServeServer` of the
port in this process, on loopback, under an open loop of Poisson arrivals
from client processes that import no torch (`http_client.py`).

Set-up, counted in `setup_s`: the seeded weights loaded into the
configuration's encoder, served by the bf16 `InferenceEngine` at the
cell's buckets; an `EmbeddingIndex` of the cell's rows (clustered unit
rows made from the seed) with its IVF trained; the server, whose batcher
warms every bucket and index shape before it binds its port; then
`warm_s` seconds of the cell's own traffic. The window is the `seconds`
after that: every request due in it is timed from when it was due, and
counts in `failed` (and beyond every percentile) if it never got a 200.

The schedule is the same for every seed but its order: `rate` times
`warm_s + seconds` arrivals whose gaps are the exponential distribution's
quantiles and whose sizes are the mix's exact shares, both shuffled by the
seed; each request takes consecutive images of a seeded pool.

A traced run reads each window request's waterfall from the server's
flight recorder and opens a profiler window of `profile_s` seconds in the
window's middle.

Correctness, once every answer is in and the server is closed: the
reference (`reference/nets.py`, float32, TF32 off) embeds the images of a
seeded sample of the finished requests, the largest among them. Each
served row's score is held to the cosine of the reference's embedding
with that row of the index (`score_gap`), and the rows chosen to the IVF
top-k that the reference works out from the index's cells and the
configured `nprobe` (`select_gap`, `reference/search.py`); the cells
themselves, the program's k-means, are checked apart (`ivf_misplaced`). Rows of the wrong count, out of range, served twice
or with their scores out of order fail the run.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import devtrace, weights
from benchmark.drivers import http_client
from benchmark.reference import nets, search

ROOT = Path(__file__).resolve().parents[2]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# a cell whose centroid scores within this of the probe boundary may or may
# not be probed: the engine's bf16 embedding moves a centroid's score as it
# moves a row's, by the served scores' own error, under 0.002 (PERF.md)
PROBE_MARGIN = 0.01


def index_rows(seed: int, rows: int, dim: int, centres: int, noise: float) -> np.ndarray:
    """Clustered unit rows, the geometry of a trained dictionary."""
    rng = np.random.default_rng((seed, 3))
    c = rng.standard_normal((centres, dim))
    x = c[rng.integers(0, centres, rows)] + noise * rng.standard_normal((rows, dim))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def schedule(seed: int, rate: float, duration: float, mix: dict, pool: int) -> list:
    """[(index, due seconds, first pool image, images)], in due order."""
    n = max(int(round(rate * duration)), 1)
    rng = np.random.default_rng((seed, 1))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    sizes = []
    for size, share in sorted(mix.items(), key=lambda kv: int(kv[0])):
        sizes += [int(size)] * int(round(share * n))
    sizes = (sizes + [int(min(mix, key=int))] * n)[:n]
    rng.shuffle(sizes)
    starts = rng.integers(0, pool, n)
    due = np.cumsum(gaps)  # the first is due one gap after the start
    return [(i, float(due[i]), int(starts[i]), int(sizes[i])) for i in range(n)]


def run_clients(port: int, path: str, seed: int, tr: dict, requests: list, t0: float) -> list:
    """Every request's record, from `tr["clients"]` client processes."""
    procs, plans = [], []
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for c in range(tr["clients"]):
        plan = {"port": port, "path": path, "seed": seed, "image_size": tr["image_size"],
                "pool": tr["pool"], "t0": t0, "requests": requests[c::tr["clients"]]}
        fd, p = tempfile.mkstemp(suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(plan, f)
        plans.append(p)
        procs.append(subprocess.Popen([sys.executable, "-m", "benchmark.drivers.http_client", p],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True))
    records = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=tr["warm_s"] + tr["max_seconds"] + 180)
            if proc.returncode != 0:
                raise RuntimeError(f"a client process exited with {proc.returncode}")
            records += json.loads(out.strip().splitlines()[-1])["records"]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for p in plans:
            os.unlink(p)
    return sorted(records, key=lambda r: r["i"])


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile; a failed request is +inf."""
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def build_encoder(cfg: dict, w: dict, device):
    from moco_tpu_torch.core.moco import build_encoder as program_encoder
    from moco_tpu_torch.utils.config import MocoConfig

    with torch.device(device):
        enc = program_encoder(MocoConfig(**cfg["moco"]), num_filters=cfg.get("num_filters", 64))
    missing, unexpected = enc.load_state_dict(w, strict=False)
    if unexpected or {n for n, _ in enc.named_parameters()} & set(missing):
        raise RuntimeError(f"weights do not fit: missing {missing}, unexpected {unexpected}")
    return enc.eval()


def program_index(tr: dict, rows: np.ndarray, dim: int, device, nprobe: int):
    from moco_tpu_torch.serve.index import EmbeddingIndex

    index = EmbeddingIndex(tr["index_rows"], dim, device=device)
    index.snapshot(rows)
    index.train_ivf(nlist=tr["nlist"], nprobe=nprobe)
    return index


def ivf_state(index) -> dict:
    """The index's coarse quantizer, copied out for the check."""
    ivf = index._ivf
    return {"centroids": ivf["centroids"].detach().cpu().clone(),
            "cells": torch.as_tensor(np.asarray(ivf["cells"]), dtype=torch.long),
            "count": int(index.count)}


def serve_setup(cell, seed: int, device, nprobe=None):
    """The server of the cell; `nprobe` other than the cell's plants a fault."""
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.serve.server import ServeServer

    cfg, tr = cell.config, cell.traffic
    nprobe = nprobe or tr["nprobe"]
    w, _ = weights.make(nets.spec_resnet50_v2(cfg.get("num_filters", 64), cfg["moco"]["dim"]),
                        seed, device, residual_gamma=cfg.get("residual_gamma", 1.0))
    w0 = {n: t.detach().cpu().clone() for n, t in w.items()}
    engine = InferenceEngine(build_encoder(cfg, w, device), tr["image_size"],
                             buckets=tuple(tr["buckets"]), device=device)
    del w
    rows = index_rows(seed, tr["index_rows"], cfg["moco"]["dim"], tr["centres"], tr["noise"])
    index = program_index(tr, rows, cfg["moco"]["dim"], device, nprobe)
    server = ServeServer(engine, index=index, port=0, slo_ms=tr["slo_ms"],
                         neighbors_k=tr["k"], neighbors_mode=tr["mode"], nprobe=nprobe,
                         warmup=True, flight_requests=tr["flight_requests"])
    return server, w0, rows


def window(server, seed: int, tr: dict, rate: float, seconds: float, device,
           profile_s: float = 0.0) -> dict:
    """Drive one open-loop window; returns the records and the trace.

    With `profile_s` the profiler is started before any request is due
    (its start stalls the interpreter for seconds, and a backlog left
    then drains slowly at the cell's load), records the card's activity
    alone, is marked for `profile_s` seconds in the window's middle from
    a thread of its own, and is stopped and parsed once every answer is
    in."""
    import threading

    prof = marker = None
    if profile_s:
        prof = devtrace.ProfilerWindow(device, host_ops=False)
        prof.open()
    duration = tr["warm_s"] + seconds
    reqs = schedule(seed, rate, duration, tr["mix"], tr["pool"])
    t0 = time.monotonic() + tr["start_s"]
    if prof is not None:
        def mark():
            time.sleep(max(t0 + tr["warm_s"] + seconds / 2 - profile_s / 2 - time.monotonic(), 0))
            prof.begin()
            time.sleep(profile_s)
            prof.end()

        marker = threading.Thread(target=mark, name="benchmark-profiler")
        marker.start()
    path = f"/neighbors?mode={tr['mode']}&k={tr['k']}"
    trace = {}
    try:
        records = run_clients(server.port, path, seed, tr, reqs, t0)
    finally:
        if marker is not None:
            marker.join()
        if prof is not None:
            prof.stop()
            trace = devtrace.summarize(prof.events)
    time.sleep(0.3)  # the last responses' waterfalls reach the flight ring
    return {"records": records, "requests": reqs, "t0": t0, "trace": trace}


def latencies(out: dict, tr: dict, seconds: float) -> tuple[list, list]:
    """(window records, their latencies in ms from the due time, +inf if failed)."""
    lo, hi = tr["warm_s"], tr["warm_s"] + seconds
    rec = [r for r in out["records"] if lo <= r["due"] < hi]
    lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else math.inf for r in rec]
    return rec, lat


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
        nprobe=None) -> dict:
    device = torch.device(device)
    tr = {**cell.traffic, "max_seconds": seconds}
    rate = float(cell.traffic["rate_rps"])
    server, w0, rows = serve_setup(cell, seed, device, nprobe)
    try:
        out = window(server, seed, tr, rate, seconds, device,
                     profile_s=tr["profile_s"] if trace else 0.0)
        waterfalls = server.flight.snapshot(top_n=0)["requests"] if trace else []
        ivf = ivf_state(server.index)
    finally:
        server.close()
    # setup ends where the window's first request was due
    setup_s = (out["t0"] + tr["warm_s"]) - (time.monotonic() - (time.perf_counter() - t_start))
    rec, lat = latencies(out, tr, seconds)
    late = sorted(r["late"] for r in rec)
    print(f"generator lateness over {len(rec)} window requests: p50 {percentile(late, 50):.4f} s, "
          f"p95 {percentile(late, 95):.4f} s, max {late[-1]:.4f} s; latency p50 "
          f"{percentile(lat, 50):.1f} ms, p95 {percentile(lat, 95):.1f} ms",
          file=sys.stderr, flush=True)
    result = {"attempted": len(rec), "failed": sum(r["status"] != 200 for r in rec),
              "e2e": {"serve_p95_ms": percentile(lat, 95), "serve_p50_ms": percentile(lat, 50),
                      "setup_s": setup_s}}
    ctx: dict = {}
    if trace:
        ids = {r.get("request_id") for r in rec}
        ctx = {"driver": "serve", "config": cell.config, "traffic": tr,
               "waterfalls": [w for w in waterfalls if w.get("request_id") in ids],
               "trace": out["trace"]}
        result["busy_s"] = out["trace"].get("busy_s")
        result["window_s"] = out["trace"].get("window_s")
        result["breakdown"] = {"device_ops": out["trace"].get("device_ops", []),
                               "idle_gaps": out["trace"].get("idle_gaps", [])}
    result["ctx"] = ctx
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    picked = sample(seed, rec, out["requests"], tr)
    result["numbers"] = check(cell, seed, out["requests"], picked, w0, rows, ivf, device)
    result["correct"] = True
    return result


def sample(seed: int, rec: list, requests: list, tr: dict) -> list:
    """A seeded sample of the finished window requests: `check_requests` of
    any size and `check_large` of the largest size."""
    done = [r for r in rec if r["status"] == 200]
    big = max(q[3] for q in requests)
    rng = np.random.default_rng((seed, 5))
    out = []
    for pool, n in ((done, tr["check_requests"]),
                    ([r for r in done if requests[r["i"]][3] == big], tr["check_large"])):
        if pool:
            out += [pool[j] for j in rng.choice(len(pool), size=min(n, len(pool)), replace=False)]
    return sorted({r["i"]: r for r in out}.values(), key=lambda r: r["i"])


def reference_embed(cfg: dict, w0: dict, images: np.ndarray, device,
                    prec: nets.Precision = nets.FP32) -> torch.Tensor:
    """Unit embeddings of uint8 NHWC images by the key encoder in eval mode."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        P = {n: t.to(device) for n, t in w0.items()}
        mean = torch.tensor(MEAN, device=device)
        std = torch.tensor(STD, device=device)
        out = []
        with torch.no_grad():
            for i in range(0, len(images), 128):
                x = (torch.from_numpy(images[i:i + 128]).to(device).float() / 255.0 - mean) / std
                e = nets.resnet50_v2(P, x, train=False, prec=prec,
                                     num_filters=cfg.get("num_filters", 64))
                out.append(e / e.norm(dim=1, keepdim=True).clamp_min(1e-12))
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def check(cell, seed: int, requests: list, picked: list, w0: dict, rows: np.ndarray,
          ivf: dict, device) -> dict:
    """The check's numbers (module docstring): `score_gap`, the widest gap
    between a served score and the reference's cosine of the request's
    image with the served row; `select_gap`, the most by which a row the
    IVF top-k has to return beats the worst row served in its place;
    and the cells' own `ivf_misplaced`. An answer
    with the wrong number of rows or a row out of range reads +inf in
    both gaps; scores out of order, or a row served twice or from a cell
    that no probe reaches, +inf in `select_gap`."""
    tr = cell.traffic
    table = torch.from_numpy(rows).to(device)
    cells, cent, count = ivf["cells"].to(device), ivf["centroids"].to(device), ivf["count"]
    numbers = search.ivf_build(table, cent, cells, count)
    numbers.update(score_gap=math.inf, select_gap=math.inf)
    if not picked:
        return numbers
    pool = http_client.image_pool(seed, tr["image_size"], tr["pool"])
    imgs = np.concatenate([http_client.request_images(pool, requests[r["i"]][2],
                                                      requests[r["i"]][3]) for r in picked])
    emb = reference_embed(cell.config, w0, imgs, device).double()
    idx, sc = [], []
    for r in picked:
        n = requests[r["i"]][3]
        i = np.asarray(r.get("indices") or [], dtype=np.int64)
        s = np.asarray(r.get("scores") or [], dtype=np.float64)
        if i.shape != (n, tr["k"]) or s.shape != i.shape or i.min() < 0 or i.max() >= len(rows):
            return numbers
        idx.append(i)
        sc.append(s)
    idx = torch.from_numpy(np.concatenate(idx)).to(device)
    sc = torch.from_numpy(np.concatenate(sc)).to(device)
    want = torch.einsum("nd,nkd->nk", emb, table.double()[idx])
    numbers["score_gap"] = float((sc - want).abs().max())
    gaps = search.selection_gap(emb, table, cent, cells, count, tr["nprobe"], idx, PROBE_MARGIN)
    ordered = bool((sc.diff(dim=1) <= 0).all())
    numbers["select_gap"] = float(gaps.max()) if ordered else math.inf
    return numbers


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    return nets._fp8_round(t.float()).double()


def control_reading(cell, seed: int, device, seconds: float, prec: str = "fp8") -> dict:
    """The reference in `prec` put in the program's place on the sample a
    run of this seed would check: its own embeddings, and its IVF search
    over the program's cells with both operands of each product rounded
    too, against the float32 reference."""
    cfg, tr = cell.config, cell.traffic
    w, _ = weights.make(nets.spec_resnet50_v2(cfg.get("num_filters", 64), cfg["moco"]["dim"]),
                        seed, device, residual_gamma=cfg.get("residual_gamma", 1.0))
    w0 = {n: t.detach().cpu().clone() for n, t in w.items()}
    del w
    rows = index_rows(seed, tr["index_rows"], cfg["moco"]["dim"], tr["centres"], tr["noise"])
    ivf = ivf_state(program_index(tr, rows, cfg["moco"]["dim"], device, tr["nprobe"]))
    reqs = schedule(seed, float(tr["rate_rps"]), tr["warm_s"] + seconds, tr["mix"], tr["pool"])
    rec = [{"i": q[0], "due": q[1], "status": 200} for q in reqs if q[1] >= tr["warm_s"]]
    picked = sample(seed, rec, reqs, tr)
    pool = http_client.image_pool(seed, tr["image_size"], tr["pool"])
    imgs = np.concatenate([http_client.request_images(pool, reqs[r["i"]][2], reqs[r["i"]][3])
                           for r in picked])
    low = reference_embed(cfg, w0, imgs, device, nets.Precision(prec))
    scores, idx = search.ivf_topk(low, torch.from_numpy(rows).to(device),
                                  ivf["centroids"].to(device), ivf["cells"].to(device),
                                  ivf["count"], tr["nprobe"], tr["k"], rounding=fp8_round)
    at = 0
    for r in picked:
        n = reqs[r["i"]][3]
        r["indices"] = idx[at:at + n].tolist()
        r["scores"] = scores[at:at + n].tolist()
        at += n
    return check(cell, seed, reqs, picked, w0, rows, ivf, device)


def skipped_chunk(real, chunk: int = 64):
    """The cell scan with the first `chunk` slots of every cell left out."""

    def scan(queries, cell_rows, probes):
        out = real(queries, cell_rows, probes)
        out[:, :, :chunk] = -1.0
        return out

    return scan


def calibration_numbers(cell, seed: int, mode: str, device, seconds: float = 8.0) -> dict:
    """The check's numbers of one calibration reading (`benchmark/calibrate.py`):
    the program under the cell's load for a short window of `seconds`
    ("program"); the fp8 reference in its place ("control"); or the
    program with a fault planted: one probe where the cell states
    `nprobe` ("nprobe1"), or the first 64-row chunk of every cell left
    out of the scan ("chunk_skip")."""
    if mode == "control":
        return control_reading(cell, seed, device, seconds)
    nprobe = 1 if mode == "nprobe1" else None
    if mode == "chunk_skip":
        import moco_tpu_torch.serve.index as program_index_module

        real = program_index_module.fused_cell_scores
        program_index_module.fused_cell_scores = skipped_chunk(real)
    try:
        return run(cell, seed, seconds, False, device, t_start=time.perf_counter(),
                   nprobe=nprobe)["numbers"]
    finally:
        if mode == "chunk_skip":
            program_index_module.fused_cell_scores = real


CALIBRATION_FAULTS = ("nprobe1", "chunk_skip")
