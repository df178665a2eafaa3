"""One serving replica as a process, the counterpart of
moco_tpu/serve/replica_main.py.

    python -m moco_tpu_torch.serve.replica_main --ckpt-dir /run/workdir \\
        --port 8001 [--replica-index 1] [--workdir /fleet/replica1] \\
        [--buckets 1,8,32] [--slo-ms 1000] [--neighbors-mode exact] \\
        [--fresh-max-age-s 60] [--device cuda]

Loads the newest good checkpoint's key encoder (`load_serving_encoder`),
wraps its queue as the serving index (`EmbeddingIndex.from_train_queue`;
a queue-free v3 checkpoint serves `/embed` alone, `/neighbors` answering
503) and starts a `ServeServer` on the port, which binds only after the
engine's warmup: a refused connection means still warming, never a cold
replica. The served model's identity is the checkpoint's step and the
digest of its parameters (obs/quality.py). The line that announces the
port gives the boot's seconds by stage (imports, restore, digest, and the
engine's, index's and batcher's warm-up). With `--workdir`, the
`serve/*` gauges go to `<workdir>/metrics.jsonl` every `--metrics-flush-s`.

`--fresh-max-age-s` above 0 declares the freshness SLO (the oldest index
row's age in wall seconds) and arms its burn alerts; `/ingest` keeps the
rows fresh (`python -m moco_tpu_torch.serve.serve_ingest`).

Faults install from `MOCO_FAULTS`. SIGTERM or SIGINT drains: intake stops,
every accepted request is flushed (`ServeServer.drain`), the server and
the sink close, and the process exits 0.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="one serving replica process (PyTorch port)")
    ap.add_argument("--ckpt-dir", required=True, help="pretraining checkpoint workdir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--replica-index", type=int, default=0)
    ap.add_argument("--workdir", default=None, help="metrics output dir")
    ap.add_argument("--buckets", default="1,8,32", help="comma-separated batch buckets")
    ap.add_argument("--slo-ms", type=float, default=1000.0)
    ap.add_argument("--neighbors-mode", default="exact")
    ap.add_argument("--neighbors-k", type=int, default=5)
    ap.add_argument("--metrics-flush-s", type=float, default=1.0)
    ap.add_argument("--drain-timeout-s", type=float, default=30.0)
    ap.add_argument("--fresh-max-age-s", type=float, default=0.0,
                    help="freshness SLO: max index-row age in wall seconds "
                    "(0 = no freshness objective declared)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    marks = [("start", time.perf_counter())]

    from moco_tpu_torch.analysis import contracts as contract_cov
    from moco_tpu_torch.obs.quality import encoder_digest
    from moco_tpu_torch.obs.sinks import JsonlSink
    from moco_tpu_torch.serve.engine import InferenceEngine, load_serving_encoder
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.serve.server import ServeServer
    from moco_tpu_torch.utils import faults
    from moco_tpu_torch.utils.checkpoint import CheckpointManager

    faults.install_from_env()
    # the contract-coverage arm: MOCO_CONTRACT_COVERAGE=1 installs a
    # recorder, dumped to <workdir>/contract_coverage.json on a graceful
    # exit, added to the file an earlier life of this slot left there in
    # the supervisor's run (a killed replica never dumps; its respawn
    # covers the same contracts)
    recorder = contract_cov.maybe_install_from_env()
    # installed before the warmup: a signal during it drains the replica as
    # soon as it serves
    stop = threading.Event()

    def _graceful(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    marks.append(("imports", time.perf_counter()))
    encoder, queue, queue_ptr, config = load_serving_encoder(args.ckpt_dir, device=args.device)
    model_step = CheckpointManager(args.ckpt_dir).latest_step()
    marks.append(("restore", time.perf_counter()))
    model_digest = encoder_digest(encoder)
    marks.append(("digest", time.perf_counter()))
    engine = InferenceEngine(encoder, config.data.image_size, buckets=buckets,
                             device=args.device)
    index = None
    if queue is not None:
        index = EmbeddingIndex.from_train_queue(queue, queue_ptr, device=args.device)
    sink = None
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        sink = JsonlSink(args.workdir)
    server = ServeServer(
        engine, index=index, host=args.host, port=args.port, slo_ms=args.slo_ms,
        neighbors_k=args.neighbors_k, neighbors_mode=args.neighbors_mode, sink=sink,
        metrics_flush_s=args.metrics_flush_s, workdir=args.workdir,
        replica_index=args.replica_index, model_step=model_step, model_digest=model_digest,
        fresh_max_age_s=args.fresh_max_age_s or None,
    )
    marks.append(("warm-up", time.perf_counter()))
    stages = ", ".join(f"{name} {t - prev:.1f} s"
                       for (_, prev), (name, t) in zip(marks, marks[1:]))
    print(f"replica {args.replica_index} serving on http://{args.host}:{server.port} "
          f"(buckets={buckets}; {stages})", flush=True)
    while not stop.wait(0.25):
        pass
    drained = server.drain(timeout=args.drain_timeout_s)
    server.close()
    if sink is not None:
        sink.close()
    if recorder is not None and args.workdir:
        contract_cov.dump_merged(recorder, os.path.join(args.workdir, contract_cov.COVERAGE_FILE))
    print(f"replica {args.replica_index} drained ({'clean' if drained else 'timed out'}) "
          "and exited", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
