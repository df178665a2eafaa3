"""The embedding service's HTTP front end (standard library), the request
path of moco_tpu/serve/server.py.

Endpoints:

- `POST /embed` — body: raw uint8 pixels, `X-Image-Shape: n,h,w,c`
  header (h/w/c must match the engine). Response JSON:
  `{"embedding": [[...f32...]]}`.
- `POST /neighbors` — same body; `?k=5` (default the prepared k, and
  capped at it) and `?mode=exact|ivf|ivf_fused|exact_i8|ivf_i8|ivf_fused_i8`
  (default: the server's `neighbors_mode`). Response adds `{"indices",
  "scores", "mode"}`: the top-k cosine rows of the EmbeddingIndex; the
  `*_i8` modes score on its int8 mirror.
- `POST /ingest` — body: raw float32 rows, `X-Rows-Shape: n,d` header,
  and optionally `X-Ckpt-Step`, the training checkpoint step the rows come
  from. FIFO-ingests the block into the live index (the path
  `python -m moco_tpu_torch.serve.serve_ingest` drives from a training
  run's checkpoints): IVF cell membership and the int8 mirror follow, and
  every written row is stamped (the freshness SLO's signal). The body is
  read outside the index lock; the dim check, `index.add` and the counters
  run inside it. 503 without an index; `delay@site=ingest` stalls here,
  before the body read.
- `GET /stats` — the live `serve/*` gauges as JSON.
- `GET /admin/model` — the served model's identity: the checkpoint step
  and parameter digest of the encoder answering here, and the last
  ingest's checkpoint step.
- `GET /healthz` — `{"ok": true, "warm": ..., "draining": false}`; `warm`
  once the batcher thread's own warm-up pass has run (before the port is
  bound at all) and nothing recompiled since; `ok` turns false while
  draining, so a router stops sending here before intake shuts.
- `GET /debug/flight` — the flight recorder's snapshot (the slowest
  requests' waterfalls first, then the ring and the recent metric lines),
  also dumped to `<workdir>/flight_<ts>.json` when there is a workdir.
- `POST /admin/drain` (`?timeout=` seconds, default 30) — `drain()`:
  answers once every accepted request has been flushed, or the timeout
  passed (`"drained": false`).

Requests flow through the ContinuousBatcher, so concurrent clients share
padded-bucket executions; handler threads only block on their own
future. A flusher thread takes the `/stats` gauges every `metrics_flush_s`
seconds, feeds the flight recorder and the alert engine, renders the
request spans, and writes the line to the `sink` when there is one (e.g.
obs/sinks.py's `JsonlSink`; obs/schema.py's `serve/*` family); a failing
sink never takes serving down. `close()` joins the flusher, the HTTP
thread and the batcher, then flushes a final line.

Request-scoped observability (obs/{reqtrace,slo,flight}.py), as in the JAX
server: with `reqtrace=True` (the default) every request gets a
replica-scoped id (`request_id` in its response; an `X-Trace-Id` /
`X-Parent-Span` context is adopted) and a stage-stamped waterfall
(`ingress -> queue_wait -> batch_assemble -> engine_execute ->
index_query -> scatter -> respond`; `respond` runs from the result's
resolve, so the handler thread's wake counts in it, where JAX's starts
once the thread runs). Completed waterfalls feed a bounded
flight-recorder ring, the `serve/trace_<stage>_ms` means, the latency
histogram's p99 exemplar and, with a `workdir`, Perfetto request spans in
`trace_events.s<replica>.jsonl` (anchored by `heartbeat.s<replica>.json`).
An `SLOBurnTracker` turns `slo_ms` into `serve/burn_rate_<w>s`; an
`AlertEngine` over the flushed lines (`alert_spec="serve_default"`:
obs/slo.py's rules) dumps the flight recorder when a rule fires. With an
approximate `neighbors_mode`, every `recall_sample_every`-th neighbors
micro-batch also runs the exact tier on the same features and records
the top-k overlap (`serve/recall_estimate`). The `slow@site=serve.ingress`
and `serve.respond` faults sleep in the handler's stages. `metrics_port`
and `process_index` apply `obs/sinks.py::resolve_serve_port`'s offset
rule to a non-zero `port`.

A declared freshness objective (`fresh_max_age_s`, `fresh_objective`)
arms a `FreshnessBurnTracker` (`serve/fresh_burn_rate_<w>s`) and, under
`alert_spec="serve_default"`, its burn alerts (`fresh_alert_spec`): each
flush samples the index's oldest row age under the index lock and records
it outside it.

The batcher thread warms itself: before the port is bound it runs every
engine bucket and every prepared index shape once (`_warm_pass`), since
PyTorch's per-thread library state would otherwise make its first flush
pay that setup (PERF.md). With `warmup=False` the caller still warms and
prepares the engine and index; the batcher thread makes its own pass all
the same, over the shapes already prepared, so nothing recompiles.
"""

from __future__ import annotations

import http.server
import json
import os
import socket
import sys
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from moco_tpu_torch.analysis.contracts import record_route
from moco_tpu_torch.obs import ctxprop
from moco_tpu_torch.obs.alerts import AlertEngine, parse_rules
from moco_tpu_torch.obs.flight import FlightRecorder
from moco_tpu_torch.obs.reqtrace import RequestIdAllocator, emit_request_spans
from moco_tpu_torch.obs.sinks import resolve_serve_port
from moco_tpu_torch.obs.slo import (
    DEFAULT_WINDOWS,
    FreshnessBurnTracker,
    SLOBurnTracker,
    fresh_alert_spec,
    serve_alert_spec,
)
from moco_tpu_torch.obs.trace import Tracer, get_tracer
from moco_tpu_torch.serve.batcher import BatcherClosedError, ContinuousBatcher, ServeMetrics
from moco_tpu_torch.serve.index import QUERY_MODES
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.locks import make_lock

DEFAULT_NEIGHBORS_K = 5
DEFAULT_RECALL_SAMPLE_EVERY = 8
QUANT_TIERS = {"off": 0, "w8": 1, "w8a8": 2}  # the serve/quant_tier gauge


class _QuietHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer that stays quiet when a client abandons the
    connection mid-response."""

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)


class ServeServer:
    """HTTP front end binding engine + index + batcher. `port=0` binds an
    ephemeral port; `self.port` is the bound one. `index=None` serves
    `/embed` only (`/neighbors` answers 503). With `warmup=True` the
    engine warms up and the index is prepared for the engine's buckets in
    the exact tier and `neighbors_mode`, then frozen; with `warmup=False`
    the caller has warmed and prepared them, and every mode is accepted.
    Either way the batcher thread then runs its own pass over the prepared
    shapes before the port is bound. `sink=None` keeps the gauges in-process
    (`/stats` only). `workdir` and `replica_index` name this replica;
    `model_step` and `model_digest` are the served model's identity
    (obs/quality.py). The request-scoped observability arguments and their
    defaults are JAX's (module docstring)."""

    def __init__(
        self,
        engine,
        index=None,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics_port: int = 0,
        process_index: int = 0,
        slo_ms: float = 100.0,
        neighbors_k: int = DEFAULT_NEIGHBORS_K,
        neighbors_mode: str = "exact",
        nprobe: int = 0,
        recall_sample_every: int = DEFAULT_RECALL_SAMPLE_EVERY,
        sink=None,
        metrics_flush_s: float = 1.0,
        warmup: bool = True,
        workdir: Optional[str] = None,
        replica_index: int = 0,
        reqtrace: bool = True,
        slo_objective: float = 0.99,
        burn_windows=DEFAULT_WINDOWS,
        alert_spec: str = "serve_default",
        flight_requests: int = 512,
        model_step: Optional[int] = None,
        model_digest: Optional[str] = None,
        fresh_max_age_s: Optional[float] = None,
        fresh_objective: float = 0.99,
    ):
        if neighbors_mode not in QUERY_MODES:
            raise ValueError(
                f"neighbors_mode must be one of {QUERY_MODES}, got {neighbors_mode!r}"
            )
        if not metrics_flush_s > 0:
            raise ValueError(f"metrics_flush_s must be > 0, got {metrics_flush_s}")
        self.engine = engine
        self.index = index
        self.neighbors_k = int(neighbors_k)
        self.neighbors_mode = neighbors_mode
        self.nprobe = int(nprobe) or None
        self.recall_sample_every = int(recall_sample_every)
        self.workdir = workdir
        self.replica_index = int(replica_index)
        self.model_step = int(model_step) if model_step is not None else None
        self.model_digest = model_digest
        # the checkpoint step of the last /ingest block (X-Ckpt-Step) and the
        # rows ingested since the start, both under the index lock
        self.ingest_ckpt_step = None
        self.ingested_rows = 0
        # request-scoped observability: replica-tagged ids and waterfalls,
        # burn rates over the declared SLO, the flight recorder, and the
        # alert engine that dumps it; all off the request path but the stamps
        self._ids = RequestIdAllocator(self.replica_index) if reqtrace else None
        burn = SLOBurnTracker(slo_ms, objective=slo_objective, windows=burn_windows)
        self.metrics = ServeMetrics(slo_ms, burn=burn)
        self.flight = FlightRecorder(max_requests=flight_requests, replica=self.replica_index)
        # the freshness SLO: a declared max index-row age in wall seconds; one
        # observation per flush off the index's ingest stamps
        self.fresh = (FreshnessBurnTracker(fresh_max_age_s, objective=fresh_objective,
                                           windows=burn_windows)
                      if fresh_max_age_s else None)
        spec = (serve_alert_spec(slo_ms, windows=burn.windows)
                if alert_spec == "serve_default" else alert_spec)
        if self.fresh is not None and alert_spec == "serve_default":
            # a declared freshness objective arms its burn alerts too
            spec = ",".join(x for x in (spec, fresh_alert_spec(windows=burn.windows)) if x)
        self._alerts = (AlertEngine(parse_rules(spec), workdir=workdir,
                                    process_index=self.replica_index, on_fire=self._on_alert)
                        if spec else None)
        # the request spans' stream: the process's tracer when one is
        # installed (a training run in this process), else this replica's
        # own beside the training family, anchored for trace_merge
        self._tracer = get_tracer()
        self._own_tracer = None
        if self._tracer is None and workdir:
            self._own_tracer = self._tracer = Tracer(
                jsonl_path=os.path.join(workdir, f"trace_events.s{self.replica_index}.jsonl"),
                process_index=self.replica_index)
        if workdir and self._tracer is not None:
            self._write_serve_anchor()
        # completed traces awaiting span emission, drained by the flusher;
        # bounded, so a stalled flusher drops spans rather than grow
        self._span_pending: deque = deque(maxlen=4 * flight_requests)
        self._lane = 0
        self._neighbor_flushes = 0
        self._sink = sink
        self._flush_step = 0
        self._stop = threading.Event()
        # set from any thread (POST /admin/drain, a signal handler's path),
        # read by every /healthz
        self._draining = threading.Event()
        # one lock covers every index touch
        self._index_lock = make_lock("serve.index")
        self._prepared_modes = set(QUERY_MODES)
        if warmup:
            engine.warmup()
            if index is not None:
                # the exact tier is always prepared: it is the oracle
                self._prepared_modes = {"exact", neighbors_mode}
                index.prepare(
                    engine.buckets, self.neighbors_k,
                    nprobe=self.nprobe, modes=sorted(self._prepared_modes),
                )
                index.freeze()
        self.batcher = ContinuousBatcher(
            self._run_batch, max_batch=engine.buckets[-1], slo_ms=slo_ms, metrics=self.metrics,
            warmup=self._warm_pass,
        )
        # the batcher thread's own pass has run before the port is bound
        self.batcher.wait_warm()
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                record_route("GET", path)
                if path == "/healthz":
                    draining = server._draining.is_set()
                    self._json(200, {
                        "ok": not draining and not server.batcher.closed,
                        "warm": (server.batcher.warm
                                 and server.engine.recompiles_after_warmup == 0),
                        "draining": draining,
                        "replica": server.replica_index,
                    })
                elif path == "/stats":
                    self._json(200, server.stats())
                elif path == "/admin/model":
                    with server._index_lock:
                        ingest_step = server.ingest_ckpt_step
                    self._json(200, {
                        "model_step": server.model_step,
                        "model_digest": server.model_digest,
                        "ingest_ckpt_step": ingest_step,
                        "replica": server.replica_index,
                    })
                elif path == "/debug/flight":
                    # the ring on demand: dumped to disk when there is a
                    # workdir, returned either way
                    body = server.flight.snapshot()
                    if server.workdir:
                        body["dump_path"] = server.flight.dump(
                            server.workdir, reason="debug_request",
                            extra={"slo_ms": server.metrics.slo_ms})
                    self._json(200, body)
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                t_arrival = time.perf_counter()
                path, _, query = self.path.partition("?")
                record_route("POST", path)
                if path == "/ingest":
                    self._handle_ingest()
                    return
                if path == "/admin/drain":
                    self._handle_drain(query)
                    return
                if path not in ("/embed", "/neighbors"):
                    self.send_error(404)
                    return
                # kill@replica=i[:at=K] dies here, with the request (and any
                # riders of its batch) in flight: the router's breaker and
                # retry absorb the reset
                faults.maybe_kill_replica(server.replica_index)
                faults.maybe_slow("serve.ingress")
                try:
                    images = self._read_images()
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                want_neighbors = path == "/neighbors"
                if want_neighbors and server.index is None:
                    self._json(503, {"error": "no embedding index attached"})
                    return
                mode = _query_param(query, "mode") if want_neighbors else None
                if mode is not None and mode not in server._prepared_modes:
                    self._json(400, {
                        "error": f"mode {mode!r} not prepared on this server "
                        f"(serving: {sorted(server._prepared_modes)})"
                    })
                    return
                # a propagated trace context (the fleet's front door) makes
                # this waterfall a child of the sender's span
                ctx = ctxprop.parse(self.headers.get("X-Trace-Id"),
                                    self.headers.get("X-Parent-Span"))
                trace = None
                if server._ids is not None:
                    # backdated to the arrival: ingress covers the body read
                    trace = server._ids.new_trace(images.shape[0], t0=t_arrival, ctx=ctx)
                    trace.stamp("ingress", t_arrival, time.perf_counter())
                try:
                    fut = server.batcher.submit(images, want_neighbors=want_neighbors,
                                                mode=mode, trace=trace)
                    out = fut.result(timeout=30.0)
                except (BatcherClosedError, TimeoutError) as e:
                    self._json(503, {"error": str(e)})
                    return
                # respond runs from the result's resolve: this thread's wake
                # after it belongs to the request's answer too
                t_respond = fut.submitted_at + fut.latency_s
                faults.maybe_slow("serve.respond")
                body = {"embedding": out["embedding"].tolist()}
                if want_neighbors:
                    k = _query_k(query, server.neighbors_k)
                    eff = mode or server.neighbors_mode
                    body["indices"] = out[f"indices:{eff}"][:, :k].tolist()
                    body["scores"] = out[f"scores:{eff}"][:, :k].tolist()
                    body["mode"] = eff
                if trace is not None:
                    body["request_id"] = trace.req_id
                    if trace.trace_id is not None:
                        # the waterfall as stamped so far rides back to the
                        # sender, which stitches this hop in band
                        body["trace"] = trace.waterfall()
                self._json(200, body)
                if trace is not None:
                    trace.stamp("respond", t_respond, time.perf_counter())
                    server._complete(trace)

            def _handle_drain(self, query: str) -> None:
                """Drain synchronously: the answer comes once every accepted
                request has been flushed or the timeout passed."""
                try:
                    timeout = float(_query_param(query, "timeout") or 30.0)
                except ValueError:
                    self._json(400, {"error": "bad timeout parameter"})
                    return
                drained = server.drain(timeout=timeout)
                self._json(200, {"draining": True, "drained": drained,
                                 "replica": server.replica_index})

            def _handle_ingest(self) -> None:
                """FIFO-ingest a raw f32 row block into the live index."""
                if server.index is None:
                    self._json(503, {"error": "no embedding index attached"})
                    return
                # delay@site=ingest stalls here, before the body read and
                # outside the index lock: rows age while the block is stuck
                faults.maybe_delay("ingest")
                try:
                    shape_hdr = self.headers.get("X-Rows-Shape", "")
                    try:
                        n, d = (int(x) for x in shape_hdr.split(","))
                    except ValueError:
                        raise ValueError(f"bad X-Rows-Shape header {shape_hdr!r}")
                    ckpt_hdr = self.headers.get("X-Ckpt-Step")
                    ckpt_step = None
                    if ckpt_hdr:
                        try:
                            ckpt_step = int(ckpt_hdr)
                        except ValueError:
                            raise ValueError(f"bad X-Ckpt-Step header {ckpt_hdr!r}")
                    length = int(self.headers.get("Content-Length", 0))
                    if length != n * d * 4:
                        raise ValueError(f"Content-Length {length} != n*d*4 = {n * d * 4}")
                    # the socket read stays outside the lock; the dim check,
                    # the write and the counters are one step inside it
                    rows = np.frombuffer(self.rfile.read(length), np.float32).reshape(n, d)
                    with server._index_lock:
                        if d != server.index.dim:
                            raise ValueError(f"row dim {d} != index dim {server.index.dim}")
                        server.index.add(rows)
                        server.ingested_rows += n
                        if ckpt_step is not None:
                            server.ingest_ckpt_step = ckpt_step
                        index_rows = server.index.count
                        total_ingested = server.ingested_rows
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {"ingested": n, "index_rows": index_rows,
                                 "total_ingested": total_ingested})

            def _read_images(self) -> np.ndarray:
                shape_hdr = self.headers.get("X-Image-Shape", "")
                try:
                    shape = tuple(int(s) for s in shape_hdr.split(","))
                except ValueError:
                    raise ValueError(f"bad X-Image-Shape header {shape_hdr!r}")
                size = server.engine.image_size
                if len(shape) != 4 or shape[0] < 1 or shape[1:] != (size, size, 3):
                    raise ValueError(f"X-Image-Shape must be 'n,{size},{size},3' with n >= 1")
                n = int(self.headers.get("Content-Length", 0))
                expected = int(np.prod(shape))
                if n != expected:
                    raise ValueError(f"Content-Length {n} != prod(X-Image-Shape) {expected}")
                return np.frombuffer(self.rfile.read(n), np.uint8).reshape(shape)

            def _json(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr lines
                pass

        self._server = _QuietHTTPServer(
            (host, resolve_serve_port(port, metrics_port, process_index)), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serve_http", daemon=True
        )
        self._thread.start()
        self._flusher = threading.Thread(
            target=self._flush_loop, args=(float(metrics_flush_s),),
            name="serve_metrics_flush", daemon=True,
        )
        self._flusher.start()

    def _warm_pass(self) -> None:
        """The batcher thread's warm-up (ContinuousBatcher's `warmup`): every
        engine bucket's forward and, on its features, every index shape
        prepared for that bucket, once, on this thread. Only prepared shapes
        run, so `recompiles_after_warmup` stays 0."""
        with self._index_lock:
            for bucket in self.engine.buckets:
                feats = self.engine.warm_bucket(bucket)
                if self.index is not None:
                    self.index.warm(feats)

    def _run_batch(self, images, want_neighbors, modes=(), *, stages=None):
        """Batcher thread body: one padded engine execution per flush,
        then one index query per requested tier on the same features. With
        an approximate tier among them, every `recall_sample_every`-th
        neighbors flush also runs the exact tier and records the top-k
        overlap. `stages` (the batcher's request-trace contract) splits
        engine_execute from index_query."""
        if want_neighbors and self.index is not None:
            requested = {self.neighbors_mode, *modes}
            approx = next((m for m in (self.neighbors_mode, *sorted(requested))
                           if m.startswith("ivf")), None)
            sample_recall = False
            if approx is not None and self.recall_sample_every > 0:
                self._neighbor_flushes += 1
                if self._neighbor_flushes % self.recall_sample_every == 0:
                    sample_recall = True
                    requested.add("exact")
            with self._index_lock:
                emb, per_mode, executed = self.engine.embed_and_query_modes(
                    images, self.index, self.neighbors_k,
                    modes=tuple(sorted(requested)), nprobe=self.nprobe, stages=stages,
                )
            if sample_recall:
                exact_idx, approx_idx = per_mode["exact"][1], per_mode[approx][1]
                overlap = np.asarray([len(set(exact_idx[i]) & set(approx_idx[i]))
                                      for i in range(exact_idx.shape[0])])
                self.metrics.record_recall(float(overlap.mean()) / exact_idx.shape[1])
            results = {"embedding": emb}
            for m, (scores, idx) in per_mode.items():
                results[f"scores:{m}"] = scores
                results[f"indices:{m}"] = idx
            return results, executed
        emb, executed = self.engine.embed(images, stages=stages)
        return {"embedding": emb}, executed

    # -- request-scoped observability ------------------------------------

    def _complete(self, trace) -> None:
        """A request finished responding: its waterfall goes to the flight
        ring and the span queue (both O(1); the flusher renders spans)."""
        self.flight.record_request(trace.waterfall())
        self._span_pending.append(trace)

    def _drain_spans(self) -> None:
        """The flusher's side of `_complete`: queued waterfalls as Perfetto
        spans on the virtual request lanes."""
        if self._tracer is None:
            self._span_pending.clear()
            return
        while True:
            try:
                trace = self._span_pending.popleft()
            except IndexError:
                break
            emit_request_spans(self._tracer, trace, self._lane)
            self._lane += 1  # mocolint: disable=JX012  (flusher-thread only during the run; close() joins the flusher BEFORE its final _write_metrics call, so the two writers are join-serialized, never concurrent)

    def _on_alert(self, alert: dict) -> None:
        """AlertEngine hook, at the firing edge: dump the flight recorder
        and write an `alert` event line."""
        if self.workdir:
            try:
                self.flight.dump(self.workdir, reason=f"alert:{alert['rule']}",
                                 extra={"alert": alert, "slo_ms": self.metrics.slo_ms,
                                        "replica": self.replica_index})
            except Exception as e:  # the dump must never take serving down
                print(f"WARNING: flight dump failed: {e!r}", flush=True)
        if self._sink is not None:
            self._sink.write(self._flush_step, {
                "event": "alert", "alert": alert["rule"], "severity": alert["severity"],
                f"alert/{alert['rule']}": 1.0})

    def _write_serve_anchor(self) -> None:
        """Atomic `heartbeat.s<replica>.json` with the tracer's wall anchor,
        which scripts/trace_merge.py aligns this replica's spans by."""
        rec = {"process": self.replica_index, "role": "serve", "host": socket.gethostname(),
               "pid": os.getpid(), "time": time.time(),
               "trace_wall_t0": self._tracer.wall_t0}
        path = os.path.join(self.workdir, f"heartbeat.s{self.replica_index}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    def stats(self) -> dict:
        """The `serve/*` gauges (`moco_tpu/serve/server.py:650`'s), read
        under the index lock so they agree with each other. The qps window
        restarts at each call."""
        with self._index_lock:
            out = self.metrics.payload()
            out["serve/recompiles_after_warmup"] = self.engine.recompiles_after_warmup
            out["serve/nprobe"] = None
            # quantized scoring anywhere: the index's int8 tier or the engine's
            out["serve/int8"] = int(self.neighbors_mode.endswith("_i8")
                                    or getattr(self.engine, "int8", False))
            out["serve/quant_tier"] = QUANT_TIERS.get(getattr(self.engine, "quant", "off"), 0)
            out["serve/model_step"] = self.model_step
            out["serve/model_digest"] = self.model_digest
            out["serve/ingest_ckpt_step"] = self.ingest_ckpt_step
            if self.fresh is not None:
                out.update(self.fresh.payload())
            if self.index is not None:
                ages = self.index.row_age_stats()
                out["serve/row_age_max_s"] = ages["row_age_max_s"]
                out["serve/row_age_mean_s"] = ages["row_age_mean_s"]
                out["serve/index_rows"] = self.index.count
                out["serve/ingested_rows"] = self.ingested_rows
                out["serve/recompiles_after_warmup"] += self.index.recompiles_after_warmup
                ivf = self.index.ivf_stats()
                if self.neighbors_mode.startswith("ivf"):
                    out["serve/nprobe"] = self.nprobe or ivf.get("nprobe")
                out["serve/ivf_spill"] = ivf["spilled"] if ivf["trained"] else None
                out["serve/ivf_occupancy"] = ivf["occupancy"] if ivf["trained"] else None
        return out

    def _flush_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self._write_metrics()

    def _write_metrics(self) -> None:
        """One off-path observability turn (the flusher thread, then
        `close()` once the flusher is joined: one writer at a time): the
        gauges into the flight ring and the alert engine (a fired rule
        dumps the ring through `_on_alert`), the pending request spans,
        then the line to the sink."""
        self._flush_step += 1  # mocolint: disable=JX012  (same join-serialization as _lane: the alert hook fires ON the flusher thread, and close() joins the flusher before the final flush, one writer at a time by construction)
        try:
            if self.fresh is not None:
                # one freshness observation per flush: the oldest row's age
                # (None: an empty index, not a stale one), sampled under the
                # index lock and recorded outside it
                age = None
                if self.index is not None:
                    with self._index_lock:
                        age = self.index.row_age_stats()["row_age_max_s"]
                self.fresh.record(age)
            payload = self.stats()
            self.flight.record_metrics(self._flush_step, payload)
            if self._alerts is not None:
                self._alerts.observe(self._flush_step, payload)
            self._drain_spans()
            if self._sink is not None:
                self._sink.write(self._flush_step, payload)
        except Exception as e:  # metrics must never take serving down
            print(f"WARNING: serve metrics sink failed: {e!r}", flush=True)

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown, first half: /healthz turns not-ok, then the
        batcher flushes every accepted request and closes its intake. HTTP
        stays up (/healthz answers during the drain); follow with
        `close()`. True when the flush finished within `timeout`; a second
        call returns at once."""
        already = self._draining.is_set()
        self._draining.set()
        if already and self.batcher.closed:
            return True
        return self.batcher.drain(timeout=timeout)

    def close(self) -> None:
        """Shut down the flusher, HTTP and the batcher, joining their
        threads; then a final metrics line lands in the sink."""
        self._stop.set()
        self._flusher.join(timeout=5.0)
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self.batcher.close()
        self._write_metrics()
        if self._alerts is not None:
            self._alerts.close()
        if self._own_tracer is not None:
            self._own_tracer.close()


def _query_param(query: str, name: str) -> str | None:
    for part in query.split("&"):
        if part.startswith(name + "="):
            return part[len(name) + 1 :] or None
    return None


def _query_k(query: str, default: int) -> int:
    val = _query_param(query, "k")
    if val is not None:
        try:
            return max(1, min(int(val), default))
        except ValueError:
            pass
    return default


__all__ = ["DEFAULT_NEIGHBORS_K", "DEFAULT_RECALL_SAMPLE_EVERY", "QUANT_TIERS", "ServeServer"]
