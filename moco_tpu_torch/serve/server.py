"""The embedding service's HTTP front end (standard library), the request
path of moco_tpu/serve/server.py.

Endpoints:

- `POST /embed` — body: raw uint8 pixels, `X-Image-Shape: n,h,w,c`
  header (h/w/c must match the engine). Response JSON:
  `{"embedding": [[...f32...]]}`.
- `POST /neighbors` — same body; `?k=5` (default the prepared k, and
  capped at it) and `?mode=exact|ivf|ivf_fused` (default: the server's
  `neighbors_mode`). Response adds `{"indices", "scores", "mode"}`: the
  top-k cosine rows of the EmbeddingIndex.
- `GET /stats` — the live `serve/*` gauges as JSON.
- `GET /admin/model` — the served model's identity: the checkpoint step
  and parameter digest of the encoder answering here (and the last
  ingest's checkpoint step, null: the port has no `/ingest` yet).
- `GET /healthz` — `{"ok": true, "warm": ..., "draining": false}` once
  warm; `ok` turns false while draining, so a router stops sending here
  before intake shuts.
- `POST /admin/drain` (`?timeout=` seconds, default 30) — `drain()`:
  answers once every accepted request has been flushed, or the timeout
  passed (`"drained": false`).

Requests flow through the ContinuousBatcher, so concurrent clients share
padded-bucket executions; handler threads only block on their own
future. With a `sink` (e.g. obs/sinks.py's `JsonlSink`), a flusher thread
writes the `/stats` gauges every `metrics_flush_s` seconds (obs/schema.py's
`serve/*` family); a failing sink never takes serving down. `close()`
joins the flusher, the HTTP thread and the batcher, then writes a final
line.

Request tracing, the flight recorder, alerts, the SLO burn and freshness
trackers, the recall estimator, `/ingest` and `/debug/flight` of the JAX
server come with a later slice: the constructor refuses their arguments.
"""

from __future__ import annotations

import http.server
import json
import sys
import threading
from typing import Optional

import numpy as np

from moco_tpu_torch.serve.batcher import BatcherClosedError, ContinuousBatcher, ServeMetrics
from moco_tpu_torch.serve.index import QUERY_MODES
from moco_tpu_torch.utils.locks import make_lock

DEFAULT_NEIGHBORS_K = 5
# the JAX server's arguments for what comes with a later slice of the port:
# request tracing, the flight recorder, alerts, the SLO burn and freshness
# trackers, the recall estimator and the metrics port's offset rule. Each
# is accepted only with a value that asks for none of it (False, None, 0).
LATER_SLICE_ARGS = frozenset({
    "reqtrace", "flight_requests", "alert_spec", "slo_objective", "burn_windows",
    "fresh_max_age_s", "fresh_objective", "recall_sample_every", "metrics_port",
    "process_index",
})


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
    the exact tier and `neighbors_mode`, then frozen, before the port is
    bound; with `warmup=False` the caller has warmed and prepared them,
    and every mode is accepted. `sink=None` keeps the gauges in-process
    (`/stats` only). `workdir` and `replica_index` name this replica;
    `model_step` and `model_digest` are the served model's identity
    (obs/quality.py)."""

    def __init__(
        self,
        engine,
        index=None,
        host: str = "127.0.0.1",
        port: int = 0,
        slo_ms: float = 100.0,
        neighbors_k: int = DEFAULT_NEIGHBORS_K,
        neighbors_mode: str = "exact",
        nprobe: int = 0,
        sink=None,
        metrics_flush_s: float = 1.0,
        warmup: bool = True,
        workdir: Optional[str] = None,
        replica_index: int = 0,
        model_step: Optional[int] = None,
        model_digest: Optional[str] = None,
        **later,
    ):
        for name, value in later.items():
            if name not in LATER_SLICE_ARGS:
                raise TypeError(f"ServeServer() got an unexpected keyword argument {name!r}")
            if value:
                raise ValueError(
                    f"ServeServer({name}={value!r}): request tracing, the flight recorder, "
                    "alerts, the SLO burn and freshness trackers and the recall estimator "
                    "come with a later slice of the port"
                )
        if neighbors_mode not in QUERY_MODES:
            raise ValueError(
                f"neighbors_mode must be one of {QUERY_MODES}, got {neighbors_mode!r}"
            )
        if sink is not None and not metrics_flush_s > 0:
            raise ValueError(f"metrics_flush_s must be > 0, got {metrics_flush_s}")
        self.engine = engine
        self.index = index
        self.neighbors_k = int(neighbors_k)
        self.neighbors_mode = neighbors_mode
        self.nprobe = int(nprobe) or None
        self.workdir = workdir
        self.replica_index = int(replica_index)
        self.model_step = int(model_step) if model_step is not None else None
        self.model_digest = model_digest
        # the checkpoint step of the last /ingest block: none without /ingest
        self.ingest_ckpt_step = None
        self.metrics = ServeMetrics(slo_ms)
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
            self._run_batch, max_batch=engine.buckets[-1], slo_ms=slo_ms, metrics=self.metrics
        )
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                if path == "/healthz":
                    draining = server._draining.is_set()
                    self._json(200, {
                        "ok": not draining and not server.batcher.closed,
                        "warm": server.engine.recompiles_after_warmup == 0,
                        "draining": draining,
                        "replica": server.replica_index,
                    })
                elif path == "/stats":
                    self._json(200, server.stats())
                elif path == "/admin/model":
                    self._json(200, {
                        "model_step": server.model_step,
                        "model_digest": server.model_digest,
                        "ingest_ckpt_step": server.ingest_ckpt_step,
                        "replica": server.replica_index,
                    })
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                path, _, query = self.path.partition("?")
                if path == "/admin/drain":
                    self._handle_drain(query)
                    return
                if path not in ("/embed", "/neighbors"):
                    self.send_error(404)
                    return
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
                try:
                    fut = server.batcher.submit(images, want_neighbors=want_neighbors, mode=mode)
                    out = fut.result(timeout=30.0)
                except (BatcherClosedError, TimeoutError) as e:
                    self._json(503, {"error": str(e)})
                    return
                body = {"embedding": out["embedding"].tolist()}
                if want_neighbors:
                    k = _query_k(query, server.neighbors_k)
                    eff = mode or server.neighbors_mode
                    body["indices"] = out[f"indices:{eff}"][:, :k].tolist()
                    body["scores"] = out[f"scores:{eff}"][:, :k].tolist()
                    body["mode"] = eff
                self._json(200, body)

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

        self._server = _QuietHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serve_http", daemon=True
        )
        self._thread.start()
        self._flusher = None
        if sink is not None:
            self._flusher = threading.Thread(
                target=self._flush_loop, args=(float(metrics_flush_s),),
                name="serve_metrics_flush", daemon=True,
            )
            self._flusher.start()

    def _run_batch(self, images, want_neighbors, modes=()):
        """Batcher thread body: one padded engine execution per flush,
        then one index query per requested tier on the same features."""
        if want_neighbors and self.index is not None:
            requested = {self.neighbors_mode, *modes}
            with self._index_lock:
                emb, per_mode, executed = self.engine.embed_and_query_modes(
                    images, self.index, self.neighbors_k,
                    modes=tuple(sorted(requested)), nprobe=self.nprobe,
                )
            results = {"embedding": emb}
            for m, (scores, idx) in per_mode.items():
                results[f"scores:{m}"] = scores
                results[f"indices:{m}"] = idx
            return results, executed
        emb, executed = self.engine.embed(images)
        return {"embedding": emb}, executed

    def stats(self) -> dict:
        """The `serve/*` gauges (`moco_tpu/serve/server.py:650`'s, for the
        tiers the port has), read under the index lock so they agree with
        each other. The qps window restarts at each call."""
        with self._index_lock:
            out = self.metrics.payload()
            out["serve/recompiles_after_warmup"] = self.engine.recompiles_after_warmup
            out["serve/nprobe"] = None
            # the port has neither the int8 tiers nor engine quantization yet
            out["serve/int8"] = int(self.neighbors_mode.endswith("_i8"))
            out["serve/quant_tier"] = 0
            out["serve/model_step"] = self.model_step
            out["serve/model_digest"] = self.model_digest
            out["serve/ingest_ckpt_step"] = self.ingest_ckpt_step
            if self.index is not None:
                out["serve/index_rows"] = self.index.count
                out["serve/ingested_rows"] = 0
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
        """One line of the gauges to the sink (the flusher thread, then
        `close()` once the flusher is joined: one writer at a time)."""
        self._flush_step += 1
        try:
            self._sink.write(self._flush_step, self.stats())
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
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self.batcher.close()
        if self._sink is not None:
            self._write_metrics()


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


__all__ = ["DEFAULT_NEIGHBORS_K", "LATER_SLICE_ARGS", "ServeServer"]
