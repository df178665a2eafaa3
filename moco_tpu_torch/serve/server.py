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
- `GET /healthz` — `{"ok": true, "warm": ...}` once warm.

Requests flow through the ContinuousBatcher, so concurrent clients share
padded-bucket executions; handler threads only block on their own
future. `close()` joins the HTTP thread and the batcher.

Request tracing, the flight recorder, alerts, the freshness SLO,
`/ingest`, `/admin/*` and the recall estimator of the JAX server come
with later slices.
"""

from __future__ import annotations

import http.server
import json
import sys
import threading

import numpy as np

from moco_tpu_torch.serve.batcher import BatcherClosedError, ContinuousBatcher, ServeMetrics
from moco_tpu_torch.serve.index import QUERY_MODES
from moco_tpu_torch.utils.locks import make_lock

DEFAULT_NEIGHBORS_K = 5


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
    the caller has warmed and prepared them, and every mode is accepted."""

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
        warmup: bool = True,
    ):
        if neighbors_mode not in QUERY_MODES:
            raise ValueError(
                f"neighbors_mode must be one of {QUERY_MODES}, got {neighbors_mode!r}"
            )
        self.engine = engine
        self.index = index
        self.neighbors_k = int(neighbors_k)
        self.neighbors_mode = neighbors_mode
        self.nprobe = int(nprobe) or None
        self.metrics = ServeMetrics(slo_ms)
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
                    self._json(200, {
                        "ok": not server.batcher.closed,
                        "warm": server.engine.recompiles_after_warmup == 0,
                    })
                elif path == "/stats":
                    self._json(200, server.stats())
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                path, _, query = self.path.partition("?")
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
        with self._index_lock:
            out = self.metrics.payload()
            out["serve/recompiles_after_warmup"] = self.engine.recompiles_after_warmup
            if self.index is not None:
                out["serve/index_rows"] = self.index.count
                out["serve/recompiles_after_warmup"] += self.index.recompiles_after_warmup
                ivf = self.index.ivf_stats()
                out["serve/nprobe"] = (
                    (self.nprobe or ivf.get("nprobe"))
                    if self.neighbors_mode.startswith("ivf") else None
                )
                out["serve/ivf_spill"] = ivf["spilled"] if ivf["trained"] else None
                out["serve/ivf_occupancy"] = ivf["occupancy"] if ivf["trained"] else None
        return out

    def close(self) -> None:
        """Shut down HTTP and the batcher; join both threads."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self.batcher.close()


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


__all__ = ["DEFAULT_NEIGHBORS_K", "ServeServer"]
