"""Metric sinks and the registry that builds them, the port's
moco_tpu/obs/sinks.py.

One `write(step, payload)` surface; the fan-out decides where a line lands:

- `JsonlSink`: the canonical append-only `metrics.jsonl` (each line
  flushed as written; the fault counters, the chaos tests and
  `scripts/obs_report.py` read it, so `build_sinks` always includes it);
- `CsvSink`: a wide table whose header grows as new fields appear (the
  file is rewritten on a header change, cheap at logging cadence);
- `TensorBoardSink`: scalars through whichever TensorBoard writer is
  importable, imported when the sink is built; without one the
  constructor raises a clear RuntimeError;
- `PrometheusSink`: an in-process HTTP endpoint serving the latest gauges
  in Prometheus text format on `/metrics`, histograms as cumulative
  `_bucket{le=...}` series.

Device-transfer discipline: a payload may hold live tensors.
`gather_payload` fetches all of them in ONE device-to-host copy (the
counterpart of JAX's single `jax.device_get`): they are flattened and
concatenated on their device, copied once, and split on the host.
"""

from __future__ import annotations

import csv
import http.server
import json
import math
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from moco_tpu_torch.utils.contracts import SERVE_PORT_STRIDE
from moco_tpu_torch.utils.locks import make_lock


def flatten_tensors(tensors: list) -> tuple[torch.Tensor, list]:
    """Tensors of one device -> (a flat float64 tensor on that device, the
    layout `unflatten_host` splits it by). float64 holds every f32, bf16
    and int32 value exactly."""
    layout = [(tuple(t.shape), t.dtype) for t in tensors]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
    return flat, layout


def _np_dtype(dtype: torch.dtype):
    if dtype == torch.bool:
        return np.bool_
    if dtype.is_floating_point:
        return np.float64 if dtype == torch.float64 else np.float32
    return np.int64


def unflatten_host(host: torch.Tensor, layout: list) -> list:
    """A host copy of `flatten_tensors`'s flat tensor -> one numpy array per
    tensor, in its own shape (bf16 and f16 come back as float32)."""
    values = host.numpy()
    out, at = [], 0
    for shape, dtype in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(values[at:at + n].astype(_np_dtype(dtype)).reshape(shape))
        at += n
    return out


def _device_get(tensors: list) -> list:
    """The one device-to-host copy of `gather_payload`: numpy arrays of
    `tensors`, which share one device."""
    flat, layout = flatten_tensors(tensors)
    return unflatten_host(flat.cpu(), layout)


# Single indirection point for the batched transfer, so tests can count
# calls (tests/test_torch_obs.py), as JAX's tests count device_get calls.
_DEVICE_GET = _device_get


def gather_payload(payload: dict) -> dict:
    """Fetch every tensor value in ONE transfer; host values pass through
    untouched. Called once per log event, upstream of all sinks."""
    keys = [k for k, v in payload.items() if torch.is_tensor(v)]
    if not keys:
        return payload
    devices = {payload[k].device for k in keys}
    if len(devices) > 1:
        raise ValueError(f"payload tensors span devices {sorted(map(str, devices))}")
    fetched = _DEVICE_GET([payload[k] for k in keys])
    out = dict(payload)
    out.update(zip(keys, fetched))
    return out


def _scrub(v):
    """JSON-safe value: non-finite floats -> None (NaN/Inf are invalid
    strict JSON; the guard writes its own event for a non-finite loss),
    numpy scalars -> Python, arrays -> scrubbed lists."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return _scrub(v.item()) if v.ndim == 0 else [_scrub(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_scrub(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        v = float(v)
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def sanitize(rec: dict) -> dict:
    return {k: _scrub(v) for k, v in rec.items()}


class Sink:
    """Interface: `write` one log event; `fsync` makes the tail durable
    (preemption and abort paths); `close` is idempotent."""

    def write(self, step: int, payload: dict) -> None:
        raise NotImplementedError

    def fsync(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """Append-only JSONL metrics, one object per log event. Every line is
    flushed to the OS as written, so a killed process loses at most the
    line being formatted; `fsync` makes the tail durable across a host
    crash. Line schema: obs/schema.py."""

    def __init__(self, workdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, filename)
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, payload: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update(sanitize(gather_payload(payload)))
        self._f.write(json.dumps(rec, allow_nan=False) + "\n")
        self._f.flush()

    def fsync(self) -> None:
        if not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self.fsync()
            self._f.close()


class CsvSink(Sink):
    """Wide-table CSV: one row per log event, columns the union of the
    fields seen so far. A payload with new fields rewrites the file with
    the grown header (the rows are kept in memory; one row per log event
    stays small). List and dict values are JSON-encoded into their cell."""

    def __init__(self, workdir: str, filename: str = "metrics.csv"):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, filename)
        self._fields: list[str] = ["step", "time"]
        self._rows: list[dict] = []

    def write(self, step: int, payload: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update(sanitize(gather_payload(payload)))
        rec = {k: json.dumps(v) if isinstance(v, (list, dict)) else v for k, v in rec.items()}
        grew = False
        for k in rec:
            if k not in self._fields:
                self._fields.append(k)
                grew = True
        self._rows.append(rec)
        if grew:
            self._rewrite()
        else:
            self._append(rec)

    def _writer(self, f):
        return csv.DictWriter(f, fieldnames=self._fields, restval="")

    def _rewrite(self) -> None:
        with open(self.path, "w", newline="") as f:
            w = self._writer(f)
            w.writeheader()
            w.writerows(self._rows)

    def _append(self, rec: dict) -> None:
        new_file = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        with open(self.path, "a", newline="") as f:
            w = self._writer(f)
            if new_file:
                w.writeheader()
            w.writerow(rec)

    def close(self) -> None:
        self._rows.clear()


class TensorBoardSink(Sink):
    """Scalar summaries through whichever TensorBoard writer is importable
    (`tensorboardX` or `torch.utils.tensorboard`), imported here, when the
    sink is built: importing either can take seconds. Without one the
    constructor raises a clear RuntimeError instead of an ImportError from
    three layers down."""

    def __init__(self, workdir: str, subdir: str = "tb"):
        writer_cls = None
        try:
            from tensorboardX import SummaryWriter as writer_cls  # noqa: N813
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter as writer_cls  # noqa: N813
            except ImportError:
                pass
        if writer_cls is None:
            raise RuntimeError(
                "TensorBoardSink needs `tensorboardX` or `torch` installed; "
                "neither is available in this environment. Use sinks="
                "'jsonl,csv' (and scripts/obs_report.py) instead, or install one."
            )
        self._w = writer_cls(os.path.join(workdir, subdir))

    def write(self, step: int, payload: dict) -> None:
        rec = sanitize(gather_payload(payload))
        for k, v in rec.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._w.add_scalar(k, v, global_step=int(step))

    def fsync(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()


# -- Prometheus ----------------------------------------------------------


def prom_name(key: str, prefix: str = "moco") -> str:
    """Metric key -> valid Prometheus metric name ([a-zA-Z_:][a-zA-Z0-9_:]*)."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in key)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return f"{prefix}_{safe}"


def _is_histogram(v) -> bool:
    """Payload values shaped like obs/schema.py's latency histogram render
    as Prometheus histograms instead of gauges."""
    return (
        isinstance(v, dict)
        and isinstance(v.get("le"), list)
        and isinstance(v.get("counts"), list)
        and len(v["counts"]) == len(v["le"]) + 1
        and "sum" in v
        and "count" in v
    )


def _render_histogram(name: str, hist: dict) -> list[str]:
    """Cumulative `_bucket{le=...}` + `_sum` / `_count` lines for one
    histogram payload (its per-bucket counts cumulate here). An exemplar
    ({"request_id", "latency_ms"}: the p99 offender) rides the first
    bucket it falls in, OpenMetrics-style; text-format-0.0.4 scrapers read
    the `# {...}` tail as a comment."""
    lines = [f"# TYPE {name} histogram"]
    exemplar = hist.get("exemplar") or {}
    ex_ms = exemplar.get("latency_ms")
    ex_id = exemplar.get("request_id")
    cum = 0
    for le, count in zip(hist["le"], hist["counts"]):
        cum += count
        line = f'{name}_bucket{{le="{le:g}"}} {cum}'
        if ex_id is not None and ex_ms is not None and ex_ms <= le:
            line += f' # {{request_id="{ex_id}"}} {ex_ms:g}'
            ex_id = ex_ms = None
        lines.append(line)
    cum += hist["counts"][-1]
    line = f'{name}_bucket{{le="+Inf"}} {cum}'
    if ex_id is not None and ex_ms is not None:
        line += f' # {{request_id="{ex_id}"}} {ex_ms:g}'
    lines.append(line)
    lines.append(f"{name}_sum {hist['sum']}")
    lines.append(f"{name}_count {hist['count']}")
    return lines


class PrometheusSink(Sink):
    """Last-value gauges and event counters behind an in-process HTTP
    `/metrics` endpoint (Prometheus text format 0.0.4). `port=0` binds an
    ephemeral port; `self.port` is the bound one. The server runs on a
    daemon thread; `write` only updates dicts under a lock."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", prefix: str = "moco"):
        self._lock = make_lock("obs.prometheus")
        self._gauges: dict[str, float] = {}
        self._events: dict[str, int] = {}
        self._hists: dict[str, dict] = {}
        self._prefix = prefix
        self.host = host
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                body = sink.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr lines
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="prometheus-metrics", daemon=True
        )
        self._thread.start()

    def write(self, step: int, payload: dict) -> None:
        rec = sanitize(gather_payload(payload))
        with self._lock:
            self._gauges[prom_name("step", self._prefix)] = int(step)
            if "event" in rec:
                self._events[str(rec["event"])] = self._events.get(str(rec["event"]), 0) + 1
            for k, v in rec.items():
                if _is_histogram(v):
                    # "serve/latency_hist" -> moco_serve_latency_ms (the
                    # bounds are milliseconds)
                    base = k[: -len("_hist")] if k.endswith("_hist") else k
                    self._hists[prom_name(base + "_ms", self._prefix)] = v
                    continue
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                self._gauges[prom_name(k, self._prefix)] = v

    def render(self) -> str:
        with self._lock:
            lines = []
            for name in sorted(self._gauges):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {self._gauges[name]}")
            for name in sorted(self._hists):
                lines.extend(_render_histogram(name, self._hists[name]))
            total = prom_name("events_total", self._prefix)
            if self._events:
                lines.append(f"# TYPE {total} counter")
                for kind in sorted(self._events):
                    lines.append(f'{total}{{kind="{kind}"}} {self._events[kind]}')
            return "\n".join(lines) + "\n"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # joined, so the bound port is free when close returns
        self._thread.join(timeout=5.0)


class MultiSink(Sink):
    """Fan one log event out to every sink. The device fetch happens ONCE
    here; the children receive host values. A failing secondary sink is
    reported and never stops the run; the primary JSONL sink's errors
    propagate."""

    def __init__(self, sinks: list[Sink], primary: Optional[JsonlSink] = None):
        self.sinks = sinks
        self.primary = primary
        self.path = primary.path if primary is not None else None
        # the Prometheus sink, when present: the training loop prints its bound
        # address
        self.prometheus: Optional[PrometheusSink] = next(
            (s for s in sinks if isinstance(s, PrometheusSink)), None
        )

    def write(self, step: int, payload: dict) -> None:
        payload = gather_payload(payload)
        for s in self.sinks:
            if s is self.primary:
                s.write(step, payload)
                continue
            try:
                s.write(step, payload)
            except Exception as e:
                print(f"WARNING: metric sink {type(s).__name__} failed: {e!r}", flush=True)

    def fsync(self) -> None:
        for s in self.sinks:
            s.fsync()

    def close(self) -> None:
        for s in self.sinks:
            s.close()


# -- registry ------------------------------------------------------------

SINK_REGISTRY: dict[str, Callable[..., Sink]] = {
    "jsonl": JsonlSink,
    "csv": CsvSink,
    "tensorboard": TensorBoardSink,
}


def register_sink(name: str, factory: Callable[..., Sink]) -> None:
    """Plug a sink in under a name `build_sinks` then accepts."""
    SINK_REGISTRY[name] = factory


def per_process_filename(base: str, process_index: int) -> str:
    """`metrics.jsonl` for process 0; `metrics.p<i>.jsonl` for the other
    processes sharing a workdir."""
    if process_index <= 0:
        return base
    stem, _, ext = base.rpartition(".")
    return f"{stem}.p{process_index}.{ext}" if stem else f"{base}.p{process_index}"


def derive_metrics_port(base_port: int, process_index: int) -> int:
    """Per-process Prometheus port: `base + process_index` (0 stays 0,
    off)."""
    return base_port + process_index if base_port else 0


def resolve_serve_port(serve_port: int, metrics_port: int = 0, process_index: int = 0) -> int:
    """Per-process serving port: `serve_port + process_index`, shifted up by
    SERVE_PORT_STRIDE when it meets this process's Prometheus port
    (`derive_metrics_port`); `serve_port=0` stays 0 (an ephemeral bind)."""
    if not serve_port:
        return 0
    resolved = serve_port + process_index
    if metrics_port and resolved == derive_metrics_port(metrics_port, process_index):
        resolved += SERVE_PORT_STRIDE
    return resolved


def build_sinks(
    spec: str,
    workdir: str,
    metrics_port: int = 0,
    metrics_host: str = "127.0.0.1",
    process_index: int = 0,
) -> MultiSink:
    """`spec` is a comma list of registry names ("jsonl,csv"). The JSONL
    sink is always included and is the MultiSink's primary.
    `metrics_port > 0` adds Prometheus text format on
    `metrics_host:(metrics_port + process_index)`. Processes > 0 write
    `*.p<i>.*` file names."""
    names = [n.strip() for n in (spec or "").split(",") if n.strip()]
    if "jsonl" not in names:
        names.insert(0, "jsonl")
    unknown = [n for n in names if n not in SINK_REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown metric sink(s) {unknown}; registered: {sorted(SINK_REGISTRY)}"
        )
    default_files = {"jsonl": "metrics.jsonl", "csv": "metrics.csv"}
    primary: Optional[JsonlSink] = None
    sinks: list[Sink] = []
    for n in names:
        if n in default_files:
            s = SINK_REGISTRY[n](
                workdir, filename=per_process_filename(default_files[n], process_index)
            )
        else:
            s = SINK_REGISTRY[n](workdir)
        if n == "jsonl":
            primary = s  # type: ignore[assignment]
        sinks.append(s)
    if metrics_port:
        sinks.append(
            PrometheusSink(port=derive_metrics_port(metrics_port, process_index),
                           host=metrics_host)
        )
    return MultiSink(sinks, primary=primary)
