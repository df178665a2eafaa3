"""Hierarchical span tracer with Chrome-trace (Perfetto) export: the port's
copy of moco_tpu/obs/trace.py (stdlib only; the same records and events).

The reference has no timing observability beyond `AverageMeter` console
lines; `torch.profiler` traces exist but capture device ops, not the
host-side structure of a training run (where did the wall time of epoch
7 go — input wait, dispatch, checkpoint write, kNN eval?). This tracer
answers that question with nested spans:

    with obs.span("epoch", epoch=3):
        with obs.span("data_wait"):
            batch = next(it)
        with obs.span("step"):
            state, metrics = step_fn(state, batch, rng)

Spans are recorded per-thread (the prefetch producer's `host_decode`
spans land on their own track) and written in two forms:

- a streaming JSONL file (one object per completed span, flushed as
  written — a SIGKILL loses at most the span being formatted), and
- `export_chrome(path)`: a Chrome trace-event JSON (`ph: "X"` complete
  events, microsecond timestamps) viewable in Perfetto / about:tracing,
  where nesting is rendered from timestamp containment per thread.

Deliberately stdlib-only (no torch import): the tracer must be usable
from any host-side module — data loaders, checkpoint I/O, report
scripts — without dragging a backend in.

Thread safety: completed spans append under a lock; the open-span stack
is thread-local, so concurrent threads can't corrupt each other's
nesting. The in-memory span list is bounded (`max_spans`); the JSONL
stream is not (every span always reaches the file).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from moco_tpu_torch.utils.locks import make_lock


class _NullSpan:
    """Reusable no-op context manager — the zero-cost path when no
    tracer is installed (hot loops call `span()` unconditionally)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCM:
    """Context manager for one live span: records ts on enter, emits the
    completed event on exit (even when the body raises)."""

    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self.tracer._stack().append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = self.tracer._stack()
        stack.pop()
        self.tracer._emit(self.name, self.t0, t1, len(stack), self.args, exc_type)
        return False


class Tracer:
    """Collects hierarchical spans; see the module docstring.

    `jsonl_path`: stream completed spans there as they close (None =
    in-memory only). `max_spans` bounds the in-memory list used by
    `export_chrome` — past it, new spans still stream to JSONL but the
    Chrome export notes the drop count instead of growing unboundedly.
    """

    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        max_spans: int = 200_000,
        process_index: int = 0,
    ):
        self._lock = make_lock("obs.trace")
        self._local = threading.local()
        self._spans: list[dict] = []
        self._dropped = 0
        self.max_spans = max_spans
        # multi-process runs tag every span with the process index so
        # scripts/trace_merge.py can stitch per-host streams into one
        # Perfetto file with a track per host
        self.process_index = int(process_index)
        # perf_counter origin so ts starts near 0 (Perfetto-friendly);
        # wall-clock anchor recorded for post-hoc correlation with
        # metrics.jsonl `time` fields.
        self._t0 = time.perf_counter()
        self.wall_t0 = time.time()
        self.jsonl_path = jsonl_path
        self._f = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._f = open(jsonl_path, "a", buffering=1)

    # -- recording -------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **args) -> _SpanCM:
        return _SpanCM(self, name, args)

    def _emit(self, name, t0, t1, depth, args, exc_type) -> None:
        rec = {
            "name": name,
            "ts": round((t0 - self._t0) * 1e6, 1),  # µs, trace-relative
            "dur": round((t1 - t0) * 1e6, 1),
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            "depth": depth,
            "p": self.process_index,
        }
        if args:
            rec["args"] = args
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self._dropped += 1
            if self._f is not None and not self._f.closed:
                self._f.write(json.dumps(rec) + "\n")

    def emit_span(
        self,
        name: str,
        t0: float,
        t1: float,
        tid: Optional[int] = None,
        thread: Optional[str] = None,
        **args,
    ) -> None:
        """Record a completed span from EXPLICIT perf_counter stamps,
        optionally onto a virtual track (`tid`/`thread` override). This
        is the off-thread emission path: the serving stack stamps
        request stages on its batcher thread (obs/reqtrace.py) and a
        flusher thread renders them here later — `span()`'s
        enter/exit-on-the-current-thread contract can't express that."""
        rec = {
            "name": name,
            "ts": round((t0 - self._t0) * 1e6, 1),
            "dur": round((t1 - t0) * 1e6, 1),
            "tid": threading.get_ident() if tid is None else int(tid),
            "thread": thread or threading.current_thread().name,
            "depth": 0,
            "p": self.process_index,
        }
        if args:
            rec["args"] = args
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self._dropped += 1
            if self._f is not None and not self._f.closed:
                self._f.write(json.dumps(rec) + "\n")

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (checkpoint committed, fault
        injected, ...) — renders as an arrow in Perfetto."""
        t = time.perf_counter()
        self._emit(name, t, t, len(self._stack()), {**args, "instant": True}, None)

    def counter(self, name: str, **values) -> None:
        """Numeric time series (Chrome `ph:"C"` counter events): the
        device prefetch ring charts its live staged depth this way, so
        Perfetto shows the input pipeline filling/draining against the
        step spans. `values` are the series of one counter track."""
        rec = {
            "name": name,
            "ts": round((time.perf_counter() - self._t0) * 1e6, 1),
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            "p": self.process_index,
            "counter": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self._dropped += 1
            if self._f is not None and not self._f.closed:
                self._f.write(json.dumps(rec) + "\n")

    # -- export ----------------------------------------------------------

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def export_chrome(self, path: str) -> str:
        """Write the Chrome trace-event JSON; returns `path`. pid is the
        PROCESS INDEX (not the OS pid), so merged multi-process traces
        get one track group per host."""
        events = spans_to_chrome_events(self.snapshot(), pid=self.process_index)
        meta = {
            "wall_t0": self.wall_t0,
            "process_index": self.process_index,
            "dropped_spans": self._dropped,
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms", "otherData": meta},
                f,
            )
        return path

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.flush()
            self._f.close()


def spans_to_chrome_events(
    spans: list[dict],
    pid: int = 0,
    process_name: Optional[str] = None,
    ts_offset_us: float = 0.0,
) -> list[dict]:
    """Span records -> Chrome trace-event list (`ph:"X"` complete events
    plus thread-name metadata). Shared by the live tracer,
    `scripts/obs_report.py`'s rebuild-from-JSONL path, and
    `scripts/trace_merge.py` (which passes a per-host `ts_offset_us`
    clock correction and a `process_name` track label)."""
    events: list[dict] = []
    if process_name is not None:
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": process_name},
            }
        )
    thread_names: dict[int, str] = {}
    for s in spans:
        tid = s.get("tid", 0)
        thread_names.setdefault(tid, s.get("thread", f"thread-{tid}"))
        if "counter" in s:  # numeric series -> Chrome counter track
            events.append(
                {
                    "name": s["name"],
                    "ph": "C",
                    "ts": s["ts"] + ts_offset_us,
                    "pid": pid,
                    "tid": tid,
                    "args": s["counter"],
                }
            )
            continue
        ev = {
            "name": s["name"],
            "ph": "X",
            "ts": s["ts"] + ts_offset_us,
            "dur": s.get("dur", 0),
            "pid": pid,
            "tid": tid,
        }
        args = dict(s.get("args") or {})
        if "error" in s:
            args["error"] = s["error"]
        if args:
            ev["args"] = args
        events.append(ev)
    for tid, name in thread_names.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )
    return events


# -- module-level current tracer (the wiring mechanism) -------------------
#
# Pipelines, checkpointing, and kNN eval call `obs.span(...)` without a
# tracer in hand; the train driver installs one for the run's duration.
# When none is installed the call returns a shared no-op context manager
# (one attribute read + one call — cheap enough for per-batch sites).

_tracer: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with None) the process-wide tracer; returns
    the previous one so callers can restore it."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _tracer


def span(name: str, **args):
    t = _tracer
    return t.span(name, **args) if t is not None else _NULL_SPAN


def instant(name: str, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **args)


def counter(name: str, **values) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, **values)
