"""Request-scoped tracing for the serving stack.

The `serve/*` gauges are aggregate-only: they can say p99 rose, not
WHICH request was slow, WHICH stage ate the budget (queue wait vs pad
vs AOT execute vs IVF scan vs scatter), or WHICH replica served it.
This module is the per-request answer: a :class:`RequestTrace` is
created at ingress, rides the request's future through
`server.py -> batcher.py -> engine.py -> index.py`, and collects one
stamped interval per stage of the serving waterfall:

    ingress -> queue_wait -> batch_assemble -> engine_execute
            -> index_query -> scatter -> respond

Cost discipline: a stamp is one `time.perf_counter()` read plus a list
append, collected on the batcher thread (never a client thread); the
expensive parts — JSON encoding, span emission into the Perfetto
stream, flight-recorder bookkeeping — all happen off-path on the
server's metrics-flusher thread. With tracing off no trace object
exists and every hook is a single `is None` check (the bench serving
leg measures the residual as `serve/trace_overhead_pct`).

Request ids carry replica identity (`r<replica>-<seq>`), so a merged
multi-replica Perfetto timeline and the flight-recorder dumps stay
attributable once N processes serve behind a balancer — the
precondition the ROADMAP's multi-replica item names.

A request arriving through the fleet front door additionally carries a
propagated trace context (obs/ctxprop.py): the router's 128-bit trace
id plus the span id of the dispatch attempt that sent it. Adopting that
context (``new_trace(ctx=...)``) makes this replica's stage waterfall a
CHILD of the router's attempt span — the ids ride the waterfall dict
and the emitted `request` span, which is what the offline stitcher
(scripts/trace_merge.py) and the router's in-band stitching join on.

Stage semantics (batcher-granularity stages are shared by every rider
of a micro-batch — the per-request part is queue_wait):

- `ingress`       body read + parse on the handler thread, up to submit
- `queue_wait`    submit -> the flush that carried this request began
- `batch_assemble` concat + pad of the micro-batch
- `engine_execute` AOT encoder forward (device wait included when the
                  engine collects stages; the host sleep of an injected
                  `slow@site=serve.engine_execute` fault lands here)
- `index_query`   top-k scan(s) of the EmbeddingIndex
- `scatter`       per-request row slicing up to THIS request's resolve
- `respond`       JSON encode + socket write on the handler thread

`engine_execute`/`index_query` intervals are synthesized contiguously
from the run start (the real device work interleaves per chunk); their
DURATIONS are exact, which is what the waterfall and the latency
-accounting test consume.

Deliberately stdlib-only, like obs/trace.py. The port's copy of
moco_tpu/obs/reqtrace.py: the same ids, stamps, waterfalls and spans.
"""

from __future__ import annotations

import itertools
import time

# Canonical stage order — waterfalls render and validate in this order;
# absent stages (e.g. index_query on an /embed request) simply skip.
STAGES = (
    "ingress",
    "queue_wait",
    "batch_assemble",
    "engine_execute",
    "index_query",
    "scatter",
    "respond",
)

# Virtual-thread lanes the request spans render on in Perfetto: one
# track per lane, requests round-robined so overlapping requests mostly
# land on different lanes and timestamp-containment nesting stays sane.
REQUEST_LANES = 8
REQUEST_LANE_TID_BASE = 1  # tiny ints never collide with real thread idents


class RequestTrace:
    """One request's stage-stamped waterfall (module docstring).

    `stamp()` is the only hot-path call: perf_counter pairs append to a
    plain list. Everything else (waterfall dict, stage sums, span
    records) runs off-path."""

    __slots__ = (
        "req_id", "replica", "rows", "t0", "wall_t0", "stages",
        "trace_id", "parent_span", "span_id",
    )

    def __init__(
        self, req_id: str, rows: int = 1, replica: int = 0, t0: float = None,
        ctx=None,
    ):
        self.req_id = req_id
        self.replica = int(replica)
        self.rows = int(rows)
        # `t0` backdates ingress to when the request actually arrived
        # (the HTTP handler reads the body before it knows the row
        # count, so the trace object is built after arrival)
        now = time.perf_counter()
        self.t0 = now if t0 is None else float(t0)
        self.wall_t0 = time.time() - (now - self.t0)
        self.stages: list[tuple[str, float, float]] = []
        # adopted distributed-trace identity (obs/ctxprop.TraceContext);
        # absent for requests that arrive without the fleet front door
        self.trace_id = ctx.trace_id if ctx is not None else None
        self.parent_span = ctx.span_id if ctx is not None else None
        self.span_id = None
        if ctx is not None:
            from moco_tpu_torch.obs import ctxprop

            self.span_id = ctxprop.new_span_id()

    def stamp(self, stage: str, t0: float, t1: float) -> None:
        """Record one completed stage interval (perf_counter domain)."""
        self.stages.append((stage, t0, t1))

    # -- off-path views --------------------------------------------------

    def stage_ms(self) -> dict[str, float]:
        """{stage: total ms} — repeated stamps of one stage sum."""
        out: dict[str, float] = {}
        for stage, t0, t1 in self.stages:
            out[stage] = out.get(stage, 0.0) + (t1 - t0) * 1e3
        return out

    def total_ms(self) -> float:
        """Ingress-to-last-stamp wall: the request's end-to-end time as
        the trace saw it."""
        if not self.stages:
            return 0.0
        return (max(t1 for _, _, t1 in self.stages) - self.t0) * 1e3

    def waterfall(self) -> dict:
        """JSON-ready waterfall record — the flight recorder's unit of
        storage and the dump/report format. Stage starts are ms relative
        to ingress. Requests carrying an adopted trace context include
        the distributed-trace ids — the join keys for stitching."""
        out = {
            "request_id": self.req_id,
            "replica": self.replica,
            "rows": self.rows,
            "wall_t0": self.wall_t0,
            "total_ms": round(self.total_ms(), 3),
            "stages": [
                {
                    "stage": stage,
                    "start_ms": round((t0 - self.t0) * 1e3, 3),
                    "dur_ms": round((t1 - t0) * 1e3, 3),
                }
                for stage, t0, t1 in self.stages
            ],
        }
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
            out["span_id"] = self.span_id
            if self.parent_span is not None:
                out["parent_span"] = self.parent_span
        return out


class RequestIdAllocator:
    """Monotonic replica-scoped request ids (`r<replica>-<seq>`).
    itertools.count is atomic under the GIL, so handler threads need no
    extra lock."""

    def __init__(self, replica: int = 0):
        self.replica = int(replica)
        self._seq = itertools.count()

    def new_trace(self, rows: int = 1, t0: float = None, ctx=None) -> RequestTrace:
        return RequestTrace(
            f"r{self.replica}-{next(self._seq):06d}",
            rows=rows,
            replica=self.replica,
            t0=t0,
            ctx=ctx,
        )


def emit_request_spans(tracer, trace: RequestTrace, lane: int) -> None:
    """Render one completed request onto the tracer as Perfetto spans:
    an enclosing `request` span plus one child per stage, on a virtual
    "requests" lane track (`REQUEST_LANES` round-robin). Called from the
    server's flusher thread — never the batcher or a handler thread."""
    if tracer is None or not trace.stages:
        return
    lane = lane % REQUEST_LANES
    tid = REQUEST_LANE_TID_BASE + lane
    thread = f"requests-{lane}"
    t_end = max(t1 for _, _, t1 in trace.stages)
    ids = {}
    if trace.trace_id is not None:
        ids["trace_id"] = trace.trace_id
        ids["span_id"] = trace.span_id
        if trace.parent_span is not None:
            ids["parent_span"] = trace.parent_span
    tracer.emit_span(
        "request",
        trace.t0,
        t_end,
        tid=tid,
        thread=thread,
        request_id=trace.req_id,
        rows=trace.rows,
        replica=trace.replica,
        **ids,
    )
    for stage, t0, t1 in trace.stages:
        tracer.emit_span(
            f"req/{stage}", t0, t1, tid=tid, thread=thread, request_id=trace.req_id
        )


__all__ = [
    "REQUEST_LANES",
    "RequestIdAllocator",
    "RequestTrace",
    "STAGES",
    "emit_request_spans",
]
