"""Trace-context propagation for the serving fleet (router -> replica).

A request that crosses the fleet front door produces spans in TWO
processes: the router's dispatch taxonomy (serve/router.py) and the
replica's stage waterfall (obs/reqtrace.py). Without a shared identity
they are two disconnected timelines. This module is the identity layer:

- a **trace id** — 128 bits, hex, minted once per client request at the
  router's ingress (or adopted verbatim from a client that already
  carries one), identical across every hop of the request;
- a **span id** — 64 bits, hex, minted per span; the router mints one
  per dispatch *attempt* and sends it downstream, so the replica's
  request span can name its exact parent (which attempt of which retry
  round carried it — not just "some router request").

On the wire the pair rides two headers, optional for plain clients and
adopted by the /embed and /neighbors handlers:

    X-Trace-Id:    32 hex chars (the trace)
    X-Parent-Span: 16 hex chars (the sender's span)

`parse()` is the receiving side (strict: a malformed id is ignored, the
request is served untraced rather than rejected — tracing must never
fail a request). `inject()` is the sending side. JAX's `extract` and its
contract-coverage hook come with the port's static analysis.

Stdlib-only, like every obs module: the port's copy of
moco_tpu/obs/ctxprop.py. The port's server adopts a context (`parse`); the
fleet router (serve/router.py) mints trace ids (`new_trace_id`) and sends
one span per dispatch attempt (`inject`).
"""

from __future__ import annotations

import os
from typing import Optional

TRACE_ID_HEADER = "X-Trace-Id"
PARENT_SPAN_HEADER = "X-Parent-Span"
TRACE_HEADERS = (TRACE_ID_HEADER, PARENT_SPAN_HEADER)

TRACE_ID_HEX_LEN = 32  # 128-bit trace id
SPAN_ID_HEX_LEN = 16  # 64-bit span id

_HEX = set("0123456789abcdef")


def new_trace_id() -> str:
    """A fresh trace id: the fleet router mints one when no upstream
    context arrives (serve/router.py)."""
    return os.urandom(TRACE_ID_HEX_LEN // 2).hex()


def new_span_id() -> str:
    return os.urandom(SPAN_ID_HEX_LEN // 2).hex()


def _valid_hex(value, length: int) -> bool:
    return (
        isinstance(value, str)
        and len(value) == length
        and set(value) <= _HEX
    )


class TraceContext:
    """One hop's view of the propagated context: the request's trace id
    plus the span id of the SENDER (i.e. the receiver's parent span)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext(trace_id={self.trace_id!r}, span_id={self.span_id!r})"


def parse(trace_id, parent_span=None) -> Optional[TraceContext]:
    """Receiving side: header values -> context, or None when the trace
    id is absent/malformed (the request is served untraced — propagation
    must never reject traffic). A malformed parent span degrades to a
    parentless context rather than dropping the trace."""
    if not _valid_hex(trace_id, TRACE_ID_HEX_LEN):
        return None
    span = parent_span if _valid_hex(parent_span, SPAN_ID_HEX_LEN) else None
    _record_header(TRACE_ID_HEADER)
    if span is not None:
        _record_header(PARENT_SPAN_HEADER)
    return TraceContext(trace_id, span)


def inject(headers: dict, ctx: TraceContext) -> dict:
    """Sending side: stamp the context onto an outbound header dict
    (mutated AND returned). `ctx.span_id` must be the span the receiver
    should parent under — for the router that is the dispatch-attempt
    span, not the request span."""
    headers[TRACE_ID_HEADER] = ctx.trace_id
    _record_header(TRACE_ID_HEADER)
    if ctx.span_id is not None:
        headers[PARENT_SPAN_HEADER] = ctx.span_id
        _record_header(PARENT_SPAN_HEADER)
    return headers


# The contract-coverage recorder's hook (analysis/contracts.py): each
# header parsed or injected is reported. One None check when off.
_COVERAGE_CB = None


def set_coverage_callback(cb) -> None:
    """Install (or clear, with None) the `cb(header_name)` callback."""
    global _COVERAGE_CB
    _COVERAGE_CB = cb


def _record_header(name: str) -> None:
    cb = _COVERAGE_CB
    if cb is not None:
        cb(name)


__all__ = [
    "PARENT_SPAN_HEADER",
    "SPAN_ID_HEX_LEN",
    "TRACE_HEADERS",
    "TRACE_ID_HEADER",
    "TRACE_ID_HEX_LEN",
    "TraceContext",
    "inject",
    "new_span_id",
    "parse",
    "set_coverage_callback",
]
