"""The serving fleet's front door, the port of moco_tpu/serve/router.py:
a fault-tolerant HTTP router over N replicas (`ServeServer` processes,
usually spawned by serve/fleet.py's ReplicaSupervisor).

Standard library HTTP as serve/server.py, with four front-door behaviours:

- **Health- and load-aware dispatch.** A poller thread reads each
  replica's `/healthz` and `/stats`; a request goes to the admitted
  (healthy, not draining) replica with the fewest dispatches in flight.
- **A circuit breaker per replica.** `fail_threshold` consecutive
  transport or 5xx failures trip a replica open; after a cooldown that
  doubles with each trip (capped) one half-open probe request is let
  through, and its outcome closes or re-trips the breaker.
- **Bounded retry and hedging.** `/embed` and `/neighbors` are
  idempotent: a failed dispatch is re-routed through utils/retry.py
  (sites `router.embed` / `router.neighbors`), and a request that
  outlives the p99-derived hedge delay is sent to a second replica, the
  first success winning (`hedges` / `hedge_wins`; the loser's cost lands
  in `hedge_wasted_ms`, never in the latency histogram).
- **Load shedding and graceful drain.** Past `max_inflight` concurrent
  requests the router answers 503 with `Retry-After` (counted, and it
  burns error budget). `POST /admin/drain?replica=i` stops dispatch to i,
  waits out its requests in flight, restarts it through the supervisor
  (SIGTERM drains the replica's batcher, respawn, warm re-ingest) and
  re-admits it once healthy.

Endpoints: `POST /embed`, `POST /neighbors` (proxied; the answer gains
`"replica": i` beside the replica's own `request_id`, and `trace_id`),
`GET /healthz` (`{"ok", "replicas", "replicas_healthy"}`), `GET /stats`
(the `fleet_serve/*` line), `GET /admin/replicas` (each replica's
snapshot: `serve_ingest --fanout` finds the replicas here), `GET
/debug/flight` (the fleet flight ring), `POST
/admin/drain?replica=i[&restart=0]` (202 `{"accepted", "replica"}`),
`POST /admin/undrain?replica=i` (200) and `POST
/admin/promote?replica=i&ckpt_dir=<path>` (202; 409 without a
supervisor): one staged-rollout step, the supervisor's checkpoint dir
retargeted and the replica drained and restarted onto it
(serve/promote.py drives it replica by replica). A bad or missing
replica index is a 400. `fleet_serve/model_skew` counts the distinct
served model digests less one.

The router's own client-observed `SLOBurnTracker` exports
`fleet_serve/burn_rate_<w>s`; each replica's `serve/burn_rate_<w>s`,
`serve/fresh_burn_rate_<w>s` and `serve/recall_estimate` are aggregated
min / mean / max beside the replica count, dispatches per replica and
the hedge, retry, shed and breaker counters.

Distributed tracing: each proxied request gets a `RouterRequestTrace`
(ingress, admission and respond stamps, and one record per dispatch
attempt: replica, retry round, primary or hedge lane, breaker state,
outcome). Each attempt mints a span id and sends `X-Trace-Id` /
`X-Parent-Span` (obs/ctxprop.py); the replica's waterfall comes back in
band as the answer's `trace` block, so the router holds the whole
request without an offline merge: the network split around the
replica's own total, every failed attempt, a hedge loser's cancelled
lane. The stitched trace feeds the fleet flight ring (dumped at a burn
alert's firing edge and on `GET /debug/flight`), obs/critpath.py (the
`fleet_serve/critpath_<hop>_ms` family) and, with a workdir, the
router's Perfetto stream `trace_events.r<i>.jsonl` anchored by
`heartbeat.r<i>.json`, which scripts/trace_merge.py joins with the
replicas' streams by trace id.

Threading: one fleet lock (`router.fleet`) guards every replica handle
and breaker, and one metrics lock (`router.metrics`) sits inside
RouterMetrics; the two never nest, and no network I/O happens under
either. The health poller, the metrics flusher and the single drain
worker are joined in `close()`.
"""

from __future__ import annotations

import concurrent.futures
import http.server
import itertools
import json
import os
import queue
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import Counter, deque
from typing import Optional

from moco_tpu_torch.analysis.contracts import record_route
from moco_tpu_torch.obs import critpath, ctxprop
from moco_tpu_torch.obs.alerts import AlertEngine, parse_rules
from moco_tpu_torch.obs.flight import FlightRecorder
from moco_tpu_torch.obs.reqtrace import REQUEST_LANE_TID_BASE, REQUEST_LANES
from moco_tpu_torch.obs.slo import DEFAULT_WINDOWS, SLOBurnTracker, serve_alert_spec
from moco_tpu_torch.obs.trace import Tracer
from moco_tpu_torch.serve.server import _QuietHTTPServer
from moco_tpu_torch.utils import retry as retry_mod
from moco_tpu_torch.utils.locks import make_lock

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class ReplicaAttemptError(OSError):
    """One dispatch attempt failed (transport error, timeout, or a 5xx
    from the replica). An OSError so the `utils/retry.py` default
    `retry_on` covers it — the request is idempotent, re-route it."""


class ReplicaUnavailableError(OSError):
    """No admitted replica could take (or answer) the request this
    round. Also an OSError: the retry layer backs off and re-polls the
    fleet, because a replica may be seconds from rejoining."""


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probe recovery.

    NOT internally locked: the router serializes every call under its
    fleet lock (one lock for all fleet state — no order to invert).
    `try_acquire()` both asks AND claims: in OPEN past the cooldown it
    transitions to HALF_OPEN and hands the caller the single probe
    slot, so two racing dispatchers cannot double-probe. Cooldown grows
    exponentially with consecutive trips (capped) and resets on any
    recovery. `now` is injectable for tests.
    """

    def __init__(
        self,
        fail_threshold: int = 3,
        cooldown_s: float = 2.0,
        cooldown_cap_s: float = 30.0,
        now=time.monotonic,
    ):
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self._now = now
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self.trips = 0  # lifetime trip count (fleet_serve/breaker_trips)
        self._trip_streak = 0  # trips since the last recovery → backoff
        self._open_until = 0.0
        self._probe_inflight = False

    def try_acquire(self) -> bool:
        """May the caller dispatch to this replica right now? Claims
        the half-open probe slot when it says yes from OPEN."""
        if self.state == BREAKER_CLOSED:
            return True
        if self.state == BREAKER_OPEN:
            if self._now() >= self._open_until:
                self.state = BREAKER_HALF_OPEN
                self._probe_inflight = True
                return True
            return False
        # HALF_OPEN: exactly one probe at a time
        if not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def record_success(self) -> None:
        if self.state == BREAKER_OPEN:
            # a straggler from before the trip; recovery goes through
            # the half-open probe, not a stale success
            return
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self._trip_streak = 0
        self._probe_inflight = False

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == BREAKER_HALF_OPEN:
            self._probe_inflight = False
            self._trip()
        elif (
            self.state == BREAKER_CLOSED
            and self.consecutive_failures >= self.fail_threshold
        ):
            self._trip()

    def reset(self) -> None:
        """Back to pristine CLOSED — the router calls this when a
        drained replica is re-admitted after a supervised restart."""
        self.state = BREAKER_CLOSED
        self.consecutive_failures = 0
        self._trip_streak = 0
        self._probe_inflight = False

    def _trip(self) -> None:
        self.state = BREAKER_OPEN
        self.trips += 1
        self._trip_streak += 1
        cooldown = min(
            self.cooldown_cap_s, self.cooldown_s * (2 ** (self._trip_streak - 1))
        )
        self._open_until = self._now() + cooldown


class ReplicaHandle:
    """Router-side state for one replica. Every field is read and
    written ONLY under the router's fleet lock."""

    def __init__(self, index: int, url: str, breaker: CircuitBreaker):
        self.index = int(index)
        self.url = url.rstrip("/")
        self.breaker = breaker
        self.healthy = False
        self.warm = False
        self.draining = False
        self.drain_phase: Optional[str] = None
        self.inflight = 0
        self.dispatched = 0
        self.stats: dict = {}  # last /stats payload the poller saw

    @property
    def admitted(self) -> bool:
        return self.healthy and not self.draining

    def snapshot(self) -> dict:
        return {
            "index": self.index,
            "url": self.url,
            "healthy": self.healthy,
            "warm": self.warm,
            "draining": self.draining,
            "drain_phase": self.drain_phase,
            "breaker": self.breaker.state,
            "breaker_trips": self.breaker.trips,
            "inflight": self.inflight,
            "dispatched": self.dispatched,
            # served-model identity from the last /stats poll: the
            # version-skew gauge and the promotion rollout both watch
            # these (None until the poller has seen the replica)
            "model_step": self.stats.get("serve/model_step"),
            "model_digest": self.stats.get("serve/model_digest"),
        }


class RouterRequestTrace:
    """One proxied request's distributed trace, router side: the
    ingress/admission/respond stamps plus a record per dispatch attempt
    (obs/critpath.py stitched schema is `stitched()`'s output).

    Threading: the handler thread creates the trace and its attempt
    records; each attempt is FINALIZED on the dispatch-pool thread that
    ran it (`outcome` is written last, so any reader seeing a non-
    "pending" outcome sees a complete record); the router's flusher
    reads completed traces. Same GIL-atomic append/assign discipline as
    obs/reqtrace.py — no per-request lock."""

    __slots__ = (
        "trace_id", "span_id", "parent_span", "path", "t0", "wall_t0",
        "ingress_ms", "admission_ms", "respond_ms", "status",
        "request_id", "t_end", "attempts", "_round",
    )

    def __init__(self, path: str, t0: float, ctx=None):
        now = time.perf_counter()
        self.t0 = float(t0)
        self.wall_t0 = time.time() - (now - self.t0)
        self.path = path
        # adopt a client-carried trace id (an upstream gateway);
        # otherwise the router is the trace root and mints one
        self.trace_id = ctx.trace_id if ctx is not None else ctxprop.new_trace_id()
        self.parent_span = ctx.span_id if ctx is not None else None
        self.span_id = ctxprop.new_span_id()
        self.ingress_ms = None
        self.admission_ms = None
        self.respond_ms = None
        self.status = None
        self.request_id = None
        self.t_end = None
        self.attempts: list[dict] = []
        self._round = 0

    def next_round(self) -> int:
        """The retry-round index for the next `_attempt_hedged` call —
        handler-thread only (retry rounds are sequential)."""
        rnd = self._round
        self._round += 1
        return rnd

    def new_attempt(self, replica: int, retry_index: int, lane: str,
                    breaker: str) -> dict:
        att = {
            "trace_id": self.trace_id,
            "span_id": ctxprop.new_span_id(),
            "replica": int(replica),
            "retry_index": int(retry_index),
            "lane": lane,  # "primary" | "hedge"
            "breaker": breaker,  # breaker state at acquisition
            "origin_t0": self.t0,  # perf_counter origin for start_ms
            "t0": None, "t1": None,  # perf_counter, set by the dispatcher
            "start_ms": None, "dur_ms": None,
            "net_send_ms": None, "net_recv_ms": None,
            "wasted_ms": None,  # a discarded hedge lane's cost
            "winner": False,
            "remote": None,  # the replica's in-band stage waterfall
            "error": None,
            "outcome": "pending",  # -> ok | failed | cancelled; set LAST
        }
        self.attempts.append(att)
        return att

    def done(self, status: int, request_id=None) -> None:
        self.t_end = time.perf_counter()
        self.status = int(status)
        self.request_id = request_id

    def complete(self) -> bool:
        """Every attempt finalized (a hedge loser may still be in
        flight after the client got its answer)."""
        return all(a["outcome"] != "pending" for a in self.attempts)

    def total_ms(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return (end - self.t0) * 1e3

    def stitched(self) -> dict:
        """The obs/critpath.py stitched-trace record (private perf-
        counter fields stripped)."""
        attempts = []
        for a in self.attempts:
            pub = {k: v for k, v in a.items()
                   if k not in ("origin_t0", "t0", "t1")}
            attempts.append(pub)
        return {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "path": self.path,
            "status": self.status,
            "wall_t0": self.wall_t0,
            "total_ms": round(self.total_ms(), 3),
            "router": {
                "ingress_ms": self.ingress_ms,
                "admission_ms": self.admission_ms,
                "respond_ms": self.respond_ms,
            },
            "attempts": attempts,
        }


def _emit_router_spans(tracer, rtrace: RouterRequestTrace, lane: int) -> None:
    """Render one completed router trace onto the Perfetto stream: a
    `request` parent, the router stage children, and one
    `router/attempt` span per dispatch lane (with its net send/recv
    split when the replica's waterfall came back). Runs on the flusher
    thread; the `request` lanes round-robin like obs/reqtrace.py."""
    if tracer is None:
        return
    lane = lane % REQUEST_LANES
    tid = REQUEST_LANE_TID_BASE + lane
    thread = f"requests-{lane}"
    t_end = rtrace.t_end if rtrace.t_end is not None else time.perf_counter()
    tracer.emit_span(
        "request",
        rtrace.t0,
        t_end,
        tid=tid,
        thread=thread,
        trace_id=rtrace.trace_id,
        span_id=rtrace.span_id,
        path=rtrace.path,
        status=rtrace.status,
        request_id=rtrace.request_id,
    )
    cursor = rtrace.t0
    for name, ms in (("router/ingress", rtrace.ingress_ms),
                     ("router/admission", rtrace.admission_ms)):
        if ms is None:
            continue
        tracer.emit_span(name, cursor, cursor + ms / 1e3, tid=tid,
                         thread=thread, trace_id=rtrace.trace_id)
        cursor += ms / 1e3
    for att in rtrace.attempts:
        if att["t0"] is None:
            continue
        t1 = att["t1"] if att["t1"] is not None else t_end
        tracer.emit_span(
            "router/attempt",
            att["t0"],
            t1,
            tid=tid,
            thread=thread,
            trace_id=rtrace.trace_id,
            span_id=att["span_id"],
            replica=att["replica"],
            retry_index=att["retry_index"],
            lane=att["lane"],
            breaker=att["breaker"],
            outcome=att["outcome"],
            winner=att["winner"],
            wasted_ms=att["wasted_ms"],
            error=att["error"],
        )
        if att["net_send_ms"] is not None:
            tracer.emit_span(
                "router/net_send", att["t0"],
                att["t0"] + att["net_send_ms"] / 1e3,
                tid=tid, thread=thread, trace_id=rtrace.trace_id,
            )
        if att["net_recv_ms"] is not None and att["t1"] is not None:
            tracer.emit_span(
                "router/net_recv", att["t1"] - att["net_recv_ms"] / 1e3,
                att["t1"],
                tid=tid, thread=thread, trace_id=rtrace.trace_id,
            )
    if rtrace.respond_ms is not None:
        tracer.emit_span(
            "router/respond", t_end - rtrace.respond_ms / 1e3, t_end,
            tid=tid, thread=thread, trace_id=rtrace.trace_id,
        )


def _finalize_attempt(
    attempt: Optional[dict], outcome: str, error: Optional[str] = None,
    remote: Optional[dict] = None, t_wall0: Optional[float] = None,
) -> None:
    """Close out one attempt record on the dispatch thread that ran it.
    With the replica's in-band waterfall (`remote`) the wall clocks
    split the attempt into network send (our send wall -> the replica's
    wall_t0) and receive (whatever the replica's own total cannot
    explain — its post-response respond write and the socket read land
    here). `outcome` is written LAST (the reader contract)."""
    if attempt is None:
        return
    t1 = time.perf_counter()
    attempt["t1"] = t1
    dur = (t1 - (attempt["t0"] or t1)) * 1e3
    attempt["dur_ms"] = round(dur, 3)
    if remote is not None and isinstance(remote, dict):
        attempt["remote"] = {
            "request_id": remote.get("request_id"),
            "replica": remote.get("replica"),
            "span_id": remote.get("span_id"),
            "stages": remote.get("stages") or [],
        }
        rw0 = remote.get("wall_t0")
        if t_wall0 is not None and isinstance(rw0, (int, float)):
            send = max(0.0, (rw0 - t_wall0) * 1e3)
            attempt["net_send_ms"] = round(send, 3)
            rtot = max(0.0, float(remote.get("total_ms") or 0.0))
            attempt["net_recv_ms"] = round(max(0.0, dur - send - rtot), 3)
    attempt["error"] = error
    attempt["outcome"] = outcome


class RouterMetrics:
    """Thread-safe router gauges; `payload()` is the `fleet_serve/*`
    core (the router's OWN client-observed latency/burn — the
    per-replica aggregation joins in FleetRouter.stats())."""

    def __init__(
        self,
        slo_ms: float,
        objective: float = 0.99,
        windows=DEFAULT_WINDOWS,
        window: int = 2048,
    ):
        self.slo_ms = float(slo_ms)
        self._lock = make_lock("router.metrics")
        self.burn = SLOBurnTracker(slo_ms, objective=objective, windows=windows)
        self._latencies_ms: deque = deque(maxlen=window)
        self._counters: Counter = Counter()
        self._completed = 0
        self._win_completed = 0
        self._win_t0 = time.perf_counter()
        # recent critical-path attributions (obs/critpath.py) — the
        # aggregation window behind fleet_serve/critpath_<hop>_ms
        self._critpath: deque = deque(maxlen=512)

    def count(self, name: str, n=1) -> None:
        with self._lock:
            self._counters[name] += n

    def record_request(self, latency_s: float, ok: bool) -> None:
        # NOTE: only CLIENT-OBSERVED completions land here — a
        # cancelled hedge lane's latency must never enter the p99
        # histogram it exists to protect (it is accounted in the
        # hedge_wasted_ms counter instead)
        ms = latency_s * 1e3
        with self._lock:
            self._latencies_ms.append(ms)
            self._completed += 1
            self._win_completed += 1
        self.burn.record(ok and ms <= self.slo_ms)

    def record_critpath(self, attribution: dict) -> None:
        with self._lock:
            self._critpath.append(attribution)

    def record_failure(self) -> None:
        """A request the fleet failed (retries exhausted) or shed —
        burns error budget; never a silent drop."""
        self.burn.record(False)

    def p99_ms(self) -> Optional[float]:
        with self._lock:
            lat = sorted(self._latencies_ms)
        if not lat:
            return None
        return lat[min(int(0.99 * (len(lat) - 1) + 0.5), len(lat) - 1)]

    def payload(self) -> dict:
        with self._lock:
            now = time.perf_counter()
            dt = max(now - self._win_t0, 1e-9)
            qps = self._win_completed / dt
            self._win_t0, self._win_completed = now, 0
            lat = sorted(self._latencies_ms)
            pct = lambda p: (
                lat[min(int(p * (len(lat) - 1) + 0.5), len(lat) - 1)] if lat else None
            )
            counters = dict(self._counters)
            completed = self._completed
            attrs = list(self._critpath)
            out = {
                "fleet_serve/requests": completed,
                "fleet_serve/qps": qps,
                "fleet_serve/p50_ms": pct(0.50),
                "fleet_serve/p99_ms": pct(0.99),
                "fleet_serve/slo_ms": self.slo_ms,
            }
        for name in (
            "hedges",
            "hedge_wins",
            "shed",
            "failed",
            "drains",
            # staged-rollout steps accepted (promote_replica): the
            # promotion audit trail's fleet-side counter
            "promotions",
        ):
            out[f"fleet_serve/{name}"] = counters.get(name, 0)
        # hedge-loser accounting: the cumulative cost of every cancelled
        # lane (the latency that used to vanish with the discarded
        # response)
        out["fleet_serve/hedge_wasted_ms"] = round(
            float(counters.get("hedge_wasted_ms", 0.0)), 3
        )
        # the burn family under the fleet prefix: the ROUTER's own
        # client-observed burn — the chaos leg's acceptance gauge
        for k, v in self.burn.payload().items():
            out["fleet_serve/" + k.split("/", 1)[1]] = v
        agg = critpath.aggregate(attrs)
        if agg["traces"]:
            out.update(critpath.metrics_payload(agg))
        return out


class FleetRouter:
    """The fleet front door (module docstring). `replica_urls` lists
    the replica base URLs; alternatively pass a started
    `ReplicaSupervisor` and the URLs are taken from it (and drain can
    restart replicas). `port=0` binds ephemeral; `self.port` is real.
    """

    def __init__(
        self,
        replica_urls=None,
        supervisor=None,
        host: str = "127.0.0.1",
        port: int = 0,
        slo_ms: float = 1000.0,
        slo_objective: float = 0.99,
        burn_windows=DEFAULT_WINDOWS,
        sink=None,
        metrics_flush_s: float = 1.0,
        health_interval_s: float = 0.5,
        health_timeout_s: float = 2.0,
        replica_timeout_s: float = 30.0,
        retry_attempts: int = 3,
        retry_base_delay_s: float = 0.05,
        retry_max_delay_s: float = 1.0,
        hedge: bool = True,
        hedge_min_ms: float = 250.0,
        hedge_p99_factor: float = 1.0,
        max_inflight: int = 64,
        shed_retry_after_s: float = 1.0,
        breaker_fail_threshold: int = 3,
        breaker_cooldown_s: float = 2.0,
        breaker_cooldown_cap_s: float = 30.0,
        drain_timeout_s: float = 60.0,
        readmit_timeout_s: float = 300.0,
        workdir: str = None,
        router_index: int = 0,
        reqtrace: bool = True,
        flight_requests: int = 256,
        alert_spec: str = "fleet_default",
    ):
        if replica_urls is None:
            if supervisor is None:
                raise ValueError("need replica_urls or a supervisor")
            replica_urls = supervisor.urls()
        if not replica_urls:
            raise ValueError("a fleet needs at least one replica")
        self._supervisor = supervisor
        self.health_interval_s = float(health_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.replica_timeout_s = float(replica_timeout_s)
        self.retry_attempts = int(retry_attempts)
        self.retry_base_delay_s = float(retry_base_delay_s)
        self.retry_max_delay_s = float(retry_max_delay_s)
        self.hedge = bool(hedge)
        self.hedge_min_ms = float(hedge_min_ms)
        self.hedge_p99_factor = float(hedge_p99_factor)
        self.max_inflight = int(max_inflight)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.readmit_timeout_s = float(readmit_timeout_s)
        self.metrics = RouterMetrics(
            slo_ms, objective=slo_objective, windows=burn_windows
        )
        self._sink = sink
        # distributed-tracing consumers (module docstring): the fleet
        # flight ring of stitched multi-hop waterfalls, the burn-rate
        # alert engine that dumps it at the firing edge, and the
        # per-router Perfetto stream when a workdir is given
        self.workdir = workdir
        self.router_index = int(router_index)
        self._reqtrace = bool(reqtrace)
        self.flight = FlightRecorder(
            max_requests=flight_requests, replica=self.router_index
        )
        spec = (
            serve_alert_spec(
                slo_ms, windows=self.metrics.burn.windows, prefix="fleet_serve"
            )
            if alert_spec == "fleet_default"
            else alert_spec
        )
        self._alerts = (
            AlertEngine(
                parse_rules(spec),
                workdir=workdir,
                process_index=self.router_index,
                on_fire=self._on_alert,
            )
            if spec
            else None
        )
        self._tracer = None
        if workdir and self._reqtrace:
            self._tracer = Tracer(
                jsonl_path=os.path.join(
                    workdir, f"trace_events.r{self.router_index}.jsonl"
                ),
                process_index=self.router_index,
            )
            self._write_router_anchor()
        # completed router traces awaiting stitching + span emission —
        # drained by the metrics flusher (bounded: a stalled flusher
        # degrades to dropped traces, never unbounded memory)
        self._trace_pending: deque = deque(maxlen=4 * flight_requests)
        # itertools.count is GIL-atomic: the flusher and a
        # /debug/flight handler may drain traces concurrently
        self._lane = itertools.count()
        self._flush_step = 0
        # ONE lock for all fleet state (handles + breakers + the
        # admission counter): no per-replica locks, no order to invert
        self._fleet_lock = make_lock("router.fleet")
        self._replicas = [
            ReplicaHandle(
                i,
                url,
                CircuitBreaker(
                    fail_threshold=breaker_fail_threshold,
                    cooldown_s=breaker_cooldown_s,
                    cooldown_cap_s=breaker_cooldown_cap_s,
                ),
            )
            for i, url in enumerate(replica_urls)
        ]
        self._active = 0  # router-wide in-flight count (shed budget)
        # dispatch pool: primary + hedge attempts run here so the
        # handler thread can time out the primary without abandoning it
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2 * self.max_inflight + 4,
            thread_name_prefix="router_dispatch",
        )
        self._stop = threading.Event()
        self._drain_q: queue.Queue = queue.Queue()
        # one synchronous poll before serving: dispatch works from the
        # first request instead of waiting out a poller interval
        self._poll_health()
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?")[0]
                record_route("GET", path)
                if path == "/healthz":
                    with server._fleet_lock:
                        healthy = sum(1 for r in server._replicas if r.admitted)
                        total = len(server._replicas)
                    self._json(200, {
                        "ok": healthy > 0,
                        "replicas": total,
                        "replicas_healthy": healthy,
                    })
                elif path == "/stats":
                    self._json(200, server.stats())
                elif path == "/admin/replicas":
                    with server._fleet_lock:
                        snaps = [r.snapshot() for r in server._replicas]
                    self._json(200, {"replicas": snaps})
                elif path == "/debug/flight":
                    # on-demand fleet flight dump: the ring of stitched
                    # multi-hop waterfalls (the router-side twin of the
                    # replica's /debug/flight)
                    server._drain_traces()
                    body = server.flight.snapshot()
                    if server.workdir:
                        body["dump_path"] = server.flight.dump(
                            server.workdir, reason="debug_request",
                            extra={
                                "slo_ms": server.metrics.slo_ms,
                                "role": "router",
                            },
                        )
                    self._json(200, body)
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                t0 = time.perf_counter()
                path, _, query = self.path.partition("?")
                record_route("POST", path)
                if path == "/admin/drain":
                    self._handle_admin_drain(query)
                    return
                if path == "/admin/undrain":
                    self._handle_admin_undrain(query)
                    return
                if path == "/admin/promote":
                    self._handle_admin_promote(query)
                    return
                if path not in ("/embed", "/neighbors"):
                    self.send_error(404)
                    return
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                headers = {}
                shape = self.headers.get("X-Image-Shape")
                if shape:
                    headers["X-Image-Shape"] = shape
                # a client-carried trace context (an upstream gateway's
                # X-Trace-Id/X-Parent-Span) is adopted; absent one the
                # router mints the trace id — either way every dispatch
                # attempt below propagates it to the replica
                ctx_in = ctxprop.parse(
                    self.headers.get("X-Trace-Id"),
                    self.headers.get("X-Parent-Span"),
                )
                t_ing = time.perf_counter()
                if not server._admit():
                    # load shedding: a counted 503 + Retry-After, never
                    # a silent drop (and it burns error budget)
                    server.metrics.count("shed")
                    server.metrics.record_failure()
                    self._json(
                        503,
                        {"error": "router at max_inflight budget", "shed": True},
                        extra_headers={
                            "Retry-After": str(
                                max(1, round(server.shed_retry_after_s))
                            )
                        },
                    )
                    return
                rtrace = None
                if server._reqtrace:
                    # backdated to handler entry so ingress covers the
                    # body read; shed requests stay untraced (no
                    # dispatch hops to attribute)
                    rtrace = RouterRequestTrace(path, t0, ctx=ctx_in)
                    rtrace.ingress_ms = round((t_ing - t0) * 1e3, 3)
                    rtrace.admission_ms = round(
                        (time.perf_counter() - t_ing) * 1e3, 3
                    )
                try:
                    status, payload, rep_index = retry_mod.retry_call(
                        server._attempt_hedged,
                        self.path,
                        body,
                        headers,
                        rtrace,
                        site="router." + path.strip("/"),
                        attempts=server.retry_attempts,
                        base_delay=server.retry_base_delay_s,
                        max_delay=server.retry_max_delay_s,
                        retry_on=(ReplicaAttemptError, ReplicaUnavailableError),
                    )
                except OSError as e:
                    # retries exhausted across the fleet: loud 503
                    server.metrics.count("failed")
                    server.metrics.record_failure()
                    err_body = {"error": f"fleet dispatch failed: {e}"}
                    if rtrace is not None:
                        err_body["trace_id"] = rtrace.trace_id
                    t_resp = time.perf_counter()
                    self._json(
                        503,
                        err_body,
                        extra_headers={"Retry-After": "1"},
                    )
                    if rtrace is not None:
                        # the failed trace is still a trace: every dead
                        # attempt attributed, no winner
                        rtrace.respond_ms = round(
                            (time.perf_counter() - t_resp) * 1e3, 3
                        )
                        rtrace.done(503)
                        server._trace_complete(rtrace)
                    return
                finally:
                    server._release()
                server.metrics.record_request(
                    time.perf_counter() - t0, ok=status == 200
                )
                if isinstance(payload, dict):
                    # replica attribution next to the replica-scoped
                    # request_id (r<i>-<seq>) the replica minted
                    payload.setdefault("replica", rep_index)
                    if rtrace is not None:
                        payload["trace_id"] = rtrace.trace_id
                t_resp = time.perf_counter()
                self._json(status, payload)
                if rtrace is not None:
                    rtrace.respond_ms = round(
                        (time.perf_counter() - t_resp) * 1e3, 3
                    )
                    rtrace.done(
                        status,
                        payload.get("request_id")
                        if isinstance(payload, dict) else None,
                    )
                    server._trace_complete(rtrace)

            def _handle_admin_drain(self, query):
                idx = _parse_replica(query, len(server._replicas))
                if idx is None:
                    self._json(400, {"error": "need replica=<index>"})
                    return
                restart = _query_flag(query, "restart", default=None)
                started = server.drain_replica(idx, restart=restart)
                with server._fleet_lock:
                    snap = server._replicas[idx].snapshot()
                self._json(202, {"accepted": started, "replica": snap})

            def _handle_admin_promote(self, query):
                # one staged-rollout step: point the supervisor at the
                # candidate checkpoint dir and drain/restart ONE replica
                # into it (the promotion controller drives this per
                # replica, watching burn gauges between steps)
                idx = _parse_replica(query, len(server._replicas))
                if idx is None:
                    self._json(400, {"error": "need replica=<index>"})
                    return
                ckpt_dir = _query_param(query, "ckpt_dir")
                if ckpt_dir is None:
                    self._json(400, {"error": "need ckpt_dir=<path>"})
                    return
                try:
                    started = server.promote_replica(
                        idx, urllib.parse.unquote(ckpt_dir)
                    )
                except RuntimeError as e:
                    self._json(409, {"error": str(e)})
                    return
                with server._fleet_lock:
                    snap = server._replicas[idx].snapshot()
                self._json(202, {"accepted": started, "replica": snap})

            def _handle_admin_undrain(self, query):
                idx = _parse_replica(query, len(server._replicas))
                if idx is None:
                    self._json(400, {"error": "need replica=<index>"})
                    return
                server.undrain_replica(idx)
                with server._fleet_lock:
                    snap = server._replicas[idx].snapshot()
                self._json(200, {"replica": snap})

            def _json(self, code, obj, extra_headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr lines
                pass

        self._server = _QuietHTTPServer((host, int(port)), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="router_http", daemon=True
        )
        self._thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router_health", daemon=True
        )
        self._health_thread.start()
        self._drainer = threading.Thread(
            target=self._drain_loop, name="router_drain", daemon=True
        )
        self._drainer.start()
        self._flusher = threading.Thread(
            target=self._flush_loop, args=(float(metrics_flush_s),),
            name="router_metrics_flush", daemon=True,
        )
        self._flusher.start()

    # -- dispatch ---------------------------------------------------------

    def _admit(self) -> bool:
        with self._fleet_lock:
            if self._active >= self.max_inflight:
                return False
            self._active += 1
            return True

    def _release(self) -> None:
        with self._fleet_lock:
            self._active -= 1

    def _acquire(self, exclude=()) -> Optional[ReplicaHandle]:
        """Claim a replica for one attempt: admitted (healthy, not
        draining), breaker willing, fewest in-flight first. Books the
        in-flight/dispatch counters under the fleet lock."""
        with self._fleet_lock:
            cands = sorted(
                (
                    r for r in self._replicas
                    if r.admitted and r.index not in exclude
                ),
                key=lambda r: (r.inflight, r.dispatched, r.index),
            )
            # a breaker due for its half-open probe takes the request
            # first: recovery needs live traffic, a failed probe is
            # retried on a closed replica anyway, and try_acquire gates
            # this to one probe per cooldown — an OPEN breaker inside
            # its cooldown says no and the request flows to the closed
            # replicas below
            for r in cands:
                if r.breaker.state != BREAKER_CLOSED and r.breaker.try_acquire():
                    r.inflight += 1
                    r.dispatched += 1
                    return r
            for r in cands:
                if r.breaker.state == BREAKER_CLOSED and r.breaker.try_acquire():
                    r.inflight += 1
                    r.dispatched += 1
                    return r
        return None

    def _finish(self, rep: ReplicaHandle, ok: bool) -> None:
        with self._fleet_lock:
            rep.inflight = max(0, rep.inflight - 1)
            if ok:
                rep.breaker.record_success()
            else:
                rep.breaker.record_failure()

    def _try_replica(
        self, rep: ReplicaHandle, path_q: str, body: bytes, headers: dict,
        attempt: Optional[dict] = None,
    ):
        """One attempt against one replica (runs on the dispatch pool;
        no locks held across the network I/O). Returns (status, payload,
        replica_index); raises ReplicaAttemptError on anything worth
        re-routing. `attempt` is this lane's RouterRequestTrace record:
        its span id rides downstream as X-Parent-Span, and the record is
        finalized here — on the thread that ran the attempt — with the
        outcome, the network send/recv split, and the replica's in-band
        stage waterfall (popped off the payload)."""
        hdrs = dict(headers)
        t_wall0 = time.time()
        if attempt is not None:
            ctxprop.inject(
                hdrs,
                ctxprop.TraceContext(attempt["trace_id"], attempt["span_id"]),
            )
            attempt["t0"] = time.perf_counter()
            attempt["start_ms"] = round(
                (attempt["t0"] - attempt["origin_t0"]) * 1e3, 3
            )
        req = urllib.request.Request(rep.url + path_q, data=body, headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=self.replica_timeout_s) as resp:
                payload = json.loads(resp.read())
                status = resp.status
        except urllib.error.HTTPError as e:
            if 400 <= e.code < 500:
                # the replica is alive and judged the request itself: a
                # client error passes through un-retried (breaker success)
                try:
                    payload = json.loads(e.read())
                except ValueError:
                    payload = {"error": f"replica {rep.index}: HTTP {e.code}"}
                self._finish(rep, ok=True)
                _finalize_attempt(attempt, "ok", error=f"HTTP {e.code}")
                return e.code, payload, rep.index
            self._finish(rep, ok=False)
            _finalize_attempt(attempt, "failed", error=f"HTTP {e.code}")
            raise ReplicaAttemptError(f"replica {rep.index}: HTTP {e.code}") from e
        except (OSError, TimeoutError) as e:  # URLError/socket resets/timeouts
            self._finish(rep, ok=False)
            _finalize_attempt(attempt, "failed", error=repr(e))
            raise ReplicaAttemptError(f"replica {rep.index}: {e!r}") from e
        except ValueError as e:  # torn/garbled response body
            self._finish(rep, ok=False)
            _finalize_attempt(attempt, "failed", error=repr(e))
            raise ReplicaAttemptError(
                f"replica {rep.index}: bad response ({e!r})"
            ) from e
        self._finish(rep, ok=True)
        remote = (
            payload.pop("trace", None) if isinstance(payload, dict) else None
        )
        _finalize_attempt(attempt, "ok", remote=remote, t_wall0=t_wall0)
        return status, payload, rep.index

    def _hedge_delay_s(self) -> Optional[float]:
        if not self.hedge:
            return None
        p99 = self.metrics.p99_ms()
        ms = max(self.hedge_min_ms, (p99 or 0.0) * self.hedge_p99_factor)
        return ms / 1e3

    def _attempt_hedged(
        self, path_q: str, body: bytes, headers: dict,
        rtrace: Optional[RouterRequestTrace] = None,
    ):
        """One retry-round: dispatch to the best replica; if it outlives
        the hedge delay, duplicate to a second one and take the first
        success (first-winner — the loser's response is discarded when
        it lands; urlopen cannot be cancelled mid-flight, so the loser
        lane is marked CANCELLED when it completes and its full cost is
        booked to `hedge_wasted_ms` rather than vanishing). Raises an
        OSError subclass when the round produced no success, which is
        what the retry layer backs off on."""
        rep = self._acquire()
        if rep is None:
            raise ReplicaUnavailableError("no admitted replica to dispatch to")
        rnd = rtrace.next_round() if rtrace is not None else 0
        att = (
            rtrace.new_attempt(rep.index, rnd, "primary", rep.breaker.state)
            if rtrace is not None else None
        )
        primary = self._pool.submit(
            self._try_replica, rep, path_q, body, headers, att
        )
        delay = self._hedge_delay_s()
        if delay is None:
            result = primary.result()
            if att is not None:
                att["winner"] = True
            return result
        try:
            result = primary.result(timeout=delay)
        except concurrent.futures.TimeoutError:
            pass  # primary is slow, not failed: hedge it
        else:
            if att is not None:
                att["winner"] = True
            return result
        second = self._acquire(exclude=(rep.index,))
        lanes = [(primary, att, time.perf_counter() - delay)]
        if second is not None:
            self.metrics.count("hedges")
            att2 = (
                rtrace.new_attempt(
                    second.index, rnd, "hedge", second.breaker.state
                )
                if rtrace is not None else None
            )
            lanes.append((
                self._pool.submit(
                    self._try_replica, second, path_q, body, headers, att2
                ),
                att2,
                time.perf_counter(),
            ))
        pending = {fut for fut, _, _ in lanes}
        errors = []
        while pending:
            done, pending = concurrent.futures.wait(
                pending, return_when=concurrent.futures.FIRST_COMPLETED
            )
            for fut in done:
                err = fut.exception()
                if err is None:
                    if len(lanes) == 2 and fut is lanes[1][0]:
                        self.metrics.count("hedge_wins")
                    for lfut, latt, lt0 in lanes:
                        if lfut is fut:
                            if latt is not None:
                                latt["winner"] = True
                        else:
                            self._cancel_lane(lfut, latt, lt0)
                    return fut.result()
                errors.append(err)
        raise ReplicaUnavailableError(
            "all attempts failed this round: "
            + "; ".join(repr(e) for e in errors)
        )

    def _cancel_lane(self, fut, att: Optional[dict], t_lane0: float) -> None:
        """Hedge-loser accounting: when the discarded lane completes
        (urlopen can't be aborted mid-flight), mark its span cancelled
        and book its full duration to the `hedge_wasted_ms` counter.
        The lane's latency never reaches the p99 histogram — only
        client-observed completions do (`RouterMetrics.record_request`)."""

        def _book(f):
            wasted = max(0.0, (time.perf_counter() - t_lane0) * 1e3)
            if att is not None:
                if att["dur_ms"] is not None:
                    wasted = att["dur_ms"]
                att["wasted_ms"] = round(wasted, 3)
                if att["outcome"] in ("ok", "pending"):
                    att["outcome"] = "cancelled"  # after wasted_ms (reader contract)
            self.metrics.count("hedge_wasted_ms", round(wasted, 3))

        fut.add_done_callback(_book)

    # -- health -----------------------------------------------------------

    def _probe(self, url: str):
        """(ok, warm, stats) for one replica — network I/O, call with
        no locks held."""
        try:
            with urllib.request.urlopen(
                url + "/healthz", timeout=self.health_timeout_s
            ) as r:
                h = json.loads(r.read())
        except (OSError, ValueError):
            return False, False, None
        stats = None
        try:
            with urllib.request.urlopen(
                url + "/stats", timeout=self.health_timeout_s
            ) as r:
                stats = json.loads(r.read())
        except (OSError, ValueError):
            pass
        return bool(h.get("ok")), bool(h.get("warm")), stats

    def _poll_health(self) -> None:
        with self._fleet_lock:
            targets = [(r.index, r.url) for r in self._replicas]
        for index, url in targets:
            ok, warm, stats = self._probe(url)
            with self._fleet_lock:
                rep = self._replicas[index]
                if rep.url != url:
                    continue  # replica moved mid-poll; drop the stale probe
                rep.healthy = ok
                rep.warm = warm
                if stats is not None:
                    rep.stats = stats

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            self._poll_health()

    # -- drain ------------------------------------------------------------

    def drain_replica(self, index: int, restart: Optional[bool] = None) -> bool:
        """Stop dispatching to replica `index`, wait out its in-flight
        requests, then (default, when a supervisor is attached) restart
        it and re-admit on healthy. Asynchronous: returns immediately
        (False = already draining); poll `/admin/replicas` for phase."""
        if restart is None:
            restart = self._supervisor is not None
        with self._fleet_lock:
            rep = self._replicas[index]
            if rep.draining:
                return False
            rep.draining = True
            rep.drain_phase = "waiting_inflight"
        self.metrics.count("drains")
        self._drain_q.put((index, bool(restart)))
        return True

    def promote_replica(self, index: int, ckpt_dir: str) -> bool:
        """One promotion step: retarget the supervisor's checkpoint dir
        at `ckpt_dir`, then drain/restart replica `index` so it comes
        back serving the candidate encoder. Asynchronous like
        `drain_replica` (False = that replica is already draining);
        the caller polls `/admin/replicas` for the swap landing (the
        replica's `model_digest` changes when it re-admits)."""
        if self._supervisor is None:
            raise RuntimeError(
                "promotion needs a supervisor-backed fleet "
                "(no supervisor attached to this router)"
            )
        self._supervisor.set_ckpt_dir(ckpt_dir)
        self.metrics.count("promotions")
        return self.drain_replica(index, restart=True)

    def undrain_replica(self, index: int) -> None:
        with self._fleet_lock:
            rep = self._replicas[index]
            rep.draining = False
            rep.drain_phase = None
            rep.breaker.reset()

    def _set_phase(self, rep: ReplicaHandle, phase: Optional[str]) -> None:
        with self._fleet_lock:
            rep.drain_phase = phase

    def _drain_loop(self) -> None:
        """The single drain worker: serializes drain/restart jobs (one
        replica leaves the fleet at a time — a fleet-wide drain storm
        cannot empty the rotation)."""
        while not self._stop.is_set():
            try:
                index, restart = self._drain_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._do_drain(index, restart)
            except Exception as e:  # a failed drain must not kill the worker
                print(f"router: drain of replica {index} failed: {e!r}", flush=True)
                self._set_phase(self._replicas[index], "drain_failed")

    def _do_drain(self, index: int, restart: bool) -> None:
        rep = self._replicas[index]
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            with self._fleet_lock:
                inflight = rep.inflight
            if inflight == 0:
                break
            time.sleep(0.05)
        if restart and self._supervisor is not None:
            self._set_phase(rep, "restarting")
            self._supervisor.restart_replica(index)
            self._set_phase(rep, "readmitting")
            deadline = time.monotonic() + self.readmit_timeout_s
            ok = False
            while time.monotonic() < deadline and not self._stop.is_set():
                ok, warm, stats = self._probe(rep.url)
                if ok:
                    break
                time.sleep(0.2)
            with self._fleet_lock:
                rep.healthy = ok
                rep.draining = False
                rep.drain_phase = None if ok else "readmit_timeout"
                rep.breaker.reset()
        else:
            # no restart: drain the replica's own batcher (flushes every
            # accepted request) and park it out of rotation
            try:
                req = urllib.request.Request(
                    rep.url + f"/admin/drain?timeout={self.drain_timeout_s:.1f}",
                    data=b"",
                )
                with urllib.request.urlopen(req, timeout=self.drain_timeout_s + 10):
                    pass
            except (OSError, ValueError) as e:
                print(
                    f"router: replica {index} /admin/drain failed: {e!r}", flush=True
                )
            self._set_phase(rep, "drained")

    # -- metrics ----------------------------------------------------------

    def stats(self) -> dict:
        """The `fleet_serve/*` gauge line: the router's own burn/latency
        family plus fleet topology, per-replica dispatch counts, and the
        per-replica burn gauges aggregated min/mean/max (the obs/fleet.py
        pattern). Snapshots fleet state first, THEN takes the metrics
        lock inside payload() — the two locks never nest."""
        with self._fleet_lock:
            snaps = [r.snapshot() for r in self._replicas]
            replica_stats = [dict(r.stats) for r in self._replicas]
            active = self._active
        out = self.metrics.payload()
        out["fleet_serve/replicas"] = len(snaps)
        out["fleet_serve/replicas_healthy"] = sum(
            1 for s in snaps if s["healthy"] and not s["draining"]
        )
        out["fleet_serve/inflight"] = active
        out["fleet_serve/breaker_open"] = sum(
            1 for s in snaps if s["breaker"] == BREAKER_OPEN
        )
        out["fleet_serve/breaker_trips"] = sum(s["breaker_trips"] for s in snaps)
        for s in snaps:
            out[f"fleet_serve/dispatch_{s['index']}"] = s["dispatched"]
        burn_keys = set()
        for st in replica_stats:
            burn_keys |= {
                k
                for k in st
                if k.startswith("serve/burn_rate_")
                or k.startswith("serve/fresh_burn_rate_")
                # the fleet's live online-recall baseline: the promotion
                # pipeline's live_recall gate reads the _max aggregate
                or k == "serve/recall_estimate"
            }
        for k in sorted(burn_keys):
            vals = [
                st[k] for st in replica_stats if st.get(k) is not None
            ]
            base = "fleet_serve/" + k.split("/", 1)[1]
            out[base + "_min"] = min(vals) if vals else None
            out[base + "_mean"] = sum(vals) / len(vals) if vals else None
            out[base + "_max"] = max(vals) if vals else None
        # version-skew gauge: how many DISTINCT encoder versions the
        # fleet is serving, minus one (0 = homogeneous; >0 mid-rollout
        # or a stuck replica). None until any replica reports a digest.
        digests = {
            st.get("serve/model_digest")
            for st in replica_stats
            if st.get("serve/model_digest") is not None
        }
        out["fleet_serve/model_skew"] = len(digests) - 1 if digests else None
        router_retries = {
            k: v
            for k, v in retry_mod.snapshot().items()
            if k.startswith("router.")
        }
        out["fleet_serve/retries"] = sum(router_retries.values())
        if router_retries:
            out["io_retries"] = router_retries
        return out

    # -- distributed-trace emission (off the request path) ---------------

    def _trace_complete(self, rtrace: RouterRequestTrace) -> None:
        """Handler-thread side: O(1) append; stitching, critical-path
        attribution, flight filing, and span rendering all happen on
        the flusher."""
        self._trace_pending.append(rtrace)

    def _drain_traces(self, force: bool = False) -> None:
        """Emit every completed pending trace. A trace whose hedge
        loser is still in flight is HELD BACK (re-queued) so the
        stitched record carries the cancelled lane's real cost — up to
        one replica-timeout of grace, then it goes out as-is. Safe for
        concurrent callers (flusher + a /debug/flight handler): the
        deque pops hand each trace to exactly one emitter."""
        grace = self.replica_timeout_s
        requeue = []
        while True:
            try:
                rt = self._trace_pending.popleft()
            except IndexError:
                break
            if (
                not force
                and not rt.complete()
                and (time.perf_counter() - (rt.t_end or rt.t0)) < grace
            ):
                requeue.append(rt)
                continue
            self._emit_trace(rt)
        for rt in requeue:
            self._trace_pending.append(rt)

    def _emit_trace(self, rtrace: RouterRequestTrace) -> None:
        stitched = rtrace.stitched()
        rec = dict(stitched)
        rec["stages"] = critpath.flatten(stitched)
        self.flight.record_request(rec)
        self.metrics.record_critpath(critpath.attribute(stitched))
        if self._tracer is not None:
            _emit_router_spans(self._tracer, rtrace, next(self._lane))

    def _write_router_anchor(self) -> None:
        """Atomic `heartbeat.r<router_index>.json` with the tracer's
        wall anchor — scripts/trace_merge.py clock-aligns the router
        stream against the replica streams with it."""
        rec = {
            "process": self.router_index,
            "role": "router",
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "time": time.time(),
            "trace_wall_t0": self._tracer.wall_t0,
        }
        path = os.path.join(self.workdir, f"heartbeat.r{self.router_index}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    def _on_alert(self, alert: dict) -> None:
        """AlertEngine on_fire hook: a fleet burn-rate (or p99) alert
        dumps the DISTRIBUTED flight ring at the firing edge — the
        postmortem file holds stitched multi-hop waterfalls, not one
        process's view — and lands an in-band alert event line."""
        if self.workdir:
            try:
                self.flight.dump(
                    self.workdir,
                    reason=f"alert:{alert['rule']}",
                    extra={
                        "alert": alert,
                        "slo_ms": self.metrics.slo_ms,
                        "role": "router",
                    },
                )
            except Exception as e:  # the dump must never take the router down
                print(f"WARNING: router flight dump failed: {e!r}", flush=True)
        if self._sink is not None:
            self._sink.write(
                self._flush_step,
                {
                    "event": "alert",
                    "alert": alert["rule"],
                    "severity": alert["severity"],
                    f"alert/{alert['rule']}": 1.0,
                },
            )

    def _flush_loop(self, interval: float) -> None:
        step = 0
        while not self._stop.wait(interval):
            step += 1
            self._write_metrics(step)
        self._write_metrics(step + 1)  # the run's last gauges land too

    def _write_metrics(self, step: int) -> None:
        self._flush_step = step  # mocolint: disable=JX012  (flusher-thread only during the run; close() joins the flusher before its own final drain, so writers are join-serialized)
        try:
            self._drain_traces()
            payload = self.stats()
            self.flight.record_metrics(step, payload)
            if self._alerts is not None:
                self._alerts.observe(step, payload)
            if self._sink is not None:
                self._sink.write(step, payload)
        except Exception as e:  # metrics must never take the router down
            print(f"WARNING: router metrics sink failed: {e!r}", flush=True)

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Stop the poller/flusher/drain worker, shut HTTP, join all
        four threads, and retire the dispatch pool (JX011 discipline).
        After the pool drains, force-emit any held-back traces (a hedge
        loser that never completed goes out with its lane pending) and
        close the trace stream."""
        self._stop.set()
        self._health_thread.join(timeout=10.0)
        self._flusher.join(timeout=10.0)
        self._drainer.join(timeout=self.drain_timeout_s + 30.0)
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10.0)
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._drain_traces(force=True)
        if self._alerts is not None:
            self._alerts.close()
        if self._tracer is not None:
            self._tracer.close()


def _query_param(query: str, name: str) -> Optional[str]:
    for part in query.split("&"):
        if part.startswith(name + "="):
            return part[len(name) + 1 :] or None
    return None


def _parse_replica(query: str, num_replicas: int) -> Optional[int]:
    val = _query_param(query, "replica")
    if val is None:
        return None
    try:
        idx = int(val)
    except ValueError:
        return None
    if not 0 <= idx < num_replicas:
        return None
    return idx


def _query_flag(query: str, name: str, default=None):
    val = _query_param(query, name)
    if val is None:
        return default
    return val not in ("0", "false", "no")


__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "FleetRouter",
    "ReplicaAttemptError",
    "ReplicaHandle",
    "ReplicaUnavailableError",
    "RouterMetrics",
    "RouterRequestTrace",
]
