"""The port's stringly-typed contracts in one place
(moco_tpu/utils/contracts.py): process exit codes (one source for the code
a supervisor keys its restart on), the port-offset stride, the HTTP routes
with their methods, headers and idempotence, the fault sites its hooks
reach, the names of its traced locks, and the schema validators the
contract-coverage recorder gates on (analysis/contracts.py).

The port's static analyzer (`python -m moco_tpu_torch.analysis`, rules
JX016-JX018) lints the tree against these registries; adding a route, a
fault site or a lock ships its entry here in the same change.

Stdlib-only: the analyzer imports it with no torch installed."""

from __future__ import annotations

STALL_EXIT_CODE = 42  # utils/watchdog.py: the watchdog fired, no step for `timeout`
KILL_EXIT_CODE = 113  # utils/faults.py: kill@host / kill@replica sudden death
# parallel/elastic.py: a survivor of a lost rank after the agreed emergency
# checkpoint; the launcher relaunches the survivors at the width it prints
RESCALE_EXIT_CODE = 75

EXIT_CODES = {
    "stall": STALL_EXIT_CODE,
    "kill": KILL_EXIT_CODE,
    "rescale": RESCALE_EXIT_CODE,
}

# How far a serving port shifts off a colliding Prometheus port
# (obs/sinks.py `resolve_serve_port`): an upper bound on co-hosted
# processes per host, so the shifted serve family never lands on any
# peer's metrics port.
SERVE_PORT_STRIDE = 16

# HTTP routes: route -> (methods, required request headers, propagated
# headers, idempotent?, which server handles it). "replica" =
# serve/server.py ServeServer, "router" = serve/router.py FleetRouter,
# "both" = the router proxies or mirrors the replica surface, "metrics" =
# obs/sinks.py's Prometheus endpoint. `idempotent` is the retry/hedge
# contract: the router may retry and hedge exactly these routes (never
# /ingest, which appends queue rows). `opt_headers` are the propagated
# headers (obs/ctxprop.py): a plain client may omit them, but every handler
# of the route must read them (JX016 checks the handler side).

# distributed-tracing context headers (obs/ctxprop.py mints and parses them)
TRACE_HEADERS = ("X-Trace-Id", "X-Parent-Span")


class Route:
    __slots__ = ("path", "methods", "headers", "opt_headers", "idempotent", "server")

    def __init__(self, path, methods, headers=(), opt_headers=(), idempotent=False,
                 server="both"):
        self.path = path
        self.methods = tuple(methods)
        self.headers = tuple(headers)
        self.opt_headers = tuple(opt_headers)
        self.idempotent = idempotent
        self.server = server


ROUTES = {
    r.path: r
    for r in (
        Route("/healthz", ("GET",), idempotent=True, server="both"),
        Route("/metrics", ("GET",), idempotent=True, server="metrics"),
        Route("/stats", ("GET",), idempotent=True, server="both"),
        Route("/debug/flight", ("GET",), idempotent=True, server="both"),
        Route("/admin/replicas", ("GET",), idempotent=True, server="router"),
        Route("/embed", ("POST",), headers=("X-Image-Shape",), opt_headers=TRACE_HEADERS,
              idempotent=True, server="both"),
        Route("/neighbors", ("POST",), headers=("X-Image-Shape",), opt_headers=TRACE_HEADERS,
              idempotent=True, server="both"),
        # X-Ckpt-Step: the source checkpoint step of the posted rows, read
        # into the replica's serve/ingest_ckpt_step gauge
        Route("/ingest", ("POST",), headers=("X-Rows-Shape",), opt_headers=("X-Ckpt-Step",),
              idempotent=False, server="replica"),
        Route("/admin/drain", ("POST",), idempotent=False, server="both"),
        Route("/admin/undrain", ("POST",), idempotent=False, server="router"),
        # the served model's identity (step, parameter digest, last ingest step)
        Route("/admin/model", ("GET",), idempotent=True, server="replica"),
        # one staged-rollout step; a retry would double-drain a replica
        Route("/admin/promote", ("POST",), idempotent=False, server="router"),
    )
}

IDEMPOTENT_ROUTES = tuple(sorted(p for p, r in ROUTES.items() if r.idempotent))


def route_methods(path: str) -> tuple:
    """Declared methods of a route (query string stripped), or () for an
    undeclared one."""
    r = ROUTES.get(path)
    return r.methods if r else ()


# The request-trace stages a `slow@` fault may stall (utils/faults.py).
SERVE_STAGE_SITES = (
    "serve.ingress",
    "serve.batch_assemble",
    "serve.engine_execute",
    "serve.index_query",
    "serve.scatter",
    "serve.respond",
)

# utils/locks.py `make_lock` names: the deadlock@site=<lock> fault inverts
# the acquisition order around the named lock (analysis/tsan.py).
LOCK_SITES = (
    "data.transfer_stats",
    "fleet.supervisor",
    "obs.comms",
    "obs.flight",
    "obs.prometheus",
    "obs.slo",
    "obs.trace",
    "promote.ledger",
    "router.fleet",
    "router.metrics",
    "serve.index",
    "serve.metrics",
    "utils.retry",
)

# The sites the port's fault hooks are called at, by kind. kill, stall,
# nan, preempt and ckpt_truncate take no site; diverge's sites are the
# comms ledger's (obs/comms.py), checked at run time by the schedule
# sanitizer, not here.
FAULT_SITES = {
    "slow": SERVE_STAGE_SITES,
    # "ingest": stalls the replica's /ingest handler before the body
    # read (serve/server.py) — the freshness-SLO chaos lever: rows age
    # past the declared max while the tail pipeline is stuck.
    # "zero.gather": the stall the hoisted ZeRO gather's worker absorbs
    # (parallel/zero.py AsyncParamGather), the overlap/zero gauge's lever.
    "delay": ("data.read", "input.h2d", "zero.gather", "ingest"),
    "io": ("data.read",),
    "deadlock": LOCK_SITES,
}

# Runtime contract-coverage gates (analysis/contracts.py's recorder): the
# serve/* validators a replica's full burst must apply (every explicit
# serve/ key but the bench-only trace-overhead gauge) ...
SERVE_GATED_VALIDATORS = (
    "serve/ingested_rows",
    "serve/int8",
    "serve/ivf_occupancy",
    "serve/ivf_spill",
    "serve/latency_hist",
    "serve/nprobe",
    "serve/p99_exemplar",
    "serve/p99_exemplar_ms",
    "serve/quant_tier",
    "serve/recall_estimate",
    "serve/slo_objective",
)

# ... the served model's identity and the freshness gauges of a replica
# with a freshness objective ...
QUALITY_GATED_VALIDATORS = (
    "serve/fresh_burn_rate_",
    "serve/fresh_max_age_s",
    "serve/ingest_ckpt_step",
    "serve/model_digest",
    "serve/model_step",
    "serve/row_age_max_s",
    "serve/row_age_mean_s",
)

# ... the router's critical-path family and hedge-loser counter ...
FLEET_GATED_VALIDATORS = (
    "fleet_serve/critpath_",
    "fleet_serve/hedge_wasted_ms",
)

# ... and the promotion ledger's lines (serve/promote.py).
PROMOTION_GATED_VALIDATORS = (
    "fleet_serve/model_skew",
    "promotion/",
    "promotion/digest",
    "promotion/failed_gate",
    "promotion/stage",
    "promotion/verdict",
)
