"""The parts of moco_tpu/utils/contracts.py the port uses: process exit
codes (one source for the code a supervisor keys its restart on) and the
fault sites its code reaches."""

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

# The request-trace stages a `slow@` fault may stall (utils/faults.py).
SERVE_STAGE_SITES = (
    "serve.ingress",
    "serve.batch_assemble",
    "serve.engine_execute",
    "serve.index_query",
    "serve.scatter",
    "serve.respond",
)

# The sites the port's fault hooks are called at, by kind.
FAULT_SITES = {
    "slow": SERVE_STAGE_SITES,
    # "ingest": stalls the replica's /ingest handler before the body
    # read (serve/server.py) — the freshness-SLO chaos lever: rows age
    # past the declared max while the tail pipeline is stuck.
    # "zero.gather": the stall the hoisted ZeRO gather's worker absorbs
    # (parallel/zero.py AsyncParamGather), the overlap/zero gauge's lever.
    "delay": ("data.read", "input.h2d", "zero.gather", "ingest"),
    "io": ("data.read",),
}
