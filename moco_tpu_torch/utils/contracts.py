"""Process exit codes (the part of moco_tpu/utils/contracts.py the port
uses): one source for the code a supervisor keys its restart on."""

from __future__ import annotations

STALL_EXIT_CODE = 42  # utils/watchdog.py: the watchdog fired, no step for `timeout`

EXIT_CODES = {
    "stall": STALL_EXIT_CODE,
}

# How far a serving port shifts off a colliding Prometheus port
# (obs/sinks.py `resolve_serve_port`): an upper bound on co-hosted
# processes per host, so the shifted serve family never lands on any
# peer's metrics port.
SERVE_PORT_STRIDE = 16
