"""Tail-latency flight recorder for the serving stack.

When a burn-rate alert fires the interesting requests are already
gone: the p99 gauge says the tail rose, but the request that rose it
completed seconds ago. The flight recorder keeps a bounded in-memory
ring of the most recent completed request waterfalls (obs/reqtrace.py
dicts) and the most recent flushed metric lines, and on demand — an
SLO-violation alert, a fatal alert, or a `/debug/flight` request —
dumps the whole ring **atomically** to `flight_<ts>.json` in the
workdir, so the postmortem has the exact stage-stamped history around
the incident instead of an aggregate.

Cost discipline matches reqtrace: `record_request` is one deque append
under a lock (deque maxlen evicts for free); the JSON encoding happens
only at dump time, never on the request path.

The dump carries a `slowest` view (top-N by total_ms) so
`scripts/obs_report.py`'s Serving section and a human tailing the file
see the offenders first; the full ring rides below it.

Stdlib-only: the port's copy of moco_tpu/obs/flight.py.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

from moco_tpu_torch.utils.locks import make_lock

DEFAULT_MAX_REQUESTS = 512
DEFAULT_MAX_METRICS = 120
DEFAULT_TOP_N = 10


class FlightRecorder:
    """Bounded ring of recent request waterfalls + metric lines with an
    atomic JSON dump (module docstring)."""

    def __init__(
        self,
        max_requests: int = DEFAULT_MAX_REQUESTS,
        max_metrics: int = DEFAULT_MAX_METRICS,
        replica: int = 0,
    ):
        self.replica = int(replica)
        self._lock = make_lock("obs.flight")
        self._requests: deque = deque(maxlen=int(max_requests))
        self._metrics: deque = deque(maxlen=int(max_metrics))
        self._dump_seq = itertools.count()
        self.dumps: list[str] = []  # paths written, oldest first

    # -- recording (hot-adjacent; O(1) appends) --------------------------

    def record_request(self, waterfall: dict) -> None:
        """One completed request's waterfall dict
        (`RequestTrace.waterfall()`)."""
        with self._lock:
            self._requests.append(waterfall)

    def record_metrics(self, step: int, payload: dict) -> None:
        """One flushed metric line (shallow-copied: payloads are
        rebuilt per flush, never mutated after)."""
        with self._lock:
            self._metrics.append({"step": int(step), "time": time.time(), **payload})

    # -- views + dump ----------------------------------------------------

    def snapshot(self, top_n: int = DEFAULT_TOP_N) -> dict:
        """JSON-ready view of the ring: `slowest` (top-N waterfalls by
        total_ms, slowest first), the full `requests` ring, and the
        recent `metrics` lines."""
        with self._lock:
            requests = list(self._requests)
            metrics = list(self._metrics)
        slowest = sorted(
            requests, key=lambda r: r.get("total_ms", 0.0), reverse=True
        )[: max(int(top_n), 0)]
        return {
            "replica": self.replica,
            "requests_recorded": len(requests),
            "slowest": slowest,
            "requests": requests,
            "metrics": metrics,
        }

    def dump(
        self,
        workdir: str,
        reason: str,
        top_n: int = DEFAULT_TOP_N,
        extra: Optional[dict] = None,
    ) -> str:
        """Write the snapshot to `<workdir>/flight_<ts>.json` via the
        atomic tmp+rename discipline (a scraper or the CI artifact
        uploader never sees a torn file); returns the path. The
        monotonic dump sequence keeps two alerts in one second from
        colliding on the timestamped name."""
        rec = {
            "reason": reason,
            "time": time.time(),
            **(extra or {}),
            **self.snapshot(top_n),
        }
        os.makedirs(workdir, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S", time.localtime(rec["time"]))
        path = os.path.join(
            workdir, f"flight_{ts}_{next(self._dump_seq):03d}.json"
        )
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=2, allow_nan=False)
        os.replace(tmp, path)
        self.dumps.append(path)
        return path


def read_flight_dumps(workdir: str) -> list[tuple[str, dict]]:
    """(path, parsed dump) for every flight_*.json under `workdir`,
    oldest first — the obs_report loader. Unparseable files are skipped
    (reporting on a crashed run is the point)."""
    import glob as _glob

    out = []
    for path in sorted(_glob.glob(os.path.join(workdir, "flight_*.json"))):
        try:
            with open(path) as f:
                out.append((path, json.load(f)))
        except (ValueError, OSError):
            continue
    return out


__all__ = ["FlightRecorder", "read_flight_dumps"]
