"""SLO burn-rate accounting for the serving stack.

A raw `serve/slo_violations` counter can't drive paging: a single slow
request in a week and a sustained 5% violation rate both increment it.
The SRE-standard signal is the **burn rate** — how fast the service is
spending its error budget:

    burn = (violating fraction over a window) / (1 - objective)

burn == 1 means the budget exactly runs out at the end of the SLO
period; 14.4 means a 30-day budget is gone in 2 days. Multi-window
evaluation (a fast window to catch cliffs, a slow one to catch creep)
is what the default alert rules threshold on.

:class:`SLOBurnTracker` keeps per-second good/bad buckets over the
longest window (bounded memory, O(1) record from the batcher thread)
and reports `serve/burn_rate_<w>s` gauges the obs schema validates,
the Prometheus sink exposes, and the existing `obs/alerts.py`
threshold rules fire on — no new rule kind needed.
:func:`serve_alert_spec` builds the serving default rule set in the
alerts grammar; the server parses it with `alerts.parse_rules` and
dumps the flight recorder when a rule fires.

Stdlib-only, like every obs module the report tooling imports: the
port's copy of moco_tpu/obs/slo.py. The freshness pair
(`FreshnessBurnTracker`, `fresh_alert_spec`) is armed by the server's
`fresh_max_age_s` (serve/server.py), fed by the index's ingest stamps that
`/ingest` writes.
"""

from __future__ import annotations

import time
import threading
from collections import deque
from typing import Optional, Sequence

from moco_tpu_torch.utils.locks import make_lock

# (fast, slow) windows, seconds. Burn thresholds below are the classic
# multiwindow pair scaled to these: sustained burn > the threshold on
# the fast window pages quickly; the slow window catches slow leaks.
DEFAULT_WINDOWS = (60, 600)
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0


class SLOBurnTracker:
    """Multi-window burn-rate over a declared latency SLO (module
    docstring). `record(ok)` is called once per completed request on
    the batcher thread; `burn_rates()`/`payload()` run on the metrics
    flusher. A deterministic `now` (seconds, monotonic domain) makes
    the math unit-testable."""

    def __init__(
        self,
        slo_ms: float,
        objective: float = 0.99,
        windows: Sequence[int] = DEFAULT_WINDOWS,
    ):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if not windows or sorted(set(int(w) for w in windows)) != sorted(
            int(w) for w in windows
        ):
            raise ValueError(f"windows must be unique and non-empty, got {windows}")
        self.slo_ms = float(slo_ms)
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.windows = tuple(sorted(int(w) for w in windows))
        self._max_w = self.windows[-1]
        self._lock = make_lock("obs.slo")
        # per-second [sec, good, bad] buckets, oldest left; pruned on
        # record so memory is bounded by the longest window
        self._buckets: deque = deque()

    def record(self, ok: bool, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        sec = int(now)
        with self._lock:
            if not self._buckets or self._buckets[-1][0] != sec:
                self._buckets.append([sec, 0, 0])
            self._buckets[-1][1 if ok else 2] += 1
            floor = sec - self._max_w
            while self._buckets and self._buckets[0][0] <= floor:
                self._buckets.popleft()

    def burn_rates(self, now: Optional[float] = None) -> dict[int, Optional[float]]:
        """{window_s: burn rate} — None where the window saw no
        requests (a silent service isn't burning budget)."""
        now = time.monotonic() if now is None else now
        sec = int(now)
        out: dict[int, Optional[float]] = {}
        with self._lock:
            buckets = list(self._buckets)
        for w in self.windows:
            floor = sec - w
            good = bad = 0
            for s, g, b in buckets:
                if s > floor:
                    good += g
                    bad += b
            total = good + bad
            out[w] = (bad / total) / self.budget if total else None
        return out

    def payload(self, now: Optional[float] = None) -> dict:
        """The schema'd `serve/burn_rate_<w>s` gauge family plus the
        declared objective — merged into ServeMetrics.payload()."""
        out = {
            f"serve/burn_rate_{w}s": rate
            for w, rate in self.burn_rates(now).items()
        }
        out["serve/slo_objective"] = self.objective
        return out


class FreshnessBurnTracker:
    """Burn-rate accounting for the serving FRESHNESS SLO: the declared
    objective is "at least `objective` of freshness observations see a
    max index-row age <= `max_age_s` wall-seconds". Each metrics flush
    records one observation (the flusher samples
    `EmbeddingIndex.row_age_stats()`), so a stalled ingest pipeline
    burns budget at exactly the flush cadence and the same multi-window
    threshold rules that page on latency burn page on staleness.

    The bucket math is `SLOBurnTracker`'s (composition, not a copy):
    per-second good/bad buckets, bounded memory, deterministic `now`
    for unit tests. The payload family is `serve/fresh_burn_rate_<w>s`
    plus the declared `serve/fresh_max_age_s` objective gauge; the
    router renames per-replica gauges into `fleet_serve/fresh_burn_*`
    aggregates exactly as it does for the latency family."""

    def __init__(
        self,
        max_age_s: float,
        objective: float = 0.99,
        windows: Sequence[int] = DEFAULT_WINDOWS,
    ):
        if not max_age_s > 0:
            raise ValueError(f"max_age_s must be > 0, got {max_age_s}")
        self.max_age_s = float(max_age_s)
        self._burn = SLOBurnTracker(
            slo_ms=self.max_age_s * 1e3, objective=objective, windows=windows
        )
        self.objective = self._burn.objective
        self.windows = self._burn.windows

    def record(self, row_age_s: Optional[float], now: Optional[float] = None) -> None:
        """One freshness observation: the index's current max row age
        (None = no stamped rows yet — an empty index is not stale)."""
        ok = row_age_s is None or float(row_age_s) <= self.max_age_s
        self._burn.record(ok, now=now)

    def burn_rates(self, now: Optional[float] = None) -> dict[int, Optional[float]]:
        return self._burn.burn_rates(now)

    def payload(self, now: Optional[float] = None) -> dict:
        """The schema'd `serve/fresh_burn_rate_<w>s` gauge family plus
        the declared max-age objective — merged into the serve flush."""
        out = {
            f"serve/fresh_burn_rate_{w}s": rate
            for w, rate in self.burn_rates(now).items()
        }
        out["serve/fresh_max_age_s"] = self.max_age_s
        return out


def serve_alert_spec(
    slo_ms: Optional[float] = None,
    windows: Sequence[int] = DEFAULT_WINDOWS,
    fast_burn: float = DEFAULT_FAST_BURN,
    slow_burn: float = DEFAULT_SLOW_BURN,
    prefix: str = "serve",
) -> str:
    """The serving default alert rules, in the obs/alerts.py grammar —
    threshold rules over the burn-rate gauges (fast window at
    `fast_burn`, slow window at `slow_burn`) plus, when `slo_ms` is
    given, a p99-over-SLO warn. `ServeServer(alert_spec="serve_default")`
    expands through this with its own slo/window settings; smokes pass
    tightened values so a short run can fire. The router expands with
    `prefix="fleet_serve"` so its rules watch the client-observed
    fleet gauges rather than any single replica's."""
    windows = tuple(sorted(int(w) for w in windows))
    rules = [
        f"threshold@name=slo_burn_fast:field={prefix}/burn_rate_{windows[0]}s:"
        f"value={fast_burn:g}"
    ]
    if len(windows) > 1:
        rules.append(
            f"threshold@name=slo_burn_slow:field={prefix}/burn_rate_{windows[-1]}s:"
            f"value={slow_burn:g}"
        )
    if slo_ms:
        rules.append(
            f"threshold@name=slo_p99_over:field={prefix}/p99_ms:"
            f"value={float(slo_ms):g}"
        )
    return ",".join(rules)


def fresh_alert_spec(
    windows: Sequence[int] = DEFAULT_WINDOWS,
    fast_burn: float = DEFAULT_FAST_BURN,
    slow_burn: float = DEFAULT_SLOW_BURN,
    prefix: str = "serve",
) -> str:
    """The freshness-SLO default alert rules — the same multiwindow
    threshold pair as `serve_alert_spec`, over the
    `<prefix>/fresh_burn_rate_<w>s` family. A replica with a freshness
    objective appends these to its serving rules; the fleet smoke's
    ingest-stall leg (`delay@site=ingest`) proves they fire."""
    windows = tuple(sorted(int(w) for w in windows))
    rules = [
        f"threshold@name=fresh_burn_fast:field={prefix}/fresh_burn_rate_{windows[0]}s:"
        f"value={fast_burn:g}"
    ]
    if len(windows) > 1:
        rules.append(
            f"threshold@name=fresh_burn_slow:field={prefix}/fresh_burn_rate_{windows[-1]}s:"
            f"value={slow_burn:g}"
        )
    return ",".join(rules)


__all__ = [
    "DEFAULT_FAST_BURN",
    "DEFAULT_SLOW_BURN",
    "DEFAULT_WINDOWS",
    "FreshnessBurnTracker",
    "SLOBurnTracker",
    "fresh_alert_spec",
    "serve_alert_spec",
]
