"""Deterministic fault injection at the data sites (the `io` and `delay`
kinds of moco_tpu/utils/faults.py).

A plan is installed from a spec string: comma-separated faults, each
`kind@key=val[:key=val...]`:

    io@site=S:at=K[:times=M]      raise IOError on the Kth (1-based) call
                                  at site S (M consecutive calls; default
                                  1): exercises the retry layer
    delay@site=S:seconds=X[:at=K:times=M]
                                  sleep X seconds on calls K..K+M-1
                                  (default: every call) at site S: a
                                  deterministic stage slow-down
                                  ("input.h2d" slows the prefetch ring's
                                  transfer stage, "data.read" the host's
                                  loads)

Faults are keyed on per-site call counters, never on randomness, so a run
is exactly reproducible. The other kinds of the JAX module (checkpoint,
NaN, stall, preemption, kill and the serving and analysis kinds) come
with the slices that port what they test. With no plan installed every
hook returns at once.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Optional

KINDS = ("io", "delay")
_INT_KEYS = ("at", "times")
_FLOAT_KEYS = ("seconds",)
_STR_KEYS = ("site",)


class FaultPlan:
    """A parsed spec and its per-site call counters."""

    def __init__(self, spec: str):
        self.rules: list[tuple[str, dict]] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            kind, _, params = part.partition("@")
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in {part!r} (known: {KINDS})")
            kv: dict = {}
            for tok in params.split(":"):
                if not tok:
                    continue
                k, _, v = tok.partition("=")
                if k in _INT_KEYS:
                    kv[k] = int(v)
                elif k in _FLOAT_KEYS:
                    kv[k] = float(v)
                elif k in _STR_KEYS:
                    kv[k] = v
                else:
                    raise ValueError(f"unknown fault param {k!r} in {part!r}")
            if kind == "delay" and "seconds" not in kv:
                raise ValueError(f"delay fault {part!r} needs seconds=<X>")
            self.rules.append((kind, kv))
        self._lock = threading.Lock()
        self._counts: Counter = Counter()  # (kind, site) -> calls seen

    def _count(self, kind: str, site: str) -> int:
        with self._lock:
            self._counts[kind, site] += 1
            return self._counts[kind, site]

    def maybe_io_error(self, site: str) -> None:
        n = self._count("io", site)
        for kind, p in self.rules:
            if kind != "io" or p.get("site", site) != site:
                continue
            at = p.get("at", 1)
            if at <= n < at + p.get("times", 1):
                raise IOError(f"injected fault: read #{n} at site {site!r}")

    def maybe_delay(self, site: str) -> None:
        """Sleep at site; counted apart from `io`, so an io@ and a delay@
        rule on one site do not move each other's schedules."""
        n = self._count("delay", site)
        for kind, p in self.rules:
            if kind != "delay" or p.get("site", site) != site:
                continue
            at, times = p.get("at", 1), p.get("times")
            if n >= at and (times is None or n < at + times):
                time.sleep(p["seconds"])


_PLAN: Optional[FaultPlan] = None


def install(spec: Optional[str]) -> Optional[FaultPlan]:
    """Install a fresh plan (counters reset); None or "" clears."""
    global _PLAN
    _PLAN = FaultPlan(spec) if spec else None
    return _PLAN


def clear() -> None:
    install(None)


def maybe_io_error(site: str) -> None:
    if _PLAN is not None:
        _PLAN.maybe_io_error(site)


def maybe_delay(site: str) -> None:
    if _PLAN is not None:
        _PLAN.maybe_delay(site)
