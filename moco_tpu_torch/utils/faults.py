"""Deterministic fault injection (the `io`, `delay`, `nan` and
`ckpt_truncate` kinds of moco_tpu/utils/faults.py).

A plan is installed from a spec string (`install`, or the `MOCO_FAULTS`
environment variable, which the training driver reads at its start):
comma-separated faults, each `kind@key=val[:key=val...]`:

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
    nan@step=N[:times=M]          the loss the driver's guard observes at
                                  global steps N..N+M-1 becomes NaN
    ckpt_truncate@step=N          halve the checkpoint file written at
                                  step N after the write completes: a
                                  torn write the restore path must survive

Faults are keyed on global steps and per-site call counters, never on
randomness, so a run is exactly reproducible. The other kinds of the JAX
module (stall, preemption, kill and the serving and analysis kinds) come
with the slices that port what they test. With no plan installed every
hook returns at once.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter
from typing import Optional

KINDS = ("io", "delay", "nan", "ckpt_truncate")
_INT_KEYS = ("step", "at", "times")
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
            if kind in ("nan", "ckpt_truncate") and "step" not in kv:
                raise ValueError(f"{kind} fault {part!r} needs step=<N>")
            self.rules.append((kind, kv))
        self._lock = threading.Lock()
        self._counts: Counter = Counter()  # (kind, site) -> calls seen
        self._fired: set = set()  # once-only rules that already fired

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

    def corrupt_loss(self, loss: float, step: int) -> float:
        for kind, p in self.rules:
            if kind == "nan" and p["step"] <= step < p["step"] + p.get("times", 1):
                return float("nan")
        return loss

    def on_checkpoint_saved(self, path: str, step: int) -> None:
        """Halve the file of the checkpoint just written at `step` (once
        per rule): the file is in place and named as a good one, but its
        payload is short."""
        for i, (kind, p) in enumerate(self.rules):
            if kind != "ckpt_truncate" or p["step"] != step:
                continue
            with self._lock:
                if i in self._fired:
                    continue
                self._fired.add(i)
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 2))
            print(f"injected fault: truncated {path} ({size} -> {max(1, size // 2)} bytes)",
                  flush=True)


_PLAN: Optional[FaultPlan] = None


def install(spec: Optional[str]) -> Optional[FaultPlan]:
    """Install a fresh plan (counters reset); None or "" clears."""
    global _PLAN
    _PLAN = FaultPlan(spec) if spec else None
    return _PLAN


def install_from_env() -> Optional[FaultPlan]:
    """Install from `MOCO_FAULTS` when it is set; otherwise leave the
    current plan alone (tests install theirs directly)."""
    spec = os.environ.get("MOCO_FAULTS")
    return install(spec) if spec else _PLAN


def clear() -> None:
    install(None)


def enabled() -> bool:
    return _PLAN is not None


def maybe_io_error(site: str) -> None:
    if _PLAN is not None:
        _PLAN.maybe_io_error(site)


def maybe_delay(site: str) -> None:
    if _PLAN is not None:
        _PLAN.maybe_delay(site)


def corrupt_loss(loss: float, step: int) -> float:
    return _PLAN.corrupt_loss(loss, step) if _PLAN is not None else loss


def on_checkpoint_saved(path: str, step: int) -> None:
    if _PLAN is not None:
        _PLAN.on_checkpoint_saved(path, step)
