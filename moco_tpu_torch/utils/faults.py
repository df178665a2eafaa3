"""Deterministic fault injection (the kinds of moco_tpu/utils/faults.py).

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
                                  loads, "ingest" a serving replica's
                                  /ingest before its body read: the
                                  freshness SLO's stall)
    nan@step=N[:times=M]          the loss the driver's guard observes at
                                  global steps N..N+M-1 becomes NaN
    ckpt_truncate@step=N          halve the checkpoint file written at
                                  step N after the write completes: a
                                  torn write the restore path must survive
                                  (under async checkpoints, after the
                                  background write has landed)
    stall@step=N:seconds=S        sleep S seconds at global step N (once):
                                  exercises the stall watchdog
    preempt@step=N                SIGTERM this process at global step N
                                  (once): a deterministic preemption
    slow@site=S:ms=X[:at=K:times=M]
                                  sleep X milliseconds on calls K..K+M-1
                                  (default: every call) at serving-stage
                                  site S (serve.ingress,
                                  serve.batch_assemble,
                                  serve.engine_execute, serve.index_query,
                                  serve.scatter, serve.respond), inside
                                  that stage's stamped interval, so the
                                  request trace and the flight recorder
                                  attribute the tail to that stage
    kill@host=i[:at=K]            rank i dies at global step K (default:
                                  the first log step it reaches): in a
                                  world of more than one rank, that
                                  process exits at once with
                                  KILL_EXIT_CODE (113), no checkpoint, no
                                  cleanup; the survivors' next collective
                                  fails (gloo) or times out (NCCL), and
                                  they exit non-zero, or under `elastic`
                                  rescale (parallel/elastic.py) and exit
                                  with RESCALE_EXIT_CODE. In a world of one,
                                  rank i's heartbeat file is stamped stale
                                  (time 0) instead, so the heartbeat rule
                                  fires
    kill@replica=i[:at=K]         serving replica i exits at once with
                                  KILL_EXIT_CODE (no drain, no flush) while
                                  handling its Kth /embed or /neighbors
                                  POST (1-based; default 1): the fleet
                                  router must retry the request elsewhere
                                  and the ReplicaSupervisor restart and
                                  re-warm the replica, whose respawn runs
                                  with the kill@replica rules stripped
                                  (`strip_replica_kills`), so one rule is
                                  one death
    diverge@site=S                perturb THIS process's recorded
                                  collective schedule at comms site S
                                  (analysis/sanitizer.py appends a marker
                                  to the site's shape signature): the
                                  schedule sanitizer's end-to-end proof
                                  without a really divergent world
    deadlock@site=L               force an inverted lock order at the
                                  traced lock L (utils/locks.py names):
                                  when L is acquired while another traced
                                  lock is held, the lock-order recorder
                                  (analysis/tsan.py) also records the
                                  edge the opposite nesting would have
                                  made, as if a second thread had raced
                                  the critical section backwards; a
                                  deterministic cycle through the real
                                  detection path, no real deadlock

Faults are keyed on global steps and per-site call counters, never on
randomness, so a run is exactly reproducible. The sites the port's code
calls the hooks at are listed in utils/contracts.py (`FAULT_SITES`). The
training loop calls the step hooks on log steps only: `corrupt_loss` as
it reads the loss, `maybe_stall`, `maybe_preempt` and `maybe_kill_host` in
the step's deferred processing; a replica's HTTP handler calls
`maybe_kill_replica` on each /embed and /neighbors POST; the schedule
recorder asks `diverge_marker` and the lock-order recorder `deadlock_marker`.
With no plan installed every hook returns at once. With a coverage callback
installed (`set_coverage_callback`, the contract-coverage recorder of
analysis/contracts.py) every hook reports its (kind, site), plan or no
plan.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from collections import Counter
from typing import Optional

from moco_tpu_torch.utils.contracts import KILL_EXIT_CODE

KINDS = ("ckpt_truncate", "io", "nan", "stall", "preempt", "delay", "diverge", "slow", "kill",
         "deadlock")
_INT_KEYS = ("step", "at", "times", "host", "replica")
_FLOAT_KEYS = ("seconds", "ms")
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
            if kind == "slow" and "ms" not in kv:
                raise ValueError(f"slow fault {part!r} needs ms=<X>")
            if kind in ("nan", "ckpt_truncate", "stall", "preempt") and "step" not in kv:
                raise ValueError(f"{kind} fault {part!r} needs step=<N>")
            if kind == "stall" and "seconds" not in kv:
                raise ValueError(f"stall fault {part!r} needs seconds=<S>")
            if kind in ("diverge", "deadlock") and "site" not in kv:
                raise ValueError(f"{kind} fault {part!r} needs site=<S>")
            if kind == "kill" and "host" not in kv and "replica" not in kv:
                raise ValueError(f"kill fault {part!r} needs host=<process index> "
                                 f"or replica=<serving replica index>")
            if kind == "kill" and "host" in kv and "replica" in kv:
                raise ValueError(f"kill fault {part!r}: host= (training harness) and "
                                 f"replica= (serving harness) are mutually exclusive")
            self.rules.append((kind, kv))
        self._lock = threading.Lock()
        self._counts: Counter = Counter()  # (kind, site) -> calls seen
        self._fired: set = set()  # once-only rules that already fired

    def describe(self) -> list:
        return [(k, dict(p)) for k, p in self.rules]

    def _fire_once(self, rule_id: int) -> bool:
        with self._lock:
            if rule_id in self._fired:
                return False
            self._fired.add(rule_id)
            return True

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

    def maybe_slow(self, site: str) -> None:
        """Millisecond sleep at a serving-stage site: `delay`'s twin for the
        request path, on its own counters, so a slow@ and a delay@ rule on
        one site do not move each other's schedules."""
        n = self._count("slow", site)
        for kind, p in self.rules:
            if kind != "slow" or p.get("site", site) != site:
                continue
            at, times = p.get("at", 1), p.get("times")
            if n >= at and (times is None or n < at + times):
                time.sleep(p["ms"] / 1e3)

    def corrupt_loss(self, loss: float, step: int) -> float:
        for kind, p in self.rules:
            if kind == "nan" and p["step"] <= step < p["step"] + p.get("times", 1):
                return float("nan")
        return loss

    def maybe_stall(self, step: int) -> None:
        for i, (kind, p) in enumerate(self.rules):
            if kind == "stall" and p["step"] == step and self._fire_once(i):
                print(f"injected fault: stalling {p['seconds']}s at step {step}", flush=True)
                time.sleep(p["seconds"])

    def maybe_preempt(self, step: int) -> None:
        for i, (kind, p) in enumerate(self.rules):
            if kind == "preempt" and p["step"] == step and self._fire_once(i):
                print(f"injected fault: SIGTERM self at step {step}", flush=True)
                os.kill(os.getpid(), signal.SIGTERM)

    def maybe_kill_host(self, step: int, workdir: Optional[str], process_index: int,
                        num_processes: int = 1) -> None:
        """`kill@host=i[:at=K]` (module docstring): rank i exits with
        KILL_EXIT_CODE in a world of several ranks; in a world of one, rank
        i's heartbeat file is stamped stale."""
        for i, (kind, p) in enumerate(self.rules):
            if kind != "kill" or "host" not in p or step < p.get("at", 1):
                continue
            host = p["host"]
            if num_processes > 1:
                if process_index == host and self._fire_once(i):
                    print(f"injected fault: killing host {host} (this process) at step {step}",
                          flush=True)
                    os._exit(KILL_EXIT_CODE)  # no beats, no cleanup: sudden death
            elif workdir and self._fire_once(i):
                path = os.path.join(workdir, f"heartbeat.p{host}.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"process": host, "host": f"killed@step={step}", "pid": 0,
                               "time": 0.0, "step": int(step), "epoch": 0}, f)
                os.replace(tmp, path)
                print(f"injected fault: simulated host {host} stopped beating at step {step}",
                      flush=True)

    def maybe_kill_replica(self, replica_index: int) -> None:
        """`kill@replica=i[:at=K]` (module docstring), keyed on this
        replica's own count of /embed and /neighbors POSTs, so the death
        lands at the same request however the router spreads the load."""
        n = self._count("kill", f"replica:{int(replica_index)}")
        for kind, p in self.rules:
            if kind != "kill" or p.get("replica") != int(replica_index):
                continue
            if n >= p.get("at", 1):
                print(f"injected fault: killing replica {replica_index} (this process) "
                      f"on request #{n}", flush=True)
                os._exit(KILL_EXIT_CODE)  # sudden death: no drain, no flush

    def deadlock_marker(self, site: str) -> bool:
        """Whether a `deadlock@site=L` rule names this traced lock."""
        return any(kind == "deadlock" and p.get("site") == site for kind, p in self.rules)

    def diverge_marker(self, site: str) -> str:
        """"#diverged" when a `diverge@site=S` rule names this comms site
        (the schedule recorder appends it to the site's signature), else
        ""."""
        for kind, p in self.rules:
            if kind == "diverge" and p.get("site") == site:
                return "#diverged"
        return ""

    def on_checkpoint_saved(self, path: str, step: int, wait=None) -> None:
        """Halve the file of the checkpoint written at `step` (once per
        rule): the file is in place and named as a good one, but its
        payload is short. `wait` blocks until an async write has landed."""
        for i, (kind, p) in enumerate(self.rules):
            if kind != "ckpt_truncate" or p["step"] != step or not self._fire_once(i):
                continue
            if wait is not None:
                wait()
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


def describe() -> list:
    return _PLAN.describe() if _PLAN else []


_COVERAGE_CB = None


def set_coverage_callback(cb) -> None:
    """Install (or clear, with None) the `cb(kind, site)` hook-reached
    callback (the module docstring)."""
    global _COVERAGE_CB
    _COVERAGE_CB = cb


def maybe_io_error(site: str) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("io", site)
    if _PLAN is not None:
        _PLAN.maybe_io_error(site)


def maybe_delay(site: str) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("delay", site)
    if _PLAN is not None:
        _PLAN.maybe_delay(site)


def maybe_slow(site: str) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("slow", site)
    if _PLAN is not None:
        _PLAN.maybe_slow(site)


def corrupt_loss(loss: float, step: int) -> float:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("nan", None)
    return _PLAN.corrupt_loss(loss, step) if _PLAN is not None else loss


def maybe_stall(step: int) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("stall", None)
    if _PLAN is not None:
        _PLAN.maybe_stall(step)


def maybe_preempt(step: int) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("preempt", None)
    if _PLAN is not None:
        _PLAN.maybe_preempt(step)


def maybe_kill_host(step: int, workdir: Optional[str], process_index: int,
                    num_processes: int = 1) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("kill", "host")
    if _PLAN is not None:
        _PLAN.maybe_kill_host(step, workdir, process_index, num_processes)


def maybe_kill_replica(replica_index: int) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("kill", "replica")
    if _PLAN is not None:
        _PLAN.maybe_kill_replica(replica_index)


def diverge_marker(site: str) -> str:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("diverge", site)
    return _PLAN.diverge_marker(site) if _PLAN is not None else ""


def deadlock_marker(site: str) -> bool:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("deadlock", site)
    return _PLAN.deadlock_marker(site) if _PLAN is not None else False


def strip_replica_kills(spec: Optional[str]) -> str:
    """`spec` without its `kill@replica=...` rules, the others verbatim and
    in order: the ReplicaSupervisor's spec for a reborn replica, so a kill
    rule fires once instead of crash-looping the respawn."""
    if not spec:
        return ""
    kept = []
    for part in spec.split(","):
        token = part.strip()
        kind, _, params = token.partition("@")
        if kind == "kill" and any(tok.partition("=")[0] == "replica"
                                  for tok in params.split(":")):
            continue
        if token:
            kept.append(token)
    return ",".join(kept)


def on_checkpoint_saved(path: str, step: int, wait=None) -> None:
    if _COVERAGE_CB is not None:
        _COVERAGE_CB("ckpt_truncate", None)
    if _PLAN is not None:
        _PLAN.on_checkpoint_saved(path, step, wait=wait)
