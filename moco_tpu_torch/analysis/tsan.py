"""Runtime lock-order / held-lock sanitizer (moco_tpu/analysis/tsan.py),
`TrainConfig.sanitize_threads` / `--sanitize-threads`.

The static pass (JX012/JX013) catches the provable races and
inversions; this is the runtime arm for the ones it cannot see (locks
acquired through foreign code, data-dependent paths, the cross-object
nesting a per-class analysis does not model). The failure it defends
against: two threads acquire the same two locks in opposite orders,
nothing errors, the replica just stops answering, with no artifact
saying which two stacks wedged it.

- **Injectable lock factory** — `make_lock(name)` (re-exported by
  utils/locks.py, which every named lock of the port goes through)
  returns a :class:`TracedLock` wrapping a `threading.Lock`. With no recorder installed the wrapper costs one
  module-global None check per acquire.
- **Order recording** — an installed :class:`LockOrderRecorder` keeps a
  per-thread stack of held locks. Acquiring B while holding A records
  the edge A→B with the acquiring stack, first-seen. A cycle appearing
  at acquire time, BEFORE the acquire blocks, means two code paths
  disagree on the order: the recorder dumps ``lock_order_diff.json``
  with both edges' stacks and (strict mode) raises
  :class:`LockOrderError`.
- **Held-lock blocking ops** — `install_profile()` hooks
  `sys.setprofile`/`threading.setprofile` and records calls that can
  block unboundedly (queue `put`/`get` with no timeout, `urlopen`,
  `time.sleep`, `Thread.join`, and the port's device syncs:
  `torch.cuda.synchronize`, `Event.synchronize`, `Stream.synchronize`
  and `Tensor.item()`) issued while a traced lock is held.
  Informational: they land in `report()`, they do not abort; some
  critical sections hold a lock across device work by design (the
  engine call under `serve.index`).
- **Chaos hook** — `deadlock@site=<lock>` (utils/faults.py) forces an
  inverted acquisition order at the named lock: when it is acquired
  while another lock is held, the recorder also records the edge the
  other order would have produced. Deterministic cycle, real detection
  path, no deadlock.

Stdlib-only: torch is never imported; blocking ops are matched by name.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from typing import Optional

# NB: `moco_tpu_torch.utils.faults` is imported inside the recorder hook,
# not here: the obs and serve modules build their locks at import time.


class LockOrderError(RuntimeError):
    """Two code paths acquire the same locks in opposite orders —
    aborting with both stacks beats deadlocking under load."""


class TracedLock:
    """A named lock that reports acquisition order to the installed
    recorder (no recorder: one global None check of overhead)."""

    def __init__(self, name: str):
        self.name = str(name)
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        rec = _RECORDER
        if rec is not None:
            rec.on_acquire_intent(self.name)
        got = self._lock.acquire(blocking, timeout)
        if rec is not None:
            if got:
                rec.on_acquired(self.name)
            else:
                rec.on_acquire_abandoned(self.name)
        return got

    def release(self) -> None:
        rec = _RECORDER
        self._lock.release()
        if rec is not None:
            rec.on_release(self.name)

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()


def make_lock(name: str) -> TracedLock:
    """The injectable factory: a drop-in `threading.Lock()` replacement
    that the runtime sanitizer can see."""
    return TracedLock(name)


def _stack(limit: int = 12) -> list[str]:
    """Compact acquiring-stack summary, tsan/this module frames pruned."""
    frames = traceback.extract_stack()[:-2]
    out = [
        f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
        for f in frames
        if "analysis/tsan" not in f.filename.replace(os.sep, "/")
    ]
    return out[-limit:]


class LockOrderRecorder:
    """Per-thread held-lock stacks + the process's lock-order graph.

    `strict=True` raises :class:`LockOrderError` at the acquire that
    closes a cycle (unit tests, the train driver); `strict=False`
    records the violation and keeps serving (the caller asserts on
    `report()` / the dumped artifact instead of crashing mid-request).
    """

    def __init__(self, workdir: Optional[str] = None, strict: bool = True):
        self.workdir = workdir
        self.strict = strict
        self._tls = threading.local()
        self._mu = threading.Lock()  # guards the graph, never user locks
        # (held, acquired) -> {"thread", "stack", "injected"} first-seen
        self.edges: dict[tuple[str, str], dict] = {}
        self.cycles: list[dict] = []
        self.blocking_ops: list[dict] = []
        self.acquisitions = 0

    # -- per-thread state --------------------------------------------------

    def _held(self) -> list[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_locks(self) -> list[str]:
        return list(self._held())

    # -- acquire/release hooks --------------------------------------------

    def on_acquire_intent(self, name: str) -> None:
        """Called BEFORE blocking on the lock: record the would-be
        edges and check for a cycle while this thread can still abort."""
        held = self._held()
        if not held:
            return
        stack = _stack()
        thread = threading.current_thread().name
        new_edges: list[tuple[str, str, bool]] = [
            (h, name, False) for h in held if h != name
        ]
        # deadlock@site=<lock>: the fault forces the INVERTED order to be
        # recorded too, as if another thread raced the opposite way — a
        # deterministic cycle through the real detection path
        from moco_tpu_torch.utils import faults

        if faults.deadlock_marker(name):
            new_edges.extend((name, h, True) for h in held if h != name)
        with self._mu:
            for a, b, injected in new_edges:
                self.edges.setdefault(
                    (a, b),
                    {"thread": thread, "stack": stack, "injected": injected},
                )
            cycle = self._find_cycle(name)
        if cycle is not None:
            self._report_cycle(cycle, name, stack, thread)

    def on_acquired(self, name: str) -> None:
        self._held().append(name)
        with self._mu:
            self.acquisitions += 1

    def on_acquire_abandoned(self, name: str) -> None:
        pass  # non-blocking acquire that failed: nothing held

    def on_release(self, name: str) -> None:
        held = self._held()
        if name in held:
            held.remove(name)

    # -- blocking ops (profile hook) --------------------------------------

    def on_blocking_op(self, desc: str) -> None:
        held = self._held()
        if not held:
            return
        with self._mu:
            if len(self.blocking_ops) < 256:
                self.blocking_ops.append(
                    {
                        "op": desc,
                        "held": list(held),
                        "thread": threading.current_thread().name,
                        "stack": _stack(),
                    }
                )

    # -- cycle detection ---------------------------------------------------

    def _find_cycle(self, start: str) -> Optional[list[str]]:
        """A cycle through `start` in the edge graph (call with _mu held).
        Lock counts are single digits; DFS is plenty."""
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        path = [start]
        seen = {start}

        def dfs(cur: str) -> Optional[list[str]]:
            for nxt in sorted(adj.get(cur, ())):
                if nxt == start:
                    return path + [start]
                if nxt not in seen:
                    seen.add(nxt)
                    path.append(nxt)
                    hit = dfs(nxt)
                    if hit is not None:
                        return hit
                    path.pop()
            return None

        return dfs(start)

    def _report_cycle(
        self, cycle: list[str], name: str, stack: list[str], thread: str
    ) -> None:
        with self._mu:
            edge_dump = [
                {
                    "held": a,
                    "acquired": b,
                    "thread": info["thread"],
                    "injected": info["injected"],
                    "stack": info["stack"],
                }
                for (a, b), info in sorted(self.edges.items())
                if a in cycle and b in cycle
            ]
            record = {
                "cycle": cycle,
                "acquiring": {"lock": name, "thread": thread, "stack": stack},
                "edges": edge_dump,
            }
            self.cycles.append(record)
        path = self.dump(record)
        msg = (
            f"lock-order cycle: {' -> '.join(cycle)} — thread {thread!r} "
            f"acquiring {name!r} closes an order another path recorded "
            "inverted; both acquisition stacks in "
            + (path or "report()")
        )
        if self.strict:
            raise LockOrderError(msg)
        print(f"WARNING: {msg}", flush=True)

    def dump(self, record: dict) -> Optional[str]:
        """Write ``lock_order_diff.json`` (atomic replace) when a workdir
        is configured; returns the path."""
        if not self.workdir:
            return None
        os.makedirs(self.workdir, exist_ok=True)
        path = os.path.join(self.workdir, "lock_order_diff.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=2)
        os.replace(tmp, path)
        return path

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """The run's lock-order summary (`lock_order.json` on close):
        edges observed, cycles caught, blocking ops seen under a lock
        (informational)."""
        with self._mu:
            return {
                "acquisitions": self.acquisitions,
                "edges": [
                    {"held": a, "acquired": b, "injected": info["injected"]}
                    for (a, b), info in sorted(self.edges.items())
                ],
                "cycles": [dict(c) for c in self.cycles],
                "blocking_ops_under_lock": [dict(b) for b in self.blocking_ops],
            }


# -- module-level hook (read by every TracedLock) --------------------------

_RECORDER: Optional[LockOrderRecorder] = None


def install_recorder(
    recorder: Optional[LockOrderRecorder],
) -> Optional[LockOrderRecorder]:
    """Install (or clear, with None) the process-wide recorder; returns
    the previous one so tests can restore it."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = recorder
    return prev


def get_recorder() -> Optional[LockOrderRecorder]:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


# -- blocking-op profile hook ----------------------------------------------

# code-object names that can block unboundedly, matched per call event;
# (co_name, filename fragment or None). `synchronize` is torch.cuda's
# function and the Event / Stream methods (torch/cuda/__init__.py and
# streams.py); `Tensor.item()` is a C method, matched on c_call below.
_BLOCKING_CO = {
    ("put", "queue.py"),
    ("get", "queue.py"),
    ("urlopen", "request.py"),
    ("synchronize", "cuda"),
    ("_wait_for_tstate_lock", "threading.py"),  # Thread.join's blocking core
}

_PREV_PROFILE = None
_PREV_THREAD_PROFILE = None


def _profile(frame, event, arg):
    rec = _RECORDER
    if rec is None:
        return
    if event == "c_call":  # builtins come through as c_call, arg = the fn
        name = getattr(arg, "__name__", "")
        if name == "sleep" and getattr(arg, "__module__", None) == "time":
            rec.on_blocking_op("time.sleep")
        elif name == "item" and type(getattr(arg, "__self__", None)).__name__ in (
            "Tensor", "Parameter"
        ):
            rec.on_blocking_op("Tensor.item()")  # a device tensor's read syncs
        return
    if event != "call":
        return
    co = frame.f_code
    for name, frag in _BLOCKING_CO:
        if co.co_name != name:
            continue
        if frag is not None and frag not in co.co_filename:
            continue
        # queue put/get with a timeout are bounded — not a finding
        if name in ("put", "get"):
            loc = frame.f_locals
            if loc.get("timeout") is not None or loc.get("block") is False:
                return
        rec.on_blocking_op(f"{name} ({os.path.basename(co.co_filename)})")
        return


def install_profile() -> None:
    """Watch for blocking calls under a traced lock, process-wide (new
    threads via `threading.setprofile`, the caller via `sys.setprofile`).
    Smoke-run tooling: profile hooks cost real CPU (PERF.md has the
    serving p50 with it on and off)."""
    global _PREV_PROFILE, _PREV_THREAD_PROFILE
    _PREV_PROFILE = sys.getprofile()
    threading.setprofile(_profile)
    sys.setprofile(_profile)


def uninstall_profile() -> None:
    threading.setprofile(None)
    sys.setprofile(_PREV_PROFILE)


class ThreadSanitizer:
    """The `--sanitize-threads` driver arm: install the recorder (+
    profile hook), run, `close()` to restore and write the report.

    `strict` follows the context: True for the train driver (abort the
    run at the cycle, like ScheduleDivergenceError), False around a
    serving burst (record, dump, keep answering; the caller asserts on
    the artifacts)."""

    def __init__(
        self,
        workdir: Optional[str] = None,
        strict: bool = True,
        profile: bool = True,
    ):
        self.recorder = LockOrderRecorder(workdir=workdir, strict=strict)
        self._prev = install_recorder(self.recorder)
        self._profiling = bool(profile)
        if self._profiling:
            install_profile()

    def check(self) -> None:
        """Raise if any cycle was recorded (non-strict recorders defer
        the abort decision to this, the log-step-shaped hook)."""
        if self.recorder.cycles:
            raise LockOrderError(
                f"{len(self.recorder.cycles)} lock-order cycle(s) recorded — "
                "see lock_order_diff.json"
            )

    def report(self) -> dict:
        return self.recorder.report()

    def close(self) -> dict:
        """Restore hooks, write ``lock_order.json`` (when a workdir is
        configured), return the report."""
        if self._profiling:
            uninstall_profile()
            self._profiling = False
        install_recorder(self._prev)
        rep = self.report()
        if self.recorder.workdir:
            os.makedirs(self.recorder.workdir, exist_ok=True)
            path = os.path.join(self.recorder.workdir, "lock_order.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rep, f, indent=2)
            os.replace(tmp, path)
        return rep


__all__ = [
    "LockOrderError",
    "LockOrderRecorder",
    "ThreadSanitizer",
    "TracedLock",
    "enabled",
    "get_recorder",
    "install_profile",
    "install_recorder",
    "make_lock",
    "uninstall_profile",
]
