"""Runtime collective-schedule sanitizer (moco_tpu/analysis/sanitizer.py),
`TrainConfig.sanitize_collectives` / `--sanitize-collectives`: catch a
divergence between ranks BEFORE the hang.

A collective mismatch does not error: every healthy rank blocks in its
next collective waiting for the one rank that took a different path,
until the group's timeout or the stall watchdog ends the job with
nothing to diagnose.

- Every `obs/comms.py` `CommsLedger.record` (the port's collective
  sites: `World`'s collectives, ZeRO's, the ring's shift, `input.h2d`)
  also records ``(site, kind, operand shape signature)`` into a
  process-local :class:`ScheduleRecorder` in FIRST-SEEN ORDER. The port
  records on every eager call of every step (JAX records once per
  trace), so the recorder is idempotent: a repeated entry is dropped,
  and the hash is the schedule, not the step count. A site whose
  signature changes is a new entry, so a rank that re-specialized
  mid-run hashes differently. With no recorder installed the hook is a
  None check.
- On log steps the driver's :class:`ScheduleSanitizer` publishes the
  schedule and its sha1 to ``schedule.p<i>.json`` (atomic replace, the
  heartbeat files' mechanism) and cross-checks every peer's file. A hash
  mismatch renders a per-site diff (missing sites, extra sites,
  kind/shape disagreements, order skew), writes it to
  ``schedule_diff.json``, and raises :class:`ScheduleDivergenceError`.
- The `diverge@site=S` fault kind (utils/faults.py) perturbs this
  process's recorded entry at site S, so a test or chip_smoke proves
  the detector end to end without a really divergent world.

Stdlib-only: the caller computes the shape signature (obs/comms.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional

from moco_tpu_torch.utils import faults


class ScheduleDivergenceError(RuntimeError):
    """Processes disagree on the collective schedule. Aborting now, with
    a per-site diff, beats deadlocking in the next collective."""


class ScheduleRecorder:
    """Ordered (site, kind, shape-signature) record of every collective
    this process has issued. First-seen order IS the issue order (the
    first step walks the schedule in program order); a site whose
    kind/signature CHANGES later is recorded as a new entry, so a
    process that re-specialized mid-run also hashes differently."""

    def __init__(self, process_index: int = 0):
        self.process_index = int(process_index)
        self._lock = threading.Lock()
        self._entries: list[tuple[str, str, str]] = []
        self._seen: set[tuple[str, str, str]] = set()

    def record(self, site: str, kind: str, signature: str) -> None:
        # deterministic fault hook: diverge@site=S perturbs THIS
        # process's view of the site, for end-to-end detector tests
        marker = faults.diverge_marker(site)
        if marker:
            signature = f"{signature}{marker}"
        entry = (str(site), str(kind), signature)
        with self._lock:
            if entry not in self._seen:
                self._seen.add(entry)
                self._entries.append(entry)

    def entries(self) -> list[tuple[str, str, str]]:
        with self._lock:
            return list(self._entries)

    def schedule_hash(self) -> str:
        payload = "\n".join("|".join(e) for e in self.entries())
        return hashlib.sha1(payload.encode("utf-8")).hexdigest()

    def payload(self) -> dict:
        """Metrics-line field: short schedule hash (stable across a
        healthy run — dashboards watch it for FLATNESS, like
        compile_cache_misses)."""
        return {"collective_schedule_hash": self.schedule_hash()[:12]}


# -- module-level hook (called from obs/comms.py CommsLedger.record) -------

_RECORDER: Optional[ScheduleRecorder] = None


def install_recorder(recorder: Optional[ScheduleRecorder]) -> Optional[ScheduleRecorder]:
    """Install (or clear, with None) the process-wide recorder; returns
    the previous one so tests can restore it."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = recorder
    return prev


def get_recorder() -> Optional[ScheduleRecorder]:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


def on_tag(site: str, kind: str, signature: str) -> None:
    """`CommsLedger.record`'s hook — no-op unless a recorder is installed."""
    if _RECORDER is not None:
        _RECORDER.record(site, kind, signature)


# -- cross-process check ---------------------------------------------------


def schedule_path(workdir: str, process_index: int) -> str:
    return os.path.join(workdir, f"schedule.p{process_index}.json")


def _render_diff(mine: list, theirs: list, peer: int) -> list[str]:
    """Human-readable per-site diff between two schedules."""
    mine_t = [tuple(e) for e in mine]
    theirs_t = [tuple(e) for e in theirs]
    my_sites = {e[0]: e for e in mine_t}
    their_sites = {e[0]: e for e in theirs_t}
    lines: list[str] = []
    for site in sorted(set(my_sites) | set(their_sites)):
        a, b = my_sites.get(site), their_sites.get(site)
        if a == b:
            continue
        if b is None:
            lines.append(f"  site {site!r}: only THIS process issues it ({a[1]} {a[2]})")
        elif a is None:
            lines.append(f"  site {site!r}: only process {peer} issues it ({b[1]} {b[2]})")
        else:
            lines.append(
                f"  site {site!r}: this process {a[1]} {a[2]} vs "
                f"process {peer} {b[1]} {b[2]}"
            )
    if not lines:  # same site set, different order
        my_order = [e[0] for e in mine_t]
        their_order = [e[0] for e in theirs_t]
        lines.append(
            f"  same sites, different issue order: this process {my_order} "
            f"vs process {peer} {their_order}"
        )
    return lines


class ScheduleSanitizer:
    """Publish-and-cross-check driver arm (see module docstring).

    `check()` is cheap (one small JSON write + at most N-1 small reads)
    and runs on log steps only. Peers that have not published yet are
    skipped; the port's driver publishes before the log step's agreement
    collective and checks after it, so every live rank's file is there.
    A DEAD peer is the heartbeat monitor's job, not this one's.
    """

    def __init__(
        self,
        workdir: str,
        process_index: int = 0,
        num_processes: int = 1,
        recorder: Optional[ScheduleRecorder] = None,
    ):
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.process_index = int(process_index)
        self.num_processes = int(num_processes)
        self.recorder = recorder or ScheduleRecorder(process_index)
        self.path = schedule_path(workdir, self.process_index)
        self.diff_path = os.path.join(workdir, "schedule_diff.json")
        self._published_hash: Optional[str] = None

    def publish(self, step: int = 0) -> str:
        """Write this process's schedule file (atomic replace); returns
        the hash. Skips the write when the schedule is unchanged."""
        h = self.recorder.schedule_hash()
        if h == self._published_hash:
            return h
        rec = {
            "process": self.process_index,
            "step": int(step),
            "time": time.time(),
            "hash": h,
            "schedule": [list(e) for e in self.recorder.entries()],
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)
        self._published_hash = h
        return h

    def _read_peer(self, peer: int) -> Optional[dict]:
        try:
            with open(schedule_path(self.workdir, peer)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def check(self, step: int = 0) -> None:
        """Publish, then compare against every published peer. Raises
        :class:`ScheduleDivergenceError` with a per-site diff on any
        hash mismatch (also written to ``schedule_diff.json``)."""
        my_hash = self.publish(step)
        mine = [list(e) for e in self.recorder.entries()]
        diffs: list[str] = []
        divergent: list[int] = []
        for peer in range(self.num_processes):
            if peer == self.process_index:
                continue
            rec = self._read_peer(peer)
            if rec is None:
                continue  # not published yet / dead (heartbeat's job)
            if rec.get("hash") == my_hash:
                continue
            divergent.append(peer)
            diffs.append(
                f"process {self.process_index} (hash {my_hash[:12]}) vs "
                f"process {peer} (hash {str(rec.get('hash'))[:12]}):"
            )
            diffs.extend(_render_diff(mine, rec.get("schedule", []), peer))
        if not divergent:
            return
        artifact = {
            "step": int(step),
            "process": self.process_index,
            "divergent_peers": divergent,
            "diff": diffs,
            "schedule": mine,
        }
        # every rank of a world shares the workdir, and each aborts with its
        # own diff: the temporary file is this process's, the last rename wins
        tmp = f"{self.diff_path}.p{self.process_index}.tmp"
        with open(tmp, "w") as f:
            json.dump(artifact, f, indent=2)
        os.replace(tmp, self.diff_path)
        raise ScheduleDivergenceError(
            f"collective schedules diverged at step {step} — aborting before "
            "the world deadlocks in a mismatched collective.\n"
            + "\n".join(diffs)
            + f"\n(full diff written to {self.diff_path})"
        )


__all__ = [
    "ScheduleDivergenceError",
    "ScheduleRecorder",
    "ScheduleSanitizer",
    "enabled",
    "get_recorder",
    "install_recorder",
    "on_tag",
    "schedule_path",
]
