"""Training metrics: meters, the progress line, the JSONL writer and the
profiler regions (the counterparts of moco_tpu/utils/metrics.py).

`AverageMeter` / `ProgressMeter` print the reference's
`Epoch: [e][i/n] Time ... Loss ... Acc@1 ...` lines (`main_moco.py:~L322-360`);
`MetricWriter` is the metrics.jsonl sink (obs/sinks.py). Console lines come
from rank 0 only when torch.distributed is initialized, as the reference
silences the other ranks (`main_moco.py:~L145`).

`profiler_trace` and `ProfilerWindow` record a `torch.profiler` trace (the
host's ops and, on a card, its kernels) of a code region or of the global
steps [a, b), exported as a Chrome trace (`trace_<pid>_<n>.json` under the
log directory, viewable in Perfetto).
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from moco_tpu_torch.obs.sinks import JsonlSink


def is_primary() -> bool:
    """True on the process that owns console output: rank 0, or any
    process when torch.distributed is not initialized."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def print0(*args, **kwargs) -> None:
    """`print` on the primary process only."""
    if is_primary():
        print(*args, **kwargs)


class AverageMeter:
    """Running value and average, formatted like the reference's meter."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self) -> None:
        self.val = self.sum = self.count = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """`Epoch: [e][ i/n] <meters>` lines; `display` prints on the primary
    process and always returns the line."""

    def __init__(self, num_batches: int, meters: list, prefix: str = ""):
        num_digits = len(str(num_batches))
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print0(line, flush=True)
        return line


class MetricWriter(JsonlSink):
    """The JSONL sink under the name the driver and the probe use."""


# The profiler is process-wide: one capture at a time. Regions are
# reentrant: an inner region under an active one is a no-op.
_profiler_state: dict = {"active": None}
_trace_seq = itertools.count()


def _start_profiler(logdir: str) -> bool:
    """Start a capture; True when THIS call owns the stop."""
    if _profiler_state["active"] is not None:
        return False  # reentrant region: the outer one owns the capture
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _profiler_state["active"] = (prof, logdir)
    return True


def _stop_profiler() -> str:
    """Stop the capture and export its Chrome trace; returns the path."""
    prof, logdir = _profiler_state["active"]
    _profiler_state["active"] = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_trace_seq)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A `torch.profiler` capture around a code region, exported under
    `logdir`; a no-op when logdir is None, and inside another region."""
    if not logdir:
        yield
        return
    owns = _start_profiler(logdir)
    try:
        yield
    finally:
        if owns:
            _stop_profiler()


class ProfilerWindow:
    """Windowed `--profile-steps a:b` capture: exactly global steps [a, b)
    instead of the whole run. Drive with `on_step(gstep)` once per loop
    iteration (the step about to run); `close()` stops a still-open window
    (early exit, preemption)."""

    def __init__(self, logdir: str, start_step: int, end_step: int):
        if end_step <= start_step:
            raise ValueError(f"empty profile window [{start_step}, {end_step})")
        self.logdir = logdir
        self.start_step = int(start_step)
        self.end_step = int(end_step)
        self._owns = False
        self._done = False
        self.path: Optional[str] = None

    def on_step(self, gstep: int) -> None:
        if self._done:
            return
        if not self._owns and self.start_step <= gstep < self.end_step:
            self._owns = _start_profiler(self.logdir)
        elif self._owns and gstep >= self.end_step:
            self.close()

    def close(self) -> None:
        if self._owns:
            self._owns = False
            self.path = _stop_profiler()
        self._done = True


def parse_profile_steps(spec: str) -> Tuple[int, int]:
    """`"a:b"` -> (a, b), validated (the CLI's `--profile-steps`)."""
    try:
        a, b = spec.split(":")
        lo, hi = int(a), int(b)
    except ValueError:
        raise ValueError(f"--profile-steps wants 'a:b' (global steps), got {spec!r}")
    if hi <= lo or lo < 0:
        raise ValueError(f"--profile-steps window [{lo}, {hi}) is empty or negative")
    return lo, hi
