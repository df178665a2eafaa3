"""The device trace of a traced run: a `torch.profiler` window opened and
closed by the driver (the card synchronized at both ends), read back from
its Chrome export into kernel intervals, the busy time (the union of the
intervals on every stream), the idle gaps labelled by the host activity
that covers them, and the device operations that took most time.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

MARK_BYTES = 7777  # a device copy of this size marks each end of a window
LABELLED_GAPS = 400  # the longest idle gaps, each named by the host op covering it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class ProfilerWindow:
    """`open()` starts the profiler, `begin()` and `end()` mark the window
    with a device copy of `MARK_BYTES` each (the card synchronized around
    them, so the window holds whole steps), and `stop()` reads the events
    back. `host_ops=False` records the card's activity alone: a server
    whose threads share the interpreter lock slows under the recording of
    every host op, and the idle gaps then go unlabelled."""

    def __init__(self, device, host_ops: bool = True):
        self.device = device
        self.host_ops = host_ops
        self.prof = None
        self.ended = False
        self.events: list = []

    def _sync(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)

    def _mark(self) -> None:
        import torch

        src = torch.zeros(MARK_BYTES, dtype=torch.uint8, device=self.device)
        torch.empty_like(src).copy_(src)

    def open(self) -> None:
        """Start the profiler; the window begins at `begin`."""
        import torch

        self._sync()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host_ops:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def begin(self) -> None:
        self._sync()
        self._mark()

    def start(self) -> None:
        self.open()
        self.begin()

    def end(self) -> None:
        """Close the window, leaving the profiler running: its stop parses
        every event in Python, under the interpreter lock, which a caller
        may want to do later."""
        if not self.ended:
            self._mark()
            self._sync()
        self.ended = True

    def stop(self) -> None:
        """End the window if it is open, stop the profiler and read its
        events."""
        self.end()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")  # under the run's TMPDIR
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """(start, end) of [lo, hi) that no interval covers, in order."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(events: list) -> dict:
    """From Chrome trace events (microseconds): {"window_s", "busy_s",
    "kernels": [(name, start_us, dur_us)], "device_ops", "idle_gaps"} over
    the window between the first and the last `MARK_BYTES` copy; {}
    without two."""
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "gpu_memcpy" and "dur" in e
                   and (e.get("args") or {}).get("bytes") == MARK_BYTES)
    if len(marks) < 2:
        return {}
    lo, hi = marks[0][0], marks[-1][1]
    kernels = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a = max(float(e["ts"]), lo)
            b = min(float(e["ts"]) + float(e["dur"]), hi)
            if b > a:
                kernels.append((e["name"], a, b - a))
    busy = union_length([(a, a + d) for _, a, d in kernels])
    by_op = defaultdict(float)
    for name, _, d in kernels:
        by_op[name] += d
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
    h0 = np.array([float(e["ts"]) for e in host])
    h1 = h0 + np.array([float(e["dur"]) for e in host])
    by_label = defaultdict(float)
    idle = sorted(gaps([(a, a + d) for _, a, d in kernels], lo, hi), key=lambda g: g[0] - g[1])
    for rank, (a, b) in enumerate(idle):
        if rank >= LABELLED_GAPS:  # the many short gaps, counted together
            by_label["(shorter gaps)"] += b - a
            continue
        mid = 0.5 * (a + b)
        covering = np.nonzero((h0 <= mid) & (h1 >= mid))[0]
        label = (host[int(covering[np.argmin(h1[covering] - h0[covering])])]["name"]
                 if len(covering) else "(no host op)")
        by_label[label] += b - a
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6, "kernels": kernels,
            "device_ops": [[n, s / 1e6] for n, s in top],
            "idle_gaps": [[n, s / 1e6] for n, s in idle]}


def kernel_seconds(kernels: list, names) -> float:
    """Summed device seconds of the kernels whose name contains any of `names`."""
    return sum(d for n, _, d in kernels if any(k in n for k in names)) / 1e6
