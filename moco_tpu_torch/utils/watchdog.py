"""Stall watchdog (moco_tpu/utils/watchdog.py): detect a wedged train step
and fail loudly.

A hung NCCL or CUDA call blocks the main thread for good, and no
Python-level timeout can interrupt it, so the watch runs in a sidecar
thread: the train loop `beat()`s after every step, and when beats stop
for longer than `timeout` the watchdog dumps every thread's stack (where
it hung), runs a bounded `on_stall` callback (the driver's emergency
checkpoint), and exits with STALL_EXIT_CODE so a supervisor restarts the
process into its automatic resume.

`startup_grace` covers the first step's one-time costs (the kernels' nvcc
build, cuDNN's autotuning): until the first beat, the effective timeout is
`max(timeout, startup_grace)`.

`exit_fn` is injectable so tests observe the firing without killing the
test process; production uses `os._exit`, since a wedged device runtime
cannot be trusted to run atexit handlers or release locks.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

from moco_tpu_torch.utils.contracts import STALL_EXIT_CODE


class StepWatchdog:
    def __init__(
        self,
        timeout: float,
        on_stall: Optional[Callable[[], None]] = None,
        dump_path: Optional[str] = None,
        startup_grace: float = 900.0,
        poll: Optional[float] = None,
        exit_code: int = STALL_EXIT_CODE,
        exit_fn: Callable[[int], None] = os._exit,
    ):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be > 0 (use no watchdog to disable)")
        self.timeout = float(timeout)
        self.on_stall = on_stall
        self.dump_path = dump_path
        self.startup_grace = float(startup_grace)
        self.poll = poll if poll is not None else max(0.2, min(5.0, timeout / 4.0))
        self.exit_code = exit_code
        self.exit_fn = exit_fn
        self._last = time.monotonic()
        self._beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StepWatchdog":
        self._last = time.monotonic()  # mocolint: disable=JX012  (lock-free by design: beat() sits on the step hot path; a monotonic float STORE is GIL-atomic and the watchdog thread only READS it, tolerating one poll of staleness)
        self._thread = threading.Thread(target=self._run, name="moco-step-watchdog", daemon=True)
        self._thread.start()
        return self

    def beat(self) -> None:
        """One step completed; called from the train loop (a timestamp
        store, no lock, no device work)."""
        self._last = time.monotonic()
        self._beats += 1  # mocolint: disable=JX012  (single writer — only the train loop beats; the watchdog thread reads it solely to pick the startup-grace limit, where a stale value is harmless)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll)

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            limit = self.timeout if self._beats else max(self.timeout, self.startup_grace)
            idle = time.monotonic() - self._last
            if idle > limit:
                self._fire(idle)
                return

    def _fire(self, idle: float) -> None:
        print(f"WATCHDOG: no step completed for {idle:.1f}s (timeout {self.timeout:.1f}s, "
              f"{self._beats} beats): dumping stacks", file=sys.stderr, flush=True)
        if self.dump_path:
            try:
                with open(self.dump_path, "w") as f:
                    faulthandler.dump_traceback(file=f, all_threads=True)
            except OSError:
                pass
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        if self.on_stall is not None:
            try:
                self.on_stall()
            except Exception as e:  # the emergency path must not mask the exit
                print(f"WATCHDOG: on_stall raised {e!r}", file=sys.stderr, flush=True)
        self.exit_fn(self.exit_code)
