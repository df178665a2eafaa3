"""Runtime arm of mocolint for the port: capture accounting and the
recompile guard (moco_tpu/analysis/runtime.py), `TrainConfig.strict_tracing`.

The port has no XLA compiler to watch. What it compiles at run time is
its CUDA graphs: the device augment's per-batch-shape capture
(data/pipeline.py `_GraphedAugment`), each a warm-up pass plus a capture,
which a shape that changes batch to batch would repeat every step.
Every capture calls `note_capture`; a :class:`CompileMonitor` reads the
captures made since it was made, `compile_cache_misses` on every
metrics.jsonl line under strict tracing, and the :class:`RecompileGuard`
keeps JAX's rule: captures are free during the warm-up steps, and one
after them aborts the run.

`jax.check_tracer_leaks` has no counterpart: an eager program has no
tracers to leak (ROADMAP.md, "By design").

Stdlib-only.
"""

from __future__ import annotations

import threading
from typing import Optional

_lock = threading.Lock()
_captures = 0


def note_capture() -> None:
    """Count one CUDA-graph capture (called by every capture site)."""
    global _captures
    with _lock:
        _captures += 1


def captures() -> int:
    """CUDA-graph captures this process has made."""
    with _lock:
        return _captures


class CompileMonitor:
    """The run's compile count: the CUDA-graph captures made since the
    monitor was created. Flat after warm-up on a healthy run; each later
    increment is a capture that some input change triggered."""

    def __init__(self):
        self._start = captures()

    def misses(self) -> int:
        return captures() - self._start


class RecompileError(RuntimeError):
    """A CUDA graph was captured after the warm-up window."""


class RecompileGuard:
    """Abort-on-recompile-after-step-N.

    `update(step, misses)` returns None while healthy. Past
    `warmup_steps`, a growing miss count returns a human-readable
    diagnosis string (the driver logs it to metrics.jsonl, then raises
    :class:`RecompileError`). Counting is driven by the caller, so the
    check costs nothing between log steps.
    """

    def __init__(self, warmup_steps: int):
        self.warmup_steps = warmup_steps
        self.baseline: Optional[int] = None

    def update(self, step: int, misses: int) -> Optional[str]:
        if step <= self.warmup_steps or self.baseline is None:
            self.baseline = misses
            return None
        if misses > self.baseline:
            return (
                f"a CUDA graph was captured after warm-up: {misses} captures "
                f"at step {step} vs {self.baseline} at the end of warm-up "
                f"(step {self.warmup_steps}) — look for varying batch shapes "
                "or dtypes from the input pipeline"
            )
        return None
