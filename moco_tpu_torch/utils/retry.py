"""Bounded retrying for host-side I/O (exponential backoff + jitter); the
port's copy of moco_tpu/utils/retry.py, with the same sites, counters and
environment knobs.

The reference's failure story is "restart by hand with `--resume`"
(SURVEY.md §5.3); on preemptible fleets reading datasets and writing
checkpoints over GCS/NFS, transient `OSError`s are routine and must
degrade to a *logged retry*, not an aborted epoch. Every wrapped call
site names itself (`site=`), and the per-site retry counters
(`snapshot()`) make a flaky filesystem observable, not silent.

Defaults are env-tunable (no config plumbing needed for ops knobs):
    MOCO_IO_RETRIES      total attempts per call (default 4)
    MOCO_IO_RETRY_BASE   first backoff in seconds (default 0.2)
    MOCO_IO_RETRY_MAX    backoff ceiling in seconds (default 5.0)

Only `OSError` (and subclasses — `IOError` is an alias) retries by
default: logic errors like a corrupt-cache `ValueError` must propagate
immediately, not burn the backoff budget masking a real bug.
"""

from __future__ import annotations

import os
import random
import time
from collections import Counter
from typing import Callable, Optional, Tuple, Type

from moco_tpu_torch.utils.locks import make_lock

_lock = make_lock("utils.retry")
_retries: Counter = Counter()  # site -> number of retried failures


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def default_attempts() -> int:
    return max(1, int(_env_float("MOCO_IO_RETRIES", 4)))


def retry_call(
    fn: Callable,
    *args,
    site: str,
    attempts: Optional[int] = None,
    base_delay: Optional[float] = None,
    max_delay: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
    **kwargs,
):
    """Call `fn(*args, **kwargs)`, retrying transient failures.

    Backoff before attempt k (1-based retries) is
    `min(max_delay, base_delay * 2**(k-1))` scaled by a uniform [0.5,
    1.5) jitter, so a fleet of workers hitting the same flaky store does
    not retry in lockstep. The final attempt's exception propagates
    unchanged. `sleep` is injectable for tests.
    """
    attempts = attempts if attempts is not None else default_attempts()
    base_delay = base_delay if base_delay is not None else _env_float("MOCO_IO_RETRY_BASE", 0.2)
    max_delay = max_delay if max_delay is not None else _env_float("MOCO_IO_RETRY_MAX", 5.0)
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            with _lock:
                _retries[site] += 1
            delay = min(max_delay, base_delay * (2**attempt)) * (0.5 + random.random())
            print(
                f"retry[{site}]: attempt {attempt + 1}/{attempts} failed "
                f"({e!r}); retrying in {delay:.2f}s",
                flush=True,
            )
            sleep(delay)


def snapshot(reset: bool = False) -> dict:
    """Per-site retry counts since process start (or the last reset).
    Empty dict when nothing retried — callers can `if snapshot():`."""
    with _lock:
        out = {k: int(v) for k, v in _retries.items() if v}
        if reset:
            _retries.clear()
    return out
