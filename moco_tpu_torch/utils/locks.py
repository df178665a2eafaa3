"""Named locks for the port's threads.

Every named lock of the port comes from this factory: a
`analysis/tsan.py` TracedLock, which reports its acquisitions to the
lock-order recorder when one is installed (`TrainConfig.sanitize_threads`,
or `tsan.ThreadSanitizer` around a serving burst) and costs one None check
per acquire otherwise. The names are utils/contracts.py's `LOCK_SITES`,
which the `deadlock@site=<lock>` fault keys on.
"""

from __future__ import annotations

from moco_tpu_torch.analysis.tsan import TracedLock, make_lock

__all__ = ["TracedLock", "make_lock"]
