"""Named locks for the serving threads.

The JAX package makes its locks through a factory that can record their
acquisition order (moco_tpu/analysis/tsan.py). The port has no such
recorder yet (it is a later item of the port's queue, with the analysis
tools); until then the factory hands out a plain lock, so the call sites
already name their locks.
"""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    del name  # the order recorder keys on it
    return threading.Lock()
