"""The metrics.jsonl sink (the `JsonlSink` of moco_tpu/obs/sinks.py). The
CSV, TensorBoard and Prometheus sinks come with a later slice."""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch


def _scrub(v):
    """JSON-safe value: non-finite floats -> None (NaN/Inf are invalid
    strict JSON; the guard writes its own event for a non-finite loss),
    numpy and 0-dim torch scalars -> Python, arrays -> scrubbed lists."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return _scrub(v.item()) if v.ndim == 0 else [_scrub(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_scrub(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        v = float(v)
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def sanitize(rec: dict) -> dict:
    return {k: _scrub(v) for k, v in rec.items()}


class JsonlSink:
    """Append-only JSONL metrics, one object per log event. Every line is
    flushed to the OS as written, so a killed process loses at most the
    line being formatted; `fsync` makes the tail durable across a host
    crash. Line schema: obs/schema.py."""

    def __init__(self, workdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, filename)
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, payload: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update(sanitize(payload))
        self._f.write(json.dumps(rec, allow_nan=False) + "\n")
        self._f.flush()

    def fsync(self) -> None:
        if not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self.fsync()
            self._f.close()
