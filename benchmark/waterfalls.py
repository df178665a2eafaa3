"""Request waterfalls (`obs/reqtrace.py`'s records) folded into
micro-batches: the stages a batch's riders share are counted once."""

from __future__ import annotations

SAME_BATCH_MS = 0.05  # riders' stamps of one shared stage differ by clock reads only


def batch_stage(waterfalls: list, stage: str) -> dict:
    """{the stage's start in ms on the wall clock: its duration in ms} for
    `stage`, one entry per micro-batch: starts closer than SAME_BATCH_MS
    are one batch's riders."""
    starts = sorted((w["wall_t0"] * 1e3 + s["start_ms"], s["dur_ms"])
                    for w in waterfalls for s in w["stages"] if s["stage"] == stage)
    out, last = {}, None
    for start, dur in starts:
        if last is None or start - last >= SAME_BATCH_MS:
            out[start] = dur
        last = start
    return out
