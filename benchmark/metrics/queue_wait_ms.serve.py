"""queue_wait_ms.serve: the batcher's queue wait per request, in ms: the
mean `queue_wait` stage (submit to the start of the flush that carried
the request; `serve/batcher.py`) over the window's requests."""

import statistics


def read(ctx):
    w = ctx.get("waterfalls") or []
    per = [sum(s["dur_ms"] for s in r["stages"] if s["stage"] == "queue_wait") for r in w]
    return statistics.fmean(per) if per else None
