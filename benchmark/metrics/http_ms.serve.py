"""http_ms.serve: the HTTP front end's time per request, in ms: the mean
over the window's requests of their `ingress` (body read and parse),
`scatter` and `respond` (JSON encode and socket write) stages of the
request waterfall (`serve/server.py`, `obs/reqtrace.py`)."""

import statistics

STAGES = ("ingress", "scatter", "respond")


def read(ctx):
    w = ctx.get("waterfalls") or []
    per = [sum(s["dur_ms"] for s in r["stages"] if s["stage"] in STAGES) for r in w]
    return statistics.fmean(per) if per else None
