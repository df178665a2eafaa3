"""engine_ms.serve: the engine's time per micro-batch, in ms: the mean
`engine_execute` stage (the encoder's forward, the card waited on;
`serve/engine.py`) over the window's micro-batches, each counted once
whatever number of requests rode it."""

import statistics

from benchmark.waterfalls import batch_stage


def read(ctx):
    per = batch_stage(ctx.get("waterfalls") or [], "engine_execute")
    return statistics.fmean(per.values()) if per else None
