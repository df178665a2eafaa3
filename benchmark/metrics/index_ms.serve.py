"""index_ms.serve: the index's time per micro-batch, in ms: the mean
`index_query` stage (the IVF cell scan and top-k; `serve/index.py`,
`ops/ivf_scan.py`, `csrc/ivf_cell_scores.cu`) over the window's
micro-batches, each counted once."""

import statistics

from benchmark.waterfalls import batch_stage


def read(ctx):
    per = batch_stage(ctx.get("waterfalls") or [], "index_query")
    return statistics.fmean(per.values()) if per else None
