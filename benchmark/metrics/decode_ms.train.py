"""decode_ms.train: the host stage's mean `host_decode` span per batch, in
ms: the pipeline's load of a batch's images into a pinned slot
(`data/pipeline.py`, `data/datasets.py`), on the decode thread, over the
traced window."""

import statistics


def read(ctx):
    spans = [s["dur"] for s in ctx.get("spans", []) if s.get("name") == "host_decode"]
    return statistics.fmean(spans) / 1e3 if spans else None
