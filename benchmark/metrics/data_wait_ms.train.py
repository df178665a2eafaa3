"""data_wait_ms.train: the loop's mean wait for the next batch from the
prefetch ring (`data_ms` of each step's record; `data/device_prefetch.py`,
`data/augment.py`), in ms, over the traced window."""

import statistics


def read(ctx):
    waits = [r["data_ms"] for r in ctx.get("records", []) if "data_ms" in r]
    return statistics.fmean(waits) if waits else None
