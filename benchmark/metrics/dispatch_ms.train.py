"""dispatch_ms.train: the host's time to issue one training step, in ms:
the step-time probe's `t_dispatch`, with the probe waiting on the card
before and after every step (`train.py`'s loop, `core/moco.py`), so the
time is the host's alone."""

import statistics


def read(ctx):
    t = ctx.get("dispatch_s") or []
    return statistics.fmean(t) * 1e3 if t else None
