"""device_idle.train: the share of the profiler window in which no kernel,
copy or memset ran on any stream of the card, in %: 1 - the union of the
device intervals over the window's wall time, over whole training steps
in the middle of the traced window."""


def read(ctx):
    trace = ctx.get("trace") or {}
    if ctx.get("driver") != "train" or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
