"""device_idle.serve: the share of the profiler window, in the middle of
the traced serving window, in which no kernel, copy or memset ran on any
stream of the card, in %."""


def read(ctx):
    trace = ctx.get("trace") or {}
    if ctx.get("driver") != "serve" or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
