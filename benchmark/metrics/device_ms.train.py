"""device_ms.train: the card's busy time per training step, in ms: the
union of the device intervals on every stream over the profiler window,
divided by the whole steps it covers. The host's share of a step falls
out of it, so it spreads far less from run to run than the window's
image rate, which a noisy host moves."""


def read(ctx):
    trace, steps = ctx.get("trace") or {}, ctx.get("profiled_steps")
    if ctx.get("driver") != "train" or not trace.get("busy_s") or not steps:
        return None
    return 1e3 * trace["busy_s"] / steps
