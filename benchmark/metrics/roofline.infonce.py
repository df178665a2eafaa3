"""roofline.infonce: the InfoNCE kernels' share of their roofline, in %:
the least time the forward and backward against the queue need
(`counts.infonce_bound_s`: 4·B·K·C operations at the TF32 rate, or q, k
and the queue read once and dq written once at 3.35 TB/s, whichever is
longer) over the summed device time of `csrc/infonce.cu`'s kernels per
step in the profiler window."""

from benchmark import counts, devtrace

KERNELS = ("infonce_", "fwd_merge_kernel", "bwd_reduce_kernel")


def read(ctx):
    trace, steps, cfg = ctx.get("trace") or {}, ctx.get("profiled_steps"), ctx.get("config")
    if not trace or not steps or cfg is None:
        return None
    spent = devtrace.kernel_seconds(trace["kernels"], KERNELS) / steps
    if spent <= 0:
        return None
    moco = cfg["moco"]
    bound = counts.infonce_bound_s(cfg["global_batch"], moco["num_negatives"], moco["dim"])
    return 100.0 * bound / spent
