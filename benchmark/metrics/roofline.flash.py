"""roofline.flash: the flash-attention kernels' share of their roofline,
in %: per v3 step the two encoders' forwards (2 x depth calls) and the
query encoder's backward (depth calls), each bounded by
`counts.flash_bound_s` (bf16 operations at 989 TFLOP/s, or q, k, v, o,
dO, the gradients and the log-sum-exp moved once at 3.35 TB/s), over the
summed device time of `csrc/flash_attention.cu`'s kernels per step in
the profiler window."""

from benchmark import counts, devtrace

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def read(ctx):
    trace, steps, cfg = ctx.get("trace") or {}, ctx.get("profiled_steps"), ctx.get("config")
    if not trace or not steps or cfg is None or "vit" not in cfg:
        return None
    spent = devtrace.kernel_seconds(trace["kernels"], KERNELS) / steps
    if spent <= 0:
        return None
    vit = cfg["vit"]
    grid = cfg["data"]["image_size"] // vit["patch"]
    seq, head_dim = grid * grid + 1, vit["width"] // vit["heads"]
    bh = 2 * cfg["global_batch"] * vit["heads"]  # both views in one call
    bound = (2 * vit["depth"] * counts.flash_bound_s(bh, seq, head_dim, backward=False)
             + vit["depth"] * counts.flash_bound_s(bh, seq, head_dim, backward=True))
    return 100.0 * bound / spent
