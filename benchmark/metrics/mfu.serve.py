"""mfu.serve: the engine's share of the card's bf16 peak, in %: the
forward FLOPs of the window's served images (ResNet-50 and the MLP head
from the shapes, `counts.py`; padding rows excluded) over the summed
`engine_execute` time of the window's micro-batches, over 989 TFLOP/s."""

from benchmark import counts
from benchmark.waterfalls import batch_stage


def read(ctx):
    w, cfg = ctx.get("waterfalls") or [], ctx.get("config")
    engine_s = sum(batch_stage(w, "engine_execute").values()) / 1e3
    if not w or engine_s <= 0 or ctx.get("driver") != "serve":
        return None
    feat = 32 * cfg.get("num_filters", 64)
    per_image = (counts.resnet50_forward_flops(ctx["traffic"]["image_size"],
                                               cfg.get("num_filters", 64))
                 + counts.mlp_flops([feat, feat, cfg["moco"]["dim"]]))
    images = sum(r["rows"] for r in w)
    return 100.0 * per_image * images / engine_s / counts.PEAK_BF16_FLOPS
