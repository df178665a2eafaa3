"""mfu.train: the whole training step's share of the card's bf16 peak, in
%: the model FLOPs of one image counted from the shapes (`counts.py`:
both encoders, the heads and the loss, forward and backward, no
recomputation) times the traced window's image rate, over 989 TFLOP/s."""

from benchmark import counts


def read(ctx):
    rate, cfg = ctx.get("imgs_per_s"), ctx.get("config")
    if not rate or ctx.get("driver") != "train":
        return None
    image = cfg["data"]["image_size"]
    moco = cfg["moco"]
    if moco.get("v3"):
        flops = counts.v3_train_flops_per_image(image, cfg["vit"], moco["dim"],
                                                cfg.get("mlp_hidden", 4096))
    else:
        flops = counts.v2_train_flops_per_image(image, moco["dim"], moco["num_negatives"],
                                                cfg.get("num_filters", 64))
    return 100.0 * flops * rate / counts.PEAK_BF16_FLOPS
