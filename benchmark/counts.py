"""The yardstick's arithmetic: the card's published peaks, the model FLOPs
of the encoders from their shapes, and the operations and bytes each
kernel's algorithm needs, counted once (no split products, no recomputed
scores), so a share reads the same whatever implements the work.

Model FLOPs count the convolutions and matrix products (2 per
multiply-add) and attention's two products; normalization, activations,
pooling and the optimizer are left out. A backward pass is twice its
forward. Recomputation is not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12  # the fastest rate for a product of f32 inputs
PEAK_BYTES_PER_S = 3.35e12


def resnet50_forward_flops(image: int = 224, num_filters: int = 64) -> float:
    """One image through ResNet-50 (v1.5, stride on the 3x3 conv)."""
    flops = 0.0

    def conv(cin, cout, k, hw_out):
        return 2.0 * cin * cout * k * k * hw_out * hw_out

    s = (image + 2 * 3 - 7) // 2 + 1  # the 7x7/2 stem
    flops += conv(3, num_filters, 7, s)
    s = (s + 2 - 3) // 2 + 1  # the 3x3/2 max pool
    cin = num_filters
    for i, blocks in enumerate((3, 4, 6, 3)):
        width = num_filters * 2 ** i
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            s_out = (s - 1) // stride + 1
            flops += conv(cin, width, 1, s) + conv(width, width, 3, s_out) \
                + conv(width, 4 * width, 1, s_out)
            if stride != 1 or cin != 4 * width:
                flops += conv(cin, 4 * width, 1, s_out)
            cin, s = 4 * width, s_out
    return flops


def mlp_flops(widths) -> float:
    return sum(2.0 * a * b for a, b in zip(widths[:-1], widths[1:]))


def vit_forward_flops(image: int = 224, patch: int = 16, width: int = 768, depth: int = 12,
                      mlp: int = 3072) -> float:
    """One image through a ViT with a class token."""
    grid = image // patch
    tokens = grid * grid + 1
    embed = 2.0 * 3 * patch * patch * width * grid * grid
    per_layer = tokens * (2.0 * 4 * width * width + 2.0 * 2 * width * mlp) \
        + 2.0 * 2 * tokens * tokens * width
    return embed + depth * per_layer


def v2_train_flops_per_image(image=224, dim=128, queue=65536, num_filters=64) -> float:
    """MoCo v2: the query encoder and head forward and backward, the key
    encoder and head forward, and the InfoNCE scores and their gradient."""
    feat = 32 * num_filters
    enc = resnet50_forward_flops(image, num_filters) + mlp_flops([feat, feat, dim])
    return 4.0 * enc + 4.0 * queue * dim


def v3_train_flops_per_image(image=224, vit=None, dim=256, hidden=4096) -> float:
    """MoCo v3: on both views, the encoder, projector and predictor forward
    and backward, and the momentum encoder and projector forward."""
    vit = vit or {}
    width = vit.get("width", 768)
    enc = vit_forward_flops(image, vit.get("patch", 16), width, vit.get("depth", 12),
                            vit.get("mlp", 3072)) + mlp_flops([width, hidden, hidden, dim])
    pred = mlp_flops([dim, hidden, dim])
    return 2 * (3.0 * (enc + pred) + enc)


def infonce_counts(batch: int, queue: int, dim: int) -> tuple[float, float]:
    """(operations, bytes) of the InfoNCE forward and backward against the
    queue: the scores 2BKC and dq 2BKC; q, k and the queue read once
    (float32), the loss rows' statistics and dq written once."""
    ops = 4.0 * batch * queue * dim
    nbytes = 4.0 * (2 * batch * dim + queue * dim + 2 * batch + batch * dim)
    return ops, nbytes


def infonce_bound_s(batch: int, queue: int, dim: int) -> float:
    ops, nbytes = infonce_counts(batch, queue, dim)
    return max(ops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def flash_counts(bh: int, seq: int, head_dim: int, backward: bool) -> tuple[float, float]:
    """(operations, bytes) of one flash-attention call in bf16: forward
    4·BH·S²·D, reading q, k, v and writing o and the f32 log-sum-exp;
    backward 8·BH·S²·D, reading q, k, v, o, dO and the log-sum-exp and
    writing dq, dk, dv."""
    t = 2.0 * bh * seq * head_dim  # one (BH, S, D) bf16 tensor
    lse = 4.0 * bh * seq
    if backward:
        return 8.0 * bh * seq * seq * head_dim, 8 * t + lse
    return 4.0 * bh * seq * seq * head_dim, 4 * t + lse


def flash_bound_s(bh: int, seq: int, head_dim: int, backward: bool) -> float:
    ops, nbytes = flash_counts(bh, seq, head_dim, backward)
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
