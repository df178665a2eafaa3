"""Plain-PyTorch references of the encoders the benchmark trains and serves:
ResNet-50 (torchvision's v1.5 bottlenecks) with the MoCo v2 MLP head, and
ViT-B/16 with the MoCo v3 projector and predictor.

Each network is a function over a dict of float32 tensors, keyed as the
parameters of the encoder under test are named (`backbone.layer1.0.conv1.weight`,
`head.fc.0.bias`, ...), so one dict of seeded weights (`benchmark/weights.py`)
feeds both sides. `spec_*` lists every tensor a network reads, with its
shape and how `weights.py` draws it.

BatchNorm in training mode normalizes with the batch's mean and biased
variance, as the MoCo papers' recipes do; in eval mode with the stored
statistics. The LayerNorm epsilon is 1e-6 and the GELU the tanh form, the
ViT's published settings in the MoCo v3 code base.

Every convolution and matrix product goes through a `Precision`: `fp32`
is plain float32 (the caller turns TF32 off), and `fp8` rounds both
operands of each product, and the gradient arriving at its output, to
float8 e4m3 with a per-tensor scale: the lower-precision control of the
correctness check. Nothing here imports the code under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-6
RESNET50_STAGES = (3, 4, 6, 3)
VIT_B16 = dict(patch=16, width=768, depth=12, heads=12, mlp=3072)
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundOperand(torch.autograd.Function):
    """Forward: the operand rounded to fp8; backward: the gradient as is."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradient(torch.autograd.Function):
    """Forward: identity; backward: the incoming gradient rounded to fp8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


class Precision:
    """How the products of a reference pass are computed: "fp32" or "fp8"."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def product(self, fn, x, w, *args, **kw):
        if self.name == "fp32":
            return fn(x, w, *args, **kw)
        out = fn(_RoundOperand.apply(x), _RoundOperand.apply(w), *args, **kw)
        return _RoundGradient.apply(out)

    def conv(self, x, w, stride=1, padding=0):
        return self.product(F.conv2d, x, w, None, stride, padding)

    def linear(self, x, w, b=None):
        y = self.product(lambda a, m: a @ m.t(), x, w)
        return y if b is None else y + b

    def matmul(self, a, b):
        return self.product(torch.matmul, a, b)


FP32 = Precision("fp32")


def batch_norm(x, P, name, train: bool, affine: bool = True):
    """BatchNorm over every axis but 1 (the channel): in training mode with
    the batch's mean and biased variance, in eval mode with the stored
    statistics."""
    w = P[f"{name}.weight"] if affine else None
    b = P[f"{name}.bias"] if affine else None
    if train:
        return F.batch_norm(x, None, None, w, b, training=True, momentum=0.0, eps=BN_EPS)
    return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"], w, b,
                        training=False, eps=BN_EPS)


# ------------------------------------------------------------------ ResNet


def _bottlenecks(num_filters: int):
    """(block name, cin, width, stride, has downsample) of ResNet-50."""
    cin = num_filters
    for i, n in enumerate(RESNET50_STAGES):
        width = num_filters * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            yield f"layer{i + 1}.{j}", cin, width, stride, stride != 1 or cin != 4 * width
            cin = 4 * width


def spec_resnet50_v2(num_filters: int = 64, dim: int = 128) -> list:
    """(name, shape, kind) of every tensor of ResNet-50 + the v2 MLP head."""
    out = []

    def conv(name, cout, cin, k):
        out.append((f"backbone.{name}.weight", (cout, cin, k, k), "conv"))

    def bn(name, c, scale="one"):
        out.extend([(f"backbone.{name}.weight", (c,), scale),
                    (f"backbone.{name}.bias", (c,), "zero"),
                    (f"backbone.{name}.running_mean", (c,), "zero"),
                    (f"backbone.{name}.running_var", (c,), "one")])

    conv("conv1", num_filters, 3, 7)
    bn("bn1", num_filters)
    for name, cin, width, _, down in _bottlenecks(num_filters):
        conv(f"{name}.conv1", width, cin, 1)
        bn(f"{name}.bn1", width)
        conv(f"{name}.conv2", width, width, 3)
        bn(f"{name}.bn2", width)
        conv(f"{name}.conv3", 4 * width, width, 1)
        bn(f"{name}.bn3", 4 * width, "residual")
        if down:
            conv(f"{name}.downsample.0", 4 * width, cin, 1)
            bn(f"{name}.downsample.1", 4 * width)
    feat = 32 * num_filters
    out += [("head.fc.0.weight", (feat, feat), "linear"), ("head.fc.0.bias", (feat,), "zero"),
            ("head.fc.2.weight", (dim, feat), "linear"), ("head.fc.2.bias", (dim,), "zero")]
    return out


def resnet50_v2(P, images_nhwc, train: bool, prec: Precision = FP32, num_filters: int = 64):
    """(n, dim) float32 head outputs of NHWC float images (not normalized
    to unit length)."""
    def cbr(x, name, bn_name, stride, padding, relu=True):
        x = prec.conv(x, P[f"backbone.{name}.weight"], stride, padding)
        x = batch_norm(x, P, f"backbone.{bn_name}", train)
        return F.relu(x) if relu else x

    x = images_nhwc.permute(0, 3, 1, 2)
    x = cbr(x, "conv1", "bn1", 2, 3)
    x = F.max_pool2d(x, 3, 2, 1)
    for name, _, _, stride, down in _bottlenecks(num_filters):
        y = cbr(x, f"{name}.conv1", f"{name}.bn1", 1, 0)
        y = cbr(y, f"{name}.conv2", f"{name}.bn2", stride, 1)
        y = cbr(y, f"{name}.conv3", f"{name}.bn3", 1, 0, relu=False)
        if down:
            x = cbr(x, f"{name}.downsample.0", f"{name}.downsample.1", stride, 0, relu=False)
        x = F.relu(y + x)
    feats = x.mean(dim=(2, 3))
    h = F.relu(prec.linear(feats, P["head.fc.0.weight"], P["head.fc.0.bias"]))
    return prec.linear(h, P["head.fc.2.weight"], P["head.fc.2.bias"])


# --------------------------------------------------------------------- ViT


def spec_mlp_head(prefix: str, widths: list, last_bn: bool) -> list:
    """The MoCo v3 MLP: Linear (no bias) -> BN -> ReLU per hidden layer, a
    last Linear, and with `last_bn` an affine-free BN."""
    out = []
    n = len(widths) - 1
    for i in range(n):
        out.append((f"{prefix}.fc{i}.weight", (widths[i + 1], widths[i]), "linear"))
        if i < n - 1:
            c = widths[i + 1]
            out += [(f"{prefix}.bn{i}.weight", (c,), "one"), (f"{prefix}.bn{i}.bias", (c,), "zero"),
                    (f"{prefix}.bn{i}.running_mean", (c,), "zero"),
                    (f"{prefix}.bn{i}.running_var", (c,), "one")]
    if last_bn:
        out += [(f"{prefix}.bn{n - 1}.running_mean", (widths[-1],), "zero"),
                (f"{prefix}.bn{n - 1}.running_var", (widths[-1],), "one")]
    return out


def mlp_head(P, prefix: str, x, layers: int, last_bn: bool, train: bool, prec: Precision = FP32):
    for i in range(layers):
        x = prec.linear(x, P[f"{prefix}.fc{i}.weight"])
        if i < layers - 1:
            x = F.relu(batch_norm(x, P, f"{prefix}.bn{i}", train))
    if last_bn:
        x = batch_norm(x, P, f"{prefix}.bn{layers - 1}", train, affine=False)
    return x


def spec_vit_v3(vit: dict = VIT_B16, dim: int = 256, hidden: int = 4096) -> list:
    """(name, shape, kind) of the ViT, its 3-layer projector and the
    2-layer predictor (prefix `predictor`)."""
    w, p = vit["width"], vit["patch"]
    out = [("backbone.patch_embed.weight", (w, 3, p, p), "conv"),
           ("backbone.patch_embed.bias", (w,), "zero"),
           ("backbone.cls_token", (1, 1, w), "token")]
    for i in range(vit["depth"]):
        b = f"backbone.blocks.{i}"
        for ln in ("norm1", "norm2"):
            out += [(f"{b}.{ln}.weight", (w,), "one"), (f"{b}.{ln}.bias", (w,), "zero")]
        for proj in ("query", "key", "value", "out"):
            out += [(f"{b}.attn.{proj}.weight", (w, w), "linear"),
                    (f"{b}.attn.{proj}.bias", (w,), "zero")]
        out += [(f"{b}.mlp.fc1.weight", (vit["mlp"], w), "linear"),
                (f"{b}.mlp.fc1.bias", (vit["mlp"],), "zero"),
                (f"{b}.mlp.fc2.weight", (w, vit["mlp"]), "linear"),
                (f"{b}.mlp.fc2.bias", (w,), "zero")]
    out += [("backbone.final_norm.weight", (w,), "one"), ("backbone.final_norm.bias", (w,), "zero")]
    out += spec_mlp_head("head", [w, hidden, hidden, dim], last_bn=True)
    out += spec_mlp_head("predictor", [dim, hidden, dim], last_bn=True)
    return out


def sincos_posembed(width: int, grid: int) -> torch.Tensor:
    """(1 + grid², width) fixed 2-D sin-cos position embedding, a zero row
    for the class token first (MoCo v3's `build_2d_sincos_position_embedding`,
    the height half before the width half)."""
    coords = np.arange(grid, dtype=np.float64)
    omega = 1.0 / (10000 ** (np.arange(width // 4, dtype=np.float64) / (width // 4)))
    ang = np.outer(coords, omega)
    half = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)  # (grid, width/2)
    ys = np.repeat(half[:, None, :], grid, axis=1)
    xs = np.repeat(half[None, :, :], grid, axis=0)
    emb = np.concatenate([ys, xs], axis=-1).reshape(grid * grid, width)
    return torch.from_numpy(np.concatenate([np.zeros((1, width)), emb]).astype(np.float32))


def vit_features(P, images_nhwc, prec: Precision = FP32, vit: dict = VIT_B16):
    """(n, width) class-token features of NHWC float images."""
    w, p, heads = vit["width"], vit["patch"], vit["heads"]
    x = prec.conv(images_nhwc.permute(0, 3, 1, 2), P["backbone.patch_embed.weight"], p, 0)
    x = x + P["backbone.patch_embed.bias"].reshape(1, -1, 1, 1)
    n, _, grid, _ = x.shape
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([P["backbone.cls_token"].expand(n, -1, -1), x], dim=1)
    x = x + sincos_posembed(w, grid).to(x.device)
    s, dh = x.shape[1], w // heads
    for i in range(vit["depth"]):
        b = f"backbone.blocks.{i}"
        h = F.layer_norm(x, (w,), P[f"{b}.norm1.weight"], P[f"{b}.norm1.bias"], LN_EPS)
        q, k, v = (prec.linear(h, P[f"{b}.attn.{t}.weight"], P[f"{b}.attn.{t}.bias"])
                   .reshape(n, s, heads, dh).transpose(1, 2) for t in ("query", "key", "value"))
        att = torch.softmax(prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        o = prec.matmul(att, v).transpose(1, 2).reshape(n, s, w)
        x = x + prec.linear(o, P[f"{b}.attn.out.weight"], P[f"{b}.attn.out.bias"])
        h = F.layer_norm(x, (w,), P[f"{b}.norm2.weight"], P[f"{b}.norm2.bias"], LN_EPS)
        h = F.gelu(prec.linear(h, P[f"{b}.mlp.fc1.weight"], P[f"{b}.mlp.fc1.bias"]),
                   approximate="tanh")
        x = x + prec.linear(h, P[f"{b}.mlp.fc2.weight"], P[f"{b}.mlp.fc2.bias"])
    x = F.layer_norm(x, (w,), P["backbone.final_norm.weight"], P["backbone.final_norm.bias"],
                     LN_EPS)
    return x[:, 0]
