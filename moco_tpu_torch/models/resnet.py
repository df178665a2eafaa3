"""ResNet encoder family in PyTorch, the counterpart of moco_tpu/models/resnet.py.

Same architecture as the Flax modules (torchvision ResNet v1.5: the stride
sits on the 3x3 conv; 7x7/s2 stem + 3x3/s2 maxpool, or the 3x3/s1 CIFAR
stem), with torchvision's parameter names, so `convert.encoder_from_flax`
follows the layout rules of moco_tpu/export.py.

Inputs are NHWC like the JAX package's. A contiguous NHWC tensor permuted
to NCHW is already in `channels_last` memory format, so the convolutions
run channels-last with no copy.

BatchNorm is the Flax layer's, not `nn.BatchNorm2d`'s, in training mode
(`flax_train_batch_norm` below, which the v3 heads' 1-D BN shares); eval
mode is `nn.BatchNorm2d`'s own, which normalizes with the stored running
mean and var exactly as Flax's `use_running_average=True` does.
"""

from __future__ import annotations

import torch
from torch import nn


def flax_train_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x):
    """Flax's training-mode BatchNorm (moco_tpu/models/resnet.py
    `BatchNorm`, full-batch mode; the virtual-group, stats-rows and
    momentum-statistics modes come with a later slice) for a torch BN
    module `bn` and its input.

    Normalizes with the batch's statistics (taken in f32), the gradient
    flowing through them, and moves the buffers toward them by the
    module's `momentum` (0.1 on the new value is Flax's 0.9 on the old).
    What differs from torch's own training mode is the running variance:
    the biased one, as Flax keeps it, not the unbiased. The statistics and
    the normalization come from one `torch.native_batch_norm` call with no
    running buffers (channels-last aware, the output in the input's
    dtype, weight and bias optional); the biased variance is recovered
    from its saved inverse standard deviation."""
    out, mean, invstd = torch.native_batch_norm(
        x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps
    )
    with torch.no_grad():
        var = invstd.float().pow(-2).sub_(bn.eps).clamp_min_(0.0)
        bn.running_mean.lerp_(mean.float(), bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
    return out


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with Flax's training semantics (`flax_train_batch_norm`).
    Eval mode is `nn.BatchNorm2d`'s, bit for bit, which normalizes with the
    stored running statistics as Flax's `use_running_average=True` does.
    Parameter and buffer names are torchvision's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return flax_train_batch_norm(self, x)


class ConvBN(nn.Sequential):
    """Conv (no bias, padding k//2) + BatchNorm; named `0`/`1` like
    torchvision's `downsample` branch, where it serves."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, eps: float = 1e-5):
        super().__init__(
            nn.Conv2d(cin, cout, kernel_size, stride, kernel_size // 2, bias=False),
            BatchNorm(cout, eps=eps),
        )


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, eps: float = 1e-5):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features, eps=eps)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features, eps=eps)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = ConvBN(cin, features, 1, stride, eps)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, eps: float = 1e-5):
        super().__init__()
        out = features * self.expansion
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features, eps=eps)
        # v1.5: stride on the 3x3, as torchvision does
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(features, eps=eps)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out, eps=eps)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = ConvBN(cin, out, 1, stride, eps)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """Backbone returning pooled features (the pre-`fc` activations),
    (n, num_features) float32 from (n, H, W, 3) NHWC images."""

    def __init__(
        self,
        stage_sizes,
        block=Bottleneck,
        num_filters: int = 64,
        cifar_stem: bool = False,
        bn_epsilon: float = 1e-5,
    ):
        super().__init__()
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.conv1 = nn.Conv2d(3, num_filters, 3, 1, 1, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, num_filters, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(num_filters, eps=bn_epsilon)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = None if cifar_stem else nn.MaxPool2d(3, 2, 1)
        cin = num_filters
        for i, num_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, num_filters * 2**i, stride, bn_epsilon))
                cin = num_filters * 2**i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.num_features = cin

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last in memory
        x = self.relu(self.bn1(self.conv1(x)))
        if self.maxpool is not None:
            x = self.maxpool(x)
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        # global average pool in the compute dtype, then f32
        return x.mean(dim=(2, 3)).float()


_CONFIGS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block=BasicBlock),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block=BasicBlock),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block=Bottleneck),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block=Bottleneck),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block=Bottleneck),
}
ARCHS = tuple(sorted(_CONFIGS))


def create_resnet(arch: str, **kwargs) -> ResNet:
    if arch not in _CONFIGS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(_CONFIGS)}")
    return ResNet(**_CONFIGS[arch], **kwargs)
