"""ResNet encoder family in PyTorch, the counterpart of moco_tpu/models/resnet.py.

Same architecture as the Flax modules (torchvision ResNet v1.5: the stride
sits on the 3x3 conv; 7x7/s2 stem + 3x3/s2 maxpool, or the 3x3/s1 CIFAR
stem), with torchvision's parameter names, so `convert.encoder_from_flax`
follows the layout rules of moco_tpu/export.py.

Inputs are NHWC like the JAX package's. A contiguous NHWC tensor permuted
to NCHW is already in `channels_last` memory format, so the convolutions
run channels-last with no copy.

BatchNorm is the Flax layer's, not `nn.BatchNorm2d`'s, in training mode
(`flax_train_batch_norm` below, which the v3 heads' 1-D BN shares), with
the training modes of moco_tpu/models/resnet.py `BatchNorm`: full batch,
`stats_rows`, `virtual_groups` and `momentum_stats`; eval mode is
`nn.BatchNorm2d`'s own, which normalizes with the stored running mean and
var exactly as Flax's `use_running_average=True` does.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from moco_tpu_torch.models.remat import remat_block


class _Moments(torch.autograd.Function):
    """(mean, mean of squares) of `x` in float32 over `dims`, keeping only
    `x` (in its own dtype) for the backward: the float32 copy and its
    square live for the forward alone."""

    @staticmethod
    def forward(ctx, x, dims):
        xf = x.float()
        ctx.save_for_backward(x)
        ctx.dims = dims
        return xf.mean(dims, keepdim=True), xf.square().mean(dims, keepdim=True)

    @staticmethod
    def backward(ctx, g_mean, g_mean2):
        (x,) = ctx.saved_tensors
        n = math.prod(x.shape[d] for d in ctx.dims)
        gx = (g_mean + 2.0 * x.float() * g_mean2) / n
        return gx.to(x.dtype), None


def _batch_moments(x, dims):
    """Mean and biased variance, as Flax takes them: mean(x^2) - mean(x)^2
    in float32, clamped at 0; the gradient flows through both."""
    mean, mean2 = _Moments.apply(x, dims)
    return mean, (mean2 - mean.square()).clamp_min(0.0)


def _normalize(x, mean, var, bn, channel_axis: int = 1):
    """x * mul + shift in x's dtype, mul and shift formed in float32 from
    the statistics and the affine parameters (none under affine=False), as
    the Flax layer's custom modes normalize."""
    shape = [1] * x.dim()
    shape[channel_axis] = -1
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight.reshape(shape)
    shift = -mean * mul
    if bn.bias is not None:
        shift = shift + bn.bias.reshape(shape)
    return x * mul.to(x.dtype) + shift.to(x.dtype)


def flax_train_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x):
    """Flax's training-mode BatchNorm (moco_tpu/models/resnet.py
    `BatchNorm`) for a torch BN module `bn` and its input, in the mode that
    `bn`'s `stats_rows`, `virtual_groups` and `momentum_stats` select (all
    off for a module that lacks them, as the v3 heads' BN).

    Full batch: normalizes with the batch's statistics (taken in f32), the
    gradient flowing through them, and moves the buffers toward them by the
    module's `momentum` (0.1 on the new value is Flax's 0.9 on the old).
    What differs from torch's own training mode is the running variance:
    the biased one, as Flax keeps it, not the unbiased. The statistics and
    the normalization come from one `torch.native_batch_norm` call with no
    running buffers (channels-last aware, the output in the input's
    dtype, weight and bias optional); the biased variance is recovered
    from its saved inverse standard deviation.

    The other modes take their own reductions, in plain torch ops, and
    normalize in the input's dtype as the Flax layer does:

    - `stats_rows=r`: statistics from the first r rows, the normalization
      over every row;
    - `virtual_groups=G`: statistics over each of G contiguous row-groups,
      each group normalized with its own; the buffers move toward the mean
      over groups of each group's mean and biased variance (the reference's
      per-GPU BN and the cross-device mean of its running statistics);
    - `momentum_stats`: normalizes with m * running + (1 - m) * batch
      (m = 1 - `bn.momentum`) and stores that; the gradient flows through
      the batch term;
    - SyncBN (`bn.sync_stats`, a `parallel.mesh.StatsGroup` that the
      encoder's builder sets under shuffle 'syncbn', and on v3's heads
      across ranks): the (mean, mean of squares) of this rank's rows (its
      first `stats_rows`) averaged over the group by one all-reduce whose
      backward all-reduces the cotangent, JAX's `pmean` of the two over
      the axis or its `axis_index_groups`; composes with `stats_rows` and
      `momentum_stats` (the batch term is then the group's).
      `torch.nn.SyncBatchNorm` is not used: it keeps the unbiased running
      variance and weighs ranks by their counts."""
    rows = getattr(bn, "stats_rows", 0)
    groups = getattr(bn, "virtual_groups", 0)
    momentum_stats = getattr(bn, "momentum_stats", False)
    sync = getattr(bn, "sync_stats", None)
    if groups > 1:
        b = x.shape[0]
        if b % groups:
            raise ValueError(f"batch {b} not divisible by virtual_groups {groups}")
        xg = x.reshape((groups, b // groups) + x.shape[1:])
        mean, var = _batch_moments(xg, (1,) + tuple(range(3, xg.dim())))
        out = _normalize(xg, mean, var, bn, channel_axis=2).reshape(x.shape)
        new = [s.reshape(groups, -1).mean(0) for s in (mean, var)]
    elif rows or momentum_stats or sync is not None:
        sub = x[:rows] if rows else x
        dims = (0,) + tuple(range(2, x.dim()))
        if sync is None:
            mean, var = _batch_moments(sub, dims)
        else:
            mean, mean2 = _Moments.apply(sub, dims)
            both = sync.mean(torch.cat([mean.reshape(-1), mean2.reshape(-1)]))
            mean, mean2 = (t.reshape(mean.shape) for t in both.chunk(2))
            var = (mean2 - mean.square()).clamp_min(0.0)
        if momentum_stats:
            m = 1.0 - bn.momentum
            mean = m * bn.running_mean.reshape(mean.shape) + (1.0 - m) * mean
            var = m * bn.running_var.reshape(var.shape) + (1.0 - m) * var
        out = _normalize(x, mean, var, bn)
        new = [s.reshape(-1) for s in (mean, var)]
    else:
        out, mean, invstd = torch.native_batch_norm(
            x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps
        )
        new = [mean.float(), invstd.float().pow(-2).sub_(bn.eps).clamp_min_(0.0)]
    with torch.no_grad():
        if momentum_stats:  # what it normalized with is the new running statistic
            bn.running_mean.copy_(new[0])
            bn.running_var.copy_(new[1])
        else:
            bn.running_mean.lerp_(new[0], bn.momentum)
            bn.running_var.lerp_(new[1], bn.momentum)
    return out


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with Flax's training semantics (`flax_train_batch_norm`)
    and the Flax layer's training modes, validated with its messages. Eval
    mode is `nn.BatchNorm2d`'s, bit for bit, which normalizes with the
    stored running statistics as Flax's `use_running_average=True` does.
    Parameter and buffer names are torchvision's, whatever the mode, so
    checkpoints interchange between the modes. `stats_barrier` is
    validated and has no effect (utils/config.py)."""

    def __init__(self, num_features: int, eps: float = 1e-5, stats_rows: int = 0,
                 stats_barrier: bool = False, virtual_groups: int = 0,
                 momentum_stats: bool = False):
        super().__init__(num_features, eps=eps)
        if stats_rows < 0:
            raise ValueError(f"stats_rows must be >= 0, got {stats_rows}")
        if virtual_groups < 0:
            raise ValueError(f"virtual_groups must be >= 0, got {virtual_groups}")
        if stats_rows and virtual_groups > 1:
            raise ValueError("stats_rows and virtual_groups are mutually exclusive")
        if stats_barrier and not stats_rows:
            raise ValueError("stats_barrier requires stats_rows > 0")
        if momentum_stats and (stats_rows or virtual_groups > 1):
            raise ValueError("momentum_stats is mutually exclusive with stats_rows/virtual_groups")
        self.stats_rows, self.stats_barrier = stats_rows, stats_barrier
        self.virtual_groups, self.momentum_stats = virtual_groups, momentum_stats

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return flax_train_batch_norm(self, x)


class ConvBN(nn.Sequential):
    """Conv (no bias, padding k//2) + BatchNorm; named `0`/`1` like
    torchvision's `downsample` branch, where it serves."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1, norm=BatchNorm):
        super().__init__(
            nn.Conv2d(cin, cout, kernel_size, stride, kernel_size // 2, bias=False),
            norm(cout),
        )


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, norm=BatchNorm):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = norm(features)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = ConvBN(cin, features, 1, stride, norm)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, norm=BatchNorm):
        super().__init__()
        out = features * self.expansion
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.bn1 = norm(features)
        # v1.5: stride on the 3x3, as torchvision does
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = norm(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = norm(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = ConvBN(cin, out, 1, stride, norm)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """Backbone returning pooled features (the pre-`fc` activations),
    (n, num_features) float32 from (n, H, W, 3) NHWC images. The `bn_*`
    keywords select every BatchNorm's training mode, as the Flax ResNet's
    do (`BatchNorm`)."""

    def __init__(
        self,
        stage_sizes,
        block=Bottleneck,
        num_filters: int = 64,
        cifar_stem: bool = False,
        bn_epsilon: float = 1e-5,
        bn_stats_rows: int = 0,
        bn_stats_barrier: bool = False,
        bn_virtual_groups: int = 0,
        bn_momentum_stats: bool = False,
    ):
        super().__init__()
        norm = functools.partial(
            BatchNorm, eps=bn_epsilon, stats_rows=bn_stats_rows, stats_barrier=bn_stats_barrier,
            virtual_groups=bn_virtual_groups, momentum_stats=bn_momentum_stats)
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.conv1 = nn.Conv2d(3, num_filters, 3, 1, 1, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, num_filters, 7, 2, 3, bias=False)
        self.bn1 = norm(num_filters)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = None if cifar_stem else nn.MaxPool2d(3, 2, 1)
        cin = num_filters
        for i, num_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, num_filters * 2**i, stride, norm))
                cin = num_filters * 2**i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.num_features = cin

    def _stem(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last in memory
        x = self.relu(self.bn1(self.conv1(x)))
        if self.maxpool is not None:
            x = self.maxpool(x)
        return x

    def residual_blocks(self) -> list:
        """The residual blocks in schedule order, across the stages."""
        return [b for i in range(self.num_stages) for b in getattr(self, f"layer{i + 1}")]

    def forward(self, x, remat: bool = False):
        """`remat` recomputes each residual block in the backward
        (models/remat.py)."""
        x = self._stem(x)
        for block in self.residual_blocks():
            x = remat_block(block, x) if remat else block(x)
        # global average pool in the compute dtype, then f32
        return x.mean(dim=(2, 3)).float()

    # -- the layer groups of the ZeRO-3 schedule (parallel/zero.py) ----------

    @property
    def group_names(self) -> tuple:
        """Schedule-ordered layer groups: the stem, then one per residual
        block (JAX's `group_names`)."""
        return ("stem",) + tuple(f"block{k}" for k in range(len(self.residual_blocks())))

    def group_param_names(self) -> dict:
        """group -> the Flax param-tree children it holds (JAX's
        `group_param_names`, whose names convert.py's layout gives)."""
        names = {"stem": ("ConvBN_0",) if self.cifar_stem else ("Conv_0", "BatchNorm_0")}
        blocks = self.residual_blocks()
        for k, block in enumerate(blocks):
            names[f"block{k}"] = (f"{type(block).__name__}_{k}",)
        return names

    def group_modules(self, group: str) -> list:
        if group == "stem":
            return [self.conv1, self.bn1]
        return [self.residual_blocks()[self._block_index(group)]]

    def _block_index(self, group: str) -> int:
        n = len(self.residual_blocks())
        if not (group.startswith("block") and group[5:].isdigit()) or int(group[5:]) >= n:
            raise ValueError(f"unknown layer group {group!r} ({n} blocks)")
        return int(group[5:])

    def forward_group(self, group: str, x):
        """One layer group on the previous group's output (the images for
        the stem); the last block also pools, as `forward` does."""
        if group == "stem":
            return self._stem(x)
        k = self._block_index(group)
        blocks = self.residual_blocks()
        x = blocks[k](x)
        return x.mean(dim=(2, 3)).float() if k == len(blocks) - 1 else x


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
