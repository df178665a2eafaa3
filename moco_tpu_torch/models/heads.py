"""Projection heads, the counterparts of moco_tpu/models/heads.py:
`ProjectionHead` (v1/v2) and `V3MLPHead` (v3's projector and predictor)."""

from __future__ import annotations

from torch import nn

from moco_tpu_torch.models.resnet import flax_train_batch_norm


class ProjectionHead(nn.Module):
    """MoCo projection head: Linear (v1) or Linear -> ReLU -> Linear with
    hidden width = in_features (v2). Named as the reference's `fc`
    surgery (`fc.weight`, or `fc.0.*` / `fc.2.*`); float32 output."""

    def __init__(self, in_features: int, dim: int = 128, mlp: bool = False):
        super().__init__()
        if mlp:
            self.fc = nn.Sequential(
                nn.Linear(in_features, in_features), nn.ReLU(inplace=True),
                nn.Linear(in_features, dim),
            )
        else:
            self.fc = nn.Linear(in_features, dim)

    def forward(self, x):
        return self.fc(x).float()


class BatchNorm1d(nn.BatchNorm1d):
    """(N, C) BatchNorm with Flax's training semantics (the rule of
    `models/resnet.py:BatchNorm`: momentum 0.9 on the old value, eps 1e-5,
    biased running variance); eval mode is `nn.BatchNorm1d`'s, which
    normalizes with the running statistics as Flax's eval does.
    `affine=False` is Flax's `use_scale=False, use_bias=False`."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return flax_train_batch_norm(self, x)


class V3MLPHead(nn.Module):
    """MoCo v3 projection / prediction MLP (`V3MLPHead`, heads.py:39): per
    hidden layer Linear (no bias) -> BN -> ReLU; then Linear (no bias) and,
    with `last_bn`, an affine-free BN. Layer i is `fc{i}` / `bn{i}` (Flax's
    `Dense_{i}` / `BatchNorm_{i}`); float32 output."""

    def __init__(self, in_features: int, num_layers: int = 3, hidden_dim: int = 4096,
                 dim: int = 256, last_bn: bool = True):
        super().__init__()
        self.num_layers, self.last_bn = num_layers, last_bn
        widths = [in_features] + [hidden_dim] * (num_layers - 1) + [dim]
        for i in range(num_layers):
            self.add_module(f"fc{i}", nn.Linear(widths[i], widths[i + 1], bias=False))
            if i < num_layers - 1:
                self.add_module(f"bn{i}", BatchNorm1d(widths[i + 1]))
        if last_bn:
            self.add_module(f"bn{num_layers - 1}", BatchNorm1d(dim, affine=False))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = getattr(self, f"bn{i}")(x).relu()
        if self.last_bn:
            x = getattr(self, f"bn{self.num_layers - 1}")(x)
        return x.float()
