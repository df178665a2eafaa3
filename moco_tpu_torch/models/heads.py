"""Projection head, the counterpart of moco_tpu/models/heads.py:ProjectionHead."""

from __future__ import annotations

from torch import nn


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
