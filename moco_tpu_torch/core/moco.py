"""Encoder = backbone + projection head (the v1/v2 branch of
moco_tpu/core/moco.py:MoCoEncoder and build_encoder)."""

from __future__ import annotations

from torch import nn

from moco_tpu_torch.models.heads import ProjectionHead
from moco_tpu_torch.models.resnet import create_resnet
from moco_tpu_torch.utils.config import MocoConfig


class MoCoEncoder(nn.Module):
    """`head(backbone(x))`: NHWC float images -> (n, dim) float32."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x):
        return self.head(self.backbone(x))


def build_encoder(cfg: MocoConfig, num_filters: int = 64) -> MoCoEncoder:
    """ResNet backbone + Linear (v1) or MLP (v2) head. `num_filters`
    narrows the backbone for tests, as `create_resnet(num_filters=...)`
    does in the JAX package."""
    if cfg.arch.startswith("vit"):
        raise ValueError(f"{cfg.arch!r}: ViT backbones come with the ViT/v3 slice")
    backbone = create_resnet(cfg.arch, num_filters=num_filters, cifar_stem=cfg.cifar_stem)
    return MoCoEncoder(backbone, ProjectionHead(backbone.num_features, cfg.dim, cfg.mlp))
