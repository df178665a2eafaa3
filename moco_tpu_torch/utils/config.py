"""The part of moco_tpu/utils/config.py that serving reads: the same field
names, defaults and presets, so a preset means the same model in both
packages. The training fields come with the training slice."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MocoConfig:
    arch: str = "resnet50"
    dim: int = 128  # --moco-dim
    num_negatives: int = 65536  # --moco-k
    mlp: bool = False  # --mlp (v2)
    cifar_stem: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    image_size: int = 224


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    moco: MocoConfig = dataclasses.field(default_factory=MocoConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


PRESETS = {
    "cifar_smoke": TrainConfig(
        moco=MocoConfig(arch="resnet18", num_negatives=4096, cifar_stem=True),
        data=DataConfig(image_size=32),
    ),
    "imagenet_v2": TrainConfig(moco=MocoConfig(mlp=True), data=DataConfig()),
}
