"""The eval seam of moco_tpu/data/augment.py: per-channel normalization and
the statistics each image size uses. The training augmentations come
with the training slice."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)


def normalize(images: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """(images - mean) / std over the last (channel) axis of NHWC images."""
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def eval_stats(image_size: int) -> tuple[tuple, tuple]:
    """(mean, std) as `get_recipe` chooses them: inputs of 64 px or less
    are CIFAR-sized and use the CIFAR statistics."""
    if image_size <= 64:
        return CIFAR_MEAN, CIFAR_STD
    return IMAGENET_MEAN, IMAGENET_STD
