"""Host-side dataset sources (counterpart of moco_tpu/data/datasets.py).

A dataset is an indexable source of raw uint8 HWC images and labels. This
slice has the seeded `SyntheticDataset` only; CIFAR-10 and ImageFolder
come with the slice that brings real data to the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SyntheticDataset:
    """Fixed-seed random uint8 images, index-deterministic: image i is
    `np.random.default_rng(i).integers(0, 256, (size, size, 3))`, the same
    bytes as the JAX package's."""

    def __init__(self, num_examples: int = 1024, image_size: int = 224, num_classes: int = 10):
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_classes = num_classes

    def __len__(self) -> int:
        return self.num_examples

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        size = decode_size or self.image_size
        rng = np.random.default_rng(index)
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        return img, int(index % self.num_classes)


def build_dataset(name: str, image_size: int):
    """The dataset a config names; `synthetic` only in this slice."""
    if name == "synthetic":
        return SyntheticDataset(image_size=max(image_size, 32))
    raise ValueError(
        f"dataset {name!r} comes with a later slice of the port; use 'synthetic' "
        "(python -m moco_tpu_torch.train --data synthetic)"
    )
