"""The two-crop training input (counterpart of moco_tpu/data/pipeline.py
`TwoCropPipeline`, device-side augment only).

Per step: the step's indices from a per-epoch permutation seeded with
numpy from (seed, epoch), as the JAX pipeline draws it; the uint8 images
loaded by a thread pool into one pinned host buffer; a `non_blocking` copy
to the card; and `two_crop_augment` there, its draws from a generator
seeded from (seed, epoch, step). The prefetch ring, host-side crops, the
decode cache and the native loader come with a later slice.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from moco_tpu_torch.data.augment import get_recipe, two_crop_augment
from moco_tpu_torch.data.datasets import build_dataset
from moco_tpu_torch.utils.config import DataConfig
from moco_tpu_torch.utils.device import resolve_device

LOADER_THREADS = 4  # host threads filling one step's pinned batch


class TwoCropPipeline:
    """{"im_q", "im_k"} batches, (B, S, S, 3) float32 on the device, by
    (epoch, step). Close it (or use it as a context manager) to stop its
    loader threads."""

    def __init__(self, config: DataConfig, seed: int = 0, dataset=None, device="cuda"):
        self.config = config
        self.seed = seed
        self.device = resolve_device(device)
        self.dataset = dataset if dataset is not None else build_dataset(
            config.dataset, config.image_size)
        self.batch_size = config.global_batch
        if len(self.dataset) < self.batch_size:
            raise ValueError(
                f"dataset of {len(self.dataset)} examples < global batch {self.batch_size}")
        self.steps_per_epoch = len(self.dataset) // self.batch_size
        self.recipe = get_recipe(config.aug_plus, config.image_size)
        self._pool = ThreadPoolExecutor(max_workers=LOADER_THREADS)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Seeded shuffle per (seed, epoch), as the JAX pipeline's."""
        return np.random.default_rng((self.seed, epoch)).permutation(len(self.dataset))

    def _host_batch(self, indices: np.ndarray) -> torch.Tensor:
        """The step's uint8 images in one host buffer, pinned when the
        batch goes to a card so the copy can be asynchronous."""
        first, _ = self.dataset.load(int(indices[0]))
        buf = torch.empty((len(indices), *first.shape), dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        view = buf.numpy()
        view[0] = first

        def fill(i):
            view[i] = self.dataset.load(int(indices[i]))[0]

        for f in [self._pool.submit(fill, i) for i in range(1, len(indices))]:
            f.result()
        return buf

    def batch(self, epoch: int, step: int) -> dict:
        """The augmented views of one step."""
        order = self.epoch_order(epoch)
        idx = order[step * self.batch_size:(step + 1) * self.batch_size]
        raw = self._host_batch(idx).to(self.device, non_blocking=True)
        seed = int(np.random.SeedSequence((self.seed, epoch, step)).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        images = raw.float() / 255.0
        return two_crop_augment(self.recipe, gen, images, self.config.image_size)
