"""Each rank's share of the data, and the launch's detection: the port's
counterpart of moco_tpu/parallel/dist.py.

The reference gives each of its GPU processes 1/n of every batch
(`DistributedSampler`, `main_moco.py:~L258`); JAX gives each host the rows
its devices hold under the batch sharding. In the port a process is one
GPU, so data rank d holds the contiguous rows [d*B/n, (d+1)*B/n) of the
global batch B: the rows device d holds on JAX's 1-D data mesh of n
devices (`device_row_ranges`). The model ranks of one data rank (the
model axis, parallel/mesh.py) load the same rows, as JAX's batch is
replicated over `model`. Every rank knows the whole global batch (the epoch
order is seeded), loads only its rows, and draws the augment for the
whole batch before it takes its rows, so the union of the ranks' batches
is the one-process batch.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from moco_tpu_torch.parallel.mesh import World, init_world


def device_row_ranges(world_size: int, global_batch: int) -> list[tuple[int, int]]:
    """[start, stop) of each rank's rows of the global batch."""
    if global_batch % world_size:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {world_size}")
    b = global_batch // world_size
    return [(r * b, (r + 1) * b) for r in range(world_size)]


class DataPartition:
    """Rank `rank`'s rows of every global batch of `global_batch` rows."""

    def __init__(self, rank: int, world_size: int, global_batch: int):
        self.rank, self.world_size = int(rank), int(world_size)
        self.global_batch = int(global_batch)
        self.start, self.stop = device_row_ranges(world_size, global_batch)[rank]
        self.local_positions = np.arange(self.start, self.stop)
        self.local_rows = self.stop - self.start

    @classmethod
    def of(cls, world: World, global_batch: int) -> "DataPartition":
        return cls(world.data_rank, world.num_data, global_batch)

    def local_indices(self, global_indices: np.ndarray) -> np.ndarray:
        """The dataset indices this rank loads for one step, from the step's
        global-batch indices (the same on every rank)."""
        return np.asarray(global_indices)[self.start:self.stop]

    def rows(self, x):
        """This rank's rows of a whole-batch array or tensor."""
        return x[self.start:self.stop]


def wants_distributed() -> bool:
    """A data-parallel launch: torchrun's WORLD_SIZE > 1, or MOCO_MULTIHOST=1
    (a world of one through the distributed path)."""
    env = os.environ
    return int(env.get("WORLD_SIZE", "1")) > 1 or env.get("MOCO_MULTIHOST") == "1"


def maybe_init_distributed(device=None, timeout_s: float = 600.0, num_model: int = 1,
                           num_data: Optional[int] = None) -> Optional[World]:
    """The launch's World when `wants_distributed()`, else None (one device,
    no process group). `device` "cpu" asks for gloo on the CPU; a card
    takes `cuda:<LOCAL_RANK>` and NCCL. The launch's WORLD_SIZE ranks are
    num_data x num_model (parallel/mesh.py `init_world`)."""
    if not wants_distributed():
        return None
    if device is not None and str(device).startswith("cuda"):
        device = None  # each rank drives its own card
    return init_world(device=device, timeout_s=timeout_s, num_model=num_model, num_data=num_data)
