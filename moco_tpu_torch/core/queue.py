"""The negative-key FIFO dictionary (counterpart of moco_tpu/core/queue.py).

A (K, dim) row-major tensor of L2-normalized rows. The write goes through
the serving index's `fifo_write`, as the JAX package's goes through its
own, so training and serving keep their dictionaries with one function.
"""

from __future__ import annotations

import torch

from moco_tpu_torch.ops.losses import l2_normalize
from moco_tpu_torch.serve.index import fifo_write


def init_queue(generator: torch.Generator, num_negatives: int, dim: int,
               device="cpu") -> torch.Tensor:
    """Random L2-normalized rows drawn from `generator` (which lives on
    `device`), like the reference's normalized randn."""
    q = torch.randn((num_negatives, dim), generator=generator, device=device)
    return l2_normalize(q, dim=-1)


def enqueue(queue: torch.Tensor, ptr: int, keys: torch.Tensor) -> tuple[torch.Tensor, int]:
    """FIFO write of a (N, dim) key block at `ptr`, in place; returns
    (queue, new_ptr). Requires K % N == 0 (`check_queue_divisibility`)."""
    return fifo_write(queue, ptr, keys)


def check_queue_divisibility(num_negatives: int, global_batch: int) -> None:
    if num_negatives % global_batch != 0:
        raise ValueError(
            f"queue size K={num_negatives} must be divisible by the global batch "
            f"{global_batch} (reference invariant, moco/builder.py:~L70)"
        )
