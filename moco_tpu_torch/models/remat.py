"""Rematerialization of one block of an encoder (the port's form of the
`jax.checkpoint` of the query apply, moco_tpu/core/moco.py:768-775).

JAX checkpoints the whole apply as one segment. In eager PyTorch one
segment saves no peak memory: the backward recomputes every activation of
the encoder before it starts (53.2 against 53.4 GB for ResNet-50 at batch
1024 on an H100, PERF.md). So the encoders checkpoint
each residual or transformer block on its own (`forward(x, remat=True)`):
only the blocks' inputs stay, and each block is recomputed just before its
backward. The values are the same either way.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn


def remat_block(block: nn.Module, x: torch.Tensor, *args) -> torch.Tensor:
    """`block(x, *args)` with its activations recomputed in the backward
    (`remat_call` over the block's buffers)."""
    return remat_call(block, list(block.buffers()), x, *args)


def remat_call(fn, buffers, *args) -> torch.Tensor:
    """`fn(*args)` with its activations recomputed in the backward
    (torch.utils.checkpoint, non-reentrant, which replays the autocast
    state). JAX's checkpoint is functional: the batch statistics come from
    the first forward alone. Here the recompute would move every training
    BN's buffers (of `buffers`) a second time, and a momentum-statistics BN
    would normalize with the already-moved ones; so the recompute runs on
    the buffers as they were before the first forward, and afterwards they
    are put back as the first forward left them. ZeRO's layer segments
    (parallel/zero.py) gather their parameters inside `fn`, so the
    recompute gathers them again."""
    buffers = [b for b in buffers if b.is_floating_point()]
    if not buffers:  # a transformer block: nothing to put back
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    saved: dict = {}

    def run(*args):
        if "after" not in saved:  # the forward
            saved["before"] = [b.clone() for b in buffers]
            out = fn(*args)
            saved["after"] = [b.clone() for b in buffers]
            return out
        with torch.no_grad():  # the recompute, in the backward
            torch._foreach_copy_(buffers, saved["before"])
        try:  # the checkpoint may stop the recompute once it has what it needs
            return fn(*args)
        finally:
            with torch.no_grad():
                torch._foreach_copy_(buffers, saved["after"])

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
