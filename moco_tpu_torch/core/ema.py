"""Momentum (EMA) key-encoder update (counterpart of moco_tpu/core/ema.py).

The JAX package returns a new tree; the port updates the key encoder's
parameters in place under no_grad, which saves a second copy of the
encoder. Only parameters move: the key encoder's BN buffers are its own,
updated by its train-mode forward.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(encoder_k: nn.Module, encoder_q: nn.Module, momentum: float) -> None:
    """param_k <- param_k * m + param_q * (1 - m), in place, parameters only."""
    params_k = list(encoder_k.parameters())
    params_q = list(encoder_q.parameters())
    if len(params_k) != len(params_q):
        raise ValueError(f"encoders differ: {len(params_k)} vs {len(params_q)} parameters")
    torch._foreach_mul_(params_k, momentum)
    torch._foreach_add_(params_k, params_q, alpha=1.0 - momentum)
