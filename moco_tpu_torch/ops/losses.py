"""Loss primitives the serving path needs (counterpart of moco_tpu/ops/losses.py)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), as torch.nn.functional.normalize computes it."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
