"""LR schedule and optimizer (counterpart of moco_tpu/utils/schedules.py).

- `make_lr_schedule`: the reference's per-EPOCH `adjust_learning_rate`
  (cosine, or x0.1 at each milestone) with optional linear warmup,
  evaluated at the optimizer's step count.
- `build_optimizer` for `sgd`: the optax chain
  `add_decayed_weights(wd) -> sgd(lr, momentum)` is, step for step,
  `torch.optim.SGD(momentum=m, dampening=0, nesterov=False,
  weight_decay=wd)` over every parameter (BN and biases included): optax's
  trace `t = g + wd*p + m*t` with update `-lr*t` is torch's
  `buf = m*buf + (g + wd*p)` (the first step `buf = g + wd*p`) and
  `p -= lr*buf`. The caller sets the lr of step n to `schedule(n)` before
  the update, as optax reads its count before incrementing it.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from moco_tpu_torch.utils.config import OptimConfig


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """lr at a global step: per-epoch granular, as `adjust_learning_rate`,
    computed in float32 as the JAX schedule computes it."""

    def schedule(step: int) -> float:
        f32 = torch.float32
        epoch = torch.tensor(step // steps_per_epoch, dtype=f32)
        if cfg.cos:
            factor = 0.5 * (1.0 + torch.cos(math.pi * epoch / cfg.epochs))
        else:
            passed = int((epoch >= torch.tensor(cfg.schedule, dtype=f32)).sum()) if cfg.schedule else 0
            factor = torch.tensor(0.1, dtype=f32) ** passed
        lr = torch.tensor(cfg.lr, dtype=f32) * factor
        if cfg.warmup_epochs > 0:
            warm_steps = cfg.warmup_epochs * steps_per_epoch
            if step < warm_steps:
                lr = torch.tensor(cfg.lr, dtype=f32) * (step + 1) / warm_steps
        return float(lr)

    return schedule


def build_optimizer(cfg: OptimConfig, params) -> torch.optim.Optimizer:
    """SGD as the reference pretrains (`main_moco.py:~L188`); its lr is set
    per step from `make_lr_schedule`."""
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(
            params, lr=cfg.lr, momentum=cfg.momentum, dampening=0.0,
            weight_decay=cfg.weight_decay, nesterov=False,
        )
    if cfg.optimizer in ("lars", "adamw"):
        raise ValueError(
            f"optimizer {cfg.optimizer!r} comes with the large-batch / v3 slice of the port; "
            "this slice trains with sgd"
        )
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
