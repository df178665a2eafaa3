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
- `build_optimizer` for `adamw`: `optax.adamw(lr, weight_decay,
  mask=_bn_and_bias_mask)` is `torch.optim.AdamW` over two parameter
  groups (`decay_groups`), step for step: torch's decoupled decay
  `p *= 1 - lr*wd` followed by the Adam step equals optax's
  `p -= lr * (adam + wd*p)`, and the bias corrections are the same.
- `build_optimizer` for `lars`: `LARS`, the chain `optax.lars` builds
  (class docstring), over the same two groups.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

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


def flax_leaf_name(module: nn.Module, param_name: str) -> str:
    """The Flax leaf a parameter of `module` comes from under convert.py's
    layout rules: a norm layer's `weight` is `scale`, any other layer's
    `kernel`, `bias` is `bias`, and a bare parameter (the ViT's
    `cls_token`) keeps its name."""
    if param_name == "weight":
        norms = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
        return "scale" if isinstance(module, norms) else "kernel"
    return param_name


def decay_groups(modules, weight_decay: float) -> list[dict]:
    """The trainable parameters of `modules` in two AdamW groups, decided as
    `_bn_and_bias_mask` (moco_tpu/utils/schedules.py:51) decides, by the
    Flax leaf name and not by ndim: decayed unless the leaf is `bias` or
    `scale` (so the ViT's cls_token and patch kernel are decayed, norm
    weights and every bias are not)."""
    decay, keep = [], []
    for module in modules:
        for sub in module.modules():
            for name, p in sub.named_parameters(recurse=False):
                if p.requires_grad:
                    leaf = flax_leaf_name(sub, name)
                    (keep if leaf in ("bias", "scale") else decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay, "decay": True},
            {"params": keep, "weight_decay": 0.0, "decay": False}]


class LARS(torch.optim.Optimizer):
    """LARS as `optax.lars` builds it (moco_tpu/utils/schedules.py:51-88,
    eps 0, no Nesterov), per parameter p with gradient g, in this order:

    1. u = g + weight_decay * p (`add_decayed_weights`);
    2. u *= trust_coefficient * |p| / |u|, or by 1 where either norm is 0
       (`scale_by_trust_ratio`, whole-tensor L2 norms);
    3. u *= -lr (`scale_by_learning_rate`);
    4. trace = u + momentum * trace (`trace`, from zeros), p += trace.

    Steps 1 and 2 apply where the group's `decay` is true, the
    `_bn_and_bias_mask` of `decay_groups`. The lr enters before the trace,
    so the trace holds lr-scaled updates and a change of lr does not
    rescale it (torch SGD's buffer holds unscaled ones). The trace is each
    parameter's `trace` state, with optax's sign."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      trust_coefficient=trust_coefficient, decay=True))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            u = [p.grad for p in params]
            if group["decay"]:
                if group["weight_decay"]:
                    u = torch._foreach_add(u, params, alpha=group["weight_decay"])
                p_norm = torch.stack(torch._foreach_norm(params))
                u_norm = torch.stack(torch._foreach_norm(u))
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    group["trust_coefficient"] * p_norm / u_norm)
                u = torch._foreach_mul(u, list(ratio.unbind()))
            u = torch._foreach_mul(u, -group["lr"])
            old, new = [], []
            for p, update in zip(params, u):
                st = self.state[p]
                if "trace" in st:
                    old.append(st["trace"])
                    new.append(update)
                else:  # the trace starts from zeros: zeros * momentum + u
                    st["trace"] = update
            if old:
                torch._foreach_mul_(old, group["momentum"])
                torch._foreach_add_(old, new)
            torch._foreach_add_(params, [self.state[p]["trace"] for p in params])


def build_optimizer(cfg: OptimConfig, params) -> torch.optim.Optimizer:
    """SGD as the reference pretrains (`main_moco.py:~L188`), LARS as
    `optax.lars`, or AdamW as `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8)
    over `params`, parameters or groups (`decay_groups` for the mask; LARS
    decays and trust-scales every parameter of a bare list); its lr is set
    per step from `make_lr_schedule`."""
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(
            params, lr=cfg.lr, momentum=cfg.momentum, dampening=0.0,
            weight_decay=cfg.weight_decay, nesterov=False,
        )
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer == "lars":
        return LARS(params, lr=cfg.lr, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                    trust_coefficient=cfg.trust_coefficient)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
