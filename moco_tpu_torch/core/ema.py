"""Momentum (EMA) key-encoder update (counterpart of moco_tpu/core/ema.py).

The JAX package returns a new tree; the port updates the key encoder's
parameters in place under no_grad, which saves a second copy of the
encoder. `ema_update` moves parameters only: the key encoder's BN buffers
are its own, updated by its train-mode forward, except under the EMAN key
forward, where `ema_running_stats` moves them toward the query encoder's.
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


def momentum_bn_stats(running, batch, momentum: float):
    """The momentum-statistics BN update ("Momentum² Teacher",
    arXiv:2101.07525 §3.2), `running * m + batch * (1 - m)`: per tensor, or
    per entry of a list, tuple or dict. The in-model form lives in
    models/resnet.py's `flax_train_batch_norm`."""
    if isinstance(running, dict):
        return {k: momentum_bn_stats(v, batch[k], momentum) for k, v in running.items()}
    if isinstance(running, (list, tuple)):
        return type(running)(momentum_bn_stats(r, b, momentum) for r, b in zip(running, batch))
    return running * momentum + batch * (1.0 - momentum)


def _running_stats(encoder: nn.Module) -> list:
    return [b for m in encoder.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var) if b is not None]


@torch.no_grad()
def ema_running_stats(encoder_k: nn.Module, encoder_q: nn.Module, momentum: float) -> None:
    """The EMAN key statistics (moco_tpu/core/moco.py:1204-1214): every BN
    running mean and var of `encoder_k` <- `momentum_bn_stats` of itself
    and `encoder_q`'s, in place."""
    stats_k, stats_q = _running_stats(encoder_k), _running_stats(encoder_q)
    if len(stats_k) != len(stats_q):
        raise ValueError(f"encoders differ: {len(stats_k)} vs {len(stats_q)} BN statistics")
    torch._foreach_mul_(stats_k, momentum)
    torch._foreach_add_(stats_k, stats_q, alpha=1.0 - momentum)
