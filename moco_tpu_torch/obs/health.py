"""MoCo training-health reductions (moco_tpu/obs/health.py), computed in the
step on tensors it already holds and returned through its metrics as
0-dim device tensors: no host sync; the driver fetches them on log steps.

- `ema_drift`: relative L2 drift `||q - k|| / ||q||` between the query and
  key encoders' parameters, global and per top-level group (backbone,
  head). Collapsing to 0: the EMA no longer tracks learning; exploding:
  the key encoder no longer gives consistent keys (arXiv:2307.13813).
- `logit_stats` / `logit_stats_from_dense`: mean and std of the positive
  and negative InfoNCE logits, after the temperature. pos ~ neg means the
  dictionary does not discriminate.
- `feature_stats`: mean per-dimension std of the query features across the
  batch (~1/sqrt(d) on the unit sphere, toward 0 under collapse) and the
  count of dimensions above 10% of that.
- `queue_age`: age of the dictionary's keys in steps (mean, max and an
  8-bucket histogram), from the step count and (K, B) alone.

Stds are population stds (`correction=0`), as `jnp.std` computes them.
ZeRO's sharded drift is left out with ZeRO.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import numpy as np
import torch


def _sq_norm(tensors: list, device) -> torch.Tensor:
    """Sum of squares over `tensors`, in float32."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).square().sum()


@torch.no_grad()
def ema_drift(params_q: Mapping[str, Iterable[torch.Tensor]],
              params_k: Mapping[str, Iterable[torch.Tensor]]) -> dict:
    """Relative L2 drift between query and key parameters, grouped as
    `params_q` is ({group: tensors}, the same order on both sides):
    `ema_drift/<group>` per group and `ema_drift` over all."""
    eps = 1e-12
    out = {}
    device = None
    diff_sq = ref_sq = None
    for group, q in params_q.items():
        q, k = list(q), list(params_k[group])
        if len(q) != len(k):
            raise ValueError(f"group {group!r}: {len(q)} query and {len(k)} key tensors")
        device = q[0].device if q else device
        d = _sq_norm(torch._foreach_sub(q, k) if q else [], device)
        r = _sq_norm(q, device)
        out[f"ema_drift/{group}"] = d.sqrt() / (r.sqrt() + eps)
        diff_sq = d if diff_sq is None else diff_sq + d
        ref_sq = r if ref_sq is None else ref_sq + r
    if diff_sq is None:
        diff_sq = ref_sq = torch.zeros((), dtype=torch.float32, device=device)
    out["ema_drift"] = diff_sq.sqrt() / (ref_sq.sqrt() + eps)
    return out


@torch.no_grad()
def ema_drift_sharded(params_q: Mapping[str, Iterable[torch.Tensor]],
                      params_k: Mapping[str, Iterable[torch.Tensor]], world) -> dict:
    """`ema_drift` over ZeRO stage 2/3's shards (each tensor this rank's
    (m,) rows; moco_tpu/obs/health.py:57-80): the local squared norms are
    summed over the ranks (`world`) before the sqrt. The zero padding
    adds nothing, so the gauge is the whole parameters' up to the order of
    the sums."""
    eps = 1e-12
    groups = list(params_q)
    local = []
    device = None
    for group in groups:
        q, k = list(params_q[group]), list(params_k[group])
        if len(q) != len(k):
            raise ValueError(f"group {group!r}: {len(q)} query and {len(k)} key tensors")
        device = q[0].device if q else device
        local += [_sq_norm(torch._foreach_sub(q, k) if q else [], device), _sq_norm(q, device)]
    if not local:
        local = [torch.zeros((), dtype=torch.float32, device=device)] * 2
    total = world.all_reduce_sum(torch.stack(local))
    out = {}
    for i, group in enumerate(groups):
        out[f"ema_drift/{group}"] = total[2 * i].sqrt() / (total[2 * i + 1].sqrt() + eps)
    out["ema_drift"] = total[0::2].sum().sqrt() / (total[1::2].sum().sqrt() + eps)
    return out


def module_groups(encoder: torch.nn.Module) -> dict:
    """{top-level child name: its parameters}: an encoder's params tree
    grouped as the JAX package's (`backbone`, `head`)."""
    return {name: list(child.parameters()) for name, child in encoder.named_children()}


@torch.no_grad()
def logit_stats(pos_logits: torch.Tensor, neg_logits: torch.Tensor) -> dict:
    pos, neg = pos_logits.float(), neg_logits.float()
    return {
        "logit_pos_mean": pos.mean(),
        "logit_pos_std": pos.std(correction=0),
        "logit_neg_mean": neg.mean(),
        "logit_neg_std": neg.std(correction=0),
    }


@torch.no_grad()
def logit_stats_from_dense(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """`logit_stats` of a (B, N) logit matrix whose positive sits at column
    `labels[b]`; the negatives' mean and std from the sum and sum of
    squares with the positives taken out (no (B, N) mask)."""
    lg = logits.float()
    b, n = lg.shape
    pos = lg.gather(1, labels[:, None].long())[:, 0]
    n_neg = float(np.float32(b * (n - 1)))
    neg_mean = (lg.sum() - pos.sum()) / n_neg
    neg_sq = (lg.square().sum() - pos.square().sum()) / n_neg
    neg_std = (neg_sq - neg_mean.square()).clamp_min(0.0).sqrt()
    return {
        "logit_pos_mean": pos.mean(),
        "logit_pos_std": pos.std(correction=0),
        "logit_neg_mean": neg_mean,
        "logit_neg_std": neg_std,
    }


@torch.no_grad()
def feature_stats(feats: torch.Tensor) -> dict:
    """`feature_std` (mean over dimensions of the std across the batch) and
    `feature_dim_active` (dimensions whose std exceeds 10% of the
    uniform-sphere 1/sqrt(d)), of (B, d) features."""
    f = feats.float()
    std = f.std(dim=0, correction=0)
    # 0.1 * (1 / sqrt(d)) in float32, as JAX folds it
    threshold = float(np.float32(0.1) * (np.float32(1.0) / np.sqrt(np.float32(f.shape[-1]))))
    return {"feature_std": std.mean(), "feature_dim_active": (std > threshold).sum().float()}


@torch.no_grad()
def queue_age(step: int, num_negatives: int, global_batch: int, num_buckets: int = 8,
              device="cpu") -> dict:
    """Ages of the enqueued keys in steps: the FIFO holds the last K/B
    batches and the batch enqueued j steps ago has age j, capped at `step`
    (slots still holding their random init are as old as the run).
    `queue_age_hist` is the fraction of keys per age bucket, oldest last."""
    depth = max(num_negatives // max(global_batch, 1), 1)
    ages = torch.arange(1, depth + 1, dtype=torch.float32, device=device).clamp(max=float(step))
    edges = torch.linspace(0.0, float(depth), num_buckets + 1, dtype=torch.float32, device=device)
    bucket = (torch.searchsorted(edges, ages, right=True) - 1).clamp(0, num_buckets - 1)
    hist = torch.zeros(num_buckets, dtype=torch.float32, device=device)
    hist.index_add_(0, bucket, torch.ones_like(ages))
    return {"queue_age_mean": ages.mean(), "queue_age_max": ages.max(),
            "queue_age_hist": hist / depth}


def health_summary(params_q, params_k, feats_q: torch.Tensor, pos_logits: torch.Tensor,
                   neg_logits: torch.Tensor, step: int, num_negatives: int = 0,
                   global_batch: int = 0, drift: Optional[dict] = None) -> dict:
    """EMA drift (`drift` when given, as ZeRO's sharded one), logit stats
    and collapse gauges, plus the queue's ages when there is a queue."""
    out = {}
    out.update(drift if drift is not None else ema_drift(params_q, params_k))
    out.update(logit_stats(pos_logits, neg_logits))
    out.update(feature_stats(feats_q))
    if num_negatives and global_batch:
        out.update(queue_age(step, num_negatives, global_batch, device=feats_q.device))
    return out


# Keys that are batch-local statistics (a data-parallel step would average
# them over its replicas); the rest are functions of the replicated state.
BATCH_LOCAL_KEYS = (
    "logit_pos_mean",
    "logit_pos_std",
    "logit_neg_mean",
    "logit_neg_std",
    "feature_std",
    "feature_dim_active",
)

HEALTH_KEYS = ("ema_drift",) + BATCH_LOCAL_KEYS + (
    "queue_age_mean", "queue_age_max", "queue_age_hist")
