"""Loss and metric primitives (counterpart of moco_tpu/ops/losses.py): the
dense InfoNCE path, `fused_infonce=False`, as in the JAX package."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), as torch.nn.functional.normalize computes it."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def infonce_logits(q, k, queue, temperature: float):
    """((N, 1+K) logits, (N,) int64 labels == 0): the positive is column 0,
    the negatives follow, all over T; k and the queue are detached."""
    k, queue = k.detach(), queue.detach()
    l_pos = (q * k).sum(-1, keepdim=True)
    l_neg = q @ queue.T
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return logits, torch.zeros(q.shape[0], dtype=torch.long, device=q.device)


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy with integer labels (stable log-softmax)."""
    logz = torch.logsumexp(logits, dim=-1)
    true = logits.gather(-1, labels[:, None])[:, 0]
    return (logz - true).mean()


def topk_accuracy(logits, labels, ks=(1, 5)) -> dict:
    """Top-k accuracy in percent. A row counts for k when fewer than k
    logits rank above its label's, where equal logits rank by index as in
    `lax.top_k` (the lower index first): the JAX metric, ties included,
    without sorting the row."""
    true = logits.gather(-1, labels[:, None])
    cols = torch.arange(logits.shape[-1], device=logits.device)
    above = (logits > true) | ((logits == true) & (cols[None, :] < labels[:, None]))
    rank = above.sum(-1)
    return {f"acc{k}": 100.0 * (rank < k).float().mean() for k in ks}
