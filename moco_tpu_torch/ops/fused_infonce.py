"""Fused streaming InfoNCE: the loss, its proxy accuracies and the query
gradient without materializing the (B, 1+K) logits.

The port of moco_tpu/ops/fused_infonce.py. Its two TPU kernels,
`_fwd_kernel` (:40) and `_bwd_kernel` (:71), are the hand-written CUDA
kernels of `csrc/infonce.cu`: split-TF32 products on the tensor cores
and a `cp.async` ring over the queue (its source note gives the bound,
the precision argument and the split-K design). `infonce_stats` and
`infonce_dq` launch them for CUDA tensors and take the plain versions
`infonce_stats_reference` and `infonce_dq_reference` only for CPU
tensors; there is no fallback from one to the other. `InfoNCEStats` is
the `custom_vjp` (:137-196) as an autograd function: a gradient for q
only, the positive term added outside the kernel as `_vjp_bwd` does
(:189-192).

A queue sharded over the model ranks (core/moco.py) runs the kernels on
each rank's shard: `merge_shard_stats` makes the whole queue's lse and
count from every shard's (`sharded_infonce_loss`).
"""

from __future__ import annotations

import ctypes

import torch

from moco_tpu_torch.ops import build

TILE_ROWS = 64  # queue rows per tile of the split plan
MAX_C = 256  # the kernels keep a CTA's query rows and two queue stages in shared memory
TARGET_CTAS = 132  # one CTA on each of an H100's 132 SMs (160-224 KiB of shared memory each)


def query_rows(width: int, forward: bool) -> int:
    """Query rows per CTA of the forward or backward kernel at C = width, as
    the library tiles them (`infonce_query_rows`)."""
    fn = build.load("infonce").infonce_query_rows
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    rows = fn(width, int(forward))
    if rows <= 0:
        raise ValueError(f"the InfoNCE kernels take 0 < C <= {MAX_C}, got C={width}")
    return rows


def infonce_stats_reference(q, k, queue, temperature: float):
    """Plain version, as `_reference` (:125): pos, then q @ queue.T / T,
    logsumexp over [pos | neg], and the count of negatives above pos."""
    pos = (q * k).sum(-1) / temperature
    neg = q @ queue.T / temperature
    lse = torch.logsumexp(torch.cat([pos[:, None], neg], dim=1), dim=1)
    above = (neg > pos[:, None]).sum(-1).to(torch.int32)
    return pos, lse, above


def infonce_dq_reference(q, queue, lse, g_lse, temperature: float):
    """Plain version of the negative term of dq, as the dense branch of
    `_vjp_bwd` (:169-171)."""
    inv_t = 1.0 / temperature
    p_neg = torch.exp(q @ queue.T * inv_t - lse[:, None])
    return (p_neg * g_lse[:, None]) @ queue * inv_t


def split_plan(batch: int, num_keys: int, rows: int) -> tuple[int, int]:
    """(n_split, tiles_per_split): the queue's 64-row tiles cut into
    contiguous runs, enough runs that ceil(B/rows) * n_split CTAs give every
    SM about one; `rows` is the kernel's `query_rows`."""
    tiles = -(-num_keys // TILE_ROWS)
    row_blocks = -(-batch // rows)
    n_split = min(tiles, max(1, -(-TARGET_CTAS // row_blocks)))
    per_split = -(-tiles // n_split)
    return -(-tiles // per_split), per_split


def _check_cuda(name: str, shapes: dict, tensors: dict) -> None:
    for tname, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {tname} is on {t.device}, the others on cuda")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if tuple(t.shape) != shapes[tname]:
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, expected {shapes[tname]}")
    c = shapes["q"][1]
    if not 0 < c <= MAX_C:
        raise ValueError(f"{name}: the kernel takes 0 < C <= {MAX_C}, got C={c}")


def _launch(fn_name: str, argtypes, args) -> None:
    fn = getattr(build.load("infonce"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {err}")


def infonce_stats(q, k, queue, temperature: float):
    """(pos, lse, n_above), each (B,): pos = q.k/T, lse = logsumexp over
    [pos | q.queue_j/T], n_above = #{j : q.queue_j/T > pos}.

    CUDA tensors go through the kernel (each launch adds one to
    `infonce_stats.launches`); CPU tensors through the plain version."""
    if q.device.type == "cpu":
        return infonce_stats_reference(q, k, queue, temperature)
    b, c = q.shape
    kk = queue.shape[0]
    _check_cuda("infonce_stats", {"q": (b, c), "k": (b, c), "queue": (kk, c)},
                {"q": q, "k": k, "queue": queue})
    if b == 0 or kk == 0:
        raise ValueError(f"infonce_stats needs B > 0 and K > 0, got B={b}, K={kk}")
    n_split, per_split = split_plan(b, kk, query_rows(c, forward=True))
    f32 = dict(dtype=torch.float32, device=q.device)
    pos, lse = torch.empty(b, **f32), torch.empty(b, **f32)
    above = torch.empty(b, dtype=torch.int32, device=q.device)
    m_part, l_part = torch.empty(n_split, b, **f32), torch.empty(n_split, b, **f32)
    c_part = torch.empty(n_split, b, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(
            "infonce_fwd_f32",
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
            [q.data_ptr(), k.data_ptr(), queue.data_ptr(), pos.data_ptr(), lse.data_ptr(),
             above.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), c_part.data_ptr(),
             b, kk, c, n_split, per_split, 1.0 / temperature],
        )
    infonce_stats.launches += 1
    return pos, lse, above


infonce_stats.launches = 0


def infonce_dq(q, queue, lse, g_lse, temperature: float):
    """(B, C): sum_j exp(q.queue_j/T - lse) * g_lse * queue_j / T, the
    negative term of the query gradient.

    CUDA tensors go through the kernel (each launch adds one to
    `infonce_dq.launches`); CPU tensors through the plain version."""
    if q.device.type == "cpu":
        return infonce_dq_reference(q, queue, lse, g_lse, temperature)
    b, c = q.shape
    kk = queue.shape[0]
    _check_cuda("infonce_dq", {"q": (b, c), "queue": (kk, c), "lse": (b,), "g_lse": (b,)},
                {"q": q, "queue": queue, "lse": lse, "g_lse": g_lse})
    if b == 0 or kk == 0:
        raise ValueError(f"infonce_dq needs B > 0 and K > 0, got B={b}, K={kk}")
    n_split, per_split = split_plan(b, kk, query_rows(c, forward=False))
    dq_part = torch.empty(n_split, b, c, dtype=torch.float32, device=q.device)
    dq = torch.empty(b, c, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(
            "infonce_bwd_f32",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
            [q.data_ptr(), queue.data_ptr(), lse.data_ptr(), g_lse.data_ptr(),
             dq_part.data_ptr(), dq.data_ptr(), b, kk, c, n_split, per_split,
             1.0 / temperature],
        )
    infonce_dq.launches += 1
    return dq


infonce_dq.launches = 0


class InfoNCEStats(torch.autograd.Function):
    """(pos, lse, n_above) with a gradient for q only (k and the queue are
    detached, as the reference detaches them). Saves (q, k, queue, lse):
    the queue must not be written in place before the backward."""

    @staticmethod
    def forward(ctx, q, k, queue, temperature: float):
        pos, lse, above = infonce_stats(q, k, queue, temperature)
        ctx.save_for_backward(q, k, queue, lse)
        ctx.temperature = temperature
        ctx.mark_non_differentiable(above)
        return pos, lse, above

    @staticmethod
    def backward(ctx, g_pos, g_lse, _g_above):
        q, k, queue, lse = ctx.saved_tensors
        inv_t = 1.0 / ctx.temperature
        # autograd hands in zeros for an output the loss does not use
        dq_neg = infonce_dq(q, queue, lse, g_lse.contiguous(), ctx.temperature)
        # the positive logit, through both the pos output and the lse
        pos = (q * k).sum(-1) * inv_t
        coeff = (g_pos + g_lse * torch.exp(pos - lse)) * inv_t
        return dq_neg + coeff[:, None] * k, None, None, None


def merge_shard_stats(pos, lse_parts, above_parts):
    """(lse, n_above) over the whole queue from each of n shards' (n, B)
    lse over [pos | its rows] and count above pos: the sum of the shards'
    exp(lse_m) counts exp(pos) n times, so
    lse = c + log(sum_m exp(lse_m - c) - (n - 1) exp(pos - c)) with c the
    largest lse_m (every exponent <= 0), and the counts add."""
    n = lse_parts.shape[0]
    c = lse_parts.max(0).values.detach()
    inner = torch.exp(lse_parts - c).sum(0) - (n - 1) * torch.exp(pos - c)
    return c + torch.log(inner), above_parts.sum(0)


def sharded_infonce_loss(q, k, queue_shard, temperature: float, gather):
    """`fused_infonce_loss` over a queue whose rows are sharded over the
    model ranks: the kernels on this rank's shard, then `gather` ((2, B) ->
    (n, 2, B), every rank's lse and count, differentiable: its backward sums
    the cotangent over the ranks) and `merge_shard_stats`. Each rank's
    query gradient then carries n times its shard's share, which the mean
    of the gradients over the model ranks cancels, as JAX's does."""
    pos, lse, above = InfoNCEStats.apply(q, k.detach(), queue_shard.detach(), temperature)
    parts = gather(torch.stack([lse, above.float()]))
    lse, above = merge_shard_stats(pos, parts[:, 0], parts[:, 1].detach())
    loss = (lse - pos).mean()
    return loss, {
        "acc1": 100.0 * (above == 0).float().mean(),
        "acc5": 100.0 * (above < 5).float().mean(),
    }


def fused_infonce_loss(q, k, queue, temperature: float):
    """(mean CE loss, {"acc1", "acc5"}) with the positive at column 0, as
    the dense infonce_logits -> cross_entropy -> topk_accuracy chain."""
    pos, lse, above = InfoNCEStats.apply(q, k.detach(), queue.detach(), temperature)
    loss = (lse - pos).mean()
    return loss, {
        "acc1": 100.0 * (above == 0).float().mean(),
        "acc5": 100.0 * (above < 5).float().mean(),
    }

