"""Ring attention: exact attention over a sequence sharded across the model
ranks (the port of moco_tpu/parallel/ring_attention.py).

Each rank holds its S/n tokens' queries, keys and values. At each of n
ring steps it runs the flash kernels (ops/flash_attention.py: the CUDA
kernels on the card, their plain versions on the CPU) of its queries
against the visiting K/V shard, merges the step's (out, lse) into a
running (m, num, den) in float32 as JAX does,

    m'   = max(m, lse_blk)
    num  = num * e^(m-m') + out_blk * e^(lse_blk-m')
    den  = den * e^(m-m') + e^(lse_blk-m')

and shifts the K/V shard from rank j to rank j+1; after n steps each
rank holds attention of its queries over the whole sequence, and the
shards are back with their owners. The merged lse is m + log(den).

Gradients: each step goes through `FlashAttention` (dq, dk/dv from both
the out and the lse cotangent), the merge through autograd, and the shift
through `_Shift`, whose backward shifts the cotangent from rank j+1 back
to rank j, so each K/V shard's gradient ends at its owner.

The shift's route is one on every backend: an `all_to_all_single` over
the ring's group whose only non-empty chunk goes to the next rank (NCCL
issues it as one grouped send/receive; gloo as its alltoallv, on CPU and
on CUDA tensors, which two ranks on one card need). A collective cannot
deadlock the way a blocking send before a receive can in a ring.

`Ring` also carries the sum of the sequence-parallel gap pool over the
group (`Ring.sum`), whose backward is the identity (`_GroupSum`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from moco_tpu_torch.obs.comms import tensor_bytes
from moco_tpu_torch.ops.flash_attention import FlashAttention

SITE = "ring_attention.kv_ppermute"


class Ring:
    """`size` ranks in a ring over `group` (None: one rank, no group), this
    process at `rank`; `ledger` (obs/comms.py) takes the shift's site."""

    def __init__(self, group=None, size: int = 1, rank: int = 0, ledger=None):
        if size > 1 and group is None:
            raise ValueError(f"a ring of {size} ranks needs a process group")
        self.group, self.size, self.rank, self.ledger = group, int(size), int(rank), ledger

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Rank j's `x` on rank j+1 (differentiable: `_Shift`)."""
        if self.size == 1:
            return x
        return _Shift.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ring's ranks; its backward hands each
        rank the cotangent as it is (`_GroupSum`)."""
        if self.size == 1:
            return x
        return _GroupSum.apply(x, self)


def _send_next(x: torch.Tensor, ring: Ring, step: int) -> torch.Tensor:
    """`x` of rank j arrives at rank j+step (mod n): one all_to_all whose
    only non-empty chunk goes there."""
    n = ring.size
    flat = x.contiguous().view(-1)
    out = torch.empty_like(flat)
    send = [0] * n
    recv = [0] * n
    send[(ring.rank + step) % n] = flat.numel()
    recv[(ring.rank - step) % n] = flat.numel()
    dist.all_to_all_single(out, flat, recv, send, group=ring.group)
    return out.view(x.shape)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return _send_next(x, ring, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_next(g, ctx.ring, -1), None


class _GroupSum(torch.autograd.Function):
    """The sum over the ring's group. What follows the sum is computed alike
    on every rank, so each rank's cotangent of it is the same, and it is
    the cotangent of each rank's term: the backward is the identity. (JAX's
    psum transposes to a psum: n times that on every rank.)"""

    @staticmethod
    def forward(ctx, x, ring):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=ring.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def ring_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: Ring,
                            scale: Optional[float] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(out in q's dtype, lse in f32) of this rank's (B, H, S_local, D)
    queries over the whole sequence, whose keys and values are sharded
    over `ring` in rank order; differentiable in q, k and v."""
    n = ring.size
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if ring.ledger is not None:
        ring.ledger.record(SITE, "ppermute", tensor_bytes([k, v]), n, calls_per_step=n,
                          operands=[k, v])
    kv = torch.stack([k, v]) if n > 1 else None
    k_cur, v_cur = k, v
    for step in range(n):
        if step:
            k_cur, v_cur = kv.unbind(0)
        out_blk, lse_blk = FlashAttention.apply(q, k_cur, v_cur, scale)
        out_blk = out_blk.float()
        if step == 0:
            m, num, den = lse_blk, out_blk, torch.ones_like(lse_blk)
        else:
            m_new = torch.maximum(m, lse_blk)
            c_old, c_new = torch.exp(m - m_new), torch.exp(lse_blk - m_new)
            num = num * c_old[..., None] + out_blk * c_new[..., None]
            den = den * c_old + c_new
            m = m_new
        if n > 1:  # n shifts, as JAX's: the shards end back with their owners
            kv = ring.shift(kv)
    return (num / den[..., None]).to(q.dtype), m + torch.log(den)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: Ring,
                   scale: Optional[float] = None) -> torch.Tensor:
    """The attention output of `ring_attention_with_lse`."""
    return ring_attention_with_lse(q, k, v, ring, scale)[0]
