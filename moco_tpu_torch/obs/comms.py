"""The comms ledger: named collective sites and their analytic bytes per
step (moco_tpu/obs/comms.py).

Each collective site of a data-parallel step records, as it issues the
collective, its analytic per-rank wire cost in the world's ledger; the
driver writes the ledger as `comms/<site>` bytes-per-step gauges (and
`comms/total`) on every metrics line. The counts are computed from the
operands' shapes and dtypes, never measured, with JAX's cost model (per
rank, per call; n = group size, b = this rank's operand bytes):

    all_gather     b * (n-1)        receives every other shard
    all_to_all     b * (n-1)/n      keeps 1/n of its own data
    psum           2b * (n-1)/n     ring all-reduce
    psum_scatter   b * (n-1)/n
    ppermute       b
    broadcast      b
    device_put     b                host -> device, whatever n

A site over a group of one records 0 bytes but still registers. A site that
fires several times a step records `calls_per_step` (the ring's shifts:
n per call). The site names are JAX's: `shuffle.gather_images`,
`shuffle.gather_keys`, `shuffle.a2a`, `shuffle.a2a_unshuffle`,
`queue.enqueue_gather`, `grad.psum`, `v3.key_gather` and `input.h2d`; on
the model axis `queue.logits_gather` (the dense loss over a sharded
queue), `grad.seq_psum` and `ring_attention.kv_ppermute`, and the port's
`queue.stats_gather` (the fused loss over a sharded queue moves (2, B)
statistics where JAX's `queue.logits_gather` moves (B, K/n) logits);
and ZeRO's `zero.*` sites
(parallel/zero.py: `zero.grad_reduce_scatter` and `zero.params_all_gather`
at stage 1, a site per fusion bucket at stages 2/3), registered where JAX's
step registers them at the same n (under `gather_perm` the enqueue reuses the
key gather, so `queue.enqueue_gather` is absent). The all-reduces JAX does
not tag (metrics, BN statistics, SyncBN's moments) are not in it either.

The ledger is an object that its world owns (parallel/mesh.py), not
process state: a new run starts with a new or reset one.

Each `record` also feeds the collective-schedule sanitizer
(analysis/sanitizer.py) when its recorder is installed: the site, the
collective and the operands' (shape, dtype) signature. The port records
on every eager call of every step, where JAX records once per trace; the
recorder keeps the first-seen entries only, so its hash is the schedule,
not the step count. With no recorder installed this costs one None check.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from moco_tpu_torch.analysis import sanitizer as _schedule
from moco_tpu_torch.utils.locks import make_lock

COLLECTIVES = ("all_gather", "all_to_all", "psum", "psum_scatter", "ppermute", "broadcast",
               "device_put")


def tensor_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Payload bytes of `tensors`."""
    return sum(t.numel() * t.element_size() for t in tensors)


def shape_signature(tensors: Iterable[torch.Tensor]) -> str:
    """Stable (shape, dtype) signature of `tensors`, JAX's spelling (for
    the schedule sanitizer)."""
    return ",".join(f"{tuple(t.shape)}:{str(t.dtype).removeprefix('torch.')}"
                    for t in tensors)


def collective_bytes(collective: str, nbytes: int, axis_size: int) -> int:
    """Per-rank wire bytes of one call of `collective` on a local operand of
    `nbytes` over a group of `axis_size` (the module docstring's model)."""
    n = int(axis_size)
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r} (known: {COLLECTIVES})")
    if collective == "device_put":
        return nbytes
    if n <= 1:
        return 0
    if collective == "all_gather":
        return nbytes * (n - 1)
    if collective == "all_to_all":
        return (nbytes * (n - 1)) // n
    if collective == "psum":
        return (2 * nbytes * (n - 1)) // n
    if collective == "psum_scatter":
        return (nbytes * (n - 1)) // n
    return nbytes


@dataclasses.dataclass(frozen=True)
class CommSite:
    """One collective site as last recorded (each site is called once a
    step)."""

    site: str
    collective: str
    operand_bytes: int  # this rank's operand
    bytes_per_step: int  # analytic wire cost, every call of the step
    axis_size: int
    calls_per_step: int = 1


class CommsLedger:
    """site -> CommSite; a site recorded again replaces its entry (the
    shapes of a run's steps do not change). Thread-safe: the prefetch
    ring's transfer thread records `input.h2d`."""

    def __init__(self):
        self._lock = make_lock("obs.comms")
        self._sites: dict[str, CommSite] = {}

    def record(self, site: str, collective: str, nbytes: int, axis_size: int,
               calls_per_step: int = 1, operands: Iterable[torch.Tensor] = ()) -> None:
        """Record `site`'s cost; `operands` are the tensors of this rank's
        call, whose signature the schedule sanitizer records."""
        if _schedule.enabled():
            _schedule.on_tag(site, collective, shape_signature(operands))
        rec = CommSite(site, collective, int(nbytes),
                       collective_bytes(collective, int(nbytes), axis_size) * int(calls_per_step),
                       int(axis_size), int(calls_per_step))
        with self._lock:
            self._sites[site] = rec

    def snapshot(self) -> dict[str, CommSite]:
        with self._lock:
            return dict(self._sites)

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()

    def payload(self) -> dict:
        """`comms/<site>` per-step bytes and `comms/total`; {} while no site
        is recorded."""
        sites = self.snapshot()
        if not sites:
            return {}
        out = {f"comms/{name}": rec.bytes_per_step for name, rec in sites.items()}
        out["comms/total"] = sum(rec.bytes_per_step for rec in sites.values())
        return out
