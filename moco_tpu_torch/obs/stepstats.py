"""Step-time breakdown probe and device-memory gauges, the port's
moco_tpu/obs/stepstats.py.

Where does a step's wall time go?

- *host data wait*: the loop blocked on the prefetch ring (`t_data`);
- *wire*: the batch's host-to-device copy, reported apart as
  `t_transfer` by the ring (data/device_prefetch.py);
- *dispatch*: the host's time to issue the step's kernels (Python,
  autograd, launches), `t_dispatch`;
- *device*: the card finishing what was issued, `t_device`.

Kernel launches return before the card finishes, so `t_dispatch` alone
says nothing about device time. The training loop keeps steps in flight and
waits on the card only on the steps the probe samples (every `every`
steps): there it waits for the stream after the dispatch, so `t_device`
is the device-side tail of that step. Off sampled steps the probe costs
nothing.

Device memory comes from `torch.cuda.memory_stats` (current and peak
allocated bytes) and the card's capacity; on the CPU the three gauges are
null, "unknown", never a fake zero, as JAX's are where a backend has no
memory statistics.
"""

from __future__ import annotations

from typing import Optional

import torch


class StepTimeProbe:
    """Per-step timing accumulator for the train loop, with the API and
    payload of JAX's.

    Per iteration:
        probe.data_wait(seconds)        # host blocked on input
        probe.dispatched(seconds)       # step_fn returned (kernels queued)
        if probe.should_sample(step):
            t0 = time.perf_counter()
            wait for the stream
            probe.device_block(time.perf_counter() - t0)
        probe.step_done(total_seconds)

    `payload()` gives the metrics line's fields: always `t_data` and
    `t_step`; `t_dispatch` and `t_device` from the latest sampled step
    (absent until one happened). `step_done` receives the smoothed
    per-step wall, (wall since the previous logged flush) / (steps since
    it): with steps in flight one iteration's host wall is mostly dispatch."""

    def __init__(self, every: int = 0):
        self.every = int(every)
        self.t_data = 0.0
        self.t_step = 0.0
        self._last_dispatch: Optional[float] = None
        self._t_dispatch: Optional[float] = None
        self._t_device: Optional[float] = None

    def should_sample(self, step: int) -> bool:
        return self.every > 0 and step % self.every == 0

    def data_wait(self, seconds: float) -> None:
        self.t_data = seconds

    def dispatched(self, seconds: float) -> None:
        self._last_dispatch = seconds

    def device_block(self, seconds: float) -> None:
        # a sampled step: this iteration's dispatch and the device wait
        # become the published pair
        self._t_dispatch = self._last_dispatch
        self._t_device = seconds

    def step_done(self, seconds: float) -> None:
        self.t_step = seconds

    @property
    def last_dispatch(self) -> Optional[float]:
        """The latest host dispatch time (every step, sampled or not)."""
        return self._last_dispatch

    def payload(self) -> dict:
        out = {"t_data": self.t_data, "t_step": self.t_step}
        if self._t_device is not None:
            out["t_dispatch"] = self._t_dispatch
            out["t_device"] = self._t_device
        return out


def device_memory_stats(device=None) -> Optional[dict]:
    """{'hbm_live_bytes', 'hbm_peak_bytes', 'hbm_headroom_bytes'} of a CUDA
    device (default: the current one), or None without one. Live and peak
    are the caching allocator's allocated bytes (`allocated_bytes.all.*`);
    headroom is the card's capacity less the live bytes, as JAX defines it
    (bytes_limit - bytes_in_use)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    live = int(stats.get("allocated_bytes.all.current", 0))
    peak = int(stats.get("allocated_bytes.all.peak", 0))
    capacity = int(torch.cuda.get_device_properties(device).total_memory)
    return {"hbm_live_bytes": live, "hbm_peak_bytes": peak,
            "hbm_headroom_bytes": capacity - live}


def memory_payload(device=None) -> dict:
    """The metrics line's device-memory fields: the gauges on a card,
    explicit nulls otherwise (the keys are always present)."""
    stats = device_memory_stats(device)
    if stats is None:
        return {"hbm_live_bytes": None, "hbm_peak_bytes": None, "hbm_headroom_bytes": None}
    return stats


def tree_shard_bytes(tensors) -> int:
    """Bytes of a collection of tensors, each counted once (a tensor that
    appears twice is not counted twice) —
    the at-rest footprint of the persistent train state (`hbm_state_bytes`).
    On one device every tensor is whole; JAX's version counts each leaf's
    shard under its sharding."""
    seen, total = set(), 0
    for t in tensors:
        if not torch.is_tensor(t):
            continue
        key = (t.data_ptr(), t.numel(), t.dtype, t.device)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


__all__ = [
    "StepTimeProbe",
    "device_memory_stats",
    "memory_payload",
    "tree_shard_bytes",
]
