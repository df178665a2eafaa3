"""Device prefetch ring: the next batches' host->device copy and augment run
on a side CUDA stream while the step runs (the port of
moco_tpu/data/device_prefetch.py).

In ring mode (`TwoCropPipeline.epoch(e, device=True)`):

- the pipeline's decode producer (`pipeline._PrefetchIterator`) loads
  batch k+2 into a pinned host slot;
- this ring's transfer thread, under `torch.cuda.stream(side)`, issues the
  `non_blocking` copy of batch k+1 from its slot and the augment, and
  records one event per batch;
- the consumer (the train loop) runs step k.

At most `depth` finished batches wait in the output queue. The consumer's
`next()` makes its current stream wait on the batch's event and calls
`record_stream` on every output tensor: the tensors were allocated on the
side stream, and without it the caching allocator would hand their memory
to the side stream's next batch while the step may still read it. On the
CPU the same thread runs the same code without streams.

`stats_payload()` gives the last batch's `t_transfer` (seconds the
transfer thread spent issuing it), `transfer_bytes` (uint8 payload) and
`prefetch_depth_live` (finished batches waiting when the consumer took it).

Shutdown: `close()` is safe from the consumer at any point. It drains the
queue, so a transfer thread blocked on `put` sees the stop flag within
one poll, closes the upstream producer (its poison pill) and joins. A
ring dropped without `close()` is still collected: the thread holds no
reference to the ring, whose `__del__` flips the flags.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import torch

from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.locks import make_lock

# fault-injection site of the transfer stage (`delay@site=input.h2d:seconds=S`)
H2D_SITE = "input.h2d"

_END = object()
_CLOSED = object()


def _responsive_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Bounded put that stays responsive to a stop flag; False = stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _ring_loop(host_iter: Iterator, transfer: Callable, q: queue.Queue,
               stop: threading.Event, device: torch.device) -> None:
    """Transfer-thread body. Module-level on purpose: the thread must not
    reference the ring object, so an abandoned ring can be collected."""
    try:
        stream = None
        if device.type == "cuda":
            torch.cuda.set_device(device)
            stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            for item in host_iter:
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                faults.maybe_delay(H2D_SITE)
                batch, nbytes = transfer(item)
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                seconds = time.perf_counter() - t0
                if not _responsive_put(q, stop, (batch, ready, seconds, nbytes)):
                    return
        _responsive_put(q, stop, _END)
    except BaseException as e:  # re-raised at the consumer's next()
        _responsive_put(q, stop, e)


class TransferStats:
    """Thread-safe transfer accounting of the last batch taken."""

    def __init__(self):
        self._lock = make_lock("data.transfer_stats")
        self.t_transfer: Optional[float] = None  # seconds, last batch
        self.transfer_bytes: Optional[int] = None  # wire bytes, last batch
        self.depth_live: int = 0  # finished batches waiting when the last was taken
        self.batches: int = 0

    def record(self, seconds: float, nbytes: int, depth_live: int) -> None:
        with self._lock:
            self.t_transfer = seconds
            self.transfer_bytes = int(nbytes)
            self.depth_live = int(depth_live)
            self.batches += 1

    def payload(self) -> dict:
        """Record fields t_transfer / transfer_bytes / prefetch_depth_live;
        empty before the first batch."""
        with self._lock:
            if self.batches == 0:
                return {}
            return {"t_transfer": self.t_transfer, "transfer_bytes": self.transfer_bytes,
                    "prefetch_depth_live": self.depth_live}


class DevicePrefetchRing:
    """Depth-N transfer ring between a host-batch iterator and the step
    loop (module docstring). `transfer(host_item) -> (batch, wire_bytes)`
    runs on the ring's thread, inside the side stream on a card; a batch
    is a dict or a tuple of tensors."""

    def __init__(self, host_iter: Iterator, transfer: Callable, depth: int = 2,
                 device="cpu", name: str = "device_prefetch"):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the consumer's device, named for the ring's thread
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stats = TransferStats()
        self._host_iter = host_iter
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_ring_loop, args=(host_iter, transfer, self._q, self._stop, self.device),
            daemon=True, name=name)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _END or item is _CLOSED:
            self._stop.set()  # a later next() must stop too, not block
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        batch, ready, seconds, nbytes = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in (batch.values() if isinstance(batch, dict) else batch):
                t.record_stream(stream)
        self.stats.record(seconds, nbytes, depth_live=self._q.qsize())
        return batch

    def stats_payload(self) -> dict:
        return self.stats.payload()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the transfer thread and the upstream producer and join the
        transfer thread. Idempotent; safe mid-epoch."""
        self._stop.set()
        while True:  # a put-blocked transfer thread unblocks at once
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        upstream_close = getattr(self._host_iter, "close", None)
        if upstream_close is not None:
            upstream_close()
        self._thread.join(timeout=timeout)

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def __del__(self):
        if not hasattr(self, "_thread"):  # __init__ raised before the thread
            return
        self._stop.set()
        upstream_close = getattr(self._host_iter, "close", None)
        if upstream_close is not None:
            try:
                upstream_close(timeout=0)  # never block inside the collector
            except Exception:
                pass


__all__ = ["DevicePrefetchRing", "TransferStats", "H2D_SITE"]
