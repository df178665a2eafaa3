"""The two-crop training input (the port of moco_tpu/data/pipeline.py's
`TwoCropPipeline` and the host machinery under it).

Split of labour:

- host: the per-epoch seeded order; for datasets with the host-crop
  protocol (ImageFolder, the packed RGB cache), torchvision-exact
  RandomResizedCrop boxes sampled against each image's original geometry,
  decoded once and cropped twice in the loader; otherwise each image
  decoded to a fixed uint8 canvas. Loads run on a thread pool (or the
  native loader's own) straight into a host slot, pinned when the batch
  goes to a card, and the slots are reused from step to step;
- wire: uint8 crosses to the device (4x fewer bytes than f32), a
  `non_blocking` copy from the pinned slot;
- device: /255 and the rest of the augment (`data/augment.py`), its draws
  from a `torch.Generator` on the device seeded from (seed, epoch, step);
  on the host-crop path the recipe without its crop. On a card the
  augment's transform is replayed from a CUDA graph per batch shape.

Two epoch modes, with the same batches bit for bit:

- `epoch(e)`: each batch made in the caller's thread when it is asked
  for, `batch(e, s)` after `batch(e, s - 1)`: the synchronous reference;
- `epoch(e, device=True)`: a decode thread fills pinned slots, a transfer
  thread copies and augments on a side CUDA stream
  (`data/device_prefetch.py`), and the caller takes finished batches, so
  load, copy, augment and step overlap.

Data parallel (`partition`, parallel/dist.py): rank r of n loads only its
rows [r*B/n, (r+1)*B/n) of each seeded global batch of B, and draws the
augment's recipe (and the host crops' boxes) for the whole global batch
from the (seed, epoch, step) generator before it takes its rows, so the
union of the ranks' batches is the one-process batch bit for bit; each
rank has its own ring on its own device. Each batch's uint8 payload is
recorded as the `input.h2d` site of a comms ledger when one is given.

Training pipelines drop the last partial batch, as the reference's
DataLoader does: the queue needs full batches. Every epoch iterator has
`close()`; a consumer that leaves an epoch early must call it, or the
producer thread stays blocked on its queue.

The linear probe's `LabeledPipeline` (one probe-recipe view and the labels)
runs through the same machinery, ring and graphs included; its
`EvalPipeline` scores a whole split in order, the tail padded and masked.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from moco_tpu_torch.analysis import runtime as _runtime
from moco_tpu_torch.data.augment import (
    PROBE_RECIPE,
    AugRecipe,
    apply_recipe,
    draw_recipe,
    get_recipe,
    normalize,
)
from moco_tpu_torch.data.datasets import build_dataset, draw_rrc_uniforms, rrc_boxes_from_uniforms
from moco_tpu_torch.data.device_prefetch import DevicePrefetchRing, _responsive_put
from moco_tpu_torch.obs.trace import span as obs_span
from moco_tpu_torch.utils import faults, retry
from moco_tpu_torch.utils.config import DataConfig
from moco_tpu_torch.utils.device import resolve_device

_END = object()
_CLOSED = object()


def _producer_loop(src: Iterator, q: queue.Queue, stop: threading.Event) -> None:
    """Prefetch producer body. Module-level on purpose: the thread must not
    reference the iterator object, or an abandoned one could never be
    collected (its `__del__` flips the stop flag)."""
    try:
        for item in src:
            if not _responsive_put(q, stop, item):
                return
        _responsive_put(q, stop, _END)
    except BaseException as e:  # re-raised at the consumer's next()
        _responsive_put(q, stop, e)
    finally:
        close = getattr(src, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass


class _PrefetchIterator:
    """Producer thread and bounded queue, with a poison-pill `close()`.

    The producer keeps `depth` items in flight; its errors are re-raised
    at the consumer's `next()`. `close()` flips the stop flag, drains the
    queue (a `put`-blocked producer unblocks within one poll), posts a
    CLOSED pill (a `get`-blocked consumer on another thread unblocks too),
    and joins the thread; the producer then closes its source. Idempotent
    and safe mid-epoch. An iterator dropped without `close()` is collected
    all the same: the thread does not reference it, and `__del__` flips
    the stop flag."""

    def __init__(self, it: Iterator, depth: int = 2, name: str = "prefetch"):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=_producer_loop, args=(it, self._q, self._stop),
                                        daemon=True, name=name)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _END or item is _CLOSED:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:
            self._q.put_nowait(_CLOSED)
        except queue.Full:
            pass
        self._thread.join(timeout=timeout)

    def __del__(self):
        self._stop.set()


class _Slot:
    """One host buffer and the event of the last copy that read it."""

    __slots__ = ("tensor", "copied")

    def __init__(self):
        self.tensor: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None


class _PinnedSlots:
    """A fixed set of host buffers, reused from step to step; pinned when
    the batches go to a card, so their copies are asynchronous. A slot is
    written again only after the copy that last read it has completed.

    Holders never exceed the count: a ring of depth d holds d slots in the
    decode queue, one in the decoder and one in the transfer thread."""

    def __init__(self, n: int, pin: bool):
        self._pin = pin
        self._free: queue.SimpleQueue = queue.SimpleQueue()
        for _ in range(n):
            self._free.put(_Slot())

    def acquire(self, shape) -> _Slot:
        try:
            slot = self._free.get_nowait()
        except queue.Empty:
            raise RuntimeError("no free host slot: more batches in flight than slots") from None
        if slot.copied is not None:
            slot.copied.synchronize()
            slot.copied = None
        if slot.tensor is None or tuple(slot.tensor.shape) != tuple(shape):
            slot.tensor = torch.empty(tuple(shape), dtype=torch.uint8, pin_memory=self._pin)
        return slot

    def release(self, slot: _Slot, copied: Optional[torch.cuda.Event] = None) -> None:
        slot.copied = copied
        self._free.put(slot)


def _leaves(tree) -> list:
    """The tensors of nested tuples and dicts, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _rows(draws: dict, partition) -> dict:
    """A rank's rows of every draw of a whole-batch recipe."""
    return {k: _rows(v, partition) if isinstance(v, dict) else partition.rows(v)
            for k, v in draws.items()}


def _clone(draws: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in draws.items()}


class _GraphedAugment:
    """The device augment's transform replayed from CUDA graphs, one per
    batch shape: the counterpart of the JAX pipeline's jitted augment. Run
    eagerly, the transform issues ~1500 small ops per batch (about 20 ms of
    host time for 256 images at 224 px on an H100 machine), which on the
    ring's thread take the interpreter lock from the step's launches; a
    replay is one launch. The draws are made eagerly from the seeded
    generator and copied into the graph's static inputs, so a replay
    computes what the eager transform computes on them.

    Replays may come from any thread and stream, one at a time: each waits
    for the last one's outputs to be copied out of the static buffers."""

    def __init__(self, transform):
        self._transform = transform  # (precropped, raw, *draws) -> the views
        self._graphs: dict = {}
        self._lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None

    def __call__(self, precropped: bool, raw: torch.Tensor, *draws: dict):
        inputs = (raw, *draws)
        key = (precropped, tuple(raw.shape))
        with self._lock:
            stream = torch.cuda.current_stream(raw.device)
            if self._done is not None:
                stream.wait_event(self._done)
            if key not in self._graphs:
                self._graphs[key] = self._capture(precropped, inputs)
            graph, static_in, static_out = self._graphs[key]
            for dst, src in zip(_leaves(static_in), _leaves(inputs)):
                dst.copy_(src)
            graph.replay()
            out = ({k: v.clone() for k, v in static_out.items()} if isinstance(static_out, dict)
                   else static_out.clone())
            self._done = torch.cuda.Event()
            self._done.record(stream)
        return out

    def _capture(self, precropped, inputs):
        raw, *draws = inputs
        static_in = (raw.clone(), *map(_clone, draws))
        side = torch.cuda.Stream(raw.device)
        side.wait_stream(torch.cuda.current_stream(raw.device))
        with torch.cuda.stream(side):  # warm-up: cuDNN's and cuBLAS's first-call work
            self._transform(precropped, *static_in)
        torch.cuda.current_stream(raw.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        _runtime.note_capture()  # strict_tracing's compile count
        # thread_local: the step's work on the other threads may go on
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self._transform(precropped, *static_in)
        return graph, static_in, static_out

    def clear(self) -> None:
        with self._lock:
            self._graphs.clear()


class HostBatch(NamedTuple):
    """One step's host-side product, not yet on the device: the uint8 rows
    in `slot.tensor`, (B, n_views, S, S, 3) precropped on the host-crop
    path, else (B, H, W, 3); `seed` seeds the device augment's draws."""

    step: int
    seed: int
    slot: _Slot
    slots: _PinnedSlots
    labels: Optional[np.ndarray]
    precropped: bool

    @property
    def views(self) -> torch.Tensor:
        return self.slot.tensor

    @property
    def wire_bytes(self) -> int:
        """uint8 payload this batch puts on the wire."""
        n = self.views.numel()
        if self.labels is not None:
            n += int(self.labels.nbytes)
        return n


class _HostPipeline:
    """Host-side machinery: the dataset, batch and step accounting, the
    loader pool, the host slots and the seeded per-epoch order."""

    def __init__(self, config: DataConfig, seed: int = 0, dataset=None, train: bool = True,
                 drop_last: bool = True, device="cuda", partition=None, ledger=None):
        self.config = config
        self.seed = seed
        self.device = resolve_device(device)
        # this rank's rows of each global batch (parallel/dist.py); None = all
        self.partition = partition
        self.ledger = ledger
        self.dataset = dataset if dataset is not None else build_dataset(
            config.dataset, config.data_dir, config.image_size, train=train,
            num_workers=config.num_workers, cache_dir=config.cache_dir)
        self.batch_size = config.global_batch
        if drop_last and len(self.dataset) < self.batch_size:
            raise ValueError(
                f"dataset of {len(self.dataset)} examples < global batch {self.batch_size}")
        n = len(self.dataset)
        self.steps_per_epoch = n // self.batch_size if drop_last else -(-n // self.batch_size)
        self._pool = ThreadPoolExecutor(max_workers=max(config.num_workers, 1))
        self._pin = self.device.type == "cuda"
        self._slots = _PinnedSlots(1, self._pin)  # the synchronous path's

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- host stage (loads; nothing on the device) ------------------------

    def _host_batch(self, indices: np.ndarray, slots: _PinnedSlots) -> tuple[_Slot, np.ndarray]:
        """The images of `indices` in a host slot, and their labels: through
        the dataset's batched `load_batch` (the native loader) where it has
        one, else by the thread pool straight into the slot. The whole read
        runs under the retry layer (site `data.read`)."""

        def _load():
            faults.maybe_io_error("data.read")
            faults.maybe_delay("data.read")
            if hasattr(self.dataset, "load_batch"):
                imgs, labels = self.dataset.load_batch(indices)
                slot = slots.acquire(imgs.shape)
                slot.tensor.numpy()[...] = imgs
                return slot, np.asarray(labels, np.int32)
            first, label0 = self.dataset.load(int(indices[0]))
            slot = slots.acquire((len(indices), *first.shape))
            view = slot.tensor.numpy()

            def fill(row):
                img, label = self.dataset.load(int(indices[row]))
                view[row] = img
                return label

            futures = []
            try:
                view[0] = first
                for row in range(1, len(indices)):
                    futures.append(self._pool.submit(fill, row))
                labels = [label0, *(f.result() for f in futures)]
            except BaseException:
                concurrent.futures.wait(futures)  # no write lands after the release
                slots.release(slot)
                raise
            return slot, np.asarray(labels, np.int32)

        # on the decode thread's track: decode time that overlaps the step
        # shows as such, instead of inflating the step's data wait
        with obs_span("host_decode", n=len(indices)):
            return retry.retry_call(_load, site="data.read")

    def _local_crop_batch(self, global_indices: np.ndarray, epoch: int, step: int,
                          n_crops: int, scale: tuple, out_size: int) -> tuple[np.ndarray, np.ndarray]:
        """Host-crop path: n_crops RRC boxes per image against its original
        dims, decoded once and cropped in the loader; (B, n_crops, S, S, 3)
        uint8 and the labels. The uniforms are drawn once per step for the
        batch x crops from a (seed, epoch, step)-keyed numpy generator, as
        the JAX pipeline draws them (one device holds every row)."""

        def _read_dims():
            faults.maybe_io_error("data.read")
            return self.dataset.dims(global_indices)

        dims = retry.retry_call(_read_dims, site="data.read")
        rng = np.random.default_rng((self.seed, epoch, step))
        u = draw_rrc_uniforms(rng, self.batch_size * n_crops)
        boxes = rrc_boxes_from_uniforms(u, np.repeat(dims, n_crops, axis=0), scale=scale)
        boxes = boxes.reshape(len(global_indices), n_crops, 4)
        if self.partition is not None:  # the boxes of the whole batch were drawn
            global_indices = self.partition.local_indices(global_indices)
            boxes = self.partition.rows(boxes)
        with obs_span("host_decode", n=len(global_indices), crops=n_crops):
            faults.maybe_delay("data.read")
            raw, labels = retry.retry_call(self.dataset.load_crop_batch, global_indices, boxes,
                                           out_size, pool=self._pool, site="data.read")
        return raw, np.asarray(labels, np.int32)

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Seeded shuffle per (seed, epoch), as the JAX pipeline's."""
        return np.random.default_rng((self.seed, epoch)).permutation(len(self.dataset))

    @property
    def host_crops(self) -> bool:
        """Crops sampled and cut on the host, against each image's original
        geometry, when the config asks and the dataset can."""
        return self.config.host_rrc and hasattr(self.dataset, "load_crop_batch")

    # -- epoch assembly ---------------------------------------------------

    def _epoch_iter(self, epoch: int, device: bool, depth: Optional[int], start: int,
                    stop: Optional[int]):
        """Steps [start, stop) of one epoch in either mode (module
        docstring): each batch made when asked for, or decode thread ->
        transfer ring -> consumer."""
        depth = 2 if depth is None else int(depth)
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        stop = self.steps_per_epoch if stop is None else min(stop, self.steps_per_epoch)
        if device:
            slots = _PinnedSlots(depth + 2, self._pin)
            host_it = _PrefetchIterator(self._host_gen(epoch, slots, start, stop), depth=depth)
            return DevicePrefetchRing(host_it, self._stage, depth=depth, device=self.device)
        return (self._stage(hb)[0] for hb in self._host_gen(epoch, self._slots, start, stop))


class _AugmentedPipeline(_HostPipeline):
    """Shuffled training batches by (epoch, step): each step's images
    loaded on the host (host crops where the dataset has the protocol),
    copied to the device and augmented there, in either epoch mode. A
    subclass gives its recipe, its crops per image, whether it keeps the
    labels, and `_draw` / `_transform` / `_output`."""

    N_CROPS = 1
    LABELED = False

    def __init__(self, config: DataConfig, recipe: AugRecipe, seed: int = 0, dataset=None,
                 train: bool = True, device="cuda", partition=None, ledger=None):
        super().__init__(config, seed=seed, dataset=dataset, train=train, drop_last=True,
                         device=device, partition=partition, ledger=ledger)
        self.recipe = recipe
        # the host-crop path's images arrive cropped to size: the device
        # applies the rest of the recipe
        self._nocrop = recipe._replace(crop=False)
        self._graphed = _GraphedAugment(self._transform)

    def close(self) -> None:
        self._graphed.clear()
        super().close()

    def host_batch(self, epoch: int, step: int, slots: Optional[_PinnedSlots] = None,
                   order: Optional[np.ndarray] = None) -> HostBatch:
        """The host stage of one step, in a slot of `slots` (default: the
        synchronous path's)."""
        slots = self._slots if slots is None else slots
        order = self.epoch_order(epoch) if order is None else order
        idx = order[step * self.batch_size:(step + 1) * self.batch_size]
        seed = int(np.random.SeedSequence((self.seed, epoch, step)).generate_state(1)[0])
        if self.host_crops:
            raw, labels = self._local_crop_batch(idx, epoch, step, n_crops=self.N_CROPS,
                                                 scale=self.recipe.crop_scale,
                                                 out_size=self.config.image_size)
            slot = slots.acquire(raw.shape)
            slot.tensor.numpy()[...] = raw
            precropped = True
        else:
            if self.partition is not None:
                idx = self.partition.local_indices(idx)
            slot, labels = self._host_batch(idx, slots)
            precropped = False
        return HostBatch(step, seed, slot, slots, labels if self.LABELED else None, precropped)

    def _host_gen(self, epoch: int, slots: _PinnedSlots, start: int, stop: int):
        order = self.epoch_order(epoch)
        for step in range(start, stop):
            yield self.host_batch(epoch, step, slots, order)

    def augment(self, hb: HostBatch, raw: torch.Tensor):
        """The device stage's augment of `raw`, the batch's uint8 rows on
        the device: the draws from a generator seeded with the batch's seed,
        then the transform (on a card replayed from a CUDA graph)."""
        gen = torch.Generator(device=self.device).manual_seed(hb.seed)
        recipe = self._nocrop if hb.precropped else self.recipe
        draws = [draw_recipe(recipe, gen, self.batch_size) for _ in range(self.N_CROPS)]
        if self.partition is not None:  # this rank's rows of the batch's draws
            draws = [_rows(d, self.partition) for d in draws]
        if self.device.type == "cuda":
            return self._graphed(hb.precropped, raw, *draws)
        return self._transform(hb.precropped, raw, *draws)

    def _view(self, precropped: bool, raw: torch.Tensor, crop: int, draws: dict) -> torch.Tensor:
        """One augmented view of the batch: crop `crop` of each image on
        the host-crop path, else the decoded images."""
        images = (raw[:, crop] if precropped else raw).float() / 255.0
        recipe = self._nocrop if precropped else self.recipe
        return apply_recipe(recipe, draws, images, self.config.image_size)

    def _stage(self, hb: HostBatch):
        """Copy the batch from its slot to the device, augment it there and
        give the slot back, with the event of its copy on a card (on the
        CPU the copy is the slot itself, so it goes back after the
        augment)."""
        raw = hb.views.to(self.device, non_blocking=True)
        if self.ledger is not None:
            self.ledger.record("input.h2d", "device_put", hb.wire_bytes, 1, operands=[raw])
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
        try:
            with obs_span("augment_dispatch", step=hb.step):
                out = self.augment(hb, raw)
        finally:
            hb.slots.release(hb.slot, copied)
        return self._output(out, hb), hb.wire_bytes

    def _output(self, views, hb: HostBatch):
        return views

    def batch(self, epoch: int, step: int):
        """The batch of one step, made now in this thread."""
        return self._stage(self.host_batch(epoch, step))[0]

    def epoch(self, epoch: int, device: bool = False, depth: Optional[int] = None,
              start: int = 0, stop: Optional[int] = None) -> Iterator:
        """Steps [start, stop) of `epoch` (default: all of it), yielding what
        `batch(epoch, step)` gives; `device=True` through the prefetch ring
        of `depth` (default 2)."""
        return self._epoch_iter(epoch, device, depth, start, stop)


class TwoCropPipeline(_AugmentedPipeline):
    """{"im_q", "im_k"} batches, (B, S, S, 3) float32 on the device, by
    (epoch, step): TwoCropsTransform, the query view's draws first; with a
    `partition`, this rank's rows of them. Close it (or use it as a
    context manager) to stop its loader threads."""

    N_CROPS = 2

    def __init__(self, config: DataConfig, seed: int = 0, dataset=None, train: bool = True,
                 device="cuda", partition=None, ledger=None):
        recipe = get_recipe(config.aug_plus, config.image_size, crops_only=config.crops_only)
        super().__init__(config, recipe, seed=seed, dataset=dataset, train=train, device=device,
                         partition=partition, ledger=ledger)

    def _transform(self, precropped: bool, raw: torch.Tensor, dq: dict, dk: dict) -> dict:
        """The deterministic part of the augment: both views from their
        draws, as `two_crop_augment` composes them."""
        return {"im_q": self._view(precropped, raw, 0, dq),
                "im_k": self._view(precropped, raw, 1, dk)}


class LabeledPipeline(_AugmentedPipeline):
    """Shuffled (images, labels) batches for the linear probe
    (`LabeledPipeline`, pipeline.py:449; `main_lincls.py`'s train
    transform: RandomResizedCrop(0.08-1) + flip + normalize), images
    (B, S, S, 3) float32 and labels (B,) int64 on the device, in either
    epoch mode, host crops where the dataset has the protocol."""

    LABELED = True

    def __init__(self, config: DataConfig, seed: int = 0, dataset=None, device="cuda",
                 partition=None):
        base = get_recipe(config.aug_plus, config.image_size)
        recipe = PROBE_RECIPE._replace(mean=base.mean, std=base.std)
        super().__init__(config, recipe, seed=seed, dataset=dataset, train=True, device=device,
                         partition=partition)

    def _transform(self, precropped: bool, raw: torch.Tensor, draws: dict) -> torch.Tensor:
        return self._view(precropped, raw, 0, draws)

    def _output(self, images, hb: HostBatch):
        labels = torch.from_numpy(hb.labels).to(self.device, torch.int64, non_blocking=True)
        return images, labels


class EvalPipeline(_HostPipeline):
    """Deterministic (images, labels, mask) batches over a whole split
    (`EvalPipeline`, pipeline.py:514; `main_lincls.py`'s val transform):
    the decoded images center-cropped to `image_size` and normalized with
    the recipe's statistics. The tail batch is padded to full size with
    repeats of its last example and masked (mask 1.0 on real rows, 0.0 on
    pads), so every example is scored once and a pad never is. Host loads
    run one batch ahead on a thread. With `partition`, this rank's rows of
    each padded batch and of its mask."""

    def __init__(self, config: DataConfig, train: bool = False, dataset=None, device="cuda",
                 partition=None):
        super().__init__(config, dataset=dataset, train=train, drop_last=False, device=device,
                         partition=partition)
        self.steps = self.steps_per_epoch
        self.recipe = get_recipe(config.aug_plus, config.image_size)

    def _host_gen(self, slots: _PinnedSlots):
        n = len(self.dataset)
        for step in range(self.steps):
            start = step * self.batch_size
            idx = np.arange(start, min(start + self.batch_size, n))
            valid = len(idx)
            if valid < self.batch_size:  # pad the tail, mask the pads
                idx = np.concatenate([idx, np.full(self.batch_size - valid, idx[-1])])
            mask = (np.arange(self.batch_size) < valid).astype(np.float32)
            if self.partition is not None:
                idx, mask = self.partition.local_indices(idx), self.partition.rows(mask)
            slot, labels = self._host_batch(idx, slots)
            yield slot, labels, mask

    def prep(self, raw: torch.Tensor) -> torch.Tensor:
        """uint8 decoded images on the device -> center crop, /255,
        normalize."""
        out_size = self.config.image_size
        x = raw.float() / 255.0
        if x.shape[1] != out_size:
            y0 = (x.shape[1] - out_size) // 2
            x = x[:, y0:y0 + out_size, y0:y0 + out_size]
        return normalize(x, self.recipe.mean, self.recipe.std)

    def __iter__(self):
        slots = _PinnedSlots(4, self._pin)  # prefetch depth 2 + one in each thread
        it = _PrefetchIterator(self._host_gen(slots), depth=2, name="eval-prefetch")
        try:
            for slot, labels, mask in it:
                raw = slot.tensor.to(self.device, non_blocking=True)
                copied = None
                if self.device.type == "cuda":
                    copied = torch.cuda.Event()
                    copied.record()
                try:
                    images = self.prep(raw)
                finally:
                    slots.release(slot, copied)
                yield (images, torch.from_numpy(labels).to(self.device, torch.int64),
                       torch.from_numpy(mask).to(self.device))
        finally:
            it.close()
