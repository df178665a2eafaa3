"""The port's prefetch ring (moco_tpu_torch/data/device_prefetch.py) and the
driver that takes its batches: the ring yields `batch(e, s)` bit for bit,
shuts down without leaving a thread behind (closed, blocked on `put`, or
dropped and collected), re-raises its threads' errors at `next()`, overlaps
its stages, and trains to the same losses as the serial path.

The shutdown and overlap tests wait on events and queue states with
generous deadlines and assert orders, never wall-clock margins. The tests
marked `cuda` run the ring on a card (its side stream and pinned slots)
and skip where none is visible. This file imports no JAX, so it also runs
on a machine without it (`--noconftest`).
"""

import dataclasses
import gc
import threading
import time

import numpy as np
import pytest
import torch

from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.data.device_prefetch import H2D_SITE, DevicePrefetchRing, TransferStats
from moco_tpu_torch.data.pipeline import TwoCropPipeline
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import faults

JOIN_S = 30.0  # generous: a join that long means a thread is stuck


@pytest.fixture(autouse=True)
def _no_fault_plan():
    faults.clear()
    yield
    faults.clear()


def _cfg(**kw):
    base = dict(dataset="synthetic", image_size=32, global_batch=4, aug_plus=True, num_workers=2)
    base.update(kw)
    return pc.DataConfig(**base)


def _pipe(device="cpu", n=24, dataset=None, **kw):
    return TwoCropPipeline(_cfg(**kw), seed=5, dataset=dataset or SyntheticDataset(n, 32),
                           device=device)


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _threads(ring):
    """The ring's transfer thread and its decode producer."""
    return [ring._thread, ring._host_iter._thread]


def _wait_for(cond, what, timeout=JOIN_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _joined(threads, timeout=JOIN_S):
    for t in threads:
        t.join(timeout)
    return not any(t.is_alive() for t in threads)


# ------------------------------------------------------------ batches


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_ring_yields_the_synchronous_batches_bit_for_bit(depth):
    with _pipe() as pipe:
        ring = pipe.epoch(1, device=True, depth=depth)
        try:
            got = list(ring)
            stats = ring.stats_payload()
        finally:
            ring.close()
        assert len(got) == pipe.steps_per_epoch == 6
        for step, batch in enumerate(got):
            assert _equal(batch, pipe.batch(1, step)), step
        serial = list(pipe.epoch(1))
        assert all(_equal(a, b) for a, b in zip(got, serial))
        assert stats["transfer_bytes"] == 4 * 32 * 32 * 3 and stats["t_transfer"] >= 0
        assert 0 <= stats["prefetch_depth_live"] <= depth
        assert not any(t.is_alive() for t in _threads(ring))


def test_ring_takes_a_slice_of_the_epoch_and_the_host_crop_path(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in ("a", "b"):
        (tmp_path / c).mkdir()
        for i in range(6):
            h, w = rng.integers(20, 60, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                tmp_path / c / f"{i}.png")
    for dataset, host_crops in ((None, False), ("imagefolder", True)):
        kw = {"dataset": dataset, "data_dir": str(tmp_path)} if dataset else {}
        with TwoCropPipeline(_cfg(image_size=16, **kw), seed=2, device="cpu",
                             dataset=None if dataset else SyntheticDataset(24, 32)) as pipe:
            assert pipe.host_crops == host_crops
            ring = pipe.epoch(0, device=True, depth=2, start=1, stop=3)
            try:
                got = list(ring)
            finally:
                ring.close()
            assert len(got) == 2 and len(list(pipe.epoch(0, start=1, stop=3))) == 2
            for step, batch in zip((1, 2), got):
                assert _equal(batch, pipe.batch(0, step))


def test_ring_depth_must_be_positive():
    with _pipe() as pipe:
        with pytest.raises(ValueError, match=">= 1"):
            pipe.epoch(0, device=True, depth=0)
    with pytest.raises(ValueError, match=">= 1"):
        DevicePrefetchRing(iter([]), lambda x: ({"x": x}, 0), depth=0)


# ------------------------------------------------------------ shutdown


def test_close_mid_epoch_leaves_no_thread():
    with _pipe() as pipe:
        ring = pipe.epoch(0, device=True, depth=2)
        assert _equal(next(ring), pipe.batch(0, 0))
        threads = _threads(ring)
        ring.close()
        ring.close()  # idempotent
        assert _joined(threads) and ring.closed
        with pytest.raises(StopIteration):
            next(ring)


def test_close_unblocks_producers_blocked_on_put():
    """Nothing consumed: both queues fill and both threads block on `put`;
    close() still ends them."""
    with _pipe(n=64) as pipe:
        ring = pipe.epoch(0, device=True, depth=1)
        _wait_for(lambda: ring._q.full() and ring._host_iter._q.full(), "both queues to fill")
        threads = _threads(ring)
        assert all(t.is_alive() for t in threads)
        ring.close()
        assert _joined(threads)


def test_abandoned_ring_is_collected_and_its_threads_end():
    with _pipe(n=64) as pipe:
        ring = pipe.epoch(0, device=True, depth=1)
        next(ring)
        _wait_for(lambda: ring._q.full(), "the ring's queue to fill")
        threads = _threads(ring)
        del ring
        gc.collect()
        assert _joined(threads)


# -------------------------------------------------------------- errors


class _Failing(SyntheticDataset):
    bad = -1

    def load(self, index, decode_size=None):
        if index == self.bad:
            raise ValueError(f"undecodable sample {index}")
        return super().load(index, decode_size)


def test_producer_error_is_raised_at_next():
    ds = _Failing(24, 32)
    with _pipe(dataset=ds) as pipe:
        ds.bad = int(pipe.epoch_order(0)[4 * 2 + 1])  # a row of step 2
        ring = pipe.epoch(0, device=True, depth=2)
        try:
            assert _equal(next(ring), pipe.batch(0, 0)) and _equal(next(ring), pipe.batch(0, 1))
            with pytest.raises(ValueError, match="undecodable sample"):
                next(ring)
            with pytest.raises(StopIteration):
                next(ring)
        finally:
            ring.close()
        assert _joined(_threads(ring))


def test_transfer_error_is_raised_at_next(monkeypatch):
    with _pipe() as pipe:
        augment = pipe.augment

        def failing(hb, raw):
            if hb.step == 1:
                raise RuntimeError("augment failed on step 1")
            return augment(hb, raw)

        monkeypatch.setattr(pipe, "augment", failing)
        ring = pipe.epoch(0, device=True, depth=2)
        try:
            next(ring)
            with pytest.raises(RuntimeError, match="augment failed on step 1"):
                next(ring)
        finally:
            ring.close()
        assert _joined(_threads(ring))


# -------------------------------------------------------------- overlap


def test_slow_transfer_overlaps_the_host_loads():
    """`delay@site=input.h2d` slows the first two transfers: while the
    transfer thread sleeps on batch 0, the decode thread loads batch 1,
    and on batch 1 it loads batch 2 (shown by the order of their events);
    the batches stay right."""
    log, lock = [], threading.Lock()

    def note(what):
        with lock:
            log.append(what)

    class Logged(SyntheticDataset):
        def load(self, index, decode_size=None):
            out = super().load(index, decode_size)
            note(("loaded", index))
            return out

    # a second per transfer: the decode of 4 tiny images fits inside it
    # with a wide margin, however loaded the host
    faults.install(f"delay@site={H2D_SITE}:seconds=1.0:times=2")
    with _pipe(dataset=Logged(24, 32)) as pipe:
        stage = pipe._stage

        def logged_stage(hb):
            out = stage(hb)
            note(("transferred", hb.step))
            return out

        pipe._stage = logged_stage
        ring = pipe.epoch(0, device=True, depth=2)
        try:
            got = [next(ring) for _ in range(3)]
        finally:
            ring.close()
        faults.clear()
        order = pipe.epoch_order(0)
        pos = {e: i for i, e in enumerate(log)}
        last_load = {s: max(pos["loaded", int(i)] for i in order[4 * s:4 * s + 4]) for s in (1, 2)}
        assert last_load[1] < pos["transferred", 0]
        assert last_load[2] < pos["transferred", 1]
        assert all(_equal(b, pipe.batch(0, s)) for s, b in enumerate(got))


def test_transfer_stats_payload():
    stats = TransferStats()
    assert stats.payload() == {}
    stats.record(0.5, 10, 1)
    stats.record(0.25, 30, 2)
    assert stats.payload() == {"t_transfer": 0.25, "transfer_bytes": 30, "prefetch_depth_live": 2}
    assert stats.batches == 2


# --------------------------------------------------------------- driver


def _train_config(device_prefetch, **kw):
    cfg = pc.PRESETS["cifar_smoke"]
    return dataclasses.replace(
        cfg, moco=dataclasses.replace(cfg.moco, num_negatives=64, dim=16),
        data=dataclasses.replace(cfg.data, dataset="synthetic", global_batch=16),
        device_prefetch=device_prefetch, **kw)


def test_train_gives_the_same_losses_with_the_ring_on_and_off():
    out = {ring: train(_train_config(ring), dataset=SyntheticDataset(64, 32), device="cpu",
                       steps=3, num_filters=4)
           for ring in (True, False)}
    on, off = (out[r]["history"] for r in (True, False))
    assert [r["loss"] for r in on] == [r["loss"] for r in off]
    assert all(np.isfinite(r["loss"]) for r in on)
    assert all(r["transfer_bytes"] == 16 * 32 * 32 * 3 for r in on)
    assert all("t_transfer" not in r for r in off)
    assert out[True]["state"].queue_ptr == out[False]["state"].queue_ptr == 48


def test_train_crosses_epochs_and_closes_every_iterator():
    """Six steps over epochs of four, from a state at step 2: the ring of
    each epoch is closed, the last one mid-epoch, and no thread is left."""
    before = set(threading.enumerate())
    cfg = _train_config(True, prefetch_depth=3)
    first = train(cfg, dataset=SyntheticDataset(64, 32), device="cpu", steps=2, num_filters=4)
    out = train(cfg, dataset=SyntheticDataset(64, 32), device="cpu", steps=6, num_filters=4,
                state=first["state"])
    assert [r["step"] for r in out["history"]] == list(range(3, 9))  # the state's step after it
    assert _joined([t for t in threading.enumerate() if t not in before])


def test_train_closes_the_ring_when_the_loss_is_not_finite(monkeypatch):
    from moco_tpu_torch import train as train_module

    real = train_module.make_train_step

    def poisoned(*args, **kw):
        step = real(*args, **kw)

        def run(state, batch):
            out = step(state, batch)
            return {**out, "loss": torch.tensor(float("nan"))}
        return run

    monkeypatch.setattr(train_module, "make_train_step", poisoned)
    before = set(threading.enumerate())
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train(_train_config(True, nan_guard_threshold=1), dataset=SyntheticDataset(64, 32),
              device="cpu", steps=3, num_filters=4)
    assert _joined([t for t in threading.enumerate() if t not in before])


# ----------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ring's side stream and pinned slots)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_ring_on_a_card_yields_the_synchronous_batches(cuda, depth):
    """Each batch read on the consumer's stream, with a matmul queued
    ahead of the read so the side stream runs on: bit-equal to batch()."""
    with _pipe(device=cuda, n=40) as pipe:
        ring = pipe.epoch(0, device=True, depth=depth)
        got = []
        try:
            busy = torch.randn(2048, 2048, device=cuda)
            for batch in ring:
                busy = busy @ busy / 2048 ** 0.5  # the consumer's stream stays busy
                got.append({k: v.clone() for k, v in batch.items()})
                del batch
        finally:
            ring.close()
        torch.cuda.synchronize()
        assert len(got) == pipe.steps_per_epoch
        for step, batch in enumerate(got):
            assert _equal(batch, pipe.batch(0, step)), step
        assert all(t.device.type == "cuda" for b in got for t in b.values())


@pytest.mark.cuda
def test_graphed_augment_equals_the_eager_transform(cuda):
    """On a card the augment is replayed from a CUDA graph: the same bits
    as the eager transform on the same draws, for both views, batch after
    batch (the graph's static inputs refilled each time)."""
    from moco_tpu_torch.data.augment import draw_recipe

    with _pipe(device=cuda) as pipe:
        for step in range(3):
            hb = pipe.host_batch(0, step)
            raw = hb.views.to(cuda)
            gen = torch.Generator(device=cuda).manual_seed(hb.seed)
            dq, dk = (draw_recipe(pipe.recipe, gen, raw.shape[0]) for _ in range(2))
            want = pipe._transform(False, raw, dq, dk)
            got = pipe.augment(hb, raw)
            hb.slots.release(hb.slot)
            assert _equal(got, want), step


@pytest.mark.cuda
def test_labeled_pipeline_ring_on_a_card_yields_the_synchronous_batches(cuda):
    """The probe's (images, labels) tuples through the ring on a card,
    their augment replayed from its own graph: bit-equal to batch()."""
    from moco_tpu_torch.data.datasets import LearnableSyntheticDataset
    from moco_tpu_torch.data.pipeline import LabeledPipeline

    data = pc.DataConfig(dataset="synthetic_learnable", image_size=32, global_batch=8,
                         num_workers=2)
    with LabeledPipeline(data, seed=1, dataset=LearnableSyntheticDataset(40, 32),
                         device=cuda) as pipe:
        ring = pipe.epoch(0, device=True)
        try:
            got = [(images.clone(), labels.clone()) for images, labels in ring]
        finally:
            ring.close()
        assert len(got) == pipe.steps_per_epoch == 5
        for step, (images, labels) in enumerate(got):
            want_images, want_labels = pipe.batch(0, step)
            assert torch.equal(images, want_images) and torch.equal(labels, want_labels), step
