"""MoCo pretraining on one device, v1/v2 or v3 (moco_tpu/train.py `train` /
`_train_impl` without the mesh, ZeRO, watchdog, alerts and elastic parts).

    python -m moco_tpu_torch.train --preset imagenet_v2 --data synthetic --steps 20
    python -m moco_tpu_torch.train --preset imagenet_v2 --data synthetic_learnable \\
        --workdir W --epochs 2 --steps-per-epoch 3 --knn-every-epochs 1
    python -m moco_tpu_torch.train --preset vit_b16_v3 --data synthetic --steps 20 \\
        --batch-size 256 --vit-flash-attention

builds the two-crop pipeline, the encoder and, for v3, the predictor (a
seeded Flax-layout init carried in through `convert`, or a given state),
the optimizer and the train state; runs the steps, each epoch's batches
from the prefetch ring unless `--no-device-prefetch`; and prints one JSON
line per step: loss, acc1, acc5, lr, data and step milliseconds, imgs/s
and the ring's transfer stats.

With a workdir (`config.workdir`, `--workdir`) the loop is closed as the
JAX driver closes it:

- resume: the newest good checkpoint under the workdir is restored before
  the first step (a structurally different config raises
  `ResumeCompatError` before the state read), and training goes on at the
  epoch after the checkpoint's, so the batches stay those of
  `batch(epoch, step)`;
- `metrics.jsonl`: a training line every `log_every` steps and at each
  epoch's last step, event lines, and the kNN monitor's `knn_top1` line;
- the kNN monitor (knn.py) every `knn_every_epochs` epochs and at the last;
- a checkpoint at the end of every `checkpoint_every_epochs`th epoch and
  of the last.

The non-finite guard runs with or without a workdir: on log steps the loss
is checked, as in JAX one step late (after the next step has run, which
the rollback then discards too). A finite log step refreshes a snapshot of
the state (both encoders with their BN statistics, the queue and its
pointer, the predictor, the optimizer's buffers; device buffers allocated
once); a non-finite one counts toward `nan_guard_threshold`, writes a
`nonfinite_loss` event, and restores the snapshot while the step counter
keeps advancing; at the threshold the run raises `FloatingPointError`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from moco_tpu_torch.convert import (
    encoder_from_flax,
    predictor_from_flax,
    random_flax_encoder,
    random_flax_predictor,
)
from moco_tpu_torch.core.moco import (
    TrainState,
    build_encoder,
    build_predictor,
    create_state,
    make_train_step,
)
from moco_tpu_torch.data.datasets import build_dataset
from moco_tpu_torch.data.pipeline import TwoCropPipeline
from moco_tpu_torch.knn import knn_eval
from moco_tpu_torch.utils import faults, retry
from moco_tpu_torch.utils.checkpoint import CheckpointManager, load_state_payload, state_payload
from moco_tpu_torch.utils.config import (
    PRESETS,
    ResumeCompatError,
    TrainConfig,
    config_to_dict,
    resume_compat_diff,
)
from moco_tpu_torch.utils.device import resolve_device
from moco_tpu_torch.utils.metrics import AverageMeter, MetricWriter, ProgressMeter, print0


def _sync(device: torch.device) -> None:
    """Wait for the current stream: the step's work and, in ring mode, the
    batch it waited on, but not the ring's work on later batches."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _seeded_state(config: TrainConfig, device, num_filters: int) -> TrainState:
    """A fresh state from seeded Flax-layout weights: the encoder, and for
    v3 the predictor (drawn from the next seed)."""
    params, stats = random_flax_encoder(config.moco, seed=config.seed, num_filters=num_filters)
    encoder = build_encoder(config.moco, num_filters=num_filters)
    encoder.load_state_dict(encoder_from_flax(params, stats))
    predictor = build_predictor(config.moco)
    if predictor is not None:
        predictor.load_state_dict(predictor_from_flax(
            *random_flax_predictor(config.moco, seed=config.seed + 1)))
    return create_state(config, encoder, device=device, predictor=predictor)


class StateSnapshot:
    """A copy of everything a rollback restores: the parameters and BN
    statistics of both encoders and the predictor, the queue and its
    pointer, and the optimizer's per-parameter state. The copies live in
    buffers allocated on the first `take` (and again only when the
    optimizer's state grows, as SGD's momentum buffers appear at its first
    step); `take` and `restore` are one batched device copy each.
    `state.step` is not part of it: the step counter keeps advancing across
    a rollback."""

    def __init__(self, state: TrainState):
        self._saved: Optional[list] = None
        self._opt_keys: list = []
        self._opt_saved: list = []
        self.queue_ptr = state.queue_ptr
        self.take(state)

    @staticmethod
    def _tensors(state: TrainState) -> list:
        """What a checkpoint holds of the modules (parameters and persistent
        buffers: not the ViT's position embedding, a function of the image
        size), and the queue."""
        modules = [m for m in (state.encoder_q, state.encoder_k, state.predictor) if m is not None]
        out = [t for m in modules for t in m.state_dict(keep_vars=True).values()]
        return out + ([state.queue] if state.queue is not None else [])

    @staticmethod
    def _opt_state(state: TrainState) -> tuple[list, list]:
        keys, tensors = [], []
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                st = state.optimizer.state.get(p, {})
                for k in sorted(st):
                    if torch.is_tensor(st[k]):
                        keys.append((id(p), k))
                        tensors.append(st[k])
        return keys, tensors

    @torch.no_grad()
    def take(self, state: TrainState) -> None:
        live = self._tensors(state)
        if self._saved is None:
            self._saved = [torch.empty_like(t) for t in live]
        keys, opt = self._opt_state(state)
        if keys != self._opt_keys:
            self._opt_keys, self._opt_saved = keys, [torch.empty_like(t) for t in opt]
        torch._foreach_copy_(self._saved, live)
        if opt:
            torch._foreach_copy_(self._opt_saved, opt)
        self.queue_ptr = state.queue_ptr

    @torch.no_grad()
    def restore(self, state: TrainState) -> None:
        torch._foreach_copy_(self._tensors(state), self._saved)
        saved = dict(zip(self._opt_keys, self._opt_saved))
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                st = state.optimizer.state.get(p)
                if st is None:
                    continue
                for k in [k for k in st if torch.is_tensor(st[k])]:
                    if (id(p), k) in saved:
                        st[k].copy_(saved[id(p), k])
                    else:  # the snapshot predates this buffer
                        del st[k]
                if not st:
                    del state.optimizer.state[p]
        state.queue_ptr = self.queue_ptr


def _num_classes(dataset) -> int:
    """A dataset's class count: its `num_classes`, else the largest label
    + 1 over every example."""
    n = getattr(dataset, "num_classes", None)
    if n is not None:
        return int(n)
    labels = getattr(dataset, "labels", None)
    if labels is None:
        labels = [dataset.load(i)[1] for i in range(len(dataset))]
    return int(np.max(np.asarray(labels)) + 1)


def train(config: TrainConfig, dataset=None, device="cuda", steps: Optional[int] = None,
          state: Optional[TrainState] = None, num_filters: int = 64,
          log: Optional[Callable[[dict], None]] = None, knn_datasets=None) -> dict:
    """Run `steps` train steps (default: to the end of epoch
    config.optim.epochs - 1) from `state` (default: a fresh seeded one),
    or from the newest checkpoint under `config.workdir` when there is
    one; returns {"history": [per-step records], "state": the final state,
    "steps_per_epoch": n, "last_avg": the last finished epoch's means
    (and its knn_top1), "nan_steps": non-finite log steps}.

    Each epoch's batches come from `pipe.epoch(e, device=config.device_prefetch,
    depth=config.prefetch_depth)`: the prefetch ring by default, made
    serially when device_prefetch is False. Each step's record holds loss,
    acc1, acc5, lr, data_ms (the wait for the batch), step_ms, imgs_per_s
    and the ring's transfer stats; `log` is called with each record. Host
    times end in a synchronize of the current stream, so they are the
    step's own. `knn_datasets` is the (bank, test) pair of the kNN monitor
    (default: built from config.data, train and held-out splits);
    `num_filters` narrows a fresh encoder for tests."""
    faults.install_from_env()
    device = resolve_device(device)
    workdir = config.workdir
    with TwoCropPipeline(config.data, seed=config.seed, dataset=dataset, device=device) as pipe:
        steps_per_epoch = config.steps_per_epoch or pipe.steps_per_epoch
        if steps_per_epoch <= 0:
            raise ValueError(f"steps_per_epoch must be > 0, got {steps_per_epoch}")
        if state is None:
            state = _seeded_state(config, device, num_filters)
        epoch, i = divmod(state.step, steps_per_epoch)
        ckpt = CheckpointManager(workdir, keep=config.checkpoint_keep) if workdir else None
        if ckpt is not None and ckpt.latest_step() is not None:  # automatic resume

            def check_compat(extra: dict) -> None:
                diffs = resume_compat_diff(extra, config)
                if diffs:
                    raise ResumeCompatError(f"checkpoint under {workdir} is incompatible with "
                                            "the live config:\n  " + "\n  ".join(diffs))

            payload, extra = ckpt.restore(validate_extra=check_compat)
            load_state_payload(state, payload)
            epoch, i = int(extra.get("epoch", 0)) + 1, 0
            print0(f"resumed from epoch {epoch - 1} (step {state.step})")
        step_fn = make_train_step(config, steps_per_epoch, device=device)
        if steps is not None:
            total = steps
        else:
            total = max(config.optim.epochs * steps_per_epoch - (epoch * steps_per_epoch + i), 0)
        knn_pair, knn_classes = None, None
        if config.knn_every_epochs and total:
            knn_pair = knn_datasets or tuple(
                build_dataset(config.data.dataset, config.data.data_dir, config.data.image_size,
                              train=split, num_workers=config.data.num_workers,
                              cache_dir=config.data.cache_dir) for split in (True, False))
            knn_classes = _num_classes(knn_pair[0])
        writer = MetricWriter(workdir) if workdir and total else None
        snapshot = StateSnapshot(state)
        guard = {"nan_steps": 0}
        flush_anchor = {"wall": time.perf_counter(), "gstep": state.step}
        history: list = []
        last_avg: dict = {}

        def flush(p: dict, meters: dict, progress: ProgressMeter) -> None:
            """A log step's deferred processing, run after the next step (or
            at the epoch's end): the guard, then the metrics line."""
            if not p["finite"]:
                guard["nan_steps"] += 1
                if writer is not None:
                    writer.write(p["gstep"], {"epoch": p["epoch"], "event": "nonfinite_loss",
                                              "nan_steps": guard["nan_steps"]})
                    writer.fsync()
                print0(f"WARNING: non-finite loss at step {p['gstep']} "
                       f"({guard['nan_steps']}/{config.nan_guard_threshold}): update skipped",
                       flush=True)
                if guard["nan_steps"] >= config.nan_guard_threshold:
                    raise FloatingPointError(
                        f"aborting: {guard['nan_steps']} non-finite loss steps (threshold "
                        f"{config.nan_guard_threshold}); last at step {p['gstep']}, epoch "
                        f"{p['epoch']}, lr {p['lr']:.3e}")
                snapshot.restore(state)  # the step counter keeps advancing
                return
            bs = config.data.global_batch
            for name in ("loss", "acc1", "acc5"):
                meters[name].update(p[name], bs)
            now = time.perf_counter()
            t_step = (now - flush_anchor["wall"]) / max(p["gstep"] - flush_anchor["gstep"], 1)
            flush_anchor["wall"], flush_anchor["gstep"] = now, p["gstep"]
            meters["time"].update(t_step)
            meters["data"].update(p["data_ms"] / 1e3)
            progress.display(p["i"])
            if writer is None:
                return
            payload = {"epoch": p["epoch"], "lr": p["lr"], "loss": p["loss"], "acc1": p["acc1"],
                       "acc5": p["acc5"], "t_data": p["data_ms"] / 1e3, "t_step": t_step}
            payload.update({k: p[k] for k in ("t_transfer", "transfer_bytes",
                                              "prefetch_depth_live") if k in p})
            if guard["nan_steps"]:
                payload["nan_steps"] = guard["nan_steps"]
            decode_failures = getattr(pipe.dataset, "decode_failures", 0)
            if decode_failures:
                payload["decode_failures"] = decode_failures
            io_retries = retry.snapshot()
            if io_retries:
                payload["io_retries"] = io_retries
            writer.write(p["gstep"], payload)

        try:
            while len(history) < total:
                stop = min(steps_per_epoch, i + total - len(history))
                meters = {"time": AverageMeter("Time", ":6.3f"),
                          "data": AverageMeter("Data", ":6.3f"),
                          "loss": AverageMeter("Loss", ":.4e"),
                          "acc1": AverageMeter("Acc@1", ":6.2f"),
                          "acc5": AverageMeter("Acc@5", ":6.2f")}
                progress = ProgressMeter(steps_per_epoch, list(meters.values()),
                                         prefix=f"Epoch: [{epoch}]")
                it = pipe.epoch(epoch, device=config.device_prefetch,
                                depth=config.prefetch_depth, start=i, stop=stop)
                pending = None
                finished = stop == steps_per_epoch
                try:
                    for i in range(i, stop):
                        t0 = time.perf_counter()
                        batch = next(it, None)
                        if batch is None:  # the dataset holds fewer steps than the epoch
                            finished = True
                            break
                        _sync(device)
                        t1 = time.perf_counter()
                        metrics = step_fn(state, batch)
                        _sync(device)
                        t2 = time.perf_counter()
                        record = {
                            "step": state.step, "loss": float(metrics["loss"]),
                            "acc1": float(metrics["acc1"]), "acc5": float(metrics["acc5"]),
                            "lr": metrics["lr"], "data_ms": (t1 - t0) * 1e3,
                            "step_ms": (t2 - t1) * 1e3,
                            "imgs_per_s": config.data.global_batch / (t2 - t0),
                        }
                        stats = getattr(it, "stats_payload", None)
                        if stats is not None:
                            record.update(stats())
                        history.append(record)
                        if pending is not None:
                            flush(pending, meters, progress)
                            pending = None
                        last = len(history) == total
                        if i % config.log_every == 0 or i == steps_per_epoch - 1 or last:
                            record["loss"] = faults.corrupt_loss(record["loss"], state.step)
                            finite = math.isfinite(record["loss"])
                            if finite:  # the state as of this step, good unless proven not
                                snapshot.take(state)
                            pending = {**record, "i": i, "gstep": state.step, "epoch": epoch,
                                       "finite": finite}
                        if log is not None:
                            log(record)
                    if pending is not None:
                        flush(pending, meters, progress)
                finally:
                    it.close()
                if finished:
                    last_avg = {"epoch": epoch, **{k: meters[k].avg for k in ("loss", "acc1",
                                                                                "acc5")}}
                    last_epoch = epoch == config.optim.epochs - 1
                    if knn_pair is not None and (epoch % config.knn_every_epochs == 0
                                                 or last_epoch):
                        top1 = knn_eval(state.encoder_q.backbone, *knn_pair,
                                        num_classes=knn_classes,
                                        k=min(config.knn_k, len(knn_pair[0])),
                                        temperature=config.knn_temperature,
                                        image_size=config.data.image_size, device=device,
                                        compute_dtype=config.moco.compute_dtype)
                        print0(f"Epoch [{epoch}] kNN top-1: {top1:.2f}%")
                        last_avg["knn_top1"] = top1
                        if writer is not None:
                            writer.write(state.step, {"epoch": epoch, "knn_top1": top1})
                    if ckpt is not None and (last_epoch
                                             or epoch % config.checkpoint_every_epochs == 0):
                        ckpt.save(state.step, state_payload(state, config.moco.arch, epoch + 1),
                                  extra={"epoch": epoch, "config": config_to_dict(config)})
                epoch, i = epoch + 1, 0
        finally:
            if writer is not None:
                writer.close()
    return {"history": history, "state": state, "steps_per_epoch": steps_per_epoch,
            "last_avg": last_avg, "nan_steps": guard["nan_steps"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="imagenet_v2", choices=sorted(PRESETS))
    ap.add_argument("--data", default=None,
                    help="dataset name (synthetic, synthetic_learnable, cifar10, imagefolder, ...)")
    ap.add_argument("--data-dir", default=None, help="CIFAR-10 batches or an image folder")
    ap.add_argument("--cache-dir", default=None,
                    help="packed RGB cache of an image folder, built on first use")
    ap.add_argument("--workers", type=int, default=None, help="host loader threads")
    ap.add_argument("--no-device-prefetch", action="store_true",
                    help="make each batch serially before its step (no prefetch ring)")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    help="batches the prefetch ring keeps ready (default 2)")
    ap.add_argument("--steps", type=int, default=None, help="steps to run (default: all epochs)")
    ap.add_argument("--batch-size", "-b", type=int, default=None,
                    help="global batch (default: the preset's)")
    ap.add_argument("--vit-flash-attention", action="store_true",
                    help="ViT attention through the flash kernels")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints, metrics.jsonl and automatic resume (default: none)")
    ap.add_argument("--epochs", type=int, default=None, help="epochs (default: the preset's)")
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="steps per epoch (default: the dataset's size over the batch)")
    ap.add_argument("--knn-every-epochs", type=int, default=None,
                    help="kNN monitor every N epochs and at the last (default 0: off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = PRESETS[args.preset]
    data = {"dataset": args.data, "global_batch": args.batch_size, "data_dir": args.data_dir,
            "cache_dir": args.cache_dir, "num_workers": args.workers}
    data = {k: v for k, v in data.items() if v is not None}
    top = {"workdir": args.workdir, "steps_per_epoch": args.steps_per_epoch,
           "knn_every_epochs": args.knn_every_epochs, "prefetch_depth": args.prefetch_depth}
    top = {k: v for k, v in top.items() if v is not None}
    if args.no_device_prefetch:
        top["device_prefetch"] = False
    config = dataclasses.replace(config, data=dataclasses.replace(config.data, **data), **top)
    if args.epochs is not None:
        config = dataclasses.replace(config, optim=dataclasses.replace(config.optim,
                                                                       epochs=args.epochs))
    if args.vit_flash_attention:
        config = dataclasses.replace(
            config, moco=dataclasses.replace(config.moco, vit_flash_attention=True))
    train(config, device=args.device, steps=args.steps,
          log=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
