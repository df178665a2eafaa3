"""MoCo pretraining on one device, v1/v2 or v3 (the core of
moco_tpu/train.py `train` / `_train_impl`).

    python -m moco_tpu_torch.train --preset imagenet_v2 --data synthetic --steps 20
    python -m moco_tpu_torch.train --preset vit_b16_v3 --data synthetic --steps 20 \
        --batch-size 256 --vit-flash-attention

builds the two-crop pipeline, the encoder and, for v3, the predictor (a
seeded Flax-layout init carried in through `convert`, or a given state),
the optimizer and the train state; runs the steps, each epoch's batches
from the prefetch ring unless `--no-device-prefetch`; and prints one JSON
line per step: loss, acc1, acc5, lr, data and step milliseconds, imgs/s
and the ring's transfer stats.
Checkpoints, the kNN monitor, the linear probe, elastic training and
alerts come with later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Callable, Optional

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
from moco_tpu_torch.data.pipeline import TwoCropPipeline
from moco_tpu_torch.utils.config import PRESETS, TrainConfig
from moco_tpu_torch.utils.device import resolve_device


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


def train(config: TrainConfig, dataset=None, device="cuda", steps: Optional[int] = None,
          state: Optional[TrainState] = None, num_filters: int = 64,
          log: Optional[Callable[[dict], None]] = None) -> dict:
    """Run `steps` train steps (default: config.optim.epochs epochs) from
    `state` (default: a fresh seeded one) and return
    {"history": [per-step metrics], "state": the final state,
    "steps_per_epoch": n}. Each epoch's batches come from
    `pipe.epoch(e, device=config.device_prefetch, depth=config.prefetch_depth)`:
    the prefetch ring by default, made serially when device_prefetch is
    False. Each step's record holds loss, acc1, acc5, lr, data_ms (the
    wait for the batch: its whole making in sync mode, the wait on the ring
    otherwise), step_ms, imgs_per_s and the ring's transfer stats; `log` is
    called with each record. Host times end in a synchronize of the
    current stream, so they are the step's own; `num_filters` narrows a
    fresh encoder for tests."""
    device = resolve_device(device)
    with TwoCropPipeline(config.data, seed=config.seed, dataset=dataset, device=device) as pipe:
        steps_per_epoch = config.steps_per_epoch or pipe.steps_per_epoch
        if steps_per_epoch <= 0:
            raise ValueError(f"steps_per_epoch must be > 0, got {steps_per_epoch}")
        if state is None:
            state = _seeded_state(config, device, num_filters)
        step_fn = make_train_step(config, steps_per_epoch, device=device)
        total = steps if steps is not None else config.optim.epochs * steps_per_epoch
        history = []
        epoch, i = divmod(state.step, steps_per_epoch)
        while len(history) < total:
            stop = min(steps_per_epoch, i + total - len(history))
            it = pipe.epoch(epoch, device=config.device_prefetch, depth=config.prefetch_depth,
                            start=i, stop=stop)
            try:
                for _ in range(i, stop):
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    if batch is None:  # the dataset holds fewer steps than the epoch
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
                    if not math.isfinite(record["loss"]):
                        raise FloatingPointError(f"non-finite loss at step {state.step}: {record}")
                    history.append(record)
                    if log is not None:
                        log(record)
            finally:
                it.close()
            epoch, i = epoch + 1, 0
    return {"history": history, "state": state, "steps_per_epoch": steps_per_epoch}


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = PRESETS[args.preset]
    data = {"dataset": args.data, "global_batch": args.batch_size, "data_dir": args.data_dir,
            "cache_dir": args.cache_dir, "num_workers": args.workers}
    data = {k: v for k, v in data.items() if v is not None}
    config = dataclasses.replace(config, data=dataclasses.replace(config.data, **data))
    if args.no_device_prefetch:
        config = dataclasses.replace(config, device_prefetch=False)
    if args.prefetch_depth is not None:
        config = dataclasses.replace(config, prefetch_depth=args.prefetch_depth)
    if args.vit_flash_attention:
        config = dataclasses.replace(
            config, moco=dataclasses.replace(config.moco, vit_flash_attention=True))
    train(config, device=args.device, steps=args.steps,
          log=lambda r: print(json.dumps(r), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
