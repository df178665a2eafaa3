"""MoCo pretraining, v1/v2 or v3, on one device or data-parallel over the
processes of a torchrun launch, one per GPU, with or without ZeRO
(moco_tpu/train.py `train` / `_train_impl` without the elastic parts).

    python -m moco_tpu_torch.train --preset imagenet_v2 --data synthetic --steps 20
    python -m moco_tpu_torch.train --preset imagenet_v2 --data synthetic_learnable \\
        --workdir W --epochs 2 --steps-per-epoch 3 --knn-every-epochs 1
    python -m moco_tpu_torch.train --preset vit_b16_v3 --data synthetic --steps 20 \\
        --batch-size 256 --vit-flash-attention
    python -m moco_tpu_torch.train --preset imagenet_v2 --data synthetic --steps 20 \\
        --bn-virtual-groups 8                  # Shuffle-BN of 8 GPUs on one card
    python -m moco_tpu_torch.train --preset imagenet_v2_large_batch --data synthetic \\
        --steps 20 --batch-size 1024 --remat   # LARS, auto_scale to the batch
    python -m torch.distributed.run --nproc_per_node 8 -m moco_tpu_torch.train \\
        --preset imagenet_v2 --data imagefolder --data-dir /data/imagenet   # 8 GPUs

derives the live lr and EMA momentum from the config's `auto_scale`
(printing the line JAX's driver prints), builds the two-crop pipeline,
the encoder and, for v3, the predictor (a
seeded Flax-layout init carried in through `convert`, or a given state),
the optimizer and the train state; runs the steps, each epoch's batches
from the prefetch ring unless `--no-device-prefetch`; and prints one JSON
line per step: loss, acc1, acc5, lr, data milliseconds, imgs/s, the
ring's transfer stats, and step milliseconds on the probe's sampled steps.

The loop keeps steps in flight, as JAX's does (moco_tpu/train.py): it
records a CUDA event after each dispatched step and, once more than
`max(prefetch_depth, 1)` steps are in flight, waits on the oldest one's
event only. Each step's loss and accuracies are copied to pinned host
memory on the stream (non-blocking) before its event, and read once the
step has left the window; a log step copies every metric tensor so, in one
copy, and its deferred processing reads them after the next step has been
dispatched. The card is waited on only there, at the window's oldest
step, at an epoch's end, and on the steps the step-time probe samples
(`obs_probe_every`): before such a step (the steps in flight, then, once
its batch is in hand, the batch's device work, inside `data_wait`) and
after its dispatch (inside `device_wait`), so `t_device` and the record's
`step_ms` are the step's own. `obs_probe_every=1` waits around every step,
as a synchronous loop would.

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
is checked, as in JAX one step late (after the next step has been
dispatched, which the rollback then discards too). Each log step copies
the state (both encoders with their BN statistics, the queue and its
pointer, the predictor, the optimizer's buffers) into a staging snapshot
on the stream; its deferred processing promotes it to the good snapshot
once the loss reads finite. A non-finite one counts toward
`nan_guard_threshold`, writes a `nonfinite_loss` event, and restores the
good snapshot while the step counter keeps advancing; at the threshold the
run raises `FloatingPointError`.

Telemetry, as in JAX: with a workdir a span tracer (obs/trace.py) is
installed for the run: `epoch`, `data_wait`, `step` and `device_wait`
here, the pipeline's `host_decode` / `augment_dispatch`, the ring's
`transfer`, the checkpoint and kNN spans, streamed to
`trace_events.jsonl` and exported as `trace.json` (Perfetto) at the end;
the lines go through `build_sinks(config.sinks, ...)` (metrics.jsonl and
csv / tensorboard, and `/metrics` on `metrics_port`), each training line
with the probe's times, the device-memory gauges and the state's bytes
(`hbm_state_bytes`); `profile_dir` / `profile_steps` record a
torch.profiler trace of the run or of global steps [a, b).

Fault tolerance and health, as in the JAX driver:

- preemption: SIGTERM (how a preemptible node or a scheduler announces the
  end) or a first SIGINT sets a flag that the loop reads after each step;
  the run then writes a `preempt` event line, saves the live state (an
  emergency checkpoint: extras `epoch` = the last completed epoch,
  `emergency`, `reason`), waits until it is durable, and returns. A resume
  redoes the partial epoch. A second SIGINT raises KeyboardInterrupt. The
  handlers are installed on the main thread only, and the previous ones
  come back when `train` returns;
- the stall watchdog (`watchdog_timeout` > 0, utils/watchdog.py): no
  finished step for that long dumps every thread's stack to
  `stall_stacks.txt`, writes a `stall` line, saves the guard's snapshot
  (the last finite log step's state: a wedged card cannot be asked for the
  live one) from a sidecar thread joined for at most max(30 s, timeout),
  and exits with code 42;
- `checkpoint_async`: epoch-end saves return once the state is copied to
  host memory; every emergency save blocks until durable;
- the health gauges (`health_metrics`, obs/health.py) on every training
  line, fetched on log steps only, in one copy;
- the heartbeat file (obs/fleet.py), beaten at the start and on log steps;
- the alert engine (`alert_rules`, obs/alerts.py) over every training
  payload and `nonfinite_loss` event: one `alert` event line per fire;
  under `alerts_fatal`, an emergency checkpoint of the snapshot
  (`reason="alert"`), then `FatalAlertError`;
- the fault hooks `nan@step=N` (at the deferred read of the loss),
  `stall@step=N:seconds=S` and `preempt@step=N`, run at a log step's
  deferred processing;
- the analysis's runtime arms (analysis/), each installed before the
  first step or the run fails: `strict_tracing` puts the run's CUDA-graph
  captures on every line as `compile_cache_misses` and aborts with a
  `recompile_after_warmup` event line on a capture after
  `recompile_warmup_steps`; `sanitize_collectives` records every comms
  site's (site, kind, operand signature), publishes the schedule's hash
  (`schedule.p<rank>.json`, `collective_schedule_hash` on the lines)
  before each log step's agreement and checks every peer's after it,
  aborting with `schedule_diff.json` on a mismatch; `sanitize_threads`
  records the traced locks' acquisition order (a cycle aborts with
  `lock_order_diff.json`) and writes `lock_order.json` at the run's end.

Without a workdir nothing is written: no checkpoint, emergency or not, no
metrics, heartbeat, alerts.jsonl or trace; preemption still stops the run.

Data parallel (a torchrun launch with WORLD_SIZE > 1, or MOCO_MULTIHOST=1,
or a `world` passed in; parallel/mesh.py): each rank drives `cuda:<local
rank>` (NCCL; gloo with `--device cpu`), loads its B/n rows of each global
batch through its own ring, and runs the step of core/moco.py over the
data group. Rank 0 alone prints, writes metrics.jsonl, the sinks, the
alerts and trace.json, and saves checkpoints (a barrier follows each
save); every rank restores the same file, writes its own heartbeat
(`heartbeat.p<rank>.json`) and runs its own watchdog. Every line carries
the comms ledger's `comms/<site>` bytes (obs/comms.py) and rank 0's the
fleet aggregate (obs/fleet.py, `fleet_metrics`). A preemption signal is
agreed over the ranks at the log steps' deferred processing (each rank
stops at the same step), then rank 0 saves the live state and the ranks
meet at a barrier. kNN runs on every rank over the whole bank. `kill@host=i`
ends rank i with exit code 113 at its step; without `elastic` the survivors
leave with an error at their next collective (gloo), or when the group's
timeout (`ParallelConfig.timeout_s`) or the watchdog fires (NCCL).

Elastic training (`config.elastic`, `--elastic`; parallel/elastic.py), as
JAX's driver runs it on several processes: each log step asks the
heartbeat files for a newly stale rank, and so does a failed collective
(gloo) or the stall watchdog (NCCL), polling for up to
`heartbeat_timeout`, else the original error stands. A named rank commits
the rescale: this rank's process group is aborted (peers blocked on it
fail at once and run the same check), `plan_rescale` over the dead ranks,
the survivors' file consensus (`agree`), then the lowest surviving rank
saves the guard's snapshot (extras `reason: "rescale"` and the plan, epoch
= the last completed one: the relaunch redoes the epoch) and writes the
schema'd `rescale` line, fsynced; the other survivors wait until it is
durable, and every survivor exits with RESCALE_EXIT_CODE (75), printing
the relaunch's `--num-data`, `--batch-size` and `--auto-scale`. No process
group is re-formed in place. Under ZeRO the survivors cannot gather the
dead rank's shards: no emergency checkpoint is written, and the relaunch
resumes from the newest durable one. Without `auto_scale` an elastic run
is anchored at its own global batch; the relaunch resumes the emergency
checkpoint at the new width (whole tensors) and keeps that anchor, so lr
and momentum are the rule's at kappa = new / old batch. Under NCCL set
`timeout_s` above `watchdog_timeout + heartbeat_timeout`, so the
watchdog, not NCCL's own, wakes the survivors.

The model axis (`ParallelConfig.num_model`, parallel/mesh.py): a launch of
num_data x num_model ranks. The model ranks of a data rank load the same
rows; v1/v2 shards the queue over them, v3 with `vit_sequence_parallel`
the ViT's tokens (core/moco.py). Every save gathers a sharded queue on
every rank into the whole (K, dim) queue that rank 0 writes (the extras
carry `num_model`, which a resume must match, as JAX's); the snapshot's
emergency saves are skipped as under ZeRO. kNN runs dense on every rank.

ZeRO (`ParallelConfig.shard_weight_update`, parallel/zero.py) shards the
state over the ranks. At stage 2/3 with `zero_overlap_gather` the gather
of step k+1 is issued right after step k (`AsyncParamGather`, JAX's hoist);
the lines carry `overlap/zero` (and `overlap/zero_layer`) and
`hbm_model_peak_bytes`, and `hbm_state_bytes` counts the shards. The kNN
monitor runs on the gathered parameters. Every save gathers the shards on
every rank into whole tensors that rank 0 writes, so a checkpoint resumes
under any layout; the stall's and a fatal alert's emergency saves, which
one rank makes from the snapshot alone, are skipped under ZeRO (printed).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from moco_tpu_torch.analysis.runtime import CompileMonitor, RecompileError, RecompileGuard
from moco_tpu_torch.analysis.sanitizer import ScheduleDivergenceError, ScheduleSanitizer
from moco_tpu_torch.analysis.sanitizer import install_recorder as install_schedule_recorder
from moco_tpu_torch.analysis.tsan import LockOrderError, ThreadSanitizer
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
from moco_tpu_torch.obs.alerts import AlertEngine, FatalAlertError, parse_rules
from moco_tpu_torch.obs.fleet import FleetAggregator, Heartbeat
from moco_tpu_torch.obs.sinks import JsonlSink, build_sinks, flatten_tensors, unflatten_host
from moco_tpu_torch.obs.stepstats import StepTimeProbe, memory_payload, tree_shard_bytes
from moco_tpu_torch.obs.trace import Tracer, set_tracer
from moco_tpu_torch.obs.trace import span as obs_span
from moco_tpu_torch.parallel.dist import DataPartition, maybe_init_distributed
from moco_tpu_torch.parallel.elastic import (
    ElasticCoordinator,
    ElasticRescale,
    plan_rescale,
    surviving_ranks,
)
from moco_tpu_torch.parallel.mesh import World
from moco_tpu_torch.parallel.zero import AsyncParamGather
from moco_tpu_torch.utils import faults, retry
from moco_tpu_torch.utils.checkpoint import CheckpointManager, load_state_payload, state_payload
from moco_tpu_torch.utils.config import (
    PRESETS,
    ResumeCompatError,
    TrainConfig,
    apply_auto_scale,
    config_to_dict,
    elastic_reference,
    parse_auto_scale,
    resume_compat_diff,
    validate_elastic,
)
from moco_tpu_torch.utils.contracts import RESCALE_EXIT_CODE
from moco_tpu_torch.utils.device import resolve_device
from moco_tpu_torch.utils.metrics import (
    AverageMeter,
    ProfilerWindow,
    ProgressMeter,
    parse_profile_steps,
    print0,
    profiler_trace,
)
from moco_tpu_torch.utils.watchdog import StepWatchdog


def _record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event after the work issued so far on the current stream (None
    on the CPU, where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _wait(target, why: str) -> None:
    """The loop's one way to wait on the card: a step's event (`why`
    "window", "log", or "drain" at an epoch's end) or a device's current
    stream ("probe"); a no-op on the CPU. The prefetch ring's work on
    later batches keeps running on its own stream."""
    del why  # names the wait site for tests that count them
    if isinstance(target, torch.cuda.Event):
        target.synchronize()
    elif isinstance(target, torch.device) and target.type == "cuda":
        torch.cuda.current_stream(target).synchronize()


class _MetricsFetch:
    """A step's metric tensors on their way to the host: flattened into one
    buffer and copied on the current stream (non-blocking, into pinned
    memory, on a card), so that the step's event covers the copy. Read
    `values()` only once that event has been waited on."""

    def __init__(self, metrics: dict, keys: list):
        self.keys = keys
        flat, self.layout = flatten_tensors([metrics[k] for k in keys])
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
        else:
            self.host = flat

    def values(self) -> dict:
        return {k: float(v) if v.ndim == 0 else v.tolist()
                for k, v in zip(self.keys, unflatten_host(self.host, self.layout))}


def _seeded_state(config: TrainConfig, device, num_filters: int, world: World) -> TrainState:
    """A fresh state from seeded Flax-layout weights: the encoder, and for
    v3 the predictor (drawn from the next seed); the same on every rank."""
    params, stats = random_flax_encoder(config.moco, seed=config.seed, num_filters=num_filters)
    encoder = build_encoder(config.moco, num_filters=num_filters, world=world)
    encoder.load_state_dict(encoder_from_flax(params, stats))
    predictor = build_predictor(config.moco, world=world)
    if predictor is not None:
        predictor.load_state_dict(predictor_from_flax(
            *random_flax_predictor(config.moco, seed=config.seed + 1)))
    zero_n = world.num_data if config.parallel.shard_weight_update else None
    return create_state(config, encoder, device=device, predictor=predictor,
                        zero_num_data=zero_n, world=world)


class _Copy:
    """One buffer of a StateSnapshot: device copies of the state's tensors
    and optimizer buffers, the queue pointer and the step."""

    def __init__(self):
        self.saved: Optional[list] = None
        self.opt_keys: list = []
        self.opt_saved: list = []
        self.queue_ptr = 0
        self.step = 0


class StateSnapshot:
    """Copies of everything a rollback restores: the parameters and BN
    statistics of both encoders and the predictor, the queue and its
    pointer, and the optimizer's per-parameter state, in a pair of
    buffers. `take` copies the state into the staging buffer (one batched
    device copy on the stream; the buffers are allocated on first use and
    again only when the optimizer's state grows, as SGD's momentum buffers
    appear at its first step); `promote` makes the staging copy the good
    one; `restore` and `payload` read the good one. A snapshot starts with
    the state it is built from as its good copy. `state.step` is not
    restored: the step counter keeps advancing across a rollback. `step`
    is the good copy's step, and `payload` gives a checkpoint of it (the
    watchdog's and fatal alerts' emergency saves)."""

    def __init__(self, state: TrainState):
        self._good, self._staging = _Copy(), _Copy()
        self.take(state)
        self.promote()

    @property
    def step(self) -> int:
        return self._good.step

    @property
    def queue_ptr(self) -> int:
        return self._good.queue_ptr

    @staticmethod
    def _tensors(state: TrainState) -> list:
        """What a checkpoint holds of the modules (parameters and persistent
        buffers: not the ViT's position embedding, a function of the image
        size), and the queue. At ZeRO stage 2/3 the shards stand in for the
        modules' parameters (parallel/zero.py)."""
        modules = [m for m in (state.encoder_q, state.encoder_k, state.predictor) if m is not None]
        out = [t for m in modules for t in m.state_dict(keep_vars=True).values()]
        if state.zero is not None and state.zero.stage23:
            out = [t for t in out if not isinstance(t, torch.nn.Parameter)]
            out += state.zero.shard_tensors()
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
        c = self._staging
        live = self._tensors(state)
        if c.saved is None:
            c.saved = [torch.empty_like(t) for t in live]
        keys, opt = self._opt_state(state)
        if keys != c.opt_keys:
            c.opt_keys, c.opt_saved = keys, [torch.empty_like(t) for t in opt]
        torch._foreach_copy_(c.saved, live)
        if opt:
            torch._foreach_copy_(c.opt_saved, opt)
        c.queue_ptr = state.queue_ptr
        c.step = state.step

    def promote(self) -> None:
        self._good, self._staging = self._staging, self._good

    def payload(self, state: TrainState, arch: str, epoch: int) -> dict:
        """`state_payload`'s layout with the good copy in place of `state`'s
        live tensors; save it at `self.step`."""
        c = self._good
        it = iter(c.saved)
        sds = {side: None if m is None else {k: next(it) for k in m.state_dict(keep_vars=True)}
               for side, m in (("q", state.encoder_q), ("k", state.encoder_k),
                               ("predictor", state.predictor))}
        queue = next(it) if state.queue is not None else None
        by_param: dict = {}
        for (pid, k), t in zip(c.opt_keys, c.opt_saved):
            by_param.setdefault(pid, {})[k] = t
        opt = state.optimizer.state_dict()
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        opt["state"] = {i: by_param[id(p)] for i, p in enumerate(params) if id(p) in by_param}
        return state_payload(state, arch, epoch, tensors={
            **sds, "queue": queue, "queue_ptr": c.queue_ptr, "optimizer": opt})

    @torch.no_grad()
    def restore(self, state: TrainState) -> None:
        c = self._good
        torch._foreach_copy_(self._tensors(state), c.saved)
        saved = dict(zip(c.opt_keys, c.opt_saved))
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
        state.queue_ptr = c.queue_ptr


class _AnalysisArms:
    """The analysis's runtime arms a run asked for (module docstring):
    each is installed at construction, or the run fails; `close` restores
    the hooks and writes lock_order.json."""

    def __init__(self, config: TrainConfig, world: World):
        self.schedule: Optional[ScheduleSanitizer] = None
        self.threads: Optional[ThreadSanitizer] = None
        self.monitor: Optional[CompileMonitor] = None
        self.guard: Optional[RecompileGuard] = None
        self._prev_schedule = None
        if config.sanitize_collectives:
            if not config.workdir:
                raise ValueError("sanitize_collectives needs a workdir: every rank publishes "
                                 "its schedule there (schedule.p<rank>.json)")
            self.schedule = ScheduleSanitizer(config.workdir, process_index=world.rank,
                                              num_processes=world.world_size)
            self._prev_schedule = install_schedule_recorder(self.schedule.recorder)
        if config.sanitize_threads:
            # one lock_order.json per run: rank 0's (a cycle on another rank
            # still aborts it, with both stacks in the error)
            self.threads = ThreadSanitizer(workdir=config.workdir if world.is_main else None,
                                           strict=True, profile=True)
        if config.strict_tracing:
            self.monitor = CompileMonitor()
            self.guard = RecompileGuard(config.recompile_warmup_steps)

    def line_fields(self) -> dict:
        """The fields of a log step's line (and record)."""
        out = {}
        if self.monitor is not None:  # on every line: absence would read as 0
            out["compile_cache_misses"] = self.monitor.misses()
        if self.schedule is not None:
            out.update(self.schedule.recorder.payload())
        return out

    def publish(self, gstep: int) -> None:
        if self.schedule is not None:
            self.schedule.publish(gstep)

    def check(self, gstep: int, epoch: int, writer) -> None:
        """After the log step's agreement: the peers' schedules (every live
        rank published before it), then the recompile guard; each aborts
        with its line on disk first."""
        if self.schedule is not None:
            if writer is not None:
                writer.fsync()
            self.schedule.check(gstep)
        if self.guard is not None:
            misses = self.monitor.misses()
            diagnosis = self.guard.update(gstep, misses)
            if diagnosis is not None:
                if writer is not None:
                    writer.write(gstep, {"epoch": epoch, "event": "recompile_after_warmup",
                                         "compile_cache_misses": misses})
                    writer.fsync()
                raise RecompileError(diagnosis)

    def close(self) -> None:
        if self.schedule is not None:
            install_schedule_recorder(self._prev_schedule)
        if self.threads is not None:
            self.threads.close()  # restores the hooks, writes lock_order.json


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
          log: Optional[Callable[[dict], None]] = None, knn_datasets=None,
          profile_dir: Optional[str] = None, profile_steps: Optional[tuple] = None,
          world: Optional[World] = None) -> dict:
    """Run `steps` train steps (default: to the end of epoch
    config.optim.epochs - 1) from `state` (default: a fresh seeded one),
    or from the newest checkpoint under `config.workdir` when there is
    one; returns {"history": [per-step records], "state": the final state,
    "steps_per_epoch": n, "last_avg": the last epoch's means (and its
    knn_top1), "nan_steps": non-finite log steps, "preempted": whether a
    signal stopped the run, "config": the live config (lr and momentum
    derived by `auto_scale`)}.

    Each epoch's batches come from `pipe.epoch(e, device=config.device_prefetch,
    depth=config.prefetch_depth)`: the prefetch ring by default, made
    serially when device_prefetch is False. Each step's record holds loss,
    acc1, acc5, lr, data_ms (the wait for the batch), imgs_per_s (the
    batch over its loop iteration's wall time), the ring's transfer stats,
    on log steps the health gauges, and on the probe's sampled steps
    t_dispatch and t_device (seconds) and their sum as step_ms. It is
    filled once the step has left the in-flight window, and `log` is
    called with it then, in step order: with `obs_probe_every=1`, before
    the next step is dispatched.
    `knn_datasets` is the (bank, test) pair of the kNN monitor (default:
    built from config.data, train and held-out splits); `num_filters`
    narrows a fresh encoder for tests. `profile_dir` records a
    torch.profiler trace of the whole run, or of global steps
    `profile_steps = (a, b)` (into `profile_dir`, default
    `<workdir>/profile`).

    `world` (parallel/mesh.py) runs the steps data-parallel over its ranks
    on its device (a given `state` must be built with it); without one, a
    torchrun launch of several processes (`maybe_init_distributed`) makes
    the world, and destroys its process group when the run ends; else the
    run has one device, `device`. Rank 0 alone writes and profiles.

    Under `config.elastic` a lost rank ends the run with SystemExit(75) on
    every survivor once the rescale is committed (module docstring); the
    world is then aborted, and its `close()` does nothing."""
    validate_elastic(config)
    workdir = config.workdir
    if profile_steps is not None and not (profile_dir or workdir):
        raise ValueError("profile_steps needs a profile_dir or a workdir")
    own_world = None
    if world is None:
        world = own_world = maybe_init_distributed(device, config.parallel.timeout_s,
                                                   num_model=config.parallel.num_model)
    if world is None:
        world = World(device=resolve_device(device))
    tracer = (Tracer(os.path.join(workdir, "trace_events.jsonl"))
              if workdir and world.is_main else None)
    prev_tracer = set_tracer(tracer) if tracer is not None else None
    arms = None
    try:
        arms = _AnalysisArms(config, world)  # before the first collective
        # the reference config: lr and momentum at the auto_scale anchor
        return _train_impl(elastic_reference(config), dataset, world, steps, state,
                           num_filters, log, knn_datasets,
                           profile_dir if world.is_main else None,
                           profile_steps if world.is_main else None, arms)
    except ElasticRescale as r:
        # a process group cannot shrink in place: the launcher relaunches
        # the survivors at the planned width, which resumes the checkpoint
        print(f"rank {world.rank}: {r}; exiting {RESCALE_EXIT_CODE} for the launcher to "
              f"relaunch with {r.relaunch_flags()}", flush=True)
        world.abort()
        raise SystemExit(RESCALE_EXIT_CODE) from r
    finally:
        if arms is not None:
            arms.close()
        if own_world is not None:
            own_world.close()
        if tracer is not None:
            try:
                tracer.export_chrome(os.path.join(workdir, "trace.json"))
            except Exception as e:  # telemetry must never mask the real error
                print(f"WARNING: chrome trace export failed: {e!r}", flush=True)
            set_tracer(prev_tracer)
            tracer.close()


def _train_impl(config: TrainConfig, dataset, world: World, steps, state, num_filters, log,
                knn_datasets, profile_dir, profile_steps, arms: _AnalysisArms) -> dict:
    faults.install_from_env()
    device = world.device
    n = world.num_data
    if config.parallel.num_data not in (None, n):
        raise ValueError(f"parallel.num_data={config.parallel.num_data} but the launch has "
                         f"{n} rank(s): one process per GPU, every rank in the data group")
    if config.parallel.num_model != world.num_model:
        raise ValueError(f"parallel.num_model={config.parallel.num_model} but the launch's model "
                         f"axis has {world.num_model} rank(s): the launch needs num_data x "
                         "num_model ranks")
    world.ledger.reset()  # this run's sites only
    validate_elastic(config)
    if config.elastic and not config.workdir:
        raise ValueError("elastic=True needs a workdir: the heartbeats, the consensus files "
                         "and the emergency checkpoint live there")
    # `config` carries the reference lr and momentum; the live ones follow
    # from the global batch (utils/config.py `apply_auto_scale`); the
    # elastic rescale re-derives from the same reference
    ref_config = config
    config, auto_info = apply_auto_scale(config)
    if auto_info is not None:
        print0(f"auto-scale: global batch {config.data.global_batch} vs ref "
               f"{auto_info['ref_batch']} (kappa={auto_info['kappa']:g}) -> "
               f"lr {auto_info['lr']:g}, EMA momentum {auto_info['momentum']:g}")
    workdir = config.workdir
    partition = DataPartition.of(world, config.data.global_batch) if n > 1 else None
    with TwoCropPipeline(config.data, seed=config.seed, dataset=dataset, device=device,
                         partition=partition, ledger=world.ledger) as pipe:
        steps_per_epoch = config.steps_per_epoch or pipe.steps_per_epoch
        if steps_per_epoch <= 0:
            raise ValueError(f"steps_per_epoch must be > 0, got {steps_per_epoch}")
        if state is None:
            state = _seeded_state(config, device, num_filters, world)
        epoch, i = divmod(state.step, steps_per_epoch)
        ckpt = (CheckpointManager(workdir, keep=config.checkpoint_keep,
                                  async_save=config.checkpoint_async) if workdir else None)

        def check_compat(extra: dict) -> None:
            diffs = resume_compat_diff(extra, config, n)
            if diffs:
                raise ResumeCompatError(f"checkpoint under {workdir} is incompatible with "
                                        "the live config:\n  " + "\n  ".join(diffs))

        # automatic resume: rank 0 finds the newest good file (quarantining
        # torn ones), then every rank reads that one
        restored = None
        if ckpt is not None and world.is_main and ckpt.latest_step() is not None:
            restored = ckpt.restore(validate_extra=check_compat)
        if ckpt is not None and world.distributed:
            resume_step = world.broadcast_int(-1 if restored is None else restored[0]["step"])
            if not world.is_main and resume_step >= 0:
                restored = ckpt.restore(step=resume_step, validate_extra=check_compat)
        if restored is not None:
            payload, extra = restored
            load_state_payload(state, payload)
            epoch, i = int(extra.get("epoch", 0)) + 1, 0
            print0(f"resumed from epoch {epoch - 1} (step {state.step})")
            anchor = (extra.get("rescale") or {}).get("ref_batch")
            if (config.elastic and anchor is not None
                    and parse_auto_scale(ref_config.auto_scale) != int(anchor)):
                # a rescale's relaunch keeps the anchor of the run it rescales
                ref_config = dataclasses.replace(ref_config, auto_scale=f"ref_batch={anchor}")
                config, auto_info = apply_auto_scale(ref_config)
                print0(f"elastic resume: the rescaled run's anchor ref_batch={anchor} -> "
                       f"lr {auto_info['lr']:g}, EMA momentum {auto_info['momentum']:g}")
        step_fn = make_train_step(config, steps_per_epoch, device=device, world=world)
        zero = state.zero
        # a save gathers on every rank: ZeRO's shards, a sharded queue's rows
        gathered_save = zero is not None or state.queue_world is not None
        zero23 = zero is not None and zero.stage23
        gatherer: Optional[AsyncParamGather] = None
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
        # the sink fan-out (obs/sinks.py): metrics.jsonl always, plus
        # config.sinks; metrics_port > 0 serves Prometheus text on /metrics
        writer = (build_sinks(config.sinks, workdir, metrics_port=config.metrics_port,
                              metrics_host=config.metrics_host)
                  if workdir and total and world.is_main else None)
        if writer is not None and writer.prometheus is not None:
            print(f"metrics endpoint: http://{writer.prometheus.host}:"
                  f"{writer.prometheus.port}/metrics", flush=True)
        snapshot = StateSnapshot(state)
        guard = {"nan_steps": 0, "epoch": epoch}
        flush_anchor = {"wall": time.perf_counter(), "gstep": state.step}
        probe = StepTimeProbe(config.obs_probe_every)
        profile_window: Optional[ProfilerWindow] = None
        if profile_steps is not None:
            profile_window = ProfilerWindow(profile_dir or os.path.join(workdir, "profile"),
                                            *profile_steps)
            profile_dir = None  # the window replaces the whole-run trace
        history: list = []
        last_avg: dict = {}
        arch = config.moco.arch

        def save_extra(completed_epoch: int) -> dict:
            """A checkpoint's extras: the epoch, the config, and the layout
            it was saved from (the payload itself holds whole tensors)."""
            return {"epoch": completed_epoch, "num_data": n, "num_model": world.num_model,
                    "config": config_to_dict(config),
                    "shard_weight_update": config.parallel.shard_weight_update,
                    "zero_stage": config.parallel.zero_stage}

        def emergency_save(source, completed_epoch: int, reason: str,
                           extra_fields: Optional[dict] = None, writer_rank: int = 0) -> None:
            """Save first, die second: the preemption exit (`source` the
            live state), the watchdog's stall, a fatal alert and an elastic
            rescale (`source` the guard's snapshot). Skips a step that is
            already durable; always blocks until the write lands. Rank
            `writer_rank`'s alone (the state is the same on every rank; the
            rescale's is the lowest surviving rank), but under ZeRO every
            rank joins the gather of the shards (`state_payload`), and a
            save from the snapshot, which one rank makes alone, is skipped;
            so is a sharded queue's."""
            if gathered_save:
                if source is snapshot:
                    print0(f"{reason}: the state is sharded over the ranks (ZeRO or the queue) "
                           "and this save cannot gather it from one rank; no emergency "
                           "checkpoint", flush=True)
                    return
                if ckpt is None:
                    return
                durable = world.broadcast_int(int(world.is_main
                                                  and source.step in ckpt.all_steps()))
                if durable:
                    print0(f"{reason}: step {source.step} already durable, skipping emergency "
                           "save", flush=True)
                    return
                payload = state_payload(state, arch, completed_epoch + 1)
                if world.is_main:
                    ckpt.save(source.step, payload, extra={**save_extra(completed_epoch),
                                                           "emergency": True, "reason": reason,
                                                           **(extra_fields or {})}, force=True)
                    ckpt.wait()
                return
            if world.rank != writer_rank:
                return
            if ckpt is None:
                print0(f"{reason}: no workdir, no emergency checkpoint", flush=True)
                return
            if source.step in ckpt.all_steps():
                print(f"{reason}: step {source.step} already durable, skipping emergency save",
                      flush=True)
                return
            extra = {**save_extra(completed_epoch), "emergency": True, "reason": reason,
                     **(extra_fields or {})}
            if source is snapshot:
                payload = snapshot.payload(state, arch, completed_epoch + 1)
            else:
                payload = state_payload(state, arch, completed_epoch + 1)
            ckpt.save(source.step, payload, extra=extra, force=True)
            ckpt.wait()

        heartbeat = Heartbeat(workdir, process_index=world.rank) if workdir else None
        if heartbeat is not None:
            heartbeat.beat(step=state.step, epoch=epoch)
        engine = (AlertEngine(parse_rules(config.alert_rules,
                                          heartbeat_timeout=config.heartbeat_timeout),
                              workdir=workdir)
                  if config.alert_rules and config.alert_rules != "none" and world.is_main
                  else None)
        fleet = FleetAggregator(world) if config.fleet_metrics else None

        def handle_alerts(gstep: int, epoch: int, fired: list) -> None:
            """One `alert` event line per fire; under alerts_fatal, an
            emergency checkpoint of the snapshot, then FatalAlertError."""
            if not fired:
                return
            for a in fired:
                print0(f"ALERT [{a['severity']}] {a['rule']} @ step {gstep}: {a['message']}",
                       flush=True)
                if writer is not None:
                    writer.write(gstep, {"epoch": epoch, "event": "alert", "alert": a["rule"],
                                         "severity": a["severity"], f"alert/{a['rule']}": 1})
            if writer is not None:
                writer.fsync()
            if config.alerts_fatal:
                # under elastic a lost heartbeat is handled (the rescale the
                # same observation commits), not fatal
                fatal = [a for a in fired
                         if not (config.elastic and a.get("kind") == "heartbeat")]
                if not fatal:
                    return
                # the last finite state, mid-epoch: resume redoes the epoch
                emergency_save(snapshot, epoch - 1, "alert", {"alert": fatal[0]["rule"]})
                where = f"; see {engine.path}" if engine.path else ""
                raise FatalAlertError(f"aborting on fired alert(s) {[a['rule'] for a in fatal]} "
                                      f"at step {gstep} (alerts_fatal); emergency checkpoint "
                                      f"saved{where}")

        # -- elastic training (parallel/elastic.py) ---------------------------
        # the consensus waits out a survivor blocked in a collective on the
        # lost rank: under gloo up to the group's timeout
        elastic_coord = (ElasticCoordinator(
            workdir, process_index=world.rank, num_processes=world.world_size,
            timeout=config.heartbeat_timeout,
            barrier_timeout=max(60.0, config.parallel.timeout_s + config.heartbeat_timeout))
            if config.elastic else None)
        commit_lock = threading.Lock()  # the loop's and the watchdog's commits: one wins

        if elastic_coord is not None:  # stale only once the process is gone
            heartbeat.keep_fresh(max(min(config.heartbeat_timeout / 4, 5.0), 0.05),
                                 lambda: {"step": state.step, "epoch": guard["epoch"]})

        def elastic_rescale(gstep: int, epoch: int, dead_now: list) -> None:
            """The commit point (JAX's `elastic_rescale`): abort this rank's
            process group, plan over the dead ranks, agree with the
            survivors, the lowest surviving rank's emergency save of the
            snapshot and its `rescale` line; the others wait for that save;
            then ElasticRescale."""
            commit_lock.acquire()  # held until the process exits
            world.abort()  # no collective from here; a peer blocked on us fails now
            plan, _, info = plan_rescale(ref_config, n, world.num_model, sorted(dead_now), gstep,
                                         world_size=world.world_size)
            writer_rank = min(surviving_ranks(plan.dead_hosts, world.world_size))
            say = print if world.rank == writer_rank else (lambda *a, **k: None)
            say(f"elastic: ranks {sorted(dead_now)} lost heartbeat (> "
                f"{config.heartbeat_timeout:g}s stale) at step {gstep}; proposing mesh "
                f"{plan.old_num_data} -> {plan.new_num_data}", flush=True)
            plan = elastic_coord.agree(plan)
            rescale_extra = {**plan.consensus_key(), "step": plan.step}
            for k in ("kappa", "lr", "momentum", "ref_batch"):
                if k in info:
                    rescale_extra[k] = info[k]
            if world.rank == writer_rank:
                if zero is not None:
                    say("rescale: under ZeRO the survivors lack the lost ranks' shards and "
                        "cannot gather them; no emergency checkpoint: the relaunch resumes "
                        "from the newest durable checkpoint", flush=True)
                else:  # mid-epoch: the relaunch redoes this epoch
                    emergency_save(snapshot, epoch - 1, "rescale", {"rescale": rescale_extra},
                                   writer_rank=writer_rank)
                line = {"epoch": epoch, "event": "rescale",
                        "rescale/dead_hosts": list(plan.dead_hosts),
                        "rescale/old_num_data": plan.old_num_data,
                        "rescale/new_num_data": plan.new_num_data,
                        "rescale/old_global_batch": plan.old_global_batch,
                        "rescale/new_global_batch": plan.new_global_batch}
                for k in ("kappa", "lr", "momentum"):
                    if k in info:
                        line[f"rescale/{k}"] = float(info[k])
                sink = writer if writer is not None else JsonlSink(workdir)
                sink.write(gstep, line)
                sink.fsync()  # the rescale leaves its event on disk
                if sink is not writer:
                    sink.close()
                elastic_coord.mark_durable(plan)
            else:
                elastic_coord.wait_durable(plan, writer_rank)
            raise ElasticRescale(plan, info)

        def elastic_recover(err: BaseException) -> None:
            """A collective failed: abort, poll the heartbeats for up to the
            timeout; a stale rank commits the rescale, else `err` stands."""
            world.abort()
            dead = elastic_coord.wait_for_stale()
            if not dead:
                raise err
            print(f"rank {world.rank}: a collective failed ({type(err).__name__}); ranks "
                  f"{dead} are stale", flush=True)
            elastic_rescale(state.step, guard["epoch"], dead)

        # -- the in-flight window --------------------------------------
        # `waited["upto"]`: the newest step known finished on the card;
        # `inflight`: the dispatched steps whose records are not filled yet
        pipeline_depth = max(int(config.prefetch_depth), 1)
        waited = {"upto": state.step}
        inflight: deque = deque()

        def settle(entry: dict, why: str) -> None:
            """Wait until `entry`'s step (and every older one) has finished."""
            if entry["gstep"] > waited["upto"]:
                _wait(entry["event"], why)
                waited["upto"] = entry["gstep"]

        def harvest() -> None:
            """Fill the records of the finished steps from their host copies
            (a log step's loss as the guard sees it) and hand each to `log`,
            in step order."""
            while inflight and inflight[0]["gstep"] <= waited["upto"]:
                e = inflight.popleft()
                m = e["fetch"].values()
                if e["log_step"]:
                    m["loss"] = faults.corrupt_loss(m["loss"], e["gstep"])
                e["record"].update(m)
                if log is not None:
                    log(e["record"])

        def flush(p: dict, meters: dict, progress: ProgressMeter) -> None:
            """A log step's deferred processing, run after the next step's
            dispatch (or at the epoch's end): one read of its metrics, the
            fault hooks, the guard, then the metrics line, the heartbeat
            and the alert engine."""
            settle(p, "log")
            m = p["fetch"].values()
            gstep, record = p["gstep"], p["record"]
            m["loss"] = faults.corrupt_loss(m["loss"], gstep)
            faults.maybe_stall(gstep)
            faults.maybe_preempt(gstep)
            faults.maybe_kill_host(gstep, workdir, world.rank, world.world_size)
            if not math.isfinite(m["loss"]):
                guard["nan_steps"] += 1
                if writer is not None:
                    writer.write(gstep, {"epoch": p["epoch"], "event": "nonfinite_loss",
                                         "nan_steps": guard["nan_steps"]})
                    writer.fsync()
                if engine is not None:
                    handle_alerts(gstep, p["epoch"], engine.observe(
                        gstep, {"event": "nonfinite_loss", "nan_steps": guard["nan_steps"]}))
                print0(f"WARNING: non-finite loss at step {gstep} "
                       f"({guard['nan_steps']}/{config.nan_guard_threshold}): update skipped",
                       flush=True)
                if guard["nan_steps"] >= config.nan_guard_threshold:
                    raise FloatingPointError(
                        f"aborting: {guard['nan_steps']} non-finite loss steps (threshold "
                        f"{config.nan_guard_threshold}); last at step {gstep}, epoch "
                        f"{p['epoch']}, lr {record['lr']:.3e}")
                snapshot.restore(state)  # the step counter keeps advancing
                if gatherer is not None:  # the parked gather is of the dropped lineage
                    gatherer.resubmit(state, state.step)
                return
            snapshot.promote()  # this log step's state is good
            bs = config.data.global_batch
            for name in ("loss", "acc1", "acc5"):
                meters[name].update(m[name], bs)
            now = time.perf_counter()
            t_step = (now - flush_anchor["wall"]) / max(gstep - flush_anchor["gstep"], 1)
            flush_anchor["wall"], flush_anchor["gstep"] = now, gstep
            meters["time"].update(t_step)
            meters["data"].update(record["data_ms"] / 1e3)
            # re-pin the probe to THIS step's data wait: later iterations
            # overwrote it before this deferred flush ran
            probe.data_wait(record["data_ms"] / 1e3)
            probe.step_done(t_step)
            progress.display(p["i"])
            if heartbeat is not None:
                heartbeat.beat(step=gstep, epoch=p["epoch"])
            probe_fields = probe.payload()
            memory = memory_payload(device)
            decode_failures = getattr(pipe.dataset, "decode_failures", 0)
            io_retries = retry.snapshot()
            fleet_fields = {}
            if fleet is not None:  # a collective: every rank, every log step
                stats = fleet.gather(fleet.host_vector(
                    t_data=probe_fields.get("t_data"), t_step=probe_fields.get("t_step"),
                    t_transfer=record.get("t_transfer"), dispatch_lag=probe.last_dispatch,
                    io_retries=float(sum(io_retries.values())) if io_retries else 0.0,
                    decode_failures=float(decode_failures),
                    hbm_live=memory.get("hbm_live_bytes")))
                fleet_fields = fleet.payload(stats)
            record.update(arms.line_fields())
            if writer is not None or engine is not None:
                emit(p, m, record, probe_fields, memory, decode_failures, io_retries,
                     fleet_fields)
            if elastic_coord is not None:
                # off the hot path: file reads on log steps; a newly stale
                # rank commits the rescale
                dead_now = elastic_coord.stale_hosts()
                if dead_now:
                    elastic_rescale(gstep, p["epoch"], dead_now)

        def emit(p, m, record, probe_fields, memory, decode_failures, io_retries,
                 fleet_fields) -> None:
            """A log step's metrics line (rank 0) and the alert engine."""
            gstep = p["gstep"]
            resident = StateSnapshot._tensors(state) + StateSnapshot._opt_state(state)[1]
            if zero is not None and not zero23:  # stage 1's shards, the optimizer's
                resident += zero.q_shards
            payload = {"epoch": p["epoch"], "lr": record["lr"], **m, **probe_fields, **memory,
                       "hbm_state_bytes": tree_shard_bytes(resident)}
            if gatherer is not None:
                payload.update(gatherer.payload())
                if zero.layer:
                    payload["overlap/zero_layer"] = gatherer.last_overlap
            if zero23:
                payload["hbm_model_peak_bytes"] = zero.hbm_model_peak_bytes
            payload.update({k: record[k] for k in ("t_transfer", "transfer_bytes",
                                                   "prefetch_depth_live", "compile_cache_misses",
                                                   "collective_schedule_hash") if k in record})
            if guard["nan_steps"]:
                payload["nan_steps"] = guard["nan_steps"]
            if decode_failures:
                payload["decode_failures"] = decode_failures
            if io_retries:
                payload["io_retries"] = io_retries
            payload.update(world.ledger.payload())
            payload.update(fleet_fields)
            if writer is not None:
                writer.write(gstep, payload)
            if engine is not None:
                handle_alerts(gstep, p["epoch"], engine.observe(gstep, payload))

        # graceful preemption: the flag is read after each step, or across
        # ranks at each log step's deferred processing (`agreed`)
        preempted = {"count": 0, "agreed": False}

        def stop_requested() -> bool:
            return preempted["agreed"] if world.distributed else preempted["count"] > 0

        def flush_and_agree(p: dict, meters: dict, progress: ProgressMeter) -> None:
            """`flush`, then (data parallel) whether any rank was signalled:
            every rank flushes the same log steps, so they agree there. The
            schedule is published before that agreement and the peers'
            checked after it, so every live rank's file is in place."""
            flush(p, meters, progress)
            arms.publish(p["gstep"])
            if world.distributed:
                preempted["agreed"] = world.any(preempted["count"] > 0)
            arms.check(p["gstep"], p["epoch"], writer)

        def on_signal(signum, frame):
            preempted["count"] += 1
            if signum == signal.SIGINT and preempted["count"] > 1:
                raise KeyboardInterrupt
            print0(f"signal {signum}: checkpointing at the next step, then exiting", flush=True)

        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():  # signals reach it alone
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, on_signal)

        wd: Optional[StepWatchdog] = None
        if config.watchdog_timeout > 0:

            def on_stall() -> None:
                # bounded: the main thread is stuck in a device call and the
                # save may hang on a wedged context, so it runs in a sidecar
                # thread and the exit comes after the budget regardless
                if elastic_coord is not None:  # an NCCL collective with a lost peer blocks
                    elastic_stall()
                try:
                    if writer is not None:
                        writer.write(0, {"event": "stall", "epoch": guard["epoch"],
                                         "watchdog_timeout": config.watchdog_timeout})
                        writer.fsync()
                except Exception:
                    pass

                def save() -> None:
                    try:  # mid-epoch: resume redoes the epoch from its start
                        emergency_save(snapshot, guard["epoch"] - 1, "stall")
                        print("watchdog: emergency checkpoint saved", flush=True)
                    except Exception as e:
                        print(f"watchdog: emergency checkpoint failed: {e!r}", flush=True)

                t = threading.Thread(target=save, name="moco-stall-save", daemon=True)
                t.start()
                t.join(timeout=max(30.0, config.watchdog_timeout))

            def elastic_stall() -> None:
                """The stall under elastic: the heartbeats polled for up to
                the timeout; a stale rank commits the rescale from this
                thread (bounded as the stall's save) and the process exits
                with RESCALE_EXIT_CODE; else the stall's own path goes on."""
                done: dict = {}

                def commit() -> None:
                    try:
                        dead = elastic_coord.wait_for_stale()
                        if dead:
                            elastic_rescale(state.step, guard["epoch"], dead)
                    except ElasticRescale as r:
                        done["rescale"] = r
                    except Exception as e:
                        print(f"watchdog: elastic check failed: {e!r}", flush=True)

                t = threading.Thread(target=commit, name="moco-stall-rescale", daemon=True)
                t.start()
                t.join(timeout=config.heartbeat_timeout + max(30.0, config.watchdog_timeout))
                r = done.get("rescale")
                if r is not None:
                    print(f"rank {world.rank}: {r}; exiting {RESCALE_EXIT_CODE} for the "
                          f"launcher to relaunch with {r.relaunch_flags()}", flush=True)
                    os._exit(RESCALE_EXIT_CODE)  # the main thread is wedged in a collective

            stacks = "stall_stacks.txt" if world.is_main else f"stall_stacks.p{world.rank}.txt"
            wd = StepWatchdog(config.watchdog_timeout, on_stall=on_stall,
                              dump_path=os.path.join(workdir, stacks)
                              if workdir else None).start()

        stop_now = False
        try:
            # ZeRO stage 2/3: step k+1's gather is issued right after step k
            # (parallel/zero.py AsyncParamGather); the overlap/zero gauge reads it
            if zero23 and config.parallel.zero_overlap_gather:
                gatherer = AsyncParamGather(step_fn.gather)
                gatherer.submit(state, state.step)
            with profiler_trace(profile_dir):
                while len(history) < total:
                    stop = min(steps_per_epoch, i + total - len(history))
                    meters = {"time": AverageMeter("Time", ":6.3f"),
                              "data": AverageMeter("Data", ":6.3f"),
                              "loss": AverageMeter("Loss", ":.4e"),
                              "acc1": AverageMeter("Acc@1", ":6.2f"),
                              "acc5": AverageMeter("Acc@5", ":6.2f")}
                    progress = ProgressMeter(steps_per_epoch, list(meters.values()),
                                             prefix=f"Epoch: [{epoch}]")
                    guard["epoch"] = epoch
                    finished = stop == steps_per_epoch
                    with obs_span("epoch", epoch=epoch):
                        it = pipe.epoch(epoch, device=config.device_prefetch,
                                        depth=config.prefetch_depth, start=i, stop=stop)
                        pending = None
                        try:
                            for i in range(i, stop):
                                gstep = state.step
                                if profile_window is not None:
                                    profile_window.on_step(gstep)
                                sampled = probe.should_sample(gstep)
                                if sampled:  # the steps in flight finish first
                                    with obs_span("device_wait", step=gstep):
                                        _wait(device, "probe")
                                    waited["upto"] = gstep
                                t0 = time.perf_counter()
                                with obs_span("data_wait", step=gstep):
                                    batch = next(it, None)
                                    if sampled and batch is not None:
                                        # and the batch's device work, so
                                        # the wait after the dispatch is
                                        # the step's own
                                        _wait(device, "probe")
                                if batch is None:  # the dataset holds fewer steps
                                    finished = True
                                    break
                                t_data = time.perf_counter() - t0
                                probe.data_wait(t_data)
                                log_step = (i % config.log_every == 0
                                            or i == steps_per_epoch - 1
                                            or len(history) + 1 == total)
                                t_disp0 = time.perf_counter()
                                with obs_span("step", step=gstep):
                                    if gatherer is not None:
                                        # issued one iteration ago, under the
                                        # previous step
                                        metrics = step_fn.step(state, batch, gatherer.take())
                                        gatherer.submit(state, state.step)
                                    else:
                                        metrics = step_fn(state, batch)
                                    keys = ([k for k, v in metrics.items() if torch.is_tensor(v)]
                                            if log_step else ["loss", "acc1", "acc5"])
                                    fetch = _MetricsFetch(metrics, keys)
                                    event = _record_event(device)
                                t_dispatch = time.perf_counter() - t_disp0
                                probe.dispatched(t_dispatch)
                                record = {"step": state.step, "lr": metrics["lr"],
                                          "data_ms": t_data * 1e3}
                                if sampled:
                                    with obs_span("device_wait", step=gstep):
                                        t_dev0 = time.perf_counter()
                                        _wait(device, "probe")
                                        t_device = time.perf_counter() - t_dev0
                                    waited["upto"] = state.step
                                    probe.device_block(t_device)
                                    record.update(step_ms=(t_dispatch + t_device) * 1e3,
                                                  t_dispatch=t_dispatch, t_device=t_device)
                                stats = getattr(it, "stats_payload", None)
                                if stats is not None:
                                    record.update(stats())
                                entry = {"gstep": state.step, "i": i, "epoch": epoch,
                                         "record": record, "fetch": fetch, "event": event,
                                         "log_step": log_step}
                                history.append(record)
                                inflight.append(entry)
                                # the window: wait on the oldest step only
                                if state.step - waited["upto"] > pipeline_depth:
                                    settle(inflight[-1 - pipeline_depth], "window")
                                if wd is not None:
                                    wd.beat()
                                if pending is not None:
                                    flush_and_agree(pending, meters, progress)
                                    pending = None
                                if log_step:
                                    # the state as of this step, on the
                                    # stream: good once its loss reads finite
                                    snapshot.take(state)
                                record["imgs_per_s"] = (config.data.global_batch
                                                        / (time.perf_counter() - t0))
                                harvest()
                                if stop_requested():  # this step's line is not written
                                    stop_now = True
                                    break
                                if log_step:
                                    pending = entry
                            if pending is not None and not stop_now:
                                flush_and_agree(pending, meters, progress)
                                pending = None
                        finally:
                            it.close()
                        # the epoch's last records: their steps have finished
                        # (or are about to: the epoch's end waits on them)
                        if inflight:
                            settle(inflight[-1], "drain")
                            harvest()
                        if finished or stop_now:
                            last_avg = {"epoch": epoch,
                                        **{k: meters[k].avg for k in ("loss", "acc1", "acc5")}}
                        if stop_now:
                            # mid-epoch: the previous epoch is the last completed one,
                            # so a resume redoes this one from its start
                            if writer is not None:
                                writer.write(state.step, {"epoch": epoch, "event": "preempt"})
                            emergency_save(state, epoch - 1, "preempt")
                            world.barrier()  # the save is durable before any rank leaves
                            if writer is not None:
                                writer.fsync()
                            print0(f"preempted mid-epoch {epoch}: state saved at step "
                                   f"{state.step}; resume will redo epoch {epoch}", flush=True)
                            break
                        if finished:
                            last_epoch = epoch == config.optim.epochs - 1
                            if knn_pair is not None and (epoch % config.knn_every_epochs == 0
                                                         or last_epoch):
                                if zero23:  # the gathered parameters (every rank)
                                    zero.gather_into("q")
                                top1 = knn_eval(state.encoder_q.backbone, *knn_pair,
                                                num_classes=knn_classes,
                                                k=min(config.knn_k, len(knn_pair[0])),
                                                temperature=config.knn_temperature,
                                                image_size=config.data.image_size, device=device,
                                                compute_dtype=config.moco.compute_dtype)
                                if zero23 and (gatherer is None or zero.layer):
                                    zero.release("q")
                                print0(f"Epoch [{epoch}] kNN top-1: {top1:.2f}%")
                                last_avg["knn_top1"] = top1
                                if writer is not None:
                                    writer.write(state.step, {"epoch": epoch, "knn_top1": top1})
                            if ckpt is not None and (last_epoch
                                                     or epoch % config.checkpoint_every_epochs == 0):
                                # under ZeRO or a sharded queue every rank
                                # joins the payload's gather
                                payload = (state_payload(state, arch, epoch + 1)
                                           if world.is_main or gathered_save else None)
                                if world.is_main:
                                    ckpt.save(state.step, payload, extra=save_extra(epoch))
                                world.barrier()
                    epoch, i = epoch + 1, 0
        except (ElasticRescale, FatalAlertError, ScheduleDivergenceError, LockOrderError,
                RecompileError):
            raise
        except RuntimeError as e:  # gloo raises once a peer's socket closes
            if elastic_coord is None:
                raise
            elastic_recover(e)
        finally:
            if gatherer is not None:
                gatherer.close()  # the parked gather is dropped
            if zero23:  # at rest: the shards alone
                zero.release("q")
                zero.release("k")
            if profile_window is not None:
                profile_window.close()  # stop a still-open capture window
            if wd is not None:
                wd.stop()
            if heartbeat is not None:
                heartbeat.stop()
            if engine is not None:
                engine.close()
            if writer is not None:
                writer.close()
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            if ckpt is not None:
                ckpt.close()  # an async write lands, or its error is raised
    return {"history": history, "state": state, "steps_per_epoch": steps_per_epoch,
            "last_avg": last_avg, "nan_steps": guard["nan_steps"], "preempted": stop_now,
            "config": config}


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
    ap.add_argument("--shuffle", choices=("gather_perm", "a2a", "syncbn", "none"), default=None,
                    help="BN decorrelation (the reference's Shuffle-BN is gather_perm); on one "
                         "device it permutes the keys with --bn-virtual-groups only")
    ap.add_argument("--syncbn-group-size", type=int, default=None,
                    help="with --shuffle syncbn: BN statistics over groups of this many "
                         "consecutive ranks (default 0: the whole data group)")
    ap.add_argument("--bn-stats-rows", type=int, default=None,
                    help="BN training statistics from the first N rows (0 = the whole batch)")
    ap.add_argument("--bn-stats-barrier", action="store_true", default=None,
                    help="with --bn-stats-rows: JAX's TPU fusion barrier; no effect here")
    ap.add_argument("--bn-momentum-stats", action="store_true", default=None,
                    help="momentum-statistics BN: normalize with, and store, "
                         "m * running + (1 - m) * batch")
    ap.add_argument("--bn-virtual-groups", type=int, default=None,
                    help="virtual Shuffle-BN: per-group BN statistics over G row-groups and "
                         "the key batch permuted, the reference's G-GPU recipe on one card")
    ap.add_argument("--key-bn-eval", dest="key_bn_running_stats", action="store_true",
                    default=None,
                    help="EMAN key forward: eval-mode key BN whose statistics trail the "
                         "query encoder's (needs --shuffle none or syncbn); experimental")
    ap.add_argument("--no-key-bn-stats-warmup", dest="key_bn_stats_warmup",
                    action="store_false", default=None,
                    help="without the (1+s)/(10+s) cap on the key statistics' momentum")
    ap.add_argument("--remat", action="store_true", default=None,
                    help="recompute the query forward in the backward (less memory)")
    ap.add_argument("--optimizer", choices=("sgd", "lars", "adamw"), default=None)
    ap.add_argument("--auto-scale", default=None, metavar="ref_batch=N",
                    help="lr and momentum are the values at global batch N; the live ones "
                         "follow from the batch (kappa = batch / N: lr x kappa, m ** kappa)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoints, metrics.jsonl and automatic resume (default: none)")
    ap.add_argument("--epochs", type=int, default=None, help="epochs (default: the preset's)")
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="steps per epoch (default: the dataset's size over the batch)")
    ap.add_argument("--knn-every-epochs", type=int, default=None,
                    help="kNN monitor every N epochs and at the last (default 0: off)")
    ap.add_argument("--checkpoint-async", action="store_true", default=None,
                    help="overlap checkpoint writes with training; the emergency saves "
                         "still block until durable")
    ap.add_argument("--watchdog-timeout", type=float, default=None,
                    help="seconds without a finished step before the stall watchdog dumps "
                         "every thread's stack, saves the last finite log step's state and "
                         "exits with code 42 (0 = off; the first step gets 900 s)")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="seconds after which another process's heartbeat counts as stale "
                         "(the heartbeat_loss alert and the elastic trigger; default 120)")
    ap.add_argument("--elastic", action="store_true", default=None,
                    help="on a lost rank the survivors agree, the lowest saves the last "
                         "finite state, and each exits 75 printing the relaunch's "
                         "--num-data, --batch-size and --auto-scale")
    ap.add_argument("--alert-rules", default=None,
                    help="in-stream alert rules (obs/alerts.py grammar): 'default' = the "
                         "built-ins, 'default,<spec>' extends them, 'none' turns them off")
    ap.add_argument("--alerts-fatal", action="store_true", default=None,
                    help="abort on any fired alert, after an emergency checkpoint")
    ap.add_argument("--no-health-metrics", dest="health_metrics", action="store_false",
                    default=None,
                    help="no health gauges in the step (EMA drift, logit statistics, "
                         "collapse, queue age)")
    ap.add_argument("--sinks", default=None,
                    help="comma list of metric sinks (jsonl,csv,tensorboard); the JSONL "
                         "sink is always included")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text format on this port's /metrics (0 = off)")
    ap.add_argument("--metrics-host", default=None,
                    help="bind address of the /metrics endpoint (default 127.0.0.1)")
    ap.add_argument("--obs-probe-every", type=int, default=None,
                    help="every N steps wait on the card around the step to split host "
                         "dispatch from device time (default 50; 0 = never)")
    ap.add_argument("--strict-tracing", action="store_true", default=None,
                    help="compile_cache_misses (the run's CUDA-graph captures) on every "
                         "line; abort on a capture after --recompile-warmup-steps")
    ap.add_argument("--recompile-warmup-steps", type=int, default=None,
                    help="steps during which captures are free under --strict-tracing "
                         "(default 8)")
    ap.add_argument("--sanitize-collectives", action="store_true", default=None,
                    help="record every rank's collective schedule, cross-check the hashes "
                         "on log steps and abort with schedule_diff.json on a mismatch "
                         "(needs --workdir)")
    ap.add_argument("--sanitize-threads", action="store_true", default=None,
                    help="record the traced locks' acquisition order: a cycle aborts with "
                         "lock_order_diff.json; lock_order.json at the end")
    ap.add_argument("--profile-dir", default=None, help="torch.profiler trace output dir")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="profile exactly global steps [A, B) (into --profile-dir or "
                         "workdir/profile) instead of the whole run")
    ap.add_argument("--num-data", type=int, default=None,
                    help="data ranks of the launch (default: every rank over --num-model)")
    ap.add_argument("--dist-timeout", type=float, default=None,
                    help="seconds a collective waits for its peers before the process "
                         "group fails the rank (default 600)")
    ap.add_argument("--zero-stage", type=int, default=None, choices=(1, 2, 3),
                    help="ZeRO over the data ranks: 1 shards the optimizer state and update, "
                         "2 and 3 the parameters between steps too (sgd and adamw only)")
    ap.add_argument("--zero-layer-granular", action="store_true", default=None,
                    help="with --zero-stage 2 or 3 (or the zero3 preset): gather one layer "
                         "group at a time")
    ap.add_argument("--num-model", type=int, default=None,
                    help="model ranks per data rank (the launch has num_data x num_model): "
                         "v1/v2 shard the queue over them, v3 with --vit-sequence-parallel "
                         "the ViT's tokens")
    ap.add_argument("--vit-sequence-parallel", action="store_true", default=None,
                    help="shard the ViT's tokens over the model ranks, ring attention "
                         "across them (v3, gap pooling)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (each rank of a torchrun launch takes cuda:<local rank>, "
                         "NCCL) or cpu (gloo)")
    args = ap.parse_args(argv)
    config = PRESETS[args.preset]
    data = {"dataset": args.data, "global_batch": args.batch_size, "data_dir": args.data_dir,
            "cache_dir": args.cache_dir, "num_workers": args.workers}
    data = {k: v for k, v in data.items() if v is not None}
    top = {"workdir": args.workdir, "steps_per_epoch": args.steps_per_epoch,
           "knn_every_epochs": args.knn_every_epochs, "prefetch_depth": args.prefetch_depth,
           "checkpoint_async": args.checkpoint_async, "watchdog_timeout": args.watchdog_timeout,
           "heartbeat_timeout": args.heartbeat_timeout, "alert_rules": args.alert_rules,
           "alerts_fatal": args.alerts_fatal, "health_metrics": args.health_metrics,
           "auto_scale": args.auto_scale, "sinks": args.sinks, "elastic": args.elastic,
           "metrics_port": args.metrics_port, "metrics_host": args.metrics_host,
           "obs_probe_every": args.obs_probe_every, "strict_tracing": args.strict_tracing,
           "recompile_warmup_steps": args.recompile_warmup_steps,
           "sanitize_collectives": args.sanitize_collectives,
           "sanitize_threads": args.sanitize_threads}
    top = {k: v for k, v in top.items() if v is not None}
    if args.no_device_prefetch:
        top["device_prefetch"] = False
    config = dataclasses.replace(config, data=dataclasses.replace(config.data, **data), **top)
    optim = {"epochs": args.epochs, "optimizer": args.optimizer}
    optim = {k: v for k, v in optim.items() if v is not None}
    par = {"timeout_s": args.dist_timeout, "zero_layer_granular": args.zero_layer_granular,
           "num_model": args.num_model, "num_data": args.num_data}
    if args.zero_stage is not None:
        par.update(shard_weight_update=True, zero_stage=args.zero_stage)
    config = dataclasses.replace(config, parallel=dataclasses.replace(
        config.parallel, **{k: v for k, v in par.items() if v is not None}))
    moco = {"vit_flash_attention": args.vit_flash_attention or None, "shuffle": args.shuffle,
            "syncbn_group_size": args.syncbn_group_size,
            "bn_stats_rows": args.bn_stats_rows, "bn_stats_barrier": args.bn_stats_barrier,
            "bn_momentum_stats": args.bn_momentum_stats,
            "bn_virtual_groups": args.bn_virtual_groups,
            "key_bn_running_stats": args.key_bn_running_stats,
            "key_bn_stats_warmup": args.key_bn_stats_warmup, "remat": args.remat,
            "vit_sequence_parallel": args.vit_sequence_parallel}
    moco = {k: v for k, v in moco.items() if v is not None}
    config = dataclasses.replace(config, optim=dataclasses.replace(config.optim, **optim),
                                 moco=dataclasses.replace(config.moco, **moco))
    profile = {"profile_dir": args.profile_dir,
               "profile_steps": (parse_profile_steps(args.profile_steps)
                                 if args.profile_steps else None)}
    rank0 = int(os.environ.get("RANK", "0")) == 0  # torchrun's; the lines are rank 0's
    train(config, device=args.device, steps=args.steps,
          log=(lambda r: print(json.dumps(r), flush=True)) if rank0 else None,
          **{k: v for k, v in profile.items() if v is not None})
    return 0


if __name__ == "__main__":
    sys.exit(main())
