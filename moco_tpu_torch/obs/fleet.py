"""The fleet aggregate and out-of-band heartbeats (moco_tpu/obs/fleet.py).

- `FleetAggregator`: on log steps every rank contributes a small
  fixed-width stats vector (`FLEET_FIELDS`: data wait, step wall, wire
  transfer time, dispatch lag, io retries, decode failures, live device
  memory) through one all_gather of the (F,) vector over the whole world;
  `reduce_stats` gives per-field min / mean / max / argmax and
  `straggler_skew` = (max(t_step) - mean(t_step)) / mean(t_step), the
  share of every step the world spends waiting for its slowest rank, and
  rank 0 merges them into its metrics line. A row is one rank, that is
  one GPU, where JAX's row is one host. Unknown values travel as NaN and
  reduce NaN-aware, so a field no rank reports stays null in the line.
  Every rank must call `gather()` at the same log steps (the driver's log
  schedule is the same on every rank). A world of one reduces its own row
  with no collective.
- `Heartbeat`: a per-process file, `heartbeat.p<i>.json` in the workdir
  (i = the rank), replaced atomically at each beat, carrying the process's
  last step and wall time. When a process dies its metrics stop but its
  heartbeat stays: the alert engine's heartbeat rule reads the files of
  the other processes.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

FLEET_FIELDS = ("t_data", "t_step", "t_transfer", "dispatch_lag", "io_retries",
                "decode_failures", "hbm_live")


def reduce_stats(stats: np.ndarray, t_step_index: int) -> dict:
    """The per-field reduction of an (n_ranks, n_fields) stats matrix,
    NaN-aware: {"min", "mean", "max" (F,), "argmax" (F,) int32,
    "straggler_skew" ()}. A NaN never wins an argmax; an all-NaN column
    reduces to NaN (argmax 0)."""
    s = np.asarray(stats, np.float32)
    empty = np.isnan(s).all(axis=0)
    filled = np.where(np.isnan(s), np.float32(np.inf), s)
    mins = np.where(empty, np.nan, filled.min(axis=0)).astype(np.float32)
    filled = np.where(np.isnan(s), np.float32(-np.inf), s)
    maxs = np.where(empty, np.nan, filled.max(axis=0)).astype(np.float32)
    counts = (~np.isnan(s)).sum(axis=0)
    sums = np.where(np.isnan(s), np.float32(0), s).sum(axis=0, dtype=np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        means = np.where(empty, np.nan, sums / np.maximum(counts, 1)).astype(np.float32)
    argmax = filled.argmax(axis=0).astype(np.int32)
    t_mean, t_max = means[t_step_index], maxs[t_step_index]
    skew = np.float32((t_max - t_mean) / max(t_mean, np.float32(1e-12)))
    return {"min": mins, "mean": means, "max": maxs, "argmax": argmax, "straggler_skew": skew}


class FleetAggregator:
    """The log-step gather of every rank's stats vector over the whole world
    (module docstring): one row per process, data and model ranks alike."""

    def __init__(self, world, fields: Sequence[str] = FLEET_FIELDS):
        self.fields = tuple(fields)
        if "t_step" not in self.fields:
            raise ValueError("fleet fields must include 't_step' (skew is defined on it)")
        self.world = world
        self.num_hosts = world.world_size
        self.process_index = world.rank
        self._t_idx = self.fields.index("t_step")

    def host_vector(self, **values) -> np.ndarray:
        """(F,) float32 vector from per-field keyword values; missing or None
        fields become NaN ("unknown")."""
        unknown = set(values) - set(self.fields)
        if unknown:
            raise ValueError(f"unknown fleet fields {sorted(unknown)}; have {self.fields}")
        out = np.full((len(self.fields),), np.nan, np.float32)
        for i, name in enumerate(self.fields):
            v = values.get(name)
            if v is not None:
                out[i] = float(v)
        return out

    def gather(self, host_vector: np.ndarray) -> dict:
        """Contribute this rank's vector and get the world's reduction (the
        same on every rank). Every rank must call it at the same step."""
        row = torch.from_numpy(np.asarray(host_vector, np.float32).reshape(1, -1))
        if self.world.distributed:
            row = row.to(self.world.comm_device)
        stats = self.world.all_gather_rows(row, over="world").cpu().numpy()
        return reduce_stats(stats, self._t_idx)

    def payload(self, stats: dict) -> dict:
        """Metrics-line fields of a `gather()` result: `fleet/<name>_{min,
        mean,max,argmax}`, `straggler_skew` and the rank count (JAX's
        `fleet_hosts`). NaNs pass through: the sink writes them as null."""
        out = {"fleet_hosts": self.num_hosts}
        for i, name in enumerate(self.fields):
            out[f"fleet/{name}_min"] = float(stats["min"][i])
            out[f"fleet/{name}_mean"] = float(stats["mean"][i])
            out[f"fleet/{name}_max"] = float(stats["max"][i])
            out[f"fleet/{name}_argmax"] = int(stats["argmax"][i])
        out["straggler_skew"] = float(stats["straggler_skew"])
        return out


def heartbeat_path(workdir: str, process_index: int) -> str:
    return os.path.join(workdir, f"heartbeat.p{process_index}.json")


class Heartbeat:
    """A per-process liveness file; `beat()` is one small JSON write and a
    rename, which the driver makes at its start and on log steps.
    `keep_fresh(interval, fields)` beats from a daemon thread as well, until
    `stop()`: the file then goes stale only when the process is gone (the
    elastic trigger, parallel/elastic.py), not while a rank waits in a
    collective on a lost peer."""

    def __init__(self, workdir: str, process_index: int = 0,
                 trace_wall_t0: Optional[float] = None):
        os.makedirs(workdir, exist_ok=True)
        self.process_index = int(process_index)
        self.path = heartbeat_path(workdir, self.process_index)
        self.trace_wall_t0 = trace_wall_t0
        self._host = socket.gethostname()
        self._pid = os.getpid()
        self._lock = threading.Lock()  # the loop's beats and the thread's share one tmp file
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def keep_fresh(self, interval: float, fields: Callable[[], dict]) -> "Heartbeat":
        """Beat every `interval` seconds from a daemon thread, with
        `fields()` (step, epoch) as the record's."""
        def run() -> None:
            while not self._stop.wait(interval):
                self.beat(**fields())

        self._thread = threading.Thread(target=run, name="moco-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def beat(self, step: int = 0, epoch: int = 0, **extra) -> None:
        rec = {"process": self.process_index, "host": self._host, "pid": self._pid,
               "time": time.time(), "step": int(step), "epoch": int(epoch)}
        if self.trace_wall_t0 is not None:
            rec["trace_wall_t0"] = self.trace_wall_t0
        rec.update(extra)
        tmp = self.path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)  # readers never see a torn write


def read_heartbeats(workdir: str) -> dict[int, dict]:
    """{process index: its last heartbeat record} for every heartbeat file
    under `workdir`; an unparseable file is skipped."""
    out: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(workdir, "heartbeat.p*.json"))):
        try:
            with open(path) as f:
                rec = json.load(f)
            out[int(rec["process"])] = rec
        except (ValueError, KeyError, OSError):
            continue
    return out
