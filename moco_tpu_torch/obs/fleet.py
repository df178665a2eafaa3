"""Out-of-band heartbeats: the `heartbeat_path`, `Heartbeat` and
`read_heartbeats` of moco_tpu/obs/fleet.py. The cross-host aggregation
(`FleetAggregator`, `straggler_skew`) comes with data-parallel training.

A `Heartbeat` is a per-process file, `heartbeat.p<i>.json` in the workdir,
replaced atomically at each beat, carrying the process's last step and
wall time. When a process dies its metrics stop but its heartbeat stays:
the alert engine's heartbeat rule reads the files of the other processes.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import time
from typing import Optional


def heartbeat_path(workdir: str, process_index: int) -> str:
    return os.path.join(workdir, f"heartbeat.p{process_index}.json")


class Heartbeat:
    """A per-process liveness file; `beat()` is one small JSON write and a
    rename, which the driver makes at its start and on log steps."""

    def __init__(self, workdir: str, process_index: int = 0,
                 trace_wall_t0: Optional[float] = None):
        os.makedirs(workdir, exist_ok=True)
        self.process_index = int(process_index)
        self.path = heartbeat_path(workdir, self.process_index)
        self.trace_wall_t0 = trace_wall_t0
        self._host = socket.gethostname()
        self._pid = os.getpid()

    def beat(self, step: int = 0, epoch: int = 0, **extra) -> None:
        rec = {"process": self.process_index, "host": self._host, "pid": self._pid,
               "time": time.time(), "step": int(step), "epoch": int(epoch)}
        if self.trace_wall_t0 is not None:
            rec["trace_wall_t0"] = self.trace_wall_t0
        rec.update(extra)
        tmp = self.path + ".tmp"
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
