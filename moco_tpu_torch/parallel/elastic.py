"""Elastic training: heartbeat loss -> consensus -> emergency checkpoint ->
rescale exit (the port's counterpart of moco_tpu/parallel/elastic.py).

When a rank stops beating (a crash, a preemption, the `kill@host=i` fault),
the survivors

1. **detect** the loss out of band: `ElasticCoordinator.stale_hosts()`
   reads the per-rank `heartbeat.p<i>.json` files (obs/fleet.py) and names
   any whose age exceeds `heartbeat_timeout`. The driver asks on its log
   steps, and also when a collective fails (gloo raises once a peer's
   socket closes) or the stall watchdog fires (an NCCL collective with a
   dead peer blocks): the failure only wakes the survivors, the criterion
   stays the heartbeat's staleness;
2. **agree** on the event: `agree()` publishes this rank's plan to
   `rescale.p<i>.json` (an atomic rename) and polls until every surviving
   peer has published a matching one. It uses no collective: the dead
   rank may be wedged inside one, and the process group is broken;
3. **checkpoint**: the lowest surviving rank saves the guard's snapshot
   (the last finite log step's state, which every rank holds whole under
   replicated data parallelism) and writes the `rescale` event line;
4. **exit** with RESCALE_EXIT_CODE. A port rank is a process on its own
   card, and a process group cannot shrink in place, so every rescale goes
   through the launcher: it relaunches the survivors at the planned width
   and batch, which the survivors print, and the relaunch resumes the
   emergency checkpoint (whole tensors: any world size loads it).

`plan_rescale` picks the widest surviving data axis that keeps the queue's
`K % global_batch == 0` at a constant per-rank batch, and re-derives lr and
the EMA momentum through `apply_auto_scale` (kappa = new / reference batch:
lr linearly, momentum m ** kappa) from the reference config, so repeated
rescales derive from one anchor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence

from moco_tpu_torch.obs.fleet import read_heartbeats
from moco_tpu_torch.utils.config import TrainConfig, apply_auto_scale
from moco_tpu_torch.utils.contracts import RESCALE_EXIT_CODE


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """The agreed rescale: which ranks died, at which step, and the width
    and global batch the survivors relaunch at."""

    step: int
    dead_hosts: tuple  # every dead rank, across rescales
    old_num_data: int
    new_num_data: int
    old_global_batch: int
    new_global_batch: int

    def consensus_key(self) -> dict:
        """The fields the survivors must agree on exactly (not the step:
        staleness may be seen one log step apart on two ranks; the plan
        derived from it may not differ)."""
        return {
            "dead_hosts": sorted(int(h) for h in self.dead_hosts),
            "new_num_data": int(self.new_num_data),
            "new_global_batch": int(self.new_global_batch),
        }


class ElasticRescale(RuntimeError):
    """Raised by the driver's commit point once the emergency checkpoint is
    durable (or, under ZeRO, once the plan is agreed); `train()` turns it
    into the exit with RESCALE_EXIT_CODE."""

    def __init__(self, plan: RescalePlan, info: dict):
        super().__init__(
            f"elastic rescale at step {plan.step}: hosts {list(plan.dead_hosts)} "
            f"lost, mesh {plan.old_num_data} -> {plan.new_num_data}, global "
            f"batch {plan.old_global_batch} -> {plan.new_global_batch}"
        )
        self.plan = plan
        self.info = info

    def relaunch_flags(self) -> str:
        """The driver flags of the relaunch: the width, the global batch and
        the reference batch the lr and momentum derive from."""
        ref = self.info.get("ref_batch")
        flags = f"--num-data {self.plan.new_num_data} --batch-size {self.plan.new_global_batch}"
        return flags + (f" --auto-scale ref_batch={ref}" if ref is not None else "")


def feasible_width(survivors: int, per_rank_batch: int, num_negatives: int) -> int:
    """The widest data axis <= `survivors` whose global batch, at a constant
    per-rank batch, divides K (the queue's FIFO invariant, core/queue.py);
    any width for a queue-free (v3) run. Raises when none does."""
    if survivors < 1:
        raise ValueError("no surviving hosts — nothing to rescale onto")
    for n in range(survivors, 0, -1):
        if num_negatives > 0 and num_negatives % (per_rank_batch * n):
            continue
        return n
    raise ValueError(
        f"no mesh width <= {survivors} keeps K={num_negatives} divisible by "
        f"the global batch (per-device batch {per_rank_batch})"
    )


def surviving_ranks(dead_hosts: Sequence[int], world_size: int) -> list:
    """The ranks of a world of `world_size` that are not dead: a port rank
    is one process on one card, so a dead host is its rank (JAX's
    `surviving_devices` over the dead processes' devices)."""
    dead = set(int(h) for h in dead_hosts)
    return [r for r in range(int(world_size)) if r not in dead]


def plan_rescale(ref_config: TrainConfig, num_data: int, num_model: int,
                 dead_hosts: Sequence[int], step: int,
                 world_size: Optional[int] = None) -> tuple[RescalePlan, TrainConfig, dict]:
    """The post-loss world from the reference config (lr and momentum at the
    `auto_scale` reference batch): the surviving ranks of a world of
    `world_size` (default num_data x num_model) -> the feasible width at
    the same per-rank batch -> the new global batch -> lr and momentum
    through `apply_auto_scale`. Returns (plan, the new reference config,
    the derived hyperparameters' info)."""
    if num_model != 1:
        raise ValueError("elastic rescale supports num_model=1 meshes only")
    per_rank = ref_config.data.global_batch // num_data
    if per_rank * num_data != ref_config.data.global_batch:
        raise ValueError(
            f"global batch {ref_config.data.global_batch} not divisible by "
            f"the data axis {num_data}"
        )
    size = num_data * num_model if world_size is None else int(world_size)
    survivors = len(surviving_ranks(dead_hosts, size)) // num_model
    new_n = feasible_width(survivors, per_rank, ref_config.moco.num_negatives)
    new_batch = per_rank * new_n
    plan = RescalePlan(
        step=int(step),
        dead_hosts=tuple(sorted(int(h) for h in dead_hosts)),
        old_num_data=int(num_data),
        new_num_data=int(new_n),
        old_global_batch=int(ref_config.data.global_batch),
        new_global_batch=int(new_batch),
    )
    new_ref = dataclasses.replace(
        ref_config,
        data=dataclasses.replace(ref_config.data, global_batch=new_batch),
        parallel=dataclasses.replace(ref_config.parallel, num_data=new_n),
    )
    _, info = apply_auto_scale(new_ref)
    return plan, new_ref, dict(info or {})


def rescale_path(workdir: str, process_index: int) -> str:
    return os.path.join(workdir, f"rescale.p{process_index}.json")


def durable_path(workdir: str) -> str:
    """The writer's mark that a rescale's checkpoint and line are on disk."""
    return os.path.join(workdir, "rescale.durable.json")


class ElasticCoordinator:
    """One rank's detection and consensus (module docstring). Every rescale
    ends the processes, so no rank is known dead beforehand: JAX's
    `known_dead` (its in-process re-entry's) has no counterpart, and the
    files of ranks a rescale left behind lie outside the relaunched world."""

    def __init__(self, workdir: str, process_index: int = 0, num_processes: int = 1,
                 timeout: float = 120.0, barrier_timeout: float = 60.0,
                 poll_interval: float = 0.05):
        self.workdir = workdir
        self.process_index = int(process_index)
        self.num_processes = int(num_processes)
        self.timeout = float(timeout)
        self.barrier_timeout = float(barrier_timeout)
        self.poll_interval = float(poll_interval)
        self._published = 0.0  # when this rank last published its plan

    def stale_hosts(self, now: Optional[float] = None) -> list[int]:
        """Ranks whose heartbeat file is older than the timeout (not this
        rank). A rank with no file is not reported: it never joined this
        run; nor is a rank outside this world's `num_processes`: the file of
        a wider launch that a rescale left behind."""
        now = time.time() if now is None else now
        stale = []
        for p, rec in read_heartbeats(self.workdir).items():
            if p == self.process_index or p >= self.num_processes:
                continue
            if now - float(rec.get("time", 0.0)) > self.timeout:
                stale.append(p)
        return sorted(stale)

    def wait_for_stale(self, budget: Optional[float] = None) -> list[int]:
        """`stale_hosts()` polled for up to `budget` seconds (default the
        heartbeat timeout, plus one poll), until it names a rank; [] when
        none went stale. (The driver's heartbeat thread keeps this rank's
        own file fresh meanwhile.)"""
        budget = self.timeout + max(self.poll_interval, 0.5) if budget is None else budget
        deadline = time.time() + budget
        while True:
            dead = self.stale_hosts()
            if dead or time.time() > deadline:
                return dead
            time.sleep(max(self.poll_interval, 0.1))

    def mark_durable(self, plan: RescalePlan) -> None:
        """The writer's word that the emergency checkpoint and the event
        line of `plan` are on disk (`durable_path`)."""
        path = durable_path(self.workdir)
        with open(path + ".tmp", "w") as f:
            json.dump({"process": self.process_index, "time": time.time(),
                       **plan.consensus_key()}, f)
        os.replace(path + ".tmp", path)

    def wait_durable(self, plan: RescalePlan, writer: int) -> None:
        """Wait until rank `writer` has marked `plan` durable after this
        rank's own `agree` (a survivor must not leave before the save: a
        launcher may stop the others once one exits). Raises RuntimeError
        after the barrier timeout."""
        key = plan.consensus_key()
        deadline = time.time() + self.barrier_timeout
        while True:
            try:
                with open(durable_path(self.workdir)) as f:
                    rec = json.load(f)
                if ({k: rec.get(k) for k in key} == key
                        and rec.get("time", 0.0) >= self._published):
                    return
            except (OSError, ValueError):
                pass
            if time.time() > deadline:
                raise RuntimeError(f"rank {writer} did not mark the rescale durable within "
                                   f"{self.barrier_timeout:g}s")
            time.sleep(self.poll_interval)

    def agree(self, plan: RescalePlan) -> RescalePlan:
        """Publish this rank's plan and wait until every surviving peer has
        published a matching one (equal `consensus_key`). Raises
        RuntimeError when the barrier times out or a peer's fresh plan
        differs: the survivors do not share one view of who died."""
        key = plan.consensus_key()
        path = rescale_path(self.workdir, self.process_index)
        tmp = path + ".tmp"
        self._published = time.time()
        with open(tmp, "w") as f:
            json.dump({"process": self.process_index, "time": self._published, **key}, f)
        os.replace(tmp, path)
        pending = {p for p in range(self.num_processes)
                   if p != self.process_index and p not in set(plan.dead_hosts)}
        deadline = time.time() + self.barrier_timeout
        while pending:
            for p in sorted(pending):
                try:
                    with open(rescale_path(self.workdir, p)) as f:
                        peer = json.load(f)
                except (OSError, ValueError):
                    continue
                peer_key = {k: peer.get(k) for k in key}
                if peer_key == key:
                    pending.discard(p)
                elif peer.get("time", 0.0) >= time.time() - self.barrier_timeout:
                    raise RuntimeError(
                        f"rescale consensus conflict: process {p} proposes "
                        f"{peer_key}, this process {key}"
                    )
            if pending and time.time() > deadline:
                raise RuntimeError(
                    f"rescale consensus barrier timed out after "
                    f"{self.barrier_timeout:g}s waiting for processes "
                    f"{sorted(pending)}"
                )
            if pending:
                time.sleep(self.poll_interval)
        return plan


__all__ = [
    "RESCALE_EXIT_CODE",
    "ElasticCoordinator",
    "ElasticRescale",
    "RescalePlan",
    "durable_path",
    "feasible_width",
    "plan_rescale",
    "rescale_path",
    "surviving_ranks",
]
