"""Worlds of ranks for the port's data-parallel tests: each rank is a
spawned process that joins a gloo group on the CPU through a FileStore
under the test's tmp_path (no ports), runs a job and hands its numpy
results back to the parent through a file. This module imports torch and
the port only; the parent compares the results with JAX.

`run_world(job, n, root, spec)` runs `job(world, spec)` on ranks 0..n-1
and returns their results in rank order; `num_model` lays the n ranks out
as (n / num_model) x num_model (parallel/mesh.py). The group has a timeout and the
parent a join timeout, so a broken world fails its test instead of
hanging the suite.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0


def _entry(job, rank: int, n: int, root: str, spec, num_model: int = 1,
           timeout_s: float = GROUP_TIMEOUT_S) -> None:
    torch.set_num_threads(1)
    from moco_tpu_torch.parallel.mesh import init_world

    out = os.path.join(root, f"rank{rank}.pkl")
    try:
        world = init_world(backend="gloo", rank=rank, world_size=n, device="cpu",
                           store_path=os.path.join(root, "store"), timeout_s=timeout_s,
                           num_model=num_model)
        try:
            result = job(world, spec)
        finally:
            world.close()
        with open(out, "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def start_world(job, n: int, root: str, spec=None, num_model: int = 1,
                timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Spawn the n ranks of `job` (their group's collectives time out after
    `timeout_s`); the caller joins them (`join_world`)."""
    os.makedirs(root, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(job, r, n, root, spec, num_model, timeout_s),
                         daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join_world(procs: list, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Exit codes of the ranks, each joined within `timeout` (a rank still
    alive then is killed and reads None)."""
    codes = []
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def collect_world(procs: list, root: str) -> list:
    """Join the ranks of `start_world` and return their results, rank
    order; raises with the ranks' tracebacks when one fails or hangs."""
    n = len(procs)
    codes = join_world(procs)
    if any(c != 0 for c in codes):
        errs = []
        for r in range(n):
            path = os.path.join(root, f"rank{r}.pkl.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
        raise RuntimeError(f"world of {n} failed, exit codes {codes}\n" + "\n".join(errs))
    out = []
    for r in range(n):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_world(job, n: int, root: str, spec=None, num_model: int = 1,
              timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Every rank's result of `job(world, spec)`, rank order."""
    return collect_world(start_world(job, n, root, spec, num_model, timeout_s), root)


# -- jobs ---------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def state_arrays(state) -> dict:
    """Every tensor of a train state as numpy: both encoders' state dicts,
    the predictor's, the queue."""
    out = {}
    for side, m in (("q", state.encoder_q), ("k", state.encoder_k), ("pred", state.predictor)):
        if m is not None:
            out.update({f"{side}.{k}": _np(v) for k, v in m.state_dict().items()})
    if state.queue is not None:
        out["queue"] = _np(state.queue)
    return out


def collectives_job(world, spec) -> dict:
    """The shuffle collectives on this rank's rows of spec's global arrays:
    gather_perm's shuffle and unshuffle, a2a's shuffle and unshuffle with
    this rank's (pre, post), the fleet gather, and the ledger."""
    from moco_tpu_torch.obs.fleet import FleetAggregator
    from moco_tpu_torch.parallel import shuffle as sh
    from moco_tpu_torch.parallel.dist import DataPartition

    part = DataPartition.of(world, spec["x"].shape[0])
    x = torch.from_numpy(part.rows(spec["x"]))
    perm = torch.from_numpy(spec["perm"])
    pre, post = (torch.from_numpy(spec[k][world.rank]) for k in ("pre", "post"))
    fleet = FleetAggregator(world)
    vec = spec["fleet"][world.rank]
    k_local, k_global = sh.dp_unshuffle_gather(world, x, torch.argsort(perm))
    return {
        "shuffled": _np(sh.dp_shuffle_gather(world, x, perm)),
        "k_local": _np(k_local), "k_global": _np(k_global),
        "a2a": _np(sh.dp_balanced_shuffle(world, x, pre, post)),
        "a2a_inverse": _np(sh.dp_balanced_unshuffle(
            world, sh.dp_balanced_shuffle(world, x, pre, post), pre, post)),
        "a2a_unshuffle": _np(sh.dp_balanced_unshuffle(world, x, pre, post)),
        "fleet": fleet.gather(vec),
        "ledger": {k: (v.collective, v.operand_bytes, v.bytes_per_step)
                   for k, v in world.ledger.snapshot().items()},
    }


def train_steps_job(world, spec) -> list:
    """For each case of spec["cases"]: the port state built from the case's
    numpy tree (its SyncBNs over this world), then the case's steps on this
    rank's rows of its global views, with its permutations (gather_perm's
    global `perm`, or this rank's a2a `pre` / `post`). Per case: the
    metrics of each step, a digest of the whole state after each step, the
    final state, queue pointer and step, and the ledger."""
    from moco_tpu_torch import convert
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.parallel.dist import DataPartition

    out = []
    for case in spec["cases"]:
        cfg = case["config"]
        world.ledger.reset()
        state = convert.state_from_flax(cfg, case["tree"], device="cpu",
                                        num_filters=case.get("num_filters", 64), world=world)
        step = make_train_step(cfg, case["steps_per_epoch"], device="cpu", world=world)
        part = DataPartition.of(world, cfg.data.global_batch)
        hist, digests = [], []
        for i, views in enumerate(case["views"]):
            batch = {"im_q": torch.from_numpy(part.rows(views[0])),
                     "im_k": torch.from_numpy(part.rows(views[1]))}
            perms = case.get("perms")
            if perms is not None and "perm" in perms[i]:
                batch["perm"] = torch.from_numpy(perms[i]["perm"])
            elif perms is not None:
                batch["pre"] = torch.from_numpy(perms[i]["pre"][world.rank])
                batch["post"] = torch.from_numpy(perms[i]["post"][world.rank])
            m = step(state, batch)
            hist.append({k: (np.asarray(v.detach().cpu().numpy(), np.float64)
                             if torch.is_tensor(v) else float(v)) for k, v in m.items()})
            arrays = state_arrays(state)
            digests.append(hashlib.sha256(
                b"".join(arrays[k].tobytes() for k in sorted(arrays))).hexdigest())
        out.append({"hist": hist, "digests": digests, "state": state_arrays(state),
                    "queue_ptr": state.queue_ptr, "step": state.step,
                    "ledger": {k: (v.collective, v.operand_bytes, v.bytes_per_step)
                               for k, v in world.ledger.snapshot().items()}})
    return out


def train_job(world, spec) -> list:
    """`train()` in this world for each run of spec["runs"] (config, steps),
    one after another: per run, the history's losses and steps, the final
    state and step, whether it was preempted, and the live lr and EMA
    momentum. spec["faults"], a fault spec or {rank: spec}, is installed
    first."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils import faults

    plan = spec.get("faults")
    faults.install(plan.get(world.rank) if isinstance(plan, dict) else plan)
    out = []
    for cfg, steps in spec["runs"]:
        res = train(cfg, dataset=SyntheticDataset(spec["examples"], cfg.data.image_size),
                    device="cpu", steps=steps, num_filters=spec["num_filters"], world=world)
        out.append({"losses": [r["loss"] for r in res["history"]],
                    "steps": [r["step"] for r in res["history"]],
                    "state": state_arrays(res["state"]), "step": res["state"].step,
                    "preempted": res["preempted"], "lr": res["config"].optim.lr,
                    "momentum": res["config"].moco.momentum})
    return out


def full_state_arrays(state) -> dict:
    """`state_arrays` with whole parameters under every ZeRO layout (at
    stage 2/3 the shards are gathered: a collective)."""
    if state.zero is None or not state.zero.stage23:
        return state_arrays(state)
    sds = state.zero.full_state_dicts()
    out = {}
    for side, key in (("q", "q"), ("k", "k"), ("pred", "predictor")):
        if sds[key] is not None:
            out.update({f"{side}.{k}": _np(v) for k, v in sds[key].items()})
    if state.queue is not None:
        out["queue"] = _np(state.queue)
    return out


def zero_job(world, spec) -> dict:
    """ZeRO in this world: spec["archs"] ({name: stage sizes} of BasicBlock
    ResNets) added to the arch table, then spec["cases"] as
    `train_steps_job` runs them (each case's config says its layout), with
    whole-tensor states
    (`full_state_arrays`), each step's metrics, the ledger, the rank's
    shard bytes and the analytic peak; then spec["resume"] (a stage-3
    checkpoint of the first steps of a case, resumed under other layouts)
    and spec["probe"] (the linear probe in this world)."""
    from moco_tpu_torch import convert
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.models import resnet
    from moco_tpu_torch.parallel.dist import DataPartition

    for arch, stages in spec.get("archs", {}).items():  # this process's test archs
        resnet._CONFIGS[arch] = dict(stage_sizes=stages, block=resnet.BasicBlock)
    out = {"cases": {}}
    for name, case in spec["cases"]:
        cfg = case["config"]
        world.ledger.reset()
        state = convert.state_from_flax(cfg, case["tree"], device="cpu",
                                        num_filters=case.get("num_filters", 64), world=world,
                                        mlp_hidden=case.get("mlp_hidden"))
        step = make_train_step(cfg, case["steps_per_epoch"], device="cpu", world=world)
        part = DataPartition.of(world, cfg.data.global_batch)
        hist, digests = [], []
        for i, views in enumerate(case["views"]):
            batch = {"im_q": torch.from_numpy(part.rows(views[0])),
                     "im_k": torch.from_numpy(part.rows(views[1]))}
            perms = case.get("perms")
            if perms is not None:
                batch["perm"] = torch.from_numpy(perms[i]["perm"])
            m = step(state, batch)
            hist.append({k: (np.asarray(v.detach().cpu().numpy(), np.float64)
                             if torch.is_tensor(v) else float(v)) for k, v in m.items()})
            arrays = full_state_arrays(state)
            digests.append(hashlib.sha256(
                b"".join(arrays[k].tobytes() for k in sorted(arrays))).hexdigest())
        z = state.zero
        out["cases"][name] = {
            "hist": hist, "digests": digests, "state": full_state_arrays(state),
            "step": state.step,
            "ledger": {k: (v.collective, v.operand_bytes, v.bytes_per_step)
                       for k, v in world.ledger.snapshot().items()},
            "hbm_model_peak_bytes": None if z is None else z.hbm_model_peak_bytes,
            "shard_bytes": None if z is None else sum(s.numel() * 4 for s in z.shard_tensors()),
            "released": None if z is None else [z.released("q"), z.released("k")]}
    if spec.get("trio") is not None:
        x = torch.from_numpy(spec["trio"][world.rank])
        world.ledger.reset()
        sh = world.local_shard(x)
        out["trio"] = {"scatter_mean": _np(world.scatter_mean(x, "trio.scatter")),
                       "local_shard": _np(sh), "unshard": _np(world.unshard(sh, x, "trio.gather")),
                       "ledger": {k: (v.collective, v.operand_bytes, v.bytes_per_step)
                                  for k, v in world.ledger.snapshot().items()}}
    if spec.get("resume"):
        out["resume"] = _resume_job(world, spec["resume"])
    if spec.get("probe"):
        out["probe"] = _probe_job(world, spec["probe"])
    return out


def _resume_job(world, spec) -> dict:
    """Steps of a case under the first layout of spec["layouts"], a
    checkpoint of it (rank 0 writes), the same checkpoint loaded into a
    fresh state under every layout, and one more step from each: per
    layout the loaded state's whole tensors and the next step's loss."""
    from moco_tpu_torch import convert
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.parallel.dist import DataPartition
    from moco_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_payload,
        state_payload,
    )
    from moco_tpu_torch.utils.config import config_to_dict

    part = DataPartition.of(world, spec["layouts"][0][1].data.global_batch)

    def batch(views):
        return {"im_q": torch.from_numpy(part.rows(views[0])),
                "im_k": torch.from_numpy(part.rows(views[1]))}

    out = {}
    ckpt = CheckpointManager(spec["workdir"], keep=0)
    for i, (name, cfg) in enumerate(spec["layouts"]):
        state = convert.state_from_flax(cfg, spec["tree"], device="cpu",
                                        num_filters=spec["num_filters"], world=world)
        step = make_train_step(cfg, spec["steps_per_epoch"], device="cpu", world=world)
        if i == 0:
            for views in spec["views"][:-1]:
                step(state, batch(views))
            payload = state_payload(state, cfg.moco.arch, 1)
            if world.is_main:
                ckpt.save(state.step, payload, extra={"epoch": 0,
                                                      "config": config_to_dict(cfg)})
                ckpt.wait()
            world.barrier()
        else:
            load_state_payload(state, ckpt.restore()[0])
        arrays = full_state_arrays(state)
        loss = float(step(state, batch(spec["views"][-1]))["loss"])
        out[name] = {"state": arrays, "step": state.step, "next_loss": loss,
                     "next_state": full_state_arrays(state)}
    ckpt.close()
    return out


def _probe_job(world, spec) -> dict:
    """`train_lincls` in this world: the classifier and the last
    validation."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.lincls import train_lincls

    out = train_lincls(spec["pretrain"], spec["probe"], data=spec["data"],
                       workdir=spec["workdir"],
                       train_dataset=SyntheticDataset(spec["n_train"], spec["data"].image_size),
                       val_dataset=SyntheticDataset(spec["n_val"], spec["data"].image_size),
                       device="cpu", world=world)
    return {k: float(v) for k, v in out.items()}


def model_axis_job(world, spec) -> dict:
    """The model axis in this world (num_data x num_model ranks): spec's
    "archs" added to the arch table, then each part spec holds:

    - "ring": ring attention of this rank's sequence shard of the global
      (B, H, S, D) q, k, v over the model group ("model") or every rank
      ("world"): out, lse and the gradients of sum(out ** 2);
    - "vit": the sequence-parallel ViT's features of the images;
    - "steps": {name: case}, the step from a case's JAX tree on this rank's
      rows of each step's views (with the global `perm`s): the sharded
      queue's v1/v2 step or the sequence-parallel v3 step, replicated or
      under the case config's ZeRO layout; per step the metrics, the
      trained parameters' gradients (replicated) and a digest of the state
      but the queue (whole tensors), then the final state, queue_ptr and
      the ledger;
    - "ckpt": `train()` runs with workdirs (run "a" straight, "b" and then
      "c" resuming it): each run's final state;
    - "cross": a checkpoint across layouts (`_cross_job`)."""
    import torch.distributed as dist

    from moco_tpu_torch import convert
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.models import resnet
    from moco_tpu_torch.models.vit import create_vit, sequence_parallel_ring
    from moco_tpu_torch.parallel.dist import DataPartition
    from moco_tpu_torch.parallel.ring_attention import Ring, ring_attention_with_lse

    for arch, stages in spec.get("archs", {}).items():  # this process's test archs
        resnet._CONFIGS[arch] = dict(stage_sizes=stages, block=resnet.BasicBlock)
    out = {}
    for name, case in spec.get("ring", {}).items():
        world.ledger.reset()
        ring = (world.ring() if case["over"] == "model"
                else Ring(dist.group.WORLD, world.world_size, world.rank, world.ledger))
        local = case["q"].shape[2] // ring.size
        q, k, v = (torch.from_numpy(case[x][:, :, ring.rank * local:(ring.rank + 1) * local])
                   .requires_grad_(True) for x in ("q", "k", "v"))
        o, lse = ring_attention_with_lse(q, k, v, ring)
        (o ** 2).sum().backward()
        out[f"ring_{name}"] = {"out": _np(o), "lse": _np(lse), "dq": _np(q.grad),
                               "dk": _np(k.grad), "dv": _np(v.grad),
                               "ledger": {k: (v.collective, v.bytes_per_step, v.calls_per_step)
                                          for k, v in world.ledger.snapshot().items()}}
    if spec.get("vit") is not None:
        case = spec["vit"]
        vit = create_vit("vit_tiny", image_size=case["images"].shape[1], patch_size=4,
                         pool="gap", sequence_parallel=True)
        vit.load_state_dict({k: torch.from_numpy(v) for k, v in case["weights"].items()})
        with torch.no_grad(), sequence_parallel_ring(world.ring()):
            out["vit"] = _np(vit(torch.from_numpy(case["images"])))
    for name, case in spec.get("steps", {}).items():
        cfg = case["config"]
        world.ledger.reset()
        state = convert.state_from_flax(cfg, case["tree"], device="cpu",
                                        num_filters=case.get("num_filters", 64), world=world,
                                        mlp_hidden=case.get("mlp_hidden"))
        step = make_train_step(cfg, case["steps_per_epoch"], device="cpu", world=world)
        part = DataPartition.of(world, cfg.data.global_batch)
        trained = [(f"{side}.{k}", p) for side, m in (("q", state.encoder_q),
                                                       ("pred", state.predictor))
                   if m is not None for k, p in m.named_parameters() if p.requires_grad]
        hist, grads, digests = [], [], []
        for i, views in enumerate(case["views"]):
            batch = {"im_q": torch.from_numpy(part.rows(views[0])),
                     "im_k": torch.from_numpy(part.rows(views[1]))}
            if case.get("perms") is not None:
                batch["perm"] = torch.from_numpy(case["perms"][i]["perm"])
            m = step(state, batch)
            hist.append({k: float(v) for k, v in m.items() if k in ("loss", "acc1", "acc5")})
            grads.append({k: _np(p.grad) for k, p in trained if p.grad is not None})
            arrays = full_state_arrays(state)
            digests.append(hashlib.sha256(
                b"".join(arrays[k].tobytes() for k in sorted(arrays) if k != "queue")).hexdigest())
        out[name] = {"hist": hist, "grads": grads, "digests": digests,
                     "state": full_state_arrays(state), "queue_ptr": state.queue_ptr,
                     "ledger": {k: (v.collective, v.operand_bytes, v.bytes_per_step)
                                for k, v in world.ledger.snapshot().items()}}
    if spec.get("ckpt") is not None:
        from moco_tpu_torch.data.datasets import SyntheticDataset
        from moco_tpu_torch.train import train

        case = spec["ckpt"]
        out["ckpt"] = {}
        for run, (cfg, steps) in case["runs"].items():
            res = train(cfg, dataset=SyntheticDataset(case["examples"], cfg.data.image_size),
                        device="cpu", steps=steps, num_filters=case["num_filters"], world=world)
            out["ckpt"][run] = {"state": state_arrays(res["state"]), "step": res["state"].step,
                                "queue_ptr": res["state"].queue_ptr,
                                "losses": [r["loss"] for r in res["history"]]}
    if spec.get("cross") is not None:
        out["cross"] = _cross_job(world, spec["cross"])
    return out


def _cross_job(world, case, wait_s: float = JOIN_TIMEOUT_S) -> dict:
    """One step of case["config"] from its tree, saved under case["save"]
    (every rank joins the payload's gathers, rank 0 writes), then the
    checkpoint another world writes under case["load"] (waited for) loaded
    into a fresh state of the config, and one step from it: the saved and
    loaded states (whole tensors, this rank's queue rows), the loaded step
    and the next loss."""
    import time

    from moco_tpu_torch import convert
    from moco_tpu_torch.core.moco import make_train_step
    from moco_tpu_torch.parallel.dist import DataPartition
    from moco_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_state_payload,
        state_payload,
    )

    cfg = case["config"]
    part = DataPartition.of(world, cfg.data.global_batch)

    def batch(i):
        views = case["views"][i]
        b = {"im_q": torch.from_numpy(part.rows(views[0])),
             "im_k": torch.from_numpy(part.rows(views[1]))}
        if case.get("perms") is not None:
            b["perm"] = torch.from_numpy(case["perms"][i]["perm"])
        return b

    def fresh():
        return convert.state_from_flax(cfg, case["tree"], device="cpu",
                                       num_filters=case["num_filters"], world=world)

    step = make_train_step(cfg, case["steps_per_epoch"], device="cpu", world=world)
    state = fresh()
    step(state, batch(0))
    payload = state_payload(state, cfg.moco.arch, 1)
    if world.is_main:
        mgr = CheckpointManager(case["save"], keep=0)
        mgr.save(state.step, payload, extra={"epoch": 0})
        mgr.close()
    saved = full_state_arrays(state)
    deadline = time.time() + wait_s
    while CheckpointManager(case["load"]).latest_step() is None:
        if time.time() > deadline:
            raise TimeoutError(f"no checkpoint under {case['load']}")
        time.sleep(0.2)
    world.barrier()
    state = fresh()
    load_state_payload(state, CheckpointManager(case["load"]).restore()[0])
    loaded, loaded_step = full_state_arrays(state), state.step
    loss = float(step(state, batch(1))["loss"])
    return {"saved": saved, "loaded": loaded, "loaded_step": loaded_step, "next_loss": loss}
