"""The port's data-parallel layer on the CPU, against the JAX package where
it has a counterpart: the partition of the global batch (parallel/dist.py
against `device_row_ranges` / `ProcessDataPartition`) and the union of the
ranks' pipeline batches; the Shuffle-BN collectives (parallel/shuffle.py's
`dp_*`) against JAX's under `shard_map` at worlds of 2 and 4, with their
ledger sites; the fleet aggregate (obs/fleet.py) against JAX's
`reduce_stats`; the gates with JAX's messages; and the driver in a world
of 2: metrics.jsonl with the comms ledger and the fleet's gauges, rank 0's
files only, a restart that continues the trajectory bit for bit, a
preemption signalled on one rank, `kill@host`, and the torchrun command;
and elastic training in a world of 4: `kill@host=0`, the survivors' exit
75 with rank 1's emergency checkpoint and `rescale` line, and the relaunch
at the planned width of 2 resuming it.

Ranks are spawned processes in a gloo world (tests/_torch_dist_worker.py);
each world has a group timeout and a join timeout.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as dw
from moco_tpu.core.moco import create_backbone as jax_create_backbone
from moco_tpu.obs import comms as jax_comms
from moco_tpu.obs import fleet as jax_fleet
from moco_tpu.parallel import create_mesh
from moco_tpu.parallel import shuffle as jax_shuffle
from moco_tpu.parallel.compat import shard_map
from moco_tpu.parallel.dist import ProcessDataPartition
from moco_tpu.parallel.dist import device_row_ranges as jax_row_ranges
from moco_tpu.parallel.mesh import batch_sharding
from moco_tpu.utils import config as jc
from moco_tpu_torch.core.moco import build_encoder, make_train_step
from moco_tpu_torch.data.datasets import ImageFolderDataset, SyntheticDataset
from moco_tpu_torch.data.pipeline import TwoCropPipeline
from moco_tpu_torch.obs import fleet as port_fleet
from moco_tpu_torch.obs.schema import validate_line
from moco_tpu_torch.parallel import dist as port_dist
from moco_tpu_torch.parallel.mesh import World
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils.checkpoint import CheckpointManager
from moco_tpu_torch.utils.contracts import KILL_EXIT_CODE, RESCALE_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_KEY = 5


# -- the partition ---------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_row_ranges_and_partition_match_jax(n):
    """Rank r's rows are the rows device r holds on JAX's 1-D data mesh of n
    devices: the ranges, `local_positions` and `local_indices` of
    ProcessDataPartition with device r as the process's device."""
    b = 32
    mesh = create_mesh(num_data=n, devices=jax.devices()[:n])
    sharding = batch_sharding(mesh)
    by_device = jax_row_ranges(sharding, b)
    assert port_dist.device_row_ranges(n, b) == [by_device[d] for d in mesh.devices.reshape(-1)]
    order = np.random.default_rng(n).permutation(1000)[:b]
    for r, dev in enumerate(mesh.devices.reshape(-1)):
        theirs = ProcessDataPartition(sharding, b, addressable_devices=[dev])
        ours = port_dist.DataPartition(r, n, b)
        np.testing.assert_array_equal(ours.local_positions, theirs.local_positions)
        np.testing.assert_array_equal(ours.local_indices(order), theirs.local_indices(order))
        assert ours.local_rows == theirs.local_rows == b // n
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        port_dist.device_row_ranges(3, b)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """An ImageFolder of 16 PNG images of varied geometry in 2 classes."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dist_imgs")
    rng = np.random.default_rng(0)
    for c in ("a", "b"):
        (root / c).mkdir()
        for i in range(8):
            h, w = 20 + 3 * i, 30 - 2 * i
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(root / c / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("source,ring", [("synthetic", False), ("synthetic", True),
                                         ("folder", False)])
def test_union_of_rank_batches_is_the_one_process_batch(folder, source, ring):
    """Each of 4 ranks loads only its rows and draws the augment (and, on
    the host-crop path, the crop boxes) for the whole global batch: the
    ranks' batches, concatenated in rank order, equal the one-process
    batch(epoch, step) bit for bit, through the ring and in sync mode; the
    `input.h2d` ledger site counts a rank's quarter of the wire bytes."""
    n, b = 4, 8
    cfg = pc.DataConfig(dataset="synthetic", image_size=16, global_batch=b, num_workers=1,
                        aug_plus=True)
    dataset = (SyntheticDataset(2 * b, 16) if source == "synthetic"
               else ImageFolderDataset(folder))
    with TwoCropPipeline(cfg, seed=3, dataset=dataset, device="cpu") as one:
        assert one.host_crops == (source == "folder")
        want = [one.batch(1, s) for s in range(2)]
        one_bytes = one.host_batch(1, 0).wire_bytes
    got = []
    for r in range(n):
        world = World(rank=r, world_size=n, device="cpu")
        with TwoCropPipeline(cfg, seed=3, dataset=dataset, device="cpu",
                             partition=port_dist.DataPartition(r, n, b),
                             ledger=world.ledger) as part:
            it = part.epoch(1, device=ring)
            try:
                got.append(list(it))
            finally:
                it.close()
            assert world.ledger.snapshot()["input.h2d"].bytes_per_step * n == one_bytes
    for s in range(2):
        for view in ("im_q", "im_k"):
            union = np.concatenate([g[s][view].numpy() for g in got])
            np.testing.assert_array_equal(union, want[s][view].numpy(), err_msg=f"{view} {s}")


# -- the Shuffle-BN collectives --------------------------------------------------


def _jax_collectives(x, perm, n):
    """JAX's shuffle collectives on a mesh of n devices under shard_map, and
    the ledger their trace records."""
    mesh = create_mesh(num_data=n, devices=jax.devices()[:n])
    rng = jax.random.PRNGKey(ROOT_KEY)
    jax_comms.reset()
    perm_j = jnp.asarray(perm)
    sm = functools.partial(shard_map, mesh=mesh, check_vma=False)
    x_j = jnp.asarray(x)
    out = {
        "shuffled": sm(lambda a: jax_shuffle.shuffle_gather(a, perm_j, "data"),
                       in_specs=P("data"), out_specs=P("data"))(x_j),
    }
    k_local, k_global = sm(lambda a: jax_shuffle.unshuffle_gather(a, jnp.argsort(perm_j), "data"),
                           in_specs=P("data"), out_specs=(P("data"), P()))(x_j)
    out["k_local"], out["k_global"] = k_local, k_global
    out["a2a"] = sm(lambda a: jax_shuffle.balanced_shuffle(rng, a, "data"),
                    in_specs=P("data"), out_specs=P("data"))(x_j)
    out["a2a_unshuffle"] = sm(lambda a: jax_shuffle.balanced_unshuffle(rng, a, "data"),
                              in_specs=P("data"), out_specs=P("data"))(x_j)
    ledger = {k: (v.collective, v.operand_bytes, v.bytes_per_step)
              for k, v in jax_comms.snapshot().items()}
    return {k: np.asarray(v) for k, v in out.items()}, ledger


def _local_perms(n, lb):
    """Each rank's (pre, post): JAX's fold of the rank into the step key."""
    rng = jax.random.PRNGKey(ROOT_KEY)
    local = lambda salt, r: np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(rng, salt), r), lb), np.int64)
    return [local(17, r) for r in range(n)], [local(29, r) for r in range(n)]


@functools.lru_cache(maxsize=None)
def _collectives(root):
    """Worlds of 2 and 4 ranks (side by side) running the collectives on
    the same global arrays, and the fleet gather."""
    specs, procs = {}, {}
    for n in (2, 4):
        rng = np.random.default_rng(n)
        x = rng.standard_normal((16, 5)).astype(np.float32)
        pre, post = _local_perms(n, 16 // n)
        fleet = rng.random((n, len(port_fleet.FLEET_FIELDS))).astype(np.float32)
        fleet[rng.random(fleet.shape) < 0.3] = np.nan
        fleet[:, -1] = np.nan  # a field no rank reports
        specs[n] = {"x": x, "perm": rng.permutation(16), "pre": pre, "post": post,
                    "fleet": fleet}
        procs[n] = dw.start_world(dw.collectives_job, n, f"{root}/w{n}", specs[n])
    return {n: (specs[n], dw.collect_world(procs[n], f"{root}/w{n}")) for n in (2, 4)}


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return _collectives(str(tmp_path_factory.mktemp("dist_coll")))


@pytest.mark.parametrize("n", [2, 4])
def test_shuffle_collectives_match_jax_shard_map(collectives, n):
    """gather_perm's shuffle and unshuffle (k_local and the replicated
    k_global), a2a's balanced shuffle and unshuffle with JAX's per-rank
    permutations: each rank's rows equal JAX's exactly; the unshuffle
    inverts the shuffle; the four ledger sites are JAX's, operand bytes
    and bytes per step."""
    spec, ranks = collectives[n]
    want, jax_ledger = _jax_collectives(spec["x"], spec["perm"], n)
    lb = 16 // n
    for r, res in enumerate(ranks):
        rows = slice(r * lb, (r + 1) * lb)
        for k in ("shuffled", "k_local", "a2a", "a2a_unshuffle"):
            np.testing.assert_array_equal(res[k], want[k][rows], err_msg=f"{k} rank {r}")
        np.testing.assert_array_equal(res["k_global"], want["k_global"])
        np.testing.assert_array_equal(res["a2a_inverse"], spec["x"][rows])
        assert res["ledger"] == jax_ledger


@pytest.mark.parametrize("n", [2, 4])
def test_fleet_gather_reduces_as_jax(collectives, n):
    """The gather of every rank's vector: the same reduction on every rank,
    equal to JAX's reduce_stats of the stacked vectors (NaN where no rank
    reports), straggler_skew included."""
    spec, ranks = collectives[n]
    want = jax_fleet.reduce_stats(jnp.asarray(spec["fleet"]), 1)
    for res in ranks:
        for k, v in want.items():
            np.testing.assert_array_equal(res["fleet"][k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_reduce_stats_matches_jax_on_nan_padded_matrices(seed):
    """NaN-aware min / mean / max / argmax and straggler_skew of random
    (ranks, fields) matrices with NaN holes and an all-NaN column: equal to
    JAX's (float32, NaN where JAX's is); the payload's keys are JAX's."""
    rng = np.random.default_rng(seed)
    s = rng.random((1 + seed * 3, 7)).astype(np.float32) * 10
    s[rng.random(s.shape) < 0.25] = np.nan
    s[:, 6] = np.nan
    s[0, 1] = 1.0  # t_step reported somewhere
    want = jax_fleet.reduce_stats(jnp.asarray(s), 1)
    got = port_fleet.reduce_stats(s, 1)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    agg = port_fleet.FleetAggregator(World(device="cpu"))
    payload = agg.payload(got)
    assert set(payload) == set(jax_fleet.FleetAggregator().payload(want))
    assert port_fleet.FLEET_FIELDS == jax_fleet.FLEET_FIELDS


# -- the gates -------------------------------------------------------------------


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_gates_raise_jax_messages():
    """syncbn_group_size not dividing the data axis, or set without one; a
    global batch the ranks cannot split; the parallel fields beyond
    num_data, num_model (tests/test_torch_model_axis.py) and ZeRO's
    (tests/test_torch_zero.py) still a TypeError (`elastic` is a
    TrainConfig field, as in JAX); elastic on a model axis with the
    driver's message; a world that is not num_data ranks."""
    for g, n in ((3, 4), (4, 2)):
        kw = dict(arch="resnet18", shuffle="syncbn", syncbn_group_size=g)
        want = _message(lambda: jax_create_backbone(jc.MocoConfig(**kw), num_data=n))
        got = _message(lambda: build_encoder(pc.MocoConfig(**kw), num_filters=4,
                                             world=World(world_size=n, device="cpu")))
        assert got == want == f"data axis {n} not divisible by syncbn group {g}"
    kw = dict(arch="resnet18", shuffle="syncbn", syncbn_group_size=2)
    assert (_message(lambda: build_encoder(pc.MocoConfig(**kw), num_filters=4))
            == _message(lambda: jax_create_backbone(jc.MocoConfig(**kw))))
    cfg = pc.TrainConfig(moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=60),
                         data=pc.DataConfig(global_batch=12))
    assert (_message(lambda: make_train_step(cfg, 2, device="cpu",
                                             world=World(world_size=8, device="cpu")))
            == "global batch 12 not divisible by data axis 8")
    a2a = dataclasses.replace(cfg, moco=dataclasses.replace(cfg.moco, shuffle="a2a"))
    assert "a2a shuffle needs local batch 3 divisible by axis size 4" in _message(
        lambda: make_train_step(a2a, 2, device="cpu", world=World(world_size=4, device="cpu")))
    with pytest.raises(TypeError):
        pc.ParallelConfig(elastic=2)
    elastic = pc.TrainConfig(elastic=True, parallel=pc.ParallelConfig(num_model=2))
    want = "elastic=True supports num_model=1 meshes only"
    assert _message(lambda: pc.validate_elastic(elastic)) == want  # moco_tpu/train.py:207-208
    tiny = pc.TrainConfig(moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64),
                          data=pc.DataConfig(global_batch=8, image_size=16),
                          parallel=pc.ParallelConfig(num_data=2))
    from moco_tpu_torch.train import train
    with pytest.raises(ValueError, match="num_data=2 but the launch has 1 rank"):
        train(tiny, dataset=SyntheticDataset(16, 16), device="cpu", steps=1, num_filters=4)


def test_linear_probe_refuses_a_data_parallel_launch(monkeypatch, tmp_path):
    """The probe now runs under a data-parallel launch (it used to refuse
    one): with MOCO_MULTIHOST=1 (a world of one through the distributed
    path, rendezvous at 127.0.0.1 on a free port) train_lincls makes its
    world, gloo on the CPU, probes a pretraining checkpoint, closes the
    group, and scores exactly as the one-process probe. A world of two:
    tests/test_torch_zero_dist.py."""
    import socket

    import torch.distributed as dist

    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.lincls import train_lincls
    from moco_tpu_torch.train import train

    pre = tmp_path / "pre"
    train(_config(pre), dataset=SyntheticDataset(16, 16), device="cpu", num_filters=4)
    probe = pc.ProbeConfig(lr=1.0, epochs=1, num_classes=10)
    data = dataclasses.replace(_config(pre).data, global_batch=8)

    def run(workdir):
        return train_lincls(str(pre), probe, data=data, workdir=str(workdir),
                            train_dataset=SyntheticDataset(16, 16),
                            val_dataset=SyntheticDataset(12, 16), device="cpu")

    one = run(tmp_path / "one")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with monkeypatch.context() as m:
        for k, v in {"MOCO_MULTIHOST": "1", "WORLD_SIZE": "1", "RANK": "0",
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
            m.setenv(k, v)
        launched = run(tmp_path / "launched")
    assert not dist.is_initialized()
    assert launched == one


# -- the driver in a world of 2 --------------------------------------------------


def _config(workdir, epochs=1, **kw):
    moco = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                cifar_stem=True, compute_dtype="float32", shuffle="gather_perm")
    return pc.TrainConfig(moco=pc.MocoConfig(**moco),
                          optim=pc.OptimConfig(lr=0.03, epochs=epochs, cos=True),
                          data=pc.DataConfig(dataset="synthetic", image_size=16, global_batch=8,
                                             num_workers=1),
                          workdir=str(workdir), log_every=1, obs_probe_every=1,
                          checkpoint_keep=0, **kw)


def _lines(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


ELASTIC_TIMEOUT_S = 12.0  # the elastic world's group timeout: a survivor blocked on a peer waits it out
ELASTIC_BATCH = 16  # 4 ranks x 4 rows; K = 64: feasible_width(3, 4, 64) = 2 -> 8


def _elastic_config(workdir, batch=ELASTIC_BATCH):
    cfg = _config(workdir, elastic=True, heartbeat_timeout=2.0, steps_per_epoch=6,
                  parallel=pc.ParallelConfig(timeout_s=ELASTIC_TIMEOUT_S))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, global_batch=batch))


@functools.lru_cache(maxsize=None)
def _driver(root):
    """Three worlds of 2 side by side: (a) an uninterrupted run of 2 epochs
    of 3 steps, then one epoch and its restart to 2 epochs on another
    workdir; (b) `preempt@step=2` on rank 1 alone; (c) `kill@host=1:at=2`;
    beside them (d) an elastic world of 4 with `kill@host=0:at=3`, and once
    it has ended (e) its relaunch at 2 ranks and the planned batch: a run of
    no step (the restored state), then 3 steps."""
    common = {"examples": 24, "num_filters": 4}
    w = {k: os.path.join(root, k) for k in ("whole", "split", "preempt", "kill", "elastic")}
    elastic = {"examples": 6 * ELASTIC_BATCH, "num_filters": 4}
    procs = {
        "a": dw.start_world(dw.train_job, 2, f"{root}/a", {**common, "runs": [
            (_config(w["whole"], epochs=2), None), (_config(w["split"], epochs=1), None),
            (_config(w["split"], epochs=2), None)]}),
        "b": dw.start_world(dw.train_job, 2, f"{root}/b", {**common, "faults": {
            1: "preempt@step=2"}, "runs": [(_config(w["preempt"], epochs=2), None)]}),
        "c": dw.start_world(dw.train_job, 2, f"{root}/c", {
            **common, "faults": "kill@host=1:at=2", "runs": [(_config(w["kill"]), None)]}),
        "d": dw.start_world(dw.train_job, 4, f"{root}/d", {
            **elastic, "faults": "kill@host=0:at=3",
            "runs": [(_elastic_config(w["elastic"]), None)]}, timeout_s=ELASTIC_TIMEOUT_S),
    }
    out = {"d": dw.join_world(procs["d"]), "dirs": w}
    relaunch = _elastic_config(w["elastic"], ELASTIC_BATCH // 2)
    procs["e"] = dw.start_world(dw.train_job, 2, f"{root}/e", {
        **elastic, "runs": [(relaunch, 0), (relaunch, 3)]}, timeout_s=ELASTIC_TIMEOUT_S)
    out.update({"a": dw.collect_world(procs["a"], f"{root}/a"),
                "b": dw.collect_world(procs["b"], f"{root}/b"),
                "c": dw.join_world(procs["c"]),
                "e": dw.collect_world(procs["e"], f"{root}/e")})
    return out


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    return _driver(str(tmp_path_factory.mktemp("dist_driver")))


def test_two_rank_run_writes_rank0_files_with_comms_and_fleet(driver):
    """One metrics.jsonl line per step (rank 0's), each schema-valid with
    the `comms/<site>` bytes of gather_perm at n = 2 and rank 0's fleet
    aggregate over 2 rows (straggler_skew); one checkpoint per epoch (its
    extras carry num_data); a heartbeat per rank; trace.json; the ranks in
    lockstep."""
    ranks, whole = driver["a"], driver["dirs"]["whole"]
    lines = [r for r in _lines(whole) if "loss" in r]
    assert [r["step"] for r in lines] == [1, 2, 3, 4, 5, 6]
    for r in lines:
        assert validate_line(r) == [], r
        assert {"comms/shuffle.gather_images", "comms/shuffle.gather_keys", "comms/grad.psum",
                "comms/input.h2d", "comms/total"} <= set(r)
        assert "comms/queue.enqueue_gather" not in r
        assert r["comms/shuffle.gather_images"] == 4 * 16 * 16 * 3 * 4  # (2-1) x 4 rows f32
        assert r["fleet_hosts"] == 2 and r["straggler_skew"] >= 0
        assert r["comms/input.h2d"] == 4 * 16 * 16 * 3  # 4 uint8 canvases: the rank's rows
    mgr = CheckpointManager(whole)
    assert mgr.all_steps() == [3, 6] and mgr.read_extra(6)["num_data"] == 2
    assert sorted(f for f in os.listdir(whole) if f.startswith("heartbeat")) == [
        "heartbeat.p0.json", "heartbeat.p1.json"]
    assert os.path.exists(os.path.join(whole, "trace.json"))
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
    for k, v in ranks[0][0]["state"].items():
        np.testing.assert_array_equal(ranks[1][0]["state"][k], v, err_msg=k)


def test_restart_continues_the_trajectory_bit_for_bit(driver):
    """A 2-rank run of one epoch, then a fresh train() on its workdir for 2
    epochs: both ranks restore rank 0's step-3 file and steps 4-6 give the
    uninterrupted run's losses and final state bit for bit."""
    ranks = driver["a"]
    for res in ranks:
        whole, first, resumed = res
        assert first["steps"] == [1, 2, 3] and resumed["steps"] == [4, 5, 6]
        assert first["losses"] + resumed["losses"] == whole["losses"]
        for k, v in whole["state"].items():
            np.testing.assert_array_equal(resumed["state"][k], v, err_msg=k)
    assert CheckpointManager(driver["dirs"]["split"]).all_steps() == [3, 6]


def test_preemption_on_one_rank_stops_every_rank_at_the_same_step(driver):
    """SIGTERM on rank 1 alone (preempt@step=2, at that log step's deferred
    processing): the ranks agree at the same log step, both stop after step
    3 with `preempted`, and rank 0's emergency checkpoint of step 3 (reason
    "preempt") is durable; one `preempt` line."""
    ranks, workdir = driver["b"], driver["dirs"]["preempt"]
    for res in ranks:
        assert res[0]["preempted"] and res[0]["step"] == 3
    extra = CheckpointManager(workdir).read_extra(3)
    assert extra["emergency"] and extra["reason"] == "preempt"
    assert [r["step"] for r in _lines(workdir) if r.get("event") == "preempt"] == [3]


def test_kill_host_exits_113_and_the_survivor_does_not_hang(driver):
    """kill@host=1:at=2: rank 1 exits with KILL_EXIT_CODE at its step-2 log
    processing; rank 0 leaves with a non-zero exit at its next collective,
    well inside the join timeout (no hang)."""
    codes = driver["c"]
    assert codes[1] == KILL_EXIT_CODE == 113
    assert codes[0] not in (0, None)


def test_elastic_survivors_exit_75_after_rank_1_saves(driver):
    """Elastic, kill@host=0:at=3 in a world of 4 (rank 0, the writer, dies at
    its step-3 log processing): rank 0 exits 113 and every survivor 75;
    rank 1, the lowest survivor, has written the emergency checkpoint of
    the guard's step-3 snapshot (extras `reason: "rescale"`, the plan,
    epoch -1: the relaunch redoes the epoch) and one `rescale` line, valid
    under the port's schema and JAX's, planning 4 -> 2 ranks and 16 -> 8
    rows at kappa 1/2."""
    from moco_tpu.obs.schema import validate_line as jax_validate_line

    assert driver["d"] == [KILL_EXIT_CODE] + [RESCALE_EXIT_CODE] * 3
    workdir = driver["dirs"]["elastic"]
    mgr = CheckpointManager(workdir)
    assert mgr.all_steps() == [3]
    extra = mgr.read_extra(3)
    mgr.close()
    assert extra["emergency"] and extra["reason"] == "rescale" and extra["epoch"] == -1
    cfg = _elastic_config(workdir)
    assert extra["rescale"] == {"dead_hosts": [0], "new_num_data": 2, "new_global_batch": 8,
                                "step": extra["rescale"]["step"], "kappa": 0.5,
                                "lr": cfg.optim.lr * 0.5,
                                "momentum": cfg.moco.momentum ** 0.5, "ref_batch": 16}
    lines = [r for r in _lines(workdir) if r.get("event") == "rescale"]
    assert len(lines) == 1
    line = lines[0]
    assert validate_line(line) == [] and jax_validate_line(line) == []
    assert {k: line[k] for k in line if k.startswith("rescale/")} == {
        "rescale/dead_hosts": [0], "rescale/old_num_data": 4, "rescale/new_num_data": 2,
        "rescale/old_global_batch": 16, "rescale/new_global_batch": 8, "rescale/kappa": 0.5,
        "rescale/lr": cfg.optim.lr * 0.5, "rescale/momentum": cfg.moco.momentum ** 0.5}


def test_elastic_relaunch_resumes_the_checkpoint_bit_for_bit(driver):
    """The relaunch at the plan's 2 ranks and batch 8 (no --auto-scale: the
    checkpoint's anchor, ref_batch 16, is kept): each rank's restored state
    is the emergency checkpoint's, bit for bit (the file loaded here into a
    one-process state), lr and EMA momentum are `apply_auto_scale`'s at
    kappa 1/2, and 3 more steps (4-6) train to finite losses, the ranks in
    lockstep."""
    from moco_tpu_torch.core.moco import build_encoder as port_encoder
    from moco_tpu_torch.core.moco import create_state
    from moco_tpu_torch.utils.checkpoint import load_state_payload

    workdir = driver["dirs"]["elastic"]
    relaunch = _elastic_config(workdir, ELASTIC_BATCH // 2)
    want, _ = pc.apply_auto_scale(dataclasses.replace(relaunch, auto_scale="ref_batch=16"))
    mgr = CheckpointManager(workdir)
    payload, _ = mgr.restore(step=3)
    mgr.close()
    state = create_state(relaunch, port_encoder(relaunch.moco, num_filters=4), device="cpu")
    load_state_payload(state, payload)
    restored = dw.state_arrays(state)
    ranks = driver["e"]
    for restart, trained in ranks:
        assert restart["step"] == 3 and restart["steps"] == []
        assert set(restart["state"]) == set(restored)
        for k, v in restored.items():
            np.testing.assert_array_equal(restart["state"][k], v, err_msg=k)
        for run in (restart, trained):
            assert run["lr"] == want.optim.lr == relaunch.optim.lr * 0.5
            assert run["momentum"] == want.moco.momentum == relaunch.moco.momentum ** 0.5
        assert trained["steps"] == [4, 5, 6] and np.all(np.isfinite(trained["losses"]))
    assert ranks[0][1]["losses"] == ranks[1][1]["losses"]


def test_torchrun_trains_two_gloo_ranks_on_the_cpu(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    moco_tpu_torch.train ... --device cpu`: each rank joins through
    torchrun's environment (gloo), rank 0 alone prints step lines and writes
    metrics.jsonl (with the ledger and the fleet aggregate) and the one
    checkpoint."""
    workdir = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "moco_tpu_torch.train", "--preset", "cifar_smoke", "--data", "synthetic",
           "--batch-size", "8", "--epochs", "1", "--steps-per-epoch", "2", "--workers", "1",
           "--workdir", str(workdir), "--device", "cpu", "--dist-timeout", "60"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    steps = [json.loads(line)["step"] for line in proc.stdout.splitlines()
             if line.startswith("{")]
    assert steps == [1, 2]  # rank 0's lines alone
    lines = [r for r in _lines(workdir) if "loss" in r]
    assert [r["step"] for r in lines] == [1, 2]
    assert all("straggler_skew" in r and r["comms/grad.psum"] > 0 for r in lines)
    assert CheckpointManager(str(workdir)).all_steps() == [2]
