"""The port's elastic training (moco_tpu_torch/parallel/elastic.py and the
driver's use of it) against the JAX package's, on the CPU with no spawned
world: `feasible_width` and `plan_rescale` against JAX's on a grid of
widths, per-rank batches, queues and dead hosts (the plan, the new config,
kappa, lr and momentum); the coordinator's detection and consensus on the
port's heartbeat files (tests/test_elastic.py's cases); the rescale line
under both schema validators; the refusals with JAX's messages; the config
fields and the auto_scale anchor; and a heartbeat alert that elastic
handles instead of aborting. The world of 4 with `kill@host=0` and its
relaunch: tests/test_torch_dist.py.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import pytest

from moco_tpu.obs.schema import validate_line as jax_validate_line
from moco_tpu.parallel import elastic as jax_elastic
from moco_tpu.utils import config as jc
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.obs.fleet import Heartbeat
from moco_tpu_torch.obs.schema import validate_line
from moco_tpu_torch.parallel import elastic
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.contracts import EXIT_CODES, RESCALE_EXIT_CODE


def _message(exc_type, fn) -> str:
    with pytest.raises(exc_type) as e:
        fn()
    return str(e.value)


# -- the width and the plan -------------------------------------------------------


@pytest.mark.parametrize("survivors", [0, 1, 3, 5, 7])
@pytest.mark.parametrize("per_rank,k", [(8, 128), (8, 96), (7, 128), (4, 64), (8, 0)])
def test_feasible_width_matches_jax(survivors, per_rank, k):
    """The widest width whose batch divides K, or JAX's error, word for word."""
    try:
        want = jax_elastic.feasible_width(survivors, per_rank, k)
    except ValueError as e:
        assert _message(ValueError, lambda: elastic.feasible_width(survivors, per_rank, k)) \
            == str(e)
        return
    assert elastic.feasible_width(survivors, per_rank, k) == want


GRID = [(n, per, k, dead) for n in (1, 2, 4, 8) for per in (2, 8) for k in (0, 64, 96)
        for dead in ((0,), (2, 5), (1, 3, 6))]


@pytest.mark.parametrize("n,per,k,dead", GRID)
def test_plan_rescale_matches_jax(n, per, k, dead):
    """plan_rescale against JAX's on one process's 8 virtual devices (JAX's
    fake fleet: a device is a host; the port's world of 8 ranks), each
    config anchored at its own batch (elastic's default): the plan, the
    new reference config's batch, width, lr and momentum, and the derived
    kappa, lr and momentum; or JAX's error."""
    assert len(jax.devices()) == 8
    batch = per * n
    kw = dict(auto_scale=f"ref_batch={batch}")
    jcfg = jc.TrainConfig(moco=jc.MocoConfig(num_negatives=k, momentum=0.99),
                          data=jc.DataConfig(global_batch=batch), **kw)
    pcfg = pc.TrainConfig(moco=pc.MocoConfig(num_negatives=k, momentum=0.99),
                          data=pc.DataConfig(global_batch=batch), **kw)
    try:
        want = jax_elastic.plan_rescale(jcfg, n, 1, list(dead), step=7)
    except ValueError as e:
        got = _message(ValueError, lambda: elastic.plan_rescale(pcfg, n, 1, list(dead), 7,
                                                                world_size=8))
        assert got == str(e)
        return
    plan, new_ref, info = elastic.plan_rescale(pcfg, n, 1, list(dead), 7, world_size=8)
    assert dataclasses.asdict(plan) == dataclasses.asdict(want[0])
    assert plan.consensus_key() == want[0].consensus_key()
    for get in (lambda c: c.data.global_batch, lambda c: c.parallel.num_data,
                lambda c: c.optim.lr, lambda c: c.moco.momentum, lambda c: c.auto_scale):
        assert get(new_ref) == get(want[1])
    assert info == want[2]
    live, _ = pc.apply_auto_scale(new_ref)
    assert (live.optim.lr, live.moco.momentum) == (info["lr"], info["momentum"])


def test_plan_rescale_refusals_and_surviving_ranks():
    """JAX's refusals, word for word: a model axis, a batch the width does
    not divide; a rank is a process, so the survivors are the other ranks."""
    for args in ((8, 2, [2]), (3, 1, [0])):
        cfg = dict(data=dict(global_batch=64))
        want = _message(ValueError, lambda: jax_elastic.plan_rescale(
            jc.TrainConfig(data=jc.DataConfig(**cfg["data"])), *args, step=3))
        got = _message(ValueError, lambda: elastic.plan_rescale(
            pc.TrainConfig(data=pc.DataConfig(**cfg["data"])), *args, 3))
        assert got == want
    assert elastic.surviving_ranks([2, 5], 8) == [0, 1, 3, 4, 6, 7]
    assert elastic.plan_rescale(pc.TrainConfig(moco=pc.MocoConfig(num_negatives=128),
                                               data=pc.DataConfig(global_batch=64)),
                                8, 1, [2], 3)[0].new_num_data == 4
    assert RESCALE_EXIT_CODE == EXIT_CODES["rescale"] == 75


# -- detection and consensus (tests/test_elastic.py's cases) ----------------------


def _beat(workdir, process, t):
    path = os.path.join(workdir, f"heartbeat.p{process}.json")
    with open(path, "w") as f:
        json.dump({"process": process, "time": t, "step": 1, "epoch": 0}, f)


def test_stale_hosts_flags_only_new_dead(tmp_path):
    now = time.time()
    Heartbeat(str(tmp_path), 0).beat(step=1)  # self, through the port's writer
    _beat(tmp_path, 1, now - 1.0)
    _beat(tmp_path, 2, 0.0)
    _beat(tmp_path, 3, now - 100.0)
    _beat(tmp_path, 4, 0.0)  # a rank of a wider launch a rescale left: outside this world
    coord = elastic.ElasticCoordinator(str(tmp_path), 0, num_processes=4, timeout=10.0)
    assert coord.stale_hosts(now=now) == [2, 3]
    # JAX names it unless told it is known dead: its hosts are not its processes
    args, kw = (str(tmp_path), 0), dict(num_processes=4, timeout=10.0)
    assert jax_elastic.ElasticCoordinator(*args, **kw).stale_hosts(now=now) == [2, 3, 4]
    assert jax_elastic.ElasticCoordinator(*args, **kw, known_dead=[4]).stale_hosts(now=now) == [
        2, 3]
    _beat(tmp_path, 2, now)
    assert coord.stale_hosts(now=now) == [3]


def test_stale_hosts_ignores_hosts_that_never_beat(tmp_path):
    Heartbeat(str(tmp_path), 0).beat()
    coord = elastic.ElasticCoordinator(str(tmp_path), 0, num_processes=8, timeout=5.0)
    assert coord.stale_hosts() == []
    assert coord.wait_for_stale(budget=0.2) == []


def test_heartbeat_thread_keeps_a_waiting_rank_fresh(tmp_path):
    """keep_fresh beats from a thread: the file stays fresh while the rank
    does nothing, and goes stale once it stops."""
    hb = Heartbeat(str(tmp_path), 1).keep_fresh(0.05, lambda: {"step": 4, "epoch": 0})
    coord = elastic.ElasticCoordinator(str(tmp_path), 0, num_processes=2, timeout=0.3)
    try:
        time.sleep(0.5)
        assert coord.stale_hosts() == []
    finally:
        hb.stop()
    assert coord.wait_for_stale(budget=2.0) == [1]


def _plan(dead=(2,), new_n=4, new_b=32, step=3):
    return elastic.RescalePlan(step=step, dead_hosts=tuple(dead), old_num_data=8,
                               new_num_data=new_n, old_global_batch=64, new_global_batch=new_b)


def test_consensus_barrier_agrees_across_survivors(tmp_path):
    """Two survivors of three publish matching plans (their steps differ);
    both clear the barrier; the writer's durable mark releases the other."""
    coords = [elastic.ElasticCoordinator(str(tmp_path), p, num_processes=3, barrier_timeout=5.0)
              for p in (0, 1)]
    results, errors = {}, []

    def run(i):
        try:
            results[i] = coords[i].agree(_plan(step=3 + i))
            if i == 0:
                coords[0].mark_durable(results[0])
            else:
                coords[1].wait_durable(results[1], 0)
        except Exception as e:  # surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not errors and set(results) == {0, 1}
    for p in (0, 1):
        assert os.path.exists(elastic.rescale_path(str(tmp_path), p))
    with open(elastic.rescale_path(str(tmp_path), 1)) as f:
        assert {k: v for k, v in json.load(f).items() if k not in ("time",)} == {
            "process": 1, **_plan().consensus_key()}


def test_consensus_barrier_times_out_without_peer(tmp_path):
    coord = elastic.ElasticCoordinator(str(tmp_path), 0, num_processes=2, barrier_timeout=0.3,
                                       poll_interval=0.02)
    with pytest.raises(RuntimeError, match="timed out"):
        coord.agree(_plan())
    with pytest.raises(RuntimeError, match="did not mark the rescale durable"):
        coord.wait_durable(_plan(), 1)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_consensus_barrier_rejects_conflicting_plan(tmp_path, package):
    mod = elastic if package == "port" else jax_elastic
    with open(mod.rescale_path(str(tmp_path), 1), "w") as f:
        json.dump({"process": 1, "time": time.time(), "dead_hosts": [3], "new_num_data": 2,
                   "new_global_batch": 16}, f)
    coord = mod.ElasticCoordinator(str(tmp_path), 0, num_processes=2, barrier_timeout=1.0,
                                   poll_interval=0.02)
    with pytest.raises(RuntimeError) as e:
        coord.agree(mod.RescalePlan(**dataclasses.asdict(_plan())))
    assert str(e.value).startswith("rescale consensus conflict: process 1 proposes")


def test_consensus_barrier_ignores_stale_previous_round(tmp_path):
    """A previous round's file (an hour old, another plan) is no conflict:
    the barrier waits for the peer to overwrite it, and times out here."""
    with open(elastic.rescale_path(str(tmp_path), 1), "w") as f:
        json.dump({"process": 1, "time": time.time() - 3600, "dead_hosts": [],
                   "new_num_data": 8, "new_global_batch": 64}, f)
    coord = elastic.ElasticCoordinator(str(tmp_path), 0, num_processes=2, barrier_timeout=0.3,
                                       poll_interval=0.02)
    with pytest.raises(RuntimeError, match="timed out"):
        coord.agree(_plan())


# -- the line, the config ---------------------------------------------------------


def test_rescale_line_under_both_schemas():
    """The driver's rescale line: valid under the port's schema and JAX's;
    a width that is not an int, or dead hosts that are not a list, fail
    both."""
    line = {"step": 3, "time": 1.0, "epoch": 1, "event": "rescale",
            "rescale/dead_hosts": [2], "rescale/old_num_data": 8, "rescale/new_num_data": 4,
            "rescale/old_global_batch": 64, "rescale/new_global_batch": 32,
            "rescale/kappa": 0.5, "rescale/lr": 0.015, "rescale/momentum": 0.99498}
    assert validate_line(line) == [] == jax_validate_line(line)
    for bad in ({"rescale/new_num_data": "four"}, {"rescale/dead_hosts": "2"},
                {"rescale/kappa": "half"}):
        assert validate_line({**line, **bad}) and jax_validate_line({**line, **bad})


def test_config_elastic_fields_and_anchor():
    """`elastic` is a TrainConfig field as in JAX (round trip with
    heartbeat_timeout and auto_scale); an elastic run without auto_scale is
    anchored at its own batch, with one given it keeps it; JAX's refusal of
    a model axis."""
    cfg = pc.TrainConfig(elastic=True, heartbeat_timeout=7.5, auto_scale="ref_batch=64")
    rt = pc.config_from_dict(pc.config_to_dict(cfg))
    assert rt.elastic and rt.heartbeat_timeout == 7.5 and rt.auto_scale == "ref_batch=64"
    assert pc.elastic_reference(cfg) is cfg
    plain = pc.TrainConfig(elastic=True, data=pc.DataConfig(global_batch=96))
    assert pc.elastic_reference(plain).auto_scale == "ref_batch=96"
    assert pc.elastic_reference(pc.TrainConfig()).auto_scale == ""
    assert {f.name for f in dataclasses.fields(pc.TrainConfig)} >= {"elastic"}
    with pytest.raises(ValueError, match=r"^elastic=True supports num_model=1 meshes only$"):
        pc.validate_elastic(pc.TrainConfig(elastic=True, parallel=pc.ParallelConfig(num_model=2)))


# -- the driver in one process ------------------------------------------------------


def _driver_config(workdir, **kw):
    moco = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                cifar_stem=True, compute_dtype="float32", shuffle="none")
    return pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(lr=0.03, epochs=1),
                          data=pc.DataConfig(dataset="synthetic", image_size=16, global_batch=8,
                                             num_workers=1),
                          workdir=str(workdir), log_every=1, steps_per_epoch=2,
                          device_prefetch=False, health_metrics=False, alerts_fatal=True,
                          heartbeat_timeout=5.0, **kw)


def test_heartbeat_alert_is_handled_not_fatal_under_elastic(tmp_path):
    """kill@host=1 in a world of one stamps rank 1's heartbeat stale, and
    the heartbeat_loss alert fires with fatal severity under alerts_fatal,
    which aborts a run (FatalAlertError) on any other fatal alert; under
    elastic this one is handled, not fatal (`handle_alerts` leaves it out),
    and the run ends (a world of one has no rank 1 to rescale away: rank
    1's file is a wider launch's); lr is the anchored rule's (kappa 1)."""
    from moco_tpu_torch.train import train

    cfg = _driver_config(tmp_path / "run", elastic=True)
    faults.install("kill@host=1:at=1")
    try:
        out = train(cfg, dataset=SyntheticDataset(16, 16), device="cpu", num_filters=4)
    finally:
        faults.install(None)
    assert [r["step"] for r in out["history"]] == [1, 2]
    assert out["config"].optim.lr == cfg.optim.lr
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["severity"] for r in lines if r.get("alert") == "heartbeat_loss"][:1] == ["fatal"]
    assert not any(r.get("event") == "rescale" for r in lines)


def test_elastic_needs_a_workdir():
    from moco_tpu_torch.train import train

    cfg = dataclasses.replace(_driver_config("unused", elastic=True), workdir=None)
    with pytest.raises(ValueError, match="elastic=True needs a workdir"):
        train(cfg, dataset=SyntheticDataset(24, 16), device="cpu", num_filters=4)
