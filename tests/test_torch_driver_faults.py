"""The port's fault-tolerance and health layer in its driver
(moco_tpu_torch/train.py) against moco_tpu/train.py on the CPU, each case
running both drivers on the same tiny configuration and fault spec:
preemption (`preempt@step=3`: the same emergency step, extras and
`preempt` line, the signal handlers restored, the same step count after the
resume), `alerts_fatal` (FatalAlertError at the same step after a
`reason="alert"` checkpoint), and the watchdog's emergency path (`stall`,
with an injected `exit_fn` so no thread ends the test process). Signals
are sent only by the `preempt` fault, inside a `train()` call whose
handler is installed."""

import dataclasses
import json
import os
import signal

import pytest

from moco_tpu import train as jax_train_module
from moco_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from moco_tpu.obs.alerts import FatalAlertError as JaxFatalAlertError
from moco_tpu.obs.alerts import read_alerts as jax_read_alerts
from moco_tpu.train import train as jax_train
from moco_tpu.utils import config as jc
from moco_tpu.utils import faults as jax_faults
from moco_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from moco_tpu_torch import train as train_module
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.obs.alerts import FatalAlertError, read_alerts
from moco_tpu_torch.obs.schema import validate_line
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.checkpoint import CheckpointManager

NF = 4
MOCO = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
            shuffle="none", cifar_stem=True, compute_dtype="float32")
DATA = dict(dataset="synthetic", image_size=16, global_batch=16, num_workers=2)


def _configs(workdir, epochs, **kw):
    """The same run for both drivers: log every step, every checkpoint
    kept, JAX on one device without the fleet aggregation (the port has
    none)."""
    optim = dict(lr=0.03, epochs=epochs, cos=True)
    jcfg = jc.TrainConfig(moco=jc.MocoConfig(**MOCO), optim=jc.OptimConfig(**optim),
                          data=jc.DataConfig(**DATA), parallel=jc.ParallelConfig(num_data=1),
                          workdir=str(workdir / "jax"), log_every=1, checkpoint_keep=0,
                          fleet_metrics=False, **kw)
    pcfg = pc.TrainConfig(moco=pc.MocoConfig(**MOCO), optim=pc.OptimConfig(**optim),
                          data=pc.DataConfig(**DATA), workdir=str(workdir / "port"), log_every=1,
                          checkpoint_keep=0, **kw)
    return jcfg, pcfg


def _run_both(jcfg, pcfg, n, spec, expect=None):
    """One run of each driver on `n` synthetic images under fault `spec`;
    with `expect`, each must raise it (JAX's class first)."""
    for run, cfg, mod, data, exc in (
            (lambda c, d: jax_train(c, dataset=d), jcfg, jax_faults,
             JaxSynthetic(num_examples=n, image_size=16), expect and expect[0]),
            (lambda c, d: train(c, dataset=d, device="cpu", num_filters=NF), pcfg, faults,
             SyntheticDataset(n, 16), expect and expect[1])):
        mod.install(spec)
        try:
            if exc is None:
                run(cfg, data)
            else:
                with pytest.raises(exc):
                    run(cfg, data)
        finally:
            mod.clear()


def _lines(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _events(workdir):
    return [(r["step"], r["epoch"], r["event"], r.get("alert")) for r in _lines(workdir)
            if "event" in r]


def _emergency(mgr, step):
    extra = mgr.read_extra(step)
    return {k: extra[k] for k in ("epoch", "emergency", "reason") if k in extra}


def test_preemption_matches_jax(tmp_path):
    """`preempt@step=3` in 3 epochs of 2 steps (moco_tpu's
    tests/test_train_driver.py case): the signal lands at the deferred
    processing of step 3, one step late, so both save at step 4 with
    extras epoch 0 (the last completed one), emergency and
    reason="preempt", write the same `preempt` line and return with the
    previous SIGTERM/SIGINT handlers back; the resumed runs redo epoch 1
    and end at step 4 + 2 epochs of 2 = 8."""
    jcfg, pcfg = _configs(tmp_path, epochs=3)
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    _run_both(jcfg, pcfg, 32, "preempt@step=3")
    assert {s: signal.getsignal(s) for s in before} == before
    jmgr, pmgr = JaxCheckpointManager(jcfg.workdir), CheckpointManager(pcfg.workdir)
    assert jmgr.all_steps() == pmgr.all_steps() == [2, 4]
    assert _emergency(pmgr, 4) == _emergency(jmgr, 4) == {
        "epoch": 0, "emergency": True, "reason": "preempt"}
    assert _events(pcfg.workdir) == _events(jcfg.workdir) == [(4, 1, "preempt", None)]
    assert [r["step"] for r in _lines(pcfg.workdir) if "loss" in r] == [1, 2, 3]
    assert all(validate_line(r) == [] for r in _lines(pcfg.workdir))
    jmgr.close()
    _run_both(jcfg, pcfg, 32, "")
    jmgr = JaxCheckpointManager(jcfg.workdir)
    assert jmgr.latest_step() == CheckpointManager(pcfg.workdir).latest_step() == 8
    jmgr.close()
    assert {s: signal.getsignal(s) for s in before} == before


def test_alerts_fatal_matches_jax(tmp_path):
    """`nan@step=2` under the default rules with alerts_fatal, epochs of 3
    steps: step 2's loss is found non-finite after step 3 ran; the
    nonfinite_loss event fires its alert; both drivers write the event and
    alert lines and the same alerts.jsonl entry (time aside), save the last
    finite log step's state (step 1) with reason="alert" and the rule's
    name, and raise FatalAlertError."""
    jcfg, pcfg = _configs(tmp_path, epochs=2, alerts_fatal=True)
    _run_both(jcfg, pcfg, 48, "nan@step=2", expect=(JaxFatalAlertError, FatalAlertError))
    jmgr, pmgr = JaxCheckpointManager(jcfg.workdir), CheckpointManager(pcfg.workdir)
    assert jmgr.all_steps() == pmgr.all_steps() == [1]
    assert _emergency(pmgr, 1) == _emergency(jmgr, 1) == {
        "epoch": -1, "emergency": True, "reason": "alert"}
    assert pmgr.read_extra(1)["alert"] == jmgr.read_extra(1)["alert"] == "nonfinite_loss"
    jmgr.close()
    assert _events(pcfg.workdir) == _events(jcfg.workdir) == [
        (2, 0, "nonfinite_loss", None), (2, 0, "alert", "nonfinite_loss")]

    def entries(workdir):
        return [{k: v for k, v in a.items() if k != "time"}
                for a in read_alerts(os.path.join(workdir, "alerts.jsonl"))]

    assert entries(pcfg.workdir) == [
        {k: v for k, v in a.items() if k != "time"}
        for a in jax_read_alerts(os.path.join(jcfg.workdir, "alerts.jsonl"))]
    assert len(entries(pcfg.workdir)) == 1


def test_watchdog_emergency_path_matches_jax(tmp_path, monkeypatch):
    """`stall@step=2:seconds=10` with a 4 s watchdog, epochs of 3 steps:
    the loop sleeps in step 2's deferred processing (after step 3 ran),
    the watchdog fires once, dumps the stacks to stall_stacks.txt, writes
    the `stall` line (step 0, the epoch, the timeout), saves the guard's
    state with reason="stall" and extras epoch -1 (mid-epoch 0), and calls
    its exit_fn with 42, here a recorder, so both runs go on to their end.
    Both save the same step: the last log step whose loss the deferred
    fetch has read finite (step 1; the port's staged snapshot of step 2 is
    promoted only after the stall)."""
    exits = {"jax": [], "port": []}

    def recording(cls, key):
        def make(*args, **kw):
            return cls(*args, exit_fn=exits[key].append, **kw)
        return make

    monkeypatch.setattr(jax_train_module, "StepWatchdog",
                        recording(jax_train_module.StepWatchdog, "jax"))
    monkeypatch.setattr(train_module, "StepWatchdog",
                        recording(train_module.StepWatchdog, "port"))
    jcfg, pcfg = _configs(tmp_path, epochs=1, watchdog_timeout=4.0)
    _run_both(jcfg, pcfg, 48, "stall@step=2:seconds=10")
    assert exits == {"jax": [42], "port": [42]}
    for cfg in (jcfg, pcfg):
        assert "Thread" in open(os.path.join(cfg.workdir, "stall_stacks.txt")).read()
        stall = [r for r in _lines(cfg.workdir) if r.get("event") == "stall"]
        assert [(r["step"], r["epoch"], r["watchdog_timeout"]) for r in stall] == [(0, 0, 4.0)]
    jmgr, pmgr = JaxCheckpointManager(jcfg.workdir), CheckpointManager(pcfg.workdir)
    assert jmgr.all_steps() == pmgr.all_steps() == [1, 3]
    assert _emergency(pmgr, 1) == _emergency(jmgr, 1) == {
        "epoch": -1, "emergency": True, "reason": "stall"}
    jmgr.close()
    assert [r["alert"] for r in _lines(pcfg.workdir) if r.get("event") == "alert"] == []


def test_new_cli_flags_reach_the_config_as_in_jax(monkeypatch, tmp_path):
    """--checkpoint-async, --watchdog-timeout, --heartbeat-timeout,
    --alert-rules, --alerts-fatal and --no-health-metrics give the port's
    config the values the repo-root train.py gives JAX's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", os.path.join(os.path.dirname(os.path.dirname(__file__)), "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    flags = ["--checkpoint-async", "--watchdog-timeout", "15", "--heartbeat-timeout", "30",
             "--alert-rules", "default,threshold@name=x:field=loss:value=9", "--alerts-fatal",
             "--no-health-metrics"]
    jcfg = cli.config_from_args(cli.build_parser().parse_args(["--preset", "imagenet_v2"] + flags))
    seen = {}
    monkeypatch.setattr(train_module, "train", lambda config, **kw: seen.update(config=config))
    assert train_module.main(["--preset", "imagenet_v2", "--device", "cpu"] + flags) == 0
    fields = ("checkpoint_async", "watchdog_timeout", "heartbeat_timeout", "alert_rules",
              "alerts_fatal", "health_metrics")
    got = {f: getattr(seen["config"], f) for f in fields}
    assert got == {f: getattr(jcfg, f) for f in fields} == {
        "checkpoint_async": True, "watchdog_timeout": 15.0, "heartbeat_timeout": 30.0,
        "alert_rules": "default,threshold@name=x:field=loss:value=9", "alerts_fatal": True,
        "health_metrics": False}
    monkeypatch.setattr(train_module, "train", lambda config, **kw: seen.update(config=config))
    train_module.main(["--preset", "imagenet_v2", "--device", "cpu"])
    assert {f: getattr(seen["config"], f) for f in fields} == {
        f: getattr(jc.TrainConfig(), f) for f in fields}
    assert dataclasses.asdict(pc.TrainConfig())["alert_rules"] == "default"
