"""The port's training loop with its telemetry (moco_tpu_torch/train.py) on
the CPU, against moco_tpu/train.py on the same tiny configuration: a run
with a workdir, sinks "jsonl,csv" and obs_probe_every=2 writes training
lines with JAX's driver key set for that configuration, less the families
the port does not write yet (NOT_PORTED); its CSV rows are its JSONL
lines; its trace.json nests every step's spans inside an epoch span with
`device_wait` on the sampled steps only; JAX's scripts/obs_report.py
renders the workdir. The in-flight window changes no number: losses are
bit-equal with the probe waiting around every step and never. And the
loop waits only where it says: counting the calls to its one wait helper,
a run without probe samples waits at the window's oldest step and at the
log steps' deferred reads, nothing else. The CLI's telemetry flags reach
the config as the repo-root train.py's reach JAX's."""

import csv
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from moco_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from moco_tpu.obs.schema import validate_line as jax_validate_line
from moco_tpu.train import train as jax_train
from moco_tpu.utils import config as jc
from moco_tpu.utils import retry as jax_retry
from moco_tpu_torch import train as train_module
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.obs.schema import validate_line
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import retry as port_retry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = 4
MOCO = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
            shuffle="none", cifar_stem=True, compute_dtype="float32")
OPTIM = dict(lr=0.03, epochs=1, cos=True)
DATA = dict(dataset="synthetic", image_size=16, global_batch=16, num_workers=2)
OBS = dict(log_every=1, sinks="jsonl,csv", obs_probe_every=2)
# JAX's training-line families the port does not write yet: the ZeRO
# gauges, the elastic rescale, the recompile counter (strict tracing). The
# comms ledger is on both sides' lines; the fleet aggregate is off on both.
NOT_PORTED = ("overlap/zero", "hbm_model_peak_bytes", "rescale/", "compile_cache_misses")


def _port_config(workdir, **kw):
    return pc.TrainConfig(moco=pc.MocoConfig(**MOCO), optim=pc.OptimConfig(**OPTIM),
                          data=pc.DataConfig(**DATA), workdir=workdir, fleet_metrics=False,
                          **{**OBS, **kw})


def _lines(workdir, name="metrics.jsonl"):
    with open(os.path.join(workdir, name)) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port run of 4 steps (one epoch) on the same config."""
    root = tmp_path_factory.mktemp("obs_driver")
    # both drivers write `io_retries` once their process-wide retry ledger
    # holds a count; tests that ran earlier in this process may have left one
    jax_retry.snapshot(reset=True)
    port_retry.snapshot(reset=True)
    jcfg = jc.TrainConfig(moco=jc.MocoConfig(**MOCO), optim=jc.OptimConfig(**OPTIM),
                          data=jc.DataConfig(**DATA), parallel=jc.ParallelConfig(num_data=1),
                          workdir=str(root / "jax"), fleet_metrics=False, **OBS)
    jax_train(jcfg, dataset=JaxSynthetic(num_examples=64, image_size=16))
    pdir = str(root / "port")
    out = train(_port_config(pdir), dataset=SyntheticDataset(64, 16), device="cpu",
                num_filters=NF)
    return str(root / "jax"), pdir, out


def test_training_lines_carry_jax_key_set(runs):
    jdir, pdir, out = runs
    jlines = [r for r in _lines(jdir) if "loss" in r]
    plines = [r for r in _lines(pdir) if "loss" in r]
    assert [r["step"] for r in plines] == [r["step"] for r in jlines] == [1, 2, 3, 4]
    for j, p in zip(jlines, plines):
        want = {k for k in j if not k.startswith(NOT_PORTED)}
        assert set(p) == want, (set(p) ^ want)
        assert validate_line(p) == [] and jax_validate_line(p) == [], p
    # the probe's split from the first sampled step (0) on; no card: null memory
    assert all(r["t_dispatch"] >= 0 and r["t_device"] >= 0 for r in plines)
    assert all(r["hbm_live_bytes"] is None and r["hbm_state_bytes"] > 0 for r in plines)
    assert [("step_ms" in r) for r in out["history"]] == [True, False, True, False]
    with open(os.path.join(pdir, "metrics.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [r["step"] for r in _lines(pdir)]
    for row, line in zip(rows, _lines(pdir)):
        for k, v in line.items():
            if k == "time":  # each sink stamps its own write, as in JAX
                continue
            cell = (json.dumps(v) if isinstance(v, (list, dict))
                    else "" if v is None else str(v))
            assert row[k] == cell, k


def test_trace_json_nests_and_samples(runs):
    _, pdir, _ = runs
    with open(os.path.join(pdir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    with open(os.path.join(pdir, "trace_events.jsonl")) as f:
        assert len(f.readlines()) == len(events)
    epochs = [e for e in events if e["name"] == "epoch"]
    assert len(epochs) == 1
    ep = epochs[0]
    inner = [e for e in events if e["name"] in ("step", "data_wait", "device_wait")]
    for e in inner:
        assert e["tid"] == ep["tid"] and ep["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= ep["ts"] + ep["dur"] + 0.2
    assert sorted(e["args"]["step"] for e in inner if e["name"] == "step") == [0, 1, 2, 3]
    # sampled steps 0 and 2: a wait before the step and one after its dispatch
    assert sorted(e["args"]["step"] for e in inner if e["name"] == "device_wait") == [0, 0, 2, 2]
    names = {e["name"] for e in events}
    assert {"host_decode", "augment_dispatch", "transfer", "checkpoint_save"} <= names


def test_obs_report_renders_the_port_workdir(runs):
    _, pdir, _ = runs
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "obs_report.py"), pdir,
                           "--strict"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "t_dispatch" in proc.stdout or "dispatch" in proc.stdout


def _history(tmp_path, name, probe_every, **kw):
    cfg = dataclasses.replace(_port_config(None, obs_probe_every=probe_every, **kw),
                              optim=pc.OptimConfig(**{**OPTIM, "epochs": 2}))
    return train(cfg, dataset=SyntheticDataset(64, 16), device="cpu", num_filters=NF)


def test_losses_are_bit_equal_with_and_without_probe_waits(tmp_path):
    """Two epochs of 4 steps: the records' loss, accuracies and lr, and the
    final queue pointer and step, with a wait around every step and with
    none."""
    every, never = (_history(tmp_path, n, p) for n, p in (("every", 1), ("never", 0)))
    key = lambda out: [(r["step"], r["loss"], r["acc1"], r["acc5"], r["lr"])
                       for r in out["history"]]
    assert key(every) == key(never) and len(every["history"]) == 8
    assert all("step_ms" in r for r in every["history"])
    assert not any("step_ms" in r for r in never["history"])
    assert (every["state"].queue_ptr, every["state"].step) == (
        never["state"].queue_ptr, never["state"].step)


@pytest.mark.parametrize("probe_every,want", [
    # window depth 2: steps 1 and 6 are log steps (the epoch's first and
    # last), read one dispatch late; steps 2-5 leave the window at 4, 5, 6
    (0, ["log", "window", "window", "window", "log"]),
    # every step sampled: a wait before it (the steps in flight, then its
    # batch) and one after its dispatch; nothing is left for the window
    (1, ["probe"] * 18),
])
def test_the_loop_waits_only_at_the_window_log_steps_and_samples(tmp_path, monkeypatch,
                                                                  probe_every, want):
    waits = []
    real = train_module._wait

    def counting(target, why):
        waits.append(why)
        return real(target, why)

    monkeypatch.setattr(train_module, "_wait", counting)
    cfg = dataclasses.replace(_port_config(None, obs_probe_every=probe_every),
                              log_every=100, steps_per_epoch=6)
    out = train(cfg, dataset=SyntheticDataset(96, 16), device="cpu", num_filters=NF)
    assert len(out["history"]) == 6
    assert waits == want


def test_telemetry_cli_flags_reach_train_as_in_jax(monkeypatch, tmp_path):
    """--sinks, --metrics-port, --metrics-host and --obs-probe-every give the
    port's config the values the repo-root train.py gives JAX's, and
    --profile-dir / --profile-steps reach train() as JAX's driver gets
    them; the defaults are JAX's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_train_cli",
                                                  os.path.join(REPO, "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    flags = ["--sinks", "jsonl,csv", "--metrics-port", "9300", "--metrics-host", "0.0.0.0",
             "--obs-probe-every", "7"]
    jcfg = cli.config_from_args(cli.build_parser().parse_args(["--preset", "imagenet_v2"] + flags))
    seen = {}
    monkeypatch.setattr(train_module, "train", lambda config, **kw: seen.update(config=config, **kw))
    prof = ["--profile-dir", str(tmp_path), "--profile-steps", "3:5"]
    assert train_module.main(["--preset", "imagenet_v2", "--device", "cpu"] + flags + prof) == 0
    fields = ("sinks", "metrics_port", "metrics_host", "obs_probe_every")
    assert {f: getattr(seen["config"], f) for f in fields} == {
        f: getattr(jcfg, f) for f in fields} == {
        "sinks": "jsonl,csv", "metrics_port": 9300, "metrics_host": "0.0.0.0",
        "obs_probe_every": 7}
    assert (seen["profile_dir"], seen["profile_steps"]) == (str(tmp_path), (3, 5))
    assert {f: getattr(pc.TrainConfig(), f) for f in fields} == {
        f: getattr(jc.TrainConfig(), f) for f in fields}
    with pytest.raises(ValueError, match="profile-steps"):
        train_module.main(["--preset", "imagenet_v2", "--device", "cpu",
                           "--profile-steps", "5:5"])
