"""The port's alert engine and heartbeats (moco_tpu_torch/obs/alerts.py,
obs/fleet.py) against moco_tpu/obs/alerts.py and obs/fleet.py on the CPU:
the same rules parsed from the same specs, the same parse errors, and on
the same seeded payload streams (with the same clock) the same fires and
the same alerts.jsonl lines, for every rule kind, the default set and the
heartbeat rule against a stale file; a heartbeat written by either package
read by both. The engines are host code: equality is exact."""

import dataclasses
import json
import os

import numpy as np
import pytest

from moco_tpu.obs import alerts as ja
from moco_tpu.obs import fleet as jf
from moco_tpu_torch.obs import alerts as pa
from moco_tpu_torch.obs import fleet as pf
from moco_tpu_torch.obs.schema import validate_line

SPECS = [
    "default",
    "none",
    "",
    "default,threshold@name=loss_low:field=loss:value=0.5:op=lt",
    "spike@name=s:field=t_step:factor=2:window=8:warmup=4:cooldown=3,"
    "ratio@name=r:num=t_data:den=t_step:value=0.4:consecutive=2:cooldown=2,"
    "threshold@name=t:field=ema_drift:value=0.05:severity=fatal,"
    "event@name=e:event=nonfinite_loss,heartbeat@name=h:timeout=30",
]


def _rules(mod, spec, **kw):
    return [dataclasses.asdict(r) for r in mod.parse_rules(spec, **kw)]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_rules_match_jax(spec):
    assert _rules(pa, spec) == _rules(ja, spec)
    assert _rules(pa, spec, heartbeat_timeout=45.0) == _rules(ja, spec, heartbeat_timeout=45.0)


def test_default_spec_matches_jax():
    assert pa.DEFAULT_SPEC == ja.DEFAULT_SPEC
    assert pa.default_spec(300.0) == ja.default_spec(300.0)
    assert pa.DEFAULT_HEARTBEAT_TIMEOUT == ja.DEFAULT_HEARTBEAT_TIMEOUT
    names = [r["name"] for r in _rules(pa, "default")]
    assert "straggler_skew_high" in names and "nonfinite_loss" in names


@pytest.mark.parametrize("spec", [
    "bogus@name=x", "threshold@field=x:value=1", "threshold@name=x:value=1",
    "ratio@name=x:num=a", "event@name=x", "threshold@name=x:field=f:op=eq",
    "threshold@name=x:field=f:severity=page", "spike@name=x:field=f:colour=red",
    "event@name=x:event=a,event@name=x:event=b",
])
def test_parse_errors_match_jax(spec):
    with pytest.raises(ValueError) as theirs:
        ja.parse_rules(spec)
    with pytest.raises(ValueError) as ours:
        pa.parse_rules(spec)
    assert str(ours.value) == str(theirs.value)


def _stream(seed: int, n: int = 120):
    """A seeded payload stream that crosses every rule: step-time spikes,
    data-starved stretches, drift and staleness excursions, straggler
    skew, and non-finite and stall events."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.08:
            out.append({"event": rng.choice(["nonfinite_loss", "stall", "preempt"]).item(),
                        "nan_steps": int(i)})
            continue
        t_step = float(0.2 * (1 + 0.1 * rng.standard_normal()))
        if rng.random() < 0.07:
            t_step *= 5.0
        starved = (i // 10) % 3 == 1
        out.append({
            "loss": float(rng.random() * 5),
            "t_step": t_step,
            "t_data": t_step * (0.8 if starved else 0.1),
            "ema_drift": float(0.6 if rng.random() < 0.1 else 0.02),
            "queue_age_max": float(rng.choice([256.0, 5000.0])),
            "straggler_skew": float(rng.random()),
        })
    return out


def _run(mod, spec, stream, workdir):
    engine = mod.AlertEngine(mod.parse_rules(spec), workdir=str(workdir))
    fired = [engine.observe(i + 1, payload, now=1000.0 + i) for i, payload in enumerate(stream)]
    engine.close()
    return fired, mod.read_alerts(os.path.join(str(workdir), "alerts.jsonl"))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spec", [SPECS[0], SPECS[3], SPECS[4]])
def test_engine_fires_like_jax(tmp_path, seed, spec):
    """The same fires, step by step, and the same alerts.jsonl lines; the
    stream fires every rule kind but the heartbeat's (below)."""
    stream = _stream(seed)
    theirs = _run(ja, spec, stream, tmp_path / "jax")
    ours = _run(pa, spec, stream, tmp_path / "port")
    assert ours == theirs
    kinds = {a["kind"] for step in ours[0] for a in step}
    assert kinds >= {"spike", "threshold", "ratio", "event"}
    assert ours[1] == [a for step in ours[0] for a in step]


def test_queue_stale_seconds_is_derived(tmp_path):
    payload = {"queue_age_max": 300.0, "t_step": 2.5}
    for mod in (pa, ja):
        engine = mod.AlertEngine(mod.parse_rules("default"))
        (alert,) = engine.observe(7, payload, now=1.0)
        assert (alert["rule"], alert["value"], alert["threshold"]) == ("queue_stale", 750.0, 600)


def test_heartbeat_rule_against_a_stale_file(tmp_path):
    """Process 0 fires once for another process whose heartbeat is older
    than the timeout, not again until it beats, then again when it goes
    stale anew; its own file never counts. Both engines alike."""
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        pf.Heartbeat(str(d), process_index=0).beat(step=5)
        (d / "heartbeat.p1.json").write_text(json.dumps({"process": 1, "host": "h1",
                                                         "time": 1000.0, "step": 3}))
    fires = {}
    for mod, name in ((ja, "jax"), (pa, "port")):
        d = tmp_path / name
        engine = mod.AlertEngine(mod.parse_rules("heartbeat@name=hb:timeout=30"), workdir=str(d))
        seen = [engine.observe(1, {}, now=1010.0), engine.observe(2, {}, now=1040.0),
                engine.observe(3, {}, now=1050.0)]
        (d / "heartbeat.p1.json").write_text(json.dumps({"process": 1, "host": "h1",
                                                         "time": 1045.0, "step": 9}))
        seen += [engine.observe(4, {}, now=1050.0), engine.observe(5, {}, now=1100.0)]
        engine.close()
        fires[name] = (seen, mod.read_alerts(str(d / "alerts.jsonl")))
    assert fires["port"] == fires["jax"]
    counts = [len(f) for f in fires["port"][0]]
    assert counts == [0, 1, 0, 0, 1]
    assert fires["port"][0][1][0]["severity"] == "warn" and "h1" in fires["port"][0][1][0]["message"]
    other = pa.AlertEngine(pa.parse_rules("default"), workdir=str(tmp_path / "port"),
                           process_index=1)
    assert other.observe(1, {}, now=1e9) == []  # only process 0 watches heartbeats


def test_alert_event_line_passes_the_schema():
    line = {"step": 4, "time": 1.0, "epoch": 0, "event": "alert", "alert": "nonfinite_loss",
            "severity": "warn", "alert/nonfinite_loss": 1}
    assert validate_line(line) == []
    assert validate_line({**line, "severity": "page"}) != []
    assert validate_line({**line, "alert/nonfinite_loss": "x"}) != []


@pytest.mark.parametrize("writer,reader", [(pf, jf), (jf, pf), (pf, pf)])
def test_heartbeat_round_trip(tmp_path, writer, reader):
    """A heartbeat file written by one package reads back in the other: the
    same record, replaced atomically (no temporary left)."""
    hb = writer.Heartbeat(str(tmp_path), process_index=2, trace_wall_t0=12.5)
    hb.beat(step=7, epoch=1, note="x")
    assert hb.path == pf.heartbeat_path(str(tmp_path), 2) == jf.heartbeat_path(str(tmp_path), 2)
    recs = reader.read_heartbeats(str(tmp_path))
    assert set(recs) == {2}
    rec = recs[2]
    assert (rec["process"], rec["step"], rec["epoch"], rec["trace_wall_t0"], rec["note"]) == (
        2, 7, 1, 12.5, "x")
    assert rec["pid"] == os.getpid() and rec["time"] > 0
    assert not os.path.exists(hb.path + ".tmp")
    (tmp_path / "heartbeat.p9.json").write_text("{torn")
    assert set(reader.read_heartbeats(str(tmp_path))) == {2}
