"""The port's span tracer, metric sinks, step-time probe and profiler
regions (moco_tpu_torch/obs/{trace,sinks,stepstats}.py,
moco_tpu_torch/utils/metrics.py) held to moco_tpu's on the same inputs on
the CPU: the same span sequence under a fixed clock gives the same span
records and Chrome events; CsvSink files and PrometheusSink text (its
histograms and exemplars included) are byte-equal for the same payloads
(the port's given tensors where JAX's gets arrays); build_sinks names its
files and shifts its ports as JAX's does; StepTimeProbe gives the same
payloads on the same call sequence; memory_payload is all-null on the
CPU; gather_payload makes one host copy for every sink of a MultiSink;
parse_profile_steps accepts and refuses what JAX's does."""

import json
import os
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.obs import sinks as jax_sinks
from moco_tpu.obs import stepstats as jax_stepstats
from moco_tpu.obs import trace as jax_trace
from moco_tpu.utils import metrics as jax_metrics
from moco_tpu_torch.obs import sinks, stepstats, trace
from moco_tpu_torch.utils import metrics


class _Clock:
    """perf_counter / time stand-ins that tick a fixed step per read."""

    def __init__(self, start: float, tick: float):
        self.now, self.tick = start, tick

    def __call__(self) -> float:
        self.now += self.tick
        return self.now


def _span_sequence(mod, path):
    """The same nested spans, instants and counters on a tracer of `mod`."""
    tr = mod.Tracer(path, process_index=1)
    prev = mod.set_tracer(tr)
    try:
        with mod.span("epoch", epoch=0):
            for step in range(3):
                with mod.span("data_wait", step=step):
                    pass
                with mod.span("step", step=step):
                    mod.counter("ring", depth=step)
                    if step == 1:
                        with mod.span("device_wait", step=step):
                            pass
            mod.instant("checkpoint", step=3)
        with pytest.raises(KeyError):
            with mod.span("knn_eval"):
                raise KeyError("x")
    finally:
        mod.set_tracer(prev)
    return tr


def test_tracer_records_and_chrome_events_match_jax(tmp_path, monkeypatch):
    out = {}
    for name, mod in (("port", trace), ("jax", jax_trace)):
        monkeypatch.setattr(time, "perf_counter", _Clock(1000.0, 0.25))
        tr = _span_sequence(mod, str(tmp_path / name / "trace_events.jsonl"))
        tr.export_chrome(str(tmp_path / name / "trace.json"))
        tr.close()
        monkeypatch.undo()
        with open(tmp_path / name / "trace_events.jsonl") as f:
            lines = [json.loads(line) for line in f]
        with open(tmp_path / name / "trace.json") as f:
            chrome = json.load(f)
        chrome["otherData"].pop("wall_t0")
        out[name] = (lines, chrome, tr.snapshot())
    assert out["port"] == out["jax"]
    lines = out["port"][0]
    assert [r["name"] for r in lines if "dur" in r][:3] == ["data_wait", "step", "data_wait"]
    assert next(r for r in lines if r["name"] == "knn_eval")["error"] == "KeyError"
    assert trace.spans_to_chrome_events(lines, pid=3, process_name="h", ts_offset_us=5.0) == \
        jax_trace.spans_to_chrome_events(lines, pid=3, process_name="h", ts_offset_us=5.0)
    assert trace.get_tracer() is None and trace.span("x") is trace.span("y")  # the no-op


def test_tracer_threads_get_their_own_tracks_and_memory_is_bounded(tmp_path):
    tr = trace.Tracer(str(tmp_path / "t.jsonl"), max_spans=3)

    def work():
        with tr.span("host_decode"):
            pass

    threads = [threading.Thread(target=work, name=f"decode-{i}") for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    with tr.span("a"), tr.span("b"):
        pass
    tr.close()
    assert {s["thread"] for s in tr.snapshot()} >= {"decode-0", "decode-1"}
    assert len(tr.snapshot()) == 3 and tr._dropped == 1
    with open(tmp_path / "t.jsonl") as f:
        assert len(f.readlines()) == 4  # the stream is not bounded


def _payloads(device_arrays):
    """Log events with scalars, vectors, a non-finite value, an event, a
    latency histogram with an exemplar, and fields that appear later (the
    CSV header grows); `device_arrays` makes the tensors (port) or arrays
    (JAX) the sinks fetch."""
    hist = {"le": [1.0, 2.5, 5.0], "counts": [3, 0, 2, 1], "sum": 17.5, "count": 6,
            "exemplar": {"request_id": "r0-000004", "latency_ms": 4.25}}
    return [
        (1, {"epoch": 0, "loss": device_arrays(np.float32(2.5)), "acc1": 12.5,
             "queue_age_hist": device_arrays(np.arange(4, dtype=np.float32))}),
        (2, {"epoch": 0, "loss": device_arrays(np.float32(np.nan)), "acc1": 25.0,
             "t_device": 0.125, "flag": True}),
        (3, {"event": "alert", "alert": "slo_burn_fast", "alert/slo_burn_fast": 1}),
        (4, {"serve/latency_hist": hist, "serve/p99_ms": 4.25, "serve/requests": 6}),
    ]


def test_csv_and_prometheus_sinks_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    port_csv = sinks.CsvSink(str(tmp_path / "port"))
    jax_csv = jax_sinks.CsvSink(str(tmp_path / "jax"))
    port_prom = sinks.PrometheusSink(port=0)
    jax_prom = jax_sinks.PrometheusSink(port=0)
    try:
        for (step, p), (_, j) in zip(_payloads(torch.as_tensor), _payloads(jnp.asarray)):
            port_csv.write(step, p)
            jax_csv.write(step, j)
            port_prom.write(step, p)
            jax_prom.write(step, j)
        assert port_prom.render() == jax_prom.render()
        with socket.create_connection(("127.0.0.1", port_prom.port), timeout=10) as s:
            s.sendall(b"GET /metrics HTTP/1.0\r\n\r\n")
            body = b""
            while chunk := s.recv(65536):
                body += chunk
        assert body.decode().endswith(port_prom.render())
    finally:
        port_prom.close()
        jax_prom.close()
    text = port_prom.render()
    assert 'moco_serve_latency_ms_bucket{le="5"} 5 # {request_id="r0-000004"} 4.25' in text
    assert 'moco_events_total{kind="alert"} 1' in text
    with open(port_csv.path) as a, open(jax_csv.path) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("process_index", [0, 2])
def test_build_sinks_names_and_ports_match_jax(tmp_path, process_index):
    for base in ("metrics.jsonl", "metrics.csv", "trace.json", "noext"):
        assert sinks.per_process_filename(base, process_index) == \
            jax_sinks.per_process_filename(base, process_index)
    for serve, metrics_port in ((0, 0), (8000, 0), (8000, 8000), (8000, 7998), (9000, 9100)):
        assert sinks.resolve_serve_port(serve, metrics_port, process_index) == \
            jax_sinks.resolve_serve_port(serve, metrics_port, process_index)
        assert sinks.derive_metrics_port(metrics_port, process_index) == \
            jax_sinks.derive_metrics_port(metrics_port, process_index)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1] - process_index
    names = {}
    for name, mod in (("port", sinks), ("jax", jax_sinks)):
        d = tmp_path / name
        ms = mod.build_sinks("csv", str(d), metrics_port=base if name == "port" else 0,
                             process_index=process_index)
        ms.write(1, {"loss": 1.0})
        if name == "port":
            assert ms.prometheus.port == base + process_index
            assert "moco_loss 1.0" in ms.prometheus.render()
        ms.close()
        names[name] = (sorted(os.listdir(d)), os.path.basename(ms.path),
                       [type(s).__name__ for s in ms.sinks if type(s).__name__ != "PrometheusSink"])
    assert names["port"] == names["jax"]
    with pytest.raises(ValueError, match="unknown metric sink"):
        sinks.build_sinks("jsonl,parquet", str(tmp_path))


def test_tensorboard_sink_writes_or_refuses_as_jax(tmp_path, monkeypatch):
    """Without a writer both raise the same RuntimeError (the writer is
    imported in the constructor, so nothing else needs it)."""
    import builtins

    real_import = builtins.__import__

    def no_tb(name, *args, **kw):
        if name.startswith(("tensorboardX", "torch.utils.tensorboard")):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    errs = []
    for mod in (sinks, jax_sinks):
        with pytest.raises(RuntimeError) as e:
            mod.TensorBoardSink(str(tmp_path))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_multisink_gathers_every_tensor_in_one_copy(tmp_path, monkeypatch):
    """A payload of tensors reaches three sinks through ONE host copy (the
    counterpart of JAX's one device_get), with the values intact; a
    failing secondary sink is reported and the others still write."""
    calls = []
    real = sinks._DEVICE_GET

    def counting(tensors):
        calls.append(len(tensors))
        return real(tensors)

    monkeypatch.setattr(sinks, "_DEVICE_GET", counting)

    class Broken(sinks.Sink):
        def write(self, step, payload):
            raise OSError("disk full")

    jsonl, csv = sinks.JsonlSink(str(tmp_path)), sinks.CsvSink(str(tmp_path))
    ms = sinks.MultiSink([jsonl, csv, Broken()], primary=jsonl)
    ms.write(7, {"loss": torch.tensor(1.5), "hist": torch.arange(3, dtype=torch.int32),
                 "lr": 0.1, "bf": torch.tensor(0.25, dtype=torch.bfloat16)})
    ms.close()
    assert calls == [3]
    with open(jsonl.path) as f:
        rec = json.loads(f.readline())
    assert (rec["loss"], rec["hist"], rec["lr"], rec["bf"]) == (1.5, [0, 1, 2], 0.1, 0.25)
    got = sinks.gather_payload({"a": torch.tensor([1.0, 2.0]), "b": 3})
    assert got["a"].tolist() == [1.0, 2.0] and got["b"] == 3


def test_step_probe_payloads_match_jax():
    seq = [("data_wait", 0.01), ("dispatched", 0.002), ("sample", 0), ("step_done", 0.2),
           ("data_wait", 0.03), ("dispatched", 0.004), ("sample", 1),
           ("device_block", 0.15), ("step_done", 0.18), ("data_wait", 0.02),
           ("dispatched", 0.003), ("sample", 4), ("device_block", 0.11)]
    for every in (0, 2, 4):
        probes = (stepstats.StepTimeProbe(every), jax_stepstats.StepTimeProbe(every))
        for op, arg in seq:
            got = []
            for p in probes:
                if op == "sample":
                    got.append(p.should_sample(arg))
                else:
                    getattr(p, op)(arg)
                got.append(p.payload())
                got.append(p.last_dispatch)
            assert got[: len(got) // 2] == got[len(got) // 2:], (every, op)


def test_memory_payload_is_null_on_the_cpu_and_state_bytes_count_once():
    nulls = {"hbm_live_bytes": None, "hbm_peak_bytes": None, "hbm_headroom_bytes": None}
    assert stepstats.memory_payload("cpu") == nulls
    if not torch.cuda.is_available():
        assert stepstats.memory_payload() == nulls == jax_stepstats.memory_payload()
    a, b = torch.zeros(10), torch.zeros(3, dtype=torch.float64)
    assert stepstats.tree_shard_bytes([a, b, a, "x"]) == 10 * 4 + 3 * 8


@pytest.mark.parametrize("spec", ["0:5", "3:4", "5:5", "7:2", "-1:3", "a:b", "1:2:3", "4"])
def test_parse_profile_steps_matches_jax(spec):
    try:
        want = jax_metrics.parse_profile_steps(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            metrics.parse_profile_steps(spec)
        assert str(got.value) == str(e)
    else:
        assert metrics.parse_profile_steps(spec) == want


def test_profiler_window_records_exactly_its_steps(tmp_path):
    """[2, 4): the capture starts at step 2 and stops at 4, one Chrome trace;
    a region inside it is a no-op; an empty window raises."""
    window = metrics.ProfilerWindow(str(tmp_path), 2, 4)
    started = []
    for step in range(6):
        window.on_step(step)
        started.append(metrics._profiler_state["active"] is not None)
        with metrics.profiler_trace(str(tmp_path / "inner")):
            torch.ones(4).sum()
    window.close()
    assert started == [False, False, True, True, False, False]
    assert os.listdir(tmp_path).count(os.path.basename(window.path)) == 1
    with open(window.path) as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(ValueError, match="empty profile window"):
        metrics.ProfilerWindow(str(tmp_path), 3, 3)
