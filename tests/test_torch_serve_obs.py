"""Request-scoped serving observability of the port (moco_tpu_torch/obs/
{reqtrace,ctxprop,slo,flight}.py, the batcher's stage stamps, the
engine's `stages` split, the server's request ids, `/debug/flight`, SLO
burn alerts and the recall estimator, the `slow@` fault) on the CPU, each
held against its moco_tpu counterpart on the same inputs: the waterfall
and the backdated ingress, replica-scoped ids, the burn math under a fixed
clock, the alert specs, the flight recorder's bounds and `slowest`, the
batcher's stage split in the payload, tracing off making no trace, the
`slow` grammar and its firing, the chaos capture over HTTP (an injected
slow engine stage -> a burn alert -> a flight dump that blames that
stage), `X-Trace-Id` adoption, and the recall estimate on an index whose
approximate tier disagrees with the exact one by construction. Exact
equality throughout, but for host sleeps, which are held to lower bounds."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from moco_tpu.obs import ctxprop as jax_ctxprop
from moco_tpu.obs import flight as jax_flight
from moco_tpu.obs import reqtrace as jax_reqtrace
from moco_tpu.obs import slo as jax_slo
from moco_tpu.obs.schema import validate_line as jax_validate_line
from moco_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
from moco_tpu.utils import faults as jax_faults
from moco_tpu_torch.obs import ctxprop, flight, reqtrace, schema, slo
from moco_tpu_torch.obs.alerts import read_alerts
from moco_tpu_torch.obs.sinks import JsonlSink
from moco_tpu_torch.serve.batcher import ContinuousBatcher
from moco_tpu_torch.serve.server import ServeServer
from moco_tpu_torch.utils import faults


# -- reqtrace ------------------------------------------------------------


def _stamped(mod):
    tr = mod.RequestTrace("r0-000042", rows=3, replica=0, t0=100.0)
    for stage, a, b in (("ingress", 100.0, 100.001), ("queue_wait", 100.001, 100.011),
                        ("engine_execute", 100.011, 100.031),
                        ("engine_execute", 100.031, 100.041)):
        tr.stamp(stage, a, b)
    return tr


def test_request_trace_waterfall_and_backdated_ingress_match_jax():
    """The same stamps give JAX's stage sums, total and waterfall (its wall
    anchor aside, which reads the clock); a trace backdated to its arrival
    starts its ingress at 0 ms."""
    port, ref = _stamped(reqtrace), _stamped(jax_reqtrace)
    assert port.stage_ms() == ref.stage_ms()
    assert port.stage_ms()["engine_execute"] == pytest.approx(30.0, abs=1e-6)
    assert port.total_ms() == ref.total_ms() == pytest.approx(41.0, abs=1e-6)
    drop = lambda w: {k: v for k, v in w.items() if k != "wall_t0"}
    assert drop(port.waterfall()) == drop(ref.waterfall())
    t_arrival = time.perf_counter()
    time.sleep(0.005)
    tr = reqtrace.RequestTrace("r1-000000", rows=1, replica=1, t0=t_arrival)
    tr.stamp("ingress", t_arrival, time.perf_counter())
    wf = tr.waterfall()
    assert wf["stages"][0]["start_ms"] == 0.0 and wf["stages"][0]["dur_ms"] >= 5.0
    assert reqtrace.STAGES == jax_reqtrace.STAGES


def test_request_ids_unique_and_replica_scoped():
    ids = reqtrace.RequestIdAllocator(replica=2)
    seen, lock = [], threading.Lock()

    def grab():
        got = [ids.new_trace().req_id for _ in range(200)]
        with lock:
            seen.extend(got)

    threads = [threading.Thread(target=grab) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(set(seen)) == 800 and all(r.startswith("r2-") for r in seen)
    ref = jax_reqtrace.RequestIdAllocator(replica=2)
    assert [reqtrace.RequestIdAllocator(2).new_trace().req_id for _ in range(1)] == [
        ref.new_trace().req_id]


def test_request_spans_match_jax():
    """emit_request_spans renders the same `request` and `req/<stage>`
    spans onto a recording tracer."""
    def spans(mod):
        got = []

        class Rec:
            def emit_span(self, name, t0, t1, **kw):
                got.append((name, t0, t1, kw))

        mod.emit_request_spans(Rec(), _stamped(mod), lane=11)
        return got

    assert spans(reqtrace) == spans(jax_reqtrace)


# -- trace context ---------------------------------------------------------


def test_trace_context_parse_and_inject_match_jax():
    good, span = "0123456789abcdef" * 2, "fedcba9876543210"
    for args in ((good, span), (good, None), (good, "xyz"), ("short", span), (None, None)):
        a, b = ctxprop.parse(*args), jax_ctxprop.parse(*args)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.trace_id, a.span_id) == (b.trace_id, b.span_id)
    ctx = ctxprop.TraceContext(good, span)
    assert ctxprop.inject({}, ctx) == jax_ctxprop.inject({}, jax_ctxprop.TraceContext(good, span))


# -- SLO burn rate -------------------------------------------------------


@pytest.mark.parametrize("objective,windows", [(0.9, (10, 100)), (0.99, (10,))])
def test_burn_rate_math_matches_jax(objective, windows):
    """One good/bad sequence under a fixed clock: the same burn rates and
    payload as JAX's tracker at every read, buckets aging out included."""
    trackers = [m.SLOBurnTracker(slo_ms=100, objective=objective, windows=windows)
                for m in (slo, jax_slo)]
    rng = np.random.default_rng(0)
    for i in range(60):
        ok = bool(rng.random() > 0.3)
        for t in trackers:
            t.record(ok, now=1000.0 + i * 0.37)
    for now in (1005.0, 1010.0, 1022.0, 1050.0, 1200.0):
        assert trackers[0].burn_rates(now=now) == trackers[1].burn_rates(now=now)
        assert trackers[0].payload(now=now) == trackers[1].payload(now=now)
    t = slo.SLOBurnTracker(slo_ms=100, objective=0.9, windows=(10, 100))
    for i in range(20):
        t.record(i % 4 != 0, now=1000.0 + i * 0.1)
    assert t.burn_rates(now=1002.0) == {10: pytest.approx(2.5), 100: pytest.approx(2.5)}
    for bad in ({"objective": 1.0}, {"windows": ()}, {"windows": (10, 10)}):
        with pytest.raises(ValueError):
            slo.SLOBurnTracker(100, **bad)


def test_freshness_burn_matches_jax():
    trackers = [m.FreshnessBurnTracker(5.0, objective=0.9, windows=(10, 60))
                for m in (slo, jax_slo)]
    for i, age in enumerate([None, 1.0, 7.0, 4.9, 12.0, 5.0, None, 6.0]):
        for t in trackers:
            t.record(age, now=50.0 + i)
    assert trackers[0].payload(now=58.0) == trackers[1].payload(now=58.0)
    with pytest.raises(ValueError):
        slo.FreshnessBurnTracker(0.0)


@pytest.mark.parametrize("kw", [{}, {"slo_ms": 250.0, "windows": (30, 300)},
                                {"slo_ms": 80.0, "windows": (60,), "fast_burn": 2.0},
                                {"prefix": "fleet_serve", "slow_burn": 3.0}])
def test_alert_specs_equal_jax(kw):
    assert slo.serve_alert_spec(**kw) == jax_slo.serve_alert_spec(**kw)
    fresh = {k: v for k, v in kw.items() if k != "slo_ms"}
    assert slo.fresh_alert_spec(**fresh) == jax_slo.fresh_alert_spec(**fresh)


# -- flight recorder -----------------------------------------------------


def _wf(rid, total_ms, stage="engine_execute"):
    return {"request_id": rid, "replica": 0, "rows": 1, "wall_t0": 0.0, "total_ms": total_ms,
            "stages": [{"stage": stage, "start_ms": 0.0, "dur_ms": total_ms}]}


def test_flight_recorder_bounds_and_slowest_match_jax(tmp_path):
    recs = [m.FlightRecorder(max_requests=4, max_metrics=2) for m in (flight, jax_flight)]
    for fr in recs:
        for i in (3, 9, 1, 7, 0, 8, 2, 6):
            fr.record_request(_wf(f"r0-{i:06d}", float(i)))
        for s in (1, 2, 3):
            fr.record_metrics(s, {"serve/qps": float(s)})
    snaps = [fr.snapshot(top_n=2) for fr in recs]
    for snap in snaps:
        for m in snap["metrics"]:
            m.pop("time")
    assert snaps[0] == snaps[1]
    assert snaps[0]["requests_recorded"] == 4
    assert [r["request_id"] for r in snaps[0]["slowest"]] == ["r0-000008", "r0-000006"]
    path = recs[0].dump(str(tmp_path), reason="test", extra={"k": 1})
    path2 = recs[0].dump(str(tmp_path), reason="again")
    assert path2 != path and os.path.basename(path).startswith("flight_")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    loaded = flight.read_flight_dumps(str(tmp_path))
    assert [p for p, _ in loaded] == [p for p, _ in jax_flight.read_flight_dumps(str(tmp_path))]
    assert loaded[0][1]["reason"] == "test" and loaded[0][1]["k"] == 1
    assert len(loaded[0][1]["requests"]) == 4


# -- the batcher ---------------------------------------------------------


def _echo(images, wn, *, stages=None, engine_s=0.0):
    if engine_s:
        t0 = time.perf_counter()
        time.sleep(engine_s)
        if stages is not None:
            stages["engine_execute"] = stages.get("engine_execute", 0.0) + time.perf_counter() - t0
    return ({"embedding": np.arange(images.shape[0], dtype=np.float32)[:, None]},
            [(images.shape[0], images.shape[0])])


def test_batcher_stage_split_lands_in_the_payload_as_in_jax():
    """One traced 8-row request through each batcher: the same payload keys,
    the engine stage at least the engine's sleep, the exemplar the request's
    id, and the window reset on the next payload."""
    def run_batch(images, wn, *, stages=None):
        return _echo(images, wn, stages=stages, engine_s=0.01)

    payloads = []
    for cls in (ContinuousBatcher, JaxBatcher):
        b = cls(run_batch, max_batch=8, slo_ms=1000, reqtrace=True)
        try:
            b.submit(np.zeros((8, 4, 4, 3), np.uint8)).result(10)
            payloads.append((b.metrics.payload(), b.metrics.payload()))
        finally:
            b.close()
    (p, p2), (j, j2) = payloads
    assert set(p) == set(j) and set(p2) == set(j2)
    assert p["serve/trace_requests"] == 1 and p["serve/trace_engine_execute_ms"] >= 10.0
    assert set(k for k in p if k.startswith("serve/trace_")) == {
        "serve/trace_requests", "serve/trace_queue_wait_ms", "serve/trace_batch_assemble_ms",
        "serve/trace_engine_execute_ms", "serve/trace_scatter_ms"}
    assert p["serve/p99_exemplar"] == "r0-000000" and p["serve/p99_exemplar_ms"] > 0
    assert "serve/trace_engine_execute_ms" not in p2 and p2["serve/p99_exemplar"] is None
    assert schema.validate_line({"step": 1, "time": 0.0, **p}) == []
    assert jax_validate_line({"step": 1, "time": 0.0, **p}) == []


def test_batcher_tracing_off_is_traceless():
    b = ContinuousBatcher(_echo, max_batch=4, slo_ms=1000)
    try:
        fut = b.submit(np.zeros((1, 4, 4, 3), np.uint8))
        fut.result(10)
        assert fut.trace is None
        p = b.metrics.payload()
        assert p["serve/p99_exemplar"] is None and p["serve/latency_hist"]["count"] == 1
        assert not any(k.startswith("serve/trace_") for k in p)
    finally:
        b.close()


def test_batcher_stage_stamps_sum_to_the_wall_under_saturation():
    """Each request's stage durations sum to its measured latency (within
    scheduling slack), and queued requests' queue_wait dominates."""
    def run_batch(images, wn, *, stages=None):
        return _echo(images, wn, stages=stages, engine_s=0.03)

    b = ContinuousBatcher(run_batch, max_batch=4, slo_ms=10_000, reqtrace=True)
    try:
        futs = [b.submit(np.zeros((2, 4, 4, 3), np.uint8)) for _ in range(12)]
        for f in futs:
            f.result(30)
    finally:
        b.close()
    queue = engine = 0.0
    for f in futs:
        ms, lat = f.trace.stage_ms(), f.latency_s * 1e3
        assert abs(sum(ms.values()) - lat) <= max(0.15 * lat, 25.0), (ms, lat)
        queue += ms.get("queue_wait", 0.0)
        engine += ms.get("engine_execute", 0.0)
    assert queue > 2.0 * engine


# -- the slow@ fault -------------------------------------------------------


@pytest.mark.parametrize("spec", ["slow@site=serve.engine_execute:ms=250:at=2:times=3",
                                  "slow@site=serve.scatter:ms=5",
                                  "slow@site=serve.ingress:ms=1.5:times=2,delay@site=x:seconds=1"])
def test_slow_fault_grammar_matches_jax(spec):
    assert faults.FaultPlan(spec).describe() == jax_faults.FaultPlan(spec).describe()
    with pytest.raises(ValueError):
        faults.FaultPlan("slow@site=x:ms=1:bogus=1")


def test_slow_fault_fires_at_the_calls_jax_does(monkeypatch):
    """The same plan, the same call sequence: the same sleeps at the same
    calls (the sleep recorded, not taken); another site never sleeps, and
    a delay@ rule beside it keeps its own schedule."""
    spec = ("slow@site=serve.scatter:ms=40:at=2:times=2,"
            "delay@site=data.read:seconds=0.5:at=1:times=1")
    sleeps = {}
    for name, mod in (("port", faults), ("jax", jax_faults)):
        got = sleeps[name] = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        mod.install(spec)
        try:
            for site in ("serve.scatter", "serve.scatter", "serve.respond", "serve.scatter",
                         "serve.scatter"):
                mod.maybe_slow(site)
            mod.maybe_delay("data.read")
            mod.maybe_delay("data.read")
        finally:
            mod.clear()
    assert sleeps["port"] == sleeps["jax"] == [0.04, 0.04, 0.5]


# -- the server ------------------------------------------------------------


class _TinyEngine:
    """Engine-shaped stub with the engine's fault discipline: the injected
    slow@serve.engine_execute sleep lands inside the engine stage's window;
    `embed_and_query_modes` answers the exact tier with ids 0..k-1 and the
    IVF tiers with ids 0..k-1 but for the last `miss` of them (a forced
    disagreement)."""

    buckets = (1, 4)
    recompiles_after_warmup = 0
    image_size = 4
    miss = 2

    def warmup(self):
        pass

    def warm_bucket(self, bucket):
        return np.zeros((bucket, 4), np.float32)

    def embed(self, images, stages=None):
        t0 = time.perf_counter()
        faults.maybe_slow("serve.engine_execute")
        emb = np.ones((images.shape[0], 4), np.float32) / 2.0
        if stages is not None:
            stages["engine_execute"] = stages.get("engine_execute", 0.0) + time.perf_counter() - t0
        return emb, [(images.shape[0], images.shape[0])]

    def embed_and_query_modes(self, images, index, k, modes=("exact",), nprobe=None,
                              stages=None):
        emb, executed = self.embed(images, stages=stages)
        n = images.shape[0]
        exact = np.tile(np.arange(k, dtype=np.int32), (n, 1))
        approx = exact.copy()
        approx[:, k - self.miss:] += 100
        per_mode = {m: (np.zeros((n, k), np.float32), exact if m == "exact" else approx)
                    for m in modes}
        return emb, per_mode, executed


class _Index:
    count = 128
    recompiles_after_warmup = 0

    def warm(self, feats):
        pass

    def row_age_stats(self):
        return {"row_age_max_s": None, "row_age_mean_s": None}

    def ivf_stats(self):
        return {"trained": True, "spilled": 0, "occupancy": 0.5, "nprobe": 4}


def _post(port, path, imgs, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=imgs.tobytes(),
        headers={"X-Image-Shape": ",".join(map(str, imgs.shape)), **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def test_server_chaos_flight_capture(tmp_path):
    """An injected slow@serve.engine_execute request trips the burn alert;
    the flight dump (and /debug/flight) blames exactly that stage; the
    metrics lines pass both schemas with the whole request surface on
    them; the request spans and their anchor reach the replica's stream;
    every response has a distinct request id."""
    wd = str(tmp_path)
    sink = JsonlSink(wd)
    server = ServeServer(
        _TinyEngine(), index=None, port=0, slo_ms=100.0, sink=sink, metrics_flush_s=0.1,
        workdir=wd, slo_objective=0.9, burn_windows=(10, 60),
        alert_spec="threshold@name=slo_burn_fast:field=serve/burn_rate_10s:value=1.0")
    imgs = np.zeros((2, 4, 4, 3), np.uint8)
    try:
        ids = [_post(server.port, "/embed", imgs)["request_id"] for _ in range(10)]
        faults.install("slow@site=serve.engine_execute:ms=400:at=1:times=2")
        try:
            slowed = [_post(server.port, "/embed", imgs)["request_id"] for _ in range(2)]
        finally:
            faults.clear()
        ids += slowed + [_post(server.port, "/embed", imgs)["request_id"] for _ in range(4)]
        deadline = time.time() + 8.0
        while time.time() < deadline and not flight.read_flight_dumps(wd):
            time.sleep(0.05)
        debug = _get(server.port, "/debug/flight")
    finally:
        server.close()
        sink.close()
    assert len(set(ids)) == 16 and all(i.startswith("r0-") for i in ids)
    assert any(a["rule"] == "slo_burn_fast" for a in read_alerts(os.path.join(wd, "alerts.jsonl")))
    dump = next(rec for _, rec in flight.read_flight_dumps(wd)
                if str(rec.get("reason", "")).startswith("alert:"))
    by_id = {r["request_id"]: r for r in dump["requests"]}
    stage_ms = {s["stage"]: s["dur_ms"] for s in by_id[slowed[0]]["stages"]}
    assert max(stage_ms, key=stage_ms.get) == "engine_execute"
    assert stage_ms["engine_execute"] >= 400.0
    assert [s["stage"] for s in by_id[slowed[0]]["stages"]] == [
        "ingress", "queue_wait", "batch_assemble", "engine_execute", "scatter", "respond"]
    assert debug["dump_path"] and set(slowed) <= {r["request_id"] for r in debug["requests"]}
    assert debug["slowest"][0]["request_id"] in slowed
    lines = schema.read_metrics(os.path.join(wd, "metrics.jsonl"))
    for rec in lines:
        assert schema.validate_line(rec) == [] and jax_validate_line(rec) == [], rec
    assert any(r.get("serve/burn_rate_10s") is not None for r in lines)
    assert any(r.get("serve/p99_exemplar") in slowed for r in lines)
    assert any(r.get("event") == "alert" for r in lines)
    spans = [json.loads(line) for line in open(os.path.join(wd, "trace_events.s0.jsonl"))]
    assert {"request", "req/engine_execute", "req/queue_wait"} <= {s["name"] for s in spans}
    anchor = json.load(open(os.path.join(wd, "heartbeat.s0.json")))
    assert anchor["role"] == "serve" and "trace_wall_t0" in anchor


def test_server_adopts_trace_context_and_samples_recall():
    """`X-Trace-Id` / `X-Parent-Span` make the request a child of the
    sender's span: the response carries the waterfall with both ids; a
    malformed id is served untraced by the context. With an ivf default
    tier and recall_sample_every=2, every second neighbors flush also asks
    the exact tier, and the estimate is the forced overlap (k - miss) / k."""
    tid, parent = "ab" * 16, "cd" * 8
    server = ServeServer(_TinyEngine(), index=_Index(), port=0, slo_ms=1000.0,
                         neighbors_k=5, neighbors_mode="ivf", warmup=False,
                         recall_sample_every=2, metrics_flush_s=0.1)
    imgs = np.zeros((1, 4, 4, 3), np.uint8)
    try:
        out = _post(server.port, "/neighbors", imgs,
                    {"X-Trace-Id": tid, "X-Parent-Span": parent})
        plain = _post(server.port, "/neighbors", imgs, {"X-Trace-Id": "not-hex"})
        for _ in range(4):
            _post(server.port, "/neighbors", imgs)
        stats = _get(server.port, "/stats")
    finally:
        server.close()
    assert out["trace"]["trace_id"] == tid and out["trace"]["parent_span"] == parent
    assert len(out["trace"]["span_id"]) == 16 and out["request_id"] == out["trace"]["request_id"]
    assert "trace" not in plain and plain["request_id"] != out["request_id"]
    assert out["mode"] == "ivf" and out["indices"][0][-1] == 104
    assert stats["serve/recall_estimate"] == pytest.approx((5 - _TinyEngine.miss) / 5)
    assert stats["serve/mode_default"] == 6


def test_server_tracing_off_answers_without_ids():
    server = ServeServer(_TinyEngine(), port=0, slo_ms=1000.0, reqtrace=False, alert_spec="")
    try:
        out = _post(server.port, "/embed", np.zeros((1, 4, 4, 3), np.uint8))
        stats = _get(server.port, "/stats")
    finally:
        server.close()
    assert "request_id" not in out and stats["serve/p99_exemplar"] is None
    assert not any(k.startswith("serve/trace_") for k in stats)
