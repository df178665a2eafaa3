"""The port's fleet router (moco_tpu_torch/serve/router.py) and critical-path
analyser (moco_tpu_torch/obs/critpath.py) against moco_tpu's.

Each case drives JAX's `FleetRouter` and the port's through the same
script, each in front of its own pair of the stdlib fake replicas of
tests/test_router.py (imported, not copied), and compares what a client
and an operator see: the response bodies (all but the trace ids), the
status codes and headers, the counters of `stats()`, the `/admin/*`
answers. Every line a router flushes passes both packages' schemas.

Where a case depends on time, it is held still: the breakers run on an
injected clock, a breaker that must stay open has a cooldown far past the
case, and the hedged replica sleeps 15x the hedge delay. The breaker's
state trace, critpath on the JAX router's own stitched records and the
schema's fleet and promotion families are compared directly.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from moco_tpu.obs import critpath as jax_critpath
from moco_tpu.obs import schema as jax_schema
from moco_tpu.serve import router as jax_router
from moco_tpu.utils import retry as jax_retry
from moco_tpu_torch.obs import critpath, schema
from moco_tpu_torch.serve import router
from moco_tpu_torch.utils import retry
from tests.test_router import FakeReplica, _get, _post

MODULES = {"jax": jax_router, "port": router}
# keys of a stats() line that depend on wall time, not on the requests
TIMED = ("fleet_serve/qps", "fleet_serve/p50_ms", "fleet_serve/p99_ms",
         "fleet_serve/hedge_wasted_ms", "fleet_serve/critpath_", "fleet_serve/burn_rate_")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _ListSink:
    """A metrics sink that keeps each flushed line, as JsonlSink writes it."""

    def __init__(self):
        self.lines = []
        self._lock = threading.Lock()

    def write(self, step, payload):
        with self._lock:
            self.lines.append({"step": int(step), "time": time.time(), **payload})


def _counters(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if k.startswith("fleet_serve/") and not k.startswith(TIMED)}


def _strip(body):
    """A response body without its ids of one run (the router's trace id)."""
    if isinstance(body, dict):
        return {k: v for k, v in body.items() if k != "trace_id"}
    return body


def _with_router(mod, fakes, sink, **kw):
    opts = dict(slo_ms=1000.0, health_interval_s=0.1, retry_attempts=3,
                retry_base_delay_s=0.01, retry_max_delay_s=0.05, hedge=False,
                breaker_fail_threshold=2, breaker_cooldown_s=0.2, drain_timeout_s=5.0,
                sink=sink, metrics_flush_s=0.1)
    opts.update(kw)
    return mod.FleetRouter(replica_urls=[f.url for f in fakes], **opts)


def _post_status(url, path="/embed"):
    try:
        status, body = _post(url, path)
        return status, body, None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _admin(url, path):
    req = urllib.request.Request(url + path, data=b"")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- the cases: each returns what a client and an operator saw -------------


def _dispatch(mod, fakes, r, url):
    bodies = [_strip(_post(url)[1]) for _ in range(8)]
    return {"bodies": bodies, "healthz": _get(url, "/healthz"),
            "requests": [f.count("requests") for f in fakes]}


def _retry_dead(mod, fakes, r, url):
    fakes[0].set(fail_next=100)  # replica 0 answers 500 to everything
    bodies = [_strip(_post(url)[1]) for _ in range(8)]
    snaps = _get(url, "/admin/replicas")["replicas"]
    return {"bodies": bodies, "breakers": [s["breaker"] for s in snaps],
            "trips": [s["breaker_trips"] for s in snaps]}


def _half_open(mod, fakes, r, url):
    clock = _Clock()
    for rep in r._replicas:
        rep.breaker._now = clock
    fakes[0].set(fail_next=100)
    first = [_strip(_post(url)[1]) for _ in range(6)]
    opened = r.stats()["fleet_serve/breaker_open"]
    fakes[0].set(fail_next=0)  # replica 0 heals; its cooldown passes
    clock.t = 1.0
    probe = _strip(_post(url)[1])
    closed = r.stats()["fleet_serve/breaker_open"]
    after = [_strip(_post(url)[1]) for _ in range(6)]
    return {"first": first, "opened": opened, "probe": probe, "closed": closed,
            "after": after}


def _hedge(mod, fakes, r, url):
    t0 = time.perf_counter()
    status, body = _post(url)
    return {"status": status, "body": _strip(body), "fast": time.perf_counter() - t0 < 1.2}


def _shed(mod, fakes, r, url):
    outcomes, lock = [], threading.Lock()
    barrier = threading.Barrier(6)

    def worker():
        barrier.wait()
        got = _post_status(url)
        with lock:
            outcomes.append(got)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    shed = sorted((code, json.dumps(_strip(body), sort_keys=True), ra)
                  for code, body, ra in outcomes if code != 200)
    return {"answered": len(outcomes), "ok": sum(code == 200 for code, _, _ in outcomes),
            "shed": shed}


def _drain(mod, fakes, r, url):
    failures, stop, lock = [], threading.Event(), threading.Lock()

    def traffic():
        while not stop.is_set():
            try:
                _post(url)
            except Exception as e:  # a dropped request is the failure counted
                with lock:
                    failures.append(repr(e))
            time.sleep(0.01)

    threads = [threading.Thread(target=traffic) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        code, body = _admin(url, "/admin/drain?replica=0&restart=0")
        accepted = (code, body["accepted"], sorted(body["replica"]))

        def phase():
            snaps = _get(url, "/admin/replicas")["replicas"]
            return next(s for s in snaps if s["index"] == 0)["drain_phase"]

        drained = _wait(lambda: phase() == "drained")
        settled = fakes[0].count("requests")
        time.sleep(0.3)
        idle = fakes[0].count("requests") == settled
        fakes[0].set(draining=False)
        code_u, body_u = _admin(url, "/admin/undrain?replica=0")
        readmitted = _wait(lambda: fakes[0].count("requests") > settled)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    return {"accepted": accepted, "drained": drained, "idle": idle,
            "undrain": (code_u, body_u["replica"]["draining"], body_u["replica"]["drain_phase"]),
            "readmitted": readmitted, "failures": failures,
            "fake_draining": fakes[0].count("draining")}


def _refusals(mod, fakes, r, url):
    out = {q: _admin(url, q) for q in (
        "/admin/drain?replica=7", "/admin/drain", "/admin/undrain?replica=x",
        "/admin/promote?replica=1", "/admin/promote?ckpt_dir=/x",
        "/admin/promote?replica=9&ckpt_dir=/x", "/admin/promote?replica=1&ckpt_dir=/x")}
    out["first"] = r.drain_replica(0, restart=False)
    out["second"] = r.drain_replica(0, restart=False)  # already draining
    return out


# case -> (script, per-replica latency s, router options, counters that
# count the load rather than the case)
CASES = {
    "dispatch": (_dispatch, {}, {}, ()),
    # a cooldown far past the case: replica 0's breaker stays open
    "retry_dead": (_retry_dead, {}, {"breaker_cooldown_s": 600.0}, ()),
    "half_open": (_half_open, {}, {"breaker_cooldown_s": 0.5}, ()),
    # the slow primary sleeps 15x the hedge delay
    "hedge": (_hedge, {0: 1.5}, {"hedge": True, "hedge_min_ms": 100.0}, ()),
    "shed": (_shed, {0: 1.0, 1: 1.0}, {"max_inflight": 2, "shed_retry_after_s": 2.0,
                                       "slo_ms": 5000.0}, ()),
    # three client threads as fast as the fleet answers
    "drain": (_drain, {}, {}, ("fleet_serve/requests", "fleet_serve/dispatch_0",
                               "fleet_serve/dispatch_1")),
    "refusals": (_refusals, {}, {}, ()),
}


def _run(mod, case):
    fn, latency, kw, load = CASES[case]
    fakes = [FakeReplica(i, latency_s=latency.get(i, 0.0)) for i in range(2)]
    sink = _ListSink()
    (jax_retry if mod is jax_router else retry).snapshot(reset=True)
    r = _with_router(mod, fakes, sink, **kw)
    url = f"http://127.0.0.1:{r.port}"
    try:
        seen = fn(mod, fakes, r, url)
        seen["counters"] = {k: v for k, v in _counters(r.stats()).items() if k not in load}
    finally:
        r.close()
        for f in fakes:
            f.close()
    return seen, sink.lines


def _check_retry_dead(seen):
    assert all(b["replica"] == 1 for b in seen["bodies"])
    c = seen["counters"]
    assert c["fleet_serve/breaker_trips"] == 1 and c["fleet_serve/retries"] == 2
    assert c["fleet_serve/failed"] == 0 and seen["breakers"][0] == router.BREAKER_OPEN


def _check_half_open(seen):
    assert seen["opened"] == 1 and seen["closed"] == 0 and seen["probe"]["replica"] == 0
    assert {b["replica"] for b in seen["after"]} == {0, 1}


def _check_hedge(seen):
    assert seen["body"]["replica"] == 1 and seen["fast"]
    assert seen["counters"]["fleet_serve/hedges"] == 1
    assert seen["counters"]["fleet_serve/hedge_wins"] == 1


def _check_shed(seen):
    assert seen["answered"] == 6 and seen["ok"] == 2 and len(seen["shed"]) == 4
    assert all(code == 503 and ra == "2" for code, _, ra in seen["shed"])
    assert seen["counters"]["fleet_serve/shed"] == 4


def _check_drain(seen):
    assert seen["failures"] == [] and seen["drained"] and seen["idle"] and seen["readmitted"]
    assert seen["counters"]["fleet_serve/drains"] == 1


def _check_dispatch(seen):
    assert {b["replica"] for b in seen["bodies"]} == {0, 1}
    assert all(b["request_id"].startswith(f"r{b['replica']}-") for b in seen["bodies"])


def _check_refusals(seen):
    assert seen["first"] is True and seen["second"] is False
    assert seen["/admin/promote?replica=1&ckpt_dir=/x"][0] == 409


CHECKS = {"dispatch": _check_dispatch, "retry_dead": _check_retry_dead,
          "half_open": _check_half_open, "hedge": _check_hedge, "shed": _check_shed,
          "drain": _check_drain, "refusals": _check_refusals}


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_case_matches_jax(case):
    """The two routers run the case at once, each on its own fakes."""
    runs = {}

    def run(name):
        runs[name] = _run(MODULES[name], case)

    threads = [threading.Thread(target=run, args=(name,)) for name in MODULES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    (got, lines), (want, jax_lines) = runs["port"], runs["jax"]
    assert got == want
    CHECKS[case](got)
    assert lines and jax_lines
    for line in lines:
        assert schema.validate_line(line) == [], line
        assert jax_schema.validate_line(line) == [], line


def test_router_needs_a_replica_as_jax():
    for kwargs in ({"replica_urls": []}, {}):
        with pytest.raises(ValueError) as want:
            jax_router.FleetRouter(**kwargs)
        with pytest.raises(ValueError) as got:
            router.FleetRouter(**kwargs)
        assert str(got.value) == str(want.value)


# -- the breaker -----------------------------------------------------------

# name -> (fail_threshold, events); ("t", x) sets the clock to x seconds
BREAKER_EVENTS = {
    "trip_and_reset_streak": (3, ["fail", "fail", "ok", "fail", "fail", "fail", "acquire",
                                  "acquire"]),
    "half_open_single_probe": (1, ["fail", ("t", 1.9), "acquire", ("t", 2.1), "acquire",
                                   "acquire", "ok", "acquire", "acquire"]),
    "exponential_cooldown": (1, ["fail", ("t", 2.5), "acquire", "fail", ("t", 6.4), "acquire",
                                 ("t", 6.6), "acquire", "ok", "fail", ("t", 8.7), "acquire",
                                 "reset", "acquire"]),
    "cooldown_cap_and_stale_success": (1, [
        "fail", "ok", "acquire", ("t", 40.0), "acquire", "fail", ("t", 100.0), "acquire",
        "fail", ("t", 200.0), "acquire", "fail", ("t", 300.0), "acquire", "fail",
        ("t", 329.0), "acquire", ("t", 331.0), "acquire"]),
}


def _breaker_trace(mod, threshold, events):
    clock = _Clock()
    b = mod.CircuitBreaker(fail_threshold=threshold, cooldown_s=2.0, cooldown_cap_s=30.0,
                           now=clock)
    trace = []
    for ev in events:
        got = None
        if isinstance(ev, tuple):
            clock.t = ev[1]
        elif ev == "acquire":
            got = b.try_acquire()
        elif ev == "ok":
            b.record_success()
        elif ev == "fail":
            b.record_failure()
        else:
            b.reset()
        trace.append((ev, got, b.state, b.trips, b.consecutive_failures, b._open_until))
    return trace


@pytest.mark.parametrize("name", sorted(BREAKER_EVENTS))
def test_breaker_state_trace_matches_jax(name):
    got = _breaker_trace(router, *BREAKER_EVENTS[name])
    assert got == _breaker_trace(jax_router, *BREAKER_EVENTS[name])
    assert {s for *_, s, _, _, _ in got} >= {router.BREAKER_OPEN}


# -- critpath on the JAX router's stitched records --------------------------


@pytest.fixture(scope="module")
def jax_records():
    """Stitched records from the JAX router's flight ring: plain wins, a
    failed first round then a win, a hedge win with its cancelled lane."""
    fakes = [FakeReplica(0, latency_s=0.02), FakeReplica(1, latency_s=0.02)]
    r = _with_router(jax_router, fakes, None, hedge=False)
    url = f"http://127.0.0.1:{r.port}"
    hedged = None
    try:
        for _ in range(4):
            _post(url)
        fakes[0].set(fail_next=1)
        fakes[1].set(fail_next=1)
        _post(url)
        # the next primary (fewest dispatches, then the lower index) is slow
        slow = min(range(2), key=lambda i: (r._replicas[i].dispatched, i))
        r.hedge, r.hedge_min_ms = True, 50.0
        fakes[slow].set(latency_s=0.6)
        fakes[1 - slow].set(latency_s=0.0)
        _post(url)
        hedged = _wait(lambda: len(_get(url, "/debug/flight")["requests"]) >= 6)
        recs = _get(url, "/debug/flight")["requests"]
    finally:
        r.close()
        for f in fakes:
            f.close()
    assert hedged and len(recs) == 6
    return recs


def test_critpath_matches_jax_on_router_records(jax_records):
    outcomes = {a["outcome"] for rec in jax_records for a in rec["attempts"]}
    assert outcomes == {"ok", "failed", "cancelled"}
    attrs, want_attrs = [], []
    for rec in jax_records:
        got, want = critpath.attribute(rec), jax_critpath.attribute(rec)
        assert got.keys() == want.keys() and got["hops"].keys() == want["hops"].keys()
        for hop in want["hops"]:
            assert got["hops"][hop] == pytest.approx(want["hops"][hop], abs=1e-9)
        for k in ("total_ms", "retry_failed_ms", "wasted_ms"):
            assert got[k] == pytest.approx(want[k], abs=1e-9)
        assert (got["hedged"], got["hedge_won"], got["attempts"], got["trace_id"]) == (
            want["hedged"], want["hedge_won"], want["attempts"], want["trace_id"])
        assert sum(got["hops"].values()) == pytest.approx(got["total_ms"], abs=1e-6)
        assert critpath.flatten(rec) == jax_critpath.flatten(rec)
        attrs.append(got)
        want_attrs.append(want)
    agg, want_agg = critpath.aggregate(attrs), jax_critpath.aggregate(want_attrs)
    assert json.dumps(agg, sort_keys=True) == json.dumps(want_agg, sort_keys=True)
    assert critpath.aggregate([]) == jax_critpath.aggregate([])
    payload = critpath.metrics_payload(agg)
    want_payload = jax_critpath.metrics_payload(want_agg)
    assert payload.keys() == want_payload.keys()
    for k, v in want_payload.items():
        assert payload[k] == pytest.approx(v, abs=1e-9)
    line = {"step": 1, "time": 0.0, **payload}
    assert schema.validate_line(line) == [] == jax_schema.validate_line(line)


# -- the schema's fleet and promotion families -------------------------------

SCHEMA_LINES = [
    {"fleet_serve/replicas": 2, "fleet_serve/replicas_healthy": 0,
     "fleet_serve/slo_objective": 0.99, "fleet_serve/hedge_wasted_ms": 12.5,
     "fleet_serve/model_skew": None, "fleet_serve/p99_ms": None,
     "fleet_serve/burn_rate_60s_max": 0.0, "fleet_serve/critpath_net_send_ms": 1.0},
    {"fleet_serve/replicas": 0},
    {"fleet_serve/replicas_healthy": -1},
    {"fleet_serve/slo_objective": 1.0},
    {"fleet_serve/hedge_wasted_ms": -1.0},
    {"fleet_serve/model_skew": 1.5},
    {"fleet_serve/burn_rate_60s_mean": -0.1},
    {"fleet_serve/fresh_burn_rate_60s_min": -2},
    {"fleet_serve/critpath_router_other_ms": -0.5},
    {"fleet_serve/dispatch_0": "x"},
    {"event": "promotion", "promotion/verdict": "rejected", "promotion/stage": "gates",
     "promotion/digest": "abc", "promotion/failed_gate": "compat_cosine",
     "promotion/replica": None, "promotion/step": 3, "promotion/gate/compat_cosine": 0.2,
     "promotion/floor/compat_cosine": 0.9, "promotion/gate_ok/compat_cosine": 0},
    {"event": "promotion", "promotion/verdict": "shipped"},
    {"promotion/stage": 3},
    {"promotion/digest": 7},
    {"promotion/replica": 1.5},
    {"promotion/step": None},
    {"promotion/gate/feature_std": "low"},
]


@pytest.mark.parametrize("i", range(len(SCHEMA_LINES)))
def test_schema_fleet_and_promotion_families_match_jax(i):
    line = {"step": 1, "time": 0.0, **SCHEMA_LINES[i]}
    got, want = schema.validate_line(line), jax_schema.validate_line(line)
    assert got == want
    assert (got == []) == (i in (0, 10))


# -- serve_ingest --fanout through a router ----------------------------------


def _fanout(ingest, retry_mod, monkeypatch):
    fakes = [FakeReplica(0), FakeReplica(1)]
    r = _with_router(router, fakes, None)
    url = f"http://127.0.0.1:{r.port}"
    rows = np.ones((7, 4), np.float32)
    try:
        topo = ingest.discover_replicas(url)
        first = ingest.fanout_rows(url, rows, ckpt_step=5)
        landed = [(f.count("ingested"), f.count("ingest_ckpt_step")) for f in fakes]
        # replica 1 down: its block is reported lost (None), replica 0 gets it
        monkeypatch.setenv("MOCO_IO_RETRIES", "2")
        monkeypatch.setenv("MOCO_IO_RETRY_BASE", "0.01")
        retry_mod.snapshot(reset=True)
        fakes[1].close()
        second = ingest.fanout_rows(url, rows, block=4)
        sites = retry_mod.snapshot(reset=True)
        fakes[1] = FakeReplica(1)
    finally:
        r.close()
        for f in fakes:
            f.close()
    ports = {i: u.rsplit(":", 1)[1] for i, u in topo.items()}
    return {"topo": sorted(topo), "ports_are_fakes": len(set(ports.values())) == 2,
            "first": first, "landed": landed, "second": second, "sites": sites}


def test_fanout_lands_on_every_replica_as_jax(monkeypatch):
    from moco_tpu_torch.serve import serve_ingest
    from tests.conftest import load_script

    got = _fanout(serve_ingest, retry, monkeypatch)
    want = _fanout(load_script("serve_ingest.py"), jax_retry, monkeypatch)
    assert got == want
    assert got["first"] == {0: 7, 1: 7} and got["landed"] == [(7, 5), (7, 5)]
    assert got["second"] == {0: 14, 1: None}
    assert got["sites"] == {"ingest.post.r1": 1}
