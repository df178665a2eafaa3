"""The port's runtime analysis arms against JAX's (moco_tpu/analysis):
the lock-order recorder and `deadlock@` (analysis/tsan.py), the
collective-schedule recorder and sanitizer and `diverge@`
(analysis/sanitizer.py), the contract-coverage recorder on a real port
ServeServer, the recompile guard (analysis/runtime.py), and the driver's
four fields on a CPU `train()`."""

import json
import os
import queue
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from moco_tpu.analysis import contracts as jax_cov
from moco_tpu.analysis import runtime as jax_runtime
from moco_tpu.analysis import sanitizer as jax_sanitizer
from moco_tpu.analysis import tsan as jax_tsan
from moco_tpu.obs import schema as jax_schema
from moco_tpu.utils import faults as jax_faults
from moco_tpu_torch.analysis import contracts as cov
from moco_tpu_torch.analysis import runtime
from moco_tpu_torch.analysis import sanitizer
from moco_tpu_torch.analysis import tsan
from moco_tpu_torch.core.moco import build_encoder
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.obs import schema
from moco_tpu_torch.parallel.mesh import World
from moco_tpu_torch.serve.engine import InferenceEngine
from moco_tpu_torch.serve.index import EmbeddingIndex
from moco_tpu_torch.serve.server import ServeServer
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import faults

PACKAGES = {"jax": (jax_tsan, jax_sanitizer, jax_faults), "port": (tsan, sanitizer, faults)}


def _strip(obj):
    """A report or artifact without its stacks, threads and times (the
    call sites differ between the packages' own frames)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("stack", "thread", "time")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# the lock-order recorder


def _lock_sequence(pkg, workdir, spec=None, strict=False, nestings=None):
    tsan_mod, _, faults_mod = PACKAGES[pkg]
    faults_mod.install(spec)
    rec = tsan_mod.LockOrderRecorder(workdir=workdir, strict=strict)
    prev = tsan_mod.install_recorder(rec)
    locks = {n: tsan_mod.make_lock(n) for n in ("obs.trace", "serve.metrics", "serve.index")}
    try:
        for outer, inner in nestings:
            with locks[outer]:
                with locks[inner]:
                    pass
    finally:
        tsan_mod.install_recorder(prev)
        faults_mod.clear()
    return rec


CASES = {
    # three locks nested in a ring: the third nesting closes the cycle
    "ring": (None, [("obs.trace", "serve.metrics"), ("serve.metrics", "serve.index"),
                    ("serve.index", "obs.trace")]),
    # one consistent order: edges, no cycle
    "ordered": (None, [("obs.trace", "serve.metrics"), ("obs.trace", "serve.index"),
                       ("serve.metrics", "serve.index")]),
    # deadlock@site: the inverted edge is recorded at the named lock
    "deadlock": ("deadlock@site=serve.index", [("serve.metrics", "serve.index")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lock_order_recorder_matches_jax(tmp_path, case):
    """The same acquisitions give the same edges, cycles and
    lock_order_diff.json in both packages (stacks aside); each recorded
    edge of a cycle carries its acquiring stack."""
    spec, nestings = CASES[case]
    out = {}
    for pkg in PACKAGES:
        d = str(tmp_path / pkg)
        rec = _lock_sequence(pkg, d, spec, nestings=nestings)
        diff = os.path.join(d, "lock_order_diff.json")
        art = json.load(open(diff)) if os.path.exists(diff) else None
        out[pkg] = (_strip(rec.report()), _strip(art))
        if art is not None:
            assert all(e["stack"] for e in art["edges"]) and art["acquiring"]["stack"]
    assert out["port"] == out["jax"]
    report, art = out["port"]
    assert bool(report["cycles"]) == (case != "ordered") == (art is not None)
    if case == "deadlock":
        assert {(e["held"], e["acquired"], e["injected"]) for e in report["edges"]} == {
            ("serve.metrics", "serve.index", False), ("serve.index", "serve.metrics", True)}


def test_strict_recorder_raises_at_the_closing_acquire(tmp_path):
    for pkg, error in (("port", tsan.LockOrderError), ("jax", jax_tsan.LockOrderError)):
        with pytest.raises(error, match="lock-order cycle"):
            _lock_sequence(pkg, str(tmp_path / pkg), strict=True, nestings=CASES["ring"][1])
        assert os.path.exists(tmp_path / pkg / "lock_order_diff.json")


def test_the_ports_locks_are_traced():
    """Every named lock of the port is a TracedLock; with no recorder it is
    a plain lock."""
    from moco_tpu_torch.obs.comms import CommsLedger
    from moco_tpu_torch.utils import locks

    assert isinstance(CommsLedger()._lock, tsan.TracedLock)
    assert CommsLedger()._lock.name == "obs.comms"
    lock = locks.make_lock("serve.index")
    assert tsan.get_recorder() is None and lock.acquire() and lock.locked()
    lock.release()


def test_profile_hook_records_the_ports_blocking_ops_under_a_lock(tmp_path):
    """Tensor.item(), time.sleep and an untimed queue put under a held
    traced lock land in lock_order.json; outside a lock nothing does."""
    san = tsan.ThreadSanitizer(workdir=str(tmp_path), strict=False, profile=True)
    try:
        lock = tsan.make_lock("serve.metrics")
        torch.ones(1).item()  # no lock held: not recorded
        with lock:
            torch.ones(1).item()
            time.sleep(0)
            queue.Queue().put(1)
            queue.Queue().put(1, timeout=1.0)  # bounded: not a finding
    finally:
        rep = san.close()
    ops = [b["op"] for b in rep["blocking_ops_under_lock"]]
    assert ops.count("Tensor.item()") == 1 and ops.count("time.sleep") == 1
    assert ops.count("put (queue.py)") == 1
    assert all(b["held"] == ["serve.metrics"] for b in rep["blocking_ops_under_lock"])
    assert json.load(open(tmp_path / "lock_order.json"))["cycles"] == []
    assert tsan.get_recorder() is None


# ---------------------------------------------------------------------------
# the collective-schedule sanitizer

SCHEDULE = [("input.h2d", "device_put", "(16, 32, 32, 3):uint8"),
            ("shuffle.gather_images", "all_gather", "(8, 3, 32, 32):float32"),
            ("grad.psum", "psum", "(64,):float32,(8,):float32"),
            ("queue.enqueue_gather", "all_gather", "(8, 16):float32")]


def _feed(rec, steps=3):
    for _ in range(steps):  # eager: every step records again
        for entry in SCHEDULE:
            rec.record(*entry)


@pytest.mark.parametrize("spec", (None, "diverge@site=grad.psum"))
def test_schedule_recorder_matches_jax(spec):
    got = {}
    for pkg, (_, san_mod, faults_mod) in PACKAGES.items():
        faults_mod.install(spec)
        try:
            rec = san_mod.ScheduleRecorder(0)
            _feed(rec)
        finally:
            faults_mod.clear()
        got[pkg] = (rec.entries(), rec.schedule_hash(), rec.payload())
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == len(SCHEDULE)  # first-seen: the hash is not the step count
    assert ("#diverged" in got["port"][0][2][2]) == (spec is not None)


def test_divergent_peer_aborts_both_processes_with_the_same_diff(tmp_path):
    """Process 1 runs diverge@site=grad.psum: once both have published,
    each check raises with a per-site diff and schedule_diff.json, the
    same in both packages; a peer that has not published is skipped."""
    diffs = {}
    for pkg, (_, san_mod, faults_mod) in PACKAGES.items():
        d = str(tmp_path / pkg)
        p0 = san_mod.ScheduleSanitizer(d, process_index=0, num_processes=2)
        p1 = san_mod.ScheduleSanitizer(d, process_index=1, num_processes=2)
        _feed(p0.recorder)
        p0.check(step=1)  # process 1 has not published: skipped
        faults_mod.install("diverge@site=grad.psum")
        try:
            _feed(p1.recorder)
        finally:
            faults_mod.clear()
        for me in (p1, p0):
            with pytest.raises(san_mod.ScheduleDivergenceError, match="grad.psum"):
                me.check(step=2)
            art = json.load(open(os.path.join(d, "schedule_diff.json")))
            diffs.setdefault(pkg, []).append(art)
        assert json.load(open(sanitizer.schedule_path(d, 1)))["hash"] == p1.recorder.schedule_hash()
        assert [f for f in os.listdir(d) if f.endswith(".tmp")] == []
    assert diffs["port"] == diffs["jax"]
    assert diffs["port"][0]["divergent_peers"] == [0] and diffs["port"][1]["divergent_peers"] == [1]


def test_world_collectives_feed_the_recorder_once_per_site():
    """The port records on every eager call; at a world of 1 three steps
    of three collectives leave three entries, and the hash stays put."""
    world = World(device="cpu")
    rec = sanitizer.ScheduleRecorder(0)
    prev = sanitizer.install_recorder(rec)
    hashes = []
    try:
        for _ in range(3):
            x = torch.ones(4, 2)
            world.all_gather_rows(x, site="shuffle.gather_keys")
            world.all_to_all_rows(x, site="shuffle.a2a")
            world.all_reduce_mean_([torch.ones(3), None, torch.ones(2, 2)], site="grad.psum")
            world.all_reduce_mean_([torch.ones(3)])  # no site: not in the schedule
            hashes.append(rec.schedule_hash())
    finally:
        sanitizer.install_recorder(prev)
    assert [e[0] for e in rec.entries()] == ["shuffle.gather_keys", "shuffle.a2a", "grad.psum"]
    assert rec.entries()[2] == ("grad.psum", "psum", "(3,):float32,(2, 2):float32")
    assert len(set(hashes)) == 1
    world.all_gather_rows(torch.ones(1), site="late")  # uninstalled: one None check
    assert len(rec.entries()) == 3


# ---------------------------------------------------------------------------
# contract coverage on a real replica

IMG, DIM, K = 16, 16, 32


@pytest.fixture(scope="module")
def replica():
    cfg = pc.MocoConfig(arch="resnet18", dim=DIM, mlp=True, cifar_stem=True,
                        compute_dtype="float32")
    torch.manual_seed(0)
    engine = InferenceEngine(build_encoder(cfg, num_filters=4).eval(), IMG, buckets=(1, 4),
                             device="cpu")
    index = EmbeddingIndex(K, DIM, device="cpu")
    rows = np.random.default_rng(0).normal(size=(K, DIM)).astype(np.float32)
    index.snapshot(rows / np.linalg.norm(rows, axis=1, keepdims=True))
    return engine, index


def _call(port, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status


def test_coverage_recorder_on_a_port_replica_covers_its_declared_routes(replica):
    """With the recorder installed, one request per declared replica route
    (declared_route_gates("replica"), JAX's list) passes check_coverage;
    the trace headers, the stage fault hooks and the schema validators
    of the replica's own line are counted too."""
    engine, index = replica
    rec = cov.install_recorder()
    srv = ServeServer(engine, index=index, warmup=False, alert_spec="", slo_ms=2000.0)
    try:
        imgs = np.random.default_rng(1).integers(0, 255, (2, IMG, IMG, 3), dtype=np.uint8)
        shape = {"X-Image-Shape": ",".join(map(str, imgs.shape)),
                 "X-Trace-Id": "0123456789abcdef0123456789abcdef",
                 "X-Parent-Span": "0123456789abcdef"}
        for path in ("/healthz", "/stats", "/debug/flight", "/admin/model"):
            assert _call(srv.port, path) == 200
        assert _call(srv.port, "/embed", imgs.tobytes(), shape) == 200
        assert _call(srv.port, "/neighbors", imgs.tobytes(), shape) == 200
        rows = np.eye(2, DIM, dtype=np.float32)
        assert _call(srv.port, "/ingest", rows.tobytes(),
                     {"X-Rows-Shape": "2,16", "X-Ckpt-Step": "3"}) == 200
        schema.validate_line({"step": 1, "time": 0.0, **srv.stats()})
        assert _call(srv.port, "/admin/drain", b"") == 200
    finally:
        srv.close()
        cov.uninstall_recorder()
    snap = rec.snapshot()
    gates = cov.declared_route_gates("replica")
    assert gates == jax_cov.declared_route_gates("replica") and len(gates) == 8
    assert cov.check_coverage(snap, routes=gates, headers=("X-Trace-Id", "X-Parent-Span"),
                              fault_sites=("slow@serve.ingress", "slow@serve.engine_execute",
                                           "kill@replica"),
                              validators=("serve/nprobe", "serve/latency_hist",
                                          "serve/ingested_rows")) == []
    assert cov.check_coverage(snap, routes=["GET /admin/replicas"]) == [
        "route never handled: GET /admin/replicas"]
    merged = cov.merge_coverage([snap, snap])
    assert merged == jax_cov.merge_coverage([snap, snap])
    assert merged["routes"]["POST /embed"] == 2 * snap["routes"]["POST /embed"]


def test_coverage_env_arm_and_fault_callbacks(monkeypatch, tmp_path):
    monkeypatch.delenv("MOCO_CONTRACT_COVERAGE", raising=False)
    assert cov.maybe_install_from_env() is None
    monkeypatch.setenv("MOCO_CONTRACT_COVERAGE", "1")
    rec = cov.maybe_install_from_env()
    try:
        assert cov.get_recorder() is rec
        faults.maybe_delay("data.read")
        faults.diverge_marker("grad.psum")
        faults.deadlock_marker("serve.index")
        cov.record_route("GET", "/stats?x=1")
    finally:
        cov.uninstall_recorder()
    cov.record_route("GET", "/healthz")  # uninstalled: not counted
    snap = rec.dump(str(tmp_path / "c.json"))
    assert snap == json.load(open(tmp_path / "c.json"))
    assert snap["fault_hooks"] == {"delay@data.read": 1, "diverge@grad.psum": 1,
                                   "deadlock@serve.index": 1}
    assert snap["routes"] == {"GET /stats": 1}


_COVERAGE_CHILD = """
import os, signal, sys, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from moco_tpu_torch.analysis import contracts as cov

port, workdir = int(sys.argv[1]), sys.argv[2]
rec = cov.maybe_install_from_env()


class H(BaseHTTPRequestHandler):
    def do_GET(self):
        cov.record_route("GET", self.path)
        body = b'{"ok": true}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


srv = ThreadingHTTPServer(("127.0.0.1", port), H)
signal.signal(signal.SIGTERM, lambda *a: threading.Thread(target=srv.shutdown).start())
srv.serve_forever()
os.makedirs(workdir, exist_ok=True)
cov.dump_merged(rec, os.path.join(workdir, cov.COVERAGE_FILE))
"""


def test_supervisor_run_drops_an_earlier_runs_coverage_and_adds_up_respawns(tmp_path):
    """A slot's dump left in the workdir by an earlier run is removed when
    the supervisor first starts the slot; within the run, each graceful
    life's counts add to the file."""
    from moco_tpu_torch.serve.fleet import ReplicaSupervisor

    script, work = str(tmp_path / "child.py"), str(tmp_path / "fleet")
    with open(script, "w") as f:
        f.write(_COVERAGE_CHILD)
    dump = os.path.join(work, "replica0", cov.COVERAGE_FILE)
    os.makedirs(os.path.dirname(dump))
    with open(dump, "w") as f:
        json.dump({"routes": {"GET /admin/model": 5}}, f)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(__file__)),
           "MOCO_CONTRACT_COVERAGE": "1"}
    sup = ReplicaSupervisor(
        1, workdir=work, env=env, boot_timeout_s=60.0, term_timeout_s=10.0,
        argv_for=lambda i, port: [sys.executable, script, str(port),
                                  os.path.join(work, f"replica{i}")])
    try:
        sup.start()
        assert not os.path.exists(dump)
        for n in (2, 3):
            for _ in range(n):
                _call(int(sup.url(0).rsplit(":", 1)[1]), "/stats")
            sup.restart_replica(0, graceful=True)
    finally:
        sup.close()
    with open(dump) as f:
        routes = json.load(f)["routes"]
    assert routes["GET /stats"] == 5 and "GET /admin/model" not in routes


# ---------------------------------------------------------------------------
# faults, the recompile guard


@pytest.mark.parametrize("spec", ("diverge@site=grad.psum", "deadlock@site=serve.index",
                                  "deadlock@site=obs.comms,diverge@site=input.h2d"))
def test_diverge_and_deadlock_parse_as_jax(spec):
    assert faults.install(spec).describe() == jax_faults.install(spec).describe()
    for site in ("grad.psum", "input.h2d", "serve.index", "obs.comms", "other"):
        assert faults.diverge_marker(site) == jax_faults.diverge_marker(site)
        assert faults.deadlock_marker(site) == jax_faults.deadlock_marker(site)
    faults.clear()
    jax_faults.clear()
    with pytest.raises(ValueError, match="needs site"):
        faults.install("deadlock@at=1")


def test_recompile_guard_matches_jax_on_a_fake_counter():
    seq = [(0, 0), (1, 2), (2, 2), (3, 3), (4, 3), (5, 3), (6, 4), (7, 4)]
    for warmup in (0, 3, 8):
        ours, theirs = runtime.RecompileGuard(warmup), jax_runtime.RecompileGuard(warmup)
        assert [ours.update(*s) is None for s in seq] == [theirs.update(*s) is None for s in seq]
    monitor = runtime.CompileMonitor()
    assert monitor.misses() == 0
    runtime.note_capture()
    runtime.note_capture()
    assert monitor.misses() == 2 and runtime.CompileMonitor().misses() == 0


# ---------------------------------------------------------------------------
# the driver


def _config(workdir, **kw):
    return pc.TrainConfig(
        moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                           shuffle="none", cifar_stem=True, compute_dtype="float32"),
        optim=pc.OptimConfig(lr=0.03, epochs=1),
        data=pc.DataConfig(dataset="synthetic", image_size=16, global_batch=16, num_workers=2),
        workdir=workdir, log_every=1, **kw)


def test_train_under_every_arm_writes_their_fields_and_artifacts(tmp_path):
    """A CPU run under strict_tracing, sanitize_collectives and
    sanitize_threads: `compile_cache_misses` (0: the CPU captures no
    graph) and `collective_schedule_hash` on every training line, which
    both packages' schemas accept with required_train_keys(True); the
    published schedule; lock_order.json; the hooks restored."""
    d = str(tmp_path)
    cfg = _config(d, strict_tracing=True, recompile_warmup_steps=1, sanitize_collectives=True,
                  sanitize_threads=True)
    out = train(cfg, dataset=SyntheticDataset(64, 16), device="cpu", steps=3, num_filters=4)
    lines = [json.loads(x) for x in open(os.path.join(d, "metrics.jsonl"))]
    training = [r for r in lines if "loss" in r]
    assert len(training) == 3
    published = json.load(open(os.path.join(d, "schedule.p0.json")))
    assert schema.required_train_keys(True) == jax_schema.required_train_keys(True)
    for r in training:
        assert set(schema.required_train_keys(True)) <= set(r)
        assert r["compile_cache_misses"] == 0
        assert r["collective_schedule_hash"] == published["hash"][:12]
        assert schema.validate_line(r) == [] and jax_schema.validate_line(r) == []
    assert [e[0] for e in published["schedule"]] == ["input.h2d", "grad.psum"]
    assert all("compile_cache_misses" in rec for rec in out["history"])
    assert json.load(open(os.path.join(d, "lock_order.json")))["cycles"] == []
    assert sanitizer.get_recorder() is None and tsan.get_recorder() is None
    with pytest.raises(ValueError, match="needs a workdir"):
        train(_config(None, sanitize_collectives=True), dataset=SyntheticDataset(64, 16),
              device="cpu", steps=1, num_filters=4)
