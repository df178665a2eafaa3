"""The port's serving fleet on the CPU: the `kill@replica` fault
(moco_tpu_torch/utils/faults.py), the ReplicaSupervisor
(moco_tpu_torch/serve/fleet.py) against moco_tpu's, and one fleet of real
port replicas behind the port's router.

The supervisors of both packages run the same stdlib child, a fake
replica that installs the port's fault plan and dies through
`maybe_kill_replica`: the crash, the respawn with its `MOCO_FAULTS`
scrubbed, the warm replay and a graceful restart give equal `events()`.

End to end: two `python -m moco_tpu_torch.serve.replica_main --device
cpu` processes serve a tiny port checkpoint behind the port's
`FleetRouter`, one module-scoped fleet shared by the cases in order:
`kill@replica=1:at=2` absorbed (no client failure, one exit with rc 113,
one warm respawn), `/embed` through the router against JAX's engine on
the same weights (within 1e-4), the router's `/debug/flight` against
JAX's offline stitch of the router's and replicas' span streams, a drain
cycle that drops nothing, and a rollout to a second checkpoint
through `serve_promote.rollout` that ends with `model_skew` back at 0.
"""

import json
import os
import sys
import textwrap
import threading
import time
import urllib.request

import numpy as np
import pytest

from moco_tpu.serve import fleet as jax_fleet
from moco_tpu.utils import faults as jax_faults
from moco_tpu_torch.serve import fleet
from moco_tpu_torch.utils import faults
from tests.conftest import load_script
from tests.test_router import _get, _post

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_S = 120.0  # a replica's spawn-to-healthy limit on a loaded CPU


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


# -- kill@replica ------------------------------------------------------------


@pytest.mark.parametrize("spec", ["kill@at=2", "kill@host=2:replica=1", "kill@replica=x"])
def test_kill_grammar_refusals_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.install(spec)
    with pytest.raises(ValueError) as got:
        faults.install(spec)
    assert str(got.value) == str(want.value)


def test_kill_replica_fires_on_the_kth_request_as_jax(monkeypatch):
    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)  # both modules' os
    traces = {}
    for name, mod in (("port", faults), ("jax", jax_faults)):
        exits.clear()
        mod.install("kill@replica=1:at=3,kill@host=0")
        seen = []
        for index in [0] * 5 + [1, 1, 1, 1]:
            mod.maybe_kill_replica(index)
            seen.append(list(exits))
        traces[name] = seen
    assert traces["port"] == traces["jax"]
    assert traces["port"][-1] == [faults.KILL_EXIT_CODE] * 2 == [113] * 2
    assert traces["port"][6] == []  # replica 1's 2nd request: not yet


def test_kill_host_ignores_replica_rules(tmp_path):
    for mod in (faults, jax_faults):
        mod.install("kill@replica=0")
        mod.maybe_kill_host(5, str(tmp_path), 0, 1)
    assert os.listdir(tmp_path) == []  # no heartbeat stamped, no exit


@pytest.mark.parametrize("spec", [
    "slow@site=x:ms=5,kill@replica=1:at=3,kill@host=2,io@site=y:at=1",
    "kill@replica=0", "", None, " kill@replica=2 , delay@site=ingest:seconds=1 ,",
    "kill@host=1:at=3",
])
def test_strip_replica_kills_matches_jax(spec):
    assert faults.strip_replica_kills(spec) == jax_faults.strip_replica_kills(spec)


def test_default_replica_argv_runs_the_port_on_the_card():
    args = ("/ckpt", "/fleet", 1, 8123)
    kw = dict(host="0.0.0.0", buckets=(1, 4), slo_ms=250.0, fresh_max_age_s=30.0)
    want = jax_fleet.default_replica_argv(*args, **kw)
    want[want.index("moco_tpu.serve.replica_main")] = "moco_tpu_torch.serve.replica_main"
    got = fleet.default_replica_argv(*args, **kw)
    cut = want.index("--fresh-max-age-s")
    assert got == want[:cut] + ["--device", "cuda"] + want[cut:]
    cpu = fleet.default_replica_argv(*args, device="cpu", **kw)
    assert cpu[cpu.index("--device") + 1] == "cpu"


def test_child_env_scrub_matches_jax():
    env = {"PATH": os.environ.get("PATH", ""),
           "MOCO_FAULTS": "kill@replica=0:at=2,slow@site=x:ms=1"}
    extra = {1: {"MOCO_FAULTS": "kill@replica=1"}}
    for index in (0, 1):
        for scrub in (False, True):
            got = fleet.ReplicaSupervisor(2, argv_for=lambda i, p: ["true"], env=env,
                                          extra_env=extra)._child_env(index, scrub)
            want = jax_fleet.ReplicaSupervisor(2, argv_for=lambda i, p: ["true"], env=env,
                                               extra_env=extra)._child_env(index, scrub)
            assert got == want
    assert "MOCO_FAULTS" not in got  # replica 1's only rule was its kill


# -- the supervisor against JAX's, on a stdlib fake child ---------------------

_FAKE_CHILD = textwrap.dedent(
    """
    import json, os, sys
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from moco_tpu_torch.utils import faults

    faults.install_from_env()
    port, index = int(sys.argv[1]), int(sys.argv[2])
    state = {"rows": 0}

    class H(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            b = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(b)))
            self.end_headers()
            self.wfile.write(b)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": True, "warm": True})
            elif self.path.startswith("/stats"):
                self._json(200, {"serve/ingested_rows": state["rows"],
                                 "faults": os.environ.get("MOCO_FAULTS")})
            else:
                self.send_error(404)

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path.startswith("/ingest"):
                state["rows"] += int(self.headers.get("X-Rows-Shape", "0,0").split(",")[0])
                self._json(200, {"index_rows": state["rows"]})
            elif self.path.startswith("/embed"):
                faults.maybe_kill_replica(index)
                self._json(200, {"replica": index})
            else:
                self.send_error(404)

        def log_message(self, *a):
            pass

    ThreadingHTTPServer(("127.0.0.1", port), H).serve_forever()
    """
)


def _supervise(mod, script):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("MOCO_FAULTS", None)
    sup = mod.ReplicaSupervisor(
        2, argv_for=lambda i, port: [sys.executable, script, str(port), str(i)],
        warm_rows_fn=lambda: np.ones((1100, 4), np.float32),  # 3 blocks of 512
        env=env, extra_env={1: {"MOCO_FAULTS": "kill@replica=1:at=2,slow@site=x:ms=1"}},
        boot_timeout_s=60.0, term_timeout_s=10.0, monitor_interval_s=0.05,
        restart_backoff_s=0.05)
    try:
        sup.start()
        first = _post(sup.url(1))[1]
        try:
            _post(sup.url(1))  # its 2nd /embed: the child exits 113 mid-request
            died = False
        except OSError:
            died = True
        deadline = time.monotonic() + 60.0
        while ("restart", 1) not in [(e["kind"], e["replica"]) for e in sup.events()]:
            assert time.monotonic() < deadline, sup.events()
            time.sleep(0.05)
        reborn = _get(sup.url(1), "/stats")
        served = _post(sup.url(1))[1]  # its kill rule is gone
        sup.restart_replica(0, graceful=True)
        healthy = _get(sup.url(0), "/healthz")["ok"]
    finally:
        sup.close()
    keep = ("kind", "replica", "rc", "reason", "rows", "graceful")
    events = [{k: e[k] for k in keep if k in e} for e in sup.events()]
    reaped = all(c.proc.poll() is not None for c in sup._children)
    return {"first": first, "died": died, "reborn": reborn, "served": served,
            "healthy": healthy, "events": events, "reaped": reaped}


def test_supervisor_crash_respawn_warm_matches_jax(tmp_path):
    script = str(tmp_path / "fake_child.py")
    with open(script, "w") as f:
        f.write(_FAKE_CHILD)
    runs = {}
    threads = [threading.Thread(target=lambda n=n, m=m: runs.__setitem__(n, _supervise(m, script)))
               for n, m in (("port", fleet), ("jax", jax_fleet))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    got, want = runs["port"], runs["jax"]
    assert got == want
    assert got["died"] and got["reaped"] and got["healthy"]
    assert got["reborn"] == {"serve/ingested_rows": 1100, "faults": "slow@site=x:ms=1"}
    kinds = [(e["kind"], e["replica"], e.get("rc")) for e in got["events"]]
    assert kinds == [("spawn", 0, None), ("spawn", 1, None), ("exit", 1, 113),
                     ("spawn", 1, None), ("warm", 1, None), ("restart", 1, 113),
                     ("exit", 0, -15), ("spawn", 0, None), ("warm", 0, None),
                     ("restart", 0, None)]


# -- a fleet of real port replicas ----------------------------------------------


def tiny_checkpoint(workdir: str, step: int = 2) -> None:
    """A tiny v2 checkpoint of tests/test_torch_serve_ckpt.py's config
    (resnet18 at 4 filters, 16 px, K 64) from a seeded fresh state, saved
    as `train()` saves it, without the steps."""
    import torch

    from moco_tpu_torch.core.moco import build_encoder, create_state
    from moco_tpu_torch.utils import config as pc
    from moco_tpu_torch.utils.checkpoint import CheckpointManager, state_payload
    from tests.test_torch_serve_ckpt import NF, _v2_config

    cfg = _v2_config(workdir)
    torch.manual_seed(0)
    state = create_state(cfg, build_encoder(cfg.moco, num_filters=NF), device="cpu",
                         step=step, queue_ptr=step * cfg.data.global_batch)
    CheckpointManager(workdir).save(step, state_payload(state, "resnet18", 1),
                                    extra={"epoch": 0, "config": pc.config_to_dict(cfg)})


def _nudged_copy(src: str, dst: str) -> None:
    """`src`'s checkpoint with every encoder parameter scaled by 1 + 1e-3,
    saved two steps later: a compatible candidate with its own digest."""
    import torch

    from moco_tpu_torch.lincls import restore_pretrain_state
    from moco_tpu_torch.utils.checkpoint import CheckpointManager, encoder_to_reference

    payload, extra = CheckpointManager(src).restore()
    restored = restore_pretrain_state(src, sides=("q", "k"), device="cpu")
    for side, enc in restored.encoders.items():
        with torch.no_grad():
            for p in enc.parameters():
                p.mul_(1.0 + 1e-3)
        for k, v in encoder_to_reference(enc).items():
            payload["state_dict"][f"module.encoder_{side}.{k}"] = v.detach().clone()
    CheckpointManager(dst).save(CheckpointManager(src).latest_step() + 2, payload, extra=extra)


@pytest.fixture(scope="module")
def real_fleet(tmp_path_factory):
    """Checkpoints A (2 steps) and B (A's parameters nudged, step 4), two replica_main
    processes serving A on the CPU under a supervisor (replica 1 with
    kill@replica=1:at=2), the port's router in front, all sharing one
    workdir for their span streams."""
    from moco_tpu_torch.serve.router import FleetRouter

    root = tmp_path_factory.mktemp("fleet")
    a_dir, b_dir, work = str(root / "a"), str(root / "b"), str(root / "work")
    tiny_checkpoint(a_dir)
    _nudged_copy(a_dir, b_dir)
    from moco_tpu_torch.serve.serve_ingest import read_queue

    warm = read_queue(a_dir)[0][:24]
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("MOCO_FAULTS", None)
    sup = fleet.ReplicaSupervisor(
        2, ckpt_dir=a_dir, workdir=work, buckets=(1, 4), device="cpu", env=env,
        extra_env={1: {"MOCO_FAULTS": "kill@replica=1:at=2"}}, warm_rows_fn=lambda: warm,
        boot_timeout_s=BOOT_S, monitor_interval_s=0.1, restart_backoff_s=0.1)
    sup.start()
    router = None
    try:
        router = FleetRouter(supervisor=sup, workdir=work, health_interval_s=0.1,
                             hedge=False, retry_attempts=4, retry_base_delay_s=0.05,
                             breaker_fail_threshold=1, breaker_cooldown_s=0.5,
                             breaker_cooldown_cap_s=2.0,
                             readmit_timeout_s=BOOT_S, metrics_flush_s=0.2)
        yield {"sup": sup, "router": router, "url": f"http://127.0.0.1:{router.port}",
               "a": a_dir, "b": b_dir, "work": work, "warm": warm}
    finally:
        if router is not None:
            router.close()
        sup.close()


def _embed(url, imgs):
    req = urllib.request.Request(url + "/embed", data=imgs.tobytes(),
                                 headers={"X-Image-Shape": ",".join(map(str, imgs.shape))})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _traffic(url, imgs, stop, failures, lock):
    while not stop.is_set():
        try:
            _embed(url, imgs)
        except Exception as e:  # a dropped request is the failure counted
            with lock:
                failures.append(repr(e))
        time.sleep(0.02)


def _wait(pred, timeout):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_fleet_1_kill_replica_is_absorbed(real_fleet):
    from tests.test_torch_serve_ckpt import IMG, _images

    url, sup, router = real_fleet["url"], real_fleet["sup"], real_fleet["router"]
    imgs = _images(2, IMG, seed=3)
    bodies = [_embed(url, imgs) for _ in range(6)]  # replica 1's 2nd request kills it
    assert {b["replica"] for b in bodies} == {0, 1}
    _wait(lambda: ("restart", 1) in [(e["kind"], e["replica"]) for e in sup.events()], BOOT_S)
    events = [e for e in sup.events() if e["replica"] == 1]
    exits = [e for e in events if e["kind"] == "exit"]
    assert [(e["rc"], e["reason"]) for e in exits] == [(113, "crash")]
    assert [e["kind"] for e in events].count("restart") == 1
    assert [e["rows"] for e in events if e["kind"] == "warm"] == [len(real_fleet["warm"])]
    assert _get(sup.url(1), "/stats")["serve/ingested_rows"] == len(real_fleet["warm"])
    stats = router.stats()
    assert stats["fleet_serve/failed"] == 0 and stats["fleet_serve/retries"] >= 1
    assert stats["fleet_serve/breaker_trips"] >= 1
    # re-admitted: a half-open probe finds the reborn replica, which then
    # answers through the router again
    _wait(lambda: _embed(url, imgs)["replica"] == 1, 30.0)
    assert router.stats()["fleet_serve/breaker_open"] == 0


def test_fleet_2_embed_matches_jax_and_stitches(real_fleet):
    import jax.numpy as jnp

    from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
    from moco_tpu.import_torch import import_reference_state_dict
    from moco_tpu.models import resnet as jax_resnet
    from moco_tpu.models.heads import ProjectionHead as FlaxHead
    from moco_tpu.serve.engine import InferenceEngine as JaxEngine
    from moco_tpu_torch.utils.checkpoint import CheckpointManager
    from tests.test_torch_serve_ckpt import IMG, NF, _images

    url, router = real_fleet["url"], real_fleet["router"]
    payload, _ = CheckpointManager(real_fleet["a"]).restore()
    pieces = import_reference_state_dict(
        {k: v.numpy() for k, v in payload["state_dict"].items()}, "resnet18")
    enc = FlaxEncoder(
        backbone=jax_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True,
                                          dtype=jnp.float32),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32))
    jax_engine = JaxEngine(enc, pieces["params_k"], pieces["batch_stats_k"], image_size=IMG,
                           buckets=(1, 8))
    answers = []
    for n in (1, 3, 4, 2):
        imgs = _images(n, IMG, seed=10 + n)
        body = _embed(url, imgs)
        want, _ = jax_engine.embed(imgs)
        np.testing.assert_allclose(np.asarray(body["embedding"], np.float32),
                                   np.asarray(want), atol=1e-4, rtol=0)
        assert body["request_id"].startswith(f"r{body['replica']}-")
        answers.append(body)
    assert {b["replica"] for b in answers} == {0, 1}
    # the replicas flush their spans every second, the router every 0.2 s
    stitch = load_script("trace_merge.py").stitch_traces
    want_ids = {b["trace_id"] for b in answers}
    deadline = time.monotonic() + 30.0
    while True:
        flight = {r["trace_id"]: r for r in _get(url, "/debug/flight")["requests"]}
        offline = stitch(real_fleet["work"])
        if want_ids <= set(flight) and all(
                offline.get(t, {}).get("attempts") and offline[t]["attempts"][0]["remote"]
                for t in want_ids):
            break
        assert time.monotonic() < deadline, (sorted(flight), sorted(offline))
        time.sleep(0.2)
    for body in answers:
        rec, off = flight[body["trace_id"]], offline[body["trace_id"]]
        assert off["request_id"] == rec["request_id"] == body["request_id"]
        assert (off["path"], off["status"]) == (rec["path"], rec["status"]) == ("/embed", 200)
        assert len(off["attempts"]) == len(rec["attempts"]) == 1
        a, b = off["attempts"][0], rec["attempts"][0]
        for k in ("span_id", "replica", "retry_index", "lane", "outcome", "winner"):
            assert a[k] == b[k], k
        assert a["remote"]["request_id"] == b["remote"]["request_id"] == body["request_id"]
        # the in-band waterfall leaves before its own respond stage is
        # stamped; the replica's stream has it
        assert ([s["stage"] for s in a["remote"]["stages"]]
                == [s["stage"] for s in b["remote"]["stages"]] + ["respond"])
        assert abs(off["total_ms"] - rec["total_ms"]) <= max(5.0, 0.2 * rec["total_ms"])


def test_fleet_3_drain_cycle_drops_nothing(real_fleet):
    from tests.test_torch_serve_ckpt import IMG, _images

    url, sup = real_fleet["url"], real_fleet["sup"]
    failures, stop, lock = [], threading.Event(), threading.Lock()
    threads = [threading.Thread(target=_traffic, args=(url, _images(1, IMG), stop, failures,
                                                       lock)) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        req = urllib.request.Request(url + "/admin/drain?replica=0", data=b"")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 202

        def back():
            snap = _get(url, "/admin/replicas")["replicas"][0]
            return snap["healthy"] and not snap["draining"] and snap["drain_phase"] is None

        time.sleep(0.2)
        _wait(back, BOOT_S)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert failures == []
    restarts = [e for e in sup.events() if e["kind"] == "restart" and e["replica"] == 0]
    assert [e["graceful"] for e in restarts] == [True]
    assert real_fleet["router"].stats()["fleet_serve/drains"] == 1


def test_fleet_4_promotion_rolls_out_and_skew_returns_to_zero(real_fleet):
    from moco_tpu_torch.obs.quality import encoder_digest
    from moco_tpu_torch.serve import serve_promote
    from moco_tpu_torch.serve.engine import load_serving_encoder

    url, router = real_fleet["url"], real_fleet["router"]
    digest_a = encoder_digest(load_serving_encoder(real_fleet["a"], device="cpu")[0])
    digest_b = encoder_digest(load_serving_encoder(real_fleet["b"], device="cpu")[0])
    assert digest_a != digest_b
    _wait(lambda: router.stats()["fleet_serve/model_skew"] == 0, 30.0)
    skews, stop = [], threading.Event()

    def watch():
        while not stop.is_set():
            skews.append(router.stats()["fleet_serve/model_skew"])
            time.sleep(0.05)

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        out = serve_promote.rollout(url, real_fleet["b"], real_fleet["a"],
                                    target_digest=digest_b, soak_s=0.2,
                                    swap_timeout_s=BOOT_S, poll_s=0.1)
    finally:
        stop.set()
        watcher.join(timeout=10)
    assert out == {"verdict": "promoted", "swapped": [0, 1], "replica": None,
                   "reason": None, "burn": None}
    assert max(s for s in skews if s is not None) == 1  # the half-finished rollout
    _wait(lambda: router.stats()["fleet_serve/model_skew"] == 0, 30.0)
    snaps = _get(url, "/admin/replicas")["replicas"]
    assert [s["model_digest"] for s in snaps] == [digest_b, digest_b]
    assert [s["model_step"] for s in snaps] == [4, 4]
    assert router.stats()["fleet_serve/promotions"] == 2
