"""`/ingest`, the ingest stamps' freshness SLO, the streaming ingester and
the batcher thread's own warm-up, in the port (moco_tpu_torch/serve) on the
CPU, held against the JAX server and scripts/serve_ingest.py where they
have a counterpart.

- `/ingest`: status codes and JSON bodies equal to JAX's `ServeServer` for
  the same requests (a good block, each 400, 503 without an index); the
  rows written equal JAX's index's; `serve/ingested_rows`,
  `serve/ingest_ckpt_step` and `/admin/model` as JAX's.
- The freshness SLO: rows stamped 30 s in the past (injected), an
  objective of 5 s, and `delay@site=ingest` stalling the refreshing block:
  `fresh_burn_fast` fires while the block is stuck, and the block, once in,
  brings the oldest row's age under the objective.
- `serve_ingest.fresh_rows` equal to the script's on the same queue and
  heads; `python -m moco_tpu_torch.serve.serve_ingest --once` against a
  live CPU server; the retry site; `--fanout` refused; the replica passing
  `--fresh-max-age-s` through.
- The batcher repair: the warm-up pass runs every bucket and prepared
  index shape on the batcher thread (its ident recorded) before the port
  is bound, so `/healthz` reports warm only after it."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

from moco_tpu.serve.index import EmbeddingIndex as JaxIndex
from moco_tpu.serve.server import ServeServer as JaxServer
from moco_tpu.utils import contracts as jax_contracts
from moco_tpu_torch.core.moco import build_encoder, create_state
from moco_tpu_torch.obs.alerts import read_alerts
from moco_tpu_torch.serve import replica_main, serve_ingest
from moco_tpu_torch.serve import server as server_mod
from moco_tpu_torch.serve.batcher import ContinuousBatcher
from moco_tpu_torch.serve.engine import InferenceEngine, load_serving_encoder
from moco_tpu_torch.serve.index import QUERY_MODES, EmbeddingIndex
from moco_tpu_torch.serve.server import ServeServer
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import contracts, faults, retry
from moco_tpu_torch.utils.checkpoint import CheckpointManager, state_payload
from tests.conftest import load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF, IMG, K, DIM = 4, 16, 64, 16


def unit_rows(n, seed):
    r = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return r / np.linalg.norm(r, axis=1, keepdims=True)


def _config():
    return pc.TrainConfig(
        moco=pc.MocoConfig(arch="resnet18", dim=DIM, num_negatives=K, mlp=True, cifar_stem=True,
                           compute_dtype="float32"),
        data=pc.DataConfig(dataset="synthetic", image_size=IMG, global_batch=8))


def write_ckpt(workdir, state, step, queue, ptr):
    """A checkpoint of `state` at `step` whose queue is `queue` at `ptr`."""
    state.queue.copy_(torch.from_numpy(queue))
    state.queue_ptr, state.step = ptr, step
    mgr = CheckpointManager(workdir)
    mgr.save(step, state_payload(state, "resnet18", 1),
             extra={"epoch": 0, "config": pc.config_to_dict(_config())})
    mgr.close()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A v2 checkpoint at step 5 (queue at head 24) and its state."""
    workdir = str(tmp_path_factory.mktemp("ingest") / "pre")
    cfg = _config()
    state = create_state(cfg, build_encoder(cfg.moco, num_filters=NF), device="cpu")
    write_ckpt(workdir, state, 5, unit_rows(K, 0), 24)
    return workdir, state


@pytest.fixture(scope="module")
def engine(ckpt):
    encoder, *_ = load_serving_encoder(ckpt[0], device="cpu")
    return InferenceEngine(encoder, IMG, buckets=(1, 4), device="cpu")


class _JaxStubEngine:
    """What JAX's server reads of an engine when the caller has warmed it."""

    buckets = (1, 4)
    recompiles_after_warmup = 0
    image_size = IMG


def _request(port, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _ingest(port, rows, ckpt_step=None, shape=None):
    headers = {"X-Rows-Shape": shape or f"{rows.shape[0]},{rows.shape[1]}"}
    if ckpt_step is not None:
        headers["X-Ckpt-Step"] = str(ckpt_step)
    return _request(port, "/ingest", rows.tobytes(), headers)


def test_ingest_answers_as_jax(engine):
    rows = unit_rows(K, 1)
    jidx, pidx = JaxIndex(K, DIM), EmbeddingIndex(K, DIM, device="cpu")
    for idx in (jidx, pidx):
        idx.snapshot(rows)
    jsrv = JaxServer(_JaxStubEngine(), index=jidx, warmup=False, alert_spec="")
    psrv = ServeServer(engine, index=pidx, warmup=False, alert_spec="")
    bare_j = JaxServer(_JaxStubEngine(), index=None, warmup=False, alert_spec="")
    bare_p = ServeServer(engine, index=None, warmup=False, alert_spec="")
    block = unit_rows(8, 2)
    cases = [
        (block, 7, None),  # 200
        (block, None, "8"),  # bad X-Rows-Shape
        (block, "x", None),  # bad X-Ckpt-Step
        (block[:4], None, "8,16"),  # Content-Length off n*d*4
        (np.zeros((8, 12), np.float32), None, None),  # row dim off the index's
        (unit_rows(4, 3), None, None),  # 200 again, no step header
    ]
    try:
        for rows_in, step, shape in cases:
            want = _ingest(jsrv.port, rows_in, step, shape)
            got = _ingest(psrv.port, rows_in, step, shape)
            assert got == want, (shape, step)
        assert got == (200, {"ingested": 4, "index_rows": K, "total_ingested": 12})
        assert _ingest(bare_p.port, block) == _ingest(bare_j.port, block)
        assert _ingest(bare_p.port, block)[0] == 503
        np.testing.assert_array_equal(pidx.rows.numpy(), np.asarray(jidx.rows))
        assert pidx._ptr == jidx._ptr == 12
        for key in ("serve/ingested_rows", "serve/ingest_ckpt_step", "serve/index_rows"):
            assert psrv.stats()[key] == jsrv.stats()[key], key
        assert psrv.stats()["serve/ingested_rows"] == 12
        assert _get(psrv.port, "/admin/model")["ingest_ckpt_step"] == 7
        assert _get(psrv.port, "/admin/model") == _get(jsrv.port, "/admin/model")
    finally:
        for srv in (jsrv, psrv, bare_j, bare_p):
            srv.close()


def test_freshness_burn_fires_under_a_stalled_ingest(tmp_path, engine):
    idx = EmbeddingIndex(K, DIM, device="cpu")
    idx.snapshot(unit_rows(K, 4), now=time.time() - 30.0)  # injected: 30 s old
    srv = ServeServer(engine, index=idx, warmup=False, fresh_max_age_s=5.0,
                      burn_windows=(2, 4), metrics_flush_s=0.1, workdir=str(tmp_path))
    faults.install("delay@site=ingest:seconds=1.5")
    done = {}

    def ingest():
        t0 = time.time()
        done["reply"] = _ingest(srv.port, unit_rows(K, 5), ckpt_step=9)
        done["t"], done["took"] = time.time(), time.time() - t0

    try:
        t = threading.Thread(target=ingest)
        t.start()
        t.join(timeout=60)
        stats = srv.stats()
    finally:
        faults.clear()
        srv.close()
    alerts = read_alerts(str(tmp_path / "alerts.jsonl"))
    fresh = [a for a in alerts if a["rule"] == "fresh_burn_fast"]
    assert fresh, alerts
    assert done["reply"][0] == 200 and done["took"] >= 1.5
    assert fresh[0]["time"] < done["t"]  # fired while the block was stuck
    assert stats["serve/fresh_max_age_s"] == 5.0
    assert stats["serve/row_age_max_s"] < 5.0 and stats["serve/ingest_ckpt_step"] == 9
    assert stats["serve/fresh_burn_rate_2s"] is not None


@pytest.mark.parametrize("old, new", [(None, 3), (2, 5), (6, 2), (4, 4), (None, 0), (0, 7)])
def test_fresh_rows_match_the_script(old, new):
    script = load_script("serve_ingest.py")
    q = np.arange(8)[:, None] * np.ones((8, 2), np.float32)
    np.testing.assert_array_equal(serve_ingest.fresh_rows(q, old, new),
                                  script.fresh_rows(q, old, new))


def test_serve_ingest_once_against_a_live_server(ckpt, engine, tmp_path):
    """The first poll sends the whole queue oldest-first from the head; a
    later one the rows enqueued since; each row is its own top-1 in the
    exact and exact_i8 tiers."""
    workdir, state = ckpt
    queue5, ptr5 = serve_ingest.read_queue(workdir)
    assert ptr5 == 24
    idx = EmbeddingIndex.from_train_queue(queue5, ptr5, device="cpu")
    idx.enable_int8()
    srv = ServeServer(engine, index=idx, warmup=False, alert_spec="")
    d = str(tmp_path / "run")
    queue7 = queue5.copy()
    queue7[24:40] = unit_rows(16, 6)
    write_ckpt(d, state, 7, queue7, 40)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "moco_tpu_torch.serve.serve_ingest", "--ckpt-dir", d,
             "--server", f"http://127.0.0.1:{srv.port}", "--once", "--block", "24"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert f"step 7: ingested {K} fresh rows" in proc.stdout
        st = srv.stats()
        assert (st["serve/ingested_rows"], st["serve/ingest_ckpt_step"]) == (K, 7)
        sent = serve_ingest.fresh_rows(queue7, None, 40)
        np.testing.assert_array_equal(idx.rows.numpy(), np.roll(sent, 24, axis=0))
        for mode in ("exact", "exact_i8"):
            _, ids = idx.query(sent[:8], 1, mode=mode)
            np.testing.assert_array_equal(ids[:, 0], (24 + np.arange(8)) % K)
        # the next checkpoint's 8 new rows, through poll_once in this process
        queue9 = queue7.copy()
        queue9[40:48] = unit_rows(8, 7)
        write_ckpt(d, state, 9, queue9, 48)
        seen = {"step": 7, "ptr": 40}
        assert serve_ingest.poll_once(d, f"http://127.0.0.1:{srv.port}", seen) == 8
        assert seen == {"step": 9, "ptr": 48}
        assert serve_ingest.poll_once(d, f"http://127.0.0.1:{srv.port}", seen) == 0
        assert srv.stats()["serve/ingested_rows"] == K + 8
        np.testing.assert_array_equal(idx.rows[24:32].numpy(), queue9[40:48])
    finally:
        srv.close()


def test_post_rows_retries_at_its_site(monkeypatch):
    calls = []

    def flaky(req, timeout):
        calls.append(req.headers)
        if len(calls) == 1:
            raise OSError("connection reset")

        class Reply:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def read(self):
                return b'{"index_rows": 3}'
        return Reply()

    monkeypatch.setattr(serve_ingest, "_urlopen", flaky)
    monkeypatch.setenv("MOCO_IO_RETRY_BASE", "0.001")
    # a ledger of its own: the process-wide one feeds other tests' lines
    monkeypatch.setattr(retry, "_retries", Counter())
    assert serve_ingest.post_rows("http://x", unit_rows(3, 8), ckpt_step=11) == 3
    assert retry.snapshot() == {"ingest.post": 1}
    assert calls[-1]["X-ckpt-step"] == "11" and calls[-1]["X-rows-shape"] == "3,16"


def test_fanout_is_refused(monkeypatch):
    """`--fanout` is taken now: main hands `poll_once` the router URL with
    fanout on (its path is held against JAX's in test_torch_router.py), and
    leaves it off without the flag."""
    seen = []
    monkeypatch.setattr(serve_ingest, "poll_once",
                        lambda *a, **kw: seen.append((a, kw)) or 0)
    for flags, fanout in ((["--fanout"], True), ([], False)):
        seen.clear()
        assert serve_ingest.main(["--ckpt-dir", "d", "--server", "http://x", "--once",
                                  "--block", "64", *flags]) == 0
        assert seen == [(("d", "http://x", {}, 64), {"fanout": fanout})]


def test_replica_passes_fresh_max_age_through(ckpt, monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def recorder(engine, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(server_mod, "ServeServer", recorder)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for flag, want in ((["--fresh-max-age-s", "7.5"], 7.5), ([], None)):
            with pytest.raises(Stop):
                replica_main.main(["--ckpt-dir", ckpt[0], "--port", "0", "--device", "cpu",
                                   "--buckets", "1", *flag])
            assert seen["fresh_max_age_s"] == want
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def test_neighbors_int8_modes_and_quant_gauges(ckpt):
    """A w8a8 engine over an int8-enabled IVF index: every tier answers
    `?mode=`, the int8 ones as the index does on the answer's own
    embeddings; `serve/quant_tier` 2 and `serve/int8` 1."""
    encoder, queue, ptr, _ = load_serving_encoder(ckpt[0], device="cpu")
    imgs = np.random.default_rng(9).integers(0, 255, (6, IMG, IMG, 3), np.uint8)
    eng = InferenceEngine(encoder, IMG, buckets=(1, 4), device="cpu", engine_quant="w8a8",
                          calib_sample=imgs)
    idx = EmbeddingIndex.from_train_queue(queue, ptr, device="cpu")
    idx.enable_int8()
    idx.train_ivf(nlist=4, nprobe=2)
    srv = ServeServer(eng, index=idx, neighbors_k=3, neighbors_mode="ivf_fused_i8",
                      alert_spec="")
    try:
        body = imgs[:3].tobytes()
        hdr = {"X-Image-Shape": f"3,{IMG},{IMG},3"}
        for mode in ("exact_i8", "ivf_i8", "ivf"):
            status, out = _request(srv.port, f"/neighbors?mode={mode}", body, hdr)
            assert status == 400 and "not prepared" in out["error"], (mode, out)
        status, out = _request(srv.port, "/neighbors", body, hdr)
        assert status == 200 and out["mode"] == "ivf_fused_i8"
        # the index's answer on the reply's own embeddings, padded to bucket 4
        emb = np.asarray(out["embedding"], np.float32)
        _, ids = idx.query(np.concatenate([emb, np.zeros((1, DIM), np.float32)]), 3,
                           mode="ivf_fused_i8")
        np.testing.assert_array_equal(np.asarray(out["indices"]), ids[:3])
        st = srv.stats()
        assert (st["serve/quant_tier"], st["serve/int8"]) == (2, 1)
        assert st["serve/recompiles_after_warmup"] == 0
    finally:
        srv.close()
    # warmup=False: the caller prepared every tier, and each is accepted
    idx = EmbeddingIndex.from_train_queue(queue, ptr, device="cpu")
    idx.enable_int8()
    idx.train_ivf(nlist=4, nprobe=2)
    idx.prepare(eng.buckets, 3, modes=QUERY_MODES)
    idx.freeze()
    srv = ServeServer(eng, index=idx, neighbors_k=3, warmup=False, alert_spec="")
    try:
        for mode in QUERY_MODES:
            status, out = _request(srv.port, f"/neighbors?mode={mode}", body, hdr)
            assert status == 200 and out["mode"] == mode
    finally:
        srv.close()


# -- the batcher thread's own warm-up ---------------------------------------


def test_batcher_warmup_runs_on_its_thread_before_any_request():
    order = []

    def warm():
        time.sleep(0.2)
        order.append(("warm", threading.get_ident()))

    def run_batch(images, want_neighbors):
        order.append(("run", threading.get_ident()))
        return {"embedding": np.zeros((images.shape[0], 2), np.float32)}, [(1, 1)]

    b = ContinuousBatcher(run_batch, max_batch=1, warmup=warm)
    try:
        fut = b.submit(np.zeros((1, 2, 2, 3), np.uint8))  # queued during the warm-up
        fut.result(timeout=10)
        assert b.wait_warm(timeout=1) and b.warm
        assert [k for k, _ in order] == ["warm", "run"]
        assert order[0][1] == order[1][1] == b.warm_thread_ident == b._thread.ident
        assert b.warm_thread_ident != threading.get_ident() and b.warm_s >= 0.2
    finally:
        b.close()

    def broken():
        raise RuntimeError("warm-up failed")

    b = ContinuousBatcher(run_batch, max_batch=1, warmup=broken)
    with pytest.raises(RuntimeError, match="warm-up failed"):
        b.wait_warm(timeout=10)
    assert not b.warm and b.closed
    b.close()


@pytest.mark.parametrize("warmup", [True, False])
def test_server_warms_the_batcher_thread_before_healthz(engine, warmup):
    """Every engine bucket and every prepared index shape runs on the
    batcher thread before the constructor returns (the port is bound
    after it); nothing recompiles."""
    idx = EmbeddingIndex(K, DIM, device="cpu")
    idx.snapshot(unit_rows(K, 10))
    idx.train_ivf(nlist=4, nprobe=2)
    if not warmup:
        engine.warmup()
        idx.prepare(engine.buckets, 5, modes=("exact", "ivf"))
        idx.freeze()
    calls = []
    warm_bucket, index_warm = engine.warm_bucket, idx.warm
    engine.warm_bucket = lambda b: (calls.append(("engine", b, threading.get_ident(),
                                                  time.perf_counter())), warm_bucket(b))[1]
    idx.warm = lambda f: (calls.append(("index", f.shape[0], threading.get_ident(),
                                        time.perf_counter())), index_warm(f))[1]
    try:
        srv = ServeServer(engine, index=idx, neighbors_mode="ivf", warmup=warmup,
                          alert_spec="")
        t_built = time.perf_counter()
    finally:
        del engine.warm_bucket
    try:
        assert [(c[0], c[1]) for c in calls] == [("engine", 1), ("index", 1), ("engine", 4),
                                                 ("index", 4)]
        ident = srv.batcher.warm_thread_ident
        assert ident == srv.batcher._thread.ident != threading.get_ident()
        assert all(c[2] == ident and c[3] < t_built for c in calls)
        health = _get(srv.port, "/healthz")
        assert health["warm"] and health["ok"]
        assert {(mode, m) for mode, m, _, _ in idx._prepared} == {
            (mode, m) for mode in ("exact", "ivf") for m in (1, 4)}
        assert srv.stats()["serve/recompiles_after_warmup"] == 0
    finally:
        srv.close()


def test_a_failing_warm_pass_fails_the_constructor(engine, monkeypatch):
    def broken(bucket):
        raise RuntimeError("no card state")

    monkeypatch.setattr(engine, "warm_bucket", broken)
    with pytest.raises(RuntimeError, match="no card state"):
        ServeServer(engine, index=None, warmup=False, alert_spec="")


def test_fault_sites_registry():
    """The `ingest` delay site is registered with JAX's comment, and the
    port's sites are JAX's for each kind it has."""
    assert "ingest" in contracts.FAULT_SITES["delay"]
    for kind, sites in contracts.FAULT_SITES.items():
        assert set(sites) <= set(jax_contracts.FAULT_SITES[kind]), kind
    assert contracts.SERVE_STAGE_SITES == jax_contracts.SERVE_STAGE_SITES
