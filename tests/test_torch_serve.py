"""The PyTorch port's serving path (moco_tpu_torch/serve) on the CPU:
engine parity with the JAX InferenceEngine, the bucket freeze, the
continuous batcher, the HTTP request path, and the import guard that
keeps JAX out of the port.

Engine tolerance: atol 1e-4 on unit-norm f32 embeddings (both sides run
the same f32 encoder; convolutions sum in different orders)."""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.models.resnet import create_resnet as flax_resnet
from moco_tpu.serve.engine import InferenceEngine as JaxEngine
from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
from moco_tpu_torch.core.moco import build_encoder
from moco_tpu_torch.serve.batcher import BatcherClosedError, ContinuousBatcher
from moco_tpu_torch.serve.engine import EngineRecompileError, InferenceEngine
from moco_tpu_torch.serve.index import EmbeddingIndex
from moco_tpu_torch.serve.server import ServeServer
from moco_tpu_torch.utils.config import MocoConfig

IMG = 32
CFG = MocoConfig(arch="resnet18", dim=16, mlp=True, cifar_stem=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_encoder(params, stats, num_filters=8):
    model = build_encoder(CFG, num_filters=num_filters)
    model.load_state_dict(encoder_from_flax(params, stats))
    return model


@pytest.fixture(scope="module")
def flax_weights():
    return random_flax_encoder(CFG, seed=0, num_filters=8)


@pytest.fixture(scope="module")
def engine(flax_weights):
    eng = InferenceEngine(port_encoder(*flax_weights), IMG, buckets=(1, 4, 8), device="cpu")
    eng.warmup()
    return eng


def images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, IMG, IMG, 3), np.uint8)


def test_engine_matches_jax_engine(flax_weights):
    """The port's engine against moco_tpu's InferenceEngine on the CPU in
    f32, buckets (1, 8): the same uint8 batches give embeddings within
    atol 1e-4, including the padded bucket."""
    params, stats = flax_weights
    enc = FlaxEncoder(
        backbone=flax_resnet("resnet18", num_filters=8, cifar_stem=True, dtype=jnp.float32),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32),
    )
    jax_engine = JaxEngine(enc, jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, stats), image_size=IMG,
                           buckets=(1, 8))
    port = InferenceEngine(port_encoder(params, stats), IMG, buckets=(1, 8), device="cpu")
    for n in (1, 5, 8):
        imgs = images(n, seed=n)
        want, want_exec = jax_engine.embed(imgs)
        got, got_exec = port.embed(imgs)
        assert got_exec == want_exec
        assert got.shape == want.shape == (n, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_engine_chunks_and_pads(engine):
    """Padding rows never leak into valid rows, and a batch above the
    largest bucket chunks into bucket-shaped executions."""
    imgs = images(19)
    full, executed = engine.embed(imgs)
    assert executed == [(8, 8), (8, 8), (4, 3)]
    for n, bucket in ((5, 8), (3, 4), (1, 1)):
        part, ex = engine.embed(imgs[:n])
        assert ex == [(bucket, n)]
        np.testing.assert_allclose(part, full[:n], atol=1e-5)
    with pytest.raises(ValueError, match="expected"):
        engine.embed(np.zeros((2, IMG + 1, IMG, 3), np.uint8))


def test_engine_freezes_its_buckets_after_warmup(flax_weights):
    eng = InferenceEngine(port_encoder(*flax_weights), IMG, buckets=(1, 4), device="cpu")
    eng.embed(images(2))  # before warmup a bucket may still be prepared
    eng.warmup()
    assert eng.recompiles_after_warmup == 0
    eng.embed(images(3))
    with pytest.raises(EngineRecompileError):
        eng._run_bucket(np.zeros((2, IMG, IMG, 3), np.uint8))
    assert eng.recompiles_after_warmup == 0


def test_engine_on_cuda_raises_without_a_card(flax_weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(port_encoder(*flax_weights), IMG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbeddingIndex(8, 4)


def test_embed_and_query_modes_share_one_forward(engine):
    imgs = images(6, seed=3)
    feats, _ = engine.embed(images(40, seed=4))
    index = EmbeddingIndex(40, 16, device="cpu")
    index.snapshot(feats)
    index.train_ivf(nlist=4, nprobe=2)
    emb, per_mode, executed = engine.embed_and_query_modes(
        imgs, index, 3, modes=("exact", "ivf", "ivf_fused")
    )
    assert executed == [(8, 6)] and emb.shape == (6, 16)
    np.testing.assert_array_equal(per_mode["ivf"][1], per_mode["ivf_fused"][1])
    np.testing.assert_allclose(per_mode["ivf"][0], per_mode["ivf_fused"][0], atol=1e-5)
    exact = emb @ feats.T
    np.testing.assert_array_equal(per_mode["exact"][1][:, 0], exact.argmax(1))
    _, scores, idx, _ = engine.embed_and_query(imgs, index, 3)
    np.testing.assert_array_equal(idx, per_mode["exact"][1])


def _echo_run_batch(images, want_neighbors):
    return {"embedding": np.arange(images.shape[0], dtype=np.float32)[:, None]}, [
        (8, images.shape[0])
    ]


def test_batcher_coalesces_and_scatters_in_order():
    calls = []

    def run_batch(images, wn, modes):
        calls.append((images.shape[0], modes))
        return _echo_run_batch(images, wn)

    b = ContinuousBatcher(run_batch, max_batch=8, slo_ms=10_000)
    try:
        t0 = time.perf_counter()
        futs = [b.submit(np.zeros((2, 4, 4, 3), np.uint8), want_neighbors=True,
                         mode="ivf" if i % 2 else None) for i in range(4)]
        outs = [f.result(10) for f in futs]
        assert time.perf_counter() - t0 < 2.0  # flushed by size, not the 5 s deadline
        assert calls == [(8, ("ivf",))]
        got = np.concatenate([o["embedding"][:, 0] for o in outs])
        np.testing.assert_array_equal(got, np.arange(8, dtype=np.float32))
        p = b.metrics.payload()
        assert p["serve/requests"] == 4 and p["serve/bucket_8"] == 1
        assert p["serve/mode_ivf"] == 2 and p["serve/mode_default"] == 2
    finally:
        b.close()


def test_batcher_deadline_flush_and_errors():
    b = ContinuousBatcher(_echo_run_batch, max_batch=1000, slo_ms=200)
    try:
        t0 = time.perf_counter()
        assert b.submit(np.zeros((3, 4, 4, 3), np.uint8)).result(10)["embedding"].shape == (3, 1)
        assert 0.05 < time.perf_counter() - t0 < 2.0  # the slo/2 deadline flushed it
    finally:
        b.close()

    def bad_run(images, wn):
        raise RuntimeError("engine on fire")

    b = ContinuousBatcher(bad_run, max_batch=1, slo_ms=50)
    try:
        with pytest.raises(RuntimeError, match="engine on fire"):
            b.submit(np.zeros((1, 4, 4, 3), np.uint8)).result(10)
    finally:
        b.close()


def test_batcher_close_and_drain():
    release = threading.Event()

    def slow_run(images, wn):
        release.wait(5)
        return _echo_run_batch(images, wn)

    b = ContinuousBatcher(slow_run, max_batch=1, slo_ms=1000, queue_depth=8)
    futs = [b.submit(np.zeros((1, 4, 4, 3), np.uint8)) for _ in range(4)]
    timer = threading.Timer(0.2, release.set)  # the batch in flight ends mid-close
    timer.start()
    b.close()
    timer.join(timeout=5)
    outcomes = []
    for f in futs:
        try:
            f.result(5)
            outcomes.append("ok")
        except BatcherClosedError:
            outcomes.append("closed")
    assert len(outcomes) == 4 and "closed" in outcomes
    with pytest.raises(BatcherClosedError):
        b.submit(np.zeros((1, 4, 4, 3), np.uint8))
    b = ContinuousBatcher(_echo_run_batch, max_batch=100, slo_ms=5000)
    futs = [b.submit(np.zeros((1, 4, 4, 3), np.uint8)) for _ in range(3)]
    assert b.drain(timeout=10)
    assert all(f.result(1)["embedding"].shape == (1, 1) for f in futs)


def test_batcher_scatter_under_concurrent_clients():
    """24 client threads (more than cores) with a short switch interval:
    every future gets back exactly its own rows, and every request is
    counted once."""

    def run_batch(images, wn):
        return {"tag": images[:, 0, 0, 0].astype(np.int64)}, [(64, images.shape[0])]

    b = ContinuousBatcher(run_batch, max_batch=64, slo_ms=20)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(c):
        try:
            for r in range(10):
                tag = c * 10 + r
                n = 1 + (tag % 3)
                fut = b.submit(np.full((n, 2, 2, 3), tag % 256, np.uint8))
                got = fut.result(30)["tag"]
                if got.tolist() != [tag % 256] * n:
                    errors.append((tag, got.tolist()))
        except Exception as e:  # surfaced through `errors`
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(24)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert b.metrics.payload()["serve/requests"] == 240


@pytest.fixture(scope="module")
def server(engine):
    feats, _ = engine.embed(images(64, seed=7))
    index = EmbeddingIndex(64, 16, device="cpu")
    index.snapshot(feats)
    index.train_ivf(nlist=4, nprobe=2)
    srv = ServeServer(engine, index=index, port=0, slo_ms=5000, neighbors_k=3,
                      neighbors_mode="ivf_fused")
    yield srv, feats
    srv.close()


def _post(srv, path, imgs):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=imgs.tobytes(),
        headers={"X-Image-Shape": ",".join(map(str, imgs.shape))},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
        return json.loads(r.read())


def test_http_embed_round_trip(server, engine):
    srv, _ = server
    imgs = images(5, seed=11)
    out = _post(srv, "/embed", imgs)
    np.testing.assert_allclose(np.asarray(out["embedding"]), engine.embed(imgs)[0], atol=1e-5)
    assert _get(srv, "/healthz") == {"ok": True, "warm": True, "draining": False, "replica": 0}
    bad = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/embed", data=b"xx", headers={"X-Image-Shape": "1,2,3"}
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(bad, timeout=10)
    assert e.value.code == 400
    e.value.close()


@pytest.mark.parametrize("mode", [None, "exact"])
def test_http_neighbors_round_trip(server, mode):
    """/neighbors finds each seed image itself first, in the default
    (ivf_fused) tier and in the exact tier; an unprepared tier is a 400."""
    srv, _ = server
    imgs = images(64, seed=7)[[0, 9, 33]]
    path = "/neighbors?k=2" + (f"&mode={mode}" if mode else "")
    out = _post(srv, path, imgs)
    assert out["mode"] == (mode or "ivf_fused")
    assert np.asarray(out["indices"]).shape == (3, 2)
    np.testing.assert_array_equal(np.asarray(out["indices"])[:, 0], [0, 9, 33])
    np.testing.assert_allclose(np.asarray(out["scores"])[:, 0], 1.0, atol=1e-5)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/neighbors?mode=ivf", imgs)
    assert e.value.code == 400
    e.value.close()
    stats = _get(srv, "/stats")
    assert stats["serve/recompiles_after_warmup"] == 0
    assert stats["serve/requests"] >= 1 and stats["serve/nprobe"] == 2


def test_port_imports_no_jax():
    """Every module of moco_tpu_torch imports with jax, flax, optax,
    moco_tpu and PIL (which a card's machine may lack) made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'moco_tpu', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import moco_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(moco_tpu_torch.__path__, 'moco_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 14
    assert {"moco_tpu_torch.obs.quality", "moco_tpu_torch.serve.replica_main"} <= set(names)


def test_port_names_no_jax_module_in_any_import():
    """No import in moco_tpu_torch, at the top of a module or inside a
    function, names jax, flax, optax or moco_tpu: the runtime check above
    sees only what importing a module runs."""
    import ast
    from pathlib import Path

    banned = {"jax", "flax", "optax", "moco_tpu"}
    found = []
    for path in sorted((Path(REPO) / "moco_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path.name, n) for n in names if n.split(".")[0] in banned]
        calls = re.findall(r"import_module\(\s*[\"'](\w+)", path.read_text())
        found += [(path.name, n) for n in calls if n in banned]
    assert not found
