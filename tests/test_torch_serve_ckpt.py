"""Train to serve in the port on the CPU: a port checkpoint read by
`serve/engine.py::load_serving_encoder` and served, held against the JAX
package on the same weights and images.

- ResNet (written by the port's `train()`): the port's f32 engine on the
  restored key encoder against JAX's `InferenceEngine` in f32 on the params
  `import_reference_state_dict` reads from the same file, atol 1e-4 on
  unit-norm embeddings (convolutions sum in other orders); the queue and
  its pointer equal, the encoder bit-equal to the trained one.
- ViT-tiny with flash attention (written with `state_payload`): JAX's
  engine on `convert.encoder_to_flax` weights, its Pallas kernels in
  interpret mode (145 tokens, past the 128 at which JAX's flash path runs
  them), against the port on its plain attention, atol 1e-4; `queue=None`
  and `/neighbors` answering 503 (the port's v3 checkpoint keeps no queue).
- `params_digest`: the port's digest of an encoder equals JAX's
  `quality.params_digest` of the same weights, for a ResNet and a ViT.
- The ViT export: `convert_pretrain`'s timm `.pth` equals JAX's
  `vit_to_timm`, key for key and value for value, for cls and gap pooling;
  the detectron2 format is refused with the root converter's message.
- The server's `metrics.jsonl`: every line passes the port's and JAX's
  `validate_line`; `/admin/model`, `/admin/drain` and `/healthz` while
  draining; the refused later-slice arguments.
- `python -m moco_tpu_torch.serve.replica_main --device cpu` on a tiny
  checkpoint: it answers `/embed`, `/neighbors`, `/stats`, `/admin/model`
  and `/healthz`, writes schema-valid lines, and drains to exit 0 on
  SIGTERM, under a time limit of its own.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.export import vit_to_timm as jax_vit_to_timm
from moco_tpu.import_torch import import_reference_state_dict
from moco_tpu.models import resnet as jax_resnet
from moco_tpu.models import vit as jax_vit
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.models.heads import V3MLPHead as FlaxV3Head
from moco_tpu.obs import quality as jax_quality
from moco_tpu.obs.schema import validate_line as jax_validate_line
from moco_tpu.serve.engine import InferenceEngine as JaxEngine
from moco_tpu.serve.engine import load_serving_encoder as jax_load_serving_encoder
from moco_tpu_torch import convert, convert_pretrain
from moco_tpu_torch.core.moco import build_encoder, build_predictor, create_state, make_train_step
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.obs import quality
from moco_tpu_torch.obs.schema import read_metrics, validate_line
from moco_tpu_torch.obs.sinks import JsonlSink
from moco_tpu_torch.serve import replica_main
from moco_tpu_torch.serve.engine import InferenceEngine, load_serving_encoder
from moco_tpu_torch.serve.index import EmbeddingIndex
from moco_tpu_torch.serve.server import ServeServer
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils.checkpoint import CheckpointManager, state_payload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF, IMG, VIT_IMG, HIDDEN = 4, 16, 48, 32
REPLICA_TIMEOUT_S = 240  # the replica test's own limit: spawn, warmup, requests, drain


def _v2_config(workdir):
    return pc.TrainConfig(
        moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                           cifar_stem=True, compute_dtype="float32"),
        optim=pc.OptimConfig(lr=0.05, epochs=1, cos=True),
        data=pc.DataConfig(dataset="synthetic", image_size=IMG, global_batch=8, num_workers=2),
        steps_per_epoch=2, workdir=workdir)


def _v3_config(pool="cls"):
    return pc.TrainConfig(
        moco=pc.MocoConfig(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99,
                           momentum_cos=True, temperature=0.2, v3=True, shuffle="none",
                           compute_dtype="float32", vit_patch_size=4, vit_pool=pool,
                           vit_flash_attention=True),
        optim=pc.OptimConfig(optimizer="adamw", lr=0.05, weight_decay=0.1, epochs=2, cos=True),
        data=pc.DataConfig(dataset="synthetic", image_size=VIT_IMG, global_batch=4))


def _images(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, size, size, 3), np.uint8)


@pytest.fixture(scope="module")
def v2_ckpt(tmp_path_factory):
    """A port checkpoint of two v2 steps written by `train()`, and the
    trained state."""
    workdir = str(tmp_path_factory.mktemp("v2") / "pre")
    run = train(_v2_config(workdir), dataset=SyntheticDataset(16, IMG), device="cpu",
                num_filters=NF)
    return workdir, run["state"]


def _v3_ckpt(workdir, pool="cls"):
    """Two v3 steps of a ViT-tiny with flash attention (head and predictor
    32 wide) on seeded views, saved through `state_payload`; the state."""
    cfg = dataclasses.replace(_v3_config(pool), workdir=workdir)
    torch.manual_seed(0)
    state = create_state(cfg, build_encoder(cfg.moco, mlp_hidden=HIDDEN), device="cpu",
                         predictor=build_predictor(cfg.moco, mlp_hidden=HIDDEN))
    step = make_train_step(cfg, 2, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        views = rng.standard_normal((2, 4, VIT_IMG, VIT_IMG, 3)).astype(np.float32)
        step(state, {"im_q": torch.from_numpy(views[0]), "im_k": torch.from_numpy(views[1])})
    CheckpointManager(workdir).save(state.step, state_payload(state, "vit_tiny", 1),
                                    extra={"epoch": 0, "config": pc.config_to_dict(cfg)})
    return state


@pytest.fixture(scope="module")
def v3_ckpt(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("v3") / "pre")
    return workdir, _v3_ckpt(workdir)


def _flax_vit_encoder(pool="cls"):
    return FlaxEncoder(
        backbone=jax_vit.create_vit("vit_tiny", image_size=VIT_IMG, patch_size=4, pool=pool,
                                    use_flash_attention=True, dtype=jnp.float32),
        head=FlaxV3Head(num_layers=3, hidden_dim=HIDDEN, dim=16, dtype=jnp.float32))


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k].cpu(), sb[k].cpu()), k


# ------------------------------------------------------ restore and the engine


def test_resnet_checkpoint_serves_as_jax_engine(v2_ckpt):
    """The key side of a `train()` checkpoint: bit-equal to the trained
    key encoder, the queue and pointer equal to the state's and to what JAX
    imports; embeddings within 1e-4 of JAX's engine on the imported params,
    the padded bucket included."""
    workdir, state = v2_ckpt
    encoder, queue, ptr, config = load_serving_encoder(workdir, device="cpu")
    _same_weights(encoder, state.encoder_k)
    assert not encoder.training and config.moco.arch == "resnet18"
    assert torch.equal(queue, state.queue) and ptr == state.queue_ptr == 16
    payload, _ = CheckpointManager(workdir).restore()
    pieces = import_reference_state_dict(
        {k: v.numpy() for k, v in payload["state_dict"].items()}, "resnet18")
    np.testing.assert_array_equal(pieces["queue"], queue.numpy())
    assert pieces["queue_ptr"] == ptr
    enc = FlaxEncoder(
        backbone=jax_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True,
                                          dtype=jnp.float32),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32))
    jax_engine = JaxEngine(enc, pieces["params_k"], pieces["batch_stats_k"], image_size=IMG,
                           buckets=(1, 8))
    port = InferenceEngine(encoder, IMG, buckets=(1, 8), device="cpu")
    for n in (1, 5):
        imgs = _images(n, IMG, seed=n)
        want, want_exec = jax_engine.embed(imgs)
        got, got_exec = port.embed(imgs)
        assert got_exec == want_exec
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    # the query side on request, and JAX's refusal of any other
    q_encoder, *_ = load_serving_encoder(workdir, side="q", device="cpu")
    _same_weights(q_encoder, state.encoder_q)
    with pytest.raises(ValueError) as want_err:
        jax_load_serving_encoder(workdir, side="x")
    with pytest.raises(ValueError) as got_err:
        load_serving_encoder(workdir, side="x", device="cpu")
    assert str(got_err.value) == str(want_err.value)


def test_vit_checkpoint_serves_as_jax_engine_and_has_no_queue(v3_ckpt):
    """ViT-tiny with flash attention: the port's engine (plain attention on
    the CPU) within 1e-4 of JAX's (Pallas in interpret mode) on the
    checkpoint's key encoder; the v3 head's BNs use their running
    statistics. No queue: `/embed` answers and `/neighbors` is a 503."""
    workdir, state = v3_ckpt
    encoder, queue, ptr, config = load_serving_encoder(workdir, device="cpu")
    assert queue is None and ptr == 0 and config.moco.vit_flash_attention
    _same_weights(encoder, state.encoder_k)
    params, stats = convert.encoder_to_flax(encoder.state_dict(), num_heads=3)
    assert set(stats) == {"head"}  # the head's BN statistics; the ViT has none
    jax_engine = JaxEngine(_flax_vit_encoder(), params, stats, image_size=VIT_IMG, buckets=(4,))
    port = InferenceEngine(encoder, VIT_IMG, buckets=(4,), device="cpu")
    imgs = _images(3, VIT_IMG, seed=5)
    want, _ = jax_engine.embed(imgs)
    got, _ = port.embed(imgs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    srv = ServeServer(port, index=None, slo_ms=5000, warmup=False)
    try:
        out = _post(srv.port, "/embed", imgs[:2])
        np.testing.assert_allclose(np.asarray(out["embedding"]), got[:2], atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "/neighbors", imgs[:2])
        assert e.value.code == 503
        e.value.close()
    finally:
        srv.close()


@pytest.mark.parametrize("arch", ["resnet", "vit"])
def test_params_digest_matches_jax(arch, v2_ckpt, v3_ckpt):
    """The port's digest of an encoder equals JAX's `params_digest` of the
    same weights: for the ResNet, the params JAX imports from the port's
    checkpoint; for the ViT, Flax-initialized params carried into the port
    by `encoder_from_flax`."""
    if arch == "resnet":
        workdir, _ = v2_ckpt
        encoder, *_ = load_serving_encoder(workdir, device="cpu")
        payload, _ = CheckpointManager(workdir).restore()
        params = import_reference_state_dict(
            {k: v.numpy() for k, v in payload["state_dict"].items()}, "resnet18")["params_k"]
    else:
        module = _flax_vit_encoder()
        variables = module.init(jax.random.PRNGKey(3), jnp.zeros((1, VIT_IMG, VIT_IMG, 3)),
                                train=False)
        params = jax.device_get(variables["params"])
        encoder = build_encoder(_v3_config().moco, mlp_hidden=HIDDEN)
        encoder.load_state_dict(convert.encoder_from_flax(params, variables["batch_stats"]))
    want = jax_quality.params_digest(params)
    assert quality.encoder_digest(encoder) == want
    assert quality.params_digest(params) == want
    assert quality.model_payload(3, want) == jax_quality.model_payload(3, want)


@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_vit_export_equals_jax_vit_to_timm(tmp_path, pool):
    """`convert_pretrain` on a ViT checkpoint writes timm names equal, key for
    key and value for value, to JAX's `vit_to_timm` of the same query
    backbone; no `cls_token` under gap pooling; `.pkl` is refused."""
    workdir = str(tmp_path / "pre")
    state = _v3_ckpt(workdir, pool)
    pth = str(tmp_path / "vit.pth")
    assert convert_pretrain.main([workdir, pth]) == 0
    got = torch.load(pth, weights_only=True)
    sd = {k[len("backbone."):]: v for k, v in state.encoder_q.state_dict().items()
          if k.startswith("backbone.")}
    want = jax_vit_to_timm(convert.vit_to_flax(sd, num_heads=3), patch_size=4,
                           image_size=VIT_IMG)
    assert set(got) == set(want)
    assert ("cls_token" in got) == (pool == "cls") and len(got) == 3 + 12 * 4 + 2 + (pool == "cls")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    with pytest.raises(SystemExit, match="ViT checkpoints export as a timm state dict"):
        convert_pretrain.main([workdir, str(tmp_path / "vit.pkl")])


# --------------------------------------------------------------- the server


def _post(port, path, imgs=None, timeout=60):
    data = b"" if imgs is None else imgs.tobytes()
    headers = {} if imgs is None else {"X-Image-Shape": ",".join(map(str, imgs.shape))}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def test_server_lines_identity_and_drain(tmp_path, v2_ckpt):
    """A checkpoint's encoder and queue behind a server with a JsonlSink:
    `/admin/model` and every `/stats` carry its step and digest; `POST
    /admin/drain` answers drained and `/healthz` turns not-ok; `close()`
    writes a final line; every line passes both packages' `validate_line`."""
    workdir, state = v2_ckpt
    encoder, queue, ptr, _ = load_serving_encoder(workdir, device="cpu")
    digest = quality.encoder_digest(encoder)
    engine = InferenceEngine(encoder, IMG, buckets=(1, 4), device="cpu")
    index = EmbeddingIndex.from_train_queue(queue, ptr, device="cpu")
    sink = JsonlSink(str(tmp_path / "serve"))
    srv = ServeServer(engine, index=index, slo_ms=5000, neighbors_k=3, sink=sink,
                      metrics_flush_s=0.05, workdir=str(tmp_path / "serve"), replica_index=2,
                      model_step=state.step, model_digest=digest)
    try:
        imgs = _images(3, IMG, seed=9)
        out = _post(srv.port, "/neighbors", imgs)
        emb = np.asarray(out["embedding"], np.float32)
        want = np.argsort(-(emb.astype(np.float64) @ queue.numpy().T.astype(np.float64)), 1)
        np.testing.assert_array_equal(np.asarray(out["indices"])[:, 0], want[:, 0])
        assert _get(srv.port, "/admin/model") == {
            "model_step": state.step, "model_digest": digest, "ingest_ckpt_step": None,
            "replica": 2}
        stats = _get(srv.port, "/stats")
        assert stats["serve/model_digest"] == digest and stats["serve/index_rows"] == 64
        assert _get(srv.port, "/healthz") == {"ok": True, "warm": True, "draining": False,
                                              "replica": 2}
        time.sleep(0.2)  # a few flusher lines
        assert _post(srv.port, "/admin/drain?timeout=10") == {"draining": True, "drained": True,
                                                              "replica": 2}
        assert _get(srv.port, "/healthz")["ok"] is False
        assert srv.drain(timeout=1.0)  # a second drain returns at once
    finally:
        srv.close()
        sink.close()
    lines = read_metrics(str(tmp_path / "serve" / "metrics.jsonl"))
    assert len(lines) >= 2
    for rec in lines:
        assert validate_line(rec) == [] and jax_validate_line(rec) == [], rec
    last = lines[-1]
    assert last["serve/requests"] == 1 and last["serve/model_step"] == state.step
    assert [r["step"] for r in lines] == list(range(1, len(lines) + 1))


def test_server_refuses_later_slice_arguments(v2_ckpt):
    """Request tracing, alerts, the freshness SLO and the rest come with a
    later slice: asking for one raises, the value that asks for none is
    accepted, and an unknown argument is a TypeError; the replica's CLI
    refuses a freshness objective."""
    workdir, _ = v2_ckpt
    encoder, *_ = load_serving_encoder(workdir, device="cpu")
    engine = InferenceEngine(encoder, IMG, buckets=(1,), device="cpu")
    for kw in ({"reqtrace": True}, {"alert_spec": "serve_default"}, {"fresh_max_age_s": 30.0},
               {"slo_objective": 0.99}):
        with pytest.raises(ValueError, match="later slice"):
            ServeServer(engine, **kw)
    with pytest.raises(TypeError, match="unexpected keyword"):
        ServeServer(engine, tracing=True)
    srv = ServeServer(engine, reqtrace=False, fresh_max_age_s=None, metrics_port=0)
    srv.close()
    with pytest.raises(SystemExit, match="freshness SLO comes with a later slice"):
        replica_main.main(["--ckpt-dir", workdir, "--port", "0", "--device", "cpu",
                           "--fresh-max-age-s", "5"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_replica_main_serves_a_checkpoint_and_drains_on_sigterm(tmp_path, v2_ckpt):
    """The replica process on the CPU: it binds after warmup (the test waits
    on /healthz), answers /embed, /neighbors (the checkpoint's queue, ids as
    the in-process engine finds them), /stats and /admin/model (the
    checkpoint's step and the encoder's digest), writes schema-valid lines
    under --workdir, and on SIGTERM drains and exits 0."""
    workdir, state = v2_ckpt
    port, out_dir = _free_port(), str(tmp_path / "replica")
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    env.pop("MOCO_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "moco_tpu_torch.serve.replica_main", "--ckpt-dir", workdir,
         "--port", str(port), "--device", "cpu", "--buckets", "1,4", "--workdir", out_dir,
         "--metrics-flush-s", "0.2", "--replica-index", "1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + REPLICA_TIMEOUT_S
    try:
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "replica never became healthy"
            try:
                health = _get(port, "/healthz", timeout=2)
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.25)
        assert health == {"ok": True, "warm": True, "draining": False, "replica": 1}
        encoder, queue, ptr, _ = load_serving_encoder(workdir, device="cpu")
        local = InferenceEngine(encoder, IMG, buckets=(1, 4), device="cpu")
        imgs = _images(3, IMG, seed=4)
        emb = np.asarray(_post(port, "/embed", imgs)["embedding"], np.float32)
        np.testing.assert_allclose(emb, local.embed(imgs)[0], atol=1e-5)
        out = _post(port, "/neighbors", imgs)
        index = EmbeddingIndex.from_train_queue(queue, ptr, device="cpu")
        np.testing.assert_array_equal(np.asarray(out["indices"]),
                                      index.query(local.embed(imgs)[0], 5)[1])
        assert _get(port, "/admin/model") == {
            "model_step": state.step, "model_digest": quality.encoder_digest(encoder),
            "ingest_ckpt_step": None, "replica": 1}
        assert _get(port, "/stats")["serve/requests"] == 2
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stdout
    assert f"replica 1 serving on http://127.0.0.1:{port}" in stdout
    assert "replica 1 drained (clean) and exited" in stdout
    lines = read_metrics(os.path.join(out_dir, "metrics.jsonl"))
    assert lines and lines[-1]["serve/requests"] == 2
    for rec in lines:
        assert validate_line(rec) == [] and jax_validate_line(rec) == [], rec
