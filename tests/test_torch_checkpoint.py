"""The port's checkpoints (moco_tpu_torch/utils/checkpoint.py) on the CPU:
bit-exact round trips of v2 and v3 train states, the fault-tolerance rules
of tests/test_checkpoint.py (keep-N, quarantine and fall-back, every file
corrupt, explicit step, validate_extra before the state read, the
ckpt_truncate fault), the resume compatibility diff, the reference
`.pth.tar` layout read by the JAX package's `import_reference_state_dict`
(the JAX encoder on the imported params within 1e-4 of the port's features
in float32), and `convert.encoder_to_flax` as the inverse of
`encoder_from_flax` on Flax-initialized trees (exact); async saves (the
file holds the state as of `save()` though the next steps update it in
place, ckpt_truncate, a failed write, a resumed run bit for bit), the
guard snapshot's emergency payload, and the driver's new config fields; the
eval side's shared restore (`lincls.restore_pretrain_state`): both encoders
bit for bit at the checkpoint's widths, the queue's rows and pointer, a v3
checkpoint's missing queue, the config from the extras or given, and the
fall-back past a torn newest file."""

import dataclasses
import os
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.import_torch import import_reference_state_dict
from moco_tpu.models import resnet as jax_resnet
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.models.heads import V3MLPHead as FlaxV3Head
from moco_tpu.models.vit import create_vit as jax_create_vit
from moco_tpu_torch import convert
from moco_tpu_torch.core.moco import build_encoder, build_predictor, create_state, make_train_step
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import checkpoint as checkpoint_module
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.checkpoint import (
    CheckpointCorruptionError,
    CheckpointManager,
    best_exists,
    load_state_payload,
    restore_best,
    save_best,
    state_payload,
)

NF = 4


def _v2_config():
    return pc.TrainConfig(
        moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                           cifar_stem=True, compute_dtype="float32"),
        optim=pc.OptimConfig(lr=0.05, epochs=2, cos=True),
        data=pc.DataConfig(dataset="synthetic", image_size=16, global_batch=8))


def _v3_config():
    return pc.TrainConfig(
        moco=pc.MocoConfig(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99,
                           momentum_cos=True, temperature=0.2, v3=True, shuffle="none",
                           compute_dtype="float32", vit_patch_size=8),
        optim=pc.OptimConfig(optimizer="adamw", lr=0.05, weight_decay=0.1, epochs=2, cos=True),
        data=pc.DataConfig(dataset="synthetic", image_size=16, global_batch=4))


def _state(cfg, seed=0):
    torch.manual_seed(seed)
    if cfg.moco.v3:
        return create_state(cfg, build_encoder(cfg.moco, mlp_hidden=32), device="cpu",
                            predictor=build_predictor(cfg.moco, mlp_hidden=32))
    return create_state(cfg, build_encoder(cfg.moco, num_filters=NF), device="cpu")


def _stepped(cfg, steps=2, seed=0):
    """A state after `steps` train steps on seeded views, so BN statistics,
    the queue and the optimizer's buffers all hold non-initial values."""
    state = _state(cfg, seed)
    step = make_train_step(cfg, 2, device="cpu")
    rng = np.random.default_rng(seed)
    b, s = cfg.data.global_batch, cfg.data.image_size
    for _ in range(steps):
        views = rng.standard_normal((2, b, s, s, 3)).astype(np.float32)
        step(state, {"im_q": torch.from_numpy(views[0]), "im_k": torch.from_numpy(views[1])})
    return state


def _everything(state):
    """Every tensor a restore must bring back, by name."""
    out = {f"q.{k}": v for k, v in state.encoder_q.state_dict().items()}
    out.update({f"k.{k}": v for k, v in state.encoder_k.state_dict().items()})
    if state.predictor is not None:
        out.update({f"p.{k}": v for k, v in state.predictor.state_dict().items()})
    if state.queue is not None:
        out["queue"] = state.queue
    for i, p in enumerate(p for g in state.optimizer.param_groups for p in g["params"]):
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"opt.{i}.{k}"] = v if torch.is_tensor(v) else torch.tensor(v)
    return out


def _assert_same_state(a, b):
    ta, tb = _everything(a), _everything(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (a.step, a.queue_ptr) == (b.step, b.queue_ptr)


@pytest.mark.parametrize("make_config", [_v2_config, _v3_config], ids=["v2", "v3"])
def test_roundtrip_is_bit_exact(tmp_path, make_config):
    cfg = make_config()
    state = _stepped(cfg)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state.step, state_payload(state, cfg.moco.arch, 1), extra={"epoch": 0})
    payload, extra = mgr.restore()
    fresh = _state(cfg, seed=1)  # other weights, no optimizer state yet
    load_state_payload(fresh, payload)
    _assert_same_state(state, fresh)
    assert extra == {"epoch": 0} and payload["epoch"] == 1 and payload["arch"] == cfg.moco.arch
    # the payload holds only what a weights-only load accepts
    torch.load(mgr.path(state.step), weights_only=True)


def test_keep_last_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.full((3,), float(step))}, extra={"epoch": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    payload, extra = mgr.restore()
    assert torch.equal(payload["x"], torch.full((3,), 3.0)) and extra["epoch"] == 3
    everything = CheckpointManager(str(tmp_path / "all"), keep=0)
    for step in range(5):
        everything.save(step, {"x": torch.zeros(1)})
    assert everything.all_steps() == [0, 1, 2, 3, 4]


def test_restore_errors_when_empty(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore()
    assert CheckpointManager(str(tmp_path)).latest_step() is None


def test_best_snapshot(tmp_path):
    assert not best_exists(str(tmp_path))
    save_best(str(tmp_path), {"w": torch.ones(2)}, metric=12.5)
    save_best(str(tmp_path), {"w": torch.full((2,), 2.0)}, metric=40.0)
    payload, metric = restore_best(str(tmp_path))
    assert best_exists(str(tmp_path)) and metric == 40.0
    assert torch.equal(payload["w"], torch.full((2,), 2.0))


def _truncate(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def test_corrupt_latest_falls_back_and_quarantines(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for step in (2, 4):
        mgr.save(step, {"x": torch.full((4,), float(step))}, extra={"epoch": step})
    _truncate(mgr.path(4))
    payload, extra = mgr.restore()
    assert extra["epoch"] == 2 and torch.equal(payload["x"], torch.full((4,), 2.0))
    assert mgr.all_steps() == [2]
    assert os.listdir(tmp_path / "quarantine") == [os.path.basename(mgr.path(4))]


def test_all_corrupt_raises_corruption_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 2):
        mgr.save(step, {"x": torch.zeros(8)})
        _truncate(mgr.path(step))
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore()
    assert len(os.listdir(tmp_path / "quarantine")) == 2


def test_explicit_step_restore_does_not_fall_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 2):
        mgr.save(step, {"x": torch.zeros(8)})
    _truncate(mgr.path(2))
    with pytest.raises(Exception):
        mgr.restore(step=2)
    assert mgr.all_steps() == [1, 2]  # nothing quarantined
    assert mgr.restore(step=1)[1] == {}


def test_latest_step_skips_torn_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(2)}, extra={"epoch": 0})
    open(mgr.path(5), "wb").close()  # a zero-length file named as a good one
    assert mgr.latest_step() == 1
    assert os.path.exists(tmp_path / "quarantine" / os.path.basename(mgr.path(5)))
    assert mgr.read_extra() == {"epoch": 0}


def test_validate_extra_incompat_fails_fast_without_quarantine(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": torch.zeros(2)}, extra={"config": {"moco": {"dim": 32}}})
    seen = []

    def reject(extra):
        seen.append(extra)
        raise pc.ResumeCompatError("dim differs")

    with pytest.raises(pc.ResumeCompatError):
        mgr.restore(validate_extra=reject)
    assert seen and not os.path.exists(tmp_path / "quarantine") and mgr.all_steps() == [3]


def test_ckpt_truncate_fault_injection_roundtrip(tmp_path):
    faults.install("ckpt_truncate@step=4")
    try:
        mgr = CheckpointManager(str(tmp_path))
        for step in (2, 4):
            mgr.save(step, {"x": torch.full((64,), float(step))}, extra={"epoch": step})
    finally:
        faults.clear()
    assert mgr.latest_step() == 2  # the torn file is found structurally
    assert torch.equal(mgr.restore()[0]["x"], torch.full((64,), 2.0))
    assert os.listdir(tmp_path / "quarantine") == [os.path.basename(mgr.path(4))]


def test_resume_compat_diff_fields():
    cfg = _v2_config()
    saved = {"config": pc.config_to_dict(cfg)}
    assert pc.resume_compat_diff(saved, cfg) == []
    assert pc.resume_compat_diff({}, cfg) == []  # a checkpoint without a config
    tunable = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, lr=1.0, epochs=9))
    assert pc.resume_compat_diff(saved, tunable) == []
    bad = dataclasses.replace(cfg, moco=dataclasses.replace(cfg.moco, dim=32, arch="resnet50"),
                              data=dataclasses.replace(cfg.data, image_size=32))
    diffs = pc.resume_compat_diff(saved, bad)
    assert sorted(d.split(":")[0] for d in diffs) == ["data.image_size", "moco.arch", "moco.dim"]
    assert pc.config_from_dict(saved["config"]) == cfg


def test_jax_imports_a_port_checkpoint(tmp_path):
    """The reference layout: JAX's `import_reference_state_dict` reads the
    port's file; the Flax encoder on the imported params gives the port's
    features (eval mode) within 1e-4 in float32, and the queue and its
    pointer come back exactly."""
    cfg = _v2_config()
    state = _stepped(cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state_payload(state, "resnet18", 1))
    payload = torch.load(mgr.path(state.step), weights_only=True)
    sd = {k: v.numpy() for k, v in payload["state_dict"].items()}
    pieces = import_reference_state_dict(sd, "resnet18")
    assert pieces["mlp"] and pieces["dim"] == 16 and pieces["queue_ptr"] == state.queue_ptr
    np.testing.assert_array_equal(pieces["queue"], state.queue.numpy())
    flax_enc = FlaxEncoder(
        backbone=jax_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True,
                                          dtype=jnp.float32),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32))
    x = np.random.default_rng(3).standard_normal((4, 16, 16, 3)).astype(np.float32)
    for side, enc in (("q", state.encoder_q), ("k", state.encoder_k)):
        want = flax_enc.apply({"params": pieces[f"params_{side}"],
                               "batch_stats": pieces[f"batch_stats_{side}"]},
                              jnp.asarray(x), train=False)
        with torch.no_grad():
            got = enc.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _flax_trees(module, x):
    """(params, batch_stats) shaped as Flax's init makes them, filled with
    seeded values (the init's structure without its cost)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                train=False))
    rng = np.random.default_rng(0)
    fill = lambda a: rng.standard_normal(a.shape).astype(np.float32)  # noqa: E731
    return (jax.tree.map(fill, fnn.meta.unbox(shapes["params"])),
            jax.tree.map(fill, shapes.get("batch_stats", {})))


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("kind", ["resnet_v1", "resnet_v2", "resnet50_v2", "vit_v3"])
def test_encoder_to_flax_inverts_encoder_from_flax(kind):
    if kind == "vit_v3":
        backbone = jax_create_vit("vit_tiny", image_size=16, patch_size=8, dtype=jnp.float32)
        head = FlaxV3Head(num_layers=3, hidden_dim=32, dim=16, dtype=jnp.float32)
    else:
        arch = "resnet50" if kind == "resnet50_v2" else "resnet18"
        backbone = jax_resnet.create_resnet(arch, num_filters=NF, cifar_stem=arch == "resnet18",
                                            dtype=jnp.float32)
        head = FlaxHead(dim=16, mlp=kind != "resnet_v1", dtype=jnp.float32)
    x = np.zeros((2, 16, 16, 3), np.float32)
    params, stats = _flax_trees(FlaxEncoder(backbone=backbone, head=head), x)
    sd = convert.encoder_from_flax(params, stats)
    back_params, back_stats = convert.encoder_to_flax(sd, num_heads=3)
    _assert_trees_equal(params, back_params)
    _assert_trees_equal(stats, back_stats)


def test_convert_pretrain_matches_jax_export(tmp_path):
    """`python -m moco_tpu_torch.convert_pretrain`: the `.pth` loads with
    strict=True into a fresh port backbone and gives the query encoder's
    features bit for bit; the detectron2 pickle equals, key for key and
    bit for bit, the one the JAX package's export writes from the same
    checkpoint read through `import_reference_state_dict`."""
    import pickle

    from moco_tpu.export import resnet_to_torchvision, save_detectron2_pickle
    from moco_tpu_torch import convert_pretrain
    from moco_tpu_torch.models.resnet import create_resnet

    cfg = _v2_config()
    state = _stepped(cfg)
    mgr = CheckpointManager(str(tmp_path / "w"))
    mgr.save(state.step, state_payload(state, "resnet18", 1),
             extra={"epoch": 0, "config": pc.config_to_dict(cfg)})
    pth, pkl = str(tmp_path / "b.pth"), str(tmp_path / "b.pkl")
    assert convert_pretrain.main([str(tmp_path / "w"), pth]) == 0
    assert convert_pretrain.main([str(tmp_path / "w"), pkl]) == 0
    fresh = create_resnet("resnet18", num_filters=NF, cifar_stem=True)
    fresh.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(fresh.eval()(x), state.encoder_q.backbone.eval()(x))
    payload = torch.load(mgr.path(state.step), weights_only=True)
    pieces = import_reference_state_dict({k: v.numpy() for k, v in payload["state_dict"].items()},
                                         "resnet18")
    save_detectron2_pickle(resnet_to_torchvision(pieces["params_q"]["backbone"],
                                                 pieces["batch_stats_q"]["backbone"],
                                                 stage_sizes=(2, 2, 2, 2)),
                           str(tmp_path / "jax.pkl"))
    with open(pkl, "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    assert {k: v for k, v in got.items() if k != "model"} == \
        {k: v for k, v in want.items() if k != "model"}
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        np.testing.assert_array_equal(got["model"][k], v, err_msg=k)


# ------------------------------------------------------------ async saves


def _slow_writes(monkeypatch, seconds=0.3):
    """Delay every background write, so the steps after `save()` surely run
    before the file is written."""
    real = checkpoint_module._write_atomic

    def slow(path, payload):
        time.sleep(seconds)
        real(path, payload)

    monkeypatch.setattr(checkpoint_module, "_write_atomic", slow)


@pytest.mark.parametrize("make_config", [_v2_config, _v3_config], ids=["v2", "v3"])
def test_async_roundtrip_with_wait(tmp_path, make_config):
    """An async save restores bit for bit after `wait()`; `all_steps` and
    `restore` wait on their own."""
    cfg = make_config()
    state = _stepped(cfg)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(state.step, state_payload(state, cfg.moco.arch, 1), extra={"epoch": 0})
    mgr.wait()
    assert mgr.all_steps() == [state.step]
    fresh = _state(cfg, seed=1)
    payload, extra = mgr.restore()
    load_state_payload(fresh, payload)
    _assert_same_state(state, fresh)
    assert extra == {"epoch": 0}
    torch.load(mgr.path(state.step), weights_only=True)


def test_async_save_holds_the_state_as_of_save(tmp_path, monkeypatch):
    """The state is updated in place: two more train steps right after
    `save()` returns (while the write is held back) must not reach the
    file, which holds the values of the moment of `save()`, bit for bit.
    The host buffers are reused, so a second save waits for the first
    write, and keep-N runs on the background thread."""
    _slow_writes(monkeypatch)
    cfg = _v2_config()
    state = _stepped(cfg)
    before = {k: v.clone() for k, v in _everything(state).items()}
    step_at_save, ptr_at_save = state.step, state.queue_ptr
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    mgr.save(state.step, state_payload(state, cfg.moco.arch, 1))
    step = make_train_step(cfg, 2, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(2):
        views = rng.standard_normal((2, 8, 16, 16, 3)).astype(np.float32)
        step(state, {"im_q": torch.from_numpy(views[0]), "im_k": torch.from_numpy(views[1])})
    moved = _everything(state)
    assert not torch.equal(moved["queue"], before["queue"])  # the steps did write in place
    fresh = _state(cfg, seed=1)
    payload, _ = mgr.restore(step=step_at_save)
    load_state_payload(fresh, payload)
    got = _everything(fresh)
    assert set(got) == set(before)
    for k, v in before.items():
        assert torch.equal(got[k], v), k
    assert (fresh.step, fresh.queue_ptr) == (step_at_save, ptr_at_save)
    mgr.save(state.step, state_payload(state, cfg.moco.arch, 2))
    assert mgr.all_steps() == [state.step]  # keep=1 pruned the first file


def test_async_ckpt_truncate_still_falls_back(tmp_path, monkeypatch):
    """Under async saves the fault waits for the write to land, then halves
    it: the restore falls back to the older step and quarantines the torn
    file, as with blocking saves."""
    _slow_writes(monkeypatch, 0.1)
    faults.install("ckpt_truncate@step=4")
    try:
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        for step in (2, 4):
            mgr.save(step, {"x": torch.full((64,), float(step))}, extra={"epoch": step})
    finally:
        faults.clear()
    assert mgr.latest_step() == 2
    assert torch.equal(mgr.restore()[0]["x"], torch.full((64,), 2.0))
    assert os.listdir(tmp_path / "quarantine") == [os.path.basename(mgr.path(4))]


def test_async_write_failure_reaches_the_caller(tmp_path, monkeypatch):
    def broken(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint_module, "_write_atomic", broken)
    monkeypatch.setattr(checkpoint_module.retry, "retry_call", lambda fn, *a, site, **k: fn(*a))
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    mgr.save(2, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError):
        mgr.close()


def test_async_run_resumes_like_a_continuous_run(tmp_path):
    """checkpoint_async=True: two epochs in one run against one epoch, its
    async checkpoint and a resumed second epoch: the same losses and the
    same final state, bit for bit."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train

    data = SyntheticDataset(16, 16)
    cfg = dataclasses.replace(_v2_config(), workdir=str(tmp_path / "one"), log_every=1,
                              checkpoint_async=True)
    whole = train(cfg, dataset=data, device="cpu", num_filters=NF)
    split = dataclasses.replace(cfg, workdir=str(tmp_path / "two"))
    first = train(split, dataset=data, device="cpu", num_filters=NF, steps=2)
    second = train(split, dataset=data, device="cpu", num_filters=NF)
    assert [r["step"] for r in second["history"]] == [3, 4]
    assert [r["loss"] for r in whole["history"]] == [
        r["loss"] for r in first["history"] + second["history"]]
    _assert_same_state(whole["state"], second["state"])
    assert CheckpointManager(split.workdir).all_steps() == [2, 4]


def test_snapshot_payload_is_the_state_at_take(tmp_path):
    """The guard's snapshot, saved after the state moved on (the watchdog's
    and a fatal alert's emergency save), restores the state of the moment
    of `take`, bit for bit, at that step."""
    from moco_tpu_torch.train import StateSnapshot

    for cfg in (_v2_config(), _v3_config()):
        state = _stepped(cfg)
        snap = StateSnapshot(state)
        want = {k: v.clone() for k, v in _everything(state).items()}
        at = (state.step, state.queue_ptr)
        more = _stepped(cfg, steps=1, seed=3)  # other values, same structure
        load_state_payload(state, state_payload(more, cfg.moco.arch, 1) | {"step": 9})
        mgr = CheckpointManager(str(tmp_path / cfg.moco.arch))
        mgr.save(snap.step, snap.payload(state, cfg.moco.arch, 1))
        fresh = _state(cfg, seed=1)
        load_state_payload(fresh, mgr.restore()[0])
        got = _everything(fresh)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        assert (fresh.step, fresh.queue_ptr) == at


def test_driver_fields_round_trip_and_do_not_block_a_resume():
    """The fault-tolerance and health fields go through config_to_dict /
    config_from_dict and, as in JAX, are no resume-compat fields."""
    cfg = _v2_config()
    changed = dataclasses.replace(cfg, checkpoint_async=True, watchdog_timeout=15.0,
                                  health_metrics=False, alert_rules="none", alerts_fatal=True,
                                  heartbeat_timeout=30.0)
    assert pc.config_from_dict(pc.config_to_dict(changed)) == changed
    assert pc.resume_compat_diff({"config": pc.config_to_dict(cfg)}, changed) == []
    from moco_tpu.utils import config as jc

    for f in ("checkpoint_async", "watchdog_timeout", "health_metrics", "alert_rules",
              "alerts_fatal", "heartbeat_timeout"):
        assert getattr(pc.TrainConfig(), f) == getattr(jc.TrainConfig(), f), f


def test_bn_and_optimizer_fields_round_trip_and_do_not_block_a_resume():
    """The BN, EMAN, remat, LARS and auto_scale fields go through
    config_to_dict / config_from_dict and, as in JAX, are no resume-compat
    fields; their defaults are JAX's."""
    from moco_tpu.utils import config as jc

    cfg = _v2_config()
    changed = dataclasses.replace(
        cfg, auto_scale="ref_batch=16",
        moco=dataclasses.replace(cfg.moco, bn_stats_rows=3, bn_stats_barrier=True,
                                 bn_virtual_groups=2, allow_leaky_bn=True,
                                 bn_momentum_stats=True, key_bn_running_stats=True,
                                 key_bn_stats_warmup=False, remat=True),
        optim=dataclasses.replace(cfg.optim, optimizer="lars", trust_coefficient=0.002))
    assert pc.config_from_dict(pc.config_to_dict(changed)) == changed
    assert pc.resume_compat_diff({"config": pc.config_to_dict(cfg)}, changed) == []
    for section, fields in (("moco", ("bn_stats_rows", "bn_stats_barrier", "bn_virtual_groups",
                                      "allow_leaky_bn", "bn_momentum_stats",
                                      "key_bn_running_stats", "key_bn_stats_warmup", "remat")),
                            ("optim", ("trust_coefficient",))):
        for f in fields:
            assert getattr(getattr(pc.TrainConfig(), section), f) == getattr(
                getattr(jc.TrainConfig(), section), f), f
    assert pc.TrainConfig().auto_scale == jc.TrainConfig().auto_scale


def test_state_from_flax_carries_the_lars_trace():
    """JAX's LARS state after 3 steps (the large-batch option of
    test_torch_train.py: LARS, momentum-statistics BN, auto_scale), through
    state_from_flax: its `trace`s are optax's trace (the chain's last
    element) exactly, and within rtol 1e-3 / atol 5e-4 of the port's own
    after the same 3 steps (the trajectories' tolerance)."""
    from test_torch_train import NF as TRAIN_NF
    from test_torch_train import _configs, _numpy_state, _trajectories

    variant = "momentum_stats_lars_auto_scale"
    jstate, pstate, _ = _trajectories(True, variant)
    pcfg = pc.apply_auto_scale(_configs(True, variant)[1])[0]
    tree = _numpy_state(jstate, "lars")
    conv = convert.state_from_flax(pcfg, tree, device="cpu", num_filters=TRAIN_NF)
    want = convert.encoder_from_flax(tree["trace"])
    mine = dict(pstate.encoder_q.named_parameters())
    for name, p in conv.encoder_q.named_parameters():
        trace = conv.optimizer.state[p]["trace"]
        assert torch.equal(trace, want[name]), name
        np.testing.assert_allclose(trace.numpy(), pstate.optimizer.state[mine[name]]["trace"]
                                   .numpy(), rtol=1e-3, atol=5e-4, err_msg=name)
        assert "momentum_buffer" not in conv.optimizer.state[p]


def test_lars_run_resumes_like_a_continuous_run(tmp_path):
    """A LARS run with momentum-statistics BN and auto_scale (the
    large-batch preset's options): two epochs in one run against one
    epoch, its checkpoint and a resumed second epoch give the same losses
    and the same final state, LARS's traces included, bit for bit."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train

    data = SyntheticDataset(16, 16)
    base = _v2_config()
    cfg = dataclasses.replace(
        base, workdir=str(tmp_path / "one"), log_every=1, auto_scale="ref_batch=16",
        moco=dataclasses.replace(base.moco, bn_momentum_stats=True),
        optim=dataclasses.replace(base.optim, optimizer="lars", lr=4.8, weight_decay=1e-6,
                                  warmup_epochs=1))
    whole = train(cfg, dataset=data, device="cpu", num_filters=NF)
    split = dataclasses.replace(cfg, workdir=str(tmp_path / "two"))
    first = train(split, dataset=data, device="cpu", num_filters=NF, steps=2)
    second = train(split, dataset=data, device="cpu", num_filters=NF)
    assert [r["step"] for r in second["history"]] == [3, 4]
    assert [r["loss"] for r in whole["history"]] == [
        r["loss"] for r in first["history"] + second["history"]]
    _assert_same_state(whole["state"], second["state"])
    assert any(k.endswith(".trace") for k in _everything(second["state"]))
    lrs = [r["lr"] for r in whole["history"]]  # auto-scaled 4.8 -> 2.4, warmup, cosine
    np.testing.assert_allclose(lrs, [1.2, 2.4, 1.2, 1.2], rtol=1e-6)


# ------------------------------------------------- the eval side's restore


@pytest.mark.parametrize("make_config", [_v2_config, _v3_config], ids=["v2", "v3"])
def test_restore_pretrain_state_reads_both_sides_bit_for_bit(tmp_path, make_config):
    """Both sides rebuilt at the checkpoint's widths (a ResNet's stem 4
    wide, a v3 head 32 wide) and loaded bit for bit, in eval mode; the
    queue back as (K, dim) rows with its pointer, or None for v3; the
    step; the config from the extras."""
    from moco_tpu_torch.lincls import restore_pretrain_state

    cfg = make_config()
    state = _stepped(cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state_payload(state, cfg.moco.arch, 1),
             extra={"epoch": 0, "config": pc.config_to_dict(cfg)})
    restored = restore_pretrain_state(str(tmp_path), sides=("q", "k"), device="cpu")
    assert restored.config == cfg and restored.step == state.step == 2
    for side, enc in (("q", state.encoder_q), ("k", state.encoder_k)):
        got, want = restored.encoders[side].state_dict(), enc.state_dict()
        assert list(got) == list(want) and not restored.encoders[side].training
        for k in want:
            assert torch.equal(got[k], want[k]), (side, k)
    if cfg.moco.v3:
        assert restored.queue is None and restored.queue_ptr == 0
    else:
        assert torch.equal(restored.queue, state.queue) and restored.queue.shape == (64, 16)
        assert restored.queue_ptr == state.queue_ptr == 16
    only_k = restore_pretrain_state(str(tmp_path), sides=("k",), device="cpu")
    assert set(only_k.encoders) == {"k"}
    with pytest.raises(ValueError, match="sides"):
        restore_pretrain_state(str(tmp_path), sides=("x",), device="cpu")


def test_restore_pretrain_state_config_and_fallback(tmp_path):
    """Without a config in the extras one must be passed (and a passed one
    is used as given); a torn newest checkpoint is quarantined and the
    next older one read."""
    from moco_tpu_torch.lincls import restore_pretrain_state

    cfg = _v2_config()
    state = _stepped(cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_payload(state, "resnet18", 1), extra={"epoch": 0})
    with pytest.raises(KeyError, match="carries no config"):
        restore_pretrain_state(str(tmp_path), device="cpu")
    assert restore_pretrain_state(str(tmp_path), cfg, device="cpu").step == 1
    mgr.save(2, state_payload(state, "resnet18", 1), extra={"epoch": 1})
    _truncate(mgr.path(2))
    restored = restore_pretrain_state(str(tmp_path), cfg, device="cpu")
    assert restored.step == 1 and mgr.all_steps() == [1]
