"""The port's closed training loop (moco_tpu_torch/train.py) on the CPU:
resume (four steps in one run equal two steps, a checkpoint and two resumed
steps, bit for bit), the non-finite guard against moco_tpu/train.py (the
same `nonfinite_loss` event lines and `nan_steps`, the same logged steps,
the state rolled back to the same step's, and the abort at the
threshold), metrics.jsonl under the JAX schema and `scripts/obs_report.py
--strict`, the snapshot's rollback of optimizer buffers, and the CLI's new
flags."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core.moco import build_encoder as jax_build_encoder
from moco_tpu.core.moco import create_state as jax_create_state
from moco_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from moco_tpu.obs.schema import validate_line
from moco_tpu.train import train as jax_train
from moco_tpu.utils import config as jc
from moco_tpu.utils import faults as jax_faults
from moco_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from moco_tpu.utils.schedules import build_optimizer as jax_build_optimizer
from moco_tpu_torch import lincls
from moco_tpu_torch import train as train_module
from moco_tpu_torch.core.moco import build_encoder, create_state, make_train_step
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.train import StateSnapshot, train
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = 4
MOCO = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
            shuffle="none", cifar_stem=True, compute_dtype="float32")
OPTIM = dict(lr=0.03, epochs=3, cos=True)
DATA = dict(dataset="synthetic", image_size=16, global_batch=16, num_workers=2)


def _config(workdir, **kw):
    return pc.TrainConfig(moco=pc.MocoConfig(**MOCO), optim=pc.OptimConfig(**OPTIM),
                          data=pc.DataConfig(**DATA), workdir=str(workdir), log_every=1, **kw)


def _lines(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _state_tensors(state):
    out = {f"q.{k}": v for k, v in state.encoder_q.state_dict().items()}
    out.update({f"k.{k}": v for k, v in state.encoder_k.state_dict().items()})
    out["queue"] = state.queue
    for i, p in enumerate(p for g in state.optimizer.param_groups for p in g["params"]):
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"opt.{i}.{k}"] = v
    return out


def test_resume_equals_a_continuous_run(tmp_path):
    """Two epochs of two steps in one run, against one epoch, its
    checkpoint, and a second call that resumes at epoch 1 from it: the
    same losses and the same final state, bit for bit."""
    data = SyntheticDataset(32, 16)
    cfg = dataclasses.replace(_config(tmp_path / "one"),
                              optim=pc.OptimConfig(**{**OPTIM, "epochs": 2}))
    whole = train(cfg, dataset=data, device="cpu", num_filters=NF)
    split_cfg = dataclasses.replace(cfg, workdir=str(tmp_path / "two"))
    first = train(split_cfg, dataset=data, device="cpu", num_filters=NF, steps=2)
    assert CheckpointManager(split_cfg.workdir).all_steps() == [2]
    second = train(split_cfg, dataset=data, device="cpu", num_filters=NF)
    assert [r["step"] for r in second["history"]] == [3, 4]
    losses = [r["loss"] for r in whole["history"]]
    assert losses == [r["loss"] for r in first["history"] + second["history"]]
    a, b = _state_tensors(whole["state"]), _state_tensors(second["state"])
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert whole["state"].queue_ptr == second["state"].queue_ptr
    assert CheckpointManager(split_cfg.workdir).all_steps() == [2, 4]


def _jax_rolled_back(workdir, config):
    """JAX's checkpoints at steps 2 and 4, restored into a template."""
    encoder = jax_build_encoder(config.moco)
    tx = jax_build_optimizer(config.optim, steps_per_epoch=2)
    template = jax_create_state(jax.random.PRNGKey(0), config, encoder, tx,
                                jnp.zeros((1, 16, 16, 3), jnp.float32))
    mgr = JaxCheckpointManager(workdir)
    out = [mgr.restore(template, step=s)[0] for s in (2, 4)]
    mgr.close()
    return out


def test_nan_guard_matches_jax(tmp_path):
    """`nan@step=3,nan@step=5` with threshold 2, log_every 1, epochs of two
    steps. In both packages the loss of step 3 is found non-finite after
    step 4 has run; the state rolls back to step 2's (so the checkpoint at
    the end of epoch 1, step 4, holds step 2's parameters, BN statistics,
    queue and optimizer buffers) while the step counter goes on; step 4's
    line is written; step 5's non-finite loss is the second and aborts.
    Both write the same nonfinite_loss lines and training lines."""
    spec = "nan@step=3,nan@step=5"
    jcfg = jc.TrainConfig(moco=jc.MocoConfig(**MOCO), optim=jc.OptimConfig(**OPTIM),
                          data=jc.DataConfig(**DATA),
                          parallel=jc.ParallelConfig(num_data=1), workdir=str(tmp_path / "jax"),
                          log_every=1, nan_guard_threshold=2, checkpoint_keep=0,
                          health_metrics=False, fleet_metrics=False)
    jax_faults.install(spec)
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            jax_train(jcfg, dataset=JaxSynthetic(num_examples=32, image_size=16))
    finally:
        jax_faults.clear()
    pcfg = _config(tmp_path / "port", nan_guard_threshold=2, checkpoint_keep=0)
    faults.install(spec)
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            train(pcfg, dataset=SyntheticDataset(32, 16), device="cpu", num_filters=NF)
    finally:
        faults.clear()

    def summary(lines):
        events = [(r["step"], r["epoch"], r["nan_steps"]) for r in lines
                  if r.get("event") == "nonfinite_loss"]
        return events, [r["step"] for r in lines if "loss" in r]

    jlines, plines = _lines(jcfg.workdir), _lines(pcfg.workdir)
    assert summary(plines) == summary(jlines) == ([(3, 1, 1), (5, 2, 2)], [1, 2, 4])
    assert next(r for r in plines if r["step"] == 4 and "loss" in r)["nan_steps"] == 1
    # JAX: the checkpoint of step 4 holds step 2's state
    j2, j4 = _jax_rolled_back(jcfg.workdir, jcfg)
    assert int(j4.step) == 4 and int(j2.step) == 2
    for a, b in zip(jax.tree.leaves(j2.replace(step=j4.step)), jax.tree.leaves(j4)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port: the same
    mgr = CheckpointManager(pcfg.workdir)
    assert mgr.all_steps() == [2, 4]
    (p2, _), (p4, e4) = mgr.restore(step=2), mgr.restore(step=4)
    assert e4["epoch"] == 1 and p4["step"] == 4
    for k, v in p2["state_dict"].items():
        assert torch.equal(v, p4["state_dict"][k]), k
    for i, st in p2["optimizer"]["state"].items():
        assert torch.equal(st["momentum_buffer"], p4["optimizer"]["state"][i]["momentum_buffer"])


def test_snapshot_restore_drops_buffers_it_predates():
    """A snapshot taken before the first step restores the initial state:
    SGD's momentum buffers, which appear at that step, go again."""
    cfg = _config("unused")
    state = create_state(cfg, build_encoder(cfg.moco, num_filters=NF), device="cpu")
    before = {k: v.clone() for k, v in _state_tensors(state).items()}
    snap = StateSnapshot(state)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 16, 16, 3),
                                                                  ).astype(np.float32))
    make_train_step(cfg, 2, device="cpu")(state, {"im_q": x[0], "im_k": x[1]})
    assert state.optimizer.state and state.queue_ptr == 16
    snap.restore(state)
    assert not state.optimizer.state and state.queue_ptr == 0 and state.step == 1
    after = _state_tensors(state)
    assert set(after) == set(before)
    for k in before:
        assert torch.equal(before[k], after[k]), k


def test_metrics_jsonl_validates_and_obs_report_strict_passes(tmp_path):
    """Training lines every log step, the kNN monitor's line per epoch and
    a nonfinite_loss event: every line passes the JAX schema's
    validate_line, and obs_report.py --strict exits 0 on the workdir."""
    cfg = dataclasses.replace(_config(tmp_path, knn_every_epochs=1, knn_k=5),
                              optim=pc.OptimConfig(**{**OPTIM, "epochs": 2}))
    faults.install("nan@step=2")
    try:
        out = train(cfg, dataset=SyntheticDataset(32, 16), device="cpu", num_filters=NF,
                    knn_datasets=(SyntheticDataset(24, 16), SyntheticDataset(8, 16)))
    finally:
        faults.clear()
    lines = _lines(tmp_path)
    assert all(validate_line(r) == [] for r in lines)
    assert [r["epoch"] for r in lines if "knn_top1" in r] == [0, 1]
    assert out["nan_steps"] == 1 and out["last_avg"]["knn_top1"] == lines[-1]["knn_top1"]
    train_lines = [r for r in lines if "loss" in r]
    assert all(k in r for r in train_lines for k in ("t_data", "t_step", "t_transfer",
                                                      "transfer_bytes", "prefetch_depth_live"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "obs_report.py"),
                           str(tmp_path), "--strict"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cli_flags_reach_train(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(train_module, "train",
                        lambda config, **kw: seen.update(config=config, **kw))
    assert train_module.main(["--preset", "imagenet_v2", "--data", "synthetic_learnable",
                              "--workdir", str(tmp_path), "--epochs", "2",
                              "--steps-per-epoch", "3", "--knn-every-epochs", "1",
                              "--device", "cpu"]) == 0
    c = seen["config"]
    assert (c.workdir, c.optim.epochs, c.steps_per_epoch, c.knn_every_epochs) == (
        str(tmp_path), 2, 3, 1)
    assert c.data.dataset == "synthetic_learnable" and seen["device"] == "cpu"
    assert pc.PRESETS["imagenet_v2"].workdir is None
    with pytest.raises(TypeError):
        pc.TrainConfig(checkpoint_async=True)


def test_probe_cli_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lincls.main([str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lincls.main([str(tmp_path), "--evaluate"])
