"""Parity of the port's MoCo v3 training slice with the JAX package on the CPU:
three whole v3 steps against JAX `make_train_step` (flash attention, the
Pallas kernels in interpret mode on the JAX side), `state_from_flax` for a
v3 state with Adam moments, the driver, and the EMA momentum ramp shared
by the v1/v2 and v3 steps.

Both packages run in float32 on the same numpy views; each test states its
tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.core.moco import create_state as jax_create_state
from moco_tpu.core.moco import make_train_step as jax_make_train_step
from moco_tpu.core.moco import place_state
from moco_tpu.models import vit as jax_vit
from moco_tpu.models.heads import V3MLPHead as FlaxV3Head
from moco_tpu.parallel import create_mesh, shard_batch
from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch import convert
from moco_tpu_torch.core.moco import build_encoder, create_state, make_ema_momentum, make_train_step
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch import train as train_module
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc

SPE = 2  # steps per epoch: 3 steps cross an epoch boundary of the cosine lr
# 48 px at patch 4: 145 tokens, so JAX takes its Pallas kernels; batch 8,
# the least that JAX's top-5 accuracy over the batch's keys takes
BATCH, IMG = 8, 48
# Hidden width of the v3 heads. A ReLU has a kink at 0: a unit whose input
# lies within the packages' float32 forward difference of zero can be
# active in one and dead in the other (ROADMAP queue 3, the v2 parity
# test's width-8 ResNet). At width 32 from JAX's init key 1, no head or
# predictor ReLU input of the three steps (16 rows per BN) lies within 1e-4 of zero: the
# smallest |input| is 1.1e-3, where widths 48-128 and keys 0-2 came as
# close as 1.9e-6 (`test_no_relu_input_near_zero` keeps the premise).
HIDDEN, INIT_KEY = 32, 1


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _configs(optimizer="sgd"):
    moco = dict(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99, momentum_cos=True,
                temperature=0.2, v3=True, shuffle="none", compute_dtype="float32",
                vit_flash_attention=True, vit_patch_size=4)
    optim = dict(optimizer=optimizer, lr=0.05, momentum=0.9, weight_decay=0.0, epochs=2, cos=True)
    data = dict(dataset="synthetic", image_size=IMG, global_batch=BATCH)
    return (jc.TrainConfig(moco=jc.MocoConfig(**moco), optim=jc.OptimConfig(**optim),
                           data=jc.DataConfig(**data)),
            pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                           data=pc.DataConfig(**data)))


def _flax_modules():
    encoder = FlaxEncoder(
        backbone=jax_vit.create_vit("vit_tiny", patch_size=4, use_flash_attention=True),
        head=FlaxV3Head(num_layers=3, hidden_dim=HIDDEN, dim=16))
    return encoder, FlaxV3Head(num_layers=2, hidden_dim=HIDDEN, dim=16)


def _numpy_state(state):
    """A JAX v3 MocoState's contents as numpy trees, as state_from_flax takes them."""
    return {f: jax.tree.map(np.asarray, getattr(state, f)) for f in (
        "step", "params_q", "batch_stats_q", "params_k", "batch_stats_k", "params_pred",
        "batch_stats_pred")}


def _views(i):
    return np.random.default_rng(20 + i).standard_normal((2, BATCH, IMG, IMG, 3)).astype(np.float32)


def _gauges(metrics) -> dict:
    """A step's health gauges (its metrics beside loss, accuracy and lr)
    as float64 numpy values."""
    return {k: np.asarray(v, np.float64) for k, v in metrics.items()
            if k not in ("loss", "acc1", "acc5", "lr")}


@functools.lru_cache(maxsize=None)
def _trajectories():
    """3 v3 steps of JAX make_train_step on a one-device mesh and of the
    port's, the port starting from state_from_flax of the JAX create_state
    (its own seeded Flax init), both fed the same pre-augmented views."""
    jcfg, pcfg = _configs()
    encoder, predictor = _flax_modules()
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    mesh = create_mesh(num_data=1, num_model=1, devices=jax.devices()[:1])
    jstate = jax_create_state(jax.random.PRNGKey(INIT_KEY), jcfg, encoder, tx,
                              jnp.zeros((1, IMG, IMG, 3)), predictor=predictor)
    init = _numpy_state(jstate)
    pstate = convert.state_from_flax(pcfg, init, device="cpu")
    jstate = place_state(jstate, mesh)
    jstep = jax_make_train_step(jcfg, encoder, tx, mesh, predictor=predictor,
                                total_steps=jcfg.optim.epochs * SPE)
    pstep = make_train_step(pcfg, SPE, device="cpu")
    rng = jax.device_put(jax.random.PRNGKey(3),
                         jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    relu_inputs = []
    hooks = [getattr(head, f"bn{i}").register_forward_hook(
                 lambda _m, _i, o: relu_inputs.append(o.detach().abs().min()))
             for head in (pstate.encoder_q.head, pstate.predictor)
             for i in range(head.num_layers - 1)]  # the BNs in front of a ReLU
    hist = []
    for i in range(3):
        views = _views(i)
        jstate, jm = jstep(jstate, shard_batch(mesh, {"im_q": views[0], "im_k": views[1]}), rng)
        pm = pstep(pstate, {"im_q": _t(views[0]), "im_k": _t(views[1])})
        hist.append(({**{k: float(jm[k]) for k in ("loss", "acc1", "acc5")},
                      "gauges": _gauges(jm)},
                     {**{k: float(pm[k]) for k in ("loss", "acc1", "acc5", "lr")},
                      "gauges": _gauges(pm)}))
    for h in hooks:
        h.remove()
    return init, jstate, pstate, hist, float(min(relu_inputs))


def test_no_relu_input_near_zero():
    """The premise of the tolerances below (see HIDDEN)."""
    assert _trajectories()[4] > 1e-4


def test_three_v3_steps_match_jax():
    """Per step: loss rtol 2e-5 (measured 1.9e-7, 4.9e-6, 7.0e-6: the
    parameters' float32 drift after each update), acc1/acc5 equal. After 3
    steps (SGD, wd 0, the EMA on the cosine ramp): params_q, params_k, the
    predictor and every BN statistic within atol 5e-5 + rtol 1e-5 (measured
    at most 8.5e-6: float32 reassociation through 4 ViT blocks and the
    heads, carried by three momentum-SGD updates); the frozen patch
    embedding of the query encoder bit-equal to its init in both."""
    init, jstate, pstate, hist = _trajectories()[:4]
    for step, (jm, pm) in enumerate(hist):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=2e-5, err_msg=f"step {step}")
        assert pm["acc1"] == jm["acc1"] and pm["acc5"] == jm["acc5"], step
    lrs = [pm["lr"] for _, pm in hist]
    assert lrs[0] == lrs[1] > lrs[2]  # the epoch boundary of the cosine schedule
    pairs = ((pstate.encoder_q.state_dict(), convert.encoder_from_flax(
                 *(jax.tree.map(np.asarray, t) for t in (jstate.params_q, jstate.batch_stats_q)))),
             (pstate.encoder_k.state_dict(), convert.encoder_from_flax(
                 *(jax.tree.map(np.asarray, t) for t in (jstate.params_k, jstate.batch_stats_k)))),
             (pstate.predictor.state_dict(), convert.predictor_from_flax(
                 *(jax.tree.map(np.asarray, t) for t in (jstate.params_pred,
                                                         jstate.batch_stats_pred)))))
    for sd, want in pairs:
        for name, arr in want.items():
            np.testing.assert_allclose(sd[name].numpy(), arr.numpy(), rtol=1e-5, atol=5e-5,
                                       err_msg=name)
    frozen = init["params_q"]["backbone"]["patch_embed"]
    np.testing.assert_array_equal(np.asarray(jstate.params_q["backbone"]["patch_embed"]["kernel"]),
                                  frozen["kernel"])
    got = pstate.encoder_q.state_dict()["backbone.patch_embed.weight"]
    np.testing.assert_array_equal(got.numpy(), convert._conv(frozen["kernel"]))
    assert pstate.step == int(jstate.step) == 3 and pstate.queue is None


def test_remat_leaves_the_v3_step_unchanged():
    """The v3 step with remat (the query encoder's forward recomputed in the
    backward) from the same initial state and views: the same losses and,
    after 3 steps, the same query and key encoders, BN statistics included,
    predictor and momentum buffers within 1e-6 of the step without it."""
    init, _, plain, hist = _trajectories()[:4]
    _, pcfg = _configs()
    pcfg = dataclasses.replace(pcfg, moco=dataclasses.replace(pcfg.moco, remat=True))
    state = convert.state_from_flax(pcfg, init, device="cpu")
    step = make_train_step(pcfg, SPE, device="cpu")
    for i, (_, pm) in enumerate(hist):
        views = _views(i)
        got = step(state, {"im_q": _t(views[0]), "im_k": _t(views[1])})
        np.testing.assert_allclose(float(got["loss"]), pm["loss"], rtol=1e-6)
    for a, b in ((plain.encoder_q, state.encoder_q), (plain.encoder_k, state.encoder_k),
                 (plain.predictor, state.predictor)):
        sd = b.state_dict()
        for name, t in a.state_dict().items():
            np.testing.assert_allclose(sd[name].numpy(), t.numpy(), atol=1e-6, rtol=0,
                                       err_msg=name)
    mine = [p for g in state.optimizer.param_groups for p in g["params"]]
    theirs = [p for g in plain.optimizer.param_groups for p in g["params"]]
    for p, q in zip(mine, theirs):
        for k, v in plain.optimizer.state[q].items():
            np.testing.assert_allclose(state.optimizer.state[p][k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=0)


def test_state_from_flax_carries_a_v3_state_and_adam_moments():
    """A JAX v3 state with AdamW moments (filled with numpy values) becomes
    a port state holding every parameter, statistic, moment and the count
    exactly as the JAX trees hold them; the frozen patch embedding has no
    optimizer state."""
    jcfg, pcfg = _configs("adamw")
    encoder, predictor = _flax_modules()
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    jstate = jax_create_state(jax.random.PRNGKey(1), jcfg, encoder, tx,
                              jnp.zeros((1, IMG, IMG, 3)), predictor=predictor)
    rng = np.random.default_rng(0)
    adam = jstate.opt_state[0]
    moments = {k: jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                               getattr(adam, k)) for k in ("mu", "nu")}
    tree = {**_numpy_state(jstate), "step": 7, "adam": {**moments, "count": 7}}
    state = convert.state_from_flax(pcfg, tree, device="cpu")
    assert state.step == 7 and isinstance(state.optimizer, torch.optim.AdamW)
    want_q = convert.encoder_from_flax(tree["params_q"], tree["batch_stats_q"])
    sd = state.encoder_q.state_dict()
    for name, t in want_q.items():
        np.testing.assert_array_equal(sd[name].numpy(), t.numpy(), err_msg=name)
    for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        enc = convert.encoder_from_flax(moments[moment]["enc"])
        pred = convert.predictor_from_flax(moments[moment]["pred"])
        for module, want in ((state.encoder_q, enc), (state.predictor, pred)):
            for name, p in module.named_parameters():
                if not p.requires_grad:
                    assert p not in state.optimizer.state, name
                    continue
                np.testing.assert_array_equal(state.optimizer.state[p][key].numpy(),
                                              want[name].numpy(), err_msg=name)
                assert float(state.optimizer.state[p]["step"]) == 7.0
    assert not state.encoder_q.backbone.patch_embed.weight.requires_grad


def test_ema_momentum_ramp_matches_jax_and_the_v2_step_uses_it():
    """make_ema_momentum against JAX's expression (moco_tpu/core/moco.py:477)
    evaluated in float32 at every step of a 4-step ramp and past its end
    (clamped); then a v2 step with momentum_cos=True moves the key encoder
    by m(step), not by the constant m: two steps, each leaf of params_k
    equal to m(t) k + (1 - m(t)) q of the pre-update encoders within 1e-6
    (the in-place update rounds in another order), where the constant m
    would leave it off by 1.5e-3 |k - q| at t = 1."""
    m, total = 0.99, 4
    ramp = make_ema_momentum(pc.MocoConfig(momentum=m, momentum_cos=True), total)
    for step in range(total + 3):
        frac = jnp.clip(jnp.asarray(step, jnp.int32).astype(jnp.float32) / total, 0.0, 1.0)
        want = 1.0 - (1.0 - m) * 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
        assert ramp(step) == float(want), step
    assert make_ema_momentum(pc.MocoConfig(momentum=m), total)(3) == m

    cfg = pc.TrainConfig(
        moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64, momentum=m,
                           momentum_cos=True, mlp=True, cifar_stem=True, compute_dtype="float32"),
        optim=pc.OptimConfig(lr=0.05, epochs=2, cos=True),
        data=pc.DataConfig(image_size=16, global_batch=8))
    state = create_state(cfg, build_encoder(cfg.moco, num_filters=4), device="cpu")
    step = make_train_step(cfg, 2, device="cpu")
    ramp = make_ema_momentum(cfg.moco, 4)
    for t in range(2):
        q0 = {n: p.detach().clone() for n, p in state.encoder_q.named_parameters()}
        k0 = {n: p.detach().clone() for n, p in state.encoder_k.named_parameters()}
        views = np.random.default_rng(t).standard_normal((2, 8, 16, 16, 3)).astype(np.float32)
        step(state, {"im_q": _t(views[0]), "im_k": _t(views[1])})
        mt = ramp(t)
        for n, p in state.encoder_k.named_parameters():
            torch.testing.assert_close(p.detach(), k0[n] * mt + q0[n] * (1.0 - mt), atol=1e-6,
                                       rtol=0)
    assert ramp(0) == pytest.approx(m) and m < ramp(1) < ramp(4) == 1.0


def test_v3_train_driver_runs_on_cpu():
    _, cfg = _configs("adamw")
    cfg = dataclasses.replace(cfg, moco=dataclasses.replace(cfg.moco, vit_patch_size=8),
                              data=dataclasses.replace(cfg.data, image_size=32, global_batch=8),
                              obs_probe_every=1)  # step_ms on every record
    out = train(cfg, dataset=SyntheticDataset(32, 32), device="cpu", steps=2)
    state = out["state"]
    assert len(out["history"]) == 2 and state.step == 2 and state.queue is None
    for rec in out["history"]:
        assert all(np.isfinite(rec[k]) for k in ("loss", "acc1", "acc5", "lr", "step_ms"))
    assert isinstance(state.optimizer, torch.optim.AdamW) and state.predictor is not None


def test_train_cli_takes_the_v3_preset_with_its_flags(monkeypatch):
    """`python -m moco_tpu_torch.train --preset vit_b16_v3 --batch-size 256
    --vit-flash-attention` reaches train() with the preset otherwise as it
    stands."""
    seen = {}
    monkeypatch.setattr(train_module, "train", lambda config, **kw: seen.update(config=config, **kw))
    assert train_module.main(["--preset", "vit_b16_v3", "--data", "synthetic", "--steps", "3",
                              "--batch-size", "256", "--vit-flash-attention"]) == 0
    cfg, preset = seen["config"], pc.PRESETS["vit_b16_v3"]
    assert cfg.moco == dataclasses.replace(preset.moco, vit_flash_attention=True)
    assert cfg.data == dataclasses.replace(preset.data, dataset="synthetic", global_batch=256)
    assert cfg.optim == preset.optim and seen["steps"] == 3 and seen["device"] == "cuda"
