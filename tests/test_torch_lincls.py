"""The port's linear probe (moco_tpu_torch/lincls.py) and its input
(LabeledPipeline, EvalPipeline, PROBE_RECIPE) against moco_tpu on the CPU,
float32 on both sides, on a ResNet and on a ViT-tiny with flash attention
(JAX's Pallas kernels in interpret mode at 145 tokens, the port's plain
attention): three probe steps within 1e-5 of JAX's
`make_probe_step` (loss, accuracies, classifier weights), the eval step's
masked sums within 1e-5 relative (counts exact) with a padded tail, the
evaluation batches within 1e-6 and their labels and masks equal to JAX's
`EvalPipeline`, the probe recipe within 1e-5 in pixel units on given
draws; and, in the port alone,
the frozen backbone (BN statistics unchanged, `sanity_check` catching a
changed weight) and a whole CPU run: pretrain -> probe -> `evaluate_lincls`
scoring model_best at the best epoch's top-1 exactly, for a ResNet and for
a ViT checkpoint."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from moco_tpu import lincls as jax_lincls
from moco_tpu.data import augment as ja
from moco_tpu.data.datasets import LearnableSyntheticDataset as JaxLearnable
from moco_tpu.data.pipeline import EvalPipeline as JaxEvalPipeline
from moco_tpu.models import LinearClassifier as JaxLinear
from moco_tpu.models import resnet as jax_resnet
from moco_tpu.models import vit as jax_vit
from moco_tpu.obs.schema import validate_file
from moco_tpu.parallel import create_mesh
from moco_tpu.utils import config as jc
from moco_tpu_torch import convert, lincls
from moco_tpu_torch.data import augment as ta
from moco_tpu_torch.data.datasets import LearnableSyntheticDataset
from moco_tpu_torch.data.pipeline import EvalPipeline, LabeledPipeline
from moco_tpu_torch.models import resnet as port_resnet
from moco_tpu_torch.models import vit as port_vit
from moco_tpu_torch.models.heads import LinearClassifier
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc
from test_torch_augment import recipe_draws
from test_torch_serve_ckpt import _v3_ckpt
from test_torch_vit import fill

NF, IMG, CLASSES, B = 4, 16, 8, 8
VIT_IMG = 48  # patch 4: 144 patches + cls, past the 128 tokens at which JAX runs Pallas


def _backbones(arch):
    """(JAX backbone, port backbone, input size) of the arch."""
    if arch == "vit":
        return (jax_vit.create_vit("vit_tiny", image_size=VIT_IMG, patch_size=4,
                                   use_flash_attention=True, dtype=jnp.float32),
                port_vit.create_vit("vit_tiny", image_size=VIT_IMG, patch_size=4,
                                    use_flash_attention=True), VIT_IMG)
    return (jax_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True,
                                     dtype=jnp.float32),
            port_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True), IMG)


@pytest.fixture(scope="module", params=["resnet", "vit"])
def probe_pair(request):
    """The same seeded backbone (a ResNet, or a ViT with flash attention)
    and classifier in both packages, and JAX's probe state, optimizer and
    one-device mesh."""
    backbone, port, size = _backbones(request.param)
    classifier = JaxLinear(num_classes=CLASSES)
    shapes = jax.eval_shape(lambda: backbone.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(11)
    if request.param == "vit":
        params, stats = fill(shapes["params"], seed=11), {}
    else:
        params = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
                              shapes["params"])
        stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                             shapes["batch_stats"])
    probe = pc.ProbeConfig(lr=0.5, momentum=0.9, weight_decay=0.01, schedule=(1, 2), epochs=3,
                           num_classes=CLASSES)
    jprobe = jc.ProbeConfig(**dataclasses.asdict(probe))
    tx = jax_lincls._probe_tx(jprobe, 1)
    state = jax_lincls._probe_template(tx, backbone, classifier, params, stats)
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    sd = (convert.vit_from_flax(params) if request.param == "vit"
          else convert.backbone_from_flax(params, stats))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    port.eval().requires_grad_(False)
    fc = LinearClassifier(port.num_features, CLASSES)
    dense = state.fc_params["Dense_0"]
    fc.load_state_dict({"weight": torch.from_numpy(np.array(dense["kernel"]).T.copy()),
                        "bias": torch.from_numpy(np.array(dense["bias"]))})
    return dict(backbone=backbone, classifier=classifier, tx=tx, state=state, mesh=mesh,
                probe=probe, port=port, fc=fc, size=size, arch=request.param)


def _put(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, PartitionSpec("data")))


def test_three_probe_steps_match_jax(probe_pair):
    p = probe_pair
    jstep = jax_lincls.make_probe_step(p["backbone"], p["classifier"], p["tx"], p["mesh"])
    fc = LinearClassifier(p["port"].num_features, CLASSES)
    fc.load_state_dict(p["fc"].state_dict())
    optimizer, schedule = lincls._probe_tx(p["probe"], 1, fc.parameters())
    pstep = lincls.make_probe_step(p["port"], fc, optimizer, schedule)
    stats_before = {k: v.clone() for k, v in p["port"].state_dict().items()}
    state, rng, size = p["state"], np.random.default_rng(4), p["size"]
    for n in range(3):  # the lr is cut x0.1 after each step (schedule (1, 2), one step an epoch)
        x = rng.standard_normal((B, size, size, 3)).astype(np.float32)
        y = rng.integers(0, CLASSES, B).astype(np.int32)
        state, want = jstep(state, _put(p["mesh"], x), _put(p["mesh"], y))
        got = pstep(n, torch.from_numpy(x), torch.from_numpy(y).long())
        for k in ("loss", "acc1", "acc5"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(fc.weight.detach().numpy(),
                                   np.asarray(state.fc_params["Dense_0"]["kernel"]).T,
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(fc.bias.detach().numpy(),
                                   np.asarray(state.fc_params["Dense_0"]["bias"]),
                                   atol=1e-5, rtol=0)
    assert got["lr"] == pytest.approx(0.5 * 0.01)
    # the frozen backbone: weights and BN statistics never move, no gradient
    for k, v in p["port"].state_dict().items():
        assert torch.equal(v, stats_before[k]), k
    assert all(q.grad is None for q in p["port"].parameters()) and not p["port"].training


def test_eval_sums_match_jax_with_a_padded_tail(probe_pair):
    p = probe_pair
    jeval = jax_lincls.make_eval_step(p["backbone"], p["classifier"], p["mesh"])
    peval = lincls.make_eval_step(p["port"], p["fc"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, p["size"], p["size"], 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    mask = (np.arange(B) < B - 3).astype(np.float32)
    want = jeval(p["state"], _put(p["mesh"], x), _put(p["mesh"], y), _put(p["mesh"], mask))
    got = peval(torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for k in ("correct1", "correct5", "count"):
        assert float(got[k]) == float(want[k]), k
    assert float(got["count"]) == B - 3


def test_sanity_check_catches_a_changed_weight(probe_pair):
    port = probe_pair["port"]
    pretrained = {k: v.clone() for k, v in port.state_dict().items()}
    lincls.sanity_check(port, pretrained)
    key = {"resnet": "layer2.0.bn1.running_var", "vit": "blocks.1.norm1.weight"}[
        probe_pair["arch"]]
    pretrained[key][0] += 1e-6
    with pytest.raises(AssertionError, match=key):
        lincls.sanity_check(port, pretrained)


@pytest.mark.parametrize("size,canvas,n", [(24, 32, 20), (32, 32, 16)])
def test_eval_pipeline_matches_jax(size, canvas, n):
    """Center crop, normalization, and the tail padded with repeats and
    masked: the same labels and masks as JAX's, exactly, and the same
    images within 1e-6 (XLA fuses /255, - mean and / std in its own order:
    the two differ by an ulp of values below 2.5)."""
    data = dict(dataset="synthetic_learnable", image_size=size, global_batch=B, num_workers=2)
    mesh = create_mesh(num_data=1, devices=jax.devices()[:1])
    want = list(JaxEvalPipeline(jc.DataConfig(**data), mesh, dataset=JaxLearnable(n, canvas)))
    with EvalPipeline(pc.DataConfig(**data), dataset=LearnableSyntheticDataset(n, canvas),
                      device="cpu") as pipe:
        got = list(pipe)
    assert len(got) == len(want) == -(-n // B)
    for (gi, gl, gm), (wi, wl, wm) in zip(got, want):
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert sum(float(m.sum()) for _, _, m in got) == n


@pytest.mark.parametrize("crop", [True, False])
def test_probe_recipe_matches_jax(crop):
    """PROBE_RECIPE (crop 0.08-1, flip, normalize), and without its crop as
    the host-crop path runs it, within 1e-5 in pixel units."""
    base = ja.get_recipe(False, 32)
    recipe_j = ja.PROBE_RECIPE._replace(mean=base.mean, std=base.std, crop=crop)
    recipe_t = ta.PROBE_RECIPE._replace(mean=base.mean, std=base.std, crop=crop)
    assert tuple(recipe_t) == tuple(recipe_j)
    key = jax.random.PRNGKey(21)
    x = np.random.default_rng(2).uniform(0, 1, (6, 40 if crop else 32, 40 if crop else 32, 3))
    x = x.astype(np.float32)
    want = np.asarray(ja.apply_recipe(recipe_j, key, jnp.asarray(x), 32))
    draws = recipe_draws(key, 6)
    if not crop:
        del draws["crop"]
    got = ta.apply_recipe(recipe_t, draws, torch.from_numpy(x), 32).numpy()
    std = np.asarray(base.std, np.float32)
    np.testing.assert_allclose(got * std, want * std, atol=1e-5, rtol=0)


def test_labeled_pipeline_gives_the_same_batches_in_both_modes():
    data = pc.DataConfig(dataset="synthetic_learnable", image_size=32, global_batch=B,
                         num_workers=2)
    with LabeledPipeline(data, seed=1, dataset=LearnableSyntheticDataset(24, 32),
                         device="cpu") as pipe:
        sync = list(pipe.epoch(0))
        ring = list(pipe.epoch(0, device=True))
        assert pipe.recipe.crop_scale == (0.08, 1.0) and pipe.recipe.mean == ta.CIFAR_MEAN
    assert len(sync) == len(ring) == 3
    order = np.random.default_rng((1, 0)).permutation(24)
    for s, ((si, sl), (ri, rl)) in enumerate(zip(sync, ring)):
        assert si.shape == (B, 32, 32, 3) and sl.dtype == torch.int64
        assert torch.equal(si, ri) and torch.equal(sl, rl)
        np.testing.assert_array_equal(sl.numpy(), order[s * B:(s + 1) * B] % 8)


def test_probe_run_and_evaluate_best_on_cpu(tmp_path):
    """Pretrain two steps into a workdir, probe two epochs from it, and
    score model_best: `evaluate_lincls` gives the best epoch's top-1
    exactly, the probe's backbone passed `sanity_check`, and every line of
    the probe's metrics.jsonl validates under the JAX schema."""
    cfg = pc.TrainConfig(
        moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                           cifar_stem=True, compute_dtype="float32"),
        optim=pc.OptimConfig(lr=0.05, epochs=1, cos=True),
        data=pc.DataConfig(dataset="synthetic_learnable", image_size=32, global_batch=16,
                           num_workers=2),
        workdir=str(tmp_path / "pre"))
    train(cfg, dataset=LearnableSyntheticDataset(32, 32), device="cpu", num_filters=NF)
    probe = pc.ProbeConfig(lr=1.0, schedule=(1,), epochs=2, num_classes=CLASSES)
    val = LearnableSyntheticDataset(20, 32, train=False)  # 16 + a padded tail of 4
    out = lincls.train_lincls(cfg.workdir, probe, data=dataclasses.replace(cfg.data,
                                                                            global_batch=B),
                              train_dataset=LearnableSyntheticDataset(32, 32),
                              val_dataset=val, device="cpu")
    assert out["count"] == 20
    best = lincls.evaluate_lincls(cfg.workdir, val_dataset=val, device="cpu")
    assert best["acc1"] == out["best_acc1"]
    probe_dir = str(tmp_path / "pre_lincls")
    assert validate_file(os.path.join(probe_dir, "metrics.jsonl")) == []
    assert sorted(os.listdir(probe_dir)) == ["checkpoint_00000001.pth.tar", "metrics.jsonl",
                                             "model_best.pth.tar"]


def test_vit_probe_run_and_evaluate_best_on_cpu(tmp_path):
    """A ViT checkpoint (vit_tiny, flash attention, v3): the probe's
    backbone is the query encoder's ViT (no head, 192 features), two probe
    epochs from it, `sanity_check` inside, and `evaluate_lincls` scoring
    model_best at the best epoch's top-1 exactly; the CLI refuses nothing
    of a ViT."""
    pre = str(tmp_path / "pre")
    state = _v3_ckpt(pre)
    backbone, pretrained, cfg = lincls.load_pretrained_backbone(pre, device="cpu")
    assert isinstance(backbone, port_vit.VisionTransformer) and backbone.num_features == 192
    assert "cls_token" in pretrained and not any(k.startswith("fc.") for k in pretrained)
    want = state.encoder_q.backbone.state_dict()
    assert set(pretrained) == set(want)
    assert all(torch.equal(pretrained[k], want[k]) for k in want)
    data = pc.DataConfig(dataset="synthetic_learnable", image_size=VIT_IMG, global_batch=B,
                         num_workers=2)
    probe = pc.ProbeConfig(lr=1.0, schedule=(1,), epochs=2, num_classes=CLASSES)
    val = LearnableSyntheticDataset(12, VIT_IMG, train=False)  # 8 + a padded tail of 4
    out = lincls.train_lincls(pre, probe, data=data,
                              train_dataset=LearnableSyntheticDataset(16, VIT_IMG),
                              val_dataset=val, device="cpu")
    assert out["count"] == 12 and np.isfinite(out["loss"])
    best = lincls.evaluate_lincls(pre, val_dataset=val, device="cpu")
    assert best["acc1"] == out["best_acc1"]
    assert validate_file(os.path.join(str(tmp_path / "pre_lincls"), "metrics.jsonl")) == []
