"""Parity of the port's ViT / MoCo v3 modules with the JAX package on the CPU:
`VisionTransformer` (dense and flash attention, cls and gap pooling),
`sincos_2d_posembed`, `V3MLPHead` in train and eval mode, and AdamW with
its decay mask against `optax.adamw` and `_bn_and_bias_mask`.

Weights are Flax trees filled with numpy values and carried over by
`convert`; inputs are numpy; both packages run in float32. Each test states
its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.models import vit as jax_vit
from moco_tpu.models.heads import V3MLPHead as FlaxV3Head
from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch import convert
from moco_tpu_torch.core.moco import build_encoder, build_predictor
from moco_tpu_torch.models import heads, vit
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import schedules


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def fill(shapes, seed):
    """Numpy values for a Flax variable tree (from eval_shape): kernels
    LeCun-normal by their fan-in, biases and running means near 0, scales
    and running variances in [0.5, 1.5], the cls token N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name or "'bias'" in name:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "cls_token" in name:
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if "'out'" not in name else int(np.prod(s.shape[:2]))
        if "MultiHeadDotProductAttention" in name and "'out'" not in name:
            fan_in = s.shape[0]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# ------------------------------------------------------------------- ViT


def test_sincos_posembed_matches_jax():
    for dim, grid, cls in ((192, 12, True), (64, 5, False), (768, 14, True)):
        np.testing.assert_array_equal(vit.sincos_2d_posembed(dim, grid, cls),
                                      jax_vit.sincos_2d_posembed(dim, grid, cls))


@pytest.mark.parametrize("pool", ["cls", "gap"])
@pytest.mark.parametrize("flash", [False, True])
def test_vit_matches_flax(pool, flash):
    """vit_tiny at 48 px with patch 4: 144 patches (+ cls) >= 128 tokens, so
    JAX's flash path runs its Pallas kernels (interpret mode). Pooled
    features within 2e-5 of Flax's (O(1) LayerNorm outputs after 4 blocks
    of float32 sums taken in another order)."""
    x = np.random.default_rng(1).standard_normal((3, 48, 48, 3)).astype(np.float32)
    mod = jax_vit.create_vit("vit_tiny", patch_size=4, use_flash_attention=flash, pool=pool)
    params = fill(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"],
                  seed=2)
    want = mod.apply({"params": params}, jnp.asarray(x))
    port = vit.create_vit("vit_tiny", image_size=48, patch_size=4, use_flash_attention=flash,
                          pool=pool)
    port.load_state_dict(convert._tensors(convert.vit_from_flax(params)))
    got = port(_t(x))
    assert got.dtype == torch.float32 and got.shape == (3, 192)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_vit_flash_and_dense_paths_share_weights_and_agree():
    """Same weights through either attention (the parameter trees are
    identical) give features within 2e-5 of each other, at an image size
    other than the one the module was built for."""
    x = _t(np.random.default_rng(3).standard_normal((2, 32, 32, 3)))
    dense = vit.create_vit("vit_tiny", patch_size=4)
    flash = vit.create_vit("vit_tiny", patch_size=4, use_flash_attention=True)
    flash.load_state_dict(dense.state_dict())
    np.testing.assert_allclose(flash(x).detach().numpy(), dense(x).detach().numpy(), atol=2e-5)


# ------------------------------------------------------------- V3MLPHead


@pytest.mark.parametrize("last_bn", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_v3_head_matches_flax(last_bn, train):
    """Outputs within 1e-5 and, in train mode, the mutated batch_stats
    (momentum 0.9 on the old value, biased variance) within 1e-6."""
    x = np.random.default_rng(4).standard_normal((8, 24)).astype(np.float32)
    mod = FlaxV3Head(num_layers=3, hidden_dim=32, dim=16, last_bn=last_bn, dtype=jnp.float32)
    v = fill(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=5)
    want, mut = mod.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
    port = heads.V3MLPHead(24, num_layers=3, hidden_dim=32, dim=16, last_bn=last_bn)
    port.load_state_dict(convert.predictor_from_flax(v["params"], v["batch_stats"]))
    port.train(train)
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    sd = port.state_dict()
    for name, arr in convert.predictor_from_flax(v["params"], mut["batch_stats"]).items():
        np.testing.assert_allclose(sd[name].numpy(), arr.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


# ------------------------------------------------------------ AdamW, mask


def _flax_v3_trees(cfg):
    """Flax params of the v3 encoder and predictor `build_encoder` /
    `build_predictor` make for `cfg` (vit_tiny, the head narrowed to 32)."""
    encoder = FlaxEncoder(
        backbone=jax_vit.create_vit(cfg.arch, patch_size=cfg.vit_patch_size),
        head=FlaxV3Head(num_layers=3, hidden_dim=32, dim=cfg.dim))
    predictor = FlaxV3Head(num_layers=2, hidden_dim=32, dim=cfg.dim)
    x = jnp.zeros((2, 16, 16, 3))
    enc = jax.eval_shape(lambda: encoder.init(jax.random.PRNGKey(0), x, train=False))
    pred = jax.eval_shape(lambda: predictor.init(jax.random.PRNGKey(0), jnp.zeros((2, cfg.dim)),
                                                 train=False))
    return enc["params"], pred["params"]


@pytest.mark.parametrize("freeze", [True, False])
def test_adamw_groups_follow_bn_and_bias_mask(freeze):
    """Every trained parameter sits in the group `_bn_and_bias_mask` gives
    its Flax leaf (the cls token and the patch kernel decay; LayerNorm and
    BN scales and every bias do not), converted leaf by leaf; the frozen
    patch embedding is in neither group."""
    cfg = pc.MocoConfig(arch="vit_tiny", dim=16, num_negatives=0, v3=True, vit_patch_size=4,
                        freeze_patch_embed=freeze)
    enc_p, pred_p = _flax_v3_trees(cfg)
    mask = jax_schedules._bn_and_bias_mask({"enc": enc_p, "pred": pred_p})

    def as_arrays(mask, shapes):  # each leaf's mask bit as an array of its shape
        return jax.tree.map(lambda m, s: np.full(s.shape, float(m), np.float32), mask, shapes)

    want = {f"enc.{n}": bool(t.flatten()[0]) for n, t in
            convert.encoder_from_flax(as_arrays(mask["enc"], enc_p)).items()}
    want.update({f"pred.{n}": bool(t.flatten()[0]) for n, t in
                 convert.predictor_from_flax(as_arrays(mask["pred"], pred_p)).items()})
    encoder, predictor = build_encoder(cfg, mlp_hidden=32), build_predictor(cfg, mlp_hidden=32)
    if freeze:
        encoder.backbone.patch_embed.requires_grad_(False)
    decay, keep = schedules.decay_groups([encoder, predictor], 0.1)
    assert decay["weight_decay"] == 0.1 and keep["weight_decay"] == 0.0
    names = {id(p): f"enc.{n}" for n, p in encoder.named_parameters()}
    names.update({id(p): f"pred.{n}" for n, p in predictor.named_parameters()})
    got = {names[id(p)]: True for p in decay["params"]}
    got.update({names[id(p)]: False for p in keep["params"]})
    frozen = {"enc.backbone.patch_embed.weight", "enc.backbone.patch_embed.bias"}
    assert set(got) == set(want) - (frozen if freeze else set())
    assert got == {n: want[n] for n in got}
    assert want["enc.backbone.cls_token"] and want["enc.backbone.patch_embed.weight"]
    assert not want["enc.backbone.blocks.0.norm1.weight"] and not want["pred.bn0.weight"]


def test_adamw_matches_optax_for_three_steps():
    """torch AdamW over decay_groups against optax.adamw(mask=_bn_and_bias_mask)
    on a Linear + LayerNorm, three updates from given gradients with a
    warmup lr: parameters within 3e-6 after each. optax forms the bias
    correction 1 - 0.999^t in float32, torch in double: at t = 2 the f32
    rounding of 0.999^2 (up to 6e-8) is 3e-5 of 1 - 0.999^2, which moves an
    update of size <= lr = 0.1 by up to 1.5e-6 (measured 1.34e-6)."""
    ocfg = dict(optimizer="adamw", lr=0.1, weight_decay=0.1, warmup_epochs=2, epochs=4, cos=True)
    rng = np.random.default_rng(6)
    lin, norm = nn.Linear(5, 4), nn.LayerNorm(4)
    with torch.no_grad():
        for p in (*lin.parameters(), *norm.parameters()):
            p.copy_(_t(rng.standard_normal(p.shape)))
    jparams = {"Dense_0": {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
                           "bias": jnp.asarray(lin.bias.detach().numpy())},
               "LayerNorm_0": {"scale": jnp.asarray(norm.weight.detach().numpy()),
                               "bias": jnp.asarray(norm.bias.detach().numpy())}}
    tx = jax_schedules.build_optimizer(jc.OptimConfig(**ocfg), steps_per_epoch=1)
    jstate = tx.init(jparams)
    opt = schedules.build_optimizer(pc.OptimConfig(**ocfg),
                                    schedules.decay_groups([lin, norm], ocfg["weight_decay"]))
    sched = schedules.make_lr_schedule(pc.OptimConfig(**ocfg), 1)
    for step in range(3):
        g = {"w": rng.standard_normal((4, 5)), "b": rng.standard_normal(4),
             "s": rng.standard_normal(4), "c": rng.standard_normal(4)}
        g = {k: v.astype(np.float32) for k, v in g.items()}
        jgrads = {"Dense_0": {"kernel": jnp.asarray(g["w"].T), "bias": jnp.asarray(g["b"])},
                  "LayerNorm_0": {"scale": jnp.asarray(g["s"]), "bias": jnp.asarray(g["c"])}}
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        for p, key in ((lin.weight, "w"), (lin.bias, "b"), (norm.weight, "s"), (norm.bias, "c")):
            p.grad = _t(g[key])
        opt.step()
        pairs = ((lin.weight, jparams["Dense_0"]["kernel"].T), (lin.bias, jparams["Dense_0"]["bias"]),
                 (norm.weight, jparams["LayerNorm_0"]["scale"]),
                 (norm.bias, jparams["LayerNorm_0"]["bias"]))
        for p, want in pairs:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), atol=3e-6, rtol=0)
