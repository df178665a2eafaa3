"""Parity of the PyTorch port's model stack (moco_tpu_torch) with the JAX
package on the CPU: l2_normalize, the eval normalization, ResNet + head
through `convert.encoder_from_flax`, its torchvision names, the config
presets, and the device rule.

Inputs and weights are made with numpy from a seed and handed to both
packages. Tolerance for the encoder: atol 1e-4 in f32 (outputs are O(1);
the two sides sum convolutions in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.data import augment as jax_augment
from moco_tpu.export import resnet_to_torchvision
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.models.resnet import create_resnet as flax_resnet
from moco_tpu.ops.losses import l2_normalize as jax_l2_normalize
from moco_tpu.utils import config as jax_config
from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
from moco_tpu_torch.core.moco import build_encoder
from moco_tpu_torch.data.augment import eval_stats, normalize
from moco_tpu_torch.ops.losses import l2_normalize
from moco_tpu_torch.utils import config as port_config
from moco_tpu_torch.utils.device import resolve_device

# (arch, num_filters, cifar_stem, image size, mlp)
ENCODERS = [
    ("resnet18", 64, True, 32, True),
    ("resnet18", 64, True, 32, False),
    ("resnet50", 8, False, 64, True),
    ("resnet50", 8, False, 64, False),
]


def flax_variables(enc, x, seed=1):
    """Flax variables of `enc` filled with numpy draws: He-normal kernels,
    BN scale/bias and running statistics away from 1/0 so the eval BN
    arithmetic is exercised."""
    shapes = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name or "'bias'" in name:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.2, 0.6, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_encoder(arch, nf, cifar, mlp, dim=16):
    return FlaxEncoder(
        backbone=flax_resnet(arch, num_filters=nf, cifar_stem=cifar, dtype=jnp.float32),
        head=FlaxHead(dim=dim, mlp=mlp, dtype=jnp.float32),
    )


@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 8)])
def test_l2_normalize_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x[0] = 0.0  # the eps floor: a zero row stays zero
    got = l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_l2_normalize(jnp.asarray(x))), atol=1e-7)


@pytest.mark.parametrize("image_size", [32, 64, 96, 224])
def test_eval_normalization_matches_recipe(image_size):
    recipe = jax_augment.get_recipe(False, image_size)
    mean, std = eval_stats(image_size)
    assert (mean, std) == (tuple(recipe.mean), tuple(recipe.std))
    x = np.random.default_rng(1).uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jax_augment.normalize(jnp.asarray(x), recipe.mean, recipe.std))
    np.testing.assert_allclose(normalize(torch.from_numpy(x), mean, std).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("arch,nf,cifar,size,mlp", ENCODERS)
def test_encoder_matches_flax_eval(arch, nf, cifar, size, mlp):
    """The whole eval forward, Flax weights carried over by
    encoder_from_flax: atol 1e-4 in f32."""
    enc = flax_encoder(arch, nf, cifar, mlp)
    x = np.random.default_rng(0).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    v = flax_variables(enc, x)
    want = np.asarray(jax.jit(lambda v, x: enc.apply(v, x, train=False))(v, x))
    model = build_encoder(
        port_config.MocoConfig(arch=arch, dim=16, mlp=mlp, cifar_stem=cifar), num_filters=nf
    ).eval()
    model.load_state_dict(encoder_from_flax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch,nf,cifar,size,mlp", ENCODERS[1:3])
def test_state_dict_names_follow_torchvision_export(arch, nf, cifar, size, mlp):
    """The backbone's state_dict is exactly export.resnet_to_torchvision's
    names and arrays (plus torch's BN step counters); the head follows
    the reference's fc surgery."""
    enc = flax_encoder(arch, nf, cifar, mlp)
    v = flax_variables(enc, np.zeros((1, size, size, 3), np.float32))
    tv = resnet_to_torchvision(
        v["params"]["backbone"], v["batch_stats"]["backbone"],
        stage_sizes={"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}[arch],
    )
    sd = encoder_from_flax(v["params"], v["batch_stats"])
    backbone = {k[len("backbone."):]: t for k, t in sd.items() if k.startswith("backbone.")}
    assert backbone.keys() == tv.keys()
    for k, arr in tv.items():
        np.testing.assert_array_equal(backbone[k].numpy(), arr)
    model = build_encoder(
        port_config.MocoConfig(arch=arch, dim=16, mlp=mlp, cifar_stem=cifar), num_filters=nf
    )
    names = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert names == sd.keys()
    head = {k for k in sd if k.startswith("head.")}
    assert head == ({"head.fc.0.weight", "head.fc.0.bias", "head.fc.2.weight", "head.fc.2.bias"}
                    if mlp else {"head.fc.weight", "head.fc.bias"})


@pytest.mark.parametrize("arch,cifar,mlp", [("resnet18", True, False), ("resnet50", False, True)])
def test_random_flax_encoder_has_the_flax_tree(arch, cifar, mlp):
    """The seeded numpy init chip_smoke.py serves has exactly the tree and
    shapes Flax's init makes, so it reaches the port the way real
    checkpoint weights do."""
    cfg = port_config.MocoConfig(arch=arch, dim=16, mlp=mlp, cifar_stem=cifar)
    enc = flax_encoder(arch, 8, cifar, mlp)
    shapes = jax.eval_shape(
        lambda: enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    )
    params, stats = random_flax_encoder(cfg, seed=3, num_filters=8)
    for got, want in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        assert jax.tree_util.tree_all(
            jax.tree_util.tree_map(lambda a, s: a.shape == s.shape, got, want)
        )
    build_encoder(cfg, num_filters=8).load_state_dict(encoder_from_flax(params, stats))


@pytest.mark.parametrize("preset", ["cifar_smoke", "imagenet_v2"])
def test_presets_match_the_jax_config(preset):
    ours, theirs = port_config.PRESETS[preset], jax_config.PRESETS[preset]
    for f in dataclasses.fields(port_config.MocoConfig):
        assert getattr(ours.moco, f.name) == getattr(theirs.moco, f.name), f.name
        assert getattr(port_config.MocoConfig(), f.name) == getattr(
            jax_config.MocoConfig(), f.name
        ), f.name
    assert ours.data.image_size == theirs.data.image_size
    assert port_config.DataConfig().image_size == jax_config.DataConfig().image_size


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
