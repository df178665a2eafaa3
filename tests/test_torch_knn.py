"""The port's kNN monitor (moco_tpu_torch/knn.py) against moco_tpu/knn.py on
the CPU, float32 on both sides: `knn_classify` gives the same predictions
on tie-free features (`torch.topk` and `lax.top_k` may order equal scores
differently, as tests/test_torch_index.py notes), `extract_features` the
same features within 1e-5 and the same labels, and `knn_eval` the same
decisions on a small LearnableSyntheticDataset wherever the two packages'
feature difference cannot move them (see `test_knn_eval_matches_jax`);
`extract_features` on a ViT-tiny with flash attention (the v3 driver's
monitor; JAX's Pallas kernels in interpret mode, the port's plain
attention) within 1e-5 as well."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu import knn as jax_knn
from moco_tpu.data.datasets import LearnableSyntheticDataset as JaxLearnable
from moco_tpu.models import resnet as jax_resnet
from moco_tpu.models import vit as jax_vit
from moco_tpu_torch import convert, knn
from moco_tpu_torch.data.datasets import LearnableSyntheticDataset
from moco_tpu_torch.models import resnet as port_resnet
from moco_tpu_torch.models import vit as port_vit
from test_torch_vit import fill

NF, IMG, CLASSES = 8, 32, 8


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("k,temperature", [(1, 0.07), (20, 0.07), (64, 0.5)])
def test_knn_classify_matches_jax(k, temperature):
    rng = np.random.default_rng(k)
    bank, test = _unit(rng, (300, 16)), _unit(rng, (70, 16))
    labels = rng.integers(0, CLASSES, 300).astype(np.int32)
    want = jax_knn.knn_classify(bank, labels, test, CLASSES, k=k, temperature=temperature,
                                batch_size=32)
    got = knn.knn_classify(bank, labels, test, CLASSES, k=k, temperature=temperature,
                           batch_size=32, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def backbones():
    """A narrow CIFAR-stem ResNet-18 in both packages with the same seeded
    weights (He-scaled convolutions, BN near identity; eval mode reads the
    statistics)."""
    mod = jax_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, IMG, IMG, 3)), train=False))
    rng = np.random.default_rng(5)

    def param(path, a):
        if a.ndim == 4:  # conv kernel (H, W, Cin, Cout)
            return (rng.standard_normal(a.shape) * np.sqrt(2.0 / np.prod(a.shape[:3]))).astype(
                np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    def stat(path, a):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(param, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"])
    port = port_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True)
    sd = {k: torch.from_numpy(v) for k, v in convert.backbone_from_flax(params, stats).items()}
    port.load_state_dict(sd, strict=False)
    return (mod, params, stats), port


def test_extract_features_matches_jax(backbones):
    (mod, params, stats), port = backbones
    want_f, want_y = jax_knn.extract_features(mod, params, stats, JaxLearnable(40, IMG),
                                              batch_size=16, image_size=IMG)
    port.train()
    got_f, got_y = knn.extract_features(port, LearnableSyntheticDataset(40, IMG), batch_size=16,
                                        image_size=IMG, device="cpu")
    assert port.training  # the caller's mode is restored
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_f, want_f, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got_f, axis=1), 1.0, atol=1e-5)


def _robust_rows(test_f, bank_f, bank_y, k, temperature, delta):
    """Rows whose kNN decision no change of the similarities by up to
    `delta` can move: the k-th and (k+1)-th similarities more than 2 delta
    apart, and the best class's vote more than exp(2 delta / T) times the
    runner-up's."""
    sims = test_f @ bank_f.T
    order = np.argsort(-sims, axis=1)
    top = np.take_along_axis(sims, order, 1)
    gap_ok = top[:, k - 1] - top[:, k] > 2 * delta
    votes = np.zeros((len(test_f), CLASSES))
    for r in range(len(test_f)):
        np.add.at(votes[r], bank_y[order[r, :k]], np.exp(top[r, :k] / temperature))
    best = np.sort(votes, axis=1)
    return gap_ok & (best[:, -1] > best[:, -2] * np.exp(2 * delta / temperature))


def test_knn_eval_matches_jax(backbones):
    """Top-1 of the whole monitor. Two float32 implementations of the
    convolutions give features that differ by ~1e-6, and a random
    backbone's features sit close together, so a near-tie between two
    neighbours or two classes may go either way: every decision that the
    measured difference of the similarities cannot move must agree, and
    the top-1s may differ by the share of the others, at most 1 in 8."""
    (mod, params, stats), port = backbones
    k, t = 10, 0.07
    jax_sets = (JaxLearnable(64, IMG), JaxLearnable(32, IMG, train=False))
    port_sets = (LearnableSyntheticDataset(64, IMG), LearnableSyntheticDataset(32, IMG, train=False))
    want = jax_knn.knn_eval(mod, params, stats, *jax_sets, num_classes=CLASSES, k=k,
                            temperature=t, batch_size=32, image_size=IMG)
    got = knn.knn_eval(port, *port_sets, num_classes=CLASSES, k=k, temperature=t, batch_size=32,
                       image_size=IMG, device="cpu")
    (jb, jy), (jt, jty) = (jax_knn.extract_features(mod, params, stats, d, 32, IMG)
                           for d in jax_sets)
    (pb, _), (pt, _) = (knn.extract_features(port, d, 32, IMG, device="cpu") for d in port_sets)
    delta = float(np.abs(pt @ pb.T - jt @ jb.T).max())
    robust = _robust_rows(jt, jb, jy, k, t, delta)
    assert robust.mean() >= 7 / 8, (delta, robust.mean())
    want_pred = jax_knn.knn_classify(jb, jy, jt, CLASSES, k=k, temperature=t)
    got_pred = knn.knn_classify(pb, jy, pt, CLASSES, k=k, temperature=t, device="cpu")
    np.testing.assert_array_equal(got_pred[robust], want_pred[robust])
    assert want == pytest.approx(100.0 * np.mean(want_pred == jty))
    assert got == pytest.approx(100.0 * np.mean(got_pred == jty))
    assert abs(got - want) <= 100.0 * (1.0 - robust.mean()) + 1e-9


def test_extract_features_matches_jax_on_a_vit():
    """The monitor's extract on the v3 backbone: vit_tiny at 48 px, patch 4
    (145 tokens: JAX's flash path runs its Pallas kernels, in interpret
    mode), the same seeded weights in both packages; features within 1e-5,
    labels equal. `knn_eval` takes any backbone that maps NHWC images to
    features, so nothing in knn.py is ResNet-specific."""
    size = 48
    mod = jax_vit.create_vit("vit_tiny", image_size=size, patch_size=4, use_flash_attention=True,
                             dtype=jnp.float32)
    params = fill(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, size, size, 3))))["params"],
                  seed=6)
    port = port_vit.create_vit("vit_tiny", image_size=size, patch_size=4,
                               use_flash_attention=True)
    port.load_state_dict(convert._tensors(convert.vit_from_flax(params)))
    want_f, want_y = jax_knn.extract_features(mod, params, {}, JaxLearnable(12, size),
                                              batch_size=8, image_size=size)
    got_f, got_y = knn.extract_features(port, LearnableSyntheticDataset(12, size), batch_size=8,
                                        image_size=size, device="cpu")
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_f, want_f, atol=1e-5, rtol=0)
