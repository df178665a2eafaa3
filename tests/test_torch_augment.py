"""Parity of the port's device-side augmentations (moco_tpu_torch.data.augment)
with moco_tpu/data/augment.py on the CPU.

`jax.random` cannot be reproduced in torch, so each test repeats the JAX
op's own `jax.random.split` / `uniform` calls to get its draws as numpy,
hands them to the port's deterministic transform, and compares with the
JAX op run on the same key. Bernoulli(p) is `uniform < p` in JAX, so its
draw is that uniform.

Tolerance: 1e-5 absolute in pixel units (images in [0, 1]; normalized
views are compared after multiplying back by the recipe's std), float32
on both sides: the resize sums its separable products in another order,
and the blur's depthwise convolutions likewise.

Documented gap, the resize at full size: the sample positions of
`compute_weight_mat` are rounded in float32 at coordinates up to the
image size (224 * 2^-24 ~ 1.3e-5 px), and XLA fuses that arithmetic in
its own order, so on white-noise images (a pixel-to-pixel step of up to
1) the two packages differ by up to ~3.5e-5 at 224 px, the size of the
JAX package's own jit-versus-eager gap on the same call. The 224-px case
is held to 5e-5 for that reason; at <= 48 px the gap is under 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.data import augment as ja
from moco_tpu_torch.data import augment as ta

ATOL = 1e-5
U = jax.random.uniform


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _images(b, h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def crop_draws(key, b, attempts=10):
    """The four tables `random_resized_crop_params` draws (augment.py:71-90)."""
    k_area, k_ratio, k_y, k_x = jax.random.split(key, 4)
    shape = (b, attempts)
    return {name: _np(U(k, shape)) for name, k in
            (("scale", k_area), ("log_ratio", k_ratio), ("y", k_y), ("x", k_x))}


def jitter_draws(key, b):
    """color_jitter's draws (augment.py:237-254): factors, order, apply."""
    k_order, k_apply, kb, kc, ks, kh = jax.random.split(key, 6)
    factors = np.stack([_np(U(k, (b, 1, 1, 1))).reshape(b) for k in (kb, kc, ks, kh)], axis=1)
    return factors, _np(U(k_order, (b, 4))), _np(U(k_apply, (b, 1, 1, 1))).reshape(b)


def recipe_draws(key, b):
    """Every draw of `apply_recipe(recipe, key, ...)` (augment.py:355-371)."""
    k_crop, k_jit, k_gray, k_blur, k_flip = jax.random.split(key, 5)
    factors, order, jitter_apply = jitter_draws(k_jit, b)
    k_sigma, k_blur_apply = jax.random.split(k_blur)
    d = {
        "crop": crop_draws(k_crop, b), "jitter": factors, "order": order,
        "jitter_apply": jitter_apply,
        "gray": _np(U(k_gray, (b, 1, 1, 1))).reshape(b),
        "blur_sigma": _np(U(k_sigma, (b,))),
        "blur_apply": _np(U(k_blur_apply, (b, 1, 1, 1))).reshape(b),
        "flip": _np(U(k_flip, (b, 1, 1, 1))).reshape(b),
    }
    return {k: ({n: _t(a) for n, a in v.items()} if isinstance(v, dict) else _t(v))
            for k, v in d.items()}


@pytest.mark.parametrize("b,h,w,scale", [(16, 64, 64, (0.2, 1.0)), (16, 40, 24, (0.08, 1.0)),
                                          (8, 10, 100, (0.9, 1.0)), (8, 100, 10, (0.9, 1.0))])
def test_crop_boxes_match_jax(b, h, w, scale):
    """torchvision's 10-attempt rule, including the centre-crop fallback
    (the last two shapes admit no attempt): exact."""
    key = jax.random.PRNGKey(h * 1000 + w)
    want = ja.random_resized_crop_params(key, b, h, w, scale=scale)
    got = ta.crop_boxes({k: _t(v) for k, v in crop_draws(key, b).items()}, h, w, scale=scale)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w_))


@pytest.mark.parametrize("b,h,w,out,atol", [(6, 48, 40, 16, ATOL), (4, 16, 16, 32, ATOL),
                                            (4, 32, 32, 32, ATOL), (2, 224, 224, 224, 5e-5)])
def test_crop_resize_matches_scale_and_translate(b, h, w, out, atol):
    """Downsampling (antialiased), upsampling and same-size crops against
    `random_resized_crop` on the same key; the 224-px case carries the
    documented float32 gap (module docstring)."""
    key = jax.random.PRNGKey(7 + out)
    x = _images(b, h, w)
    want = _np(ja.random_resized_crop(key, jnp.asarray(x), out))
    boxes = ta.crop_boxes({k: _t(v) for k, v in crop_draws(key, b).items()}, h, w)
    got = ta.crop_resize(_t(x), *boxes, out).numpy()
    assert got.shape == (b, out, out, 3)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue"])
def test_color_ops_match_jax(op):
    x = _images(5, 9, 7, seed=2)
    factor = np.random.default_rng(3).uniform(0.5, 1.5, (5, 1, 1, 1)).astype(np.float32)
    if op == "hue":
        factor = factor - 1.0  # deltas in [-0.5, 0.5]
    want = _np(getattr(ja, f"adjust_{op}")(jnp.asarray(x), jnp.asarray(factor)))
    got = getattr(ta, f"adjust_{op}")(_t(x), _t(factor)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hue,prob", [(0.1, 0.8), (0.4, 1.0), (0.0, 0.5)])
def test_color_jitter_matches_jax(hue, prob):
    b = 12
    key = jax.random.PRNGKey(11)
    x = _images(b, 8, 8, seed=4)
    want = _np(ja.color_jitter(key, jnp.asarray(x), 0.4, 0.4, 0.4, hue, apply_prob=prob))
    u, order, apply_u = jitter_draws(key, b)
    lo = (0.6, 0.6, 0.6, -hue)
    hi = (1.4, 1.4, 1.4, hue)
    factors = torch.stack([ta.uniform_range(_t(u[:, j]), lo[j], hi[j]) for j in range(4)], dim=1)
    apply = _t(apply_u) < prob if prob < 1.0 else torch.ones(b, dtype=torch.bool)
    got = ta.color_jitter(_t(x), factors, _t(order), apply, hue).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_grayscale_blur_flip_match_jax():
    """Each JAX op runs on `key`, and the port gets the draws the op takes
    from that same key: the reuse of the key is the point of the test."""
    b = 8
    x = _images(b, 30, 26, seed=5)
    key = jax.random.PRNGKey(5)
    want = _np(ja.random_grayscale(key, jnp.asarray(x), 0.5))
    u = _np(U(key, (b, 1, 1, 1))).reshape(b)  # mocolint: disable=JX003  (replays the op's draw)
    got = ta.grayscale(_t(x), _t(u) < 0.5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    want = _np(ja.gaussian_blur(key, jnp.asarray(x), apply_prob=0.5))
    k_sigma, k_apply = jax.random.split(key)  # mocolint: disable=JX003  (replays the op's split)
    sigma = ta.uniform_range(_t(_np(U(k_sigma, (b,)))), 0.1, 2.0)
    apply = _t(_np(U(k_apply, (b, 1, 1, 1))).reshape(b)) < 0.5
    got = ta.gaussian_blur(_t(x), sigma, apply).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        ta.gaussian_kernels(sigma).numpy(), _np(ja._gaussian_kernels(jnp.asarray(sigma.numpy()), 23)),
        atol=1e-7, rtol=0)

    want = _np(ja.random_horizontal_flip(key, jnp.asarray(x)))  # mocolint: disable=JX003  (same key)
    u = _np(U(key, (b, 1, 1, 1))).reshape(b)  # mocolint: disable=JX003  (replays the op's draw)
    got = ta.horizontal_flip(_t(x), _t(u) < 0.5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aug_plus,size,canvas", [(True, 72, 80), (False, 32, 40), (True, 32, 32)])
def test_apply_recipe_matches_jax(aug_plus, size, canvas):
    """A whole view: the v2 recipe with blur (> 64 px), v1, and v2 at
    CIFAR size (no blur, CIFAR statistics), within 1e-5 in pixel units.
    The JAX recipe runs op by op, as the transforms are written."""
    b = 6
    recipe_j = ja.get_recipe(aug_plus, size)
    recipe_t = ta.get_recipe(aug_plus, size)
    assert tuple(recipe_t) == tuple(recipe_j)
    key = jax.random.PRNGKey(size + canvas)
    x = _images(b, canvas, canvas, seed=6)
    want = _np(ja.apply_recipe(recipe_j, key, jnp.asarray(x), size))
    got = ta.apply_recipe(recipe_t, recipe_draws(key, b), _t(x), size).numpy()
    std = np.asarray(recipe_j.std, np.float32)
    np.testing.assert_allclose(got * std, want * std, atol=ATOL, rtol=0)


@pytest.mark.parametrize("crops_only,crop,size,canvas", [
    (True, True, 72, 80), (True, True, 32, 40), (False, False, 72, 72), (True, False, 32, 32)])
def test_crops_only_and_precropped_recipes_match_jax(crops_only, crop, size, canvas):
    """The crops-only recipe (crop, flip, normalize), and a recipe without
    its crop as the host-crop path runs it on images cropped to size,
    within 1e-5 in pixel units."""
    b = 6
    recipe_j = ja.get_recipe(True, size, crops_only=crops_only)._replace(crop=crop)
    recipe_t = ta.get_recipe(True, size, crops_only=crops_only)._replace(crop=crop)
    assert tuple(recipe_t) == tuple(recipe_j)
    key = jax.random.PRNGKey(size + canvas + crop)
    x = _images(b, canvas, canvas, seed=7)
    want = _np(ja.apply_recipe(recipe_j, key, jnp.asarray(x), size))
    draws = recipe_draws(key, b)
    if not crop:
        del draws["crop"]
    got = ta.apply_recipe(recipe_t, draws, _t(x), size).numpy()
    std = np.asarray(recipe_j.std, np.float32)
    np.testing.assert_allclose(got * std, want * std, atol=ATOL, rtol=0)


def test_draws_and_samplers_stay_in_range():
    gen = torch.Generator().manual_seed(0)
    d = ta.draw_recipe(ta.V2_RECIPE, gen, 64)
    for v in (*d["crop"].values(), d["jitter"], d["order"], d["flip"]):
        assert v.min() >= 0 and v.max() < 1
    y0, x0, ch, cw = ta.crop_boxes(d["crop"], 50, 70)
    assert (ch >= 1).all() and (cw >= 1).all()
    assert (y0 >= 0).all() and (y0 + ch <= 50).all() and (x0 >= 0).all() and (x0 + cw <= 70).all()
    area = ch * cw / (50 * 70)
    assert area.min() >= 0.15 and area.max() <= 1.0
    lo, hi = ta.uniform_range(d["jitter"][:, 0], 0.6, 1.4).aminmax()
    assert lo >= 0.6 and hi <= 1.4
    sigma = ta.uniform_range(d["blur_sigma"], 0.1, 2.0)
    assert sigma.min() >= 0.1 and sigma.max() <= 2.0


@pytest.mark.parametrize("aug_plus,size", [(True, 96), (False, 32)])
def test_two_crop_augment_shapes_and_normalization(aug_plus, size):
    recipe = ta.get_recipe(aug_plus, size)
    gen = torch.Generator().manual_seed(1)
    x = _t(_images(4, size + 8, size + 8, seed=8))
    out = ta.two_crop_augment(recipe, gen, x, size)
    assert set(out) == {"im_q", "im_k"}
    mean, std = torch.tensor(recipe.mean), torch.tensor(recipe.std)
    for v in out.values():
        assert v.shape == (4, size, size, 3) and v.dtype == torch.float32
        raw = v * std + mean  # back to [0, 1]
        assert raw.min() >= -1e-5 and raw.max() <= 1 + 1e-5
    assert not torch.equal(out["im_q"], out["im_k"])  # independent draws
