"""Batched augmentations on the device (counterpart of moco_tpu/data/augment.py).

Images are NHWC float32 in [0, 1]. Every random op is split in two:

- a **draw** (`draw_recipe`): the uniforms the JAX op draws inside itself,
  taken from a `torch.Generator` on the images' device;
- a **deterministic transform** (`crop_boxes`, `crop_resize`, `adjust_*`,
  `gaussian_blur`, ..., composed by `apply_recipe`) of those uniforms, in
  the JAX package's arithmetic.

`jax.random` cannot be reproduced in torch, so the two packages agree on
the transform given the same uniforms: the tests draw them with the JAX
keys and hand them to the port. Recipes (SURVEY.md §2.2 row 9):

- v2 / `--aug-plus`: RandomResizedCrop(scale 0.2-1), ColorJitter(0.4,
  0.4, 0.4, 0.1) with p=0.8, RandomGrayscale(0.2), GaussianBlur(sigma in
  [0.1, 2]) with p=0.5, HorizontalFlip(0.5), Normalize;
- v1: RandomResizedCrop, RandomGrayscale(0.2), ColorJitter(0.4, 0.4, 0.4,
  0.4) always, HorizontalFlip(0.5), Normalize.

Hue jitter is the JAX package's float HSV round trip. The crop resize is
`jax.image.scale_and_translate(method="linear")`, antialiased when it
downsamples: its separable triangle-kernel weight matrices are built here
as `jax.image` builds them and applied as two batched products.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)
CROP_ATTEMPTS = 10
BLUR_TAPS = 23


def normalize(images: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """(images - mean) / std over the last (channel) axis of NHWC images.
    The statistics are filled on the images' device, not copied from the
    host: the augment is captured in a CUDA graph, where such a copy is
    refused."""

    def on_device(values):
        return torch.stack([torch.full((), v, dtype=images.dtype, device=images.device)
                            for v in values])

    return (images - on_device(mean)) / on_device(std)


def eval_stats(image_size: int) -> tuple[tuple, tuple]:
    """(mean, std) as `get_recipe` chooses them: inputs of 64 px or less
    are CIFAR-sized and use the CIFAR statistics."""
    if image_size <= 64:
        return CIFAR_MEAN, CIFAR_STD
    return IMAGENET_MEAN, IMAGENET_STD


def _f32(x: float, device) -> torch.Tensor:
    """`x` rounded to float32, made on `device` by a fill: no host-to-device
    copy, which would wait for the stream, and which a CUDA graph's capture
    refuses."""
    return torch.full((), x, dtype=torch.float32, device=device)


def uniform_range(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jax.random.uniform(minval=lo, maxval=hi)` from its unit draw `u`:
    max(lo, u * (hi - lo) + lo) in float32."""
    lo = lo if torch.is_tensor(lo) else _f32(lo, u.device)
    hi = hi if torch.is_tensor(hi) else _f32(hi, u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


# ---------------------------------------------------------------- crops


def crop_boxes(u: dict, h: int, w: int, scale=(0.2, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """(y0, x0, ch, cw), each (B,) float32 holding integers, from the four
    (B, attempts) unit draws {"scale", "log_ratio", "y", "x"}:
    torchvision's RandomResizedCrop.get_params (first of 10 attempts whose
    rounded box fits, else the ratio-clamped centre crop), as
    `random_resized_crop_params` (augment.py:50-105) computes it."""
    dev = u["scale"].device
    target_area = uniform_range(u["scale"], scale[0], scale[1]) * float(h * w)
    log_lo, log_hi = torch.log(_f32(ratio[0], dev)), torch.log(_f32(ratio[1], dev))
    aspect = torch.exp(uniform_range(u["log_ratio"], log_lo, log_hi))
    cw_all = torch.round(torch.sqrt(target_area * aspect))
    ch_all = torch.round(torch.sqrt(target_area / aspect))
    valid = (cw_all > 0) & (cw_all <= w) & (ch_all > 0) & (ch_all <= h)
    first = torch.argmax(valid.to(torch.uint8), dim=1, keepdim=True)
    any_valid = valid.any(dim=1)

    def pick(arr):
        return arr.gather(1, first)[:, 0]

    cw, ch = pick(cw_all), pick(ch_all)
    y0 = torch.floor(pick(u["y"]) * (h - ch + 1.0))
    x0 = torch.floor(pick(u["x"]) * (w - cw + 1.0))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        fw, fh = w, round(w / ratio[0])
    elif in_ratio > ratio[1]:
        fh, fw = h, round(h * ratio[1])
    else:
        fw, fh = w, h
    fy, fx = (h - fh) // 2, (w - fw) // 2
    return (
        torch.where(any_valid, y0, float(fy)),
        torch.where(any_valid, x0, float(fx)),
        torch.where(any_valid, ch, float(fh)),
        torch.where(any_valid, cw, float(fw)),
    )


def resize_weights(input_size: int, output_size: int, scale: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """(B, input_size, output_size) weights of `jax.image`'s
    `compute_weight_mat` for the linear (triangle) kernel with antialias,
    one matrix per per-image (scale, translation)."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    out_idx = torch.arange(output_size, dtype=torch.float32, device=dev)
    sample_f = (out_idx[None, :] + 0.5) * inv_scale - translation[:, None] * inv_scale - 0.5
    in_idx = torch.arange(input_size, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_idx[None, :, None]).abs() / kernel_scale[:, :, None]
    weights = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def crop_resize(images: torch.Tensor, y0, x0, ch, cw, out_size: int) -> torch.Tensor:
    """Crop each image to its box and resize it to (out_size, out_size):
    `scale_and_translate(scale=out/ch, translation=-y0*out/ch, linear)` per
    image (augment.py:121-135), as two batched products."""
    b, h, w, c = images.shape
    sy, sx = out_size / ch, out_size / cw
    wy = resize_weights(h, out_size, sy, -y0 * sy)  # (B, H, S)
    wx = resize_weights(w, out_size, sx, -x0 * sx)  # (B, W, S)
    rows = torch.bmm(wy.transpose(1, 2), images.reshape(b, h, w * c))  # (B, S, W*C)
    rows = rows.reshape(b, out_size, w, c)
    return torch.einsum("bywc,bwx->byxc", rows, wx)


# ------------------------------------------------------------ color ops


def _blend(a, b, factor):
    return torch.clamp(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def _rgb_to_gray(img):
    """ITU-R 601 luma, as PIL convert('L') uses; (..., 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b)[..., None]


def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img, factor):
    mean = _rgb_to_gray(img).mean(dim=(-3, -2, -1), keepdim=True)
    return _blend(img, mean, factor)


def adjust_saturation(img, factor):
    return _blend(img, _rgb_to_gray(img), factor)


def adjust_hue(img, delta):
    """Hue shift by `delta` (B, 1, 1, 1), a fraction of the colour wheel,
    through a float HSV round trip (augment.py:176-215)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    s = torch.where(maxc > 0, c / torch.where(maxc > 0, maxc, 1.0), 0.0)
    safe_c = torch.where(c > 0, c, 1.0)
    rc, gc, bc = (maxc - r) / safe_c, (maxc - g) / safe_c, (maxc - b) / safe_c
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    h = torch.remainder(h + delta.reshape(delta.shape[:-1]), 1.0)
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):  # the first true condition wins, as jnp.select
            out = torch.where(i == k, choices[k], out)
        return out

    rgb = torch.stack([select((v, q, p, p, t), v), select((t, v, v, q, p), p),
                       select((p, p, t, v, v), q)], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def color_jitter(images, factors, order_u, apply, hue: float):
    """ColorJitter with per-image factors (B, 4) = (brightness, contrast,
    saturation, hue delta), the sub-op order argsort(order_u) per image,
    and the RandomApply mask `apply` (B,) (augment.py:218-256)."""
    view = (-1, 1, 1, 1)
    fb, fc, fs, fh = (factors[:, j].reshape(view) for j in range(4))
    order = torch.argsort(order_u, dim=1, stable=True)
    out = images
    for slot in range(4):
        idx = order[:, slot].reshape(view)
        xb, xc, xs = adjust_brightness(out, fb), adjust_contrast(out, fc), adjust_saturation(out, fs)
        xh = adjust_hue(out, fh) if hue > 0 else out
        out = torch.where(idx == 0, xb, torch.where(idx == 1, xc, torch.where(idx == 2, xs, xh)))
    return torch.where(apply.reshape(view), out, images)


def grayscale(images, take):
    """RandomGrayscale with the mask `take` (B,)."""
    gray = _rgb_to_gray(images).expand_as(images)
    return torch.where(take.reshape(-1, 1, 1, 1), gray, images)


# ---------------------------------------------------------------- blur


def gaussian_kernels(sigma: torch.Tensor, taps: int = BLUR_TAPS) -> torch.Tensor:
    """(B, taps) normalized 1-D Gaussian kernels for per-image sigma."""
    x = torch.arange(taps, dtype=torch.float32, device=sigma.device) - (taps - 1) / 2.0
    k = torch.exp(-0.5 * (x[None, :] / sigma[:, None]) ** 2)
    return k / k.sum(dim=1, keepdim=True)


def gaussian_blur(images, sigma, apply, taps: int = BLUR_TAPS):
    """Separable Gaussian blur with edge-replicate padding, per-image sigma
    (B,), kept where `apply` (B,) (augment.py:276-304): a depthwise
    vertical then horizontal pass."""
    b, h, w, c = images.shape
    k1d = gaussian_kernels(sigma, taps).repeat_interleave(c, dim=0)  # (B*C, taps)
    x = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    pad = taps // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    x = F.conv2d(x, k1d.reshape(b * c, 1, taps, 1), groups=b * c)
    x = F.conv2d(x, k1d.reshape(b * c, 1, 1, taps), groups=b * c)
    blurred = x.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return torch.where(apply.reshape(-1, 1, 1, 1), blurred, images)


def horizontal_flip(images, flip):
    return torch.where(flip.reshape(-1, 1, 1, 1), images.flip(2), images)


# -------------------------------------------------------------- recipes


class AugRecipe(NamedTuple):
    """A composed augmentation (augment.py:325)."""

    name: str
    crop: bool  # random-resized-crop from the (larger) input
    jitter: tuple[float, float, float, float]
    jitter_prob: float
    grayscale_prob: float
    blur_prob: float
    crop_scale: tuple[float, float] = (0.2, 1.0)
    mean: tuple = IMAGENET_MEAN
    std: tuple = IMAGENET_STD


V1_RECIPE = AugRecipe("v1", True, (0.4, 0.4, 0.4, 0.4), 1.0, 0.2, 0.0)
V2_RECIPE = AugRecipe("v2", True, (0.4, 0.4, 0.4, 0.1), 0.8, 0.2, 0.5)
# The linear probe's training transform (`main_lincls.py`, augment.py:343):
# RandomResizedCrop (scale 0.08-1) + flip + normalize only.
PROBE_RECIPE = AugRecipe("probe", True, (0.0, 0.0, 0.0, 0.0), 0.0, 0.0, 0.0, (0.08, 1.0))
# Geometric only (crop + flip + normalize, the pretraining crop scale): the
# BN-leak positive control's recipe (augment.py:348).
CROPS_ONLY_RECIPE = AugRecipe("probe", True, (0.0, 0.0, 0.0, 0.0), 0.0, 0.0, 0.0, (0.2, 1.0))


def get_recipe(aug_plus: bool, image_size: int, crops_only: bool = False) -> AugRecipe:
    """v2, v1 or crops only; CIFAR-sized inputs (<= 64 px) skip blur and
    use the CIFAR statistics (augment.py:387)."""
    base = CROPS_ONLY_RECIPE if crops_only else (V2_RECIPE if aug_plus else V1_RECIPE)
    if image_size <= 64:
        return base._replace(blur_prob=0.0, mean=CIFAR_MEAN, std=CIFAR_STD)
    return base


def draw_recipe(recipe: AugRecipe, generator: torch.Generator, batch: int) -> dict:
    """Every unit uniform one view of `recipe` consumes, from `generator`
    (on the device the images live on): the crop's four (B, 10) tables,
    the jitter factors (B, 4) and order (B, 4), and one (B,) draw per
    Bernoulli mask and for the blur sigma. Bernoulli(p) is `u < p`."""
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    draws = {}
    if recipe.crop:
        draws["crop"] = {k: rand(batch, CROP_ATTEMPTS) for k in ("scale", "log_ratio", "y", "x")}
    draws["jitter"] = rand(batch, 4)
    draws["order"] = rand(batch, 4)
    draws["jitter_apply"] = rand(batch)
    draws["gray"] = rand(batch)
    draws["blur_sigma"] = rand(batch)
    draws["blur_apply"] = rand(batch)
    draws["flip"] = rand(batch)
    return draws


def apply_recipe(recipe: AugRecipe, draws: dict, images: torch.Tensor, out_size: int):
    """One view from its draws (augment.py:351): crop, then v1's grayscale
    and jitter, v2's jitter, grayscale and blur, or nothing (crops only),
    then flip and normalize.
    `images` float [0, 1] NHWC, any (H, W) >= out_size."""
    x = images
    if recipe.crop:
        _, h, w, _ = x.shape
        boxes = crop_boxes(draws["crop"], h, w, scale=recipe.crop_scale)
        x = crop_resize(x, *boxes, out_size)
    if recipe.name == "probe":  # crop, flip and normalize only
        x = horizontal_flip(x, draws["flip"] < 0.5)
        return normalize(x, recipe.mean, recipe.std)
    b = x.shape[0]
    bright, contrast, sat, hue = recipe.jitter
    u = draws["jitter"]
    factors = torch.stack([
        uniform_range(u[:, 0], max(0.0, 1 - bright), 1 + bright),
        uniform_range(u[:, 1], max(0.0, 1 - contrast), 1 + contrast),
        uniform_range(u[:, 2], max(0.0, 1 - sat), 1 + sat),
        uniform_range(u[:, 3], -hue, hue),
    ], dim=1)
    jitter_on = (draws["jitter_apply"] < recipe.jitter_prob if recipe.jitter_prob < 1.0
                 else torch.ones(b, dtype=torch.bool, device=x.device))
    gray_on = draws["gray"] < recipe.grayscale_prob
    if recipe.name == "v1":
        x = grayscale(x, gray_on)
        x = color_jitter(x, factors, draws["order"], jitter_on, hue)
    else:
        x = color_jitter(x, factors, draws["order"], jitter_on, hue)
        x = grayscale(x, gray_on)
        if recipe.blur_prob > 0:
            sigma = uniform_range(draws["blur_sigma"], 0.1, 2.0)
            x = gaussian_blur(x, sigma, draws["blur_apply"] < recipe.blur_prob)
    x = horizontal_flip(x, draws["flip"] < 0.5)
    return normalize(x, recipe.mean, recipe.std)


def two_crop_augment(recipe: AugRecipe, generator: torch.Generator, images: torch.Tensor,
                     out_size: int) -> dict:
    """TwoCropsTransform (`moco/loader.py:~L10-20`): the recipe twice, the
    query view's draws first -> {"im_q", "im_k"}."""
    b = images.shape[0]
    dq = draw_recipe(recipe, generator, b)
    dk = draw_recipe(recipe, generator, b)
    return {"im_q": apply_recipe(recipe, dq, images, out_size),
            "im_k": apply_recipe(recipe, dk, images, out_size)}

