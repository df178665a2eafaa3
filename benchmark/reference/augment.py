"""Plain reference of the MoCo v2 two-crop augmentation (`aug_plus`):
RandomResizedCrop(224, scale 0.2-1), ColorJitter(0.4, 0.4, 0.4, 0.1) with
p 0.8 in a random order, RandomGrayscale(0.2), GaussianBlur(sigma 0.1-2)
with p 0.5, HorizontalFlip(0.5) and the ImageNet normalization.

The random numbers are the inputs. For the batch of step `step` of epoch
`epoch` they come from a `torch.Generator` on the images' device seeded
with `batch_seed(seed, epoch, step)`, drawn per view in this order: the
crop's four (B, 10) tables (area, log aspect, y, x), the jitter factors
(B, 4), the jitter order (B, 4), then one (B,) draw each for the jitter's
coin, the grayscale coin, the blur sigma, the blur coin and the flip coin.
The query view draws first. The transform of those numbers is written out
here on its own: the crop box is torchvision's `get_params` (the first of
ten attempts that fits, else the centre crop), and the resize is a
triangle filter that widens by the downscale factor (antialiased, each
output pixel the normalized weighted sum of the inputs under it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
JITTER = (0.4, 0.4, 0.4, 0.1)
ATTEMPTS = 10
TAPS = 23


def batch_seed(seed: int, epoch: int, step: int) -> int:
    """The draws' seed of one batch."""
    return int(np.random.SeedSequence((seed, epoch, step)).generate_state(1)[0])


def draws(gen: torch.Generator, batch: int) -> dict:
    dev = gen.device

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    d = {"crop": [u(batch, ATTEMPTS) for _ in range(4)], "factors": u(batch, 4),
         "order": u(batch, 4)}
    for name in ("jitter_on", "gray_on", "sigma", "blur_on", "flip"):
        d[name] = u(batch)
    return d


def _lerp(u, lo, hi):
    """A uniform on [lo, hi) from its unit draw: lo + u (hi - lo), with lo
    and hi rounded to float32 first and the arithmetic in float32 (the
    box's `round` and `floor` turn on the last bit)."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=u.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(u * (hi - lo) + lo, lo)


def crop_box(d: dict, h: int, w: int, scale=(0.2, 1.0), ratio=(3 / 4, 4 / 3)):
    """(top, left, height, width), each (B,) float."""
    su, ru, yu, xu = d["crop"]
    area = _lerp(su, scale[0], scale[1]) * (h * w)
    # the logarithms on the draws' device: a card's logf and the CPU's can
    # differ in the last bit, which the box's `round` turns into a pixel
    lo, hi = (torch.log(torch.tensor(r, dtype=torch.float32, device=ru.device)) for r in ratio)
    aspect = torch.exp(_lerp(ru, lo, hi))
    cw = torch.round(torch.sqrt(area * aspect))
    ch = torch.round(torch.sqrt(area / aspect))
    fits = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    boxes = []
    for b in range(fits.shape[0]):
        hit = torch.nonzero(fits[b])
        if len(hit):
            a = int(hit[0])
            top = torch.floor(yu[b, a] * (h - ch[b, a] + 1.0))
            left = torch.floor(xu[b, a] * (w - cw[b, a] + 1.0))
            boxes.append((float(top), float(left), float(ch[b, a]), float(cw[b, a])))
        else:  # the centre crop of the clamped aspect
            r = w / h
            fh, fw = (round(w / ratio[0]), w) if r < ratio[0] else (
                (h, round(h * ratio[1])) if r > ratio[1] else (h, w))
            boxes.append(((h - fh) // 2, (w - fw) // 2, fh, fw))
    return boxes


def _resize_matrix(n_in: int, n_out: int, start: float, length: float, device) -> torch.Tensor:
    """(n_out, n_in) weights taking the span [start, start + length) of an
    axis of n_in pixels to n_out pixels with the triangle filter."""
    f32 = torch.float32
    scale = torch.tensor(n_out, dtype=f32) / torch.tensor(length, dtype=f32)
    inv = 1.0 / scale
    support = torch.clamp_min(inv, 1.0)
    out = torch.arange(n_out, dtype=f32)
    centres = (out + 0.5) * inv - (-torch.tensor(start, dtype=f32) * scale) * inv - 0.5
    src = torch.arange(n_in, dtype=f32)
    wts = torch.clamp_min(1.0 - ((centres[:, None] - src[None, :]).abs() / support).abs(), 0.0)
    total = wts.sum(1, keepdim=True)
    wts = torch.where(total.abs() > 1000 * torch.finfo(f32).eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (centres >= -0.5) & (centres <= n_in - 0.5)
    return torch.where(inside[:, None], wts, 0.0).to(device)


def _gray(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def _blend(a, b, f):
    return (f * a + (1 - f) * b).clamp(0, 1)


def _hue(img, delta):
    """Rotate the hue of one HWC image by `delta` turns (HSV round trip)."""
    r, g, b = img.unbind(-1)
    mx, mn = img.max(-1).values, img.min(-1).values
    c = mx - mn
    s = torch.where(mx > 0, c / torch.where(mx > 0, mx, 1.0), 0.0)
    cc = torch.where(c > 0, c, 1.0)
    rc, gc, bc = (mx - r) / cc, (mx - g) / cc, (mx - b) / cc
    hh = torch.where(r == mx, bc - gc, torch.where(g == mx, 2 + rc - bc, 4 + gc - rc))
    hh = torch.where(c > 0, torch.remainder(hh / 6, 1.0), 0.0)
    hh = torch.remainder(hh + delta, 1.0) * 6
    sector = torch.remainder(torch.floor(hh).to(torch.int64), 6)
    f = hh - torch.floor(hh)
    v = mx
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    table = {0: (v, t, p), 1: (q, v, p), 2: (p, v, t), 3: (p, q, v), 4: (t, p, v), 5: (v, p, q)}
    out = torch.zeros_like(img)
    for k, rgb in table.items():
        out = torch.where((sector == k)[..., None], torch.stack(rgb, -1), out)
    return out.clamp(0, 1)


def one_view(img: torch.Tensor, d: dict, b: int, size: int) -> torch.Tensor:
    """View of image `b` (HWC float in [0, 1]) from row b of the draws."""
    h, w, _ = img.shape
    top, left, bh, bw = crop_box_cache(d, h, w)[b]
    wy = _resize_matrix(h, size, top, bh, img.device)
    wx = _resize_matrix(w, size, left, bw, img.device)
    rows = (wy @ img.reshape(h, -1)).reshape(size, w, -1)
    x = torch.einsum("ywc,xw->yxc", rows, wx)
    fac = d["factors"][b]
    factors = [_lerp(fac[0], 0.6, 1.4), _lerp(fac[1], 0.6, 1.4), _lerp(fac[2], 0.6, 1.4),
               _lerp(fac[3], -JITTER[3], JITTER[3])]
    if d["jitter_on"][b] < 0.8:
        for op in torch.argsort(d["order"][b], stable=True).tolist():
            if op == 0:
                x = _blend(x, torch.zeros_like(x), factors[0])
            elif op == 1:
                x = _blend(x, _gray(x).mean(), factors[1])
            elif op == 2:
                x = _blend(x, _gray(x), factors[2])
            else:
                x = _hue(x, factors[3])
    if d["gray_on"][b] < 0.2:
        x = _gray(x).expand_as(x)
    if d["blur_on"][b] < 0.5:
        sigma = _lerp(d["sigma"][b], 0.1, 2.0)
        t = torch.arange(TAPS, dtype=torch.float32, device=x.device) - (TAPS - 1) / 2
        k = torch.exp(-0.5 * (t / sigma) ** 2)
        k = k / k.sum()
        y = F.pad(x.permute(2, 0, 1)[None], (TAPS // 2,) * 4, mode="replicate")[0]
        y = F.conv2d(y[:, None], k.reshape(1, 1, TAPS, 1))
        y = F.conv2d(y, k.reshape(1, 1, 1, TAPS))
        x = y[:, 0].permute(1, 2, 0)
    if d["flip"][b] < 0.5:
        x = x.flip(1)
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return (x - mean) / std


def crop_box_cache(d: dict, h: int, w: int):
    key = ("boxes", h, w)
    if key not in d:
        d[key] = crop_box(d, h, w)
    return d[key]


def two_views(images_u8: torch.Tensor, seed: int, epoch: int, step: int, size: int) -> tuple:
    """(im_q, im_k), (B, size, size, 3) float32, of a batch of uint8 NHWC
    images on the device the draws are made on."""
    gen = torch.Generator(device=images_u8.device).manual_seed(batch_seed(seed, epoch, step))
    n = images_u8.shape[0]
    dq, dk = draws(gen, n), draws(gen, n)
    imgs = images_u8.float() / 255.0
    return tuple(torch.stack([one_view(imgs[b], d, b, size) for b in range(n)]) for d in (dq, dk))
