"""Host-side dataset sources (the port's copy of moco_tpu/data/datasets.py).

A dataset is an indexable source of raw uint8 HWC images and labels;
decode and resize run on host threads, the stochastic augmentation on the
device (`data/augment.py`). Every source gives the same bytes as its
JAX twin for the same index.

Sources:
- `SyntheticDataset`: seeded random images (tests, smoke runs);
- `LearnableSyntheticDataset`, `HardSyntheticDataset`,
  `HardTemplateDataset`, `LeakControlSyntheticDataset`: seeded tasks with
  class structure, for learning-signal runs without a download;
- `Cifar10Dataset`: the standard python-pickle batches from a local
  directory (nothing is downloaded);
- `ImageFolderDataset`: class-per-subdirectory layout with torchvision
  ImageFolder's semantics (sorted class names -> indices), and the
  host-crop protocol (`dims`, `load_crop_batch`);
- `build_dataset` routes `imagefolder` through the packed RGB cache
  (`data/cache.py`) when a cache dir is set, else through the native C++
  loader (`data/native_loader.py`) where it builds, else through PIL.

PIL is imported inside the functions that decode, so the package imports
without it.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from moco_tpu_torch.utils import retry

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


def draw_rrc_uniforms(
    rng: np.random.Generator, n: int, attempts: int = 10
) -> dict[str, np.ndarray]:
    """The four uniform tables one RandomResizedCrop sample consumes
    (scale, log-ratio, y, x — each (n, attempts)), drawn VECTORIZED from
    a single generator. The pipeline draws one table for the whole
    global batch × crops instead of constructing a fresh seeded
    Generator per (row, crop) — measured at ~0.24 ms per (row, crop) of
    pure seeding/slicing overhead (scripts/profile_input.py), i.e.
    ~120 ms of serial host time per 256-image two-crop batch."""
    return {
        "scale": rng.uniform(size=(n, attempts)),
        "log_ratio": rng.uniform(size=(n, attempts)),
        "y": rng.uniform(size=(n, attempts)),
        "x": rng.uniform(size=(n, attempts)),
    }


def rrc_boxes_from_uniforms(
    u: dict[str, np.ndarray],
    dims: np.ndarray,  # (bs, 2) original (h, w) per image
    scale: tuple[float, float] = (0.2, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """(bs, 4) int32 RandomResizedCrop boxes (y0, x0, ch, cw) in ORIGINAL
    image coordinates from pre-drawn uniforms — torchvision get_params
    semantics (10-attempt rejection + ratio-clamped center-crop
    fallback), vectorized in numpy for the host-crop pipeline
    (`augment.crop_boxes` is the on-device twin)."""
    b = dims.shape[0]
    attempts = u["scale"].shape[1]
    h = np.maximum(dims[:, 0].astype(np.float64), 1.0)
    w = np.maximum(dims[:, 1].astype(np.float64), 1.0)
    area = h * w
    ta = (scale[0] + (scale[1] - scale[0]) * u["scale"]) * area[:, None]
    log_r0, log_r1 = np.log(ratio[0]), np.log(ratio[1])
    ar = np.exp(log_r0 + (log_r1 - log_r0) * u["log_ratio"])
    cw = np.round(np.sqrt(ta * ar))
    ch = np.round(np.sqrt(ta / ar))
    valid = (cw > 0) & (cw <= w[:, None]) & (ch > 0) & (ch <= h[:, None])
    first = np.argmax(valid, axis=1)
    any_valid = valid.any(axis=1)
    rows = np.arange(b)
    cw_s, ch_s = cw[rows, first], ch[rows, first]
    y0 = np.floor(u["y"][rows, first] * (h - ch_s + 1.0))
    x0 = np.floor(u["x"][rows, first] * (w - cw_s + 1.0))

    in_ratio = w / h
    fw = np.where(in_ratio < ratio[0], w, np.where(in_ratio > ratio[1], np.round(h * ratio[1]), w))
    fh = np.where(in_ratio < ratio[0], np.round(w / ratio[0]), h)
    fy = np.floor((h - fh) / 2)
    fx = np.floor((w - fw) / 2)
    ch_s = np.where(any_valid, ch_s, fh)
    cw_s = np.where(any_valid, cw_s, fw)
    y0 = np.where(any_valid, y0, fy)
    x0 = np.where(any_valid, x0, fx)
    return np.stack([y0, x0, ch_s, cw_s], axis=1).astype(np.int32)


def sample_rrc_boxes(
    rng: np.random.Generator,
    dims: np.ndarray,
    scale: tuple[float, float] = (0.2, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    attempts: int = 10,
) -> np.ndarray:
    """Draw + transform in one call (tests and single-shot callers);
    the pipeline uses the split form to amortize the draw over the
    whole batch."""
    return rrc_boxes_from_uniforms(
        draw_rrc_uniforms(rng, dims.shape[0], attempts), dims, scale, ratio
    )


class SyntheticDataset:
    """Fixed-seed random uint8 images; index-deterministic so tests can
    rely on reproducibility without holding the whole set in memory."""

    def __init__(self, num_examples: int = 1024, image_size: int = 224, num_classes: int = 10):
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_classes = num_classes

    def __len__(self) -> int:
        return self.num_examples

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        size = decode_size or self.image_size
        rng = np.random.default_rng(index)
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        return img, int(index % self.num_classes)


class LearnableSyntheticDataset:
    """Deterministic synthetic dataset with real class structure — the
    learning-signal stand-in for ImageNet in this no-dataset environment
    (the reference's de-facto test is metric reproduction on ImageNet,
    SURVEY.md §4; this gives the same end-to-end signal at CI scale).

    Each class c is a fixed low-frequency color field (seeded by c);
    an instance adds a seeded affine warp of the template (shift +
    scale), its own high-frequency texture, and pixel noise. Same-class
    images are therefore similar but not identical, and two random crops
    of one image share instance + class structure — exactly the setting
    in which contrastive pretraining produces kNN/probe accuracy far
    above chance while raw-pixel kNN stays weak.
    """

    def __init__(
        self,
        num_examples: int = 2048,
        image_size: int = 32,
        num_classes: int = 8,
        train: bool = True,
        noise: float = 0.15,
    ):
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_classes = num_classes
        self.noise = noise
        # train/test draw disjoint instance seeds from the same classes
        self._seed_base = 0 if train else 1_000_003
        # class templates: smooth random RGB fields, upsampled 4x4 -> full
        self._templates = []
        for c in range(num_classes):
            rng = np.random.default_rng(77_000 + c)
            coarse = rng.uniform(0.15, 0.85, (4, 4, 3))
            self._templates.append(_bilinear_upsample(coarse, image_size))

    def __len__(self) -> int:
        return self.num_examples

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        size = decode_size or self.image_size
        label = int(index % self.num_classes)
        rng = np.random.default_rng(self._seed_base + index)
        t = self._templates[label]
        # instance-specific roll (toroidal shift) + brightness/contrast
        dy, dx = rng.integers(0, self.image_size, 2)
        img = np.roll(np.roll(t, dy, axis=0), dx, axis=1)
        img = img * rng.uniform(0.8, 1.2) + rng.uniform(-0.1, 0.1)
        # instance texture: a smooth field unique to this example
        coarse = rng.uniform(-1.0, 1.0, (8, 8, 3))
        img = img + 0.25 * _bilinear_upsample(coarse, self.image_size)
        img = img + rng.normal(0.0, self.noise, img.shape)
        img = np.clip(img, 0.0, 1.0)
        if size != self.image_size:
            img = _bilinear_upsample(img, size)
        return (img * 255).astype(np.uint8), label


class HardSyntheticDataset:
    """Harder learning-signal task (VERDICT r2 next-round #7): ≥32
    classes, raw-pixel kNN at chance, large pretrain headroom.

    Class identity is a *power spectrum*: each class c owns a smooth
    spectral mask (a few Gaussian lobes in log-frequency × orientation
    space, seeded by c), and an instance is white noise filtered by
    that mask — a Gaussian random field with class-specific texture
    statistics. Every frequency bin carries an independent random
    phase, so two same-class instances are pixel-decorrelated in
    hundreds of independent dimensions (no phase-matched twin exists
    in any reasonably-sized bank) and raw-pixel kNN sits at chance.
    The class signature survives exactly the transforms two-crop
    training is invariant to — cropping, rescaling, color jitter all
    preserve the orientation/band structure of the texture — so the
    crop-invariant content IS the label (the reference's QA is metric
    reproduction on ImageNet, SURVEY.md §4; this gives the same
    end-to-end evidence with an honest margin over the pixel
    baseline, unlike the 8-class `LearnableSyntheticDataset` where
    pixel kNN reaches ~73%).

    `tests/test_data.py` validates both halves: pixel-kNN ≈ chance
    and an FFT-magnitude oracle (phase-invariant spectral features)
    far above chance, i.e. the task is unsolvable from pixels but
    solvable from exactly the invariances two-crop training rewards.
    """

    def __init__(
        self,
        num_examples: int = 16384,
        image_size: int = 32,
        num_classes: int = 32,
        train: bool = True,
        n_lobes: int = 4,
        signal: float = 0.28,
        nuisance: float = 0.40,
        noise: float = 0.04,
    ):
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_classes = num_classes
        self.signal = signal
        self.nuisance = nuisance
        self.noise = noise
        self._seed_base = 0 if train else 9_000_017
        # class spectral masks over the full fft grid (image_size²),
        # built from n_lobes Gaussian bumps in (log radius, orientation);
        # band 2-10 cycles/image: low enough to survive the v2 recipe's
        # blur and the RRC rescale (which shifts apparent frequency by
        # the crop scale, up to ~2.2x), high enough to be texture rather
        # than color. Lobe widths (0.5 in log-radius, 0.8 in angle) are
        # tuned so the mask spans enough independent frequency bins that
        # best-of-bank phase matching fails: measured pixel-kNN 5.5% vs
        # 3.1% chance with narrow lobes leaking 40%+ (the FFT oracle
        # stays at 95%).
        s = image_size
        fy = np.fft.fftfreq(s)[:, None] * s  # cycles/image
        fx = np.fft.fftfreq(s)[None, :] * s
        r = np.hypot(fy, fx)
        logr = np.log(np.maximum(r, 1e-6))
        ang = np.arctan2(fy, fx) % np.pi  # spectrum symmetry: angle mod pi
        self._masks = np.empty((num_classes, s, s))
        for c in range(num_classes):
            rng = np.random.default_rng(55_000 + c)
            mask = np.zeros((s, s))
            for _ in range(n_lobes):
                lr0 = rng.uniform(np.log(2.0), np.log(10.0))
                a0 = rng.uniform(0.0, np.pi)
                d_ang = np.minimum(np.abs(ang - a0), np.pi - np.abs(ang - a0))
                mask += np.exp(
                    -((logr - lr0) ** 2) / (2 * 0.5**2) - d_ang**2 / (2 * 0.8**2)
                )
            mask[r < 1.5] = 0.0  # no DC/near-DC: keep signal out of mean color
            self._masks[c] = mask / np.sqrt((mask**2).mean() + 1e-12)

    def __len__(self) -> int:
        return self.num_examples

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        size = decode_size or self.image_size
        label = int(index % self.num_classes)
        rng = np.random.default_rng(self._seed_base + index)
        s = self.image_size
        mask = self._masks[label]
        # per-channel GRF: filter white noise through the class mask
        white = rng.normal(size=(3, s, s))
        tex = np.fft.ifft2(np.fft.fft2(white, axes=(1, 2)) * mask, axes=(1, 2)).real
        tex = tex / (tex.std(axis=(1, 2), keepdims=True) + 1e-8)
        img = 0.5 + self.signal * tex.transpose(1, 2, 0)
        # instance nuisance: smooth color field dominating pixel distance
        coarse = rng.uniform(-1.0, 1.0, (4, 4, 3))
        img = img + self.nuisance * _bilinear_upsample(coarse, s)
        img = img + rng.normal(0.0, self.noise, img.shape)
        img = np.clip(img, 0.0, 1.0)
        if size != self.image_size:
            img = _bilinear_upsample(img, size)
        return (img * 255).astype(np.uint8), label


class HardTemplateDataset:
    """Second-generation hard learning-signal task (the redesign brief in
    REPORT.md's hard-signal section): class identity is a FIXED texture
    realization, instances are geometric transforms of it.

    `HardSyntheticDataset` (class = power spectrum, instance = fresh
    phases) measured unlearnable at CI budget: per-instance phases are
    themselves a perfect crop-invariant instance signature, so instance
    discrimination never needs class structure. Here the design inverts:
    every instance of class c carries the SAME band-limited texture
    realization T_c, seen under a random rotation + scale + toroidal
    shift. Shared class structure (the template) is now the cheapest
    crop-invariant signal — the regime where instance discrimination
    provably transfers (the 8-class template task) — while pixel kNN
    dies geometrically: the (rotation × scale × shift) transform space
    is far too large for any bank to contain a near-aligned same-class
    neighbor (`tests/test_data.py` pins pixel-kNN near chance).

    STATUS (measured, REPORT.md hard-signal section): pixel-kNN at
    chance as designed, but the 12-epoch CI-budget training gate FAILED
    (kNN flat ~4%): a CNN solves instance discrimination with
    rotation-SPECIFIC template features that do not cluster across a
    class's rotations. Kept as the documented experiment; not
    registered as a supported dataset. The lesson feeds the next
    design: the class-shared signal must be invariant under transforms
    conv features natively tolerate (translation/scale/appearance
    noise), not rotation.
    """

    def __init__(
        self,
        num_examples: int = 16384,
        image_size: int = 32,
        num_classes: int = 32,
        train: bool = True,
        signal: float = 0.30,
        nuisance: float = 0.25,
        noise: float = 0.04,
        scale_range: tuple[float, float] = (0.75, 1.35),
    ):
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_classes = num_classes
        self.signal = signal
        self.nuisance = nuisance
        self.noise = noise
        self.scale_range = scale_range
        self._seed_base = 0 if train else 9_000_017
        # class templates: band-limited GRF realizations on a 2x-size
        # torus (band chosen so a 1x window sees ~2-8 cycles; the torus
        # wraps, so any rotated/scaled window samples valid texture)
        t = 2 * image_size
        fy = np.fft.fftfreq(t)[:, None] * t
        fx = np.fft.fftfreq(t)[None, :] * t
        r = np.hypot(fy, fx)
        # 4-16 cycles per 2x torus = 2-8 per 1x window
        band = ((r >= 4.0) & (r <= 16.0)).astype(np.float64)
        self._templates = np.empty((num_classes, t, t, 3))
        for c in range(num_classes):
            rng = np.random.default_rng(77_700 + c)
            white = rng.normal(size=(3, t, t))
            tex = np.fft.ifft2(np.fft.fft2(white, axes=(1, 2)) * band, axes=(1, 2)).real
            tex /= tex.std(axis=(1, 2), keepdims=True) + 1e-8
            self._templates[c] = tex.transpose(1, 2, 0)

    def __len__(self) -> int:
        return self.num_examples

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        size = decode_size or self.image_size
        label = int(index % self.num_classes)
        rng = np.random.default_rng(self._seed_base + index)
        t = self._templates[label]
        ts = t.shape[0]
        s = self.image_size
        theta = rng.uniform(0.0, 2 * np.pi)
        zoom = rng.uniform(*self.scale_range)
        dy, dx = rng.uniform(0.0, ts, 2)
        # inverse-map the s x s window through rotate/scale/shift on the torus
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float64)
        ct, st = np.cos(theta), np.sin(theta)
        sy = (ct * yy - st * xx) / zoom + dy
        sx = (st * yy + ct * xx) / zoom + dx
        y0 = np.floor(sy).astype(int)
        x0 = np.floor(sx).astype(int)
        wy = (sy - y0)[..., None]
        wx = (sx - x0)[..., None]
        y0 %= ts; x0 %= ts
        y1 = (y0 + 1) % ts
        x1 = (x0 + 1) % ts
        tex = (
            t[y0, x0] * (1 - wy) * (1 - wx)
            + t[y0, x1] * (1 - wy) * wx
            + t[y1, x0] * wy * (1 - wx)
            + t[y1, x1] * wy * wx
        )
        img = 0.5 + self.signal * tex
        coarse = rng.uniform(-1.0, 1.0, (4, 4, 3))
        img = img + self.nuisance * _bilinear_upsample(coarse, s)
        img = img + rng.normal(0.0, self.noise, img.shape)
        img = np.clip(img, 0.0, 1.0)
        if size != s:
            img = _bilinear_upsample(img, size)
        return (img * 255).astype(np.uint8), label


def _bilinear_upsample(field: np.ndarray, size: int) -> np.ndarray:
    """(h, w, c) float -> (size, size, c) bilinear (numpy, no deps)."""
    h, w, _ = field.shape
    ys = np.linspace(0, h - 1, size)
    xs = np.linspace(0, w - 1, size)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = field[y0][:, x0] * (1 - wy) * (1 - wx)
    b = field[y0][:, x1] * (1 - wy) * wx
    c = field[y1][:, x0] * wy * (1 - wx)
    d = field[y1][:, x1] * wy * wx
    return a + b + c + d


class LeakControlSyntheticDataset:
    """BN-cheat POSITIVE CONTROL (VERDICT r3 missing #3): a task built so
    the batch-statistics shortcut Shuffle-BN prevents
    (the reference model's ~L79-126) is the DOMINANT gradient.

    Why the leak never developed on the other synthetic tasks: their
    two crops share strong pixel content, so the honest channel is far
    cheaper than reading co-batch statistics. This dataset inverts the
    balance. Every image is iid uniform noise (two non-identical crops
    of noise are content-decorrelated — resampling destroys pixel
    alignment) carrying only a weak GLOBAL color tint:

        img = noise + class_tint[label] + instance_tint[index]

    The tint is the only crop-invariant signal. Per crop it is weak
    (amplitude ~ the crop's noise-mean fluctuation), so the honest path
    — estimate the tint from one crop, match it across views — is slow.
    But BatchNorm *injects* each BN group's mean into every activation
    it normalizes: with tiny groups (2 rows/device), the injected
    co-batch fingerprint (tint_a + tint_b)/2 has several times the
    per-crop SNR and is shared between the query group and the aligned
    key group by construction. Training with shuffle='none' therefore
    has a high-SNR shortcut that solves the (K+1)-way task without
    learning content; gather_perm/a2a decorrelate the key groups and
    leave only the honest channel. Run with crops-only augmentation —
    photometric jitter (±0.4 brightness) would swamp a 0.03-0.05 tint
    through BOTH channels and mask the phenomenon.

    The class component of the tint survives to held-out instances, so
    class-kNN measures honest learning; the instance component makes
    group fingerprints near-unique (queue keys from other compositions
    rarely collide, keeping the cheat's ceiling high).
    """

    def __init__(
        self,
        num_examples: int = 512,
        image_size: int = 32,
        num_classes: int = 8,
        train: bool = True,
        class_tint: float = 0.03,
        instance_tint: float = 0.05,
    ):
        self.num_examples = num_examples
        self.image_size = image_size
        self.num_classes = num_classes
        self.class_tint = class_tint
        self.instance_tint = instance_tint
        self._seed_base = 0 if train else 9_000_017
        tints = []
        for c in range(num_classes):
            v = np.random.default_rng(551_000 + c).normal(size=3)
            tints.append(v / np.linalg.norm(v) * class_tint)
        self._class_tints = np.asarray(tints)

    def __len__(self) -> int:
        return self.num_examples

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        size = decode_size or self.image_size
        label = int(index % self.num_classes)
        rng = np.random.default_rng(self._seed_base + index)
        inst = rng.normal(size=3)
        inst = inst / np.linalg.norm(inst) * self.instance_tint
        img = rng.uniform(0.0, 1.0, (size, size, 3))
        img = img + self._class_tints[label] + inst
        img = np.clip(img, 0.0, 1.0)
        return (img * 255).astype(np.uint8), label


class Cifar10Dataset:
    """CIFAR-10 from the standard `cifar-10-batches-py` pickle files."""

    def __init__(self, data_dir: str, train: bool = True):
        batch_dir = data_dir
        if os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py")):
            batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        images, labels = [], []
        for name in names:
            path = os.path.join(batch_dir, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} not found — provide the standard cifar-10-batches-py "
                    "directory (no network access to download it)"
                )

            def _read(p=path):
                with open(p, "rb") as f:
                    return pickle.load(f, encoding="bytes")

            d = retry.retry_call(_read, site="data.cifar10")
            images.append(d[b"data"])
            labels.extend(d[b"labels"])
        data = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.images = np.ascontiguousarray(data)  # uint8 NHWC
        self.labels = np.asarray(labels, np.int32)
        self.num_classes = 10

    def __len__(self) -> int:
        return len(self.images)

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        return self.images[index], int(self.labels[index])


class ImageFolderDataset:
    """`root/class_x/img.jpg` layout; classes sorted alphabetically, as
    torchvision ImageFolder assigns indices."""

    def __init__(self, root: str, decode_size: int = 256):
        self.root = root
        self.decode_size = decode_size
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        if not classes:
            raise ValueError(f"no class subdirectories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.num_classes = len(classes)
        # Cumulative zero-filled crop slots (undecodable images) —
        # surfaced by the pipeline as the `decode_failures` metric so
        # corrupt data is visible instead of silently training on black.
        self.decode_failures = 0
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[index]
        size = decode_size or self.decode_size

        def _decode():
            with Image.open(path) as im:
                im = im.convert("RGB")
                # Shortest-side resize to `size` on the host; used by the
                # eval center-crop path and as the canvas for on-device RRC
                # when host_rrc is off. (Training normally uses the
                # host-crop protocol below, which samples crops against the
                # ORIGINAL geometry — no canvas clipping.)
                w, h = im.size
                s = size / min(w, h)
                # explicit BILINEAR: the reference's torchvision transforms
                # default, and what native/loader.cc reproduces (antialiased)
                im = im.resize(
                    (max(size, round(w * s)), max(size, round(h * s))),
                    resample=Image.BILINEAR,
                )
                return np.asarray(im, np.uint8)

        # transient filesystem errors retry; a truly bad file raises
        arr = retry.retry_call(_decode, site="data.imagefolder")
        # Center-crop the long side to a square canvas of fixed shape so
        # batches stack.
        h, w, _ = arr.shape
        y0, x0 = (h - size) // 2, (w - size) // 2
        return arr[y0 : y0 + size, x0 : x0 + size], label

    # -- host-crop protocol (same surface as NativeImageFolderDataset):
    # the pipeline samples RandomResizedCrop boxes against the ORIGINAL
    # image geometry and the dataset decodes once + crops N times, so the
    # crop distribution matches torchvision exactly (no fixed-canvas
    # clipping — VERDICT r1 weak-item 6). ------------------------------
    def dims(self, indices) -> np.ndarray:
        from PIL import Image

        if not hasattr(self, "_dims_cache"):
            self._dims_cache: dict[int, tuple[int, int]] = {}
        out = np.zeros((len(indices), 2), np.int32)
        for row, i in enumerate(np.asarray(indices, np.int64)):
            i = int(i)
            hw = self._dims_cache.get(i)
            if hw is None:
                try:
                    with Image.open(self.samples[i][0]) as im:  # header-only
                        w, h = im.size
                    hw = (h, w)
                except Exception:
                    hw = (0, 0)
                self._dims_cache[i] = hw
            out[row] = hw
        return out

    def load_crop_batch(
        self, indices, boxes: np.ndarray, out_size: int, pool=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(bs, n_crops, out, out, 3) uint8 + labels; PIL resized-crop.
        `pool` is the caller's ThreadPoolExecutor (the pipeline passes its
        config.num_workers-sized pool); a small default is created only
        for direct/test use."""
        from PIL import Image

        idx = np.asarray(indices, np.int64)
        boxes = np.asarray(boxes, np.int64)
        bs, n_crops = boxes.shape[0], boxes.shape[1]
        out = np.zeros((bs, n_crops, out_size, out_size, 3), np.uint8)
        labels = np.empty(bs, np.int32)

        def one(row):
            # returns the failure count for this row instead of bumping
            # self.decode_failures from 8 pool threads at once — `+=` is
            # a read-modify-write, and concurrent workers lose updates
            # (JX012); the caller aggregates single-threaded below
            i = int(idx[row])
            path, label = self.samples[i]
            labels[row] = label
            try:
                with Image.open(path) as im:
                    im = im.convert("RGB")
                    w, h = im.size
                    for c in range(n_crops):
                        y0, x0, ch, cw = boxes[row, c]
                        y0 = int(np.clip(y0, 0, h - 1))
                        x0 = int(np.clip(x0, 0, w - 1))
                        ch = int(np.clip(ch, 1, h - y0))
                        cw = int(np.clip(cw, 1, w - x0))
                        crop = im.crop((x0, y0, x0 + cw, y0 + ch)).resize(
                            (out_size, out_size), resample=Image.BILINEAR
                        )
                        out[row, c] = np.asarray(crop, np.uint8)
            except Exception:
                return 1  # slot stays zero, but COUNTED (by the caller)
            return 0

        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            if not hasattr(self, "_crop_pool"):
                self._crop_pool = ThreadPoolExecutor(max_workers=8)
            pool = self._crop_pool
        self.decode_failures += sum(pool.map(one, range(bs)))
        return out, labels


def build_dataset(
    name: str,
    data_dir: Optional[str],
    image_size: int,
    train: bool = True,
    num_workers: int = 8,
    cache_dir: Optional[str] = None,
):
    if name == "synthetic":
        return SyntheticDataset(image_size=max(image_size, 32))
    if name == "synthetic_learnable":
        return LearnableSyntheticDataset(image_size=max(image_size, 32), train=train)
    if name == "synthetic_hard":
        return HardSyntheticDataset(
            num_examples=16384 if train else 2048,
            image_size=max(image_size, 32),
            train=train,
        )
    if name == "synthetic_learnable32":
        # the round-3 hard-task redesign's surviving candidate (REPORT.md
        # hard-signal lesson v2): the PROVEN template design — class
        # structure as the cheapest crop-invariant signal, inside the
        # transform group conv features tolerate — at 32 classes with
        # heavy per-instance noise (pixel-kNN ~7% vs 3.1% chance). The
        # budget-binding claim is tested by running THIS task at the
        # headline chain's budget.
        return LearnableSyntheticDataset(
            image_size=max(image_size, 32), train=train,
            num_classes=32, noise=0.5,
        )
    if name == "synthetic_leak_control":
        return LeakControlSyntheticDataset(image_size=max(image_size, 32), train=train)
    if name == "cifar10":
        if data_dir is None:
            raise ValueError("cifar10 needs data_dir")
        return Cifar10Dataset(data_dir, train=train)
    if name == "imagefolder":
        if data_dir is None:
            raise ValueError("imagefolder needs data_dir")
        split = "train" if train else "val"
        root = data_dir
        if os.path.isdir(os.path.join(data_dir, split)):
            root = os.path.join(data_dir, split)
        # decode canvas ~1.146x the crop (256 for 224-crops, the standard ratio)
        decode_size = round(image_size * 256 / 224)
        if cache_dir:
            # decode-once packed RGB cache: built from the plain folder
            # listing, then all epoch reads come from the mmap. Reuse
            # re-lists the source to verify the stamped fingerprint (a
            # drifted listing raises; a since-REMOVED data_dir is
            # tolerated — the cache is self-contained).
            from moco_tpu_torch.data.cache import PackedRGBCacheDataset, build_rgb_cache

            # key the cache subdir by the RESOLVED root: a flat data_dir
            # (no train/ val/ subdirs) serves both splits from one cache
            # ("all") instead of building two identical copies. Existing
            # caches win over the naming rule: a legacy flat-layout cache
            # under train/ (or val/) is reused rather than re-decoded, and
            # when the source directory is GONE the split detection above
            # degrades (isdir false -> root==data_dir) — the surviving
            # stamped cache from the original layout is still found.
            from moco_tpu_torch.data.cache import _read_stamp

            flat = root == data_dir
            req = "train" if train else "val"
            primary = "all" if flat else req
            # Pass 1 — exact stamp-root match. Flat layout: both splits
            # are the same data, so ANY matching stamped subdir serves
            # (legacy caches included). Split layout: only this split's
            # subdir or "all" may serve — the other split is different
            # data (the root check enforces that).
            candidates = ["all", "train", "val"] if flat else [primary, "all"]
            split = None
            for cand in dict.fromkeys(candidates):
                stamp = _read_stamp(os.path.join(cache_dir, cand))
                if stamp and stamp.get("root") in (None, os.path.realpath(root)):
                    split = cand
                    break
            if split is None and not os.path.isdir(root):
                # Pass 2 — the source is gone, so no stamp can match and
                # the layout is undetectable. Prefer the REQUESTED
                # split's cache (a gone split-layout val request must not
                # silently get the train cache), then "all", then the
                # other split as a last resort. Loud either way: this is
                # indistinguishable from a typo'd --data-dir.
                other = "val" if req == "train" else "train"
                for cand in dict.fromkeys([req, "all", other]):
                    stamp = _read_stamp(os.path.join(cache_dir, cand))
                    if stamp:
                        import warnings

                        warnings.warn(
                            f"data_dir {root!r} does not exist; serving RGB cache "
                            f"{cand!r} built from {stamp.get('root')!r} — if this "
                            "is a mistyped --data-dir, fix it"
                        )
                        split = cand
                        break
            split_cache = os.path.join(cache_dir, split or primary)
            build_rgb_cache(
                lambda: ImageFolderDataset(root, decode_size=decode_size),
                split_cache,
                num_workers=num_workers,
                canvas_size=decode_size,
                root=root,
            )
            return PackedRGBCacheDataset(
                split_cache, decode_size=decode_size, num_workers=num_workers
            )
        from moco_tpu_torch.data.native_loader import native_available

        if native_available():  # C++ decode pool (native/loader.cc)
            from moco_tpu_torch.data.native_loader import NativeImageFolderDataset

            return NativeImageFolderDataset(
                root, decode_size=decode_size, threads=max(num_workers, 1)
            )
        return ImageFolderDataset(root, decode_size=decode_size)
    raise ValueError(f"unknown dataset {name!r}")
