"""Decode-once packed RGB cache for path-based datasets (the port's copy of
moco_tpu/data/cache.py: the same layout, stamp and checks, so a cache
built by either package reads the same in the other).

The reference hides JPEG-decode cost behind 32 DataLoader worker
processes per GPU (`main_moco.py:~L256` num_workers); on hosts with few
cores the decode bounds the input pipeline. This cache removes the
per-epoch decode entirely: every image is decoded ONCE at full original geometry and its
raw RGB pixels appended to one packed file; epochs then read crops
straight out of an `np.memmap` — no codec work, no per-image files, and
the host-crop RandomResizedCrop protocol keeps sampling boxes against
the ORIGINAL image dims, so the crop distribution stays
torchvision-exact (the same guarantee the direct JPEG path gives).

Layout under `cache_dir`:
    data.bin        — concatenated H*W*3 uint8 blobs (original geometry)
    canvas_{S}.bin  — (N, S, S, 3) uint8 fixed-stride canvases
                      (shortest-side resize + center crop at S), so the
                      canvas/on-device-crop input mode (`host_rrc=False`)
                      is a pure mmap row read — zero host codec AND
                      resize work per epoch
    index.npz       — offsets (N+1,) int64, dims (N,2) int32 [h,w],
                      labels (N,) int32, num_classes
    .complete       — stamp JSON {n, canvas_sizes, root, fingerprint}

Safety properties:
- builds take an exclusive fcntl lock (same pattern as the native
  loader's cross-process build lock) and write per-pid temp names, so
  concurrent processes sharing a cache_dir cannot interleave writes;
- the stamp records the SOURCE identity (root path + a fingerprint of
  the (path, label, file-size) listing); reuse verifies both, so a cache
  from a different source, one whose source gained/lost images or
  classes, or files re-encoded in place under identical names (size
  drift) raises instead of silently serving the wrong pixels. (If the
  source directory is gone the self-contained cache is trusted as-is.)
  A same-size in-place pixel edit is the one drift this cannot see —
  delete the cache_dir to force a rebuild;
- a cache built at one canvas size grows canvases for new sizes on
  demand from data.bin (no re-decode), so changing image_size never
  silently drops the mmap fast path.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Optional, Union

import numpy as np

from moco_tpu_torch.utils import retry

__all__ = ["PackedRGBCacheDataset", "build_rgb_cache"]


def _fingerprint(samples, legacy: bool = False) -> str:
    """Identity of the source listing. v2 folds each file's SIZE into the
    per-sample hash so files re-encoded in place under identical names
    (e.g. a synthetic folder regenerated with new constants) are caught
    as drift, not served stale. `legacy=True` reproduces the pre-size
    format so caches stamped before v2 still verify instead of being
    invalidated wholesale."""
    h = hashlib.sha256()
    for path, label in samples:
        if legacy:
            h.update(f"{os.path.basename(path)}\0{label}\n".encode())
        else:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1
            h.update(f"{os.path.basename(path)}\0{label}\0{size}\n".encode())
    prefix = "" if legacy else "v2:"
    return f"{prefix}{len(samples)}:{h.hexdigest()[:16]}"


def _read_stamp(cache_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(cache_dir, ".complete")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _canvas(arr: np.ndarray, size: int) -> np.ndarray:
    """Shortest-side BILINEAR resize + square center crop — the same
    canvas ImageFolderDataset.load produces from the decoded image."""
    from PIL import Image

    h, w, _ = arr.shape
    s = size / min(w, h)
    im = Image.fromarray(np.ascontiguousarray(arr)).resize(
        (max(size, round(w * s)), max(size, round(h * s))),
        resample=Image.BILINEAR,
    )
    out = np.asarray(im, np.uint8)
    h, w, _ = out.shape
    y0, x0 = (h - size) // 2, (w - size) // 2
    return out[y0 : y0 + size, x0 : x0 + size]


def build_rgb_cache(
    source_or_factory: Union[object, Callable[[], object]],
    cache_dir: str,
    num_workers: int = 8,
    canvas_size: int = 256,
    root: Optional[str] = None,
) -> str:
    """Decode every image of a source dataset (anything with `.samples`
    [(path, label), ...]) at ORIGINAL size into the packed-file layout,
    plus a fixed-stride canvas file at `canvas_size`.

    `source_or_factory` may be a zero-arg callable; on reuse it is still
    invoked (a directory listing) to verify the stamp's fingerprint, but
    no pixels are re-decoded — and if construction fails (source
    directory since removed) the self-contained cache is trusted as-is.
    `root` is the source's directory, recorded in the stamp on build and
    checked on reuse. A stale cache — different root, or a listing whose
    fingerprint drifted (images/classes added or removed) — raises
    instead of silently serving wrong pixels. A complete cache missing
    `canvas_{canvas_size}.bin` grows it from data.bin without
    re-decoding. Returns `cache_dir`."""
    stamp = _read_stamp(cache_dir)
    root_real = os.path.realpath(root) if root else None
    if stamp is not None:
        # mismatch only matters when the REQUESTED root actually exists:
        # with the source gone, split detection upstream degrades to a
        # different root string, and the self-contained cache must still
        # be usable
        if (
            root_real
            and stamp.get("root")
            and stamp["root"] != root_real
            and os.path.isdir(root_real)
        ):
            raise ValueError(
                f"RGB cache at {cache_dir} was built from {stamp['root']!r}, "
                f"not {root_real!r} — point --cache-dir elsewhere or delete it"
            )
        if stamp.get("fingerprint"):
            try:
                source = (
                    source_or_factory() if callable(source_or_factory) else source_or_factory
                )
            except OSError:
                # source DIRECTORY gone: the cache is self-contained.
                # Anything else (e.g. "no images under root" — a directory
                # that exists but lost its images) must propagate: that IS
                # the drift the fingerprint check exists to catch.
                source = None
            legacy = not stamp["fingerprint"].startswith("v2:")
            if source is not None and _fingerprint(source.samples, legacy=legacy) != stamp["fingerprint"]:
                raise ValueError(
                    f"RGB cache at {cache_dir} is stale: the source listing under "
                    f"{stamp.get('root') or root_real!r} changed since the build "
                    "(images or classes added/removed) — delete the cache dir to rebuild"
                )
        if canvas_size in stamp.get("canvas_sizes", []):
            return cache_dir
        _with_build_lock(cache_dir, lambda: _grow_canvas(cache_dir, canvas_size))
        return cache_dir
    source = source_or_factory() if callable(source_or_factory) else source_or_factory
    _with_build_lock(
        cache_dir,
        lambda: _build(source, cache_dir, num_workers, canvas_size, root_real),
    )
    return cache_dir


def _with_build_lock(cache_dir: str, fn) -> None:
    """Exclusive fcntl lock + post-acquire re-check wrapper (the native
    loader's build-lock pattern): only one process builds; the rest wait
    and find the finished artifacts."""
    import fcntl

    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, ".build.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            fn()
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _build(source, cache_dir, num_workers, canvas_size, root_real) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    if _read_stamp(cache_dir) is not None:  # another process built it
        _grow_canvas(cache_dir, canvas_size)
        return
    samples = source.samples
    n = len(samples)

    dead_slots = [0]  # undecodable sources, recorded in the stamp

    def decode(i):
        """Decode + canvas-resize in the worker (the consumer thread only
        writes), returning ready-to-write bytes. File reads retry;
        genuinely undecodable sources become counted dead slots."""
        path, label = samples[i]
        try:
            def _read():
                with Image.open(path) as im:
                    return np.asarray(im.convert("RGB"), np.uint8)

            arr = retry.retry_call(_read, site="data.cache_build")
        except Exception:
            dead_slots[0] += 1  # dead slot, mirrors loaders — but COUNTED
            arr = np.zeros((1, 1, 3), np.uint8)
        return arr.tobytes(), arr.shape[:2], _canvas(arr, canvas_size).tobytes(), int(label)

    offsets = np.zeros(n + 1, np.int64)
    dims = np.zeros((n, 2), np.int32)
    labels = np.zeros(n, np.int32)
    pid = os.getpid()  # per-pid temps: no interleaved writes even unlocked
    data_tmp = os.path.join(cache_dir, f"data.bin.tmp.{pid}")
    canvas_tmp = os.path.join(cache_dir, f"canvas_{canvas_size}.bin.tmp.{pid}")
    workers = max(num_workers, 1)
    with open(data_tmp, "wb") as f, open(canvas_tmp, "wb") as cf, ThreadPoolExecutor(
        max_workers=workers
    ) as pool:
        # bounded submission window (2x workers): plain pool.map would
        # enqueue all n decodes up front and the finished full-geometry
        # arrays would accumulate far ahead of the serial writer —
        # unbounded memory on an ImageNet-scale build
        from collections import deque

        window: deque = deque()
        i = 0
        for j in range(min(2 * workers, n)):
            window.append(pool.submit(decode, j))
        next_submit = len(window)
        while window:
            raw, hw, canvas_bytes, label = window.popleft().result()
            if next_submit < n:
                window.append(pool.submit(decode, next_submit))
                next_submit += 1
            f.write(raw)
            cf.write(canvas_bytes)
            offsets[i + 1] = offsets[i] + len(raw)
            dims[i] = hw
            labels[i] = label
            i += 1
    np.savez(
        os.path.join(cache_dir, "index.npz"),
        offsets=offsets,
        dims=dims,
        labels=labels,
        num_classes=np.int32(getattr(source, "num_classes", int(labels.max()) + 1)),
    )
    os.replace(data_tmp, os.path.join(cache_dir, "data.bin"))
    os.replace(canvas_tmp, os.path.join(cache_dir, f"canvas_{canvas_size}.bin"))
    if dead_slots[0]:
        import warnings

        warnings.warn(
            f"RGB cache build: {dead_slots[0]}/{n} images failed to decode "
            "(zero-filled dead slots, recorded in the stamp)"
        )
    with open(os.path.join(cache_dir, ".complete"), "w") as f:
        json.dump(
            {
                "n": n,
                "canvas_sizes": [canvas_size],
                "root": root_real,
                "fingerprint": _fingerprint(samples),
                "dead_slots": dead_slots[0],
            },
            f,
        )


def _grow_canvas(cache_dir: str, canvas_size: int) -> None:
    """Add canvas_{S}.bin for a new size to a complete cache, resizing
    from the stored full-geometry pixels (no re-decode)."""
    stamp = _read_stamp(cache_dir)
    if stamp is None or canvas_size in stamp.get("canvas_sizes", []):
        return
    ds = PackedRGBCacheDataset(cache_dir, decode_size=canvas_size, use_native=False)
    pid = os.getpid()
    canvas_tmp = os.path.join(cache_dir, f"canvas_{canvas_size}.bin.tmp.{pid}")
    with open(canvas_tmp, "wb") as cf:
        for i in range(len(ds)):
            cf.write(_canvas(ds._image(i), canvas_size).tobytes())
    os.replace(canvas_tmp, os.path.join(cache_dir, f"canvas_{canvas_size}.bin"))
    stamp["canvas_sizes"] = sorted(stamp.get("canvas_sizes", []) + [canvas_size])
    with open(os.path.join(cache_dir, ".complete"), "w") as f:
        json.dump(stamp, f)


class PackedRGBCacheDataset:
    """Same duck-typed surface as ImageFolderDataset (load / dims /
    load_crop_batch / num_classes), reading from the packed cache.

    `use_native=None` (auto) routes the host-crop protocol through the
    C++ raw loader when the native library is available — the crop+
    resize then runs in the C++ worker pool with no codec, GIL, or
    per-image Python cost. `use_native=False` keeps the PIL resampler
    (bit-exact with the direct JPEG path; the native resampler agrees
    only to the documented mean-abs-diff tolerance)."""

    def __init__(
        self,
        cache_dir: str,
        decode_size: int = 256,
        use_native: Optional[bool] = None,
        num_workers: int = 8,
    ):
        if not os.path.exists(os.path.join(cache_dir, ".complete")):
            raise FileNotFoundError(f"no complete RGB cache under {cache_dir}")
        # transient-store retries on the open path; once the memmap is
        # established, page reads are the kernel's problem
        idx = retry.retry_call(
            np.load, os.path.join(cache_dir, "index.npz"), site="data.cache_open"
        )
        self.offsets = idx["offsets"]
        self._dims = idx["dims"]
        self.labels = idx["labels"]
        self.num_classes = int(idx["num_classes"])
        self.decode_size = decode_size
        self._num_workers = max(num_workers, 1)
        # dead slots stamped at build time: a constant decode_failures
        # count the pipeline surfaces like the live loaders' counters
        stamp = _read_stamp(cache_dir) or {}
        self.decode_failures = int(stamp.get("dead_slots", 0))
        self._data = retry.retry_call(
            np.memmap,
            os.path.join(cache_dir, "data.bin"),
            dtype=np.uint8,
            mode="r",
            site="data.cache_open",
        )
        self._native = None
        if use_native is not False:
            try:
                from moco_tpu_torch.data.native_loader import NativeRawBatchLoader

                self._native = NativeRawBatchLoader(
                    os.path.join(cache_dir, "data.bin"),
                    self.offsets,
                    self._dims,
                    canvas=decode_size,
                    threads=max(num_workers, 1),
                )
            except Exception:
                if use_native:  # explicit request must not degrade silently
                    raise
                self._native = None
        n = len(self.labels)
        canvas_path = os.path.join(cache_dir, f"canvas_{decode_size}.bin")
        self._canvases = (
            np.memmap(canvas_path, dtype=np.uint8, mode="r").reshape(
                n, decode_size, decode_size, 3
            )
            if os.path.exists(canvas_path)
            else None
        )

    def __len__(self) -> int:
        return len(self.labels)

    def _image(self, index: int) -> np.ndarray:
        h, w = self._dims[index]
        start = self.offsets[index]
        return self._data[start : start + h * w * 3].reshape(h, w, 3)

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        """Shortest-side resize + square center-crop canvas, matching
        ImageFolderDataset.load (same BILINEAR semantics) minus the
        decode. At the cache's own canvas size this is a pure mmap row
        read — no resize either."""
        size = decode_size or self.decode_size
        if self._canvases is not None and size == self._canvases.shape[1]:
            return np.asarray(self._canvases[index]), int(self.labels[index])
        return _canvas(self._image(index), size), int(self.labels[index])

    def dims(self, indices) -> np.ndarray:
        return self._dims[np.asarray(indices, np.int64)]

    def load_crop_batch(
        self, indices, boxes: np.ndarray, out_size: int, pool=None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host-crop protocol against the cached full-geometry pixels:
        same pixels as the JPEG path's decode+crop, at memmap-read cost.
        Routed through the C++ raw loader when available (thread-pool
        crop+resize, no GIL); PIL otherwise."""
        from PIL import Image

        if self._native is not None:
            out = self._native.load_crops(indices, boxes, out_size)
            return out, np.asarray(self.labels[np.asarray(indices, np.int64)], np.int32)

        idx = np.asarray(indices, np.int64)
        boxes = np.asarray(boxes, np.int64)
        bs, n_crops = boxes.shape[0], boxes.shape[1]
        out = np.zeros((bs, n_crops, out_size, out_size, 3), np.uint8)
        labels = np.empty(bs, np.int32)

        def one(row):
            i = int(idx[row])
            labels[row] = self.labels[i]
            arr = self._image(i)
            h, w, _ = arr.shape
            for c in range(n_crops):
                y0, x0, ch, cw = boxes[row, c]
                y0 = int(np.clip(y0, 0, h - 1))
                x0 = int(np.clip(x0, 0, w - 1))
                ch = int(np.clip(ch, 1, h - y0))
                cw = int(np.clip(cw, 1, w - x0))
                crop = Image.fromarray(
                    np.ascontiguousarray(arr[y0 : y0 + ch, x0 : x0 + cw])
                ).resize((out_size, out_size), resample=Image.BILINEAR)
                out[row, c] = np.asarray(crop, np.uint8)

        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            if not hasattr(self, "_crop_pool"):
                self._crop_pool = ThreadPoolExecutor(max_workers=self._num_workers)
            pool = self._crop_pool
        list(pool.map(one, range(bs)))
        return out, labels
