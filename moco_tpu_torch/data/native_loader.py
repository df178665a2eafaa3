"""ctypes binding of the native (C++) image loader (the port's copy of
moco_tpu/data/native_loader.py).

`native/loader.cc` runs an in-process C++ thread pool: file read ->
libjpeg/libpng decode -> antialiased bilinear shortest-side resize ->
center crop into a caller-owned contiguous uint8 batch, all outside the
GIL. `NativeImageFolderDataset` has `ImageFolderDataset`'s surface plus a
batched `load_batch`; `NativeRawBatchLoader` reads the packed RGB cache
(`data/cache.py`). Samples the C++ decoders reject (webp/bmp/ppm, CMYK
JPEGs) are retried through PIL with the same geometry.

The port builds its own library: `g++ ... native/loader.cc -ljpeg -lpng`
into `build/native/libmoco_loader-<hash of the source>.so` at the
repository root, on first use, under an fcntl lock (concurrent processes,
pytest-xdist), written under a temporary name and renamed into place. It
never runs `make -C native` nor loads `native/libmoco_loader.so`, the JAX
package's build, which that package deletes when its ABI mismatches.
Where the compiler, libjpeg or libpng is missing the build fails and
`native_available()` is False; callers then take the PIL path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from moco_tpu_torch.utils import retry

REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = REPO / "native" / "loader.cc"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-pthread", "-shared")
LIBS = ("-ljpeg", "-lpng")
ABI_VERSION = 4
_load_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the loader builds to; the hash pins the source, so an edited
    `loader.cc` is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmoco_loader-{digest}.so"


def _build(out: Path) -> None:
    """Compile `out` unless it exists, holding an exclusive fcntl lock so
    one process builds and none loads a half-written library."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if out.exists():
                return
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, out)
            finally:
                if tmp.exists():
                    tmp.unlink()
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _declare_bindings(lib: ctypes.CDLL) -> None:
    """Symbol declarations for the CURRENT ABI — only called after the
    version check passes (a stale .so may lack the newer symbols, and a
    failed dlsym here would otherwise mask the rebuild path)."""
    lib.mtl_create.restype = ctypes.c_void_p
    lib.mtl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mtl_load_batch.restype = ctypes.c_int
    lib.mtl_load_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mtl_load_batch_crops.restype = ctypes.c_int
    lib.mtl_load_batch_crops.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mtl_get_dims.restype = ctypes.c_int
    lib.mtl_get_dims.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.mtl_create_raw.restype = ctypes.c_void_p
    lib.mtl_create_raw.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mtl_destroy.argtypes = [ctypes.c_void_p]


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _load_lock:
        if _lib is None:
            path = library_path()
            _build(path)
            lib = ctypes.CDLL(str(path))
            # the version first: a library of another ABI may lack the
            # symbols _declare_bindings names
            lib.mtl_version.restype = ctypes.c_int
            if lib.mtl_version() != ABI_VERSION:
                raise RuntimeError(f"{path}: native loader ABI {lib.mtl_version()}, "
                                   f"want {ABI_VERSION}")
            _declare_bindings(lib)
            _lib = lib
        return _lib


def native_available() -> bool:
    try:
        _load_lib()
        return True
    except Exception:
        return False


class NativeBatchLoader:
    """Thin handle over the C++ loader for a fixed list of image paths."""

    def __init__(self, paths: list[str], canvas: int, threads: int = 8):
        self._lib = _load_lib()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = self._lib.mtl_create(arr, len(paths), canvas, threads)
        if not self._handle:
            raise RuntimeError("mtl_create failed")
        self.paths = paths
        self.canvas = canvas
        self.num_paths = len(paths)
        # Hard (native + PIL both failed) decode failures, cumulative.
        # Zero-filled slots are silent black images to the trainer —
        # this counter is how the pipeline makes them visible
        # (`decode_failures` in metrics.jsonl).
        self.decode_failures = 0

    def _pil_fallback(self, path: str) -> Optional[np.ndarray]:
        """Decode one image through PIL with the same geometry (the
        ImageFolderDataset.load recipe) for formats the C++ side lacks.
        The file read retries (transient NFS/GCS errors must not count
        as a decode failure); a genuinely undecodable image returns
        None."""
        try:
            from PIL import Image

            size = self.canvas

            def _decode():
                with Image.open(path) as im:
                    im = im.convert("RGB")
                    w, h = im.size
                    s = size / min(w, h)
                    im = im.resize(
                        (max(size, round(w * s)), max(size, round(h * s))),
                        resample=Image.BILINEAR,
                    )
                    return np.asarray(im, np.uint8)

            arr = retry.retry_call(_decode, site="data.native_pil")
            h, w, _ = arr.shape
            y0, x0 = (h - size) // 2, (w - size) // 2
            return arr[y0 : y0 + size, x0 : x0 + size]
        except Exception:
            return None

    def load_batch(self, indices: np.ndarray) -> np.ndarray:
        """(bs, canvas, canvas, 3) uint8. Slots the native decoders fail on
        are retried via PIL; only doubly-failed slots stay zero."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.canvas, self.canvas, 3), np.uint8)
        status = np.empty(len(idx), np.uint8)
        errors = self._lib.mtl_load_batch(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if errors:
            hard_failures = 0
            for slot in np.nonzero(status == 0)[0]:
                i = int(idx[slot])
                img = self._pil_fallback(self.paths[i]) if 0 <= i < self.num_paths else None
                if img is not None:
                    out[slot] = img
                else:
                    hard_failures += 1
            if hard_failures:
                import warnings

                self.decode_failures += hard_failures
                warnings.warn(
                    f"native loader: {hard_failures}/{len(idx)} images failed to decode"
                )
        return out

    def get_dims(self, indices: np.ndarray) -> np.ndarray:
        """(bs, 2) original (h, w) per sample — header parse only, cached
        in C++. Slots that fail get (0, 0); callers treat those as
        undecodable (their crops degrade to the PIL fallback)."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        dims = np.empty((len(idx), 2), np.int32)
        status = np.empty(len(idx), np.uint8)
        self._lib.mtl_get_dims(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return dims

    def _pil_fallback_crops(
        self, path: str, boxes: np.ndarray, out_size: int
    ) -> Optional[np.ndarray]:
        """(n_crops, out, out, 3) via PIL resized-crop — same geometry."""
        try:
            from PIL import Image

            with Image.open(path) as im:
                im = im.convert("RGB")
                w, h = im.size
                outs = []
                for y0, x0, ch, cw in np.asarray(boxes, np.int64):
                    y0 = int(np.clip(y0, 0, h - 1))
                    x0 = int(np.clip(x0, 0, w - 1))
                    ch = int(np.clip(ch, 1, h - y0))
                    cw = int(np.clip(cw, 1, w - x0))
                    crop = im.crop((x0, y0, x0 + cw, y0 + ch)).resize(
                        (out_size, out_size), resample=Image.BILINEAR
                    )
                    outs.append(np.asarray(crop, np.uint8))
                return np.stack(outs)
        except Exception:
            return None

    def load_crops(
        self, indices: np.ndarray, boxes: np.ndarray, out_size: int
    ) -> np.ndarray:
        """(bs, n_crops, out, out, 3) uint8: decode each sample ONCE, then
        antialias-resize each of its boxes (y0, x0, ch, cw in original
        coords). Failed slots retry through PIL; doubly-failed stay zero."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        boxes = np.ascontiguousarray(boxes, dtype=np.int32)
        bs, n_crops = boxes.shape[0], boxes.shape[1]
        assert bs == len(idx) and boxes.shape[2] == 4
        out = np.empty((bs, n_crops, out_size, out_size, 3), np.uint8)
        status = np.empty(bs, np.uint8)
        errors = self._lib.mtl_load_batch_crops(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            bs,
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_crops,
            out_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if errors:
            hard_failures = 0
            for slot in np.nonzero(status == 0)[0]:
                i = int(idx[slot])
                img = (
                    self._pil_fallback_crops(self.paths[i], boxes[slot], out_size)
                    if 0 <= i < self.num_paths
                    else None
                )
                if img is not None:
                    out[slot] = img
                else:
                    hard_failures += 1
            if hard_failures:
                import warnings

                self.decode_failures += hard_failures
                warnings.warn(
                    f"native loader: {hard_failures}/{bs} images failed to decode"
                )
        return out

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.mtl_destroy(handle)
            self._handle = None


class NativeRawBatchLoader:
    """C++ loader over a packed-RGB cache file (data/cache.py):
    the codec stage disappears (samples are raw blobs mmap'd in C++) and
    the antialiased crop+resize runs in the C++ worker pool instead of
    PIL — no GIL, no per-image Python. Same load_crops/load_batch/
    get_dims surface as NativeBatchLoader; raw reads cannot soft-fail,
    so there is no PIL fallback (dead build slots stay zero, like the
    path backend's doubly-failed slots)."""

    def __init__(
        self,
        data_path: str,
        offsets: np.ndarray,
        dims: np.ndarray,
        canvas: int,
        threads: int = 8,
    ):
        self._lib = _load_lib()
        offsets = np.ascontiguousarray(offsets, np.int64)
        dims = np.ascontiguousarray(dims, np.int32)
        n = len(dims)
        assert len(offsets) == n + 1
        # mtl_create_raw copies both arrays into C++ vectors at create
        self._handle = self._lib.mtl_create_raw(
            data_path.encode(),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            canvas,
            threads,
        )
        if not self._handle:
            raise RuntimeError(f"mtl_create_raw failed for {data_path}")
        self.canvas = canvas
        self._dims = dims  # (n, 2) int32, answers get_dims without C++

    def get_dims(self, indices: np.ndarray) -> np.ndarray:
        return self._dims[np.asarray(indices, np.int64)]

    def load_batch(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.canvas, self.canvas, 3), np.uint8)
        status = np.empty(len(idx), np.uint8)
        errors = self._lib.mtl_load_batch(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        self._check(errors, status, idx)
        return out

    def load_crops(
        self, indices: np.ndarray, boxes: np.ndarray, out_size: int
    ) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        boxes = np.ascontiguousarray(boxes, dtype=np.int32)
        bs, n_crops = boxes.shape[0], boxes.shape[1]
        assert bs == len(idx) and boxes.shape[2] == 4
        out = np.empty((bs, n_crops, out_size, out_size, 3), np.uint8)
        status = np.empty(bs, np.uint8)
        errors = self._lib.mtl_load_batch_crops(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            bs,
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_crops,
            out_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        self._check(errors, status, idx)
        return out

    def _check(self, errors: int, status: np.ndarray, idx: np.ndarray) -> None:
        """Raw blob reads cannot soft-fail like codec decodes can — a
        failed slot means the cache index is inconsistent with data.bin.
        Training on silently zero-filled slots would be much worse than
        stopping, so raise."""
        if errors:
            bad = idx[np.nonzero(status == 0)[0]].tolist()
            raise RuntimeError(
                f"raw cache read failed for indices {bad[:8]}{'...' if len(bad) > 8 else ''} "
                "— the packed cache is corrupt or its index mismatches data.bin; "
                "delete the cache dir to rebuild"
            )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.mtl_destroy(handle)
            self._handle = None


class NativeImageFolderDataset:
    """`root/class_x/img.jpg` layout (torchvision ImageFolder semantics,
    like `ImageFolderDataset`) backed by the C++ decode pool."""

    def __init__(self, root: str, decode_size: int = 256, threads: int = 8):
        from moco_tpu_torch.data.datasets import ImageFolderDataset

        # reuse the Python class for directory walking / label assignment
        py = ImageFolderDataset(root, decode_size=decode_size)
        self.samples = py.samples
        self.class_to_idx = py.class_to_idx
        self.num_classes = py.num_classes
        self.decode_size = decode_size
        self._labels = np.asarray([l for _, l in py.samples], np.int32)
        self._loader = NativeBatchLoader(
            [p for p, _ in py.samples], canvas=decode_size, threads=threads
        )

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def decode_failures(self) -> int:
        """Cumulative hard decode failures (native + PIL both failed);
        surfaced by the pipeline as a `decode_failures` metric."""
        return self._loader.decode_failures

    def load(self, index: int, decode_size: Optional[int] = None) -> tuple[np.ndarray, int]:
        if decode_size is not None and decode_size != self.decode_size:
            raise ValueError(
                f"native loader decodes at the fixed canvas {self.decode_size}; "
                f"got decode_size={decode_size} (use ImageFolderDataset for variable sizes)"
            )
        img = self._loader.load_batch(np.asarray([index]))[0]
        return img, int(self._labels[index])

    def load_batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self._loader.load_batch(indices), self._labels[np.asarray(indices)]

    # -- host-crop protocol (pipeline samples torchvision-exact RRC boxes
    # against original geometry; decode once, crop N times) --------------
    def dims(self, indices: np.ndarray) -> np.ndarray:
        return self._loader.get_dims(indices)

    def load_crop_batch(
        self, indices: np.ndarray, boxes: np.ndarray, out_size: int, pool=None
    ) -> tuple[np.ndarray, np.ndarray]:
        # `pool` accepted for PIL-path signature compatibility; the C++
        # loader owns its own thread pool.
        crops = self._loader.load_crops(indices, boxes, out_size)
        return crops, self._labels[np.asarray(indices)]
