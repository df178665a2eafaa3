"""Parity of the port's input layer (moco_tpu_torch.data) with the JAX
package's on the CPU: the seeded datasets, the RandomResizedCrop draws and
boxes, ImageFolder and CIFAR-10 on tiny files written to a temp dir, the
native C++ loader, the packed RGB cache (each package reading the other's),
the host-crop batch and the epoch order. Every comparison is byte-equal.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from moco_tpu.data import cache as jax_cache
from moco_tpu.data import datasets as jax_ds
from moco_tpu.data import native_loader as jax_native
from moco_tpu.data.pipeline import TwoCropPipeline as JaxTwoCropPipeline
from moco_tpu.parallel import create_mesh
from moco_tpu.utils.config import DataConfig as JaxDataConfig
from moco_tpu_torch.data import cache, datasets, native_loader
from moco_tpu_torch.data.augment import two_crop_augment
from moco_tpu_torch.data.pipeline import TwoCropPipeline
from moco_tpu_torch.train import main as train_main
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import faults, retry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = [(40, 56), (64, 48), (37, 53), (80, 80), (33, 90)]  # (h, w)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """An ImageFolder of JPEG and PNG images of varied geometry, 3 classes
    x 5 images, one grayscale."""
    root = tmp_path_factory.mktemp("torch_imgs")
    rng = np.random.default_rng(0)
    for c in ("cat", "ant", "bee"):
        (root / c).mkdir()
        for i, (h, w) in enumerate(GEOMETRIES):
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            im = Image.fromarray(arr)
            if c == "bee" and i == 0:
                im = im.convert("L")
            if i % 2:
                im.save(root / c / f"{i}.png")
            else:
                im.save(root / c / f"{i}.jpg", quality=90)
    (root / "cat" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    """The cifar-10-batches-py layout: five train batches and a test batch
    of 4 seeded images each."""
    root = tmp_path_factory.mktemp("cifar") / "cifar-10-batches-py"
    root.mkdir()
    rng = np.random.default_rng(1)
    for i, name in enumerate([f"data_batch_{j}" for j in range(1, 6)] + ["test_batch"]):
        d = {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
             b"labels": [int(x) for x in rng.integers(0, 10, 4)]}
        with open(root / name, "wb") as f:
            pickle.dump(d, f)
    return str(root.parent)


# ------------------------------------------------------------- synthetic


@pytest.mark.parametrize("name", ["SyntheticDataset", "LearnableSyntheticDataset",
                                  "HardSyntheticDataset", "HardTemplateDataset",
                                  "LeakControlSyntheticDataset"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_datasets_match_jax_byte_for_byte(name, train):
    kw = {} if name == "SyntheticDataset" else {"train": train}
    if name in ("HardSyntheticDataset", "HardTemplateDataset"):
        kw.update(num_examples=64, num_classes=8)
    ours = getattr(datasets, name)(image_size=32, **kw)
    theirs = getattr(jax_ds, name)(image_size=32, **kw)
    assert len(ours) == len(theirs)
    for i in (0, 1, 7, 13):
        for size in (None, 48):
            (a, la), (b, lb) = ours.load(i, size), theirs.load(i, size)
            assert la == lb and a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["synthetic", "synthetic_learnable", "synthetic_hard",
                                  "synthetic_learnable32", "synthetic_leak_control"])
def test_build_dataset_names_the_same_sources(name):
    ours = datasets.build_dataset(name, None, 32, train=False)
    theirs = jax_ds.build_dataset(name, None, 32, train=False)
    assert type(ours).__name__ == type(theirs).__name__ and len(ours) == len(theirs)
    np.testing.assert_array_equal(ours.load(5)[0], theirs.load(5)[0])
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.build_dataset("imagenet21k", None, 32)


# ------------------------------------------------------------------ crops


def test_rrc_uniforms_and_boxes_match_jax():
    seed, epoch, step, n = 3, 2, 7, 24
    ours = datasets.draw_rrc_uniforms(np.random.default_rng((seed, epoch, step)), n)
    theirs = jax_ds.draw_rrc_uniforms(np.random.default_rng((seed, epoch, step)), n)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])
    dims = np.random.default_rng(0).integers(1, 400, (n, 2)).astype(np.int32)
    dims[:3] = [[10, 400], [400, 10], [0, 0]]  # ratio-clamped fallbacks, a failed read
    for scale in ((0.2, 1.0), (0.08, 1.0)):
        np.testing.assert_array_equal(datasets.rrc_boxes_from_uniforms(ours, dims, scale),
                                      jax_ds.rrc_boxes_from_uniforms(theirs, dims, scale))
    np.testing.assert_array_equal(
        datasets.sample_rrc_boxes(np.random.default_rng(9), dims),
        jax_ds.sample_rrc_boxes(np.random.default_rng(9), dims))


# ------------------------------------------------------- files on disk


def test_image_folder_matches_jax(folder):
    ours = datasets.ImageFolderDataset(folder, decode_size=24)
    theirs = jax_ds.ImageFolderDataset(folder, decode_size=24)
    assert ours.samples == theirs.samples and ours.class_to_idx == theirs.class_to_idx
    for i in range(len(theirs)):
        for size in (None, 32):
            (a, la), (b, lb) = ours.load(i, size), theirs.load(i, size)
            assert la == lb
            np.testing.assert_array_equal(a, b)
    idx = np.arange(len(theirs))[::-1]
    np.testing.assert_array_equal(ours.dims(idx), theirs.dims(idx))
    boxes = datasets.sample_rrc_boxes(np.random.default_rng(4), np.repeat(theirs.dims(idx), 2, 0))
    boxes = boxes.reshape(len(idx), 2, 4)
    (a, la), (b, lb) = ours.load_crop_batch(idx, boxes, 16), theirs.load_crop_batch(idx, boxes, 16)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert ours.decode_failures == theirs.decode_failures == 0


def test_cifar10_matches_jax(cifar_dir):
    for train in (True, False):
        ours, theirs = datasets.Cifar10Dataset(cifar_dir, train), jax_ds.Cifar10Dataset(cifar_dir, train)
        assert len(ours) == len(theirs) == (20 if train else 4)
        np.testing.assert_array_equal(ours.images, theirs.images)
        np.testing.assert_array_equal(ours.labels, theirs.labels)
        assert ours.load(3)[1] == theirs.load(3)[1]
    with pytest.raises(FileNotFoundError, match="no network"):
        datasets.Cifar10Dataset(os.path.dirname(cifar_dir) + "/nowhere")
    with pytest.raises(ValueError, match="cifar10 needs data_dir"):
        datasets.build_dataset("cifar10", None, 32)


def test_host_reads_retry_an_injected_io_error(monkeypatch):
    """`io@site=data.read` fails the step's first read: the retry layer
    reads again, counts it, and the batch is the one an unfaulted read
    gives."""
    monkeypatch.setenv("MOCO_IO_RETRY_BASE", "0")
    cfg = pc.DataConfig(dataset="synthetic", image_size=32, global_batch=4)
    with TwoCropPipeline(cfg, dataset=datasets.SyntheticDataset(8, 32), device="cpu") as pipe:
        want = pipe.batch(0, 1)
        before = retry.snapshot().get("data.read", 0)
        faults.install("io@site=data.read:at=1")
        try:
            got = pipe.batch(0, 1)
        finally:
            faults.clear()
        assert retry.snapshot().get("data.read", 0) == before + 1
        assert all(torch.equal(got[k], want[k]) for k in want)
        faults.install("io@site=data.read:at=1:times=9")
        try:
            with pytest.raises(OSError, match="injected fault"):
                pipe.batch(0, 1)
        finally:
            faults.clear()
        assert torch.equal(pipe.batch(0, 1)["im_q"], want["im_q"])  # the slot came back
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.install("melt@step=1")
    with pytest.raises(ValueError, match="needs seconds"):
        faults.install("delay@site=input.h2d")


def test_cifar_smoke_preset_builds_and_trains_from_the_cli(cifar_dir, monkeypatch):
    """The cifar_smoke preset names cifar10: its pipeline builds from a
    data dir, and the CLI's data and ring flags reach train()."""
    cfg = dataclasses.replace(pc.PRESETS["cifar_smoke"].data, data_dir=cifar_dir, global_batch=8)
    with TwoCropPipeline(cfg, device="cpu") as pipe:
        assert type(pipe.dataset).__name__ == "Cifar10Dataset" and pipe.steps_per_epoch == 2
        b = pipe.batch(0, 1)
        assert b["im_q"].shape == (8, 32, 32, 3) and torch.isfinite(b["im_k"]).all()
    seen = {}
    from moco_tpu_torch import train as train_module

    monkeypatch.setattr(train_module, "train", lambda config, **kw: seen.update(config=config, **kw))
    assert train_main(["--preset", "cifar_smoke", "--data-dir", cifar_dir, "--cache-dir", "/c",
                       "--workers", "3", "--no-device-prefetch", "--prefetch-depth", "4",
                       "--steps", "1", "--device", "cpu"]) == 0
    c = seen["config"]
    assert (c.data.dataset, c.data.data_dir, c.data.cache_dir, c.data.num_workers) == (
        "cifar10", cifar_dir, "/c", 3)
    assert c.device_prefetch is False and c.prefetch_depth == 4
    assert pc.PRESETS["cifar_smoke"].device_prefetch is True
    assert pc.PRESETS["cifar_smoke"].prefetch_depth == 2
    with pytest.raises(TypeError):
        pc.TrainConfig(prefetch_donate=True)
    with pytest.raises(ValueError, match="prefetch_depth"):
        pc.TrainConfig(prefetch_depth=0)


# ---------------------------------------------------------- native loader


@pytest.fixture(scope="module")
def native_pair():
    """The port's build of native/loader.cc and the JAX package's."""
    if not (native_loader.native_available() and jax_native.native_available()):
        pytest.skip("the native loader does not build here (g++, libjpeg or libpng missing)")
    assert native_loader.library_path().parent.name == "native"
    assert native_loader.library_path().parent.parent.name == "build"
    return native_loader, jax_native


def test_native_loader_matches_jax(folder, native_pair):
    ours_mod, theirs_mod = native_pair
    ours = ours_mod.NativeImageFolderDataset(folder, decode_size=24, threads=2)
    theirs = theirs_mod.NativeImageFolderDataset(folder, decode_size=24, threads=2)
    idx = np.array([3, 0, 14, 7, 7, 11])
    (a, la), (b, lb) = ours.load_batch(idx), theirs.load_batch(idx)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ours.load(2)[0], theirs.load(2)[0])
    dims = ours.dims(idx)
    np.testing.assert_array_equal(dims, theirs.dims(idx))
    np.testing.assert_array_equal(dims, datasets.ImageFolderDataset(folder).dims(idx))
    boxes = datasets.sample_rrc_boxes(np.random.default_rng(2), np.repeat(dims, 2, 0))
    boxes = boxes.reshape(len(idx), 2, 4)
    (a, _), (b, _) = ours.load_crop_batch(idx, boxes, 16), theirs.load_crop_batch(idx, boxes, 16)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fixed canvas"):
        ours.load(0, decode_size=32)


def test_native_loader_retries_unsupported_formats_through_pil(tmp_path, native_pair, monkeypatch):
    """A BMP is no format of the C++ decoders: its slot comes from PIL, as
    in the JAX package, and only an unreadable file stays zero."""
    monkeypatch.setenv("MOCO_IO_RETRY_BASE", "0")
    ours_mod, theirs_mod = native_pair
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)).save(tmp_path / "a.bmp")
    (tmp_path / "b.jpg").write_bytes(b"not a jpeg")
    paths = [str(tmp_path / "a.bmp"), str(tmp_path / "b.jpg")]
    ours = ours_mod.NativeBatchLoader(paths, canvas=16, threads=2)
    theirs = theirs_mod.NativeBatchLoader(paths, canvas=16, threads=2)
    with pytest.warns(UserWarning, match="failed to decode"):
        a = ours.load_batch(np.array([0, 1]))
    with pytest.warns(UserWarning, match="failed to decode"):
        b = theirs.load_batch(np.array([0, 1]))
    np.testing.assert_array_equal(a, b)
    assert a[0].std() > 0 and a[1].max() == 0 and ours.decode_failures == 1


def test_native_raw_backend_matches_jax(folder, tmp_path, native_pair):
    ours_mod, theirs_mod = native_pair
    cache.build_rgb_cache(datasets.ImageFolderDataset(folder), str(tmp_path), num_workers=2,
                          canvas_size=24, root=folder)
    idx = np.arange(15)[::-1].copy()
    loaders = []
    for mod in (ours_mod, theirs_mod):
        meta = np.load(tmp_path / "index.npz")
        loaders.append(mod.NativeRawBatchLoader(str(tmp_path / "data.bin"), meta["offsets"],
                                                meta["dims"], canvas=24, threads=2))
    np.testing.assert_array_equal(loaders[0].load_batch(idx), loaders[1].load_batch(idx))
    dims = loaders[0].get_dims(idx)
    boxes = datasets.sample_rrc_boxes(np.random.default_rng(8), np.repeat(dims, 2, 0))
    boxes = boxes.reshape(len(idx), 2, 4)
    np.testing.assert_array_equal(loaders[0].load_crops(idx, boxes, 16),
                                  loaders[1].load_crops(idx, boxes, 16))
    with pytest.raises(RuntimeError, match="raw cache read failed"):
        loaders[0].load_batch(np.array([0, 99]))


def test_native_build_never_touches_the_jax_library():
    """The port builds into build/native/ from native/loader.cc under its
    own lock, and names no `make` and no native/libmoco_loader.so."""
    src = open(native_loader.__file__).read()
    assert 'make", "-C' not in src and "native/libmoco_loader.so\"" not in src
    assert native_loader.library_path() == (
        native_loader.REPO / "build" / "native" / native_loader.library_path().name)
    assert native_loader.SOURCE == native_loader.REPO / "native" / "loader.cc"


def test_native_builds_in_concurrent_processes(tmp_path):
    """Four processes load the library at once into a fresh build dir:
    one compiles under the lock, every one loads the same file."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from moco_tpu_torch.data import native_loader as n\n"
        "n.BUILD_DIR = Path(sys.argv[1])\n"
        "print(n.native_available(), n.library_path())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {o.strip() for o, _ in outs}
    if lines == {f"False {native_loader.library_path().name}"}:
        pytest.skip("the native loader does not build here")
    assert len(lines) == 1 and lines.pop().startswith("True")
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == [
        native_loader.library_path().name]
    assert not [p for p in tmp_path.iterdir() if p.name.endswith(".tmp")]


# ------------------------------------------------------------ RGB cache


@pytest.mark.parametrize("made_by", ["port", "jax"])
def test_rgb_cache_reads_the_same_in_both_packages(folder, tmp_path, made_by):
    build = cache.build_rgb_cache if made_by == "port" else jax_cache.build_rgb_cache
    src = datasets.ImageFolderDataset if made_by == "port" else jax_ds.ImageFolderDataset
    build(lambda: src(folder, decode_size=24), str(tmp_path), num_workers=2, canvas_size=24,
          root=folder)
    ours = cache.PackedRGBCacheDataset(str(tmp_path), decode_size=24, use_native=False)
    theirs = jax_cache.PackedRGBCacheDataset(str(tmp_path), decode_size=24, use_native=False)
    assert len(ours) == len(theirs) == 15 and ours.num_classes == theirs.num_classes == 3
    for i in range(15):
        for size in (None, 20):
            (a, la), (b, lb) = ours.load(i, size), theirs.load(i, size)
            assert la == lb
            np.testing.assert_array_equal(a, b)
    idx = np.array([14, 2, 9, 0])
    np.testing.assert_array_equal(ours.dims(idx), theirs.dims(idx))
    boxes = datasets.sample_rrc_boxes(np.random.default_rng(6), np.repeat(ours.dims(idx), 2, 0))
    boxes = boxes.reshape(len(idx), 2, 4)
    (a, la), (b, lb) = ours.load_crop_batch(idx, boxes, 16), theirs.load_crop_batch(idx, boxes, 16)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    # the cache's crops are the decoded files' crops
    np.testing.assert_array_equal(a, datasets.ImageFolderDataset(folder).load_crop_batch(
        idx, boxes, 16)[0])
    # a canvas size grown by the other package
    other = jax_cache.build_rgb_cache if made_by == "port" else cache.build_rgb_cache
    other(lambda: src(folder, decode_size=20), str(tmp_path), canvas_size=20, root=folder)
    np.testing.assert_array_equal(cache.PackedRGBCacheDataset(str(tmp_path), 20, False).load(4)[0],
                                  jax_cache.PackedRGBCacheDataset(str(tmp_path), 20, False).load(4)[0])


def test_rgb_cache_refuses_a_stale_or_foreign_source(folder, tmp_path):
    import shutil

    src = tmp_path / "src"
    shutil.copytree(folder, src)
    out = str(tmp_path / "cache")
    cache.build_rgb_cache(lambda: datasets.ImageFolderDataset(str(src)), out, num_workers=1,
                          canvas_size=16, root=str(src))
    assert cache._read_stamp(out)["fingerprint"] == jax_cache._read_stamp(out)["fingerprint"]
    Image.fromarray(np.zeros((9, 9, 3), np.uint8)).save(src / "ant" / "new.png")
    for build, ds in ((cache.build_rgb_cache, datasets), (jax_cache.build_rgb_cache, jax_ds)):
        with pytest.raises(ValueError, match="stale"):
            build(lambda: ds.ImageFolderDataset(str(src)), out, canvas_size=16, root=str(src))
        with pytest.raises(ValueError, match="was built from"):
            build(lambda: ds.ImageFolderDataset(folder), out, canvas_size=16, root=folder)
    with pytest.raises(FileNotFoundError, match="no complete RGB cache"):
        cache.PackedRGBCacheDataset(str(tmp_path / "nothing"))


def test_build_dataset_routes_imagefolder_as_jax_does(folder, tmp_path):
    for ours, theirs in (
        (datasets.build_dataset("imagefolder", folder, 21, num_workers=2),
         jax_ds.build_dataset("imagefolder", folder, 21, num_workers=2)),
        (datasets.build_dataset("imagefolder", folder, 21, num_workers=2,
                                cache_dir=str(tmp_path / "p")),
         jax_ds.build_dataset("imagefolder", folder, 21, num_workers=2,
                              cache_dir=str(tmp_path / "j"))),
    ):
        assert type(ours).__name__ == type(theirs).__name__
        assert ours.decode_size == theirs.decode_size == 24
        np.testing.assert_array_equal(ours.load(6)[0], theirs.load(6)[0])
    assert os.path.exists(tmp_path / "p" / "all" / ".complete")
    with pytest.raises(ValueError, match="imagefolder needs data_dir"):
        datasets.build_dataset("imagefolder", None, 21)


# -------------------------------------------------------- the pipeline


def _jax_pipeline(cfg_kw, dataset):
    import jax

    cfg = JaxDataConfig(**cfg_kw)
    return JaxTwoCropPipeline(cfg, create_mesh(devices=jax.devices()[:1]), seed=3, dataset=dataset)


@pytest.mark.parametrize("source", ["folder", "cache"])
def test_host_crop_batch_matches_jax(folder, tmp_path, source):
    kw = dict(dataset="imagefolder", data_dir=folder, image_size=16, global_batch=6,
              num_workers=2, aug_plus=True)
    if source == "folder":
        ours_ds, theirs_ds = datasets.ImageFolderDataset(folder), jax_ds.ImageFolderDataset(folder)
    else:
        cache.build_rgb_cache(datasets.ImageFolderDataset(folder), str(tmp_path), canvas_size=16,
                              root=folder)
        ours_ds = cache.PackedRGBCacheDataset(str(tmp_path), 16, use_native=False)
        theirs_ds = jax_cache.PackedRGBCacheDataset(str(tmp_path), 16, use_native=False)
    theirs = _jax_pipeline(kw, theirs_ds)
    with TwoCropPipeline(pc.DataConfig(**kw), seed=3, dataset=ours_ds, device="cpu") as ours:
        assert ours.host_crops and theirs.host_crops
        np.testing.assert_array_equal(ours.epoch_order(1), theirs._epoch_order(1))
        idx = ours.epoch_order(1)[6:12]
        scale = ours.recipe.crop_scale
        assert scale == theirs.recipe.crop_scale
        (a, la), (b, lb) = (p._local_crop_batch(idx, 1, 1, 2, scale, 16) for p in (ours, theirs))
        assert a.shape == (6, 2, 16, 16, 3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        hb = ours.host_batch(1, 1)
        assert hb.precropped and hb.wire_bytes == a.nbytes
        np.testing.assert_array_equal(hb.views.numpy(), a)
        hb.slots.release(hb.slot)
        out = ours.batch(1, 1)
        assert out["im_q"].shape == out["im_k"].shape == (6, 16, 16, 3)


def test_epoch_order_matches_jax():
    kw = dict(dataset="synthetic", image_size=32, global_batch=8)
    theirs = _jax_pipeline(kw, jax_ds.SyntheticDataset(40, 32))
    with TwoCropPipeline(pc.DataConfig(**kw), seed=3, dataset=datasets.SyntheticDataset(40, 32),
                         device="cpu") as ours:
        assert ours.steps_per_epoch == theirs.steps_per_epoch == 5
        for e in (0, 1, 7):
            np.testing.assert_array_equal(ours.epoch_order(e), theirs._epoch_order(e))


def test_canvas_batch_is_the_dataset_images_augmented():
    """A canvas-path host batch holds the dataset's own images of the
    step's indices, in order, in one reused slot."""
    cfg = pc.DataConfig(dataset="synthetic", image_size=32, global_batch=4, crops_only=True)
    ds = datasets.SyntheticDataset(12, 32)
    with TwoCropPipeline(cfg, seed=1, dataset=ds, device="cpu") as pipe:
        assert pipe.recipe.name == "probe" and not pipe.host_crops
        slots = []
        for step in range(3):
            hb = pipe.host_batch(2, step)
            idx = pipe.epoch_order(2)[4 * step:4 * step + 4]
            np.testing.assert_array_equal(hb.views.numpy(), np.stack([ds.load(i)[0] for i in idx]))
            slots.append(hb.slot)
            hb.slots.release(hb.slot)
        assert slots[0] is slots[1] is slots[2]
        # the device stage is two_crop_augment on the batch's seeded generator
        hb = pipe.host_batch(2, 1)
        images = hb.views.float() / 255.0
        hb.slots.release(hb.slot)
        want = two_crop_augment(pipe.recipe, torch.Generator().manual_seed(hb.seed), images, 32)
        got = pipe.batch(2, 1)
        assert all(torch.equal(got[k], want[k]) for k in want)
