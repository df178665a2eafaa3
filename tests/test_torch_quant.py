"""The port's quantized engine tiers (moco_tpu_torch/serve/quant.py and
`engine_quant` of serve/engine.py) held against moco_tpu/serve/quant.py and
the JAX engine on the CPU, at resnet18 width 8 and 32 px.

- `quantize_params_int8`: the int8 values equal JAX's, the scales within
  1 ULP, both read in the port's layout through `convert.encoder_from_flax`.
- Calibration: the same Flax paths as JAX's, each amax within 1e-5
  relative, on the same weights and numpy sample; the artifact moves both
  ways (JAX's file validates and serves here, the port's passes JAX's
  `load_calibration` + `validate_calibration`).
- `w8` embeddings within 1e-4 of JAX's `engine_quant="w8"` (the same
  dequantized f32 weights through two f32 forwards).
- `w8a8` against JAX's engine in its emulation (`int8_compute=False`):
  the two packages' f32 forwards differ in the last bits before a layer's
  `round(x / a_s)` (the layer-by-layer test below holds it within 1e-4 of
  a step), which now and then flips one element sitting at a .5 boundary
  by one step and moves that row's embedding (JAX's own jitted and eager
  emulations differ the same way). Held at 1e-2, with at most one row of
  a batch past 1e-5 and at least three of the four batches within 1e-6;
  layer by layer, no flip at all against JAX's eager `quantized_apply` on
  a batch that has none.
- The `torch._int_mm` route bit-equal to the emulation, padding included
  (the stem's K = 27, bucket 1's m = 1, the head's N = 16).
- A ViT: `w8` serves, `w8a8` raises JAX's uncovered-layers error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.models.resnet import create_resnet as flax_resnet
from moco_tpu.serve import quant as jax_quant
from moco_tpu.serve.engine import InferenceEngine as JaxEngine
from moco_tpu.serve.engine import quantize_params_int8 as jax_quantize_params_int8
from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
from moco_tpu_torch.core.moco import build_encoder
from moco_tpu_torch.ops.int8 import im2col, int8_matmul, pad_int8_weight
from moco_tpu_torch.serve import quant
from moco_tpu_torch.serve.engine import (
    EngineRecompileError,
    InferenceEngine,
    dequantize_params,
    quantize_params_int8,
)
from moco_tpu_torch.utils.config import MocoConfig

IMG, NF = 32, 8
CFG = MocoConfig(arch="resnet18", dim=16, mlp=True, cifar_stem=True)
BUCKETS = (1, 4)
W8A8_ATOL = 1e-2  # one flipped round() (module docstring)


def images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, IMG, IMG, 3), np.uint8)


def port_encoder(params, stats):
    model = build_encoder(CFG, num_filters=NF)
    model.load_state_dict(encoder_from_flax(params, stats))
    return model.eval()


@pytest.fixture(scope="module")
def weights():
    params, stats = random_flax_encoder(CFG, seed=0, num_filters=NF)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstats = jax.tree_util.tree_map(jnp.asarray, stats)
    flax = FlaxEncoder(
        backbone=flax_resnet("resnet18", num_filters=NF, cifar_stem=True, dtype=jnp.float32),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32),
    )
    return params, stats, flax, jparams, jstats


@pytest.fixture(scope="module")
def sample():
    return images(16, seed=7)


@pytest.fixture(scope="module")
def calibrations(weights, sample):
    params, stats, flax, jparams, jstats = weights
    want = jax_quant.calibrate_encoder(flax, jparams, jstats, sample, IMG)
    got = quant.calibrate_encoder(port_encoder(params, stats), sample, IMG)
    return got, want


@pytest.fixture(scope="module")
def jax_engines(weights, calibrations):
    _, _, flax, jparams, jstats = weights
    _, want = calibrations
    return {
        tier: JaxEngine(flax, jparams, jstats, image_size=IMG, buckets=BUCKETS,
                        engine_quant=tier, calibration=want if tier == "w8a8" else None,
                        int8_compute=False)
        for tier in ("w8", "w8a8")
    }


def test_quantize_params_int8_matches_jax(weights):
    """Int8 values equal JAX's, scales within 1 ULP, pass-through leaves
    untouched; dequantize is the inverse map."""
    params, stats, _, jparams, _ = weights
    model = port_encoder(params, stats)
    qparams, qscales = quantize_params_int8(model)
    jq, js = jax_quantize_params_int8(jparams)
    want_q = encoder_from_flax(jax.tree_util.tree_map(np.asarray, jq))
    full_s = jax.tree_util.tree_map(lambda s, p: np.broadcast_to(np.asarray(s), np.shape(p)),
                                    js, jparams)
    want_s = encoder_from_flax(full_s)
    quantized = 0
    for name, p in model.named_parameters():
        q, s = qparams[name], qscales[name]
        if q.dtype == torch.int8:
            quantized += 1
            np.testing.assert_array_equal(q.numpy(), want_q[name].numpy().astype(np.int8),
                                          err_msg=name)
            np.testing.assert_array_max_ulp(np.broadcast_to(s.numpy(), q.shape),
                                            want_s[name].numpy(), maxulp=1)
        else:
            assert p.dim() < 2 and torch.equal(q, p.detach()) and float(s) == 1.0
    assert quantized == sum(p.dim() >= 2 for p in model.parameters()) == 22
    dq = dequantize_params(qparams, qscales)
    for name, p in model.named_parameters():
        if p.dim() >= 2:  # within half a quantization step of the weight
            assert ((dq[name] - p.detach()).abs() <= 0.5001 * qscales[name]).all()


def test_calibration_matches_jax(calibrations):
    got, want = calibrations
    assert set(got["amax"]) == set(want["amax"]) and got["num_layers"] == want["num_layers"] == 22
    for path, v in want["amax"].items():
        assert got["amax"][path] == pytest.approx(v, rel=1e-5, abs=0), path
    assert {k: v for k, v in got.items() if k != "amax"} == {
        k: v for k, v in want.items() if k != "amax"}


def test_calibration_artifacts_interchange(tmp_path, weights, calibrations):
    """JAX's file validates and serves here; the port's passes JAX's load
    and validate; save -> load is the identity in both."""
    params, stats, _, jparams, _ = weights
    got, want = calibrations
    model = port_encoder(params, stats)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_quant.save_calibration(str(jax_dir), want)
    from_jax = quant.load_calibration(str(jax_dir))
    assert from_jax == want
    quant.validate_calibration(from_jax, model, IMG)
    eng = InferenceEngine(model, IMG, buckets=(1,), device="cpu", engine_quant="w8a8",
                          calibration=from_jax)
    assert eng.calibration == want and np.isfinite(eng.embed(images(1))[0]).all()
    path = quant.save_calibration(str(port_dir), got)
    assert path.endswith(quant.CALIBRATION_FILENAME) == path.endswith(jax_quant.CALIBRATION_FILENAME)
    from_port = jax_quant.load_calibration(path)
    assert from_port == got == quant.load_calibration(str(port_dir))
    jax_quant.validate_calibration(from_port, jparams, IMG)
    with pytest.raises(ValueError, match="image_size"):
        quant.validate_calibration(got, model, IMG * 2)
    clipped = dict(got, amax=dict(list(got["amax"].items())[:3]))
    with pytest.raises(ValueError) as port_err:
        quant.validate_calibration(clipped, model, IMG)
    with pytest.raises(ValueError) as jax_err:
        jax_quant.validate_calibration(clipped, jparams, IMG)
    assert str(port_err.value) == str(jax_err.value)


def test_w8_matches_jax(weights, jax_engines):
    params, stats, *_ = weights
    eng = InferenceEngine(port_encoder(params, stats), IMG, buckets=BUCKETS, device="cpu",
                          engine_quant="w8")
    eng.warmup()
    assert (eng.quant, eng.int8, eng.int8_compute) == ("w8", True, False)
    for n in (1, 3):
        got, ex = eng.embed(images(n, seed=n))
        want, want_ex = jax_engines["w8"].embed(images(n, seed=n))
        assert ex == want_ex
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert eng.int8_audit() == {1: True, 4: True}
    assert eng.recompiles_after_warmup == 0
    b = eng.int8_bytes
    assert b["int8"] > 0 and b["f32"] == 4 * b["int8"]


def test_w8a8_matches_jax_emulation(weights, calibrations, jax_engines):
    params, stats, *_ = weights
    got_cal, want_cal = calibrations
    eng = InferenceEngine(port_encoder(params, stats), IMG, buckets=BUCKETS, device="cpu",
                          engine_quant="w8a8", calibration=want_cal)
    eng.warmup()
    assert (eng.quant, eng.int8, eng.int8_compute, eng.dtype) == ("w8a8", True, False,
                                                                   torch.float32)
    f32 = InferenceEngine(port_encoder(params, stats), IMG, buckets=BUCKETS, device="cpu")
    exact_batches = 0
    for n, seed in ((1, 10), (4, 11), (4, 12), (4, 13)):
        imgs = images(n, seed=seed)
        got, _ = eng.embed(imgs)
        want, _ = jax_engines["w8a8"].embed(imgs)
        np.testing.assert_allclose(got, want, atol=W8A8_ATOL, rtol=0)
        off = np.abs(got - want).max(1)
        assert (off > 1e-5).sum() <= 1, off
        exact_batches += int(off.max() <= 1e-6)
        ref, _ = f32.embed(imgs)
        assert (got * ref).sum(1).min() >= 0.99  # JAX's QUANT_COSINE_FLOOR
        assert np.abs(got - ref).max() > 0  # the activations really quantize
    assert exact_batches >= 3
    assert eng.int8_audit() == {1: True, 4: True} and eng.recompiles_after_warmup == 0
    with pytest.raises(EngineRecompileError):
        eng._run_bucket(np.zeros((2, IMG, IMG, 3), np.uint8))


def test_w8a8_layers_match_jax_quantized_apply(weights, calibrations):
    """Layer by layer against JAX's eager `quantized_apply` (emulation) on
    one batch: every layer's input on the int8 grid equal (no flipped
    round), its pre-round value within 1e-4 of a step, and the embeddings
    within 1e-6."""
    import flax.linen as nn

    from moco_tpu.data.augment import get_recipe, normalize

    params, stats, flax, jparams, jstats = weights
    _, cal = calibrations
    imgs = images(4, seed=14)
    acts = jax_quant.activation_scales(cal)
    qp, qs = jax_quantize_params_int8(jparams)
    want_in = {}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and isinstance(mod, (nn.Conv, nn.Dense)):
            path = "/".join(mod.path)
            want_in[path] = np.asarray(args[0].astype(jnp.float32) / acts[path])
        return next_fun(*args, **kwargs)

    recipe = get_recipe(False, IMG)
    x = normalize(jnp.asarray(imgs, jnp.float32) / 255.0, recipe.mean, recipe.std)
    with nn.intercept_methods(record):
        want = np.array(jax_quant.quantized_apply(flax, qp, qs, jstats, acts, x,
                                                  int8_compute=False))
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    eng = InferenceEngine(port_encoder(params, stats), IMG, buckets=(4,), device="cpu",
                          engine_quant="w8a8", calibration=cal)
    keys = quant.layer_keys(port_encoder(params, stats))
    got_in = {}
    for name, mod in eng.module.named_modules():
        if isinstance(mod, quant._Int8Layer):
            mod.register_forward_pre_hook(
                lambda m, args, path=keys[name]: got_in.__setitem__(
                    path, (args[0].float() / m.a_scale).numpy()))
    got, _ = eng.embed(imgs)
    assert set(got_in) == set(want_in) and len(got_in) == 22
    for path, w in want_in.items():
        g = got_in[path]
        g = g.transpose(0, 2, 3, 1) if g.ndim == 4 else g  # NCHW -> Flax's NHWC
        assert np.abs(g - w).max() <= 1e-4, path
        np.testing.assert_array_equal(np.clip(np.round(g), -127, 127),
                                      np.clip(np.round(w), -127, 127), err_msg=path)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_int_mm_route_equals_the_emulation(weights, calibrations):
    """True int8 products (`torch._int_mm` behind the padding) and the
    scaled-integer emulation give the same embeddings bit for bit and the
    same int32 accumulators at every layer, buckets 1 and 4."""
    params, stats, *_ = weights
    cal, _ = calibrations
    engines = {flag: InferenceEngine(port_encoder(params, stats), IMG, buckets=BUCKETS,
                                     device="cpu", engine_quant="w8a8", calibration=cal,
                                     int8_compute=flag) for flag in (False, True)}
    for n in (1, 4):
        accs = {}
        for flag, eng in engines.items():
            layers = [m for m in eng.module.modules() if isinstance(m, quant._Int8Layer)]
            accs[flag] = []
            for m in layers:
                m.capture = accs[flag]
            out, _ = eng.embed(images(n, seed=20 + n))
            accs[flag].append(out)
            for m in layers:
                m.capture = None
        assert len(accs[True]) == len(accs[False]) == 23
        for a, b in zip(accs[True][:-1], accs[False][:-1]):
            assert a.dtype == torch.int32 and torch.equal(a.double(), b.double())
        np.testing.assert_array_equal(accs[True][-1], accs[False][-1])


@pytest.mark.parametrize("kernel, stride, padding, dilation", [
    (3, 1, 1, 1), (3, 2, 1, 1), (1, 2, 0, 1), (7, 2, 3, 1), (3, 1, 2, 2)])
def test_im2col_conv_equals_conv2d(kernel, stride, padding, dilation):
    rng = np.random.default_rng(kernel + stride)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 9, 11, 5)).astype(np.int8))  # NHWC
    w = torch.from_numpy(rng.integers(-127, 128, (6, 5, kernel, kernel)).astype(np.int8))
    cols, (n, ho, wo) = im2col(x, (kernel, kernel), (stride, stride), (padding, padding),
                               (dilation, dilation))
    got = int8_matmul(cols, pad_int8_weight(w.permute(0, 2, 3, 1).reshape(6, -1)))[:, :6]
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), None, stride, padding, dilation)
    assert torch.equal(got.reshape(n, ho, wo, 6).permute(0, 3, 1, 2).double(), want)


def test_engine_quant_arguments_as_jax(weights):
    params, stats, *_ = weights
    model = port_encoder(params, stats)
    with pytest.raises(ValueError, match="calib"):
        InferenceEngine(model, IMG, buckets=(1,), device="cpu", engine_quant="w8a8")
    with pytest.raises(ValueError, match="engine_quant"):
        InferenceEngine(model, IMG, buckets=(1,), device="cpu", engine_quant="int4")
    eng = InferenceEngine(model, IMG, buckets=(1,), device="cpu", int8=True)
    assert eng.quant == "w8" and eng.int8
    off = InferenceEngine(model, IMG, buckets=(1,), device="cpu")
    assert off.quant == "off" and not off.int8 and off.int8_audit() == {}
    assert not quant.default_int8_compute("cpu") and quant.default_int8_compute("cuda")
    # a calibration fitted from the sample by the engine equals the module's own
    sample = images(8, seed=3)
    fitted = InferenceEngine(model, IMG, buckets=(1,), device="cpu", engine_quant="w8a8",
                             calib_sample=sample)
    assert fitted.calibration == quant.calibrate_encoder(model, sample, IMG)


def test_vit_serves_w8_and_w8a8_raises_jax_error():
    cfg = MocoConfig(arch="vit_tiny", dim=16, mlp=True, vit_patch_size=8)
    params, stats = random_flax_encoder(cfg, seed=1)
    model = build_encoder(cfg)
    model.load_state_dict(encoder_from_flax(params, stats))
    imgs = images(2, seed=4)
    ref, _ = InferenceEngine(model, IMG, buckets=(2,), device="cpu").embed(imgs)
    w8 = InferenceEngine(model, IMG, buckets=(2,), device="cpu", engine_quant="w8")
    got, _ = w8.embed(imgs)
    assert np.isfinite(got).all() and (got * ref).sum(1).min() >= 0.99
    assert w8.int8_audit() == {2: True}
    cal = quant.calibrate_encoder(model, imgs, IMG)
    assert not any("MultiHeadDotProductAttention" in p for p in cal["amax"])
    with pytest.raises(ValueError, match="uncovered quantized layers") as port_err:
        InferenceEngine(model, IMG, buckets=(2,), device="cpu", engine_quant="w8a8",
                        calibration=cal)
    with pytest.raises(ValueError) as jax_err:
        jax_quant.validate_calibration(cal, jax.tree_util.tree_map(jnp.asarray, params), IMG)
    assert str(port_err.value) == str(jax_err.value)
