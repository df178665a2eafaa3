"""Activation-quantized int8 inference: calibration and the w8a8 forward,
the counterpart of moco_tpu/serve/quant.py.

Weight-only PTQ (`engine_quant="w8"`, serve/engine.py) keeps the weights
int8 at rest and runs f32 products. The w8a8 tier puts the activations on
the int8 grid too, which needs calibration: a held-out sample runs once
through the f32 encoder at the engine's preprocessing seam (/255, the eval
recipe's normalize), an observer records `amax = max|input|` at the input
of every quantized layer, and symmetric per-tensor scales are fitted from
those ranges (`s = amax / 127`; per-tensor on activations,
per-output-channel on weights, as `engine.quantize_params_int8`).

Layers are keyed by the Flax path the JAX package gives them
(`backbone/BasicBlock_0/ConvBN_0/Conv_0`, `head/Dense_1`), so a
`quant_calib.json` written by either package serves in the other. The
table is read off `convert.py`'s own layout rules, not kept by hand: each
parameter, filled with its ordinal, goes through `*_to_flax`, and each
Flax leaf then names the parameter it came from (`flax_leaves`).

- **observe** (`ActivationObserver`): forward pre-hooks on every plain
  `nn.Conv2d` / `nn.Linear` whose Flax counterpart is an `nn.Conv` or an
  `nn.Dense` (a 4-D or 2-D kernel). A ViT's attention projections are
  `DenseGeneral` in Flax (3-D kernels): JAX's observer never sees them, and
  neither does this one, so `validate_calibration` refuses a ViT for w8a8
  in both packages. Grouped convolutions and other padding modes pass
  through in f32 (`_is_plain`).
- **quantize** (`quantized_copy`, the counterpart of `quantized_apply`): a
  copy of the encoder whose calibrated layers are `Int8Conv2d` /
  `Int8Linear`. Each quantizes its input, `clip(round(x / a_s), -127,
  127)`, accumulates in int32, rescales once by `a_s * w_s` and adds the
  bias in f32. Everything between layers (BN, ReLU, residual adds,
  pooling, L2-normalize) stays f32.

Two routes compute the same integers. `int8_compute=True` runs true int8
products: `torch._int_mm` (cuBLASLt int8 -> int32 on the card) for a
linear, for a 1x1 convolution over its channels-last rows, and for a kxk
convolution after an im2col that takes the module's own stride, padding
and dilation; shapes are padded to what cuBLASLt takes (m > 16, K and N
multiples of 8; ops/int8.py). `int8_compute=False` is JAX's
scaled-integer emulation: the same integer values held in f32 (or
float64, `emulation_dtype`) through the f32 convolution and matmul. The
emulation is exact while a layer's sums stay under 2^24 in f32, and in
float64 always. `default_int8_compute` picks true int8 on the card and the
emulation on the CPU, as JAX gates on its backend; the route never changes
on its own, and `InferenceEngine.int8_compute` says which one ran.

Calibration persists as a small JSON artifact beside the checkpoint
(`quant_calib.json`: version, image size, sample size, per-path amax),
JAX's format: `save_calibration` / `load_calibration` round-trip bitwise.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moco_tpu_torch import convert
from moco_tpu_torch.ops.int8 import im2col, int8_matmul, pad_int8_weight

CALIBRATION_VERSION = 1
CALIBRATION_FILENAME = "quant_calib.json"
# module types the quantized forward replaces; anything else runs f32
QUANT_LAYER_TYPES = (nn.Conv2d, nn.Linear)
# engine quantization tiers (serve/engine.py's engine_quant knob)
QUANT_MODES = ("off", "w8", "w8a8")


# -- the Flax layout, through convert.py ---------------------------------


def _num_heads(module: nn.Module) -> Optional[int]:
    return next((m.num_heads for m in module.modules() if hasattr(m, "num_heads")), None)


def to_flax(sd: dict, num_heads: Optional[int] = None) -> dict:
    """The Flax params tree of `sd` (torch names, parameters only): a whole
    `MoCoEncoder`, a ResNet or ViT backbone, or a head."""
    if any(k.startswith("backbone.") for k in sd):
        return convert.encoder_to_flax(sd, num_heads)[0]
    if "patch_embed.weight" in sd:
        return convert.vit_to_flax(sd, num_heads)
    if "conv1.weight" in sd:
        return convert.backbone_to_flax(sd)[0]
    return convert.head_to_flax(sd)[0]


def from_flax(tree: dict, like: dict) -> dict:
    """The inverse of `to_flax` for a module whose parameters are `like`:
    torch names -> float32 numpy arrays."""
    if any(k.startswith("backbone.") for k in like):
        return {k: v.numpy() for k, v in convert.encoder_from_flax(tree).items()}
    if "patch_embed.weight" in like:
        return convert.vit_from_flax(tree)
    if "conv1.weight" in like:
        return convert.backbone_from_flax(tree)
    return convert.head_from_flax(tree)


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def flax_leaves(module: nn.Module) -> dict:
    """{parameter name: (Flax leaf path tuple, Flax leaf shape)} for every
    parameter of `module`, as `convert.py` lays them out (module
    docstring)."""
    params = list(module.named_parameters())
    tagged = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(params)}
    out = {}
    for path, leaf in flatten(to_flax(tagged, _num_heads(module))).items():
        out[params[int(np.asarray(leaf).flat[0])][0]] = (path, np.shape(leaf))
    return out


def _is_plain(mod: nn.Module) -> bool:
    """Only plain convolutions and linears quantize; a grouped convolution
    or another padding mode passes through f32 rather than risk a
    semantics mismatch in the int8 op."""
    if isinstance(mod, nn.Linear):
        return True
    return (isinstance(mod, nn.Conv2d) and mod.groups == 1 and mod.padding_mode == "zeros"
            and not isinstance(mod.padding, str))


def layer_keys(module: nn.Module) -> dict:
    """{torch module name: Flax layer path} of the layers the observer and
    the w8a8 forward take: plain `nn.Conv2d` / `nn.Linear` whose weight is
    a 4-D or 2-D Flax kernel (an `nn.Conv` or `nn.Dense`)."""
    leaves = flax_leaves(module)
    out = {}
    for name, mod in module.named_modules():
        if not isinstance(mod, QUANT_LAYER_TYPES) or not _is_plain(mod):
            continue
        path, shape = leaves[f"{name}.weight" if name else "weight"]
        if path[-1] == "kernel" and len(shape) in (2, 4):
            out[name] = "/".join(path[:-1])
    return out


# -- calibration ------------------------------------------------------------


class ActivationObserver:
    """Records per-tensor activation ranges (`amax[path] = max|input|`) of
    every observed layer (`layer_keys`) while `intercept(module)` is
    active. Ranges accumulate across calls (a running max over the
    calibration batches)."""

    def __init__(self):
        self.amax: dict[str, float] = {}

    def _hook(self, path: str):
        def pre(_mod, args):
            v = float(args[0].detach().abs().max())
            self.amax[path] = max(self.amax.get(path, 0.0), v)
        return pre

    @contextlib.contextmanager
    def intercept(self, module: nn.Module):
        mods = dict(module.named_modules())
        handles = [mods[name].register_forward_pre_hook(self._hook(path))
                   for name, path in layer_keys(module).items()]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()


def fit_scales(amax: dict) -> dict:
    """Symmetric per-tensor activation scales from observed ranges:
    `s = amax / 127`, 1 for a never-activated tensor (its quantized values
    are all zero anyway)."""
    return {path: (v / 127.0 if v > 0.0 else 1.0) for path, v in sorted(amax.items())}


@torch.no_grad()
def calibrate_encoder(module: nn.Module, images: np.ndarray, image_size: int,
                      batch_size: int = 32) -> dict:
    """One calibration pass at the engine's preprocessing seam: the
    held-out uint8 `images` run through /255 -> the eval recipe's normalize
    -> the f32 encoder (eagerly, on the module's device, in eval mode)
    under the observer. Returns the JSON-ready artifact."""
    from moco_tpu_torch.data.augment import eval_stats, normalize

    images = np.asarray(images, np.uint8)
    if images.ndim != 4 or images.shape[1:] != (image_size, image_size, 3):
        raise ValueError(
            f"calibration sample must be (n, {image_size}, {image_size}, 3) "
            f"uint8, got {images.shape}"
        )
    mean, std = eval_stats(int(image_size))
    device = next(module.parameters()).device
    was_training = module.training
    module.eval()
    obs = ActivationObserver()
    try:
        with obs.intercept(module):
            for lo in range(0, images.shape[0], int(batch_size)):
                x = torch.from_numpy(images[lo : lo + int(batch_size)]).to(device).float() / 255.0
                module(normalize(x, mean, std))
    finally:
        module.train(was_training)
    if not obs.amax:
        raise ValueError("calibration saw no quantizable Conv/Dense layer")
    return {
        "version": CALIBRATION_VERSION,
        "image_size": int(image_size),
        "sample_n": int(images.shape[0]),
        "num_layers": len(obs.amax),
        "amax": {k: obs.amax[k] for k in sorted(obs.amax)},
    }


def calibration_path(ckpt_dir: str) -> str:
    """Where the artifact lives relative to a checkpoint directory."""
    return os.path.join(ckpt_dir, CALIBRATION_FILENAME)


def save_calibration(path: str, calib: dict) -> str:
    """Atomic JSON write (floats through repr, so load(save(x)) == x
    bitwise). Takes a checkpoint directory or a file path."""
    if os.path.isdir(path):
        path = calibration_path(path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(calib, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_calibration(path: str) -> dict:
    if os.path.isdir(path):
        path = calibration_path(path)
    with open(path) as f:
        calib = json.load(f)
    if calib.get("version") != CALIBRATION_VERSION or "amax" not in calib:
        raise ValueError(f"{path} is not a v{CALIBRATION_VERSION} calibration artifact")
    return calib


def default_int8_compute(device) -> bool:
    """True int8 products on the card, the emulation on the CPU: JAX's
    backend gate (tpu/gpu against cpu)."""
    return torch.device(device).type == "cuda"


def quantized_layer_paths(module: nn.Module) -> set:
    """Flax paths of the layers `quantize_params_int8` quantizes (every
    kernel of two or more dimensions): what a w8a8 calibration must cover."""
    return {"/".join(path[:-1]) for path, shape in flax_leaves(module).values()
            if path[-1] == "kernel" and len(shape) >= 2}


def validate_calibration(calib: dict, module: nn.Module, image_size: int) -> None:
    """Fail at engine build, not at serve time: the artifact must match the
    serving geometry and cover every quantized layer (an uncovered one would
    be a silent tier downgrade)."""
    if int(calib.get("image_size", -1)) != int(image_size):
        raise ValueError(
            f"calibration was captured at image_size="
            f"{calib.get('image_size')}, engine serves {image_size}"
        )
    missing = quantized_layer_paths(module) - set(calib["amax"])
    if missing:
        raise ValueError(
            f"calibration covers {len(calib['amax'])} layers but the encoder "
            f"has {len(missing)} uncovered quantized layers: {sorted(missing)[:4]}"
        )


def activation_scales(calib: dict) -> dict:
    """{Flax path: float32 scale} of the artifact (`fit_scales`, each scale
    rounded to float32 as JAX's `jnp.float32(s)` does)."""
    return {path: torch.tensor(s, dtype=torch.float32)
            for path, s in fit_scales(calib["amax"]).items()}


# -- the int8 layers --------------------------------------------------------


class _Int8Layer(nn.Module):
    """What the two int8 modules share: the calibrated activation scale,
    the per-output-channel weight scale, the rescale `a_s * w_s` (f32), the
    f32 bias, the route, and the accumulator capture a check may set."""

    def __init__(self, layer, w_scale: torch.Tensor, a_scale: torch.Tensor,
                 int8_compute: bool):
        super().__init__()
        self.int8_compute = bool(int8_compute)
        # the emulation's dtype: float32 as JAX's; float64 keeps every sum exact
        self.emulation_dtype = torch.float32
        # a list to append each call's accumulator to (None: off)
        self.capture: Optional[list] = None
        w_scale = w_scale.reshape(-1).float()
        a_scale = a_scale.reshape(()).float()
        self.register_buffer("a_scale", a_scale)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("scale", a_scale * w_scale)
        bias = layer.bias
        self.register_buffer("bias", None if bias is None else bias.detach().float().clone())
        self.out_features = w_scale.numel()

    def _quantize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x.float() / self.a_scale), -127.0, 127.0)

    def _finish(self, acc: torch.Tensor, channel_dim: int) -> torch.Tensor:
        if self.capture is not None:
            self.capture.append(acc)
        shape = [1] * acc.dim()
        shape[channel_dim] = -1
        out = acc.float() * self.scale.reshape(shape)
        if self.bias is not None:
            out = out + self.bias.reshape(shape)
        return out


class Int8Conv2d(_Int8Layer):
    """A plain `nn.Conv2d` on the int8 grid (module docstring). `qweight`
    holds the int8 weight in the layout of the route: (O, C, kh, kw) for
    the emulation, the padded (O', K') patch-row matrix for `_int_mm`."""

    def __init__(self, conv: nn.Conv2d, qweight: torch.Tensor, w_scale, a_scale,
                 int8_compute: bool):
        super().__init__(conv, w_scale, a_scale, int8_compute)
        self.kernel_size, self.stride = conv.kernel_size, conv.stride
        self.padding, self.dilation = conv.padding, conv.dilation
        q = qweight.to(torch.int8)
        if self.int8_compute:  # (O, C, kh, kw) -> (O, kh * kw * C), the im2col column order
            q = pad_int8_weight(q.permute(0, 2, 3, 1).reshape(q.shape[0], -1))
        self.register_buffer("qweight", q.contiguous())

    def forward(self, x):
        xq = self._quantize(x)  # (N, C, H, W) integer values in f32
        if not self.int8_compute:
            dt = self.emulation_dtype
            acc = F.conv2d(xq.to(dt), self.qweight.to(dt), None, self.stride, self.padding,
                           self.dilation)
            # channels-last as the int8 route's rows are: the layers after
            # (BN, ReLU) pick their kernels by layout, and a float64
            # convolution on the card answers in NCHW
            return self._finish(acc.contiguous(memory_format=torch.channels_last), 1)
        x8 = xq.permute(0, 2, 3, 1).to(torch.int8)  # channels-last rows
        cols, (n, ho, wo) = im2col(x8, self.kernel_size, self.stride, self.padding,
                                   self.dilation)
        acc = int8_matmul(cols, self.qweight)[:, : self.out_features]
        return self._finish(acc.reshape(n, ho, wo, -1).permute(0, 3, 1, 2), 1)


class Int8Linear(_Int8Layer):
    """A `nn.Linear` on the int8 grid; `qweight` is (O, I) for the
    emulation and the padded (O', I') matrix for `_int_mm`."""

    def __init__(self, linear: nn.Linear, qweight: torch.Tensor, w_scale, a_scale,
                 int8_compute: bool):
        super().__init__(linear, w_scale, a_scale, int8_compute)
        q = qweight.to(torch.int8)
        self.register_buffer("qweight", pad_int8_weight(q) if self.int8_compute else q)

    def forward(self, x):
        xq = self._quantize(x)
        if not self.int8_compute:
            dt = self.emulation_dtype
            return self._finish(F.linear(xq.to(dt), self.qweight.to(dt)), -1)
        lead = xq.shape[:-1]
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]).to(torch.int8), self.qweight)
        return self._finish(acc[:, : self.out_features].reshape(*lead, -1), -1)


def _set_module(root: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, new)


def quantized_copy(module: nn.Module, qparams: dict, qscales: dict, act_scales: dict,
                   int8_compute: bool) -> nn.Module:
    """The w8a8 forward as a module, the counterpart of `quantized_apply`: a
    copy of `module` whose observed layers (`layer_keys`) with a calibrated
    activation scale are `Int8Conv2d` / `Int8Linear`, built from the int8
    weights and scales of `engine.quantize_params_int8` (`qparams`,
    `qscales`, by parameter name) and `act_scales` (by Flax path). Any
    other layer keeps its f32 weights (`validate_calibration` refuses a
    module with an uncovered quantized layer up front)."""
    out = copy.deepcopy(module)
    mods = dict(out.named_modules())
    for name, path in layer_keys(module).items():
        a_s = act_scales.get(path)
        weight = f"{name}.weight" if name else "weight"
        if a_s is None or qparams[weight].dtype != torch.int8:
            continue
        kind = Int8Conv2d if isinstance(mods[name], nn.Conv2d) else Int8Linear
        new = kind(mods[name], qparams[weight], qscales[weight], a_s, int8_compute)
        if name:
            _set_module(out, name, new)
        else:
            out = new
    return out


__all__ = [
    "ActivationObserver",
    "CALIBRATION_FILENAME",
    "CALIBRATION_VERSION",
    "Int8Conv2d",
    "Int8Linear",
    "QUANT_LAYER_TYPES",
    "QUANT_MODES",
    "activation_scales",
    "calibrate_encoder",
    "calibration_path",
    "default_int8_compute",
    "fit_scales",
    "flax_leaves",
    "layer_keys",
    "load_calibration",
    "quantized_copy",
    "quantized_layer_paths",
    "save_calibration",
    "validate_calibration",
]
