"""Bucketed embedding inference, the counterpart of moco_tpu/serve/engine.py.

Requests of any size are chunked at the largest bucket and padded with
zero rows up to the next bucket (default {1, 8, 32, 128}), so the device
only ever sees those batch shapes. `warmup()` runs every bucket once and
freezes the set: afterwards a batch shape outside it raises
`EngineRecompileError`, and `recompiles_after_warmup` stays the gauge
that proves it.

Forward: uint8 NHWC -> /255 -> per-channel normalize (the eval recipe's
statistics) -> encoder -> f32 -> L2-normalize. `engine_quant` selects the
quantization tier at this seam (`int8=True` is JAX's spelling of "w8"):

- **off**: the encoder as given. On the card it runs in bf16 under
  `torch.autocast` with f32 weights, as the JAX package serves in bf16 on
  accelerators; on the CPU in f32.
- **w8**: weight-only PTQ. Every weight of two or more dimensions is
  stored int8 with symmetric per-output-channel scales
  (`quantize_params_int8`, JAX's grouping and rounding) and stays int8 on
  the card; each bucket dequantizes it into the forward, under the same
  autocast as tier off. ~4x less weight memory at rest.
- **w8a8**: activation-quantized int8 (serve/quant.py): a calibration
  artifact (or a held-out sample to fit one) gives each plain convolution
  and linear an input scale; each runs int8 x int8 -> int32 with one f32
  rescale, in f32 between layers as JAX's. `int8_compute` picks true int8
  products (the card's default) or the scaled-integer emulation (the
  CPU's), and says which ran.

The quantized tiers serve a copy of the encoder whose quantized layers
hold int8 tensors (`module`); the caller's encoder is left as it was. The
JAX engine audits buffer donation; nothing is donated here, so instead the
engine checks once per bucket that its int8 tensors are unchanged after a
call: the same storage, the same checksum (`int8_audit`). The encoder is a
ResNet or a ViT: `channels_last` reorders only 4-D tensors (the
convolutions, a ViT's patch embedding), never a Linear's weight. A ViT
serves `w8`; its attention projections are never calibrated (quant.py), so
`w8a8` refuses it as JAX's does.

Request tracing: `embed`, `embed_and_query` and `embed_and_query_modes`
take `stages`, a dict they add `engine_execute` and `index_query` seconds
to. Timing a stage waits for the card inside its window (the forward's
stream after the encoder; the index query returns host arrays), so the
split is honest under asynchronous launches; that wait is the tracing
cost. Each chunk's forward is a `serve_embed` span and each query a
`serve_query` span, and `slow@site=serve.engine_execute` sleeps inside
the engine stage. `warm_bucket` runs one bucket's forward outside those
hooks, for a thread's own warm-up pass (serve/server.py).

`load_serving_encoder` reads a pretraining checkpoint for serving: its key
(EMA) encoder and its queue, which `EmbeddingIndex.from_train_queue` turns
into the index `/neighbors` answers from.
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moco_tpu_torch.data.augment import eval_stats, normalize
from moco_tpu_torch.lincls import restore_pretrain_state
from moco_tpu_torch.obs.trace import span as obs_span
from moco_tpu_torch.ops.losses import l2_normalize
from moco_tpu_torch.serve import quant as quant_mod
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.device import resolve_device

DEFAULT_BUCKETS = (1, 8, 32, 128)


class EngineRecompileError(RuntimeError):
    """A batch shape arrived after warmup that is not one of the buckets."""


def _compact(s: np.ndarray) -> np.ndarray:
    """`s` with every axis it is constant along cut to length 1: the
    smallest array that broadcasts back to it."""
    for axis in range(s.ndim):
        first = np.take(s, [0], axis=axis)
        if np.array_equal(np.broadcast_to(first, s.shape), s):
            s = first
    return s


def quantize_params_int8(module: nn.Module) -> tuple[dict, dict]:
    """Weight-only int8 PTQ of `module`'s parameters, JAX's
    `quantize_params_int8` on the same weights: in the Flax layout
    (`quant.to_flax`), every floating leaf of two or more dimensions gets
    symmetric scales over all but its last axis (`s = max|w| / 127`, 1
    where that is 0) and int8 values `clip(round(w / s), -127, 127)`;
    biases, BN parameters and other 1-D leaves pass through. Returns
    (qparams, qscales) by parameter name in the module's own layout: an
    int8 tensor and a float32 scale that broadcasts against it (per output
    channel for a convolution or a linear), or the f32 tensor and a scalar
    1. For a ViT the attention projections keep JAX's grouping (per head
    dimension), their 2-D Flax biases included."""
    like = {n: p.detach().cpu().numpy().astype(np.float32) for n, p in module.named_parameters()}
    flat = quant_mod.flatten(quant_mod.to_flax(like, quant_mod._num_heads(module)))
    q_flat, s_flat = {}, {}
    for path, leaf in flat.items():
        leaf = np.asarray(leaf, np.float32)
        if leaf.ndim >= 2:
            s = np.max(np.abs(leaf), axis=tuple(range(leaf.ndim - 1)), keepdims=True) / np.float32(127.0)
            s = np.where(s <= 0, np.float32(1.0), s).astype(np.float32)
            q_flat[path] = np.clip(np.round(leaf / s), -127, 127)
            s_flat[path] = np.broadcast_to(s, leaf.shape)
        else:
            q_flat[path] = s_flat[path] = None
    # back to the module's layout; pass-through leaves carry their own values
    marks = {path: (q if q is not None else flat[path]) for path, q in q_flat.items()}
    q_sd = quant_mod.from_flax(quant_mod.unflatten(marks), like)
    s_sd = quant_mod.from_flax(quant_mod.unflatten(
        {path: (s if s is not None else np.ones(np.shape(flat[path]), np.float32))
         for path, s in s_flat.items()}), like)
    quantized = {n for n, (path, _) in quant_mod.flax_leaves(module).items()
                 if q_flat[path] is not None}
    qparams, qscales = {}, {}
    for name, p in module.named_parameters():
        if name in quantized:
            qparams[name] = torch.from_numpy(q_sd[name].astype(np.int8))
            qscales[name] = torch.from_numpy(_compact(s_sd[name]).copy())
        else:
            qparams[name] = p.detach().float().cpu().clone()
            qscales[name] = torch.ones((), dtype=torch.float32)
    return qparams, qscales


def dequantize_params(qparams: dict, qscales: dict) -> dict:
    """The inverse of `quantize_params_int8`: int8 tensors rescale to f32,
    pass-through tensors come back as they are."""
    return {n: (q.float() * qscales[n] if q.dtype == torch.int8 else q)
            for n, q in qparams.items()}


class _W8Layer(nn.Module):
    """A convolution's or a linear's weight (and, for a ViT's attention
    projection, bias) held int8 with its scale, dequantized into each
    forward (the w8 tier)."""

    def __init__(self, layer, qparams: dict, qscales: dict, name: str):
        super().__init__()
        for leaf in ("weight", "bias"):
            key = f"{name}.{leaf}" if name else leaf
            q = qparams.get(key)
            if q is not None and q.dtype == torch.int8:
                self.register_buffer(f"{leaf}_int8", q.clone())
                self.register_buffer(f"{leaf}_scale", qscales[key].clone())
                self.register_buffer(leaf, None)
            else:
                t = getattr(layer, leaf)
                self.register_buffer(leaf, None if t is None else t.detach().float().clone())

    def _dq(self, leaf: str):
        q = getattr(self, f"{leaf}_int8", None)
        return getattr(self, leaf) if q is None else q.float() * getattr(self, f"{leaf}_scale")


class W8Conv2d(_W8Layer):
    def __init__(self, conv: nn.Conv2d, qparams, qscales, name):
        super().__init__(conv, qparams, qscales, name)
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.groups = conv.groups
        if conv.padding_mode != "zeros":
            raise ValueError(f"{name}: padding_mode {conv.padding_mode!r} is not served in w8")

    def forward(self, x):
        return F.conv2d(x, self._dq("weight"), self._dq("bias"), self.stride, self.padding,
                        self.dilation, self.groups)


class W8Linear(_W8Layer):
    def forward(self, x):
        return F.linear(x, self._dq("weight"), self._dq("bias"))


def w8_copy(module: nn.Module, qparams: dict, qscales: dict) -> nn.Module:
    """A copy of `module` whose int8-quantized convolutions and linears
    are `W8Conv2d` / `W8Linear`; any other quantized parameter (a ViT's
    cls token) takes its dequantized value, as JAX's forward reads it."""
    out = copy.deepcopy(module)
    for name, mod in list(out.named_modules()):
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            weight = f"{name}.weight" if name else "weight"
            if qparams[weight].dtype == torch.int8:
                new = (W8Conv2d if isinstance(mod, nn.Conv2d) else W8Linear)(
                    mod, qparams, qscales, name)
                parent, _, leaf = name.rpartition(".")
                setattr(out.get_submodule(parent) if parent else out, leaf, new)
    dq = dequantize_params(qparams, qscales)
    with torch.no_grad():
        for name, p in out.named_parameters():
            if qparams[name].dtype == torch.int8:
                p.copy_(dq[name])
    return out


def _checksum(t: torch.Tensor) -> int:
    """A position-weighted sum of an int8 tensor's values: a moved, changed
    or swapped element changes it."""
    flat = t.reshape(-1).to(torch.int64)
    weights = torch.arange(flat.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return int((flat * weights).sum())


def load_serving_encoder(workdir: str, config=None, side: str = "k", device="cuda"):
    """(encoder, queue, queue_ptr, config) for serving from the newest good
    pretraining checkpoint under `workdir`, the counterpart of
    `moco_tpu/serve/engine.py:129`: the whole encoder of `side` (the key,
    EMA side by default; backbone and head, so embeddings live in the
    queue's space) on `device` in eval mode, the queue's (K, dim) f32 rows
    on the CPU and its pointer, and the config (the checkpoint's unless
    given), through the eval side's shared restore
    (`lincls.restore_pretrain_state`). The serving dtype is the engine's
    choice, not the checkpoint's.

    A queue-free (v3) checkpoint gives `queue=None`, where JAX gives its
    one-row placeholder: the port's v3 state keeps no queue, so its
    checkpoint has none to return."""
    if side not in ("q", "k"):
        raise ValueError(f"side must be 'q' or 'k', got {side!r}")
    restored = restore_pretrain_state(workdir, config, sides=(side,), device=device)
    return restored.encoders[side], restored.queue, restored.queue_ptr, restored.config


class InferenceEngine:
    """`embed` (and `embed_and_query*` against an `EmbeddingIndex`) over
    (n, H, W, 3) uint8 batches. `module` is an eval-ready encoder with its
    weights loaded (e.g. `build_encoder` + `encoder_from_flax`); tier off
    moves it to `device` in `channels_last`, the quantized tiers serve a
    copy of it (module docstring). `dtype` is the compute dtype of tiers
    off and w8: bf16 by default on the card, f32 on the CPU; w8a8 runs f32
    between its int8 layers. The quantization arguments and their errors
    are JAX's (`moco_tpu/serve/engine.py:205-256`)."""

    def __init__(
        self,
        module: nn.Module,
        image_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
        int8: bool = False,
        engine_quant: Optional[str] = None,
        calibration: Optional[dict] = None,
        calib_sample: Optional[np.ndarray] = None,
        int8_compute: Optional[bool] = None,
    ):
        if not buckets or len(set(int(b) for b in buckets)) != len(buckets):
            raise ValueError(f"buckets must be unique and non-empty, got {buckets}")
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.image_size = int(image_size)
        # tier resolution: engine_quant wins; int8=True is JAX's spelling of "w8"
        if engine_quant is None:
            engine_quant = "w8" if int8 else "off"
        if engine_quant not in quant_mod.QUANT_MODES:
            raise ValueError(
                f"engine_quant must be one of {quant_mod.QUANT_MODES}, got {engine_quant!r}"
            )
        self.quant = engine_quant
        self.int8 = engine_quant != "off"  # the serve/int8 gauge
        self.int8_compute = (quant_mod.default_int8_compute(self.device)
                             if int8_compute is None else bool(int8_compute))
        self.calibration: Optional[dict] = None
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if self.quant == "off":
            self.module = module.to(self.device, memory_format=torch.channels_last).eval()
        else:
            # the copy is quantized; the caller's encoder is left as it was
            encoder = copy.deepcopy(module).to(self.device).eval()
            qparams, qscales = quantize_params_int8(encoder)
            if self.quant == "w8":
                served = w8_copy(encoder, qparams, qscales)
            else:
                if calibration is None:
                    if calib_sample is None:
                        raise ValueError(
                            "engine_quant='w8a8' needs a calibration artifact "
                            "(calibration=...) or a held-out sample (calib_sample=...)"
                        )
                    calibration = quant_mod.calibrate_encoder(encoder, calib_sample,
                                                              self.image_size)
                quant_mod.validate_calibration(calibration, encoder, self.image_size)
                self.calibration = calibration
                served = quant_mod.quantized_copy(
                    encoder, qparams, qscales, quant_mod.activation_scales(calibration),
                    self.int8_compute)
                dtype = torch.float32  # f32 between the int8 layers, as JAX's
            del encoder
            self.module = served.to(self.device, memory_format=torch.channels_last).eval()
        self.dtype = dtype
        # the int8 tensors at rest and their (storage, checksum) at build
        self._int8 = [b for b in self.module.buffers() if b.dtype == torch.int8]
        self._int8_marks = [(b.data_ptr(), _checksum(b)) for b in self._int8]
        self._int8_audit: dict[int, bool] = {}
        self._mean, self._std = eval_stats(self.image_size)
        self._frozen = False
        self.prepares = 0
        self._prepared: set = set()
        self._warm_prepares: Optional[int] = None

    @property
    def int8_bytes(self) -> dict:
        """Bytes at rest of the quantized layers' tensors: `int8` (the int8
        weights), `scales` (their f32 scales and rescales) and `f32` (the
        same weights in f32). Zeros on tier off."""
        int8 = sum(b.numel() for b in self._int8)
        scales = sum(b.numel() * b.element_size() for name, b in self.module.named_buffers()
                     if b.dtype == torch.float32 and name.rsplit(".", 1)[-1] in (
                         "weight_scale", "bias_scale", "w_scale", "a_scale", "scale"))
        return {"int8": int8, "scales": scales, "f32": 4 * int8}

    def int8_audit(self) -> dict:
        """{bucket: True} once a bucket has run with every int8 tensor at its
        build-time storage and checksum after the call, False where one
        moved or changed; empty on tier off."""
        return dict(self._int8_audit)

    # -- buckets ---------------------------------------------------------

    def _prepare(self, bucket: int) -> None:
        if self._frozen:
            raise EngineRecompileError(
                f"batch bucket {bucket} was not prepared and the engine is warm — "
                f"pad requests to a bucket {self.buckets} instead"
            )
        self._prepared.add(bucket)
        self.prepares += 1

    def warmup(self) -> None:
        """Run every bucket once, wait for the device, and freeze."""
        for b in self.buckets:
            self._run_bucket(np.zeros((b, self.image_size, self.image_size, 3), np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._frozen = True
        self._warm_prepares = self.prepares

    @property
    def recompiles_after_warmup(self) -> int:
        if self._warm_prepares is None:
            return 0
        return self.prepares - self._warm_prepares

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding n rows (n <= max bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds the largest bucket {self.buckets[-1]}")

    # -- execution -------------------------------------------------------

    @torch.no_grad()
    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) uint8 on the device -> (b, dim) f32 unit rows."""
        x = normalize(raw.float() / 255.0, self._mean, self._std)
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            feats = self.module(x)
        return l2_normalize(feats.float())

    def _run_bucket(self, padded: np.ndarray) -> torch.Tensor:
        """One forward on an exactly-bucket-shaped uint8 batch; the result
        stays on the device. A quantized tier's first call of a bucket
        checks its int8 tensors after the call (`int8_audit`)."""
        # the request trace's engine_execute stage
        # (slow@site=serve.engine_execute)
        faults.maybe_slow("serve.engine_execute")
        bucket = padded.shape[0]
        if bucket not in self._prepared:
            self._prepare(bucket)
        raw = torch.from_numpy(padded).to(self.device)
        out = self.forward(raw)
        if self._int8 and bucket not in self._int8_audit:
            self._int8_audit[bucket] = all(
                (b.data_ptr(), _checksum(b)) == mark
                for b, mark in zip(self._int8, self._int8_marks))
        return out

    def warm_bucket(self, bucket: int) -> torch.Tensor:
        """One forward of a prepared `bucket` of zeros on the calling thread,
        waited on: a thread's own warm-up pass (the serving batcher's), which
        prepares nothing and passes no fault hook. Returns the features."""
        if bucket not in self._prepared:
            self._prepare(bucket)
        raw = torch.zeros((bucket, self.image_size, self.image_size, 3), dtype=torch.uint8,
                          device=self.device)
        feats = self.forward(raw)
        if feats.is_cuda:
            torch.cuda.current_stream(feats.device).synchronize()
        return feats

    def _padded_chunks(self, images: np.ndarray):
        """Yield (padded_uint8, valid_rows, bucket): chunk at the largest
        bucket, pad each chunk with zero rows to its bucket."""
        images = np.asarray(images, np.uint8)
        if images.ndim != 4 or images.shape[1:] != (self.image_size, self.image_size, 3):
            raise ValueError(
                f"expected (n, {self.image_size}, {self.image_size}, 3) uint8, "
                f"got {images.shape}"
            )
        max_b = self.buckets[-1]
        for start in range(0, images.shape[0], max_b):
            chunk = images[start : start + max_b]
            bucket = self.bucket_for(chunk.shape[0])
            padded = chunk
            if bucket != chunk.shape[0]:
                padded = np.zeros((bucket,) + chunk.shape[1:], np.uint8)
                padded[: chunk.shape[0]] = chunk
            yield padded, chunk.shape[0], bucket

    def _forward_stage(self, padded: np.ndarray, n: int, bucket: int,
                       stages: Optional[dict]) -> torch.Tensor:
        """One chunk's forward in its `serve_embed` span; with `stages`, the
        card is waited on inside the engine_execute window."""
        with obs_span("serve_embed", bucket=bucket, valid=n):
            if stages is None:
                return self._run_bucket(padded)
            t0 = time.perf_counter()
            feats = self._run_bucket(padded)
            if feats.is_cuda:
                torch.cuda.current_stream(feats.device).synchronize()
            stages["engine_execute"] = (stages.get("engine_execute", 0.0)
                                        + time.perf_counter() - t0)
            return feats

    def embed(self, images: np.ndarray, stages: Optional[dict] = None
              ) -> tuple[np.ndarray, list[Tuple[int, int]]]:
        """L2-normalized (n, dim) f32 embeddings of an (n, H, W, 3) uint8
        batch, plus the executed (bucket, valid_rows) pairs. Padding rows
        are sliced away before anything downstream sees them. `stages`: the
        request trace's seconds (module docstring)."""
        outs, executed = [], []
        for padded, n, bucket in self._padded_chunks(images):
            outs.append(self._forward_stage(padded, n, bucket, stages)[:n].cpu().numpy())
            executed.append((bucket, n))
        return np.concatenate(outs), executed

    def embed_and_query(self, images: np.ndarray, index, k: int,
                        stages: Optional[dict] = None):
        """(embeddings, scores, indices, executed) against the exact tier."""
        emb, per_mode, executed = self.embed_and_query_modes(images, index, k, stages=stages)
        scores, idx = per_mode["exact"]
        return emb, scores, idx, executed

    def embed_and_query_modes(
        self,
        images: np.ndarray,
        index,
        k: int,
        modes: Sequence[str] = ("exact",),
        nprobe: Optional[int] = None,
        stages: Optional[dict] = None,
    ) -> tuple[np.ndarray, dict, list[Tuple[int, int]]]:
        """(embeddings, {mode: (scores, indices)}, executed): one forward
        per padded chunk, then one index query per requested tier on the
        same device features, at the padded bucket shape the index was
        prepared for; padding rows' results are sliced away. `stages`: the
        request trace's engine_execute / index_query seconds."""
        outs, executed = [], []
        per_mode: dict = {mode: ([], []) for mode in modes}
        for padded, n, bucket in self._padded_chunks(images):
            feats = self._forward_stage(padded, n, bucket, stages)  # (bucket, dim), device
            for mode in modes:
                with obs_span("serve_query", bucket=bucket, k=k, mode=mode):
                    t0 = time.perf_counter()
                    scores, idx = index.query(feats, k, mode=mode, nprobe=nprobe)  # host arrays
                    if stages is not None:
                        stages["index_query"] = (stages.get("index_query", 0.0)
                                                 + time.perf_counter() - t0)
                per_mode[mode][0].append(scores[:n])
                per_mode[mode][1].append(idx[:n])
            outs.append(feats[:n].cpu().numpy())
            executed.append((bucket, n))
        return (
            np.concatenate(outs),
            {m: (np.concatenate(s), np.concatenate(i)) for m, (s, i) in per_mode.items()},
            executed,
        )


__all__ = [
    "DEFAULT_BUCKETS",
    "EngineRecompileError",
    "InferenceEngine",
    "W8Conv2d",
    "W8Linear",
    "dequantize_params",
    "load_serving_encoder",
    "quantize_params_int8",
    "w8_copy",
]
