"""Bucketed embedding inference, the counterpart of moco_tpu/serve/engine.py
(tier `engine_quant="off"`).

Requests of any size are chunked at the largest bucket and padded with
zero rows up to the next bucket (default {1, 8, 32, 128}), so the device
only ever sees those batch shapes. `warmup()` runs every bucket once and
freezes the set: afterwards a batch shape outside it raises
`EngineRecompileError`, and `recompiles_after_warmup` stays the gauge
that proves it.

Forward: uint8 NHWC -> /255 -> per-channel normalize (the eval recipe's
statistics) -> encoder -> f32 -> L2-normalize. On the card the encoder
runs in bf16 under `torch.autocast` with f32 weights, as the JAX package
serves in bf16 on accelerators; on the CPU it runs in f32. The encoder is a
ResNet or a ViT: `channels_last` reorders only 4-D tensors (the
convolutions, a ViT's patch embedding), never a Linear's weight.
Whole-model capture (CUDA graphs) is later work.

Request tracing: `embed`, `embed_and_query` and `embed_and_query_modes`
take `stages`, a dict they add `engine_execute` and `index_query` seconds
to. Timing a stage waits for the card inside its window (the forward's
stream after the encoder; the index query returns host arrays), so the
split is honest under asynchronous launches; that wait is the tracing
cost. Each chunk's forward is a `serve_embed` span and each query a
`serve_query` span, and `slow@site=serve.engine_execute` sleeps inside
the engine stage.

`load_serving_encoder` reads a pretraining checkpoint for serving: its key
(EMA) encoder and its queue, which `EmbeddingIndex.from_train_queue` turns
into the index `/neighbors` answers from.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import time

import numpy as np
import torch
from torch import nn

from moco_tpu_torch.data.augment import eval_stats, normalize
from moco_tpu_torch.lincls import restore_pretrain_state
from moco_tpu_torch.obs.trace import span as obs_span
from moco_tpu_torch.ops.losses import l2_normalize
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.device import resolve_device

DEFAULT_BUCKETS = (1, 8, 32, 128)


class EngineRecompileError(RuntimeError):
    """A batch shape arrived after warmup that is not one of the buckets."""


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
    weights loaded (e.g. `build_encoder` + `encoder_from_flax`); the
    engine moves it to `device` in `channels_last`. `dtype` is the compute
    dtype: bf16 by default on the card, f32 on the CPU."""

    def __init__(
        self,
        module: nn.Module,
        image_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ):
        if not buckets or len(set(int(b) for b in buckets)) != len(buckets):
            raise ValueError(f"buckets must be unique and non-empty, got {buckets}")
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.image_size = int(image_size)
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.module = module.to(self.device, memory_format=torch.channels_last).eval()
        self._mean, self._std = eval_stats(self.image_size)
        self._frozen = False
        self.prepares = 0
        self._prepared: set = set()
        self._warm_prepares: Optional[int] = None

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
        stays on the device."""
        # the request trace's engine_execute stage
        # (slow@site=serve.engine_execute)
        faults.maybe_slow("serve.engine_execute")
        bucket = padded.shape[0]
        if bucket not in self._prepared:
            self._prepare(bucket)
        raw = torch.from_numpy(padded).to(self.device)
        return self.forward(raw)

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


__all__ = ["DEFAULT_BUCKETS", "EngineRecompileError", "InferenceEngine", "load_serving_encoder"]
