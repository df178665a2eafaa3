"""MoCo v1/v2 on one device: the encoder, the train state and the train step
(the v1/v2 single-device branch of moco_tpu/core/moco.py).

The JAX step is a pure function over an immutable `MocoState`; here the
state holds modules and tensors that the step updates in place (in-place
EMA and FIFO writes save a copy of the key encoder and of the queue).
The step follows the reference's order (moco_tpu/core/moco.py:1061-1316):

1. EMA of the key encoder's parameters toward the pre-update query
   encoder (:1084-1087);
2. key forward with train-mode BN, which updates the key encoder's
   running statistics, then l2_normalize (:1117-1131);
3. query forward and l2_normalize;
4. the fused loss (:1146-1157) unless `fused_infonce` is False, then
   the dense one (:1158-1168); the fused loss takes any K (the JAX gate
   at :731-758 exists for its Pallas tile, which the CUDA kernels do not
   need);
5. backward and the SGD step (:1250-1258);
6. FIFO enqueue of this step's keys (:1260-1277), after the loss (and its
   backward, which saved the queue) has read the old queue.

One device means no Shuffle-BN collective: the JAX step's
`shuffle_active` is false there, whatever `shuffle` says.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from moco_tpu_torch.core.ema import ema_update
from moco_tpu_torch.core.queue import check_queue_divisibility, enqueue, init_queue
from moco_tpu_torch.models.heads import ProjectionHead
from moco_tpu_torch.models.resnet import create_resnet
from moco_tpu_torch.ops.fused_infonce import fused_infonce_loss
from moco_tpu_torch.ops.losses import cross_entropy, infonce_logits, l2_normalize, topk_accuracy
from moco_tpu_torch.utils.config import MocoConfig, TrainConfig
from moco_tpu_torch.utils.device import resolve_device
from moco_tpu_torch.utils.schedules import build_optimizer, make_lr_schedule


class MoCoEncoder(nn.Module):
    """`head(backbone(x))`: NHWC float images -> (n, dim) float32."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x):
        return self.head(self.backbone(x))


def build_encoder(cfg: MocoConfig, num_filters: int = 64) -> MoCoEncoder:
    """ResNet backbone + Linear (v1) or MLP (v2) head. `num_filters`
    narrows the backbone for tests, as `create_resnet(num_filters=...)`
    does in the JAX package."""
    if cfg.arch.startswith("vit"):
        raise ValueError(f"{cfg.arch!r}: ViT backbones come with the ViT/v3 slice")
    backbone = create_resnet(cfg.arch, num_filters=num_filters, cifar_stem=cfg.cifar_stem)
    return MoCoEncoder(backbone, ProjectionHead(backbone.num_features, cfg.dim, cfg.mlp))


@dataclasses.dataclass
class TrainState:
    """What `MocoState` (moco_tpu/core/moco.py:237) carries for v1/v2: the
    step, both encoders, the queue and its pointer, and the optimizer
    (whose momentum buffers are optax's trace)."""

    step: int
    encoder_q: MoCoEncoder
    encoder_k: MoCoEncoder
    queue: torch.Tensor  # (K, dim) L2-normalized rows
    queue_ptr: int
    optimizer: torch.optim.Optimizer


def create_state(config: TrainConfig, encoder_q: MoCoEncoder, device="cuda",
                 encoder_k: Optional[MoCoEncoder] = None,
                 queue: Optional[torch.Tensor] = None, step: int = 0,
                 queue_ptr: int = 0) -> TrainState:
    """The train state on `device` (moco_tpu/core/moco.py:329): the key
    encoder is a copy of the query encoder with requires_grad=False unless
    one is given; the queue is drawn from a generator on `device` seeded
    with config.seed unless one is given; SGD over every query-encoder
    parameter. Both encoders are kept channels-last."""
    device = resolve_device(device)
    cfg = config.moco
    if cfg.num_negatives <= 0:
        raise ValueError("num_negatives must be > 0: the queue-free v3 step comes with its slice")
    encoder_q = encoder_q.to(device, memory_format=torch.channels_last)
    if encoder_k is None:
        encoder_k = copy.deepcopy(encoder_q)
    encoder_k = encoder_k.to(device, memory_format=torch.channels_last).requires_grad_(False)
    if queue is None:
        generator = torch.Generator(device=device).manual_seed(config.seed)
        queue = init_queue(generator, cfg.num_negatives, cfg.dim, device=device)
    queue = queue.to(device=device, dtype=torch.float32).contiguous()
    if tuple(queue.shape) != (cfg.num_negatives, cfg.dim):
        raise ValueError(f"queue {tuple(queue.shape)} != (K, dim) = {(cfg.num_negatives, cfg.dim)}")
    optimizer = build_optimizer(config.optim, encoder_q.parameters())
    return TrainState(step, encoder_q, encoder_k, queue, int(queue_ptr), optimizer)


def make_train_step(config: TrainConfig, steps_per_epoch: int,
                    device="cuda") -> Callable[[TrainState, dict], dict]:
    """`step(state, batch) -> metrics`: one MoCo v1/v2 step on `device`,
    updating `state` in place. `batch` is {"im_q", "im_k"}, (B, S, S, 3)
    float32 views already augmented, B = config.data.global_batch.
    Metrics: loss, acc1, acc5 (0-dim tensors, not synchronized) and lr.

    Under compute_dtype="bfloat16" the encoders run under autocast while
    the parameters, BN statistics, head output and loss inputs stay
    float32, as in JAX."""
    device = resolve_device(device)
    cfg = config.moco
    global_batch = config.data.global_batch
    check_queue_divisibility(cfg.num_negatives, global_batch)
    schedule = make_lr_schedule(config.optim, steps_per_epoch)
    bf16 = cfg.compute_dtype == "bfloat16"
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # the trainer's shapes are fixed

    def autocast():
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)

    def step(state: TrainState, batch: dict) -> dict:
        im_q, im_k = batch["im_q"], batch["im_k"]
        if im_q.shape[0] != global_batch or im_k.shape[0] != global_batch:
            raise ValueError(f"batch of {im_q.shape[0]} rows, config says {global_batch}")
        # (1) EMA before the key forward, on the pre-update query params
        ema_update(state.encoder_k, state.encoder_q, cfg.momentum)
        # (2) key forward, train-mode BN (its running stats move)
        state.encoder_k.train()
        with torch.no_grad(), autocast():
            k = state.encoder_k(im_k)
        k = l2_normalize(k.float())
        # (3) query forward
        state.encoder_q.train()
        with autocast():
            q = state.encoder_q(im_q)
        q = l2_normalize(q.float())
        # (4) loss in float32 on the old queue
        if cfg.fused_infonce is not False:  # None or True, for any K
            loss, acc = fused_infonce_loss(q, k, state.queue, cfg.temperature)
        else:
            logits, labels = infonce_logits(q, k, state.queue, cfg.temperature)
            loss, acc = cross_entropy(logits, labels), topk_accuracy(logits, labels)
        # (5) backward and SGD at the lr of this step's optimizer count
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        # (6) FIFO enqueue after the loss has read the old queue
        state.queue, state.queue_ptr = enqueue(state.queue, state.queue_ptr, k)
        state.step += 1
        return {"loss": loss.detach(), "acc1": acc["acc1"], "acc5": acc["acc5"], "lr": lr}

    return step
