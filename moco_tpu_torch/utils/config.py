"""The part of moco_tpu/utils/config.py that the port runs: serving,
single-device MoCo v1/v2 training and single-device MoCo v3 training of a
ViT, the driver's checkpoint, log, kNN and non-finite-guard fields, and the
linear probe's `ProbeConfig`. Same field names, defaults and presets, so a
preset means the same model and recipe in both packages; `workdir` alone
differs: None (write nothing, resume nothing) instead of a fixed path.

Fields of the JAX config that the port does not run yet (the BN modes
`syncbn_group_size`, `bn_virtual_groups`, `bn_stats_rows`,
`bn_stats_barrier`, `bn_momentum_stats`, `allow_leaky_bn`,
`key_bn_running_stats`, `key_bn_stats_warmup`, `remat`,
`vit_sequence_parallel`; LARS's `trust_coefficient`; the parallel, ZeRO,
telemetry, watchdog and elastic fields; `checkpoint_async`) are left out,
so a config that asks for one fails at construction with a TypeError
instead of being ignored. So is `prefetch_donate`: it recycles a consumed staging slot's
device buffer through XLA's donation, and PyTorch's caching allocator
already reuses that memory; and `on_device_augment`: the port always
augments on the device. So are `fused_block_k`, the TPU kernel's tile (see
`fused_infonce`), and the presets that need them
(`imagenet_v2_large_batch`, `vit_b16_v3_huge_batch_zero3`,
`vit_b16_v3_highres_sp`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

SHUFFLES = ("gather_perm", "a2a", "syncbn", "none")


@dataclasses.dataclass(frozen=True)
class MocoConfig:
    arch: str = "resnet50"
    dim: int = 128  # --moco-dim
    num_negatives: int = 65536  # --moco-k
    momentum: float = 0.999  # --moco-m
    # Cosine-anneal the EMA momentum from `momentum` to 1.0 over training
    # (moco-v3's --moco-m-cos), in both the v1/v2 and the v3 step.
    momentum_cos: bool = False
    temperature: float = 0.07  # --moco-t (0.2 for the v2 recipe)
    mlp: bool = False  # --mlp (v2)
    # BN decorrelation across devices. On one device every choice computes
    # the same step (the JAX step's `shuffle_active` is false there), which
    # is all the port runs yet.
    shuffle: str = "gather_perm"
    cifar_stem: bool = False
    compute_dtype: str = "bfloat16"
    # False = the dense logits path; anything else = the streaming InfoNCE
    # (ops/fused_infonce.py: the CUDA kernels on the card, their plain
    # versions on the CPU) for any K. None stays the default so a preset
    # equals JAX's field for field; there "auto" hinges on whether the
    # Pallas tile (fused_block_k) divides K, a rule the CUDA kernels, which
    # mask their tail, do not need.
    fused_infonce: Optional[bool] = None
    # MoCo v3 (queue-free symmetric contrastive): set num_negatives=0;
    # v3=True adds the prediction head.
    v3: bool = False
    # v3's stability trick: the ViT patch embedding stays at its init.
    freeze_patch_embed: bool = True
    # The ViT patch size (None = the arch's, 16); small-image tests use 4.
    vit_patch_size: Optional[int] = None
    # ViT attention through the flash kernels (ops/flash_attention.py: the
    # CUDA kernels on the card, their plain versions on the CPU); False is
    # dense attention. The parameters are the same either way.
    vit_flash_attention: bool = False
    # ViT feature pooling: "cls" (v3's) or "gap" (global average pool).
    vit_pool: str = "cls"

    def __post_init__(self):
        if self.shuffle not in SHUFFLES:
            raise ValueError(f"shuffle must be one of {SHUFFLES}, got {self.shuffle!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype!r}")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "sgd"  # sgd | adamw (lars comes with its slice)
    lr: float = 0.03
    momentum: float = 0.9
    weight_decay: float = 1e-4
    cos: bool = False  # cosine schedule (--cos)
    schedule: Tuple[int, ...] = (120, 160)  # step-decay epochs (--schedule)
    warmup_epochs: int = 0
    epochs: int = 200


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"  # synthetic* | cifar10 | imagefolder (data/datasets.py)
    data_dir: Optional[str] = None
    image_size: int = 224
    global_batch: int = 256
    aug_plus: bool = False  # v2 aug recipe (jitter + blur)
    # Geometric-only two-crop recipe (crop + flip + normalize): the BN-leak
    # positive control's setting; overrides aug_plus.
    crops_only: bool = False
    num_workers: int = 4  # host loader threads (and the native loader's)
    # Sample the RandomResizedCrop boxes on the host against each image's
    # original geometry and decode once / crop twice in the loader, for
    # datasets with the host-crop protocol (imagefolder, the RGB cache);
    # the others crop on the device from their decode canvas.
    host_rrc: bool = True
    # Decode-once packed RGB cache (data/cache.py), built on first use.
    cache_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    moco: MocoConfig = dataclasses.field(default_factory=MocoConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    seed: int = 0
    steps_per_epoch: Optional[int] = None  # None = derive from the dataset size
    # The prefetch ring (data/device_prefetch.py): a decode thread and a
    # transfer thread keep `prefetch_depth` batches ready, copied and
    # augmented on a side CUDA stream, while the step runs. False = each
    # batch made serially in the loop before its step.
    device_prefetch: bool = True
    prefetch_depth: int = 2
    # Checkpoints (utils/checkpoint.py), metrics.jsonl and automatic resume
    # live under `workdir`; None runs without any of them.
    workdir: Optional[str] = None
    log_every: int = 10  # --print-freq
    checkpoint_every_epochs: int = 1
    # keep the last N checkpoints; 0 keeps every one (the reference's
    # per-epoch checkpoint_{epoch:04d}.pth.tar)
    checkpoint_keep: int = 3
    # The weighted-kNN monitor on frozen backbone features (knn.py) every N
    # epochs and at the last; 0 disables.
    knn_every_epochs: int = 0
    knn_k: int = 200
    knn_temperature: float = 0.07
    # Non-finite-loss guard, checked on log steps: a NaN/Inf loss rolls the
    # state back to the last finite log step's (the step counter keeps
    # advancing), is written to metrics.jsonl, and the run aborts after
    # this many such steps.
    nan_guard_threshold: int = 10

    def __post_init__(self):
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.log_every < 1 or self.checkpoint_every_epochs < 1:
            raise ValueError("log_every and checkpoint_every_epochs must be >= 1")


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Linear-probe hyperparameters (`main_lincls.py:~L30-95, ~L200-210`):
    SGD(lr=30.0, momentum=0.9, wd=0), step schedule [60, 80], 100 epochs,
    frozen backbone with BN in eval mode."""

    lr: float = 30.0
    momentum: float = 0.9
    weight_decay: float = 0.0
    schedule: Tuple[int, ...] = (60, 80)
    epochs: int = 100
    num_classes: int = 1000


def _v2(moco: MocoConfig, **kw) -> MocoConfig:
    return dataclasses.replace(moco, mlp=True, temperature=0.2, **kw)


PRESETS = {
    "cifar_smoke": TrainConfig(
        moco=MocoConfig(arch="resnet18", num_negatives=4096, cifar_stem=True, shuffle="none"),
        optim=OptimConfig(lr=0.03, epochs=10, cos=True),
        data=DataConfig(dataset="cifar10", image_size=32, global_batch=256),
    ),
    "imagenet_v2": TrainConfig(
        moco=_v2(MocoConfig()),
        optim=OptimConfig(lr=0.03, epochs=200, cos=True),
        data=DataConfig(dataset="imagefolder", aug_plus=True),
    ),
    # MoCo v3 ViT-B/16: queue-free symmetric loss, AdamW with warmup
    # (arXiv:2104.02057's recipe, lr = 1.5e-4 * batch / 256).
    "vit_b16_v3": TrainConfig(
        moco=MocoConfig(
            arch="vit_b16", dim=256, num_negatives=0, momentum=0.99,
            momentum_cos=True, temperature=0.2, v3=True, shuffle="none",
        ),
        optim=OptimConfig(
            optimizer="adamw", lr=2.4e-3, weight_decay=0.1, epochs=300,
            cos=True, warmup_epochs=40,
        ),
        data=DataConfig(dataset="imagefolder", aug_plus=True, global_batch=4096),
    ),
}


def config_to_dict(cfg: TrainConfig) -> dict:
    """JSON-serializable dict (tuples become lists when dumped), stored in
    every checkpoint so the probe and the converters rebuild the model
    without the user re-specifying flags."""
    return dataclasses.asdict(cfg)


def dataclass_from_dict(cls, sub: dict):
    """A config dataclass from checkpointed JSON: unknown keys are dropped
    (a JAX checkpoint's extra fields, fields of later versions) and lists
    become tuples."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in sub:
            v = sub[f.name]
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def config_from_dict(d: dict) -> TrainConfig:
    top = {f.name for f in dataclasses.fields(TrainConfig)} - {"moco", "optim", "data"}
    return TrainConfig(
        moco=dataclass_from_dict(MocoConfig, d.get("moco", {})),
        optim=dataclass_from_dict(OptimConfig, d.get("optim", {})),
        data=dataclass_from_dict(DataConfig, d.get("data", {})),
        **{k: d[k] for k in top if k in d},
    )


class ResumeCompatError(ValueError):
    """The checkpoint being resumed was trained under a structurally
    different config; carries a field-by-field diff."""


# Structural fields a resume must agree on: they fix parameter, optimizer
# state and queue shapes. Tunables (lr, epochs, temperature, recipe) may
# change across a resume on purpose. The JAX list's `parallel` section and
# `vit_sequence_parallel` have no counterpart here.
RESUME_COMPAT_FIELDS = {
    "moco": ("arch", "dim", "num_negatives", "mlp", "v3", "cifar_stem",
             "vit_pool", "vit_patch_size"),
    "data": ("image_size",),
}


def resume_compat_diff(saved_extra: dict, config: TrainConfig) -> list[str]:
    """Incompatibilities between a checkpoint's saved `extra` (its
    `config`) and the live config; empty = compatible. Fields the saved
    config lacks are skipped, so older checkpoints stay resumable."""
    diffs = []
    saved_cfg = saved_extra.get("config") or {}
    live = config_to_dict(config)
    for section, fields in RESUME_COMPAT_FIELDS.items():
        saved_sec = saved_cfg.get(section) or {}
        for f in fields:
            if f not in saved_sec:
                continue
            sv, lv = saved_sec[f], live[section][f]
            if isinstance(lv, tuple):
                lv = list(lv)
            if isinstance(sv, tuple):
                sv = list(sv)
            if sv != lv:
                diffs.append(f"{section}.{f}: checkpoint={sv!r} != config={lv!r}")
    return diffs
