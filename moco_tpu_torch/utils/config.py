"""The part of moco_tpu/utils/config.py that the port runs: serving,
MoCo v1/v2 training (with every BatchNorm mode, Shuffle-BN on one device
and across ranks, SyncBN with its subgroups, the EMAN key forward, remat,
SGD or LARS, and `auto_scale`) and MoCo v3 training of a ViT, on one GPU or
data-parallel over `ParallelConfig.num_data` ranks (one process per GPU),
the driver's checkpoint (async writes included), log, kNN,
non-finite-guard, watchdog, health-gauge, alert, heartbeat and fleet
fields, the telemetry fields (`sinks`, `metrics_port`, `metrics_host`,
`obs_probe_every`), and the linear probe's `ProbeConfig`. Same field
names, defaults and presets, so a preset means the same model and recipe
in both packages; `workdir` alone differs: None (write nothing, resume
nothing) instead of a fixed path. `ParallelConfig.timeout_s` (the process
group's timeout) is the port's own: JAX's runtime has no such group.

`bn_stats_barrier` is validated as in JAX (it needs `bn_stats_rows`) and
has no effect here: it fences a slice against an XLA fusion on the TPU,
and eager PyTorch fuses nothing to fence.

ZeRO (`ParallelConfig.shard_weight_update`, `zero_stage`, `zero_bucket_mb`,
`zero_overlap_gather`, `zero_layer_granular`; parallel/zero.py) has JAX's
fields, defaults and refusals (`validate_zero`, with JAX's messages), and
the preset `vit_b16_v3_huge_batch_zero3` is here.

The model axis (`ParallelConfig.num_model`; parallel/mesh.py) is here with
the two features that run on it: the v1/v2 queue sharded over the model
ranks (core/moco.py) and, with `MocoConfig.vit_sequence_parallel`, the
ViT's tokens sharded over them with ring attention
(parallel/ring_attention.py); so is the preset `vit_b16_v3_highres_sp`.
ZeRO composes with it as in JAX: the state is sharded over the data axis
only, and the model ranks of a data index hold the same shards.

Elastic training (`TrainConfig.elastic`, parallel/elastic.py) is JAX's
field with its refusal (`validate_elastic`) and its anchor: without
`auto_scale` an elastic run's reference batch is its own global batch
(`elastic_reference`), so a rescale derives lr and momentum from the
pre-loss recipe.

The analysis's runtime arms have JAX's fields and defaults:
`strict_tracing` with `recompile_warmup_steps` (the port counts its
CUDA-graph captures, analysis/runtime.py), `sanitize_collectives` and
`sanitize_threads`.

Fields of the JAX config that the port does not take are left out, so a
config that asks for one fails at construction with a TypeError instead
of being ignored: `prefetch_donate` (it recycles a consumed staging slot's
device buffer through XLA's donation, and PyTorch's caching allocator
already reuses that memory), `on_device_augment` (the port always augments
on the device) and `fused_block_k`, the TPU kernel's tile (see
`fused_infonce`).
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
    # BN decorrelation: 'gather_perm' (the reference's Shuffle-BN), 'a2a'
    # (balanced permutation), 'syncbn', 'none'. On one device the key batch
    # is permuted only with bn_virtual_groups > 1 (the JAX step's
    # `shuffle_active`): gather_perm as one in-batch permutation, a2a as
    # its two local ones (parallel/shuffle.py).
    shuffle: str = "gather_perm"
    # With shuffle='syncbn': 0 = statistics over the whole data group, else
    # over subgroups of this many consecutive ranks (JAX's
    # axis_index_groups; the detection configs' per-8-GPU statistics).
    syncbn_group_size: int = 0
    # Training BN statistics from the first N rows of the batch (0 = all).
    bn_stats_rows: int = 0
    # With bn_stats_rows: JAX's fusion barrier around the subset slice, a
    # TPU compile workaround, numerically identical; validated, no effect
    # here (see the module docstring).
    bn_stats_barrier: bool = False
    # Virtual Shuffle-BN: per-group BN statistics over G contiguous
    # row-groups, and the key batch permuted in-batch, the reference's
    # G-GPU recipe on one device. 0 = off.
    bn_virtual_groups: int = 0
    # Lets shuffle='none' compose with bn_virtual_groups / bn_stats_rows
    # (the leak demonstration); never set in a training recipe.
    allow_leaky_bn: bool = False
    # Momentum-statistics BN ("Momentum² Teacher", arXiv:2101.07525): each
    # training BN normalizes with, and stores, m * running + (1 - m) * batch.
    bn_momentum_stats: bool = False
    # The EMAN key forward (arXiv:2101.08482): eval-mode BN in the key
    # encoder, whose running statistics trail the query encoder's on the
    # parameters' momentum schedule. Needs shuffle 'none' or 'syncbn'; v1/v2.
    key_bn_running_stats: bool = False
    # With key_bn_running_stats: that momentum capped at (1+s)/(10+s).
    key_bn_stats_warmup: bool = True
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
    # ViT feature pooling: "cls" (v3's) or "gap" (global average pool,
    # which sequence parallelism needs).
    vit_pool: str = "cls"
    # Sequence parallelism for the ViT: the tokens are sharded over the
    # model ranks (ParallelConfig.num_model) and attention runs as ring
    # attention across them. Needs v3, gap pooling and tokens divisible by
    # num_model.
    vit_sequence_parallel: bool = False
    # Recompute the query encoder's forward in the backward
    # (torch.utils.checkpoint), leaving the BN buffers as the first forward
    # left them: less activation memory for more FLOPs.
    remat: bool = False

    def __post_init__(self):
        if self.shuffle not in SHUFFLES:
            raise ValueError(f"shuffle must be one of {SHUFFLES}, got {self.shuffle!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype!r}")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "sgd"  # sgd | lars | adamw
    lr: float = 0.03
    momentum: float = 0.9
    weight_decay: float = 1e-4
    cos: bool = False  # cosine schedule (--cos)
    schedule: Tuple[int, ...] = (120, 160)  # step-decay epochs (--schedule)
    warmup_epochs: int = 0
    epochs: int = 200
    # LARS's trust coefficient (the large-batch preset)
    trust_coefficient: float = 0.001


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
class ParallelConfig:
    # Data-parallel ranks, one process per GPU (torchrun's WORLD_SIZE).
    # None = every rank of the launch; a number must equal the world's size.
    num_data: Optional[int] = None
    # Model ranks per data rank: the v1/v2 queue's rows (and its logits),
    # or under vit_sequence_parallel the ViT's tokens, are sharded over
    # them. The launch has num_data * num_model ranks.
    num_model: int = 1
    # Seconds a collective may wait for its peers before the process group
    # fails the rank (a dead peer ends a survivor within this).
    timeout_s: float = 600.0
    # Sharded weight update (ZeRO over the data ranks, parallel/zero.py):
    # the optimizer state and update are sharded 1/n per rank, through a
    # reduce-scatter of the gradients and an all-gather of the parameters.
    # Elementwise optimizers only (sgd, adamw).
    shard_weight_update: bool = False
    # 1 = sharded optimizer state only, the parameters gathered in every
    # step; 2 and 3 (one implementation) = the query, key and predictor
    # parameters persist between steps as shards too, the key EMA runs on
    # the shards, and the training loop issues step k+1's gather right after step k.
    zero_stage: int = 1
    # Fusion-bucket size of the stage-2/3 collectives: leaves pack into
    # about this many MB of shard payload per all-gather / reduce-scatter.
    zero_bucket_mb: float = 4.0
    # Hoist the stage-2/3 gather of step k+1 under step k (default); False
    # runs gather and step inline (no overlap/zero gauge then).
    zero_overlap_gather: bool = True
    # Layer-granular stage 2/3: each layer group's parameters are gathered
    # just in time and freed after its forward / backward, so the transient
    # model memory drops from the whole tree to about two adjacent groups.
    # Needs zero_stage >= 2; the checkpoint layout is the same.
    zero_layer_granular: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    moco: MocoConfig = dataclasses.field(default_factory=MocoConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
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
    # Overlap checkpoint writes with training: the save returns once the
    # state is copied to host memory, and the write runs on a background
    # thread. The emergency (preemption, stall, alert) saves still block
    # until the file is durable.
    checkpoint_async: bool = False
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
    # Stall watchdog (utils/watchdog.py): seconds without a finished step
    # before the process dumps every thread's stack to
    # <workdir>/stall_stacks.txt, saves the last finite log step's state and
    # exits with code 42. 0 disables. Must exceed the longest gap between
    # steps (an epoch's end: kNN, checkpoint); the first step gets 900 s.
    watchdog_timeout: float = 0.0
    # Strict tracing (analysis/runtime.py, --strict-tracing): the run's
    # CUDA-graph captures (the augment's, one per batch shape) as
    # `compile_cache_misses` on every metrics line, and an abort
    # (RecompileError, after an event line) on a capture after
    # `recompile_warmup_steps`. Checked on log steps only.
    strict_tracing: bool = False
    # Steps during which captures are free; one after them aborts under
    # strict_tracing.
    recompile_warmup_steps: int = 8
    # Collective-schedule sanitizer (analysis/sanitizer.py,
    # --sanitize-collectives): every comms-ledger site records (site, kind,
    # operand signature) into this rank's schedule; on log steps the
    # schedule's hash is published to <workdir>/schedule.p<rank>.json and
    # checked against every peer's. A mismatch writes schedule_diff.json and
    # aborts (ScheduleDivergenceError) before the ranks deadlock in the
    # mismatched collective. Needs a workdir.
    sanitize_collectives: bool = False
    # Lock-order sanitizer (analysis/tsan.py, --sanitize-threads): every
    # utils/locks.py lock reports its acquisition order; an order cycle
    # aborts (LockOrderError) with both stacks in lock_order_diff.json, and
    # blocking calls under a held lock are recorded in lock_order.json at
    # the run's end. The profile hook costs host time.
    sanitize_threads: bool = False
    # The health gauges computed in the step (obs/health.py: EMA drift,
    # logit statistics, collapse, queue age), on every training line.
    health_metrics: bool = True
    # Metric sinks (obs/sinks.py registry), a comma list of "jsonl", "csv",
    # "tensorboard"; the JSONL sink is always included.
    sinks: str = "jsonl"
    # Prometheus text format on http://<metrics_host>:<metrics_port>/metrics
    # (an in-process daemon thread) while the run goes; 0 = off.
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"
    # The fleet aggregate (obs/fleet.py): every rank's stats vector gathered
    # on log steps, min / mean / max / argmax and straggler_skew on rank 0's
    # metrics line.
    fleet_metrics: bool = True
    # Step-time probe (obs/stepstats.py): every N steps the loop waits on
    # the card after the step's dispatch, splitting host dispatch from
    # device time (t_dispatch / t_device on the next training line); the
    # other steps stay in flight. 0 = never (t_data / t_step still logged).
    obs_probe_every: int = 50
    # In-stream alert rules over every logged payload (obs/alerts.py
    # grammar): "default" = the built-in set, "default,<spec>" extends it,
    # "none" disables. A fire writes <workdir>/alerts.jsonl and an `alert`
    # event line.
    alert_rules: str = "default"
    # Abort on any fired alert (FatalAlertError) after an emergency
    # checkpoint of the last finite log step's state.
    alerts_fatal: bool = False
    # Elastic training (parallel/elastic.py): when another rank's heartbeat
    # goes stale (or a collective with it fails), the survivors agree on
    # the loss through files, the lowest surviving rank saves the guard's
    # snapshot, writes a `rescale` event line, and every survivor exits
    # with RESCALE_EXIT_CODE, printing the width and batch to relaunch at
    # (the resume re-derives lr and momentum through auto_scale).
    # Requires num_model == 1.
    elastic: bool = False
    # Seconds after which another process's heartbeat file counts as
    # stale (the default rules' heartbeat_loss, and the elastic trigger).
    heartbeat_timeout: float = 120.0
    # Batch scaling, "ref_batch=N": optim.lr and moco.momentum are the
    # values at global batch N, and the live ones follow from the actual
    # batch with kappa = global_batch / N: lr * kappa, momentum ** kappa
    # (`apply_auto_scale`). "" = off.
    auto_scale: str = ""

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
    "imagenet100_v2": TrainConfig(
        moco=_v2(MocoConfig()),
        optim=OptimConfig(lr=0.03, epochs=200, cos=True),
        data=DataConfig(dataset="imagefolder", aug_plus=True),
    ),
    "imagenet_v2": TrainConfig(
        moco=_v2(MocoConfig()),
        optim=OptimConfig(lr=0.03, epochs=200, cos=True),
        data=DataConfig(dataset="imagefolder", aug_plus=True),
    ),
    # Large batch with LARS, declared at its 4096 reference and run at
    # 8192 through auto_scale (kappa = 2: lr x 2, momentum ** 2), with
    # momentum-statistics BN in place of cross-replica statistics.
    "imagenet_v2_large_batch": TrainConfig(
        moco=_v2(MocoConfig(), bn_momentum_stats=True),
        optim=OptimConfig(
            optimizer="lars", lr=4.8, weight_decay=1e-6, epochs=200, cos=True, warmup_epochs=10
        ),
        data=DataConfig(dataset="imagefolder", aug_plus=True, global_batch=8192),
        auto_scale="ref_batch=4096",
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
    # Huge-batch v3 on the layer-granular ZeRO-3 memory budget: the
    # vit_b16_v3 recipe declared at its 4096 reference batch, run at 8192
    # through auto_scale (kappa = 2), the parameters and optimizer state
    # sharded and gathered one layer group at a time. AdamW is elementwise,
    # so the sharded update is eligible (LARS is not).
    "vit_b16_v3_huge_batch_zero3": TrainConfig(
        moco=MocoConfig(
            arch="vit_b16", dim=256, num_negatives=0, momentum=0.99,
            momentum_cos=True, temperature=0.2, v3=True, shuffle="none",
        ),
        optim=OptimConfig(
            optimizer="adamw", lr=2.4e-3, weight_decay=0.1, epochs=300,
            cos=True, warmup_epochs=40,
        ),
        data=DataConfig(dataset="imagefolder", aug_plus=True, global_batch=8192),
        parallel=ParallelConfig(shard_weight_update=True, zero_stage=3,
                                zero_layer_granular=True),
        auto_scale="ref_batch=4096",
    ),
    # Long sequences: 448 px inputs give ViT-B/16 784 tokens, sharded over
    # a model axis of 8 with ring attention (gap pooling, --num-model 8);
    # lr is the v3 rule 1.5e-4 * batch / 256 at this preset's batch of 1024.
    "vit_b16_v3_highres_sp": TrainConfig(
        moco=MocoConfig(
            arch="vit_b16", dim=256, num_negatives=0, momentum=0.99,
            momentum_cos=True, temperature=0.2, v3=True, shuffle="none",
            vit_pool="gap", vit_sequence_parallel=True,
        ),
        optim=OptimConfig(
            optimizer="adamw", lr=6e-4, weight_decay=0.1, epochs=300,
            cos=True, warmup_epochs=40,
        ),
        data=DataConfig(
            dataset="imagefolder", aug_plus=True, global_batch=1024, image_size=448
        ),
        parallel=ParallelConfig(num_model=8),
    ),
}


def validate_zero(config: TrainConfig) -> None:
    """JAX's refusals of a ZeRO config (moco_tpu/core/moco.py:497-521,
    :551-562), with its messages: a stage outside {1, 2, 3}, LARS, the
    layer-granular schedule without stage >= 2, with a model axis or with
    sequence parallelism. Stages 1-3 compose with a model axis: the shards
    span the data axis."""
    par = config.parallel
    zero23 = par.shard_weight_update and par.zero_stage >= 2
    if par.shard_weight_update:
        if par.zero_stage not in (1, 2, 3):
            raise ValueError(f"zero_stage must be 1, 2 or 3, got {par.zero_stage}")
        if config.optim.optimizer == "lars":
            raise ValueError("shard_weight_update supports element-wise optimizers only "
                             "(sgd/adamw), not lars")
    if par.zero_layer_granular and not zero23:
        raise ValueError(
            "zero_layer_granular requires shard_weight_update=True with "
            "zero_stage >= 2 (the per-group schedule runs on the persistent "
            "shard layout)"
        )
    if par.zero_layer_granular and par.num_model > 1:
        raise ValueError(
            "zero_layer_granular requires num_model == 1 (the per-group "
            "schedule is a data-axis pipeline; model-axis sharding of the "
            "same params would double-gather)"
        )
    if par.zero_layer_granular and config.moco.vit_sequence_parallel:
        raise ValueError(
            "zero_layer_granular does not compose with vit_sequence_parallel "
            "(the token shard would cross layer-group boundaries)"
        )


def validate_elastic(config: TrainConfig) -> None:
    """JAX's refusal of an elastic run (moco_tpu/train.py:207-208)."""
    if config.elastic and config.parallel.num_model > 1:
        raise ValueError("elastic=True supports num_model=1 meshes only")


def elastic_reference(config: TrainConfig) -> TrainConfig:
    """The reference config of a run: under `elastic` without `auto_scale`,
    the scaling rules anchored at the run's own global batch
    (moco_tpu/train.py:139-146), so that a rescale derives kappa against
    the pre-loss recipe; else `config` itself."""
    if config.elastic and not config.auto_scale:
        return dataclasses.replace(config, auto_scale=f"ref_batch={config.data.global_batch}")
    return config


def parse_auto_scale(spec: str) -> Optional[int]:
    """The `auto_scale` spec ("ref_batch=N", colon-separated key=val as in
    JAX) -> N; None when unset."""
    if not spec:
        return None
    ref_batch: Optional[int] = None
    for tok in spec.split(":"):
        tok = tok.strip()
        if not tok:
            continue
        k, _, v = tok.partition("=")
        if k == "ref_batch":
            ref_batch = int(v)
        else:
            raise ValueError(f"unknown auto-scale param {k!r} in {spec!r}")
    if ref_batch is None or ref_batch <= 0:
        raise ValueError(f"auto-scale spec {spec!r} needs ref_batch=<positive int>")
    return ref_batch


def apply_auto_scale(config: TrainConfig) -> Tuple[TrainConfig, Optional[dict]]:
    """The live config under the batch-scaling rules: kappa = global_batch /
    ref_batch, lr * kappa, EMA momentum ** kappa (the BN momentum is not
    scaled), and the info dict JAX's driver prints; (config, None) without
    a spec. Derives from the values in `config`, so pass the reference
    config each time."""
    ref_batch = parse_auto_scale(config.auto_scale)
    if ref_batch is None:
        return config, None
    kappa = config.data.global_batch / ref_batch
    lr = config.optim.lr * kappa
    momentum = config.moco.momentum**kappa
    derived = dataclasses.replace(
        config,
        optim=dataclasses.replace(config.optim, lr=lr),
        moco=dataclasses.replace(config.moco, momentum=momentum),
    )
    info = {"ref_batch": ref_batch, "kappa": kappa, "lr": lr, "momentum": momentum,
            "ref_lr": config.optim.lr, "ref_momentum": config.moco.momentum}
    return derived, info


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
    top = {f.name for f in dataclasses.fields(TrainConfig)} - {"moco", "optim", "data", "parallel"}
    return TrainConfig(
        moco=dataclass_from_dict(MocoConfig, d.get("moco", {})),
        optim=dataclass_from_dict(OptimConfig, d.get("optim", {})),
        data=dataclass_from_dict(DataConfig, d.get("data", {})),
        parallel=dataclass_from_dict(ParallelConfig, d.get("parallel") or {}),
        **{k: d[k] for k in top if k in d},
    )


class ResumeCompatError(ValueError):
    """The checkpoint being resumed was trained under a structurally
    different config; carries a field-by-field diff."""


# Structural fields a resume must agree on: they fix parameter, optimizer
# state and queue shapes. Tunables (lr, epochs, temperature, recipe) may
# change across a resume on purpose. JAX's list: `num_data` and the ZeRO
# fields are not in it in either package (the port's checkpoint holds whole
# tensors under every layout, so it resumes at any world size and under
# any ZeRO stage: JAX's "compatible but resharded"). `parallel.num_model`
# is, as in JAX, though the port's whole queue could be sliced anew.
RESUME_COMPAT_FIELDS = {
    "moco": ("arch", "dim", "num_negatives", "mlp", "v3", "cifar_stem",
             "vit_pool", "vit_patch_size", "vit_sequence_parallel"),
    "data": ("image_size",),
    "parallel": ("num_model",),
}


def resume_compat_diff(saved_extra: dict, config: TrainConfig,
                       num_data: Optional[int] = None) -> list[str]:
    """Incompatibilities between a checkpoint's saved `extra` (its `config`
    and `num_data`) and the live run; empty = compatible. Fields the saved
    config lacks are skipped, so older checkpoints stay resumable. A
    different `num_data` or ZeRO layout is no incompatibility, as in JAX:
    the checkpoint holds whole tensors, which a load shards into the live
    layout."""
    del num_data
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
