"""MoCo on one device: the encoders, the train state and the train step
(the single-device branches of moco_tpu/core/moco.py: v1/v2 and v3).

The JAX step is a pure function over an immutable `MocoState`; here the
state holds modules and tensors that the step updates in place (in-place
EMA and FIFO writes save a copy of the key encoder and of the queue).

The v1/v2 step follows the reference's order (moco_tpu/core/moco.py:1061-1316):

1. EMA of the key encoder's parameters toward the pre-update query
   encoder (:1084-1087), at `ema_momentum(step)`;
2. key forward with train-mode BN, which updates the key encoder's
   running statistics, then l2_normalize (:1117-1131). With
   `bn_virtual_groups > 1` (`shuffle_active` on one device, :1101) and
   shuffle `gather_perm` or `a2a`, the forward runs on the permuted batch
   and the keys are unshuffled (parallel/shuffle.py), so the loss and the
   queue see them in the batch's order. Under `key_bn_running_stats`
   (EMAN) the key forward runs eval-mode BN instead;
3. query forward and l2_normalize; under `remat` each block of it is
   recomputed in the backward (models/remat.py);
4. the fused loss (:1146-1157) unless `fused_infonce` is False, then
   the dense one (:1158-1168); the fused loss takes any K (the JAX gate
   at :731-758 exists for its Pallas tile, which the CUDA kernels do not
   need);
5. backward and the optimizer step (:1250-1258). Under EMAN the key
   encoder's running statistics then move toward the query encoder's
   updated ones (as the query forward left them) at `ema_momentum(step)`,
   with `key_bn_stats_warmup` capped at (1 + step) / (10 + step)
   (:1204-1214);
6. the health gauges (obs/health.py, :1279-1305) when
   `config.health_metrics`: the positive logits from the (q, k) diagonal,
   the negatives from q against the first min(1024, K) rows of the old
   queue, both over T; `feature_stats` of q; the drift of the updated query
   parameters from the key parameters; the queue's ages at the step count
   before its increment;
7. FIFO enqueue of this step's keys (:1260-1277), after the loss (and its
   backward, which saved the queue) and the gauges have read the old queue.

The v3 step (`v3_step`, :875-1059, the single-device branch without ZeRO):

1. EMA of the key encoder toward the pre-update query encoder (the
   predictor has no key-side twin);
2. key forward in train mode on cat([im_q, im_k]), l2_normalize, split;
3. query forward and predictor on the same concatenation (the head BNs
   take their statistics over all 2B rows, as in JAX);
4. ctr(q1, k2) + ctr(q2, k1), each 2T * CE(q @ k^T / T, arange), and acc
   from q1's logits;
5. backward and the optimizer step. `freeze_patch_embed` keeps the patch
   embedding out of the optimizer with requires_grad=False: no gradient
   and no decoupled weight decay reach it, which is what JAX gets by
   zeroing both its gradient and its update (:953, :1028-1033);
6. the health gauges when `config.health_metrics` (:1035, :1041-1050):
   `logit_stats_from_dense` of the first term's logits, `feature_stats`
   of q1 and the drift of the updated query encoder (not the predictor)
   from the key encoder; no queue gauges.

The step's permutations come from the state's generator, seeded anew
each step from (config.seed, step) as JAX folds the step into its root
key, so a resume or a rollback draws the same ones; a batch may carry its
own (`perm` for gather_perm, `pre` and `post` for a2a), as the parity
tests pass JAX's.

Data parallel (`world`, parallel/mesh.py, n data ranks, one process per
GPU): each rank's batch is its B/n rows of the global batch and the step
is JAX's at `num_data = n` (:875-1316, no ZeRO):

- Shuffle-BN is active when n > 1 or G > 1 (:1101): gather_perm gathers
  the images and the keys (the global keys feed the enqueue), a2a
  exchanges them all-to-all with each rank's local permutations from
  (seed, step, rank) and gathers the keys for the enqueue
  (`queue.enqueue_gather`), as 'syncbn' and 'none' do when n > 1
  (:1097-1131);
- SyncBN: the backbone's BNs average their moments over the data group or
  the rank's subgroup of `syncbn_group_size` (`build_encoder`); v3's heads
  over the data group when n > 1 (:205-232);
- after the backward, the gradients' mean over the data group, one flat
  all-reduce (:1250-1255, :1025-1026); the loss, the accuracies, the BN
  running statistics (:1200-1218, averaged over ranks, not rank 0's as
  under DDP) and the batch-local health gauges (:1300, :1049) are averaged
  too, so every rank takes the same non-finite decision and holds the
  same state;
- v3 gathers both views' keys (:905-908) and offsets its labels by
  rank * local batch (:911).

The InfoNCE and flash kernels run on each rank's local rows. Every
collective site records its analytic bytes in the world's comms ledger
(obs/comms.py) under JAX's site names, also where n = 1 or no process
group exists (0 bytes then), as JAX's step registers its sites at n = 1.
A World without a process group issues no collective and the step is the
one-device step.

ZeRO (`config.parallel.shard_weight_update`, parallel/zero.py), JAX's
branches of the same steps: `create_state` builds the replicated state and
`shard_state` makes it ZeRO's (`TrainState.zero`; the optimizer over this
rank's shards). Stage 1 replaces the gradients' all-reduce by the sharded
update (:133-156 of moco_tpu/parallel/zero.py). At stage 2/3 the step takes
a gather (`Zero23TrainStep`, :1349-1402): the key shards' EMA and the
parameters gathered (`gather_core`, :827-853), or under the layer schedule
the key encoder's first group (`gather_core_layer`) with the groups
gathered inside the forwards (:551-700); after the backward the bucketed
reduce-scatter and the shard update (`zero23_update` / `zero_layer_update`,
:786-806), and the drift from the shards (`ema_drift_sharded`). The frozen
patch embedding stays out of the optimizer, as JAX's restore of the old
shards (:984-991) and re-imposed full parameters (:1001-1021) keep it.

The model axis (a world of num_data x num_model ranks, parallel/mesh.py;
the model ranks of a data rank take the same rows):

- v1/v2 shard the queue's rows over the model ranks (:410, :487-496):
  each rank runs the InfoNCE kernels on its K / num_model rows, gathers
  every shard's (lse, count) over its model group and merges them
  (ops/fused_infonce.py `sharded_infonce_loss`; with `fused_infonce`
  False, JAX's gather of the dense logits, :1156-1168); the gradients'
  mean runs over data x model, which cancels the gather's n (:1223-1255);
  each rank writes the enqueued rows that fall in its shard (:1260-1272);
  the gauges read the local shard's first rows (:1286-1289);
- v3 with `vit_sequence_parallel` shards the ViT's tokens over them: both
  forwards run inside `sequence_parallel_ring` (ring attention, the gap
  pool summed over the ring, models/vit.py), and after the backward the
  backbone's partial gradients are summed over the model ranks
  (`grad.seq_psum`, :957-968). The result is the dense gradient; JAX's is
  num_model times it in the backbone (ROADMAP.md, queue 3).

ZeRO on a model axis (:1225-1243): the state is sharded over the data
ranks only (parallel/zero.py), so the model ranks of a data index hold the
same shards. v1/v2 with a sharded queue first means the gradients over the
model group (JAX's `pmean(grads, MODEL_AXIS)`, which records no ledger
site there either), then the stage's data-group update; v3 under sequence
parallelism sums the backbone's partial gradients over the model ranks
(`grad.seq_psum`), then the stage's update.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from moco_tpu_torch.core.ema import ema_running_stats, ema_update
from moco_tpu_torch.core.queue import check_queue_divisibility, enqueue, init_queue
from moco_tpu_torch.models.heads import BatchNorm1d, ProjectionHead, V3MLPHead
from moco_tpu_torch.models.resnet import BatchNorm, create_resnet
from moco_tpu_torch.models.vit import create_vit, sequence_parallel_ring
from moco_tpu_torch.obs import health
from moco_tpu_torch.parallel import shuffle as sh
from moco_tpu_torch.parallel.mesh import World
from moco_tpu_torch.parallel.zero import ZeroGathered, ZeroLayout
from moco_tpu_torch.ops.fused_infonce import fused_infonce_loss, sharded_infonce_loss
from moco_tpu_torch.ops.losses import cross_entropy, infonce_logits, l2_normalize, topk_accuracy
from moco_tpu_torch.utils.config import MocoConfig, TrainConfig, validate_zero
from moco_tpu_torch.utils.device import resolve_device
from moco_tpu_torch.utils.schedules import build_optimizer, decay_groups, make_lr_schedule

V3_HIDDEN = 4096  # V3MLPHead's hidden width


class MoCoEncoder(nn.Module):
    """`head(backbone(x))`: NHWC float images -> (n, dim) float32."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x, remat: bool = False):
        """`remat` recomputes each backbone block in the backward
        (models/remat.py)."""
        return self.head(self.backbone(x, remat=remat))


def _sync_norms(module: nn.Module, kind: type, stats) -> None:
    """Make every `kind` BatchNorm under `module` a SyncBN over `stats`."""
    for m in module.modules():
        if isinstance(m, kind):
            m.sync_stats = stats


def build_encoder(cfg: MocoConfig, num_filters: int = 64,
                  mlp_hidden: int = V3_HIDDEN, world: Optional[World] = None) -> MoCoEncoder:
    """Backbone (ResNet or ViT from `cfg.arch`, moco_tpu/core/moco.py:88) +
    projection head (:200): v3 takes the V3MLPHead (3 layers behind a ViT,
    2 behind a ResNet, both ending in the affine-free BN), v1/v2 the Linear
    / MLP ProjectionHead. `num_filters` narrows a ResNet and `mlp_hidden`
    the v3 head for tests, as `create_resnet(num_filters=...)` does in the
    JAX package.

    The BN fields are checked as `create_backbone` (:92-190) checks them on
    one device, with its messages: none on a ViT, no virtual groups under
    syncbn, no barrier without stats rows, and no virtual groups without a
    key permutation (shuffle 'none' or v3) unless `allow_leaky_bn`, or the
    EMAN key forward on v1/v2, which reads no batch statistics. JAX's
    `bn_stats_rows` gate fires on a data axis of more than one device.

    `world` (parallel/mesh.py) is the data axis, JAX's `num_data`: with a
    process group, shuffle 'syncbn' makes the backbone's BNs SyncBNs over
    the data group or the rank's subgroup of `syncbn_group_size` ranks, and
    v3's projector BNs SyncBNs over the data group when it has more than
    one rank. `syncbn_group_size` needs a world that it divides.

    `vit_sequence_parallel` (JAX's `sequence_axis`) is refused as
    `create_backbone` refuses it, with its messages: not without a ViT
    arch, v3 and gap pooling."""
    if cfg.vit_sequence_parallel and not cfg.arch.startswith("vit"):
        raise ValueError(f"vit_sequence_parallel requires a ViT arch, got {cfg.arch!r}")
    vit = cfg.arch.startswith("vit")
    n = 1 if world is None else world.num_data
    if cfg.shuffle == "syncbn" and cfg.syncbn_group_size and not vit:
        if world is None:
            raise ValueError(
                "syncbn_group_size is set but build_encoder was called without "
                "num_data — subgrouped SyncBN needs the data-axis size to form groups"
            )
        if n % cfg.syncbn_group_size:
            raise ValueError(f"data axis {n} not divisible by syncbn group {cfg.syncbn_group_size}")
    if vit and (cfg.bn_stats_rows or cfg.bn_virtual_groups > 1 or cfg.bn_momentum_stats):
        raise ValueError(
            "bn_stats_rows / bn_virtual_groups / bn_momentum_stats apply "
            "to ResNet BatchNorm, not ViT archs"
        )
    if not vit:
        if cfg.bn_virtual_groups > 1 and cfg.shuffle == "syncbn":
            raise ValueError("bn_virtual_groups does not compose with syncbn")
        if cfg.bn_stats_barrier and not cfg.bn_stats_rows:
            raise ValueError("bn_stats_barrier requires bn_stats_rows > 0")
        if (cfg.bn_stats_rows and (cfg.shuffle == "none" or cfg.v3) and n > 1
                and not cfg.allow_leaky_bn and not (cfg.key_bn_running_stats and not cfg.v3)):
            raise ValueError(
                "bn_stats_rows needs a key permutation on a multi-device data "
                "axis (fixed first-N-rows statistics concentrate the BN leak "
                "Shuffle-BN prevents): use shuffle='gather_perm' or 'a2a', and "
                "leave it unset for the v3 step, which never shuffles"
            )
        if (cfg.bn_virtual_groups > 1 and (cfg.shuffle == "none" or cfg.v3)
                and not cfg.allow_leaky_bn and not (cfg.key_bn_running_stats and not cfg.v3)):
            raise ValueError(
                "bn_virtual_groups needs a key permutation: use shuffle='gather_perm' "
                "or 'a2a' (shuffle='none' and the v3 step would leak per-group stats)"
            )
    if vit:
        kw = {"patch_size": cfg.vit_patch_size} if cfg.vit_patch_size else {}
        if cfg.vit_sequence_parallel:
            if not cfg.v3:
                raise ValueError("vit_sequence_parallel requires the v3 (queue-free) step")
            if cfg.vit_pool != "gap":
                raise ValueError("vit_sequence_parallel requires vit_pool='gap'")
        backbone = create_vit(cfg.arch, use_flash_attention=cfg.vit_flash_attention,
                              pool=cfg.vit_pool, sequence_parallel=cfg.vit_sequence_parallel,
                              **kw)
    else:
        backbone = create_resnet(
            cfg.arch, num_filters=num_filters, cifar_stem=cfg.cifar_stem,
            bn_stats_rows=cfg.bn_stats_rows, bn_stats_barrier=cfg.bn_stats_barrier,
            bn_virtual_groups=cfg.bn_virtual_groups, bn_momentum_stats=cfg.bn_momentum_stats)
    if cfg.v3:
        num_layers = 3 if vit else 2
        head = V3MLPHead(backbone.num_features, num_layers, mlp_hidden, cfg.dim)
    else:
        head = ProjectionHead(backbone.num_features, cfg.dim, cfg.mlp)
    if world is not None and world.distributed:
        if cfg.shuffle == "syncbn" and not vit:
            _sync_norms(backbone, BatchNorm, world.syncbn_stats(cfg.syncbn_group_size))
        if cfg.v3 and n > 1:
            _sync_norms(head, BatchNorm1d, world.syncbn_stats())
    return MoCoEncoder(backbone, head)


def build_predictor(cfg: MocoConfig, mlp_hidden: int = V3_HIDDEN,
                    world: Optional[World] = None) -> Optional[V3MLPHead]:
    """v3's 2-layer prediction MLP on the query side (:220), with the final
    affine-free BN behind a ViT and without it behind a ResNet; None for
    v1/v2. Its BNs are SyncBNs over a `world` of more than one rank."""
    if not cfg.v3:
        return None
    head = V3MLPHead(cfg.dim, 2, mlp_hidden, cfg.dim, last_bn=cfg.arch.startswith("vit"))
    if world is not None and world.distributed and world.num_data > 1:
        _sync_norms(head, BatchNorm1d, world.syncbn_stats())
    return head


@dataclasses.dataclass
class TrainState:
    """What `MocoState` (moco_tpu/core/moco.py:237) carries: the step, both
    encoders, the queue and its pointer (v1/v2; v3 is queue-free and keeps
    neither, where JAX keeps a 1-row placeholder for its checkpointer), the
    v3 predictor, and the optimizer (optax's SGD trace or Adam moments)."""

    step: int
    encoder_q: MoCoEncoder
    encoder_k: MoCoEncoder
    queue: Optional[torch.Tensor]  # (K, dim) L2-normalized rows; None for v3
    queue_ptr: int
    optimizer: torch.optim.Optimizer
    predictor: Optional[nn.Module] = None
    # the Shuffle-BN permutations' generator, on the state's device
    generator: Optional[torch.Generator] = None
    # ZeRO (parallel/zero.py): the shards and plans; `optimizer` is then
    # over this rank's (m,) shards
    zero: Optional[ZeroLayout] = None
    # v1/v2 on a model axis: the world whose model ranks shard the queue;
    # `queue` is then this rank's (K / num_model, dim) rows
    queue_world: Optional[World] = None

    def full_queue(self) -> Optional[torch.Tensor]:
        """The whole (K, dim) queue: under a sharded queue every model
        rank's rows gathered (a collective each model rank must join)."""
        if self.queue_world is None:
            return self.queue
        return self.queue_world.model_gather(self.queue).flatten(0, 1)

    def queue_rows(self) -> tuple[int, int]:
        """[start, stop) of the whole queue's rows this state holds."""
        if self.queue_world is None:
            return 0, 0 if self.queue is None else self.queue.shape[0]
        rows = self.queue.shape[0]
        return self.queue_world.model_rank * rows, (self.queue_world.model_rank + 1) * rows


def create_state(config: TrainConfig, encoder_q: MoCoEncoder, device="cuda",
                 encoder_k: Optional[MoCoEncoder] = None,
                 queue: Optional[torch.Tensor] = None, step: int = 0,
                 queue_ptr: int = 0, predictor: Optional[nn.Module] = None,
                 zero_num_data: Optional[int] = None,
                 world: Optional[World] = None) -> TrainState:
    """The train state on `device` (moco_tpu/core/moco.py:329): the key
    encoder is a copy of the query encoder with requires_grad=False unless
    one is given. v1/v2: the queue is drawn from a generator on `device`
    seeded with config.seed unless one is given. v3: no queue; the
    predictor is required. The optimizer runs over the query encoder's
    trainable parameters and the predictor's (AdamW and LARS in the two
    groups of the decay mask). Both encoders are kept channels-last.

    With `config.parallel.shard_weight_update` the state is ZeRO's
    (`shard_state`): `zero_num_data` is the data axis's size, JAX's
    argument, and must be `world`'s (one process holds its rank's row).

    v1/v2 with `config.parallel.num_model` > 1: the state holds this
    model rank of `world`'s K / num_model rows of the whole queue (given or
    drawn), JAX's P("model", None) (moco_tpu/core/moco.py:410)."""
    device = resolve_device(device)
    cfg = config.moco
    if config.parallel.shard_weight_update and not zero_num_data:
        raise ValueError(
            "config.parallel.shard_weight_update=True requires zero_num_data "
            "(the data-axis size) so the opt state gets the (n, m) layout"
        )
    if cfg.v3 != (cfg.num_negatives == 0):
        raise ValueError("v3 is queue-free (num_negatives=0); v1/v2 need num_negatives > 0")
    if cfg.v3 and predictor is None:
        raise ValueError("v3=True requires a predictor module (build_predictor)")
    encoder_q = encoder_q.to(device, memory_format=torch.channels_last)
    if encoder_k is None:
        encoder_k = copy.deepcopy(encoder_q)
    encoder_k = encoder_k.to(device, memory_format=torch.channels_last).requires_grad_(False)
    if cfg.v3:
        predictor = predictor.to(device)
        if cfg.freeze_patch_embed and hasattr(encoder_q.backbone, "patch_embed"):
            encoder_q.backbone.patch_embed.requires_grad_(False)
        queue = None
    else:
        if queue is None:
            generator = torch.Generator(device=device).manual_seed(config.seed)
            queue = init_queue(generator, cfg.num_negatives, cfg.dim, device=device)
        queue = queue.to(device=device, dtype=torch.float32).contiguous()
        if tuple(queue.shape) != (cfg.num_negatives, cfg.dim):
            raise ValueError(f"queue {tuple(queue.shape)} != (K, dim) = {(cfg.num_negatives, cfg.dim)}")
        if config.parallel.num_model > 1:  # this model rank's rows of the world's
            if world is None or world.num_model != config.parallel.num_model:
                raise ValueError(f"parallel.num_model={config.parallel.num_model} shards the "
                                 "queue over the model ranks: create_state needs their world")
            rows = cfg.num_negatives // world.num_model
            m = world.model_rank
            queue = queue[m * rows:(m + 1) * rows].clone()
    trained = [m for m in (encoder_q, predictor) if m is not None]
    if config.optim.optimizer in ("adamw", "lars"):
        params = decay_groups(trained, config.optim.weight_decay)
    else:
        params = [p for m in trained for p in m.parameters() if p.requires_grad]
    optimizer = build_optimizer(config.optim, params)
    state = TrainState(step, encoder_q, encoder_k, queue, int(queue_ptr), optimizer, predictor,
                       torch.Generator(device=device))
    if queue is not None and config.parallel.num_model > 1:
        state.queue_world = world
    if config.parallel.shard_weight_update:
        state = shard_state(state, config, world or World(device=device), zero_num_data)
    return state


def shard_state(state: TrainState, config: TrainConfig, world: World,
                zero_num_data: Optional[int] = None) -> TrainState:
    """A replicated train state -> ZeRO's, in place (parallel/zero.py): the
    layout's shards of this rank, the optimizer rebuilt over them in the
    replicated one's parameter order and groups (its state, if any, sharded
    into it), and at stage 2/3 the modules' whole parameters released."""
    validate_zero(config)
    n = zero_num_data or world.num_data
    if n != world.num_data:
        raise ValueError(f"zero_num_data={n} but the world's data axis has {world.num_data} "
                         "rank(s): each process holds its own data rank's rows")
    par = config.parallel
    layout = ZeroLayout(state.encoder_q, state.encoder_k, state.predictor, world,
                        par.zero_stage, par.zero_layer_granular, par.zero_bucket_mb)
    full = state.optimizer.state_dict()
    shard_of = {id(lf.q): s for lf, s in zip(layout.trainable, layout.q_shards)}
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [shard_of[id(p)] for p in g["params"]]}
              for g in state.optimizer.param_groups]
    state.optimizer = build_optimizer(config.optim, groups)
    layout.load_optimizer_state(state.optimizer, full)
    if layout.stage23:
        layout.release("q")
        layout.release("k")
    state.zero = layout
    return state


def make_ema_momentum(cfg: MocoConfig, total_steps: int) -> Callable[[int], float]:
    """`ema_momentum(step)` (moco_tpu/core/moco.py:477-485): the constant m,
    or with `momentum_cos` moco-v3's cosine ramp from m to 1 over
    `total_steps`, the fraction clamped to [0, 1] (a resume that replays
    steps past the end must not ramp back down); in float32 as JAX
    computes it."""
    if cfg.momentum_cos and total_steps <= 0:
        raise ValueError(f"momentum_cos needs total_steps > 0, got {total_steps}")
    # JAX folds the Python constants (1 - m) * 0.5 in double, then rounds them to f32
    half_gap = torch.tensor((1.0 - cfg.momentum) * 0.5, dtype=torch.float32)

    def ema_momentum(step: int) -> float:
        if not cfg.momentum_cos:
            return cfg.momentum
        frac = torch.clamp(torch.tensor(step, dtype=torch.float32) / total_steps, 0.0, 1.0)
        return float(1.0 - half_gap * (1.0 + torch.cos(math.pi * frac)))

    return ema_momentum


def _bn_buffers(*modules) -> list:
    """The BN running statistics of `modules` (floating buffers: not the
    integer batch counters), in a fixed order."""
    return [b for m in modules if m is not None for b in m.buffers() if b.is_floating_point()]


def make_train_step(config: TrainConfig, steps_per_epoch: int, device="cuda",
                    world: Optional[World] = None) -> Callable[[TrainState, dict], dict]:
    """`step(state, batch) -> metrics`: one MoCo step on `device` (v3 when
    `config.moco.v3`), updating `state` in place. `batch` is {"im_q",
    "im_k"}, (b, S, S, 3) float32 views already augmented: b =
    config.data.global_batch on one device, this rank's B / n rows under
    a `world` of n ranks (module docstring). Metrics: loss, acc1, acc5 (0-dim
    tensors, not synchronized; their mean over the ranks), lr, and with
    `config.health_metrics` the health gauges (0-dim tensors,
    `queue_age_hist` an (8,) one, not synchronized). The EMA ramp spans
    epochs * steps_per_epoch steps, the total moco_tpu/train.py:360 passes.

    Under compute_dtype="bfloat16" the encoders run under autocast while
    the parameters, BN statistics, head output and loss inputs stay
    float32, as in JAX.

    The EMAN key forward is checked as JAX's `make_train_step` checks it
    (:457-470), with its messages: not on v3, not under gather_perm or
    a2a; so is the batch's split over the ranks."""
    device = resolve_device(device)
    cfg = config.moco
    if cfg.key_bn_running_stats:
        if cfg.v3:
            raise ValueError(
                "key_bn_running_stats is a v2-step lever; the v3 step "
                "manages its own momentum encoder"
            )
        if cfg.shuffle in ("gather_perm", "a2a"):
            raise ValueError(
                "key_bn_running_stats removes batch statistics from the key "
                "forward, so Shuffle-BN would be pure wasted communication: "
                "set shuffle='none' (or 'syncbn' for query-side statistics)"
            )
    validate_zero(config)
    par = config.parallel
    zero23 = par.shard_weight_update and par.zero_stage >= 2
    layer = zero23 and par.zero_layer_granular
    world = World(device=device) if world is None else world
    n, rank, n_model = world.num_data, world.data_rank, world.num_model
    if config.parallel.num_model != n_model:
        raise ValueError(f"parallel.num_model={config.parallel.num_model} but the world's model "
                         f"axis has {n_model} rank(s)")
    global_batch = config.data.global_batch
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {n}")
    local_b = global_batch // n
    # the model axis: v1/v2's queue rows sharded over it (:487-496), or the
    # sequence-parallel ViT's tokens (:957-968)
    shard_queue = n_model > 1 and not cfg.v3
    if shard_queue and cfg.num_negatives % (n_model * max(global_batch, 1)):
        raise ValueError("sharded queue requires K % (num_model*global_batch) == 0")
    ring = world.ring() if cfg.vit_sequence_parallel else None
    shuffle_active = n > 1 or cfg.bn_virtual_groups > 1  # :1101
    # the step's permutations: `gather_perm`'s one, `a2a`'s two local ones
    shuffle = cfg.shuffle if shuffle_active and cfg.shuffle in ("gather_perm", "a2a") else None
    if shuffle == "a2a" and local_b % n:
        raise ValueError(f"a2a shuffle needs local batch {local_b} divisible by axis size {n}")
    if not cfg.v3:
        check_queue_divisibility(cfg.num_negatives, global_batch)
    schedule = make_lr_schedule(config.optim, steps_per_epoch)
    ema_momentum = make_ema_momentum(cfg, config.optim.epochs * steps_per_epoch)
    bf16 = cfg.compute_dtype == "bfloat16"
    health_on = config.health_metrics
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # the trainer's shapes are fixed

    def autocast():
        return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)

    def key_forward(state: TrainState, batch: dict, apply_k):
        """(k_local, k_global): this rank's keys and the global batch's, in
        the batch's order, l2-normalized: the key forward on the permuted
        batch under Shuffle-BN, else on the batch itself (eval-mode BN
        under EMAN); the global keys come from the unshuffle's gather under
        gather_perm and from the enqueue's own gather otherwise (n > 1)."""
        im_k = batch["im_k"]
        if shuffle is not None:
            state.generator.manual_seed(
                sh.step_seed(config.seed, state.step, rank if shuffle == "a2a" else 0))
        if shuffle == "gather_perm":
            perm = batch.get("perm")
            if perm is None:
                perm, inv_perm = sh.make_permutation(state.generator, global_batch)
            else:
                inv_perm = torch.argsort(perm)
            im_k = sh.dp_shuffle_gather(world, im_k, perm)
        elif shuffle == "a2a":
            pre, post = (batch["pre"], batch["post"]) if "pre" in batch else sh.local_perms(
                state.generator, local_b)
            im_k = sh.dp_balanced_shuffle(world, im_k, pre, post)
        state.encoder_k.train(not cfg.key_bn_running_stats)
        with torch.no_grad(), autocast():
            k = apply_k(im_k)
        k = l2_normalize(k.float())
        if shuffle == "gather_perm":
            return sh.dp_unshuffle_gather(world, k, inv_perm)
        if shuffle == "a2a":
            k = sh.dp_balanced_unshuffle(world, k, pre, post)
            return k, world.all_gather_rows(k, "queue.enqueue_gather")
        if n > 1:
            return k, world.all_gather_rows(k, "queue.enqueue_gather")
        return k, k

    def eman_momentum(step: int) -> float:
        """The key statistics' momentum: ema_momentum(step), with the warmup
        min(m, (1 + step) / (10 + step)), in float32 as JAX takes it."""
        m = torch.tensor(ema_momentum(step), dtype=torch.float32)
        if cfg.key_bn_stats_warmup:
            s = torch.tensor(step, dtype=torch.float32)
            m = torch.minimum(m, (1.0 + s) / (10.0 + s))
        return float(m)

    def check_batch(im_q, im_k):
        if im_q.shape[0] != local_b or im_k.shape[0] != local_b:
            where = "config says" if n == 1 else f"this rank of {n} holds"
            raise ValueError(f"batch of {im_q.shape[0]} rows, {where} {local_b}")

    def update(state: TrainState, loss) -> float:
        """Backward, the gradients' mean over the ranks (`grad.psum`), and
        the optimizer step at the lr of this step's count; under ZeRO the
        stage's sharded update (parallel/zero.py) instead. A sharded queue
        takes the mean over data and model (:1250-1255), under ZeRO the
        model group's mean and then the stage's data-group update
        (:1225-1243); under sequence
        parallelism the backbone's partial gradients are first summed over
        the model ranks (`grad.seq_psum`, :957-968), the heads' and the
        predictor's being whole on every model rank."""
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if ring is not None:
            world.model_all_reduce_sum_([p.grad for p in state.encoder_q.backbone.parameters()
                                         if p.grad is not None], "grad.seq_psum")
        z = state.zero
        if z is None:
            world.all_reduce_mean_([p.grad for group in state.optimizer.param_groups
                                    for p in group["params"]], "grad.psum",
                                   over="world" if shard_queue else "data")
            state.optimizer.step()
            return lr
        if shard_queue:  # the whole parameters' gradients, before the data-group update
            world.model_all_reduce_mean_([lf.q.grad for lf in z.trainable])
        if layer:
            z.layer_update(state.optimizer)
        elif zero23:
            z.zero23_update(state.optimizer)
        else:
            z.stage1_update(state.optimizer)
        return lr

    def check_state(state: TrainState) -> None:
        """The state's ZeRO layout and queue shard are the ones the config
        and world ask for."""
        if shard_queue and (state.queue_world is not world
                            or state.queue.shape[0] != cfg.num_negatives // n_model):
            raise ValueError("a sharded queue's step needs the state's K / num_model rows of "
                             "this world's model rank: build it with create_state(world=...)")
        z = state.zero
        want = None if not par.shard_weight_update else (par.zero_stage >= 2, layer, n)
        have = None if z is None else (z.stage23, z.layer, z.n)
        if want != have:
            raise ValueError(f"the state's ZeRO layout {have} (stage >= 2, layer-granular, "
                             f"ranks) is not the config's {want}: build it with create_state "
                             "from this config and world")

    def begin(state: TrainState, gathered: Optional[ZeroGathered]):
        """The key encoder's EMA and its forward (a callable on images): at
        stage 2/3 the gather (`gathered`, or made here) holds the new key
        shards and the parameters the step computes with."""
        check_state(state)
        z = state.zero
        if not zero23:
            ema_update(state.encoder_k, state.encoder_q, ema_momentum(state.step))
            return state.encoder_k
        if gathered is None:
            gathered = z.gather_params(ema_momentum(state.step), state.step)
        if gathered.step != state.step:
            raise ValueError(f"the gather was made for step {gathered.step}, "
                             f"the state is at {state.step}")
        z.k_shards = gathered.k_shards
        if layer:
            return lambda x: z.layer_key_forward(gathered, x)
        return state.encoder_k

    def query_forward(state: TrainState, x):
        if layer:
            return state.zero.layer_query_forward(x)
        return state.encoder_q(x, remat=cfg.remat)

    def model_axis():
        """The sequence-parallel ViT's ring for the forwards (a no-op
        context without sequence parallelism)."""
        return sequence_parallel_ring(ring) if ring is not None else contextlib.nullcontext()

    def infonce(q, k, queue):
        """(loss, acc) of q against k and the queue: the fused loss unless
        `fused_infonce` is False, for any K; over a sharded queue the kernels
        on this rank's rows and the merge of the shards' statistics
        (`queue.stats_gather`), or JAX's gather of the dense logits
        (`queue.logits_gather`, :1156-1168)."""
        if not shard_queue:
            if cfg.fused_infonce is not False:
                return fused_infonce_loss(q, k, queue, cfg.temperature)
            logits, labels = infonce_logits(q, k, queue, cfg.temperature)
            return cross_entropy(logits, labels), topk_accuracy(logits, labels)
        if cfg.fused_infonce is not False:
            return sharded_infonce_loss(
                q, k, queue, cfg.temperature,
                lambda x: world.model_gather(x, "queue.stats_gather"))
        logits, labels = infonce_logits(q, k, queue, cfg.temperature)
        l_neg = world.model_gather(logits[:, 1:], "queue.logits_gather")  # (n, B, K/n)
        logits = torch.cat([logits[:, :1], l_neg.permute(1, 0, 2).flatten(1)], 1)
        return cross_entropy(logits, labels), topk_accuracy(logits, labels)

    def fifo(state: TrainState, k_global) -> None:
        """The enqueue of the global keys (:1260-1272): over a sharded queue
        each model rank writes the rows that fall in its shard."""
        if not shard_queue:
            state.queue, state.queue_ptr = enqueue(state.queue, state.queue_ptr, k_global)
            return
        start, stop = state.queue_rows()
        if start <= state.queue_ptr and state.queue_ptr + global_batch <= stop:
            enqueue(state.queue, state.queue_ptr - start, k_global)
        state.queue_ptr = (state.queue_ptr + global_batch) % cfg.num_negatives

    def drift(state: TrainState) -> Optional[dict]:
        """Stage 2/3's EMA drift, from the shards (None: the modules')."""
        if not zero23:
            return None
        z = state.zero
        q_g, k_g = {}, {}
        q_enc = [s for s, lf in zip(z.q_shards, z.trainable) if lf.side == "enc"]
        for qs, ks, lf in zip(q_enc, z.k_shards, z.enc):
            q_g.setdefault(lf.path[0], []).append(qs)
            k_g.setdefault(lf.path[0], []).append(ks)
        return health.ema_drift_sharded(q_g, k_g, world)

    def mean_metrics(metrics: dict, keys) -> None:
        """The ranks' mean of the 0-dim `keys` of `metrics`, in one
        all-reduce (JAX's pmean of the metrics tree)."""
        if not world.distributed:
            return
        keys = [k for k in keys if k in metrics]
        reduced = world.all_reduce_mean(torch.stack([metrics[k].float() for k in keys]))
        metrics.update(zip(keys, reduced.unbind()))

    def step(state: TrainState, batch: dict, gathered: Optional[ZeroGathered] = None) -> dict:
        im_q, im_k = batch["im_q"], batch["im_k"]
        check_batch(im_q, im_k)
        # (1) EMA before the key forward, on the pre-update query params
        apply_k = begin(state, gathered)
        # (2) key forward, train-mode BN (its running stats move) unless EMAN
        k, k_global = key_forward(state, batch, apply_k)
        if zero23 and not layer:
            state.zero.release("k")
        # (3) query forward
        state.encoder_q.train()
        with autocast():
            q = query_forward(state, im_q)
        q = l2_normalize(q.float())
        # (4) loss in float32 on the old queue (this rank's rows of it)
        loss, acc = infonce(q, k, state.queue)
        # (5) backward, the gradients' mean and the optimizer step; the
        # running statistics' mean over the ranks; under EMAN the key
        # statistics then trail the query's (the backward leaves the BN
        # buffers as the query forward left them, remat's recompute too)
        lr = update(state, loss)
        world.all_reduce_mean_(_bn_buffers(
            state.encoder_q, None if cfg.key_bn_running_stats else state.encoder_k))
        if cfg.key_bn_running_stats:
            ema_running_stats(state.encoder_k, state.encoder_q, eman_momentum(state.step))
        metrics = {"loss": loss.detach(), "acc1": acc["acc1"], "acc5": acc["acc5"], "lr": lr}
        mean_metrics(metrics, ("loss", "acc1", "acc5"))
        # (6) the gauges, on the old queue and the updated query parameters
        if health_on:
            with torch.no_grad():
                q_h = q.detach()
                pos = (q_h * k).sum(-1) / cfg.temperature
                neg = (q_h @ state.queue[:min(1024, state.queue.shape[0])].T) / cfg.temperature
                metrics.update(health.health_summary(
                    health.module_groups(state.encoder_q), health.module_groups(state.encoder_k),
                    q_h, pos, neg, state.step, cfg.num_negatives, global_batch,
                    drift=drift(state)))
            mean_metrics(metrics, health.BATCH_LOCAL_KEYS)
        # (7) FIFO enqueue of the global keys, after the loss and the gauges
        # have read the old queue
        fifo(state, k_global)
        state.step += 1
        return metrics

    def v3_step(state: TrainState, batch: dict, gathered: Optional[ZeroGathered] = None) -> dict:
        im_q, im_k = batch["im_q"], batch["im_k"]
        check_batch(im_q, im_k)
        x_cat = torch.cat([im_q, im_k])
        # (1) EMA of the key encoder (not the predictor), before the key forward
        apply_k = begin(state, gathered)
        # (2) key forward on both views, train-mode BN in the head
        state.encoder_k.train()
        with torch.no_grad(), autocast(), model_axis():
            k_cat = apply_k(x_cat)
        if zero23 and not layer:
            state.zero.release("k")
        k1, k2 = l2_normalize(k_cat.float()).chunk(2)
        if n > 1:  # the global keys of both views, in one gather
            k_g = world.all_gather_rows(torch.cat([k1, k2], 1), "v3.key_gather")
            k1, k2 = k_g[:, :cfg.dim], k_g[:, cfg.dim:]
        labels = rank * local_b + torch.arange(local_b, device=im_q.device)
        # (3) query forward and predictor on the same 2b rows
        state.encoder_q.train()
        state.predictor.train()
        with autocast(), model_axis():
            feats = query_forward(state, x_cat)
            preds = (state.zero.layer_pred_forward(feats) if layer
                     else state.predictor(feats))
        q1, q2 = l2_normalize(preds.float()).chunk(2)

        # (4) the symmetric loss, each term scaled by 2T
        def ctr(q, k):
            logits = q @ k.T / cfg.temperature
            return 2.0 * cfg.temperature * cross_entropy(logits, labels), logits

        loss1, logits = ctr(q1, k2)
        loss = loss1 + ctr(q2, k1)[0]
        acc = topk_accuracy(logits.detach(), labels)
        # (5) backward, the gradients' mean and the optimizer step; the
        # running statistics' mean over the ranks
        lr = update(state, loss)
        world.all_reduce_mean_(_bn_buffers(state.encoder_q, state.encoder_k, state.predictor))
        metrics = {"loss": loss.detach(), "acc1": acc["acc1"], "acc5": acc["acc5"], "lr": lr}
        mean_metrics(metrics, ("loss", "acc1", "acc5"))
        # (6) the gauges; the drift of the updated encoder, not the predictor
        if health_on:
            metrics.update(health.logit_stats_from_dense(logits.detach(), labels))
            metrics.update(health.feature_stats(q1.detach()))
            mean_metrics(metrics, health.BATCH_LOCAL_KEYS)
            shard_drift = drift(state)
            metrics.update(shard_drift if shard_drift is not None else health.ema_drift(
                health.module_groups(state.encoder_q), health.module_groups(state.encoder_k)))
        state.step += 1
        return metrics

    fn = v3_step if cfg.v3 else step
    if not zero23:
        return fn
    return Zero23TrainStep(
        lambda state: state.zero.gather_params(ema_momentum(state.step), state.step), fn)


class Zero23TrainStep:
    """The stage-2/3 step as a (gather, step) pair (JAX's `Zero23TrainStep`):

    - `gather(state) -> ZeroGathered`: the key shards' EMA and the
      parameters' gather (parallel/zero.py `ZeroLayout.gather_params`),
      which the training loop issues for step k + 1 right after step k
      (`AsyncParamGather`);
    - `step(state, batch, gathered) -> metrics`: the step on them.

    Calling the object runs both inline, the schedule without the hoist."""

    def __init__(self, gather: Callable, step: Callable):
        self.gather, self.step = gather, step

    def __call__(self, state: TrainState, batch: dict) -> dict:
        return self.step(state, batch, self.gather(state))
