"""Sharded weight update over the data ranks (ZeRO): the port's counterpart
of moco_tpu/parallel/zero.py, built on the `World` collectives
(parallel/mesh.py), not on FSDP or `ZeroRedundancyOptimizer`.

The shards span the data axis, as JAX's: n is the world's `num_data`,
a rank's row its `data_rank`, and every collective here runs over the data
group. On a model axis the model ranks of a data index hold the same rows
and make the same update (the step first means their gradients over the
model group).

The layout is JAX's. Each parameter leaf is flattened in its logical order,
zero-padded to n * m elements (m = `padded_cols(size, n)`) and viewed as
(n, m): rank r owns row r. The leaves are those of JAX's params tree, in
its order (`{"enc": {"backbone", "head"}, "pred"}`, dict keys sorted at
every level), so the fusion buckets, their ledger sites and their bytes
are JAX's; a conv kernel is OIHW here and HWIO there, which changes which
rank owns which element of it but not the sizes, and the optimizers are
elementwise.

- Stage 1 (`ZeroLayout.stage1_update`): the parameters stay whole on every
  rank; after the backward the gradients are reduce-scattered (a sum, then
  the division by n), the optimizer updates this rank's (m,) shard of each
  leaf and the shards are all-gathered back into the parameters.
- Stages 2/3 (one implementation): the query, key and predictor parameters
  persist between steps as shards; the modules' own parameters are then
  released (an empty tensor, so a forward that meets one fails loudly
  instead of computing on stale memory). `ZeroLayout.gather_params` moves
  a step's EMA of the key shards (elementwise, no collective) and one
  bucketed all-gather per parameter family into the modules;
  `zero23_update` reduce-scatters the gradients and updates the shards,
  with no gather after it.
- Layer-granular (`GroupPlan`, `GatherGroup`): the step gathers one layer
  group at a time, the query side inside each group's rematerialized
  segment, whose backward re-gathers the group and reduce-scatters its
  gradients onto the shards (JAX's AD transpose of the gather).

Collectives go in fusion buckets (`BucketPlan`): leaves are packed
greedily, in leaf order and per dtype, until a bucket holds
`zero_bucket_mb` of shard payload; one all-gather or reduce-scatter per
bucket moves exactly what per-leaf ones would, the same element to the
same rank. Every collective is issued from the thread that drives the
step (the autograd engine's, inside a backward the training loop waits on), in
the same order on every rank; `AsyncParamGather` hoists the next step's
gather on that thread and never waits on the device.

Only elementwise optimizers (SGD momentum, AdamW) are eligible: LARS's
trust ratios need whole-tensor norms (`utils/config.py::validate_zero`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from moco_tpu_torch.models.remat import remat_call
from moco_tpu_torch.obs.trace import span
from moco_tpu_torch.utils import faults

DEFAULT_BUCKET_MB = 4.0


def padded_cols(numel: int, n: int) -> int:
    """Columns of the (n, m) sharded view of a flat leaf of `numel`."""
    return -(-max(int(numel), 1) // int(n))


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', ... of a torch, numpy or JAX dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def dtype_size(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _numel(shape) -> int:
    return int(np.prod(tuple(shape))) if len(tuple(shape)) else 1


# -- host layout helpers (numpy; checkpoints and conversions) ---------------


def shard_leaf_host(x, n: int) -> np.ndarray:
    """A full leaf -> its (n, m) sharded-flat layout."""
    x = np.asarray(x)
    m = padded_cols(x.size, n)
    return np.pad(x.reshape(-1), (0, n * m - x.size)).reshape(n, m)


def unshard_leaf_host(x, shape, dtype=None) -> np.ndarray:
    """(n, m) sharded-flat -> the full leaf of `shape`."""
    x = np.asarray(x)
    out = x.reshape(-1)[:_numel(shape)].reshape(tuple(shape))
    return out.astype(dtype) if dtype is not None else out


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unshard_tree_host(tree, template):
    """A whole tree of (n, m) leaves -> full shapes; `template`'s leaves
    (anything with .shape and .dtype) give them."""
    return _tree_map(lambda x, t: unshard_leaf_host(x, t.shape, t.dtype), tree, template)


# -- fusion buckets ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    """One leaf's place inside a fusion bucket."""

    index: int  # position in the plan's leaf order
    size: int  # true element count
    m: int  # padded_cols(size, n)
    offset: int  # column offset inside the bucket's (n, total_m) view
    shape: tuple
    dtype: Any


@dataclasses.dataclass(frozen=True)
class Bucket:
    slots: tuple
    total_m: int
    dtype: Any


def _flat_rows(t: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """`t` flattened in its logical order and zero-padded to (n, m)."""
    flat = t.reshape(-1)
    if flat.numel() < n * m:
        flat = torch.nn.functional.pad(flat, (0, n * m - flat.numel()))
    return flat.view(n, m)


def _empty_full(shape, dtype, device, channels_last: bool = False) -> torch.Tensor:
    fmt = torch.channels_last if channels_last and len(shape) == 4 else torch.contiguous_format
    return torch.empty(shape, dtype=dtype, device=device, memory_format=fmt)


class _PendingGather:
    """A bucketed all-gather in flight: `finish` waits on it and unpacks the
    buckets into full leaves."""

    def __init__(self, plan: "BucketPlan", outs: list, works: list, device):
        self.plan, self.outs, self.works, self.device = plan, outs, works, device

    def finish(self, out: Optional[Sequence] = None, channels_last: Optional[Sequence] = None) -> list:
        """The full leaves: written into `out`'s tensors (any memory format)
        when given, else fresh ones (channels-last where `channels_last`
        says so)."""
        plan, n = self.plan, self.plan.n
        result: list = [None] * plan.num_leaves
        for bucket, full, work in zip(plan.buckets, self.outs, self.works):
            if work is not None:
                work.wait()
            rows = full.view(n, bucket.total_m)
            for s in bucket.slots:
                flat = rows[:, s.offset:s.offset + s.m].reshape(-1)[:s.size].view(s.shape)
                if out is not None:
                    out[s.index].copy_(flat)
                    result[s.index] = out[s.index]
                else:
                    cl = bool(channels_last[s.index]) if channels_last is not None else False
                    result[s.index] = _empty_full(s.shape, full.dtype, full.device, cl)
                    result[s.index].copy_(flat)
        return result


class BucketPlan:
    """Static packing of a tree's leaves into fusion buckets (JAX's
    `BucketPlan`): greedy in leaf order, one open bucket per dtype; a
    bucket closes once it holds >= `bucket_bytes` of shard payload, so the
    last bucket of each dtype is the ragged tail, and a leaf larger than
    `bucket_bytes` gets a bucket of its own. Bucket row r is the
    concatenation of every member leaf's row r."""

    def __init__(self, leaves: Sequence, n: int, bucket_bytes: Optional[int] = None):
        """`leaves`: descriptors with .shape and .dtype (torch, numpy or JAX
        dtypes), in the order the runtime methods are fed."""
        self.n = int(n)
        bucket_bytes = int(bucket_bytes if bucket_bytes is not None
                           else DEFAULT_BUCKET_MB * 1024 * 1024)
        leaves = list(leaves)
        buckets: list[Bucket] = []
        open_slots: dict = {}  # dtype name -> (slots, cols, bytes, dtype)
        for i, leaf in enumerate(leaves):
            shape = tuple(leaf.shape)
            size = _numel(shape)
            m = padded_cols(size, self.n)
            key = dtype_name(leaf.dtype)
            slots, cols, nbytes, dtype = open_slots.setdefault(key, ([], 0, 0, leaf.dtype))
            slots.append(_LeafSlot(i, size, m, cols, shape, leaf.dtype))
            cols += m
            nbytes += m * dtype_size(leaf.dtype)
            if nbytes >= bucket_bytes:
                buckets.append(Bucket(tuple(slots), cols, dtype))
                del open_slots[key]
            else:
                open_slots[key] = (slots, cols, nbytes, dtype)
        for slots, cols, _, dtype in open_slots.values():  # the ragged tails
            buckets.append(Bucket(tuple(slots), cols, dtype))
        self.buckets = tuple(buckets)
        self.num_leaves = len(leaves)

    def shard_leaves(self, full_leaves: Sequence) -> list:
        """Full leaves -> their (n, m) layouts."""
        return [_flat_rows(x, self.n, padded_cols(x.numel(), self.n)) for x in full_leaves]

    def local_shards(self, full_leaves: Sequence, rank: int) -> list:
        """This rank's (m,) rows of full leaves (copies)."""
        return [rows[rank].clone() for rows in self.shard_leaves(full_leaves)]

    def gather_async(self, world, shard_leaves: Sequence, site: Optional[str] = None
                     ) -> _PendingGather:
        """(m,) shards -> full leaves, one all-gather per bucket issued now
        (async), each recorded as `<site>.b<i>` when `site` is given."""
        outs, works = [], []
        for bi, bucket in enumerate(self.buckets):
            concat = torch.cat([shard_leaves[s.index].reshape(-1) for s in bucket.slots])
            full, work = world.all_gather_flat(
                concat, None if site is None else f"{site}.b{bi}", async_op=True)
            outs.append(full)
            works.append(work)
        device = outs[0].device if outs else None
        return _PendingGather(self, outs, works, device)

    def gather(self, world, shard_leaves: Sequence, site: Optional[str] = None,
               out: Optional[Sequence] = None, channels_last: Optional[Sequence] = None) -> list:
        """`gather_async(...).finish(out, channels_last)`."""
        return self.gather_async(world, shard_leaves, site).finish(out, channels_last)

    def _scatter(self, world, grad_leaves: Sequence, site: Optional[str]) -> list:
        out: list = [None] * self.num_leaves
        n = self.n
        for bi, bucket in enumerate(self.buckets):
            parts = []
            for s in bucket.slots:
                g = grad_leaves[s.index]
                if g is None:
                    g = torch.zeros(s.shape, dtype=bucket_dtype(bucket), device=world.device)
                parts.append(_flat_rows(g, n, s.m))
            block = torch.cat(parts, dim=1).reshape(-1)
            shard = world.reduce_scatter_flat(block, None if site is None else f"{site}.b{bi}")
            for s in bucket.slots:
                out[s.index] = shard[s.offset:s.offset + s.m]
        return out

    def scatter_sum(self, world, grad_leaves: Sequence, site: Optional[str] = None) -> list:
        """Full local gradients (None reads as zeros) -> this rank's (m,)
        rows of their sum over the ranks, one reduce-scatter per bucket."""
        return self._scatter(world, grad_leaves, site)

    def scatter_mean(self, world, grad_leaves: Sequence, site: Optional[str] = "zero.scatter"
                     ) -> list:
        """`scatter_sum` divided by n: the ranks' mean on this rank's rows."""
        return [s.div_(self.n) for s in self._scatter(world, grad_leaves, site)]

    def shard_bytes(self) -> int:
        """Bytes of one rank's row of every leaf, the padding included."""
        return sum(b.total_m * dtype_size(b.dtype) for b in self.buckets)

    def describe(self) -> list[dict]:
        """The static bucket table (JAX's `describe`)."""
        return [{"bucket": i, "leaves": len(b.slots), "dtype": dtype_name(b.dtype),
                 "shard_bytes": b.total_m * dtype_size(b.dtype)}
                for i, b in enumerate(self.buckets)]


def bucket_dtype(bucket: Bucket) -> torch.dtype:
    d = bucket.dtype
    return d if isinstance(d, torch.dtype) else getattr(torch, dtype_name(d))


@dataclasses.dataclass(frozen=True)
class _Group:
    """One layer group of a GroupPlan."""

    name: str
    indices: tuple  # leaf positions in the plan's leaf order
    plan: BucketPlan
    full_bytes: int  # bytes of the group's full leaves


class GroupPlan:
    """JAX's `GroupPlan`: an ordered partition of the leaves into named
    layer groups (schedule order: stem or embedding, blocks, head), each
    with its own bucket plan and ledger site `<prefix>.<group>.b<i>`. The
    partition must cover every leaf once; `peak_full_bytes` is the largest
    sum of two adjacent groups' full bytes (group g is live while g + 1 is
    gathered)."""

    def __init__(self, leaves: Sequence, groups: Sequence, n: int,
                 bucket_bytes: Optional[int] = None):
        self.n = int(n)
        leaves = list(leaves)
        seen: set = set()
        built = []
        for name, indices in groups:
            indices = tuple(int(i) for i in indices)
            overlap = seen.intersection(indices)
            if overlap:
                raise ValueError(f"group {name!r} re-claims leaves {sorted(overlap)}")
            seen.update(indices)
            full_bytes = sum(_numel(leaves[i].shape) * dtype_size(leaves[i].dtype)
                             for i in indices)
            built.append(_Group(str(name), indices,
                                BucketPlan([leaves[i] for i in indices], n, bucket_bytes),
                                full_bytes))
        missing = sorted(set(range(len(leaves))) - seen)
        if missing:
            raise ValueError(f"group map misses leaves {missing}")
        self.groups = tuple(built)
        self.num_leaves = len(leaves)

    def group_shards(self, shard_leaves: Sequence, gi: int) -> list:
        return [shard_leaves[i] for i in self.groups[gi].indices]

    def gather_group_async(self, world, group_shard_leaves: Sequence, gi: int,
                           site_prefix: str = "zero.gather") -> _PendingGather:
        g = self.groups[gi]
        return g.plan.gather_async(world, group_shard_leaves, site=f"{site_prefix}.{g.name}")

    def gather_group(self, world, group_shard_leaves: Sequence, gi: int,
                     site_prefix: str = "zero.gather", channels_last=None) -> list:
        return self.gather_group_async(world, group_shard_leaves, gi, site_prefix).finish(
            channels_last=channels_last)

    def peak_full_bytes(self) -> int:
        sizes = [g.full_bytes for g in self.groups]
        return peak_of_adjacent(sizes)

    def total_full_bytes(self) -> int:
        return sum(g.full_bytes for g in self.groups)

    def describe(self) -> list[dict]:
        return [{"group": g.name, "leaves": len(g.indices), "buckets": len(g.plan.buckets),
                 "full_bytes": g.full_bytes} for g in self.groups]


def peak_of_adjacent(sizes: Sequence[int]) -> int:
    """The largest sum of two adjacent sizes (the one size when alone)."""
    sizes = list(sizes)
    if not sizes:
        return 0
    if len(sizes) == 1:
        return sizes[0]
    return max(a + b for a, b in zip(sizes, sizes[1:]))


class GatherGroup(torch.autograd.Function):
    """One layer group's shards -> its full parameters. The backward
    reduce-scatters the full parameters' gradients onto the shards as a
    sum over the ranks (the division by n comes in the update), JAX's AD
    transpose of the gather; like JAX's, the transpose records no ledger
    site. Shards that do not require a gradient get none."""

    @staticmethod
    def forward(ctx, world, plan: BucketPlan, site: Optional[str], channels_last, *shards):
        ctx.world, ctx.plan = world, plan
        ctx.needs = [s.requires_grad for s in shards]
        return tuple(plan.gather(world, shards, site, channels_last=channels_last))

    @staticmethod
    def backward(ctx, *grads):
        sums = ctx.plan.scatter_sum(ctx.world, list(grads))
        return (None, None, None, None,
                *[s if need else None for s, need in zip(sums, ctx.needs)])


# -- the hoisted gather ------------------------------------------------------------


class AsyncParamGather:
    """Hoists the stage-2/3 gather of step k + 1 under step k (JAX's
    `AsyncParamGather`), with its two contracts:

    1. the gather is issued on the caller's thread (`submit` calls
       `gather_fn` there), so every rank issues its collectives in one
       order from one thread;
    2. `take()` never waits for the device: it waits only for what the
       worker thread absorbs off the critical path, the deterministic
       `delay@site=zero.gather` fault, the synthetic slow collective.

    `overlap = 1 - wait / duration` (clamped to [0, 1]) says how much of
    the absorbed stall hid under the training loop's iteration; None when nothing
    was absorbed (a duration under 1 ms). After the hand-off the worker
    waits on the gather's CUDA event, if it has one, so the `zero_gather`
    span shows when the gather was done on the card. Bounded queues, a
    poison-pill `close()` that joins the worker, and errors before the
    hand-off surface at `take()`."""

    FAULT_SITE = "zero.gather"

    def __init__(self, gather_fn: Callable):
        self._gather_fn = gather_fn
        self._submit: queue_mod.Queue = queue_mod.Queue(maxsize=1)
        self._done: queue_mod.Queue = queue_mod.Queue(maxsize=1)
        self._outstanding = 0
        self._closed = False
        self.last_overlap: Optional[float] = None
        self.last_duration: Optional[float] = None
        self._thread = threading.Thread(target=self._run, name="zero-param-gather", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._submit.get()
            if item is None:
                return
            out, step = item
            t0 = time.perf_counter()
            handed = False
            try:
                with span("zero_gather", step=step):
                    faults.maybe_delay(self.FAULT_SITE)
                    self._done.put(("ok", out, time.perf_counter() - t0))
                    handed = True
                    event = getattr(out, "event", None)
                    if event is not None:
                        event.synchronize()
            except BaseException as e:
                if not handed:
                    self._done.put(("err", e, time.perf_counter() - t0))

    def submit(self, state, step: int = 0) -> None:
        """Issue the gather for `state` on this thread and hand it to the
        worker; one submit is outstanding per take."""
        if self._closed:
            raise RuntimeError("AsyncParamGather is closed")
        out = self._gather_fn(state)
        self._outstanding += 1
        self._submit.put((out, step))

    def take(self):
        """The submitted gather, once the worker has absorbed its stall;
        updates `last_overlap` and `last_duration`."""
        t0 = time.perf_counter()
        kind, payload, duration = self._done.get()
        self._outstanding -= 1
        wait = time.perf_counter() - t0
        self.last_duration = duration
        self.last_overlap = (max(0.0, min(1.0, 1.0 - wait / duration))
                             if duration > 1e-3 else None)
        if kind == "err":
            raise payload
        return payload

    def resubmit(self, state, step: int = 0) -> None:
        """Drop a parked result (a rolled-back lineage) and gather `state`."""
        while self._outstanding:
            try:
                self.take()
            except Exception:
                pass  # a dropped gather's error goes with its lineage
        self.submit(state, step)

    def payload(self) -> dict:
        return {"overlap/zero": self.last_overlap}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._submit.put(None)
        self._thread.join(timeout=30.0)


# -- the port's train-state layout ------------------------------------------------


@dataclasses.dataclass
class ZeroLeaf:
    """One leaf of the trained tree: a query-encoder parameter (`side`
    "enc", with its key-encoder twin) or a predictor one ("pred")."""

    side: str
    path: tuple  # Flax leaf path inside its side's tree
    name: str  # parameter name in its module's state_dict
    q: torch.nn.Parameter
    q_owner: tuple  # (module, attribute) that holds `q`
    k: Optional[torch.nn.Parameter]
    k_owner: Optional[tuple]
    shape: tuple
    dtype: torch.dtype
    channels_last: bool
    frozen: bool  # out of the optimizer (v3's frozen patch embedding)

    @property
    def size(self) -> int:
        return _numel(self.shape)


def _owner(module: torch.nn.Module, name: str) -> tuple:
    mod_name, _, attr = name.rpartition(".")
    return (module.get_submodule(mod_name) if mod_name else module, attr)


@contextlib.contextmanager
def bound(owners: Sequence[tuple], tensors: Sequence[torch.Tensor]):
    """The modules' parameters replaced by `tensors` for the duration (a
    layer group run on its gathered parameters)."""
    saved = [mod._parameters[attr] for mod, attr in owners]
    for (mod, attr), t in zip(owners, tensors):
        mod._parameters[attr] = t
    try:
        yield
    finally:
        for (mod, attr), p in zip(owners, saved):
            mod._parameters[attr] = p


@dataclasses.dataclass
class ZeroGathered:
    """What the stage-2/3 gather hands the step: the state's step it was
    made for, the key shards after this step's EMA (the step commits
    them), the key encoder's group-0 parameters (layer-granular), and an
    event after the gather on the card."""

    step: int
    k_shards: list
    k_group0: Optional[list] = None
    event: Optional[Any] = None


class ZeroLayout:
    """A train state's ZeRO side (the port's counterpart of JAX's (n, m)
    opt-state and param trees): the leaves in JAX's order, the bucket and
    group plans, this rank's (m,) shards, and the moves between the
    modules' whole parameters and the shards. Built by
    core/moco.py::shard_state."""

    def __init__(self, encoder_q, encoder_k, predictor, world, stage: int,
                 layer_granular: bool, bucket_mb: float):
        from moco_tpu_torch.convert import flax_param_paths

        self.world = world
        self.n, self.rank = world.num_data, world.data_rank  # the data axis's
        self.stage, self.layer = int(stage), bool(layer_granular)
        self.stage23 = self.stage >= 2
        self.bucket_bytes = int(bucket_mb * 1024 * 1024)
        self.encoder_q, self.encoder_k, self.predictor = encoder_q, encoder_k, predictor
        leaves = []
        for side, mod_q, mod_k in (("enc", encoder_q, encoder_k), ("pred", predictor, None)):
            if mod_q is None:
                continue
            paths = flax_param_paths(mod_q)
            twins = dict(mod_k.named_parameters()) if mod_k is not None else {}
            side_leaves = []
            for name, p in mod_q.named_parameters():
                side_leaves.append(ZeroLeaf(
                    side, paths[name], name, p, _owner(mod_q, name),
                    twins.get(name), _owner(mod_k, name) if mod_k is not None else None,
                    tuple(p.shape), p.dtype,
                    p.dim() == 4 and p.is_contiguous(memory_format=torch.channels_last)
                    and not p.is_contiguous(), not p.requires_grad))
            leaves += sorted(side_leaves, key=lambda leaf: leaf.path)
        self.trainable = leaves
        self.enc = [leaf for leaf in leaves if leaf.side == "enc"]
        self.plan_trainable = BucketPlan(self.trainable, self.n, self.bucket_bytes)
        self.plan_enc = BucketPlan(self.enc, self.n, self.bucket_bytes)
        self.group_plan = self.pred_plan = None
        self.group_names: tuple = ()
        if self.layer:
            backbone = encoder_q.backbone
            children = backbone.group_param_names()
            specs = []
            for g in backbone.group_names:
                specs.append((g, tuple(i for child in children[g] for i, leaf in enumerate(self.enc)
                                       if leaf.path[0] == "backbone" and leaf.path[1] == child)))
            specs.append(("head", tuple(i for i, leaf in enumerate(self.enc)
                                        if leaf.path[0] == "head")))
            self.group_plan = GroupPlan(self.enc, specs, self.n, self.bucket_bytes)
            self.group_names = tuple(g.name for g in self.group_plan.groups)
            pred = [leaf for leaf in self.trainable if leaf.side == "pred"]
            if pred:
                self.pred_plan = BucketPlan(pred, self.n, self.bucket_bytes)
        with torch.no_grad():
            self.q_shards = self.plan_trainable.local_shards([lf.q for lf in self.trainable],
                                                             self.rank)
            self.k_shards = (self.plan_enc.local_shards([lf.k for lf in self.enc], self.rank)
                             if self.stage23 else None)
        for s, leaf in zip(self.q_shards, self.trainable):
            s.requires_grad_(not leaf.frozen)
        self.hbm_model_peak_bytes = self._model_peak_bytes() if self.stage23 else None

    # -- sizes ---------------------------------------------------------------

    def _model_peak_bytes(self) -> int:
        """JAX's analytic per-rank model-memory high-water mark
        (moco_tpu/core/moco.py:542-550): the query and key shards, plus the
        whole trees the step gathers, or under the layer schedule the
        largest adjacent pair of (encoder groups..., predictor)."""
        full = lambda leaves: sum(lf.size * lf.dtype.itemsize for lf in leaves)  # noqa: E731
        resident = self.plan_trainable.shard_bytes() + self.plan_enc.shard_bytes()
        if not self.layer:
            return resident + full(self.trainable) + full(self.enc)
        sizes = [g.full_bytes for g in self.group_plan.groups]
        pred = full([lf for lf in self.trainable if lf.side == "pred"])
        if pred:
            sizes.append(pred)
        return resident + peak_of_adjacent(sizes)

    def shard_tensors(self) -> list:
        """The persistent shards: the query side's, and at stage 2/3 the
        key encoder's."""
        return list(self.q_shards) + (list(self.k_shards) if self.stage23 else [])

    # -- the modules' whole parameters --------------------------------------------

    def _side(self, side: str) -> list:
        return ([(lf.q, lf) for lf in self.trainable] if side == "q"
                else [(lf.k, lf) for lf in self.enc])

    def release(self, side: str) -> None:
        """Free the whole parameters of `side` ("q": the query encoder and
        the predictor, "k": the key encoder): each becomes an empty tensor,
        so a forward that meets one fails instead of reading stale memory."""
        for p, leaf in self._side(side):
            p.grad = None
            if p.numel():
                p.data = torch.empty(0, dtype=leaf.dtype, device=p.device)

    def materialize(self, side: str) -> list:
        """Memory for the whole parameters of `side` (contents undefined),
        in their own memory format; returns them in leaf order."""
        out = []
        for p, leaf in self._side(side):
            if tuple(p.shape) != leaf.shape:
                p.data = _empty_full(leaf.shape, leaf.dtype, p.device, leaf.channels_last)
            out.append(p)
        return out

    def released(self, side: str) -> bool:
        return any(tuple(p.shape) != leaf.shape for p, leaf in self._side(side))

    @torch.no_grad()
    def gather_into(self, side: str, site: Optional[str] = None, shards=None) -> None:
        """All-gather the shards of `side` (default the state's) into its
        modules' whole parameters."""
        plan = self.plan_trainable if side == "q" else self.plan_enc
        shards = shards if shards is not None else (self.q_shards if side == "q" else self.k_shards)
        plan.gather(self.world, shards, site, out=self.materialize(side))

    @torch.no_grad()
    def shard_from_modules(self) -> None:
        """The shards from the modules' whole parameters (after a load)."""
        rows = self.plan_trainable.local_shards([lf.q for lf in self.trainable], self.rank)
        torch._foreach_copy_(self.q_shards, rows)
        if self.stage23:
            rows = self.plan_enc.local_shards([lf.k for lf in self.enc], self.rank)
            torch._foreach_copy_(self.k_shards, rows)

    # -- the step's parts -------------------------------------------------------

    @torch.no_grad()
    def gather_params(self, momentum: float, step: int) -> ZeroGathered:
        """Stage 2/3's gather (JAX's `gather_core` / `gather_core_layer`):
        the key shards' EMA toward the query shards on this rank's rows, no
        collective; then the query tree (`zero.gather_q`) and the new key
        shards (`zero.gather_k`) gathered into the modules, or under the
        layer schedule the key encoder's first group alone
        (`zero.gather.k.<group>`)."""
        q_enc = [s for s, lf in zip(self.q_shards, self.trainable) if lf.side == "enc"]
        k_new = torch._foreach_mul(self.k_shards, momentum)
        torch._foreach_add_(k_new, q_enc, alpha=1.0 - momentum)
        g0 = None
        if self.layer:
            plan = self.group_plan
            g0 = plan.gather_group(self.world, plan.group_shards(k_new, 0), 0, "zero.gather.k",
                                   channels_last=[self.enc[i].channels_last
                                                  for i in plan.groups[0].indices])
        else:
            self.gather_into("q", "zero.gather_q")
            self.gather_into("k", "zero.gather_k", k_new)
        event = None
        if self.world.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.world.device))
        return ZeroGathered(int(step), k_new, g0, event)

    def _set_shard_grads(self, grads: Sequence) -> None:
        for s, g, leaf in zip(self.q_shards, grads, self.trainable):
            s.grad = None if leaf.frozen else g

    def _full_grads(self) -> list:
        return [lf.q.grad for lf in self.trainable]

    def stage1_update(self, optimizer) -> None:
        """JAX's `sharded_update`: the gradients' reduce-scatter (a sum,
        then the division by n; site `zero.grad_reduce_scatter`), the
        optimizer on this rank's rows of the parameters, and the updated
        rows all-gathered into the parameters (`zero.params_all_gather`). A
        frozen leaf stays as it was."""
        world, n = self.world, self.n
        grads = self._full_grads()
        world.ledger.record("zero.grad_reduce_scatter", "psum_scatter",
                            sum(lf.size * lf.dtype.itemsize for lf in self.trainable), n,
                            operands=[g for g in grads if g is not None])
        sh = self.plan_trainable.scatter_mean(world, grads, site=None)
        with torch.no_grad():
            rows = self.plan_trainable.local_shards([lf.q for lf in self.trainable], self.rank)
            torch._foreach_copy_(self.q_shards, rows)
        self._set_shard_grads(sh)
        optimizer.step()
        world.ledger.record("zero.params_all_gather", "all_gather",
                            self.plan_trainable.shard_bytes(), n, operands=self.q_shards)
        with torch.no_grad():
            self.plan_trainable.gather(world, self.q_shards, None,
                                       out=[lf.q for lf in self.trainable])
        for lf in self.trainable:
            lf.q.grad = None

    def zero23_update(self, optimizer) -> None:
        """JAX's `zero23_update`: the bucketed reduce-scatter of the whole
        local gradients (`zero.scatter.b<i>`), the optimizer on the shards,
        no gather after it; the query side's whole parameters are freed."""
        sh = self.plan_trainable.scatter_mean(self.world, self._full_grads(), site="zero.scatter")
        self._set_shard_grads(sh)
        optimizer.step()
        self.release("q")

    def layer_update(self, optimizer) -> None:
        """JAX's `zero_layer_update`: the segments' backward left the ranks'
        sums on the shards; divided by n, then the optimizer."""
        with torch.no_grad():
            for s in self.q_shards:
                if s.grad is not None:
                    s.grad.div_(self.n)
        optimizer.step()

    # -- the layer-granular forwards --------------------------------------------

    def _run_group(self, encoder, group: str, x):
        if group == "head":
            return encoder.head(x)
        return encoder.backbone.forward_group(group, x)

    def _group_buffers(self, encoder, group: str) -> list:
        mods = [encoder.head] if group == "head" else encoder.backbone.group_modules(group)
        return [b for m in mods for b in m.buffers()]

    def _group_cl(self, gi: int) -> list:
        return [self.enc[i].channels_last for i in self.group_plan.groups[gi].indices]

    @torch.no_grad()
    def layer_key_forward(self, gathered: ZeroGathered, x):
        """The key encoder group by group (JAX's `layer_key_forward`): group
        g + 1's gather is issued before group g runs and waited on after
        it; each group's whole parameters are dropped once it has run."""
        plan = self.group_plan
        full = gathered.k_group0
        for gi, g in enumerate(self.group_names):
            nxt = None
            if gi + 1 < len(self.group_names):
                nxt = plan.gather_group_async(
                    self.world, plan.group_shards(gathered.k_shards, gi + 1), gi + 1,
                    "zero.gather.k")
            owners = [self.enc[i].k_owner for i in plan.groups[gi].indices]
            with bound(owners, full):
                x = self._run_group(self.encoder_k, g, x)
            full = None
            if nxt is not None:
                full = nxt.finish(channels_last=self._group_cl(gi + 1))
        return x

    def layer_query_forward(self, x):
        """The query encoder group by group (JAX's `layer_query_forward`):
        each group a rematerialized segment that gathers the group's
        parameters (`zero.gather.q.<group>`, a differentiable gather whose
        backward reduce-scatters onto the shards) and runs it; the
        backward re-gathers the group and frees it again."""
        plan = self.group_plan
        enc_shards = [s for s, lf in zip(self.q_shards, self.trainable) if lf.side == "enc"]
        for gi, g in enumerate(self.group_names):
            idx = plan.groups[gi].indices
            owners = [self.enc[i].q_owner for i in idx]
            cl = self._group_cl(gi)

            def seg(x, *shards, gi=gi, g=g, owners=owners, cl=cl):
                full = GatherGroup.apply(self.world, plan.groups[gi].plan,
                                         f"zero.gather.q.{g}", cl, *shards)
                with bound(owners, full):
                    return self._run_group(self.encoder_q, g, x)

            x = remat_call(seg, self._group_buffers(self.encoder_q, g), x,
                           *[enc_shards[i] for i in idx])
        return x

    def layer_pred_forward(self, x):
        """v3's predictor as one more segment (`zero.gather.q.pred`)."""
        pred = [(s, lf) for s, lf in zip(self.q_shards, self.trainable) if lf.side == "pred"]
        owners = [lf.q_owner for _, lf in pred]

        def seg(x, *shards):
            full = GatherGroup.apply(self.world, self.pred_plan, "zero.gather.q.pred",
                                     None, *shards)
            with bound(owners, full):
                return self.predictor(x)

        return remat_call(seg, list(self.predictor.buffers()), x, *[s for s, _ in pred])

    # -- checkpoints: whole tensors in, whole tensors out -------------------------

    @torch.no_grad()
    def full_state_dicts(self) -> dict:
        """{"q", "k", "predictor": state dicts} with whole parameters (a
        collective at stage 2/3: the shards are gathered into new tensors;
        the modules stay as they are)."""
        out = {"q": None, "k": None, "predictor": None}
        if not self.stage23:
            return out
        cl = [lf.channels_last for lf in self.trainable]
        q_full = self.plan_trainable.gather(self.world, self.q_shards, channels_last=cl)
        k_full = self.plan_enc.gather(self.world, self.k_shards,
                                      channels_last=[lf.channels_last for lf in self.enc])
        for key, module, pairs in (
                ("q", self.encoder_q, [(lf, t) for lf, t in zip(self.trainable, q_full)
                                       if lf.side == "enc"]),
                ("k", self.encoder_k, list(zip(self.enc, k_full))),
                ("predictor", self.predictor, [(lf, t) for lf, t in zip(self.trainable, q_full)
                                               if lf.side == "pred"])):
            if module is None:
                continue
            sd = dict(module.state_dict())
            sd.update({lf.name: t for lf, t in pairs})
            out[key] = sd
        return out

    def _opt_leaves(self, optimizer) -> list:
        index = {id(s): i for i, s in enumerate(self.q_shards)}
        return [index[id(p)] for group in optimizer.param_groups for p in group["params"]]

    @torch.no_grad()
    def full_optimizer_state(self, optimizer) -> dict:
        """The optimizer's state dict with every per-parameter buffer
        gathered to its parameter's whole shape (a collective): the state
        dict the replicated optimizer over the same parameters has."""
        sd = optimizer.state_dict()  # its per-parameter dicts are the live ones
        sd = {**sd, "state": {i: dict(st) for i, st in sd["state"].items()}}
        leaves = self._opt_leaves(optimizer)
        keys = sorted({k for st in sd["state"].values() for k, v in st.items()
                       if torch.is_tensor(v) and v.dim() == 1})
        for key in keys:
            shards = [torch.zeros_like(s) for s in self.q_shards]
            for i, li in enumerate(leaves):
                st = sd["state"].get(i)
                if st is not None and key in st:
                    shards[li] = st[key]
            full = self.plan_trainable.gather(
                self.world, shards, channels_last=[lf.channels_last for lf in self.trainable])
            for i, li in enumerate(leaves):
                st = sd["state"].get(i)
                if st is not None and key in st:
                    st[key] = full[li]
        return sd

    def load_optimizer_state(self, optimizer, full: dict) -> None:
        """A replicated optimizer's state dict (whole buffers) -> this rank's
        rows, loaded into the shard optimizer."""
        leaves = self._opt_leaves(optimizer)
        state = {}
        for i, st in full["state"].items():
            leaf = self.trainable[leaves[int(i)]]
            m = padded_cols(leaf.size, self.n)
            state[int(i)] = {
                k: (_flat_rows(v, self.n, m)[self.rank].clone()
                    if torch.is_tensor(v) and v.dim() >= 1 and v.numel() == leaf.size else v)
                for k, v in st.items()}
        optimizer.load_state_dict({"state": state, "param_groups": full["param_groups"]})
