"""The process world of parallel training: the port's counterpart of
moco_tpu/parallel/mesh.py.

JAX lays its devices out as a `Mesh` with a `data` and a `model` axis and
runs the step once over it (`create_mesh`, `initialize_multihost` on a
pod). The port runs one process per GPU, as upstream's `main_moco.py`
does: a `World` says which rank this process is, how many there are,
which device it drives and which process groups it belongs to, and carries
the step's collectives, each of which records its site in the world's
comms ledger (obs/comms.py).

The model axis: a world of num_data x num_model ranks lays rank r at data
index r // num_model and model index r % num_model, the device order of
`create_mesh`'s reshape(num_data, num_model) (`mesh_layout`). The data
group of a rank holds the ranks of its model index (one per data index),
its model group the ranks of its data index; every rank creates every
group, as `dist.new_group` requires. `rank` and `world_size` are the
process's; `data_rank` / `num_data` and `model_rank` / `num_model` are its
place on each axis. The data-parallel collectives below run over the data
group; `model_gather` (differentiable), `model_all_reduce_sum_` and
`ring()` (parallel/ring_attention.py: the ring's shifts and the gap
pool's sum) over the model group, which the sharded queue and sequence
parallelism take (core/moco.py, models/vit.py); `barrier`,
`any`, `broadcast_int` and `all_gather_rows(..., over="world")` over every
rank. With num_model = 1 the data group is the world's and nothing changes.

- `World()` with no group is one device: no process group exists and no
  collective is ever issued; the step then runs as it always has.
- `init_world(...)` makes a process group: NCCL on the card, gloo where
  the caller asks for the CPU (the tests) or for gloo itself (two ranks
  on one card, which NCCL refuses). It reads torchrun's `RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`, or takes
  them as arguments with a `FileStore` path (no ports), sets the CUDA
  device before `init_process_group(device_id=...)`, and gives the group
  the timeout it is given (ParallelConfig.timeout_s).
- SyncBN's groups (`syncbn_stats`): the whole data group, or its
  subgroups of `syncbn_group_size` consecutive ranks, JAX's
  `axis_index_groups`; every rank creates every subgroup, as
  `dist.new_group` requires.
- ZeRO's flat collectives (parallel/zero.py): `all_gather_flat` (async on
  request) and `reduce_scatter_flat` (a sum), and JAX's per-leaf trio `scatter_mean`,
  `local_shard` and `unshard`; each records its site when named. They
  run over the data group: on a model axis ZeRO shards the state over the
  data ranks, and the model ranks of a data index hold the same shards
  (the gradients' mean over the model group, `model_all_reduce_mean_`,
  comes first).
- `abort()` tears the process group down without its peers (a dead rank
  of an elastic run, parallel/elastic.py): the communicators are aborted,
  not destroyed, so no exit waits on a peer or on a store whose host is
  gone; `close()` is then a no-op.

The multi-slice mesh (`create_multislice_mesh`) has no counterpart: a
process group spans hosts as it spans GPUs. moco_tpu/parallel/compat.py
holds JAX version shims and has no counterpart.
"""

from __future__ import annotations

import datetime
import gc
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from moco_tpu_torch.obs.comms import CommsLedger, tensor_bytes

# all_gather into one tensor: the name changed (all_gather_into_tensor is
# deprecated in newer torch), the semantics did not
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _AllReduceMean(torch.autograd.Function):
    """The mean of `x` over a group; its backward is the mean of the
    cotangent over the group, the transpose JAX's pmean has under
    shard_map (each rank's loss reaches every rank's input through the
    mean)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y.div_(size)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g.div_(ctx.size), None, None


def mesh_layout(num_data: int, num_model: int) -> np.ndarray:
    """(num_data, num_model) process ranks: row d is data index d's model
    group, column m model index m's data group (`create_mesh`'s order)."""
    return np.arange(num_data * num_model).reshape(num_data, num_model)


def split_world(world_size: int, num_model: int, num_data: Optional[int] = None) -> int:
    """num_data of a launch of `world_size` ranks (None: world_size //
    num_model), with `create_mesh`'s messages."""
    if num_data is None:
        if world_size % num_model:
            raise ValueError(f"{world_size} devices not divisible by model={num_model}")
        num_data = world_size // num_model
    if num_data * num_model > world_size:
        raise ValueError(f"need {num_data * num_model} devices, have {world_size}")
    if num_data * num_model != world_size:
        raise ValueError(f"num_data={num_data} x num_model={num_model} but the launch has "
                         f"{world_size} rank(s): one process per GPU, every rank on the mesh")
    return num_data


class _ModelGather(torch.autograd.Function):
    """(n, *x.shape): every model rank's `x`, model-rank order. Its backward
    is the sum of the cotangent over the group, this rank's row of it: the
    transpose of JAX's all_gather under shard_map (a psum_scatter)."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return world._model_all_gather(x)

    @staticmethod
    def backward(ctx, g):
        w = ctx.world
        g = g.contiguous().clone()
        dist.all_reduce(g, group=w.model_group)
        return g[w.model_rank], None


class StatsGroup:
    """The group a SyncBN layer averages its moments over. Shared, not
    copied, when a module holding it is deep-copied (the key encoder is a
    copy of the query encoder)."""

    def __init__(self, group, size: int):
        self.group, self.size = group, int(size)

    def __deepcopy__(self, memo):
        return self

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable mean of `x` over the group: a sum all-reduce, then
        a division (gloo has no ReduceOp.AVG)."""
        return _AllReduceMean.apply(x, self.group, self.size)


class World:
    """This process's place on the mesh (module docstring). `group` is the
    whole world's; `data_group` and `model_group` its axes' (the data group
    is `group` when num_model is 1, the model group None then). No `group`
    means no process group, one device."""

    def __init__(self, rank: int = 0, world_size: int = 1, local_rank: int = 0,
                 device="cuda", group=None, backend: Optional[str] = None,
                 num_model: int = 1, data_group=None, model_group=None):
        self.rank, self.world_size, self.local_rank = int(rank), int(world_size), int(local_rank)
        self.num_model = int(num_model)
        self.num_data = split_world(self.world_size, self.num_model)
        self.device = torch.device(device)
        self.group, self.backend = group, backend
        self.data_group = group if self.num_model == 1 else data_group
        self.model_group = None if self.num_model == 1 else model_group
        self.ledger = CommsLedger()
        self._stats_groups: dict[int, StatsGroup] = {}

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_rank(self) -> int:
        return self.rank // self.num_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.num_model

    # -- groups -------------------------------------------------------------

    def syncbn_stats(self, group_size: int = 0) -> StatsGroup:
        """The rank's SyncBN group: the data group (`group_size` 0 or the
        data axis's size) or its subgroup of `group_size` consecutive data
        ranks, with JAX's message when the axis does not divide."""
        n = self.num_data
        g = int(group_size) or n
        if n % g:
            raise ValueError(f"data axis {n} not divisible by syncbn group {g}")
        if g not in self._stats_groups:
            if g == n:
                self._stats_groups[g] = StatsGroup(self.data_group, n)
            else:
                mine = None
                # collective: every rank makes every group of every model index
                for m in range(self.num_model):
                    for start in range(0, n, g):
                        ranks = [d * self.num_model + m for d in range(start, start + g)]
                        pg = dist.new_group(ranks)
                        if self.rank in ranks:
                            mine = pg
                self._stats_groups[g] = StatsGroup(mine, g)
        return self._stats_groups[g]

    # -- collectives over the model group ---------------------------------------

    def _model_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        n = self.num_model
        x = x.contiguous()
        if self.model_group is None:
            return x[None].clone()
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        if self.backend == "gloo":
            dist.all_gather(list(out.unbind(0)), x, group=self.model_group)
        else:
            _all_gather_into(out.view(-1), x.view(-1), group=self.model_group)
        return out

    def model_gather(self, x: torch.Tensor, site: Optional[str] = None) -> torch.Tensor:
        """(num_model, *x.shape): every model rank's `x`, differentiable
        (`_ModelGather`); `site` names it in the ledger."""
        if site is not None:
            self.ledger.record(site, "all_gather", tensor_bytes([x]), self.num_model,
                               operands=[x])
        if self.model_group is None:
            return x[None]
        return _ModelGather.apply(x, self)

    @torch.no_grad()
    def model_all_reduce_sum_(self, tensors: list, site: Optional[str] = None) -> None:
        """Replace each tensor (None entries skipped) by its sum over the
        model group, in place, through one flat all-reduce."""
        tensors = [t for t in tensors if t is not None]
        if site is not None:
            self.ledger.record(site, "psum", tensor_bytes(tensors), self.num_model,
                               operands=tensors)
        if self.model_group is None or not tensors:
            return
        flat = torch._utils._flatten_dense_tensors(tensors)
        dist.all_reduce(flat, group=self.model_group)
        torch._foreach_copy_(tensors, torch._utils._unflatten_dense_tensors(flat, tensors))

    @torch.no_grad()
    def model_all_reduce_mean_(self, tensors: list) -> None:
        """Replace each tensor (None entries skipped) by its mean over the
        model group, in place, through one flat all-reduce (JAX's
        `lax.pmean(grads, MODEL_AXIS)` before a ZeRO update, which records
        no ledger site)."""
        tensors = [t for t in tensors if t is not None]
        if self.model_group is None or not tensors:
            return
        flat = torch._utils._flatten_dense_tensors(tensors)
        dist.all_reduce(flat, group=self.model_group)
        flat.div_(self.num_model)
        torch._foreach_copy_(tensors, torch._utils._unflatten_dense_tensors(flat, tensors))

    def ring(self):
        """The model group as the ring of parallel/ring_attention.py."""
        from moco_tpu_torch.parallel.ring_attention import Ring

        return Ring(self.model_group, self.num_model, self.model_rank, self.ledger)

    # -- collectives over the data group ---------------------------------------

    def barrier(self) -> None:
        """Every rank of the world meets."""
        if not self.distributed:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=self.group)

    def all_gather_rows(self, x: torch.Tensor, site: Optional[str] = None,
                        over: str = "data") -> torch.Tensor:
        """(n * b, ...) from every data rank's (b, ...), data-rank order
        (`over="world"`: every rank's, rank order); `site` names it in the
        ledger."""
        n, group = ((self.num_data, self.data_group) if over == "data"
                    else (self.world_size, self.group))
        if site is not None:
            self.ledger.record(site, "all_gather", tensor_bytes([x]), n, operands=[x])
        if not self.distributed:
            return x
        x = x.contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        if self.backend == "gloo":  # gloo takes a card's tensors in the list form
            dist.all_gather(list(out.chunk(n)), x, group=group)
        else:
            _all_gather_into(out, x, group=group)
        return out

    def all_to_all_rows(self, x: torch.Tensor, site: Optional[str] = None) -> torch.Tensor:
        """JAX's tiled all_to_all over the batch: chunk j of this rank's
        rows goes to rank j, and the rows from rank i arrive as chunk i."""
        n = self.num_data
        if x.shape[0] % n:
            raise ValueError(f"a2a shuffle needs local batch {x.shape[0]} divisible by "
                             f"axis size {n}")
        if site is not None:
            self.ledger.record(site, "all_to_all", tensor_bytes([x]), n, operands=[x])
        if not self.distributed:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.data_group)
        return out

    @torch.no_grad()
    def all_reduce_mean_(self, tensors: list, site: Optional[str] = None,
                         over: str = "data") -> None:
        """Replace each tensor (float32; None entries skipped) by its mean
        over the data group (`over="world"`: over every rank, JAX's pmean
        over (data, model)), in place, through one flat all-reduce (the
        order of `tensors` must be the same on every rank)."""
        n, group = ((self.num_data, self.data_group) if over == "data"
                    else (self.world_size, self.group))
        tensors = [t for t in tensors if t is not None]
        if site is not None:
            self.ledger.record(site, "psum", tensor_bytes(tensors), n, operands=tensors)
        if not self.distributed or not tensors:
            return
        flat = torch._utils._flatten_dense_tensors(tensors)
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        torch._foreach_copy_(tensors, torch._utils._unflatten_dense_tensors(flat, tensors))

    # -- ZeRO's flat collectives (parallel/zero.py) -----------------------------

    def all_gather_flat(self, shard: torch.Tensor, site: Optional[str] = None,
                        async_op: bool = False):
        """(n * m,) from every rank's (m,) `shard`, rank order; with
        `async_op`, (out, work or None): `out` holds the result once
        `work.wait()` has returned."""
        if site is not None:
            self.ledger.record(site, "all_gather", tensor_bytes([shard]), self.num_data,
                               operands=[shard])
        shard = shard.contiguous()
        if not self.distributed:
            out, work = shard.clone(), None
        else:
            out = torch.empty(self.num_data * shard.numel(), dtype=shard.dtype,
                              device=shard.device)
            if self.backend == "gloo":
                work = dist.all_gather(list(out.chunk(self.num_data)), shard,
                                       group=self.data_group, async_op=True)
            else:
                work = _all_gather_into(out, shard, group=self.data_group, async_op=True)
        if async_op:
            return out, work
        if work is not None:
            work.wait()
        return out

    @torch.no_grad()
    def reduce_scatter_flat(self, block: torch.Tensor, site: Optional[str] = None) -> torch.Tensor:
        """This rank's (m,) rows of the sum over the ranks of the (n * m,)
        `block`: one reduce-scatter (NCCL's, and gloo's on the CPU and on
        CUDA tensors, which the installed gloo takes: chip_smoke 12i reports
        it)."""
        n = self.num_data
        if site is not None:
            self.ledger.record(site, "psum_scatter", tensor_bytes([block]), n,
                               operands=[block])
        m = block.numel() // n
        if not self.distributed:
            return block.reshape(-1).clone()
        block = block.contiguous()
        out = torch.empty(m, dtype=block.dtype, device=block.device)
        _reduce_scatter_into(out, block, group=self.data_group)
        return out

    def scatter_mean(self, x: torch.Tensor, site: Optional[str] = None) -> torch.Tensor:
        """The ranks' mean of a full local leaf, this rank's (m,) rows of it
        (zero-padded to n * m)."""
        from moco_tpu_torch.parallel.zero import padded_cols

        n = self.num_data
        m = padded_cols(x.numel(), n)
        flat = torch.nn.functional.pad(x.reshape(-1), (0, n * m - x.numel()))
        return self.reduce_scatter_flat(flat, site).div_(n)

    def local_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (m,) rows of a full leaf (a copy)."""
        from moco_tpu_torch.parallel.zero import padded_cols

        n = self.num_data
        m = padded_cols(x.numel(), n)
        flat = torch.nn.functional.pad(x.reshape(-1), (0, n * m - x.numel()))
        return flat[self.data_rank * m:(self.data_rank + 1) * m].clone()

    def unshard(self, shard: torch.Tensor, like: torch.Tensor,
                site: Optional[str] = None) -> torch.Tensor:
        """Every rank's (m,) shard gathered back into a leaf shaped `like`."""
        full = self.all_gather_flat(shard, site)
        return full[:like.numel()].reshape(like.shape).to(like.dtype)

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of `x` over the data group, a new tensor (no gradient)."""
        if not self.distributed:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.data_group)
        return y.div_(self.num_data)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the data group, a new tensor (no gradient)."""
        if not self.distributed:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.data_group)
        return y

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank of the world (a host value: a
        sync)."""
        if not self.distributed:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def broadcast_int(self, value: int) -> int:
        """Rank 0's `value` on every rank."""
        if not self.distributed:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.comm_device)
        dist.broadcast(t, src=0, group=self.group)
        return int(t.item())

    @property
    def comm_device(self) -> torch.device:
        """Where a host value travels: the rank's card under NCCL."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def close(self) -> None:
        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()
        self.group = self.data_group = self.model_group = None

    def abort(self) -> None:
        """Abort every communicator of this process (module docstring) and
        drop this world's references to its groups. Under gloo the group's
        sockets stay open after the abort (the process's socket count does
        not drop), so a peer blocked in a collective on this rank fails only
        at the group's timeout. Idempotent."""
        if self.distributed and dist.is_initialized():
            try:
                dist.distributed_c10d._abort_process_group()
            except Exception as e:  # the group is broken already; leaving is the point
                print(f"rank {self.rank}: process group abort raised {e!r}", flush=True)
        for stats in self._stats_groups.values():
            stats.group = None
        self.group = self.data_group = self.model_group = None
        gc.collect()


def init_world(backend: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, local_rank: Optional[int] = None,
               device=None, store_path: Optional[str] = None,
               timeout_s: float = 600.0, num_model: int = 1,
               num_data: Optional[int] = None) -> World:
    """A process group and this rank's World (module docstring). Arguments
    left None come from torchrun's environment; `device` defaults to
    `cuda:<local_rank>`; `backend` to NCCL on a card and gloo on the CPU.
    `store_path` rendezvouses through a FileStore instead of
    MASTER_ADDR / MASTER_PORT. With `num_model` > 1 the launch's ranks are
    num_data x num_model (`num_data` None: WORLD_SIZE // num_model, with
    `create_mesh`'s message when it does not divide) and the data and model
    groups are made. No fallback: a failing backend raises."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    num_data = split_world(world_size, int(num_model), num_data)
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else int(local_rank)
    device = torch.device(f"cuda:{local_rank}" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if store_path is not None:
        kwargs["store"] = dist.FileStore(store_path, world_size)
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kwargs)
    data_group = model_group = None
    if num_model > 1:  # collective: every rank makes every group, in one order
        layout = mesh_layout(num_data, num_model)
        for m in range(num_model):
            g = dist.new_group([int(r) for r in layout[:, m]])
            if rank % num_model == m:
                data_group = g
        for d in range(num_data):
            g = dist.new_group([int(r) for r in layout[d]])
            if rank // num_model == d:
                model_group = g
    return World(rank, world_size, local_rank, device, group=dist.group.WORLD, backend=backend,
                 num_model=num_model, data_group=data_group, model_group=model_group)
