"""The embedding index, the counterpart of moco_tpu/serve/index.py.

MoCo's dictionary as a serving store: (K, d) L2-normalized rows on the
device, FIFO and snapshot ingest, and top-k cosine queries in three tiers:

- **exact** (`topk_cosine`): one (m, K) matmul + top-k over the valid
  rows; the oracle for the approximate tiers.
- **ivf** (`train_ivf` + `_ivf_topk`): spherical k-means cells stored as a
  dense padded (nlist, cell_cap) id table (padded slots hold the sentinel
  id `capacity`); a query scores the `nprobe` nearest centroids, gathers
  those cells' rows and scans only them.
- **ivf_fused** (`_ivf_topk_fused_kernel`): the same candidates scored
  straight out of a cell-major (nlist, cell_cap, d) copy of the rows by
  the CUDA cell-scan kernel (`ops/ivf_scan.py`), with no (m, nprobe *
  cell_cap, d) candidate gather; on a CPU index the kernel's plain
  version runs instead.

An **int8 scoring path** (`enable_int8`) twins each tier: a symmetric
per-row int8 mirror of the store (`q = round(127 x / max|x|)`, one f32
scale per row, zero rows at scale 1), kept fresh by every snapshot, FIFO
write and wrap; queries are quantized the same way, scores accumulate in
int32 and are rescaled to f32 as `acc * q_scale * row_scale`, under
JAX's mask and top-k contract:

- **exact_i8**: one (m, K) int8 product through `torch._int_mm`
  (`ops/int8.py`; the mirror is kept padded to multiples of 8);
- **ivf_i8** / **ivf_fused_i8**: the composed and the looped IVF scans on
  the gathered int8 candidates, their products taken in f32 on the int8
  values. Each product is at most 127^2 and a row sums d of them, so the
  f32 sums are exact integers while d * 127^2 < 2^24, i.e. d <= 1040
  (d = 128: 2.06e6); a wider index sums in float64, also exactly. The
  int8 twins do not reach the cell-scan kernel, as in JAX.

Every written row carries a wall-clock ingest stamp (a host float64 per
slot, NaN for never written): `snapshot` stamps the rows it loads and
`add` the slots it overwrites, at `now` (the clock unless given);
`row_age_stats` reads the valid rows' ages, the raw signal of the
serving freshness SLO.

PyTorch runs eagerly, so there is nothing to compile ahead of time; the
`prepare` / `freeze` contract is kept all the same: `prepare` runs each
(mode, m, k, nprobe) shape once, and after `freeze` an unprepared shape
raises `IndexRecompileError`, which is what keeps serving traffic on the
engine's padded buckets. `warm` runs every prepared shape once more on the
calling thread (the serving batcher's warm-up pass). Mesh sharding comes
with the fleet.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from moco_tpu_torch.ops.ivf_scan import fused_cell_scores
from moco_tpu_torch.ops.losses import l2_normalize
from moco_tpu_torch.ops.int8 import int8_matmul
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.device import resolve_device

DEFAULT_KMEANS_ITERS = 10
# modes query()/prepare() understand; "*_i8" score in int8 (enable_int8)
QUERY_MODES = ("exact", "ivf", "exact_i8", "ivf_i8", "ivf_fused", "ivf_fused_i8")
# the largest d whose int8 candidate products sum exactly in f32: d * 127^2 < 2^24
I8_F32_EXACT_DIM = (2**24 - 1) // 127**2


def fifo_write(rows: torch.Tensor, ptr: int, values: torch.Tensor) -> tuple[torch.Tensor, int]:
    """FIFO block write of `values` (N, d) at `ptr`, in place; returns
    (rows, new_ptr). The write never wraps: callers keep K % N == 0 or
    split the block (`EmbeddingIndex.add`)."""
    n = values.shape[0]
    if ptr + n > rows.shape[0]:
        raise ValueError(f"block of {n} rows at {ptr} overruns {rows.shape[0]} rows")
    rows[ptr : ptr + n] = values.detach().to(rows.dtype)
    return rows, (ptr + n) % rows.shape[0]


def topk_cosine(
    queries: torch.Tensor, rows: torch.Tensor, k: int, valid_count: Optional[int] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine (scores, row ids) of L2-normalized `queries` (m, d)
    against `rows` (K, d); rows at index >= `valid_count` score -inf."""
    sims = queries @ rows.T
    if valid_count is not None:
        invalid = torch.arange(rows.shape[0], device=rows.device) >= valid_count
        sims = sims.masked_fill(invalid[None, :], -torch.inf)
    return torch.topk(sims, k)


def kmeans_fit(rows: torch.Tensor, nlist: int, iters: int = DEFAULT_KMEANS_ITERS) -> torch.Tensor:
    """Spherical k-means: `iters` Lloyd iterations over L2-normalized rows
    (n, d) -> (nlist, d) L2-normalized centroids. Strided init (every
    n//nlist-th row); an empty cell keeps its centroid. The segment sum is
    a one-hot matmul, as in the JAX package, so it is deterministic."""
    n = rows.shape[0]
    if nlist > n:
        raise ValueError(f"nlist={nlist} exceeds the {n} training rows")
    stride = max(n // nlist, 1)
    cent = l2_normalize(rows[: stride * nlist : stride])
    for _ in range(iters):
        assign = torch.argmax(rows @ cent.T, dim=1)
        onehot = torch.nn.functional.one_hot(assign, nlist).to(rows.dtype)
        sums = onehot.T @ rows
        counts = onehot.sum(0)[:, None]
        cent = l2_normalize(torch.where(counts > 0, sums / counts.clamp_min(1.0), cent))
    return cent


def _assign_top2(rows: torch.Tensor, centroids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(first, second) nearest-centroid ids per row, int32; the second is
    the fallback when the first cell is full."""
    sims = rows @ centroids.T
    first = torch.argmax(sims, dim=1)
    masked = sims.scatter(1, first[:, None], -torch.inf)
    return first.int(), torch.argmax(masked, dim=1).int()


def _quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: q = round(x / s), s = max|x| / 127 per row
    in f32 (a zero row gets scale 1, so padding stays exactly zero). The
    division by 127 is a product with the f32 reciprocal, as XLA compiles
    JAX's jitted `/ 127.0`: the scales are JAX's bit for bit."""
    s = x.abs().amax(dim=-1).float() * torch.tensor(1.0 / 127.0, dtype=torch.float32,
                                                      device=x.device)
    s = torch.where(s <= 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(x.float() / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _i8_scores(q8, cand) -> torch.Tensor:
    """(m, L) int8-grid products of queries (m, d) with their gathered
    int8 candidates (m, L, d), exact (module docstring): in f32 up to
    `I8_F32_EXACT_DIM`, in float64 beyond."""
    dt = torch.float32 if q8.shape[-1] <= I8_F32_EXACT_DIM else torch.float64
    return torch.bmm(cand.to(dt), q8.to(dt)[:, :, None])[:, :, 0].float()


def _exact_topk_int8(queries, rows_i8, row_scale, num_rows: int, dim: int, valid_count: int,
                     k: int):
    """The exact scan's int8 twin: per-row quantized queries against the
    int8 mirror ((K', d') padded to multiples of 8; only its first
    `num_rows` rows and `dim` columns hold rows) through `int8_matmul`,
    int32 accumulation, f32 rescale, `topk_cosine`'s mask and top-k."""
    q8, qs = _quantize_rows_int8(queries)
    if rows_i8.shape[1] != dim:
        q8 = torch.nn.functional.pad(q8, (0, rows_i8.shape[1] - dim))
    acc = int8_matmul(q8, rows_i8)[:, :num_rows]
    sims = acc.float() * qs[:, None] * row_scale[None, :]
    invalid = torch.arange(num_rows, device=sims.device) >= valid_count
    return torch.topk(sims.masked_fill(invalid[None, :], -torch.inf), k)


def _probe(queries, centroids, nprobe: int) -> torch.Tensor:
    """The `nprobe` nearest cells per query, (m, nprobe), best first."""
    return torch.topk(queries @ centroids.T, nprobe).indices


def _ivf_topk(queries, rows, centroids, cell_ids, valid_count: int, k: int, nprobe: int,
              row_scale=None, num_rows: Optional[int] = None):
    """Composed IVF scan: probes -> one gather of the probed cells' rows
    (m, nprobe*cell_cap, d) -> batched dot -> mask -> top-k, mapped back
    to row ids. Padded slots carry id == capacity and score -inf. With
    `row_scale`, `rows` is the int8 mirror and the candidates are scored on
    the int8 grid (`_i8_scores`) and rescaled."""
    m = queries.shape[0]
    num_rows = rows.shape[0] if num_rows is None else num_rows
    cand_ids = cell_ids[_probe(queries, centroids, nprobe)].reshape(m, -1)
    safe = cand_ids.clamp_max(num_rows - 1).long()
    cand = rows[safe]
    if row_scale is None:
        sims = torch.bmm(cand, queries[:, :, None])[:, :, 0]
    else:
        q8, qs = _quantize_rows_int8(queries)
        sims = _i8_scores(q8, cand[..., : queries.shape[1]]) * qs[:, None] * row_scale[safe]
    sims = sims.masked_fill(cand_ids >= valid_count, -torch.inf)
    scores, local = torch.topk(sims, k)
    return scores, cand_ids.gather(1, local)


def _ivf_topk_fused(queries, rows, centroids, cell_ids, valid_count: int, k: int, nprobe: int,
                    row_scale=None, num_rows: Optional[int] = None):
    """The fused scan as a loop: one probed cell per query per step, folded
    into a running top-k (the k carried best + the cell's cell_cap
    scores). Same candidates as `_ivf_topk`; -inf tail slots carry the
    sentinel id `capacity`. With `row_scale`, the int8 twin (as
    `_ivf_topk`)."""
    m = queries.shape[0]
    num_rows = rows.shape[0] if num_rows is None else num_rows
    probes = _probe(queries, centroids, nprobe)
    if row_scale is not None:
        q8, qs = _quantize_rows_int8(queries)
    best_s = torch.full((m, k), -torch.inf, device=queries.device)
    best_i = torch.full((m, k), num_rows, dtype=cell_ids.dtype, device=queries.device)
    for j in range(nprobe):
        ids = cell_ids[probes[:, j]]
        safe = ids.clamp_max(num_rows - 1).long()
        cand = rows[safe]
        if row_scale is None:
            sims = torch.bmm(cand, queries[:, :, None])[:, :, 0]
        else:
            sims = _i8_scores(q8, cand[..., : queries.shape[1]]) * qs[:, None] * row_scale[safe]
        sims = sims.masked_fill(ids >= valid_count, -torch.inf)
        merged_s = torch.cat([best_s, sims], dim=1)
        merged_i = torch.cat([best_i, ids], dim=1)
        best_s, loc = torch.topk(merged_s, k)
        best_i = merged_i.gather(1, loc)
    return best_s, best_i


def _ivf_topk_fused_kernel(
    queries, centroids, cell_ids, cell_rows, valid_count: int, k: int, nprobe: int
):
    """The fused scan through the cell-scan kernel: probes ->
    `fused_cell_scores` on the cell-major rows (no candidate-row gather)
    -> mask -> one top-k. Same candidates and mask as `_ivf_topk`."""
    m = queries.shape[0]
    probes = _probe(queries, centroids, nprobe).int()
    sims = fused_cell_scores(queries.contiguous(), cell_rows, probes).reshape(m, -1)
    cand_ids = cell_ids[probes.long()].reshape(m, -1)
    sims = sims.masked_fill(cand_ids >= valid_count, -torch.inf)
    scores, local = torch.topk(sims, k)
    return scores, cand_ids.gather(1, local)


class IndexRecompileError(RuntimeError):
    """A query shape arrived that was not prepared before freeze() —
    serving must pad to a prepared bucket."""


class EmbeddingIndex:
    """Device-resident (capacity, dim) f32 store with FIFO/snapshot ingest
    and bucketed top-k cosine queries (module docstring)."""

    def __init__(self, capacity: int, dim: int, device="cuda"):
        if capacity < 1:
            raise ValueError(f"index capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.count = 0  # valid rows
        self._ptr = 0  # FIFO write head
        self.rows = torch.zeros((self.capacity, self.dim), device=self.device)
        # wall-clock ingest stamps (the freshness SLO): one host float64 per
        # slot, NaN = never written
        self._row_time = np.full(self.capacity, np.nan, np.float64)
        # the int8 mirror (enable_int8): (K', d') int8, padded to multiples
        # of 8 for `int8_matmul`, and one f32 scale per row
        self._rows_i8: Optional[torch.Tensor] = None
        self._row_scale: Optional[torch.Tensor] = None
        self._prepared: set = set()
        self._frozen = False
        self.prepares = 0
        self._warm_prepares: Optional[int] = None
        self._ivf: Optional[dict] = None

    # -- ingest ----------------------------------------------------------

    def snapshot(self, embeddings, normalized: bool = True, now: Optional[float] = None) -> None:
        """Replace the contents with `embeddings` (n <= capacity rows) and
        reset the FIFO head. A trained IVF goes stale (retrain); the int8
        mirror is requantized. Every loaded row is stamped at `now` (the
        wall clock unless given)."""
        embs = torch.as_tensor(np.asarray(embeddings), dtype=torch.float32)
        n = embs.shape[0]
        if n > self.capacity or embs.shape[1] != self.dim:
            raise ValueError(
                f"snapshot shape {tuple(embs.shape)} exceeds index ({self.capacity}, {self.dim})"
            )
        if not normalized:
            embs = l2_normalize(embs)
        self.rows.zero_()
        self.rows[:n] = embs.to(self.device)
        self.count = n
        self._ptr = n % self.capacity
        self._row_time[:] = np.nan
        self._row_time[:n] = time.time() if now is None else now
        self._ivf = None
        if self._rows_i8 is not None:
            self._requantize_all()

    def _write_block(self, block: torch.Tensor, ptr: int) -> None:
        """One no-wrap block write at `ptr`: the rows, then the int8 mirror
        when enabled."""
        fifo_write(self.rows, ptr, block)
        if self._rows_i8 is not None:
            q, s = _quantize_rows_int8(block)
            self._rows_i8[ptr : ptr + q.shape[0], : self.dim] = q
            self._row_scale[ptr : ptr + q.shape[0]] = s

    def add(self, embeddings, now: Optional[float] = None) -> None:
        """FIFO ingest of an (N, dim) block at the write head; a block
        crossing the end splits into two writes. IVF cell membership and the
        int8 mirror follow incrementally, and every overwritten slot is
        stamped at `now` (the wall clock unless given): FIFO eviction is
        what takes the oldest stamp away with its row."""
        # a copy: an HTTP body's rows arrive in a read-only buffer
        embs = torch.from_numpy(np.array(embeddings, dtype=np.float32))
        n = embs.shape[0]
        if n == 0:
            return
        if n > self.capacity:
            raise ValueError(
                f"FIFO block of {n} rows exceeds capacity {self.capacity}; "
                "use snapshot() for bulk loads"
            )
        start = self._ptr
        head = min(n, self.capacity - start)
        written = [(start, embs[:head])]
        if head < n:
            written.append((0, embs[head:]))
        overwritten = np.concatenate([np.arange(p, p + b.shape[0]) for p, b in written])
        for p, block in written:
            self._write_block(block.to(self.device), p)
        if self._ivf is not None:
            self._ivf_reassign(overwritten, embs)
        self._row_time[overwritten] = time.time() if now is None else now
        self._ptr = (self._ptr + n) % self.capacity
        self.count = min(self.count + n, self.capacity)

    @classmethod
    def from_train_queue(
        cls, queue, queue_ptr: int = 0, count: Optional[int] = None, device="cuda"
    ) -> "EmbeddingIndex":
        """A training queue's (K, dim) rows as an index; `count=None`
        treats every row as valid."""
        rows = np.asarray(queue, np.float32)
        idx = cls(rows.shape[0], rows.shape[1], device=device)
        idx.snapshot(rows)
        idx.count = rows.shape[0] if count is None else int(count)
        idx._ptr = int(queue_ptr)
        return idx

    def row_age_stats(self, now: Optional[float] = None) -> dict:
        """Wall-clock staleness of the valid rows: max and mean seconds since
        each row's stamp; None for both while no valid row is stamped. `now`
        is injectable for tests."""
        now = time.time() if now is None else now
        stamps = self._row_time[: self.count]
        valid = stamps[np.isfinite(stamps)]
        if valid.size == 0:
            return {"row_age_max_s": None, "row_age_mean_s": None}
        ages = np.maximum(now - valid, 0.0)
        return {"row_age_max_s": float(ages.max()), "row_age_mean_s": float(ages.mean())}

    # -- int8 scoring path ----------------------------------------------

    def enable_int8(self) -> None:
        """Build the per-row int8 mirror of the store. From here on the
        `*_i8` modes answer, and every snapshot and FIFO write keeps the
        mirror fresh."""
        if self._rows_i8 is None:
            self._requantize_all()

    @property
    def int8_enabled(self) -> bool:
        return self._rows_i8 is not None

    def _requantize_all(self) -> None:
        q, s = _quantize_rows_int8(self.rows)
        pad_rows, pad_cols = -self.capacity % 8, -self.dim % 8
        self._rows_i8 = torch.nn.functional.pad(q, (0, pad_cols, 0, pad_rows)).contiguous()
        self._row_scale = s

    @property
    def int8_bytes(self) -> dict:
        """Bytes at rest of the rows: `int8` (the mirror), `scales` (its
        per-row scales), `f32` (the rows themselves)."""
        if self._rows_i8 is None:
            return {"int8": 0, "scales": 0, "f32": self.rows.numel() * 4}
        return {"int8": self._rows_i8.numel(), "scales": self._row_scale.numel() * 4,
                "f32": self.rows.numel() * 4}

    # -- IVF build + maintenance -----------------------------------------

    def train_ivf(
        self,
        nlist: Optional[int] = None,
        iters: int = DEFAULT_KMEANS_ITERS,
        cell_cap: Optional[int] = None,
        sample_rows: int = 65536,
        nprobe: Optional[int] = None,
        assign_chunk: int = 65536,
    ) -> dict:
        """Fit the coarse quantizer on a strided sample of <= `sample_rows`
        valid rows, assign every valid row to its nearest centroid, and
        build dense padded cells of width `cell_cap` (default 2x the
        balanced fill): a row whose first cell is full goes to its second;
        a row with both full is left out of the IVF (`spilled`, still
        served by the exact tier). Returns `ivf_stats()`."""
        if self.count < 2:
            raise ValueError("train_ivf needs at least 2 valid rows")
        if nlist is None:
            nlist = max(2, int(np.sqrt(self.count)))
        valid = self.rows[: self.count]
        stride = max(self.count // int(sample_rows), 1)
        sample = valid[::stride][: int(sample_rows)]
        nlist = int(max(2, min(nlist, sample.shape[0])))
        centroids = kmeans_fit(sample, nlist=nlist, iters=int(iters))
        if cell_cap is None:
            cell_cap = max(2 * -(-self.count // nlist), 8)
        cell_cap = int(min(cell_cap, self.capacity))
        first = np.empty(self.count, np.int32)
        second = np.empty(self.count, np.int32)
        for lo in range(0, self.count, int(assign_chunk)):
            a1, a2 = _assign_top2(valid[lo : lo + int(assign_chunk)], centroids)
            first[lo : lo + a1.shape[0]] = a1.cpu().numpy()
            second[lo : lo + a2.shape[0]] = a2.cpu().numpy()
        # host build of the dense padded cells (vectorized first choice,
        # a loop only over the overflow tail)
        cells = np.full((nlist, cell_cap), self.capacity, np.int32)
        counts = np.zeros(nlist, np.int32)
        row_cell = np.full(self.capacity, -1, np.int32)
        row_slot = np.full(self.capacity, -1, np.int32)
        order = np.argsort(first, kind="stable")
        sorted_cells = first[order]
        starts = np.searchsorted(sorted_cells, np.arange(nlist), side="left")
        pos = np.arange(self.count) - starts[sorted_cells]
        ok = pos < cell_cap
        cells[sorted_cells[ok], pos[ok]] = order[ok]
        row_cell[order[ok]] = sorted_cells[ok]
        row_slot[order[ok]] = pos[ok]
        np.add.at(counts, sorted_cells[ok], 1)
        spilled = 0
        for rid in order[~ok]:  # overflow: second-choice fallback
            c2 = second[rid]
            if counts[c2] < cell_cap:
                cells[c2, counts[c2]] = rid
                row_cell[rid], row_slot[rid] = c2, counts[c2]
                counts[c2] += 1
            else:
                spilled += 1
        self._ivf = {
            "nlist": nlist,
            "cell_cap": cell_cap,
            "nprobe": int(nprobe) if nprobe else max(1, nlist // 16),
            "centroids": centroids,
            "cells_dev": None,  # pushed lazily (dirty)
            "cell_rows_dev": None,  # cell-major copy for the kernel
            "cells": cells,
            "counts": counts,
            "row_cell": row_cell,
            "row_slot": row_slot,
            "spilled": int(spilled),
            "dirty": True,
        }
        return self.ivf_stats()

    def ivf_stats(self) -> dict:
        """Cell-occupancy spread and spill count of the trained IVF."""
        if self._ivf is None:
            return {"trained": False}
        c = self._ivf["counts"]
        return {
            "trained": True,
            "nlist": self._ivf["nlist"],
            "cell_cap": self._ivf["cell_cap"],
            "nprobe": self._ivf["nprobe"],
            "spilled": self._ivf["spilled"],
            "cell_count_min": int(c.min()),
            "cell_count_mean": float(c.mean()),
            "cell_count_max": int(c.max()),
            "occupancy": float(c.mean()) / self._ivf["cell_cap"],
        }

    def _ivf_reassign(self, overwritten: np.ndarray, fresh: torch.Tensor) -> None:
        """Incremental maintenance for one FIFO block: swap-remove each
        overwritten row from its cell, then insert the fresh rows at their
        first (else second) nearest centroid. Host side; the device table
        is pushed again before the next IVF query."""
        ivf = self._ivf
        cells, counts = ivf["cells"], ivf["counts"]
        row_cell, row_slot = ivf["row_cell"], ivf["row_slot"]
        for rid in overwritten:
            c = row_cell[rid]
            if c < 0:
                continue
            slot, last = row_slot[rid], counts[c] - 1
            mover = cells[c, last]
            cells[c, slot] = mover
            row_slot[mover] = slot
            cells[c, last] = self.capacity
            counts[c] = last
            row_cell[rid] = row_slot[rid] = -1
        a1, a2 = _assign_top2(fresh.to(self.device), ivf["centroids"])
        a1, a2 = a1.cpu().numpy(), a2.cpu().numpy()
        for i, rid in enumerate(overwritten):
            for c in (a1[i], a2[i]):
                if counts[c] < ivf["cell_cap"]:
                    cells[c, counts[c]] = rid
                    row_cell[rid], row_slot[rid] = c, counts[c]
                    counts[c] += 1
                    break
            else:
                ivf["spilled"] += 1
        ivf["dirty"] = True

    def _ivf_device_cells(self) -> torch.Tensor:
        ivf = self._ivf
        if ivf["dirty"] or ivf["cells_dev"] is None:
            ivf["cells_dev"] = torch.as_tensor(ivf["cells"], device=self.device)
            ivf["cell_rows_dev"] = None  # the cell-major copy went stale too
            ivf["dirty"] = False
        return ivf["cells_dev"]

    def _ivf_device_cell_rows(self) -> torch.Tensor:
        """Cell-major (nlist, cell_cap, d) f32 copy of the rows, built
        lazily per IVF epoch (one gather): the kernel streams each probed
        cell's tile from it. ~2x the row memory at the default cell_cap."""
        ivf = self._ivf
        cells = self._ivf_device_cells()
        if ivf["cell_rows_dev"] is None:
            ivf["cell_rows_dev"] = self.rows[cells.clamp_max(self.capacity - 1).long()].contiguous()
        return ivf["cell_rows_dev"]

    # -- query -----------------------------------------------------------

    def _require(self, mode: str, nprobe: Optional[int]) -> int:
        if mode not in QUERY_MODES:
            raise ValueError(f"unknown query mode {mode!r}; one of {QUERY_MODES}")
        if mode.endswith("_i8") and self._rows_i8 is None:
            raise ValueError(f"mode {mode!r} needs enable_int8() first")
        if mode.startswith("ivf"):
            if self._ivf is None:
                raise ValueError(f"mode {mode!r} needs train_ivf() first")
            return int(nprobe or self._ivf["nprobe"])
        return 0

    def _prepare_shape(self, m: int, k: int, mode: str, nprobe: int) -> None:
        if self._frozen:
            raise IndexRecompileError(
                f"query shape (mode={mode}, m={m}, k={k}, nprobe={nprobe}) was "
                "not prepared before freeze() — serving must pad to a prepared "
                "bucket (engine bucket set)"
            )
        if mode.startswith("ivf") and k > nprobe * self._ivf["cell_cap"]:
            raise ValueError(
                f"k={k} exceeds the candidate pool nprobe*cell_cap="
                f"{nprobe * self._ivf['cell_cap']}; raise nprobe"
            )
        self._prepared.add((mode, m, k, nprobe))
        self.prepares += 1
        # one run at the shape: builds the kernel library and warms the
        # allocator, as the JAX package's AOT compile does
        self._run(torch.zeros((m, self.dim), device=self.device), k, mode, nprobe)

    def prepare(
        self,
        buckets: Sequence[int],
        k: int,
        nprobe: Optional[int] = None,
        modes: Sequence[str] = ("exact",),
    ) -> None:
        """Prepare every (mode, bucket, k, nprobe) shape serving will query."""
        for mode in modes:
            np_eff = self._require(mode, nprobe)
            for m in buckets:
                if (mode, int(m), int(k), np_eff) not in self._prepared:
                    self._prepare_shape(int(m), int(k), mode, np_eff)

    def freeze(self) -> None:
        """End of warmup: any later unprepared shape raises IndexRecompileError."""
        self._frozen = True
        self._warm_prepares = self.prepares

    @property
    def recompiles_after_warmup(self) -> int:
        if self._warm_prepares is None:
            return 0
        return self.prepares - self._warm_prepares

    def warm(self, feats: torch.Tensor) -> None:
        """Run every prepared shape whose m is `feats`'s rows once on the
        calling thread, on `feats`: a thread's own warm-up pass, which
        prepares nothing and passes no fault hook."""
        m = feats.shape[0]
        for mode, pm, k, nprobe in sorted(self._prepared):
            if pm == m:
                self._run(feats, k, mode, nprobe)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, q: torch.Tensor, k: int, mode: str, nprobe: int):
        if mode == "exact":
            return topk_cosine(q, self.rows, k, valid_count=self.count)
        if mode == "exact_i8":
            return _exact_topk_int8(q, self._rows_i8, self._row_scale, self.capacity, self.dim,
                                    self.count, k)
        ivf = self._ivf
        if mode in ("ivf_i8", "ivf_fused_i8"):
            scan = _ivf_topk if mode == "ivf_i8" else _ivf_topk_fused
            return scan(q, self._rows_i8, ivf["centroids"], self._ivf_device_cells(), self.count,
                        k, nprobe, row_scale=self._row_scale, num_rows=self.capacity)
        if mode == "ivf":
            return _ivf_topk(
                q, self.rows, ivf["centroids"], self._ivf_device_cells(), self.count, k, nprobe
            )
        return _ivf_topk_fused_kernel(
            q, ivf["centroids"], self._ivf_device_cells(), self._ivf_device_cell_rows(),
            self.count, k, nprobe,
        )

    def query(
        self, queries, k: int, mode: str = "exact", nprobe: Optional[int] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores f32, row ids int32), each (m, k), of the top-k valid rows
        per query. `queries` is an (m, dim) array or tensor; once frozen,
        (mode, m, k, nprobe) must be a prepared shape. Modes: "exact" (the
        oracle), "ivf" (`nprobe` cells, default the trained width),
        "ivf_fused" (the same scan through the cell-scan kernel), and their
        int8 twins "exact_i8", "ivf_i8" and "ivf_fused_i8"."""
        # the request trace's index_query stage (slow@site=serve.index_query)
        faults.maybe_slow("serve.index_query")
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        m, k = q.shape[0], int(k)
        np_eff = self._require(mode, nprobe)
        if (mode, m, k, np_eff) not in self._prepared:
            self._prepare_shape(m, k, mode, np_eff)
        scores, idx = self._run(q, k, mode, np_eff)
        return scores.cpu().numpy(), idx.int().cpu().numpy()


__all__ = [
    "DEFAULT_KMEANS_ITERS",
    "EmbeddingIndex",
    "IndexRecompileError",
    "I8_F32_EXACT_DIM",
    "QUERY_MODES",
    "fifo_write",
    "kmeans_fit",
    "topk_cosine",
]
