"""Plain references of the served search: which rows an IVF top-k over
given cells has to return, and whether the cells themselves are a sound
IVF of the rows.

The coarse quantizer (the k-means centroids and the rows' cells) is the
program's state, made from the rows at set-up; the reference cannot make
the same one, since k-means lands on one of many equally good partitions.
So it takes the centroids and cells as given, checks them by themselves
(`ivf_build`), and from them works out again what a search of `nprobe`
cells has to return (`selection_gap`). Everything here is float64 on
the caller's device; nothing imports the code under test.
"""

from __future__ import annotations

import torch


def _members(cells: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row ids, their cells) of every filled slot of `cells`."""
    ids = cells.long().flatten()
    owner = torch.arange(cells.shape[0], device=cells.device).repeat_interleave(cells.shape[1])
    keep = (ids >= 0) & (ids < count)
    return ids[keep], owner[keep]


def _row_cells(cells: torch.Tensor, count: int) -> torch.Tensor:
    """(count,) the cell each row sits in, -1 where it sits in none."""
    ids, owner = _members(cells, count)
    row_cell = torch.full((count,), -1, dtype=torch.long, device=cells.device)
    row_cell[ids] = owner
    return row_cell


def f32_tie(d: int) -> float:
    """The most by which float32 can misorder two dot products of unit
    vectors of width `d`: each is off by at most d * 2**-24 (the bound of
    a float32 sum of d products whose magnitudes add to at most 1)."""
    return 2.0 * d * 2.0**-24


def ivf_build(rows: torch.Tensor, centroids: torch.Tensor, cells: torch.Tensor,
              count: int) -> dict:
    """The IVF's own check, over unit `rows` (count, d), unit `centroids`
    (nlist, d) and `cells` (nlist, cap) of row ids (padding: ids >= count):
    `ivf_misplaced`, the rows that sit in more than one cell, or in a cell
    that is neither of their two nearest centroids, or in none while fewer
    than two of those nearest cells are full (an IVF with a cell cap
    leaves a row out when both its cells are full). Two centroids whose
    scores lie within `f32_tie(d)` are a tie: the program ranks them from
    float32 products, which can order them either way.
    How near the k-means came to converging is not held: a fixed number
    of Lloyd iterations ends where it ends."""
    rows, centroids = rows.double(), centroids.double()
    tie = f32_tie(rows.shape[1])
    ids, owner = _members(cells, count)
    seen = torch.bincount(ids, minlength=count)
    full = torch.bincount(owner, minlength=cells.shape[0]) == cells.shape[1]
    sims = rows @ centroids.T
    top2 = sims.topk(2, dim=1).values[:, 1, None]
    placed = sims.gather(1, _row_cells(cells, count).clamp_min(0)[:, None])
    near = sims >= top2 - tie
    left_out_rightly = (near & full[None, :]).sum(dim=1) >= 2
    bad = ((seen > 1) | ((seen == 1) & (placed < top2 - tie)[:, 0])
           | ((seen == 0) & ~left_out_rightly))
    return {"ivf_misplaced": float(bad.sum())}


def selection_gap(emb: torch.Tensor, table: torch.Tensor, centroids: torch.Tensor,
                  cells: torch.Tensor, count: int, nprobe: int, served: torch.Tensor,
                  margin: float, block: int = 256) -> torch.Tensor:
    """Per query, how far the served rows fall short of the IVF top-k.

    `emb` (m, d) are the queries as the reference embeds them, `served`
    (m, k) the row ids the program returned, best first. A cell whose
    centroid scores above the (nprobe+1)-th best by more than `margin` is
    probed whatever the program's rounding; its rows are required. A cell
    scoring under the nprobe-th best by more than `margin` is never probed;
    a served row from it reads +inf, as does a row served twice or one out
    of range. The gap is the best required row left unserved less the
    worst served row, by the reference's scores, and 0 where the served
    rows are the best."""
    table, centroids = table.double()[:count], centroids.double()
    nlist = centroids.shape[0]
    row_cell = _row_cells(cells, count)
    out = []
    for lo in range(0, emb.shape[0], block):
        e = emb[lo:lo + block].double()
        got = served[lo:lo + block].long()
        cscore = e @ centroids.T
        ranked = cscore.sort(dim=1, descending=True).values
        must = cscore > ranked[:, min(nprobe, nlist - 1), None] + margin
        may = cscore >= ranked[:, nprobe - 1, None] - margin
        safe = got.clamp(0, count - 1)
        cell = row_cell[safe]
        ok = ((got >= 0) & (got < count) & (cell >= 0)).all(dim=1)
        ok &= may.gather(1, cell.clamp_min(0)).all(dim=1)
        ok &= (got.sort(dim=1).values.diff(dim=1) != 0).all(dim=1)
        scores = e @ table.T  # (block, count)
        required = must[:, row_cell.clamp_min(0)] & (row_cell >= 0)[None, :]
        required.scatter_(1, safe, False)
        best_left = scores.masked_fill(~required, -torch.inf).max(dim=1).values
        worst_served = scores.gather(1, safe).min(dim=1).values
        gap = (best_left - worst_served).clamp_min(0.0)
        out.append(gap.masked_fill(~ok, torch.inf))
    return torch.cat(out)


def ivf_topk(emb: torch.Tensor, table: torch.Tensor, centroids: torch.Tensor,
             cells: torch.Tensor, count: int, nprobe: int, k: int,
             rounding=None, block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores, row ids), each (m, k), of an IVF search over the given
    cells: the `nprobe` best centroids, then the best `k` rows of their
    cells. `rounding`, applied to both operands of each product, makes
    the lower-precision control."""
    r = rounding or (lambda t: t)
    table, centroids = r(table.double()), r(centroids.double())
    emb = r(emb.double())
    scores, ids = [], []
    for lo in range(0, emb.shape[0], block):
        e = emb[lo:lo + block]
        probes = (e @ centroids.T).topk(nprobe, dim=1).indices
        cand = cells.long()[probes].flatten(1)  # (block, nprobe * cap)
        valid = (cand >= 0) & (cand < count)
        sims = torch.einsum("md,mcd->mc", e, table[cand.clamp(0, count - 1)])
        s, at = sims.masked_fill(~valid, -torch.inf).topk(k, dim=1)
        scores.append(s)
        ids.append(cand.gather(1, at))
    return torch.cat(scores), torch.cat(ids)
