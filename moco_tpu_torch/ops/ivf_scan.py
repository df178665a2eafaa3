"""IVF cell scan: the scores of each query against the rows of its probed
cells, (m, nprobe, cell_cap) f32.

The port of the TPU kernel `_fused_cell_scores_kernel`
(moco_tpu/serve/index.py:273) as the hand-written CUDA kernel
`cell_scores_mma_kernel` in `csrc/ivf_cell_scores.cu`. The TPU kernel's
grid is one step per (query, probe) pair; carried over, that re-reads a
cell once per pair that probes it (on the served path 2048 pairs fall on
19 cells) and leaves the card idle at small m. The kernel's work is
cell-major instead: an item is (probed cell, 64-row chunk), numbered by
a bitmap of the probed cells that every CTA builds from the probe ids
itself; a CTA copies its item's chunk from device memory once, by one
bulk copy into shared memory, gathers the queries that probe the cell,
and scores them all from that copy. The products run on the TF32 tensor
cores as three split products (lo.hi + hi.lo + hi.hi), which keeps the
scores at the f32 level. The bound is bytes at the serving shapes: the
distinct probed cells, read once. A probe id outside [0, nlist) gives
NaN scores, each written by one CTA. The source note gives the details.

`fused_cell_scores` launches the kernel for CUDA tensors and takes the
plain version `fused_cell_scores_reference` only for CPU tensors; there
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from moco_tpu_torch.ops import build

MAX_DIM = 512  # widths are zero-padded to 32, 64, 128, 256 or 512
MAX_PAIRS = 2**30  # m * nprobe: the kernel indexes pairs with int32


def fused_cell_scores_reference(
    queries: torch.Tensor, cell_rows: torch.Tensor, probes: torch.Tensor
) -> torch.Tensor:
    """Plain version: gather the probed cells, one batched dot."""
    return torch.einsum("md,mpcd->mpc", queries, cell_rows[probes.long()])


def _check(queries, cell_rows, probes) -> None:
    if queries.dtype != torch.float32 or cell_rows.dtype != torch.float32:
        raise TypeError(
            f"queries and cell_rows must be float32, got {queries.dtype}, {cell_rows.dtype}"
        )
    if probes.dtype != torch.int32:
        raise TypeError(f"probes must be int32, got {probes.dtype}")
    if queries.ndim != 2 or cell_rows.ndim != 3 or probes.ndim != 2:
        raise ValueError(
            f"expected queries (m, d), cell_rows (nlist, cell_cap, d), probes (m, nprobe); "
            f"got {tuple(queries.shape)}, {tuple(cell_rows.shape)}, {tuple(probes.shape)}"
        )
    if queries.shape[1] != cell_rows.shape[2] or probes.shape[0] != queries.shape[0]:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, cell_rows "
            f"{tuple(cell_rows.shape)}, probes {tuple(probes.shape)}"
        )
    if not (queries.device == cell_rows.device == probes.device):
        raise ValueError("queries, cell_rows and probes must be on one device")


def fused_cell_scores(
    queries: torch.Tensor, cell_rows: torch.Tensor, probes: torch.Tensor
) -> torch.Tensor:
    """(m, nprobe, cell_cap) f32: out[i, j, c] = queries[i] · cell_rows[probes[i, j], c].

    CUDA tensors go through the kernel (each launch adds one to
    `fused_cell_scores.launches`); CPU tensors through the plain version.
    A probe id outside [0, nlist) gives NaN scores on the card and an
    IndexError on the CPU."""
    _check(queries, cell_rows, probes)
    if queries.device.type == "cpu":
        return fused_cell_scores_reference(queries, cell_rows, probes)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_cell_scores runs on cpu or cuda, not {queries.device}")
    m, d = queries.shape
    nlist, cell_cap, _ = cell_rows.shape
    nprobe = probes.shape[1]
    if d % 4 or not 0 < d <= MAX_DIM:
        raise ValueError(f"the kernel needs d % 4 == 0 and 0 < d <= {MAX_DIM}, got d={d}")
    if m * nprobe > MAX_PAIRS:
        raise ValueError(f"the kernel takes m * nprobe <= {MAX_PAIRS}, got {m * nprobe}")
    for name, t in (("queries", queries), ("cell_rows", cell_rows), ("probes", probes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((m, nprobe, cell_cap), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:
        return out
    lib = build.load("ivf_cell_scores")
    fn = lib.ivf_cell_scores_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            queries.data_ptr(), cell_rows.data_ptr(), probes.data_ptr(), out.data_ptr(),
            m, nprobe, nlist, cell_cap, d, stream,
        )
    if err:
        raise RuntimeError(f"ivf_cell_scores launch failed: cudaError_t {err}")
    fused_cell_scores.launches += 1
    return out


fused_cell_scores.launches = 0
