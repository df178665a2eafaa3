#!/usr/bin/env python3
"""Time the IVF cell-scan kernel of a checkout of this repository on one CUDA card.

    python3 time_ivf_scan.py [ROOT]

ROOT (default: the directory of this script) is the checkout whose
`moco_tpu_torch.ops.ivf_scan.fused_cell_scores` is built and timed, so
two versions of the kernel can be timed by the same code in one run.
Cells: nlist 256 x cell_cap 512 x d 128 unit rows, the serving index's
IVF layout (67 MB); nprobe 16; probes drawn uniformly from the 256 cells
and from 19 of them (the skew of the served features' own probes), at
m in {1, 8, 32, 128}, from a fixed seed. Prints the card's
`nvidia-smi` name and power limit, then one JSON line per case: the
kernel's own device time (torch.profiler, mean over 50 calls) and the
time per call of back-to-back wrapper calls (CUDA events, which at small
m measure how fast the host launches it), in ms.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import cuda_ms, kernel_device_ms

NLIST, CELL_CAP, DIM, NPROBE, SEED = 256, 512, 128, 16, 0


def main() -> int:
    if not torch.cuda.is_available():
        print("time_ivf_scan: no CUDA device visible", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parent).resolve()
    sys.path.insert(0, str(root))
    from moco_tpu_torch.ops import ivf_scan

    if not Path(ivf_scan.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ivf_scan.__file__}, not the checkout at {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = torch.randn((NLIST, CELL_CAP, DIM), generator=gen, device="cuda")
    rows /= rows.norm(dim=-1, keepdim=True)
    hot = torch.randperm(NLIST, generator=gen, device="cuda")[:19].int()
    for probes_from in ("uniform", "19 cells"):
        for m in (1, 8, 32, 128):
            q = torch.randn((m, DIM), generator=gen, device="cuda")
            q /= q.norm(dim=-1, keepdim=True)
            if probes_from == "uniform":
                probes = torch.randint(0, NLIST, (m, NPROBE), generator=gen, device="cuda",
                                       dtype=torch.int32)
            else:
                probes = hot[torch.randint(0, 19, (m, NPROBE), generator=gen, device="cuda")]
            probes = probes.contiguous()

            def run(q=q, probes=probes):
                return ivf_scan.fused_cell_scores(q, rows, probes)

            print(json.dumps({"root": str(root), "probes": probes_from, "m": m,
                              "distinct_cells": int(torch.unique(probes).numel()),
                              "device_ms": kernel_device_ms(run, "cell_scores"),
                              "event_ms": cuda_ms(run, iters=200, warm=10)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
