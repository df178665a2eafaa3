#!/usr/bin/env python3
"""Run one cell of the benchmark of moco_tpu_torch once, on this machine's
card, and print its result as the last line of standard output:

    python3 benchmark/run.py --workload v2_r50_train --seed 7 --seconds 30 --trace 0

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer ones (a traced run: spans, the step-time probe and a profiler
window). Every run checks what the timed path produced against the plain
reference under `benchmark/reference/` and prints each number compared
beside its limit, last on standard error and last in the result line.
The run fails, printing no result, without a CUDA card, or if JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from benchmark import harness

    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    # the program's compile caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = harness.driver_for(cell).run(cell, seed=args.seed, seconds=args.seconds,
                                       trace=bool(args.trace), device="cuda", t_start=t_start)
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"no result: the run loaded {forbidden}", file=sys.stderr)
        return 3
    correct, checks = harness.judge(out["numbers"], cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if args.trace:
        metrics = harness.read_per_layer(cell, out["ctx"])
    else:
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in out["e2e"].items()
                   if k in units}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit_w": harness.power_limit_w()}
    breakdown = None
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
        breakdown = out.get("breakdown")
    harness.print_checks(checks)
    print(harness.result_line(correct and out["correct"], out["attempted"], out["failed"],
                              metrics, device, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
