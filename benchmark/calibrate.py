#!/usr/bin/env python3
"""Readings for the limits of a cell's correctness check, on the card, in
one process:

    python3 benchmark/calibrate.py --workload v2_r50_train --seeds 12 --controls 3

For each of `--seeds` seeds the program's readings (a training cell's
first three steps through `train()`, no window; a serving cell's short
window at the cell's load); for each of `--controls` further seeds the
reference put in the program's place in fp8 (the control) and each of
the driver's planted faults (training: half of each batch left out;
serving: one probe where the cell states more, the first chunk of every
cell skipped by the scan).
Prints one JSON line per reading, then the largest program reading and
the smallest control and fault reading of each number. PERF.md records
what each limit was set from.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_100_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    drv = harness.driver_for(cell)
    plan = [(args.first_seed + i, "program") for i in range(args.seeds)]
    for i in range(args.controls):
        seed = args.first_seed + args.seeds + i
        plan += [(seed, mode) for mode in ("control", *drv.CALIBRATION_FAULTS)]
    seen: dict = {}
    for seed, mode in plan:
        numbers = drv.calibration_numbers(cell, seed, mode, args.device)
        seen.setdefault(mode, []).append(numbers)
        print(json.dumps({"workload": cell.name, "seed": seed, "mode": mode, "numbers": numbers}),
              flush=True)
    summary = {}
    for name in seen["program"][0]:
        summary[name] = {"lower": max(n.get(name, float("inf")) for n in seen["program"])}
        for mode in seen:
            if mode != "program":
                summary[name][mode] = min(n.get(name, float("inf")) for n in seen[mode])
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
