#!/usr/bin/env python3
"""Phase 12j of chip_smoke.py (the model axis on the card) alone on one CUDA
card.

    python3 chip_smoke_12j.py

Builds the kernels, runs `chip_smoke.model_axis_phase` (its ranks in child
processes) and writes its numbers to chiprun_out/run_12j.json. The full
script runs every phase; this one serves to iterate on 12j in a few
minutes of card time."""

import json
import os
import sys
import time

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_12j: no CUDA device visible", file=sys.stderr)
        return 2
    from moco_tpu_torch.ops import build, fused_infonce
    from moco_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    out, launches, shapes = cs.model_axis_phase(fused_infonce, fa)
    out["phase_s"] = time.perf_counter() - t1
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "run_12j.json"), "w") as f:
        json.dump({"model_axis": out, "launches": launches, "shapes": shapes, "device": smi},
                  f, indent=1, default=str)
    print(json.dumps({"launches": launches, "phase_s": out["phase_s"], "device": smi}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
