#!/usr/bin/env python3
"""Phase 12k of chip_smoke.py (ZeRO on a 2 x 2 world, elastic training) alone
on one CUDA card.

    python3 chip_smoke_12k.py

Builds the kernels, runs `chip_smoke.zk_phase` (its ranks in child
processes) and writes its numbers to chiprun_out/run_12k.json. The full
script runs every phase; this one serves to iterate on 12k in a few
minutes of card time."""

import json
import os
import sys
import time

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_12k: no CUDA device visible", file=sys.stderr)
        return 2
    from moco_tpu_torch.ops import build, fused_infonce

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    out, launches = cs.zk_phase(fused_infonce)
    out["phase_s"] = time.perf_counter() - t1
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "run_12k.json"), "w") as f:
        json.dump({"zero_model_elastic": out, "launches": launches, "device": smi}, f,
                  indent=1, default=str)
    print(json.dumps({"launches": launches, "phase_s": out["phase_s"], "device": smi}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
