#!/usr/bin/env python3
"""Phase 12i of chip_smoke.py (ZeRO on the card) alone on one CUDA card.

    python3 chip_smoke_12i.py

Builds the kernels, runs `chip_smoke.zero_phase` (its two ranks in child
processes), and writes its numbers to chiprun_out/run_12i.json. The full
script runs every phase; this one serves to iterate on 12i in a few
minutes of card time. 12h's peak memory, which the full script prints
beside 12i's, is not measured here."""

import json
import os
import sys
import time

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_12i: no CUDA device visible", file=sys.stderr)
        return 2
    from moco_tpu_torch.ops import build, fused_infonce

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    out, launches = cs.zero_phase(fused_infonce)
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "run_12i.json"), "w") as f:
        json.dump({"zero": out, "launches": launches, "device": smi}, f, indent=1, default=str)
    print(json.dumps({"launches": launches, "wall_s": out["wall_s"], "device": smi}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
