#!/usr/bin/env python3
"""Phase 12l of chip_smoke.py (the serving fleet) alone on one CUDA card.

    python3 chip_smoke_12l.py

Builds the kernels, makes the phase's two checkpoints as phases 12e and 12g
make them (a 3-step imagenet_v2 run from phase 8's seeded state, and a copy
of it trained 3 steps further, whose queue the phase fans out), runs
`chip_smoke.fleet_phase` and writes its
numbers to chiprun_out/run_12l.json. The full script runs every phase; this
one serves to iterate on 12l in a few minutes of card time."""

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_12l: no CUDA device visible", file=sys.stderr)
        return 2
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.ops import build, ivf_scan
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    preset = PRESETS["imagenet_v2"]
    work = tempfile.mkdtemp(prefix="chip_smoke_12l_")
    try:
        v2_dir, step6_dir = os.path.join(work, "v2"), os.path.join(work, "step6")
        cfg = dataclasses.replace(preset, data=dataclasses.replace(preset.data,
                                                                   dataset="synthetic"),
                                  steps_per_epoch=cs.SERVE_V2_STEPS, workdir=v2_dir,
                                  knn_every_epochs=0, obs_probe_every=1)
        data = SyntheticDataset(num_examples=cfg.data.global_batch * cs.EPOCH_STEPS,
                                image_size=cs.IMG)
        train(cfg, dataset=data, device="cuda", steps=cs.SERVE_V2_STEPS,
              state=cs.seeded_v2_state(cfg))
        shutil.copytree(v2_dir, step6_dir)
        train(dataclasses.replace(cfg, workdir=step6_dir), dataset=data, device="cuda",
              steps=cs.SERVE_V2_STEPS)
        torch.cuda.empty_cache()
        print(f"inputs ready at {time.perf_counter() - t0:.1f} s", flush=True)
        t1 = time.perf_counter()
        out, launches = cs.fleet_phase(ivf_scan, v2_dir, step6_dir, os.path.join(work, "fleet"))
        out["phase_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(work)
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "run_12l.json"), "w") as f:
        json.dump({"fleet": out, "launches_12l": launches, "device": smi}, f, indent=1,
                  default=str)
    print(json.dumps({"launches_12l": launches, "phase_s": out["phase_s"], "device": smi}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
