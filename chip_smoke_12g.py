#!/usr/bin/env python3
"""Phase 12g of chip_smoke.py ("serving, the rest") alone on one CUDA card.

    python3 chip_smoke_12g.py

Builds the kernels, makes the phase's inputs as phases 4 and 12e make them
(the seeded imagenet_v2 encoder's bf16 features of phase 4's images, and a
3-step imagenet_v2 ring run's checkpoint from phase 8's seeded state), runs
`chip_smoke.serving_rest_phase`, and writes its numbers to
chiprun_out/run_12g.json. The full script runs every phase; this one
serves to iterate on 12g in about 2.5 minutes of card time."""

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_12g: no CUDA device visible", file=sys.stderr)
        return 2
    from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
    from moco_tpu_torch.core.moco import build_encoder
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.ops import build, fused_infonce, ivf_scan
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build_all()
    cfg = PRESETS["imagenet_v2"]
    params, stats = random_flax_encoder(cfg.moco, seed=cs.SEED)
    model = build_encoder(cfg.moco)
    model.load_state_dict(encoder_from_flax(params, stats))
    rng = np.random.default_rng(cs.SEED)
    cs.unit_rows(rng, cs.K, cs.DIM)  # phase 4's rows, drawn first from the same generator
    imgs = rng.integers(0, 256, (128, cs.IMG, cs.IMG, 3), np.uint8)
    engine = InferenceEngine(model, cs.IMG, device="cuda")
    engine.warmup()
    feats_t = engine.forward(torch.from_numpy(imgs).cuda())
    del engine, model
    serve_dir = tempfile.mkdtemp(prefix="chip_smoke_12g_serve_")
    work = tempfile.mkdtemp(prefix="chip_smoke_12g_")
    try:
        v2_dir = os.path.join(serve_dir, "v2")
        c2 = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"),
                                 steps_per_epoch=cs.SERVE_V2_STEPS, workdir=v2_dir,
                                 knn_every_epochs=0, obs_probe_every=1)
        b = c2.data.global_batch
        train(c2, dataset=SyntheticDataset(num_examples=b * cs.EPOCH_STEPS, image_size=cs.IMG),
              device="cuda", steps=cs.SERVE_V2_STEPS, state=cs.seeded_v2_state(c2))
        print(f"inputs ready at {time.perf_counter() - t0:.1f} s", flush=True)
        out, launches = cs.serving_rest_phase(fused_infonce, ivf_scan, feats_t, v2_dir, work)
    finally:
        shutil.rmtree(work)
        shutil.rmtree(serve_dir)
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "run_12g.json"), "w") as f:
        json.dump({"serving_rest": out, "launches": launches, "device": smi}, f, indent=1,
                  default=str)
    print(json.dumps({"launches": launches, "phase_s": out["phase_s"], "device": smi}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
