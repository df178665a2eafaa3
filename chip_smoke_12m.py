#!/usr/bin/env python3
"""Phase 12m of chip_smoke.py (the analysis's runtime legs) alone on one
CUDA card.

    python3 chip_smoke_12m.py

Builds the kernels, then runs each leg of chip_smoke's 12m on its own,
with the setup the full script's phases pay for: (d) a ring run of phase
8's imagenet_v2 under strict_tracing, the training arms' cost (`leg_cost`:
that run's step ms with no arm and with the arms on, in alternating order,
as quartiles), (a) two ranks on the card (gloo)
through `dp_sanitize_legs`, (b) phase 4's engine and IVF index through
`lock_order_part`, and (c) phase 12l (`fleet_phase`, whose replicas run
under contract coverage) over a 3-step checkpoint and a copy trained 3
steps further, as chip_smoke_12l.py makes them. Writes the legs' numbers
to chiprun_out/run_12m.json. The full script runs every phase; this one
serves to iterate on 12m in a few minutes of card time."""

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


def san_child(rank: int, n: int, store: str, out_dir: str) -> None:
    """(a), one rank: its world on cuda:0 (gloo), then the two driver runs."""
    from moco_tpu_torch.parallel.mesh import init_world

    out = {}
    try:
        world = init_world("gloo", rank, n, device="cuda:0", store_path=store,
                           timeout_s=cs.DP_TIMEOUT_S)
        try:
            out = cs.dp_sanitize_legs(world, rank, world.device, out_dir)
        finally:
            world.close()
    except BaseException:
        import traceback

        out = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"san{rank}.json"), "w") as f:
        json.dump(out, f)


def leg_a() -> dict:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_12m_a_")
    try:
        procs = [ctx.Process(target=san_child, args=(r, cs.DP_RANKS, os.path.join(tmp, "store"),
                                                     tmp))
                 for r in range(cs.DP_RANKS)]
        for p in procs:
            p.start()
        codes = cs.dp_join(procs, 2 * cs.DP_TIMEOUT_S)
        results = []
        for r in range(cs.DP_RANKS):
            with open(os.path.join(tmp, f"san{r}.json")) as f:
                results.append(json.load(f))
        cs.check(codes == [0] * cs.DP_RANKS and not any("error" in r for r in results),
                 f"12m(a): exit {codes}: {[r.get('error') for r in results]}")
        return cs.dp_sanitize_check(results, tmp)
    finally:
        shutil.rmtree(tmp)


def leg_b(work: str) -> dict:
    from moco_tpu_torch.convert import encoder_from_flax, random_flax_encoder
    from moco_tpu_torch.core.moco import build_encoder
    from moco_tpu_torch.serve.engine import InferenceEngine
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS["imagenet_v2"]
    params, stats = random_flax_encoder(cfg.moco, seed=cs.SEED)
    model = build_encoder(cfg.moco)
    model.load_state_dict(encoder_from_flax(params, stats))
    engine = InferenceEngine(model, cs.IMG, device="cuda")
    engine.warmup()
    index = EmbeddingIndex(cs.K, cs.DIM, device="cuda")
    index.snapshot(cs.unit_rows(np.random.default_rng(cs.SEED), cs.K, cs.DIM))
    index.train_ivf(nlist=cs.NLIST, nprobe=cs.NPROBE)
    index.prepare(engine.buckets, cs.TOPK, modes=cs.F32_MODES)
    index.freeze()
    return cs.lock_order_part(engine, index, work)


def leg_c(work: str) -> dict:
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.ops import ivf_scan
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    preset = PRESETS["imagenet_v2"]
    v2_dir, step6_dir = os.path.join(work, "v2"), os.path.join(work, "step6")
    cfg = dataclasses.replace(preset, data=dataclasses.replace(preset.data, dataset="synthetic"),
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
    out, _ = cs.fleet_phase(ivf_scan, v2_dir, step6_dir, os.path.join(work, "fleet"))
    return {"coverage": out["coverage"], "phase_s": out["phase_s"]}


def leg_d() -> dict:
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.ops import fused_infonce
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS["imagenet_v2"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"),
                              obs_probe_every=1, strict_tracing=True,
                              recompile_warmup_steps=cs.STRICT_WARMUP_STEPS)
    dataset = SyntheticDataset(num_examples=cfg.data.global_batch * cs.EPOCH_STEPS,
                               image_size=cs.IMG)
    run = cs.v2_run(fused_infonce, cfg, dataset, cs.seeded_v2_state(cfg), "ring")
    return cs.strict_tracing_check(run["hist"], "ring")


COST_ROUNDS, COST_TIMED = 4, 10  # leg_cost: rounds of the three arms, timed steps a run


def leg_cost(work: str) -> dict:
    """The training arms' cost on one card: phase 8's imagenet_v2 ring run
    (a wait around every step, TRAIN_WARMUP + COST_TIMED steps from the
    same seeded state, each with a workdir of its own) with no arm, with
    strict_tracing and sanitize_collectives, and with those and
    sanitize_threads (its profile hook on every thread the run starts).
    COST_ROUNDS rounds, the arms' order reversed each round, so that no arm
    always runs first or last. For each arm, over all its timed steps: the
    median and quartiles of step_ms, t_dispatch and t_device, and each
    round's median step_ms (the spread between runs of one arm)."""
    import copy

    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.config import PRESETS

    cfg = PRESETS["imagenet_v2"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"),
                              obs_probe_every=1)
    dataset = SyntheticDataset(num_examples=cfg.data.global_batch * cs.EPOCH_STEPS,
                               image_size=cs.IMG)
    state = cs.seeded_v2_state(cfg)
    arms = {"off": {}, "strict_collectives": {"strict_tracing": True, "sanitize_collectives": True},
            "all_three": {"strict_tracing": True, "sanitize_collectives": True,
                          "sanitize_threads": True}}
    steps = {name: [] for name in arms}
    rounds = {name: [] for name in arms}
    for r in range(COST_ROUNDS):
        for name in (list(arms) if r % 2 == 0 else list(reversed(arms))):
            c = dataclasses.replace(cfg, workdir=os.path.join(work, f"cost_{name}_{r}"),
                                    **arms[name])
            hist = train(c, dataset=dataset, device="cuda", steps=cs.TRAIN_WARMUP + COST_TIMED,
                         state=copy.deepcopy(state))["history"][cs.TRAIN_WARMUP:]
            steps[name] += hist
            rounds[name].append(float(np.median([h["step_ms"] for h in hist])))
            print(f"12m cost round {r} {name}: median step {rounds[name][-1]:.3f} ms", flush=True)
            torch.cuda.empty_cache()
    out = {"rounds": COST_ROUNDS, "timed_steps_per_run": COST_TIMED}
    for name, hist in steps.items():
        out[name] = {k: [float(q) for q in np.percentile([h[k] for h in hist], (25, 50, 75))]
                     for k in ("step_ms", "t_dispatch", "t_device")}
        out[name]["round_median_step_ms"] = rounds[name]
        print(f"12m cost {name} (q1, median, q3): {json.dumps(out[name])}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_12m: no CUDA device visible", file=sys.stderr)
        return 2
    from moco_tpu_torch.ops import build

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"device": smi}
    work = tempfile.mkdtemp(prefix="chip_smoke_12m_")
    try:
        for name, leg in (("d", leg_d), ("cost", lambda: leg_cost(work)), ("a", leg_a),
                          ("b", lambda: leg_b(work)), ("c", lambda: leg_c(work))):
            t1 = time.perf_counter()
            out[name] = leg()
            out[name + "_s"] = time.perf_counter() - t1
            print(f"12m({name}) in {out[name + '_s']:.1f} s", flush=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work)
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "run_12m.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in out.items() if k.endswith("_s") or k == "device"}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
