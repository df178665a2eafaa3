"""The training driver: MoCo pretraining through `moco_tpu_torch.train.train()`
on the port's `SyntheticDataset`, with the prefetch ring, as a user runs it.

Set-up, counted in `setup_s`: the seeded weights and queue (`weights.py`)
loaded into the program's encoder and train state; then one `train()`
call, whose first `warm_steps` steps fill the ring, capture the augment's
CUDA graph and give the correctness check its readings (`Setup`: the
first steps' losses, first gradient, parameters and enqueued keys). At
the end of the warm-up the card is synchronized and the window opens;
after `seconds` it is synchronized again and closed,
and the run is stopped as a scheduler stops one, by SIGTERM, which the
loop reads after the step it is on.

`train_imgs_per_s` is every image of every step dispatched and finished
inside the window over the window's wall time.

A traced run (`trace`) opens the same window with an in-memory span
tracer installed; after half the window the card is synchronized (the
image rate for `mfu.train` is taken up to there) and a profiler window
covers `profile_steps` steps; then, in one more `train()` call, the
step-time probe waits on the card around each of `probe_steps` steps for
the host's dispatch time.

Correctness, once the window has closed, the peak memory has been read
and the program's state freed: the reference (`reference/steps.py`) runs
the same three steps from the same weights and images, in float32 with
TF32 off, and the program's readings are held to it (`compare`).
"""

from __future__ import annotations

import gc
import os
import signal
import statistics
import sys
import time

import torch

from benchmark import devtrace, weights
from benchmark.reference import augment, nets, steps as ref_steps

CHECK_STEPS = 3
SKIP_RULE = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def program_config(cell, seed: int, probe_every: int):
    from moco_tpu_torch.utils.config import DataConfig, MocoConfig, OptimConfig, TrainConfig

    c = cell.config
    return TrainConfig(moco=MocoConfig(**c["moco"]), optim=OptimConfig(**c["optim"]),
                       data=DataConfig(**c["data"], global_batch=c["global_batch"]),
                       seed=int(seed), obs_probe_every=probe_every)


def spec_of(cfg: dict) -> list:
    if cfg["moco"].get("v3"):
        return nets.spec_vit_v3(cfg["vit"], cfg["moco"]["dim"], cfg.get("mlp_hidden", 4096))
    return nets.spec_resnet50_v2(cfg.get("num_filters", 64), cfg["moco"]["dim"])


def build_state(cell, config, w: dict, queue, device):
    """The program's train state holding the benchmark's weights."""
    from moco_tpu_torch.core.moco import build_encoder, build_predictor, create_state

    c = cell.config
    hidden = {"mlp_hidden": c["mlp_hidden"]} if "mlp_hidden" in c else {}
    with torch.device(device):
        encoder = build_encoder(config.moco, num_filters=c.get("num_filters", 64), **hidden)
        predictor = build_predictor(config.moco, **hidden)
    for module, prefix in ((encoder, ""), (predictor, "predictor.")):
        if module is None:
            continue
        own = {n[len(prefix):]: t for n, t in w.items()
               if (n.startswith(prefix) if prefix else not n.startswith("predictor."))}
        missing, unexpected = module.load_state_dict(own, strict=False)
        params = {n for n, _ in module.named_parameters()}
        if unexpected or params & set(missing):
            raise RuntimeError(f"weights do not fit the encoder: missing {missing}, "
                               f"unexpected {unexpected}")
    return create_state(config, encoder, device=device, queue=queue, predictor=predictor)


def named_params(state) -> dict:
    out = {f"{n}": p for n, p in state.encoder_q.named_parameters()}
    if state.predictor is not None:
        out.update({f"predictor.{n}": p for n, p in state.predictor.named_parameters()})
    return out


def first_gradient(state, optim: dict, w0: dict) -> dict:
    """The first step's gradient as the optimizer received it, worked out
    from its state after that step: SGD's buffer is g + wd p0, AdamW's
    first moment (1 - b1) g."""
    out = {}
    for n, p in named_params(state).items():
        st = state.optimizer.state.get(p)
        if not st:
            continue
        if optim["optimizer"] == "sgd":
            g = st["momentum_buffer"] - optim["weight_decay"] * w0[n].to(p.device)
        else:
            g = st["exp_avg"] / 0.1
        out[n] = g.detach().float().cpu()
    return out


def snapshot(state) -> tuple[dict, dict]:
    q = {n: p.detach().float().cpu().clone() for n, p in named_params(state).items()}
    k = {n: p.detach().float().cpu().clone() for n, p in state.encoder_k.named_parameters()}
    return q, k


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The log callback of the window's `train()` call (module docstring)."""

    def __init__(self, state, seconds: float, warm: int, batch: int, device,
                 profile_steps: int = 0):
        self.state, self.seconds, self.warm, self.batch = state, seconds, warm, batch
        self.device = device
        self.seen = 0
        self.t0 = self.t1 = self.t_rate = None
        self.step0 = self.step1 = self.step_rate = None
        self.records: list = []
        self.profile_steps = profile_steps
        self.profiler = None
        self.prof_step0 = self.prof_steps = None
        self.trace: dict = {}

    def __call__(self, record: dict) -> None:
        self.seen += 1
        if self.t1 is not None:
            return
        if self.t0 is None:
            if self.seen >= self.warm:
                sync(self.device)
                self.t0, self.step0 = time.perf_counter(), self.state.step
            return
        self.records.append(record)
        now = time.perf_counter()
        if self.profile_steps:
            if self.profiler is None and self.t_rate is None and now - self.t0 >= self.seconds / 2:
                sync(self.device)
                self.t_rate, self.step_rate = time.perf_counter(), self.state.step
                self.profiler = devtrace.ProfilerWindow(self.device)
                self.profiler.start()
                self.prof_step0 = self.state.step
            elif (self.profiler is not None
                  and self.state.step - self.prof_step0 >= self.profile_steps):
                self.prof_steps = self.state.step - self.prof_step0
                self.profiler.stop()
                self.trace = devtrace.summarize(self.profiler.events)
                self.profiler = None
        if now - self.t0 >= self.seconds and self.profiler is None:
            sync(self.device)
            self.t1, self.step1 = time.perf_counter(), self.state.step
            os.kill(os.getpid(), signal.SIGTERM)  # the loop stops after this step

    @property
    def images(self) -> int:
        return (self.step1 - self.step0) * self.batch

    @property
    def rate(self) -> float:
        return self.images / (self.t1 - self.t0)


class Setup:
    """One seed's program under test: the train state built from the
    benchmark's weights and queue, the pieces `train()` is called with, and
    the program's readings of its first steps for `compare`, taken inside
    the run's own `train()` call by a hook after each optimizer update (in
    the stream's order, on the main thread): the first gradient after step
    1, both encoders after step `CHECK_STEPS`, and the queue's rows after
    the next update (a step enqueues after its update); the losses from
    the loop's records (`log`)."""

    def __init__(self, cell, seed: int, device):
        from moco_tpu_torch import train as program
        from moco_tpu_torch.data.datasets import SyntheticDataset

        cfg, tr = cell.config, cell.traffic
        self.program, self.device, self.optim = program, device, cfg["optim"]
        self.batch = cfg["global_batch"]
        self.steps_per_epoch = tr["dataset_rows"] // self.batch
        self.config = program_config(cell, seed, tr.get("probe_every_default", 50))
        self.dataset = SyntheticDataset(num_examples=tr["dataset_rows"],
                                        image_size=cfg["data"]["image_size"])
        w, gen = weights.make(spec_of(cfg), seed, device,
                              residual_gamma=cfg.get("residual_gamma", 1.0))
        queue = (None if cfg["moco"].get("v3") else
                 weights.queue(gen, cfg["moco"]["num_negatives"], cfg["moco"]["dim"]))
        self.w0 = {n: t.detach().cpu().clone() for n, t in w.items()}
        self.q0 = None if queue is None else queue.detach().cpu().clone()
        self.state = build_state(cell, self.config, w, queue, device)
        del w, queue
        self.readings = {"losses": [], "grads": None, "q3": None, "k3": None, "keys": None}
        self.updates = 0
        self._hook = self.state.optimizer.register_step_post_hook(self._after_update)

    def _after_update(self, optimizer, args, kwargs) -> None:
        self.updates += 1
        state, r = self.state, self.readings
        if self.updates == 1:
            r["grads"] = first_gradient(state, self.optim, self.w0)
        if self.updates == CHECK_STEPS:
            r["q3"], r["k3"] = snapshot(state)
        if self.updates == CHECK_STEPS + 1:
            if state.queue is not None:
                r["keys"] = state.queue[:CHECK_STEPS * self.batch].detach().cpu().clone()
            self._hook.remove()

    def log(self, then=None):
        """The loop's log callback: the first steps' losses, then `then`."""

        def on_record(record: dict) -> None:
            if len(self.readings["losses"]) < CHECK_STEPS:
                self.readings["losses"].append(record["loss"])
            if then is not None:
                then(record)

        return on_record

    def checked(self) -> dict:
        if self.updates <= CHECK_STEPS:
            raise RuntimeError(f"the run made {self.updates} updates; the check reads "
                               f"{CHECK_STEPS + 1}")
        return self.readings

    def train(self, config=None, **kw) -> dict:
        return self.program.train(config or self.config, self.dataset, self.device,
                                  state=self.state, **kw)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start=None) -> dict:
    from moco_tpu_torch.obs import trace as obs_trace

    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    setup = Setup(cell, seed, device)
    state, batch = setup.state, setup.batch

    tracer = None
    if trace:
        tracer = obs_trace.Tracer(None)
        t_tracer = time.perf_counter()
        obs_trace.set_tracer(tracer)
    win = Window(state, seconds, tr["warm_steps"], batch, device,
                 profile_steps=tr["profile_steps"] if trace else 0)
    left = setup.steps_per_epoch - state.step
    try:
        out = setup.train(steps=left, log=setup.log(win))
    finally:
        if tracer is not None:
            obs_trace.set_tracer(None)
    if win.t1 is None or not out.get("preempted"):
        raise RuntimeError(f"the window did not close inside the epoch ({left} steps)")
    result = {"attempted": win.images, "failed": 0,
              "e2e": {"train_imgs_per_s": win.rate, "setup_s": win.t0 - t_start}}
    ctx: dict = {}
    if trace:
        probed = setup.train(program_config(cell, seed, 1), steps=tr["probe_steps"])
        dispatch = [h["t_dispatch"] for h in probed["history"] if "t_dispatch" in h]
        spans = [s for s in tracer.snapshot()
                 if "dur" in s and t_tracer + s["ts"] / 1e6 >= win.t0
                 and t_tracer + (s["ts"] + s["dur"]) / 1e6 <= win.t1]
        rate = (None if win.t_rate is None
                else (win.step_rate - win.step0) * batch / (win.t_rate - win.t0))
        ctx = {"driver": "train", "config": cfg, "spans": spans, "records": win.records,
               "dispatch_s": dispatch[tr.get("probe_skip", 2):], "imgs_per_s": rate,
               "trace": win.trace, "profiled_steps": win.prof_steps, "batch": batch}
        result["busy_s"] = win.trace.get("busy_s")
        result["window_s"] = win.trace.get("window_s")
        result["breakdown"] = {"device_ops": win.trace.get("device_ops", []),
                               "idle_gaps": win.trace.get("idle_gaps", [])}
    result["ctx"] = ctx
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    readings, w0, q0, steps_per_epoch = (setup.checked(), setup.w0, setup.q0,
                                         setup.steps_per_epoch)
    del setup, state, out, win
    free(device)
    ref = reference_run(cfg, tr, seed, w0, q0, steps_per_epoch, device)
    result["numbers"] = compare(readings, ref, w0)
    result["correct"] = True
    return result


def reference_run(cfg: dict, tr: dict, seed: int, w0: dict, q0, steps_per_epoch: int, device,
                  prec: nets.Precision = nets.FP32, half_batch: bool = False) -> dict:
    """The reference's three steps: {"losses", "grads", "q3", "k3", "keys"}."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False  # no autotuning of shapes run three times
    try:
        kinds = weights.kinds(spec_of(cfg))
        trainer = ref_steps.Trainer(cfg, w0, kinds, q0, steps_per_epoch, device, prec, half_batch)
        size = cfg["data"]["image_size"]
        for s in range(CHECK_STEPS):
            t0 = time.perf_counter()
            rows = ref_steps.synthetic_batch(seed, 0, s, cfg["global_batch"], tr["dataset_rows"],
                                             size)
            im_q, im_k = augment.two_views(torch.from_numpy(rows).to(device), seed, 0, s, size)
            sync(device)
            t1 = time.perf_counter()
            trainer.step(im_q, im_k)
            sync(device)
            print(f"reference step {s}: inputs {t1 - t0:.2f} s, "
                  f"step {time.perf_counter() - t1:.2f} s", file=sys.stderr, flush=True)
        keys = torch.cat(trainer.keys).cpu() if trainer.keys else None
        return {"losses": trainer.losses,
                "grads": {n: g.cpu() for n, g in trainer.first_grads.items()},
                "q3": {n: trainer.q[n].cpu() for n in trainer.params},
                "k3": {n: trainer.k[n].cpu() for n in trainer.params if n in trainer.k},
                "keys": keys}
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """{leaf: | ||prog|| - ||ref|| | / max(||ref||, the median leaf's ||ref||)}."""
    norms = {n: float(ref[n].norm()) for n in names}
    med = statistics.median(norms.values())
    return {n: abs(float(prog[n].norm()) - norms[n]) / max(norms[n], med) for n in names}


def compare(prog: dict, ref: dict, w0: dict) -> dict:
    """The numbers the check can compare (the cell's limits say which it
    does; PERF.md gives the readings each limit was set from):

    - loss: the largest relative gap of the three steps' losses;
    - grad: the first gradient's worst-leaf gap of norms; grad_median:
      the median leaf's;
    - change_q / change_k: the worst-leaf gap of the norms of each
      encoder's parameter change after the three steps (the query side
      with the predictor);
    - keys (v2): the largest distance between an enqueued key and the
      reference's.

    Leaves whose reference gradient is under `SKIP_RULE` of the median
    leaf's (the attention key's bias under softmax) move by round-off
    alone and are left out of grad and change."""
    gnorm = {n: float(g.norm()) for n, g in ref["grads"].items()}
    med = statistics.median(gnorm.values())
    live = [n for n, g in gnorm.items() if g >= SKIP_RULE * med]
    missing = [n for n in live if n not in prog["grads"]]
    if missing:  # a leaf the reference moves and the program does not
        return {"loss": float("inf"), "grad": float("inf")}
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses = [float("inf")]
    grad_gaps = leaf_gaps(prog["grads"], ref["grads"], live)
    out = {"loss": max(losses), "grad": max(grad_gaps.values()),
           "grad_median": statistics.median(grad_gaps.values())}
    for side, p3, r3 in (("q", prog["q3"], ref["q3"]), ("k", prog["k3"], ref["k3"])):
        names = [n for n in live if n in r3]
        gaps = leaf_gaps({n: p3[n] - w0[n] for n in names}, {n: r3[n] - w0[n] for n in names},
                         names)
        out[f"change_{side}"] = max(gaps.values())
    if ref["keys"] is not None:
        if prog["keys"] is None or prog["keys"].shape != ref["keys"].shape:
            out["keys"] = float("inf")
        else:
            out["keys"] = float((prog["keys"] - ref["keys"]).norm(dim=1).max())
    return out


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def seed_readings(cell, seed: int, device, mode: str = "program") -> tuple[dict, dict, dict]:
    """(readings, the reference's, the initial weights) of one seed without
    a window: the program's checked steps (`mode` "program"), or the
    reference put in the program's place in fp8 ("control") or with half
    of each batch left out ("half_batch"). For setting the limits
    (`benchmark/calibrate.py`); `compare` turns them into the numbers."""
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    if mode == "program":
        setup = Setup(cell, seed, device)
        setup.train(steps=CHECK_STEPS + 1, log=setup.log())
        got, w0, q0, steps_per_epoch = setup.checked(), setup.w0, setup.q0, setup.steps_per_epoch
        del setup
    else:
        w, gen = weights.make(spec_of(cfg), seed, device,
                              residual_gamma=cfg.get("residual_gamma", 1.0))
        w0 = {n: t.detach().cpu().clone() for n, t in w.items()}
        q0 = (None if cfg["moco"].get("v3") else
              weights.queue(gen, cfg["moco"]["num_negatives"], cfg["moco"]["dim"]).cpu())
        del w
        steps_per_epoch = tr["dataset_rows"] // cfg["global_batch"]
        prec = nets.Precision("fp8" if mode == "control" else "fp32")
        got = reference_run(cfg, tr, seed, w0, q0, steps_per_epoch, device, prec,
                            half_batch=mode == "half_batch")
    free(device)
    ref = reference_run(cfg, tr, seed, w0, q0, steps_per_epoch, device)
    return got, ref, w0


def calibration_numbers(cell, seed: int, mode: str, device) -> dict:
    """The check's numbers of one calibration reading (`benchmark/calibrate.py`):
    `mode` "program", "control" or "half_batch" (`seed_readings`)."""
    return compare(*seed_readings(cell, seed, device, mode))


CALIBRATION_FAULTS = ("half_batch",)
