#!/usr/bin/env python3
"""Where chip_smoke.py's wall time goes, on one CUDA card.

    python3 chip_smoke_profile.py          # the whole script
    python3 chip_smoke_profile.py --dist   # the kernel build, then 12h-12k only

Runs chip_smoke.main() (or, with --dist, its distributed phases) while a
thread samples the main thread's Python stack every 20 ms; each child that
a phase spawns samples its own main thread the same way (this module is
the children's main module). Writes chiprun_out/prof/parent.json and one
child_<target>_<rank>_<pid>.json per child: seconds by chain of
chip_smoke.py functions, and by that chain with the innermost frames of the
port and of the interpreter (an import shows as importlib frames, a wait
on a subprocess or a thread as its wait). Host clock only: a sample says
what the main thread was doing, not what the card was. The sampling costs
the sampled process well under 1% (one stack walk per 20 ms).
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "prof")


class StackSampler:
    """Samples the main thread's stack every `every` seconds on a daemon
    thread until `dump`."""

    def __init__(self, every: float = 0.02):
        self.every = every
        self.ident = threading.main_thread().ident
        self.lock = threading.Lock()
        self.chains: collections.Counter = collections.Counter()
        self.leaves: collections.Counter = collections.Counter()
        self.stop = threading.Event()
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        last = time.perf_counter()
        while not self.stop.wait(self.every):
            now = time.perf_counter()
            dt, last = now - last, now
            frame = sys._current_frames().get(self.ident)
            frames = []
            while frame is not None:
                frames.append(frame)
                frame = frame.f_back
            frames.reverse()
            chain = ">".join(f.f_code.co_name for f in frames
                             if f.f_code.co_filename.endswith("chip_smoke.py"))
            port = " < ".join(f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
                              for f in frames if "/moco_tpu_torch/" in f.f_code.co_filename)
            inner = " < ".join(f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}:"
                               f"{f.f_lineno}" for f in frames[-4:])
            del frames  # no frame (and so no local of the sampled code) outlives the sample
            with self.lock:
                self.chains[chain] += dt
                self.leaves[f"{chain} | {port} || {inner}"] += dt

    def dump(self, path: str, title: str) -> None:
        self.stop.set()
        self.thread.join(timeout=5)
        with self.lock:
            out = {"title": title, "wall_s": time.perf_counter() - self.t0,
                   "chains": self.chains.most_common(300),
                   "leaves": self.leaves.most_common(500)}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=0)


def _dump_child(sampler: StackSampler) -> None:
    import multiprocessing

    p = multiprocessing.current_process()
    name = getattr(getattr(p, "_target", None), "__name__", "child")
    args = getattr(p, "_args", ())
    rank = args[0] if args and isinstance(args[0], int) else ""
    sampler.dump(os.path.join(OUT, f"child_{name}_{rank}_{os.getpid()}.json"), f"{name} {rank}")


def distributed_only() -> int:
    """The kernel build, then phases 12h, 12i, 12j and 12k as chip_smoke
    runs them alone (each spawns its own ranks); a phase that fails is
    printed and the next runs."""
    import chip_smoke
    from moco_tpu_torch.ops import build
    from moco_tpu_torch.ops import flash_attention as fa
    from moco_tpu_torch.ops import fused_infonce as fi

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, run in (("12h", lambda: chip_smoke.dp_phase(fi)),
                      ("12i", lambda: chip_smoke.zero_phase(fi)),
                      ("12j", lambda: chip_smoke.model_axis_phase(fi, fa)),
                      ("12k", lambda: chip_smoke.zk_phase(fi))):
        t0 = time.perf_counter()
        try:
            run()
        except Exception as e:  # the report is the point: the next phase still runs
            print(f"{name} failed: {e!r}"[:2000], flush=True)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__mp_main__":  # a phase's spawned child
    atexit.register(_dump_child, StackSampler())

if __name__ == "__main__":
    sys.path.insert(0, HERE)
    import chip_smoke

    parent = StackSampler()
    rc = 1
    try:
        rc = distributed_only() if "--dist" in sys.argv[1:] else chip_smoke.main()
    finally:
        parent.dump(os.path.join(OUT, "parent.json"), "parent")
    sys.exit(rc)
