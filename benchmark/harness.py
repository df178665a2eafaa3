"""The harness's shared part: where the benchmark's files are, how a cell
is assembled from them by name, and the result line.

A cell `<name>` of BENCHMARK.json is put together from files found by name:

- `benchmark/configs/<config>.json`: the model configuration as it is run;
- `benchmark/traffic/<traffic>.json`: the traffic mix, whose `driver`
  names the general code that runs it, `benchmark/drivers/<driver>.py`;
- `benchmark/workloads/<name>.json`: the cell's own numbers (its rate,
  its dataset's size) and the limits of its correctness check;
- `benchmark/metrics/<metric>.py` for each per-layer metric the cell
  reports: a `read(ctx)` that returns the number, or None when the run
  left nothing to read.

A later cell, mix, configuration or metric is added by adding such files
and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# top-level module names nothing the benchmark runs may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "moco_tpu")


def process_start() -> float:
    """`time.perf_counter()` at this process's start, from the kernel's
    record of it (10 ms resolution), so set-up counts the interpreter's
    own start and every import."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """Import a file of the benchmark by path (metric files have dots in
    their names)."""
    name = name or "benchmark_file_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the workload entry of BENCHMARK.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json, then the cell's own `traffic` numbers over it
    limits: dict  # name -> limit of each number the correctness check compares
    end_to_end: list  # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list  # BENCHMARK.json's per_layer entries this cell reports


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether `cell` reports `metric`: listed under its `workloads`, or,
    without that key, a cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(root / conf["file"])
    here = root / "benchmark"
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    own = load_json(here / "workloads" / f"{name}.json")
    traffic = {**traffic, **own.get("traffic", {})}
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, entry, config, traffic, own.get("limits", {}), e2e, per_layer)


def driver_for(cell: Cell, root: Path = ROOT):
    return load_module(root / "benchmark" / "drivers" / f"{cell.traffic['driver']}.py")


def read_per_layer(cell: Cell, ctx: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of each per-layer metric whose reader found
    something to read."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    states a limit for: each at or under its limit; one that is missing
    or not finite fails, and so does a cell with no limit at all."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = ok and value is not None and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    """The result's JSON line; a metric that is not finite (a tail past
    the failed requests) is left out, a compared number that is not
    finite is written as a string."""
    metrics = {k: v for k, v in metrics.items() if math.isfinite(v["value"])}
    checks = {k: {kk: _finite(vv) for kk, vv in c.items()} for k, c in checks.items()}
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks  # last: each number compared beside its limit
    return json.dumps(line)


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
