"""The harness's data-driven assembly, its rules for names and units, the
open loop's schedule and timing, and the result line."""

from __future__ import annotations

import json
import math
import re
import shutil

import pytest

from benchmark import harness
from benchmark.drivers import serve

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.mark.parametrize("name", CELLS)
def test_cell_assembles_from_its_files(name):
    cell = harness.load_cell(name)
    assert cell.traffic["driver"] in ("train", "serve")
    assert hasattr(harness.driver_for(cell), "run")
    assert cell.limits, "every cell states the limits of its check"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert (harness.ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e


def test_file_keys_and_limits_of_the_contract():
    assert set(BENCH) == TOP_KEYS
    for group, keys in ENTRY_KEYS.items():
        for entry in BENCH[group]:
            assert set(entry) <= keys, (group, entry)
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert harness.NAME_RE.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert harness.UNIT_RE.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                text = entry.get(key)
                if key in entry and group != "end_to_end":
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for w in BENCH["workloads"]:
        assert harness.NAME_RE.match(w["config"]) and harness.NAME_RE.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(harness.NAME_RE.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
    for path in (harness.ROOT / "benchmark").rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./\-]+$", str(path.relative_to(harness.ROOT)))


def test_a_new_cell_config_and_metric_come_from_new_files_alone(tmp_path):
    """A later change adds a cell, a configuration, a traffic mix and a
    per-layer metric by adding files and entries, editing none."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "fixture_cfg", "source": "https://example.org/paper",
                             "file": "benchmark/configs/fixture_cfg.json", "reduced": [],
                             "why": "a fixture"})
    bench["workloads"].append({"name": "fixture_cell", "config": "fixture_cfg",
                               "traffic": "fixture_mix", "chips": 1, "why": "a fixture"})
    bench["per_layer"].append({"name": "fixture_metric.train", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "a fixture layer",
                               "moves": "train_imgs_per_s", "workloads": ["fixture_cell"]})
    bench["end_to_end"][0]["workloads"].append("fixture_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    here = root / "benchmark"
    (here / "configs" / "fixture_cfg.json").write_text(json.dumps({"global_batch": 4}))
    (here / "traffic" / "fixture_mix.json").write_text(json.dumps({"driver": "train",
                                                                   "dataset_rows": 40}))
    (here / "workloads" / "fixture_cell.json").write_text(json.dumps(
        {"traffic": {"dataset_rows": 80}, "limits": {"loss": 1.0}}))
    (here / "metrics" / "fixture_metric.train.py").write_text(
        "def read(ctx):\n    return ctx.get('fixture')\n")
    cell = harness.load_cell("fixture_cell", root)
    assert cell.config == {"global_batch": 4}
    assert cell.traffic == {"driver": "train", "dataset_rows": 80}
    assert cell.limits == {"loss": 1.0}
    assert [m["name"] for m in cell.end_to_end] == ["train_imgs_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["fixture_metric.train"]
    assert harness.read_per_layer(cell, {"fixture": 2.5}, root) == {
        "fixture_metric.train": {"value": 2.5, "unit": "ms"}}
    assert harness.read_per_layer(cell, {}, root) == {}  # nothing read, nothing reported
    assert harness.driver_for(cell, root).__file__.startswith(str(root))


def test_reports_rule():
    assert harness.reports({"workloads": ["a"]}, "a", ())
    assert not harness.reports({"workloads": ["a"]}, "b", ("x",))
    assert harness.reports({"moves": "x"}, "b", ("x",))
    assert not harness.reports({"moves": "x"}, "b", ("y",))


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 4_200_000_000])
def test_open_loop_schedule_from_the_seed(seed):
    mix = {"1": 0.5, "16": 0.35, "64": 0.15}
    a = serve.schedule(seed, 40.0, 30.0, mix, 512)
    assert a == serve.schedule(seed, 40.0, 30.0, mix, 512)
    assert len(a) == 1200
    due = [q[1] for q in a]
    assert due == sorted(due) and due[0] > 0.0
    assert abs(due[-1] - 30.0) < 3.0
    sizes = [q[3] for q in a]
    assert (sizes.count(1), sizes.count(16), sizes.count(64)) == (600, 420, 180)
    other = serve.schedule(seed + 1, 40.0, 30.0, mix, 512)
    assert sorted(q[3] for q in other) == sorted(sizes)  # the same work, in another order
    gaps = sorted(b - c for b, c in zip(due, [0.0] + due[:-1]))
    other_due = [q[1] for q in other]
    assert gaps == pytest.approx(sorted(b - c for b, c in zip(other_due, [0.0] + other_due[:-1])),
                                 abs=1e-9)
    assert [q[1] for q in other] != due


def test_latency_is_timed_from_the_due_time():
    tr = {"warm_s": 1.0}
    out = {"records": [
        {"i": 0, "due": 0.5, "late": 0.0, "done": 0.6, "status": 200},  # warm-up: not counted
        {"i": 1, "due": 1.0, "late": 0.25, "done": 1.3, "status": 200},  # sent late
        {"i": 2, "due": 1.5, "late": 0.0, "done": 1.52, "status": 200},
        {"i": 3, "due": 2.0, "late": 0.0, "done": 9.0, "status": 503},  # failed
    ]}
    rec, lat = serve.latencies(out, tr, 2.0)
    assert [r["i"] for r in rec] == [1, 2, 3]
    assert lat[0] == pytest.approx(300.0) and lat[1] == pytest.approx(20.0)
    assert math.isinf(lat[2])
    assert serve.percentile(lat, 50) == pytest.approx(300.0)
    assert math.isinf(serve.percentile(lat, 95))


def test_result_line_and_judge():
    ok, checks = harness.judge({"loss": 0.1, "keys": 0.2}, {"loss": 0.5, "keys": 0.3})
    assert ok and list(checks) == ["loss", "keys"]
    assert not harness.judge({"loss": 0.6}, {"loss": 0.5})[0]
    assert not harness.judge({"loss": math.inf}, {"loss": 0.5})[0]
    assert not harness.judge({"loss": 0.1}, {})[0]
    assert not harness.judge({}, {"loss": 0.5})[0]
    device = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    line = json.loads(harness.result_line(True, 3, 0, {"m": {"value": 1.0, "unit": "ms"}},
                                          device, checks))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    traced = json.loads(harness.result_line(True, 3, 0, {}, {**device, "busy_s": 1.0,
                                                              "window_s": 2.0}, checks,
                                            {"device_ops": [], "idle_gaps": []}))
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    from benchmark import run

    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
