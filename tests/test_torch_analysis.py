"""The port's static analyzer (moco_tpu_torch/analysis) against JAX's
(moco_tpu/analysis): the thread and contract rules on JAX's own lint
fixtures, the engine and the CLI (statement-extent suppressions, the
baseline under the port's own file name, SARIF, `--changed`,
`--dump-contracts`, exit codes 0/1/2), the declared registries of
`utils/contracts.py`, and the self-check: the port's tree and every
chip_smoke*.py lint clean with no baseline, with the analyzer's imports
free of torch.

The bad fixtures the port adds live in strings and tmp_path: a .py file
under tests/ with intentional findings would move JAX's checked-in
baseline (tests/test_analysis_v2.py lints all of tests/ against it)."""

import glob
import json
import os
import re
import subprocess
import sys

import pytest

from moco_tpu.analysis import analyze_source as jax_analyze_source
from moco_tpu.analysis import contracts as jax_contracts_mod
from moco_tpu.utils import contracts as jax_decl
from moco_tpu_torch.analysis import analyze_paths, analyze_source, iter_rules, load_baseline
from moco_tpu_torch.analysis import contracts as contracts_mod
from moco_tpu_torch.analysis.__main__ import main as mocolint_main
from moco_tpu_torch.analysis.engine import (
    BASELINE_FILENAME,
    discover_baseline,
    render_sarif,
    write_baseline,
)
from moco_tpu_torch.utils import contracts as decl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
PORTED = ("JX011", "JX012", "JX013", "JX015", "JX016", "JX017", "JX018")


def _triples(findings):
    return sorted((f.rule, f.line, f.message, f.suppressed) for f in findings)


# ---------------------------------------------------------------------------
# the ported rules on JAX's fixtures


@pytest.mark.parametrize("kind", ("bad", "good"))
@pytest.mark.parametrize("rule", PORTED)
def test_rule_matches_jax_on_its_fixtures(rule, kind):
    """JAX's fixture for each ported rule, read as text, gives the same
    (rule, line, message) in both analyzers; the bad one fires on every
    line it marks `# expect: JXnnn` and the good one not at all. The
    contract rules key on each package's own registry (utils/contracts.py,
    obs/schema.py), whose entries the fixtures read are equal in the two
    (test_declared_registries_equal_jax)."""
    path = os.path.join(FIXTURES, f"{rule.lower()}_{kind}.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    want = jax_analyze_source(src, path, rules=[rule])
    got = analyze_source(src, path, rules=[rule])
    assert _triples(got) == _triples(want)
    active = {f.line for f in got if f.active}
    if kind == "bad":
        expected = {i for i, line in enumerate(src.splitlines(), 1)
                    if f"expect: {rule}" in line}
        assert active and expected <= active
    else:
        assert not active


def test_only_the_thread_and_contract_rules_are_ported():
    assert [rid for rid, _ in iter_rules()] == list(PORTED)


@pytest.mark.parametrize("call", ("torch.cuda.synchronize()", "ev.synchronize()",
                                  "torch.cuda.current_stream().synchronize()",
                                  "x.block_until_ready()"))
def test_device_syncs_under_a_lock_are_blocking(call):
    """JX013's blocking calls keep JAX's names and add the port's device
    syncs."""
    src = ("import threading\nimport torch\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def run(self, ev, x):\n"
           "        with self._lock:\n"
           f"            {call}\n")
    found = [f for f in analyze_source(src, "m.py", rules=["JX013"]) if f.line == 8]
    assert len(found) == 1 and "device sync" in found[0].message
    jax_found = [f for f in jax_analyze_source(src, "m.py", rules=["JX013"]) if f.line == 8]
    assert len(jax_found) == ("block_until_ready" in call)


# ---------------------------------------------------------------------------
# engine and CLI

_RACE = ("import threading\n"
         "class C:\n"
         "    def __init__(self):\n"
         "        self._t = threading.Thread(target=self._run)\n"
         "        self._t.start()\n"
         "    def _run(self):\n"
         "        self.n = f(\n"
         "            2,\n"
         "        ){suppress}\n"
         "    def close(self):\n"
         "        self._t.join()\n"
         "    def poke(self):\n"
         "        self.n = 1\n")


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_suppression_on_the_closing_line_of_a_statement():
    src = _RACE.format(suppress="  # mocolint: disable=JX012  (a test's own race)")
    (f,) = analyze_source(src, "m.py", rules=["JX012"])
    assert f.suppressed and not f.active
    bare = analyze_source(_RACE.format(suppress=""), "m.py", rules=["JX012"])
    assert [x.active for x in bare] == [True]
    assert _triples(bare) == _triples(jax_analyze_source(_RACE.format(suppress=""), "m.py",
                                                         rules=["JX012"]))


def test_baseline_round_trip_under_the_ports_own_name(tmp_path):
    """`--update-baseline` writes mocolint-torch-baseline.json beside the
    analyzed file; later runs discover it and pass; JAX's baseline name is
    never looked for."""
    bad = _write(tmp_path, "m.py", _RACE.format(suppress=""))
    (tmp_path / "mocolint-baseline.json").write_text('{"findings": []}')
    assert discover_baseline([bad]) is None  # the JAX name is not the port's
    assert BASELINE_FILENAME == "mocolint-torch-baseline.json"
    target = str(tmp_path / BASELINE_FILENAME)
    assert mocolint_main([bad, "--update-baseline", "--baseline", target]) == 0
    assert discover_baseline([bad]) == target
    assert load_baseline(target) == {"JX012:m.py:7"}
    assert mocolint_main([bad]) == 0  # auto-discovered
    assert mocolint_main([bad, "--no-baseline"]) == 1
    findings = analyze_paths([bad], baseline=load_baseline(target))
    assert findings and all(f.baselined and not f.active for f in findings)
    assert write_baseline(str(tmp_path / "again.json"), findings) == 1


def test_exit_codes_and_reports(tmp_path, capsys):
    good = _write(tmp_path, "good.py", "x = 1\n")
    bad = _write(tmp_path, "bad.py", _RACE.format(suppress=""))
    assert mocolint_main([good, "--no-baseline"]) == 0
    assert mocolint_main([bad, "--no-baseline"]) == 1
    assert mocolint_main([good, "--rules", "JX001"]) == 2  # a JAX-only rule is unknown here
    capsys.readouterr()
    assert mocolint_main(["--list-rules"]) == 0
    assert [ln.split()[0] for ln in capsys.readouterr().out.splitlines()] == list(PORTED)
    report = str(tmp_path / "r.json")
    sarif = str(tmp_path / "r.sarif")
    assert mocolint_main([bad, "--no-baseline", "--format", "json", "-o", report,
                          "--sarif", sarif]) == 1
    rep = json.load(open(report))
    assert rep["counts"] == {"active": 1, "suppressed": 0, "baselined": 0}
    doc = json.load(open(sarif))
    assert doc["version"] == "2.1.0"
    (res,) = doc["runs"][0]["results"]
    assert res["ruleId"] == "JX012" and res["locations"][0]["physicalLocation"]["region"][
        "startLine"] == 7
    assert {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]} == set(PORTED)
    suppressed = analyze_source(_RACE.format(suppress="  # mocolint: disable=JX012  (why)"),
                                "m.py")
    assert json.loads(render_sarif(suppressed))["runs"][0]["results"][0]["suppressions"]


def test_dump_contracts(tmp_path):
    out = str(tmp_path / "contracts.json")
    assert mocolint_main([os.path.join(REPO, "moco_tpu_torch", "serve", "server.py"),
                          "--no-baseline", "--dump-contracts", out]) == 0
    reg = json.load(open(out))
    routes = {(r["route"], r["method"]) for r in reg["handler_routes"]}
    assert {("/healthz", "GET"), ("/ingest", "POST"), ("/embed", "POST")} <= routes
    assert {h["site"] for h in reg["hook_sites"] if h["kind"] == "deadlock"} == {"serve.index"}


def test_changed_lints_only_the_files_that_differ(tmp_path, monkeypatch, capsys):
    repo = tmp_path / "r"
    repo.mkdir()

    def git(*args):
        subprocess.run(["git", *args], cwd=repo, check=True, capture_output=True)

    git("init", "-q")
    git("config", "user.email", "t@example.invalid")
    git("config", "user.name", "t")
    _write(repo, "clean.py", "x = 1\n")
    git("add", "-A")
    git("-c", "commit.gpgsign=false", "commit", "-qm", "base")
    _write(repo, "new.py", _RACE.format(suppress=""))
    monkeypatch.chdir(repo)
    assert mocolint_main([".", "--changed", "HEAD", "--no-baseline"]) == 1
    assert "linting 1 file(s)" in capsys.readouterr().out
    os.remove(repo / "new.py")
    assert mocolint_main([".", "--changed", "HEAD", "--no-baseline"]) == 0
    assert mocolint_main([".", "--changed", "no-such-ref"]) == 2


# ---------------------------------------------------------------------------
# the analyzer's JX012 findings in the port, repaired


def test_async_checkpoint_error_reaches_one_of_two_waiters(tmp_path, monkeypatch):
    """Two threads wait on one failing async write (the loop and the stall
    watchdog's emergency save): both block until the write ends, one of
    them gets its error, and the manager is clean after."""
    import threading
    import time

    import torch

    from moco_tpu_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), async_save=True)
    gate = threading.Event()

    def failing_write(path, payload):
        gate.wait(30)
        raise OSError("injected")

    monkeypatch.setattr(mgr, "_write", failing_write)
    mgr.save(1, {"x": torch.ones(2)})
    errors, done = [], []

    def waiter():
        try:
            mgr.wait()
        except RuntimeError as e:
            errors.append(e)
        done.append(time.monotonic())

    threads = [threading.Thread(target=waiter) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    released = time.monotonic()
    gate.set()
    for t in threads:
        t.join(30)
    assert len(done) == 2 and min(done) >= released
    assert len(errors) == 1 and isinstance(errors[0].__cause__, OSError)
    mgr.close()


def test_batcher_warmup_error_reaches_the_caller():
    from moco_tpu_torch.serve.batcher import ContinuousBatcher

    def warmup():
        raise ValueError("no warm-up")

    b = ContinuousBatcher(lambda images: {}, max_batch=4, warmup=warmup)
    try:
        with pytest.raises(ValueError, match="no warm-up"):
            b.wait_warm(timeout=30)
        assert not b.warm
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the declared registries


def test_declared_registries_equal_jax():
    """The port's utils/contracts.py holds its own values; each equals
    JAX's. JAX's SCALING_GATED_VALIDATORS gates its scaling battery
    script, which the port has no counterpart of; its per-route header
    maps are read by nothing but a test, and the port keeps the headers in
    ROUTES alone."""
    assert decl.EXIT_CODES == jax_decl.EXIT_CODES
    assert decl.SERVE_PORT_STRIDE == jax_decl.SERVE_PORT_STRIDE
    assert decl.TRACE_HEADERS == jax_decl.TRACE_HEADERS
    assert {p: (r.methods, r.headers, r.opt_headers, r.idempotent, r.server)
            for p, r in decl.ROUTES.items()} == {
        p: (r.methods, r.headers, r.opt_headers, r.idempotent, r.server)
        for p, r in jax_decl.ROUTES.items()}
    for name in ("IDEMPOTENT_ROUTES", "LOCK_SITES", "SERVE_STAGE_SITES", "FAULT_SITES",
                 "SERVE_GATED_VALIDATORS", "QUALITY_GATED_VALIDATORS",
                 "FLEET_GATED_VALIDATORS", "PROMOTION_GATED_VALIDATORS"):
        assert getattr(decl, name) == getattr(jax_decl, name), name
    assert all(decl.route_methods(p) == jax_decl.route_methods(p)
               for p in (*decl.ROUTES, "/nope"))
    assert not hasattr(decl, "SCALING_GATED_VALIDATORS")
    assert not hasattr(decl, "REQUIRED_HEADERS") and not hasattr(decl, "OPTIONAL_HEADERS")
    for server in ("replica", "router"):
        assert contracts_mod.declared_route_gates(server) == \
            jax_contracts_mod.declared_route_gates(server)


def test_every_named_lock_of_the_port_is_a_declared_lock_site():
    """Each `make_lock("<name>")` of the port names a LOCK_SITES entry,
    and every entry is used: the deadlock@ fault can reach each lock."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "moco_tpu_torch", "**", "*.py"), recursive=True):
        names |= set(re.findall(r"make_lock\(\"([a-z_.]+)\"\)", open(path).read()))
    assert names == set(decl.LOCK_SITES)


# ---------------------------------------------------------------------------
# the self-check: the port's tree lints clean


@pytest.fixture(scope="module")
def tree_report(tmp_path_factory):
    """One CLI run over moco_tpu_torch/ and every chip_smoke*.py, from the
    repo root, with torch made unimportable (the analyzer is stdlib-only)
    and no baseline file in play."""
    out = str(tmp_path_factory.mktemp("lint") / "report.json")
    smokes = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "chip_smoke*.py")))
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from moco_tpu_torch.analysis.__main__ import main\n"
            f"rc = main(['moco_tpu_torch', *{smokes!r}, '--format', 'json', '-o', {out!r}])\n"
            "assert 'torch' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert not os.path.exists(os.path.join(REPO, BASELINE_FILENAME))
    return proc, json.load(open(out)), smokes


def test_tree_lints_clean_with_no_baseline(tree_report):
    proc, rep, smokes = tree_report
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert rep["counts"]["active"] == 0 and rep["counts"]["baselined"] == 0
    paths = {f["path"] for f in rep["findings"]}
    assert len(smokes) >= 6 and paths  # the suppressed findings are reported too


@pytest.mark.parametrize("rule", PORTED)
def test_no_active_finding_of_each_rule(tree_report, rule):
    _, rep, _ = tree_report
    assert [f for f in rep["findings"] if f["rule"] == rule and not f["suppressed"]] == []


def test_every_suppression_states_its_reason():
    """A `mocolint: disable=` comment in the port carries a parenthesized
    reason, as JAX's do."""
    bare = []
    for path in glob.glob(os.path.join(REPO, "moco_tpu_torch", "**", "*.py"), recursive=True):
        for i, line in enumerate(open(path), 1):
            m = re.search(r"#\s*mocolint:\s*disable=[A-Z0-9,]+(.*)$", line)
            if m and not re.match(r"\s*\(.+\)", m.group(1)):
                bare.append(f"{path}:{i}")
    assert bare == []


def test_no_chip_smoke_script_imports_jax():
    """The port's own import test covers moco_tpu_torch/; the chip_smoke
    scripts are held to the same rule."""
    import ast

    banned = {"jax", "flax", "optax", "moco_tpu"}
    found = []
    for path in sorted(glob.glob(os.path.join(REPO, "chip_smoke*.py"))):
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path, n) for n in names if n.split(".")[0] in banned]
    assert not found
