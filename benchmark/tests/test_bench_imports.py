"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (`moco_tpu_torch` begins with `moco_tpu`), and
the plain references import nothing of the program either."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark import harness

HERE = Path(harness.__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "moco_tpu_torch" not in top_level_imports(path)


def test_the_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "moco_tpu_torch_lookalike", types.ModuleType("x"))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "moco_tpu.models", types.ModuleType("y"))
    assert harness.loaded_forbidden() == ["moco_tpu"]


def test_the_harness_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness; "
            "from benchmark.drivers import train, serve; import moco_tpu_torch.train; "
            "import moco_tpu_torch.serve.server; print(harness.loaded_forbidden())"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin"} | {
                             k: v for k, v in __import__("os").environ.items()
                             if k in ("HOME", "TMPDIR", "LD_LIBRARY_PATH")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
