"""Shared AST machinery for the mocolint rules (moco_tpu/analysis/astutils.py,
less its jitted-scope discovery and flow walker, which only the JAX-only
rules read).

Everything here is deliberately *approximate*: a linter wants high-value
findings at near-zero false-positive rate, not soundness. The primitive
is import-alias resolution (``from moco_tpu_torch.utils import faults`` ->
``moco_tpu_torch.utils.faults``), so rules match on dotted qualnames
instead of guessing at surface spellings.
"""

from __future__ import annotations

import ast
from typing import Optional


def collect_imports(tree: ast.Module) -> dict[str, str]:
    """Local binding -> dotted origin, e.g. {'faults':
    'moco_tpu_torch.utils.faults', 'threading': 'threading'}."""
    imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    imports[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    imports[root] = root
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                origin = f"{mod}.{a.name}" if mod else a.name
                imports[a.asname or a.name] = origin
    return imports


def qualname(node: ast.AST, imports: dict[str, str]) -> Optional[str]:
    """Dotted name of an expression through the import map, or None for
    anything that isn't a plain Name/Attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return ".".join([imports.get(node.id, node.id)] + parts[::-1])
    return None


class ModuleContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, tree: ast.Module, source: str, path: str):
        self.tree = tree
        self.path = path
        self.source_lines = source.splitlines()
        # the whole-program backref, attached by analysis.callgraph
        self.program = None
        self.imports = collect_imports(tree)
        self.functions: list[ast.FunctionDef] = [
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        self.constants = self._module_constants(tree)

    @staticmethod
    def _module_constants(tree: ast.Module) -> dict[str, str]:
        """Module-level NAME = "string" assignments (site-name constants)."""
        out: dict[str, str] = {}
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = node.value.value
        return out

    def qual(self, node: ast.AST) -> Optional[str]:
        return qualname(node, self.imports)
