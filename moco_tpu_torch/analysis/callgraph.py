"""The analyzed file set as one program (moco_tpu/analysis/callgraph.py,
less the call graph and the jitted closure, which only the JAX-only rules
read).

`engine.analyze_source` / `analyze_paths` build a `Program` over every
parsed module and attach it to each `ModuleContext` as ``ctx.program``;
the contract rules (JX015-JX018) key their registry on it
(`contracts.registry_for` caches one extraction per program), so four
rules cost one pass over the tree. Stdlib-only.
"""

from __future__ import annotations

from moco_tpu_torch.analysis.astutils import ModuleContext


class Program:
    """The analyzed file set as one unit: path -> ModuleContext."""

    def __init__(self, contexts: dict[str, ModuleContext]):
        self.contexts = contexts


def build_program(contexts: dict[str, ModuleContext]) -> Program:
    """Construct and attach: every ctx gains a ``.program`` backref."""
    program = Program(contexts)
    for ctx in contexts.values():
        ctx.program = program
    return program
