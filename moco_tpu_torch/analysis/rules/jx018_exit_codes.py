"""JX018: single-source exit-code and port-offset constants.

The magic numbers 42 (watchdog stall), 75 (elastic rescale) and 113
(chaos kill) are load-bearing: harnesses gate on them, supervisors
dispatch on them. They live in `utils/contracts.py` (`EXIT_CODES`);
re-typing one inline means the next renumbering silently breaks every
copy. Same story for the port-offset rule: `base + process_index` (and
the `SERVE_PORT_STRIDE` collision shift) is implemented exactly once,
by `obs/sinks.py` `derive_metrics_port`/`resolve_serve_port` — a
hand-computed offset elsewhere will disagree with the resolver the
moment the collision rule changes.

Flagged shapes:

- an exit call (`sys.exit`/`os._exit`/`SystemExit`/`exit`) with an
  inline 42/75/113;
- a comparison of 42/75/113 against something exit-ish (`rc`,
  `returncode`, `exit`, `code`, `status` in the other operand);
- an exit-ish keyword (`expect_rc=`, `rc=`, `returncode=`,
  `exit_code=`) passed an inline code;
- `<something>port</something> + <something>index</something>`
  arithmetic, or any arithmetic on `SERVE_PORT_STRIDE`, outside the two
  sanctioned resolver functions.

The registry module itself is exempt (it is the single source).
"""

from __future__ import annotations

import ast
import re

from moco_tpu_torch.analysis.engine import rule
from moco_tpu_torch.utils import contracts as decl

_EXIT_CALLS = ("exit", "_exit", "SystemExit")
_EXIT_KWARGS = ("expect_rc", "expected_rc", "rc", "returncode", "exit_code")
_EXITISH_RE = re.compile(r"\b(rc|returncode|exitcode|exit_code|exit|code|status)\b")


def _last_segment(node) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _portish(node) -> bool:
    return "port" in _last_segment(node).lower()


def _indexish(node) -> bool:
    seg = _last_segment(node).lower()
    return seg in ("pidx", "rank") or seg.endswith("index")


def _strideish(node) -> bool:
    return _last_segment(node) == "SERVE_PORT_STRIDE"


@rule("JX018", "inline exit-code literal or hand-computed port offset — use the shared constants")
def check_exit_codes(ctx):
    if ctx.path.replace("\\", "/").endswith("utils/contracts.py"):
        return
    codes = set(decl.EXIT_CODES.values())
    by_code = {v: k for k, v in decl.EXIT_CODES.items()}

    def const_name(val: int) -> str:
        return {
            "stall": "STALL_EXIT_CODE",
            "rescale": "RESCALE_EXIT_CODE",
            "kill": "KILL_EXIT_CODE",
        }[by_code[val]]

    sanctioned: list[tuple[int, int]] = [
        (f.lineno, getattr(f, "end_lineno", f.lineno))
        for f in ctx.functions
        if f.name in ("derive_metrics_port", "resolve_serve_port")
    ]

    def in_sanctioned(line: int) -> bool:
        return any(a <= line <= b for a, b in sanctioned)

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            base = (ctx.qual(node.func) or "").rsplit(".", 1)[-1]
            if base in _EXIT_CALLS:
                for a in node.args:
                    if isinstance(a, ast.Constant) and a.value in codes:
                        yield (
                            node.lineno,
                            f"inline exit code {a.value} — use "
                            f"utils/contracts.{const_name(a.value)}",
                        )
            for kw in node.keywords:
                if (
                    kw.arg in _EXIT_KWARGS
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value in codes
                ):
                    yield (
                        node.lineno,
                        f"inline exit code {kw.value.value} passed as "
                        f"{kw.arg}= — use utils/contracts."
                        f"{const_name(kw.value.value)}",
                    )
        elif isinstance(node, ast.Compare) and len(node.comparators) == 1:
            sides = (node.left, node.comparators[0])
            for a, b in (sides, sides[::-1]):
                if (
                    isinstance(a, ast.Constant)
                    and a.value in codes
                    and not isinstance(b, ast.Constant)
                    and _EXITISH_RE.search(ast.unparse(b).lower())
                ):
                    yield (
                        node.lineno,
                        f"exit code {a.value} compared inline — use "
                        f"utils/contracts.{const_name(a.value)}",
                    )
                    break
        elif isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Sub)):
            if in_sanctioned(node.lineno):
                continue
            l, r = node.left, node.right
            if _strideish(l) or _strideish(r):
                yield (
                    node.lineno,
                    "arithmetic on SERVE_PORT_STRIDE outside the sanctioned "
                    "resolver — use obs/sinks.resolve_serve_port",
                )
            elif (_portish(l) and _indexish(r)) or (_indexish(l) and _portish(r)):
                yield (
                    node.lineno,
                    "hand-computed port offset — use obs/sinks."
                    "derive_metrics_port / resolve_serve_port",
                )
