"""mocolint engine (moco_tpu/analysis/engine.py): rule registry,
suppression comments, baselines, reporting.

Rules live in `moco_tpu_torch/analysis/rules/` — one module per rule,
each registering itself with :func:`rule`. A rule is a callable
``(ModuleContext) -> Iterable[(ast_node_or_line, message)]``; the engine
stamps rule id / path / position, applies suppression comments, and
renders text, JSON or SARIF. `analyze_paths` parses the WHOLE file set
first and attaches a `callgraph.Program` to every module context, so the
contract rules see one registry program-wide.

Suppression is per statement, per rule — the comment may sit on ANY
line of the statement's extent (first line, a continuation line, or the
closing paren of a multi-line call)::

    risky_line()  # mocolint: disable=JX012  (why this is intentional)
    other()       # mocolint: disable=JX012,JX013  (one reason for both)
    x = helper(
        arg,
    )  # mocolint: disable=JX015  (closing-line suppression works)

Suppressed findings are kept (with ``suppressed=True``) so reports can
audit them; only unsuppressed findings affect the exit code.

Baselines gate rule rollout: ``write_baseline`` records the current
findings' fingerprints (rule, path, line); a later run with the
baseline loaded marks exactly those findings ``baselined=True``. The
port's baseline file is `mocolint-torch-baseline.json`, a name of its
own, so walking up from `moco_tpu_torch/` never picks up (or
overwrites) the JAX package's `mocolint-baseline.json`. The port ships
at zero findings with no baseline file.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable, Iterator, Optional, Union

from moco_tpu_torch.analysis.astutils import ModuleContext
from moco_tpu_torch.analysis.callgraph import build_program

# top-level directory names a repo-relative path is anchored at
ANCHORS = ("moco_tpu_torch", "scripts", "tests")

RuleResult = Iterable[tuple[Union[ast.AST, int], str]]
RuleFn = Callable[[ModuleContext], RuleResult]

_RULES: dict[str, tuple[str, RuleFn]] = {}

_SUPPRESS_RE = re.compile(r"#\s*mocolint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    message: str
    path: str
    line: int
    col: int = 0
    suppressed: bool = False
    baselined: bool = False

    @property
    def active(self) -> bool:
        """Counts toward the nonzero exit code."""
        return not self.suppressed and not self.baselined

    def fingerprint(self) -> str:
        """Baseline identity: rule + normalized path + line. Line-based
        on purpose — a baseline is a snapshot, regenerated with
        `--update-baseline` when the baselined files move."""
        return f"{self.rule}:{norm_path(self.path)}:{self.line}"

    def render(self) -> str:
        tag = (
            " (suppressed)" if self.suppressed
            else " (baselined)" if self.baselined
            else ""
        )
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"


def norm_path(path: str) -> str:
    """Repo-stable path form for fingerprints: forward slashes, anchored
    at the repo's top-level package/dir names (`ANCHORS`) — the same file must
    fingerprint identically whether the analyzer was invoked as
    `mocolint tests/`, `mocolint ./tests`, or with absolute paths."""
    p = os.path.normpath(path).replace(os.sep, "/")
    parts = p.split("/")
    for anchor in ANCHORS:
        if anchor in parts[:-1]:
            return "/".join(parts[parts.index(anchor):])
    if p.startswith("./"):
        p = p[2:]
    return parts[-1] if os.path.isabs(path) else p


def rule(rule_id: str, summary: str) -> Callable[[RuleFn], RuleFn]:
    """Decorator registering a rule under its JXnnn id."""

    def deco(fn: RuleFn) -> RuleFn:
        _RULES[rule_id] = (summary, fn)
        return fn

    return deco


def _load_rules() -> None:
    # importing the package registers every rule module
    import moco_tpu_torch.analysis.rules  # noqa: F401


def iter_rules() -> list[tuple[str, str]]:
    """[(rule_id, one-line summary)] for --list-rules and the README table."""
    _load_rules()
    return sorted((rid, summary) for rid, (summary, _) in _RULES.items())


def _suppressed_rules(line: str) -> set[str]:
    m = _SUPPRESS_RE.search(line)
    if not m:
        return set()
    return {tok.strip().upper() for tok in m.group(1).split(",") if tok.strip()}


def _stmt_extents(tree: ast.Module) -> list[tuple[int, int]]:
    """(first_line, last_line) of every statement's own extent.

    A compound statement (if/for/while/with) contributes only its HEADER
    lines — its body statements carry their own extents — so a
    suppression inside a function body never leaks to sibling findings.
    Function/class defs and try blocks are pure containers here.
    """
    extents: list[tuple[int, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        if isinstance(node, (ast.If, ast.While)):
            end = getattr(node.test, "end_lineno", None)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            end = getattr(node.iter, "end_lineno", None)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            ends = [getattr(i.context_expr, "end_lineno", None) for i in node.items]
            end = max((e for e in ends if e), default=None)
        elif isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Try)
        ):
            continue
        else:
            end = getattr(node, "end_lineno", None)
        extents.append((node.lineno, end or node.lineno))
    return extents


def _suppression_extent(extents: list[tuple[int, int]], line: int) -> tuple[int, int]:
    """The smallest statement extent containing `line` (the statement the
    finding anchors to); the line itself when no statement covers it."""
    best: Optional[tuple[int, int]] = None
    for start, end in extents:
        if start <= line <= end:
            if best is None or (end - start) < (best[1] - best[0]):
                best = (start, end)
    return best or (line, line)


def analyze_source(
    source: str,
    path: str,
    rules: Optional[Iterable[str]] = None,
    ctx: Optional[ModuleContext] = None,
) -> list[Finding]:
    """All findings (suppressed ones flagged, not dropped) for one file.

    Called directly (tests, one-off strings) it builds a single-file
    program so cross-function resolution works within the module; the
    multi-file path (`analyze_paths`) passes a pre-built `ctx` already
    carrying the whole-program backref.
    """
    _load_rules()
    if ctx is None:
        ctx = parse_module(source, path)
        if isinstance(ctx, Finding):
            return [ctx]
        build_program({path: ctx})
    selected = set(rules) if rules is not None else set(_RULES)
    extents = _stmt_extents(ctx.tree)
    findings: list[Finding] = []
    for rule_id, (_, fn) in sorted(_RULES.items()):
        if rule_id not in selected:
            continue
        for node, message in fn(ctx):
            line = node if isinstance(node, int) else getattr(node, "lineno", 1)
            col = 0 if isinstance(node, int) else getattr(node, "col_offset", 0)
            # suppression anchored to the FULL statement extent: the
            # comment may sit on the closing line of a multi-line call
            # while the finding anchors to the statement's first line
            start, end = _suppression_extent(extents, line)
            suppressed_here: set[str] = set()
            for ln in range(start, min(end, len(ctx.source_lines)) + 1):
                if 0 < ln <= len(ctx.source_lines):
                    suppressed_here |= _suppressed_rules(ctx.source_lines[ln - 1])
            findings.append(
                Finding(
                    rule=rule_id,
                    message=message,
                    path=path,
                    line=line,
                    col=col,
                    suppressed=rule_id.upper() in suppressed_here
                    or "ALL" in suppressed_here,
                )
            )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def parse_module(source: str, path: str) -> Union[ModuleContext, Finding]:
    """Parse one file into a ModuleContext, or a PARSE Finding."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return Finding(
            rule="PARSE",
            message=f"syntax error: {e.msg}",
            path=path,
            line=e.lineno or 1,
            col=e.offset or 0,
        )
    return ModuleContext(tree, source, path)


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if d != "__pycache__" and not d.startswith(".")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def analyze_paths(
    paths: Iterable[str],
    rules: Optional[Iterable[str]] = None,
    baseline: Optional[set[str]] = None,
) -> list[Finding]:
    """Analyze a file set as ONE program: every module is parsed first,
    the call graph + dataflow summaries are built over all of them, and
    only then do the rules run — so taint crosses file boundaries.
    `baseline` is a set of fingerprints to mark (not drop)."""
    _load_rules()
    contexts: dict[str, ModuleContext] = {}
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        with open(f, "r", encoding="utf-8") as fh:
            parsed = parse_module(fh.read(), f)
        if isinstance(parsed, Finding):
            findings.append(parsed)
        else:
            contexts[f] = parsed
    if contexts:
        build_program(contexts)
    for f, ctx in contexts.items():
        source = "\n".join(ctx.source_lines)
        findings.extend(analyze_source(source, f, rules=rules, ctx=ctx))
    if baseline:
        findings = [
            dataclasses.replace(fi, baselined=True)
            if not fi.suppressed and fi.fingerprint() in baseline
            else fi
            for fi in findings
        ]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---------------------------------------------------------------------------
# baselines

BASELINE_FILENAME = "mocolint-torch-baseline.json"


def load_baseline(path: str) -> set[str]:
    """Fingerprints from a baseline file written by `write_baseline`."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        entries = data.get("findings", [])
    else:  # bare list form is accepted too
        entries = data
    out: set[str] = set()
    for e in entries:
        if isinstance(e, str):
            out.add(e)
        elif isinstance(e, dict) and {"rule", "path", "line"} <= set(e):
            out.add(f"{e['rule']}:{norm_path(e['path'])}:{e['line']}")
    return out


def write_baseline(path: str, findings: list[Finding]) -> int:
    """Record every unsuppressed finding's fingerprint (suppressed ones
    already carry their justification in-source). Returns the count."""
    by_fp: dict[str, dict] = {}
    for f in findings:
        if not f.suppressed:
            by_fp.setdefault(
                f.fingerprint(),
                {
                    "rule": f.rule,
                    "path": norm_path(f.path),
                    "line": f.line,
                    "message": f.message,  # for humans diffing the baseline
                },
            )
    entries = [by_fp[k] for k in sorted(by_fp)]
    payload = {
        "version": 1,
        "note": (
            "mocolint findings baseline — regenerate with "
            "`python -m moco_tpu_torch.analysis <paths> --update-baseline`; "
            "a run fails on any finding NOT fingerprinted here"
        ),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(entries)


def discover_baseline(paths: Iterable[str]) -> Optional[str]:
    """Walk up from each analyzed path looking for a
    `mocolint-torch-baseline.json`; first hit wins. `--no-baseline` opts
    out."""
    seen: set[str] = set()
    for p in paths:
        d = os.path.abspath(p if os.path.isdir(p) else os.path.dirname(p) or ".")
        while d not in seen:
            seen.add(d)
            candidate = os.path.join(d, BASELINE_FILENAME)
            if os.path.isfile(candidate):
                return candidate
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    return None


def render_text(findings: list[Finding], show_suppressed: bool = False) -> str:
    shown = [f for f in findings if show_suppressed or f.active]
    lines = [f.render() for f in shown]
    active = sum(1 for f in findings if f.active)
    suppressed = sum(1 for f in findings if f.suppressed)
    baselined = sum(1 for f in findings if f.baselined)
    lines.append(
        f"mocolint: {active} finding(s)"
        + (f", {suppressed} suppressed" if suppressed else "")
        + (f", {baselined} baselined" if baselined else "")
    )
    return "\n".join(lines)


def render_json(findings: list[Finding]) -> str:
    return json.dumps(
        {
            "version": 1,
            "counts": {
                "active": sum(1 for f in findings if f.active),
                "suppressed": sum(1 for f in findings if f.suppressed),
                "baselined": sum(1 for f in findings if f.baselined),
            },
            "findings": [dataclasses.asdict(f) for f in findings],
        },
        indent=2,
    )


def render_sarif(findings: list[Finding]) -> str:
    """SARIF 2.1.0 — the GitHub code-scanning upload format. Suppressed
    and baselined findings are included but carry a `suppressions`
    entry, so code scanning shows them as dismissed rather than open."""
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "warning",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": norm_path(f.path),
                            "uriBaseId": "%SRCROOT%",
                        },
                        "region": {
                            "startLine": f.line,
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        if f.suppressed:
            result["suppressions"] = [
                {"kind": "inSource", "justification": "mocolint: disable comment"}
            ]
        elif f.baselined:
            result["suppressions"] = [
                {"kind": "external", "justification": BASELINE_FILENAME}
            ]
        results.append(result)
    payload = {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "mocolint",
                        "informationUri": "https://example.invalid/mocolint",
                        "rules": [
                            {
                                "id": rule_id,
                                "shortDescription": {"text": summary},
                            }
                            for rule_id, summary in iter_rules()
                        ],
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }
    return json.dumps(payload, indent=2)
