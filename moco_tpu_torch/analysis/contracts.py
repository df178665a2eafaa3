"""Cross-artifact contract registry + runtime contract-coverage recorder
(moco_tpu/analysis/contracts.py).

The serving fleet is held together by stringly-typed contracts that no
single-file rule can check: metric keys must have a validator in
`obs/schema.py`, HTTP clients must call routes some handler actually
serves (with the headers it requires), `kind@site=` fault specs must
name sites a hook can fire, and the exit codes / port-offset rule must
come from `utils/contracts.py` instead of being re-typed inline.

Two arms share this module:

- **Static** (`build_registry` / `registry_for`): one pass over the
  whole analyzed program extracting every side of every contract —
  metric emissions and validator tables, handler routes and
  urlopen-client calls (methods, headers, status codes), fault hook
  sites and spec literals. The JX015-JX018 rules are thin checks over
  this registry; it is built once per program and cached.

- **Runtime** (`ContractCoverageRecorder`): install a recorder and
  every applied schema validator (`obs/schema.py` callback), every
  handled route (`record_route` in serve/server.py and serve/router.py),
  every propagated trace header (`obs/ctxprop.py` callback) and every
  reached fault hook (`utils/faults.py` callback) is counted;
  `check_coverage` then names each registered contract that never fired.
  A replica installs one from `MOCO_CONTRACT_COVERAGE=1`
  (`maybe_install_from_env`) and dumps it on a graceful exit.

Approximate on purpose: extraction only trusts literals (and
module-level string constants) and skips anything dynamic. Stdlib-only;
`install_recorder` imports the hooked modules when it is called.
"""

from __future__ import annotations

import ast
import json
import os
import re
import threading
from typing import Iterable, Optional

from moco_tpu_torch.analysis.astutils import ModuleContext
from moco_tpu_torch.utils import contracts as decl

# ---------------------------------------------------------------------------
# extraction helpers

# a metric key / prefix family: lowercase family name, a slash, rest
_METRIC_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*/")

# a resolvable fault site: lowercase dotted name (placeholders like
# `<lock>` or a bare `S` in grammar docs never match)
_SITE_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")

# kind@params tokens inside any string (docstrings included — doc drift
# is drift). `\x00` marks an f-string placeholder, see _joined_literal.
_SPEC_RE = re.compile(
    r"\b(ckpt_truncate|io|nan|stall|preempt|delay|diverge|slow|kill|deadlock)"
    r"@([A-Za-z0-9_.=:\x00-]+)"
)

_HTTP_METHODS = ("GET", "POST", "PUT", "DELETE", "HEAD", "PATCH")

_PLACEHOLDER = "\x00"


def _joined_literal(node: ast.JoinedStr) -> str:
    """An f-string as text, formatted values replaced by `\\x00`."""
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append(_PLACEHOLDER)
    return "".join(parts)


def _literal_head(node: ast.JoinedStr) -> Optional[str]:
    """The leading literal chunk of an f-string ('serve/trace_' of
    f"serve/trace_{stage}_ms"), or None when it starts dynamic."""
    if node.values and isinstance(node.values[0], ast.Constant):
        v = node.values[0].value
        if isinstance(v, str):
            return v
    return None


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def parse_fault_specs(text: str) -> list[dict]:
    """Every `kind@k=v[:k=v...]` token in a string. Values containing an
    f-string placeholder come back as None (dynamic, unverifiable)."""
    out = []
    for m in _SPEC_RE.finditer(text):
        kind, body = m.group(1), m.group(2)
        params: dict = {}
        for tok in body.split(":"):
            key, eq, val = tok.partition("=")
            if not eq:
                params.setdefault(key, None)
                continue
            params[key] = None if _PLACEHOLDER in val else val
        out.append({"kind": kind, "params": params, "raw": m.group(0)})
    return out


def _route_from_url(node: ast.AST) -> tuple[Optional[str], bool]:
    """(route, found_literal) for a client URL expression.

    Handles `"http://h:p/stats"`, `base + "/healthz"`, and
    f"{base}/admin/drain?replica={i}" shapes; anything fully dynamic
    returns (None, False). Query strings are stripped — the route is
    the path."""
    texts: list[str] = []
    s = _str_const(node)
    if s is not None:
        texts.append(s)
    elif isinstance(node, ast.JoinedStr):
        texts.extend(
            v.value
            for v in node.values
            if isinstance(v, ast.Constant) and isinstance(v.value, str)
        )
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        for side in (node.left, node.right):
            r, found = _route_from_url(side)
            if found:
                return r, True
        return None, False
    for text in texts:
        m = re.search(r"https?://[^/\s]+(/[^\s\"']*)", text)
        if m:
            text = m.group(1)
        if text.startswith("/"):
            route = text.split("?")[0].rstrip()
            if route and route != "/":
                return route, True
    return None, False


class _Item:
    """One extracted contract occurrence (a location plus fields)."""

    __slots__ = ("path", "line", "data")

    def __init__(self, path: str, line: int, **data):
        self.path = path
        self.line = line
        self.data = data

    def __getattr__(self, name):
        try:
            return self.data[name]
        except KeyError:
            raise AttributeError(name)


class ContractRegistry:
    """Every side of every extracted contract, program-wide."""

    def __init__(self):
        # metric schema
        self.emitted_keys: list[_Item] = []  # key=
        self.emitted_prefixes: list[_Item] = []  # prefix=
        self.field_validators: list[_Item] = []  # key=
        self.prefix_validators: list[_Item] = []  # prefix=
        self.schema_paths: set[str] = set()
        # any string constant occurrence: value -> set of paths
        self.literal_strings: dict[str, set[str]] = {}
        # http
        self.handler_routes: list[_Item] = []  # route=, method=, cls=
        self.client_calls: list[_Item] = []  # route=, method=, func= (node|None)
        self.retry_wraps: list[_Item] = []  # routes=tuple
        self.class_headers: dict[str, set[str]] = {}  # "path::Class" -> X- headers
        self.module_headers: dict[str, set[str]] = {}  # path -> X- headers
        self.handler_status: list[_Item] = []  # code=
        self.client_status: list[_Item] = []  # code=
        # faults
        self.hook_sites: list[_Item] = []  # kind=, site=
        self.spec_literals: list[_Item] = []  # kind=, params=, raw=
        # registry-module presence gates the whole-tree-only clauses
        self.has_registry_module: bool = False
        # every analyzed path — scope gates (e.g. "is the test corpus
        # in this program?") key off it
        self.paths: set[str] = set()

    def hook_site_set(self, kind: str) -> set[str]:
        return {h.site for h in self.hook_sites if h.kind == kind}

    def validator_keys(self) -> set[str]:
        return {v.key for v in self.field_validators}

    def validator_prefixes(self) -> set[str]:
        return {v.prefix for v in self.prefix_validators}

    def to_json(self) -> dict:
        def items(seq):
            return [dict(i.data, path=i.path, line=i.line) for i in seq]

        return {
            "emitted_keys": items(self.emitted_keys),
            "emitted_prefixes": items(self.emitted_prefixes),
            "field_validators": items(self.field_validators),
            "prefix_validators": items(self.prefix_validators),
            "handler_routes": items(self.handler_routes),
            "client_calls": [
                {k: v for k, v in dict(i.data, path=i.path, line=i.line).items()
                 if k != "func"}
                for i in self.client_calls
            ],
            "retry_wraps": items(self.retry_wraps),
            "handler_status": items(self.handler_status),
            "client_status": items(self.client_status),
            "hook_sites": items(self.hook_sites),
            "spec_literals": items(self.spec_literals),
        }


def build_registry(contexts: dict[str, ModuleContext]) -> ContractRegistry:
    reg = ContractRegistry()
    for path, ctx in contexts.items():
        reg.paths.add(path)
        _extract_module(reg, path, ctx)
    return reg


def registry_for(ctx: ModuleContext) -> ContractRegistry:
    """The program-wide registry for this module's program, built once
    and cached on the Program object (single-module fallback when the
    context was never attached to a program)."""
    program = ctx.program
    if program is None:
        return build_registry({ctx.path: ctx})
    cached = getattr(program, "_contract_registry", None)
    if cached is None:
        cached = build_registry(program.contexts)
        program._contract_registry = cached
    return cached


# ---------------------------------------------------------------------------
# per-module extraction


def _extract_module(reg: ContractRegistry, path: str, ctx: ModuleContext) -> None:
    tree = ctx.tree
    if path.replace("\\", "/").endswith("utils/contracts.py") or any(
        isinstance(n, ast.Assign)
        and any(
            isinstance(t, ast.Name) and t.id == "SERVE_STAGE_SITES"
            for t in n.targets
        )
        for n in tree.body
    ):
        reg.has_registry_module = True

    validator_dicts: set[int] = set()  # Dict node ids to skip as emissions
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)):
            continue
        names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        kind = (
            "field"
            if "FIELD_VALIDATORS" in names
            else "prefix"
            if "PREFIX_VALIDATORS" in names
            else None
        )
        if kind is None:
            continue
        validator_dicts.add(id(node.value))
        reg.schema_paths.add(path)
        for k in node.value.keys:
            key = _str_const(k)
            if key is None:
                continue
            item = _Item(path, k.lineno, **{("key" if kind == "field" else "prefix"): key})
            (reg.field_validators if kind == "field" else reg.prefix_validators).append(
                item
            )

    # innermost-enclosing-function lookup for client header checks
    fn_spans = sorted(
        (
            (f.lineno, getattr(f, "end_lineno", f.lineno), f)
            for f in ctx.functions
        ),
        key=lambda t: (t[1] - t[0]),
    )

    def enclosing_fn(line: int) -> Optional[ast.FunctionDef]:
        for start, end, f in fn_spans:
            if start <= line <= end:
                return f
        return None

    mod_headers = reg.module_headers.setdefault(path, set())

    for node in ast.walk(tree):
        # -- string liveness + fault spec literals -------------------------
        text = None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
            reg.literal_strings.setdefault(text, set()).add(path)
            if text.startswith("X-"):
                mod_headers.add(text)
        elif isinstance(node, ast.JoinedStr):
            text = _joined_literal(node)
        if text and "@" in text:
            for spec in parse_fault_specs(text):
                reg.spec_literals.append(_Item(path, node.lineno, **spec))

        # -- metric emissions ----------------------------------------------
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Subscript):
                    key = _str_const(t.slice)
                    if key is not None and _METRIC_KEY_RE.match(key):
                        reg.emitted_keys.append(_Item(path, t.lineno, key=key))
                    elif isinstance(t.slice, ast.JoinedStr):
                        head = _literal_head(t.slice)
                        if head and _METRIC_KEY_RE.match(head):
                            reg.emitted_prefixes.append(
                                _Item(path, t.lineno, prefix=head)
                            )
        if isinstance(node, ast.Dict) and id(node) not in validator_dicts:
            for k in node.keys:
                key = _str_const(k)
                if key is not None and _METRIC_KEY_RE.match(key):
                    reg.emitted_keys.append(_Item(path, k.lineno, key=key))
                elif isinstance(k, ast.JoinedStr):
                    head = _literal_head(k)
                    if head and _METRIC_KEY_RE.match(head):
                        reg.emitted_prefixes.append(_Item(path, k.lineno, prefix=head))

        if not isinstance(node, ast.Call):
            continue
        qual = ctx.qual(node.func) or ""
        base = qual.rsplit(".", 1)[-1]

        # -- fault hooks ----------------------------------------------------
        hook_kind = {
            "maybe_slow": "slow",
            "maybe_delay": "delay",
            "maybe_io_error": "io",
            "make_lock": "deadlock",
            "make_rlock": "deadlock",
        }.get(base)
        if hook_kind and node.args:
            site = _str_const(node.args[0])
            if site is None and isinstance(node.args[0], ast.Name):
                site = ctx.constants.get(node.args[0].id)
            # skip the grammar's own delegating defs (arg is a parameter)
            if site is not None and not path.replace("\\", "/").endswith(
                ("utils/faults.py", "analysis/tsan.py")
            ):
                reg.hook_sites.append(_Item(path, node.lineno, kind=hook_kind, site=site))

        # -- retry / hedge wrappers -----------------------------------------
        if base == "retry_call":
            fn = enclosing_fn(node.lineno)
            routes: list[str] = []
            if fn is not None:
                for n in ast.walk(fn):
                    if (
                        isinstance(n, ast.Compare)
                        and n.lineno <= node.lineno
                        and len(n.ops) == 1
                        and isinstance(n.ops[0], (ast.In, ast.NotIn))
                        and isinstance(n.comparators[0], (ast.Tuple, ast.List, ast.Set))
                    ):
                        for el in n.comparators[0].elts:
                            r = _str_const(el)
                            if r and r.startswith("/"):
                                routes.append(r)
            reg.retry_wraps.append(
                _Item(path, node.lineno, routes=tuple(dict.fromkeys(routes)))
            )

        # -- urlopen clients -------------------------------------------------
        is_request = qual.endswith("urllib.request.Request") or qual == "Request"
        is_urlopen = base == "urlopen"
        if is_request or is_urlopen:
            url_arg = node.args[0] if node.args else None
            route, found = (
                _route_from_url(url_arg) if url_arg is not None else (None, False)
            )
            if found:
                method = "GET"
                if (
                    len(node.args) > 1
                    and not (
                        isinstance(node.args[1], ast.Constant)
                        and node.args[1].value is None
                    )
                ) or any(
                    kw.arg == "data"
                    and not (
                        isinstance(kw.value, ast.Constant) and kw.value.value is None
                    )
                    for kw in node.keywords
                ):
                    method = "POST"
                for kw in node.keywords:
                    if kw.arg == "method":
                        m = _str_const(kw.value)
                        if m:
                            method = m.upper()
                reg.client_calls.append(
                    _Item(
                        path,
                        node.lineno,
                        route=route,
                        method=method,
                        func=enclosing_fn(node.lineno),
                    )
                )

        # -- status codes (registry data for reports/coverage) ---------------
        if base in ("send_response", "send_error") and node.args:
            code = node.args[0]
            if isinstance(code, ast.Constant) and isinstance(code.value, int):
                reg.handler_status.append(_Item(path, node.lineno, code=code.value))

    # -- handler routes: do_* methods keyed by innermost class ---------------
    class _ClassWalker(ast.NodeVisitor):
        def __init__(self):
            self.stack: list[ast.ClassDef] = []

        def visit_ClassDef(self, node: ast.ClassDef):
            self.stack.append(node)
            key = f"{path}::{node.name}"
            hdrs = reg.class_headers.setdefault(key, set())
            for n in ast.walk(node):
                if isinstance(n, ast.Constant) and isinstance(n.value, str):
                    if n.value.startswith("X-"):
                        hdrs.add(n.value)
            self.generic_visit(node)
            self.stack.pop()

        def visit_FunctionDef(self, node: ast.FunctionDef):
            if self.stack and node.name.startswith("do_"):
                method = node.name[3:].upper()
                if method in _HTTP_METHODS:
                    cls = self.stack[-1].name
                    seen: set[tuple] = set()
                    for n in ast.walk(node):
                        lits: list[tuple[str, int]] = []
                        if isinstance(n, ast.Compare):
                            for cand in [n.left, *n.comparators]:
                                s = _str_const(cand)
                                if s and s.startswith("/"):
                                    lits.append((s, cand.lineno))
                                elif isinstance(cand, (ast.Tuple, ast.List, ast.Set)):
                                    for el in cand.elts:
                                        s = _str_const(el)
                                        if s and s.startswith("/"):
                                            lits.append((s, el.lineno))
                        elif (
                            isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Attribute)
                            and n.func.attr == "startswith"
                            and n.args
                        ):
                            s = _str_const(n.args[0])
                            if s and s.startswith("/"):
                                lits.append((s.split("?")[0], n.args[0].lineno))
                        for route, line in lits:
                            route = route.split("?")[0]
                            if (route, method) not in seen and route != "/":
                                seen.add((route, method))
                                reg.handler_routes.append(
                                    _Item(
                                        path, line, route=route, method=method, cls=cls
                                    )
                                )
            self.generic_visit(node)

        visit_AsyncFunctionDef = visit_FunctionDef

    _ClassWalker().visit(tree)

    # client-observed status codes: `e.code == 503` comparisons
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and len(node.comparators) == 1:
            sides = (node.left, node.comparators[0])
            for a, b in (sides, sides[::-1]):
                if (
                    isinstance(a, ast.Attribute)
                    and a.attr in ("code", "status")
                    and isinstance(b, ast.Constant)
                    and isinstance(b.value, int)
                ):
                    reg.client_status.append(_Item(path, node.lineno, code=b.value))


# ---------------------------------------------------------------------------
# runtime contract-coverage recorder


class ContractCoverageRecorder:
    """Thread-safe counters for contracts observed at runtime.

    Sections: `validators` (schema keys/prefixes that applied), `routes`
    ("METHOD /path" handled), `fault_hooks` ("kind@site" hook reached),
    `headers` (propagated trace headers parsed/injected — obs/ctxprop).
    Multi-process runs dump per-process files and merge with
    `merge_coverage`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.validators: dict[str, int] = {}
        self.routes: dict[str, int] = {}
        self.fault_hooks: dict[str, int] = {}
        self.headers: dict[str, int] = {}

    def _bump(self, table: dict, key: str) -> None:
        with self._lock:
            table[key] = table.get(key, 0) + 1

    def record_validator(self, key: str) -> None:
        self._bump(self.validators, key)

    def record_route(self, method: str, path: str) -> None:
        self._bump(self.routes, f"{method.upper()} {path.split('?')[0]}")

    def record_fault_hook(self, kind: str, site: Optional[str]) -> None:
        self._bump(self.fault_hooks, f"{kind}@{site}" if site else kind)

    def record_header(self, name: str) -> None:
        self._bump(self.headers, name)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "validators": dict(self.validators),
                "routes": dict(self.routes),
                "fault_hooks": dict(self.fault_hooks),
                "headers": dict(self.headers),
            }

    def dump(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, indent=2, sort_keys=True)
            fh.write("\n")
        return snap


_RECORDER: Optional[ContractCoverageRecorder] = None

# a replica's dump in its workdir (serve/replica_main.py); the supervisor
# removes it when it first starts the slot (serve/fleet.py), so the dumps
# add up over one run's respawns only
COVERAGE_FILE = "contract_coverage.json"


def install_recorder(
    rec: Optional[ContractCoverageRecorder] = None,
) -> ContractCoverageRecorder:
    """Install (and wire into obs/schema + utils/faults) a recorder."""
    global _RECORDER
    _RECORDER = rec or ContractCoverageRecorder()
    from moco_tpu_torch.obs import ctxprop as _ctxprop
    from moco_tpu_torch.obs import schema as _schema
    from moco_tpu_torch.utils import faults as _faults

    _schema.set_coverage_callback(_RECORDER.record_validator)
    _faults.set_coverage_callback(_RECORDER.record_fault_hook)
    _ctxprop.set_coverage_callback(_RECORDER.record_header)
    return _RECORDER


def uninstall_recorder() -> None:
    global _RECORDER
    _RECORDER = None
    from moco_tpu_torch.obs import ctxprop as _ctxprop
    from moco_tpu_torch.obs import schema as _schema
    from moco_tpu_torch.utils import faults as _faults

    _schema.set_coverage_callback(None)
    _faults.set_coverage_callback(None)
    _ctxprop.set_coverage_callback(None)


def get_recorder() -> Optional[ContractCoverageRecorder]:
    return _RECORDER


def record_route(method: str, path: str) -> None:
    """Zero-cost-when-off route hook for the HTTP handlers."""
    if _RECORDER is not None:
        _RECORDER.record_route(method, path)


def maybe_install_from_env() -> Optional[ContractCoverageRecorder]:
    """Child-process arm: `MOCO_CONTRACT_COVERAGE=1` in the environment
    (set by whoever spawns the replicas) installs a recorder; the replica
    dumps it on a graceful exit (`dump_merged`)."""
    if os.environ.get("MOCO_CONTRACT_COVERAGE"):
        return install_recorder()
    return None


def merge_coverage(snapshots: Iterable[dict]) -> dict:
    """Union per-process coverage dumps (counts added)."""
    out: dict = {"validators": {}, "routes": {}, "fault_hooks": {}, "headers": {}}
    for snap in snapshots:
        for section in out:
            for k, v in (snap.get(section) or {}).items():
                out[section][k] = out[section].get(k, 0) + int(v)
    return out


def dump_merged(rec: ContractCoverageRecorder, path: str) -> dict:
    """`rec`'s snapshot added to the dump already at `path` (a respawned
    replica's slot keeps one file over the run: `merge_coverage`), written
    back; returns the merged counts."""
    snaps = [rec.snapshot()]
    if os.path.exists(path):
        with open(path, encoding="utf-8") as fh:
            snaps.insert(0, json.load(fh))
    merged = merge_coverage(snaps)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(merged, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return merged


def check_coverage(
    coverage: dict,
    routes: Iterable[str] = (),
    fault_sites: Iterable[str] = (),
    validators: Iterable[str] = (),
    headers: Iterable[str] = (),
) -> list[str]:
    """Missing-contract descriptions (empty list = gate passes).

    `routes` entries are "METHOD /path"; `fault_sites` are "kind@site"
    (or a bare kind); `validators` are schema keys/prefixes; `headers`
    are propagated trace-header names (obs/ctxprop)."""
    missing = []
    seen_routes = set(coverage.get("routes") or {})
    for r in routes:
        if r not in seen_routes:
            missing.append(f"route never handled: {r}")
    seen_hooks = set(coverage.get("fault_hooks") or {})
    for s in fault_sites:
        if s not in seen_hooks:
            missing.append(f"fault hook never reached: {s}")
    seen_validators = set(coverage.get("validators") or {})
    for v in validators:
        if v not in seen_validators:
            missing.append(f"schema validator never applied: {v}")
    seen_headers = set(coverage.get("headers") or {})
    for h in headers:
        if h not in seen_headers:
            missing.append(f"trace header never propagated: {h}")
    return missing


def declared_route_gates(server: Optional[str] = None) -> list[str]:
    """The "METHOD /path" gate list from the declared ROUTES registry,
    optionally restricted to routes a given server ("replica"/"router")
    participates in."""
    out = []
    for path, r in sorted(decl.ROUTES.items()):
        if server is not None and r.server not in (server, "both"):
            continue
        for m in r.methods:
            out.append(f"{m} {path}")
    return out
