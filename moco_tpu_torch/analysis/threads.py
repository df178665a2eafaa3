"""Thread-escape + lock-set model for the concurrency rules (JX012/JX013),
moco_tpu/analysis/threads.py.

The port's serving and input surfaces are threaded — batcher and flusher
threads, HTTP handler pools, ingest tails, prefetch rings, async param
gathers, the router's drain worker — and the bug classes that come with it
(unlocked shared counters, lock-order inversions, blocking calls under a
lock) hang or corrupt a replica in ways no test run reliably surfaces.
This module computes, per class ("component"), the facts those rules
need, with the same contract as the rest of mocolint: approximate,
near-zero false positives, unresolvable constructs stay unresolved.

The model answers three questions per component:

1. **Which threads reach each method?** Roots are: `threading.Thread(
   target=...)` targets, HTTP handler methods (``do_GET``/``do_POST``/…
   on a nested handler class — one thread PER REQUEST, so a handler
   root counts as two threads by itself), and callback escapes (a bound
   method passed by reference to any call — the batcher's `run_batch`,
   an alert engine's `on_fire`). Public methods additionally carry the
   calling ("main") thread. Roots propagate caller→callee over the
   intra-component call graph (`self.m()` and outer-alias calls — the
   repo's ``server = self`` / ``sink = self`` closure idiom resolves to
   the owning component).

2. **Which locks are provably held at each attribute access?** A
   lock-set walker tracks ``with self._lock:`` blocks (locks are
   recognized by constructor — `threading.Lock`/`RLock`/
   `tsan.make_lock` — or a ``lock``-ish name) and threads guaranteed
   locks through intra-component calls: a private method invoked ONLY
   under a lock inherits it (the intersection over its call sites, to a
   fixpoint), so `_handle_ingest`-style helpers don't false-positive.

3. **What does each lock acquisition order/block on?** Acquiring lock B
   while A is held contributes an A→B edge to the component's
   lock-order graph (JX013 reports cycles), and calls that can block
   unboundedly — `put`/`get` with no timeout, `Event.wait()` with no
   timeout, `urlopen`, `time.sleep`, `join`, the device syncs
   (`torch.cuda.synchronize`, `Event.synchronize`, `Stream.synchronize`,
   and JAX's `block_until_ready` / `device_get`, kept so one fixture
   means the same in both analyzers) — are recorded with the lock-set
   they run under.

`__init__` accesses are excluded everywhere: construction happens
strictly before any thread this model knows about starts (the
happens-before edge `Thread.start()` provides). A nested HTTP handler
class's OWN attributes are also excluded — `http.server` builds one
handler instance per request, so they are per-thread by construction;
only its accesses to the outer component (via the alias) are shared.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional

from moco_tpu_torch.analysis.astutils import ModuleContext

# attribute values of these constructor shapes are thread-safe-by-design
# primitives (or are the synchronization itself) — never "shared mutable
# state" in the JX012 sense
_SAFE_CTOR_SUFFIXES = (
    ".Lock", ".RLock", ".Event", ".Condition", ".Semaphore",
    ".BoundedSemaphore", ".Barrier", ".local", ".Queue", ".SimpleQueue",
    ".LifoQueue", ".PriorityQueue", ".deque", ".make_lock", ".make_rlock",
)
_SAFE_CTOR_NAMES = {
    "Lock", "RLock", "Event", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "deque", "make_lock", "make_rlock",
}

_LOCK_CTOR_SUFFIXES = (".Lock", ".RLock", ".make_lock", ".make_rlock")
_LOCK_CTOR_NAMES = {"Lock", "RLock", "make_lock", "make_rlock"}

# container-mutating method names that count as a WRITE to the receiver
# attribute (self._pending.append(...) mutates self._pending)
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "add", "update",
    "insert", "remove", "discard", "pop", "popleft", "popitem", "clear",
    "setdefault", "sort",
}

_HTTP_HANDLER_METHODS = {
    "do_GET", "do_POST", "do_PUT", "do_DELETE", "do_HEAD", "do_PATCH",
}

MAIN_ROOT = "main"


@dataclasses.dataclass
class Access:
    attr: str
    # "write"  = direct (re)assignment / subscript store
    # "mutate" = container-mutating method call (x.append, x.add, ...)
    # "read"   = deep use (x.count, x.query(...)) — reads mutable state
    # "ref"    = bare reference (x is None, passing x along) — races only
    #            when the attr itself is reassigned somewhere
    kind: str
    method: str
    lineno: int
    node: ast.AST
    locks: frozenset[str]

    @property
    def is_write(self) -> bool:
        return self.kind in ("write", "mutate")


@dataclasses.dataclass
class LockEdge:
    """Lock `held` was held while `acquired` was acquired."""

    held: str
    acquired: str
    method: str
    node: ast.AST


@dataclasses.dataclass
class BlockingCall:
    desc: str
    method: str
    node: ast.AST
    locks: frozenset[str]


class ComponentModel:
    """One class (plus its nested handler classes and closures) as a
    concurrency unit: methods, thread roots, attribute accesses with
    lock-sets, lock-order edges, blocking-under-lock sites."""

    def __init__(self, ctx: ModuleContext, cls: ast.ClassDef):
        self.ctx = ctx
        self.cls = cls
        self.name = cls.name
        # method name -> def node; nested handler-class methods join the
        # component under "Handler.do_GET"-style keys
        self.methods: dict[str, ast.FunctionDef] = {}
        # names aliasing the component instance inside method bodies
        # (the `server = self` closure idiom)
        self.aliases: set[str] = set()
        # method key -> set of root labels
        self.roots: dict[str, set[str]] = {}
        # attr -> constructor qualname it was assigned from (in __init__)
        self.attr_ctors: dict[str, str] = {}
        self.lock_attrs: set[str] = set()
        self.accesses: list[Access] = []
        self.lock_edges: list[LockEdge] = []
        self.blocking: list[BlockingCall] = []
        # (caller method, callee method, locks held at the call site)
        self.call_sites: list[tuple[str, str, frozenset[str]]] = []
        # every lock acquisition: (method, lock, with-item node)
        self._acquisitions: list[tuple[str, str, ast.AST]] = []
        # nested classes whose own `self` is per-request (HTTP handlers)
        self._handler_classes: set[str] = set()
        # id(method def) -> nested class name, for resolving `self.m()`
        # inside a nested class to that class's own methods
        self._nested_class_of: dict[int, str] = {}
        # @property defs are attribute reads, never callbacks
        self._properties: set[str] = set()
        self._collect()

    # -- structure discovery ------------------------------------------------

    def _collect(self) -> None:
        self._discover_methods()
        self._discover_aliases_and_ctors()
        entries = self._discover_roots()
        self._walk_methods()
        self._propagate(entries)
        self._apply_inherited_locks(entries)

    def _apply_inherited_locks(self, entries: dict[str, set[str]]) -> None:
        """A private method invoked ONLY under a lock inherits it: the
        intersection of locks over its intra-component call sites, to a
        fixpoint. Methods a caller thread can invoke directly (entries,
        public surface) inherit nothing."""
        TOP = None  # "not yet constrained" (universal set)
        inherited: dict[str, Optional[frozenset[str]]] = {}
        for name in self.methods:
            inherited[name] = frozenset() if entries.get(name) else TOP
        for _ in range(len(self.methods) + 1):
            changed = False
            for caller, callee, locks in self.call_sites:
                base = inherited.get(caller)
                if base is TOP:
                    continue
                site = locks | base
                cur = inherited.get(callee)
                new = site if cur is TOP else (cur & site)
                if new != cur:
                    inherited[callee] = new
                    changed = True
            if not changed:
                break
        extra = {
            m: locks for m, locks in inherited.items() if locks
        }
        if not extra:
            return
        self.accesses = [
            dataclasses.replace(a, locks=a.locks | extra[a.method])
            if a.method in extra
            else a
            for a in self.accesses
        ]
        self.blocking = [
            dataclasses.replace(b, locks=b.locks | extra[b.method])
            if b.method in extra
            else b
            for b in self.blocking
        ]
        # a lock acquired inside an always-under-lock helper orders after
        # the inherited lock(s) too
        for method, lock, node in self._acquisitions:
            for h in extra.get(method, ()):
                if h != lock:
                    self.lock_edges.append(LockEdge(h, lock, method, node))

    def _discover_methods(self) -> None:
        for node in self.cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[node.name] = node
                for dec in node.decorator_list:
                    q = self.ctx.qual(dec) or ""
                    if q == "property" or q.endswith(".setter") or q == "cached_property":
                        self._properties.add(node.name)
                # nested defs/classes inside a method body (closure thread
                # targets, per-request handler classes)
                in_nested_class: set[int] = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.ClassDef):
                        if any(
                            isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and m.name in _HTTP_HANDLER_METHODS
                            for m in sub.body
                        ):
                            self._handler_classes.add(sub.name)
                        for m in sub.body:
                            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                                self.methods[f"{sub.name}.{m.name}"] = m
                                self._nested_class_of[id(m)] = sub.name
                                for inner in ast.walk(m):
                                    in_nested_class.add(id(inner))
                for sub in ast.walk(node):
                    if (
                        isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and sub is not node
                        and id(sub) not in in_nested_class
                        and sub.name not in self.methods
                    ):
                        self.methods[sub.name] = sub

    def _discover_aliases_and_ctors(self) -> None:
        for name, fn in list(self.methods.items()):
            if "." in name:
                continue  # nested-class methods have their own self
            for node in ast.walk(fn):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                value = node.value
                # alias = self
                if isinstance(value, ast.Name) and value.id == "self":
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.aliases.add(t.id)
                # self.attr = Ctor(...)  (plain or annotated assignment)
                if isinstance(value, ast.Call):
                    q = self.ctx.qual(value.func) or ""
                    for t in targets:
                        attr = self._self_attr(t, fn)
                        if attr is None:
                            continue
                        self.attr_ctors.setdefault(attr, q)
                        if self._is_lock_ctor(q):
                            self.lock_attrs.add(attr)
        # name-based fallback: an attr whose name says "lock" is one
        for name, fn in self.methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) and "lock" in node.attr.lower():
                    if self._receiver_is_component(node.value, fn):
                        self.lock_attrs.add(node.attr)

    @staticmethod
    def _is_lock_ctor(qual: str) -> bool:
        return bool(qual) and (
            qual in _LOCK_CTOR_NAMES or qual.endswith(_LOCK_CTOR_SUFFIXES)
        )

    def attr_is_safe_type(self, attr: str) -> bool:
        q = self.attr_ctors.get(attr, "")
        return bool(q) and (
            q in _SAFE_CTOR_NAMES or q.endswith(_SAFE_CTOR_SUFFIXES)
        )

    def _receiver_is_component(
        self, recv: ast.AST, fn: ast.FunctionDef
    ) -> bool:
        """Does this expression denote the component instance? `self` in a
        direct method (NOT a nested handler class's method, whose `self`
        is its own per-request instance) or a recorded alias anywhere."""
        if not isinstance(recv, ast.Name):
            return False
        if recv.id in self.aliases:
            return True
        if recv.id == "self":
            # `self` belongs to the component only in its direct methods
            return any(
                f is fn and "." not in name for name, f in self.methods.items()
            )
        return False

    def _self_attr(self, target: ast.AST, fn: ast.FunctionDef) -> Optional[str]:
        if isinstance(target, ast.Attribute) and self._receiver_is_component(
            target.value, fn
        ):
            return target.attr
        return None

    # -- thread roots -------------------------------------------------------

    def _discover_roots(self) -> dict[str, set[str]]:
        """Seed roots: Thread targets, handler methods, callback escapes,
        and MAIN for public methods (anything a caller thread can invoke
        directly). `__init__` is excluded — it runs before any thread
        this model knows about starts."""
        entries: dict[str, set[str]] = {name: set() for name in self.methods}
        for name, fn in self.methods.items():
            base = name.rsplit(".", 1)[-1]
            if base in _HTTP_HANDLER_METHODS:
                entries[name].add(f"http:{base}")
            elif name != "__init__" and not base.startswith("_"):
                entries[name].add(MAIN_ROOT)
        for name, fn in self.methods.items():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                q = self.ctx.qual(node.func) or ""
                is_thread = q == "threading.Thread" or q.endswith(".Thread") or q == "Thread"
                if is_thread:
                    for kw in node.keywords:
                        if kw.arg == "target":
                            tgt = self._method_ref(kw.value, fn)
                            if tgt is not None:
                                entries[tgt].add(f"thread:{tgt}")
                else:
                    # callback escape: a component method passed BY
                    # REFERENCE (not called) to any call — it will run on
                    # whatever thread the receiver chooses
                    for arg in [*node.args, *[kw.value for kw in node.keywords]]:
                        tgt = self._method_ref(arg, fn)
                        if tgt is not None and tgt != "__init__":
                            entries[tgt].add(f"callback:{tgt}")
        return entries

    def _method_ref(self, expr: ast.AST, fn: ast.FunctionDef) -> Optional[str]:
        """`self.m` / `alias.m` / bare closure name -> method key.
        Properties are attribute READS, not callables escaping."""
        if isinstance(expr, ast.Attribute) and self._receiver_is_component(
            expr.value, fn
        ):
            if expr.attr in self.methods and expr.attr not in self._properties:
                return expr.attr
        if isinstance(expr, ast.Name) and expr.id in self.methods:
            # bare name: a closure/nested def used as a target
            if "." not in expr.id and expr.id not in self._properties:
                return expr.id
        return None

    def _propagate(self, entries: dict[str, set[str]]) -> None:
        """Roots flow caller -> callee over intra-component calls."""
        edges: dict[str, set[str]] = {name: set() for name in self.methods}
        for name, fn in self.methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = self._called_method(node, fn)
                    if callee is not None:
                        edges[name].add(callee)
        roots = {name: set(r) for name, r in entries.items()}
        changed = True
        while changed:
            changed = False
            for caller, callees in edges.items():
                for callee in callees:
                    if callee == "__init__":
                        continue
                    before = len(roots[callee])
                    roots[callee] |= roots[caller]
                    changed = changed or len(roots[callee]) != before
        self.roots = roots

    def _called_method(self, call: ast.Call, fn: ast.FunctionDef) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Attribute) and self._receiver_is_component(
            func.value, fn
        ):
            if func.attr in self.methods:
                return func.attr
        # `self.m()` inside a nested class resolves to that class's own
        # methods ("Handler.do_POST" calling "Handler._handle_ingest")
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            nested = self._nested_class_of.get(id(fn))
            if nested is not None and f"{nested}.{func.attr}" in self.methods:
                return f"{nested}.{func.attr}"
        if isinstance(func, ast.Name) and func.id in self.methods:
            return func.id
        return None

    # -- lock-set walk ------------------------------------------------------

    def _lock_name(self, expr: ast.AST, fn: ast.FunctionDef) -> Optional[str]:
        """Canonical name of a lock expression, or None when it isn't
        one. Component locks normalize to `self.<attr>`; other receivers
        keep their dotted spelling so `metrics._lock` and `self._lock`
        stay distinct nodes in the order graph."""
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            is_lockish = attr in self.lock_attrs or "lock" in attr.lower()
            if not is_lockish:
                return None
            if self._receiver_is_component(expr.value, fn):
                return f"self.{attr}"
            parts = []
            node = expr
            while isinstance(node, ast.Attribute):
                parts.append(node.attr)
                node = node.value
            if isinstance(node, ast.Name):
                base = "self" if node.id in self.aliases else node.id
                return ".".join([base] + parts[::-1])
            return None
        if isinstance(expr, ast.Name) and "lock" in expr.id.lower():
            return expr.id
        return None

    def _walk_methods(self) -> None:
        for name, fn in self.methods.items():
            self._walk(fn.body, name, fn, [])

    def _walk(
        self,
        stmts: list[ast.stmt],
        method: str,
        fn: ast.FunctionDef,
        held: list[str],
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired: list[str] = []
                for item in stmt.items:
                    self._scan_expr(item.context_expr, method, fn, held + acquired)
                    lock = self._lock_name(item.context_expr, fn)
                    if lock is not None:
                        self._acquisitions.append((method, lock, item.context_expr))
                        for h in held + acquired:
                            if h != lock:
                                self.lock_edges.append(
                                    LockEdge(h, lock, method, item.context_expr)
                                )
                        acquired.append(lock)
                self._walk(stmt.body, method, fn, held + acquired)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: analyzed as its own method entry; a closure
                # body does NOT run under the enclosing with-block at def
                # time, so don't thread `held` into it here
                continue
            elif isinstance(stmt, ast.ClassDef):
                continue
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(stmt.test, method, fn, held)
                self._walk(stmt.body, method, fn, held)
                self._walk(stmt.orelse, method, fn, held)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(stmt.iter, method, fn, held)
                self._walk(stmt.body, method, fn, held)
                self._walk(stmt.orelse, method, fn, held)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body, method, fn, held)
                for handler in stmt.handlers:
                    self._walk(handler.body, method, fn, held)
                self._walk(stmt.orelse, method, fn, held)
                self._walk(stmt.finalbody, method, fn, held)
            else:
                self._scan_stmt(stmt, method, fn, held)

    def _scan_stmt(
        self, stmt: ast.stmt, method: str, fn: ast.FunctionDef, held: list[str]
    ) -> None:
        locks = frozenset(held)
        write_nodes: set[int] = set()
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in targets:
                base = t
                while isinstance(base, (ast.Subscript, ast.Starred)):
                    base = base.value
                attr = self._self_attr(base, fn)
                if attr is not None:
                    self.accesses.append(
                        Access(attr, "write", method, stmt.lineno, stmt, locks)
                    )
                    write_nodes.add(id(base))
                    # AugAssign / subscript-store also READS the attr; the
                    # write record covers the hazard
        self._scan_expr(stmt, method, fn, held, skip=write_nodes)

    def _scan_expr(
        self,
        expr: ast.AST,
        method: str,
        fn: ast.FunctionDef,
        held: list[str],
        skip: Optional[set[int]] = None,
    ) -> None:
        locks = frozenset(held)
        skip = skip or set()
        # `self.x.anything` / `self.x[...]`: the inner `self.x` access is
        # a DEEP use (it reads the object's mutable state), vs a bare
        # reference like `self.x is None`
        deep: set[int] = set()
        for node in ast.walk(expr):
            if isinstance(node, (ast.Attribute, ast.Subscript)) and isinstance(
                node.value, ast.Attribute
            ):
                deep.add(id(node.value))
        for node in ast.walk(expr):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(node, ast.Call):
                self._scan_call(node, method, fn, locks)
            elif isinstance(node, ast.Attribute) and id(node) not in skip:
                if self._receiver_is_component(node.value, fn):
                    if isinstance(node.ctx, ast.Store):
                        kind = "write"
                    else:
                        kind = "read" if id(node) in deep else "ref"
                    self.accesses.append(
                        Access(node.attr, kind, method, node.lineno, node, locks)
                    )

    def _scan_call(
        self, node: ast.Call, method: str, fn: ast.FunctionDef, locks: frozenset[str]
    ) -> None:
        func = node.func
        callee = self._called_method(node, fn)
        if callee is not None:
            self.call_sites.append((method, callee, locks))
        # mutator method on a component attr counts as a write to it
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _MUTATORS
            and isinstance(func.value, ast.Attribute)
            and self._receiver_is_component(func.value.value, fn)
        ):
            self.accesses.append(
                Access(func.value.attr, "mutate", method, node.lineno, node, locks)
            )
        if locks:
            desc = self._blocking_desc(node)
            if desc is not None:
                self.blocking.append(BlockingCall(desc, method, node, locks))

    def _blocking_desc(self, node: ast.Call) -> Optional[str]:
        """Can this call block unboundedly? (Only consulted under a lock.)"""
        kwargs = {kw.arg for kw in node.keywords}
        q = self.ctx.qual(node.func) or ""
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in ("put", "get") and "timeout" not in kwargs and "block" not in kwargs:
                if len(node.args) <= (1 if attr == "put" else 0):
                    return f"blocking queue .{attr}() with no timeout"
            if attr == "wait" and "timeout" not in kwargs and not node.args:
                return "event/condition .wait() with no timeout"
            if attr == "join" and "timeout" not in kwargs and not node.args:
                return ".join() with no timeout"
            if attr == "block_until_ready":
                return "device sync (.block_until_ready())"
            if attr == "synchronize":  # torch.cuda / Event / Stream
                return "device sync (.synchronize())"
        if q.endswith(".urlopen") or q == "urlopen":
            return "HTTP I/O (urlopen)"
        if q == "time.sleep":
            return "time.sleep()"
        if q.endswith(".device_get") or q == "jax.device_get":
            return "device transfer (device_get)"
        return None

    # -- consumers ----------------------------------------------------------

    def thread_weight(self, root: str) -> int:
        """HTTP handler roots are one thread PER REQUEST: two concurrent
        requests already race, so a handler root alone counts as 2."""
        return 2 if root.startswith("http:") else 1

    def roots_of_accesses(self, accesses: list[Access]) -> set[str]:
        out: set[str] = set()
        for a in accesses:
            out |= self.roots.get(a.method, set())
        return out

    def shared_attr_accesses(self) -> Iterator[tuple[str, list[Access], set[str]]]:
        """(attr, accesses, roots) for every attr written outside
        `__init__` whose accessing methods span ≥ 2 thread weight with at
        least one non-main root — the JX012 candidates. Safe-typed attrs
        (locks, queues, events, deques) are skipped."""
        by_attr: dict[str, list[Access]] = {}
        for a in self.accesses:
            if a.method == "__init__" or not self.roots.get(a.method):
                continue
            by_attr.setdefault(a.attr, []).append(a)
        for attr, accesses in sorted(by_attr.items()):
            if self.attr_is_safe_type(attr):
                continue
            if attr in self.lock_attrs:
                continue
            writes = [a for a in accesses if a.is_write]
            if not writes:
                continue
            # bare references (`self.x is None`, passing x along) race
            # only when the attr is directly REASSIGNED somewhere; for a
            # container mutated in place they are just identity reads
            if not any(a.kind == "write" for a in writes):
                accesses = [a for a in accesses if a.kind != "ref"]
            roots = self.roots_of_accesses(accesses)
            non_main = {r for r in roots if r != MAIN_ROOT}
            if not non_main:
                continue
            weight = sum(self.thread_weight(r) for r in roots)
            if weight < 2:
                continue
            yield attr, accesses, roots


def component_models(ctx: ModuleContext) -> list[ComponentModel]:
    """Cached per-module component models (one per top-level class)."""
    cached = getattr(ctx, "_thread_models", None)
    if cached is None:
        cached = []
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                cached.append(ComponentModel(ctx, node))
        ctx._thread_models = cached  # type: ignore[attr-defined]
    return cached
