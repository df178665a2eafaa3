"""JX011 — input-wire thread hygiene: join-on-close and poison pills.

The input wire runs on real threads (`data/pipeline.py`'s decode
producer, `data/device_prefetch.py`'s transfer ring), and the
producer-leak fix there (`_responsive_put`) documents the failure mode
this rule enforces statically: a producer thread blocked on a bounded `queue.Queue.put`
keeps its owner alive forever when the consumer abandons the iterator —
the decode pool stays pinned, epochs leak a thread each, and a
"graceful" shutdown hangs in `join()` that never comes.

Two findings:

1. **Thread without join-on-close** — a `threading.Thread(...)` that is
   `.start()`ed but whose binding is never `.join(...)`ed anywhere in
   the owning scope (the class for `self._thread`, the function for a
   local). Daemon threads are not exempt: daemonhood avoids blocking
   interpreter EXIT, not resource pinning during the run (a server
   thread's owner must `shutdown()` AND join in `close()`; see
   obs/sinks.py).

2. **Blocking put with no poison-pill path** — a `.put(item)` with no
   `timeout=` (and not `put_nowait`) on a BOUNDED queue (`maxsize`
   nonzero) owned by the same scope that also owns a thread. The
   repo-idiomatic fix is `_responsive_put` (timeout + stop-flag poll)
   or a drain-then-pill `close()` (`data/pipeline.py`).

Unbounded queues (`Queue()` / `maxsize=0`) never block a put and are
exempt from (2).
"""

from __future__ import annotations

import ast
from typing import Optional

from moco_tpu_torch.analysis.astutils import ModuleContext
from moco_tpu_torch.analysis.engine import rule


def _is_thread_ctor(ctx: ModuleContext, call: ast.Call) -> bool:
    q = ctx.qual(call.func)
    return q is not None and (q == "threading.Thread" or q.endswith(".Thread") or q == "Thread")


def _is_bounded_queue_ctor(ctx: ModuleContext, call: ast.Call) -> bool:
    q = ctx.qual(call.func)
    if q is None or not (q == "queue.Queue" or q.endswith(".Queue")):
        return False
    # Queue() and Queue(maxsize=0) are unbounded
    for kw in call.keywords:
        if kw.arg == "maxsize":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value == 0)
    if call.args:
        arg = call.args[0]
        return not (isinstance(arg, ast.Constant) and arg.value == 0)
    return False


def _binding_of(target: ast.AST) -> Optional[str]:
    """'self.x' or 'x' for the assignment target, else None."""
    if isinstance(target, ast.Name):
        return target.id
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return f"self.{target.attr}"
    return None


def _method_calls_on(scope: ast.AST, binding: str) -> set[str]:
    """Method names invoked on `binding` anywhere in `scope`."""
    out: set[str] = set()
    want_self = binding.startswith("self.")
    attr = binding[5:] if want_self else None
    for n in ast.walk(scope):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)):
            continue
        recv = n.func.value
        if want_self:
            if (
                isinstance(recv, ast.Attribute)
                and recv.attr == attr
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
            ):
                out.add(n.func.attr)
        elif isinstance(recv, ast.Name) and recv.id == binding:
            out.add(n.func.attr)
    return out


def _scopes(ctx: ModuleContext):
    """(scope node, owner description) for classes, top-level functions,
    and the module body — the unit within which join/close must exist."""
    claimed: set[int] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            yield node, f"class {node.name}"
            for sub in ast.walk(node):
                claimed.add(id(sub))
    for fn in ctx.functions:
        if id(fn) not in claimed:
            yield fn, f"function {fn.name}"
            for sub in ast.walk(fn):
                claimed.add(id(sub))
    yield ctx.tree, "module scope"


@rule("JX011", "thread started without join-on-close / blocking put with no poison-pill path")
def check(ctx: ModuleContext):
    reported: set[int] = set()
    for scope, owner in _scopes(ctx):
        threads: list[tuple[str, ast.Call]] = []
        bounded_queues: set[str] = set()
        for node in ast.walk(scope):
            if id(node) in reported:
                continue
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                for tgt in node.targets:
                    binding = _binding_of(tgt)
                    if binding is None:
                        continue
                    if _is_thread_ctor(ctx, node.value):
                        threads.append((binding, node.value))
                    elif _is_bounded_queue_ctor(ctx, node.value):
                        bounded_queues.add(binding)
            # anonymous fire-and-forget: threading.Thread(...).start()
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "start"
                and isinstance(node.func.value, ast.Call)
                and _is_thread_ctor(ctx, node.func.value)
            ):
                reported.add(id(node))
                yield node, (
                    "threading.Thread(...).start() with no binding can never "
                    "be joined — keep a reference and join it on close "
                    "(abandoned threads pin their closure's resources; see "
                    "data/pipeline.py's producer-leak fix)"
                )
        for binding, ctor in threads:
            if id(ctor) in reported:
                continue
            calls = _method_calls_on(scope, binding)
            if "start" in calls and "join" not in calls:
                reported.add(id(ctor))
                yield ctor, (
                    f"thread '{binding}' is started but never joined in "
                    f"{owner} — add a close()/stop() that joins it (daemon=True "
                    "only unblocks interpreter exit, not the resources the "
                    "thread pins while the run continues)"
                )
        if not threads and not bounded_queues:
            continue
        # blocking puts on bounded queues in thread-owning scopes
        for node in ast.walk(scope):
            if id(node) in reported:
                continue
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "put"
            ):
                continue
            recv = _binding_of(node.func.value)
            if recv is None or recv not in bounded_queues:
                continue
            if any(kw.arg in ("timeout", "block") for kw in node.keywords):
                continue
            if len(node.args) > 1:  # put(item, block, timeout) positional
                continue
            reported.add(id(node))
            yield node, (
                f"blocking put() on bounded queue '{recv}' — a consumer that "
                "stops draining leaves this producer blocked forever and "
                "close()/join() hangs; use a timeout + stop-flag poll "
                "(_responsive_put in data/pipeline.py) or a drain-then-"
                "poison-pill close()"
            )
