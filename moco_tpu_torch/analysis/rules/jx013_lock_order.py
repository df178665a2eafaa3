"""JX013 — static lock-order cycles and blocking calls under a lock.

Two findings, both the "replica wedges with nothing to diagnose" class
the collective-schedule sanitizer exists for on the training side:

1. **Lock-order cycle** — the component's lock-order graph (lock A held
   while B is acquired ⇒ edge A→B, including acquisitions inside
   always-under-lock helpers) contains a cycle. Two threads walking the
   cycle from different entry points deadlock; no Python tool reports
   it, the process just stops serving. One finding per cycle, anchored
   at the lexically last acquisition in it.

2. **Blocking call under a lock** — `queue.put`/`get` with no timeout,
   `Event.wait()` with no timeout, `join()` with no timeout, HTTP I/O
   (`urlopen`), `time.sleep`, or a device sync (`block_until_ready` /
   `device_get`) issued while a lock is held. The blocked thread pins
   the lock; every thread contending for it stalls behind an operation
   with no bound — the held-lock flavor of the JX011 producer-leak.

The runtime arm (`analysis/tsan.py`, `--sanitize-threads`) watches the
same two invariants on live runs; this rule catches the provable
cases before anything runs.
"""

from __future__ import annotations

from moco_tpu_torch.analysis.astutils import ModuleContext
from moco_tpu_torch.analysis.engine import rule
from moco_tpu_torch.analysis.threads import component_models


def _sccs(nodes: set[str], edges: dict[str, set[str]]) -> list[set[str]]:
    """Strongly connected components with ≥ 2 nodes (iterative Tarjan
    is overkill at this scale: locks per class are single digits)."""
    reach: dict[str, set[str]] = {}
    for n in nodes:
        seen: set[str] = set()
        stack = [n]
        while stack:
            cur = stack.pop()
            for nxt in edges.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        reach[n] = seen
    out: list[set[str]] = []
    claimed: set[str] = set()
    for n in sorted(nodes):
        if n in claimed:
            continue
        scc = {m for m in reach[n] if n in reach[m]}
        if len(scc) >= 2:
            out.append(scc)
            claimed |= scc
    return out


@rule("JX013", "lock-order cycle / blocking call while holding a lock")
def check(ctx: ModuleContext):
    for model in component_models(ctx):
        if model.lock_edges:
            nodes: set[str] = set()
            adj: dict[str, set[str]] = {}
            for e in model.lock_edges:
                nodes |= {e.held, e.acquired}
                adj.setdefault(e.held, set()).add(e.acquired)
            for scc in _sccs(nodes, adj):
                cycle_edges = [
                    e for e in model.lock_edges
                    if e.held in scc and e.acquired in scc
                ]
                anchor = max(cycle_edges, key=lambda e: getattr(e.node, "lineno", 0))
                order = " <-> ".join(sorted(scc))
                sites = ", ".join(
                    f"{e.held}->{e.acquired}@{getattr(e.node, 'lineno', '?')}"
                    for e in sorted(
                        cycle_edges, key=lambda e: getattr(e.node, "lineno", 0)
                    )
                )
                yield anchor.node, (
                    f"lock-order cycle in {model.name}: {order} "
                    f"(acquisitions: {sites}) — two threads entering from "
                    "different sides deadlock; pick ONE acquisition order "
                    "and apply it everywhere"
                )
        for b in model.blocking:
            locks = ", ".join(sorted(b.locks))
            yield b.node, (
                f"{b.desc} while holding {locks} in {model.name}.{b.method} — "
                "an unbounded wait pins the lock and stalls every contending "
                "thread; move the call outside the lock or bound it with a "
                "timeout"
            )
