"""JX012 — shared mutable attribute written without a common lock.

The serving stack's bug class: an attribute of a thread-owning object
(`ServeServer.ingested_rows`, a metrics counter, a stats dict) written
on one thread and read or written on another with no lock both sides
agree on. On CPython the GIL hides most of the torn-write risk but none
of the lost-update risk (`x += 1` is a read-modify-write), and none of
the consistency risk (a /stats snapshot interleaving with an ingest).

The thread-escape model (`analysis/threads.py`) computes, per class,
which methods run on which threads — `threading.Thread` targets, HTTP
handler methods (one thread per request: a handler alone counts as two),
and callback escapes (a bound method handed to a batcher/alert engine) —
and which locks are provably held at each attribute access, including
locks inherited from call sites by always-under-lock private helpers.

A finding fires for every attribute that is written outside `__init__`,
is reachable from ≥ 2 thread weight, and has NO lock common to all its
accesses:

- when some lock guards the writes, each access missing it is reported
  (the "`_index_lock` guards ingest but not the stats read" shape);
- when no lock is held anywhere, one finding anchors at the first write.

Thread-safe-by-construction attributes (locks, `queue.Queue`, `Event`,
`deque`, `threading.local`) are exempt; so are attributes of per-request
HTTP handler instances (fresh object per thread).
"""

from __future__ import annotations

from moco_tpu_torch.analysis.engine import rule
from moco_tpu_torch.analysis.astutils import ModuleContext
from moco_tpu_torch.analysis.threads import component_models


@rule("JX012", "shared mutable attribute written without a common lock across its accessing threads")
def check(ctx: ModuleContext):
    for model in component_models(ctx):
        for attr, accesses, roots in model.shared_attr_accesses():
            common = None
            for a in accesses:
                common = a.locks if common is None else (common & a.locks)
            if common:
                continue
            roots_str = ", ".join(sorted(roots))
            writes = [a for a in accesses if a.is_write]
            write_locks: dict[str, int] = {}
            for w in writes:
                for lock in w.locks:
                    write_locks[lock] = write_locks.get(lock, 0) + 1
            if write_locks:
                # some lock guards (some of) the writes: report every
                # access that skips it — the torn-snapshot shape
                guard = sorted(write_locks, key=lambda k: (-write_locks[k], k))[0]
                seen: set[int] = set()
                for a in sorted(accesses, key=lambda a: (a.lineno, a.kind)):
                    if guard in a.locks or a.lineno in seen:
                        continue
                    seen.add(a.lineno)
                    yield a.node, (
                        f"attribute '{attr}' of {model.name} is "
                        f"{'written' if a.is_write else 'read'} without "
                        f"lock '{guard}' that guards its writes elsewhere "
                        f"(accessed from threads: {roots_str}) — hold the same "
                        "lock on every access or snapshot under it"
                    )
            else:
                first = min(writes, key=lambda a: a.lineno)
                yield first.node, (
                    f"attribute '{attr}' of {model.name} is written from "
                    f"multiple threads ({roots_str}) with no lock — a lost "
                    "update or torn snapshot; guard every access with one "
                    "lock (tsan.make_lock gives the runtime sanitizer "
                    "visibility too)"
                )
