"""mocolint for the port: static analysis of `moco_tpu_torch` and the
runtime sanitizers (moco_tpu/analysis, its thread and contract rules).

The invariants the serving and training stacks hang on are invisible to
Python's type system: a field written from two threads needs one lock,
two locks must always nest the same way, a metric key needs a schema
validator, a client must call a route some handler serves, a fault spec
must name a site a hook can fire, and every rank must issue the same
collectives in the same order or the world deadlocks silently.
`mocolint` checks the static half of these before the run:

====  =========================================================
Rule  Checks
====  =========================================================
JX011 thread hygiene — threads started without join-on-close;
      blocking `put` on a bounded queue with no poison-pill/timeout
      path (the producer-leak shape)
JX012 shared mutable attribute written without a common lock
      across its accessing threads — thread-escape analysis over
      Thread targets, HTTP handler methods (one thread per
      request), and callback escapes, with lock-sets inherited
      through always-under-lock helpers (analysis/threads.py)
JX013 lock-order cycles (lock A held while B is acquired, and
      elsewhere the inverse — the static deadlock) and blocking
      calls under a held lock (queue put/get with no timeout,
      `Event.wait()`, `urlopen`, `time.sleep`, device syncs)
JX015 metric key emitted without an `obs/schema.py` validator, or a
      dead/shadowed validator
JX016 HTTP route/method/header drift from `utils/contracts.py`
      ROUTES, or a retry of a non-idempotent route
JX017 fault spec naming a site no hook can fire, or a hook site
      missing from `utils/contracts.py` FAULT_SITES
JX018 inline exit-code literal or hand-computed port offset
====  =========================================================

JAX's rules JX001–JX010 and JX014 (jit purity, traced host transfers,
PRNG keys, recompiles, `stop_gradient`, donation, `shard_map` axis
names, the static SPMD-divergence check, `preferred_element_type`, AOT
freeze) and the dataflow summaries only they read are not here: their
subjects do not exist in an eager PyTorch program (ROADMAP.md, "By
design"). The runtime half of JX008/JX010 is the schedule sanitizer
below.

Usage::

    python -m moco_tpu_torch.analysis                    # moco_tpu_torch/
    python -m moco_tpu_torch.analysis moco_tpu_torch/ chip_smoke.py --format json -o report.json

Exit codes: 0 when every finding is suppressed or baselined (or none
exist), 1 when findings remain, 2 on a usage error. Suppress a finding
with a justification — the comment may sit on ANY line of the
statement, including the closing line of a multi-line call::

    self._last = time.monotonic()  # mocolint: disable=JX012  (why this is safe)

A baseline (``--update-baseline``) is named `mocolint-torch-baseline.json`
so it never meets the JAX package's `mocolint-baseline.json`; the port
ships at zero findings and without one.

The runtime arms, wired into the training driver and the serving stack:

- `strict_tracing` (`analysis/runtime.py`): the run's CUDA-graph captures
  as `compile_cache_misses` on every metrics.jsonl line, and an abort
  on a capture after `recompile_warmup_steps`;
- `sanitize_collectives` (`analysis/sanitizer.py`): every comms-ledger
  site (`obs/comms.py`) records (site, kind, operand signature) into the
  process's schedule; log steps publish its hash (`schedule.p<i>.json`)
  and cross-check every peer, aborting with a per-site diff
  (`schedule_diff.json`) before a mismatch can deadlock the world, with
  `collective_schedule_hash` on the lines. `diverge@site=S`
  (`utils/faults.py`) injects a deterministic divergence;
- `sanitize_threads` (`analysis/tsan.py`): every lock of
  `utils/locks.py`'s factory reports its acquisition order; a cycle
  aborts (or, around a serving burst, is recorded) with both stacks in
  `lock_order_diff.json`, and a profile hook records blocking ops under
  a held lock (`lock_order.json`). `deadlock@site=<lock>` forces an
  inverted order at the named lock;
- contract coverage (`analysis/contracts.py`): `MOCO_CONTRACT_COVERAGE=1`
  makes a replica count the validators, routes, headers and fault hooks
  it exercised.

`--changed <git-ref>` lints only the files differing from the ref (plus
untracked ones).
"""

from __future__ import annotations

from moco_tpu_torch.analysis.engine import (
    Finding,
    analyze_paths,
    analyze_source,
    iter_rules,
    load_baseline,
    render_json,
    render_text,
    write_baseline,
)

__all__ = [
    "Finding",
    "analyze_paths",
    "analyze_source",
    "iter_rules",
    "load_baseline",
    "render_json",
    "render_text",
    "write_baseline",
]
