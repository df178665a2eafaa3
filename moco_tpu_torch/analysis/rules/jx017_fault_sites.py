"""JX017: fault-grammar site resolution.

A `kind@site=...` spec only does anything if some hook calls
`faults.maybe_<kind>(site)` (or `tsan.make_lock(site)` for deadlock@)
with that exact string — the grammar has no unknown-site error at
install time, so a renamed stage silently turns a chaos leg into a
no-op that still passes. Three clauses over the contract registry:

1. **unresolvable spec** — a `slow@site=`/`delay@site=`/`io@site=`/
   `deadlock@site=` literal (in code, tests, or docstrings — doc drift
   is drift) naming a site that is neither registered in
   `utils/contracts.py` `FAULT_SITES` nor extracted from any hook call
   in the analyzed program. Placeholder sites (`<lock>`, bare `S`) are
   skipped; `kill@`/`stall@`/`nan@`... are site-less; `diverge@` sites
   are dynamic comms tags validated at runtime.
2. **unregistered hook** — a hook call whose literal site is missing
   from the declared `FAULT_SITES` vocabulary: ship the registry entry
   with the new site. Unit tests (`test_*.py`) are exempt — they probe
   the grammar machinery itself with synthetic sites on purpose.
3. **untested serve stage** — whole-tree runs only (the program
   includes both the registry module AND the test corpus, so partial
   and `moco_tpu_torch/`-only scopes stay quiet): a serve-stage `maybe_slow`
   hook whose site appears in no `slow@site=` spec anywhere — no chaos
   leg or test would notice the stage's fault attribution breaking.
"""

from __future__ import annotations

import os

from moco_tpu_torch.analysis import contracts
from moco_tpu_torch.analysis.contracts import _SITE_RE
from moco_tpu_torch.analysis.engine import rule
from moco_tpu_torch.utils import contracts as decl


@rule("JX017", "fault spec site no hook can fire, or hook site unregistered/untested")
def check_fault_sites(ctx):
    reg = contracts.registry_for(ctx)

    for s in reg.spec_literals:
        if s.path != ctx.path:
            continue
        declared = decl.FAULT_SITES.get(s.kind)
        if declared is None:
            continue  # site-less kind, or dynamic site space (diverge@)
        site = s.params.get("site")
        if site is None or not _SITE_RE.match(site):
            continue  # dynamic or placeholder site
        if site not in declared and site not in reg.hook_site_set(s.kind):
            yield (
                s.line,
                f"spec {s.raw!r} names site {site!r} that no {s.kind} hook "
                f"can fire (not registered, not extracted from any hook call)",
            )

    is_test_module = os.path.basename(ctx.path).startswith("test_")
    for h in reg.hook_sites:
        if h.path != ctx.path or is_test_module:
            continue
        declared = decl.FAULT_SITES.get(h.kind)
        if declared is not None and h.site not in declared:
            yield (
                h.line,
                f"{h.kind} hook site {h.site!r} is not registered in "
                f"utils/contracts.py FAULT_SITES — ship a registry entry",
            )

    has_test_corpus = any(
        os.path.basename(p).startswith("test_") for p in reg.paths
    )
    if not (reg.has_registry_module and has_test_corpus):
        return
    exercised = {
        s.params.get("site")
        for s in reg.spec_literals
        if s.kind == "slow" and s.params.get("site")
    }
    for h in reg.hook_sites:
        if h.path != ctx.path or h.kind != "slow":
            continue
        if h.site in decl.SERVE_STAGE_SITES and h.site not in exercised:
            yield (
                h.line,
                f"no test or chaos leg exercises slow@site={h.site} — the "
                f"stage's fault hook is unverified",
            )
