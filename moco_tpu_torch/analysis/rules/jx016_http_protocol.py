"""JX016: HTTP-protocol consistency across the fleet.

The router <-> replica surface is declared once, in
`utils/contracts.py` `ROUTES` (methods, required headers, idempotence,
which server handles it). This rule keeps both sides honest against
that declaration, program-wide:

1. **handler side** — a `do_GET`/`do_POST` comparing the request path
   against a route literal the registry doesn't declare (new endpoint
   shipped without its registry entry), or handling it under an
   undeclared method.
2. **client side** — a `urllib.request.Request`/`urlopen` call whose
   URL resolves to an undeclared route (typo, removed endpoint), the
   wrong method for a declared route (GET to a POST-only route and vice
   versa), or a POST to a route with required headers
   (`X-Image-Shape`, `X-Rows-Shape`) where the enclosing function never
   mentions the header literal.
3. **retry/hedge idempotence** — a `retry_call` wrapper whose guarding
   route-membership tuple admits a route outside the declared
   idempotent set. The canonical violation this exists to prevent: the
   router retrying `/ingest` (appends queue rows — a retried ingest
   double-writes; only the fan-out writer may re-post, reconciling by
   row count).

Route extraction trusts literals only (`base + "/healthz"`, f-string
literal chunks); fully dynamic URLs — e.g. the router's own proxy
forwarding `self.path` verbatim — are out of scope by design.
Deliberately-invalid probes (404 tests) carry inline suppressions.
"""

from __future__ import annotations

import ast

from moco_tpu_torch.analysis import contracts
from moco_tpu_torch.analysis.engine import rule
from moco_tpu_torch.utils import contracts as decl


def _mentions(fn, reg, path, header: str) -> bool:
    if fn is None:
        return header in reg.module_headers.get(path, set())
    for n in ast.walk(fn):
        if isinstance(n, ast.Constant) and n.value == header:
            return True
    return False


@rule("JX016", "HTTP route/method/header drift from the declared registry, or non-idempotent retry")
def check_http_protocol(ctx):
    reg = contracts.registry_for(ctx)

    for h in reg.handler_routes:
        if h.path != ctx.path:
            continue
        r = decl.ROUTES.get(h.route)
        if r is None:
            yield (
                h.line,
                f"handler serves undeclared route {h.route!r} — ship a "
                f"utils/contracts.py ROUTES entry with it",
            )
            continue
        if h.method not in r.methods:
            yield (
                h.line,
                f"handler serves {h.route!r} via {h.method} but the registry "
                f"declares methods {r.methods}",
            )
            continue
        hdrs = reg.class_headers.get(f"{ctx.path}::{h.cls}", set()) | (
            reg.module_headers.get(ctx.path, set())
        )
        for header in r.headers:
            if header not in hdrs:
                yield (
                    h.line,
                    f"handler for {h.route!r} never reads required header "
                    f"{header!r} declared in the registry",
                )
        # propagated headers (opt_headers) bind the HANDLER side only:
        # a plain client may omit X-Trace-Id, but every server of the
        # route must adopt it or the trace silently breaks at this hop.
        for header in r.opt_headers:
            if header not in hdrs:
                yield (
                    h.line,
                    f"handler for {h.route!r} never reads propagated header "
                    f"{header!r} declared in the registry (opt_headers)",
                )

    for c in reg.client_calls:
        if c.path != ctx.path:
            continue
        r = decl.ROUTES.get(c.route)
        if r is None:
            yield (
                c.line,
                f"client calls route {c.route!r} that no handler declares "
                f"(not in utils/contracts.py ROUTES)",
            )
            continue
        if c.method not in r.methods:
            yield (
                c.line,
                f"client calls {c.route!r} via {c.method} but the registry "
                f"declares methods {r.methods}",
            )
            continue
        for header in r.headers:
            if not _mentions(c.func, reg, ctx.path, header):
                yield (
                    c.line,
                    f"client posts to {c.route!r} without required header "
                    f"{header!r}",
                )

    for w in reg.retry_wraps:
        if w.path != ctx.path:
            continue
        for route in w.routes:
            if route in decl.ROUTES and route not in decl.IDEMPOTENT_ROUTES:
                yield (
                    w.line,
                    f"retry/hedge wrapper reachable by non-idempotent route "
                    f"{route!r} — only {decl.IDEMPOTENT_ROUTES} may be retried",
                )
