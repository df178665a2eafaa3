"""Critical-path analysis over stitched multi-hop request traces, the
port's copy of moco_tpu/obs/critpath.py (stdlib only, like the original).

The fleet router (serve/router.py) and the offline stitcher
(scripts/trace_merge.py `stitch_traces`) produce one record per
distributed request, the *stitched trace*, and this module reduces it to
the question the fleet's p99 hangs on: which hop took the milliseconds?
Router queueing, the network, a replica stage, or a failed attempt the
retry layer had to wait out.

Stitched-trace schema (all times in ms):

    {
      "trace_id": str, "request_id": str|None, "path": str,
      "status": int, "wall_t0": float,
      "total_ms": float,                  # router ingress -> respond
      "router": {"ingress_ms", "admission_ms", "respond_ms"},
      "attempts": [
        {"span_id", "replica", "retry_index", "lane",   # primary|hedge
         "breaker", "outcome",     # ok|failed|cancelled|pending
         "winner": bool, "start_ms", "dur_ms",
         "net_send_ms", "net_recv_ms",   # clock-aligned network split
         "wasted_ms",                    # cancelled hedge lane's cost
         "error": str|None,
         "remote": {"request_id", "replica",
                    "stages": [{"stage", "start_ms", "dur_ms"}]} | None}
      ],
    }

`attribute()` walks the request's critical path, the chain the client
waited on: router ingress and admission, each losing retry round's
longest lane, then the winning attempt split into network send, the
replica's stages and network receive, then the router's respond write.
What the spans cannot explain (scheduler gaps, retry backoff sleeps)
lands in `router_other`, so the hop sum equals `total_ms` by
construction. A cancelled hedge lane is not on the critical path; its
cost is counted apart as `wasted_ms`.

`aggregate()` folds many attributions into per-hop mean and share plus
the hedge and retry accounting; `metrics_payload()` turns that into the
`fleet_serve/critpath_<hop>_ms` gauge family the router flushes
(obs/schema.py); `flatten()` gives the flight recorder's waterfall.
"""

from __future__ import annotations

ROUTER_HOPS = ("router_ingress", "router_admission", "router_respond")


def attribute(stitched: dict) -> dict:
    """One stitched trace -> its critical-path hop attribution (module
    docstring). Hop values are clamped non-negative (clock skew between
    hosts can make a raw network split dip below zero); the residual
    `router_other` absorbs what the spans cannot explain so the hop sum
    is exactly `total_ms`."""
    total = float(stitched.get("total_ms") or 0.0)
    router = stitched.get("router") or {}
    hops: dict[str, float] = {}
    for hop in ROUTER_HOPS:
        ms = router.get(hop[len("router_"):] + "_ms")
        if isinstance(ms, (int, float)):
            hops[hop] = max(0.0, float(ms))
    attempts = stitched.get("attempts") or []
    winner = next((a for a in attempts if a.get("winner")), None)
    hedged = any(a.get("lane") == "hedge" for a in attempts)
    hedge_won = bool(winner and winner.get("lane") == "hedge")
    # Retry cost is accounted per RETRY ROUND (attempts sharing a
    # retry_index ran concurrently — primary + its hedge): a round with
    # a winner puts its losers entirely off-path (waste); a losing
    # round blocked the retry layer for its LONGEST lane (on-path,
    # `retry_failed` hop) while any shorter concurrent lane is waste.
    retry_failed = 0.0
    wasted = 0.0
    rounds: dict[int, list] = {}
    for a in attempts:
        rounds.setdefault(int(a.get("retry_index") or 0), []).append(a)
    for rnd in sorted(rounds):
        group = rounds[rnd]
        has_winner = any(a.get("winner") for a in group)
        blocked = 0.0
        for a in group:
            if a.get("winner"):
                continue
            dur = max(0.0, float(a.get("dur_ms") or 0.0))
            cost = max(0.0, float(a.get("wasted_ms") or 0.0)) or dur
            if a.get("outcome") == "failed" and not has_winner:
                blocked = max(blocked, dur)
                wasted += dur
            else:
                wasted += cost
        if blocked:
            retry_failed += blocked
            wasted -= blocked  # the blocking lane is on-path, not waste
    if retry_failed:
        hops["retry_failed"] = retry_failed
    if winner is not None:
        explained = 0.0
        for key, hop in (("net_send_ms", "net_send"), ("net_recv_ms", "net_recv")):
            ms = winner.get(key)
            if isinstance(ms, (int, float)):
                hops[hop] = hops.get(hop, 0.0) + max(0.0, float(ms))
                explained += max(0.0, float(ms))
        remote = winner.get("remote") or {}
        for s in remote.get("stages") or ():
            ms = max(0.0, float(s.get("dur_ms") or 0.0))
            hop = f"replica_{s.get('stage')}"
            hops[hop] = hops.get(hop, 0.0) + ms
            explained += ms
        # the attempt's own unexplained slack (socket buffering, the
        # replica's respond write — stamped after its response, so it
        # reaches us as slack, never as a remote stage)
        slack = max(0.0, float(winner.get("dur_ms") or 0.0)) - explained
        if slack > 0.0:
            hops["net_recv"] = hops.get("net_recv", 0.0) + slack
    hops["router_other"] = max(0.0, total - sum(hops.values()))
    return {
        "trace_id": stitched.get("trace_id"),
        "total_ms": total,
        "hops": hops,
        "hedged": hedged,
        "hedge_won": hedge_won,
        "retry_failed_ms": retry_failed,
        "wasted_ms": wasted,
        "attempts": len(attempts),
    }


def aggregate(attributions) -> dict:
    """Fold per-trace attributions into run-level accounting: per-hop
    mean ms and share-of-total, hedge win rate, retry cost. Empty input
    -> zeroed aggregate (the router flushes before its first request)."""
    attrs = [a for a in attributions if a]
    n = len(attrs)
    hop_sums: dict[str, float] = {}
    total = 0.0
    hedged = hedge_won = with_retry = 0
    retry_ms = wasted_ms = 0.0
    for a in attrs:
        total += a.get("total_ms", 0.0)
        for hop, ms in (a.get("hops") or {}).items():
            hop_sums[hop] = hop_sums.get(hop, 0.0) + ms
        hedged += 1 if a.get("hedged") else 0
        hedge_won += 1 if a.get("hedge_won") else 0
        if a.get("retry_failed_ms"):
            with_retry += 1
            retry_ms += a["retry_failed_ms"]
        wasted_ms += a.get("wasted_ms", 0.0)
    hops = {
        hop: {
            "mean_ms": s / n,
            "share": (s / total) if total else 0.0,
        }
        for hop, s in hop_sums.items()
    } if n else {}
    return {
        "traces": n,
        "total_mean_ms": (total / n) if n else 0.0,
        "hops": hops,
        "hedge": {
            "hedged": hedged,
            "won": hedge_won,
            "win_rate": (hedge_won / hedged) if hedged else None,
            "wasted_ms": wasted_ms,
        },
        "retry": {
            "traces_with_retry": with_retry,
            "failed_attempt_ms": retry_ms,
            "mean_cost_ms": (retry_ms / with_retry) if with_retry else None,
        },
    }


def metrics_payload(agg: dict) -> dict:
    """Aggregate -> the `fleet_serve/critpath_<hop>_ms` gauge family
    (mean ms per hop over the aggregation window). Hop names are stage
    identifiers ([a-z_]), so the keys stay schema-clean."""
    out: dict = {}
    for hop, rec in sorted((agg.get("hops") or {}).items()):
        out[f"fleet_serve/critpath_{hop}_ms"] = round(rec["mean_ms"], 3)
    return out


def flatten(stitched: dict) -> list[dict]:
    """Stitched trace -> a flat waterfall `stages` list (the flight
    recorder / obs_report display format): router stages, each failed
    attempt, then the winning attempt's network + replica hops, in
    start order where the producers recorded one."""
    out: list[dict] = []
    router = stitched.get("router") or {}

    def add(stage, start, dur):
        if isinstance(dur, (int, float)):
            out.append({
                "stage": stage,
                "start_ms": round(float(start or 0.0), 3),
                "dur_ms": round(max(0.0, float(dur)), 3),
            })

    add("router_ingress", 0.0, router.get("ingress_ms"))
    add("router_admission", router.get("ingress_ms"), router.get("admission_ms"))
    for a in stitched.get("attempts") or ():
        start = float(a.get("start_ms") or 0.0)
        if a.get("outcome") == "failed" and not a.get("winner"):
            add(f"failed_attempt_r{a.get('replica')}", start, a.get("dur_ms"))
            continue
        if a.get("outcome") == "cancelled":
            add(f"cancelled_hedge_r{a.get('replica')}", start, a.get("wasted_ms"))
            continue
        if not a.get("winner"):
            continue
        add("net_send", start, a.get("net_send_ms"))
        cursor = start + float(a.get("net_send_ms") or 0.0)
        for s in (a.get("remote") or {}).get("stages") or ():
            add(
                f"replica_{s.get('stage')}",
                cursor + float(s.get("start_ms") or 0.0),
                s.get("dur_ms"),
            )
        end = start + float(a.get("dur_ms") or 0.0)
        add("net_recv", end - float(a.get("net_recv_ms") or 0.0), a.get("net_recv_ms"))
    total = float(stitched.get("total_ms") or 0.0)
    add("router_respond", total - float(router.get("respond_ms") or 0.0),
        router.get("respond_ms"))
    return out


__all__ = ["ROUTER_HOPS", "aggregate", "attribute", "flatten", "metrics_payload"]
