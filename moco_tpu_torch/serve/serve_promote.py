"""Gate and promote training checkpoints into the serving fleet, the port
of scripts/serve_promote.py.

    python -m moco_tpu_torch.serve.serve_promote --candidate-dir /run/new \\
        --live-dir /run/current [--router http://127.0.0.1:9000] \\
        [--ledger promotions.jsonl] [--watch-s 10] [--probes 32] [--k 5] \\
        [--device cuda]

For the newest checkpoint of the candidate directory, run the promotion
gate battery (serve/promote.py) against the live serving checkpoint:
embedding-space compatibility (`serve/compat_cosine`,
`serve/recall_overlap` against the live queue's index), the collapse
floor and the EMA-drift ceiling, and write the verdict as one schema'd
line of an append-only `promotions.jsonl`. A candidate that clears the
gates rolls out through the fleet router one replica at a time (`POST
/admin/promote`: drain, restart onto the candidate, wait until its digest
lands), soaking on the fleet's burn gauges between replicas; a breach or a
stuck swap rolls every touched replica back to the live checkpoint.

Without `--router` this is gates only (`accepted` or `rejected` in the
ledger, no traffic touched). With a router the last verdict is `promoted`
or `rolled_back`. One shot by default; `--watch-s N` polls the candidate
directory. The gate engines (live, and the candidate's key and query
encoders) run in this process on `--device`. Exit code 0 when the last
verdict was accepted or promoted, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.parse
import urllib.request

# injectable for tests (a fleet is simulated by swapping this)
_urlopen = urllib.request.urlopen


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with _urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_json(url: str, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(url, data=b"")
    with _urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def load_engine_for_gates(workdir: str, n_probes: int, sides=("k",), device="cuda"):
    """(engine over the key encoder, {side: encoder}, queue, queue_ptr,
    config) for the newest good checkpoint under `workdir`: one engine
    bucket sized to the probe set (the battery embeds exactly one batch)."""
    from moco_tpu_torch.lincls import restore_pretrain_state
    from moco_tpu_torch.serve.engine import InferenceEngine

    restored = restore_pretrain_state(workdir, sides=tuple(sides), device=device)
    engine = InferenceEngine(restored.encoders["k"], restored.config.data.image_size,
                             buckets=(int(n_probes),), device=device)
    return engine, restored.encoders, restored.queue, restored.queue_ptr, restored.config


def gate_candidate(live_dir: str, candidate_dir: str, n_probes: int = 32, k: int = 5,
                   floors: dict = None, live_recall: float = None, device="cuda") -> tuple:
    """The full battery for the candidate directory's newest checkpoint.
    Returns (battery result, the candidate's digest, its step)."""
    from moco_tpu_torch.obs import health, quality
    from moco_tpu_torch.serve.index import EmbeddingIndex
    from moco_tpu_torch.serve.promote import run_gate_battery
    from moco_tpu_torch.utils.checkpoint import CheckpointManager

    step = CheckpointManager(candidate_dir).latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {candidate_dir}")
    live_engine, _, queue, queue_ptr, config = load_engine_for_gates(
        live_dir, n_probes, device=device)
    if queue is None:
        raise ValueError(f"the live checkpoint under {live_dir} holds no queue (a v3 run?)")
    index = EmbeddingIndex.from_train_queue(queue, queue_ptr, device=device)
    # both sides of the candidate from one restore: the key encoder serves,
    # the query encoder is the EMA-drift gate's other half
    cand_engine, encoders, _, _, _ = load_engine_for_gates(
        candidate_dir, n_probes, sides=("q", "k"), device=device)
    probes = quality.synthetic_probes(n_probes, config.data.image_size)
    result = run_gate_battery(
        live_engine, cand_engine, probes, index=index, k=k, floors=floors,
        cand_params_q=health.module_groups(encoders["q"]),
        cand_params_k=health.module_groups(encoders["k"]),
        live_recall=live_recall,
    )
    return result, quality.encoder_digest(encoders["k"]), int(step)


def fleet_burn(router: str):
    """The rollout's soak gauge: the worst of the router's latency and
    freshness burn families (its own and the replicas' aggregates)."""
    stats = _get_json(router.rstrip("/") + "/stats")
    vals = [v for key, v in stats.items()
            if key.startswith("fleet_serve/") and "burn_rate_" in key
            and isinstance(v, (int, float))]
    return max(vals) if vals else None


def live_recall_estimate(router: str):
    """The fleet's sampled online recall (the baseline gate): the max over
    the replicas' serve/recall_estimate, None before any sample."""
    stats = _get_json(router.rstrip("/") + "/stats")
    v = stats.get("fleet_serve/recall_estimate_max")
    return v if isinstance(v, (int, float)) else None


def rollout(router: str, candidate_dir: str, live_dir: str, target_digest: str = None,
            soak_s: float = 2.0, swap_timeout_s: float = 60.0, burn_ceiling: float = None,
            poll_s: float = 0.25) -> dict:
    """Staged rollout over every replica behind `router`, rolled back to
    `live_dir` on a breach: serve/promote.py's StagedRollout with its
    callables wired to the router's HTTP surface."""
    from moco_tpu_torch.obs.slo import DEFAULT_FAST_BURN
    from moco_tpu_torch.serve.promote import StagedRollout

    base = router.rstrip("/")
    replicas = _get_json(base + "/admin/replicas")["replicas"]

    def _swap_to(ckpt_dir):
        quoted = urllib.parse.quote(str(ckpt_dir), safe="")

        def _swap(i):
            _post_json(f"{base}/admin/promote?replica={i}&ckpt_dir={quoted}")

        return _swap

    def _status(i):
        for rep in _get_json(base + "/admin/replicas")["replicas"]:
            if rep["index"] == i:
                return rep
        return {}

    machine = StagedRollout(
        len(replicas), swap=_swap_to(candidate_dir), status=_status,
        burn=lambda: fleet_burn(base), swap_back=_swap_to(live_dir),
        target_digest=target_digest, soak_s=soak_s, swap_timeout_s=swap_timeout_s,
        burn_ceiling=DEFAULT_FAST_BURN if burn_ceiling is None else burn_ceiling,
        poll_s=poll_s,
    )
    return machine.run()


def promote_once(args, ledger) -> str:
    """One pass: gates, their ledger line, then (with a router) the rollout
    and its line. Returns the last verdict."""
    from moco_tpu_torch.serve.promote import ledger_record

    floors = {
        "compat_cosine": args.floor_cosine,
        "recall_overlap": args.floor_overlap,
        "feature_std": args.floor_feature_std,
        "ema_drift_max": args.max_ema_drift,
        "live_recall": args.floor_live_recall,
    }
    live_recall = None
    if args.router and args.floor_live_recall is not None:
        live_recall = live_recall_estimate(args.router)
    result, digest, step = gate_candidate(
        args.live_dir, args.candidate_dir, n_probes=args.probes, k=args.k, floors=floors,
        live_recall=live_recall, device=args.device)
    verdict = "accepted" if result["ok"] else "rejected"
    ledger.append(ledger_record(step, verdict, "gates", digest=digest,
                                failed_gate=result["failed_gate"], gates=result["gates"],
                                compat=result["compat"]))
    print(f"step {step} ({digest}): gates {verdict}"
          + (f" (failed: {result['failed_gate']})" if result["failed_gate"] else ""),
          flush=True)
    if verdict == "rejected" or not args.router:
        return verdict
    out = rollout(args.router, args.candidate_dir, args.live_dir, target_digest=digest,
                  soak_s=args.soak_s, swap_timeout_s=args.swap_timeout_s,
                  burn_ceiling=args.burn_ceiling, poll_s=args.poll_s)
    # a rollback's evidence: the breaching burn reading against the ceiling,
    # in the battery's gate shape
    gates = None
    if out["verdict"] == "rolled_back" and out["burn"] is not None:
        gates = {"burn": {"value": out["burn"], "floor": args.burn_ceiling, "ok": False}}
    ledger.append(ledger_record(step, out["verdict"], "rollout", digest=digest,
                                failed_gate=out["reason"], replica=out["replica"], gates=gates))
    print(f"step {step} ({digest}): rollout {out['verdict']}"
          + (f" (replica {out['replica']}: {out['reason']})"
             if out["reason"] else f" across {len(out['swapped'])} replicas"), flush=True)
    return out["verdict"]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="gate and promote checkpoints into the serving fleet (PyTorch port)")
    ap.add_argument("--candidate-dir", required=True, help="checkpoint dir to watch")
    ap.add_argument("--live-dir", required=True, help="the fleet's current checkpoint dir")
    ap.add_argument("--router", default=None, help="fleet router base URL (omit for gates only)")
    ap.add_argument("--ledger", default=None,
                    help="promotions.jsonl path (default: <candidate-dir>/promotions.jsonl)")
    ap.add_argument("--probes", type=int, default=32, help="held-back probe batch size")
    ap.add_argument("--k", type=int, default=5, help="top-k for the recall-overlap gate")
    ap.add_argument("--floor-cosine", type=float, default=0.90)
    ap.add_argument("--floor-overlap", type=float, default=0.60)
    ap.add_argument("--floor-feature-std", type=float, default=0.25)
    ap.add_argument("--max-ema-drift", type=float, default=0.50)
    ap.add_argument("--floor-live-recall", type=float, default=None,
                    help="also require the fleet's live recall_estimate above this")
    ap.add_argument("--soak-s", type=float, default=2.0,
                    help="burn-gauge soak between replica swaps")
    ap.add_argument("--swap-timeout-s", type=float, default=60.0)
    ap.add_argument("--burn-ceiling", type=float, default=14.4,
                    help="roll back above this fleet burn reading")
    ap.add_argument("--poll-s", type=float, default=0.25)
    ap.add_argument("--watch-s", type=float, default=0.0,
                    help="poll the candidate dir every N seconds (0 = one shot)")
    ap.add_argument("--device", default="cuda", help="where the gate engines run")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from moco_tpu_torch.serve.promote import PromotionLedger
    from moco_tpu_torch.utils.checkpoint import CheckpointManager

    ledger = PromotionLedger(
        args.ledger or os.path.join(args.candidate_dir, "promotions.jsonl"))
    if args.watch_s <= 0:
        verdict = promote_once(args, ledger)
        return 0 if verdict in ("accepted", "promoted") else 1
    last_step = None
    while True:
        step = CheckpointManager(args.candidate_dir).latest_step()
        if step is not None and step != last_step:
            promote_once(args, ledger)
            last_step = step
        time.sleep(args.watch_s)


if __name__ == "__main__":
    sys.exit(main())
