"""Checkpoint promotion for the serving fleet, the port of
moco_tpu/serve/promote.py: gates, an audit ledger, a staged rollout.

Training keeps writing checkpoints while the fleet serves an encoder
whose index rows some checkpoint embedded. A candidate encoder can be
healthy alone yet incompatible with the live embedding space, and recall
then degrades with no error. This module makes the handoff an auditable
pipeline:

- **Gate battery** (`run_gate_battery`): the candidate must clear
  declared floors before it takes traffic: `compat_cosine` and
  `recall_overlap` (obs/quality.py, against the live encoder and index),
  `feature_std` (obs/health.py's collapse gauge on the candidate's probe
  embeddings, scaled so 1.0 is the uniform sphere's spread) and, given
  the candidate's query and key parameters, an `ema_drift` ceiling. An
  optional `live_recall` floor holds the fleet's `serve/recall_estimate`,
  so a promotion never starts from a degraded baseline.
- **Audit ledger** (`PromotionLedger`): every verdict is one line of an
  append-only `promotions.jsonl`, validated against obs/schema.py before
  the write (`event: "promotion"`): the verdict, the stage, the
  candidate's digest and each gate's evidence (`promotion/gate/<name>`
  beside `promotion/floor/<name>`, `promotion/gate_ok/<name>` 0/1). A
  rejected checkpoint names the gate that stopped it.
- **Staged rollout** (`StagedRollout`): one replica at a time through the
  router: swap (drain, restart onto the candidate, wait until it is
  admitted again with the candidate's digest), then soak on the fleet's
  burn gauges; a breach rolls every swapped replica back. The swap,
  status and burn callables, the sleep and the clock are injected, so the
  transitions, the rollback among them, run without a fleet.

`python -m moco_tpu_torch.serve.serve_promote` wires real engines, the
router's `/admin/promote` and a watch loop around these pieces.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from moco_tpu_torch.obs import health, quality, schema
from moco_tpu_torch.obs.slo import DEFAULT_FAST_BURN
from moco_tpu_torch.utils.locks import make_lock

# Promotion verdicts (obs/schema.py validates the ledger against this
# set): gates either "accepted"/"rejected" a candidate; a rollout ends
# "promoted" or "rolled_back".
VERDICTS = ("accepted", "rejected", "promoted", "rolled_back")

# Default gate floors. `feature_std` is normalized by sqrt(dim) so 1.0
# is the uniform-sphere value (obs/health.py); `ema_drift_max` is a
# CEILING (the gate fails above it); `live_recall` is opt-in (None =
# not gated) because a fleet without online-recall sampling has no
# baseline to threshold.
DEFAULT_FLOORS = {
    "compat_cosine": 0.90,
    "recall_overlap": 0.60,
    "feature_std": 0.25,
    "ema_drift_max": 0.50,
    "live_recall": None,
}


def _gate_floor(value, floor) -> dict:
    v = None if value is None else float(value)
    return {"value": v, "floor": float(floor), "ok": v is not None and v >= float(floor)}


def _gate_ceiling(value, ceiling) -> dict:
    # ledger-side the threshold still lands in `promotion/floor/<name>`
    # (one evidence shape for every gate); the `_max` suffix in the
    # gate's name is what says "fail above, not below"
    v = None if value is None else float(value)
    return {
        "value": v,
        "floor": float(ceiling),
        "ok": v is not None and v <= float(ceiling),
    }


def _leaves(tree) -> list:
    """A parameter tree's leaves as tensors: a nested dict in sorted-key
    order (obs/quality.py's order), a list or tuple in its own, a tensor or
    array as itself."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))]


def _groups(params) -> dict:
    """{top-level group: its leaves}, the grouping obs/health.py's
    `ema_drift` takes: a Flax-layout tree or `health.module_groups`."""
    return {group: _leaves(tree) for group, tree in params.items()}


def run_gate_battery(
    live_engine,
    cand_engine,
    probes,
    index=None,
    k: int = 5,
    mode: str = "exact",
    floors: Optional[dict] = None,
    cand_params_q=None,
    cand_params_k=None,
    live_recall: Optional[float] = None,
) -> dict:
    """Evaluate every promotion gate for one candidate encoder.

    Returns `{"ok", "failed_gate", "gates", "compat"}`: `gates` maps
    gate name → `{"value", "floor", "ok"}` (insertion order is the
    evaluation order; `failed_gate` is the FIRST failure, the one the
    ledger names), `compat` is the schema'd
    `serve/compat_cosine`/`serve/recall_overlap` gauge pair. Engines
    are duck-typed (`embed(images) -> (emb, executed)`) so tests drive
    the battery with fakes. `cand_params_q` / `cand_params_k` map each
    top-level group (`backbone`, `head`) to its parameters: a nested tree
    of arrays or tensors, or a list of tensors (`health.module_groups`)."""
    f = dict(DEFAULT_FLOORS)
    f.update(floors or {})
    probes = np.asarray(probes)
    live_emb, _ = live_engine.embed(probes)
    cand_emb, _ = cand_engine.embed(probes)
    cosine = quality.compat_cosine(live_emb, cand_emb)
    overlap = None
    gates = {"compat_cosine": _gate_floor(cosine, f["compat_cosine"])}
    if index is not None and getattr(index, "count", 0) > 0:
        overlap = quality.recall_overlap(live_emb, cand_emb, index, k=k, mode=mode)
        gates["recall_overlap"] = _gate_floor(overlap, f["recall_overlap"])
    # dimensional-collapse check on the candidate's embeddings, the
    # health gauge rescaled so 1.0 is the uniform sphere's spread
    cand_np = np.asarray(cand_emb, np.float32)
    fstd = float(health.feature_stats(torch.from_numpy(cand_np))["feature_std"])
    gates["feature_std"] = _gate_floor(
        fstd * float(np.sqrt(cand_np.shape[-1])), f["feature_std"]
    )
    if cand_params_q is not None and cand_params_k is not None:
        drift = float(
            health.ema_drift(_groups(cand_params_q), _groups(cand_params_k))["ema_drift"]
        )
        gates["ema_drift_max"] = _gate_ceiling(drift, f["ema_drift_max"])
    if f.get("live_recall") is not None and live_recall is not None:
        gates["live_recall"] = _gate_floor(live_recall, f["live_recall"])
    failed = next((name for name, g in gates.items() if not g["ok"]), None)
    return {
        "ok": failed is None,
        "failed_gate": failed,
        "gates": gates,
        "compat": quality.compat_payload(cosine, overlap),
    }


def ledger_record(
    step: int,
    verdict: str,
    stage: str,
    digest: Optional[str] = None,
    failed_gate: Optional[str] = None,
    replica: Optional[int] = None,
    gates: Optional[dict] = None,
    compat: Optional[dict] = None,
    now: Optional[float] = None,
) -> dict:
    """One schema'd promotion event line: verdict + stage + candidate
    identity, per-gate evidence flattened to
    `promotion/gate/<name>` / `promotion/floor/<name>` /
    `promotion/gate_ok/<name>`, and the compat gauge pair."""
    if verdict not in VERDICTS:
        raise ValueError(f"verdict must be one of {VERDICTS}, got {verdict!r}")
    rec = {
        "step": int(step),
        "time": time.time() if now is None else float(now),
        "event": "promotion",
        "promotion/step": int(step),
        "promotion/verdict": str(verdict),
        "promotion/stage": str(stage),
        "promotion/digest": digest,
        "promotion/failed_gate": failed_gate,
        "promotion/replica": int(replica) if replica is not None else None,
    }
    for name, g in (gates or {}).items():
        rec[f"promotion/gate/{name}"] = g["value"]
        rec[f"promotion/floor/{name}"] = g["floor"]
        rec[f"promotion/gate_ok/{name}"] = int(bool(g["ok"]))
    rec.update(compat or {})
    return rec


class PromotionLedger:
    """Append-only `promotions.jsonl`: the promotion pipeline's audit
    trail. Every record is validated against the obs schema BEFORE the
    write (an unschema'd verdict never lands on disk) and serialized
    with `allow_nan=False` (the writer-side twin of `loads_strict`).
    Append-only by construction: open(..., "a") under a lock, one line
    per event, never rewritten."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = make_lock("promote.ledger")

    def append(self, rec: dict) -> dict:
        errors = schema.validate_line(rec)
        if errors:
            raise ValueError(f"promotion ledger record fails schema: {errors}")
        line = json.dumps(rec, allow_nan=False)
        with self._lock:
            with open(self.path, "a") as fh:
                fh.write(line + "\n")
        return rec

    def read(self) -> list:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as fh:
            return [schema.loads_strict(ln) for ln in fh if ln.strip()]


class StagedRollout:
    """One-replica-at-a-time rollout with burn-gauge soak and
    auto-rollback — the state machine behind `serve_promote`'s rollout
    stage, decoupled from HTTP so the transitions are unit-testable.

    Callables (all injectable):

    - `swap(i)` — start moving replica `i` onto the CANDIDATE
      checkpoint (the CLI posts `/admin/promote?replica=i&ckpt_dir=…`).
    - `swap_back(i)` — same, onto the PREVIOUS checkpoint (rollback
      path; defaults to `swap`, which only makes sense in tests).
    - `status(i)` — that replica's `/admin/replicas` snapshot: the
      machine waits for `healthy and not draining` and, when
      `target_digest` is given, for `model_digest` to match it (the
      swap has LANDED, not merely restarted).
    - `burn()` — the fleet gauge to soak on (the CLI reads the max of
      the router's fast-window latency/freshness burn aggregates);
      any reading above `burn_ceiling` during the soak triggers
      rollback. None readings (no traffic yet) are not breaches.

    `run()` returns `{"verdict": "promoted"|"rolled_back", "swapped",
    "replica", "reason", "burn"}` — `replica`/`reason` name the step
    that failed (`swap_timeout` or `burn_breach`)."""

    def __init__(
        self,
        num_replicas: int,
        swap: Callable[[int], object],
        status: Callable[[int], dict],
        burn: Optional[Callable[[], Optional[float]]] = None,
        swap_back: Optional[Callable[[int], object]] = None,
        target_digest: Optional[str] = None,
        soak_s: float = 1.0,
        swap_timeout_s: float = 60.0,
        burn_ceiling: float = DEFAULT_FAST_BURN,
        poll_s: float = 0.2,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        self.num_replicas = int(num_replicas)
        self.swap = swap
        self.swap_back = swap_back if swap_back is not None else swap
        self.status = status
        self.burn = burn
        self.target_digest = target_digest
        self.soak_s = float(soak_s)
        self.swap_timeout_s = float(swap_timeout_s)
        self.burn_ceiling = float(burn_ceiling)
        self.poll_s = float(poll_s)
        self._sleep = sleep
        self._clock = clock

    def _landed(self, snap: dict, digest: Optional[str]) -> bool:
        if not snap.get("healthy") or snap.get("draining"):
            return False
        if snap.get("drain_phase") is not None:
            return False
        return digest is None or snap.get("model_digest") == digest

    def _swap_and_wait(self, index: int, swap_fn, digest: Optional[str]) -> bool:
        swap_fn(index)
        deadline = self._clock() + self.swap_timeout_s
        while self._clock() < deadline:
            if self._landed(self.status(index), digest):
                return True
            self._sleep(self.poll_s)
        return self._landed(self.status(index), digest)

    def _soak(self) -> Optional[float]:
        """None = clean soak; a float = the breaching burn reading."""
        if self.burn is None or self.soak_s <= 0:
            return None
        deadline = self._clock() + self.soak_s
        while True:
            b = self.burn()
            if b is not None and float(b) > self.burn_ceiling:
                return float(b)
            if self._clock() >= deadline:
                return None
            self._sleep(self.poll_s)

    def run(self) -> dict:
        swapped: list = []
        for i in range(self.num_replicas):
            if not self._swap_and_wait(i, self.swap, self.target_digest):
                return self._rollback(swapped, i, "swap_timeout", None)
            swapped.append(i)
            breach = self._soak()
            if breach is not None:
                return self._rollback(swapped, i, "burn_breach", breach)
        return {
            "verdict": "promoted",
            "swapped": swapped,
            "replica": None,
            "reason": None,
            "burn": None,
        }

    def _rollback(
        self, swapped: Sequence[int], failed: int, reason: str, burn: Optional[float]
    ) -> dict:
        # every replica that touched the candidate goes back — including
        # the one whose swap timed out (it may have half-landed); no
        # digest wait on the way back (the previous encoder's digest is
        # unknown here), just healthy re-admission
        for j in dict.fromkeys(list(swapped) + [failed]):
            self._swap_and_wait(j, self.swap_back, None)
        return {
            "verdict": "rolled_back",
            "swapped": list(swapped),
            "replica": int(failed),
            "reason": reason,
            "burn": burn,
        }


__all__ = [
    "DEFAULT_FLOORS",
    "PromotionLedger",
    "StagedRollout",
    "VERDICTS",
    "ledger_record",
    "run_gate_battery",
]
