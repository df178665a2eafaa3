"""The metrics.jsonl line schema, as code: the port's copy of the part of
moco_tpu/obs/schema.py that its lines use (stdlib only, like the original).

Line kinds (all carry `step` int + `time` float):

- *training lines*: `loss` present -> require `epoch`/`lr`/`acc1`/`acc5`;
  optionally the step times (`t_data`/`t_step`, and `t_dispatch`/
  `t_device` from the probe's latest sampled step), the device-memory
  gauges (`hbm_live_bytes`/`hbm_peak_bytes`/`hbm_headroom_bytes`, number
  or null) and the state's bytes (`hbm_state_bytes`), ZeRO's gauges
  (`overlap/zero`, `overlap/zero_layer`, `hbm_model_peak_bytes`), the input-wire
  gauges of the prefetch ring
  (`t_transfer`/`transfer_bytes`/`prefetch_depth_live`), the health
  gauges (`ema_drift`, `ema_drift/<group>`, `logit_*`, `feature_*`,
  `queue_age_*`), and the fault counters
  (`nan_steps`/`decode_failures`/`io_retries` when nonzero);
- *event lines*: `event` in EVENT_KINDS instead of the metric fields: the
  guard's `nonfinite_loss`, the watchdog's `stall` (with its
  `watchdog_timeout`), `preempt`, `alert` (with `alert`, `severity`
  and an `alert/<rule>` gauge), and the elastic `rescale` (the `rescale/`
  family: the dead ranks' list, the old and new width and global batch as
  ints, kappa and the derived lr and momentum as numbers);
- *aux lines*: neither (the kNN monitor's `knn_top1` line).

Serving lines (serve/server.py's metrics flusher) carry the `serve/*`
family: latency and occupancy gauges, counters, the per-bucket and per-tier
counts (numbers, or null before the first request), the latency histogram
(a structured payload), the retrieval tier's gauges and the sampled
recall, the request-trace stage means (`serve/trace_<stage>_ms`), the SLO
burn rates (`serve/burn_rate_<w>s`, and the freshness twin), the p99
exemplar, and the served model's identity; the exemplar's request id and
the model digest are the strings in the family. An explicit field
validator wins over its prefix family, else the longest prefix.

Numbers are finite or null: NaN/Inf literals are rejected at parse time
(`loads_strict`), matching the writer's scrubbing. Data-parallel lines
carry the fleet aggregate (`fleet_hosts`, `straggler_skew`, the `fleet/`
family, rank 0's) and the `comms/` ledger. The serving fleet's router
flushes the `fleet_serve/*` family (serve/router.py: topology counts, the
hedge-loser and version-skew gauges, the burn and critical-path families),
and the promotion ledger (serve/promote.py) writes `event: "promotion"`
lines of the `promotion/*` family. A field this copy does not list passes
unchecked, as in the original.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

EVENT_KINDS = frozenset(
    {"nonfinite_loss", "stall", "recompile_after_warmup", "alert", "preempt", "rescale",
     "promotion"}
)

TRAIN_REQUIRED = ("epoch", "lr", "loss", "acc1", "acc5")

_NUMBER = (int, float)


def _num(v: Any) -> bool:
    return isinstance(v, _NUMBER) and not isinstance(v, bool)


def _num_or_null(v: Any) -> bool:
    return v is None or _num(v)


def _int_like(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _num_list(v: Any) -> bool:
    return isinstance(v, list) and all(_num_or_null(x) for x in v)


def _counter_map(v: Any) -> bool:
    return isinstance(v, dict) and all(isinstance(k, str) and _int_like(n) for k, n in v.items())


def _str_or_null(v: Any) -> bool:
    return v is None or isinstance(v, str)


def _nonneg_or_null(v: Any) -> bool:
    return v is None or (_num(v) and v >= 0)


def _latency_hist(v: Any) -> bool:
    """The latency histogram: ascending finite bucket bounds (ms), one count
    per bucket plus the +Inf slot (per bucket, not cumulative), and the
    sum / count pair."""
    if not isinstance(v, dict):
        return False
    le, counts = v.get("le"), v.get("counts")
    return (
        isinstance(le, list)
        and all(_num(x) for x in le)
        and le == sorted(le)
        and isinstance(counts, list)
        and len(counts) == len(le) + 1
        and all(_int_like(c) and c >= 0 for c in counts)
        and _num(v.get("sum"))
        and _int_like(v.get("count"))
    )


# field -> validator; a field listed here, when present, must satisfy it
FIELD_VALIDATORS = {
    "step": _int_like,
    "time": _num,
    "epoch": _int_like,
    "lr": _num_or_null,
    "loss": _num_or_null,
    "acc1": _num_or_null,
    "acc5": _num_or_null,
    "knn_top1": _num_or_null,
    # step times (obs/stepstats.py)
    "t_data": _num,
    "t_step": _num,
    "t_dispatch": _num_or_null,
    "t_device": _num,
    # device memory (null where there is no card) and the train state's
    # bytes
    "hbm_live_bytes": _num_or_null,
    "hbm_peak_bytes": _num_or_null,
    "hbm_headroom_bytes": _num_or_null,
    "hbm_state_bytes": _int_like,
    # ZeRO (parallel/zero.py): the hoisted gather's overlap, 1 - wait /
    # duration of the stall its worker absorbed (null when none), under its
    # own key too on the layer-granular schedule; the analytic per-rank
    # peak model bytes at stage 2/3 (the shards plus the gathered whole
    # parameters, or the largest adjacent group pair)
    "overlap/zero": _num_or_null,
    "overlap/zero_layer": _num_or_null,
    "hbm_model_peak_bytes": _num_or_null,
    # the fleet aggregate (obs/fleet.py; rank 0's lines only)
    "fleet_hosts": _int_like,
    "straggler_skew": _num_or_null,
    # input wire (the prefetch ring): the last batch's transfer seconds,
    # its uint8 bytes, and the staged batches resident when it was taken
    "t_transfer": _num,
    "transfer_bytes": _int_like,
    "prefetch_depth_live": _int_like,
    # MoCo health gauges (obs/health.py)
    "ema_drift": _num_or_null,
    "logit_pos_mean": _num_or_null,
    "logit_pos_std": _num_or_null,
    "logit_neg_mean": _num_or_null,
    "logit_neg_std": _num_or_null,
    "feature_std": _num_or_null,
    "feature_dim_active": _num_or_null,
    "queue_age_mean": _num_or_null,
    "queue_age_max": _num_or_null,
    "queue_age_hist": _num_list,
    # fault-tolerance counters (present only when nonzero)
    "nan_steps": _int_like,
    "decode_failures": _int_like,
    "io_retries": _counter_map,
    # the analysis's runtime arms (analysis/runtime.py, analysis/sanitizer.py):
    # the run's CUDA-graph captures on every line under strict_tracing, and
    # the short hash of this rank's collective schedule under
    # sanitize_collectives (flat on a healthy run, equal on every rank)
    "compile_cache_misses": _int_like,
    "collective_schedule_hash": lambda v: isinstance(v, str),
    # the watchdog's stall event line
    "watchdog_timeout": _num,
    # alert event lines (obs/alerts.py)
    "alert": lambda v: isinstance(v, str),
    "severity": lambda v: v in ("warn", "fatal"),
    # elastic rescale event lines (parallel/elastic.py): the lost ranks (a
    # list of ints) ride the otherwise numeric rescale/ family
    "rescale/dead_hosts": _num_list,
    "rescale/old_num_data": _int_like,
    "rescale/new_num_data": _int_like,
    "rescale/old_global_batch": _int_like,
    "rescale/new_global_batch": _int_like,
    # serving (serve/server.py): the IVF probe width (null on the exact
    # tier), whether any scoring runs int8 (0/1), the streaming-ingest row
    # counter, the engine's quantization tier (0 off, 1 w8, 2 w8a8), the
    # IVF's unplaced rows and mean cell fill (null before train_ivf)
    "serve/nprobe": lambda v: v is None or (_int_like(v) and v >= 1),
    "serve/int8": lambda v: v in (0, 1),
    "serve/ingested_rows": _int_like,
    "serve/quant_tier": lambda v: v in (0, 1, 2),
    "serve/ivf_spill": lambda v: v is None or (_int_like(v) and v >= 0),
    "serve/ivf_occupancy": lambda v: v is None or (_num(v) and 0.0 <= v <= 1.0),
    "serve/latency_hist": _latency_hist,
    # request-scoped serving (obs/reqtrace.py, obs/slo.py): the sampled
    # recall of the approximate tier (null until a sample), the p99
    # exemplar's request id (a string) and latency, the declared SLO
    # objective, the measured tracing overhead, and the freshness
    # objective (a replica without one omits it)
    "serve/recall_estimate": lambda v: v is None or (_num(v) and 0.0 <= v <= 1.0),
    "serve/p99_exemplar": _str_or_null,
    "serve/p99_exemplar_ms": _nonneg_or_null,
    "serve/slo_objective": lambda v: _num(v) and 0.0 < v < 1.0,
    "serve/trace_overhead_pct": _num_or_null,
    "serve/fresh_max_age_s": lambda v: _num(v) and v > 0,
    # the served model's identity (obs/quality.py): its checkpoint step and
    # parameter digest (null for a hand-built engine), and the checkpoint
    # step of the last ingested block (null without one)
    "serve/model_step": lambda v: v is None or _int_like(v),
    "serve/model_digest": _str_or_null,
    "serve/ingest_ckpt_step": lambda v: v is None or _int_like(v),
    # the valid index rows' age (null on an empty index)
    "serve/row_age_max_s": _nonneg_or_null,
    "serve/row_age_mean_s": _nonneg_or_null,
    # the fleet router's gauges (serve/router.py FleetRouter.stats):
    # topology counts are ints, the objective mirrors serve/slo_objective,
    # the cancelled hedge lanes' cost is a counter in ms, and the version
    # skew (distinct served digests minus one) is null until a replica
    # reports a digest
    "fleet_serve/replicas": lambda v: _int_like(v) and v >= 1,
    "fleet_serve/replicas_healthy": lambda v: _int_like(v) and v >= 0,
    "fleet_serve/slo_objective": lambda v: _num(v) and 0.0 < v < 1.0,
    "fleet_serve/hedge_wasted_ms": _nonneg_or_null,
    "fleet_serve/model_skew": lambda v: v is None or (_int_like(v) and v >= 0),
    # promotion ledger lines (serve/promote.py ledger_record): the verdict,
    # the stage, the candidate's digest, the first failed gate (null on
    # success) and the replica a rollout line names (null fleet-wide); the
    # per-gate evidence rides the numeric promotion/ family below
    "promotion/verdict": lambda v: v in ("accepted", "rejected", "promoted", "rolled_back"),
    "promotion/stage": lambda v: isinstance(v, str),
    "promotion/digest": _str_or_null,
    "promotion/failed_gate": _str_or_null,
    "promotion/replica": lambda v: v is None or _int_like(v),
    "promotion/step": _int_like,
}

# key-prefix families sharing one validator: the per-group EMA drift, the
# per-rule alert gauge and the serving family (p50_ms / p99_ms null before
# the first request, occupancy before the first flush; qps, requests,
# slo_violations, slo_ms, recompiles_after_warmup, index_rows and the
# bucket_<b> / mode_<tier> counts numeric); an explicit FIELD_VALIDATORS
# entry wins, else the longest matching prefix
PREFIX_VALIDATORS = {
    "ema_drift/": _num_or_null,
    # the rescale line's kappa, lr and momentum; the explicit entries above
    # (the dead ranks' list, the int widths and batches) win
    "rescale/": _num_or_null,
    # the fleet's min / mean / max / argmax (null where no rank reports the
    # field) and the comms ledger's analytic bytes (always numeric)
    "fleet/": _num_or_null,
    "comms/": _num,
    "alert/": _num,
    "serve/": _num_or_null,
    # stage means (ms) and burn rates: null while a window is empty, never
    # negative
    "serve/trace_": _nonneg_or_null,
    "serve/burn_rate_": _nonneg_or_null,  # mocolint: disable=JX015  (emitted as f-string keys of a dict comprehension, obs/slo.py SLOBurnTracker.payload, which the literal extraction does not read; the contract-coverage recorder sees the family live)
    "serve/fresh_burn_rate_": _nonneg_or_null,  # mocolint: disable=JX015  (the freshness twin of serve/burn_rate_, emitted by the same dict comprehension in obs/slo.py)
    # the router's family: latency gauges null before the first proxied
    # request, counters numeric; its burn rates (its own and the replicas'
    # min / mean / max, renamed from serve/) and the critical-path hop means
    # (obs/critpath.py) never negative
    "fleet_serve/": _num_or_null,
    "fleet_serve/burn_rate_": _nonneg_or_null,  # mocolint: disable=JX015  (the router renames each replica's serve/burn_rate_* gauges into this family dynamically, so no literal emission exists; the runtime contract-coverage gate proves the family live instead)
    "fleet_serve/fresh_burn_rate_": _nonneg_or_null,  # mocolint: disable=JX015  (the freshness burn aggregates ride the same dynamic rename, so the same no-literal-emission exemption applies)
    "fleet_serve/critpath_": _nonneg_or_null,
    # promotion/gate/<name> (null where a gate could not run),
    # promotion/floor/<name> and promotion/gate_ok/<name> (0/1)
    "promotion/": _num_or_null,
}


def _reject_nonfinite(val: str):
    raise ValueError(f"non-finite JSON literal {val!r} (writer must scrub to null)")


def loads_strict(line: str) -> dict:
    """json.loads that rejects NaN/Infinity literals."""
    rec = json.loads(line, parse_constant=_reject_nonfinite)
    if not isinstance(rec, dict):
        raise ValueError("metrics line is not a JSON object")
    return rec


# The contract-coverage recorder's hook (analysis/contracts.py): when set,
# every validator that applies to a line, an explicit key or the winning
# prefix family, is reported. One None check per use when off.
_COVERAGE_CB = None


def set_coverage_callback(cb) -> None:
    """Install (or clear, with None) the `cb(validator_key)` callback."""
    global _COVERAGE_CB
    _COVERAGE_CB = cb


def validate_line(rec: dict) -> list[str]:
    """Schema errors for one parsed line (empty list = valid)."""
    errors = []
    for k in ("step", "time"):
        if k not in rec:
            errors.append(f"missing required key {k!r}")
    if "event" in rec:
        if rec["event"] not in EVENT_KINDS:
            errors.append(f"unknown event kind {rec['event']!r}")
        if "loss" in rec:
            errors.append("event line must not carry metric field 'loss'")
    elif "loss" in rec:
        missing = [k for k in TRAIN_REQUIRED if k not in rec]
        if missing:
            errors.append(f"training line missing {missing}")
    for k, check in FIELD_VALIDATORS.items():
        if k in rec:
            if _COVERAGE_CB is not None:
                _COVERAGE_CB(k)
            if not check(rec[k]):
                errors.append(f"field {k!r} has invalid value {rec[k]!r}")
    for k, v in rec.items():
        if k in FIELD_VALIDATORS:
            continue
        matches = [p for p in PREFIX_VALIDATORS if k.startswith(p)]
        if matches:
            winner = max(matches, key=len)
            if _COVERAGE_CB is not None:
                _COVERAGE_CB(winner)
            if not PREFIX_VALIDATORS[winner](v):
                errors.append(f"field {k!r} has invalid value {v!r}")
    return errors


def validate_lines(lines: Iterable[str]) -> list[str]:
    """Errors across a whole metrics.jsonl body, tagged with 1-based line
    numbers; parse failures (NaN literals included) are schema errors."""
    errors = []
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        try:
            rec = loads_strict(line)
        except ValueError as e:
            errors.append(f"line {i}: unparseable: {e}")
            continue
        errors.extend(f"line {i}: {e}" for e in validate_line(rec))
    return errors


def validate_file(path: str) -> list[str]:
    with open(path) as f:
        return validate_lines(f)


def required_train_keys(strict_tracing: bool = False) -> tuple:
    """The keys every training line carries; `strict_tracing` adds the
    always-present capture counter."""
    base = TRAIN_REQUIRED + ("t_data", "t_step", "hbm_live_bytes")
    return base + ("compile_cache_misses",) if strict_tracing else base


def read_metrics(path: str) -> list[dict]:
    """Parsed records of a metrics.jsonl; raises on a malformed line."""
    with open(path) as f:
        return [loads_strict(line) for line in f if line.strip()]
