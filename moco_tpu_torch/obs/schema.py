"""The metrics.jsonl line schema, as code: the port's copy of the part of
moco_tpu/obs/schema.py that its lines use (stdlib only, like the original).

Line kinds (all carry `step` int + `time` float):

- *training lines*: `loss` present -> require `epoch`/`lr`/`acc1`/`acc5`;
  optionally the step times (`t_data`/`t_step`), the input-wire gauges of
  the prefetch ring (`t_transfer`/`transfer_bytes`/`prefetch_depth_live`),
  the health gauges (`ema_drift`, `ema_drift/<group>`, `logit_*`,
  `feature_*`, `queue_age_*`), and the fault counters
  (`nan_steps`/`decode_failures`/`io_retries` when nonzero);
- *event lines*: `event` in EVENT_KINDS instead of the metric fields: the
  guard's `nonfinite_loss`, the watchdog's `stall` (with its
  `watchdog_timeout`), `preempt`, and `alert` (with `alert`, `severity`
  and an `alert/<rule>` gauge);
- *aux lines*: neither (the kNN monitor's `knn_top1` line).

Serving lines (serve/server.py's metrics flusher) carry the `serve/*`
family: latency and occupancy gauges, counters, the per-bucket and per-tier
counts (numbers, or null before the first request), the latency histogram
(a structured payload), the retrieval tier's gauges, and the served model's
identity, whose digest is the one string in the family. An explicit field
validator wins over its prefix family.

Numbers are finite or null: NaN/Inf literals are rejected at parse time
(`loads_strict`), matching the writer's scrubbing. The JAX schema's
fleet, ZeRO, rescale and promotion families come with the slices that
write them; a field this copy does not list passes unchecked, as in
the original.
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
    # step times
    "t_data": _num,
    "t_step": _num,
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
    # the watchdog's stall event line
    "watchdog_timeout": _num,
    # alert event lines (obs/alerts.py)
    "alert": lambda v: isinstance(v, str),
    "severity": lambda v: v in ("warn", "fatal"),
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
    # the served model's identity (obs/quality.py): its checkpoint step and
    # parameter digest (null for a hand-built engine), and the checkpoint
    # step of the last ingested block (null without one)
    "serve/model_step": lambda v: v is None or _int_like(v),
    "serve/model_digest": _str_or_null,
    "serve/ingest_ckpt_step": lambda v: v is None or _int_like(v),
}

# key-prefix families sharing one validator: the per-group EMA drift, the
# per-rule alert gauge and the serving family (p50_ms / p99_ms null before
# the first request, occupancy before the first flush; qps, requests,
# slo_violations, slo_ms, recompiles_after_warmup, index_rows and the
# bucket_<b> / mode_<tier> counts numeric); an explicit FIELD_VALIDATORS
# entry wins, else the longest matching prefix
PREFIX_VALIDATORS = {
    "ema_drift/": _num_or_null,
    "alert/": _num,
    "serve/": _num_or_null,
}


def _reject_nonfinite(val: str):
    raise ValueError(f"non-finite JSON literal {val!r} (writer must scrub to null)")


def loads_strict(line: str) -> dict:
    """json.loads that rejects NaN/Infinity literals."""
    rec = json.loads(line, parse_constant=_reject_nonfinite)
    if not isinstance(rec, dict):
        raise ValueError("metrics line is not a JSON object")
    return rec


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
        if k in rec and not check(rec[k]):
            errors.append(f"field {k!r} has invalid value {rec[k]!r}")
    for k, v in rec.items():
        if k in FIELD_VALIDATORS:
            continue
        matches = [p for p in PREFIX_VALIDATORS if k.startswith(p)]
        if matches and not PREFIX_VALIDATORS[max(matches, key=len)](v):
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


def read_metrics(path: str) -> list[dict]:
    """Parsed records of a metrics.jsonl; raises on a malformed line."""
    with open(path) as f:
        return [loads_strict(line) for line in f if line.strip()]
