"""Declarative in-stream alerting over the metrics stream (the port's copy
of moco_tpu/obs/alerts.py, stdlib only like the original).

The engine evaluates declarative rules against every logged payload, on
the host (no device work), and emits:

- `alerts.jsonl` in the workdir (one JSON object per fired alert);
- an `event: "alert"` metrics line per fire (written by the driver);
- with `alerts_fatal`, a `FatalAlertError` abort after the driver's
  emergency checkpoint (save first, die second).

Rule spec grammar (comma-separated `kind@key=val:key=val`; the entry
`default` expands to DEFAULT_SPEC):

    spike@name=N:field=F:factor=X:window=W:warmup=K
        fires when F exceeds X times its rolling median over the last W
        observations (after K observations)
    threshold@name=N:field=F:value=V[:op=gt|lt]
        fires on the rising edge of F crossing V (no re-fire while the
        condition stays true)
    ratio@name=N:num=A:den=B:value=V:consecutive=C
        fires when A/B exceeds V for C consecutive observations
    event@name=N:event=E
        fires on every metrics event line of kind E
    heartbeat@name=N:timeout=T
        process 0 only: fires when another process's heartbeat file is
        older than T seconds (once per process, until it beats again)

Any rule takes `severity=warn|fatal` and `cooldown=K` (observations
between re-fires; default 10 for spike, ratio and event).

Derived field: `queue_stale_seconds` = `queue_age_max * t_step` (the
dictionary's oldest key in wall seconds), added before evaluation.

The default set's `straggler_skew_high` reads the fleet aggregate's
`straggler_skew` (obs/fleet.py; rank 0's lines), which one process reports
as 0; on one process `heartbeat_loss` finds no other process's file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from collections import deque
from typing import Optional

from moco_tpu_torch.obs.fleet import read_heartbeats

RULE_KINDS = ("spike", "threshold", "ratio", "event", "heartbeat")

_INT_KEYS = ("window", "warmup", "consecutive", "cooldown")
_FLOAT_KEYS = ("value", "factor", "timeout")
_STR_KEYS = ("name", "field", "num", "den", "event", "op", "severity")

DEFAULT_HEARTBEAT_TIMEOUT = 120.0


def default_spec(heartbeat_timeout: float = DEFAULT_HEARTBEAT_TIMEOUT) -> str:
    """The built-in rule set, with the heartbeat-staleness threshold
    parameterized (config.heartbeat_timeout, --heartbeat-timeout)."""
    return (
        "spike@name=step_time_spike:field=t_step:factor=3:window=32:warmup=8,"
        "ratio@name=data_starvation:num=t_data:den=t_step:value=0.6:consecutive=3,"
        "threshold@name=straggler_skew_high:field=straggler_skew:value=0.5,"
        "threshold@name=ema_drift_runaway:field=ema_drift:value=0.5,"
        "threshold@name=queue_stale:field=queue_stale_seconds:value=600,"
        "event@name=nonfinite_loss:event=nonfinite_loss,"
        "event@name=stall:event=stall,"
        f"heartbeat@name=heartbeat_loss:timeout={heartbeat_timeout:g}:severity=fatal"
    )


DEFAULT_SPEC = default_spec()


class FatalAlertError(RuntimeError):
    """Raised by the driver when a fired alert is fatal under
    --alerts-fatal; the emergency checkpoint is already durable."""


@dataclasses.dataclass(frozen=True)
class AlertRule:
    name: str
    kind: str
    field: str = ""
    op: str = "gt"
    value: float = 0.0
    factor: float = 3.0
    window: int = 32
    warmup: int = 8
    num: str = ""
    den: str = ""
    consecutive: int = 1
    event: str = ""
    timeout: float = 120.0
    cooldown: int = 10
    severity: str = "warn"


def parse_rules(
    spec: Optional[str], heartbeat_timeout: Optional[float] = None
) -> list[AlertRule]:
    """Rules from a spec string; '' / 'none' -> no rules; the entry
    'default' expands in place, so 'default,threshold@name=...' extends
    the built-ins. `heartbeat_timeout` parameterizes the default set's
    heartbeat_loss threshold (explicit heartbeat@ rules keep their own
    timeout=)."""
    if not spec or spec.strip().lower() == "none":
        return []
    rules: list[AlertRule] = []
    seen: set[str] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.lower() == "default":
            expanded = default_spec(
                heartbeat_timeout
                if heartbeat_timeout is not None
                else DEFAULT_HEARTBEAT_TIMEOUT
            )
            for r in parse_rules(expanded):
                if r.name not in seen:
                    seen.add(r.name)
                    rules.append(r)
            continue
        kind, _, params = part.partition("@")
        if kind not in RULE_KINDS:
            raise ValueError(f"unknown alert rule kind {kind!r} in {part!r} (known: {RULE_KINDS})")
        kv: dict = {"kind": kind}
        for tok in params.split(":"):
            if not tok:
                continue
            k, _, v = tok.partition("=")
            if k in _INT_KEYS:
                kv[k] = int(v)
            elif k in _FLOAT_KEYS:
                kv[k] = float(v)
            elif k in _STR_KEYS:
                kv[k] = v
            else:
                raise ValueError(f"unknown alert rule param {k!r} in {part!r}")
        if "name" not in kv:
            raise ValueError(f"alert rule {part!r} needs name=")
        rule = AlertRule(**kv)
        _validate_rule(rule, part)
        if rule.name in seen:
            raise ValueError(f"duplicate alert rule name {rule.name!r}")
        seen.add(rule.name)
        rules.append(rule)
    return rules


def _validate_rule(rule: AlertRule, part: str) -> None:
    if rule.kind in ("spike", "threshold") and not rule.field:
        raise ValueError(f"{rule.kind} rule {part!r} needs field=")
    if rule.kind == "ratio" and not (rule.num and rule.den):
        raise ValueError(f"ratio rule {part!r} needs num= and den=")
    if rule.kind == "event" and not rule.event:
        raise ValueError(f"event rule {part!r} needs event=")
    if rule.op not in ("gt", "lt"):
        raise ValueError(f"rule {part!r}: op must be gt or lt")
    if rule.severity not in ("warn", "fatal"):
        raise ValueError(f"rule {part!r}: severity must be warn or fatal")


def _num(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


class AlertEngine:
    """Evaluates rules against each logged payload; appends fired alerts
    to `<workdir>/alerts.jsonl` (line-buffered, crash-safe tail) and
    returns them to the caller for in-band event lines / aborts."""

    def __init__(
        self,
        rules: list[AlertRule],
        workdir: Optional[str] = None,
        process_index: int = 0,
        on_fire=None,
    ):
        self.rules = list(rules)
        self.process_index = int(process_index)
        # per-alert callback, invoked (after the jsonl write) with each
        # fired alert dict, at the firing edge. Exceptions are swallowed: a
        # broken hook must not take alerting (or the run) down.
        self.on_fire = on_fire
        self.workdir = workdir
        self.path = os.path.join(workdir, "alerts.jsonl") if workdir else None
        self._f = None
        self._hist: dict[str, deque] = {
            r.name: deque(maxlen=max(r.window, 1)) for r in self.rules if r.kind == "spike"
        }
        self._consec: dict[str, int] = {}
        self._active: set[str] = set()  # threshold rules currently over the line
        self._last_fired: dict[str, int] = {}  # rule -> observation index
        self._hb_alerted: set[int] = set()  # processes currently declared lost
        self._obs = 0

    # -- evaluation ------------------------------------------------------

    def observe(self, step: int, payload: dict, now: Optional[float] = None) -> list[dict]:
        """Evaluate every rule against one logged payload; returns the
        alerts fired (possibly empty). Cheap: dict lookups + a rolling
        median per spike rule."""
        now = time.time() if now is None else now
        self._obs += 1
        view = dict(payload)
        qmax, tstep = _num(view.get("queue_age_max")), _num(view.get("t_step"))
        if qmax is not None and tstep is not None:
            view["queue_stale_seconds"] = qmax * tstep
        fired: list[dict] = []
        for rule in self.rules:
            alert = self._eval(rule, step, view, now)
            if alert is not None:
                fired.append(alert)
        if fired:
            self._write(fired)
            if self.on_fire is not None:
                for alert in fired:
                    try:
                        self.on_fire(alert)
                    except Exception as e:
                        print(f"WARNING: alert on_fire hook failed: {e!r}", flush=True)
        return fired

    def _cooldown_ok(self, rule: AlertRule) -> bool:
        last = self._last_fired.get(rule.name)
        return last is None or self._obs - last >= max(rule.cooldown, 1)

    def _fire(self, rule: AlertRule, step: int, now: float, value, threshold, message: str) -> dict:
        self._last_fired[rule.name] = self._obs
        return {
            "time": now,
            "step": int(step),
            "rule": rule.name,
            "kind": rule.kind,
            "severity": rule.severity,
            "value": value,
            "threshold": threshold,
            "message": message,
        }

    def _eval(self, rule: AlertRule, step: int, view: dict, now: float) -> Optional[dict]:
        if rule.kind == "spike":
            val = _num(view.get(rule.field))
            if val is None:
                return None
            hist = self._hist[rule.name]
            out = None
            if len(hist) >= max(rule.warmup, 2):
                med = statistics.median(hist)
                if med > 0 and val > rule.factor * med and self._cooldown_ok(rule):
                    out = self._fire(
                        rule, step, now, val, rule.factor * med,
                        f"{rule.field}={val:.4g} > {rule.factor:g}x rolling median {med:.4g}",
                    )
            hist.append(val)
            return out
        if rule.kind == "threshold":
            val = _num(view.get(rule.field))
            if val is None:
                return None
            over = val > rule.value if rule.op == "gt" else val < rule.value
            if not over:
                self._active.discard(rule.name)
                return None
            if rule.name in self._active:  # no re-fire while continuously over
                return None
            self._active.add(rule.name)
            op = ">" if rule.op == "gt" else "<"
            return self._fire(
                rule, step, now, val, rule.value,
                f"{rule.field}={val:.4g} {op} {rule.value:g}",
            )
        if rule.kind == "ratio":
            num, den = _num(view.get(rule.num)), _num(view.get(rule.den))
            if num is None or den is None or den <= 0:
                return None
            ratio = num / den
            if ratio > rule.value:
                self._consec[rule.name] = self._consec.get(rule.name, 0) + 1
            else:
                self._consec[rule.name] = 0
                return None
            if self._consec[rule.name] == rule.consecutive or (
                self._consec[rule.name] > rule.consecutive and self._cooldown_ok(rule)
            ):
                return self._fire(
                    rule, step, now, ratio, rule.value,
                    f"{rule.num}/{rule.den}={ratio:.3f} > {rule.value:g} "
                    f"for {self._consec[rule.name]} consecutive log steps",
                )
            return None
        if rule.kind == "event":
            if view.get("event") != rule.event:
                return None
            return self._fire(
                rule, step, now, 1, None, f"event {rule.event!r} observed"
            )
        if rule.kind == "heartbeat":
            if self.process_index != 0 or not self.workdir:
                return None
            for p, rec in read_heartbeats(self.workdir).items():
                if p == self.process_index:
                    continue
                age = now - float(rec.get("time", 0.0))
                if age <= rule.timeout:
                    self._hb_alerted.discard(p)
                elif p not in self._hb_alerted:
                    self._hb_alerted.add(p)
                    return self._fire(
                        rule, step, now, age, rule.timeout,
                        f"process {p} heartbeat {age:.0f}s old (> {rule.timeout:g}s) "
                        f"— host {rec.get('host', '?')} lost?",
                    )
            return None
        return None

    # -- output ----------------------------------------------------------

    def _write(self, alerts: list[dict]) -> None:
        if self.path is None:
            return
        if self._f is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        for a in alerts:
            self._f.write(json.dumps(a, allow_nan=False) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.flush()
            self._f.close()


def read_alerts(path: str) -> list[dict]:
    """Parsed alerts.jsonl (missing file -> empty list) — the report
    loader."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


__all__ = [
    "DEFAULT_HEARTBEAT_TIMEOUT",
    "DEFAULT_SPEC",
    "default_spec",
    "AlertEngine",
    "AlertRule",
    "FatalAlertError",
    "parse_rules",
    "read_alerts",
]
