"""JX015: metric-schema consistency.

The metrics contract lives in `obs/schema.py`: every key a writer emits
must be covered by an explicit `FIELD_VALIDATORS` entry or a
`PREFIX_VALIDATORS` family, or `validate_file` silently waves it
through and the schema checks prove nothing about it. The inverse drift
is just as real: a validator whose key no writer emits anymore is dead
weight that reads as coverage, and a prefix family every emission of
which is captured by longer families (or by nothing at all) is
shadowed — its validator can never run.

Three clauses over the program-wide contract registry
(`analysis/contracts.py`):

1. **emitted-but-unvalidated** — a literal metric key (or the literal
   head of an f-string family emission) stored into a payload dict with
   no explicit validator and no matching prefix family; anchored at the
   emission.
2. **dead validator** — an explicit `FIELD_VALIDATORS` key that is
   never emitted and whose literal appears nowhere outside the schema
   module; anchored at the schema entry. Only fires in the module that
   defines the validator table, so partial-tree runs stay quiet.
3. **dead/shadowed prefix family** — a `PREFIX_VALIDATORS` entry that
   is the longest match for NO emitted key or family head; anchored at
   the schema entry.

Validators come from the analyzed program when it defines the tables
(fixtures, the real schema module in whole-tree runs) and fall back to
importing `moco_tpu_torch.obs.schema` for partial-tree runs, so a
focused lint pass sees the real contract.
"""

from __future__ import annotations

from moco_tpu_torch.analysis import contracts
from moco_tpu_torch.analysis.engine import rule


def _tables(reg):
    if reg.schema_paths:
        return reg.validator_keys(), reg.validator_prefixes()
    from moco_tpu_torch.obs import schema

    return set(schema.FIELD_VALIDATORS), set(schema.PREFIX_VALIDATORS)


@rule("JX015", "metric key emitted without a schema validator, or dead/shadowed validator")
def check_metric_schema(ctx):
    reg = contracts.registry_for(ctx)
    fields, prefixes = _tables(reg)

    # 1) emissions in THIS module must be validated somewhere
    for item in reg.emitted_keys:
        if item.path != ctx.path:
            continue
        key = item.key
        if key in fields or any(key.startswith(p) for p in prefixes):
            continue
        yield (
            item.line,
            f"metric key {key!r} is emitted but no obs/schema.py validator "
            f"(field or prefix family) covers it",
        )
    for item in reg.emitted_prefixes:
        if item.path != ctx.path:
            continue
        head = item.prefix
        if any(head.startswith(p) for p in prefixes) or any(
            f.startswith(head) for f in fields
        ):
            continue
        yield (
            item.line,
            f"metric family {head!r}... is emitted but no obs/schema.py "
            f"prefix validator covers it",
        )

    # 2) + 3) anchor in the schema-defining module only
    if ctx.path not in reg.schema_paths:
        return

    emitted = {e.key for e in reg.emitted_keys}
    heads = {e.prefix for e in reg.emitted_prefixes}
    for item in reg.field_validators:
        if item.path != ctx.path:
            continue
        key = item.key
        live = (
            key in emitted
            or any(key.startswith(h) for h in heads)
            or any(
                p not in reg.schema_paths
                for p in reg.literal_strings.get(key, ())
            )
        )
        if not live:
            yield (
                item.line,
                f"validator for {key!r} is dead: no writer emits it and the "
                f"literal appears nowhere outside the schema module",
            )

    def longest(cands, value):
        hits = [p for p in cands if value.startswith(p)]
        return max(hits, key=len) if hits else None

    for item in reg.prefix_validators:
        if item.path != ctx.path:
            continue
        prefix = item.prefix
        selected = any(
            k not in fields and longest(prefixes, k) == prefix for k in emitted
        ) or any(longest(prefixes, h) == prefix for h in heads)
        if not selected:
            yield (
                item.line,
                f"prefix family {prefix!r} is the longest match for no emitted "
                f"key — dead, or fully shadowed by longer families",
            )
