"""CLI: ``python -m moco_tpu_torch.analysis [paths...]`` (mocolint for the
port; default path `moco_tpu_torch`).

Exit status 0 when every finding is suppressed or baselined (or none
exist), 1 when new findings remain, 2 on usage errors.

Baseline workflow (a baseline is `mocolint-torch-baseline.json`, never
the JAX package's file)::

    python -m moco_tpu_torch.analysis moco_tpu_torch/ --update-baseline
    python -m moco_tpu_torch.analysis moco_tpu_torch/        # auto-discovered
    python -m moco_tpu_torch.analysis moco_tpu_torch/ --baseline FILE
    python -m moco_tpu_torch.analysis moco_tpu_torch/ --no-baseline
"""

from __future__ import annotations

import argparse
import sys

from moco_tpu_torch.analysis.astutils import ModuleContext
from moco_tpu_torch.analysis.engine import (
    analyze_paths,
    discover_baseline,
    iter_rules,
    load_baseline,
    render_json,
    render_sarif,
    render_text,
    write_baseline,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mocolint",
        description="JAX/TPU-aware static analysis for moco-tpu "
        "(impure jitted code, host transfers, PRNG reuse, recompile "
        "hazards, stop_gradient invariants, donation bugs, axis names, "
        "SPMD divergence, mixed-precision hazards, sharding consistency, "
        "input-wire thread hygiene — interprocedural since v2)",
    )
    p.add_argument("paths", nargs="*", default=["moco_tpu_torch"], help="files or directories")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("-o", "--output", default=None, help="write the report to a file")
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--show-suppressed", action="store_true",
        help="include suppressed/baselined findings in text output",
    )
    p.add_argument("--list-rules", action="store_true")
    p.add_argument(
        "--sarif", default=None, metavar="FILE",
        help="also write a SARIF 2.1.0 report to FILE (for GitHub code "
        "scanning); the --format text/json report is unchanged",
    )
    p.add_argument(
        "--dump-contracts", default=None, metavar="FILE",
        help="also write the extracted cross-artifact contract registry "
        "(metric keys, HTTP routes, fault sites, ...) as JSON to FILE",
    )
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="findings baseline to accept (default: auto-discover "
        "mocolint-torch-baseline.json walking up from the analyzed paths)",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline, including an auto-discovered one",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="(re)write the baseline file from this run's findings "
        "instead of failing on them",
    )
    p.add_argument(
        "--changed", metavar="GIT_REF", default=None,
        help="lint only files that differ from GIT_REF (plus untracked "
        "ones) inside the given paths, a fast pre-pass. NOTE: the contract "
        "registry then sees only the changed subset, so the full run "
        "remains the gate; this one just fails earlier",
    )
    return p


def changed_files(ref: str, paths: list[str]) -> list[str]:
    """Python files under `paths` that differ from `ref` (per
    `git diff --name-only`, deletions excluded) or are untracked."""
    import subprocess

    from moco_tpu_torch.analysis.engine import iter_python_files

    def _git(*args: str) -> list[str]:
        out = subprocess.run(
            ["git", *args], capture_output=True, text=True, check=True
        ).stdout
        return [l.strip() for l in out.splitlines() if l.strip()]

    top = _git("rev-parse", "--show-toplevel")[0]
    changed = set(
        _git("diff", "--name-only", "--diff-filter=d", ref, "--")
        + _git("ls-files", "--others", "--exclude-standard")
    )
    import os

    changed_abs = {os.path.normpath(os.path.join(top, c)) for c in changed}
    return [
        f
        for f in iter_python_files(paths)
        if os.path.normpath(os.path.abspath(f)) in changed_abs
    ]


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule_id, summary in iter_rules():
            print(f"{rule_id}  {summary}")
        return 0
    rules = None
    if args.rules:
        rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        known = {rid for rid, _ in iter_rules()}
        unknown = set(rules) - known
        if unknown:
            print(f"mocolint: unknown rule(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2
    paths = args.paths
    if args.changed is not None:
        import subprocess

        try:
            paths = changed_files(args.changed, paths)
        except (subprocess.CalledProcessError, OSError, IndexError) as e:
            print(f"mocolint: cannot resolve --changed {args.changed!r}: {e}",
                  file=sys.stderr)
            return 2
        if not paths:
            print(f"mocolint: no python files changed vs {args.changed}")
            return 0
        print(
            f"mocolint: --changed {args.changed}: linting "
            f"{len(paths)} file(s)"
        )
    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or discover_baseline(args.paths)
    if args.update_baseline:
        findings = analyze_paths(args.paths, rules=rules)
        from moco_tpu_torch.analysis.engine import BASELINE_FILENAME

        target = args.baseline or baseline_path or BASELINE_FILENAME
        n = write_baseline(target, findings)
        print(f"mocolint: baseline written to {target} ({n} fingerprint(s))")
        return 0
    baseline = None
    if baseline_path is not None:
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"mocolint: cannot read baseline {baseline_path}: {e}", file=sys.stderr)
            return 2
    findings = analyze_paths(paths, rules=rules, baseline=baseline)
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as fh:
            fh.write(render_sarif(findings) + "\n")
    if args.dump_contracts:
        import json

        from moco_tpu_torch.analysis import contracts as _contracts
        from moco_tpu_torch.analysis.engine import iter_python_files, parse_module

        contexts = {}
        for path in iter_python_files(paths):
            with open(path, "r", encoding="utf-8") as fh:
                ctx = parse_module(fh.read(), path)
            if not isinstance(ctx, ModuleContext):
                continue  # syntax errors already reported as findings
            contexts[path] = ctx
        registry = _contracts.build_registry(contexts)
        with open(args.dump_contracts, "w", encoding="utf-8") as fh:
            json.dump(registry.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
    report = (
        render_json(findings)
        if args.format == "json"
        else render_text(findings, show_suppressed=args.show_suppressed)
    )
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(report + "\n")
    if args.format == "text" or not args.output:
        print(report)
    return 1 if any(f.active for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
