"""CLI: ``python -m celestia_tpu_torch.lint [paths...] [options]``.

The JAX lint's CLI (``celestia_tpu/lint/__main__.py``): the same options
and exit codes, over the port.

Exit status 0 when the tree is clean (every finding suppressed with a
reason), 1 when any finding fails, 2 on usage errors — so `make lint`
and CI can gate on it directly.  ``--format json|sarif`` emits the
machine-readable documents (stable rule ids, file/line/col, suppression
state) under the SAME exit-code contract.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from celestia_tpu_torch.lint.engine import (
    LintStats,
    failing,
    render_human,
    render_json,
    render_sarif,
    resolve_rules,
    run_lint,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m celestia_tpu_torch.lint",
        description="celint: concurrency & determinism static analysis",
    )
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/directories to lint (default: the celestia_tpu_torch package)",
    )
    parser.add_argument(
        "--rules", help="comma-separated rule ids or r1..r8 aliases "
        "(default: all)",
    )
    parser.add_argument(
        "--format", dest="fmt", choices=("human", "json", "sarif"),
        default="human", help="output format (default: human)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="alias for --format json (kept for existing callers)",
    )
    parser.add_argument(
        "--stats", action="store_true",
        help="append per-rule wall-time/finding stats (human prints a "
        "table; json embeds a stats object)",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also print suppressed findings with their reasons",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "--write-lock-hierarchy", action="store_true",
        help="regenerate specs/lock_hierarchy_torch.md from the R6 lock graph "
        "and exit (0 on success)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in resolve_rules(None):
            print(f"{rule.id}: {rule.summary}")
            if rule.doc:
                print(f"    {rule.doc}")
        return 0

    if args.write_lock_hierarchy:
        from celestia_tpu_torch.lint.lockorder import write_lock_hierarchy

        path = write_lock_hierarchy()
        print(f"wrote {path}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
    fmt = "json" if args.json else args.fmt
    stats = LintStats() if args.stats else None
    try:
        findings = run_lint(args.paths or None, rule_ids, stats=stats)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if fmt == "json":
        print(render_json(findings, stats=stats))
    elif fmt == "sarif":
        print(render_sarif(findings))
        if stats is not None:
            # the SARIF document has no stats slot; keep stdout a clean
            # parseable document and put the table on stderr
            _print_stats(stats, sys.stderr)
    else:
        print(render_human(findings, show_suppressed=args.show_suppressed))
        if stats is not None:
            _print_stats(stats, sys.stdout)
    return 1 if failing(findings) else 0


def _print_stats(stats: LintStats, out) -> None:
    d = stats.to_dict()
    print(f"stats: {d['files']} file(s) in {d['total_wall_ms']:.0f} ms", file=out)
    for rid, rec in d["rules"].items():
        print(
            f"  {rid}: {rec['wall_ms']:.0f} ms, "
            f"{rec['findings']} finding(s), "
            f"{rec['suppressed']} suppressed",
            file=out,
        )


if __name__ == "__main__":
    sys.exit(main())
