"""``python -m repro_torch.analysis`` — the port's contract gate.

Runs the AST contract lint (rules R2-R5) over the port's files and the
graph audit over every registered evaluator family, prints each finding
as ``path:line: [RULE] message``, and exits non-zero if anything fired.
There is deliberately no ``--fix``: every violation is either a real
contract breach (fix the code) or a reviewed exception (annotate the
line with ``# repro: noqa-contract(RULE)``).
"""
from __future__ import annotations

import argparse
import sys

from . import DEFAULT_ROOTS, run_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="SparseMap port contract linter + graph auditor")
    ap.add_argument("roots", nargs="*", default=None,
                    help=f"source roots to lint (default: "
                         f"{' '.join(DEFAULT_ROOTS)}, existing only)")
    ap.add_argument("--skip-graph", action="store_true",
                    help="lint layer only (no program runs; fast)")
    ap.add_argument("--no-scan", action="store_true",
                    help="audit the row evaluators but skip the segment "
                         "programs (quicker)")
    args = ap.parse_args(argv)

    report = run_report(roots=args.roots or None,
                        include_graph=not args.skip_graph,
                        include_scan=not args.no_scan)

    for line in report["lint"]["violations"]:
        print(line)
    gr = report.get("graph")
    if gr:
        for line in gr["findings"]:
            print(line)

    n_lint = len(report["lint"]["violations"])
    counts = ", ".join(f"{k}={v}" for k, v in
                       sorted(report["lint"]["rule_counts"].items()))
    print(f"analysis: lint {n_lint} violation(s) [{counts}] in "
          f"{report['lint']['seconds']}s", file=sys.stderr)
    if gr:
        print(f"analysis: graph {len(gr['findings'])} finding(s) across "
              f"{gr['families']} families in {gr['seconds']}s",
              file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
