"""Static analysis of the PyTorch port: machine checks for its
load-bearing contracts, the counterpart of the JAX package's
``repro.analysis``.

Layer 1 — AST contract lint (:mod:`.lint`, :mod:`.rules`): rules R2-R4
walk Python source, R5 reflects over the live plugin registries.

Layer 2 — graph audit (:mod:`.graph_audit`): runs every registered
evaluator family and one generation of a device segment on ``meta``
tensors and traces them op by op on CPU tensors, asserting no host sync,
no float64 outside ``torch_cost._pow``, and one graph per family.

Run both as a gate with ``python -m repro_torch.analysis`` (exit code 1
on any finding).  Suppress a single lint line with
``# repro: noqa-contract(R2)`` — suppressions carry the rule id and are
reviewable in the diff.  The reference's compile-ahead key checks have
no counterpart: the port compiles nothing ahead of a dispatch.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from .lint import (Rule, Violation, default_rules, iter_py_files,
                   lint_file, lint_paths, lint_source)

__all__ = [
    "DEFAULT_ROOTS", "Rule", "Violation", "default_rules", "iter_py_files",
    "lint_file", "lint_paths", "lint_source", "run_report",
]

#: the port's files, relative to the repo root (globs allowed)
DEFAULT_ROOTS = ("src/repro_torch", "benchmarks/*_torch.py",
                 "examples/*_torch.py", "chip_smoke.py")


def default_roots(base: str = ".") -> List[str]:
    """:data:`DEFAULT_ROOTS` under ``base``, globs expanded, existing
    only."""
    import glob
    out: List[str] = []
    for r in DEFAULT_ROOTS:
        out += sorted(glob.glob(os.path.join(base, r)))
    return out


def run_report(roots: Optional[List[str]] = None,
               include_graph: bool = True,
               include_scan: bool = True) -> Dict:
    """Run both analysis layers and return a JSON-ready report:
    ``{"lint": {...}, "graph": {...}, "ok": bool}``.  Shared by the
    ``python -m repro_torch.analysis`` gate, ``chip_smoke.py``'s
    ``analysis`` line and ``benchmarks/run_torch.py`` (which records the
    rule counts and graph hashes into ``BENCH_sweep_torch.json``)."""
    from .rules import ALL_RULES
    from .rules.r5_registry import check_registries

    if roots is None:
        roots = default_roots()

    t0 = time.perf_counter()
    violations = lint_paths(roots)
    violations += check_registries()
    lint_s = time.perf_counter() - t0

    rule_counts = {r.rule_id: 0 for r in ALL_RULES}
    rule_counts["R5"] = 0
    for v in violations:
        rule_counts[v.rule] = rule_counts.get(v.rule, 0) + 1

    report: Dict = {
        "lint": {
            "roots": list(roots),
            "violations": [str(v) for v in violations],
            "rule_counts": rule_counts,
            "seconds": round(lint_s, 3),
        },
    }

    graph_viol: List[Violation] = []
    if include_graph:
        from .graph_audit import audit_families
        t1 = time.perf_counter()
        graph_viol, hashes = audit_families(include_scan=include_scan)
        report["graph"] = {
            "findings": [str(v) for v in graph_viol],
            "hashes": hashes,
            "families": len(hashes),
            "seconds": round(time.perf_counter() - t1, 3),
        }

    report["ok"] = not violations and not graph_viol
    return report
