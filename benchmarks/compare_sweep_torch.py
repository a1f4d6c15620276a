"""Compare a freshly generated ``BENCH_sweep_torch.json`` against the
committed baseline run (``benchmarks/BENCH_sweep_torch.baseline.json``,
regenerated with ``benchmarks.run_torch --quick --only sweep_json
--device cpu`` whenever a change intentionally moves the counts) — the
port's twin of ``benchmarks/compare_sweep.py``, with its own copy of the
framework-free logic.

    PYTHONPATH=src python -m benchmarks.compare_sweep_torch \\
        --baseline benchmarks/BENCH_sweep_torch.baseline.json \\
        --current BENCH_sweep_torch.json

Hard failures (exit 1): a dispatches-per-round increase, a
host-syncs-per-round increase, an arch that disappears (compared
arch-by-arch over the archs present in the baseline; a newly added arch
has no baseline and is reported, not failed), and a contract-analysis
violation recorded in the current run.  The reference's compile-count
and compile-ahead gates have no counterpart: eager PyTorch compiles
nothing.  Timing — seconds and host_blocked_s — is warn-only, and so is
drift of the graph hashes.  When the two runs used different budgets
the counts are not comparable either, so everything but the analysis
downgrades to warnings.

``entries`` restricts the arch comparison to the named entries: a run on
another backend compares only the entries whose ``device_rounds`` are
explicit, since a fleet's default differs per backend (1 on the CPU, 4
on a GPU).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

#: warn when an arch's wall-clock grows beyond this factor
TIME_WARN_RATIO = 1.5


def explicit_entries(record: dict) -> List[str]:
    """The entries of a record whose fleets fixed ``device_rounds``."""
    return [a["arch"] for a in record.get("archs", [])
            if a.get("device_rounds_source") == "explicit"]


def compare(baseline: dict, current: dict,
            entries: Optional[Sequence[str]] = None
            ) -> Tuple[List[str], List[str]]:
    """(failures, warnings) between two ``bench_sweep_json`` records of
    the port, over ``entries`` (every baseline arch when ``None``)."""
    failures: List[str] = []
    warnings: List[str] = []
    comparable = baseline.get("budget") == current.get("budget")
    if not comparable:
        warnings.append(
            f"budgets differ (baseline {baseline.get('budget')} vs "
            f"current {current.get('budget')}): dispatch/sync counts "
            f"are not comparable, downgrading all checks to warnings")
    base_archs: Dict[str, dict] = {a["arch"]: a
                                   for a in baseline.get("archs", [])}
    cur_archs: Dict[str, dict] = {a["arch"]: a
                                  for a in current.get("archs", [])}
    if entries is not None:
        base_archs = {k: v for k, v in base_archs.items() if k in entries}
        cur_archs = {k: v for k, v in cur_archs.items() if k in entries}
    for name in cur_archs:
        if name not in base_archs:
            warnings.append(f"{name}: new arch, no baseline to compare")
    for name, base in base_archs.items():
        sink = failures if comparable else warnings
        cur = cur_archs.get(name)
        if cur is None:
            sink.append(f"{name}: arch disappeared from the sweep")
            continue
        if cur["dispatches_per_round"] > base["dispatches_per_round"]:
            sink.append(
                f"{name}: dispatches/round regressed "
                f"{base['dispatches_per_round']} -> "
                f"{cur['dispatches_per_round']}")
        # a device-resident fleet losing its k-round segments (or a
        # per-round fleet growing extra host round-trips) shows up here
        # even when dispatch counts stay flat
        base_hspr = base.get("host_syncs_per_round")
        cur_hspr = cur.get("host_syncs_per_round")
        if base_hspr is not None and cur_hspr is not None and \
                cur_hspr > base_hspr:
            sink.append(
                f"{name}: host syncs/round regressed "
                f"{base_hspr} -> {cur_hspr}")
        if base.get("seconds") and cur.get("seconds", 0.0) > \
                TIME_WARN_RATIO * base["seconds"]:
            warnings.append(
                f"{name}: {cur['seconds']:.2f}s vs baseline "
                f"{base['seconds']:.2f}s (> {TIME_WARN_RATIO}x, "
                f"warn-only)")
        base_hb = base.get("host_blocked_s")
        cur_hb = cur.get("host_blocked_s", 0.0)
        if base_hb and cur_hb > TIME_WARN_RATIO * base_hb:
            warnings.append(
                f"{name}: host_blocked_s {cur_hb:.4f} vs baseline "
                f"{base_hb:.4f} (> {TIME_WARN_RATIO}x, warn-only)")
    # contract analysis: a violation recorded in the sweep is a hard
    # failure regardless of budget — `python -m repro_torch.analysis`
    # should have caught it, the record carries it as provenance
    cur_an = current.get("analysis")
    if cur_an is not None and cur_an.get("violations", 0) > 0:
        failures.append(
            f"analysis: {cur_an['violations']} contract violation(s) "
            f"recorded in the sweep (run `python -m repro_torch.analysis`)")
    base_h = baseline.get("graph_hashes") or {}
    cur_h = current.get("graph_hashes") or {}
    for fam in sorted(set(base_h) & set(cur_h)):
        if base_h[fam] != cur_h[fam]:
            warnings.append(
                f"graph hash drift for family {fam}: {base_h[fam]} -> "
                f"{cur_h[fam]} (warn-only; expected when a change "
                f"intentionally alters the program or the torch version "
                f"differs)")
    for fam in sorted(set(base_h) - set(cur_h)):
        warnings.append(f"family {fam} disappeared from the graph_hashes "
                        f"record")
    # pipelining (warn-only, it is a timing measure): the pipelined
    # device fleet should spend less host-blocked wall-clock than its
    # unpipelined twin in the SAME run
    pipe = cur_archs.get("cloud_device_k4")
    nopipe = cur_archs.get("cloud_device_k4_unpipelined")
    if pipe is not None and nopipe is not None and \
            pipe.get("host_blocked_s") is not None and \
            pipe["host_blocked_s"] >= nopipe.get("host_blocked_s", 0.0):
        warnings.append(
            f"cloud_device_k4: pipelined host_blocked_s "
            f"{pipe['host_blocked_s']} not below unpipelined "
            f"{nopipe.get('host_blocked_s')} (warn-only)")
    return failures, warnings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True,
                    help="committed BENCH_sweep_torch.baseline.json")
    ap.add_argument("--current", required=True,
                    help="freshly generated sweep record")
    ap.add_argument("--explicit-only", action="store_true",
                    help="compare only the entries with explicit "
                         "device_rounds (a run on another backend)")
    args = ap.parse_args(argv)
    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.current) as f:
        current = json.load(f)
    entries = explicit_entries(baseline) if args.explicit_only else None
    failures, warnings = compare(baseline, current, entries)
    for w in warnings:
        print(f"WARN: {w}")
    for x in failures:
        print(f"FAIL: {x}")
    if failures:
        return 1
    n = len(entries) if entries is not None else \
        len(baseline.get("archs", []))
    print(f"OK: {n} baseline archs compared, no dispatch/sync "
          f"regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
