"""Roofline table from the port's dry-run JSONL, the counterpart of
``benchmarks/roofline.py`` (framework-free, as that one is).

Reads ``benchmarks/dryrun_torch.jsonl`` (written by
``python -m repro_torch.launch.sweep`` / ``repro_torch.launch.dryrun``;
a path given on the command line overrides it) and emits, per (arch x
shape) cell of each mesh, the three roofline terms with the dominant
bottleneck, the model's 6·N·D FLOPs over the FLOPs the dry-run counted,
the state a rank holds and the seconds the cell took (build and run), as
a markdown table under ``REPRO_BENCH_OUT`` (``bench_out/`` by default):

    PYTHONPATH=src python -m benchmarks.roofline_torch [path.jsonl]

The terms are the dry-run's counts over ``accel.H100_SXM``'s published
peaks (dense bf16 FLOP/s, HBM bytes/s, NVLink or inter-node link bytes/s),
not times measured on a card.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

OUT_DIR = os.environ.get("REPRO_BENCH_OUT", "bench_out")
DEFAULT_JSONL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "dryrun_torch.jsonl")


def load(path: Optional[str] = None) -> List[Dict]:
    """One record per (arch, shape, mesh): an ``ok`` or ``skipped`` record
    replaces what came before it (reruns after fixes), an error only
    stands where nothing else does."""
    path = path or DEFAULT_JSONL
    recs = {}
    if not os.path.exists(path):
        return []
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (r.get("arch"), r.get("shape"), r.get("mesh"))
            if r.get("status") in ("ok", "skipped") or key not in recs:
                recs[key] = r
    return list(recs.values())


def table(recs: List[Dict], mesh: str = "16x16") -> List[Dict]:
    rows = []
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append(dict(arch=r["arch"], shape=r["shape"],
                             status="skipped", reason=r.get("reason", "")))
            continue
        if r.get("status") != "ok":
            rows.append(dict(arch=r["arch"], shape=r["shape"],
                             status="error", reason=r.get("error", "")))
            continue
        terms = dict(compute=r["t_compute_s"], memory=r["t_memory_s"],
                     collective=r["t_collective_s"])
        dom = max(terms, key=terms.get)
        t_bound = max(terms.values())
        frac = terms["compute"] / t_bound if t_bound > 0 else 0.0
        rows.append(dict(
            arch=r["arch"], shape=r["shape"], status="ok",
            t_compute_s=r["t_compute_s"], t_memory_s=r["t_memory_s"],
            t_collective_s=r["t_collective_s"], bottleneck=dom,
            roofline_fraction=frac,
            useful_flops_ratio=r.get("useful_flops_ratio", 0.0),
            state_gb=r.get("state_bytes_per_device", 0) / 1e9,
            seconds=r.get("build_s", 0) + r.get("run_s", 0)))
    return rows


def markdown(rows: List[Dict]) -> str:
    out = ["| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bottleneck | comp/roof | 6ND/counted | state GB/dev | "
           "build_s + run_s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r['status']}: {r.get('reason', '')[:60]} | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3g} | "
            f"{r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} | "
            f"**{r['bottleneck']}** | {r['roofline_fraction']:.2f} | "
            f"{r['useful_flops_ratio']:.2f} | {r['state_gb']:.1f} | "
            f"{r['seconds']:.1f} |")
    return "\n".join(out)


def main(path: Optional[str] = None) -> List[Dict]:
    recs = load(path)
    ok = [r for r in recs if r.get("status") == "ok"]
    sk = [r for r in recs if r.get("status") == "skipped"]
    print(f"dryrun records: {len(recs)} ({len(ok)} ok, {len(sk)} skipped)")
    os.makedirs(OUT_DIR, exist_ok=True)
    for mesh in ("16x16", "2x16x16"):
        rows = table(recs, mesh)
        name = f"roofline_torch_{mesh.replace('x', '_')}.md"
        out = os.path.join(OUT_DIR, name)
        with open(out, "w") as f:
            f.write(markdown(rows) + "\n")
        print(f"wrote {out} ({len(rows)} rows)")
    return recs


if __name__ == "__main__":
    main(*sys.argv[1:2])
