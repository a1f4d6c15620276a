"""Perf hillclimb of three dry-run cells, the counterpart of the JAX
package's ``launch/hillclimb.py``: each variant runs its cell again
through :func:`~repro_torch.launch.dryrun.run_cell` with one change, and
its record (``tag`` names the variant) is written beside the cell's
baseline record (``tag="baseline"``: the sweep's record in
``benchmarks/dryrun_torch.jsonl`` where it has the cell, a fresh run
otherwise).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --jsonl benchmarks/hillclimb_torch.jsonl [--only kimi,commandr,xlstm]

Cells and variants (``train_4k`` on 16x16 each):

* ``kimi-k2-1t-a32b``: ``v1_moe_grouped`` (the grouped dispatch,
  ``moe_n_groups=256``: rank-local groups, each with its own capacity),
  and ``v2_grouped_dots`` (the same with ``remat="dots"``);
* ``command-r-35b``: ``v1_remat_dots`` (keep the products' outputs, do
  not recompute them), and ``v2_dots_embed_dmodel`` (the same with the
  embedding sharded by width);
* ``xlstm-350m``: ``v1_pure_dp`` (nothing tensor-parallel, under
  ``sharding.pure_data_parallel()``: the specs name no "model" and the
  rows go over ("data", "model")); the mapping is restored whatever the
  cell does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import Dict, Optional

DRYRUN_JSONL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "benchmarks", "dryrun_torch.jsonl")


def run_variant(arch: str, shape: str, tag: str, cfg=None,
                pure_dp: bool = False) -> Dict:
    """One variant's record; ``pure_dp`` runs it with the tensor-parallel
    specs off and the rows over ("data", "model")."""
    from ..models import sharding
    from . import dryrun
    with sharding.pure_data_parallel() if pure_dp else \
            contextlib.nullcontext():
        return dryrun.run_cell(arch, shape, multi_pod=False, arch_cfg=cfg,
                               tag=tag)


def baseline(arch: str, shape: str, path: str = DRYRUN_JSONL) -> Dict:
    """The cell's 16x16 record from the sweep's JSONL (the last ``ok``
    one), or a fresh run; tagged ``baseline``."""
    found: Optional[Dict] = None
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if (r.get("arch"), r.get("shape"), r.get("mesh"),
                        r.get("status")) == (arch, shape, "16x16", "ok"):
                    found = r
    if found is None:
        from . import dryrun
        found = dryrun.run_cell(arch, shape, multi_pod=False)
    return dict(found, tag="baseline")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--jsonl", default="bench_out/hillclimb_torch.jsonl")
    ap.add_argument("--only", default=None,
                    help="comma list: kimi,commandr,xlstm")
    args = ap.parse_args(argv)

    from ..configs import get_config
    only = set(args.only.split(",")) if args.only else None
    if os.path.dirname(args.jsonl):
        os.makedirs(os.path.dirname(args.jsonl), exist_ok=True)
    rc = 0

    def emit(rec: Dict) -> None:
        nonlocal rc
        keep = {k: v for k, v in rec.items() if k != "traceback"}
        print(json.dumps(keep), flush=True)
        with open(args.jsonl, "a") as f:
            f.write(json.dumps(keep) + "\n")
        if rec.get("status") != "ok":
            print(rec.get("traceback", "")[-1500:], file=sys.stderr)
            rc = 1

    if only is None or "kimi" in only:
        base = get_config("kimi-k2-1t-a32b")
        emit(baseline("kimi-k2-1t-a32b", "train_4k"))
        emit(run_variant("kimi-k2-1t-a32b", "train_4k", "v1_moe_grouped",
                         cfg=dataclasses.replace(base, moe_grouped=True,
                                                 moe_n_groups=256)))
        emit(run_variant("kimi-k2-1t-a32b", "train_4k", "v2_grouped_dots",
                         cfg=dataclasses.replace(base, moe_grouped=True,
                                                 moe_n_groups=256,
                                                 remat="dots")))
    if only is None or "commandr" in only:
        base = get_config("command-r-35b")
        emit(baseline("command-r-35b", "train_4k"))
        emit(run_variant("command-r-35b", "train_4k", "v1_remat_dots",
                         cfg=dataclasses.replace(base, remat="dots")))
        emit(run_variant("command-r-35b", "train_4k", "v2_dots_embed_dmodel",
                         cfg=dataclasses.replace(base, remat="dots",
                                                 embed_shard="dmodel")))
    if only is None or "xlstm" in only:
        emit(baseline("xlstm-350m", "train_4k"))
        emit(run_variant("xlstm-350m", "train_4k", "v1_pure_dp",
                         pure_dp=True))
    return rc


if __name__ == "__main__":
    sys.exit(main())
