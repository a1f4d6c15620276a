"""The paper's tables and figures on the PyTorch port (``repro_torch``),
twin of ``benchmarks/paper_tables.py``.

Each function takes the reference's arguments plus ``device`` (``None`` =
the GPU, raising where there is none; ``"cpu"`` on purpose), computes the
same rows by the same route — ``table_iv`` one ``search.run`` at a time,
``fig17_baselines`` and ``fig18_ablation`` as one ``run_method_sweep``
fleet with ``concurrent=True`` — and writes the same CSV names and
headers under ``OUT_DIR``: ``$REPRO_BENCH_OUT/torch`` (default
``bench_out/torch``), so the reference's CSVs are never overwritten.

    PYTHONPATH=src python -c "from benchmarks import paper_tables_torch as t; \\
        print(t.table_iv(budget=20000, workload_names=['mm1']))"
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.configs.paper_workloads import all_workloads, by_name
from repro_torch.core import accel, search
from repro_torch.core.workload import spmm
from repro_torch.device import DeviceLike, resolve_device

OUT_DIR = os.path.join(os.environ.get("REPRO_BENCH_OUT", "bench_out"),
                       "torch")


def _write_csv(name: str, header: Sequence[str], rows: List[Sequence]):
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


# ----------------------------------------------------------- Fig. 17


def fig17_baselines(budget: int = 1500, seeds: Sequence[int] = (0,),
                    workload_names: Sequence[str] = ("conv2", "conv4",
                                                     "conv5", "conv7"),
                    platform: str = "cloud",
                    concurrent: bool = True,
                    device: DeviceLike = None) -> List[Dict]:
    """Fig. 17(a)/(b): SparseMap vs classical optimizers on pruned-VGG16
    layers (EDP + valid-point fraction under the same budget).

    With ``concurrent=True`` (default) the whole grid runs as ONE
    mega-batched ``search.run_method_sweep`` fleet per seed, one device
    dispatch per signature per round instead of one per (method,
    workload).  Its results equal the sequential path's at one generation
    a round (the CPU's default); on a GPU the fleet's default of k = 4
    generations a device segment takes another trajectory, as in the
    reference."""
    device = resolve_device(device)
    methods = ["sparsemap", "pso", "mcts", "tbpsa", "ppo", "dqn"]
    wls = [by_name(n) for n in workload_names]
    results: Dict[str, Dict[str, List]] = \
        {m: {w.name: [] for w in wls} for m in methods}
    t0 = time.time()
    for seed in seeds:
        if concurrent:
            grid = search.run_method_sweep(methods, wls, platform,
                                           budget=budget, seed=seed,
                                           device=device)
            for m in methods:
                for w in wls:
                    results[m][w.name].append(grid[m][w.name])
        else:
            for m in methods:
                for w in wls:
                    results[m][w.name].append(
                        search.run(m, w, platform, budget=budget,
                                   seed=seed, device=device))
    grid_seconds = round(time.time() - t0, 1)
    rows, out = [], []
    for wname in workload_names:
        for method in methods:
            rs = results[method][wname]
            rec = dict(workload=wname, method=method,
                       edp=float(np.min([r.best_edp for r in rs])),
                       valid_frac=float(np.mean([r.valid_fraction
                                                 for r in rs])),
                       budget=budget, grid_seconds=grid_seconds)
            out.append(rec)
            rows.append([wname, method, rec["edp"], rec["valid_frac"],
                         budget])
    _write_csv("fig17.csv",
               ["workload", "method", "best_edp", "valid_frac", "budget"],
               rows)
    return out


# ----------------------------------------------------------- Table IV

TABLE_IV_METHODS = ("random_mapper", "sage_like", "sparsemap")


def table_iv_row(workload: str, platform: str, edps: Dict[str, float]
                 ) -> Dict:
    """One Table IV record from each method's best EDP (what
    ``table_iv`` returns per row; ``chip_smoke.py`` builds the rows of a
    fleet with it)."""
    rec = dict(workload=workload, platform=platform)
    for method in TABLE_IV_METHODS:
        rec[method] = edps[method]
    rec["speedup_vs_sparseloop"] = (
        rec["random_mapper"] / rec["sparsemap"]
        if np.isfinite(rec["sparsemap"]) else float("nan"))
    rec["speedup_vs_sage"] = (
        rec["sage_like"] / rec["sparsemap"]
        if np.isfinite(rec["sparsemap"]) else float("nan"))
    return rec


def table_iv(budget: int = 1500, seed: int = 0,
             platforms: Sequence[str] = ("edge", "mobile", "cloud"),
             workload_names: Sequence[str] = None,
             device: DeviceLike = None) -> List[Dict]:
    """Table IV: ours vs Sparseloop-Mapper-like vs SAGE-like across the
    28 workloads x 3 platforms."""
    device = resolve_device(device)
    wls = all_workloads() if workload_names is None else \
        [by_name(n) for n in workload_names]
    rows, out = [], []
    for wl in wls:
        for plat in platforms:
            edps = {method: search.run(method, wl, plat, budget=budget,
                                       seed=seed, device=device).best_edp
                    for method in TABLE_IV_METHODS}
            rec = table_iv_row(wl.name, plat, edps)
            out.append(rec)
            rows.append([wl.name, plat, rec["random_mapper"],
                         rec["sage_like"], rec["sparsemap"],
                         rec["speedup_vs_sparseloop"],
                         rec["speedup_vs_sage"]])
    _write_csv("table_iv.csv",
               ["workload", "platform", "sparseloop_like", "sage_like",
                "sparsemap", "speedup_vs_sparseloop", "speedup_vs_sage"],
               rows)
    return out


# ----------------------------------------------------------- Fig. 18


def fig18_ablation(budget: int = 3000, seed: int = 0,
                   workload_names: Sequence[str] = ("mm3", "conv4"),
                   platform: str = "cloud",
                   concurrent: bool = True,
                   device: DeviceLike = None) -> List[Dict]:
    """Fig. 18: standard ES (direct encoding) vs +PFCE vs full SparseMap
    (+CEOI); convergence curves to CSV.

    All three curves — including the direct-encoding ``standard_es``,
    whose generator yields canonical rows — run as ONE mega-batched
    ``run_method_sweep`` fleet by default; at one generation a round (the
    CPU's default) the results are those of the sequential path, and on a
    GPU the fleet's k = 4 device segments take another trajectory, as in
    the reference."""
    device = resolve_device(device)
    methods = ["standard_es", "pfce_es", "sparsemap"]
    wls = [by_name(n) for n in workload_names]
    if concurrent:
        grid = search.run_method_sweep(methods, wls, platform,
                                       budget=budget, seed=seed,
                                       device=device)
        results = {(m, w.name): grid[m][w.name]
                   for m in methods for w in wls}
    else:
        results = {(m, w.name): search.run(m, w, platform, budget=budget,
                                           seed=seed, device=device)
                   for m in methods for w in wls}
    rows, out = [], []
    for wname in workload_names:
        for method in methods:
            res = results[(method, wname)]
            # subsample history to 100 points
            h = res.history
            idx = np.linspace(0, len(h) - 1, 100).astype(int)
            for i in idx:
                rows.append([wname, method, int(i), h[i]])
            out.append(dict(workload=wname, method=method,
                            best_edp=res.best_edp,
                            valid_frac=res.valid_fraction))
    _write_csv("fig18.csv", ["workload", "method", "eval", "best_edp"],
               rows)
    return out


# ----------------------------------------------------------- Fig. 2


def fig2_interaction(platform: str = "mobile",
                     device: DeviceLike = None) -> List[Dict]:
    """Fig. 2: no single (mapping x format) wins across sparsity — we
    sweep OS/IS mappings x {CSR-like, RLE} formats over densities.

    The float64 numpy cost model computes every point on the host, in
    both packages; ``device`` is resolved all the same, so this function
    refuses a machine without a card as its siblings do."""
    from repro_torch.core.cost_model import (Design, evaluate,
                                             make_tensor_format)
    from repro_torch.core.mapping import Mapping, balanced_mapping
    from repro_torch.core.sparse import SparseStrategy

    resolve_device(device)
    plat = accel.PLATFORMS[platform]
    rows, out = [], []
    for dens in (0.05, 0.1, 0.2, 0.4, 0.8):
        wl = spmm(f"fig2_d{dens}", 256, 512, 256, dens, dens)
        for mapping_name in ("OS", "IS"):
            mp = balanced_mapping(wl, plat.n_pe, plat.macs_per_pe)
            if mapping_name == "IS":
                # input stationary: move contraction dims outermost
                perms = tuple(
                    tuple(reversed(p)) for p in mp.perms)
                mp = Mapping(workload=wl, factors=mp.factors, perms=perms)
            for fmt_name, genes in (("CSR", (0, 0, 0, 4, 3)),
                                    ("RLE", (0, 0, 0, 0, 2))):
                fmts = {t.name: make_tensor_format(mp, t.name, genes)
                        for t in wl.tensors}
                fmts["Z"] = make_tensor_format(mp, "Z", (0, 0, 0, 0, 0))
                st = SparseStrategy(formats=fmts,
                                    sg={"L2": 0, "L3": 0, "C": 3})
                rep = evaluate(Design(mp, st), plat)
                rec = dict(density=dens, mapping=mapping_name,
                           fmt=fmt_name, valid=rep.valid,
                           edp=rep.edp if rep.valid else float("inf"),
                           latency=rep.cycles if rep.valid else
                           float("inf"),
                           energy=rep.energy_pj if rep.valid else
                           float("inf"))
                out.append(rec)
                rows.append([dens, mapping_name, fmt_name, rep.valid,
                             rec["edp"], rec["latency"], rec["energy"]])
    _write_csv("fig2.csv", ["density", "mapping", "format", "valid",
                            "edp", "latency_cycles", "energy_pj"], rows)
    return out


# ----------------------------------------------------------- Fig. 7


def fig7_space(n_samples: int = 1000, platform: str = "cloud",
               seed: int = 0, device: DeviceLike = None) -> Dict:
    """Fig. 7: random design points; valid points are a small colored
    island in a sea of invalid ones.  PCA over mapping/sparse gene
    blocks reproduces the scatter structure."""
    wl = by_name("mm3")
    spec, ev = search.get_evaluator(wl, platform, device=device)
    rng = np.random.default_rng(seed)
    G = spec.random_genomes(rng, n_samples)
    res = ev(G)
    valid = np.asarray(res["valid"])
    edp = np.asarray(res["edp"])

    def pca1(block: np.ndarray) -> np.ndarray:
        x = block.astype(np.float64)
        x = (x - x.mean(0)) / (x.std(0) + 1e-9)
        cov = x.T @ x / len(x)
        w, v = np.linalg.eigh(cov)
        return x @ v[:, -1]

    map_end = spec.segments["tiling"].stop
    xs = pca1(G[:, :map_end])
    ys = pca1(G[:, map_end:])
    rows = [[xs[i], ys[i], bool(valid[i]),
             edp[i] if valid[i] else ""] for i in range(n_samples)]
    _write_csv("fig7.csv", ["pca_mapping", "pca_sparse", "valid", "edp"],
               rows)
    return dict(n=n_samples, valid_frac=float(valid.mean()))
