"""ES operator micro-benchmark and fleet dispatch-sharing checks on the
PyTorch port (``repro_torch``), twin of ``benchmarks/es_ops.py``.  Every
function takes ``device`` (``None`` = the GPU, raising where there is
none; ``"cpu"`` on purpose):

* ``bench_operators`` — throughput (individuals/s) of the vectorized
  host ``mutate`` + ``crossover`` vs the seed per-individual Python
  loops at the paper's pop_size=100, and of the device segment's
  task-axis forms (``es_ops.apply_crossover`` / ``apply_mutation``) on
  ``device``;
* ``bench_stacked_prep`` — dispatch prep of the mega-batch path: the
  stacked-constants cache vs rebuilding the per-row constants every
  round, and a steady ``eval_stacked`` round;
* ``bench_device_rounds`` — k-generation device segments vs the host
  replay of the same plans (bit-identical by construction);
* ``bench_multisearch`` — a 2-workload ``MultiSearch`` against the same
  searches one at a time;
* ``bench_method_sweep`` — a 2-workload x 3-method grid as one stacked
  fleet against the sequential grid.

The reference's claim for the last two is fewer XLA compilations.  Eager
PyTorch compiles nothing, so here it becomes fewer dispatches (evaluator
calls, ``torch_cost.dispatch_count``) with equal best EDPs.

    PYTHONPATH=src python -m benchmarks.es_ops_torch --device cpu
    PYTHONPATH=src python -m benchmarks.run_torch --only es_ops,multisearch
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------- seed reference ops


def _ref_mutate(genomes, spec, rng, p_mut, genes_per, sens, p_high):
    out = genomes.copy()
    L = spec.length
    for i in range(len(out)):
        if rng.random() >= p_mut:
            continue
        if sens is not None:
            seg = sens.high_indices if rng.random() < p_high \
                else sens.low_indices
            if len(seg) == 0:
                seg = np.arange(L)
        else:
            seg = np.arange(L)
        for _ in range(genes_per):
            g = int(seg[rng.integers(0, len(seg))])
            out[i, g] = rng.integers(0, spec.gene_ub[g])
    return out


def _ref_crossover(parents, n_children, spec, rng, sens):
    L = spec.length
    if sens is not None:
        pts = {0, L}
        for a, b in sens.high_segments():
            pts.add(a)
            pts.add(b)
        cut_points = sorted(pts - {0, L}) or [L // 2]
    else:
        cut_points = list(range(1, L))
    kids = np.empty((n_children, L), dtype=parents.dtype)
    for i in range(n_children):
        a, b = rng.integers(0, len(parents), 2)
        cut = cut_points[rng.integers(0, len(cut_points))]
        kids[i, :cut] = parents[a, :cut]
        kids[i, cut:] = parents[b, cut:]
    return kids


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, min_seconds: float = 0.4) -> float:
    """Calls/second of fn()."""
    fn()                                    # warmup
    n = 0
    t0 = time.perf_counter()
    while True:
        fn()
        n += 1
        dt = time.perf_counter() - t0
        if dt >= min_seconds:
            return n / dt


def bench_operators(pop_size: int = 100, workload_name: str = "mm3",
                    device: DeviceLike = None) -> Dict[str, float]:
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import es_ops
    from repro_torch.core.encoding import GenomeSpec
    from repro_torch.core.evolution import crossover, mutate
    from repro_torch.core.sensitivity import SensitivityResult

    device = resolve_device(device)
    wl = by_name(workload_name)
    spec = GenomeSpec(wl)
    high = np.zeros(spec.length, dtype=bool)
    high[spec.segments["perm"].slice] = True
    high[spec.segments["sg"].slice] = True
    sens = SensitivityResult(
        scores=high.astype(np.float64), high_mask=high,
        valid_pool=spec.random_genomes(np.random.default_rng(0), 64),
        threshold=0.75, evals_used=0)

    rng = np.random.default_rng(1)
    pop = spec.random_genomes(rng, pop_size)
    parents = pop[:40]

    def vec_pair():
        kids = crossover(parents, pop_size, spec, rng, sens)
        mutate(kids, spec, rng, 0.9, 2, sens, 0.5)

    def ref_pair():
        kids = _ref_crossover(parents, pop_size, spec, rng, sens)
        _ref_mutate(kids, spec, rng, 0.9, 2, sens, 0.5)

    vec_cps = _time(vec_pair)
    ref_cps = _time(ref_pair)
    out = dict(
        workload=workload_name, pop_size=pop_size, genome_len=spec.length,
        device=str(device),
        vectorized_pairs_per_s=vec_cps * pop_size,
        reference_pairs_per_s=ref_cps * pop_size,
        speedup=vec_cps / ref_cps)
    out["mutate_speedup"] = (
        _time(lambda: mutate(pop, spec, rng, 0.9, 2, sens, 0.5)) /
        _time(lambda: _ref_mutate(pop, spec, rng, 0.9, 2, sens, 0.5)))
    out["crossover_speedup"] = (
        _time(lambda: crossover(parents, pop_size, spec, rng, sens)) /
        _time(lambda: _ref_crossover(parents, pop_size, spec, rng, sens)))

    # the device segment's forms, one task, the same plan every call
    hi, lo = es_ops.mutation_index_tables(spec.length, sens)
    plan = es_ops.plan_generation(
        rng, n_children=pop_size, n_parents=len(parents),
        cut_arr=es_ops.crossover_cut_points(spec.length, sens),
        gene_ub=spec.gene_ub, genes_per=2, p_mut=0.9, p_high=0.5, hi=hi,
        lo=lo)
    t = {k: torch.as_tensor(np.asarray(v)[None], device=device)
         for k, v in dict(parents=parents, ab=plan.ab, cuts=plan.cuts,
                          active=plan.active, gene=plan.gene,
                          vals=plan.vals).items()}

    def dev_pair():
        kids = es_ops.apply_crossover(t["parents"], t["ab"], t["cuts"])
        es_ops.apply_mutation(kids, t["active"], t["gene"], t["vals"])
        _sync(device)

    out["device_pairs_per_s"] = _time(dev_pair) * pop_size
    return out


def bench_stacked_prep(n_tasks: int = 6, rows_per_task: int = 64,
                       rounds: int = 50, device: DeviceLike = None
                       ) -> Dict[str, float]:
    """Dispatch prep of the mega-batch path: ``_stacked_consts`` with the
    per-(fleet, signature) cache vs rebuilt every round, and the time of
    a steady ``eval_stacked`` round (results on the host)."""
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import search, torch_cost
    from repro_torch.core.torch_cost import _pad_batch, _stacked_consts

    device = resolve_device(device)
    search.clear_cache()
    wls = [by_name(n) for n in ("mm1", "mm3")]
    models, batches = [], []
    rng = np.random.default_rng(0)
    for i in range(n_tasks):
        spec, ev = search.get_evaluator(wls[i % len(wls)], "cloud",
                                        device=device)
        models.append(ev)
        batches.append(spec.random_genomes(rng, rows_per_task))
    sizes = [len(b) for b in batches]
    padded = _pad_batch(sum(sizes))

    def cached():
        _stacked_consts(models, sizes, padded, "stacked")
        _sync(device)

    def uncached():
        torch_cost.clear_stack_cache()
        _stacked_consts(models, sizes, padded, "stacked")
        _sync(device)

    cached()                                    # warm the epoch entry
    cached_cps = _time(cached)
    uncached_cps = _time(uncached)

    torch_cost.reset_stack_prep_counts()
    torch_cost.eval_stacked(models, batches)    # warm
    t0 = time.perf_counter()
    for _ in range(rounds):
        torch_cost.eval_stacked(models, batches)
    per_round_s = (time.perf_counter() - t0) / rounds
    hits, misses = torch_cost.stack_prep_counts()
    return dict(
        n_tasks=n_tasks, rows_per_task=rows_per_task, device=str(device),
        cached_preps_per_s=cached_cps, uncached_preps_per_s=uncached_cps,
        prep_speedup=cached_cps / uncached_cps,
        eval_round_seconds=per_round_s,
        prep_hits=hits, prep_misses=misses)


def bench_device_rounds(budget: int = 2000, seed: int = 0,
                        device_rounds: int = 8,
                        device: DeviceLike = None) -> Dict[str, float]:
    """Device segments vs host replay: the SAME pre-drawn operator plans
    executed as k-generation segments (``device_execute=True``) vs
    replayed per generation on the host (``device_execute=False``, one
    dispatch and one host sync per generation).  Results are
    bit-identical by construction, so the deltas are pure host-sync and
    dispatch overhead."""
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import search

    device = resolve_device(device)
    wls = [by_name("mm1"), by_name("mm3")]

    def fleet(execute: bool):
        search.clear_cache()
        stats: Dict = {}
        t0 = time.perf_counter()
        grid = search.run_method_sweep(
            ["sparsemap"], wls, "cloud", budget=budget, seed=seed,
            stack_batches=True, device_rounds=device_rounds,
            device_execute=execute, stats_out=stats, device=device)
        _sync(device)
        dt = time.perf_counter() - t0
        best = {w.name: grid["sparsemap"][w.name].best_edp for w in wls}
        return dt, stats, best

    fused_s, fused_stats, fused_best = fleet(True)
    host_s, host_stats, host_best = fleet(False)
    return dict(
        budget=budget, device_rounds=device_rounds, device=str(device),
        fused_seconds=fused_s, host_seconds=host_s,
        speedup=host_s / fused_s,
        fused_host_syncs=fused_stats["host_syncs"],
        host_host_syncs=host_stats["host_syncs"],
        fused_syncs_per_round=fused_stats["host_syncs_per_round"],
        host_syncs_per_round=host_stats["host_syncs_per_round"],
        fused_dispatches=fused_stats["dispatches"],
        host_dispatches=host_stats["dispatches"],
        edp_exact=all(fused_best[w] == host_best[w] for w in fused_best))


def bench_multisearch(budget: int = 1000, seed: int = 0,
                      device: DeviceLike = None) -> Dict[str, float]:
    """Two workloads of two natural signatures (mm1: prime bucket 16,
    mm4: 32) as one aligned fleet vs one search at a time: dispatches and
    best EDPs."""
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import search, torch_cost

    device = resolve_device(device)
    wls = [by_name("mm1"), by_name("mm4")]

    search.clear_cache()
    t0 = time.perf_counter()
    seq = {w.name: search.run("sparsemap", w, "cloud", budget=budget,
                              seed=seed, device=device) for w in wls}
    seq_s = time.perf_counter() - t0
    seq_dispatches = torch_cost.dispatch_count()

    search.clear_cache()
    t0 = time.perf_counter()
    ms = search.MultiSearch(
        [search.SearchTask(w, "cloud", budget=budget, seed=seed)
         for w in wls], device=device)
    multi = ms.run()
    multi_s = time.perf_counter() - t0

    match = all(
        (not np.isfinite(seq[w.name].best_edp)) or
        abs(np.log10(multi[f"{w.name}@cloud"].best_edp) -
            np.log10(seq[w.name].best_edp)) < 1e-3
        for w in wls)
    return dict(
        budget=budget, device=str(device), seq_dispatches=seq_dispatches,
        multi_dispatches=ms.stats["dispatches"], seq_seconds=seq_s,
        multi_seconds=multi_s, edp_match=match,
        signatures=ms.stats["signatures"],
        natural_signatures=ms.stats["natural_signatures"])


def bench_method_sweep(budget: int = 2000, seed: int = 0,
                       device: DeviceLike = None) -> Dict[str, float]:
    """Sequential fig17-style grid vs one stacked MultiSearch fleet:
    dispatches, wall clock, and exact result parity (at the CPU's default
    of one generation a round; a GPU fleet's k = 4 takes another
    trajectory than ``search.run``, in both packages)."""
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import search, torch_cost

    device = resolve_device(device)
    wls = [by_name("mm1"), by_name("mm3")]      # shared (3, 16) signature
    methods = ["sparsemap", "pso", "random_mapper"]

    search.clear_cache()
    t0 = time.perf_counter()
    seq = {m: {w.name: search.run(m, w, "cloud", budget=budget, seed=seed,
                                  device=device)
               for w in wls} for m in methods}
    seq_s = time.perf_counter() - t0
    seq_dispatches = torch_cost.dispatch_count()

    search.clear_cache()
    stats: Dict = {}
    t0 = time.perf_counter()
    grid = search.run_method_sweep(methods, wls, "cloud", budget=budget,
                                   seed=seed, stack_batches=True,
                                   stats_out=stats, device=device)
    sweep_s = time.perf_counter() - t0

    exact = all(
        seq[m][w.name].best_edp == grid[m][w.name].best_edp and
        np.array_equal(seq[m][w.name].history, grid[m][w.name].history)
        for m in methods for w in wls)
    return dict(
        budget=budget, device=str(device), n_methods=len(methods),
        n_workloads=len(wls), seq_dispatches=seq_dispatches,
        sweep_dispatches=stats["dispatches"], rounds=stats["rounds"],
        dispatches_per_round=stats["dispatches"] / max(stats["rounds"], 1),
        seq_dispatches_per_round=seq_dispatches / max(stats["rounds"], 1),
        device_rounds=stats["device_rounds"],
        seq_seconds=seq_s, sweep_seconds=sweep_s, edp_exact=exact)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    device = ap.parse_args(argv).device
    ops = bench_operators(device=device)
    print(f"es_ops: pop={ops['pop_size']} L={ops['genome_len']} "
          f"({ops['workload']}) — mutate {ops['mutate_speedup']:.1f}x, "
          f"crossover {ops['crossover_speedup']:.1f}x, "
          f"mutate+crossover {ops['speedup']:.1f}x "
          f"({ops['vectorized_pairs_per_s']:.3g} vs "
          f"{ops['reference_pairs_per_s']:.3g} individuals/s); on "
          f"{ops['device']} {ops['device_pairs_per_s']:.3g}")
    sp = bench_stacked_prep(device=device)
    print(f"stacked_prep: {sp['n_tasks']} tasks x {sp['rows_per_task']} "
          f"rows — cached prep {sp['prep_speedup']:.1f}x faster, steady "
          f"round {sp['eval_round_seconds'] * 1e3:.2f}ms, "
          f"hits/misses {sp['prep_hits']}/{sp['prep_misses']}")
    ms = bench_multisearch(device=device)
    print(f"multisearch: dispatches {ms['multi_dispatches']} vs "
          f"sequential {ms['seq_dispatches']}, signatures "
          f"{ms['signatures']} vs {ms['natural_signatures']}, "
          f"edp_match={ms['edp_match']}")
    dr = bench_device_rounds(device=device)
    print(f"device_rounds: k={dr['device_rounds']} — fused "
          f"{dr['fused_seconds']:.1f}s vs host-loop "
          f"{dr['host_seconds']:.1f}s, syncs/round "
          f"{dr['fused_syncs_per_round']:.3f} vs "
          f"{dr['host_syncs_per_round']:.3f}, edp_exact={dr['edp_exact']}")
    sw = bench_method_sweep(device=device)
    print(f"method_sweep: dispatches {sw['sweep_dispatches']} vs "
          f"sequential {sw['seq_dispatches']} "
          f"({sw['dispatches_per_round']:.1f} vs "
          f"{sw['seq_dispatches_per_round']:.1f} per round), "
          f"edp_exact={sw['edp_exact']}")


if __name__ == "__main__":
    main()
