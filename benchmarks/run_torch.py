"""Benchmark harness of the PyTorch port, twin of ``benchmarks/run.py``:
one benchmark per paper table/figure and per fleet mechanism.  Prints
``name,seconds,derived`` CSV lines.

    PYTHONPATH=src python -m benchmarks.run_torch [--budget N] [--quick]
        [--full] [--only a,b] [--device cpu|cuda]

``--only sweep_json`` (also run by default) writes the machine-readable
``BENCH_sweep_torch.json`` (path: ``$REPRO_BENCH_SWEEP_JSON_TORCH``) —
dispatches and host syncs per round, per-topology pad-watermark
trajectories, best EDP per method x workload x arch, the contract
analysis and the graph hash of every evaluator family — which
``benchmarks.compare_sweep_torch`` gates against the committed
``benchmarks/BENCH_sweep_torch.baseline.json``.  The reference's record
also has ``compiles`` and ``compile_ahead_*``; they have no eager
meaning and are left out.  ``roofline`` tabulates the production-mesh
dry-run's records (``benchmarks/roofline_torch.py`` on
``benchmarks/dryrun_torch.jsonl``) and prints its summary line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep_json_path() -> str:
    return os.environ.get("REPRO_BENCH_SWEEP_JSON_TORCH",
                          "BENCH_sweep_torch.json")


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def bench_sweep_json(budget: int, out_path: str = None,
                     device: DeviceLike = None) -> dict:
    """One stacked ``run_method_sweep`` fleet per registered arch, one
    structured-density fleet (the 2:4 BlockNM family + a banded
    attention workload + a uniform control as ONE signature), the
    device-resident fleet at k = 4 (sharded over every visible device by
    ``make_search_mesh``) with and without pipelining, and a sweep
    server's coalescing of two concurrent clients; the per-cell best
    EDPs, fleet-level dispatch and sync counts, the contract analysis and
    the graph hashes land in ``out_path`` as JSON."""
    from repro_torch.analysis import default_roots, run_report
    from repro_torch.configs.paper_workloads import (
        banded_attention_workloads, by_name)
    from repro_torch.core import search
    from repro_torch.launch import sweep_serve
    from repro_torch.launch.mesh import make_search_mesh

    device = resolve_device(device)
    out_path = out_path or sweep_json_path()
    methods = ["sparsemap", "random_mapper", "pso"]
    wls = [by_name(n) for n in ("mm1", "mm3")]
    archs = ["cloud", "maple_edge", "cluster_cloud", "systolic_mesh",
             "quant_edge", "eyeriss_like", "sigma_like", "dstc_like"]
    record = dict(budget=budget, device=str(device), methods=methods,
                  workloads=[w.name for w in wls], archs=[], cells=[])

    def run_fleet(entry_name, fleet_methods, fleet_wls, arch,
                  fleet_budget=None, **fleet_kw):
        search.clear_cache()
        stats: dict = {}
        t0 = time.perf_counter()
        config = search.FleetConfig(stack_batches=True, **fleet_kw)
        grid = search.run_method_sweep(fleet_methods, fleet_wls, arch,
                                       budget=fleet_budget or budget,
                                       seed=0, stats_out=stats,
                                       config=config, device=device)
        _sync(device)
        seconds = round(time.perf_counter() - t0, 2)
        record["archs"].append(dict(
            arch=entry_name, seconds=seconds,
            budget=fleet_budget or budget,
            rounds=stats["rounds"], dispatches=stats["dispatches"],
            dispatches_per_round=round(
                stats["dispatches"] / max(stats["rounds"], 1), 3),
            seconds_per_round=round(seconds / max(stats["rounds"], 1), 4),
            # host round-trips per search generation: 1.0 for per-round
            # fleets, ~1/k in the segment phase of device_rounds=k fleets
            host_syncs=stats["host_syncs"],
            host_syncs_per_round=round(stats["host_syncs_per_round"], 3),
            device_rounds=stats["device_rounds"],
            device_rounds_source=stats["device_rounds_source"],
            host_blocked_s=round(stats["host_blocked_s"], 4),
            pipeline=stats["pipeline"],
            n_devices=stats["devices"],
            signatures=[list(s) for s in stats["signatures"]],
            pad_watermarks=stats.get("pad_watermarks", {}),
            pad_policies=stats.get("pad_policies", {})))
        for m in fleet_methods:
            for w in fleet_wls:
                r = grid[m][w.name]
                record["cells"].append(dict(
                    arch=entry_name, method=m, workload=w.name,
                    best_edp=(float(r.best_edp)
                              if np.isfinite(r.best_edp) else None),
                    evals=int(r.evals), valid_evals=int(r.valid_evals)))

    for arch in archs:
        run_fleet(arch, methods, wls, arch)

    # structured-density mixed fleet on the paper arch: density-mode
    # alignment promotes the whole group onto the structured evaluator,
    # so it holds ONE signature (1.0 dispatches/round)
    struct_wls = ([by_name(n) for n in ("mm1", "mm8", "mm9", "mm10")] +
                  banded_attention_workloads()[:1])
    run_fleet("structured_cloud", ["sparsemap", "random_mapper"],
              struct_wls, "cloud")

    # device-resident fleet on the paper arch: k = 4 generations a
    # segment (host_syncs_per_round tracks the segment phase's sync
    # ratio); sharded when more than one device is visible.  The budget
    # floor gets past the host-driven calibration/HSHI prologue into the
    # segment phase even under --quick
    mesh = make_search_mesh(device=device)
    run_fleet("cloud_device_k4", ["sparsemap"], wls, "cloud",
              fleet_budget=max(budget, 2000), device_rounds=4, mesh=mesh)
    run_fleet("cloud_device_k4_unpipelined", ["sparsemap"], wls, "cloud",
              fleet_budget=max(budget, 2000), device_rounds=4, mesh=mesh,
              pipeline=False)

    # search-as-a-service coalescing: one in-process sweep server serves
    # a single-client epoch, then TWO concurrent same-signature clients;
    # the pair must hold 1.0 dispatches/round (one mega-batch)
    search.clear_cache()
    serve_budget = min(budget, 600)
    srv = sweep_serve.SweepServer(
        port=0, config=search.FleetConfig(stack_batches=True,
                                          device_rounds=1), device=device)
    srv.start_background()
    t0 = time.perf_counter()

    def serve_task(name, seed):
        return search.SearchTask(wls[0], "cloud", budget=serve_budget,
                                 seed=seed, name=name)

    try:
        list(sweep_serve.submit(srv.host, srv.port,
                                serve_task("serve_single", 0)))
        clients = [threading.Thread(
            target=lambda nm, sd: list(sweep_serve.submit(
                srv.host, srv.port, serve_task(nm, sd))),
            args=(f"serve_pair_{i}", i + 1)) for i in range(2)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        if any(th.is_alive() for th in clients):
            raise RuntimeError("a sweep client did not finish in 600 s")
        st = next(iter(sweep_serve.request(srv.host, srv.port,
                                           {"op": "stats"})))["stats"]
    finally:
        srv.stop()
    fleet = st["fleet"]
    record["archs"].append(dict(
        arch="serve_coalesce", seconds=round(time.perf_counter() - t0, 2),
        budget=serve_budget,
        rounds=fleet["rounds"], dispatches=fleet["dispatches"],
        dispatches_per_round=round(
            fleet["dispatches"] / max(fleet["rounds"], 1), 3),
        host_syncs_per_round=round(fleet["host_syncs_per_round"], 3),
        device_rounds=1, device_rounds_source="explicit",
        # largest same-signature group any epoch held (2 = the pair
        # coalesced; recorded, not gated: admission timing can split the
        # pair across epochs on a loaded machine)
        coalesced_group_size=max(
            (max(g.values()) for g in st["epoch_signature_groups"] if g),
            default=0),
        queries=st["queries"], completed=st["completed"],
        warm_started=st["warm_started"],
        pad_watermarks=fleet.get("pad_watermarks", {}),
        pad_policies=fleet.get("pad_policies", {})))

    # contract analysis: lint wall time and per-rule counts, and the
    # canonical graph hash of every evaluator family (compare_sweep_torch
    # fails recorded violations; hash drift is warn-only)
    rep = run_report(roots=default_roots(ROOT), include_graph=True,
                     include_scan=False)
    record["analysis"] = dict(
        lint_seconds=rep["lint"]["seconds"],
        graph_seconds=rep["graph"]["seconds"],
        rule_counts=rep["lint"]["rule_counts"],
        violations=(len(rep["lint"]["violations"])
                    + len(rep["graph"]["findings"])))
    record["graph_hashes"] = rep["graph"]["hashes"]

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--quick", action="store_true",
                    help="minimal budgets (CI)")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale budgets (20k evals/workload)")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset: fig2,fig7,fig17,fig18,"
                         "table_iv,roofline,arch_dse,es_ops,stacked_prep,"
                         "multisearch,method_sweep,device_rounds,"
                         "sweep_json")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    budget = args.budget or (300 if args.quick else
                             20000 if args.full else 10000)
    only = set(args.only.split(",")) if args.only else None
    # the roofline table reads records and needs no device
    device = None if only == {"roofline"} else resolve_device(args.device)

    from benchmarks import es_ops_torch as es_ops
    from benchmarks import paper_tables_torch as paper_tables

    def want(name):
        return only is None or name in only

    print("name,seconds,derived")

    if want("es_ops"):
        t0 = time.time()
        ops = es_ops.bench_operators(pop_size=100, device=device)
        print(f"es_ops,{time.time()-t0:.1f},"
              f"mutate_speedup={ops['mutate_speedup']:.1f}x;"
              f"crossover_speedup={ops['crossover_speedup']:.1f}x;"
              f"combined_speedup={ops['speedup']:.1f}x;"
              f"device_pairs_per_s={ops['device_pairs_per_s']:.3g}")

    if want("device_rounds"):
        t0 = time.time()
        dr = es_ops.bench_device_rounds(
            budget=min(max(budget, 1200), 2000), device=device)
        print(f"device_rounds,{time.time()-t0:.1f},"
              f"k={dr['device_rounds']};"
              f"fused_vs_host_speedup={dr['speedup']:.2f}x;"
              f"syncs_per_round={dr['fused_syncs_per_round']:.3f}"
              f"_vs_{dr['host_syncs_per_round']:.3f};"
              f"edp_exact={dr['edp_exact']}")

    if want("stacked_prep"):
        t0 = time.time()
        sp = es_ops.bench_stacked_prep(device=device)
        print(f"stacked_prep,{time.time()-t0:.1f},"
              f"prep_speedup={sp['prep_speedup']:.1f}x;"
              f"round_ms={sp['eval_round_seconds']*1e3:.2f}")

    if want("sweep_json"):
        t0 = time.time()
        rec = bench_sweep_json(budget=min(budget, 1000), device=device)
        dpr = ";".join(f"{a['arch']}={a['dispatches_per_round']}"
                       for a in rec["archs"])
        print(f"sweep_json,{time.time()-t0:.1f},"
              f"path={sweep_json_path()};dispatches_per_round={dpr}")

    if want("multisearch"):
        t0 = time.time()
        ms = es_ops.bench_multisearch(budget=min(budget, 2000),
                                      device=device)
        print(f"multisearch,{time.time()-t0:.1f},"
              f"dispatches={ms['multi_dispatches']}_vs_seq_"
              f"{ms['seq_dispatches']};edp_match={ms['edp_match']}")

    if want("method_sweep"):
        t0 = time.time()
        sw = es_ops.bench_method_sweep(budget=min(budget, 2000),
                                       device=device)
        print(f"method_sweep,{time.time()-t0:.1f},"
              f"dispatches={sw['sweep_dispatches']}_vs_seq_"
              f"{sw['seq_dispatches']};"
              f"dispatches_per_round={sw['dispatches_per_round']:.1f}"
              f"_vs_seq_{sw['seq_dispatches_per_round']:.1f};"
              f"edp_exact={sw['edp_exact']}")

    if want("fig2"):
        t0 = time.time()
        rows = paper_tables.fig2_interaction(device=device)
        # does the best (mapping, fmt) change across densities?
        best = {}
        for r in rows:
            if not r["valid"]:
                continue
            key = r["density"]
            if key not in best or r["edp"] < best[key][1]:
                best[key] = ((r["mapping"], r["fmt"]), r["edp"])
        winners = {v[0] for v in best.values()}
        print(f"fig2_interaction,{time.time()-t0:.1f},"
              f"distinct_winners={len(winners)}")

    if want("fig7"):
        t0 = time.time()
        info = paper_tables.fig7_space(n_samples=1000, device=device)
        print(f"fig7_space,{time.time()-t0:.1f},"
              f"valid_frac={info['valid_frac']:.4f}")

    if want("fig17"):
        t0 = time.time()
        wl_names = ("conv2", "conv4") if args.quick else \
            ("conv2", "conv4", "conv5", "conv7")
        out = paper_tables.fig17_baselines(budget=budget,
                                           workload_names=wl_names,
                                           device=device)
        ours = {r["workload"]: r["edp"] for r in out
                if r["method"] == "sparsemap"}
        ratios = []
        for w, o in ours.items():
            b = min(r["edp"] for r in out
                    if r["workload"] == w and r["method"] != "sparsemap")
            if np.isfinite(b) and np.isfinite(o) and o > 0:
                ratios.append(b / o)
        gm = float(np.exp(np.mean(np.log(ratios)))) if ratios else 0.0
        print(f"fig17_baselines,{time.time()-t0:.1f},"
              f"geomean_best_baseline_over_ours={gm:.2f}x")

    if want("fig18"):
        t0 = time.time()
        out = paper_tables.fig18_ablation(budget=max(budget, 2000),
                                          device=device)
        summary = {(r["workload"], r["method"]): r["best_edp"]
                   for r in out}
        ok = all(
            summary[(w, "sparsemap")] <= summary[(w, "pfce_es")] * 1.5
            for w in ("mm3", "conv4"))
        print(f"fig18_ablation,{time.time()-t0:.1f},ordering_holds={ok}")

    if want("table_iv"):
        t0 = time.time()
        wl_names = ["mm1", "mm3", "conv2", "conv4"] if args.quick else None
        out = paper_tables.table_iv(budget=budget, workload_names=wl_names,
                                    device=device)
        sp = [r["speedup_vs_sparseloop"] for r in out
              if np.isfinite(r.get("speedup_vs_sparseloop", np.nan))]
        sg = [r["speedup_vs_sage"] for r in out
              if np.isfinite(r.get("speedup_vs_sage", np.nan))]
        gm_sp = float(np.exp(np.mean(np.log(np.maximum(sp, 1e-9))))) \
            if sp else 0.0
        gm_sg = float(np.exp(np.mean(np.log(np.maximum(sg, 1e-9))))) \
            if sg else 0.0
        print(f"table_iv,{time.time()-t0:.1f},"
              f"geomean_edp_reduction_vs_sparseloop={gm_sp:.2f}x;"
              f"vs_sage={gm_sg:.2f}x")

    if want("arch_dse"):
        t0 = time.time()
        from repro_torch.configs.paper_workloads import arch_gemms
        from repro_torch.core import search as search_lib
        rows = []
        for arch in ("mistral-nemo-12b", "kimi-k2-1t-a32b"):
            for wl in arch_gemms(arch)[:2]:
                res = search_lib.run("sparsemap", wl, "cloud",
                                     budget=budget, seed=0, device=device)
                rows.append((wl.name, res.best_edp))
        print(f"arch_dse,{time.time()-t0:.1f},"
              f"searched={len(rows)}_arch_gemms")

    if want("roofline"):
        t0 = time.time()
        from benchmarks import roofline_torch
        recs = roofline_torch.main()
        ok = sum(r.get("status") == "ok" for r in recs)
        sk = sum(r.get("status") == "skipped" for r in recs)
        print(f"roofline,{time.time()-t0:.1f},records={len(recs)};ok={ok};"
              f"skipped={sk};wrote=roofline_torch_16_16.md,"
              f"roofline_torch_2_16_16.md")


if __name__ == "__main__":
    main()
