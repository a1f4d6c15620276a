#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device and ``nvcc``; it exits non-zero, printing no result,
where there is no CUDA device or the port's package is missing.  It

1. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. drives the port's main path with every kernel-launch count set to 0 —
   the paper's search (``search.run("sparsemap", ...)``) on Table III
   workloads at their published sizes with the row cost evaluator on the
   GPU, then the kernel entry points (``kernels.ops``) at shapes of those
   workloads — and reads the counts: a kernel that was not launched fails
   the run;
3. drives the fleet engine (``search.run_method_sweep`` / ``MultiSearch``):
   one method grid four ways (device segments, host replay, per-task
   dispatch, unpipelined) that must agree bit for bit, then all 28
   Table III workloads at a budget of 20,000 as one fleet on one
   signature, timed against the same searches run one after another;
4. drives the sweep server (``launch.sweep_serve.SweepServer``) on
   loopback: the same 28 queries from 28 client threads, four of them
   admitted into the running fleet, in a clean epoch with checkpoints, an
   epoch whose worker crashes once, a fresh server resuming the orphaned
   checkpoint, and an epoch of k = 4 device segments; every answer equals
   a plain ``MultiSearch`` of the same tasks bit for bit;
5. drives the LM serving path (``repro_torch.models``, ``launch.steps``,
   ``launch.serve``) on ``mistral-nemo-12b`` at full width in bf16 with
   random weights from a seed: one prefill forward of 32,768 tokens whose
   attention must run on the flash kernel in all 40 layers, the
   ``serve decode`` loop (batch 4, prompt 64, 32 generated), the flash
   route against the chunked route on the first 2 layers and 256
   ``decode_step`` calls against one forward;
6. holds the GPU evaluator against the CPU one on 262,144 genomes per
   workload and measures its rows per second;
7. holds each kernel against its plain PyTorch version on the card — the
   reference's test shapes, the edges of each route's tiles (half a query
   tile, empty, fully dense and all-zero block-rows, every column tile) and
   the workload shapes; at the LM prefill's attention shape against the
   model's chunked route — and times kernel, plain version and one library
   call beside the least time the card could take (``bound_ms``).  Each
   row names the route that ran (``kernel_route``: ``wgmma``, ``wmma`` or
   ``fma``, chosen by the wrappers' ``flash_plan`` / ``bsr_plan``);
   ``graph_ms`` is the kernel's device time without the host's share.

Every check that fails raises, so the script exits non-zero.  One JSON
object per phase goes to standard output; the second to last line is the
``{"kernels": [...]}`` table and the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

LG_TOL = 2e-3          # |dlog10_edp| <= LG_TOL * max(|log10_edp|, 1)
CAP_MARGIN = 5e-3      # validity may differ within this capacity margin


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing


def time_ms(fn, reps: int, flush) -> float:
    """Median device time of ``fn()`` over ``reps`` launches, each after
    the L2 cache was overwritten, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in pairs)
    return ts[len(ts) // 2]


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn()`` that ends in its results on the
    host, from a synchronised start: what a caller waits for one call."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` without the host's share: ``calls``
    calls captured in one CUDA graph, replayed, timed by CUDA events (no
    L2 flush between the calls)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


# ------------------------------------------------------------------ search

SEARCHES = [("conv4", 2000), ("mm13", 20_000), ("mm9", 5000),
            ("battn2", 2000)]


def search_phase(device):
    import numpy as np
    import torch
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import search, torch_cost

    # first touch of the device (context, allocator) is not a search time
    t0 = time.perf_counter()
    search.run("sparsemap", by_name("mm1"), "cloud", budget=400, seed=0)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    rows = []
    for name, budget in SEARCHES:
        wl = by_name(name)
        torch_cost.reset_dispatch_count()
        t0 = time.perf_counter()
        res = search.run("sparsemap", wl, "cloud", budget=budget, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dispatches = torch_cost.dispatch_count()
        _, ev = search.get_evaluator(wl, "cloud")
        check(ev.device.type == "cuda", f"{name}: evaluator not on the GPU")
        check(res.evals == budget, f"{name}: {res.evals} evals != {budget}")
        check(len(res.history) == budget, f"{name}: history length")
        check(res.best_genome is not None and np.isfinite(res.best_edp),
              f"{name}: the search found no valid design")
        check(dispatches > 0, f"{name}: no evaluator dispatch was counted")
        lg = float(np.log10(res.best_edp))
        rep = search.report_best(wl, "cloud", res)
        check(rep is not None and rep.valid,
              f"{name}: the numpy oracle calls the best design invalid "
              f"({getattr(rep, 'reason', None)})")
        lg_oracle = float(np.log10(rep.edp))
        check(abs(lg - lg_oracle) <= LG_TOL * max(abs(lg_oracle), 1.0),
              f"{name}: search log10 EDP {lg} vs oracle {lg_oracle}")
        gens = int(res.extras.get("generations", 0))
        rows.append(dict(
            workload=name, platform="cloud", budget=budget, evals=res.evals,
            valid_fraction=res.valid_fraction, best_log10_edp=lg,
            oracle_log10_edp=lg_oracle, wall_s=wall, generations=gens,
            s_per_generation=wall / max(gens, 1),
            dispatch_count=dispatches, s_per_dispatch=wall / dispatches))
    return dict(phase="search", device=str(device), warmup_s=warmup_s,
                searches=rows)


# ------------------------------------------------------------------- fleet

FLEET_METHODS = ["sparsemap", "standard_es", "pso", "random_mapper"]
FLEET_BUDGET = 20_000


def _same_grid(a, b, what):
    """Two run_method_sweep grids agree bit for bit."""
    for m in a:
        for w in a[m]:
            x, y = a[m][w], b[m][w]
            check(x.best_edp == y.best_edp and x.evals == y.evals
                  and x.valid_evals == y.valid_evals
                  and x.history.shape == y.history.shape
                  and bool((x.history == y.history).all()),
                  f"fleet parity: {m}/{w} differs between the default "
                  f"fleet and {what} (best {x.best_edp} vs {y.best_edp}, "
                  f"evals {x.evals} vs {y.evals}, valid {x.valid_evals} vs "
                  f"{y.valid_evals})")


def fleet_phase(device):
    """The fleet engine on the card: (a) the same method grid four ways —
    default (device segments, stacked, pipelined), host replay of the
    segments, per-task dispatch, unpipelined — and each SparseMap task
    alone, all bit for bit; (b) the 28 Table III workloads at the full
    budget as one fleet against the same searches one after another."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_workloads import all_workloads, by_name
    from repro_torch.core import search, torch_cost

    # ---- (a) parity
    wls = [by_name("mm1"), by_name("mm3")]
    variants = [("default", {}), ("device_execute=False",
                                  dict(device_execute=False)),
                ("stack_batches=False", dict(stack_batches=False)),
                ("pipeline=False", dict(pipeline=False))]
    grids, parity = {}, []
    for name, kw in variants:
        stats = {}
        t0 = time.perf_counter()
        grids[name] = search.run_method_sweep(
            FLEET_METHODS, wls, "cloud", budget=2000, seed=0,
            **{**dict(stack_batches=True, device_rounds=4), **kw},
            stats_out=stats)
        torch.cuda.synchronize()
        parity.append(dict(variant=name, wall_s=time.perf_counter() - t0,
                           rounds=stats["rounds"],
                           dispatches=stats["dispatches"],
                           host_syncs=stats["host_syncs"],
                           host_syncs_per_round=stats[
                               "host_syncs_per_round"]))
        check(stats["device"].startswith("cuda"), "fleet not on the GPU")
        if name != "default":
            _same_grid(grids["default"], grids[name], name)
    for wl in wls:
        alone = search.run("sparsemap", wl, "cloud", budget=2000, seed=0,
                           device_rounds=4)
        _same_grid({"sparsemap": {wl.name: grids["default"]["sparsemap"][
            wl.name]}}, {"sparsemap": {wl.name: alone}},
            "its standalone search.run")
    grid_rows = [dict(method=m, workload=w, evals=r.evals,
                      valid_evals=r.valid_evals,
                      best_log10_edp=float(np.log10(r.best_edp)))
                 for m, g in grids["default"].items() for w, r in g.items()]

    # ---- (b) full width: one dispatch per round for all 28 searches
    table3 = all_workloads()
    run_segments, eval_stacked = torch_cost.run_segments, \
        torch_cost.eval_stacked

    def table3_fleet(**kw):
        return search.MultiSearch(
            [search.SearchTask(wl, "cloud", budget=FLEET_BUDGET, seed=0)
             for wl in table3], search.FleetConfig(stack_batches=True, **kw))

    t0 = time.perf_counter()
    ms = table3_fleet()
    fleet = ms.run()
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    stats = ms.stats
    check(stats["device_rounds"] == 4 and
          stats["device_rounds_source"] == "default:gpu",
          f"fleet device rounds {stats['device_rounds']} "
          f"({stats['device_rounds_source']}), expected 4 (default:gpu)")
    check(len(stats["signatures"]) == 1,
          f"Table III fleet spans {stats['signatures']}, expected one "
          f"signature")
    dpr = stats["dispatches"] / stats["rounds"]
    check(dpr <= 1.0, f"{dpr} dispatches per round, expected <= 1")
    check(stats["host_syncs_per_round"] <= 0.25 + 1e-9,
          f"{stats['host_syncs_per_round']} host syncs per round in the "
          f"segment phase, expected <= 1/4")
    rows = []
    for wl, name in zip(table3, ms.final_names):
        res = fleet[name]
        check(res.evals == FLEET_BUDGET,
              f"{name}: {res.evals} evals != {FLEET_BUDGET}")
        check(res.best_genome is not None and np.isfinite(res.best_edp),
              f"{name}: the fleet found no valid design")
        rep = search.report_best(wl, "cloud", res)
        check(rep is not None and rep.valid,
              f"{name}: the numpy oracle calls the best design invalid")
        lg, lg_oracle = float(np.log10(res.best_edp)), float(np.log10(
            rep.edp))
        check(abs(lg - lg_oracle) <= LG_TOL * max(abs(lg_oracle), 1.0),
              f"{name}: fleet log10 EDP {lg} vs oracle {lg_oracle}")
        rows.append(dict(workload=wl.name, best_log10_edp=lg,
                         oracle_log10_edp=lg_oracle,
                         valid_fraction=res.valid_fraction))

    # the same fleet with every segment replayed on the host, one
    # generation a round: what the segments change, and bit parity at
    # full width
    t0 = time.perf_counter()
    replay = table3_fleet(device_execute=False)
    replayed = replay.run()
    torch.cuda.synchronize()
    replay_wall = time.perf_counter() - t0
    _same_grid({"sparsemap": fleet}, {"sparsemap": replayed},
               "the Table III fleet replayed on the host")

    # the same 28 searches one after another, as a user without the fleet
    # would run them
    t0 = time.perf_counter()
    seq = {wl.name: search.run("sparsemap", wl, "cloud",
                               budget=FLEET_BUDGET, seed=0)
           for wl in table3}
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    for row in rows:
        row["sequential_best_log10_edp"] = float(
            np.log10(seq[row["workload"]].best_edp))

    # the inputs of one segment and one stacked call of all 28 tasks, from
    # a fleet of its own stepped until it has made both, outside every
    # timed run
    seen = {}

    def keep_segments(models, segs, **kw):
        if len(segs) == len(table3):
            seen["seg"] = (list(models), list(segs))
        return run_segments(models, segs, **kw)

    def keep_stacked(models, batches, **kw):
        if len(batches) == len(table3):
            seen["stacked"] = (list(models), list(batches))
        return eval_stacked(models, batches, **kw)

    torch_cost.run_segments, torch_cost.eval_stacked = keep_segments, \
        keep_stacked
    try:
        probe = table3_fleet()
        probe.start()
        while len(seen) < 2 and probe.step():
            pass
    finally:
        torch_cost.run_segments, torch_cost.eval_stacked = run_segments, \
            eval_stacked
    check(len(seen) == 2, "the Table III fleet made no segment or no "
          "stacked call of all its tasks")
    models, segs = seen["seg"]
    models_s, batches = seen["stacked"]

    def one_segment():
        return run_segments(models, segs)

    def one_stacked():
        return eval_stacked(models_s, batches)

    seg_launches = count_device_launches(one_segment)
    stacked_launches = count_device_launches(one_stacked)
    return dict(
        phase="fleet", device=str(device), parity=parity,
        parity_grid=grid_rows,
        table3=dict(
            tasks=len(table3), budget=FLEET_BUDGET,
            fleet_wall_s=fleet_wall, sequential_wall_s=seq_wall,
            host_replay_fleet_wall_s=replay_wall,
            host_replay_rounds=replay.stats["rounds"],
            host_replay_dispatches=replay.stats["dispatches"],
            rounds=stats["rounds"], host_syncs=stats["host_syncs"],
            dispatches=stats["dispatches"], dispatches_per_round=dpr,
            host_syncs_per_round=stats["host_syncs_per_round"],
            host_blocked_s=stats["host_blocked_s"],
            signature=list(stats["signatures"][0]),
            pad_watermarks=stats["pad_watermarks"],
            segment_tasks=len(segs), segment_rounds=segs[0].rounds,
            device_ops_per_segment=seg_launches,
            ms_per_segment=wall_ms(one_segment),
            stacked_rows=sum(len(b) for b in batches),
            device_ops_per_stacked_call=stacked_launches,
            ms_per_stacked_call=wall_ms(one_stacked),
            searches=rows))


# ------------------------------------------------------------------- serve

SERVE_BUDGET = FLEET_BUDGET
#: the first query of an epoch: its fleet's signature (32 primes,
#: structured density) is the one every Table III workload aligns to, so
#: each query admitted after it joins the same mega-batch
SERVE_ANCHOR = "mm8"
#: submitted only after the first ``update`` reaches a client: admitted
#: into the running fleet
SERVE_LATE = ("conv10", "conv11", "conv12", "conv13")


def _serve_tasks():
    from repro_torch.configs.paper_workloads import all_workloads
    from repro_torch.core.search import SearchTask
    return [SearchTask(wl, "cloud", budget=SERVE_BUDGET, seed=0)
            for wl in all_workloads()]


def _serve_epoch(srv):
    """The 28 Table III queries against a running server, one client
    thread each: the anchor first, the other 23 of the first 24 at once
    when it is accepted, the last 4 when the first ``update`` reaches a
    client.  Returns ({name: events}, {name: s to first update}, wall s)."""
    import threading
    from repro_torch.launch.sweep_serve import submit
    tasks = {t.resolved_name(): t for t in _serve_tasks()}
    anchor = f"{SERVE_ANCHOR}@cloud"
    late = [f"{n}@cloud" for n in SERVE_LATE]
    events, first_update, errors = {}, {}, []
    accepted = {name: threading.Event() for name in tasks}
    any_update = threading.Event()

    def client(name):
        try:
            t0 = time.perf_counter()
            evs = []
            for ev in submit(srv.host, srv.port, tasks[name]):
                evs.append(ev)
                accepted[name].set()
                if ev.get("event") == "update" and name not in first_update:
                    first_update[name] = time.perf_counter() - t0
                    any_update.set()
            events[name] = evs
        except Exception as e:      # noqa: BLE001 — re-raised below
            errors.append(f"{name}: {e!r}")
        finally:
            accepted[name].set()

    def launch(names):
        ths = [threading.Thread(target=client, args=(n,), daemon=True)
               for n in names]
        for th in ths:
            th.start()
        return ths

    t0 = time.perf_counter()
    threads = launch([anchor])
    check(accepted[anchor].wait(600), "the anchor query was not accepted")
    threads += launch([n for n in tasks if n != anchor and n not in late])
    check(any_update.wait(600), "no client received an update")
    threads += launch(late)
    for th in threads:
        th.join(1200)
    wall = time.perf_counter() - t0
    check(not errors, f"serve clients failed: {errors}")
    return events, first_update, wall


def _check_serve_events(events, want, what):
    """Every client got ``ok``, updates and one ``done`` that equals the
    plain fleet's result for its task bit for bit."""
    import numpy as np
    check(sorted(events) == sorted(want),
          f"serve {what}: answered {sorted(events)}")
    for name, evs in events.items():
        check(evs and evs[0].get("ok") is True and evs[0].get("id") == name,
              f"serve {what}: {name} was not accepted: {evs[:1]}")
        check(any(e.get("event") == "update" for e in evs),
              f"serve {what}: {name} got no update")
        done = [e for e in evs if e.get("event") == "done"]
        check(len(done) == 1 and evs[-1] is done[0],
              f"serve {what}: {name} got {len(done)} done events "
              f"({[e.get('event') for e in evs[-3:]]})")
        d, r = done[0], want[name]
        check(d["evals"] == SERVE_BUDGET,
              f"serve {what}: {name} {d['evals']} evals != {SERVE_BUDGET}")
        check(d["best_edp"] == r.best_edp and d["evals"] == r.evals
              and d["valid_evals"] == r.valid_evals
              and d["best_genome"] == np.asarray(r.best_genome).tolist(),
              f"serve {what}: {name} differs from the plain MultiSearch "
              f"(best {d['best_edp']} vs {r.best_edp}, evals {d['evals']} "
              f"vs {r.evals})")


def _stats(srv):
    from repro_torch.launch.sweep_serve import request
    return next(iter(request(srv.host, srv.port, {"op": "stats"})))["stats"]


def _epoch_row(stats, events, first_update, wall):
    import numpy as np
    lat = sorted(first_update.values())
    fleet = stats["fleet"]
    n_ck = stats["checkpoints"]
    return dict(
        wall_s=wall, queries=len(events), queries_per_s=len(events) / wall,
        first_update_s_median=float(np.median(lat)),
        first_update_s_max=lat[-1], epochs=stats["epochs"],
        rounds=fleet["rounds"], dispatches=fleet["dispatches"],
        dispatches_per_round=stats["dispatches_per_round"],
        host_syncs_per_round=fleet["host_syncs_per_round"],
        device_rounds=fleet["device_rounds"],
        host_blocked_s=fleet["host_blocked_s"],
        signature_groups=stats["signature_groups"],
        restarts=stats["restarts"], checkpoints=n_ck,
        bytes_per_checkpoint=stats["checkpoint_bytes"] / n_ck if n_ck
        else 0,
        ms_per_pack_fleet=1e3 * stats["checkpoint_pack_s"] / n_ck if n_ck
        else 0.0,
        ms_per_save_flat=1e3 * stats["checkpoint_s"] / n_ck if n_ck
        else 0.0)


def serve_phase(device):
    """The sweep server on the card (``repro_torch.launch.sweep_serve``),
    on loopback, the 28 Table III queries at 20,000 each from 28 client
    threads, four epochs: (a) clean with checkpoints (k = 1), (b) the
    worker crashed once after the second checkpoint, (c) a fresh server
    resuming the fleet orphaned by (b), (d) no checkpoints, k = 4.  Every
    ``done`` is held bit for bit against a plain ``MultiSearch`` of the
    same 28 tasks, every best design against the float64 oracle."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core import search, torch_cost
    from repro_torch.core.search import FleetConfig, MultiSearch
    from repro_torch.launch.sweep_serve import SweepServer, library_key

    torch.cuda.reset_peak_memory_stats(device)
    cfg1 = FleetConfig(stack_batches=True, device_rounds=1)
    cfg4 = FleetConfig(stack_batches=True, device_rounds=4)
    tasks = _serve_tasks()
    names = [t.resolved_name() for t in tasks]
    out = dict(phase="serve", device=str(device), tasks=len(tasks),
               budget=SERVE_BUDGET, anchor=SERVE_ANCHOR,
               late=list(SERVE_LATE))

    t0 = time.perf_counter()
    plain1 = MultiSearch(_serve_tasks(), cfg1, device=device).run()
    out["plain_k1_wall_s"] = time.perf_counter() - t0
    for t, name in zip(tasks, names):
        res = plain1[name]
        check(res.best_genome is not None and np.isfinite(res.best_edp),
              f"serve: {name} found no valid design")
        rep = search.report_best(t.workload, "cloud", res)
        check(rep is not None and rep.valid,
              f"serve: the numpy oracle calls {name}'s best invalid")
        lg, lg_o = float(np.log10(res.best_edp)), float(np.log10(rep.edp))
        check(abs(lg - lg_o) <= LG_TOL * max(abs(lg_o), 1.0),
              f"serve: {name} log10 EDP {lg} vs oracle {lg_o}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        # ---- (a) the clean epoch
        ck_a = os.path.join(tmp, "a")
        srv = SweepServer(port=0, config=cfg1, ckpt_dir=ck_a, ckpt_every=8,
                          device=device)
        srv.start_background()
        try:
            events, first, wall = _serve_epoch(srv)
            st = _stats(srv)
        finally:
            srv.stop()
        _check_serve_events(events, plain1, "clean epoch")
        check(st["epochs"] == 1 and st["completed"] == len(tasks),
              f"serve clean epoch: {st['epochs']} epochs, "
              f"{st['completed']} completed")
        check(st["dispatches_per_round"] == 1.0,
              f"serve clean epoch: {st['dispatches_per_round']} dispatches "
              f"per round, expected 1.0 ({st['signature_groups']})")
        check(st["checkpoints"] >= 2, "serve clean epoch: fewer than two "
              "checkpoints")
        check(not [d for d in os.listdir(ck_a) if d.startswith("step_")],
              "serve clean epoch: spent checkpoints left behind")
        out["clean"] = _epoch_row(st, events, first, wall)

        # ---- (b) the crash epoch, (c) the orphan it leaves
        ck_b, ck_c = os.path.join(tmp, "b"), os.path.join(tmp, "c")
        srv = SweepServer(port=0, config=cfg1, ckpt_dir=ck_b, ckpt_every=8,
                          device=device)
        crash = dict(raised=None, recovered=None, step=None, cache=[])
        orig_step = MultiSearch.step

        def crashy(ms):
            # the crash: at the first step after the second checkpoint
            # that holds every task mid-generation (past its calibration
            # and HSHI prologue), so each one resumes from its population
            if crash["raised"] is None and srv._stats["checkpoints"] >= 2:
                step = ckpt_lib.latest_step(ck_b)
                _, meta = ckpt_lib.load_flat(ck_b, step)
                if len(meta["tasks"]) == len(tasks) and \
                        all(e["_resumable"] for e in meta["tasks"]):
                    shutil.copytree(os.path.join(ck_b, f"step_{step:08d}"),
                                    os.path.join(ck_c, f"step_{step:08d}"))
                    crash["step"] = step
                    crash["raised"] = time.perf_counter()
                    raise RuntimeError("injected worker crash")
            if crash["raised"] is None or len(crash["cache"]) >= 3:
                return orig_step(ms)
            # the first rounds after the restore: the stacked-constants
            # cache's hits and misses in each
            h0, m0 = torch_cost.stack_prep_counts()
            alive = orig_step(ms)
            if crash["recovered"] is None:
                crash["recovered"] = time.perf_counter()
            h1, m1 = torch_cost.stack_prep_counts()
            crash["cache"].append(dict(hits=h1 - h0, misses=m1 - m0))
            return alive

        MultiSearch.step = crashy
        try:
            srv.start_background()
            events, first, wall = _serve_epoch(srv)
            st = _stats(srv)
        finally:
            MultiSearch.step = orig_step
            srv.stop()
        check(crash["raised"] is not None and crash["recovered"] is not None,
              "serve crash epoch: the crash was not injected or not "
              "recovered from")
        check(st["restarts"] == 1,
              f"serve crash epoch: {st['restarts']} restarts, expected 1")
        _check_serve_events(events, plain1, "crash epoch")
        row = _epoch_row(st, events, first, wall)
        row["rounds_after_restore"] = row.pop("rounds")
        out["crash"] = dict(
            row, crashed_after_round=crash["step"],
            recovery_s=crash["recovered"] - crash["raised"],
            stacked_consts_cache_after_restore=crash["cache"])

        # (c) a fresh server on the orphaned checkpoint, no client
        t0 = time.perf_counter()
        srv = SweepServer(port=0, config=cfg1, ckpt_dir=ck_c, ckpt_every=8,
                          device=device)
        srv.start_background()
        try:
            deadline = time.monotonic() + 600
            while _stats(srv)["completed"] < len(tasks) and \
                    time.monotonic() < deadline:
                time.sleep(0.1)
            st = _stats(srv)
        finally:
            srv.stop()
        orphan_wall = time.perf_counter() - t0
        check(st["completed"] == len(tasks) and st["epochs"] == 1
              and st["restarts"] == 0,
              f"serve orphan: {st['completed']} completed, {st['epochs']} "
              f"epochs, {st['restarts']} restarts")
        for t, name in zip(tasks, names):
            entry = srv.library._best.get(library_key(t))
            check(entry is not None and entry[0] == plain1[name].best_edp,
                  f"serve orphan: library best for {name} "
                  f"{entry and entry[0]} != {plain1[name].best_edp}")
        out["orphan"] = dict(wall_s=orphan_wall, resumed_from_round=crash[
            "step"], rounds=st["fleet"]["rounds"],
            dispatches_per_round=st["dispatches_per_round"],
            library_size=st["library"]["size"])

        # ---- (d) no checkpoints, k = 4 device segments
        t0 = time.perf_counter()
        plain4 = MultiSearch(_serve_tasks(), cfg4, device=device).run()
        out["plain_k4_wall_s"] = time.perf_counter() - t0
        srv = SweepServer(port=0, config=cfg4, device=device)
        srv.start_background()
        try:
            events, first, wall = _serve_epoch(srv)
            st = _stats(srv)
        finally:
            srv.stop()
        check(st["fleet"]["device_rounds"] == 4,
              f"serve k=4: fleet ran {st['fleet']['device_rounds']} rounds "
              f"a segment")
        _check_serve_events(events, plain4, "k=4 epoch")
        out["k4"] = _epoch_row(st, events, first, wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
        device)
    out["card"] = card_line()
    return out


# ---------------------------------------------------------------------- lm

LM_ARCH = "mistral-nemo-12b"
LM_PREFILL_S = 32_768       # prefill_32k's sequence length, one sequence
LM_DECODE = (4, 64, 32)     # batch, prompt, generated: the CLI's defaults
LM_ROUTES_CHECK = (2, 2, 4096)      # layers, batch, sequence of check (a)
LM_DECODE_CHECK_S = 256             # prompt of check (b)
# Model-level bf16 logits are held per position: the rms of the error over
# the vocabulary within LM_REL_RMS of the rms of the logits (the 0.05·rms
# term of the kernel limit, applied to the error's rms).  The kernel limit
# itself, taken element by element, is bf16's own spread for a model: the
# JAX package's bf16 logits miss its fp32 logits by up to 1.3 times it at
# two layers on the CPU, and on an H100 checks (a) and (b) below miss it
# by 1.16 and 2.29 times while their per-position error rms is 1.1 % and
# 2.5 %.
LM_REL_RMS = 0.05


def _first_layers(model, n):
    """A view of ``model`` cut to its first ``n`` blocks (same weights)."""
    import copy

    import torch
    sub = copy.copy(model)
    sub._modules = dict(model._modules)
    sub.blocks = torch.nn.ModuleList(list(model.blocks)[:n])
    return sub


def _logits_check(a, b, name):
    """Per position, ``rms(a - b) <= LM_REL_RMS * rms(b)`` over the
    vocabulary; returns the worst ratio and, for the record, the largest
    element error as a share of the kernel limit."""
    import torch
    worst, share = 0.0, 0.0
    for i in range(a.shape[0]):            # one sequence at a time
        x, y = a[i].float(), b[i].float()
        err = x - y
        ratio = err.pow(2).mean(-1).sqrt() / y.pow(2).mean(-1).sqrt()
        worst = max(worst, float(ratio.max()))
        atol = ATOL_RMS * float(y.pow(2).mean().sqrt())
        share = max(share, float((err.abs_() / (atol + RTOL_BF16 * y.abs())
                                  ).max()))
        del x, y, err
    check(math.isfinite(worst) and worst <= LM_REL_RMS,
          f"{name}: per-position error rms is {worst:.3g} of the logits' "
          f"rms (limit {LM_REL_RMS})")
    torch.cuda.synchronize()
    return dict(worst_rel_rms=worst, rel_rms_limit=LM_REL_RMS,
                elementwise_share_of_kernel_limit=share)


def device_ms_by_kernel(fn):
    """Device time of one call of ``fn`` per kernel name, from
    ``torch.profiler`` (ms), sorted by time, and the count of device
    operations it enqueued."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
            n += 1
    check(n > 0, "torch.profiler saw no device operation")
    return dict(sorted(times.items(), key=lambda kv: -kv[1])), n


def _kernel_family(name):
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attention (hand kernel)"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "GEMM (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def lm_phase(device):
    """The dense decoder on the card at full width (``mistral-nemo-12b``,
    bf16, random weights from a seed): one prefill forward of S = 32,768
    (every layer's attention on the flash kernel), the ``serve decode``
    loop at B = 4, prompt 64, gen 32, and two consistency checks — the
    flash route against the chunked route on the model's first 2 layers,
    and 256 ``decode_step`` calls against one forward over the same
    tokens on all 40 layers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.attention import attention
    from repro_torch.models.model import Model

    def reset():
        flash_attention.launches = 0
        attention.calls.update(flash=0, chunked=0)

    def counts():
        return dict(flash_kernel=flash_attention.launches,
                    route_flash=attention.calls["flash"],
                    route_chunked=attention.calls["chunked"])

    out = dict(arch=LM_ARCH)
    cfg = get_config(LM_ARCH)
    n_layers = cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    out.update(layers=n_layers, param_count=sum(
        p.numel() for p in model.parameters()), param_bytes=param_bytes,
        build_max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
            device))
    prefill = build_prefill_step(model)
    rng = np.random.default_rng(0)

    # ---- prefill: the main path of this phase, counts at 0 just before
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, LM_PREFILL_S))).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    logits = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    forward_peak = torch.cuda.max_memory_allocated(device)
    check(launches == dict(flash_kernel=n_layers, route_flash=n_layers,
                           route_chunked=0),
          f"lm prefill: {launches}, want the flash kernel in each of the "
          f"{n_layers} layers and no chunked route")
    check(tuple(logits.shape) == (1, LM_PREFILL_S, cfg.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          "lm prefill: logits of the wrong shape or not finite")
    del logits
    walls = [wall]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill({"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del logits
    by_kernel, _ = device_ms_by_kernel(lambda: prefill({"tokens": tokens}))
    dev_ms = sum(by_kernel.values())
    families = {}
    for name, ms in by_kernel.items():
        fam = _kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qkv_o = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
    s = LM_PREFILL_S
    weight_flops = 2.0 * s * (n_layers * (qkv_o + 3 * d * ff) + d * v)
    attn_flops = 4.0 * cfg.n_heads * (s * (s + 1) / 2) * cfg.hd * n_layers
    flops = weight_flops + attn_flops
    moved = param_bytes + s * v * 2
    out["prefill"] = dict(
        batch=1, seq=s, launches=launches, wall_s=walls[0],
        wall_s_repeats=walls[1:], tokens_per_s=s / min(walls),
        device_ms=dev_ms, flash_device_ms=families.get(
            "flash_attention (hand kernel)", 0.0),
        flash_share_of_device_time=families.get(
            "flash_attention (hand kernel)", 0.0) / dev_ms,
        device_ms_by_family=families,
        top_kernels_ms=dict(list(by_kernel.items())[:8]),
        flops=flops, weight_flops=weight_flops, attention_flops=attn_flops,
        bytes=moved,
        bound_s=max(flops / PEAK_FLOPS["bfloat16"], moved / HBM_BYTES_PER_S),
        forward_max_memory_allocated_bytes=forward_peak,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(device))
    out["prefill"]["share_of_bound"] = out["prefill"]["bound_s"] / min(walls)
    del tokens

    # ---- decode: the serve decode loop, counts at 0 just before
    b, pl_, g = LM_DECODE
    prompts = torch.from_numpy(serve.make_prompts(cfg.vocab_size, b, pl_)
                               ).to(device)
    reset()
    res = serve.run_decode(model, prompts, g)
    dec_launches = counts()
    gen = res["tokens"]
    check(gen.shape == (b, g) and ((gen >= 0) & (gen < v)).all(),
          f"lm decode: generated tokens {gen.shape} out of range")
    check(dec_launches["route_flash"] == dec_launches["route_chunked"] == 0,
          f"lm decode: {dec_launches}; decode steps call no prefill route")
    step = build_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(b, pl_ + g + 1)
        tok = prompts[:, :1]
        step_kernels, step_launches = device_ms_by_kernel(
            lambda: step(cache, tok, pl_ + g))
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache for t in c.values())
        del cache
    step_ms = res["decode_s"] / g * 1e3
    read = param_bytes - model.embed.numel() * model.embed.element_size() \
        + b * d * model.embed.element_size() + cache_bytes
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    out["decode"] = dict(
        batch=b, prompt=pl_, gen=g, launches=dec_launches,
        prefill_by_steps_s=res["prefill_s"],
        prefill_by_steps_tokens_per_s=b * pl_ / res["prefill_s"],
        decode_s=res["decode_s"], ms_per_step=step_ms,
        tokens_per_s=b * g / res["decode_s"],
        bytes_per_step=read, bound_ms_per_step=bound_ms,
        share_of_bound=bound_ms / step_ms,
        device_launches_per_step=step_launches,
        device_ms_per_step=sum(step_kernels.values()),
        device_idle_share=1.0 - sum(step_kernels.values()) / step_ms,
        first_generated=gen[:2, :8].tolist())

    # ---- (a) flash route against the chunked route, first 2 layers
    nl, cb, cs = LM_ROUTES_CHECK
    sub = _first_layers(model, nl)
    toks = torch.from_numpy(rng.integers(0, v, (cb, cs))).to(device)
    with torch.inference_mode():
        reset()
        lf = sub(toks)
        flash_counts = counts()
        reset()
        lc = sub(toks, force_chunked=True)
        chunked_counts = counts()
    check(flash_counts == dict(flash_kernel=nl, route_flash=nl,
                               route_chunked=0)
          and chunked_counts == dict(flash_kernel=0, route_flash=0,
                                     route_chunked=nl),
          f"lm routes check: flash run {flash_counts}, chunked run "
          f"{chunked_counts}")
    out["check_routes"] = dict(layers=nl, batch=cb, seq=cs,
                               **_logits_check(lf, lc, "lm flash vs chunked"))
    del lf, lc, sub, toks

    # ---- (b) decode_step against one forward, all layers
    toks = torch.from_numpy(rng.integers(0, v, (1, LM_DECODE_CHECK_S))
                            ).to(device)
    step = build_serve_step(model)
    with torch.inference_mode():
        fwd = prefill({"tokens": toks})
        cache = model.init_cache(1, LM_DECODE_CHECK_S)
        dec = torch.cat([step(cache, toks[:, i:i + 1], i)
                         for i in range(LM_DECODE_CHECK_S)], dim=1)
    out["check_decode"] = dict(
        layers=n_layers, seq=LM_DECODE_CHECK_S,
        **_logits_check(dec, fwd, "lm decode_step vs forward"))
    del fwd, dec, cache, toks, model, prefill, step
    torch.cuda.synchronize()
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
        device)
    torch.cuda.empty_cache()
    out["card"] = card_line()
    return out



# --------------------------------------------------------------- main path


def _banded_block_sparse(rng, m, k, band_fraction):
    """A banded P as windowed attention has it: nonzeros only within
    ``band_fraction * k / 2`` columns of the diagonal."""
    import numpy as np
    p = rng.standard_normal((m, k)).astype(np.float32)
    r = np.arange(m)[:, None] * (k / m)
    c = np.arange(k)[None, :]
    return np.where(np.abs(c - r) <= band_fraction * k / 2, p, 0.0
                    ).astype(np.float32)


def _random_block_sparse(rng, m, k, bm, bk, density):
    import numpy as np
    p = rng.standard_normal((m, k)).astype(np.float32)
    mask = rng.random((m // bm, k // bk)) < density
    p = p.reshape(m // bm, bm, k // bk, bk) * mask[:, None, :, None]
    return np.ascontiguousarray(p.reshape(m, k), dtype=np.float32)


def _bsr_case(name, p, q, bm, bk, bn, dtype, device):
    import torch
    from repro_torch.kernels.bsr_spmm import bsr_plan
    from repro_torch.kernels.ref import dense_to_bsr
    blocks, col_idx, row_ptr = dense_to_bsr(p, bm, bk)
    plan = bsr_plan(dtype, bm, bk, q.shape[1])
    return dict(
        name=name, bm=bm, bk=bk, bn=bn, m_blocks=p.shape[0] // bm,
        kernel_route=plan.route, tile=plan.bn,
        nnz=int(row_ptr[-1]), M=p.shape[0], K=p.shape[1], N=q.shape[1],
        dtype=str(dtype).replace("torch.", ""),
        args=(torch.from_numpy(blocks).to(device, dtype),
              torch.from_numpy(col_idx).to(device),
              torch.from_numpy(row_ptr).to(device),
              torch.from_numpy(q).to(device, dtype)),
        dense=torch.from_numpy(p).to(device, dtype))


def workload_cases(device):
    """Kernel inputs at shapes of the searched workloads, from a seed."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_plan
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    bsr = []
    # battn2: scores x values, P 1024x1024 banded (band fraction 0.0625),
    # Q = V 1024x64
    p = _banded_block_sparse(rng, 1024, 1024, 0.0625)
    q = rng.standard_normal((1024, 64)).astype(np.float32)
    bsr.append(_bsr_case("battn2_64x64", p, q, 64, 64, 64, bf16, device))
    # a 4096^3 product at block density 0.1, in 64x64 and 128x64 blocks
    q = rng.standard_normal((4096, 4096)).astype(np.float32)
    for bm in (64, 128):
        p = _random_block_sparse(rng, 4096, 4096, bm, 64, 0.1)
        bsr.append(_bsr_case(f"4096x4096x4096_d0.1_{bm}x64", p, q, bm, 64,
                             64, bf16, device))
    gen = torch.Generator(device="cpu").manual_seed(0)
    qkv = tuple((torch.randn((2, 16, 4096, 128), generator=gen) * sc
                 ).to(device, bf16) for sc in (0.3, 0.3, 1.0))
    plan = flash_plan(bf16, 4096, 128)
    flash = [dict(name=f"B2_H16_S4096_hd128_{'causal' if c else 'full'}",
                  causal=c, B=2, H=16, S=4096, hd=128, dtype="bfloat16",
                  kernel_route=plan.route, tile=plan.tile, args=qkv)
             for c in (True, False)]
    return bsr, flash


def lm_flash_case(device):
    """The flash kernel at the LM prefill's attention shape: one sequence of
    32,768, ``mistral-nemo-12b``'s 32 query heads of 128, causal, bf16."""
    import torch
    from repro_torch.kernels.flash_attention import flash_plan
    gen = torch.Generator(device=device).manual_seed(3)
    b, h, s, hd = 1, 32, LM_PREFILL_S, 128
    qkv = tuple((torch.randn((b, h, s, hd), generator=gen, device=device)
                 * sc).to(torch.bfloat16) for sc in (0.3, 0.3, 1.0))
    plan = flash_plan(torch.bfloat16, s, hd)
    return dict(name=f"lm_B{b}_H{h}_S{s}_hd{hd}_causal", causal=True, B=b,
                H=h, S=s, hd=hd, dtype="bfloat16", kernel_route=plan.route,
                tile=plan.tile, args=qkv, main_path="lm_prefill")


def kernel_path(bsr_cases, flash_cases):
    """The kernel half of the main path: the public entry points, in
    their default mode, on tensors on the card."""
    import torch
    from repro_torch.kernels import ops
    outs = {}
    for c in bsr_cases:
        z = ops.bsr_spmm(*c["args"], m_blocks=c["m_blocks"], bn=c["bn"])
        check(z.is_cuda and tuple(z.shape) == (c["M"], c["N"]),
              f"bsr_spmm {c['name']}: wrong device or shape")
        outs[c["name"]] = z
    for c in flash_cases:
        o = ops.flash_attention(*c["args"], causal=c["causal"])
        check(o.is_cuda and o.shape == c["args"][0].shape,
              f"flash_attention {c['name']}: wrong device or shape")
        outs[c["name"]] = o
    torch.cuda.synchronize()
    for name, t in outs.items():
        check(bool(torch.isfinite(t.float()).all()),
              f"{name}: non-finite output on the main path")
    return outs


# --------------------------------------------------------------- evaluator


def count_device_launches(fn):
    """Device kernels and copies that one call of ``fn`` enqueues, counted
    with ``torch.profiler``; a profiler that traced nothing on the device
    fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    check(n > 0, "torch.profiler saw no device operation in an evaluator "
          "call")
    return n


EVAL_CASES = [("mm13", "cloud"), ("conv4", "cloud"), ("mm9", "cloud"),
              ("conv4", "dstc_like")]
EVAL_ROWS = 262_144


def evaluator_phase(device):
    import numpy as np
    import torch
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core.arch import as_arch
    from repro_torch.core.baselines import METHODS
    from repro_torch.core.cost_model import evaluate
    from repro_torch.core.encoding import GenomeSpec
    from repro_torch.core.torch_cost import TorchCostModel, clog2

    # ceil(log2) at exact powers of two, on the card: torch.log2 against
    # the evaluator's frexp form
    ks = torch.arange(1, 120, device=device, dtype=torch.float32)
    pw = torch.pow(torch.full_like(ks, 2.0), ks)
    log2_exact = bool((torch.ceil(torch.log2(pw)) == ks).all())
    check(bool((clog2(pw) == ks).all()),
          "clog2 is not exact at powers of two on the card")

    rows = []
    for wname, aname in EVAL_CASES:
        arch = as_arch(aname)
        spec = GenomeSpec(by_name(wname), arch=arch)
        gpu = TorchCostModel(spec, arch, device=device)
        cpu = TorchCostModel(spec, arch, device="cpu")
        # random genomes are almost all invalid, so the head of the batch
        # is the request stream of a short search: mostly valid designs
        G = spec.random_genomes(np.random.default_rng(0), EVAL_ROWS)
        seen = []

        def recording(g):
            seen.append(np.array(g, dtype=G.dtype))
            return gpu(g)

        METHODS["sparsemap"](spec, recording, 4000, 0, arch)
        seen = np.concatenate(seen)
        G[:len(seen)] = seen
        gpu(G[:128])                                        # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = gpu(G)
        peak = torch.cuda.max_memory_allocated()
        chunks = [cpu(G[i:i + 32_768]) for i in range(0, EVAL_ROWS, 32_768)]
        b = {k: np.concatenate([c[k] for c in chunks]) for k in a}
        check(a["valid"].shape == (EVAL_ROWS,), "evaluator output shape")
        both = a["valid"] & b["valid"]
        lg = b["log10_edp"][both].astype(np.float64)
        err = np.abs(a["log10_edp"][both].astype(np.float64) - lg)
        check(bool(np.all(err <= LG_TOL * np.maximum(np.abs(lg), 1.0))),
              f"{wname}@{aname}: GPU and CPU log10 EDP disagree "
              f"(max {err.max() if err.size else 0})")
        flips = np.flatnonzero(a["valid"] != b["valid"])
        check(len(flips) <= 256, f"{wname}@{aname}: {len(flips)} validity "
              f"flips between GPU and CPU")
        for i in flips:
            rep = evaluate(spec.decode(G[i]), arch)
            margins = [abs(rep.occupancy_bytes[s] - cap) / cap
                       for _, s, cap in arch.capacity_stores
                       if s in rep.occupancy_bytes]
            check(min(margins, default=1.0) < CAP_MARGIN,
                  f"{wname}@{aname} row {i}: validity differs outside the "
                  f"capacity margin")
        def on_device(raw):
            return gpu.eval_device(gpu.layout.pad_rows(raw.long()))

        raw128 = torch.from_numpy(G[:128].astype(np.int32)).to(device)
        rates = {}
        for bsz in (128, 4096, EVAL_ROWS):
            reps = 20 if bsz < EVAL_ROWS else 3
            gpu(G[:bsz])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                gpu(G[:bsz])        # ends in a device->host copy: synced
            dt = (time.perf_counter() - t0) / reps
            # the same int32 rows already on the card, no copy either way,
            # through what __call__ runs there (cast, padding, evaluator):
            # the time from the first operation to the last by CUDA events
            # (at small batches still the host's time to issue them)
            raw = torch.from_numpy(G[:bsz].astype(np.int32)).to(device)
            a_ev = torch.cuda.Event(enable_timing=True)
            b_ev = torch.cuda.Event(enable_timing=True)
            a_ev.record()
            for _ in range(reps):
                on_device(raw)
            b_ev.record()
            torch.cuda.synchronize()
            del raw
            rates[str(bsz)] = dict(ms_per_call=dt * 1e3,
                                   rows_per_s=bsz / dt,
                                   device_ms_per_call=a_ev.elapsed_time(
                                       b_ev) / reps)
        rows.append(dict(
            workload=wname, arch=aname, rows=EVAL_ROWS,
            device_launches_per_call=count_device_launches(
                lambda: on_device(raw128)),
            valid_gpu=int(a["valid"].sum()), valid_cpu=int(b["valid"].sum()),
            valid_both=int(both.sum()), validity_flips=int(len(flips)),
            max_abs_dlog10_edp=float(err.max()) if err.size else 0.0,
            peak_memory_bytes=int(peak), by_batch=rates))
    return dict(phase="evaluator", device=str(device),
                torch_log2_exact_at_powers_of_two=log2_exact, cases=rows)


# ----------------------------------------------------------------- kernels


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _allclose(a, b, rtol, atol):
    import torch
    return bool(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol))


# At the main path's bf16 shapes the limit follows the size of the compared
# values: |a - b| <= ATOL_RMS * rms(b) + RTOL_BF16 * |b|, two bf16 units in
# the last place of the element plus a small share of a typical output.  A
# dropped or mis-weighted tile moves many elements by more than that.
RTOL_BF16 = 2.0 ** -6
ATOL_RMS = 0.05


def _scaled_check(a, b, name, what):
    """Hold ``a`` against ``b`` at the limit above; returns (largest
    absolute error, atol, largest error as a share of its limit)."""
    a, b = a.float(), b.float()
    atol = ATOL_RMS * float(b.pow(2).mean().sqrt())
    err = (a - b).abs()
    share = float((err / (atol + RTOL_BF16 * b.abs())).max())
    check(atol > 0 and share <= 1.0,
          f"{name}: kernel vs {what}: error is {share:.3g} of the limit "
          f"(atol {atol:.3g}, rtol {RTOL_BF16:.3g})")
    return float(err.max()), atol, share


def _row_scaled_check(a, b, name, what):
    """The limit above with ``rms`` taken over each output row (the last
    axis) instead of the whole tensor; returns (largest absolute error,
    largest error as a share of its row's limit).  For causal attention
    at long S: the rows' sizes fall with the number of keys (~1/sqrt), so
    one rms over all rows sets the limit of the early rows by the size of
    the late ones."""
    a, b = a.float(), b.float()
    atol = ATOL_RMS * b.pow(2).mean(-1, keepdim=True).sqrt()
    err = (a - b).abs()
    share = float((err / (atol + RTOL_BF16 * b.abs())).max())
    check(bool((atol > 0).all()) and share <= 1.0,
          f"{name}: kernel vs {what}: error is {share:.3g} of the per-row "
          f"limit ({ATOL_RMS}*rms(row) + {RTOL_BF16}*|x|)")
    return float(err.max()), share


def bsr_checks(device, bsr_cases):
    """bsr_spmm on the card against its plain version: the reference's
    test shapes in fp32 and bf16, an empty block-row, the all-zero matrix,
    and the workload shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels.bsr_spmm import (bsr_plan, bsr_spmm,
                                              bsr_spmm_plain)
    from repro_torch.kernels.ref import dense_to_bsr
    results = []
    shapes = [(32, 256, 128, 8, 128, 128), (64, 128, 256, 16, 128, 128),
              (128, 512, 128, 8, 128, 128)]
    rng = np.random.default_rng(1)
    for (m, k, n, bm, bk, bn) in shapes:
        for density in (0.1, 0.5, 0.9):
            p = _random_block_sparse(rng, m, k, bm, bk, density)
            p[0:bm] = 0                        # an empty block-row
            q = rng.standard_normal((k, n)).astype(np.float32)
            dense = torch.from_numpy(p @ q).to(device)
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                c = _bsr_case(f"test_{m}x{k}x{n}_{bm}x{bk}_d{density}", p, q,
                              bm, bk, bn, dtype, device)
                z = bsr_spmm(*c["args"], m_blocks=c["m_blocks"], bn=bn)
                zp = bsr_spmm_plain(*c["args"], m_blocks=c["m_blocks"])
                torch.cuda.synchronize()
                atol = tol * max(1.0, float(dense.abs().max()))
                check(float(z[0:bm].float().abs().max()) == 0.0,
                      f"{c['name']}: empty block-row is not zero")
                check(_allclose(z, zp, tol, atol),
                      f"{c['name']} {dtype}: kernel vs plain")
                check(_allclose(z, dense, tol, atol),
                      f"{c['name']} {dtype}: kernel vs dense fp32 product")
                results.append(dict(case=c["name"], dtype=c["dtype"],
                                    max_abs_err=_max_err(z, zp), tol=tol))
    blocks, col_idx, row_ptr = dense_to_bsr(np.zeros((32, 256), np.float32),
                                            8, 128)
    z = bsr_spmm(torch.from_numpy(blocks).to(device),
                 torch.from_numpy(col_idx).to(device),
                 torch.from_numpy(row_ptr).to(device),
                 torch.randn(256, 128, device=device), m_blocks=4)
    check(float(z.abs().max()) == 0.0, "all-zero P must give an all-zero Z")
    results.append(dict(case="all_zero", dtype="float32", max_abs_err=0.0,
                        tol=0.0))
    for bm in (64, 128):
        blocks, col_idx, row_ptr = dense_to_bsr(
            np.zeros((2 * bm, 256), np.float32), bm, 128)
        z = bsr_spmm(torch.from_numpy(blocks).to(device, torch.bfloat16),
                     torch.from_numpy(col_idx).to(device),
                     torch.from_numpy(row_ptr).to(device),
                     torch.randn(256, 256, device=device,
                                 dtype=torch.bfloat16), m_blocks=2, bn=32)
        check(float(z.float().abs().max()) == 0.0,
              f"all-zero P ({bm}-row blocks, bf16) must give an all-zero Z")
        results.append(dict(case=f"all_zero_{bm}x128", dtype="bfloat16",
                            route=bsr_plan(torch.bfloat16, bm, 128, 256).route,
                            max_abs_err=0.0, tol=0.0))
    # the wgmma route's edges: an empty, a fully dense (16 stored blocks:
    # the ring wraps several times) and a half-full block-row, on every
    # column tile and both swizzles of P
    for bm in (64, 128):
        for bk in (32, 64, 128):
            for n in (64, 96, 256, 512):
                p = _random_block_sparse(rng, 3 * bm, 16 * bk, bm, bk, 0.5)
                p[0:bm] = 0
                p[bm:2 * bm] = rng.standard_normal((bm, 16 * bk))
                q = rng.standard_normal((16 * bk, n)).astype(np.float32)
                c = _bsr_case(f"edge_{bm}x{bk}_N{n}", p, q, bm, bk, 32,
                              torch.bfloat16, device)
                z = bsr_spmm(*c["args"], m_blocks=3, bn=32)
                zp = bsr_spmm_plain(*c["args"], m_blocks=3)
                torch.cuda.synchronize()
                check(float(z[0:bm].float().abs().max()) == 0.0,
                      f"{c['name']}: empty block-row is not zero")
                _scaled_check(z, c["dense"].float() @ c["args"][3].float(),
                              c["name"], "the dense fp32 product")
                err, atol, share = _scaled_check(z, zp, c["name"], "plain")
                results.append(dict(case=c["name"], dtype=c["dtype"],
                                    route=c["kernel_route"], tile=c["tile"],
                                    max_abs_err=err, rtol=RTOL_BF16,
                                    atol=atol, err_over_tol=share))
    for c in bsr_cases:
        z = bsr_spmm(*c["args"], m_blocks=c["m_blocks"], bn=c["bn"])
        zp = bsr_spmm_plain(*c["args"], m_blocks=c["m_blocks"])
        dense = c["dense"].float() @ c["args"][3].float()
        _scaled_check(z, dense, c["name"], "the dense fp32 product")
        c["max_abs_err"], c["atol"], c["err_over_tol"] = _scaled_check(
            z, zp, c["name"], "plain")
        c["rtol"] = RTOL_BF16
        results.append(dict(case=c["name"], dtype=c["dtype"],
                            max_abs_err=c["max_abs_err"], rtol=RTOL_BF16,
                            atol=c["atol"], err_over_tol=c["err_over_tol"]))
    return results


def flash_checks(device, flash_cases, lm_case):
    import numpy as np
    import torch
    from repro_torch.models.attention import attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_plan)
    results = []
    rng = np.random.default_rng(2)
    for s, hd in ((256, 128), (512, 128), (256, 64)):
        q, k, v = (torch.from_numpy(
            rng.standard_normal((1, 2, s, hd)).astype(np.float32) * sc
        ).to(device) for sc in (0.3, 0.3, 1.0))
        for causal in (True, False):
            o32 = flash_attention_plain(q, k, v, causal=causal)
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
                a = tuple(t.to(dtype) for t in (q, k, v))
                o = flash_attention(*a, causal=causal)
                op = flash_attention_plain(*a, causal=causal)
                torch.cuda.synchronize()
                name = f"test_S{s}_hd{hd}_{'causal' if causal else 'full'}"
                check(_allclose(o, op, tol, tol), f"{name} {dtype}: kernel "
                      f"vs plain")
                check(_allclose(o, o32, tol, tol), f"{name} {dtype}: kernel "
                      f"vs the fp32 result")
                results.append(dict(case=name,
                                    dtype=str(dtype).replace("torch.", ""),
                                    max_abs_err=_max_err(o, op), tol=tol))
    q, k, v = (torch.randn(1, 1, 256, 128, device=device) for _ in range(3))
    o = flash_attention(q, k, v, causal=True)
    check(_allclose(o[0, 0, 0], v[0, 0, 0], 1e-5, 1e-6),
          "causal row 0 must equal v[0]")
    results.append(dict(case="causal_row0_is_v0", dtype="float32",
                        max_abs_err=_max_err(o[0, 0, 0], v[0, 0, 0]),
                        tol=1e-5))
    # the wgmma route's edges: half a query tile (192, 384) and the long
    # sequence, both head widths
    gen = torch.Generator(device="cpu").manual_seed(2)
    for b, h, s in ((1, 2, 192), (1, 2, 384), (1, 2, 4096)):
        for hd in (64, 128):
            q, k, v = ((torch.randn((b, h, s, hd), generator=gen) * sc
                        ).to(device, torch.bfloat16) for sc in (0.3, 0.3, 1.0))
            for causal in (True, False):
                name = f"edge_S{s}_hd{hd}_{'causal' if causal else 'full'}"
                o = flash_attention(q, k, v, causal=causal, bq=64, bk=64)
                op = flash_attention_plain(q, k, v, causal=causal)
                o32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                            causal=causal)
                torch.cuda.synchronize()
                _scaled_check(o, o32, name, "the fp32 result")
                err, atol, share = _scaled_check(o, op, name, "plain")
                results.append(dict(
                    case=name, dtype="bfloat16",
                    route=flash_plan(torch.bfloat16, s, hd).route,
                    max_abs_err=err, rtol=RTOL_BF16, atol=atol,
                    err_over_tol=share))
    for c in flash_cases:
        o = flash_attention(*c["args"], causal=c["causal"])
        op = flash_attention_plain(*c["args"], causal=c["causal"])
        c["max_abs_err"], c["atol"], c["err_over_tol"] = _scaled_check(
            o, op, c["name"], "plain")
        c["rtol"] = RTOL_BF16
        results.append(dict(case=c["name"], dtype=c["dtype"],
                            max_abs_err=c["max_abs_err"], rtol=RTOL_BF16,
                            atol=c["atol"], err_over_tol=c["err_over_tol"]))
    # the LM shape: the plain version's Python loop over 32,896 tile pairs
    # is skipped; the model's chunked route (fp32 scores and softmax) is
    # the PyTorch version held against the kernel there, row by row
    c = lm_case
    o = flash_attention(*c["args"], causal=True)
    q, k, v = (t.transpose(1, 2) for t in c["args"])
    ref = attention(q, k, v, causal=True, chunk=1024, force_chunked=True)
    c["max_abs_err"], c["err_over_tol"] = _row_scaled_check(
        o, ref.transpose(1, 2), c["name"], "the chunked route")
    c["rtol"], c["atol"] = RTOL_BF16, f"{ATOL_RMS}*rms(row)"
    results.append(dict(case=c["name"], dtype=c["dtype"],
                        against="the model's chunked route",
                        max_abs_err=c["max_abs_err"], rtol=RTOL_BF16,
                        atol=c["atol"], err_over_tol=c["err_over_tol"]))
    del o, ref
    return results


def bsr_bound(c):
    nbytes = 2 if c["dtype"] == "bfloat16" else 4
    flops = 2.0 * c["nnz"] * c["bm"] * c["bk"] * c["N"]
    moved = (c["nnz"] * c["bm"] * c["bk"] + c["K"] * c["N"]
             + c["M"] * c["N"]) * nbytes
    t_ops = flops / PEAK_FLOPS[c["dtype"]]
    t_bytes = moved / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, moved)


def flash_bound(c):
    nbytes = 2 if c["dtype"] == "bfloat16" else 4
    s = c["S"]
    pairs = s * (s + 1) / 2 if c["causal"] else float(s) * s
    flops = 4.0 * c["B"] * c["H"] * pairs * c["hd"]
    moved = 4.0 * c["B"] * c["H"] * s * c["hd"] * nbytes
    t_ops = flops / PEAK_FLOPS[c["dtype"]]
    t_bytes = moved / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, moved)


def kernel_timings(device, bsr_cases, flash_cases, lm_case):
    """Device times at the workload shapes: kernel, plain version, one
    library call (a yardstick only: the package never calls it), and the
    bound computed from this run's inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.bsr_spmm import (bsr_plan, bsr_spmm,
                                              bsr_spmm_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=device)
    for c in bsr_cases:
        a, mb, bn = c["args"], c["m_blocks"], c["bn"]
        c["ms"] = time_ms(lambda: bsr_spmm(*a, m_blocks=mb, bn=bn), 10, flush)
        c["plain_ms"] = time_ms(lambda: bsr_spmm_plain(*a, m_blocks=mb), 3,
                                flush)
        c["library_ms"] = time_ms(lambda: torch.matmul(c["dense"], a[3]), 10,
                                  flush)
        c["graph_ms"] = graph_ms(lambda: bsr_spmm(*a, m_blocks=mb, bn=bn))
        if c["kernel_route"] == "wgmma":   # the other grid order, once
            plan = bsr_plan(c["args"][0].dtype, c["bm"], c["bk"], c["N"])
            other = plan._replace(rows_fastest=not plan.rows_fastest)
            c["rows_fastest"] = plan.rows_fastest
            c["ms_other_grid_order"] = time_ms(
                lambda: bsr_spmm(*a, m_blocks=mb, bn=bn, plan=other), 10,
                flush)
        c["bound_ms"], c["bound_by"], c["flops"], c["bytes"] = bsr_bound(c)
    for c in flash_cases:
        a, causal = c["args"], c["causal"]
        c["ms"] = time_ms(lambda: flash_attention(*a, causal=causal), 5,
                          flush)
        c["plain_ms"] = time_ms(
            lambda: flash_attention_plain(*a, causal=causal), 1, flush)
        c["graph_ms"] = graph_ms(lambda: flash_attention(*a, causal=causal))
        c["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(*a, is_causal=causal), 10,
            flush)
        c["bound_ms"], c["bound_by"], c["flops"], c["bytes"] = flash_bound(c)
    from repro_torch.models.attention import attention
    c = lm_case
    a = c["args"]
    c["ms"] = time_ms(lambda: flash_attention(*a, causal=True), 5, flush)
    c["plain_ms"] = None
    c["plain_note"] = ("plain version skipped at this size (a Python loop "
                       "over 32,896 tile pairs); chunked_ms is the model's "
                       "chunked route")
    qt, kt, vt = (t.transpose(1, 2) for t in a)
    c["chunked_ms"] = time_ms(lambda: attention(
        qt, kt, vt, causal=True, chunk=1024, force_chunked=True), 1, flush)
    c["graph_ms"] = graph_ms(lambda: flash_attention(*a, causal=True), 5)
    c["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(*a, is_causal=True), 5, flush)
    c["bound_ms"], c["bound_by"], c["flops"], c["bytes"] = flash_bound(c)


def _case_row(c):
    keys = ("name", "dtype", "kernel_route", "tile", "max_abs_err", "rtol",
            "atol", "err_over_tol", "ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "flops", "bytes")
    row = {k: c[k] for k in keys}
    for key in ("rows_fastest", "ms_other_grid_order", "main_path",
                "plain_note", "chunked_ms"):
        if key in c:
            row[key] = c[key]
    row["tflops"] = c["flops"] / (c["ms"] * 1e-3) / 1e12
    row["share_of_bound"] = c["bound_ms"] / c["ms"]
    return row


def kernel_table(bsr_cases, flash_cases, lm_case, launches):
    """One entry per kernel; the headline numbers are those of its
    largest kernel-path shape, every shape is under ``cases``.
    ``launches`` sums the main paths' counts, ``launches_by_path`` holds
    each (``lm_prefill``: one forward of the LM)."""
    def entry(name, source, replaces, cases, head):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            kernel_route="/".join(sorted({c["kernel_route"] for c in cases})),
            launches=sum(launches[name].values()),
            launches_by_path=launches[name], shape=head["name"],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            tol=f"{ATOL_RMS}*rms + {RTOL_BF16}*|x| (lm case: rms per row)",
            err_over_tol=max(c["err_over_tol"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            cases=[_case_row(c) for c in cases])
    return [
        entry("bsr_spmm", "src/repro_torch/kernels/csrc/bsr_spmm.cu",
              "src/repro/kernels/bsr_spmm.py:89", bsr_cases, bsr_cases[1]),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:87",
              flash_cases + [lm_case], flash_cases[0]),
    ]


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's JSON to this file")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import torch.backends.cuda
    # float32 products in full float32, here and in every plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce in fp32, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    # the port's package first: where it is missing nothing is printed
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.flash_attention import flash_attention

    card = card_line()
    print(card, flush=True)

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    check(all((build_dir / f"lib{s.stem}.so").is_file()
              for s in _build.sources()), "a kernel library is missing")
    report["build"] = dict(phase="build", seconds=time.perf_counter() - t0,
                           sources=[s.name for s in _build.sources()])
    emit(report["build"])

    # ---- the main path, with every launch count at 0 just before it ----
    bsr_cases, flash_cases = workload_cases(device)
    bsr_spmm.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    report["search"] = search_phase(device)
    kernel_path(bsr_cases, flash_cases)
    launches = dict(bsr_spmm=bsr_spmm.launches,
                    flash_attention=flash_attention.launches)
    for name, n in launches.items():
        check(n > 0, f"the main path never launched the {name} kernel")
    report["search"]["kernel_launches_on_main_path"] = launches
    report["search"]["seconds"] = time.perf_counter() - t0
    emit(report["search"])

    for name, phase in (("fleet", fleet_phase), ("serve", serve_phase),
                        ("lm", lm_phase), ("evaluator", evaluator_phase)):
        t0 = time.perf_counter()
        report[name] = phase(device)
        report[name]["seconds"] = time.perf_counter() - t0
        emit(report[name])

    t0 = time.perf_counter()
    lm_case = lm_flash_case(device)
    checks = dict(bsr_spmm=bsr_checks(device, bsr_cases),
                  flash_attention=flash_checks(device, flash_cases, lm_case))
    kernel_timings(device, bsr_cases, flash_cases, lm_case)
    torch.cuda.synchronize()
    by_path = dict(
        bsr_spmm=dict(kernel_path=launches["bsr_spmm"]),
        flash_attention=dict(
            kernel_path=launches["flash_attention"],
            lm_prefill=report["lm"]["prefill"]["launches"]["flash_kernel"]))
    table = kernel_table(bsr_cases, flash_cases, lm_case, by_path)
    report["kernels"] = dict(
        phase="kernels", checks_passed={k: len(v) for k, v in checks.items()},
        checks=checks, kernels=table, seconds=time.perf_counter() - t0)
    emit(dict(phase="kernels", card=card,
              seconds=report["kernels"]["seconds"],
              checks_passed=report["kernels"]["checks_passed"],
              worst_check={k: max(v, key=lambda r: r["max_abs_err"])
                           for k, v in checks.items()}))
    for row in table:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            check(math.isfinite(row[key]) and row[key] >= 0,
                  f"{row['name']}: {key} is not a finite number")

    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    emit(dict(phase="total", seconds=report["seconds"], card=card))
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
