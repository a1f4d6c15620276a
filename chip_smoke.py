#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device and ``nvcc``; it exits non-zero, printing no result,
where there is no CUDA device or the port's package is missing.  It

1. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   ahead of the timed phases (``benchmarks/prewarm_cache_torch.py``: the
   ``build`` line names the directory, the objects and the seconds);
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
   then the fleet sharded over a ``SearchMesh`` (every visible GPU, or
   two shards of the one card): a sharded ``eval_stacked`` and an 8-task
   segment fleet against one device, and the Table III fleet sharded
   against unsharded, all bit for bit (the ``fleet_mesh`` line); the
   port's contract analysis (``repro_torch.analysis``: 0 findings) and
   deferred dispatches, plain and sharded, under
   ``torch.cuda.set_sync_debug_mode("error")`` (the ``analysis`` line);
   and ``benchmarks/run_torch.py --quick --only
   sweep_json,es_ops,device_rounds``, its record in
   ``chiprun_out/BENCH_sweep_torch.json`` held to the reference's absolute
   gates and compared with the committed CPU baseline (the ``bench``
   line);
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
6. drives the paper's tables (``benchmarks/paper_tables_torch.py``):
   Table IV at the paper's budget of 20,000 — 28 workloads x 3 platforms
   x 3 methods, one ``run_method_sweep`` fleet per platform — with every
   finite best EDP against the numpy oracle and three rows against
   ``table_iv`` run one search at a time, bit for bit; then the LLM-GEMM
   scenario ``examples/search_accelerator_torch.py`` at its defaults;
7. trains ``mistral-nemo-12b`` at full width with its depth cut to 8
   layers (``launch.train.run_train``: seq 4,096, batch 1, remat "full",
   8 steps), times the steps beside their bound and splits a step's device
   time by family, and checks that the flash kernel was not launched
   (the kernel has no backward), that every layer's ``wq``/``wk``/``wv``
   gets a gradient, that 2 microbatches give 1's loss and gradients, and
   that a 2-layer model's loss falls on a fixed batch;
8. drives the recurrent families (``repro_torch.models.ssm``, the
   ``mlstm`` / ``slstm`` / ``mamba2`` blocks, zamba2's shared attention
   block) at full width in bf16 with random weights from a seed:
   ``xlstm-350m`` (24 layers) and ``zamba2-2.7b`` (54 layers) each with
   one prefill forward (4,096 and 32,768 tokens), the ``serve decode``
   loop (batch 4, prompt 64, 32 generated), a few ``run_train`` steps
   (xlstm: seq 1,024, batch 4, full depth; zamba2: seq 4,096, batch 1,
   12 layers), and checks: forward against ``decode_step`` in fp32 over
   512 positions on the first super-blocks, every gradient leaf finite
   and nonzero, generated tokens in range, no kernel launched (xlstm has
   no attention, zamba2's head size 80 is not the flash kernel's); one
   JSON line per arch;
9. drives the mixture-of-experts models (``models.moe``, ``MoeBlock``) at
   full width in bf16 with random weights from a seed, one JSON line
   each: ``arctic-480b`` cut to 2 of 35 layers (128 experts top 2 and the
   dense residual FFN; prefill of 32,768 tokens with the flash kernel in
   both layers, the share of (token, slot) pairs dropped for capacity,
   the ``serve decode`` loop, ``run_train`` with the experts cut to 16)
   and ``kimi-k2-1t-a32b`` cut to 1 of 61 layers (384 experts top 8,
   prefill of 8,192 tokens on the chunked route, hd 112; decode); checks
   at arctic's widths: forward against 256 ``decode_step`` calls in fp32
   without drops, the flash route against the chunked one over the
   positions whose whole context was routed alike, grouped against flat dispatch, training's
   losses, balance loss and every gradient (each expert's slice
   included), a falling loss on a fixed batch;
10. drives the encoder-decoder ``seamless-m4t-large-v2`` at full size (24
    + 24 layers, bf16): a prefill of 32,768 tokens on 32,768 frames with
    all 72 attentions on the flash kernel (encoder self-attention and
    cross-attention in its full mode), the ``serve decode`` loop (its
    encoder once, on the kernel), ``run_train`` at seq 1,024, and checks:
    flash against chunked, decode against forward, every gradient;
11. drives the vision-language model ``qwen2-vl-7b`` at full size (28
    layers, bf16, M-RoPE): a prefill of 256 frontend embeddings + 32,512
    text tokens with the flash kernel in all 28 layers (GQA 28/4), the
    ``serve decode`` loop, ``run_train`` at 8 layers and seq 4,096, and
    checks: flash vs chunked, fp32 forward vs ``decode_step``, gradients,
    no flash launch in training, a falling loss on a fixed batch;
12. drives the multi-device training path on the card's world of one:
    an NCCL process group, a (1, 1) ("data", "model") ``DeviceMesh``, the
    self-test's four checks (pipeline, int8 all-reduce, sharded vs single
    train step, elastic restore) and ``run_train`` of the 8-layer
    ``qwen2-vl-7b`` in fp32 over the mesh against the un-meshed run; then,
    with one card, two gloo ranks sharing it: a (1, 2) tensor-parallel
    mesh (qwen2-vl, 2 layers) and a (2, 1) data-parallel MoE mesh (arctic,
    1 layer of 8 experts, each rank holding every expert at half its
    hidden width: ``w1`` ``[8, 7168, 2432]``; the tokens gathered over
    "data"), the same mesh at a width of 512 where the rule gathers the
    experts' slices instead (the weights form), fp32, each against the
    world of one, and arctic's routed FFN at full width on (2, 1) in both
    width forms on the same rows, the weights form against the tokens
    form (seconds, peak memory, each rank's expert rows); with four or
    more cards, one NCCL rank a card: the
    8-layer qwen2-vl on (1, 4) and (2, 2) against one card, the MoE on
    (2, 2) (16 experts, 8 a rank at half their width) in each width form
    against one card, arctic at its full width and 128 experts, 2 layers, bf16, on (2, 2)
    (64 experts a rank at half their width), then ``mistral-nemo-12b`` at
    its full 40 layers on (1, 4) (peak memory, ms a step, collective
    bytes);
13. holds the GPU evaluator against the CPU one on 262,144 genomes per
    workload and measures its rows per second;
14. holds each kernel against its plain PyTorch version on the card — the
    reference's test shapes, the edges of each route's tiles (half a query
    tile, empty, fully dense and all-zero block-rows, every column tile) and
    the workload shapes; at the model prefills' attention shapes
    (``mistral-nemo-12b``, ``arctic-480b``, ``seamless-m4t-large-v2``,
    ``qwen2-vl-7b``)
    against the model's chunked route — and times kernel, plain version
    and one library call beside the least time the card could take
    (``bound_ms``).  Each
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
import contextlib
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


def card_lines() -> list:
    """``nvidia-smi``'s name and power limit of every visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


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


def _capture_dispatches(fleet, n_tasks):
    """Step a fleet of its own until it has made one segment call and one
    stacked call of all ``n_tasks`` tasks; their (models, inputs)."""
    from repro_torch.core import torch_cost
    seen = {}
    run_segments, eval_stacked = torch_cost.run_segments, \
        torch_cost.eval_stacked

    def keep_segments(models, segs, **kw):
        if len(segs) == n_tasks and any(s.carry is not None for s in segs):
            seen.setdefault("seg", (list(models), list(segs)))
        return run_segments(models, segs, **kw)

    def keep_stacked(models, batches, **kw):
        if len(batches) == n_tasks:
            seen.setdefault("stacked", (list(models), list(batches)))
        return eval_stacked(models, batches, **kw)

    torch_cost.run_segments, torch_cost.eval_stacked = keep_segments, \
        keep_stacked
    try:
        fleet.start()
        while len(seen) < 2 and fleet.step():
            pass
    finally:
        torch_cost.run_segments, torch_cost.eval_stacked = run_segments, \
            eval_stacked
    check(len(seen) == 2, f"the fleet made no segment with carries or no "
          f"stacked call of all {n_tasks} tasks")
    return seen["seg"], seen["stacked"]


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
    (models, segs), (models_s, batches) = _capture_dispatches(
        table3_fleet(), len(table3))

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


# -------------------------------------------------------------- fleet mesh

MESH_FLEET_BUDGET = FLEET_BUDGET


def _search_mesh(device):
    """The mesh the sharded fleet runs on: every visible GPU where there
    are two or more, else two shards of the one card (``make_search_mesh``
    must give ``None`` there)."""
    import torch
    from repro_torch.core.torch_cost import SearchMesh
    from repro_torch.launch.mesh import make_search_mesh
    if torch.cuda.device_count() > 1:
        mesh = make_search_mesh()
        check(mesh is not None and len(mesh.devices) ==
              torch.cuda.device_count(), "make_search_mesh() did not take "
              "every visible GPU")
        return mesh, "every visible GPU"
    check(make_search_mesh() is None, "make_search_mesh() on one visible "
          "GPU did not return None")
    return SearchMesh((device, device), ("rows",)), "two shards of one card"


def fleet_mesh_phase(device):
    """The fleet sharded over a ``SearchMesh``: the reference's two checks
    (``tests/test_device_rounds.py``: a sharded ``eval_stacked`` and an
    8-task segment fleet against one device, bit for bit), then the 28
    Table III workloads at the full budget as one fleet, sharded against
    unsharded."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_workloads import all_workloads, by_name
    from repro_torch.core import search, torch_cost
    from repro_torch.core.torch_cost import ndev

    mesh, mesh_kind = _search_mesh(device)
    n = ndev(mesh)

    # ---- (1) a sharded mega-batch, bit for bit
    spec, ev = search.get_evaluator(by_name("mm1"), "cloud", device=device)
    rng = np.random.default_rng(0)
    batches = [spec.random_genomes(rng, m) for m in (48, 50, 64)]
    models = [ev] * len(batches)
    plain = torch_cost.eval_stacked(models, batches)
    shard = torch_cost.eval_stacked(models, batches, mesh=mesh)
    for p, s in zip(plain, shard):
        for k in p:
            check(np.array_equal(p[k], s[k]),
                  f"fleet_mesh: sharded eval_stacked differs in {k}")

    # ---- (2) an 8-task segment fleet, bit for bit
    def fleet8(m):
        tasks = [search.SearchTask(by_name("mm1"), "cloud", budget=700,
                                   seed=s, name=f"t{s}") for s in range(8)]
        ms = search.MultiSearch(tasks, search.FleetConfig(
            stack_batches=True, device_rounds=4, mesh=m), device=device)
        return ms.run(), ms.stats

    res1, st1 = fleet8(None)
    resn, stn = fleet8(mesh)
    check(stn["devices"] == n and st1["devices"] == 1,
          f"fleet_mesh: devices {stn['devices']} / {st1['devices']}")
    check(stn["host_syncs_per_round"] <= 0.25,
          f"fleet_mesh: {stn['host_syncs_per_round']} host syncs a round")
    for name in res1:
        check(res1[name].best_edp == resn[name].best_edp and
              np.array_equal(res1[name].history, resn[name].history),
              f"fleet_mesh: 8-task fleet {name} differs sharded "
              f"({resn[name].best_edp} vs {res1[name].best_edp})")

    # ---- (3) the Table III fleet at full width, sharded vs not
    table3 = all_workloads()

    def table3_fleet(m):
        return search.MultiSearch(
            [search.SearchTask(wl, "cloud", budget=MESH_FLEET_BUDGET, seed=0)
             for wl in table3],
            search.FleetConfig(stack_batches=True, mesh=m), device=device)

    runs, results = {}, {}
    for label, m in (("unsharded", None), ("sharded", mesh),
                     ("sharded_again", mesh), ("unsharded_again", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = table3_fleet(m)
        results[label] = ms.run()
        torch.cuda.synchronize()
        st = ms.stats
        runs[label] = dict(
            wall_s=time.perf_counter() - t0, rounds=st["rounds"],
            dispatches=st["dispatches"], host_syncs=st["host_syncs"],
            host_syncs_per_round=st["host_syncs_per_round"],
            host_blocked_s=st["host_blocked_s"], devices=st["devices"],
            device_rounds=st["device_rounds"])
    check(runs["sharded"]["devices"] == n, "fleet_mesh: the Table III "
          "fleet did not shard")
    for label in ("sharded", "sharded_again", "unsharded_again"):
        for name, r in results["unsharded"].items():
            s = results[label][name]
            check(r.best_edp == s.best_edp and r.evals == s.evals and
                  np.array_equal(r.history, s.history),
                  f"fleet_mesh: Table III {name} differs {label} "
                  f"({s.best_edp} vs {r.best_edp})")

    # one segment call and one stacked call of all 28 tasks, sharded and
    # not, outside every timed fleet
    (seg_models, segs), (st_models, st_batches) = _capture_dispatches(
        table3_fleet(None), len(table3))
    segment = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        def one_segment(m=m):
            return [r.resolve() for r in torch_cost.run_segments(
                seg_models, segs, mesh=m)]

        def one_stacked(m=m):
            return torch_cost.eval_stacked(st_models, st_batches, mesh=m)
        segment[label] = dict(
            ms_per_segment=wall_ms(one_segment),
            device_ops_per_segment=count_device_launches(one_segment),
            ms_per_stacked_call=wall_ms(one_stacked),
            device_ops_per_stacked_call=count_device_launches(one_stacked))
    return dict(
        phase="fleet_mesh", device=str(device), mesh=mesh_kind, shards=n,
        mesh_devices=[str(d) for d in mesh.devices],
        checks=dict(eval_stacked_rows=[48, 50, 64], eval_stacked="bit-equal",
                    fleet8="bit-equal", fleet8_devices=stn["devices"],
                    fleet8_host_syncs_per_round=stn["host_syncs_per_round"],
                    table3="bit-equal in all four runs"),
        table3=dict(tasks=len(table3), budget=MESH_FLEET_BUDGET, runs=runs,
                    sharded_over_unsharded_wall=(
                        (runs["sharded"]["wall_s"] +
                         runs["sharded_again"]["wall_s"]) /
                        (runs["unsharded"]["wall_s"] +
                         runs["unsharded_again"]["wall_s"])),
                    segment_tasks=len(segs), segment_rounds=segs[0].rounds,
                    stacked_rows=sum(len(b) for b in st_batches),
                    calls=segment),
        cross_device_cost="not measured" if len(set(mesh.devices)) == 1
        else "measured: shards on distinct cards")


# ---------------------------------------------------------------- analysis


def analysis_phase(device):
    """The port's contract analysis on the card: the lint (R2-R5) and the
    graph audit over the port's files, then the on-card half of R3 — one
    deferred ``eval_stacked`` and one deferred ``run_segments`` (each
    plain and sharded) issued under ``torch.cuda.set_sync_debug_mode
    ("error")``, where any synchronising call raises."""
    import numpy as np
    import torch
    from repro_torch.analysis import default_roots, run_report
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import search, torch_cost

    t0 = time.perf_counter()
    rep = run_report(roots=default_roots(HERE), include_graph=True,
                     include_scan=True)
    report_s = time.perf_counter() - t0
    findings = rep["lint"]["violations"] + rep["graph"]["findings"]
    check(rep["ok"] and not findings,
          f"analysis: {len(findings)} finding(s): {findings[:5]}")

    # inputs of a live fleet: 8 tasks, segments with carries, a stacked
    # call; every evaluator, twin and table built before the checked run
    mesh, _ = _search_mesh(device)
    wls = [by_name(n) for n in ("mm1", "mm3")]
    fleet = search.MultiSearch(
        [search.SearchTask(wls[s % 2], "cloud", budget=2000, seed=s,
                           name=f"a{s}") for s in range(8)],
        search.FleetConfig(stack_batches=True, device_rounds=4),
        device=device)
    (seg_models, segs), (st_models, st_batches) = _capture_dispatches(
        fleet, 8)
    for m in (None, mesh):
        torch_cost.eval_stacked(st_models, st_batches, mesh=m)
        [r.resolve() for r in torch_cost.run_segments(seg_models, segs,
                                                      mesh=m)]
    torch_cost.clear_stack_cache()      # the checked calls build them
    torch.cuda.synchronize()

    pending = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for label, m in (("plain", None), ("sharded", mesh)):
            pending[label] = (
                torch_cost.eval_stacked(st_models, st_batches, mesh=m,
                                        defer=True),
                torch_cost.run_segments(seg_models, segs, mesh=m,
                                        defer=True))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    outs = {}
    for label, (stacked, seg_res) in pending.items():
        outs[label] = (stacked.finalize(), [r.resolve() for r in seg_res])
    for a, b in zip(outs["plain"][0], outs["sharded"][0]):
        for k in a:
            check(np.array_equal(a[k], b[k]), f"analysis: deferred "
                  f"eval_stacked plain vs sharded differs in {k}")
    for a, b in zip(outs["plain"][1], outs["sharded"][1]):
        check(np.array_equal(a.final_pop, b.final_pop) and
              np.array_equal(a.final_edp, b.final_edp),
              "analysis: deferred run_segments plain vs sharded differs")
    return dict(
        phase="analysis", device=str(device), ok=rep["ok"],
        findings=len(findings), report_s=report_s,
        rule_counts=rep["lint"]["rule_counts"],
        lint_seconds=rep["lint"]["seconds"],
        graph_seconds=rep["graph"]["seconds"],
        families=rep["graph"]["families"], graph_hashes=rep["graph"]["hashes"],
        sync_debug=dict(mode="error", calls=[
            "eval_stacked(defer=True)", "run_segments(defer=True)",
            "the same, sharded"], stacked_rows=sum(len(b) for b in
                                                   st_batches),
            segment_tasks=len(segs), raised=False))


# ------------------------------------------------------------------- bench

BENCH_ARGS = ("--quick", "--only", "sweep_json,es_ops,device_rounds")


def bench_phase(device):
    """``benchmarks/run_torch.py --quick --only sweep_json,es_ops,
    device_rounds`` on the card: ``BENCH_sweep_torch.json`` written to
    ``chiprun_out/``, the reference's absolute gates, and
    ``compare_sweep_torch`` against the committed CPU baseline over the
    entries whose ``device_rounds`` are explicit (the others' default is
    per backend)."""
    import io
    from benchmarks import compare_sweep_torch, run_torch

    out_path = os.path.join(HERE, "chiprun_out", "BENCH_sweep_torch.json")
    os.environ["REPRO_BENCH_SWEEP_JSON_TORCH"] = out_path
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_torch.main(list(BENCH_ARGS))
    wall = time.perf_counter() - t0
    csv = buf.getvalue().splitlines()
    with open(out_path) as f:
        cur = json.load(f)
    with open(os.path.join(HERE, "benchmarks",
                           "BENCH_sweep_torch.baseline.json")) as f:
        base = json.load(f)
    check(cur["device"].startswith("cuda"), f"bench ran on {cur['device']}")
    archs = {a["arch"]: a for a in cur["archs"]}
    base_archs = {a["arch"]: a for a in base["archs"]}
    for name in ("structured_cloud", "serve_coalesce"):
        check(archs[name]["dispatches_per_round"] == 1.0,
              f"bench: {name} at {archs[name]['dispatches_per_round']} "
              f"dispatches a round, expected 1.0")
    for name in ("cloud_device_k4", "cloud_device_k4_unpipelined"):
        check(archs[name]["host_syncs_per_round"] <=
              base_archs[name]["host_syncs_per_round"],
              f"bench: {name} at {archs[name]['host_syncs_per_round']} "
              f"host syncs a round, the CPU baseline "
              f"{base_archs[name]['host_syncs_per_round']}")
    check(cur["analysis"]["violations"] == 0,
          f"bench: {cur['analysis']['violations']} analysis violations")
    entries = compare_sweep_torch.explicit_entries(base)
    failures, warnings = compare_sweep_torch.compare(base, cur, entries)
    cells = {(c["arch"], c["method"], c["workload"]): c["best_edp"]
             for c in base["cells"]}
    edps = [dict(arch=c["arch"], method=c["method"], workload=c["workload"],
                 gpu=c["best_edp"],
                 cpu_baseline=cells.get((c["arch"], c["method"],
                                         c["workload"])))
            for c in cur["cells"] if c["arch"] in entries]
    return dict(
        phase="bench", device=str(device), args=list(BENCH_ARGS),
        wall_s=wall, path=os.path.relpath(out_path, HERE), csv=csv,
        compared_entries=entries, compare_failures=failures,
        compare_warnings=warnings, best_edps=edps,
        entries={name: {k: a.get(k) for k in (
            "seconds", "rounds", "dispatches_per_round",
            "host_syncs_per_round", "device_rounds", "device_rounds_source",
            "host_blocked_s", "n_devices")} for name, a in archs.items()},
        analysis=cur["analysis"])


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


def _is_annotation(e):
    return bool(getattr(e, "is_user_annotation", False))


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
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not _is_annotation(e):
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


def _reset_flash_counts():
    """Set the flash kernel's launch count and the attention routes'
    call counts to 0."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import attention
    flash_attention.launches = 0
    attention.calls.update(flash=0, chunked=0)


def _flash_counts():
    """The flash kernel's launches and the attention routes' calls since
    the last :func:`_reset_flash_counts`."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import attention
    return dict(flash_kernel=flash_attention.launches,
                route_flash=attention.calls["flash"],
                route_chunked=attention.calls["chunked"])


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
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.model import Model

    reset, counts = _reset_flash_counts, _flash_counts
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
    prompts = torch.from_numpy(serve.make_inputs(cfg.vocab_size, b, pl_)[0]
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



# ------------------------------------------------------------------ tables

TABLES_BUDGET = 20_000          # the paper's budget per search
TABLES_PLATFORMS = ("edge", "mobile", "cloud")
TABLES_DEVICE_ROUNDS = 1
# rows rerun one search at a time through paper_tables_torch.table_iv,
# one on each platform; each compares all three methods
TABLES_SEQUENTIAL_ROWS = (("mm1", "edge"), ("conv4", "mobile"),
                          ("mm8", "cloud"))
# examples/search_accelerator_torch.py at its defaults (budget 4,000)
SCENARIO_ARGS = ()
SCENARIO_BUDGET = 4000


def _same_float(a, b):
    return (math.isnan(a) and math.isnan(b)) or a == b


def _geomean(xs):
    xs = [x for x in xs if math.isfinite(x) and x > 0]
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else None


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tables_phase(device):
    """The paper's Table IV at its budget of 20,000: the 28 Table III
    workloads x 3 methods as one ``run_method_sweep`` fleet per platform
    (one generation a round, as ``search.run`` takes them),
    each finite best EDP held against the float64 numpy oracle on its
    decoded design, three rows against ``paper_tables_torch.table_iv`` run
    one search at a time (bit for bit); then the LLM-GEMM scenario,
    ``examples/search_accelerator_torch.py`` at its defaults."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from benchmarks import paper_tables_torch as tables
    from repro_torch.configs.paper_workloads import all_workloads
    from repro_torch.core import search

    methods = list(tables.TABLE_IV_METHODS)
    wls = all_workloads()
    out = dict(budget=TABLES_BUDGET, workloads=len(wls), methods=methods,
               platforms=list(TABLES_PLATFORMS))
    rows, fleets, n_oracle = [], [], 0
    t_grid = time.perf_counter()
    for plat in TABLES_PLATFORMS:
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # one generation a round: the computation of table_iv's one
        # search at a time (device segments of k > 1 generations take
        # another trajectory, in the reference too)
        grid = search.run_method_sweep(methods, wls, plat,
                                       budget=TABLES_BUDGET, seed=0,
                                       stats_out=stats, device=device,
                                       device_rounds=TABLES_DEVICE_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(stats["device"].startswith("cuda"),
              f"tables {plat}: the fleet is not on the GPU")
        for wl in wls:
            for m in methods:
                res = grid[m][wl.name]
                check(res.evals == TABLES_BUDGET,
                      f"tables {m}/{wl.name}@{plat}: {res.evals} evals != "
                      f"{TABLES_BUDGET}")
                if not np.isfinite(res.best_edp):
                    continue
                rep = search.report_best(wl, plat, res)
                check(rep is not None and rep.valid,
                      f"tables {m}/{wl.name}@{plat}: the numpy oracle calls "
                      f"the best design invalid")
                lg, lg_o = float(np.log10(res.best_edp)), float(
                    np.log10(rep.edp))
                check(abs(lg - lg_o) <= LG_TOL * max(abs(lg_o), 1.0),
                      f"tables {m}/{wl.name}@{plat}: log10 EDP {lg} vs "
                      f"oracle {lg_o}")
                n_oracle += 1
            rows.append(tables.table_iv_row(
                wl.name, plat, {m: grid[m][wl.name].best_edp
                                for m in methods}))
        fleets.append(dict(platform=plat, searches=len(wls) * len(methods),
                           wall_s=wall, rounds=stats["rounds"],
                           dispatches=stats["dispatches"],
                           host_syncs=stats["host_syncs"],
                           device_rounds=stats["device_rounds"],
                           signatures=len(stats["signatures"]),
                           host_blocked_s=stats["host_blocked_s"]))
    out["grid_wall_s"] = time.perf_counter() - t_grid
    out["fleets"] = fleets
    out["oracle_checked"] = n_oracle
    out["geomean_speedup_vs_sparseloop"] = _geomean(
        [r["speedup_vs_sparseloop"] for r in rows])
    out["geomean_speedup_vs_sage"] = _geomean(
        [r["speedup_vs_sage"] for r in rows])
    out["rows_with_finite_sparsemap"] = sum(
        1 for r in rows if math.isfinite(r["sparsemap"]))
    out["rows"] = rows

    # three rows again, one search at a time, through table_iv itself
    by_key = {(r["workload"], r["platform"]): r for r in rows}
    seq = []
    out_dir = tables.OUT_DIR
    with tempfile.TemporaryDirectory() as tmp:
        tables.OUT_DIR = tmp        # table_iv writes its CSV; keep none
        for wname, plat in TABLES_SEQUENTIAL_ROWS:
            t0 = time.perf_counter()
            (row,) = tables.table_iv(budget=TABLES_BUDGET, seed=0,
                                     platforms=(plat,),
                                     workload_names=[wname], device=device)
            torch.cuda.synchronize()
            fleet_row = by_key[(wname, plat)]
            check(list(row) == list(fleet_row) and all(
                _same_float(row[k], fleet_row[k]) if isinstance(row[k], float)
                else row[k] == fleet_row[k] for k in row),
                f"tables: table_iv row {wname}@{plat} one search at a time "
                f"{row} differs from the fleet's {fleet_row}")
            seq.append(dict(workload=wname, platform=plat,
                            wall_s=time.perf_counter() - t0))
    tables.OUT_DIR = out_dir
    out["sequential_rows_bit_equal"] = seq

    # the LLM-GEMM scenario at its defaults
    example = _load_example("search_accelerator_torch")
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        grids = example.main(list(SCENARIO_ARGS))
    torch.cuda.synchronize()
    scen_wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for plat, grid in grids.items():
        for m, g in grid.items():
            for w, r in g.items():
                check(r.evals == SCENARIO_BUDGET,
                      f"scenario {m}/{w}@{plat}: {r.evals} evals")
    out["scenario"] = dict(
        args=list(SCENARIO_ARGS) or "defaults (kimi-k2-1t-a32b, budget "
        "4000, edge,cloud)", wall_s=scen_wall,
        platforms=sorted(grids), lines=lines)
    out["card"] = card_line()
    return out


# ------------------------------------------------------------------- train

TRAIN_ARCH = LM_ARCH
TRAIN_LAYERS = 8        # n_super: 3.52 B parameters, ~42 GB with moments
TRAIN_SEQ = 4096        # train_4k's length; its batch of 256 is a pod's
TRAIN_BATCH = 1
TRAIN_STEPS = 8
TRAIN_WARMUP = 2        # steps left out of the step time
# checks (3) and (4): a 2-layer fp32 model of the same width, batch 2
TRAIN_CHECK = (2, 2, 1024)      # layers, batch, sequence
# check (3): microbatches 1 and 2 agree at fp32: the loss within
# TRAIN_LOSS_RTOL of itself, each gradient leaf within TRAIN_GRAD_RTOL of
# its largest element (two GEMM shapes sum in different orders)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# check (4): ``tests/test_archs_smoke.py::test_loss_decreases_on_fixed_batch``
# (lr 3e-3 at the smoke width d = 64) at full width.  Weights are drawn
# with std 1/sqrt(d), and an AdamW step moves each by about lr, so the lr
# is scaled by sqrt(64 / d) to keep the test's step-to-weight ratio: at
# lr 3e-3 and d = 5,120 a step moves each weight by ~20 % of its size and
# the loss climbs (both packages do the same on the CPU from d = 2,048).
# The unscaled lr is run too, and recorded.
TRAIN_LR_SMOKE = 3e-3
TRAIN_CHECK_STEPS = 8
TRAIN_MIN_DROP = 0.2
def opt_bytes_per_param(moment_dtype="float32"):
    """The optimizer's least traffic a step, per parameter: read the bf16
    weight and gradient and both moments (fp32, or bf16 where the model
    keeps them so), write the weight and both moments: 22 bytes, 14 with
    bf16 moments."""
    m = 2 if moment_dtype == "bfloat16" else 4
    return 2 + 2 + 2 * m + 2 + 2 * m


OPT_BYTES_PER_PARAM = opt_bytes_per_param()


@contextlib.contextmanager
def _labelled(module, attr, label, times=None):
    """Run ``module.attr`` under ``torch.profiler.record_function(label)``
    for the duration of the block (looked up at call time, so every
    caller of the module attribute is labelled).  With ``times``, each
    call also appends a pair of CUDA events recorded around it."""
    import torch
    fn = getattr(module, attr)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            if times is None:
                return fn(*a, **kw)
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            try:
                return fn(*a, **kw)
            finally:
                pair[1].record()
                times.append(pair)

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, fn)


#: the ranges a train step is labelled with while it is profiled, and the
#: family of the kernels that run inside each range's span on the device
TRAIN_LABELS = {
    "repro.optimizer": "optimizer (AdamW apply)",
    "repro.chunked_attention": "chunked attention, forward and recompute "
                               "(its backward counts as GEMM and other)"}


def device_ms_by_family(fn, labels):
    """Device ms of one call of ``fn`` by family.  A record_function
    range shows on the device timeline as a user annotation spanning the
    kernels launched inside it: a kernel inside the span of a range named
    in ``labels`` goes to that label's family, any other by its name
    (``_kernel_family``).  Returns the families, the total device ms, the
    number of device operations and the 15 longest kernel names (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, kernels = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if _is_annotation(e):
            if e.name in labels:
                spans.setdefault(labels[e.name], []).append(
                    (e.time_range.start, e.time_range.end))
            continue
        kernels.append(e)
    check(kernels, "torch.profiler saw no device operation")
    fams, by_name = {}, {}
    for e in kernels:
        a, b = e.time_range.start, e.time_range.end
        fam = next((f for f, iv in spans.items()
                    if any(s <= a and b <= t for s, t in iv)), None) or \
            _kernel_family(e.name)
        ms = e.time_range.elapsed_us() / 1e3
        fams[fam] = fams.get(fam, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15])
    return (dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            sum(fams.values()), len(kernels), top)


def train_flops(cfg, batch, seq):
    """Model FLOPs of one training step: 3 x the forward's (its weight
    products and causal attention; remat's recompute not counted)."""
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    qkv_o = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
    tokens = batch * seq
    weights = 2.0 * tokens * (L * (qkv_o + 3 * d * ff) + d * v)
    attn = 4.0 * batch * cfg.n_heads * (seq * (seq + 1) / 2) * cfg.hd * L
    return 3.0 * (weights + attn), 3.0 * weights, 3.0 * attn


def train_phase(device):
    """Training on the card: ``mistral-nemo-12b`` at full width, depth cut
    to 8 layers, bf16, ``SyntheticLM`` at seq 4,096, batch 1, remat
    "full", 8 steps through ``launch.train.run_train``; then checks (2)
    every layer's ``wq``/``wk``/``wv`` gets a nonzero finite gradient,
    (3) microbatches 1 and 2 agree, (4) the loss of a 2-layer fp32 model
    of the same width drops on a fixed batch."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import run_train
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.model import Model
    from repro_torch.optim import optimizer as opt

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_super=TRAIN_LAYERS)
    check(cfg.remat == "full", f"{cfg.name}: remat {cfg.remat!r}")
    out = dict(arch=TRAIN_ARCH, layers=cfg.n_layers, seq=TRAIN_SEQ,
               batch=TRAIN_BATCH, steps=TRAIN_STEPS, remat=cfg.remat,
               dtype=cfg.param_dtype)
    lines = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    flash_attention.launches = 0
    attn_lib.attention.calls.update(flash=0, chunked=0)
    t0 = time.perf_counter()
    res = run_train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    device=device, log_every=1, log=lines.append)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    launches = dict(flash_kernel=flash_attention.launches,
                    route_flash=attn_lib.attention.calls["flash"],
                    route_chunked=attn_lib.attention.calls["chunked"])
    out["launches"] = launches
    losses = res["losses"]
    # check (1)
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train: losses {losses}")
    check(launches["flash_kernel"] == 0 and launches["route_flash"] == 0,
          f"train: {launches}; training must not run the forward-only "
          f"flash kernel")
    model, state = res["model"], res["opt_state"]
    n_params = sum(p.numel() for p in model.parameters())
    step_s = res["step_s"][TRAIN_WARMUP:]
    mean_s = sum(step_s) / len(step_s)
    flops, w_flops, a_flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    opt_bytes = OPT_BYTES_PER_PARAM * n_params
    bound_s = flops / PEAK_FLOPS["bfloat16"] + opt_bytes / HBM_BYTES_PER_S
    out.update(
        param_count=n_params, losses=losses, lines=lines,
        step_s=res["step_s"], ms_per_step=mean_s * 1e3,
        ms_per_step_median=sorted(step_s)[len(step_s) // 2] * 1e3,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / mean_s,
        model_flops=flops, weight_flops=w_flops, attention_flops=a_flops,
        optimizer_bytes=opt_bytes,
        bound_ms=bound_s * 1e3,
        bound_convention="3 x forward FLOPs (weight products + causal "
        "attention, recompute excluded) at 989 TFLOP/s, plus the "
        "optimizer's 22 bytes a parameter at 3.35 TB/s",
        share_of_bound=bound_s / mean_s,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(device))

    # device time of one more step by family
    data = res["data"]
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(TRAIN_STEPS).items()}
    opt_events = []
    with _labelled(attn_lib, "_attn_block", "repro.chunked_attention"), \
            _labelled(opt, "apply", "repro.optimizer", opt_events):
        fams, dev_ms, n_ops, top = device_ms_by_family(
            lambda: float(res["train_step"](batch)["loss"]), TRAIN_LABELS)
    out.update(device_ms_by_family=fams, device_ms=dev_ms,
               device_ops_per_step=n_ops, top_kernels_ms=top,
               optimizer_ms_by_cuda_events=sum(
                   a.elapsed_time(b) for a, b in opt_events),
               device_idle_share=1.0 - dev_ms / (mean_s * 1e3))

    # check (2): every layer's wq, wk, wv gets a gradient through attention
    _, grads = steps_lib.loss_and_grads(model, batch)
    bad = []
    for i in range(cfg.n_layers):
        for w in ("wq", "wk", "wv"):
            g = grads[f"blocks.{i}.attn.{w}"]
            if not (bool(torch.isfinite(g).all()) and
                    float(g.abs().max()) > 0):
                bad.append(f"blocks.{i}.attn.{w}")
    check(not bad, f"train: no nonzero finite gradient for {bad}")
    out["check_attention_grads"] = dict(layers=cfg.n_layers,
                                        leaves=3 * cfg.n_layers, ok=True)
    del grads, res, model, state, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # check (3): microbatches 1 and 2, a 2-layer fp32 model of this width
    nl, cb, cs = TRAIN_CHECK
    cfg2 = dataclasses.replace(cfg, n_super=nl, param_dtype="float32",
                               compute_dtype="float32")
    model = Model(cfg2, device=device,
                  generator=torch.Generator(device=device).manual_seed(1))
    model.requires_grad_(True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=cs,
                                  global_batch=cb))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(0).items()}
    l1, g1 = steps_lib.loss_and_grads(model, batch, 1)
    l2, g2 = steps_lib.loss_and_grads(model, batch, 2)
    loss_rel = abs(float(l1) - float(l2)) / abs(float(l1))
    worst, worst_leaf = 0.0, None
    for n in g1:
        scale = float(g1[n].abs().max())
        err = float((g1[n] - g2[n]).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_leaf = err, n
    check(loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL,
          f"train microbatches: loss rel {loss_rel:.3g} (limit "
          f"{TRAIN_LOSS_RTOL}), gradient {worst_leaf} off by {worst:.3g} of "
          f"its largest element (limit {TRAIN_GRAD_RTOL})")
    out["check_microbatches"] = dict(
        layers=nl, batch=cb, seq=cs, dtype="float32", loss_rel_err=loss_rel,
        loss_rtol=TRAIN_LOSS_RTOL, worst_grad_err_over_max=worst,
        worst_leaf=worst_leaf, grad_rtol=TRAIN_GRAD_RTOL)
    del g1, g2

    # check (4): the loss falls on a fixed batch, from the same weights at
    # the width-scaled lr (checked) and at the smoke test's (recorded)
    lr = TRAIN_LR_SMOKE * math.sqrt(64 / cfg.d_model)
    runs = {}
    for name, rate in (("scaled", lr), ("smoke_lr", TRAIN_LR_SMOKE)):
        if name != "scaled":
            del model
            torch.cuda.empty_cache()
            model = Model(cfg2, device=device, generator=torch.Generator(
                device=device).manual_seed(1))
            model.requires_grad_(True)
        ocfg = opt.OptConfig(lr=rate, warmup_steps=1, total_steps=50)
        step = steps_lib.build_train_step(
            model, ocfg, opt.init(dict(model.named_parameters()), ocfg))
        runs[name] = [float(step(batch)["loss"])
                      for _ in range(TRAIN_CHECK_STEPS)]
        del step
    fixed = runs["scaled"]
    check(all(map(math.isfinite, fixed)) and
          fixed[-1] < fixed[0] - TRAIN_MIN_DROP,
          f"train: the loss on a fixed batch went {fixed} at lr {lr:.3g}")
    out["check_loss_decreases"] = dict(
        layers=nl, batch=cb, seq=cs, lr=lr, losses=fixed,
        drop=fixed[0] - fixed[-1], min_drop=TRAIN_MIN_DROP,
        smoke_lr=TRAIN_LR_SMOKE, smoke_lr_losses=runs["smoke_lr"])
    del model, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["card"] = card_line()
    return out


# --------------------------------------------------------------------- ssm

SSM_ARCHS = ("xlstm-350m", "zamba2-2.7b")
# prefill: one sequence; xlstm at train_4k's length (its sLSTM loops over
# the tokens one by one, so prefill_32k's 32,768 would take minutes),
# zamba2 at prefill_32k's (its batch of 32 belongs to a pod)
SSM_PREFILL_S = {"xlstm-350m": 4096, "zamba2-2.7b": 32_768}
# the prefill profiled by family: xlstm's per-token loop makes ~60 device
# operations a token, so its profile runs one chunk of 256 tokens
SSM_PROFILE_S = {"xlstm-350m": 256, "zamba2-2.7b": 32_768}
SSM_DECODE = (4, 64, 32)            # batch, prompt, generated: the CLI's
# train: (n_super or None for full depth, seq, batch, steps, warm-up
# steps left out of the step time).  xlstm: seq 1,024 (not train_4k's
# 4,096: each step runs the sLSTM token by token, forward and backward,
# 14–23 s a step on an H100), batch 4 (not 256, a pod's), 1 timed step
# after 1 warm-up (3 timed steps put the phase past its time).  zamba2:
# 2 of 9 super-blocks (12 layers): at full depth with remat "none" the
# activations of seq 4,096 do not fit beside the 25 GB of fp32 moments.
SSM_TRAIN = {"xlstm-350m": (None, 1024, 4, 2, 1),
             "zamba2-2.7b": (2, 4096, 1, 2, 1)}
# check (1): forward against decode_step in fp32 over SSM_CHECK_S
# positions (two chunks of 256: the carry between chunks is crossed) on
# the model cut to its first super-blocks (xlstm 2 = 4 layers, zamba2 1 =
# 6 layers, the shared block included), per position within
# SSM_CHECK_REL_RMS of the logits' rms.  The JAX package shows ~5e-6 on
# the CPU.  In bf16 the full model's spread over SSM_SPREAD_S positions
# is recorded, not gated: the reference's own bf16 forward and decode
# differ by 5.1 % (xlstm) and 5.3 % (zamba2) of the rms at the smoke
# width, and by 115 % for xlstm at its full depth of 24 layers (d 256 on
# the CPU; its fp32 ones by 0.42 %).  256 positions, not 512: zamba2's
# decode steps cost ~47 ms each.
SSM_CHECK_SUPER = {"xlstm-350m": 2, "zamba2-2.7b": 1}
SSM_CHECK_S = 512
SSM_SPREAD_S = 256
SSM_CHECK_REL_RMS = 1e-3
# check (2): every parameter's gradient on this many tokens of a batch
SSM_GRAD_S = 256
#: record_function labels of the block kinds, for device ms by family
SSM_LABELS = {"repro.mlstm": "mlstm blocks", "repro.slstm": "slstm blocks",
              "repro.mamba2": "mamba2 blocks",
              "repro.attn": "shared attention blocks"}


def ssm_forward_flops(cfg, seq):
    """FLOPs of one forward over ``seq`` tokens of one sequence: the
    weight products (embedding gather excluded, LM head included) and
    each block's sequence mixing as the chunked forms compute it (causal
    attention: its half of S²)."""
    from repro_torch.models.blocks import _mamba_dims, _mlstm_dims
    d, v, q = cfg.d_model, cfg.vocab_size, cfg.ssm_chunk
    per_token = 2.0 * d * v
    attn = 0.0
    for b in cfg.pattern:
        n = b.repeat * cfg.n_super
        if b.kind == "mlstm":
            dp, h, hd = _mlstm_dims(cfg)
            w = d * 2 * dp + 3 * dp * dp + dp * 2 * h + dp * d
            # SSD a chunk: C·Bᵀ, (·L)·X, the chunk's state, C·h_prev; the
            # normalizer again with P = 1
            mix = h * (2 * q * hd + 2 * q * hd + 4 * hd * hd
                       + 2 * q * hd + 2 * q + 4 * hd)
            per_token += n * (2.0 * w + mix)
        elif b.kind == "slstm":
            hd = d // cfg.n_heads
            per_token += n * (2.0 * (4 * d * d + d * d)
                              + 8.0 * cfg.n_heads * hd * hd)
        elif b.kind == "mamba2":
            d_in, p, nh, ns, conv_dim = _mamba_dims(cfg)
            w = d * (2 * d_in + 2 * ns + nh) + d_in * d
            mix = nh * (2 * q * ns + 2 * q * p + 4 * p * ns) + 8 * conv_dim
            per_token += n * (2.0 * w + mix)
        else:           # attn / shared_attn: projections, MLP, attention
            hq, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
            w = 2 * d * hq * hd + 2 * d * kv * hd + 3 * d * cfg.d_ff
            per_token += n * 2.0 * w
            attn += n * 4.0 * hq * hd * seq * (seq + 1) / 2
    return per_token * seq + attn


def _cut(cfg, n_super, **kw):
    import dataclasses
    return dataclasses.replace(cfg, n_super=n_super or cfg.n_super, **kw)


def _rel_rms_positions(a, b):
    """Per position ``rms(a - b) / rms(b)`` over the last axis."""
    a, b = a.float(), b.float()
    return (a - b).pow(2).mean(-1).sqrt() / b.pow(2).mean(-1).sqrt()


def _rel_rms_worst(a, b):
    """Worst per-position ``rms(a - b) / rms(b)`` over the last axis."""
    return float(_rel_rms_positions(a, b).max())


def _decode_all(model, toks, enc_embeds=None):
    """Logits of ``decode_step`` at every position of ``toks`` [B,S]
    (after ``init_cache(enc_embeds=...)`` for an encoder-decoder)."""
    import torch
    from repro_torch.launch.steps import build_serve_step
    step = build_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(toks.shape[0], toks.shape[1],
                                 enc_embeds=enc_embeds)
        return torch.cat([step(cache, toks[:, i:i + 1], i)
                          for i in range(toks.shape[1])], dim=1)


@contextlib.contextmanager
def _block_labels():
    """Each block kind's ``forward`` / ``decode`` under its label of
    ``SSM_LABELS``."""
    from repro_torch.models import blocks
    kinds = (("MlstmBlock", "repro.mlstm"), ("SlstmBlock", "repro.slstm"),
             ("Mamba2Block", "repro.mamba2"), ("AttnBlock", "repro.attn"))
    with contextlib.ExitStack() as stack:
        for cls, label in kinds:
            for attr in ("forward", "decode"):
                stack.enter_context(_labelled(getattr(blocks, cls), attr,
                                              label))
        yield


def _ssm_arch(device, arch):
    """One arch of the ``ssm`` phase: prefill, decode, train and checks
    (1)–(4), the flash launch count at 0 just before its main path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.launch.train import run_train
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    out = dict(arch=arch, layers=cfg.n_layers, dtype=cfg.param_dtype)
    rng = np.random.default_rng(0)
    flash_attention.launches = 0
    bsr_spmm.launches = 0
    attn_lib.attention.calls.update(flash=0, chunked=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    params = list(model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    out.update(build_s=time.perf_counter() - t0,
               param_count=sum(p.numel() for p in params),
               param_bytes=param_bytes)

    # ---- prefill, one sequence
    s = SSM_PREFILL_S[arch]
    prefill = build_prefill_step(model)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s))
                              ).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tuple(logits.shape) == (1, s, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill: logits {tuple(logits.shape)} or not finite")
    del logits
    flops = ssm_forward_flops(cfg, s)
    moved = param_bytes + s * cfg.vocab_size * 2
    bound_s = max(flops / PEAK_FLOPS["bfloat16"], moved / HBM_BYTES_PER_S)
    ps = SSM_PROFILE_S[arch]
    ptoks = tokens[:, :ps]
    with _block_labels():
        prof_wall = wall_ms(lambda: prefill({"tokens": ptoks}), reps=1) \
            if ps != s else wall * 1e3
        fams, dev_ms, n_ops, top = device_ms_by_family(
            lambda: prefill({"tokens": ptoks}), SSM_LABELS)
    out["prefill"] = dict(
        batch=1, seq=s, wall_s=wall, tokens_per_s=s / wall, flops=flops,
        bytes=moved, bound_s=bound_s, share_of_bound=bound_s / wall,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(device),
        profiled_seq=ps, profiled_wall_ms=prof_wall,
        profiled_device_ms=dev_ms, profiled_device_ops=n_ops,
        profiled_device_ops_per_token=n_ops / ps,
        profiled_device_idle_share=1.0 - dev_ms / prof_wall,
        device_ms_by_family=fams, top_kernels_ms=top)
    del tokens, ptoks

    # ---- decode: the serve decode loop
    b, pl_, g = SSM_DECODE
    prompts = torch.from_numpy(serve.make_inputs(cfg.vocab_size, b, pl_)[0]
                               ).to(device)
    res = serve.run_decode(model, prompts, g)
    gen = res["tokens"]
    # check (3)
    check(gen.shape == (b, g) and ((gen >= 0) & (gen < cfg.vocab_size)
                                   ).all(),
          f"{arch} decode: generated tokens {gen.shape} out of range")
    step = build_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(b, pl_ + g + 1)
        tok = prompts[:, :1]
        step(cache, tok, 0)       # the mLSTM state is fp32 from here on
        with _block_labels():
            fams_d, step_dev_ms, step_ops, _ = device_ms_by_family(
                lambda: step(cache, tok, 1), SSM_LABELS)
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache for t in c.values())
        del cache
    step_ms = res["decode_s"] / g * 1e3
    embed_bytes = model.embed.numel() * model.embed.element_size()
    # weights (the embedding table only where it is the head), the
    # caches read and their recurrent states written once a step
    read = param_bytes - (0 if cfg.tie_embeddings else embed_bytes) \
        + 2 * cache_bytes
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    out["decode"] = dict(
        batch=b, prompt=pl_, gen=g, prefill_by_steps_s=res["prefill_s"],
        decode_s=res["decode_s"], ms_per_step=step_ms,
        tokens_per_s=b * g / res["decode_s"], cache_bytes=cache_bytes,
        bytes_per_step=read, bound_ms_per_step=bound_ms,
        share_of_bound=bound_ms / step_ms,
        device_ops_per_step=step_ops, device_ms_per_step=step_dev_ms,
        device_idle_share=1.0 - step_dev_ms / step_ms,
        device_ms_by_family=fams_d, first_generated=gen[:2, :8].tolist())

    # bf16 spread of the full model, forward against decode (recorded)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, SSM_SPREAD_S))).to(device)
    fwd = prefill({"tokens": toks})
    dec = _decode_all(model, toks)
    out["bf16_forward_vs_decode"] = dict(
        positions=SSM_SPREAD_S, worst_rel_rms=_rel_rms_worst(dec, fwd))
    del fwd, dec, model, prefill, step, params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- train through run_train, then check (2) on its model
    n_super, seq, tb, n_steps, warm = SSM_TRAIN[arch]
    tcfg = _cut(cfg, n_super)
    lines = []
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = run_train(tcfg, steps=n_steps, batch=tb, seq=seq, device=device,
                    log_every=1, log=lines.append)
    torch.cuda.synchronize()
    losses = res["losses"]
    check(len(losses) == n_steps and all(map(math.isfinite, losses)),
          f"{arch} train: losses {losses}")
    model = res["model"]
    n_params = sum(p.numel() for p in model.parameters())
    step_s = res["step_s"][warm:]
    mean_s = sum(step_s) / len(step_s)
    tflops = 3.0 * ssm_forward_flops(tcfg, seq) * tb
    t_bound_s = tflops / PEAK_FLOPS["bfloat16"] + \
        OPT_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S
    batch = {k: torch.from_numpy(v[:1, :SSM_GRAD_S]).to(device)
             for k, v in res["data"].batch_at(n_steps).items()}
    _, grads = steps_lib.loss_and_grads(model, batch)
    bad = [n for n, gr in grads.items()
           if not (bool(torch.isfinite(gr).all()) and
                   float(gr.abs().max()) > 0)]
    # check (2)
    check(not bad and len(grads) == len(list(model.parameters())),
          f"{arch} train: no nonzero finite gradient for {bad}")
    out["train"] = dict(
        layers=tcfg.n_layers, seq=seq, batch=tb, steps=n_steps,
        warmup_steps=warm, remat=tcfg.remat, param_count=n_params,
        wall_s=time.perf_counter() - t0, losses=losses, lines=lines,
        step_s=res["step_s"], ms_per_step=mean_s * 1e3,
        tokens_per_s=tb * seq / mean_s, model_flops=tflops,
        bound_ms=t_bound_s * 1e3, share_of_bound=t_bound_s / mean_s,
        bound_convention="3 x forward FLOPs at 989 TFLOP/s, plus the "
        "optimizer's 22 bytes a parameter at 3.35 TB/s",
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(device),
        check_grads=dict(leaves=len(grads), tokens=SSM_GRAD_S, ok=True))
    del grads, res, model, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # check (4): no kernel on this arch's path (prefill, decode, train)
    launches = dict(flash_attention=flash_attention.launches,
                    bsr_spmm=bsr_spmm.launches,
                    route_flash=attn_lib.attention.calls["flash"],
                    route_chunked=attn_lib.attention.calls["chunked"])
    check(launches["flash_attention"] == launches["route_flash"] ==
          launches["bsr_spmm"] == 0,
          f"{arch}: {launches}; no kernel is on this path")
    out["launches"] = launches
    if any(b.kind == "shared_attn" for b in cfg.pattern):
        q = torch.empty((1, s, cfg.n_heads, cfg.hd), dtype=torch.bfloat16,
                        device="meta")
        k = torch.empty((1, s, cfg.n_kv_heads, cfg.hd),
                        dtype=torch.bfloat16, device="meta")
        out["flash_route"] = attn_lib.attention_route(q, k, True, None, 0)
    else:
        out["flash_route"] = ("none", "no attention block")

    # check (1): forward against decode_step in fp32, first super-blocks
    ccfg = _cut(cfg, SSM_CHECK_SUPER[arch], param_dtype="float32",
                compute_dtype="float32")
    cmodel = Model(ccfg, device=device,
                   generator=torch.Generator(device=device).manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, SSM_CHECK_S))).to(device)
    fwd = build_prefill_step(cmodel)({"tokens": toks})
    dec = _decode_all(cmodel, toks)
    worst = _rel_rms_worst(dec, fwd)
    check(math.isfinite(worst) and worst <= SSM_CHECK_REL_RMS,
          f"{arch} fp32 decode_step vs forward: per-position error rms "
          f"{worst:.3g} of the logits' rms (limit {SSM_CHECK_REL_RMS})")
    out["check_decode_fp32"] = dict(
        layers=ccfg.n_layers, seq=SSM_CHECK_S, worst_rel_rms=worst,
        rel_rms_limit=SSM_CHECK_REL_RMS)
    del cmodel, fwd, dec
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def ssm_phase(device):
    """The recurrent families on the card at full width, bf16, random
    weights from seed 0: ``xlstm-350m`` (mLSTM + sLSTM, 24 layers) and
    ``zamba2-2.7b`` (Mamba-2 + a shared attention block, 54 layers), each
    with one prefill forward, the ``serve decode`` loop, a few
    ``run_train`` steps and checks (1) forward vs ``decode_step`` in fp32,
    (2) every gradient leaf finite and nonzero, (3) generated tokens in
    range, (4) no kernel launched (xlstm has no attention; zamba2's hd 80
    is outside the flash kernel's).  Emits one JSON line per arch and
    returns the headline numbers of each (``archs``) and each arch's whole
    record (``runs``, already printed)."""
    out = dict(archs={}, runs={})
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        r = _ssm_arch(device, arch)
        r["seconds"] = time.perf_counter() - t0
        r["card"] = card_line()
        emit(dict(phase="ssm", **r))
        out["runs"][arch] = r
        out["archs"][arch] = dict(
            prefill_tokens_per_s=r["prefill"]["tokens_per_s"],
            prefill_bound_s=r["prefill"]["bound_s"],
            decode_ms_per_step=r["decode"]["ms_per_step"],
            decode_bound_ms=r["decode"]["bound_ms_per_step"],
            train_ms_per_step=r["train"]["ms_per_step"],
            train_bound_ms=r["train"]["bound_ms"],
            check_decode_fp32=r["check_decode_fp32"]["worst_rel_rms"],
            launches=r["launches"], seconds=r["seconds"])
    out["card"] = card_line()
    return out


# --------------------------------------------------------------------- moe

MOE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
# depth on one card of 80 GB: arctic's 35 layers hold 13.6 B parameters
# each (952 GB in bf16), kimi's 61 hold 17 B each (2.1 TB); 2 and 1
# layers keep 55.4 and 38.8 GB of weights, beside the activations
MOE_LAYERS = {"arctic-480b": 2, "kimi-k2-1t-a32b": 1}
# prefill: arctic at prefill_32k's length; kimi at 8,192, since its head
# size of 112 takes the chunked route (fp32 scores of 17 GB a chunk at
# 32,768, beside 10.7 GB of logits)
MOE_PREFILL_S = {"arctic-480b": 32_768, "kimi-k2-1t-a32b": 8192}
MOE_DECODE = (4, 64, 32)            # batch, prompt, generated: the CLI's
# arctic's training: experts cut 128 -> 16 (top 2 kept), so weights,
# gradients and fp32 moments (~51 GB) fit with the activations of seq
# 4,096 under remat "full"; 1 warm-up step, 3 timed
MOE_TRAIN = dict(experts=16, seq=4096, batch=1, steps=4, warmup=1)
MOE_CHECK_EXPERTS = 16
# check (1): fp32, 1 layer, forward against MOE_DECODE_CHECK_S
# decode_steps at capacity_factor = experts / top_k (nothing dropped in
# either: decode's capacity is max(1, ...) of its B tokens, prefill's of
# the sequence, and the two agree only without drops)
MOE_DECODE_CHECK_S = 256
# check (2): the flash route against the chunked one, bf16, both layers,
# held over at least this many positions whose context was routed alike
MOE_ROUTES_S = 4096
MOE_ROUTES_MIN_CONTEXT = 32
# check (3): grouped (256 groups) against flat dispatch on this many
# tokens, fp32, no drops, at the reference test's tolerance
MOE_GROUPED_T = 4096
MOE_GROUPED_TOL = (1e-4, 1e-5)       # rtol, atol
# check (4): gradients on this many tokens, drawn uniformly (the
# pipeline's Zipf-skewed tokens reach a few experts: recorded); the loss
# of a 1-layer fp32 model falls on a fixed batch of (batch, seq) in
# TRAIN_CHECK_STEPS steps
MOE_GRAD_S = 1024
MOE_LOSS_BATCH = (2, 512)
MOE_LABELS = {"repro.moe": "moe ffn (router, dispatch, experts, combine)"}
EXPERT_LEAVES = (".moe.w1", ".moe.w3", ".moe.w2")
MOE_SOURCES = {
    "arctic-480b": "hf:Snowflake/snowflake-arctic-base (35 layers, d 7,168, "
    "56 heads / 8 KV of 128, 128 experts top 2 of d_ff 4,864, a dense "
    "residual FFN of 4,864, vocab 32,000)",
    "kimi-k2-1t-a32b": "Kimi K2 (configs/archs.py: 61 layers, d 7,168, 64 "
    "heads / 8 KV of 112, 384 experts top 8 of d_ff 2,048, vocab "
    "163,840)"}


@contextlib.contextmanager
def _routes_recorded():
    """Every ``moe.route`` call's top-k experts ``[G, Tg, k]`` for the
    duration of the block, in call order (one per MoE layer a pass)."""
    from repro_torch.models import moe
    seen = []
    fn = moe.route

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        seen.append(out[2].detach().clone())
        return out

    moe.route = wrapped
    try:
        yield seen
    finally:
        moe.route = fn


def _kept_experts(cfg, top_i):
    """``top_i [G, Tg, k]`` -> the experts each token was kept in, sorted,
    -1 where a slot was dropped for capacity, ``[G·Tg, k]``; and the
    share of (token, slot) pairs dropped."""
    import torch
    from repro_torch.models import moe
    g, tg, k = top_i.shape
    cap = moe.capacity(tg, k, cfg.capacity_factor, cfg.n_experts)
    _, keep = moe.slot_positions(top_i, cfg.n_experts, cap)
    kept = torch.where(keep.reshape(g, tg, k), top_i, -1)
    return (kept.reshape(g * tg, k).sort(dim=-1).values,
            float((~keep).float().mean()))


def moe_forward_flops(cfg, seq, caps):
    """FLOPs of one forward over ``seq`` tokens of one sequence as the
    algorithm computes them: the attention projections, causal attention
    (its half of S²), the router, the experts' three products over the
    capacity buffers of each layer (``caps``: slots per expert, all
    groups), the dense residual FFN, the LM head."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    per_layer = 2.0 * seq * (2 * d * h * hd + 2 * d * kv * hd) \
        + 4.0 * h * (seq * (seq + 1) / 2) * hd \
        + 2.0 * seq * d * cfg.n_experts
    if cfg.moe_dense_residual:
        per_layer += 6.0 * seq * d * cfg.d_ff
    experts = sum(6.0 * cfg.n_experts * c * d * cfg.moe_d_ff for c in caps)
    return cfg.n_layers * per_layer + experts + 2.0 * seq * d * \
        cfg.vocab_size


def _moe_decode_bytes(model, cfg, batch, cache_bytes):
    """Bytes one decode step must read: every weight but the embedding
    table (``B`` rows of it), and the caches.  ``all_experts``: the
    reference's decode, which runs every expert at capacity 1;
    ``routed``: only the ``B·top_k`` experts a step routes to, at most,
    per layer."""
    emb = model.embed.element_size()
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    base = params - model.embed.numel() * emb + batch * cfg.d_model * emb \
        + cache_bytes
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff * emb
    unrouted = max(cfg.n_experts - batch * cfg.top_k, 0)
    return base, base - cfg.n_layers * unrouted * per_expert


def _moe_arch(device, arch):
    """One arch of the ``moe`` phase: prefill, decode and, for arctic,
    training and checks (1)–(4); check (5) for both."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as flash_lib
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.launch.train import run_train
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import optimizer as opt

    reset, counts = _reset_flash_counts, _flash_counts
    full = get_config(arch)
    cfg = _cut(full, MOE_LAYERS[arch])
    s = MOE_PREFILL_S[arch]
    want_flash = cfg.n_layers if cfg.hd in flash_lib.HD_CHOICES else 0
    reduced = dict(layers=[full.n_layers, cfg.n_layers])
    if s != 32_768:
        reduced["prefill_seq"] = [32_768, s]
    out = dict(arch=arch, source=MOE_SOURCES[arch], layers=cfg.n_layers,
               experts=cfg.n_experts, top_k=cfg.top_k,
               dtype=cfg.param_dtype, reduced=reduced)
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    out.update(build_s=time.perf_counter() - t0, param_count=sum(
        p.numel() for p in model.parameters()), param_bytes=param_bytes)

    # ---- prefill, one sequence: the main path, counts at 0 just before
    prefill = build_prefill_step(model)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s))
                              ).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    logits = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    check(launches == dict(flash_kernel=want_flash, route_flash=want_flash,
                           route_chunked=cfg.n_layers - want_flash),
          f"{arch} prefill: {launches}, want the flash kernel in "
          f"{want_flash} of {cfg.n_layers} layers")
    check(tuple(logits.shape) == (1, s, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill: logits {tuple(logits.shape)} or not finite")
    peak = torch.cuda.max_memory_allocated(device)
    del logits
    with _routes_recorded() as routes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill({"tokens": tokens})
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    drops = [_kept_experts(cfg, r)[1] for r in routes]
    caps = [r.shape[0] * moe.capacity(r.shape[1], cfg.top_k,
                                      cfg.capacity_factor, cfg.n_experts)
            for r in routes]
    with _labelled(moe, "_dispatch", "repro.moe"):
        fams, dev_ms, n_ops, top = device_ms_by_family(
            lambda: prefill({"tokens": tokens}), MOE_LABELS)
    flops = moe_forward_flops(cfg, s, caps)
    moved = param_bytes + s * cfg.vocab_size * 2
    bound_s = max(flops / PEAK_FLOPS["bfloat16"], moved / HBM_BYTES_PER_S)
    out["prefill"] = dict(
        batch=1, seq=s, launches=launches, wall_s=wall,
        wall_s_repeat=wall2, tokens_per_s=s / min(wall, wall2),
        capacity_per_expert=caps, dropped_share_by_layer=drops,
        dropped_share=sum(drops) / len(drops), flops=flops, bytes=moved,
        bound_s=bound_s, share_of_bound=bound_s / min(wall, wall2),
        bound_convention="FLOPs as computed (experts over their capacity "
        "buffers, causal attention's half of S²) at 989 TFLOP/s bf16, "
        "or weights + logits at 3.35 TB/s, the larger",
        device_ms=dev_ms, device_ops=n_ops,
        device_ms_by_family=fams, top_kernels_ms=top,
        max_memory_allocated_bytes=peak)
    del tokens

    # ---- decode: the serve decode loop, counts at 0 just before
    b, pl_, g = MOE_DECODE
    prompts = torch.from_numpy(serve.make_inputs(cfg.vocab_size, b, pl_)[0]
                               ).to(device)
    reset()
    res = serve.run_decode(model, prompts, g)
    dec_launches = counts()
    gen = res["tokens"]
    # check (5)
    check(gen.shape == (b, g) and ((gen >= 0) & (gen < cfg.vocab_size)
                                   ).all(),
          f"{arch} decode: generated tokens {gen.shape} out of range")
    check(dec_launches == dict(flash_kernel=0, route_flash=0,
                               route_chunked=0),
          f"{arch} decode: {dec_launches}; decode steps call no prefill "
          f"route")
    step = build_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(b, pl_ + g + 1)
        tok = prompts[:, :1]
        step_kernels, step_ops = device_ms_by_kernel(
            lambda: step(cache, tok, pl_ + g))
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache for t in c.values())
        del cache
    step_ms = res["decode_s"] / g * 1e3
    read_all, read_routed = _moe_decode_bytes(model, cfg, b, cache_bytes)
    step_dev = sum(step_kernels.values())
    out["decode"] = dict(
        batch=b, prompt=pl_, gen=g, launches=dec_launches,
        prefill_by_steps_s=res["prefill_s"], decode_s=res["decode_s"],
        ms_per_step=step_ms, tokens_per_s=b * g / res["decode_s"],
        bytes_per_step=read_all,
        bound_ms_per_step=read_all / HBM_BYTES_PER_S * 1e3,
        routed_bytes_per_step=read_routed,
        routed_bound_ms_per_step=read_routed / HBM_BYTES_PER_S * 1e3,
        share_of_bound=read_all / HBM_BYTES_PER_S * 1e3 / step_ms,
        device_ops_per_step=step_ops, device_ms_per_step=step_dev,
        device_idle_share=1.0 - step_dev / step_ms,
        top_kernels_ms=dict(list(step_kernels.items())[:8]),
        first_generated=gen[:2, :8].tolist())
    out["launches"] = dict(prefill=launches, decode=dec_launches)

    if arch != MOE_ARCHS[0]:            # the checks run at arctic's widths
        del model, prefill, step
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return out

    # ---- check (2): the flash route against the chunked route, bf16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, MOE_ROUTES_S))).to(device)
    with torch.inference_mode():
        reset()
        with _routes_recorded() as rf:
            lf = model(toks)
        flash_counts = counts()
        reset()
        with _routes_recorded() as rc:
            lc = model(toks, force_chunked=True)
        chunked_counts = counts()
    check(flash_counts == dict(flash_kernel=cfg.n_layers,
                               route_flash=cfg.n_layers, route_chunked=0)
          and chunked_counts == dict(flash_kernel=0, route_flash=0,
                                     route_chunked=cfg.n_layers),
          f"{arch} routes check: flash run {flash_counts}, chunked run "
          f"{chunked_counts}")
    alike = [(_kept_experts(cfg, a)[0] == _kept_experts(cfg, c)[0]).all(-1)
             for a, c in zip(rf, rc)]
    same = torch.stack(alike).all(0)
    # gated: the positions whose whole context was routed alike in every
    # layer, which see only the two attention routes' rounding.  A token
    # routed otherwise in an earlier layer reaches every later position
    # through the next layer's attention, so the positions merely routed
    # alike themselves carry that routing difference too: recorded only
    context = torch.stack(alike[:-1]).all(0).int().cumprod(0).bool() & same
    ratio = _rel_rms_positions(lf, lc)[0]
    n_context = int(context.sum())
    worst = float(ratio[context].max()) if n_context else math.inf
    check(n_context >= MOE_ROUTES_MIN_CONTEXT and math.isfinite(worst)
          and worst <= LM_REL_RMS,
          f"{arch} flash vs chunked: per-position error rms {worst:.3g} of "
          f"the logits' rms over the {n_context} positions whose context "
          f"was routed alike (limits {LM_REL_RMS}, at least "
          f"{MOE_ROUTES_MIN_CONTEXT} positions)")
    out["check_routes"] = dict(
        layers=cfg.n_layers, seq=MOE_ROUTES_S,
        context_routed_alike_positions=n_context,
        min_context_positions=MOE_ROUTES_MIN_CONTEXT,
        worst_rel_rms_context_routed_alike=worst, rel_rms_limit=LM_REL_RMS,
        routed_differently_share=1.0 - float(same.float().mean()),
        worst_rel_rms_routed_alike=float(ratio[same].max())
        if bool(same.any()) else None,
        worst_rel_rms_all_positions=float(ratio.max()))
    del lf, lc, toks, model, prefill, step, rf, rc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- training through run_train (experts cut), checks (4)
    tr = MOE_TRAIN
    tcfg = _cut(cfg, None, n_experts=tr["experts"])
    check(tcfg.remat == "full", f"{tcfg.name}: remat {tcfg.remat!r}")
    lines = []
    torch.cuda.reset_peak_memory_stats(device)
    reset()
    t0 = time.perf_counter()
    res = run_train(tcfg, steps=tr["steps"], batch=tr["batch"],
                    seq=tr["seq"], device=device, log_every=1,
                    log=lines.append)
    torch.cuda.synchronize()
    train_launches = counts()
    losses = res["losses"]
    check(len(losses) == tr["steps"] and all(map(math.isfinite, losses)),
          f"{arch} train: losses {losses}")
    check(train_launches["flash_kernel"] == 0
          and train_launches["route_flash"] == 0,
          f"{arch} train: {train_launches}; training must not run the "
          f"forward-only flash kernel")
    tmodel = res["model"]
    n_params = sum(p.numel() for p in tmodel.parameters())
    step_s = res["step_s"][tr["warmup"]:]
    mean_s = sum(step_s) / len(step_s)
    tcaps = [moe.capacity(tr["batch"] * tr["seq"], tcfg.top_k,
                          tcfg.capacity_factor, tcfg.n_experts)
             ] * tcfg.n_layers
    tflops = 3.0 * tr["batch"] * moe_forward_flops(tcfg, tr["seq"], tcaps)
    moments = opt.moment_dtype_for(tcfg)
    opt_bytes = opt_bytes_per_param(moments)
    t_bound_s = tflops / PEAK_FLOPS["bfloat16"] + \
        opt_bytes * n_params / HBM_BYTES_PER_S
    train_peak = torch.cuda.max_memory_allocated(device)
    batch = {k: torch.from_numpy(v[:1, :MOE_GRAD_S]).to(device)
             for k, v in res["data"].batch_at(tr["steps"]).items()}
    with torch.no_grad():
        total, parts = tmodel.loss_fn(batch)
    total, xent, aux = (float(t) for t in (total, parts["xent"],
                                           parts["aux"]))
    check(all(map(math.isfinite, (total, xent, aux))) and aux > 0
          and abs(total - (xent + 0.01 * aux)) <= 1e-5 * abs(total),
          f"{arch} train: total {total}, xent {xent}, aux {aux}; want aux "
          f"> 0 and total = xent + 0.01·aux")
    def expert_slices(grads):
        """(expert slices with a nonzero gradient, all expert slices)"""
        live = [float(gr[e].abs().max()) > 0 for n, gr in grads.items()
                if n.endswith(EXPERT_LEAVES) for e in range(gr.shape[0])]
        return sum(live), len(live)

    # the pipeline's Zipf-skewed tokens route to a few experts (recorded);
    # every expert is held to a gradient on tokens drawn uniformly
    pipeline_live = expert_slices(
        steps_lib.loss_and_grads(tmodel, batch)[1])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, MOE_GRAD_S + 1))).to(device)
    _, grads = steps_lib.loss_and_grads(
        tmodel, dict(tokens=toks[:, :-1], labels=toks[:, 1:]))
    bad = [n for n, gr in grads.items()
           if not (bool(torch.isfinite(gr).all()) and
                   float(gr.abs().max()) > 0)]
    for n, gr in grads.items():
        if n.endswith(EXPERT_LEAVES):
            bad += [f"{n}[{e}]" for e in range(gr.shape[0])
                    if not float(gr[e].abs().max()) > 0]
    check(not bad and len(grads) == len(list(tmodel.parameters())),
          f"{arch} train: no nonzero finite gradient for {bad}")
    out["train"] = dict(
        layers=tcfg.n_layers, experts=tcfg.n_experts, top_k=tcfg.top_k,
        seq=tr["seq"], batch=tr["batch"], steps=tr["steps"],
        warmup_steps=tr["warmup"], remat=tcfg.remat, param_count=n_params,
        reduced=dict(experts=[cfg.n_experts, tcfg.n_experts],
                     layers=[full.n_layers, tcfg.n_layers]),
        wall_s=time.perf_counter() - t0, losses=losses, lines=lines,
        step_s=res["step_s"], ms_per_step=mean_s * 1e3,
        tokens_per_s=tr["batch"] * tr["seq"] / mean_s, model_flops=tflops,
        bound_ms=t_bound_s * 1e3, share_of_bound=t_bound_s / mean_s,
        moments=moments,
        bound_convention="3 x forward FLOPs (as computed) at 989 TFLOP/s, "
        f"plus the optimizer's {opt_bytes} bytes a parameter at 3.35 TB/s",
        max_memory_allocated_bytes=train_peak, launches=train_launches,
        check_loss=dict(total=total, xent=xent, aux=aux),
        check_grads=dict(
            leaves=len(grads), expert_slices=expert_slices(grads)[1],
            tokens=MOE_GRAD_S, tokens_drawn="uniformly", ok=True,
            pipeline_batch_expert_slices_with_gradient=pipeline_live))
    out["launches"]["train"] = train_launches
    del grads, res, tmodel, batch, toks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- check (1): fp32 forward against decode_step, nothing dropped
    ccfg = _cut(cfg, 1, n_experts=MOE_CHECK_EXPERTS,
                capacity_factor=MOE_CHECK_EXPERTS / cfg.top_k,
                param_dtype="float32", compute_dtype="float32")
    cmodel = Model(ccfg, device=device,
                   generator=torch.Generator(device=device).manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, MOE_DECODE_CHECK_S))).to(device)
    fwd = build_prefill_step(cmodel)({"tokens": toks})
    dec = _decode_all(cmodel, toks)
    worst = _rel_rms_worst(dec, fwd)
    check(math.isfinite(worst) and worst <= SSM_CHECK_REL_RMS,
          f"{arch} fp32 decode_step vs forward: per-position error rms "
          f"{worst:.3g} of the logits' rms (limit {SSM_CHECK_REL_RMS})")
    out["check_decode_fp32"] = dict(
        layers=ccfg.n_layers, experts=ccfg.n_experts,
        capacity_factor=ccfg.capacity_factor, seq=MOE_DECODE_CHECK_S,
        worst_rel_rms=worst, rel_rms_limit=SSM_CHECK_REL_RMS)
    del fwd, dec

    # ---- check (3): grouped against flat dispatch, fp32, no drops
    x = torch.randn((1, MOE_GROUPED_T, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(2))
    with torch.inference_mode():
        w = dict(cmodel.blocks[0].moe.named_parameters())
        cf = ccfg.capacity_factor
        y_flat, a_flat = moe.moe_ffn(x, w, ccfg.top_k, cf)
        y_grp, a_grp = moe.moe_ffn_grouped(x, w, ccfg.top_k, cf, 256)
    rtol, atol = MOE_GROUPED_TOL
    check(_allclose(y_grp, y_flat, rtol, atol)
          and abs(float(a_grp) - float(a_flat)) <= 1e-6,
          f"{arch} grouped vs flat dispatch: max |dy| "
          f"{_max_err(y_grp, y_flat):.3g} (rtol {rtol}, atol {atol}), aux "
          f"{float(a_grp)} vs {float(a_flat)}")
    out["check_grouped"] = dict(
        tokens=MOE_GROUPED_T, groups=moe.n_groups_for(MOE_GROUPED_T, 256),
        experts=ccfg.n_experts, dtype="float32",
        max_abs_err=_max_err(y_grp, y_flat), rtol=rtol, atol=atol)
    del x, y_flat, y_grp, cmodel
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- check (4): the loss of a 1-layer fp32 model falls on a fixed
    # batch at the width-scaled lr (train_phase's check (4))
    lcfg = _cut(cfg, 1, n_experts=MOE_CHECK_EXPERTS,
                param_dtype="float32", compute_dtype="float32")
    lmodel = Model(lcfg, device=device,
                   generator=torch.Generator(device=device).manual_seed(1))
    lmodel.requires_grad_(True)
    lb, ls = MOE_LOSS_BATCH
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=ls,
                                  global_batch=lb))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(0).items()}
    lr = TRAIN_LR_SMOKE * math.sqrt(64 / cfg.d_model)
    ocfg = opt.OptConfig(lr=lr, warmup_steps=1, total_steps=50)
    step = steps_lib.build_train_step(
        lmodel, ocfg, opt.init(dict(lmodel.named_parameters()), ocfg))
    fixed = [float(step(batch)["loss"]) for _ in range(TRAIN_CHECK_STEPS)]
    check(all(map(math.isfinite, fixed)) and
          fixed[-1] < fixed[0] - TRAIN_MIN_DROP,
          f"{arch}: the loss on a fixed batch went {fixed} at lr {lr:.3g}")
    out["check_loss_decreases"] = dict(
        layers=lcfg.n_layers, experts=lcfg.n_experts, batch=lb, seq=ls,
        lr=lr, losses=fixed, drop=fixed[0] - fixed[-1],
        min_drop=TRAIN_MIN_DROP)
    del lmodel, step, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def moe_phase(device):
    """The mixture-of-experts models on the card at full width, bf16,
    random weights from seed 0: ``arctic-480b`` (2 of 35 layers, 128
    experts top 2 plus the dense residual FFN) and ``kimi-k2-1t-a32b`` (1
    of 61 layers, 384 experts top 8), each with one prefill forward
    (32,768 and 8,192 tokens) and the ``serve decode`` loop; arctic with
    ``run_train`` steps (experts cut to 16) and checks (1) forward vs
    ``decode_step`` in fp32, (2) flash vs chunked, (3) grouped vs flat
    dispatch, (4) training's losses, aux and gradients, and a falling
    loss; (5) tokens in range and the flash launch counts for both.
    Emits one JSON line per arch."""
    out = dict(archs={}, runs={})
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        r = _moe_arch(device, arch)
        r["seconds"] = time.perf_counter() - t0
        r["card"] = card_line()
        emit(dict(phase="moe", **r))
        out["runs"][arch] = r
        out["archs"][arch] = dict(
            prefill_tokens_per_s=r["prefill"]["tokens_per_s"],
            prefill_bound_s=r["prefill"]["bound_s"],
            dropped_share=r["prefill"]["dropped_share"],
            decode_ms_per_step=r["decode"]["ms_per_step"],
            decode_bound_ms=r["decode"]["bound_ms_per_step"],
            launches=r["launches"], seconds=r["seconds"])
    out["card"] = card_line()
    return out


# ------------------------------------------------------------------ encdec

ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_SOURCE = "arXiv:2308.11596 (SeamlessM4T v2 large: 24 encoder + 24 " \
    "decoder layers, d 1,024, 16 heads, d_ff 8,192)"
# prefill: decoder tokens and encoder frames both at prefill_32k's length
# (the pipeline's seq_len feeds both)
ENCDEC_PREFILL_S = 32_768
ENCDEC_DECODE = (4, 64, 32)         # batch, prompt, generated: the CLI's
# train: seq 1,024 (not train_4k's 4,096: with the config's remat "none"
# the chunk-0 cross-attention scores of 24 layers alone are ~26 GB at
# 4,096), batch 1, full depth; 1 warm-up step, 3 timed
ENCDEC_TRAIN = dict(seq=1024, batch=1, steps=4, warmup=1)
ENCDEC_ROUTES_S = 4096              # check (1)
ENCDEC_DECODE_CHECK_S = 256         # check (2)
ENCDEC_GRAD_S = 256                 # check (3)


def encdec_forward_flops(cfg, seq, enc_seq):
    """FLOPs of one forward over ``seq`` tokens and ``enc_seq`` frames:
    the encoder (projections, full attention, MLP), the decoder
    (projections, causal self-attention, the cross-attention's
    projections and its full attention to the frames, MLP), the LM
    head."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    proj = 2 * d * h * hd + 2 * d * kv * hd
    mlp = 2.0 * 3 * d * cfg.d_ff
    enc = cfg.n_enc_layers * (enc_seq * (2.0 * proj + mlp)
                              + 4.0 * h * enc_seq * enc_seq * hd)
    n_dec = cfg.n_layers - cfg.n_enc_layers
    dec = n_dec * (seq * (2.0 * proj + mlp) + 4.0 * h * (seq * (seq + 1) / 2)
                   * hd + 2.0 * (seq * 2 * d * h * hd + enc_seq * 2 * d * kv
                                 * hd) + 4.0 * h * seq * enc_seq * hd)
    return enc + dec + 2.0 * seq * d * cfg.vocab_size


def encdec_phase(device):
    """The encoder-decoder on the card at full size (``seamless-m4t-
    large-v2``, 24 + 24 layers, bf16, random weights from seed 0): one
    prefill forward of 32,768 tokens on 32,768 frames (every attention on
    the flash kernel: 24 encoder self-attentions and 24 cross-attentions
    in its full mode, 24 decoder ones causal), the ``serve decode`` loop
    (its encoder once at S 64, on the kernel), ``run_train`` steps at seq
    1,024, and checks (1) flash vs chunked over the whole model, (2) 256
    ``decode_step``s after ``init_cache(enc_embeds=...)`` vs one forward,
    (3) every gradient leaf finite and nonzero, (4) tokens in range."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.launch.train import run_train
    from repro_torch.models.model import Model

    reset, counts = _reset_flash_counts, _flash_counts
    cfg = get_config(ENCDEC_ARCH)
    n_dec = cfg.n_layers - cfg.n_enc_layers
    n_attn = cfg.n_enc_layers + 2 * n_dec
    out = dict(arch=ENCDEC_ARCH, source=ENCDEC_SOURCE,
               encoder_layers=cfg.n_enc_layers, decoder_layers=n_dec,
               dtype=cfg.param_dtype,
               reduced=dict(train_seq=[4096, ENCDEC_TRAIN["seq"]]))
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    out.update(build_s=time.perf_counter() - t0, param_count=sum(
        p.numel() for p in model.parameters()), param_bytes=param_bytes)

    def frames(b, s):
        return (torch.randn((b, s, cfg.d_model), generator=gen,
                            device=device) * 0.02).to(torch.bfloat16)

    # ---- prefill: the main path, counts at 0 just before
    s = ENCDEC_PREFILL_S
    prefill = build_prefill_step(model)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, s))).to(device),
        "enc_embeds": frames(1, s)}
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    logits = prefill(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    check(launches == dict(flash_kernel=n_attn, route_flash=n_attn,
                           route_chunked=0),
          f"encdec prefill: {launches}, want the flash kernel in all "
          f"{n_attn} attentions and no chunked route")
    check(tuple(logits.shape) == (1, s, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"encdec prefill: logits {tuple(logits.shape)} or not finite")
    peak = torch.cuda.max_memory_allocated(device)
    del logits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(batch)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    by_kernel, n_ops = device_ms_by_kernel(lambda: prefill(batch))
    dev_ms = sum(by_kernel.values())
    families = {}
    for name, ms in by_kernel.items():
        fam = _kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    flops = encdec_forward_flops(cfg, s, s)
    moved = param_bytes + s * cfg.vocab_size * 2
    bound_s = max(flops / PEAK_FLOPS["bfloat16"], moved / HBM_BYTES_PER_S)
    out["prefill"] = dict(
        batch=1, seq=s, enc_seq=s, launches=launches, wall_s=wall,
        wall_s_repeat=wall2, tokens_per_s=s / min(wall, wall2), flops=flops,
        bytes=moved, bound_s=bound_s,
        share_of_bound=bound_s / min(wall, wall2), device_ms=dev_ms,
        device_ops=n_ops, flash_device_ms=families.get("flash_attention (hand kernel)", 0.0),
        device_ms_by_family=families,
        top_kernels_ms=dict(list(by_kernel.items())[:8]),
        max_memory_allocated_bytes=peak)
    del batch

    # ---- decode: the serve decode loop, counts at 0 just before
    b, pl_, g = ENCDEC_DECODE
    prompts, enc = serve.make_inputs(cfg.vocab_size, b, pl_, cfg.d_model)
    prompts, enc = torch.from_numpy(prompts).to(device), enc.to(device)
    reset()
    res = serve.run_decode(model, prompts, g, enc)
    dec_launches = counts()
    tokens = res["tokens"]
    # check (4)
    check(tokens.shape == (b, g) and ((tokens >= 0) &
                                      (tokens < cfg.vocab_size)).all(),
          f"encdec decode: generated tokens {tokens.shape} out of range")
    check(dec_launches == dict(flash_kernel=cfg.n_enc_layers,
                               route_flash=cfg.n_enc_layers,
                               route_chunked=0),
          f"encdec decode: {dec_launches}; want the encoder's "
          f"{cfg.n_enc_layers} self-attentions at S {pl_} on the kernel "
          f"and nothing else")
    step = build_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(b, pl_ + g + 1, enc_embeds=enc)
        tok = prompts[:, :1]
        step_kernels, step_ops = device_ms_by_kernel(
            lambda: step(cache, tok, pl_ + g))
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache for t in c.values())
        del cache
    enc_bytes = sum(p.numel() * p.element_size()
                    for p in model.enc.parameters()) + \
        model.enc_ln.numel() * model.enc_ln.element_size()
    emb = model.embed.element_size()
    read = param_bytes - enc_bytes - model.embed.numel() * emb + \
        b * cfg.d_model * emb + cache_bytes
    step_ms = res["decode_s"] / g * 1e3
    step_dev = sum(step_kernels.values())
    out["decode"] = dict(
        batch=b, prompt=pl_, gen=g, launches=dec_launches,
        encode_s=res["encode_s"], prefill_by_steps_s=res["prefill_s"],
        decode_s=res["decode_s"], ms_per_step=step_ms,
        tokens_per_s=b * g / res["decode_s"], bytes_per_step=read, bound_ms_per_step=read / HBM_BYTES_PER_S * 1e3,
        share_of_bound=read / HBM_BYTES_PER_S * 1e3 / step_ms,
        device_ops_per_step=step_ops, device_ms_per_step=step_dev,
        device_idle_share=1.0 - step_dev / step_ms,
        first_generated=tokens[:2, :8].tolist())

    # ---- check (1): the flash route against the chunked route, all
    # layers, S 4,096 tokens on 4,096 frames
    cs = ENCDEC_ROUTES_S
    cb = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (1, cs))).to(device),
          "enc_embeds": frames(1, cs)}
    with torch.inference_mode():
        reset()
        lf = model(cb["tokens"], cb["enc_embeds"])
        flash_counts = counts()
        reset()
        lc = model(cb["tokens"], cb["enc_embeds"], force_chunked=True)
        chunked_counts = counts()
    check(flash_counts == dict(flash_kernel=n_attn, route_flash=n_attn,
                               route_chunked=0)
          and chunked_counts == dict(flash_kernel=0, route_flash=0,
                                     route_chunked=n_attn),
          f"encdec routes check: flash run {flash_counts}, chunked run "
          f"{chunked_counts}")
    out["check_routes"] = dict(seq=cs, enc_seq=cs, **_logits_check(
        lf, lc, "encdec flash vs chunked"))
    del lf, lc, cb

    # ---- check (2): decode_step after init_cache(enc_embeds) against
    # one forward
    ds = ENCDEC_DECODE_CHECK_S
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, ds))
                            ).to(device)
    enc = frames(1, ds)
    fwd = prefill({"tokens": toks, "enc_embeds": enc})
    dec = _decode_all(model, toks, enc)
    out["check_decode"] = dict(seq=ds, enc_seq=ds, **_logits_check(
        dec, fwd, "encdec decode_step vs forward"))
    del fwd, dec, model, prefill, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- training through run_train, full depth, then check (3)
    tr = ENCDEC_TRAIN
    lines = []
    torch.cuda.reset_peak_memory_stats(device)
    reset()
    t0 = time.perf_counter()
    res = run_train(cfg, steps=tr["steps"], batch=tr["batch"],
                    seq=tr["seq"], device=device, log_every=1,
                    log=lines.append)
    torch.cuda.synchronize()
    train_launches = counts()
    losses = res["losses"]
    check(len(losses) == tr["steps"] and all(map(math.isfinite, losses)),
          f"encdec train: losses {losses}")
    check(train_launches["flash_kernel"] == 0
          and train_launches["route_flash"] == 0,
          f"encdec train: {train_launches}; training must not run the "
          f"forward-only flash kernel")
    tmodel = res["model"]
    n_params = sum(p.numel() for p in tmodel.parameters())
    step_s = res["step_s"][tr["warmup"]:]
    mean_s = sum(step_s) / len(step_s)
    tflops = 3.0 * tr["batch"] * encdec_forward_flops(cfg, tr["seq"],
                                                      tr["seq"])
    t_bound_s = tflops / PEAK_FLOPS["bfloat16"] + \
        OPT_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S
    train_peak = torch.cuda.max_memory_allocated(device)
    batch = {k: torch.from_numpy(v[:1, :ENCDEC_GRAD_S]).to(device)
             for k, v in res["data"].batch_at(tr["steps"]).items()}
    check(set(batch) == {"tokens", "labels", "enc_embeds"},
          f"encdec train: the pipeline's batch holds {sorted(batch)}")
    _, grads = steps_lib.loss_and_grads(tmodel, batch)
    bad = [n for n, gr in grads.items()
           if not (bool(torch.isfinite(gr).all()) and
                   float(gr.abs().max()) > 0)]
    check(not bad and len(grads) == len(list(tmodel.parameters())),
          f"encdec train: no nonzero finite gradient for {bad}")
    out["train"] = dict(
        layers=cfg.n_layers, seq=tr["seq"], batch=tr["batch"],
        steps=tr["steps"], warmup_steps=tr["warmup"], remat=cfg.remat,
        param_count=n_params, wall_s=time.perf_counter() - t0,
        losses=losses, lines=lines, step_s=res["step_s"],
        ms_per_step=mean_s * 1e3,
        tokens_per_s=tr["batch"] * tr["seq"] / mean_s, model_flops=tflops,
        bound_ms=t_bound_s * 1e3, share_of_bound=t_bound_s / mean_s,
        bound_convention="3 x forward FLOPs at 989 TFLOP/s, plus the "
        "optimizer's 22 bytes a parameter at 3.35 TB/s",
        max_memory_allocated_bytes=train_peak, launches=train_launches,
        check_grads=dict(leaves=len(grads), tokens=ENCDEC_GRAD_S,
                         encoder_leaves=sum(1 for n in grads
                                            if n.startswith("enc")),
                         ok=True))
    out["launches"] = dict(prefill=launches, decode=dec_launches,
                           train=train_launches)
    del grads, res, tmodel, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["card"] = card_line()
    return out


# --------------------------------------------------------------------- vlm

VLM_ARCH = "qwen2-vl-7b"
VLM_SOURCE = "arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct (28 layers, " \
    "d 3,584, 28/4 heads of 128, SwiGLU 18,944, vocab 152,064, M-RoPE " \
    "sections 2:1:1, 256 vision tokens)"
VLM_PREFILL_S = 32_768      # frontend + text positions, one sequence
VLM_DECODE = (4, 64, 32)    # batch, prompt, generated: the CLI's defaults
VLM_ROUTES_CHECK = (2, 2, 4096)     # layers, batch, positions of check (1)
VLM_DECODE_CHECK = (2, 512)         # fp32 layers, positions of check (2)
VLM_DECODE_REL_RMS = 1e-3
# depth 28 -> 8: fp32 moments of 28 layers are ~122 GB; batch 256 -> 1
VLM_TRAIN = dict(layers=8, seq=4096, batch=1, steps=4, warmup=1)
VLM_GRAD_S = 1024                   # positions of the gradient check
VLM_LOSS_CHECK = (2, 2, 1024)       # fp32 layers, batch, positions


def _frontend(cfg, b, gen, device):
    """Stand-in vision embeddings [b, nf, d], N(0, 0.02²), as the data
    pipeline draws them."""
    import torch
    return torch.randn((b, cfg.n_frontend_tokens, cfg.d_model),
                       generator=gen, device=device) * 0.02


def vlm_forward_flops(cfg, seq):
    """Forward FLOPs of one sequence of ``seq`` positions (frontend and
    text): weight products (the LM head over every position) and causal
    attention."""
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    qkv_o = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
    weights = 2.0 * seq * (L * (qkv_o + 3 * d * ff) + d * v)
    attn = 4.0 * cfg.n_heads * (seq * (seq + 1) / 2) * cfg.hd * L
    return weights, attn


def vlm_phase(device):
    """The vision-language model on the card (``qwen2-vl-7b``, all 28
    layers, bf16, random weights from seed 0): one prefill forward of 256
    frontend embeddings + 32,512 text tokens (M-RoPE in every layer, every
    attention on the flash kernel), the ``serve decode`` loop (B 4, prompt
    64, gen 32; text only, as the reference's CLI), ``run_train`` at 8
    layers, seq 4,096 (256 + 3,840), and checks (1) flash vs chunked on
    the first 2 layers, (2) fp32 forward vs 512 ``decode_step``s on the
    first 2 layers, (3) every layer's ``wq``/``wk``/``wv`` gradient finite
    and nonzero and no flash launch in a train step, (4) a 2-layer fp32
    model's loss falls on a fixed batch at the width-scaled lr."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.launch.train import run_train
    from repro_torch.models.model import Model
    from repro_torch.optim import optimizer as opt

    reset, counts = _reset_flash_counts, _flash_counts
    cfg = get_config(VLM_ARCH)
    check(cfg.m_rope and cfg.frontend == "vision",
          f"{VLM_ARCH}: m_rope {cfg.m_rope}, frontend {cfg.frontend}")
    n_layers, nf = cfg.n_layers, cfg.n_frontend_tokens
    out = dict(arch=VLM_ARCH, source=VLM_SOURCE, layers=n_layers,
               frontend_tokens=nf, dtype=cfg.param_dtype,
               reduced=dict(train_layers=[n_layers, VLM_TRAIN["layers"]],
                            train_batch=[256, VLM_TRAIN["batch"]]))
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    out.update(build_s=time.perf_counter() - t0, param_count=sum(
        p.numel() for p in model.parameters()), param_bytes=param_bytes)
    prefill = build_prefill_step(model)

    # ---- prefill: the main path of this phase, counts at 0 just before
    s = VLM_PREFILL_S
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, s - nf))).to(device),
        "frontend": _frontend(cfg, 1, gen, device)}
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    logits = prefill(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    forward_peak = torch.cuda.max_memory_allocated(device)
    check(launches == dict(flash_kernel=n_layers, route_flash=n_layers,
                           route_chunked=0),
          f"vlm prefill: {launches}, want the flash kernel in each of the "
          f"{n_layers} layers and no chunked route")
    check(tuple(logits.shape) == (1, s, cfg.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          "vlm prefill: logits of the wrong shape or not finite")
    del logits
    walls = [wall]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del logits
    by_kernel, n_ops = device_ms_by_kernel(lambda: prefill(batch))
    dev_ms = sum(by_kernel.values())
    families = {}
    for name, ms in by_kernel.items():
        fam = _kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms
    w_flops, a_flops = vlm_forward_flops(cfg, s)
    flops = w_flops + a_flops
    moved = param_bytes + s * cfg.vocab_size * 2
    flash_ms = families.get("flash_attention (hand kernel)", 0.0)
    out["prefill"] = dict(
        batch=1, positions=s, frontend=nf, text=s - nf, launches=launches,
        wall_s=walls[0], wall_s_repeats=walls[1:],
        tokens_per_s=s / min(walls), device_ms=dev_ms,
        device_ops=n_ops, flash_device_ms=flash_ms,
        flash_share_of_device_time=flash_ms / dev_ms,
        device_ms_by_family=families,
        top_kernels_ms=dict(list(by_kernel.items())[:8]),
        flops=flops, weight_flops=w_flops, attention_flops=a_flops,
        bytes=moved,
        bound_s=max(flops / PEAK_FLOPS["bfloat16"], moved / HBM_BYTES_PER_S),
        forward_max_memory_allocated_bytes=forward_peak,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(device))
    out["prefill"]["share_of_bound"] = out["prefill"]["bound_s"] / min(walls)
    del batch

    # ---- decode: the serve decode loop, counts at 0 just before
    b, pl_, g = VLM_DECODE
    prompts = torch.from_numpy(serve.make_inputs(cfg.vocab_size, b, pl_)[0]
                               ).to(device)
    reset()
    res = serve.run_decode(model, prompts, g)
    dec_launches = counts()
    gen_toks = res["tokens"]
    check(gen_toks.shape == (b, g) and ((gen_toks >= 0) &
                                        (gen_toks < cfg.vocab_size)).all(),
          f"vlm decode: generated tokens {gen_toks.shape} out of range")
    check(dec_launches["route_flash"] == dec_launches["route_chunked"] == 0,
          f"vlm decode: {dec_launches}; decode steps call no prefill route")
    step = build_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(b, pl_ + g + 1)
        step_kernels, step_launches = device_ms_by_kernel(
            lambda: step(cache, prompts[:, :1], pl_ + g))
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache for t in c.values())
        del cache
    step_ms = res["decode_s"] / g * 1e3
    read = param_bytes - model.embed.numel() * model.embed.element_size() \
        + b * cfg.d_model * model.embed.element_size() + cache_bytes
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    out["decode"] = dict(
        batch=b, prompt=pl_, gen=g, launches=dec_launches,
        prefill_by_steps_s=res["prefill_s"], decode_s=res["decode_s"],
        ms_per_step=step_ms, tokens_per_s=b * g / res["decode_s"],
        bytes_per_step=read, bound_ms_per_step=bound_ms,
        share_of_bound=bound_ms / step_ms,
        device_launches_per_step=step_launches,
        device_ms_per_step=sum(step_kernels.values()),
        device_idle_share=1.0 - sum(step_kernels.values()) / step_ms,
        first_generated=gen_toks[:2, :8].tolist())

    # ---- check (1): flash route against the chunked route, first layers
    nl, cb, cs = VLM_ROUTES_CHECK
    sub = _first_layers(model, nl)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (cb, cs - nf))).to(device)
    fe = _frontend(cfg, cb, gen, device)
    with torch.inference_mode():
        reset()
        lf = sub(toks, frontend=fe)
        flash_counts = counts()
        reset()
        lc = sub(toks, frontend=fe, force_chunked=True)
        chunked_counts = counts()
    check(flash_counts == dict(flash_kernel=nl, route_flash=nl,
                               route_chunked=0)
          and chunked_counts == dict(flash_kernel=0, route_flash=0,
                                     route_chunked=nl),
          f"vlm routes check: flash run {flash_counts}, chunked run "
          f"{chunked_counts}")
    out["check_routes"] = dict(layers=nl, batch=cb, positions=cs,
                               **_logits_check(lf, lc,
                                               "vlm flash vs chunked"))
    del lf, lc, sub, toks, fe, model, prefill, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- check (2): fp32 forward against decode_step, first layers
    nl, ds = VLM_DECODE_CHECK
    cfg32 = dataclasses.replace(cfg, n_super=nl, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device=device,
                generator=torch.Generator(device=device).manual_seed(2))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, ds))
                            ).to(device)
    with torch.inference_mode():
        fwd = m32(toks)
    dec = _decode_all(m32, toks)
    worst = _rel_rms_worst(dec, fwd)
    check(math.isfinite(worst) and worst <= VLM_DECODE_REL_RMS,
          f"vlm fp32 decode_step vs forward: {worst:.3g} of the logits' "
          f"rms (limit {VLM_DECODE_REL_RMS})")
    out["check_decode"] = dict(layers=nl, positions=ds, dtype="float32",
                               worst_rel_rms=worst,
                               rel_rms_limit=VLM_DECODE_REL_RMS)
    del m32, fwd, dec, toks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- training through run_train, 8 layers, then check (3)
    tr = VLM_TRAIN
    tcfg = dataclasses.replace(cfg, n_super=tr["layers"])
    check(tcfg.remat == "full", f"{tcfg.name}: remat {tcfg.remat!r}")
    lines = []
    torch.cuda.reset_peak_memory_stats(device)
    reset()
    t0 = time.perf_counter()
    res = run_train(tcfg, steps=tr["steps"], batch=tr["batch"],
                    seq=tr["seq"], device=device, log_every=1,
                    log=lines.append)
    torch.cuda.synchronize()
    train_launches = counts()
    losses = res["losses"]
    check(len(losses) == tr["steps"] and all(map(math.isfinite, losses)),
          f"vlm train: losses {losses}")
    check(train_launches["flash_kernel"] == 0
          and train_launches["route_flash"] == 0,
          f"vlm train: {train_launches}; training must not run the "
          f"forward-only flash kernel")
    tmodel = res["model"]
    n_params = sum(p.numel() for p in tmodel.parameters())
    step_s = res["step_s"][tr["warmup"]:]
    mean_s = sum(step_s) / len(step_s)
    w_flops, a_flops = vlm_forward_flops(tcfg, tr["seq"])
    tflops = 3.0 * tr["batch"] * (w_flops + a_flops)
    t_bound_s = tflops / PEAK_FLOPS["bfloat16"] + \
        OPT_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S
    train_peak = torch.cuda.max_memory_allocated(device)
    data_batch = res["data"].batch_at(tr["steps"])
    check(set(data_batch) == {"tokens", "labels", "frontend"}
          and data_batch["frontend"].shape[1] == nf,
          f"vlm train: the pipeline's batch holds {sorted(data_batch)}")
    batch = {k: torch.from_numpy(v[:1, :VLM_GRAD_S]).to(device)
             for k, v in data_batch.items()}
    reset()
    _, grads = steps_lib.loss_and_grads(tmodel, batch)
    grad_launches = counts()
    bad = []
    for i in range(tcfg.n_layers):
        for w in ("wq", "wk", "wv"):
            gr = grads[f"blocks.{i}.attn.{w}"]
            if not (bool(torch.isfinite(gr).all()) and
                    float(gr.abs().max()) > 0):
                bad.append(f"blocks.{i}.attn.{w}")
    check(not bad and grad_launches["flash_kernel"] == 0,
          f"vlm train: no nonzero finite gradient for {bad}, or flash "
          f"launches {grad_launches}")
    out["train"] = dict(
        layers=tcfg.n_layers, positions=tr["seq"], frontend=nf,
        text=tr["seq"] - nf, batch=tr["batch"], steps=tr["steps"],
        warmup_steps=tr["warmup"], remat=tcfg.remat, param_count=n_params,
        wall_s=time.perf_counter() - t0, losses=losses, lines=lines,
        step_s=res["step_s"], ms_per_step=mean_s * 1e3,
        ms_per_step_median=sorted(step_s)[len(step_s) // 2] * 1e3,
        tokens_per_s=tr["batch"] * tr["seq"] / mean_s, model_flops=tflops,
        bound_ms=t_bound_s * 1e3, share_of_bound=t_bound_s / mean_s,
        bound_convention="3 x forward FLOPs (weight products + causal "
        "attention, recompute excluded) at 989 TFLOP/s, plus the "
        "optimizer's 22 bytes a parameter at 3.35 TB/s",
        max_memory_allocated_bytes=train_peak, launches=train_launches,
        check_attention_grads=dict(layers=tcfg.n_layers,
                                   leaves=3 * tcfg.n_layers,
                                   positions=VLM_GRAD_S, ok=True))
    del grads, res, tmodel, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- check (4): the loss falls on a fixed batch, 2-layer fp32 model
    nl, lb, ls = VLM_LOSS_CHECK
    cfg2 = dataclasses.replace(cfg, n_super=nl, param_dtype="float32",
                               compute_dtype="float32")
    m2 = Model(cfg2, device=device,
               generator=torch.Generator(device=device).manual_seed(1))
    m2.requires_grad_(True)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=ls, global_batch=lb,
        frontend="vision", n_frontend_tokens=nf, d_model=cfg.d_model))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(0).items()}
    lr = TRAIN_LR_SMOKE * math.sqrt(64 / cfg.d_model)
    ocfg = opt.OptConfig(lr=lr, warmup_steps=1, total_steps=50)
    step = steps_lib.build_train_step(
        m2, ocfg, opt.init(dict(m2.named_parameters()), ocfg))
    fixed = [float(step(batch)["loss"]) for _ in range(TRAIN_CHECK_STEPS)]
    check(all(map(math.isfinite, fixed)) and
          fixed[-1] < fixed[0] - TRAIN_MIN_DROP,
          f"vlm train: the loss on a fixed batch went {fixed} at lr "
          f"{lr:.3g}")
    out["check_loss_decreases"] = dict(
        layers=nl, batch=lb, positions=ls, lr=lr, losses=fixed,
        drop=fixed[0] - fixed[-1], min_drop=TRAIN_MIN_DROP)
    out["launches"] = dict(prefill=launches, decode=dec_launches,
                           train=train_launches)
    del m2, step, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["card"] = card_line()
    return out


# -------------------------------------------------------------------- dist

# the sharded path's parity run: 8 layers of qwen2-vl-7b in fp32 (no TF32
# products), 2 steps; seq 4,096 -> 1,024 (256 frontend + 768 text) so the
# fp32 weights, their sharded copies, gradients and moments (~59 GB) fit
DIST_TRAIN = dict(layers=8, seq=1024, batch=1, steps=2)
DIST_LOSS_RTOL = 1e-5
# the first step's gradients against the world of one's: the norm of a
# leaf's difference over the leaf's norm, and every element over the
# leaf's largest (the train line's gradient tolerance)
DIST_GRAD_RTOL = 1e-5
DIST_GRAD_MAX = 1e-4
# after the first step the two runs' leaves differ by what AdamW's first
# update makes of their gradients' difference, which the check predicts
# element by element (``selftest._first_step``): an element whose
# gradient is near 0 turns a last-bit difference into a step of up to
# 2·lr (lr 1e-3).  What is left is rounding (ulps of the leaf), held
# within 1e-6 of the leaf's largest element: a wrong sharded update of
# any element shows there.  After the last step the leaves are held, in
# norm and by element, to 1e-4 / 1e-2, above the card's largest
# readings, 5.0e-5 / 2.8e-3, which are the first step's gap (PERF.md §6)
DIST_FIRST_STEP_MAX = 1e-6
DIST_LEAF_RTOL = 1e-4
DIST_LEAF_MAX = 1e-2
# every card visible (4 or more): the same 8-layer qwen2-vl in fp32 on a
# (1, 4) and a (2, 2) NCCL mesh, batch 2 (a row for each "data" rank)
DIST_MESHES = ((1, 4), (2, 2))
DIST_MESH_TRAIN = dict(layers=8, seq=1024, batch=2, steps=2)
# then mistral-nemo-12b at its full 40 layers, bf16, on (1, 4): what no
# card holds alone (master, moments and weights ~98 GB + activations)
DIST_BIG = dict(mesh=(1, 4), seq=4096, batch=1, steps=4, warmup=1)
# one card: two gloo ranks share it (NCCL refuses a duplicate GPU); a
# (1, 2) tensor-parallel mesh on qwen2-vl cut to 2 layers, and a (2, 1)
# data-parallel mixture-of-experts mesh on arctic cut to 1 layer of 8
# experts (its flat dispatch drops ~22 % of the slots at random weights),
# fp32, with the world of one on rank 0.  Then the blocks split by heads
# over "model" (``blocks.heads_split``): zamba2 at full width (80
# Mamba-2 heads, 40 a rank) cut to one super-block (5 Mamba-2 layers and
# the shared attention); xlstm at full width (4 heads, 2 a rank) cut to
# DIST_XLSTM's depth and sequence; and qwen2-vl's 28 query heads over 4
# K/V heads on (1, 8), eight gloo ranks (3 or 4 query heads a rank and
# the K/V head they read; all four attention leaves' slices are not
# the ranks' parts, so each use gathers the leaf or its product),
# cut to 1 layer and a vocabulary of 8,192 so that the world of one fits
# the card beside the ranks, and 1 step (the first update is predicted
# element by element, and the leaves after it held).  ``floor_k``: the
# case also runs the world of one twice more, one ulp apart, for its
# fp32 floor, and a figure within ``floor_k`` times its floor passes.
# The whole script must end within 1,200 s on a card whose host may be
# slow (the host-bound phases of one run took 1.4x another's, PERF.md
# §6): the tp case at the whole vocabulary took 183.5-209.8 s, 130-150 s
# more than at 8,192, more than the new cases take together beside the
# `ssm` line's xlstm train back at 24 layers, so the tp case keeps the
# vocabulary of 8,192 (70 % of its weights were the two vocabulary
# tables, which hold no head and no sharding this line checks)
# xlstm in fp32 is chaotic at depth: its world of one, run again from its
# embedding one ulp up, moves its own loss by 2.3e-3 and gradients by up
# to 39 % of a leaf's largest element at 24 layers and seq 512, and its
# gradients past the 1e-5 bound already at 2 layers and seq 256 (the
# sLSTM's recurrent ``r``, summed over the tokens; PERF.md §6).  Its
# parity case runs where that floor lies under the bounds, at half of
# them on an H100: one super-block (an mLSTM and an sLSTM layer), seq 64
# (the mLSTM's chunk cut with it from 256); at full depth (24 layers, seq
# 256) its sharded steps alone must give finite losses, 1 step
DIST_XLSTM = dict(arch="xlstm-350m", layers=1, seq=64, chunk=64)
# the experts' width split's weights form (``moe.width_form``: the
# experts' slices gathered whole, the rank's own tokens kept), on arctic
# cut to a width of 512 (8 heads of 64, the dense residual 512 wide, a
# vocabulary of 8,192) and experts 64 wide, 1 layer, fp32, at
# DIST_SHARED_STEP's batch 2 x 512 (one row a data rank): by the rule
# 9.50 MB of tokens against 6.29 MB of expert slices a layer
# (``remat="full"``), so the rule gathers the slices; at full width it
# would need ~26,000 rows a rank.  (At experts 512 wide and seq 4,096
# the world of one's 8,192 tokens make the CPU's embedding backward
# sum in a varying order: the first update's prediction misses by up to
# 8e-6 of ``embed``'s largest element, in either form.)
DIST_MOE_NARROW = dict(d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
                       d_ff=512, moe_d_ff=64, vocab_size=8192)
DIST_SHARED = dict(tp=dict(arch=VLM_ARCH, mesh=(1, 2), layers=2,
                           vocab=8192),
                   moe=dict(arch="arctic-480b", mesh=(2, 1), layers=1,
                            experts=8, form="tokens"),
                   zamba2=dict(arch="zamba2-2.7b", mesh=(1, 2), layers=1,
                               floor_k=4.0),
                   xlstm=dict(DIST_XLSTM, mesh=(1, 2)),
                   heads=dict(arch=VLM_ARCH, mesh=(1, 8), layers=1,
                              vocab=8192, steps=1),
                   moe_weights=dict(arch="arctic-480b", mesh=(2, 1),
                                    layers=1, experts=8,
                                    narrow=DIST_MOE_NARROW, form="weights"))
DIST_SHARED_STEP = dict(batch=2, seq=512, steps=2)
# the two width forms at arctic's full width (d_model 7,168, 8 experts
# 4,864 wide, fp32) on (2, 1), forced on the same rows: the first block's
# routed FFN forward and backward (``selftest.moe_width_forms``) on 2 x
# 4,096 tokens (one sequence a data rank; the rule would take the
# weights form from ~26,000 rows a rank), the weights form held against
# the tokens form at DIST_LOSS_RTOL / DIST_GRAD_RTOL / DIST_GRAD_MAX; one
# pass a form, so each form's seconds carry its set-up
DIST_MOE_FORMS = dict(arch="arctic-480b", mesh=(2, 1), layers=1, experts=8,
                      batch=2, seq=4096)
DIST_XLSTM_DEEP = dict(arch="xlstm-350m", mesh=(1, 2), seq=256, steps=1)
# the two forms of a leaf whose stored "model" slice is not its rank's
# part (``blocks.heads_form``: the leaf gathered whole, or the product of
# the stored slice exchanged) at decode, on (1, 2): one Mamba-2 block of
# zamba2 (its packed ``in_proj``), one mLSTM (``up``) and one sLSTM
# block of xlstm (``wx``, ``r``, ``out`` gathered in its heads split; its
# channels split, ``blocks.slstm_split``, which the rule and the
# activations form take at decode: ``wx``'s product and ``h`` at every
# step, ``r`` as stored), at full width, fp32, the SSM's chunk cut to the
# 64 positions of the forward, LM_DECODE's batch of 4: the forward, then
# 8 decode steps, in each form forced and under the rule
# (``selftest.heads_decode_forms``), each within DIST_DECODE_REL_RMS of
# the world of one (the fp32 decode bound, PERF.md §2)
DIST_HEADS_DECODE = dict(cases=(("mamba2", "zamba2-2.7b"),
                                ("mlstm", "xlstm-350m"),
                                ("slstm", "xlstm-350m")),
                         mesh=(1, 2), seq=64, steps=8)
# and the mLSTM's value split (``blocks.value_split``) the same way on
# (1, 8), eight gloo ranks: 4 heads of 512 over 8 ranks, each rank one
# head's q / k whole and 256 of its value channels (``wv`` and ``down``
# then stored as used; ``up``, ``wq``, ``wk`` exchanged); and the sLSTM,
# 4 heads of 256 over 8 ranks: at decode 32 channels of every head a
# rank in its channels split, in the heads split 4 ranks of 8 with none
DIST_HEADS_VALUES = dict(cases=(("mlstm", "xlstm-350m"),
                                ("slstm", "xlstm-350m")), mesh=(1, 8),
                         seq=64, steps=8)
DIST_DECODE_REL_RMS = 1e-3
# zamba2's fp32 floor lies above those bounds: its Mamba-2 per-head fp32
# scalars (``a_log``, ``d_skip``, ``dt_bias``) take gradients summed over
# every token with heavy cancellation, so any other fp32 order of the same
# sums moves them past the 1e-5 bound, and AdamW's first update carries
# that into the leaves, which start at 0.  So a figure of a leaf is held
# at its bound or within ``floor_k`` = 4 times the world of one's own
# fp32 floor for it (``selftest.beyond_floor``; a floor whose allowance
# would reach a tenth of its leaf opens no way), as
# ``tests/test_torch_tp_recurrent.py`` holds zamba2's smoke config; the
# readings above the bound sat at most 2.5x their floor (PERF.md §6)
# every card visible: the MoE on (2, 2) in fp32 against one card, 16
# experts (so the specs shard them over "model") of arctic's width, each
# rank 8 of them at half their hidden width; then arctic at its full
# width and its 128 experts, 2 layers, bf16 (bf16 moments, as
# ``optimizer.moment_dtype_for`` takes them for arctic), on (2, 2): 64
# experts a rank at d_ff / 2, 6.69 GB of expert weights a layer
DIST_MOE_MESH = dict(arch="arctic-480b", mesh=(2, 2), layers=1, experts=16,
                     form="tokens")
# and the weights form of the same split on (2, 2): DIST_MOE_NARROW's
# arctic with 16 experts (8 a rank over "model", as on one card)
DIST_MOE_WEIGHTS_MESH = dict(DIST_SHARED["moe_weights"], mesh=(2, 2),
                             experts=16)
DIST_MOE_BIG = dict(arch="arctic-480b", mesh=(2, 2), layers=2, seq=1024,
                    batch=2, steps=3, warmup=1)
# every card visible: xlstm at full width in fp32 on (1, 4) (one head a
# rank) against one card, at DIST_XLSTM's depth and sequence,
# then zamba2 at full width and depth (54 layers), bf16, on (1, 4): 20
# Mamba-2 heads a rank
DIST_RECURRENT_PARITY = dict(DIST_XLSTM, mesh=(1, 4))
DIST_RECURRENT_BIG = dict(arch="zamba2-2.7b", mesh=(1, 4), seq=4096,
                          batch=1, steps=3, warmup=1)


def _fp32(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


def _parity_checked(outs, what, floor_k=0.0):
    """Each rank's ``selftest.sharded_step_parity`` record held at the
    bounds (or, where the case ran the world of one's floor, within
    ``floor_k`` times it: ``selftest.beyond_floor``), its first update
    explained, its parameter bytes the specs' share; the figures, the
    heads and leaf shapes of each rank."""
    from repro_torch.distributed import selftest
    bounds = dict(loss_rel_err=DIST_LOSS_RTOL,
                  grad_rel_norm=DIST_GRAD_RTOL,
                  grad_err_over_max=DIST_GRAD_MAX,
                  leaf_rel_norm=DIST_LEAF_RTOL,
                  leaf_err_over_max=DIST_LEAF_MAX)
    for o in outs:
        beyond = selftest.beyond_floor(o, bounds, floor_k)
        check(not beyond and o["first_step_unexplained_over_max"] <=
              DIST_FIRST_STEP_MAX,
              f"dist: {what}: beyond the bounds"
              f"{' and %s x the floor' % floor_k if floor_k else ''}"
              f" (figure, leaf, value, floor): {beyond[:5]}; first step "
              f"unexplained {o['first_step_unexplained_over_max']} "
              f"({o['first_step_unexplained_leaf']}) against the world "
              f"of one")
    o = outs[0]
    out = {k: o[k] for k in ("mesh", "steps", "losses_single",
                             "losses_sharded", "loss_rel_err",
                             "worst_grad_rel_norm",
                             "worst_grad_err_over_max", "worst_grad_leaf",
                             "worst_leaf_rel_norm",
                             "worst_leaf_err_over_max", "worst_leaf",
                             "first_step_unexplained_over_max",
                             "first_step_unexplained_leaf",
                             "first_step_leaf_rel_norm", "param_bytes",
                             "spec_param_bytes", "leaf_gathers",
                             "coll_bytes", "coll_bytes_by_axis",
                             "moe_width_forms", "step_peak_bytes",
                             "seconds_by_part")}
    _shares_checked(outs, what)
    # the copies of leaves held alike each rank held to rank 0's, bit for
    # bit; each rank's heads and the shapes of its leaves, by block kind
    out["replica_checks_by_rank"] = [r["replica_checks"] for r in outs]
    out["heads_by_rank"] = [r["heads"] for r in outs]
    if "floors" in o:       # each figure's worst leaf and worst floor
        # over its bound, and the figures above their bound with floors
        out["over_bound"] = {f: max(o["figures"][f].values()) / bounds[f]
                             for f in bounds}
        out["floor_over_bound"] = {f: max(o["floors"][f].values()) /
                                   bounds[f] for f in bounds}
        out["at_floor"] = {f: sorted(
            ((n, v, o["floors"][f][n]) for n, v in o["figures"][f].items()
             if v > bounds[f]), key=lambda t: -t[1])[:8] for f in bounds}
    return out


def _shares_checked(outs, what):
    for r in outs:
        check(r["param_bytes"] == r["spec_param_bytes"],
              f"dist: {what}: {r['param_bytes']} parameter bytes, the "
              f"specs' share is {r['spec_param_bytes']}")


def _expert_shapes_checked(outs, cfg, mesh, what):
    """Every rank holds ``[E/m, d, d_ff/D]`` of ``w1`` / ``w3`` and
    ``[E/m, d_ff/D, d]`` of ``w2`` (E whole where the specs do not shard
    it): the distinct shapes, by leaf kind."""
    from repro_torch.models import sharding
    e = cfg.n_experts // (mesh[1] if sharding.mdl(cfg.n_experts) else 1)
    f = cfg.moe_d_ff // mesh[0]
    want = dict(w1=[e, cfg.d_model, f], w3=[e, cfg.d_model, f],
                w2=[e, f, cfg.d_model])
    for o in outs:
        check(bool(o["expert_shapes"]) and
              all(shape == want[n[-2:]]
                  for n, shape in o["expert_shapes"].items()),
              f"dist: {what}: expert leaves {o['expert_shapes']}, want "
              f"{want}")
    return want


def dist_shared_card(device_type="cuda"):
    """Gloo ranks share the one card: ``selftest.sharded_step_parity`` of
    each mesh of ``DIST_SHARED`` (a (1, 2) tensor-parallel mesh, a (2, 1)
    data-parallel MoE mesh in each width form, the recurrent blocks and
    an uneven head split over "model") against the world of one, in
    fp32; arctic's routed FFN at full width in both width forms
    (:func:`_moe_forms`); the recurrent blocks decoding in each heads
    form (:func:`_heads_decode`); then ``DIST_XLSTM_DEEP``'s sharded
    steps alone (``selftest.sharded_losses``): finite losses, every
    rank's alike."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import selftest
    from repro_torch.distributed.launch import spawn
    out = {}
    st = DIST_SHARED_STEP
    for name, run in DIST_SHARED.items():
        extra = _case_cuts(run)
        cfg = _fp32(get_config(run["arch"]), **extra)
        t0 = time.perf_counter()
        outs = spawn(selftest.sharded_step_parity,
                     run["mesh"][0] * run["mesh"][1],
                     (cfg, run["mesh"], st["batch"],
                      run.get("seq", st["seq"]), run.get("steps", st["steps"]),
                      1e-3, "floor_k" in run),
                     device_type=device_type, backend="gloo", timeout=900.0)
        out[name] = dict(arch=run["arch"], **extra,
                         layers=cfg.n_layers, seq=run.get("seq", st["seq"]),
                         **_parity_checked(outs, f"{name} {run['mesh']}",
                                           run.get("floor_k", 0.0)),
                         seconds=time.perf_counter() - t0)
        if "experts" in run:
            out[name]["expert_shapes"] = _expert_shapes_checked(
                outs, cfg, run["mesh"], f"{name} {run['mesh']}")
        _forms_checked(outs, run, f"{name} {run['mesh']}")
    out["moe_forms"] = _moe_forms(device_type)
    out["heads_decode"] = _heads_decode(device_type)
    run = DIST_XLSTM_DEEP
    cfg = _fp32(get_config(run["arch"]))
    t0 = time.perf_counter()
    outs = spawn(selftest.sharded_losses, run["mesh"][0] * run["mesh"][1],
                 (cfg, run["mesh"], st["batch"], run["seq"], run["steps"]),
                 device_type=device_type, backend="gloo", timeout=900.0)
    what = f"{run['arch']} {run['mesh']} at full depth"
    check(all(math.isfinite(x) for x in outs[0]["losses"]) and
          all(o["losses"] == outs[0]["losses"] for o in outs),
          f"dist: {what}: losses {[o['losses'] for o in outs]}")
    _shares_checked(outs, what)
    out["xlstm_deep"] = dict(arch=run["arch"], layers=cfg.n_layers,
                             mesh=list(run["mesh"]), seq=run["seq"],
                             losses=outs[0]["losses"],
                             param_bytes=outs[0]["param_bytes"],
                             heads_by_rank=[o["heads"] for o in outs],
                             seconds=time.perf_counter() - t0)
    return out


def _moe_forms(device_type):
    """``DIST_MOE_FORMS`` on gloo ranks sharing the card: the weights
    form's loss and gradients against the tokens form's on the same rows,
    within the bounds; every dispatch in its forced form, the weights
    form gathering each expert leaf once; for each form the seconds, the
    peak memory and the "data" bytes of each rank beside the rule's
    count; and the spread of the weights form's expert rows: each rank's
    busiest expert against ``⌈cap/D⌉``, the even share the dry-run counts
    on ``meta``, under this routing (random weights from seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import selftest
    from repro_torch.distributed.launch import spawn
    from repro_torch.models import moe
    run = DIST_MOE_FORMS
    cfg = _fp32(get_config(run["arch"]), **_case_cuts(run))
    mesh, d = run["mesh"], run["mesh"][0]
    what = f"moe forms {mesh} at full width"
    t0 = time.perf_counter()
    outs = spawn(selftest.moe_width_forms, mesh[0] * mesh[1],
                 (cfg, mesh, run["batch"], run["seq"]),
                 device_type=device_type, backend="gloo", timeout=900.0)
    bounds = dict(loss_rel_err=DIST_LOSS_RTOL, grad_rel_norm=DIST_GRAD_RTOL,
                  grad_err_over_max=DIST_GRAD_MAX)
    worst = [{f: max(o["figures"].get(f, {}).values(), default=0.0)
              for f in bounds} for o in outs]
    experts = {"data": {f"blocks.0.moe.{n}": 1 for n in ("w1", "w3", "w2")}}
    for q, o in enumerate(outs):
        check(all(worst[q][f] <= b for f, b in bounds.items()),
              f"dist: {what}: rank {q}: the weights form against the "
              f"tokens form {worst[q]}, bounds {bounds}")
        check(all(o[f]["forms"] == {f: 1} for f in moe.FORMS) and
              o["weights"]["leaf_gathers"] == experts and
              o["tokens"]["leaf_gathers"] == {},
              f"dist: {what}: rank {q}: forms "
              f"{[o[f]['forms'] for f in moe.FORMS]}, leaves gathered "
              f"{[o[f]['leaf_gathers'] for f in moe.FORMS]}")
    args = (run["batch"] // d * run["seq"], cfg.d_model, cfg.moe_d_ff,
            cfg.n_experts // mesh[1], cfg.top_k, d, 4, 4, True)
    rule = moe.width_form_bytes(*args)
    cap = outs[0]["tokens"]["expert_rows"]      # flat: one group
    even = -(-cap // d)
    rows = [o["weights"]["expert_rows"] for o in outs]
    return dict(
        arch=run["arch"], layers=cfg.n_layers, experts=cfg.n_experts,
        d_model=cfg.d_model, moe_d_ff=cfg.moe_d_ff, mesh=list(mesh),
        batch=run["batch"], seq=run["seq"], dtype="float32",
        worst_by_rank=worst, bounds=bounds,
        by_form={f: dict(
            seconds=[o[f]["seconds"] for o in outs],
            step_peak_bytes=[o[f]["step_peak_bytes"] for o in outs],
            held_bytes=[o[f]["held_bytes"] for o in outs],
            data_bytes=[o[f]["by_axis"].get("data", 0) for o in outs],
            rule_bytes=rule[f], expert_rows=[o[f]["expert_rows"] for o in outs])
            for f in moe.FORMS},
        rule_form=moe.width_form(*args), cap=cap, even_rows=even, weights_rows_by_rank=rows,
        busiest_over_even=max(rows) / even,
        seconds=time.perf_counter() - t0)


def _heads_decode(device_type):
    """``DIST_HEADS_DECODE``, then ``DIST_HEADS_VALUES`` under ``values``
    (:func:`_heads_decode_run`)."""
    out = _heads_decode_run(device_type, DIST_HEADS_DECODE)
    out["values"] = _heads_decode_run(device_type, DIST_HEADS_VALUES)
    return out


def _heads_decode_run(device_type, run):
    """``run``'s blocks on gloo ranks sharing the card: each block in
    each heads form forced and under the rule, against the world of one
    within DIST_DECODE_REL_RMS; in the decode steps, the rule takes the
    activations form wherever a leaf has it (the calls by form equal the
    forced activations form's), and each form's "model" all-gathers move
    the bytes the rule counts; each rank computes the heads of
    ``blocks.heads_split`` (the mLSTM's heads and value channels of
    ``blocks.value_split``; the sLSTM, whose decode steps take its
    channels split under the rule and the activations form and its heads
    split under the weights form, the channels ``heads_split(hd, m, q)``
    of every head there); the milliseconds a decode step of each form,
    recorded beside the card (not gated)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import selftest
    from repro_torch.distributed.launch import spawn
    from repro_torch.models import blocks
    m = run["mesh"][1]
    cases = [(_fp32(get_config(arch), ssm_chunk=run["seq"]), kind)
             for kind, arch in run["cases"]]
    t0 = time.perf_counter()
    outs = spawn(selftest.heads_decode_forms, m,
                 (cases, LM_DECODE[0], run["seq"], run["steps"]),
                 device_type=device_type, backend="gloo", timeout=900.0)
    cfg_of = {kind: cfg for cfg, kind in cases}
    for q, o in enumerate(outs):
        for kind, by_form in o.items():
            cfg = cfg_of[kind]
            what = f"heads decode {kind} {run['mesh']}: rank {q}"
            if kind == "mlstm":
                _, h, hd = blocks._mlstm_dims(cfg)
                want = blocks.value_split(h, hd, m, q)
            else:
                h = blocks._mamba_dims(cfg)[2] if kind == "mamba2" else \
                    cfg.n_heads
                want = blocks.heads_split(h, m, q)
            for form, r in by_form.items():
                got = tuple(next(iter(r["heads"].values()))) + tuple(
                    r["channels"] or ())
                split_gives = want
                if kind == "slstm":
                    split = "heads" if form == "weights" else "channels"
                    check(r["splits"]["decode"] == split,
                          f"dist: {what}: {form}: decodes in the "
                          f"{r['splits']['decode']} split, not {split}")
                    if split == "channels":
                        got, split_gives = tuple(r["channels"]), \
                            blocks.heads_split(cfg.d_model // h, m, q)
                check(got == split_gives, f"dist: {what}: {form}: computes "
                      f"{got}, the split gives {split_gives}")
                check(r["rel_rms"] <= DIST_DECODE_REL_RMS,
                      f"dist: {what}: {form}: {r['rel_rms']} of the world "
                      f"of one's rms (limit {DIST_DECODE_REL_RMS})")
                check(r["model_bytes"].get("all-gather", 0) ==
                      sum(r["heads_moved"].values()),
                      f"dist: {what}: {form}: all-gathers "
                      f"{r['model_bytes']}, the rule's count "
                      f"{r['heads_moved']}")
            acts = by_form["activations"]["heads_forms"]
            check(acts.get("activations", 0) > 0 and
                  by_form["rule"]["heads_forms"] == acts and
                  set(by_form["weights"]["heads_forms"]) == {"weights"},
                  f"dist: {what}: calls by form "
                  f"{ {f: r['heads_forms'] for f, r in by_form.items()} }")
    return dict(
        cases=[list(c) for c in run["cases"]], mesh=list(run["mesh"]),
        batch=LM_DECODE[0], seq=run["seq"], steps=run["steps"],
        dtype="float32", rel_rms_limit=DIST_DECODE_REL_RMS,
        by_case={kind: {form: dict(
            rel_rms=[o[kind][form]["rel_rms"] for o in outs],
            decode_ms=[o[kind][form]["decode_ms"] for o in outs],
            heads_by_rank=[_decode_part(o[kind][form], cfg_of[kind])
                           for o in outs],
            splits=outs[0][kind][form]["splits"],
            heads_forms=outs[0][kind][form]["heads_forms"],
            model_bytes=outs[0][kind][form]["model_bytes"],
            rule_bytes=outs[0][kind][form]["heads_moved"])
            for form in outs[0][kind]} for kind in outs[0]},
        card=card_line(), seconds=time.perf_counter() - t0)


def _decode_part(r, cfg):
    """The heads and channels a rank's decode steps computed, from one
    form's record of ``selftest.heads_decode_forms``: an sLSTM in its
    channels split every head and its channels."""
    heads = list(next(iter(r["heads"].values())))
    if (r["splits"] or {}).get("decode") == "channels":
        heads = [0, cfg.n_heads]
    return heads + (r["channels"] or [])


def _case_cuts(run):
    """A case's cuts of its config: experts, super-blocks, vocabulary,
    the SSM's chunk, and its ``narrow`` widths."""
    return {**{k: run[v] for k, v in (("n_experts", "experts"),
                                      ("n_super", "layers"),
                                      ("vocab_size", "vocab"),
                                      ("ssm_chunk", "chunk")) if v in run},
            **run.get("narrow", {})}


def _forms_checked(outs, run, what):
    """Where ``run`` names the MoE's width ``form``, every rank's every
    dispatch took it."""
    if "form" in run:
        forms = [o["moe_width_forms"] for o in outs]
        check(all(set(f) == {run["form"]} for f in forms),
              f"dist: {what}: width forms {forms}, want {run['form']}")


def dist_every_card(device, device_type="cuda"):
    """Four NCCL ranks, one a card: the 8-layer qwen2-vl in fp32 on each
    mesh of ``DIST_MESHES`` against the un-meshed run (every step's
    loss); the MoE on ``DIST_MOE_MESH`` (the tokens form) and on
    ``DIST_MOE_WEIGHTS_MESH`` (the weights form) against the world of
    one, and arctic at full width (:func:`_moe_big`); the recurrent blocks
    (:func:`_recurrent_every_card`); then 40-layer mistral-nemo-12b on
    ``DIST_BIG["mesh"]`` for a few steps (:func:`_mesh_train`): each
    rank's peak memory, the step time, the collectives' bytes a step by
    kind, the bytes held beside the specs' share."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import selftest
    from repro_torch.distributed.launch import spawn
    from repro_torch.launch.train import run_train
    import torch
    tr = DIST_MESH_TRAIN
    cfg = _fp32(get_config(VLM_ARCH), n_super=tr["layers"])
    kw = dict(steps=tr["steps"], batch=tr["batch"], seq=tr["seq"],
              log_every=1)
    single = run_train(cfg, device=device, log=lambda line: None,
                       **kw)["losses"]
    if device_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out = dict(cards=card_lines(), parity=[])
    for shape in DIST_MESHES:
        reps = spawn(selftest.mesh_train_report, 4, (cfg, shape, kw),
                     device_type=device_type, timeout=900.0)
        for r in reps:
            rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], single)]
            check(len(rel) == tr["steps"] and max(rel) <= DIST_LOSS_RTOL,
                  f"dist: {shape} losses {r['losses']} against {single}")
        out["parity"].append(dict(
            mesh=list(shape), arch=VLM_ARCH, layers=tr["layers"],
            losses_single=single, losses_mesh=reps[0]["losses"],
            loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                             zip(reps[0]["losses"], single)),
            ms_per_step=[r["step_s"][-1] * 1e3 for r in reps],
            peak_bytes=[r["peak_bytes"] for r in reps]))
    run = DIST_MOE_MESH
    st = DIST_SHARED_STEP
    mcfg = _fp32(get_config(run["arch"]), n_super=run["layers"],
                 n_experts=run["experts"])
    t0 = time.perf_counter()
    outs = spawn(selftest.sharded_step_parity, 4,
                 (mcfg, run["mesh"], st["batch"], st["seq"], st["steps"]),
                 device_type=device_type, timeout=900.0)
    _forms_checked(outs, run, f"moe {run['mesh']}")
    out["moe_parity"] = dict(
        arch=run["arch"], layers=run["layers"], experts=run["experts"],
        **_parity_checked(outs, f"moe {run['mesh']}"),
        expert_shapes=_expert_shapes_checked(outs, mcfg, run["mesh"],
                                             f"moe {run['mesh']}"),
        seconds=time.perf_counter() - t0)
    run = DIST_MOE_WEIGHTS_MESH
    wcfg = _fp32(get_config(run["arch"]), **_case_cuts(run))
    what = f"moe weights form {run['mesh']}"
    t0 = time.perf_counter()
    outs = spawn(selftest.sharded_step_parity, 4,
                 (wcfg, run["mesh"], st["batch"], st["seq"], st["steps"]),
                 device_type=device_type, timeout=900.0)
    _forms_checked(outs, run, what)
    out["moe_weights"] = dict(
        arch=run["arch"], layers=run["layers"], experts=run["experts"],
        seq=st["seq"], **run["narrow"], **_parity_checked(outs, what),
        expert_shapes=_expert_shapes_checked(outs, wcfg, run["mesh"], what),
        seconds=time.perf_counter() - t0)
    if device_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["moe_big"] = _moe_big(device_type)
    if device_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["recurrent"] = _recurrent_every_card(device_type)
    if device_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["big"] = _mesh_train(get_config(LM_ARCH), dict(arch=LM_ARCH,
                                                       **DIST_BIG),
                             device_type)
    return out


def _mesh_train(cfg, run, device_type):
    """A few steps of ``run_train`` of ``cfg`` on ``run["mesh"]``, one
    NCCL rank a card: the losses (finite, every rank's alike), the ms a
    step after ``run["warmup"]``, each rank's peak memory, the bytes held
    beside the specs' share (equal, or the check fails) and the
    collectives' bytes a step by kind and axis."""
    from repro_torch.distributed import selftest
    from repro_torch.distributed.launch import spawn
    from repro_torch.optim.optimizer import moment_dtype_for
    kw = dict(steps=run["steps"], batch=run["batch"], seq=run["seq"],
              log_every=1)
    t0 = time.perf_counter()
    reps = spawn(selftest.mesh_train_report, 4, (cfg, run["mesh"], kw),
                 device_type=device_type, timeout=900.0)
    for r in reps:
        check(all(math.isfinite(x) for x in r["losses"]) and
              r["losses"] == reps[0]["losses"],
              f"dist: {run['arch']} on {run['mesh']}: losses {r['losses']}")
        check(r["param_bytes"] == r["param_bytes_by_specs"],
              f"dist: {run['arch']} on {run['mesh']}: {r['param_bytes']} "
              f"parameter bytes, the specs say {r['param_bytes_by_specs']}")
    w = run["warmup"]
    return dict(
        arch=run["arch"], layers=cfg.n_layers, mesh=list(run["mesh"]),
        seq=run["seq"], batch=run["batch"], dtype=cfg.param_dtype,
        moments=moment_dtype_for(cfg), remat=cfg.remat,
        losses=reps[0]["losses"],
        ms_per_step=[sum(r["step_s"][w:]) / len(r["step_s"][w:]) * 1e3
                     for r in reps],
        peak_bytes=[r["peak_bytes"] for r in reps],
        param_bytes=[r["param_bytes"] for r in reps],
        param_bytes_by_specs=reps[0]["param_bytes_by_specs"],
        moment_bytes=[r["moment_bytes"] for r in reps],
        moment_bytes_by_specs=reps[0]["moment_bytes_by_specs"],
        coll_bytes_per_step=reps[0]["coll_bytes_per_step"],
        coll_calls_per_step=reps[0]["coll_calls_per_step"],
        coll_bytes_by_axis_per_step=reps[0]["coll_bytes_by_axis_per_step"],
        leaf_gathers=reps[0]["leaf_gathers"],
        moe_width_forms=reps[0]["moe_width_forms"],
        seconds=time.perf_counter() - t0)


def _moe_big(device_type):
    """``DIST_MOE_BIG``: arctic at its full width on (2, 2), bf16
    (:func:`_mesh_train`), with its expert leaves' shapes and the width
    form its shapes take (``moe.width_form``: the tokens, the expert
    slices being the larger by far; every dispatch must take it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe, sharding
    run = DIST_MOE_BIG
    cfg = dataclasses.replace(get_config(run["arch"]), n_super=run["layers"])
    e = cfg.n_experts // (run["mesh"][1] if sharding.mdl(cfg.n_experts)
                          else 1)
    f = cfg.moe_d_ff // run["mesh"][0]
    rule = (run["batch"] // run["mesh"][0] * run["seq"], cfg.d_model,
            cfg.moe_d_ff, e, cfg.top_k, run["mesh"][0], 2, 2, True,
            cfg.remat != "none")
    out = dict(**_mesh_train(cfg, run, device_type),
               expert_w1=[e, cfg.d_model, f],
               expert_bytes_per_layer=3 * e * cfg.d_model * f * 2,
               moe_width_form=moe.width_form(*rule),
               width_bytes_per_layer=moe.width_form_bytes(*rule))
    check(set(out["moe_width_forms"]) == {out["moe_width_form"]},
          f"dist: arctic on {run['mesh']}: width forms "
          f"{out['moe_width_forms']}, the rule says {out['moe_width_form']}")
    return out


def _recurrent_every_card(device_type):
    """The recurrent blocks split by heads over "model", one NCCL rank a
    card: xlstm at full width in fp32 on ``DIST_RECURRENT_PARITY``'s
    mesh, depth and sequence against the world of one (1 head a rank),
    then zamba2 at full width and depth, bf16, on
    ``DIST_RECURRENT_BIG["mesh"]`` (:func:`_mesh_train`: 20 Mamba-2 heads
    and 8 attention heads a rank)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import selftest
    from repro_torch.distributed.launch import spawn
    run, st = DIST_RECURRENT_PARITY, DIST_SHARED_STEP
    cfg = _fp32(get_config(run["arch"]), **_case_cuts(run))
    t0 = time.perf_counter()
    outs = spawn(selftest.sharded_step_parity, 4,
                 (cfg, run["mesh"], st["batch"], run["seq"], st["steps"]),
                 device_type=device_type, timeout=900.0)
    out = dict(parity=dict(arch=run["arch"], layers=cfg.n_layers,
                           seq=run["seq"],
                           **_parity_checked(outs, f"{run['arch']} "
                                             f"{run['mesh']}"),
                           seconds=time.perf_counter() - t0))
    if device_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    run = DIST_RECURRENT_BIG
    out["big"] = _mesh_train(get_config(run["arch"]), run, device_type)
    return out


def dist_phase(device):
    """The multi-device training path.  On the card's world of one: an
    NCCL process group and a (1, 1) ("data", "model") ``DeviceMesh``; the
    self-test's four checks (the GPipe pipeline, the int8 all-reduce, the
    sharded train step against the single one, an elastic restore), then
    ``run_train`` of the 8-layer ``qwen2-vl-7b`` in fp32 with ``mesh=``
    (``--mesh 1x1``) against the un-meshed run: every step's loss within
    1e-5 relative, and both step times.  Then, with 4 or more cards
    visible, :func:`dist_every_card`; with fewer,
    :func:`dist_shared_card`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import selftest
    from repro_torch.distributed.launch import process_group
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import run_train

    tr = DIST_TRAIN
    cfg = _fp32(get_config(VLM_ARCH), n_super=tr["layers"])
    out = dict(arch=VLM_ARCH, world=1, backend="nccl", mesh=[1, 1],
               train=dict(layers=tr["layers"], positions=tr["seq"],
                          batch=tr["batch"], steps=tr["steps"],
                          dtype="float32"),
               reduced=dict(train_seq=[4096, tr["seq"]]))
    kw = dict(steps=tr["steps"], batch=tr["batch"], seq=tr["seq"],
              device=device, log_every=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    single = run_train(cfg, log=lambda line: None, **kw)
    single_losses, single_s = single["losses"], single["step_s"]
    single_peak = torch.cuda.max_memory_allocated(device)
    del single
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with process_group("cuda"):
        import torch.distributed as dist
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"dist: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}")
        t0 = time.perf_counter()
        out["selftest"] = {name: fn() for name, fn in selftest.CHECKS}
        out["selftest_s"] = time.perf_counter() - t0
        mesh = make_test_mesh((1, 1), ("data", "model"))
        meshed = run_train(cfg, mesh=mesh, log=lambda line: None, **kw)
        meshed_losses, meshed_s = meshed["losses"], meshed["step_s"]
        del meshed
    rel = [abs(a - b) / abs(b) for a, b in zip(meshed_losses, single_losses)]
    check(len(rel) == tr["steps"] and max(rel) <= DIST_LOSS_RTOL,
          f"dist: --mesh 1x1 losses {meshed_losses} against "
          f"{single_losses} (limit {DIST_LOSS_RTOL} relative)")
    out["train"].update(
        losses_single=single_losses, losses_mesh=meshed_losses,
        loss_rel_err=max(rel), loss_rtol=DIST_LOSS_RTOL,
        step_s_single=single_s, step_s_mesh=meshed_s,
        ms_per_step_single=single_s[-1] * 1e3,
        ms_per_step_mesh=meshed_s[-1] * 1e3,
        max_memory_allocated_bytes_single=single_peak,
        max_memory_allocated_bytes_mesh=torch.cuda.max_memory_allocated(
            device))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    out["cards"] = cards
    if cards >= 4:
        out["design"] = "every card: one NCCL rank a card"
        out["every_card"] = dist_every_card(device)
    else:
        out["design"] = ("one card: two gloo ranks share it (NCCL refuses "
                         "a duplicate GPU)")
        out["shared_card"] = dist_shared_card()
    torch.cuda.synchronize()
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


#: the flash kernel at each attention shape a model path gives it: (path,
#: B, H, S, hd, causal) — mistral-nemo's 32 query heads of 128 (every
#: layer), arctic's 56 of 128 (every layer), seamless's prefill at 16 of
#: 64 in the kernel's full mode (its encoder's self-attention and its
#: cross-attention) and causal (its decoder's self-attention), and the
#: encoder of seamless's decode loop at S 64, shorter than one 128-row
#: tile
MODEL_FLASH_SHAPES = (("lm_prefill", 1, 32, LM_PREFILL_S, 128, True),
                      ("arctic", 1, 56, 32_768, 128, True),
                      ("seamless", 1, 16, ENCDEC_PREFILL_S, 64, False),
                      ("seamless", 1, 16, ENCDEC_PREFILL_S, 64, True),
                      ("seamless_decode", ENCDEC_DECODE[0], 16,
                       ENCDEC_DECODE[1], 64, False),
                      ("vlm_prefill", 1, 28, VLM_PREFILL_S, 128, True))
#: the divisibility tiles the model's attention passes the kernel
#: (``S_MULTIPLE``, so S 64 is accepted); its own tile is ``flash_plan``'s
MODEL_TILES = dict(bq=64, bk=64)
#: up to this S a model shape is held against the plain version; above
#: it, whose Python loop over (S / 128)² tile pairs is too slow, against
#: the model's chunked route
PLAIN_MAX_S = 4096


def model_flash_cases(device):
    """The flash kernel's inputs at the model paths' attention shapes
    (``MODEL_FLASH_SHAPES``), bf16, from a seed."""
    import torch
    from repro_torch.kernels.flash_attention import flash_plan
    gen = torch.Generator(device=device).manual_seed(3)
    cases = []
    for path, b, h, s, hd, causal in MODEL_FLASH_SHAPES:
        qkv = tuple((torch.randn((b, h, s, hd), generator=gen, device=device)
                     * sc).to(torch.bfloat16) for sc in (0.3, 0.3, 1.0))
        plan = flash_plan(torch.bfloat16, s, hd)
        mode = "causal" if causal else "full"
        cases.append(dict(name=f"{path}_B{b}_H{h}_S{s}_hd{hd}_{mode}",
                          causal=causal, B=b, H=h, S=s, hd=hd,
                          dtype="bfloat16", kernel_route=plan.route,
                          tile=plan.tile, args=qkv, main_path=path,
                          against="plain" if s <= PLAIN_MAX_S else
                          "chunked"))
    return cases


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


def flash_checks(device, flash_cases, model_cases):
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
    # the model shapes: up to PLAIN_MAX_S against the plain version (and
    # the fp32 result); above it the plain version's Python loop over
    # (S / 128)² tile pairs is skipped and the model's chunked route (fp32
    # scores and softmax) is the PyTorch version held against the kernel,
    # row by row
    for c in model_cases:
        o = flash_attention(*c["args"], causal=c["causal"], **MODEL_TILES)
        if c["against"] == "plain":
            a = c["args"]
            op = flash_attention_plain(*a, causal=c["causal"])
            o32 = flash_attention_plain(*(t.float() for t in a),
                                        causal=c["causal"])
            _scaled_check(o, o32, c["name"], "the fp32 result")
            c["max_abs_err"], c["atol"], c["err_over_tol"] = _scaled_check(
                o, op, c["name"], "plain")
            c["rtol"] = RTOL_BF16
            results.append(dict(case=c["name"], dtype=c["dtype"],
                                against="the plain version",
                                max_abs_err=c["max_abs_err"], rtol=RTOL_BF16,
                                atol=c["atol"],
                                err_over_tol=c["err_over_tol"]))
            del o, op, o32
            continue
        q, k, v = (t.transpose(1, 2) for t in c["args"])
        ref = attention(q, k, v, causal=c["causal"], chunk=1024,
                        force_chunked=True)
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


def kernel_timings(device, bsr_cases, flash_cases, model_cases):
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
    for c in model_cases:
        a, causal = c["args"], c["causal"]
        c["ms"] = time_ms(
            lambda: flash_attention(*a, causal=causal, **MODEL_TILES), 5,
            flush)
        if c["against"] == "plain":
            c["plain_ms"] = time_ms(
                lambda: flash_attention_plain(*a, causal=causal), 1, flush)
        else:
            c["plain_ms"] = None
            c["plain_note"] = ("plain version skipped at this size (a "
                               "Python loop over (S/128)^2 tile pairs); "
                               "chunked_ms is the model's chunked route")
        qt, kt, vt = (t.transpose(1, 2) for t in a)
        c["chunked_ms"] = time_ms(lambda: attention(
            qt, kt, vt, causal=causal, chunk=1024, force_chunked=True), 1,
            flush)
        c["graph_ms"] = graph_ms(
            lambda: flash_attention(*a, causal=causal, **MODEL_TILES), 5)
        c["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(*a, is_causal=causal), 5,
            flush)
        c["bound_ms"], c["bound_by"], c["flops"], c["bytes"] = \
            flash_bound(c)


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


def kernel_table(bsr_cases, flash_cases, model_cases, launches):
    """One entry per kernel; the headline numbers are those of its
    largest kernel-path shape, every shape is under ``cases``.
    ``launches`` sums the main paths' counts, ``launches_by_path`` holds
    each (``lm_prefill``, ``arctic``, ``kimi``, ``seamless``,
    ``vlm_prefill``: one prefill forward of that model;
    ``seamless_decode``: its decode loop, whose encoder runs once;
    ``tables``, ``train``, ``xlstm``, ``zamba2``, ``vlm_decode``, ``dist``
    and ``*_train``: those phases and paths, which reach no kernel)."""
    def entry(name, source, replaces, cases, head):
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            kernel_route="/".join(sorted({c["kernel_route"] for c in cases})),
            launches=sum(launches[name].values()),
            launches_by_path=launches[name], shape=head["name"],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            tol=f"{ATOL_RMS}*rms + {RTOL_BF16}*|x| (model shapes: rms per "
            f"row)",
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
              flash_cases + model_cases, flash_cases[0]),
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
    # every kernel built ahead of the timed phases, one nvcc a source
    from benchmarks.prewarm_cache_torch import prewarm
    t0 = time.perf_counter()
    built = prewarm()
    build_dir = _build.build_dir()
    check(built["dir"] == str(build_dir) and
          built["objects"] == len(_build.sources()) and
          all((build_dir / f"lib{s.stem}.so").is_file()
              for s in _build.sources()), "a kernel library is missing")
    report["build"] = dict(phase="build", seconds=time.perf_counter() - t0,
                           dir=built["dir"], objects=built["objects"],
                           build_s=built["seconds"], cached=built["cached"],
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

    for name, phase in (("fleet", fleet_phase),
                        ("fleet_mesh", fleet_mesh_phase),
                        ("analysis", analysis_phase), ("bench", bench_phase),
                        ("tables", tables_phase),
                        ("serve", serve_phase), ("lm", lm_phase),
                        ("train", train_phase), ("ssm", ssm_phase),
                        ("moe", moe_phase), ("encdec", encdec_phase),
                        ("vlm", vlm_phase), ("dist", dist_phase),
                        ("evaluator", evaluator_phase)):
        t0 = time.perf_counter()
        bsr_spmm.launches = 0
        flash_attention.launches = 0
        report[name] = phase(device)
        report[name]["kernel_launches"] = dict(
            bsr_spmm=bsr_spmm.launches,
            flash_attention=flash_attention.launches)
        report[name]["seconds"] = time.perf_counter() - t0
        # a phase's ``runs`` are lines it printed itself
        emit({k: v for k, v in report[name].items() if k != "runs"})
    # neither the tables, training nor the recurrent families reach a
    # kernel (nor do they in the reference): training runs the chunked
    # route under autograd, xlstm has no attention and zamba2's head
    # size is not the flash kernel's
    for name in ("fleet_mesh", "analysis", "bench", "tables", "train",
                 "ssm", "dist"):
        check(report[name]["kernel_launches"] == dict(bsr_spmm=0,
                                                      flash_attention=0),
              f"{name}: kernel launches {report[name]['kernel_launches']}")

    t0 = time.perf_counter()
    model_cases = model_flash_cases(device)
    checks = dict(bsr_spmm=bsr_checks(device, bsr_cases),
                  flash_attention=flash_checks(device, flash_cases,
                                               model_cases))
    kernel_timings(device, bsr_cases, flash_cases, model_cases)
    torch.cuda.synchronize()
    ssm_runs = report["ssm"]["archs"]
    moe_runs = report["moe"]["runs"]
    encdec = report["encdec"]["launches"]
    by_path = dict(
        bsr_spmm=dict(kernel_path=launches["bsr_spmm"],
                      tables=report["tables"]["kernel_launches"]["bsr_spmm"],
                      train=report["train"]["kernel_launches"]["bsr_spmm"],
                      **{a.split("-")[0]: r["launches"]["bsr_spmm"]
                         for a, r in ssm_runs.items()},
                      moe=report["moe"]["kernel_launches"]["bsr_spmm"],
                      encdec=report["encdec"]["kernel_launches"]["bsr_spmm"],
                      vlm=report["vlm"]["kernel_launches"]["bsr_spmm"],
                      dist=report["dist"]["kernel_launches"]["bsr_spmm"]),
        flash_attention=dict(
            kernel_path=launches["flash_attention"],
            lm_prefill=report["lm"]["prefill"]["launches"]["flash_kernel"],
            tables=report["tables"]["kernel_launches"]["flash_attention"],
            train=report["train"]["launches"]["flash_kernel"],
            **{a.split("-")[0]: r["launches"]["flash_attention"]
               for a, r in ssm_runs.items()},
            **{a.split("-")[0]: r["launches"]["prefill"]["flash_kernel"]
               for a, r in moe_runs.items()},
            arctic_train=moe_runs["arctic-480b"]["launches"]["train"][
                "flash_kernel"],
            seamless=encdec["prefill"]["flash_kernel"],
            seamless_decode=encdec["decode"]["flash_kernel"],
            seamless_train=encdec["train"]["flash_kernel"],
            vlm_prefill=report["vlm"]["launches"]["prefill"]["flash_kernel"],
            vlm_decode=report["vlm"]["launches"]["decode"]["flash_kernel"],
            vlm_train=report["vlm"]["launches"]["train"]["flash_kernel"],
            dist=report["dist"]["kernel_launches"]["flash_attention"]))
    table = kernel_table(bsr_cases, flash_cases, model_cases, by_path)
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
