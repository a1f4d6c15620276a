"""Full accelerator DSE scenario on the PyTorch port: search
sparse-accelerator designs for the dominant GEMMs of an assigned LLM
architecture across hardware platforms, and compare against the
prior-work baselines.  Twin of ``examples/search_accelerator.py``.

    PYTHONPATH=src python examples/search_accelerator_torch.py \\
        [--model kimi-k2-1t-a32b] [--budget 4000] [--device cpu]

``--arch`` targets any single paper platform or registered accelerator
topology by name (``--list-archs`` prints the registry); ``--platforms``
takes a comma-separated mix, e.g. ``--platforms cloud,eyeriss_like``.
Without ``--device`` the sweep runs on the GPU and fails where there is
none.

``--profile DIR`` wraps the whole sweep in ``torch.profiler`` and writes
a Chrome trace (``DIR/trace.json``, for ``chrome://tracing`` or
Perfetto): device kernels should tile the timeline with the host's ES
bookkeeping in the gaps.  The stats line leaves out the reference's
compile-ahead counters: eager PyTorch compiles nothing ahead.
"""
import argparse
import contextlib
import os
import time


def list_archs():
    from repro_torch.core.accel import PLATFORMS
    from repro_torch.core.arch import registered_archs
    print("paper platforms:")
    for name in sorted(PLATFORMS):
        print(f"  {name}")
    print("registered archs (repro_torch.configs.archs):")
    for name, spec in sorted(registered_archs().items()):
        head = spec.describe().splitlines()[-1]
        print(f"  {name:>16s}  {head}")


def main(argv=None):
    """Run the scenario; returns ``{platform: {method: {workload:
    SearchResult}}}`` (``None`` for ``--list-archs``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="kimi-k2-1t-a32b",
                    help="assigned LLM architecture to extract GEMMs from")
    ap.add_argument("--budget", type=int, default=4000)
    ap.add_argument("--arch", default=None, metavar="NAME",
                    help="single target platform/arch name (overrides "
                         "--platforms); see --list-archs")
    ap.add_argument("--platforms", default="edge,cloud",
                    help="comma-separated platform/arch names")
    ap.add_argument("--list-archs", action="store_true",
                    help="print every resolvable platform/arch and exit")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the sweep "
                         "to DIR/trace.json")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (required)")
    args = ap.parse_args(argv)

    if args.list_archs:
        list_archs()
        return None

    from repro_torch.configs.paper_workloads import arch_gemms
    from repro_torch.core.arch import as_arch
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    targets = [args.arch] if args.arch else args.platforms.split(",")
    for t in targets:
        as_arch(t)      # fail fast with the full registry listing

    workloads = arch_gemms(args.model, weight_density=0.5,
                           act_density=0.6)
    print(f"extracted {len(workloads)} GEMMs from {args.model} "
          f"(50% pruned weights, 60% dense activations)\n")

    profiler = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)

    methods = ("sparsemap", "sage_like", "random_mapper")
    with profiler as prof:
        grids = {plat: sweep(methods, workloads, plat, args.budget, device)
                 for plat in targets}
    print("\n(EDP = cycles x pJ; larger ratio = larger our advantage)")

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"\nprofiler trace written to {path}")
    return grids


def sweep(methods, workloads, plat, budget, device):
    """One platform: the (method x workload) grid and its lines."""
    from repro_torch.core import search
    print(f"== platform: {plat}")
    # the whole (method x workload) grid runs as one concurrent
    # mega-batched fleet, one device dispatch per signature per round (on
    # a GPU, 4 generations a device segment: another trajectory than
    # per-method search.run, as in the reference)
    t0 = time.time()
    stats = {}
    grid = search.run_method_sweep(
        methods, workloads, plat, budget=budget, seed=0, stats_out=stats,
        config=search.FleetConfig(stack_batches=True), device=device)
    for wl in workloads:
        row = {m: grid[m][wl.name].best_edp for m in methods}
        ours = row["sparsemap"]
        print(f"  {wl.name:>28s}: ours {ours:10.3e}  "
              f"SAGE-like {row['sage_like'] / ours:6.1f}x  "
              f"Sparseloop-like {row['random_mapper'] / ours:6.1f}x")
    print(f"  [{len(workloads) * len(methods)} searches, "
          f"{stats['rounds']} rounds, {stats['dispatches']} device "
          f"dispatches, host-blocked {stats['host_blocked_s']:.3f}s, "
          f"{time.time() - t0:.1f}s]")
    return grid


if __name__ == "__main__":
    main()
