"""Quickstart on the PyTorch port, the twin of ``examples/quickstart.py``:
1. run SparseMap's joint mapping x sparse-strategy search on one paper
   workload and print the winning accelerator design, with the batched
   cost evaluator on the GPU;
2. train a small LM (the smoke config of ``xlstm-350m``) for 30 steps.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Without ``--device`` both steps run on the GPU and fail where there is
none.
"""
import argparse
import math
import time


def main(argv=None):
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core import search

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (required)")
    ap.add_argument("--workload", default="conv4")
    ap.add_argument("--budget", type=int, default=2000)
    args = ap.parse_args(argv)

    wl = by_name(args.workload)       # conv4: pruned VGG16 layer (Table III)
    print(f"workload {wl.name}: dims={wl.orig_dim_sizes} "
          f"densities=({wl.density_of('P'):.2f}, "
          f"{wl.density_of('Q'):.2f})")

    t0 = time.time()
    res = search.run("sparsemap", wl, "cloud", budget=args.budget, seed=0,
                     device=args.device)
    print(f"SparseMap: best EDP {res.best_edp:.3e} "
          f"(valid {100 * res.valid_fraction:.0f}% of "
          f"{res.evals} evals, {time.time() - t0:.1f}s)")

    base = search.run("random_mapper", wl, "cloud", budget=args.budget,
                      seed=0, device=args.device)
    print(f"Sparseloop-Mapper-like baseline: {base.best_edp:.3e} "
          f"({base.best_edp / res.best_edp:.1f}x worse)")

    design = search.decode_best(wl, res)
    print("\nwinning mapping:")
    print(design.mapping.describe())
    print("sparse strategy:",
          {t: [f for f in fmt.formats] for t, fmt in
           design.strategy.formats.items()},
          "S/G:", design.strategy.sg)

    rep = search.report_best(wl, "cloud", res)
    print(f"oracle check (float64 numpy model on the decoded design): "
          f"valid={rep.valid}, log10 EDP {math.log10(rep.edp):.4f} vs "
          f"search {math.log10(res.best_edp):.4f}")

    # ---------------- 2. train a small LM ----------------
    from repro_torch.launch import train
    print("\ntraining xlstm-350m (smoke config) for 30 steps...")
    dev = [] if args.device is None else ["--device", args.device]
    return train.main(["--arch", "xlstm-350m", "--smoke", "--steps", "30",
                       "--batch", "4", "--seq", "64", "--log-every", "10"]
                      + dev)


if __name__ == "__main__":
    raise SystemExit(main())
