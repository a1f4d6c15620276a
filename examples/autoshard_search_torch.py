"""SparseMap's evolution strategy searching the LM substrate's
distributed-mapping space (sharding / remat / microbatching / optimizer
precision) on H100 meshes — the PyTorch port's twin of
``examples/autoshard_search.py``, with the H100 SXM roofline constants
(``repro_torch.core.accel.H100_SXM``) in place of the TPU's.

    PYTHONPATH=src python examples/autoshard_search_torch.py [--budget N]

The estimator is closed-form numpy; nothing runs on a device.  One
NVLink domain is 8 GPUs, so tensor parallelism ("model") stays within
it and the data axis spans nodes; the estimator prices every collective
at the NVLink rate, an optimistic bound across nodes.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

MESHES = {
    "1 node (8 GPUs)": {"data": 1, "model": 8},
    "32 nodes (256 GPUs)": {"data": 32, "model": 8},
}
ARCHS = ("mistral-nemo-12b", "command-r-35b", "kimi-k2-1t-a32b",
         "gemma3-12b")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=2000)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core import autoshard
    from repro_torch.core.accel import H100_SXM

    cap = H100_SXM["hbm_bytes"] / 1e9
    for arch in ARCHS:
        cfg = get_config(arch)
        print(f"\n== {arch} (train_4k: 256 x 4096 tokens/step)")
        found = {}
        for mesh_name, mesh in MESHES.items():
            dec, est, _ = autoshard.search(cfg, 4096, 256, mesh,
                                           budget=args.budget, seed=0)
            if dec is None:
                print(f"  {mesh_name}: INFEASIBLE "
                      f"(no decision fits {cap:.0f} GB HBM/GPU)")
                continue
            found[mesh_name] = (mesh, dec, est)
            print(f"  {mesh_name}: {est.t_total * 1e3:7.0f} ms/step "
                  f"[{est.bottleneck}-bound] "
                  f"hbm {est.hbm_bytes_per_device / 1e9:4.1f} GB/dev")
            keys = ("remat", "microbatches", "logits", "mlp_shard",
                    "zero1", "moments")
            print(f"     decisions: "
                  f"{{{', '.join(f'{k}={dec[k]}' for k in keys)}}}")
        # the joint-vs-marginal ablation: change one factor of the best
        # design on the largest feasible mesh (the paper's Fig. 2 argument)
        if not found:
            continue
        mesh, dec, est = found[list(found)[-1]]
        worst = 0.0
        for k, alt in (("remat", "full"), ("logits", "gather"),
                       ("moments", "fp32")):
            e2 = autoshard.estimate(cfg, 4096, 256, mesh, dict(dec, **{k: alt}))
            if e2.valid:
                worst = max(worst, e2.t_total / est.t_total)
        print(f"     single bad factor costs up to {worst:.2f}x "
              f"(why joint search matters)")


if __name__ == "__main__":
    main()
