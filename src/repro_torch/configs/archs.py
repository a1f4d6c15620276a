"""The registered ACCELERATOR topologies (repro_torch.core.arch.ArchSpec)
that extend the paper's fixed DRAM/GLB/PE/MAC hierarchy: the accelerator
half of the JAX package's ``configs/archs.py``.  The measured pad-policy
tables and the LM model family of that module are not part of this
package yet.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.arch import ArchSpec, register_arch
from repro_torch.core.arch_dsl import compile_arch

# ----------------------------------------------------- accelerator archs
#
# Non-default searchable topologies, all declared through the
# ``repro_torch.core.arch_dsl`` frontend (see COMPAT.md "Declarative arch
# frontend" for the schema).  Anything registered here resolves by name
# through the whole search stack, e.g.
#     search.run_method_sweep(methods, workloads, "maple_edge", ...)
# The energy numbers are 12nm-class pJ/byte figures in the spirit of
# Table II unless a published figure is cited; the *structure* is what
# differs from the paper topology.  ``tests/golden/zoo_validation.json``
# pins the published-vs-modeled cross-checks for the zoo entries.

#: 2-store Maple-style edge chip: no per-PE buffer — a single shared GLB
#: feeds a 16x16 PE grid directly (each PE = 1 MAC + registers).  The
#: grid computes row-wise products: one operand copy is bussed along
#: each row (fractional multicast, discount fanout 16 = the row length),
#: partial outputs reduce in-network.  One spatial mapping level, one
#: store S/G site.  3 mapping levels total.
MAPLE_EDGE = register_arch(compile_arch({
    "name": "maple_edge",
    "levels": [
        {"name": "dram"},
        {"name": "glb", "capacity": "256KB",
         "energy": [["dram", [100.0]]],
         "sg_site": "L2",
         # deliberately starved DRAM, matching Table II's edge platform
         # (16 MB/s): on-chip reuse dominates this design point, which
         # is the topology's story
         "bandwidth": "16MB/s"},
        {"name": "reg",
         "energy": [["glb", [3.5, 0.3]], ["reg", [0.05]]],
         "fanout": [16, 16],
         "noc": {"multicast": "row"}},
    ],
}))

#: 4-store clustered cloud chip: a cluster buffer sits between the GLB
#: and the PE buffers (16 clusters x 64 PEs x 16 MACs).  Three spatial
#: mapping levels, three store S/G sites ("L2"/"L3"/"L4") — 7 mapping
#: levels and a 4-gene S/G segment.
CLUSTER_CLOUD = register_arch(compile_arch({
    "name": "cluster_cloud",
    "levels": [
        {"name": "dram"},
        {"name": "glb", "capacity": "64MB",
         "energy": [["dram", [100.0]]],
         "sg_site": "L2", "bandwidth": "128GB/s"},
        {"name": "cbuf", "capacity": "1MB",
         "energy": [["glb", [15.0, 0.3]]],
         "fanout": 16, "sg_site": "L3"},
        {"name": "pebuf", "capacity": "64KB",
         "energy": [["cbuf", [1.8, 0.2]]],
         "fanout": 64, "sg_site": "L4"},
        {"name": "reg",
         "energy": [["pebuf", [0.5]], ["reg", [0.05]]],
         "fanout": 16},
    ],
}))

#: Systolic 16x16 mesh with reduction-tree output collection: operands
#: stream into the PE grid store-and-forward (mesh NoC, no multicast — an
#: irrelevant spatial loop costs one copy per PE), while partial outputs
#: collapse through an adder tree (reduction "all", one reduced result
#: per tile crosses the GLB edge).  Same S/G site count as the paper arch
#: but a distinct Topology (the NoC shape is structural).
SYSTOLIC_MESH = register_arch(compile_arch({
    "name": "systolic_mesh",
    "levels": [
        {"name": "dram"},
        {"name": "glb", "capacity": "1MB",
         "energy": [["dram", [100.0]]],
         "sg_site": "L2", "bandwidth": "32GB/s"},
        {"name": "pebuf", "capacity": "1KB",
         # per-hop mesh forwarding is pricier than the paper's
         # broadcast NoC hop — the reduction tree is the design's win
         "energy": [["glb", [6.0]], ["mesh_hop", [0.6]]],
         "fanout": [16, 16],
         "noc": {"multicast": "none", "reduction": "all"},
         "sg_site": "L3"},
        {"name": "reg",
         "energy": [["pebuf", [0.6]], ["reg", [0.05]]],
         "fanout": 4},
    ],
}))

#: Quantized 1-byte-word edge chip: the paper's exact 4-store topology
#: STRUCTURE, but every on-chip level stores 8-bit words (DRAM traffic,
#: occupancies and compression ratios all reprice; metadata bits do not
#: shrink with the datawidth, so compression pays off later than at
#: 16-bit).  Word widths are traced numbers: a family of quantized
#: variants shares one evaluator signature.
QUANT_EDGE = register_arch(compile_arch({
    "name": "quant_edge",
    "mac_energy": 0.4,          # 8-bit MACs ~ half the 16-bit energy
    "levels": [
        {"name": "dram"},
        {"name": "glb", "capacity": "128KB", "word": 1.0,
         "energy": [["dram", [100.0]]],
         "sg_site": "L2", "bandwidth": "16MB/s"},
        {"name": "pebuf", "capacity": "1KB", "word": 1.0,
         "energy": [["glb", [3.0, 0.3]]],
         "fanout": 256, "sg_site": "L3"},
        {"name": "reg", "word": 1.0,
         "energy": [["pebuf", [0.6]], ["reg", [0.05]]],
         "fanout": 4},
    ],
}))

# ------------------------------------------------------------------ zoo
#
# Published-accelerator-shaped design points.  Each is "-like": the
# STRUCTURE (hierarchy, array geometry, NoC schemes) and every cited
# number follow the publication; uncited energies are the same
# 12nm-class figures the rest of the configs use.  The cross-check
# between these declarations and the published numbers is pinned in
# ``tests/golden/zoo_validation.json`` (tests/test_zoo.py).

#: Eyeriss-like row-stationary chip (Chen et al., ISCA 2016 / JSSC
#: 2017): 12x14 PE array at 200 MHz, 108 KB GLB, ~512 B scratchpads per
#: PE, 1 MAC per PE.  Operands ride a row-wise X-bus (one GLB read
#: serves the 14 PEs of a row — fractional multicast), partial sums hop
#: PE-to-PE down each column (fractional reduction, cluster = the 12-PE
#: column).  Access energies use the paper's published normalization
#: DRAM : GLB : spad = 200 : 6 : 1 relative to one MAC (e_mac = 1.0).
EYERISS_LIKE = register_arch(compile_arch({
    "name": "eyeriss_like",
    "clock": "200MHz",
    "mac_energy": 1.0,
    "levels": [
        {"name": "dram"},
        {"name": "glb", "capacity": "108KB",
         "energy": [["dram", [200.0]]],
         "sg_site": "L2", "bandwidth": "1GB/s"},
        {"name": "spad", "capacity": "512B",
         "energy": [["glb", [6.0]]],
         "fanout": [12, 14],
         "noc": {"multicast": "row", "reduction": "col"},
         "sg_site": "L3"},
        {"name": "reg",
         "energy": [["spad", [1.0]]],
         "fanout": 1, "spatial": True},
    ],
}))

#: SIGMA-like flexible sparse trainer (Qin et al., HPCA 2020): a 128x128
#: flex-DPE array (16384 multipliers) fed through a Benes distribution
#: network — any operand reaches ANY set of multipliers in one pass, so
#: the multicast scheme is the full "all" — with partial sums collapsed
#: by the FAN forest-of-adders reduction tree, modeled as cluster-local
#: reduction across a 128-wide DPE column.  3-store hierarchy: the big
#: banked SRAM feeds multiplier registers directly.
SIGMA_LIKE = register_arch(compile_arch({
    "name": "sigma_like",
    "clock": "500MHz",
    "mac_energy": 1.0,
    "levels": [
        {"name": "dram"},
        {"name": "glb", "capacity": "4MB",
         "energy": [["dram", [160.0]]],
         "sg_site": "L2", "bandwidth": "256GB/s"},
        {"name": "reg",
         "energy": [["glb", [1.2]], ["benes", [0.8]]],
         "fanout": [128, 128],
         "noc": {"multicast": "all", "reduction": ["fan_tree", 128]}},
    ],
}))

#: DSTC-like dual-side sparse tensor core (Wang et al., ISCA 2021),
#: V100-class substrate: 80 SMs x 8 tensor-core-like units (640 total),
#: 6 MB L2 as the GLB, 96 KB shared memory per SM, 900 GB/s HBM2.
#: Operands broadcast from shared memory to the 8 units of an SM (row
#: multicast over the [80, 8] mesh), partial sums accumulate SM-locally
#: (cluster reduction, fanout 8) before crossing back to L2.
DSTC_LIKE = register_arch(compile_arch({
    "name": "dstc_like",
    "mac_energy": 0.6,
    "levels": [
        {"name": "dram"},
        {"name": "glb", "capacity": "6MB",
         "energy": [["dram", [80.0]]],
         "sg_site": "L2", "bandwidth": "900GB/s"},
        {"name": "smem", "capacity": "96KB",
         "energy": [["glb", [2.4, 0.4]]],
         "fanout": [80, 8],
         "noc": {"multicast": "row", "reduction": ["cluster", 8]},
         "sg_site": "L3"},
        {"name": "reg",
         "energy": [["smem", [0.8]], ["reg", [0.1]]],
         "fanout": 4},
    ],
}))

ACCEL_ARCHS: Dict[str, ArchSpec] = {
    a.name: a for a in (MAPLE_EDGE, CLUSTER_CLOUD, SYSTOLIC_MESH,
                        QUANT_EDGE, EYERISS_LIKE, SIGMA_LIKE,
                        DSTC_LIKE)}

#: The published-accelerator subset of :data:`ACCEL_ARCHS` (the entries
#: cross-checked by ``tests/golden/zoo_validation.json``).
ZOO_ARCHS: Dict[str, ArchSpec] = {
    a.name: a for a in (EYERISS_LIKE, SIGMA_LIKE, DSTC_LIKE)}


def zoo_validation_report() -> Dict[str, Dict[str, float]]:
    """Modeled quantities for each zoo entry, recomputed from the
    REGISTERED specs (never from the JSON), in the units the pinned
    validation table uses.  ``tests/test_zoo.py`` asserts these agree
    with ``tests/golden/zoo_validation.json`` — both the pinned modeled
    values (exactly: the declarations did not drift) and the published
    column (within each check's tolerance)."""
    e, s, d = EYERISS_LIKE, SIGMA_LIKE, DSTC_LIKE

    def first_comp(spec, edge):
        return spec.edge_energy[edge][0][1][0]

    return {
        "eyeriss_like": {
            "dram_access_vs_mac": first_comp(e, 0) / e.e_mac,
            "glb_access_vs_mac": first_comp(e, 1) / e.e_mac,
            "spad_access_vs_mac": first_comp(e, 2) / e.e_mac,
            "pe_count": float(e.store("spad").fanout),
            "row_multicast_fanout": e.edge_noc[1].multicast_fanout,
            "col_reduction_fanout": e.edge_noc[1].reduction_fanout,
            "glb_bytes": e.store("glb").capacity_bytes,
            "clock_mhz": e.clock_hz / 1e6,
        },
        "sigma_like": {
            "multiplier_count": float(s.store("reg").fanout),
            "multicast_is_full": float(
                s.edge_noc[1].multicast_scheme == "all"),
            "reduction_cluster": s.edge_noc[1].reduction_fanout,
            "clock_mhz": s.clock_hz / 1e6,
        },
        "dstc_like": {
            "tensor_core_count": float(d.store("smem").fanout),
            "l2_bytes": d.store("glb").capacity_bytes,
            "smem_bytes": d.store("smem").capacity_bytes,
            "hbm_bytes_per_s":
                d.store("glb").fill_bandwidth_bytes_per_cycle
                * d.clock_hz,
            "sm_multicast_fanout": d.edge_noc[1].multicast_fanout,
            "sm_reduction_fanout": d.edge_noc[1].reduction_fanout,
        },
    }
