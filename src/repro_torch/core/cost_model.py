"""Sparseloop-class analytical cost model (SparseMap §IV.I "Evaluation
Environment"; Sparseloop/TimeloopV2 methodology), generalized over a
declared :class:`repro_torch.core.arch.ArchSpec`.

Given (Workload, Mapping, SparseStrategy, arch-or-platform) it returns
energy (pJ), latency (cycles), EDP (cycles * pJ) and a validity verdict.
The paper uses the TimeloopV2 binary; this is a faithful
re-implementation of its published accounting (per-level access counts
from loop-nest reuse analysis, density-scaled by the sparse strategy,
per-access energy tables) — see DESIGN.md §5 for the assumptions.

Traffic edges are derived from the arch: one per storage level below the
backing store, each filtered by the S/G site of its SOURCE store (the
backing store has none).  For the default paper topology:

    DRAM -> GLB       : compression only (no S/G)
    GLB  -> PE buffer : "L2" S/G site
    PEbuf-> MAC regs  : "L3" S/G site
    MAC ops           : "C"  S/G site

Skip scales energy AND cycles; Gate scales energy only (Fig. 6).  A skip
anywhere whose leader is tensor T multiplies the effectual compute-cycle
fraction by density(T) (the paper's Fig. 14: skipping empty P rows at the
GLB skips the whole corresponding compute iterations).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

from .accel import Platform
from .arch import ArchSpec, as_arch
from .mapping import Mapping
from .sparse import (FMT_U, SparseStrategy, TensorFormat, effective_bytes,
                     followers, is_gate, is_skip, leaders)


@dataclasses.dataclass(frozen=True)
class Design:
    mapping: Mapping
    strategy: SparseStrategy


@dataclasses.dataclass
class CostReport:
    valid: bool
    reason: str = ""
    energy_pj: float = 0.0
    cycles: float = 0.0
    edp: float = float("inf")
    # --- breakdowns for analysis/benchmarks ---
    energy_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)
    traffic_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    compute_cycles: float = 0.0
    dram_cycles: float = 0.0
    # per-store occupancies for every capacity-checked store of the arch
    occupancy_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def fitness(self) -> float:
        return 0.0 if not self.valid else 1.0 / max(self.edp, 1e-30)

    # legacy accessors (paper-topology store names)
    @property
    def glb_occupancy_bytes(self) -> float:
        return self.occupancy_bytes.get("glb", 0.0)

    @property
    def pebuf_occupancy_bytes(self) -> float:
        return self.occupancy_bytes.get("pebuf", 0.0)


def tiled_subdims(mapping: Mapping, tensor_name: str
                  ) -> Tuple[Tuple[int, str, int], ...]:
    """Tiled sub-dimensions of a tensor, outer->inner: (level, dim, size),
    keeping only factors > 1 (paper Fig. 13: formats are specified for the
    sub-dimensions that actually exist)."""
    t = mapping.workload.tensor(tensor_name)
    out = []
    for lvl in range(mapping.arch.n_levels):
        for d in mapping.perms[lvl]:
            if d in t.dims:
                f = mapping.factors[lvl].get(d, 1)
                if f > 1:
                    out.append((lvl, d, f))
    return tuple(out)


def spatial_subdim_indices(mapping: Mapping, tensor_name: str
                           ) -> Tuple[int, ...]:
    subs = tiled_subdims(mapping, tensor_name)
    spatial = set(mapping.arch.spatial_levels)
    return tuple(i for i, (lvl, _, _) in enumerate(subs)
                 if lvl in spatial)


def make_tensor_format(mapping: Mapping, tensor_name: str,
                       fmt_genes: Tuple[int, ...]) -> TensorFormat:
    """Apply the paper's gene->format rule: the sub-segment has
    ``MAX_FMT_GENES`` genes; the LAST k genes map to the k tiled
    sub-dimensions; sub-dimensions beyond the first 5 stay uncompressed."""
    subs = tiled_subdims(mapping, tensor_name)
    k = len(subs)
    ng = len(fmt_genes)
    if k <= ng:
        fmts = tuple(fmt_genes[ng - k:])
    else:
        fmts = tuple(fmt_genes) + tuple([FMT_U] * (k - ng))
    return TensorFormat(tensor=tensor_name, formats=fmts,
                        fiber_lens=tuple(s for _, _, s in subs))


# --------------------------------------------------------------------------


def evaluate(design: Design, platform: Union[str, Platform, ArchSpec]
             ) -> CostReport:
    mp = design.mapping
    st = design.strategy
    wl = mp.workload
    arch = as_arch(platform)
    if arch.topology != mp.arch.topology:
        raise ValueError(
            f"mapping was built for arch {mp.arch.name!r} "
            f"(topology {mp.arch.topology.fingerprint}) but is evaluated "
            f"on {arch.name!r} ({arch.topology.fingerprint})")

    # ---------- validity: spatial fanout ----------
    caps = arch.spatial_caps()
    for lvl, cap, store_k in zip(arch.spatial_levels, caps,
                                 arch.spatial_store):
        fan = mp.spatial_fanout(lvl)
        if fan > cap:
            return CostReport(
                False, f"{arch.level_names[lvl]} fanout {fan} > {cap} "
                       f"{arch.store_names[store_k]} instances")

    # ---------- validity: sparse strategy ----------
    spatial_subs = {t.name: spatial_subdim_indices(mp, t.name)
                    for t in wl.tensors}
    ok, why = st.valid(spatial_subs)
    if not ok:
        return CostReport(False, why)

    # per-tensor density models: byte accounting consumes the full model
    # (fiber-fill statistics), S/G intersections its element-granularity
    # hit rate (== mean density for every built-in model)
    dmodel = {t.name: wl.density_model_of(t.name) for t in wl.tensors}
    hit = {n: m.hit_rate() for n, m in dmodel.items()}

    def tile_bytes(store: str, tname: str) -> float:
        # occupancy is accounted at the STORE's word width (per-level
        # datawidths: a quantized level holds narrower words)
        n = mp.tensor_tile_elems(store, tname)
        return effective_bytes(st.formats[tname], dmodel[tname], n,
                               arch.word_bytes_of(store))

    # ---------- validity: buffer capacities ----------
    occ: Dict[str, float] = {}
    for _, sname, cap in arch.capacity_stores:
        o = sum(tile_bytes(sname, t.name) for t in wl.tensors)
        occ[sname] = o
        if o > cap:
            return CostReport(
                False, f"{sname.upper()} overflow {o:.0f}B > {cap:.0f}B",
                occupancy_bytes=occ)

    # ---------- per-tensor average bytes per dense position ----------
    # the compression ratio depends on the word width (metadata bits do
    # not scale with it), so it is computed per distinct edge width
    def comp_ratio(tname: str, wb: float) -> float:
        full = wl.tensor(tname).size(wl.dim_sizes)
        return effective_bytes(st.formats[tname], dmodel[tname], full,
                               wb) / max(full * wb, 1)

    ratio = {(t.name, wb): comp_ratio(t.name, wb)
             for t in wl.tensors
             for wb in set(arch.edge_word_bytes)}

    # ---------- S/G filter fractions per edge ----------
    # a follower's surviving fraction is the product of its leaders'
    # intersection hit rates (DensityModel.hit_rate — the mean density
    # for uniform/banded/N:M leaders; N:M is deterministic at n/m)
    def edge_fraction(site: str, tname: str, energy: bool) -> float:
        sg = st.sg[site]
        if tname not in followers(sg):
            return 1.0
        if is_skip(sg) or (energy and is_gate(sg)):
            f = 1.0
            for ld in leaders(sg):
                if ld != tname:
                    f *= hit[ld]
            return f
        return 1.0

    # ---------- traffic ----------
    z_name = wl.output.name
    traffic_e: Dict[str, float] = {}     # energy-relevant bytes
    traffic_t: Dict[str, float] = {}     # time-relevant bytes
    # one edge per store below the backing store, filtered by the S/G
    # site of its source store (None for the backing store's edge)
    store_sites = tuple(s for s in arch.sg_sites[:-1])
    edges = tuple(
        (arch.store_names[k + 1],
         None if arch.edge_site[k] is None
         else store_sites[arch.edge_site[k]],
         arch.edge_word_bytes[k])
        for k in range(arch.n_edges))
    for store, site, wb in edges:
        for t in wl.tensors:
            fills = mp.fills(store, t.name)
            if t.name == z_name:
                total = wl.output.size(wl.dim_sizes)
                # read-modify-write; write-once when fully accumulated
                fills = max(2.0 * fills - total, float(total))
            bytes_dense = fills * wb * ratio[(t.name, wb)]
            fe = ft = 1.0
            if site is not None:
                fe = edge_fraction(site, t.name, energy=True)
                ft = edge_fraction(site, t.name, energy=False)
            traffic_e[f"{store}:{t.name}"] = bytes_dense * fe
            traffic_t[f"{store}:{t.name}"] = bytes_dense * ft

    # ---------- compute ----------
    macs_dense = float(wl.macs)
    cycle_leaders = set()
    energy_leaders = set()
    for site in arch.sg_sites:
        sg = st.sg[site]
        if is_skip(sg):
            cycle_leaders.update(leaders(sg))
            energy_leaders.update(leaders(sg))
        elif is_gate(sg):
            energy_leaders.update(leaders(sg))
    cyc_frac = 1.0
    for ld in cycle_leaders:
        cyc_frac *= hit[ld]
    e_frac = 1.0
    for ld in energy_leaders:
        e_frac *= hit[ld]

    compute_cycles = float(mp.temporal_iterations()) * cyc_frac

    # ---------- energy ----------
    br: Dict[str, float] = {}
    for k in range(arch.n_edges):
        store = arch.store_names[k + 1]
        edge_bytes = sum(v for key, v in traffic_e.items()
                         if key.startswith(f"{store}:"))
        for gname, comps in arch.edge_energy[k]:
            # accumulate: two edges may share a group name (e.g. "noc")
            br[gname] = br.get(gname, 0.0) + edge_bytes * sum(comps)
    br["mac"] = macs_dense * e_frac * arch.e_mac
    energy = sum(br.values())

    # ---------- latency ----------
    cycles = compute_cycles
    dram_cycles = 0.0
    for k, bpc in arch.bw_edges:
        store = arch.store_names[k + 1]
        edge_bytes_t = sum(v for key, v in traffic_t.items()
                           if key.startswith(f"{store}:"))
        edge_cycles = edge_bytes_t / bpc
        if k == 0:
            dram_cycles = edge_cycles
        cycles = max(cycles, edge_cycles)
    edp = cycles * energy

    return CostReport(
        valid=True, energy_pj=energy, cycles=cycles, edp=edp,
        energy_breakdown=br, traffic_bytes=traffic_e,
        compute_cycles=compute_cycles, dram_cycles=dram_cycles,
        occupancy_bytes=occ,
    )
