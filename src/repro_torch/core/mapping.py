"""Mapping scheme (SparseMap §II.B, §III.A.1, Fig. 4), parameterized by an
:class:`repro_torch.core.arch.ArchSpec`.

For the default paper topology (``ARCH_SPARSEMAP``: DRAM -> GLB -> PE
array -> MACs) a mapping has five mapping levels, outer to inner:

    idx  name   kind      hardware meaning
    0    L1_T   temporal  DRAM -> GLB tile schedule
    1    L2_T   temporal  GLB -> PE-array tile schedule
    2    L2_S   spatial   parallelism across PEs
    3    L3_T   temporal  PE-buffer -> MAC schedule
    4    L3_S   spatial   parallelism across MACs inside a PE

but the level structure is *derived from the arch*: each store below the
backing store owns a temporal level, plus a spatial level when it is
replicated (``StorageLevel.fanout > 1``).  Each level carries one loop per
iteration dimension; its bound is the tiling factor of that dimension at
that level (``prod_l factor[l][d] == size(d)``), and a permutation orders
the loops within the level (outermost first).

``Mapping.fills`` implements the classical Timeloop-style reuse analysis
used by the cost model: the number of fills of a tensor tile into a
storage level is

    fills = footprint * prod(bounds of loops in the outer nest)
                      / prod(bounds of the innermost contiguous run of
                             loops irrelevant to the tensor)
    (bound-1 loops are transparent; irrelevant *spatial* loops multicast
     and never multiply traffic — unless the edge's NoC descriptor
     (``StorageLevel.noc``) turns the discount off: with
     ``multicast=False`` every spatial instance's read copy crosses the
     edge, and with ``reduction=False`` every instance's partial output
     sums cross, so irrelevant spatial loops then multiply traffic by
     their bound wherever they sit in the nest.  Fractional schemes —
     ``multicast="row"``, ``reduction="cluster"``, ... with a numeric
     ``*_fanout`` — sit in between: the S spatial instances group into
     domains of ``fanout``, and ``max(S / fanout, 1)`` copies cross.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .arch import ARCH_SPARSEMAP, ArchSpec
from .workload import Workload

# Legacy module constants: the default (paper) topology's structure.
# Prefer reading these off an ArchSpec; they are kept for callers that
# only ever deal with the default arch.
LEVEL_NAMES = ARCH_SPARSEMAP.level_names
N_LEVELS = ARCH_SPARSEMAP.n_levels
SPATIAL_LEVELS = ARCH_SPARSEMAP.spatial_levels
TEMPORAL_LEVELS = ARCH_SPARSEMAP.temporal_levels
OUTER_LEVELS_FOR = dict(ARCH_SPARSEMAP.outer_levels_for)
INNER_LEVELS_FOR = dict(ARCH_SPARSEMAP.inner_levels_for)


@dataclasses.dataclass(frozen=True)
class Mapping:
    """Fully decoded mapping for a given workload on a given arch."""

    workload: Workload
    # factors[level][dim_name] -> tiling factor (int >= 1)
    factors: Tuple[Dict[str, int], ...]
    # perms[level] -> tuple of dim names, outermost first
    perms: Tuple[Tuple[str, ...], ...]
    arch: ArchSpec = ARCH_SPARSEMAP

    def __post_init__(self):
        if len(self.factors) != self.arch.n_levels:
            raise ValueError(
                f"{len(self.factors)} factor levels != arch "
                f"{self.arch.name}'s {self.arch.n_levels}")
        for d in self.workload.dim_order:
            prod = 1
            for lvl in range(self.arch.n_levels):
                prod *= self.factors[lvl].get(d, 1)
            if prod != self.workload.dim_sizes[d]:
                raise ValueError(
                    f"tiling of {d}: prod {prod} != size "
                    f"{self.workload.dim_sizes[d]}")

    # ---- tiles --------------------------------------------------------
    def tile_sizes(self, store: str) -> Dict[str, int]:
        """Per-dimension extent of the tile resident in ``store``."""
        dims = {d: 1 for d in self.workload.dim_order}
        for lvl in self.arch.inner_levels_for[store]:
            for d in dims:
                dims[d] *= self.factors[lvl].get(d, 1)
        return dims

    def tensor_tile_elems(self, store: str, tensor_name: str) -> int:
        t = self.workload.tensor(tensor_name)
        tiles = self.tile_sizes(store)
        n = 1
        for d in t.dims:
            n *= tiles[d]
        return n

    def spatial_fanout(self, level: int) -> int:
        assert level in self.arch.spatial_levels
        n = 1
        for d in self.workload.dim_order:
            n *= self.factors[level].get(d, 1)
        return n

    # ---- flattened nest ----------------------------------------------
    def loops(self) -> List[Tuple[int, str, int, bool]]:
        """Flattened loop list, outer->inner:
        (level_idx, dim_name, bound, is_spatial)."""
        out = []
        for lvl in range(self.arch.n_levels):
            for d in self.perms[lvl]:
                out.append((lvl, d, self.factors[lvl].get(d, 1),
                            self.arch.is_spatial[lvl]))
        return out

    def fills(self, store: str, tensor_name: str) -> float:
        """Number of element-fills of tensor ``tensor_name`` into ``store``
        across the whole computation (dense; sparsity scaling is applied by
        the cost model).  See module docstring for the reuse rule."""
        t = self.workload.tensor(tensor_name)
        relevant_dims = set(t.dims)
        outer_set = self.arch.outer_levels_for[store]
        outer = [l for l in self.loops() if l[0] in outer_set]
        # drop transparent loops
        outer = [l for l in outer if l[2] > 1]
        # NoC of the edge INTO this store: does an irrelevant spatial
        # loop's traffic collapse to one copy (reads: multicast; output:
        # in-network reduction of partials), cross per instance, or —
        # fractional schemes — cross once per multicast/reduction domain
        # of ``fanout`` instances?
        noc = self.arch.edge_noc[self.arch.store_index[store] - 1]
        scheme = (noc.reduction_scheme if t.is_output
                  else noc.multicast_scheme)
        discount = scheme != "none"
        # innermost contiguous run of irrelevant loops -> temporal reuse
        suffix = 0
        for lvl, d, bound, is_spatial in reversed(outer):
            if d in relevant_dims:
                break
            suffix += 1
        body = outer[: len(outer) - suffix] if suffix else outer
        mult = 1.0
        for lvl, d, bound, is_spatial in body:
            if d in relevant_dims:
                mult *= bound
            elif not is_spatial:
                mult *= bound          # temporal thrash: refetch
            elif not discount:
                mult *= bound          # unicast NoC: one copy per instance
            # irrelevant spatial loop: multicast, no extra upstream traffic
        if not discount:
            # replication is physical, not temporal reuse: irrelevant
            # spatial loops multiply traffic even inside the reuse suffix
            for lvl, d, bound, is_spatial in outer[len(outer) - suffix:]:
                if is_spatial:
                    mult *= bound
        elif scheme == "frac":
            # fractional scheme ("row"/"col"/"cluster"): the S spatial
            # instances needing the tile group into multicast/reduction
            # domains of size ``fanout``, so max(S / fanout, 1) copies
            # cross the edge — applied once over ALL irrelevant spatial
            # loops (suffix included: replication is physical), with
            # "all" the fanout->inf limit and "none" fanout=1
            fan = (noc.reduction_fanout if t.is_output
                   else noc.multicast_fanout)
            s_irrel = 1.0
            for lvl, d, bound, is_spatial in outer:
                if is_spatial and d not in relevant_dims:
                    s_irrel *= bound
            mult *= max(s_irrel / fan, 1.0)
        return self.tensor_tile_elems(store, tensor_name) * mult

    def temporal_iterations(self) -> int:
        """Total compute cycles for the dense workload = product of all
        temporal loop bounds (each cycle issues the full spatial fanout)."""
        n = 1
        for lvl in self.arch.temporal_levels:
            for d in self.workload.dim_order:
                n *= self.factors[lvl].get(d, 1)
        return n

    # ---- pretty print --------------------------------------------------
    def describe(self) -> str:
        rows = []
        for lvl in range(self.arch.n_levels):
            parts = []
            for d in self.perms[lvl]:
                b = self.factors[lvl].get(d, 1)
                kw = "par-for" if self.arch.is_spatial[lvl] else "for"
                parts.append(f"{kw} {d.lower()}{lvl+1} in [0,{b})")
            rows.append(f"{self.arch.level_names[lvl]:5s}: "
                        + " ".join(parts))
        return "\n".join(rows)


def balanced_mapping_for_arch(workload: Workload, arch: ArchSpec,
                              spatial_caps: Optional[Sequence[int]] = None
                              ) -> Mapping:
    """A sane hand-built output-stationary mapping on ``arch``, used as
    the SAGE-like fixed mapping and as a fallback individual.

    Greedy placement, generalizing the paper-topology heuristic exactly:
    the innermost spatial level takes contraction-dim parallelism (capped
    at 16; dot-product style, only when the arch has >= 2 spatial levels),
    every other spatial level takes output-dim parallelism (<= 16 per
    dim), then temporal levels inner-to-outer keep small local tiles
    (8 per dim), medium staging tiles (64 per dim), and the outermost
    temporal level absorbs the rest.  ``spatial_caps`` overrides the
    arch's declared per-spatial-level fanouts (level order).

    Every placement is additionally *capacity-aware*: a prime is only
    taken at a level if the resulting uncompressed tile still fits every
    capacity-checked store holding that level in its inner nest (at the
    store's word width); rejected primes flow outward, ultimately to the
    outermost temporal level, which no capacity-checked store holds — so
    the fallback mapping is ``evaluate``-valid on deep or small-buffer
    hierarchies where the fixed per-dim caps alone would overflow.
    """
    nl = arch.n_levels
    factors: List[Dict[str, int]] = [dict() for _ in range(nl)]
    remaining = dict(workload.dim_sizes)

    def take(level: int, dim: str, f: int):
        factors[level][dim] = factors[level].get(dim, 1) * f
        remaining[dim] //= f

    # capacity guard: (inner level set, capacity, word width) per
    # capacity-checked store of the arch
    cap_stores = [(set(arch.inner_levels_for[sname]), cap,
                   arch.store_word_bytes[k])
                  for k, sname, cap in arch.capacity_stores]

    def fits(level: int, dim: str, f: int) -> bool:
        """Would factor ``f`` of ``dim`` at ``level`` keep every
        capacity-checked store's uncompressed occupancy within budget?"""
        for inner, cap, wb in cap_stores:
            if level not in inner:
                continue
            occ = 0.0
            for t in workload.tensors:
                n = 1
                for d in t.dims:
                    for l in inner:
                        n *= factors[l].get(d, 1)
                if dim in t.dims:
                    n *= f
                occ += n * wb
            if occ > cap:
                return False
        return True

    contraction = [d for d in workload.dim_order
                   if d not in workload.output.dims]
    outs = [d for d in workload.dim_order if d in workload.output.dims]

    caps = list(spatial_caps if spatial_caps is not None
                else arch.spatial_caps())
    spatial = list(arch.spatial_levels)
    assert len(caps) == len(spatial)

    # innermost spatial level: contraction-dim parallelism (cap: leave
    # some contraction temporal so per-instance tiles exist)
    inner_spatial: List[int] = []
    if len(spatial) >= 2:
        lvl = spatial[-1]
        inner_spatial = [lvl]
        budget = min(caps[-1], 16)
        for d in contraction:
            for p in _prime_iter(remaining[d]):
                if p <= budget and fits(lvl, d, p):
                    take(lvl, d, p)
                    budget //= p
                if budget <= 1:
                    break
    # remaining spatial levels, innermost first: output-dim parallelism,
    # capped at 16 per dim so the mapping keeps temporal sub-dimensions
    for lvl, cap in reversed(list(zip(spatial, caps))):
        if lvl in inner_spatial:
            continue
        budget = cap
        for d in outs:
            per_dim = 1
            for p in _prime_iter(remaining[d]):
                if p <= budget and per_dim * p <= 16 and fits(lvl, d, p):
                    take(lvl, d, p)
                    budget //= p
                    per_dim *= p
                if budget <= 1:
                    break
    # temporal levels, inner to outer: modest local tile (8/dim), then
    # staging tiles (64/dim); the outermost absorbs whatever is left
    temporal = list(arch.temporal_levels)
    for pos, lvl in enumerate(reversed(temporal[1:])):
        cap = 8 if pos == 0 else 64
        for d in workload.dim_order:
            for p in _prime_iter(remaining[d]):
                if factors[lvl].get(d, 1) * p <= cap and fits(lvl, d, p):
                    take(lvl, d, p)
    top = temporal[0]
    for d in workload.dim_order:
        if remaining[d] > 1:
            take(top, d, remaining[d])

    # output-stationary order: contraction dims innermost at every level
    perms = tuple(tuple(outs + contraction) for _ in range(nl))
    return Mapping(workload=workload, factors=tuple(factors), perms=perms,
                   arch=arch)


def balanced_mapping(workload: Workload, n_pe: int, macs_per_pe: int
                     ) -> Mapping:
    """Paper-topology convenience wrapper around
    :func:`balanced_mapping_for_arch` (DRAM/GLB/PEs/MACs; ``n_pe`` PEs,
    ``macs_per_pe`` MACs per PE)."""
    return balanced_mapping_for_arch(workload, ARCH_SPARSEMAP,
                                     spatial_caps=(n_pe, macs_per_pe))


def _prime_iter(n: int):
    from .workload import prime_factorize
    return list(prime_factorize(n))
