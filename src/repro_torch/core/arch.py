"""First-class accelerator architecture specs (the ArchSpec subsystem).

SparseMap (§II.B, Fig. 3/4) fixes one topology — DRAM -> GLB -> PE array
-> MACs — and the seed stack hardwired it as module constants spread over
``mapping`` / ``torch_cost`` / ``sparse`` / ``accel``.  This module lifts the
memory hierarchy into data: an :class:`ArchSpec` is an ordered list of
:class:`StorageLevel`\\ s, each carrying capacity / fill-energy / bandwidth
numbers plus the mapping levels it owns (one temporal level per store, and
an optional spatial level directly above it when the store is replicated
``fanout`` times under its parent).  Everything the stack used to hardcode
is *derived* here:

* loop-slot count (``n_levels``) and level names,
* temporal / spatial level index sets,
* outer / inner mapping-level sets per store (the loop-nest reuse rule),
* S/G sites (one per store that declares one, plus compute ``"C"``),
* genome segment widths (``n_levels`` perm genes, tiling genes in
  ``[0, n_levels)``, ``len(sg_sites)`` S/G genes),
* per-level word widths (:attr:`StorageLevel.word_bytes`, default the
  global 16-bit operand width) and per-edge NoC shape
  (:class:`NoCSpec`: multicast for reads, in-network reduction for the
  output — the knobs that open systolic-mesh and quantized-edge
  accelerator classes),
* the device evaluator's constant tables and traced parameter vector.

Two ArchSpecs with the same :class:`Topology` (structure) but different
numbers — e.g. the paper's edge/mobile/cloud platforms — share one
evaluator signature: the structure is baked into the evaluator's tables,
the numbers ride in the param vector.

The paper topology ships as :data:`ARCH_SPARSEMAP` (the default
everywhere; numerically bit-identical to the pre-ArchSpec code).  New
accelerator classes are config, not code: build an ArchSpec, register it
with :func:`register_arch`, and the whole mapping/cost/genome/search stack
runs on it (see ``repro_torch.configs.archs`` for a 2-store Maple-style edge
chip and a 4-store clustered cloud chip, and COMPAT.md for the contract).
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property, lru_cache
from typing import Dict, Optional, Tuple, Union

from .accel import Platform
from .workload import WORD_BYTES

# Energy groups: ((name, (component, ...)), ...).  A group becomes one
# named entry of the numpy cost model's energy breakdown (its components
# summed first); the device evaluator flattens all components of an edge and
# sums them left-to-right in float32 — both reproduce the seed
# implementation's exact arithmetic order for the paper topology.
EnergyGroups = Tuple[Tuple[str, Tuple[float, ...]], ...]


def _noc_scheme(flag: Union[bool, str]) -> str:
    """Normalize a NoC scheme declaration to "all" / "none" / "frac".

    ``True`` and ``"all"`` mean full multicast (or full in-network
    reduction); ``False`` and ``"none"`` mean pure unicast (or
    all-partials).  Any OTHER non-empty string — ``"row"``, ``"col"``,
    ``"cluster"``, ... — declares a *fractional* scheme: the label is
    kept for display, but structurally every fractional scheme is the
    same kernel shape ("frac"); its numeric discount fanout rides in the
    traced param vector so a family of same-scheme archs shares one
    evaluator signature."""
    if flag is True or flag == "all":
        return "all"
    if flag is False or flag == "none":
        return "none"
    if isinstance(flag, str) and flag:
        return "frac"
    raise ValueError(
        f"NoC scheme must be True/'all', False/'none', or a fractional "
        f"scheme label ('row', 'col', 'cluster', ...); got {flag!r}")


def _noc_topo_code(flag: Union[bool, str]) -> Union[bool, str]:
    """The Topology-tuple encoding of a scheme: the legacy booleans for
    all/none (existing fingerprints are unchanged) and the literal string
    ``"frac"`` for every fractional scheme (labels never split
    compilation)."""
    s = _noc_scheme(flag)
    return True if s == "all" else False if s == "none" else "frac"


@dataclasses.dataclass(frozen=True)
class NoCSpec:
    """Network-on-chip shape of the fill edge into a storage level: how
    traffic crossing the edge scales with the spatial fanout unrolled
    beneath it.

    ``multicast=True`` (tree/bus-style distribution, the paper topology's
    implicit NoC) means an irrelevant spatial loop below the edge sends
    ONE copy of a read tile to all instances; ``False`` (mesh-style
    store-and-forward unicast, the systolic-array model) means every
    instance's copy crosses the edge, multiplying read traffic by the
    loop bound.  ``reduction`` is the same choice for the OUTPUT tensor:
    ``True`` reduces spatially-partitioned partial sums in-network (one
    reduced result crosses the edge per tile), ``False`` sends every
    instance's partial sums across.

    Between the two extremes sit *fractional* schemes, declared with a
    string label and a numeric ``*_fanout``: ``multicast="row",
    multicast_fanout=14`` models a row-wise bus on a 2-D mesh (one copy
    serves each row of 14 instances), ``reduction="cluster",
    reduction_fanout=8`` a cluster-local adder tree (partials reduce
    within clusters of 8, one partial per cluster crosses the edge).
    With ``S`` spatial instances needing a tile the edge carries
    ``max(S / fanout, 1)`` copies — ``"all"`` is the ``fanout -> inf``
    limit, ``"none"`` is ``fanout = 1``.

    The *scheme* is structural: it shapes the compiled kernel and is part
    of the Topology fingerprint (as the normalized code, so different
    labels and fanouts never split compilation).  The *fanout* is a
    number riding in ``ArchSpec.param_vector`` — a family of same-scheme
    archs differing only in discount factors shares one evaluator signature.
    """

    multicast: Union[bool, str] = True
    reduction: Union[bool, str] = True
    multicast_fanout: Optional[float] = None
    reduction_fanout: Optional[float] = None

    def __post_init__(self):
        for kind, flag, fan in (
                ("multicast", self.multicast, self.multicast_fanout),
                ("reduction", self.reduction, self.reduction_fanout)):
            scheme = _noc_scheme(flag)      # raises on junk values
            if scheme == "frac":
                if fan is None or not fan > 0:
                    raise ValueError(
                        f"NoCSpec {kind}={flag!r} is a fractional scheme "
                        f"and needs {kind}_fanout > 0, got {fan!r}")
            elif fan is not None:
                raise ValueError(
                    f"NoCSpec {kind}={flag!r} takes no {kind}_fanout "
                    f"(only fractional schemes carry a numeric discount)")

    @property
    def multicast_scheme(self) -> str:
        return _noc_scheme(self.multicast)

    @property
    def reduction_scheme(self) -> str:
        return _noc_scheme(self.reduction)


#: The default edge NoC: full multicast + in-network reduction (exactly
#: the pre-NoC accounting, so existing topologies are unchanged).
NOC_DEFAULT = NoCSpec()


@dataclasses.dataclass(frozen=True)
class StorageLevel:
    """One storage level of the hierarchy, outermost (DRAM-like) first.

    The *edge* that fills this level from its parent owns one temporal
    mapping level; if ``fanout > 1`` the edge additionally owns a spatial
    mapping level directly below the temporal one (``fanout`` parallel
    instances of this level and everything beneath it).  The outermost
    level has no fill edge; its energy/bandwidth fields are ignored.
    """

    name: str
    capacity_bytes: Optional[float] = None       # None = unbounded
    fill_energy: EnergyGroups = ()               # pJ/byte into this level
    fanout: int = 1                              # spatial instances
    sg_site: Optional[str] = None                # S/G site filtering the
    #                                              edge OUT of this level
    fill_bandwidth_bytes_per_cycle: Optional[float] = None  # None = inf
    # datawidth of one element held in this level, in bytes.  None = the
    # global default (workload.WORD_BYTES, the paper's 16-bit operands).
    # Fills INTO this level and this level's occupancy are accounted at
    # this width (a quantized edge chip stores 1-byte words on-chip while
    # keeping the same topology otherwise).  Ignored on the outermost
    # level, like the energy/NoC fields: every edge is priced at its
    # DESTINATION store's width and the backing store is never filled or
    # capacity-checked.
    word_bytes: Optional[float] = None
    # NoC shape of the fill edge into this level (multicast/reduction);
    # ignored on the outermost level, which has no fill edge.
    noc: NoCSpec = NOC_DEFAULT
    # whether this store owns a spatial mapping level.  None derives it
    # from ``fanout > 1``; pass True to keep the level in the genome even
    # when the cap is 1 (e.g. the paper's edge platform has 1 MAC/PE but
    # the SAME 5-level mapping structure as mobile/cloud — an L3_S factor
    # > 1 is simply invalid there).
    spatial: Optional[bool] = None

    @property
    def is_spatial(self) -> bool:
        return self.fanout > 1 if self.spatial is None else self.spatial

    def flat_energy(self) -> Tuple[float, ...]:
        return tuple(c for _, comps in self.fill_energy for c in comps)


@dataclasses.dataclass(frozen=True)
class Topology:
    """The structural fingerprint of an ArchSpec: everything that shapes
    the compiled kernel (loop slots, site wiring, which parameters exist)
    but none of the numbers.  ArchSpecs sharing a Topology share genome
    layouts and evaluator signatures."""

    store_names: Tuple[str, ...]
    has_capacity: Tuple[bool, ...]               # per store
    has_spatial: Tuple[bool, ...]                # per EDGE (stores[1:])
    n_energy_comps: Tuple[int, ...]              # per edge
    edge_site: Tuple[Optional[int], ...]         # per edge: site idx | None
    has_bandwidth: Tuple[bool, ...]              # per edge
    sg_sites: Tuple[str, ...]                    # store sites + "C"
    # NoC scheme per edge (structural: changes the fills accounting).
    # Entries are the legacy booleans for the all/none schemes (existing
    # fingerprints unchanged) or the literal "frac" for any fractional
    # scheme — the numeric fanout is traced, never part of the topology.
    noc_multicast: Tuple[Union[bool, str], ...] = ()
    noc_reduction: Tuple[Union[bool, str], ...] = ()
    # True when every level stores the global default word width; the
    # kernel then bakes the width as a constant (the pre-word-width code
    # path, bit-identical for existing topologies).  Custom-width specs
    # trace per-edge widths from the param vector instead, so e.g. a
    # family of 1-byte-word chips still shares one compilation.
    uniform_word_bytes: bool = True

    @cached_property
    def fingerprint(self) -> str:
        """Short stable tag used in compilation signatures."""
        h = hashlib.sha1(repr(dataclasses.astuple(self)).encode())
        return h.hexdigest()[:8]


class ArchSpec:
    """An ordered memory hierarchy plus compute, with all derived
    mapping/genome/kernel structure cached.  Hashable by identity-free
    content, so it can key jit caches directly."""

    def __init__(self, name: str, levels: Tuple[StorageLevel, ...],
                 e_mac: float = 0.8, clock_hz: float = 1.0e9):
        if len(levels) < 2:
            raise ValueError("ArchSpec needs >= 2 storage levels "
                             "(a backing store and at least one buffer)")
        if levels[0].is_spatial:
            raise ValueError("the outermost (backing) store cannot be "
                             "spatially replicated")
        if levels[0].capacity_bytes is not None:
            raise ValueError(
                "the outermost (backing) store is never capacity-checked;"
                " leave capacity_bytes=None (a value would only split "
                "compilation signatures for identical kernels)")
        names = [lv.name for lv in levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate storage level names: {names}")
        sites = [lv.sg_site for lv in levels if lv.sg_site is not None]
        if len(set(sites)) != len(sites):
            raise ValueError(f"duplicate S/G site names: {sites}")
        if "C" in sites:
            raise ValueError('"C" is reserved for the compute S/G site')
        if levels[-1].sg_site is not None:
            raise ValueError("the innermost store's outgoing edge IS "
                             "compute; give it sg_site=None (site 'C' "
                             "is implicit)")
        for lv in levels:
            if lv.word_bytes is not None and not lv.word_bytes > 0:
                raise ValueError(
                    f"store {lv.name!r}: word_bytes must be > 0, got "
                    f"{lv.word_bytes}")
        self.name = name
        self.levels = tuple(levels)
        self.e_mac = float(e_mac)
        self.clock_hz = float(clock_hz)
        self._build()

    # ------------------------------------------------------------ build
    def _build(self) -> None:
        lv = self.levels
        self.n_stores = len(lv)
        self.store_names = tuple(l.name for l in lv)
        self.store_index: Dict[str, int] = {
            l.name: k for k, l in enumerate(lv)}

        # mapping levels: per edge k (into store k, k >= 1) a temporal
        # level L{k}_T, then a spatial level L{k}_S when fanout > 1
        names = []
        level_edge = []          # mapping level -> edge index (store k - 1)
        spatial = []
        spatial_store = []       # spatial level -> store index it replicates
        for k in range(1, self.n_stores):
            names.append(f"L{k}_T")
            level_edge.append(k - 1)
            spatial.append(False)
            if lv[k].is_spatial:
                names.append(f"L{k}_S")
                level_edge.append(k - 1)
                spatial.append(True)
                spatial_store.append(k)
        self.level_names = tuple(names)
        self.n_levels = len(names)
        self.is_spatial = tuple(spatial)
        self.spatial_levels = tuple(
            i for i, s in enumerate(spatial) if s)
        self.temporal_levels = tuple(
            i for i, s in enumerate(spatial) if not s)
        self.level_edge = tuple(level_edge)
        self.spatial_store = tuple(spatial_store)

        self.n_edges = self.n_stores - 1
        # fills INTO store k see the loops of edges 1..k as the outer
        # nest; the tile held inside spans the levels below
        self.outer_levels_for: Dict[str, Tuple[int, ...]] = {}
        self.inner_levels_for: Dict[str, Tuple[int, ...]] = {}
        for k in range(1, self.n_stores):
            self.outer_levels_for[lv[k].name] = tuple(
                i for i, e in enumerate(level_edge) if e <= k - 1)
            self.inner_levels_for[lv[k].name] = tuple(
                i for i, e in enumerate(level_edge) if e > k - 1)

        # S/G sites: per-store declared sites in store order, then "C"
        store_sites = [l.sg_site for l in lv if l.sg_site is not None]
        self.sg_sites: Tuple[str, ...] = tuple(store_sites) + ("C",)
        site_idx = {s: i for i, s in enumerate(store_sites)}
        # edge k (into store k) is filtered by the site of store k-1
        self.edge_site: Tuple[Optional[int], ...] = tuple(
            site_idx.get(lv[k - 1].sg_site)
            for k in range(1, self.n_stores))

        # capacity-checked stores (store index, name, capacity)
        self.capacity_stores: Tuple[Tuple[int, str, float], ...] = tuple(
            (k, lv[k].name, float(lv[k].capacity_bytes))
            for k in range(1, self.n_stores)
            if lv[k].capacity_bytes is not None)
        # bandwidth-limited edges (edge index, bytes/cycle)
        self.bw_edges: Tuple[Tuple[int, float], ...] = tuple(
            (k - 1, float(lv[k].fill_bandwidth_bytes_per_cycle))
            for k in range(1, self.n_stores)
            if lv[k].fill_bandwidth_bytes_per_cycle is not None)
        self.edge_energy: Tuple[EnergyGroups, ...] = tuple(
            lv[k].fill_energy for k in range(1, self.n_stores))

        # per-store word widths (None -> the global default) and the
        # per-edge view: edge k-1 fills store k, so its traffic and the
        # store's occupancy are both accounted at store k's width
        self.store_word_bytes: Tuple[float, ...] = tuple(
            float(l.word_bytes) if l.word_bytes is not None
            else float(WORD_BYTES) for l in lv)
        self.edge_word_bytes: Tuple[float, ...] = self.store_word_bytes[1:]
        # NoC descriptor per edge (the filled store's declared NoC)
        self.edge_noc: Tuple[NoCSpec, ...] = tuple(
            lv[k].noc for k in range(1, self.n_stores))

        self.topology = Topology(
            store_names=self.store_names,
            has_capacity=tuple(l.capacity_bytes is not None for l in lv),
            has_spatial=tuple(l.is_spatial for l in lv[1:]),
            n_energy_comps=tuple(len(lv[k].flat_energy())
                                 for k in range(1, self.n_stores)),
            edge_site=self.edge_site,
            has_bandwidth=tuple(
                l.fill_bandwidth_bytes_per_cycle is not None
                for l in lv[1:]),
            sg_sites=self.sg_sites,
            noc_multicast=tuple(_noc_topo_code(n.multicast)
                                for n in self.edge_noc),
            noc_reduction=tuple(_noc_topo_code(n.reduction)
                                for n in self.edge_noc),
            uniform_word_bytes=all(
                w == float(WORD_BYTES) for w in self.edge_word_bytes),
        )

    # ------------------------------------------------------ conveniences
    def spatial_caps(self) -> Tuple[int, ...]:
        """Fanout cap per spatial mapping level, in level order."""
        return tuple(self.levels[k].fanout for k in self.spatial_store)

    def store(self, name: str) -> StorageLevel:
        return self.levels[self.store_index[name]]

    def word_bytes_of(self, store_name: str) -> float:
        """Resolved datawidth of one element held in ``store_name``."""
        return self.store_word_bytes[self.store_index[store_name]]

    def param_vector(self):
        """The traced parameter vector the device evaluator consumes:
        [spatial caps | capacities | flat edge-energy components |
        edge bandwidths | e_mac | per-edge word widths | fractional NoC
        fanouts], float32.  Two same-topology specs differ only here, so
        they share compilations (uniform-default-width topologies bake
        the width as a kernel constant and simply never read the width
        tail; the NoC tail only exists for edges declaring a fractional
        scheme, in edge order, multicast fanout before reduction
        fanout)."""
        import numpy as np
        vals = (list(self.spatial_caps()) +
                [c for _, _, c in self.capacity_stores] +
                [c for groups in self.edge_energy
                 for _, comps in groups for c in comps] +
                [bw for _, bw in self.bw_edges] +
                [self.e_mac] +
                list(self.edge_word_bytes))
        for n in self.edge_noc:
            if n.multicast_scheme == "frac":
                vals.append(n.multicast_fanout)
            if n.reduction_scheme == "frac":
                vals.append(n.reduction_fanout)
        return np.asarray(vals, dtype=np.float32)

    def describe(self) -> str:
        rows = []
        for k, l in enumerate(self.levels):
            bits = [f"store {l.name}"]
            if l.capacity_bytes is not None:
                bits.append(f"{l.capacity_bytes / 1024:.0f}KB")
            if k > 0 and l.fanout > 1:
                bits.append(f"x{l.fanout}")
            if l.sg_site:
                bits.append(f"S/G {l.sg_site}")
            if l.word_bytes is not None:
                bits.append(f"{l.word_bytes:g}B-word")
            if k > 0 and l.noc != NOC_DEFAULT:
                def _bit(scheme, label, fanout, full, empty):
                    if scheme == "all":
                        return full
                    if scheme == "none":
                        return empty
                    return f"{full}:{label}/{fanout:g}"
                bits.append(
                    "noc["
                    + _bit(l.noc.multicast_scheme, l.noc.multicast,
                           l.noc.multicast_fanout, "mc", "ucast") + "/"
                    + _bit(l.noc.reduction_scheme, l.noc.reduction,
                           l.noc.reduction_fanout, "red", "all-partials")
                    + "]")
            rows.append(" ".join(bits))
        rows.append(f"levels: {' '.join(self.level_names)}; "
                    f"sites: {'/'.join(self.sg_sites)}")
        return "\n".join(rows)

    # hashability: by content, so lru_cache can key on the spec
    def _key(self) -> Tuple:
        return (self.name, self.levels, self.e_mac, self.clock_hz)

    def __hash__(self) -> int:
        return hash(self._key())

    def __eq__(self, other) -> bool:
        return isinstance(other, ArchSpec) and self._key() == other._key()

    def __repr__(self) -> str:
        return (f"ArchSpec({self.name!r}, {self.n_stores} stores, "
                f"{self.n_levels} mapping levels, "
                f"sites={self.sg_sites})")


# ---------------------------------------------------------------- paper


@lru_cache(maxsize=None)
def arch_from_platform(p: Platform) -> ArchSpec:
    """The paper topology (Fig. 3a: DRAM -> GLB -> PE array -> MACs)
    populated with a :class:`repro_torch.core.accel.Platform`'s Table II
    numbers.  All platforms share one Topology, hence one compilation."""
    return ArchSpec(
        name=p.name,
        levels=(
            StorageLevel("dram"),
            StorageLevel(
                "glb", capacity_bytes=p.glb_bytes,
                fill_energy=(("dram", (p.e_dram_per_byte,)),),
                sg_site="L2",
                fill_bandwidth_bytes_per_cycle=p.dram_bytes_per_cycle),
            StorageLevel(
                "pebuf", capacity_bytes=p.pe_buffer_bytes,
                fill_energy=(("glb", (p.scaled_glb_energy(),
                                      p.e_noc_per_byte)),),
                fanout=p.n_pe, sg_site="L3", spatial=True),
            StorageLevel(
                "reg",
                fill_energy=(("pebuf", (p.scaled_pebuf_energy(),)),
                             ("reg", (p.e_reg_per_byte,))),
                fanout=p.macs_per_pe, spatial=True),
        ),
        e_mac=p.e_mac, clock_hz=p.clock_hz)


def _sparsemap_default() -> ArchSpec:
    from .accel import CLOUD
    spec = arch_from_platform(CLOUD)
    return ArchSpec(name="sparsemap", levels=spec.levels,
                    e_mac=spec.e_mac, clock_hz=spec.clock_hz)


#: The paper topology (cloud-class numbers) — the default arch everywhere.
ARCH_SPARSEMAP = _sparsemap_default()


# ---------------------------------------------------------------- registry

_REGISTRY: Dict[str, ArchSpec] = {}


def register_arch(spec: ArchSpec, replace: bool = False) -> ArchSpec:
    from .accel import PLATFORMS
    if spec.name in PLATFORMS:
        # as_arch resolves platform names FIRST; a same-named arch would
        # register fine but silently never be found
        raise ValueError(
            f"arch name {spec.name!r} shadows a paper platform; pick a "
            f"name outside {sorted(PLATFORMS)}")
    if spec.name in _REGISTRY and not replace \
            and _REGISTRY[spec.name] != spec:
        raise ValueError(f"arch {spec.name!r} already registered with "
                         f"different content")
    _REGISTRY[spec.name] = spec
    return spec


def registered_archs() -> Dict[str, ArchSpec]:
    _load_config_archs()
    return dict(_REGISTRY)


def _load_config_archs() -> None:
    """Import the config-level arch definitions so string lookups see
    them (they register themselves on import).  Only a genuinely absent
    configs package is tolerated; any OTHER import failure (e.g. a broken
    transitive dependency) surfaces instead of silently emptying the
    registry."""
    try:
        import repro_torch.configs.archs  # noqa: F401  (side effect: register)
    except ModuleNotFoundError as e:
        if e.name not in ("repro_torch.configs", "repro_torch.configs.archs"):
            raise


class UnknownArchError(KeyError):
    """Raised by :func:`as_arch` for an unresolvable name.  A KeyError
    subclass (callers catching KeyError keep working) whose message is
    not repr-quoted, so the full platform/arch listing stays readable."""

    def __str__(self) -> str:
        return self.args[0]


def as_arch(platform: Union[str, Platform, ArchSpec]) -> ArchSpec:
    """Resolve any accepted hardware description to an ArchSpec:
    a Platform name ("edge"/"mobile"/"cloud"), a registered arch name,
    a Platform object, or an ArchSpec (passed through).  Unknown names
    raise :class:`UnknownArchError` listing every resolvable name (the
    paper platforms plus :func:`registered_archs`)."""
    if isinstance(platform, ArchSpec):
        return platform
    if isinstance(platform, Platform):
        return arch_from_platform(platform)
    if isinstance(platform, str):
        from .accel import PLATFORMS
        if platform in PLATFORMS:
            return arch_from_platform(PLATFORMS[platform])
        if platform not in _REGISTRY:
            _load_config_archs()
        if platform in _REGISTRY:
            return _REGISTRY[platform]
        import difflib
        known = sorted(PLATFORMS) + sorted(_REGISTRY)
        close = difflib.get_close_matches(platform, known, n=3)
        hint = f"; did you mean {' / '.join(map(repr, close))}?" \
            if close else ""
        raise UnknownArchError(
            f"unknown platform/arch {platform!r}{hint}\n"
            f"  paper platforms: {', '.join(sorted(PLATFORMS))}\n"
            f"  registered archs: {', '.join(sorted(_REGISTRY))}\n"
            f"  (register new topologies with repro_torch.core.arch."
            f"register_arch or declare them via repro_torch.core.arch_dsl; "
            f"see repro_torch.configs.archs and COMPAT.md)")
    raise TypeError(f"cannot resolve {type(platform).__name__} to an "
                    f"ArchSpec")


register_arch(ARCH_SPARSEMAP)
