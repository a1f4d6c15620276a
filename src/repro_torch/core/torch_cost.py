"""PyTorch batch evaluator for the SparseMap cost model, generalized over
a declared :class:`repro_torch.core.arch.ArchSpec`.

A batched float32 re-implementation of :mod:`repro_torch.core.cost_model`
that evaluates a whole *population* of genomes in one call on one device.
The numpy implementation is the exact float64 oracle; this one is held to
it at ``|dlog10_edp| <= 2e-3 * max(|log10_edp|, 1)`` with validity equal
outside a 5e-3 relative capacity margin (tests/test_torch_cost.py).  It is
the counterpart of the JAX package's ``jax_cost.JaxCostModel``, restricted
to the broadcast path (one workload per call); the mega-batched, scanned
and sharded dispatch paths of that module are not part of this package
yet.

Structure vs numbers: the arch's *structure* (loop-slot count, store
tables, S/G site wiring, NoC multicast/reduction shape, which parameters
exist) comes from the :class:`Topology` and shapes the Python that builds
the tensor program; its *numbers* — including per-edge word widths when
any level departs from the global default — ride in the parameter vector
(``ArchSpec.param_vector``), a device tensor.  Per-tensor density models
follow the same split: the *mode* is structural — all-uniform workloads
run the literal uniform occupancy expression while any structured operand
selects the structured variant — and within the structured variant the
family codes and numeric parameters (N:M's n/m, a band's coverage) are
tensor rows.  ``TorchCostModel.signature`` is therefore
``(ndims, prime_bucket, topology_fingerprint, density_key)``: evaluators
that share it run the same program on same-shaped inputs.

The decode is fully tensorized with the batch axis written out: tiling
factors via masked products over the prime list, permutations via a
(d!, d) lookup table, loop-nest reuse via reverse cumulative products over
the fixed n_levels*d loop-slot axis.  The fiber-tree byte accounting is a
recurrence over the loop slots whose only carried value is the fiber
count, a running product; it is written here as an exclusive ``cumprod``
plus a sum over the slot axis (all three tensors at once) instead of a
per-slot loop, so one evaluator call is a few hundred device launches
whatever the workload's rank.

Nothing in ``__call__`` synchronises except the two copies: the genome
batch goes to the device in one copy, and one ``(3, B)`` float32 tensor
(valid, energy, cycles) comes back in one copy.
"""
from __future__ import annotations

import dataclasses
import threading
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import density as density_lib
from .accel import Platform
from .arch import ArchSpec, Topology, as_arch
from .encoding import GenomeSpec, all_permutations
from .sparse import MAX_FMT_GENES
from .workload import WORD_BYTES

# S/G lookup tables over gene value 0..6
_V = np.arange(7)
SG_LEADER_P = np.isin(_V, [2, 3, 5, 6])
SG_LEADER_Q = np.isin(_V, [1, 3, 4, 6])
SG_FOLLOW_P = np.isin(_V, [1, 3, 4, 6])
SG_FOLLOW_Q = np.isin(_V, [2, 3, 5, 6])
SG_IS_SKIP = _V >= 4
SG_IS_GATE = (_V >= 1) & (_V <= 3)

FMT_U, FMT_B, FMT_RLE, FMT_CP, FMT_UOP = range(5)


def _bucket(n: int, size: int = 16) -> int:
    return ((n + size - 1) // size) * size


# Evaluator calls issued through TorchCostModel since the last reset — the
# per-round dispatch-count hook.  One lock guards the counter so callers
# may call evaluators from worker threads.
_DISPATCHES = 0
_LOCK = threading.Lock()


def _count_dispatch() -> None:
    global _DISPATCHES
    with _LOCK:
        _DISPATCHES += 1


def dispatch_count() -> int:
    """Evaluator calls issued since the last reset (each batched
    ``TorchCostModel.__call__`` is one dispatch)."""
    with _LOCK:
        return _DISPATCHES


def reset_dispatch_count() -> None:
    global _DISPATCHES
    with _LOCK:
        _DISPATCHES = 0


@dataclasses.dataclass(frozen=True)
class _TopoTables:
    """Structural constants the evaluator derives from a Topology."""

    n_levels: int
    n_edges: int
    is_spatial: Tuple[bool, ...]            # per mapping level
    spatial_levels: Tuple[int, ...]
    store_outer: Tuple[Tuple[bool, ...], ...]   # (n_edges, n_levels)
    store_inner: Tuple[Tuple[bool, ...], ...]
    edge_site: Tuple[Optional[int], ...]    # per edge
    n_sites: int
    # param-vector layout (indices into the parameter vector)
    fanout_idx: Tuple[int, ...]             # per spatial level
    cap_checks: Tuple[Tuple[int, int], ...]  # (edge idx, param idx)
    energy_idx: Tuple[Tuple[int, ...], ...]  # per edge: component indices
    bw_checks: Tuple[Tuple[int, int], ...]  # (edge idx, param idx)
    mac_idx: int
    # NoC scheme per edge (True/False/"frac") + the word-width
    # parameterization: with uniform_words the evaluator uses WORD_BYTES
    # as a constant; otherwise per-edge widths are read from the param
    # vector at word_idx, so same-topology custom-width specs still share
    # one signature.  Fractional NoC schemes read their discount fanout
    # from the param-vector tail at noc_mc_idx / noc_red_idx (None on
    # all/none edges) — same split, so a same-scheme family with
    # different fanouts shares one signature.
    noc_multicast: Tuple[Union[bool, str], ...] = ()
    noc_reduction: Tuple[Union[bool, str], ...] = ()
    uniform_words: bool = True
    word_idx: Tuple[int, ...] = ()          # per edge: param idx
    noc_mc_idx: Tuple[Optional[int], ...] = ()   # per edge: param idx|None
    noc_red_idx: Tuple[Optional[int], ...] = ()


@lru_cache(maxsize=32)
def _topo_tables(topo: Topology) -> _TopoTables:
    n_edges = len(topo.has_spatial)
    level_edge: List[int] = []
    is_spatial: List[bool] = []
    for e in range(n_edges):
        level_edge.append(e)
        is_spatial.append(False)
        if topo.has_spatial[e]:
            level_edge.append(e)
            is_spatial.append(True)
    nl = len(level_edge)
    spatial_levels = tuple(i for i, s in enumerate(is_spatial) if s)
    store_outer = tuple(
        tuple(level_edge[i] <= e for i in range(nl))
        for e in range(n_edges))
    store_inner = tuple(
        tuple(level_edge[i] > e for i in range(nl))
        for e in range(n_edges))

    # param vector layout mirrors ArchSpec.param_vector
    pos = 0
    fanout_idx = tuple(range(pos, pos + len(spatial_levels)))
    pos += len(spatial_levels)
    cap_checks = []
    for k in range(1, n_edges + 1):
        if topo.has_capacity[k]:
            cap_checks.append((k - 1, pos))
            pos += 1
    energy_idx = []
    for e in range(n_edges):
        energy_idx.append(tuple(range(pos, pos + topo.n_energy_comps[e])))
        pos += topo.n_energy_comps[e]
    bw_checks = []
    for e in range(n_edges):
        if topo.has_bandwidth[e]:
            bw_checks.append((e, pos))
            pos += 1
    mac_idx = pos
    word_idx = tuple(range(pos + 1, pos + 1 + n_edges))
    # fractional NoC fanouts trail the word widths (mirrors
    # ArchSpec.param_vector: edge order, multicast before reduction)
    noc_mc = topo.noc_multicast or (True,) * n_edges
    noc_red = topo.noc_reduction or (True,) * n_edges
    pos = word_idx[-1] + 1 if word_idx else mac_idx + 1
    noc_mc_idx: List[Optional[int]] = []
    noc_red_idx: List[Optional[int]] = []
    for e in range(n_edges):
        if noc_mc[e] == "frac":
            noc_mc_idx.append(pos)
            pos += 1
        else:
            noc_mc_idx.append(None)
        if noc_red[e] == "frac":
            noc_red_idx.append(pos)
            pos += 1
        else:
            noc_red_idx.append(None)

    return _TopoTables(
        n_levels=nl, n_edges=n_edges, is_spatial=tuple(is_spatial),
        spatial_levels=spatial_levels, store_outer=store_outer,
        store_inner=store_inner, edge_site=topo.edge_site,
        n_sites=len(topo.sg_sites), fanout_idx=fanout_idx,
        cap_checks=tuple(cap_checks), energy_idx=tuple(energy_idx),
        bw_checks=tuple(bw_checks), mac_idx=mac_idx,
        noc_multicast=noc_mc,
        noc_reduction=noc_red,
        uniform_words=topo.uniform_word_bytes,
        word_idx=word_idx,
        noc_mc_idx=tuple(noc_mc_idx), noc_red_idx=tuple(noc_red_idx))


# ------------------------------------------- density occupancy functions
#
# Torch counterparts of DensityModel.block_nonempty, keyed by family name.
# Each takes (row, elems): ``row[i]`` is column i of the per-tensor
# [code, hit_rate, family params...] rows (density.param_row), shaped to
# broadcast against ``elems``, the (possibly fractional) tile extents;
# each returns P(block nonempty).  Custom families register with
# :func:`register_density_occ` BEFORE building evaluators (the registry
# fingerprint is part of the signature).


def _occ_uniform(row, e):
    return 1.0 - torch.pow(1.0 - row[2], torch.clamp(e, min=1.0))


def _occ_banded(row, e):
    cov = torch.clamp(row[3], min=1e-30)
    d_in = torch.clamp(row[2] / cov, 0.0, 1.0)
    return cov * (1.0 - torch.pow(1.0 - d_in, torch.clamp(e, min=1.0)))


def _occ_block_nm(row, e):
    # hypergeometric miss: C(m-n, e) / C(m, e) via log-gamma (fractional
    # e supported); any window wider than the zero budget m-n must hit
    n_, m_ = row[2], row[3]
    free = m_ - n_
    e_ = torch.clamp(e, min=1.0)
    ec = torch.minimum(e_, free)
    lg = (torch.lgamma(free + 1.0) + torch.lgamma(m_ - ec + 1.0)
          - torch.lgamma(free - ec + 1.0) - torch.lgamma(m_ + 1.0))
    return torch.where(e_ > free, 1.0, 1.0 - torch.exp(lg))


_TORCH_OCC = {"uniform": _occ_uniform, "banded": _occ_banded,
              "block_nm": _occ_block_nm}


def register_density_occ(family: str, fn) -> None:
    """Register the torch occupancy function of a custom density family
    (numpy side: ``density.register_density_model``).  Must happen before
    any structured evaluator is built."""
    if family in _TORCH_OCC and _TORCH_OCC[family] is not fn:
        raise ValueError(f"density family {family!r} already has a torch "
                         f"occupancy function")
    _TORCH_OCC[family] = fn


def _occ_structured(row, e):
    """Dispatch over the registered families: every family's occupancy is
    computed and the per-tensor code selects one — the family assignment
    rides in the tensor rows, so it never splits signatures."""
    fams = density_lib.registered_families()
    missing = [f for f in fams if f not in _TORCH_OCC]
    if missing:
        raise KeyError(
            f"density families {missing} have no torch occupancy function; "
            f"call torch_cost.register_density_occ (COMPAT.md)")
    out = _TORCH_OCC[fams[0]](row, e)
    for fam in fams[1:]:
        out = torch.where(row[0] == float(density_lib.family_code(fam)),
                          _TORCH_OCC[fam](row, e), out)
    return out


# ------------------------------------------------------------- evaluator


def clog2(x: torch.Tensor) -> torch.Tensor:
    """``max(1, ceil(log2(max(x, 2))))`` without a logarithm.

    One ULP of error in ``log2`` at an exact power of two adds a whole
    metadata bit per coordinate, so the exponent is read with ``frexp``
    instead: ``x = m * 2**e`` with ``m`` in [0.5, 1) gives
    ``ceil(log2 x) = e - 1`` when ``m == 0.5`` (x is a power of two) and
    ``e`` otherwise — exact on every device, and equal to the float64
    oracle whenever ``x`` itself is exact in float32."""
    m, e = torch.frexp(torch.clamp(x, min=2.0))
    return (e - (m == 0.5).to(e.dtype)).to(x.dtype)


def _rev_cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cumprod(torch.flip(x, (dim,)), dim), (dim,))


@dataclasses.dataclass(frozen=True)
class _Tables:
    """Device-resident structural tables of one (d, topology) pair."""

    perm_table: torch.Tensor        # (d!, d) int64
    lvl_slot: torch.Tensor          # (nl,) int64: lvl_of * d
    spatial_flat: torch.Tensor      # (nl,) bool
    store_outer: torch.Tensor       # (NE, nl) bool
    store_inner_lv: torch.Tensor    # (NE, NL) bool
    level_ids: torch.Tensor         # (NL,) int64
    dim_ids: torch.Tensor           # (d,) int64
    sg: torch.Tensor                # (6, 7) bool: the SG_* lookup tables


@lru_cache(maxsize=64)
def _device_tables(d: int, topo: Topology, device: torch.device) -> _Tables:
    tt = _topo_tables(topo)
    NL = tt.n_levels
    lvl_of = np.repeat(np.arange(NL), d)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return _Tables(
        perm_table=dev(all_permutations(d), torch.int64),
        lvl_slot=dev(lvl_of * d, torch.int64),
        spatial_flat=dev(np.asarray(tt.is_spatial)[lvl_of], torch.bool),
        store_outer=dev(np.asarray(tt.store_outer)[:, lvl_of], torch.bool),
        store_inner_lv=dev(tt.store_inner, torch.bool),
        level_ids=dev(np.arange(NL), torch.int64),
        dim_ids=dev(np.arange(d), torch.int64),
        sg=dev(np.stack([SG_LEADER_P, SG_LEADER_Q, SG_FOLLOW_P,
                         SG_FOLLOW_Q, SG_IS_SKIP, SG_IS_GATE]),
               torch.bool))


def eval_batch(tt: _TopoTables, tb: _Tables, structured: bool,
               perm_genes: torch.Tensor, assign: torch.Tensor,
               fmt_genes: torch.Tensor, sg: torch.Tensor,
               primes: torch.Tensor, prime_dim: torch.Tensor,
               relevance: torch.Tensor, densities: torch.Tensor,
               full_elems: torch.Tensor, total_macs: torch.Tensor,
               z_onehot: torch.Tensor, plat: torch.Tensor,
               dens_params: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The row cost evaluator on a ``(B, ...)`` batch: one workload's
    constants broadcast over the rows.

    ``perm_genes (B, NL)``, ``assign (B, n_pad)``, ``fmt_genes (B, 3,
    MAX_FMT_GENES)`` and ``sg (B, n_sites)`` are int64; the workload
    constants are float32 (``relevance`` bool, ``prime_dim`` int64).
    Returns ``(valid, energy_pj, cycles)``, each ``(B,)``, energy and
    cycles ``inf`` on invalid rows."""
    NL, NE = tt.n_levels, tt.n_edges
    d = tb.dim_ids.shape[0]
    B = perm_genes.shape[0]
    wb = float(WORD_BYTES)
    f32 = torch.float32

    # ---- tiling factors (B, NL, d) ----
    lvl_eq = assign[:, None, :] == tb.level_ids[None, :, None]  # (B,NL,np)
    dim_eq = prime_dim[None, :] == tb.dim_ids[:, None]          # (d, np)
    mask = lvl_eq[:, :, None, :] & dim_eq[None, None, :, :]     # (B,NL,d,np)
    one = primes.new_ones(())
    factors = torch.where(mask, primes, one).prod(dim=-1)       # (B, NL, d)

    # ---- flattened loops (B, nl) ----
    loop_dims = tb.perm_table[perm_genes]                       # (B, NL, d)
    dims_flat = loop_dims.reshape(B, NL * d)
    bounds = factors.reshape(B, NL * d).gather(
        1, tb.lvl_slot[None, :] + dims_flat)
    spatial_flat = tb.spatial_flat[None, :]                     # (1, nl)

    fanouts = [factors[:, lvl, :].prod(dim=-1)
               for lvl in tt.spatial_levels]                    # each (B,)
    rel_flat = relevance[:, dims_flat].permute(1, 0, 2)         # (B, 3, nl)
    transparent = bounds <= 1.0

    # tile extents per (store edge, tensor): the product of the factors
    # of the tensor's dims over the levels inside the store
    tile_mask = (tb.store_inner_lv[:, None, :, None]
                 & relevance[None, :, None, :])                 # (NE,3,NL,d)
    tiles = torch.where(tile_mask[None], factors[:, None, None], one
                        ).reshape(B, NE, 3, NL * d).prod(dim=-1)  # (B,NE,3)

    def fills_for(s: int, t: int) -> torch.Tensor:
        active = tb.store_outer[s][None, :]                     # (1, nl)
        rel = rel_flat[:, t]
        irrel = ~rel
        passthru = torch.where(active, irrel | transparent, True)
        in_suffix = _rev_cumprod(passthru.to(f32), 1) > 0.5
        contrib = torch.where(rel | ~spatial_flat, bounds, one)
        mult = torch.where(active & ~in_suffix, contrib, one).prod(dim=1)
        # NoC scheme of edge s: without multicast (reads) / in-network
        # reduction (the output, tensor 2), every spatial instance's copy
        # crosses the edge — irrelevant spatial loops multiply traffic
        # wherever they sit in the nest (suffix included).  Fractional
        # schemes carry max(S / fanout, 1) copies over the same loop set,
        # the fanout read from the param-vector tail.
        scheme = tt.noc_reduction[s] if t == 2 else tt.noc_multicast[s]
        if scheme == "frac" or not scheme:
            s_irrel = torch.where(active & irrel & spatial_flat, bounds,
                                  one).prod(dim=1)
            if scheme == "frac":
                fi = tt.noc_red_idx[s] if t == 2 else tt.noc_mc_idx[s]
                mult = mult * torch.clamp(s_irrel / plat[fi], min=1.0)
            else:
                mult = mult * s_irrel
        return tiles[:, s, t] * mult

    fills = torch.stack([torch.stack([fills_for(s, t) for t in range(3)],
                                     dim=1) for s in range(NE)],
                        dim=1)                                  # (B, NE, 3)

    # ---- fiber-tree format accounting, all three tensors at once ----
    G = MAX_FMT_GENES
    bnd3 = bounds[:, None, :]                                   # (B, 1, nl)
    is_sub = rel_flat & (bnd3 > 1.0)                            # (B, 3, nl)
    sub_i = is_sub.to(torch.int64)
    k = sub_i.sum(dim=2, keepdim=True)
    rank = torch.cumsum(sub_i, dim=2) - 1
    gidx = rank + torch.clamp(G - k, min=0)
    fmt = torch.where(
        is_sub & (gidx < G) & (gidx >= 0),
        fmt_genes.gather(2, torch.clamp(gidx, 0, G - 1)), FMT_U)
    dens = densities[None, :, None]                             # (1, 3, 1)
    sub_bounds = torch.where(is_sub, bnd3, one)
    elems_below = _rev_cumprod(sub_bounds, 2) / sub_bounds
    if structured:
        row = dens_params.t()[:, None, :, None]                  # (R,1,3,1)
        occ = _occ_structured(row, elems_below)
    else:
        # all-uniform: the literal uniform-random occupancy expression
        occ = 1.0 - torch.pow(1.0 - dens, torch.clamp(elems_below, min=1.0))
    kept = sub_bounds * occ
    full = full_elems[None, :, None]                            # (1, 3, 1)

    # The per-slot recurrence carries only the fiber count,
    #   n_fibers <- n_fibers * (L if fmt == U else kept)   on sub-dims,
    # so n_fibers entering slot j is the exclusive running product of the
    # per-slot growth, and the metadata bits are a sum over the slots.
    growth = torch.where(is_sub, torch.where(fmt == FMT_U, sub_bounds, kept),
                         one)
    n_fibers = torch.cat([torch.ones_like(growth[..., :1]),
                          torch.cumprod(growth, dim=2)[..., :-1]], dim=2)
    cl = clog2(sub_bounds)
    coord_bits = n_fibers * kept * cl
    zero = torch.zeros((), dtype=f32, device=bounds.device)
    mb = torch.where(
        fmt == FMT_B, n_fibers * sub_bounds,
        torch.where(
            (fmt == FMT_RLE) | (fmt == FMT_CP), coord_bits,
            torch.where(
                fmt == FMT_UOP,
                n_fibers * (sub_bounds + 1.0)
                * clog2(torch.clamp(full, min=2.0)), zero)))
    meta_bits = torch.where(is_sub, mb, zero).sum(dim=2)        # (B, 3)

    not_u = fmt != FMT_U
    compressed = (is_sub & not_u).any(dim=2)                    # (B, 3)
    full2, dens2 = full_elems[None, :], densities[None, :]
    data_b = torch.where(compressed, full2 * dens2 * wb, full2 * wb)
    ratios = (data_b + meta_bits / 8.0) / torch.clamp(full2 * wb, min=1.0)

    comp_here = (is_sub & not_u).to(f32)
    comp_after = torch.flip(torch.cumsum(torch.flip(comp_here, (2,)), 2),
                            (2,)) - comp_here
    uop_bad = (is_sub & (fmt == FMT_UOP) & (comp_after < 0.5)).any(dim=2)
    spat_bad = (is_sub & spatial_flat[:, None, :] & not_u).any(dim=2)
    fmt_invalid = (uop_bad | spat_bad).any(dim=1)               # (B,)
    p_comp, q_comp = compressed[:, 0:1], compressed[:, 1:2]     # (B, 1)

    # ---- S/G (sg has one gene per site; compute site "C" last) ----
    lead_p, lead_q, fol_p, fol_q, skips, gates = tb.sg[:, sg]   # (B, sites)
    if structured:
        # element-granularity intersection hit rates of the input
        # leaders (DensityModel.hit_rate, carried per tensor)
        d_p, d_q = dens_params[0, 1], dens_params[1, 1]
    else:
        d_p, d_q = densities[0], densities[1]
    sg_invalid = (skips & ((lead_p & ~p_comp) | (lead_q & ~q_comp))
                  ).any(dim=1)
    sk_or_g = skips | gates
    frac_e_p = torch.where(fol_p & sk_or_g, d_q, one)
    frac_e_q = torch.where(fol_q & sk_or_g, d_p, one)
    frac_t_p = torch.where(fol_p & skips, d_q, one)
    frac_t_q = torch.where(fol_q & skips, d_p, one)
    cyc_frac = torch.where((skips & lead_p).any(dim=1), d_p, one) * \
        torch.where((skips & lead_q).any(dim=1), d_q, one)
    e_frac = torch.where((sk_or_g & lead_p).any(dim=1), d_p, one) * \
        torch.where((sk_or_g & lead_q).any(dim=1), d_q, one)

    # ---- traffic ----
    total_z = (full_elems * z_onehot).sum()
    ones_b = bounds.new_ones(B)
    fe_rows, ft_rows = [], []
    for e in range(NE):
        si = tt.edge_site[e]
        if si is None:
            fe_rows.append(torch.stack([ones_b, ones_b, ones_b], dim=1))
            ft_rows.append(fe_rows[-1])
        else:
            fe_rows.append(torch.stack(
                [frac_e_p[:, si], frac_e_q[:, si], ones_b], dim=1))
            ft_rows.append(torch.stack(
                [frac_t_p[:, si], frac_t_q[:, si], ones_b], dim=1))
    fe = torch.stack(fe_rows, dim=1)                            # (B, NE, 3)
    ft = torch.stack(ft_rows, dim=1)
    f_rmw = torch.maximum(2.0 * fills - total_z, total_z)
    fills_adj = torch.where(z_onehot[None, None, :] > 0.5, f_rmw, fills)

    if tt.uniform_words:
        # default-width topology: the global width as a constant
        byt = fills_adj * wb * ratios[:, None, :]               # (B, NE, 3)
        tile_bytes = (tiles * wb * ratios[:, None, :]).sum(dim=2)  # (B, NE)
    else:
        # per-edge widths from the param vector: data bytes scale with
        # the width, metadata bits do not, so the compression ratio is
        # recomputed per edge (edge s fills store s+1, whose width also
        # prices that store's occupancy)
        wbs = plat[list(tt.word_idx)]                           # (NE,)
        full_wb = full_elems[None, :] * wbs[:, None]            # (NE, 3)
        data_be = torch.where(
            compressed[:, None, :],
            full_elems[None, :] * densities[None, :] * wbs[:, None],
            full_wb)                                            # (B, NE, 3)
        ratios_e = (data_be + meta_bits[:, None, :] / 8.0) / \
            torch.clamp(full_wb, min=1.0)
        byt = fills_adj * wbs[:, None] * ratios_e
        tile_bytes = (tiles * wbs[:, None] * ratios_e).sum(dim=2)
    tr_e = (byt * fe).sum(dim=2)                                # (B, NE)
    tr_t = (byt * ft).sum(dim=2)

    # ---- validity, energy, latency (param-vector driven) ----
    invalid = fmt_invalid | sg_invalid
    for fan, pi in zip(fanouts, tt.fanout_idx):
        invalid = invalid | (fan > plat[pi])
    for e, pi in tt.cap_checks:
        invalid = invalid | (tile_bytes[:, e] > plat[pi])

    # left-associated sums/products: the float32 evaluation order of the
    # reference evaluator
    energy = None
    for e in range(NE):
        comps_e = [plat[i] for i in tt.energy_idx[e]]
        e_edge = comps_e[0]
        for c in comps_e[1:]:
            e_edge = e_edge + c
        term = tr_e[:, e] * e_edge
        energy = term if energy is None else energy + term
    energy = energy + total_macs * e_frac * plat[tt.mac_idx]
    fan_prod = fanouts[0] if fanouts else ones_b
    for fan in fanouts[1:]:
        fan_prod = fan_prod * fan
    cycles = (total_macs / fan_prod) * cyc_frac
    for e, pi in tt.bw_checks:
        cycles = torch.maximum(cycles, tr_t[:, e] / plat[pi])
    valid = ~invalid
    big = torch.full((), float("inf"), dtype=f32, device=bounds.device)
    return (valid, torch.where(valid, energy, big),
            torch.where(valid, cycles, big))


# ------------------------------------------------------------ evaluators


def np_consts(spec: GenomeSpec, arch: ArchSpec, n_pad: int
              ) -> Tuple[np.ndarray, ...]:
    """The evaluator's workload/arch constants as a nine-tuple of numpy
    arrays: primes, prime_dim, relevance, densities, full_elems,
    total_macs, z_onehot, param vector, per-tensor density rows — the
    same tuple, in the same order and dtypes, as the JAX package's
    ``JaxCostModel._np_consts``."""
    wl = spec.workload
    primes = np.ones(n_pad, dtype=np.float32)
    prime_dim = np.zeros(n_pad, dtype=np.int32)
    dim_idx = {dim: i for i, dim in enumerate(wl.dim_order)}
    for i, (dd, p) in enumerate(spec.primes):
        primes[i] = p
        prime_dim[i] = dim_idx[dd]
    return (
        primes,
        prime_dim,
        np.asarray([[dim in t.dims for dim in wl.dim_order]
                    for t in wl.tensors], bool),
        np.asarray([wl.density_of(t.name) for t in wl.tensors], np.float32),
        np.asarray([t.size(wl.dim_sizes) for t in wl.tensors], np.float32),
        np.float32(wl.macs),
        np.asarray([1.0 if t.is_output else 0.0 for t in wl.tensors],
                   np.float32),
        arch.param_vector(),
        # per-tensor density rows [code, hit, family params..]
        np.asarray([density_lib.param_row(wl.density_model_of(t.name))
                    for t in wl.tensors], np.float32))


class TorchCostModel:
    """Batch evaluator bound to one (workload, arch/platform) pair and one
    device.  Instances with the same (ndims, prime bucket, topology,
    density mode) run the same tensor program — same-topology platforms
    (e.g. the paper's edge/mobile/cloud) differ only in the parameter
    vector.

    ``n_pad`` widens the prime axis beyond the workload's natural bucket so
    a group of concurrent searches over different workloads can be forced
    onto ONE signature; the padding primes are 1.0 and are numerically
    inert.

    ``structured`` likewise promotes an all-uniform workload onto the
    structured-density variant (its Uniform models become family rows) so
    a mixed uniform/banded/N:M fleet shares one signature; ``None`` picks
    the workload's natural mode.

    ``device=None`` means the GPU and raises where there is none; pass
    ``device="cpu"`` to run on the CPU on purpose."""

    def __init__(self, spec: GenomeSpec,
                 platform: Union[str, Platform, ArchSpec],
                 n_pad: Optional[int] = None,
                 structured: Optional[bool] = None,
                 device: DeviceLike = None,
                 _consts: Optional[Sequence[np.ndarray]] = None):
        self.device = resolve_device(device)
        self.spec = spec
        self.arch = as_arch(platform)
        if self.arch.topology != spec.arch.topology:
            raise ValueError(
                f"GenomeSpec was built for arch {spec.arch.name!r} but "
                f"the evaluator targets {self.arch.name!r} with a "
                f"different topology")
        wl = spec.workload
        self.d = wl.ndims
        self.n_primes = spec.n_primes
        self.n_pad = _bucket(max(self.n_primes, 1, int(n_pad or 0)))
        natural_structured = wl.structured_density
        if structured is None:
            structured = natural_structured
        elif not structured and natural_structured:
            raise ValueError(
                f"workload {wl.name!r} declares structured density "
                f"models; it cannot run on the uniform evaluator")
        self.structured = bool(structured)
        self.dens_key = "u" if not self.structured else \
            "s:" + density_lib.registry_fingerprint()

        if _consts is None:
            _consts = np_consts(spec, self.arch, self.n_pad)
        self._np_consts = tuple(np.asarray(c) for c in _consts)
        if len(self._np_consts) != 9 or \
                self._np_consts[0].shape != (self.n_pad,):
            raise ValueError(
                f"evaluator constants do not fit this spec: expected a "
                f"nine-tuple with {self.n_pad} primes")
        dtypes = (torch.float32, torch.int64, torch.bool) + \
            (torch.float32,) * 6
        self._consts = tuple(
            torch.as_tensor(c, device=self.device).to(dt)
            for c, dt in zip(self._np_consts, dtypes))

        self._tt = _topo_tables(self.arch.topology)
        self._tb = _device_tables(self.d, self.arch.topology, self.device)
        s = spec.segments
        self._sl_perm = (s["perm"].start, s["perm"].stop)
        self._sl_til = (s["tiling"].start, s["tiling"].stop)
        self._sl_fmt = [(s[f"fmt_{t.name}"].start, s[f"fmt_{t.name}"].stop)
                        for t in wl.tensors]
        self._sl_sg = (s["sg"].start, s["sg"].stop)

    @classmethod
    def from_numpy_consts(cls, spec: GenomeSpec,
                          platform: Union[str, Platform, ArchSpec],
                          consts: Sequence[np.ndarray],
                          n_pad: Optional[int] = None,
                          structured: Optional[bool] = None,
                          device: DeviceLike = None) -> "TorchCostModel":
        """Build an evaluator from a ready nine-tuple of numpy constants
        (see :func:`np_consts`) — e.g. the JAX package's
        ``JaxCostModel._np_consts`` — instead of deriving them."""
        return cls(spec, platform, n_pad=n_pad, structured=structured,
                   device=device, _consts=consts)

    @property
    def signature(self) -> Tuple[int, int, str, str]:
        """The (ndims, prime-bucket, topology, density-key) signature."""
        return (self.d, self.n_pad, self.arch.topology.fingerprint,
                self.dens_key)

    def _prepare(self, genomes: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """Slice a (B, L) int64 genome batch on the device into the
        evaluator's (perm, tiling, fmt, sg) inputs, padding the prime axis
        to its bucket.  For one signature these tensors have identical
        trailing shapes across workloads."""
        n = genomes.shape[0]
        perm = genomes[:, self._sl_perm[0]:self._sl_perm[1]]
        til = genomes[:, self._sl_til[0]:self._sl_til[1]]
        if self.n_pad != self.n_primes:
            til = torch.cat(
                [til, til.new_zeros((n, self.n_pad - self.n_primes))], dim=1)
        fmt = torch.stack([genomes[:, a:b] for a, b in self._sl_fmt], dim=1)
        sg = genomes[:, self._sl_sg[0]:self._sl_sg[1]]
        return perm, til, fmt, sg

    def eval_device(self, genomes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Evaluate a (B, L) integer genome tensor that already lives on
        this model's device; returns device tensors ``(valid, energy_pj,
        cycles)`` without synchronising."""
        with torch.no_grad():
            return eval_batch(self._tt, self._tb, self.structured,
                              *self._prepare(genomes.long()), *self._consts)

    def __call__(self, genomes) -> Dict[str, np.ndarray]:
        """genomes: (B, L) ints -> dict of (B,) numpy arrays.  No batch
        padding: eager PyTorch has no compiled shapes to reuse."""
        g = torch.from_numpy(
            np.ascontiguousarray(np.asarray(genomes, dtype=np.int32)))
        _count_dispatch()
        valid, energy, cycles = self.eval_device(g.to(self.device))
        host = torch.stack([valid.to(torch.float32), energy, cycles]
                           ).cpu().numpy()
        return _canonical(dict(valid=host[0] > 0.5, energy_pj=host[1],
                               cycles=host[2]))


def _canonical(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Derive ``edp`` and ``log10_edp`` in numpy from the device's float32
    cycles/energy, so every dispatch path — this one and those later
    slices add — gives bit-identical derived outputs for the same rows."""
    cycles = out["cycles"]
    energy = out["energy_pj"]
    with np.errstate(over="ignore"):
        out["edp"] = cycles * energy
        out["log10_edp"] = (np.log10(np.maximum(cycles, 1e-30)) +
                            np.log10(np.maximum(energy, 1e-30))
                            ).astype(cycles.dtype)
    return out
