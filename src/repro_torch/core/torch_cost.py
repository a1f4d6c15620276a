"""PyTorch batch evaluator for the SparseMap cost model, generalized over
a declared :class:`repro_torch.core.arch.ArchSpec`.

A batched float32 re-implementation of :mod:`repro_torch.core.cost_model`
that evaluates a whole *population* of genomes in one call on one device.
The numpy implementation is the exact float64 oracle; this one is held to
it at ``|dlog10_edp| <= 2e-3 * max(|log10_edp|, 1)`` with validity equal
outside a 5e-3 relative capacity margin (tests/test_torch_cost.py).  It is
the counterpart of the JAX package's ``jax_cost`` module, and one row
evaluator (:func:`eval_batch`, workload constants with a leading row axis)
serves its three dispatch paths:

* the broadcast call ``TorchCostModel(genomes)`` — one workload, its
  constants a single row broadcast over the batch;
* :func:`eval_stacked` — same-signature batches of many workloads and
  platforms concatenated into one padded mega-batch, each row given its
  workload's constants by a row-to-task index (``search.MultiSearch``);
* :func:`run_segments` — k ES generations of T same-shape tasks advanced
  on the device (selection, crossover, mutation, evaluation of the T·C
  children) with no host sync inside the segment, populations carried on
  the device from one segment to the next.

Because every row runs the same per-row arithmetic whatever batch it sits
in, the three paths give bit-identical results for the same rows; the one
operation whose CPU result depended on a row's position (float32 ``pow``,
vectorised body vs scalar tail) is evaluated in float64 (:func:`_pow`).

Several devices (the reference's ``shard_map`` over a 1-D mesh): a
:class:`SearchMesh` lists devices, and :func:`eval_stacked` gives each one
a contiguous block of the padded rows, :func:`run_segments` a contiguous
block of tasks.  It is one process and one host thread over a list of
devices, with no process group and no collective: each shard is
independent, and the fleet's host state (``search.MultiSearch``) stays
whole.  A shard runs on its device's twin of each model (the same numpy
constants uploaded there once), and its results are those of the
unsharded call, bit for bit, since a row's result does not depend on
where it sits.

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

Genome rows reach the evaluator in the padded layout of
``es_ops.PaddedLayout`` (``[perm | tiling(n_pad) | fmt | sg]``), the layout
every workload of one signature shares.  A dispatch makes one host→device
copy of its inputs (from pinned memory, so it does not wait for work
already queued) and one device→host copy of its outputs, queued behind
the work and waited for only when the caller reads them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import density as density_lib
from . import es_ops
from .accel import Platform
from .arch import ArchSpec, Topology, as_arch
from .encoding import GenomeSpec, all_permutations
from .es_ops import (DeviceSegment, PaddedLayout, SegmentResult,
                     segment_shape_key)
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


@dataclasses.dataclass(frozen=True)
class SearchMesh:
    """A 1-D mesh of devices for sharding a fleet: :func:`eval_stacked`
    splits its padded rows over ``devices`` in contiguous blocks,
    :func:`run_segments` its tasks.  A device may appear more than once
    (two shards on one card, or the CPU's shards in tests).  Built by
    ``repro_torch.launch.mesh.make_search_mesh`` or directly."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("rows",)

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a SearchMesh needs at least one device")
        if len(tuple(self.axis_names)) != 1:
            raise ValueError(f"a SearchMesh has one axis, got "
                             f"{self.axis_names!r}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))


def ndev(mesh: Optional[SearchMesh]) -> int:
    """Shards of a mesh; 1 for ``None`` (the unsharded path)."""
    return 1 if mesh is None else len(mesh.devices)


# Evaluator dispatches issued since the last reset — the per-round
# dispatch-count hook — and the seconds the host spent blocked waiting for
# device results.  One lock guards every module-level counter and cache so
# callers may dispatch from worker threads.
_DISPATCHES = 0
_HOST_BLOCKED_S = 0.0
_LOCK = threading.Lock()


def _count_dispatch() -> None:
    global _DISPATCHES
    with _LOCK:
        _DISPATCHES += 1


def dispatch_count() -> int:
    """Evaluator dispatches issued since the last reset: each broadcast
    ``TorchCostModel.__call__``, each :func:`eval_stacked` mega-batch and
    each :func:`run_segments` call is one."""
    with _LOCK:
        return _DISPATCHES


def reset_dispatch_count() -> None:
    global _DISPATCHES
    with _LOCK:
        _DISPATCHES = 0


def _time_block(fn: Callable):
    """Run a thunk that waits for device results, charging its wall clock
    to the host-blocked accumulator."""
    global _HOST_BLOCKED_S
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    with _LOCK:
        _HOST_BLOCKED_S += dt
    return out


def host_blocked_s() -> float:
    """Seconds the host spent blocked waiting for device results since the
    last reset."""
    with _LOCK:
        return _HOST_BLOCKED_S


def reset_host_blocked_s() -> None:
    global _HOST_BLOCKED_S
    with _LOCK:
        _HOST_BLOCKED_S = 0.0


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


def _pow(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """float32 ``base ** exp``, computed in float64 and rounded once.

    On the CPU, torch's float32 ``pow`` takes a vectorised routine for the
    body of a buffer and the scalar one for its tail, and the two differ
    by an ulp on some inputs, so a row's result would depend on where it
    sits in the batch.  Rounded from float64 the result no longer depends
    on its position (nor, in practice, on the routine), which is what
    makes the broadcast, stacked and segment paths bit-identical."""
    return torch.pow(base.double(), exp.double()).float()


def _occ_uniform(row, e):
    return 1.0 - _pow(1.0 - row[2], torch.clamp(e, min=1.0))


def _occ_banded(row, e):
    cov = torch.clamp(row[3], min=1e-30)
    d_in = torch.clamp(row[2] / cov, 0.0, 1.0)
    return cov * (1.0 - _pow(1.0 - d_in, torch.clamp(e, min=1.0)))


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
    """The row cost evaluator on a ``(B, ...)`` batch.

    ``perm_genes (B, NL)``, ``assign (B, n_pad)``, ``fmt_genes (B, 3,
    MAX_FMT_GENES)`` and ``sg (B, n_sites)`` are int64.  The nine workload
    constants carry a leading row axis of length R: R == 1 broadcasts one
    workload over the batch, R == B gives every row its own workload and
    platform (the stacked and segment paths).  Per row they are
    ``primes (n_pad,)`` float32, ``prime_dim (n_pad,)`` int64,
    ``relevance (3, d)`` bool, ``densities``, ``full_elems`` and
    ``z_onehot (3,)``, ``total_macs ()``, ``plat (P,)`` and
    ``dens_params (3, C)`` float32.  Returns ``(valid, energy_pj,
    cycles)``, each ``(B,)``, energy and cycles ``inf`` on invalid rows."""
    NL, NE = tt.n_levels, tt.n_edges
    d = tb.dim_ids.shape[0]
    B = perm_genes.shape[0]
    wb = float(WORD_BYTES)
    f32 = torch.float32

    # ---- tiling factors (B, NL, d) ----
    lvl_eq = assign[:, None, :] == tb.level_ids[None, :, None]  # (B,NL,np)
    dim_eq = prime_dim[:, None, :] == tb.dim_ids[None, :, None]  # (R,d,np)
    mask = lvl_eq[:, :, None, :] & dim_eq[:, None, :, :]        # (B,NL,d,np)
    one = primes.new_ones(())
    factors = torch.where(mask, primes[:, None, None, :], one
                          ).prod(dim=-1)                        # (B, NL, d)

    # ---- flattened loops (B, nl) ----
    loop_dims = tb.perm_table[perm_genes]                       # (B, NL, d)
    dims_flat = loop_dims.reshape(B, NL * d)
    bounds = factors.reshape(B, NL * d).gather(
        1, tb.lvl_slot[None, :] + dims_flat)
    spatial_flat = tb.spatial_flat[None, :]                     # (1, nl)

    fanouts = [factors[:, lvl, :].prod(dim=-1)
               for lvl in tt.spatial_levels]                    # each (B,)
    rel_flat = torch.gather(relevance.expand(B, -1, -1), 2,
                            dims_flat[:, None, :].expand(-1, 3, -1))
    transparent = bounds <= 1.0                                 # rel (B,3,nl)

    # tile extents per (store edge, tensor): the product of the factors
    # of the tensor's dims over the levels inside the store
    tile_mask = (tb.store_inner_lv[None, :, None, :, None]
                 & relevance[:, None, :, None, :])              # (R,NE,3,NL,d)
    tiles = torch.where(tile_mask, factors[:, None, None], one
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
                mult = mult * torch.clamp(s_irrel / plat[:, fi], min=1.0)
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
    dens = densities[:, :, None]                                # (R, 3, 1)
    sub_bounds = torch.where(is_sub, bnd3, one)
    elems_below = _rev_cumprod(sub_bounds, 2) / sub_bounds
    if structured:
        row = dens_params.permute(2, 0, 1)[:, :, :, None]       # (C,R,3,1)
        occ = _occ_structured(row, elems_below)
    else:
        # all-uniform: the literal uniform-random occupancy expression
        occ = 1.0 - _pow(1.0 - dens, torch.clamp(elems_below, min=1.0))
    kept = sub_bounds * occ
    full = full_elems[:, :, None]                               # (R, 3, 1)

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
    full2, dens2 = full_elems, densities                        # (R, 3)
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
        d_p, d_q = dens_params[:, 0, 1], dens_params[:, 1, 1]   # (R,)
    else:
        d_p, d_q = densities[:, 0], densities[:, 1]
    sg_invalid = (skips & ((lead_p & ~p_comp) | (lead_q & ~q_comp))
                  ).any(dim=1)
    sk_or_g = skips | gates
    frac_e_p = torch.where(fol_p & sk_or_g, d_q[:, None], one)
    frac_e_q = torch.where(fol_q & sk_or_g, d_p[:, None], one)
    frac_t_p = torch.where(fol_p & skips, d_q[:, None], one)
    frac_t_q = torch.where(fol_q & skips, d_p[:, None], one)
    cyc_frac = torch.where((skips & lead_p).any(dim=1), d_p, one) * \
        torch.where((skips & lead_q).any(dim=1), d_q, one)
    e_frac = torch.where((sk_or_g & lead_p).any(dim=1), d_p, one) * \
        torch.where((sk_or_g & lead_q).any(dim=1), d_q, one)

    # ---- traffic ----
    fz = full_elems * z_onehot
    total_z = (fz[:, 0] + fz[:, 1] + fz[:, 2])[:, None, None]  # (R, 1, 1)
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
    fills_adj = torch.where(z_onehot[:, None, :] > 0.5, f_rmw, fills)

    if tt.uniform_words:
        # default-width topology: the global width as a constant
        byt = fills_adj * wb * ratios[:, None, :]               # (B, NE, 3)
        tile_bytes = (tiles * wb * ratios[:, None, :]).sum(dim=2)  # (B, NE)
    else:
        # per-edge widths from the param vector: data bytes scale with
        # the width, metadata bits do not, so the compression ratio is
        # recomputed per edge (edge s fills store s+1, whose width also
        # prices that store's occupancy)
        # a slice, not a list: indexing a device tensor by a Python list
        # copies the index up from pageable memory, a host sync
        w0 = tt.word_idx[0]
        wbs = plat[:, w0:w0 + NE][:, :, None]                   # (R, NE, 1)
        full_wb = full_elems[:, None, :] * wbs                  # (R, NE, 3)
        data_be = torch.where(
            compressed[:, None, :],
            full_elems[:, None, :] * densities[:, None, :] * wbs,
            full_wb)                                            # (B, NE, 3)
        ratios_e = (data_be + meta_bits[:, None, :] / 8.0) / \
            torch.clamp(full_wb, min=1.0)
        byt = fills_adj * wbs * ratios_e
        tile_bytes = (tiles * wbs * ratios_e).sum(dim=2)
    tr_e = (byt * fe).sum(dim=2)                                # (B, NE)
    tr_t = (byt * ft).sum(dim=2)

    # ---- validity, energy, latency (param-vector driven) ----
    invalid = fmt_invalid | sg_invalid
    for fan, pi in zip(fanouts, tt.fanout_idx):
        invalid = invalid | (fan > plat[:, pi])
    for e, pi in tt.cap_checks:
        invalid = invalid | (tile_bytes[:, e] > plat[:, pi])

    # left-associated sums/products: the float32 evaluation order of the
    # reference evaluator
    energy = None
    for e in range(NE):
        comps_e = [plat[:, i] for i in tt.energy_idx[e]]
        e_edge = comps_e[0]
        for c in comps_e[1:]:
            e_edge = e_edge + c
        term = tr_e[:, e] * e_edge
        energy = term if energy is None else energy + term
    energy = energy + total_macs * e_frac * plat[:, tt.mac_idx]
    fan_prod = fanouts[0] if fanouts else ones_b
    for fan in fanouts[1:]:
        fan_prod = fan_prod * fan
    cycles = (total_macs / fan_prod) * cyc_frac
    for e, pi in tt.bw_checks:
        cycles = torch.maximum(cycles, tr_t[:, e] / plat[:, pi])
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
    vector — so their rows can share one dispatch (:func:`eval_stacked`,
    :func:`run_segments`).

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
        # one row of each constant (R == 1 in eval_batch): the broadcast
        # call uses them as they are, the stacked paths index them
        self._consts = tuple(
            torch.as_tensor(c[None], device=self.device).to(dt)
            for c, dt in zip(self._np_consts, dtypes))

        self._tt = _topo_tables(self.arch.topology)
        self._tb = _device_tables(self.d, self.arch.topology, self.device)
        #: the signature's shared genome layout, in which rows reach the
        #: evaluator
        self.layout = PaddedLayout(spec, self.n_pad)
        self._twins: Dict[torch.device, "TorchCostModel"] = {}

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

    def twin(self, device: torch.device) -> "TorchCostModel":
        """This evaluator on ``device``: itself where it lives there,
        else a copy made once from the same numpy constants and kept — a
        mesh shard's model, whose tables and constants all sit on the
        shard's device."""
        if device == self.device:
            return self
        with _LOCK:
            tw = self._twins.get(device)
        if tw is None:
            tw = TorchCostModel(self.spec, self.arch, n_pad=self.n_pad,
                                structured=self.structured, device=device,
                                _consts=self._np_consts)
            with _LOCK:
                tw = self._twins.setdefault(device, tw)
        return tw

    def eval_device(self, rows: torch.Tensor,
                    consts: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Evaluate ``(B, Lp)`` int64 genome rows in this signature's
        padded layout (:attr:`layout`) that already live on this model's
        device; returns device tensors ``(valid, energy_pj, cycles)``
        without synchronising.  ``consts`` are per-row constants (see
        :func:`eval_batch`); by default this model's, broadcast."""
        NL, F3 = self._tt.n_levels, 3 * MAX_FMT_GENES
        f0 = NL + self.n_pad
        with torch.no_grad():
            return eval_batch(
                self._tt, self._tb, self.structured, rows[:, :NL],
                rows[:, NL:f0],
                rows[:, f0:f0 + F3].reshape(-1, 3, MAX_FMT_GENES),
                rows[:, f0 + F3:],
                *(self._consts if consts is None else consts))

    def __call__(self, genomes) -> Dict[str, np.ndarray]:
        """genomes: (B, L) ints -> dict of (B,) numpy arrays.  No batch
        padding: eager PyTorch has no compiled shapes to reuse.  The rows
        go up as they are, in int32, and are padded to the signature's
        layout on the device: at the largest batches the host's copies,
        not the device, would otherwise set the call's time."""
        (raw,) = _upload([np.asarray(genomes)], self.device, np.int32)
        _count_dispatch()
        valid, energy, cycles = self.eval_device(
            self.layout.pad_rows(raw.long()))
        ((host,),) = _wait_all([_Fetch([torch.stack(
            [valid.to(torch.float32), energy, cycles])])])
        return _canonical(dict(valid=host[0] > 0.5, energy_pj=host[1],
                               cycles=host[2]))

    def run_segment(self, seg: DeviceSegment) -> SegmentResult:
        """Execute one device-resident ES segment against this model (the
        single-task case of :func:`run_segments`).  ``_drive`` and other
        single-evaluator drivers discover this method by name — evaluators
        without it receive ``None`` and the generator replays the segment
        on the host."""
        return run_segments([self], [seg])[0]


def _canonical(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Derive ``edp`` and ``log10_edp`` in numpy from the device's float32
    cycles/energy, so every dispatch path gives bit-identical derived
    outputs for the same rows."""
    cycles = out["cycles"]
    energy = out["energy_pj"]
    with np.errstate(over="ignore"):
        out["edp"] = cycles * energy
        out["log10_edp"] = (np.log10(np.maximum(cycles, 1e-30)) +
                            np.log10(np.maximum(energy, 1e-30))
                            ).astype(cycles.dtype)
    return out


# --------------------------------------------------- host <-> device


def _upload(arrays: Sequence[np.ndarray], device: torch.device,
            dtype=np.int64) -> List[torch.Tensor]:
    """Copy host arrays to ``device`` in ONE transfer of ``dtype`` and
    return a view of it per array, in the array's shape.  On the GPU the
    copy goes from pinned memory without blocking: a pageable copy would
    wait for every kernel already queued, which is the host sync a
    pipelined fleet must not take.  The arrays are gathered by one host
    copy, straight into that buffer."""
    arrays = [np.asarray(a) for a in arrays]
    host = torch.empty(sum(a.size for a in arrays),
                       dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=device.type == "cuda")
    np.concatenate([a.reshape(-1) for a in arrays], out=host.numpy())
    t = host.to(device, non_blocking=True)
    out, off = [], 0
    for a in arrays:
        out.append(t[off:off + a.size].view(a.shape))
        off += a.size
    return out


class _Fetch:
    """Device tensors (all on one device) on their way to the host.  On
    the GPU each is copied into pinned host memory by a copy queued now,
    on that device's stream behind the work that computes it, and an
    event recorded there marks the end of the copies; :func:`_wait_all`
    blocks on that event alone, so work queued after the copies — the
    next round — keeps running."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._event = None
        if tensors[0].is_cuda:
            with torch.cuda.device(tensors[0].device):
                self._host = []
                for t in tensors:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    self._host.append(h)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = list(tensors)

    def _ready(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def _wait_all(fetches: Sequence[_Fetch]) -> List[List[np.ndarray]]:
    """Wait for every fetch of a dispatch (one per shard), charging the
    wait to :func:`host_blocked_s` once."""
    return _time_block(lambda: [f._ready() for f in fetches])


# ------------------------------------------------- stacked mega-batch


def _pad_batch(n: int) -> int:
    """Batch-axis padding of the stacked path: next power of two, floor
    64 — ES populations and the baselines' odd native batch sizes (48,
    50, 64) all land on the same few shapes (the reference's rule, kept
    so the fleet's pad watermarks match it field for field and a later
    CUDA-graph capture has few shapes to capture)."""
    return max(64, 1 << max(0, (n - 1)).bit_length())


# The stacked constants of a same-signature group: each model's constants
# stacked into (T, ...) device tensors and given to every row through a
# row-to-task index.  One slot per (signature, device, kind, shard), keyed
# by CONTENT (workload cache_key + arch per model, never id(), so a
# recycled object can't alias a stale entry) plus the row counts: a steady
# fleet builds them once, not every round.  The shard index keeps two
# shards on one device from evicting each other's entry every round.
_STACK_CONSTS: Dict[Tuple, Tuple] = {}
_STACK_PREP_HITS = 0
_STACK_PREP_MISSES = 0


def stack_prep_counts() -> Tuple[int, int]:
    """(cache hits, cache misses) of the stacked-constants cache."""
    with _LOCK:
        return _STACK_PREP_HITS, _STACK_PREP_MISSES


def reset_stack_prep_counts() -> None:
    global _STACK_PREP_HITS, _STACK_PREP_MISSES
    with _LOCK:
        _STACK_PREP_HITS = _STACK_PREP_MISSES = 0


def clear_stack_cache() -> None:
    """Drop the cached stacked constants and zero their counters."""
    with _LOCK:
        _STACK_CONSTS.clear()
    reset_stack_prep_counts()


def _stacked_consts(models: Sequence[TorchCostModel], sizes: Sequence[int],
                    padded: int, kind: str, shard: int = 0
                    ) -> Tuple[Tuple[torch.Tensor, ...],
                               Tuple[torch.Tensor, ...]]:
    """``(per-task, per-row)`` constants of a same-signature group on its
    models' device: model ``t`` owns ``sizes[t]`` consecutive rows, the
    ``padded - sum(sizes)`` padding rows take model 0's constants."""
    global _STACK_PREP_HITS, _STACK_PREP_MISSES
    m0 = models[0]
    slot = m0.signature + (str(m0.device), kind, int(shard))
    key = (tuple((m.spec.workload.cache_key(), m.arch) for m in models),
           tuple(int(n) for n in sizes), int(padded))
    with _LOCK:
        hit = _STACK_CONSTS.get(slot)
        if hit is not None and hit[0] == key:
            _STACK_PREP_HITS += 1
            return hit[1], hit[2]
        _STACK_PREP_MISSES += 1
    task = tuple(torch.cat([m._consts[j] for m in models])
                 for j in range(len(m0._consts)))
    idx = np.zeros(padded, dtype=np.int64)
    idx[:sum(sizes)] = np.repeat(np.arange(len(models)), sizes)
    (idx_t,) = _upload([idx], m0.device)
    rows = tuple(c.index_select(0, idx_t) for c in task)
    with _LOCK:
        _STACK_CONSTS[slot] = (key, task, rows)
    return task, rows


def _check_group(models: Sequence[TorchCostModel], what: str) -> None:
    sig = models[0].signature
    if any(m.signature != sig for m in models):
        raise ValueError(
            f"{what} needs one shared signature, got "
            f"{sorted({m.signature for m in models})}")
    if any(m.device != models[0].device for m in models):
        raise ValueError(f"{what} needs its models on one device")


class StackedPending:
    """Handle to an in-flight ``eval_stacked(..., defer=True)`` dispatch:
    the devices are computing when this is constructed, and
    ``finalize()`` waits for every shard's results at once (charged to
    :func:`host_blocked_s`), joins the shards' real rows in order,
    canonicalizes, and slices the mega-batch back per task.
    ``finalize`` is idempotent."""

    def __init__(self, fetches: Sequence[_Fetch], real: Sequence[int],
                 sizes: Sequence[int]):
        self._fetches = list(fetches)
        self._real = list(real)
        self._sizes = list(sizes)
        self._sliced: Optional[List[Dict[str, np.ndarray]]] = None

    def finalize(self) -> List[Dict[str, np.ndarray]]:
        if self._sliced is None:
            hosts = _wait_all(self._fetches)
            host = np.concatenate([h[0][:, :r] for h, r in
                                   zip(hosts, self._real)], axis=1)
            flat = _canonical(dict(valid=host[0] > 0.5, energy_pj=host[1],
                                   cycles=host[2]))
            sliced: List[Dict[str, np.ndarray]] = []
            off = 0
            for n in self._sizes:
                sliced.append({k: v[off:off + n] for k, v in flat.items()})
                off += n
            self._sliced = sliced
            self._fetches = None
        return self._sliced


def _stacked_block(models: Sequence[TorchCostModel],
                   batches: Sequence[np.ndarray], rows: int,
                   shard: int) -> _Fetch:
    """Queue one device's mega-batch — ``batches`` laid out in order on
    ``rows`` rows of its models' device, padding rows zero — and the copy
    of its ``(3, rows)`` results."""
    dev = models[0].device
    sizes = [len(b) for b in batches]
    # as in __call__: the rows go up unpadded in int32 and are laid out on
    # the device
    raws = _upload(batches, dev, np.int32)
    rows_t = torch.zeros((rows, models[0].layout.Lp), dtype=torch.int64,
                         device=dev)
    off = 0
    for m, raw, n in zip(models, raws, sizes):
        m.layout.pad_rows(raw, out=rows_t[off:off + n])
        off += n
    _, consts = _stacked_consts(models, sizes, rows, "stacked", shard)
    valid, energy, cycles = models[0].eval_device(rows_t, consts)
    return _Fetch([torch.stack([valid.to(torch.float32), energy, cycles])])


def eval_stacked(models: Sequence[TorchCostModel],
                 batches: Sequence[np.ndarray],
                 pad_floor: int = 0, defer: bool = False,
                 mesh: Optional[SearchMesh] = None):
    """Evaluate several (model, genome-batch) pairs sharing one signature
    in a SINGLE dispatch.

    The batches go to the device in one int32 copy, where they are padded
    to the signature's genome layout and concatenated along the batch
    axis, every row
    is given its model's workload/platform constants by a row-to-task
    index (:func:`stack_prep_counts` counts the cache of those), and the
    row evaluator runs once on the mega-batch, padded to the next power
    of two (floor 64) or ``pad_floor`` if larger — drivers pass the
    watermark of earlier rounds (padding rows are zero genomes, sliced
    off).  Rows run the same per-row arithmetic as the broadcast call, so
    results are bit-identical to per-model calls.

    ``mesh`` (more than one shard) pads the rows further to a multiple of
    the shard count and gives shard ``i`` the ``i``-th contiguous block,
    evaluated on ``mesh.devices[i]`` by the models' twins there
    (:meth:`TorchCostModel.twin`); a block of padding rows alone is not
    evaluated.  Results are those of ``mesh=None``, bit for bit.

    ``defer=True`` returns a :class:`StackedPending` instead of the sliced
    list: the work and the copy of its results are queued, and nothing
    blocks until ``finalize()`` — the pipelined driver finalizes round N's
    group i while groups i+1.. compute.  Results are bit-identical to
    ``defer=False``."""
    if len(models) != len(batches):
        raise ValueError("models and batches must pair up")
    _check_group(models, "eval_stacked")
    sizes = [len(b) for b in batches]
    total = sum(sizes)
    padded = max(_pad_batch(total), int(pad_floor))
    n = ndev(mesh)
    if padded % n:
        padded = -(-padded // n) * n
    per = padded // n
    devices = mesh.devices if n > 1 else (models[0].device,)
    ends = np.cumsum([0] + sizes)
    _count_dispatch()
    fetches, real = [], []
    for i, dev in enumerate(devices):
        lo, hi = i * per, (i + 1) * per
        if lo >= total:
            break
        pick = [(m.twin(dev), np.asarray(b)[max(lo - a, 0):hi - a])
                for m, b, a, z in zip(models, batches, ends, ends[1:])
                if a < hi and z > lo]
        fetches.append(_stacked_block([m for m, _ in pick],
                                      [b for _, b in pick], per, i))
        real.append(min(hi, total) - lo)
    if not fetches:         # no rows at all: one block of padding
        fetches.append(_stacked_block([models[0]], [batches[0]], per, 0))
        real.append(0)
    pending = StackedPending(fetches, real, sizes)
    return pending if defer else pending.finalize()


# ------------------------------------------------ device-resident segments


def _direct_translate(kids: torch.Tensor, model: TorchCostModel,
                      primes: torch.Tensor, prime_dim: torch.Tensor,
                      scramble: torch.Tensor, dim_sizes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``DirectValueSpec.to_canonical`` on ``(T, C, Ld)`` direct-value rows
    at once: ``(canon (T, C, Lp), ok (T, C))``, ``canon`` in the padded
    layout.  Each task's primes (``(T, n_pad)``; padding primes 1.0) are
    placed greedily on the first level whose remaining factor they
    divide, in a loop over the padded prime axis; the factors are
    integral float32 values far inside the exact range, so products and
    ``remainder`` are exact and the row agrees with the numpy oracle.
    Rows with ``ok`` False are untranslatable (their ``canon`` is not
    meaningful)."""
    T, C, _ = kids.shape
    NL, d = model._tt.n_levels, model.d
    perm = scramble.gather(1, kids[:, :, :NL].reshape(T, C * NL)
                           ).reshape(T, C, NL)
    factors = kids[:, :, NL:NL + d * NL].reshape(T, C, d, NL).to(
        torch.float32)
    ok = (factors.prod(dim=3) == dim_sizes[:, None, :]).all(dim=2)
    remaining = factors
    levels = torch.arange(NL, device=kids.device)
    til = []
    for kk in range(model.n_pad):
        p = primes[:, kk, None, None, None]                    # (T,1,1,1)
        is_real = primes[:, kk, None] > 1.5                    # (T, 1)
        sel = prime_dim[:, kk, None, None, None].expand(T, C, 1, NL)
        rem = remaining.gather(2, sel)                         # (T,C,1,NL)
        can = (torch.remainder(rem, p) == 0) & (rem > 1.0)
        lvl = can.to(torch.int32).argmax(dim=3)                # (T, C, 1)
        hasl = can.any(dim=3)
        ok = ok & (hasl[..., 0] | ~is_real)
        upd = (levels == lvl[..., None]) & hasl[..., None] & \
            is_real[:, :, None, None]
        remaining = remaining.scatter(2, sel, torch.where(upd, rem / p, rem))
        til.append(torch.where(is_real & hasl[..., 0], lvl[..., 0], 0))
    canon = torch.cat([perm, torch.stack(til, dim=2),
                       kids[:, :, NL + d * NL:]], dim=2)
    return canon, ok


class _SegmentBlock:
    """One device's block of tasks in a :func:`run_segments` call: its
    plans, populations and constants uploaded to the models' device and
    its outputs allocated there; :meth:`step` queues one generation."""

    def __init__(self, models: Sequence[TorchCostModel],
                 segs: Sequence[DeviceSegment], shape_key: Tuple,
                 shard: int):
        B, k, self.n_parents, self.n_elite, _, kind, restart = shape_key
        self.direct = direct = kind == "direct"
        self.restart = restart
        self.m0 = models[0]
        dev = self.m0.device
        T = self.T = len(segs)
        C = self.C = int(np.asarray(segs[0].draws["ab"]).shape[1])
        lays = self.lays = [m.layout for m in models]

        # ---- host -> device: the integers in one copy, the floats in one
        def plan(key, pad=None):
            return np.stack([np.asarray(s.draws[key]) if pad is None or
                             direct else pad(lay)(np.asarray(s.draws[key]))
                             for s, lay in zip(segs, lays)])
        host_pop = [t for t, s in enumerate(segs) if s.carry is None]
        ints = [plan("ab"), plan("cuts", lambda lay: lay.pad_cut),
                plan("active"), plan("gene", lambda lay: lay.pad_index),
                plan("vals")]
        for t in host_pop:
            p = np.asarray(segs[t].pop, dtype=np.int64)
            ints.append(p if direct else lays[t].pad_rows(p))
        flts = [np.asarray(segs[t].edp, dtype=np.float32) for t in host_pop]
        if direct:
            ints.append(np.stack([s.aux["scramble"] for s in segs]))
            flts.append(np.stack([s.aux["dim_sizes"] for s in segs]))
        else:
            fixed = np.zeros((2, T, lays[0].Lp), dtype=np.int64)
            for t, (s, lay) in enumerate(zip(segs, lays)):
                if s.fixed_genes:
                    idx = lay.pad_index(np.asarray(list(s.fixed_genes),
                                                   dtype=np.int64))
                    fixed[0, t, idx] = 1
                    fixed[1, t, idx] = list(s.fixed_genes.values())
            ints.append(np.stack([lay.pad_vector(m.spec.gene_ub, 1)
                                  for m, lay in zip(models, lays)]))
            ints.append(fixed)
        if restart:
            ints.append(np.stack([lay.pad_rows(
                np.asarray(s.draws["fresh"], dtype=np.int64))
                for s, lay in zip(segs, lays)]))
            ints.append(np.asarray([s.state[1] for s in segs]))
            flts.append(np.asarray([s.state[0] for s in segs]))
        iu = iter(_upload(ints, dev))
        fu = iter(_upload(flts, dev, np.float32) if flts else [])
        self.ab, self.cuts, active, self.gene, self.vals = \
            (next(iu) for _ in range(5))
        self.active = active.bool()
        up_pop = {t: (next(iu), next(fu)) for t in host_pop}
        # a carry made on another device (its task sat in another shard
        # last round) moves here with one copy
        self.pop = torch.stack([up_pop[t][0] if t in up_pop else
                                s.carry[0].to(dev)
                                for t, s in enumerate(segs)])
        self.edp = torch.stack([up_pop[t][1] if t in up_pop else
                                s.carry[1].to(dev)
                                for t, s in enumerate(segs)])
        if direct:
            self.scramble, self.dim_sizes = next(iu), next(fu)
        else:
            self.ub_m1, fixed = next(iu) - 1, next(iu)
            self.fix_mask = fixed[0].bool()[:, None, :]
            self.fix_vals = fixed[1][:, None, :]
        if restart:
            self.fresh, self.since, self.best = next(iu), next(iu), next(fu)

        reps = 2 if restart else 1
        self.task_c, self.row_c = _stacked_consts(
            list(models) * reps, [C] * (T * reps), T * C * reps, "segment",
            shard)
        Lp = lays[0].Lp
        self.ys_kids = torch.empty((T, k, C, Lp), dtype=torch.int64,
                                   device=dev)
        self.ys = torch.empty((3, T, k, C), dtype=torch.float32, device=dev)
        if restart:
            self.ys_fresh = torch.empty((3, T, k, C), dtype=torch.float32,
                                        device=dev)
            self.ys_restarted = torch.empty((T, k), dtype=torch.bool,
                                            device=dev)
        self.big = torch.full((), float("inf"), dtype=torch.float32,
                              device=dev)

    def step(self, g: int) -> None:
        """Queue generation ``g`` of every task of the block."""
        T, C, m0 = self.T, self.C, self.m0
        n, Lp = T * C, self.lays[0].Lp
        pop, edp = self.pop, self.edp
        parents, elites, elite_edp = es_ops.select(pop, edp, self.n_parents,
                                                   self.n_elite)
        kids = es_ops.apply_crossover(parents, self.ab[:, g],
                                      self.cuts[:, g])
        kids = es_ops.apply_mutation(kids, self.active[:, g],
                                     self.gene[:, g], self.vals[:, g])
        if self.direct:
            # direct mutation draws are valid values by construction: no
            # clip, no fixed genes (as on the host)
            canon, ok = _direct_translate(kids, m0, self.task_c[0],
                                          self.task_c[1], self.scramble,
                                          self.dim_sizes)
            valid, energy, cycles = m0.eval_device(canon.reshape(n, Lp),
                                                   self.row_c)
            okf = ok.reshape(n)
            valid = valid & okf
            energy = torch.where(okf, energy, self.big)
            cycles = torch.where(okf, cycles, self.big)
            self.ys_kids[:, g] = torch.where(ok[:, :, None], canon, 0)
        else:
            kids = torch.minimum(kids.clamp(min=0), self.ub_m1[:, None, :])
            kids = torch.where(self.fix_mask, self.fix_vals, kids)
            self.ys_kids[:, g] = kids
            rows = kids.reshape(n, Lp)
            if self.restart:
                rows = torch.cat([rows, self.fresh[:, g].reshape(n, Lp)])
            valid, energy, cycles = m0.eval_device(rows, self.row_c)
        for i, v in enumerate((valid, energy, cycles)):
            self.ys[i, :, g] = v[:n].view(T, C)
        kedp = (cycles[:n] * energy[:n]).view(T, C)
        new_pop = torch.cat([elites, kids], dim=1)
        new_edp = torch.cat([elite_edp, kedp], dim=1)
        if self.restart:
            best, since, fresh = self.best, self.since, self.fresh[:, g]
            for i, v in enumerate((valid, energy, cycles)):
                self.ys_fresh[i, :, g] = v[n:].view(T, C)
            fedp = (cycles[n:] * energy[n:]).view(T, C)
            kbest = torch.minimum(best, kedp.min(dim=1).values)
            since = torch.where(kbest < best, 0, since + 1)
            do_r = since >= self.restart
            new_pop = torch.where(do_r[:, None, None],
                                  torch.cat([elites, fresh], dim=1), new_pop)
            new_edp = torch.where(do_r[:, None],
                                  torch.cat([elite_edp, fedp], dim=1),
                                  new_edp)
            self.best = torch.where(
                do_r, torch.minimum(kbest, fedp.min(dim=1).values), kbest)
            self.since = torch.where(do_r, 0, since)
            self.ys_restarted[:, g] = do_r
        self.pop, self.edp = new_pop, new_edp

    def outs(self) -> List[torch.Tensor]:
        outs = [self.pop, self.edp, self.ys_kids, self.ys]
        if self.restart:
            outs += [self.ys_fresh, self.ys_restarted, self.best, self.since]
        return outs


def run_segments(models: Sequence[TorchCostModel],
                 segs: Sequence[DeviceSegment],
                 defer: bool = False,
                 mesh: Optional[SearchMesh] = None) -> List[SegmentResult]:
    """Execute one DeviceSegment per model as ONE dispatch: the segments
    (which must share the models' signature and the segment shape key)
    stack along a task axis, and a Python loop over the ``k`` generations
    advances all ``T`` tasks on the device — stable-sort selection,
    crossover and mutation from the pre-drawn plans (``es_ops`` torch
    forms on ``(T, B, Lp)`` populations), clip and fixed genes, then the
    ``T·C`` children through the row evaluator with per-row constants;
    the selection fitness is the float32 product ``cycles * energy``, the
    same multiply ``_canonical`` does on the host.  Nothing inside the
    segment waits for the device: the plans go up in one copy (two with
    float inputs) before the loop, the outputs land in tensors allocated
    once per segment and come back in one queued copy after it.

    ``kind == "direct"`` segments (``standard_es``) carry direct-value
    populations and translate every generation's children to canonical
    rows inside the segment (:func:`_direct_translate`); untranslatable
    rows get fitness ``inf`` and canonical row 0.  ``restart > 0`` runs
    the stagnation-restart variant: ``seg.state`` (best-so-far, stagnant
    generations) rides along as device tensors, each generation's
    pre-drawn fresh block is always evaluated (with the children, in the
    same call) and adopted by a ``torch.where`` when the counter trips.

    ``mesh`` shards where the reference's does — more than one shard, a
    task count the shard count divides, no restart, not ``direct`` —
    giving shard ``i`` the ``i``-th contiguous block of tasks on
    ``mesh.devices[i]`` (the models' twins there), each block's plans up
    in its own copies; the one host thread queues generation g of every
    shard before generation g + 1 of any, so no device waits for another's
    whole segment.  Other calls run unsharded.  Results are those of
    ``mesh=None``, bit for bit.

    Pipelining: a segment carrying ``carry`` (the device ``(pop, edp)``
    of its previous result) starts from it, so the population never
    leaves the device between segments (a carry made on another device
    moves with one copy).  With ``defer=True`` the results hold a
    ``harvest`` thunk that waits for every shard's copy one round late
    (``SegmentResult.resolve``); ``carry`` is valid either way.  Restart
    results fill ``state`` at once (their generators harvest eagerly)."""
    if len(models) != len(segs):
        raise ValueError("models and segments must pair up")
    _check_group(models, "run_segments")
    shape_key = segment_shape_key(segs[0])
    if any(segment_shape_key(s) != shape_key for s in segs):
        raise ValueError("run_segments needs one shared segment shape")
    B, k, n_parents, n_elite, genes_per, kind, restart = shape_key
    direct = kind == "direct"
    if direct and restart:
        raise ValueError("direct segments do not support in-segment restart")
    T, n = len(segs), ndev(mesh)
    if n > 1 and T % n == 0 and not restart and not direct:
        per = T // n
        blocks = [([m.twin(dev) for m in models[i * per:(i + 1) * per]],
                   segs[i * per:(i + 1) * per])
                  for i, dev in enumerate(mesh.devices)]
    else:
        blocks = [(models, segs)]
    runs = [_SegmentBlock(ms, ss, shape_key, i)
            for i, (ms, ss) in enumerate(blocks)]
    _count_dispatch()
    with torch.no_grad():
        for g in range(k):
            for run in runs:
                run.step(g)
    fetches = [_Fetch(run.outs()) for run in runs]

    host: Dict[str, List[List[np.ndarray]]] = {}

    def materialize() -> List[List[np.ndarray]]:
        if "h" not in host:
            host["h"] = _wait_all(fetches)
        return host["h"]

    def make_harvest(i: int, t: int, lay: PaddedLayout):
        def harvest():
            h = materialize()[i]
            pf, ef, kids_h, ys_h = h[:4]
            gens = []
            for g in range(k):
                out = _canonical(dict(valid=ys_h[0, t, g] > 0.5,
                                      energy_pj=ys_h[1, t, g],
                                      cycles=ys_h[2, t, g]))
                if restart:
                    fr = h[4]
                    out["fresh"] = _canonical(dict(
                        valid=fr[0, t, g] > 0.5, energy_pj=fr[1, t, g],
                        cycles=fr[2, t, g]))
                    out["restarted"] = bool(h[5][t, g])
                gens.append((lay.unpad_rows(kids_h[t, g]), out))
            final = pf[t] if direct else lay.unpad_rows(pf[t])
            return gens, final.astype(np.int64), ef[t]
        return harvest

    results: List[SegmentResult] = []
    for i, run in enumerate(runs):
        for t, lay in enumerate(run.lays):
            r = SegmentResult(gens=None, final_pop=None, final_edp=None,
                              carry=(run.pop[t], run.edp[t]),
                              harvest=make_harvest(i, t, lay))
            if not defer:
                r.resolve()
            if restart:
                h = materialize()[i]
                r.state = (float(h[6][t]), int(h[7][t]))
            results.append(r)
    return results
