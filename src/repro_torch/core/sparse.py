"""Sparse strategy (SparseMap §II.C, §III.A.2, Figs. 5/6/13).

Two components:

* **Compression format** — a hierarchical combination of per-dimension 1-D
  formats over the *tiled sub-dimensions* of a tensor (Fig. 5).  Gene values:

      0 = U    uncompressed (dense positions)
      1 = B    bitmask: 1 bit per position
      2 = RLE  run length encoding: log2(L) bits per kept entry
      3 = CP   coordinate payload: log2(L) bits per kept entry
      4 = UOP  uncompressed offset pair: (L+1) offsets per fiber; must be
               combined with a compressed format below it (paper: "UOP needs
               to be used with other format")

* **Skipping/Gating (S/G)** — per storage/compute site (GLB=L2, PE buffer=L3,
  compute=C), one of 7 options (Fig. 6/13):

      0 = none
      1 = Gate P<-Q   (P processed only where Q nonzero; energy only)
      2 = Gate Q<-P
      3 = Gate P<->Q  (double-sided)
      4 = Skip P<-Q   (cycles AND energy)
      5 = Skip Q<-P
      6 = Skip P<->Q

The byte-accounting model follows Sparseloop's format taxonomy: a tensor
tile with dims (outer..inner per the mapping's tiled sub-dimensions) is a
fiber tree; level i has ``n_fibers(i)`` fibers of length ``L_i``; how
occupancy decays down the tree is supplied by the tensor's
:class:`~repro_torch.core.density.DensityModel` (``block_nonempty``): a plain
float density means uniform random nonzeros (the seed semantics,
bit-identical), while banded / block-N:M operands keep/drop coordinates
with their own statistics — which is exactly what moves the best
format choice on structured workloads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from .density import DensityLike, as_density
from .workload import WORD_BYTES

FMT_U, FMT_B, FMT_RLE, FMT_CP, FMT_UOP = range(5)
FORMAT_NAMES = ("U", "B", "RLE", "CP", "UOP")

SG_NONE = 0
SG_GATE_P_Q = 1     # Gate P<-Q : leader Q
SG_GATE_Q_P = 2     # Gate Q<-P : leader P
SG_GATE_BOTH = 3
SG_SKIP_P_Q = 4
SG_SKIP_Q_P = 5
SG_SKIP_BOTH = 6
SG_NAMES = ("none", "gate P<-Q", "gate Q<-P", "gate P<->Q",
            "skip P<-Q", "skip Q<-P", "skip P<->Q")
N_SG = 7
MAX_FMT_GENES = 5               # fixed sub-segment length (paper §IV.F)

# The DEFAULT (paper) arch's S/G sites: GLB, PE buffer, compute.  The
# authoritative per-arch site list is ``ArchSpec.sg_sites`` — any store
# may declare a site, and "C" (compute) is always last.
SG_SITES = ("L2", "L3", "C")


def is_gate(sg: int) -> bool:
    return sg in (SG_GATE_P_Q, SG_GATE_Q_P, SG_GATE_BOTH)


def is_skip(sg: int) -> bool:
    return sg in (SG_SKIP_P_Q, SG_SKIP_Q_P, SG_SKIP_BOTH)


def leaders(sg: int) -> Tuple[str, ...]:
    """Tensors whose metadata drives the intersection at this site."""
    if sg in (SG_GATE_P_Q, SG_SKIP_P_Q):
        return ("Q",)
    if sg in (SG_GATE_Q_P, SG_SKIP_Q_P):
        return ("P",)
    if sg in (SG_GATE_BOTH, SG_SKIP_BOTH):
        return ("P", "Q")
    return ()


def followers(sg: int) -> Tuple[str, ...]:
    """Tensors whose accesses are filtered by the mechanism."""
    if sg in (SG_GATE_P_Q, SG_SKIP_P_Q):
        return ("P",)
    if sg in (SG_GATE_Q_P, SG_SKIP_Q_P):
        return ("Q",)
    if sg in (SG_GATE_BOTH, SG_SKIP_BOTH):
        return ("P", "Q")
    return ()


@dataclasses.dataclass(frozen=True)
class TensorFormat:
    """Per-dimension formats for one tensor's tiled sub-dimensions,
    outermost first.  ``formats[i]`` applies to sub-dimension i whose fiber
    length is ``fiber_lens[i]``."""

    tensor: str
    formats: Tuple[int, ...]
    fiber_lens: Tuple[int, ...]

    @property
    def compressed(self) -> bool:
        return any(f != FMT_U for f in self.formats)

    def valid(self) -> Tuple[bool, str]:
        if len(self.formats) != len(self.fiber_lens):
            return False, "format/fiber length mismatch"
        if self.formats and self.formats[-1] == FMT_UOP:
            return False, "UOP on innermost sub-dimension"
        for i, f in enumerate(self.formats):
            if f == FMT_UOP and all(g == FMT_U for g in self.formats[i + 1:]):
                return False, "UOP without a compressed format below it"
        return True, ""


def fiber_tree_bytes(fmt: TensorFormat, density: DensityLike,
                     word_bytes: float = WORD_BYTES
                     ) -> Tuple[float, float]:
    """(data_bytes, metadata_bytes) for one *full tensor* tile whose tiled
    sub-dimension lengths are ``fmt.fiber_lens`` (product = element count).

    ``word_bytes`` is the datawidth of the level holding the tile
    (``ArchSpec.store_word_bytes``); metadata bits are width-independent,
    so the effective compression ratio varies with the level's width.

    ``density`` is a :class:`~repro_torch.core.density.DensityModel` (a float
    means :class:`~repro_torch.core.density.Uniform`, the seed semantics): the
    probability that a position at tree level i contains any nonzero
    below it is ``occ_i = model.block_nonempty(elements under the
    position)`` — for uniform random nonzeros that is
    ``1 - (1 - d) ** elems``, bit-identical to the pre-model code.
    """
    model = as_density(density)
    lens = fmt.fiber_lens
    n_elems = 1
    for L in lens:
        n_elems *= L
    if not fmt.compressed:
        return float(n_elems * word_bytes), 0.0

    data_bytes = n_elems * model.density * word_bytes
    meta_bits = 0.0
    n_fibers = 1.0          # fibers at current level
    elems_below = n_elems
    for i, L in enumerate(lens):
        elems_below //= max(L, 1)
        # probability that a coordinate at this level is "kept"
        occ = model.block_nonempty(max(elems_below, 1))
        kept = L * occ
        f = fmt.formats[i]
        if f == FMT_B:
            meta_bits += n_fibers * L                       # 1 bit/pos
        elif f == FMT_RLE:
            meta_bits += n_fibers * kept * _clog2(L)        # runlen/entry
        elif f == FMT_CP:
            meta_bits += n_fibers * kept * _clog2(L)        # coord/entry
        elif f == FMT_UOP:
            meta_bits += n_fibers * (L + 1) * _clog2(max(n_elems, 2))
        # U: no metadata, positions stay dense
        if f == FMT_U:
            n_fibers *= L
        else:
            n_fibers *= kept
    return float(data_bytes), float(meta_bits / 8.0)


def _clog2(x: float) -> float:
    return max(1.0, math.ceil(math.log2(max(x, 2))))


def effective_bytes(fmt: TensorFormat, density: DensityLike,
                    n_elems_tile: int,
                    word_bytes: float = WORD_BYTES) -> float:
    """Bytes occupied by a tile of ``n_elems_tile`` elements under this
    format, scaling the full-tensor fiber-tree accounting proportionally."""
    full_elems = 1
    for L in fmt.fiber_lens:
        full_elems *= L
    data_b, meta_b = fiber_tree_bytes(fmt, density, word_bytes)
    frac = n_elems_tile / max(full_elems, 1)
    return (data_b + meta_b) * frac


@dataclasses.dataclass(frozen=True)
class SparseStrategy:
    """Complete sparse strategy: formats for P/Q/Z + S/G per site."""

    formats: Dict[str, TensorFormat]          # keyed "P","Q","Z"
    sg: Dict[str, int]                        # keyed "L2","L3","C"

    def valid(self, spatial_subdims: Dict[str, Tuple[int, ...]]
              ) -> Tuple[bool, str]:
        """``spatial_subdims[t]`` = indices of t's tiled sub-dimensions that
        are spatially unrolled (need random parallel access -> must stay
        uncompressed)."""
        for t, fmt in self.formats.items():
            ok, why = fmt.valid()
            if not ok:
                return False, f"{t}: {why}"
            for i in spatial_subdims.get(t, ()):
                if i < len(fmt.formats) and fmt.formats[i] != FMT_U:
                    return False, (f"{t}: compressed format "
                                   f"{FORMAT_NAMES[fmt.formats[i]]} on "
                                   f"spatially unrolled sub-dimension")
        for site, sg in self.sg.items():
            if is_skip(sg):
                for ld in leaders(sg):
                    if not self.formats[ld].compressed:
                        return False, (f"{site}: skip with uncompressed "
                                       f"leader {ld} (no metadata to "
                                       f"locate nonzeros)")
        return True, ""
