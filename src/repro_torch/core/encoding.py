"""Genome encoding/decoding (SparseMap §IV.B, §IV.C, §IV.F, Fig. 13).

Genome layout (1-D int array), for a workload with ``d`` iteration dims,
``n_primes`` prime-factor slots, and an arch with ``n_levels`` mapping
levels and ``n_sites`` S/G sites (default paper arch: 5 levels, 3 sites):

    [ perm x n_levels | tiling_1..tiling_n | P fmt x5 | Q fmt x5
      | Z fmt x5 | SG x n_sites ]

* **Permutations** — Cantor (Lehmer) encoding, one gene per mapping level,
  value in [0, d!-1]; adjacent codes are adjacent permutations with the
  outer-loop rank dominating (paper Eq. 1, Fig. 10).
* **Dim. tiling** — prime-factor encoding: gene i holds the mapping level
  (in [0, n_levels)) that prime factor i of the concatenated dimension
  factorization is assigned to.  Every genome therefore satisfies the
  dimension-tiling constraint *by construction* (paper: direct value
  encoding leaves only 0.000023 % of the space valid).
* **Formats** — 5 genes per tensor in [0,4] (U/B/RLE/CP/UOP); the last k
  genes map to the k tiled sub-dimensions (cost_model.make_tensor_format).
* **S/G** — one gene in [0,6] per arch S/G site (store sites then
  compute; paper arch: GLB / PE buffer / compute).

The layout depends only on the arch's *mapping-level and site structure*
and the workload's *dimension structure*: per-level word widths and NoC
descriptors reprice the cost model but add no genes, and the same holds
for per-tensor density models (``repro_torch.core.density``) — a uniform, a
banded and a 2:4-pruned workload of the same shape share identical
genome layouts (density models reprice occupancy/intersections via the
kernel's traced parameter rows, they never widen the genome).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .arch import ARCH_SPARSEMAP, ArchSpec
from .cost_model import Design, make_tensor_format
from .mapping import Mapping
from .sparse import MAX_FMT_GENES, N_SG, SparseStrategy
from .workload import Workload

# ---------------------------------------------------------------- cantor


def cantor_encode(perm: Sequence[int]) -> int:
    """Lehmer-code a permutation of range(d) to an int in [0, d!-1].
    The paper's Eq. (1) is this +1 (1-based); we keep 0-based genes."""
    d = len(perm)
    code = 0
    for i in range(d):
        rank = sum(1 for j in range(i + 1, d) if perm[j] < perm[i])
        code += rank * math.factorial(d - 1 - i)
    return code


def cantor_decode(code: int, d: int) -> Tuple[int, ...]:
    """Inverse of :func:`cantor_encode`."""
    avail = list(range(d))
    out = []
    for i in range(d):
        f = math.factorial(d - 1 - i)
        idx, code = divmod(code, f)
        out.append(avail.pop(idx))
    return tuple(out)


def all_permutations(d: int) -> np.ndarray:
    """Lookup table: row c = cantor_decode(c, d).  Shape (d!, d)."""
    return np.array([cantor_decode(c, d) for c in range(math.factorial(d))],
                    dtype=np.int32)


# ---------------------------------------------------------------- genome


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    start: int
    stop: int

    @property
    def slice(self) -> slice:
        return slice(self.start, self.stop)

    def __len__(self) -> int:
        return self.stop - self.start


class GenomeSpec:
    """Genome layout + decode for one (workload, arch).  All searches (ES
    and every baseline) operate on this representation; the layout is
    derived from the arch's mapping-level and S/G-site structure."""

    def __init__(self, workload: Workload, arch: ArchSpec = ARCH_SPARSEMAP):
        self.workload = workload
        self.arch = arch
        self.d = workload.ndims
        self.n_perm_codes = math.factorial(self.d)
        self.primes = workload.prime_factors          # [(dim, p), ...]
        self.n_primes = len(self.primes)
        self.tensor_names = [t.name for t in workload.tensors]

        segs: List[Segment] = []
        pos = 0

        def add(name: str, n: int):
            nonlocal pos
            segs.append(Segment(name, pos, pos + n))
            pos += n

        add("perm", arch.n_levels)
        add("tiling", self.n_primes)
        for tn in self.tensor_names:
            add(f"fmt_{tn}", MAX_FMT_GENES)
        add("sg", len(arch.sg_sites))
        self.segments = {s.name: s for s in segs}
        self.length = pos

        # per-gene upper bounds (exclusive)
        ub = np.empty(self.length, dtype=np.int64)
        ub[self.segments["perm"].slice] = self.n_perm_codes
        ub[self.segments["tiling"].slice] = arch.n_levels
        for tn in self.tensor_names:
            ub[self.segments[f"fmt_{tn}"].slice] = 5
        ub[self.segments["sg"].slice] = N_SG
        self.gene_ub = ub
        self._gene_ub_minus1 = ub - 1
        self._gene_ub_f64 = ub.astype(np.float64)[None, :]
        self._perm_table = all_permutations(self.d)

    # ------------------------------------------------------------ decode
    def decode_mapping(self, genome: np.ndarray) -> Mapping:
        wl = self.workload
        perm_genes = genome[self.segments["perm"].slice]
        tiling_genes = genome[self.segments["tiling"].slice]
        factors: List[Dict[str, int]] = [dict()
                                         for _ in range(self.arch.n_levels)]
        for (dim, p), lvl in zip(self.primes, tiling_genes):
            lvl = int(lvl)
            factors[lvl][dim] = factors[lvl].get(dim, 1) * p
        perms = tuple(
            tuple(wl.dim_order[i] for i in self._perm_table[int(c)])
            for c in perm_genes)
        return Mapping(workload=wl, factors=tuple(factors), perms=perms,
                       arch=self.arch)

    def decode(self, genome: np.ndarray) -> Design:
        genome = np.asarray(genome)
        if genome.shape != (self.length,):
            raise ValueError(f"genome shape {genome.shape} != ({self.length},)")
        if (genome < 0).any() or (genome >= self.gene_ub).any():
            raise ValueError("gene out of range")
        mp = self.decode_mapping(genome)
        fmts = {}
        for tn in self.tensor_names:
            genes = tuple(int(g) for g in
                          genome[self.segments[f"fmt_{tn}"].slice])
            fmts[tn] = make_tensor_format(mp, tn, genes)
        sg = {site: int(g) for site, g in
              zip(self.arch.sg_sites, genome[self.segments["sg"].slice])}
        return Design(mapping=mp, strategy=SparseStrategy(formats=fmts, sg=sg))

    # ------------------------------------------------------------ encode
    def encode_mapping(self, mapping: Mapping) -> np.ndarray:
        """Inverse of decode for the mapping genes (tiling assignment is
        reconstructed greedily: primes of each dim are assigned outer-level
        first to reproduce the factor products)."""
        wl = self.workload
        nl = self.arch.n_levels
        genome = np.zeros(self.length, dtype=np.int64)
        inv_dim = {d: i for i, d in enumerate(wl.dim_order)}
        for lvl in range(nl):
            perm_idx = tuple(inv_dim[d] for d in mapping.perms[lvl])
            genome[self.segments["perm"].start + lvl] = cantor_encode(perm_idx)
        # greedy prime reassembly: walk primes in order, consume levels
        tpos = self.segments["tiling"].start
        remaining = {d: [mapping.factors[l].get(d, 1) for l in range(nl)]
                     for d in wl.dim_order}
        for i, (dim, p) in enumerate(self.primes):
            for lvl in range(nl):
                if remaining[dim][lvl] % p == 0 and remaining[dim][lvl] > 1:
                    remaining[dim][lvl] //= p
                    genome[tpos + i] = lvl
                    break
            else:
                raise ValueError(f"cannot reassemble tiling for {dim} prime {p}")
        return genome

    # ------------------------------------------------------------ sampling
    def random_genomes(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """One vectorized draw for the whole (n, L) population.  The
        multiply-and-floor formulation consumes exactly n*L uniforms, so
        seeded streams stay reproducible across code paths."""
        return (rng.random((n, self.length)) *
                self._gene_ub_f64).astype(np.int64)

    def clip(self, genomes: np.ndarray) -> np.ndarray:
        """Clamp genes into range.  Always returns a fresh array (callers
        mutate the result in place); the bound array is precomputed."""
        return np.clip(genomes, 0, self._gene_ub_minus1[None, :])

    # segment boundaries, used by sensitivity-aware crossover
    def segment_bounds(self) -> List[int]:
        bounds = sorted({s.start for s in self.segments.values()} |
                        {self.length})
        return bounds
