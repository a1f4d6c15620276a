"""Backend-shared ES operator core: one definition of SparseMap's
evolutionary operators usable from both the numpy host loop and a
device-resident round program working on ``torch.Tensor`` populations.

Every operator is split into a *draw plan* and a pure *apply*:

* ``plan_crossover`` / ``plan_mutation`` reproduce the numpy
  ``Generator`` call sequence of the legacy ``evolution.crossover`` /
  ``evolution.mutate`` exactly (same calls, same order, same shapes), so
  the host loop and a device segment fed the same plan make bit-identical
  operator choices.  The numpy implementations remain the oracle.
* ``apply_crossover`` / ``apply_mutation`` consume a plan and work on
  either numpy arrays or ``torch.Tensor``s — the numpy path is
  byte-identical to the legacy in-place formulation (duplicate gene draws
  within a row overwrite in draw order: the apply walks the ``genes_per``
  columns sequentially, which indexed writes preserve because each
  column's row indices are unique).
* ``torch_plan_generation`` is the keyed alternative (the counterpart of
  the JAX package's ``threefry_plan_generation``): the same plan arrays
  drawn from a ``torch.Generator`` seeded from ``(seed, generation)``.
  It is a different stream from the numpy oracle AND from the JAX
  package's threefry stream by construction, but it is deterministic
  across callers and needs no shared generator state.

The module also defines the **device-segment protocol** types
(:class:`DeviceSegment`, :class:`SegmentResult`) that request generators
yield when ``ESConfig.device_rounds > 1``, and :class:`PaddedLayout`,
the genome-column padding that lets same-signature workloads with
different prime counts share one dispatch (pad columns are
numerically inert: value 0, upper bound 1).

This module is the ONE sanctioned home for raw RNG in ``repro_torch.core``:
contract rule R2 (COMPAT.md "Machine-checked contracts") forbids
``np.random.*`` / stdlib ``random`` everywhere else in the core so that
every draw reaches the kernels as a pre-planned array.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------- plans


@dataclasses.dataclass
class GenDraws:
    """All randomness of ONE generation of the ES main loop, in canonical
    (unpadded) genome coordinates: crossover parent pairs + cut positions,
    then mutation activity/gene/value draws."""

    ab: np.ndarray          # (C, 2) parent indices into the sorted top-P
    cuts: np.ndarray        # (C,) absolute single-point cut positions
    active: np.ndarray      # (C,) bool: row is mutated
    gene: np.ndarray        # (C, genes_per) gene indices
    vals: np.ndarray        # (C, genes_per) replacement values


def crossover_cut_points(L: int, sens=None) -> np.ndarray:
    """Allowed single-point cut positions.  With ``sens``: restricted to
    high-sensitivity segment boundaries (never splitting a run), exactly
    as ``evolution.crossover``."""
    if sens is not None:
        pts = {0, L}
        for a, b in sens.high_segments():
            pts.add(a)
            pts.add(b)
        cut_points = sorted(pts - {0, L}) or [L // 2]
    else:
        cut_points = list(range(1, L))
    return np.asarray(cut_points, dtype=np.int64)


def plan_crossover(rng: np.random.Generator, n_children: int,
                   n_parents: int, cut_arr: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The two crossover draws, in the legacy call order: parent pairs,
    then cut-point indices."""
    ab = rng.integers(0, n_parents, size=(n_children, 2))
    cuts = cut_arr[rng.integers(0, len(cut_arr), size=n_children)]
    return ab, cuts


def mutation_index_tables(L: int, sens) -> Tuple[Optional[np.ndarray],
                                                 Optional[np.ndarray]]:
    """(hi, lo) gene-index tables for annealing mutation; (None, None)
    for uniform mutation.  Empty tables fall back to all genes, exactly
    as ``evolution.mutate``."""
    if sens is None:
        return None, None
    all_idx = np.arange(L)
    hi = sens.high_indices
    lo = sens.low_indices
    if len(hi) == 0:
        hi = all_idx
    if len(lo) == 0:
        lo = all_idx
    return hi, lo


def plan_mutation(rng: np.random.Generator, n: int, gene_ub: np.ndarray,
                  genes_per: int, p_mut: float, p_high: float = 0.0,
                  hi: Optional[np.ndarray] = None,
                  lo: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mutation draws in the legacy call order: activity, gene
    indices (annealed high/low split when ``hi``/``lo`` are given,
    uniform otherwise), replacement values."""
    L = len(gene_ub)
    active = rng.random(n) < p_mut
    if hi is not None:
        use_high = rng.random(n) < p_high
        u = rng.random((n, genes_per))
        gene = np.where(use_high[:, None],
                        hi[(u * len(hi)).astype(np.int64)],
                        lo[(u * len(lo)).astype(np.int64)])
    else:
        gene = rng.integers(0, L, size=(n, genes_per))
    vals = rng.integers(0, gene_ub[gene])
    return active, gene, vals


def plan_generation(rng: np.random.Generator, *, n_children: int,
                    n_parents: int, cut_arr: np.ndarray,
                    gene_ub: np.ndarray, genes_per: int, p_mut: float,
                    p_high: float, hi: Optional[np.ndarray],
                    lo: Optional[np.ndarray]) -> GenDraws:
    """One generation's full plan, matching the legacy per-generation
    draw order (crossover first, then mutation)."""
    ab, cuts = plan_crossover(rng, n_children, n_parents, cut_arr)
    active, gene, vals = plan_mutation(rng, n_children, gene_ub, genes_per,
                                       p_mut, p_high, hi, lo)
    return GenDraws(ab=ab, cuts=cuts, active=active, gene=gene, vals=vals)


def _keyed_generator(seed: int, gen: int) -> torch.Generator:
    """A CPU ``torch.Generator`` whose state depends only on
    ``(seed, gen)``."""
    g = torch.Generator(device="cpu")
    g.manual_seed((int(seed) * 1_000_003 + int(gen)) % (2 ** 63))
    return g


def torch_plan_generation(seed: int, gen: int, *, n_children: int,
                          n_parents: int, cut_arr: np.ndarray,
                          gene_ub: np.ndarray, genes_per: int,
                          p_mut: float, p_high: float,
                          hi: Optional[np.ndarray],
                          lo: Optional[np.ndarray]) -> GenDraws:
    """The keyed variant of :func:`plan_generation` (the JAX package's
    ``threefry_plan_generation`` seam): the same plan arrays drawn from a
    ``torch.Generator`` seeded from ``(seed, gen)``.  Deterministic across
    callers; a *different* stream from the numpy oracle and from the JAX
    package's threefry stream — only the shapes, ranges and the order of
    the six draws are shared."""
    L = len(gene_ub)
    g = _keyed_generator(seed, gen)

    def randint(shape, high):
        return torch.randint(0, int(high), shape, generator=g,
                             dtype=torch.int64).numpy()

    def uniform(shape):
        return torch.rand(shape, generator=g, dtype=torch.float64).numpy()

    ab = randint((n_children, 2), n_parents)
    cuts = cut_arr[randint((n_children,), len(cut_arr))]
    active = uniform((n_children,)) < p_mut
    if hi is not None:
        use_high = uniform((n_children,)) < p_high
        u = uniform((n_children, genes_per))
        gene = np.where(use_high[:, None],
                        hi[(u * len(hi)).astype(np.int64)],
                        lo[(u * len(lo)).astype(np.int64)])
    else:
        gene = randint((n_children, genes_per), L)
    vals = (uniform((n_children, genes_per))
            * gene_ub[gene]).astype(np.int64)
    return GenDraws(ab=ab, cuts=cuts, active=active, gene=gene, vals=vals)


def stack_draws(draws: Sequence[GenDraws]) -> Dict[str, np.ndarray]:
    """Stack k per-generation plans into the (k, ...) arrays a
    k-generation segment consumes, one slice per generation."""
    return dict(
        ab=np.stack([d.ab for d in draws]).astype(np.int32),
        cuts=np.stack([d.cuts for d in draws]).astype(np.int32),
        active=np.stack([d.active for d in draws]),
        gene=np.stack([d.gene for d in draws]).astype(np.int32),
        vals=np.stack([d.vals for d in draws]).astype(np.int32))


# --------------------------------------------------------------- applies


def _index(t):
    """Index tensors must be int64 (or bool) in torch."""
    return t if t.dtype in (torch.int64, torch.bool) else t.long()


def _take_rows(x, idx):
    """``x[..., idx[...], :]`` for a torch ``x (..., N, L)`` and index
    ``idx (..., M)``: whole rows gathered per leading index."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def apply_crossover(parents, ab, cuts):
    """Assemble all children from a crossover plan.  Works on numpy
    arrays and on ``torch.Tensor``s (the index grid + ``where``
    formulation is shared; plan tensors must live on ``parents``'
    device).  The torch form also takes a leading task axis —
    ``parents (T, P, L)``, ``ab (T, C, 2)``, ``cuts (T, C)`` — as the
    device segments (``torch_cost.run_segments``) use it."""
    L = parents.shape[-1]
    if isinstance(parents, np.ndarray):
        col = np.arange(L)[None, :]
        return np.where(col < cuts[:, None], parents[ab[:, 0]],
                        parents[ab[:, 1]])
    col = torch.arange(L, device=parents.device)
    ab = _index(ab)
    return torch.where(col < cuts[..., None], _take_rows(parents, ab[..., 0]),
                       _take_rows(parents, ab[..., 1]))


def apply_mutation(genomes, active, gene, vals):
    """Apply a mutation plan.  Duplicate gene draws within a row
    overwrite in draw order — the apply walks the ``genes_per`` columns
    sequentially (each column's row indices are unique, so the order is
    deterministic for the torch indexed write too).  Returns a new
    array; the input is not modified.  The torch form also takes a
    leading task axis (``genomes (T, C, L)``, plan ``(T, C, ...)``)."""
    genes_per = gene.shape[-1]
    if isinstance(genomes, np.ndarray):
        out = genomes.copy()
        rows = np.arange(len(gene))
        for j in range(genes_per):
            g = gene[:, j]
            out[rows, g] = np.where(active, vals[:, j], out[rows, g])
        return out
    out = genomes
    gene = _index(gene)
    vals = vals.to(out.dtype)
    for j in range(genes_per):
        g = gene[..., j:j + 1]
        out = out.scatter(-1, g, torch.where(active[..., None],
                                             vals[..., j:j + 1],
                                             out.gather(-1, g)))
    return out


def stable_order(edp):
    """Stable fitness order, shared by the device segment and the host
    fallback so a segment's trajectory is caller-invariant.  (The legacy
    per-round host loop keeps ``np.argsort``'s default introsort; the two
    differ only in tie order.)  Sorts along the last axis; ``inf`` and
    ``NaN`` go last, ties keep their index order, in both forms."""
    if isinstance(edp, np.ndarray):
        return np.argsort(edp, kind="stable")
    return torch.sort(edp, dim=-1, stable=True).indices


def select(pop, edp, n_parents: int, n_elite: int):
    """Elitist truncation selection: (parents, elites, elite_edp).  The
    torch form also takes a leading task axis (``pop (T, B, L)``,
    ``edp (T, B)``)."""
    order = stable_order(edp)
    if isinstance(pop, np.ndarray):
        return (pop[order[:n_parents]], pop[order[:n_elite]],
                edp[order[:n_elite]])
    return (_take_rows(pop, order[..., :n_parents]),
            _take_rows(pop, order[..., :n_elite]),
            edp.gather(-1, order[..., :n_elite]))


def best_so_far(edp):
    """Running best-so-far curve over a fitness sequence (tensor or np)."""
    if isinstance(edp, np.ndarray):
        return np.minimum.accumulate(edp)
    return torch.cummin(edp, dim=0).values


# ------------------------------------------------------ padded layout


class PaddedLayout:
    """Column padding that maps a spec's canonical genome layout
    ``[perm | tiling(n_primes) | fmt | sg]`` onto the signature's
    shared layout ``[perm | tiling(n_pad) | fmt | sg]``.  Pad columns are
    inert (value 0, upper bound 1); gene indices and cut positions at or
    beyond the tiling boundary shift by ``delta = n_pad - n_primes``."""

    def __init__(self, spec, n_pad: int):
        self.n_levels = spec.arch.n_levels
        self.n_primes = spec.n_primes
        self.n_pad = int(n_pad)
        if self.n_pad < self.n_primes:
            raise ValueError(f"n_pad {n_pad} < n_primes {self.n_primes}")
        self.boundary = self.n_levels + self.n_primes
        self.delta = self.n_pad - self.n_primes
        self.L = spec.length
        self.Lp = spec.length + self.delta
        self.cols = np.concatenate([
            np.arange(self.boundary),
            np.arange(self.boundary + self.delta, self.Lp)])

    # Rows move as two contiguous slices, not through ``cols``: a fancy
    # column index copies element by element, which at the evaluator's
    # largest batches costs more host time than the device's work.
    def pad_rows(self, g, out=None):
        """Pad numpy rows, or ``torch.Tensor`` rows on their device.  With
        ``out`` (zero in the pad columns) the rows are written there, cast
        to its dtype, and ``out`` is returned."""
        shape = tuple(g.shape[:-1]) + (self.Lp,)
        if out is None:
            out = g.new_zeros(shape) if isinstance(g, torch.Tensor) else \
                np.zeros(shape, dtype=g.dtype)
        b = self.boundary
        out[..., :b] = g[..., :b]
        out[..., b + self.delta:] = g[..., b:]
        return out

    def unpad_rows(self, gp: np.ndarray) -> np.ndarray:
        b = self.boundary
        return np.concatenate([gp[..., :b], gp[..., b + self.delta:]],
                              axis=-1)

    def pad_index(self, idx: np.ndarray) -> np.ndarray:
        """Gene indices: positions at/after the boundary shift up."""
        return np.where(idx >= self.boundary, idx + self.delta, idx)

    def pad_cut(self, c: np.ndarray) -> np.ndarray:
        """Cut positions: a cut strictly after the boundary shifts up (a
        cut AT the boundary keeps the same prefix; the pad columns it
        hands to the other parent are inert)."""
        return np.where(c > self.boundary, c + self.delta, c)

    def pad_vector(self, v: np.ndarray, fill) -> np.ndarray:
        out = np.full(self.Lp, fill, dtype=np.asarray(v).dtype)
        out[self.cols] = v
        return out


# ------------------------------------------------- segment protocol


@dataclasses.dataclass
class DeviceSegment:
    """A request for k device-resident ES generations.  Yielded by
    ``evolution.evolve_requests`` when ``ESConfig.device_rounds > 1``;
    callers that can execute it send back a :class:`SegmentResult`
    (``torch_cost.run_segments``), callers that cannot send ``None`` and
    the generator replays the same plan on the host — either way the
    trajectory is identical because all randomness is in ``draws``."""

    spec: object                    # GenomeSpec
    pop: np.ndarray                 # (B, L) current population, int64
    edp: np.ndarray                 # (B,) selection fitness, float32
    rounds: int                     # k generations in this segment
    gen0: int                       # index of the first generation
    n_parents: int
    n_elite: int
    genes_per: int
    draws: Dict[str, np.ndarray]    # stacked (k, ...) plan arrays
    fixed_genes: Optional[Dict[int, int]] = None
    rng_backend: str = "numpy"
    # pipelined dispatch (COMPAT.md "Pipelined dispatch contract"):
    # ``carry`` holds the previous segment's device-resident PADDED
    # (pop, edp) pair — when set, callers start the segment from it
    # and ``pop``/``edp`` are only the host-side fallback of record.
    carry: Optional[Tuple] = None
    # segment flavor: "es" runs in canonical genome coordinates;
    # "direct" carries direct-value genomes plus the translation tables
    # in ``aux`` (scramble, dim_sizes) and translates rows in the segment.
    kind: str = "es"
    aux: Optional[Dict[str, np.ndarray]] = None
    # stagnation restart folded into the segment: re-init the non-elite
    # population after ``restart`` generations without improvement of the
    # carried float32 best (0 = off).  ``state`` is the (best, since)
    # carry across segments; ``draws["fresh"]`` holds the pre-drawn
    # replacement populations.
    restart: int = 0
    state: Optional[Tuple[float, int]] = None


@dataclasses.dataclass
class SegmentResult:
    """What a caller sends back for a :class:`DeviceSegment`: the per-
    generation (kids, canonical output dict) pairs for `_Budget`
    accounting, plus the device's final carry state.

    With deferred harvesting (``torch_cost.run_segments(..., defer=True)``)
    ``gens``/``final_pop``/``final_edp`` start empty and ``harvest`` is a
    thunk that converts the device outputs to numpy on first call —
    request generators call :meth:`resolve` one round late, so the
    blocking conversion overlaps the next segment's device execution.
    ``carry`` always holds the device-resident PADDED (pop, edp) pair for
    the follow-up segment, and ``state`` the device (best, since) restart
    carry when the segment folded stagnation restarts."""

    gens: List[Tuple[np.ndarray, Dict[str, np.ndarray]]]
    final_pop: Optional[np.ndarray]  # (B, L) int64, unpadded
    final_edp: Optional[np.ndarray]  # (B,) float32
    carry: Optional[Tuple] = None    # device-resident padded (pop, edp)
    state: Optional[Tuple] = None    # device (best, since) restart carry
    harvest: Optional[Callable] = None

    def resolve(self) -> "SegmentResult":
        """Run the deferred numpy conversion (idempotent)."""
        if self.harvest is not None:
            self.gens, self.final_pop, self.final_edp = self.harvest()
            self.harvest = None
        return self


def segment_shape_key(seg: DeviceSegment) -> Tuple:
    """Tasks whose segments share this key (plus the evaluator
    signature) stack into one ``torch_cost.run_segments`` dispatch."""
    return (len(seg.pop), seg.rounds, seg.n_parents, seg.n_elite,
            seg.genes_per, getattr(seg, "kind", "es"),
            getattr(seg, "restart", 0))
