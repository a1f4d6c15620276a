"""Direct value encoding — the ablation counterpoint to prime-factor +
cantor encoding (SparseMap §IV.B, Fig. 10, Fig. 18 curve "ES").

Genome layout (n_levels/sg-site counts derived from the canonical spec's
arch — word widths, NoC descriptors and per-tensor density models add no
genes, exactly as in the canonical encoding; paper arch shown):

    [ perm x5 (RANDOM code->permutation table, Fig. 10a)
      | factor values, d dims x 5 levels, each in [1 .. size(dim)]
      | P fmt x5 | Q fmt x5 | Z fmt x5 | SG x3 ]

The dimension-tiling constraint (prod_l factor[d,l] == size(d)) is NOT
guaranteed by the encoding; genomes violating it are invalid — which is the
paper's point: only ~0.000023 % of direct-encoded combinations are valid
tilings.  Sampling and mutation draw factor values from the divisors of the
dimension size (a generous implementation choice; uniform integers would
never produce a single valid point at CI budgets).

Valid direct genomes are translated to the canonical `GenomeSpec` genome
and costed with the same batch evaluator, so the comparison isolates
*encoding*, not the cost model.  The engine is exposed both as the
closed-form :func:`direct_standard_es` and as the request generator
:func:`direct_requests` (the ``standard_es`` entry in
``baselines.REQUEST_METHODS``): the generator yields CANONICAL genome
batches for the translatable rows, so a ``search.MultiSearch`` fleet can
evaluate them on the shared batch evaluator alongside every other
method; untranslatable rows are charged to the budget as invalid without
costing, exactly like the closed-form path.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import es_ops
from .encoding import GenomeSpec, all_permutations


def divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


class DirectValueSpec:
    """Direct-value genome with a scrambled permutation code table."""

    def __init__(self, canonical: GenomeSpec, seed: int = 1234):
        self.canonical = canonical
        wl = canonical.workload
        self.workload = wl
        self.d = wl.ndims
        self.n_levels = canonical.arch.n_levels
        rng = np.random.default_rng(seed)
        nperm = math.factorial(self.d)
        # random encoding: code -> arbitrary permutation (Fig. 10a)
        self.scramble = rng.permutation(nperm)
        self._perm_table = all_permutations(self.d)
        self.div: Dict[str, List[int]] = {
            dim: divisors(wl.dim_sizes[dim]) for dim in wl.dim_order}

        nl = self.n_levels
        self.n_factor_genes = self.d * nl
        tail = canonical.length - canonical.segments["fmt_P"].start
        self.length = nl + self.n_factor_genes + tail
        self.perm_sl = slice(0, nl)
        self.fact_sl = slice(nl, nl + self.n_factor_genes)
        self.tail_sl = slice(nl + self.n_factor_genes, self.length)
        self.n_perm_codes = nperm

    # -------------------------------------------------------- sampling
    def random_genomes(self, rng: np.random.Generator, n: int) -> np.ndarray:
        g = np.zeros((n, self.length), dtype=np.int64)
        g[:, self.perm_sl] = rng.integers(0, self.n_perm_codes,
                                          (n, self.n_levels))
        col = self.fact_sl.start
        for dim in self.workload.dim_order:
            dv = np.asarray(self.div[dim])
            for lvl in range(self.n_levels):
                g[:, col] = dv[rng.integers(0, len(dv), n)]
                col += 1
        tail = self.canonical.length - self.canonical.segments["fmt_P"].start
        tail_ub = self.canonical.gene_ub[-tail:]
        g[:, self.tail_sl] = (rng.random((n, tail)) *
                              tail_ub[None, :]).astype(np.int64)
        return g

    def mutate_gene(self, g: np.ndarray, i: int, j: int,
                    rng: np.random.Generator) -> None:
        if j < self.perm_sl.stop:
            g[i, j] = rng.integers(0, self.n_perm_codes)
        elif j < self.fact_sl.stop:
            rel = j - self.fact_sl.start
            dim = self.workload.dim_order[rel // self.n_levels]
            dv = self.div[dim]
            g[i, j] = dv[rng.integers(0, len(dv))]
        else:
            rel = j - self.tail_sl.start
            ub = self.canonical.gene_ub[
                self.canonical.segments["fmt_P"].start + rel]
            g[i, j] = rng.integers(0, ub)

    # -------------------------------------------------------- decode
    def to_canonical(self, g: np.ndarray) -> Optional[np.ndarray]:
        """Translate to the canonical genome; None if the tiling constraint
        is violated (invalid individual)."""
        wl = self.workload
        nl = self.n_levels
        factors = g[self.fact_sl].reshape(self.d, nl)
        for i, dim in enumerate(wl.dim_order):
            if int(np.prod(factors[i])) != wl.dim_sizes[dim]:
                return None
        out = np.zeros(self.canonical.length, dtype=np.int64)
        # perms: scrambled code -> permutation -> cantor code
        for lvl in range(nl):
            code = int(self.scramble[g[self.perm_sl][lvl]])
            out[self.canonical.segments["perm"].start + lvl] = code
        # tiling: distribute primes of each dim over levels per the factors
        tpos = self.canonical.segments["tiling"].start
        remaining = {dim: list(factors[i])
                     for i, dim in enumerate(wl.dim_order)}
        for k, (dim, p) in enumerate(self.canonical.primes):
            for lvl in range(nl):
                if remaining[dim][lvl] % p == 0 and remaining[dim][lvl] > 1:
                    remaining[dim][lvl] //= p
                    out[tpos + k] = lvl
                    break
            else:
                return None
        out[self.canonical.segments["fmt_P"].start:] = g[self.tail_sl]
        return out

    def translate_batch(self, genomes: np.ndarray
                        ) -> Tuple[Optional[np.ndarray], List[int]]:
        """(stacked canonical rows or None, indices of translatable rows)."""
        canon, index = [], []
        for i in range(len(genomes)):
            c = self.to_canonical(genomes[i])
            if c is not None:
                canon.append(c)
                index.append(i)
        return (np.stack(canon) if canon else None), index

    def expand_out(self, n: int, index: List[int],
                   out: Optional[Dict]) -> Dict:
        """Scatter a canonical evaluation of the translatable subset back
        to a full-batch output dict (untranslatable rows: invalid, inf
        EDP)."""
        valid = np.zeros(n, dtype=bool)
        edp = np.full(n, np.inf)
        if out is not None and index:
            v = np.asarray(out["valid"])
            e = np.asarray(out["edp"], dtype=np.float64)
            for k, i in enumerate(index):
                valid[i] = bool(v[k])
                edp[i] = e[k] if v[k] else np.inf
        return dict(valid=valid, edp=edp,
                    log10_edp=np.log10(np.maximum(edp, 1e-30)))

    def make_batch_eval(self, canonical_eval):
        """Wrap the canonical batch evaluator: direct genomes that violate
        the tiling constraint are invalid without costing."""
        def _eval(genomes: np.ndarray) -> Dict[str, np.ndarray]:
            canon, index = self.translate_batch(genomes)
            out = canonical_eval(canon) if canon is not None else None
            return self.expand_out(len(genomes), index, out)
        return _eval


def _direct_value_draw(dspec: DirectValueSpec, j: int,
                       rng: np.random.Generator) -> int:
    """The replacement value :meth:`DirectValueSpec.mutate_gene` would
    write at gene ``j`` — same rng consumption (one ``integers`` draw),
    value independent of the genome, so a plan can pre-draw it."""
    if j < dspec.perm_sl.stop:
        return int(rng.integers(0, dspec.n_perm_codes))
    if j < dspec.fact_sl.stop:
        rel = j - dspec.fact_sl.start
        dim = dspec.workload.dim_order[rel // dspec.n_levels]
        dv = dspec.div[dim]
        return int(dv[rng.integers(0, len(dv))])
    rel = j - dspec.tail_sl.start
    ub = dspec.canonical.gene_ub[
        dspec.canonical.segments["fmt_P"].start + rel]
    return int(rng.integers(0, ub))


def _direct_plan(dspec: DirectValueSpec, rng: np.random.Generator,
                 n_children: int, n_parents: int,
                 p_mut: float) -> es_ops.GenDraws:
    """One generation's randomness for the direct-encoding ES, drawn in
    EXACTLY the legacy per-child order (parent pair, cut, mutation coin,
    then per-mutated-gene index+value) so the plan is a pure
    re-expression of the sequential loop's stream."""
    L = dspec.length
    ab = np.empty((n_children, 2), dtype=np.int64)
    cuts = np.empty(n_children, dtype=np.int64)
    active = np.empty(n_children, dtype=bool)
    gene = np.zeros((n_children, 2), dtype=np.int64)
    vals = np.zeros((n_children, 2), dtype=np.int64)
    for i in range(n_children):
        ab[i] = rng.integers(0, n_parents, 2)
        cuts[i] = rng.integers(1, L)
        active[i] = rng.random() < p_mut
        if active[i]:
            for j in range(2):
                gi = int(rng.integers(0, L))
                gene[i, j] = gi
                vals[i, j] = _direct_value_draw(dspec, gi, rng)
    return es_ops.GenDraws(ab=ab, cuts=cuts, active=active,
                           gene=gene, vals=vals)


def direct_requests(spec: GenomeSpec, tracker: "_Budget", seed: int,
                    platform=None, pop_size: int = 100,
                    parent_frac: float = 0.4, elite_frac: float = 0.1,
                    p_mut: float = 0.9, device_rounds: int = 1,
                    rng_backend: str = "numpy") -> "Requests":
    """Standard ES on the direct encoding (Fig. 18 curve 'ES') as a
    request generator over CANONICAL genome rows: each round the direct
    population is translated, the translatable subset is yielded for
    evaluation on the canonical batch evaluator, and the full population
    (translatable or not) is charged to the budget.  Canonical rows are
    registered with the tracker, so ``best_genome`` decodes with the
    ordinary :class:`GenomeSpec` like every other method's result.

    ``device_rounds=k>1`` switches to the segment protocol: the loop
    yields ``kind="direct"`` :class:`~.es_ops.DeviceSegment` requests
    whose pre-drawn plans cover k generations; ``torch_cost`` runs the
    whole fold — including the direct-to-canonical translation — as one
    segment dispatch, pipelined one round late exactly like the main
    ES's ``_segment_requests`` (COMPAT.md "standard_es segment
    protocol").  Selection then uses the stable f32 fitness order shared
    with the device kernel (the legacy per-round loop keeps its unstable
    f64 ``np.argsort``, same seam as the canonical ES).
    """
    if rng_backend != "numpy":
        raise ValueError(
            "standard_es segments support only rng_backend='numpy' "
            f"(got {rng_backend!r}); the direct value draws are tied to "
            "the legacy Generator stream")
    rng = np.random.default_rng(seed)
    dspec = DirectValueSpec(spec)

    def charge(pop: np.ndarray):
        """Translate, yield the canonical subset, register the FULL
        population against the budget; returns the full-batch EDP."""
        canon, index = dspec.translate_batch(pop)
        out = None
        if canon is not None:
            out = yield canon
        full = dspec.expand_out(len(pop), index, out)
        # register canonical rows so best_genome is canonical; rows
        # without a translation can never be best (inf EDP)
        reg_rows = np.zeros((len(pop), spec.length), dtype=np.int64)
        if canon is not None:
            reg_rows[index] = canon
        return tracker.register(reg_rows, full)

    pop = dspec.random_genomes(rng, pop_size)
    edp = yield from charge(pop)
    n_parents = max(2, int(pop_size * parent_frac))
    n_elite = max(1, int(pop_size * elite_frac))
    if device_rounds > 1:
        extras = yield from _direct_segment_requests(
            spec, dspec, tracker, rng, pop, edp, pop_size,
            n_parents, n_elite, p_mut, device_rounds)
        return extras
    while not tracker.exhausted:
        order = np.argsort(edp)
        parents = pop[order[:n_parents]]
        elites = pop[order[:n_elite]].copy()
        elite_edp = edp[order[:n_elite]].copy()
        kids = np.empty((pop_size - n_elite, dspec.length), dtype=np.int64)
        for i in range(len(kids)):
            a, b = rng.integers(0, len(parents), 2)
            cut = rng.integers(1, dspec.length)
            kids[i, :cut] = parents[a, :cut]
            kids[i, cut:] = parents[b, cut:]
            if rng.random() < p_mut:
                for _ in range(2):
                    dspec.mutate_gene(kids, i,
                                      rng.integers(0, dspec.length), rng)
        kedp = yield from charge(kids)
        pop = np.concatenate([elites, kids])
        edp = np.concatenate([elite_edp, kedp])
    return dict(method="standard_es", encoding="direct")


def _direct_segment_requests(spec: GenomeSpec, dspec: DirectValueSpec,
                             tracker: "_Budget", rng: np.random.Generator,
                             pop: np.ndarray, edp: np.ndarray,
                             pop_size: int, n_parents: int, n_elite: int,
                             p_mut: float, k: int) -> "Requests":
    """Device-resident rounds for the direct encoding: yields
    ``kind="direct"`` :class:`~.es_ops.DeviceSegment` requests whose
    ``aux`` carries the translation tables (permutation scramble and
    dimension sizes) so ``torch_cost`` can run crossover, mutation,
    direct-to-canonical translation AND evaluation as one segment
    dispatch.  Pipelined one round late exactly like
    ``evolution._segment_requests`` (COMPAT.md "Pipelined dispatch
    contract"): the response for segment N is stashed unresolved, segment
    N+1 is planned from the ``planned`` counter and yielded carrying the
    device-resident ``resp.carry``, then N is resolved and registered.
    Callers that answer ``None`` get a host replay of the identical plan
    (translate + canonical-subset yield per generation, same
    registration rows as the device harvest)."""
    n_children = pop_size - n_elite
    edp_sel = np.where(np.isfinite(edp), edp, np.inf).astype(np.float32)
    aux = dict(
        scramble=np.asarray(dspec.scramble, dtype=np.int32),
        dim_sizes=np.asarray(
            [dspec.workload.dim_sizes[d] for d in dspec.workload.dim_order],
            dtype=np.float32))
    gen = 0

    def absorb(resp):
        nonlocal pop, edp_sel, gen
        resp.resolve()
        for kids, kout in resp.gens:
            tracker.register(kids, kout)
            gen += 1
        pop = resp.final_pop
        edp_sel = np.asarray(resp.final_edp, dtype=np.float32)

    planned = tracker.evals
    pending = None
    carry = None
    while planned < tracker.budget:
        plans = [_direct_plan(dspec, rng, n_children, n_parents, p_mut)
                 for _ in range(k)]
        for _ in range(k):
            planned += min(n_children, tracker.budget - planned)
        resp = yield es_ops.DeviceSegment(
            spec=spec, pop=pop, edp=edp_sel, rounds=k, gen0=gen,
            n_parents=n_parents, n_elite=n_elite, genes_per=2,
            draws=es_ops.stack_draws(plans), fixed_genes=None,
            rng_backend="numpy", carry=carry, kind="direct", aux=aux)
        if resp is None:
            # host replay of the identical plan, one generation per yield:
            # the registered rows (canonical where translatable, zeros
            # otherwise) match the device harvest's ``canon`` output
            for d in plans:
                parents, elites, elite_edp = es_ops.select(
                    pop, edp_sel, n_parents, n_elite)
                kids = np.ascontiguousarray(
                    es_ops.apply_crossover(parents, d.ab, d.cuts),
                    dtype=pop.dtype)
                kids = es_ops.apply_mutation(kids, d.active, d.gene,
                                             d.vals)
                canon, index = dspec.translate_batch(kids)
                out = None
                if canon is not None:
                    out = yield canon
                full = dspec.expand_out(len(kids), index, out)
                reg_rows = np.zeros((len(kids), spec.length),
                                    dtype=np.int64)
                if canon is not None:
                    reg_rows[index] = canon
                tracker.register(reg_rows, full)
                kedp = np.where(
                    np.asarray(full["valid"]),
                    np.asarray(full["edp"], dtype=np.float32),
                    np.float32(np.inf)).astype(np.float32)
                pop = np.concatenate([elites, kids], axis=0)
                edp_sel = np.concatenate(
                    [np.asarray(elite_edp, np.float32), kedp])
                gen += 1
                if tracker.exhausted:
                    break
            continue
        if pending is not None:
            absorb(pending)
        pending = resp
        carry = resp.carry
    if pending is not None:
        absorb(pending)
    return dict(method="standard_es", encoding="direct", generations=gen)


def direct_standard_es(canonical_spec: GenomeSpec, canonical_eval,
                       budget: int, seed: int, platform=None,
                       **kw) -> "SearchResult":
    """Drive :func:`direct_requests` against one evaluator (the
    closed-form Fig. 18 'ES' path; identical code to the concurrent
    fleet)."""
    from .evolution import SearchResult, _Budget, _drive
    tracker = _Budget(budget)
    extras = _drive(direct_requests(canonical_spec, tracker, seed,
                                    platform=platform, **kw),
                    canonical_eval) or {}
    extras["method"] = "direct_standard_es"
    return SearchResult(best_edp=tracker.best,
                        best_genome=tracker.best_genome,
                        history=np.asarray(tracker.hist),
                        evals=tracker.evals, valid_evals=tracker.valid,
                        extras=extras)
