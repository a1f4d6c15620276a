"""SparseMap's evolution strategy (§IV.D, §IV.E, §IV.H, Fig. 16).

Components:
* **High-Sensitivity Hypercube Initialization (HSHI)** — the design space is
  partitioned into ~pop_size hypercubes along the high-sensitivity genes; a
  small random-search budget per cube finds one valid individual, with
  low-sensitivity genes seeded from the valid combinations collected during
  sensitivity calibration.
* **Annealing mutation** — Eq. (6)/(7): P_h(g) = 0.8*exp(-phi)*(1-phi),
  phi = g/G, shifting mutation mass from high- to low-sensitivity segments.
* **Sensitivity-aware crossover** — single-point crossover whose cut points
  are restricted to the natural boundaries of high-sensitivity segments, so
  high-sensitivity gene runs are never fragmented.
* **Evaluation & selection** — population fitness from the batch cost model
  (invalid individuals have fitness 0); elitist truncation selection.

`evolve` also implements the ablation variants of Fig. 18: standard ES with
LHS init, uniform crossover/mutation (``use_hshi=False, use_custom_ops=False``).

Every operator is array-at-once: mutation draws its gene indices and
replacement values as (pop, genes_per) matrices, crossover assembles all
children with one ``np.where`` over an index grid, HSHI samples one
(n_cubes, L) candidate matrix per round, and best-so-far tracking uses
``np.minimum.accumulate``.  The engine itself is a *generator*
(:func:`evolve_requests`): it yields genome batches and receives evaluation
dicts, so a caller — :func:`evolve` for a single search, or
``repro_torch.core.search.MultiSearch`` for a fleet — decides when and on which
evaluator each batch runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Generator, List, Optional

import numpy as np

from . import es_ops
from .encoding import GenomeSpec
from .es_ops import DeviceSegment
from .sensitivity import SensitivityResult, build_probes, score_probes


@dataclasses.dataclass
class ESConfig:
    pop_size: int = 100
    budget: int = 20_000            # total cost-model evaluations
    parent_frac: float = 0.4
    elite_frac: float = 0.1
    p_mutation: float = 0.9
    genes_per_mutation: int = 2
    # ablation switches (Fig. 18)
    use_hshi: bool = True
    use_custom_ops: bool = True     # annealing mutation + SA crossover
    # HSHI parameters (§IV.D: ~100 cubes, budget 20 random tries each)
    n_cubes: Optional[int] = None   # default: pop_size
    cube_budget: int = 20
    # sensitivity calibration
    calib_contexts: int = 6
    calib_samples: int = 12
    # beyond-paper: restart on stagnation
    stagnation_restart: int = 0     # 0 = off; else #gens with no improvement
    seed: int = 0
    # device-resident rounds (COMPAT.md "Device-resident round protocol"):
    # with device_rounds=k>1 the main loop yields DeviceSegment requests
    # covering k generations each instead of per-generation batches; a
    # caller that can't execute segments sends None and the generator
    # replays the identical plan on the host.  rng_backend picks where
    # the per-generation randomness comes from: "numpy" (the legacy
    # Generator stream, so k>1 makes the same operator choices as k=1)
    # or "torch" (a torch.Generator keyed by (seed, generation) — a
    # different stream, the counterpart of the JAX package's
    # "threefry").  stagnation_restart > 0 no
    # longer forces the per-round path: restart segments pre-draw one
    # fresh LHS block per generation and the segment adopts it via a
    # re-init branch on the carried (best-so-far, stagnant-gens) state
    # — a different rng consumption order than the host-adaptive
    # device_rounds=1 restart, by design (fixed shapes need the draws
    # up front), but identical between the device segment and its host
    # replay (test-pinned).
    device_rounds: int = 1
    rng_backend: str = "numpy"


@dataclasses.dataclass
class SearchResult:
    best_edp: float
    best_genome: Optional[np.ndarray]
    history: np.ndarray             # best-so-far EDP after each evaluation
    evals: int
    valid_evals: int
    extras: Dict = dataclasses.field(default_factory=dict)

    @property
    def valid_fraction(self) -> float:
        return self.valid_evals / max(self.evals, 1)


class _Budget:
    """Tracks best-so-far vs evaluation count across batched evals."""

    def __init__(self, budget: int):
        self.budget = budget
        self.evals = 0
        self.valid = 0
        self.best = np.inf
        self.best_genome: Optional[np.ndarray] = None
        self.hist: List[float] = []
        self.last_n = 0                 # rows counted by the last register

    def register(self, genomes: np.ndarray, out: Dict) -> np.ndarray:
        """Record a batch; returns a full-length EDP array: ``inf`` where
        a row was evaluated and invalid, ``NaN`` where the batch was
        truncated by the budget and the row was NOT counted.  The NaN tail
        is deliberate — selection code must not mistake budget truncation
        for "evaluated and invalid" (both compare False and sort last, but
        only NaN rows may be dropped from learning updates).  The number
        of counted rows is also exposed as ``last_n``."""
        n = min(len(genomes), self.budget - self.evals)
        self.last_n = n
        valid = np.asarray(out["valid"])[:n]
        edp = np.asarray(out["edp"], dtype=np.float64)[:n].copy()
        edp[~valid] = np.inf
        if n > 0:
            # best-so-far curve over the batch, continuing self.best
            curve = np.minimum(np.minimum.accumulate(edp), self.best)
            if curve[-1] < self.best:
                i = int(np.argmin(edp))     # first index achieving the min
                self.best = float(edp[i])
                self.best_genome = genomes[i].copy()
            self.hist.extend(curve.tolist())
            self.evals += n
            self.valid += int(valid.sum())
        full = np.full(len(genomes), np.nan)
        full[:n] = edp
        return full

    @property
    def exhausted(self) -> bool:
        return self.evals >= self.budget


# The generator engine yields (B, L) genome batches and is sent back the
# evaluator's output dict for that batch.
Requests = Generator[np.ndarray, Dict, Dict]


def _drive(gen: Requests, batch_eval):
    """Run a request generator to completion against one evaluator and
    return its StopIteration value verbatim.  DeviceSegment requests are
    routed to the evaluator's ``run_segment`` method when it has one
    (``TorchCostModel``); evaluators without one are sent ``None`` and the
    generator replays the segment on the host — same trajectory either
    way (all randomness rides in the segment's plan)."""
    try:
        req = next(gen)
        while True:
            if isinstance(req, DeviceSegment):
                runner = getattr(batch_eval, "run_segment", None)
                out = runner(req) if runner is not None else None
            else:
                out = batch_eval(req)
            req = gen.send(out)
    except StopIteration as stop:
        return stop.value


# ---------------------------------------------------------------- HSHI


def _hshi_requests(spec: GenomeSpec, sens: SensitivityResult,
                   rng: np.random.Generator, pop_size: int,
                   n_cubes: Optional[int], cube_budget: int,
                   tracker: _Budget) -> Requests:
    """High-sensitivity hypercube initialization (Fig. 11), vectorized:
    each round draws ONE (n_cubes, L) candidate matrix — low-sensitivity
    genes seeded from the calibration valid pool with a single masked
    gather, cube constraints applied as per-cube [low, high) windows on
    the high-sensitivity columns."""
    L = spec.length
    ub = spec.gene_ub
    n_cubes = n_cubes or pop_size
    hi = sens.high_indices
    H = len(hi)

    # per-gene bin counts whose product ~ n_cubes
    bins = np.ones(L, dtype=np.int64)
    if H > 0:
        per = max(1, int(round(n_cubes ** (1.0 / H))))
        bins[hi] = np.minimum(per, ub[hi])

    n_list = max(n_cubes, pop_size)
    # mixed-radix cube coordinates for every cube: (n_list, H)
    total = int(np.prod(bins[hi])) if H else 1
    cc = np.arange(n_list, dtype=np.int64) % max(total, 1)
    coords = np.empty((n_list, H), dtype=np.int64)
    for j, g in enumerate(hi):
        coords[:, j] = cc % bins[g]
        cc //= bins[g]
    if H:
        lowv = (ub[hi][None, :] * coords) // bins[hi][None, :]
        highv = np.maximum(
            lowv + 1, (ub[hi][None, :] * (coords + 1)) // bins[hi][None, :])

    low_mask = np.zeros(L, dtype=bool)
    low_mask[sens.low_indices] = True
    pool = sens.valid_pool

    found = np.zeros((n_list, L), dtype=np.int64)
    found_edp = np.full(n_list, np.inf)
    has_found = np.zeros(n_list, dtype=bool)
    fallback: Optional[np.ndarray] = None

    for _ in range(cube_budget):
        if has_found.all() or tracker.exhausted:
            break
        g = spec.random_genomes(rng, n_list)
        # low-sensitivity genes: seed from the calibration valid pool
        if len(pool) > 0:
            take = rng.random(n_list) < 0.5
            rows = rng.integers(0, len(pool), n_list)
            g = np.where(take[:, None] & low_mask[None, :],
                         pool[rows], g)
        if H:
            g[:, hi] = lowv + (rng.random((n_list, H)) *
                               (highv - lowv)).astype(np.int64)
        cands = spec.clip(g)
        out = yield cands
        edp = tracker.register(cands, out)[:n_list]
        fallback = cands
        better = np.isfinite(edp) & (edp < found_edp)
        found_edp = np.where(better, edp, found_edp)
        found = np.where(better[:, None], cands, found)
        has_found |= better

    pop = np.where(has_found[:, None], found,
                   fallback if fallback is not None
                   else spec.random_genomes(rng, n_list))
    if len(pop) < pop_size:     # unreachable (n_list >= pop_size); safety
        pop = np.concatenate(
            [pop, spec.random_genomes(rng, pop_size - len(pop))], axis=0)
    return pop[:pop_size]


def hshi_init(spec: GenomeSpec, batch_eval, sens: SensitivityResult,
              rng: np.random.Generator, pop_size: int,
              n_cubes: Optional[int], cube_budget: int,
              tracker: _Budget) -> np.ndarray:
    """Drive :func:`_hshi_requests` against a single evaluator."""
    return _drive(_hshi_requests(spec, sens, rng, pop_size, n_cubes,
                                 cube_budget, tracker), batch_eval)


def lhs_init(spec: GenomeSpec, rng: np.random.Generator,
             pop_size: int) -> np.ndarray:
    """Latin hypercube sampling over all genes (standard-ES baseline).
    One permuted strata matrix; every column is an independent shuffle."""
    L = spec.length
    strata = np.broadcast_to(
        np.arange(pop_size, dtype=np.float64)[:, None],
        (pop_size, L)).copy()
    strata = rng.permuted(strata, axis=0)
    strata = (strata + rng.random((pop_size, L))) / pop_size
    g = (strata * spec.gene_ub[None, :].astype(np.float64)
         ).astype(np.int64)
    return spec.clip(g)


# ---------------------------------------------------------------- operators


def annealing_p_high(gen: int, total_gens: int) -> float:
    """Eq. (6): P_h(g) = 0.8 * exp(-phi) * (1 - phi), phi = g/G."""
    phi = gen / max(total_gens, 1)
    return 0.8 * math.exp(-phi) * (1.0 - phi)


def mutate(genomes: np.ndarray, spec: GenomeSpec, rng: np.random.Generator,
           p_mut: float, genes_per: int,
           sens: Optional[SensitivityResult], p_high: float) -> np.ndarray:
    """Annealing mutation (sens given) or uniform mutation (sens=None).

    Fully batched: gene indices are drawn as an (n, genes_per) matrix —
    one shared uniform draw mapped into the high- or low-sensitivity
    segment per row — and the replacement values come from a single
    element-wise ``rng.integers(0, ub[gene])`` call.  Duplicate draws
    within a row overwrite in draw order, exactly like the sequential
    formulation."""
    n = len(genomes)
    if n == 0 or genes_per <= 0:
        return genomes.copy()
    hi, lo = es_ops.mutation_index_tables(spec.length, sens)
    active, gene, vals = es_ops.plan_mutation(
        rng, n, spec.gene_ub, genes_per, p_mut, p_high, hi, lo)
    return es_ops.apply_mutation(genomes, active, gene, vals)


def crossover(parents: np.ndarray, n_children: int, spec: GenomeSpec,
              rng: np.random.Generator,
              sens: Optional[SensitivityResult]) -> np.ndarray:
    """Single-point crossover.  With ``sens``: sensitivity-aware — cut
    points restricted to high-sensitivity segment boundaries (plus genome
    ends), never splitting a high-sensitivity run.

    Batched: parent pairs and cut points are drawn as vectors and all
    children are assembled with one ``np.where`` over the gene index
    grid."""
    cut_arr = es_ops.crossover_cut_points(spec.length, sens)
    ab, cuts = es_ops.plan_crossover(rng, n_children, len(parents), cut_arr)
    kids = es_ops.apply_crossover(parents, ab, cuts)
    return np.ascontiguousarray(kids, dtype=parents.dtype)


# ---------------------------------------------------------------- main loop


def calib_plan(length: int, cfg: ESConfig) -> tuple:
    """The (n_contexts, n_samples) the sensitivity calibration actually
    uses after shrinking to keep init+calibration under ~10% of the
    budget.  The probe batch the generator's FIRST yield carries has
    exactly ``n_ctx * n_smp * length`` rows."""
    calib_target = max(int(0.10 * cfg.budget), 2 * length)
    n_ctx = cfg.calib_contexts
    n_smp = cfg.calib_samples
    while n_ctx * n_smp * length > calib_target and n_ctx > 2:
        n_ctx -= 1
    while n_ctx * n_smp * length > calib_target and n_smp > 4:
        n_smp -= 1
    return n_ctx, n_smp


def evolve_requests(spec: GenomeSpec, cfg: ESConfig, tracker: _Budget,
                    sens: Optional[SensitivityResult] = None,
                    fixed_genes: Optional[Dict[int, int]] = None,
                    seeds: Optional[np.ndarray] = None,
                    resume: Optional[Dict] = None,
                    state_out: Optional[Dict] = None) -> Requests:
    """The ES as a request generator: ``yield``s every genome batch that
    needs evaluating and is ``send``-ed the evaluator's output dict.

    This is the primitive both :func:`evolve` (single search) and
    ``search.MultiSearch`` (many concurrent searches round-robined over
    shared batch evaluators) are built on.  Returns the extras dict via
    ``StopIteration.value``; all bookkeeping lives in ``tracker``.

    Checkpoint/resume (the sweep server's durability contract): pass a
    dict as ``state_out`` and the generator refreshes
    ``state_out["resume"]`` at the TOP of every main-loop generation —
    *before* that generation's rng draws — so a checkpoint taken while
    the generator is suspended at ``yield kids`` re-draws the in-flight
    generation identically on restore.  Passing such a captured dict
    back as ``resume=`` (with ``resume["tracker"]["hist"]`` filled in —
    the capture records only ``hist_len`` to keep the per-generation
    cost O(pop), see :func:`snapshot_tracker_hist`) skips calibration /
    init entirely and restores rng, population, and tracker bit-exactly:
    the resumed trajectory equals the uninterrupted one at fixed seeds.
    No ``state_out["resume"]`` exists until the first main-loop
    generation (the HSHI/calibration prologue is cheap to replay from
    scratch).  Resume requires ``device_rounds == 1`` — pipelined device
    segments keep populations device-resident and are not cleanly
    checkpointable at a generation boundary.
    """
    rng = np.random.default_rng(cfg.seed)

    def apply_fixed(g: np.ndarray) -> np.ndarray:
        if fixed_genes:
            for k, v in fixed_genes.items():
                g[..., k] = v
        return g

    if resume is not None:
        if cfg.device_rounds > 1:
            raise ValueError(
                "resume requires device_rounds == 1: device segments keep "
                "populations device-resident with no generation-boundary "
                "checkpoint (COMPAT.md 'Sweep server protocol')")
        rng.bit_generator.state = resume["rng_state"]
        sens = resume["sens"]
        pop = np.asarray(resume["pop"], dtype=np.int64).copy()
        edp = np.asarray(resume["edp"], dtype=np.float64).copy()
        gen = int(resume["gen"])
        since_improve = int(resume["since_improve"])
        last_best = float(resume["last_best"])
        total_gens = int(resume["total_gens"])
        t = resume["tracker"]
        tracker.evals = int(t["evals"])
        tracker.valid = int(t["valid"])
        tracker.best = float(t["best"])
        tracker.best_genome = None if t.get("best_genome") is None \
            else np.asarray(t["best_genome"]).copy()
        tracker.hist = list(t["hist"])
    else:
        # -- sensitivity calibration (needed by HSHI + custom operators)
        # The paper keeps init+calibration under ~10% of total search
        # time; we shrink the per-gene sampling to respect that at small
        # CI budgets.
        if (cfg.use_hshi or cfg.use_custom_ops) and sens is None:
            n_ctx, n_smp = calib_plan(spec.length, cfg)
            probes, gene_idx, sampled_vals = build_probes(
                spec, rng, n_contexts=n_ctx, n_samples=n_smp)
            out = yield probes
            sens = score_probes(spec, probes, gene_idx, sampled_vals,
                                out, rng, n_contexts=n_ctx, n_samples=n_smp)
            tracker.evals += sens.evals_used        # calibration counts
            tracker.hist.extend([tracker.best] * sens.evals_used)

        # ---- initialization ----
        if cfg.use_hshi and sens is not None:
            n_cubes = cfg.n_cubes or cfg.pop_size
            cube_budget = min(
                cfg.cube_budget,
                max(2, int(0.15 * cfg.budget) // max(n_cubes, 1)))
            pop = yield from _hshi_requests(spec, sens, rng, cfg.pop_size,
                                            n_cubes, cube_budget, tracker)
        else:
            pop = lhs_init(spec, rng, cfg.pop_size)
        if seeds is not None and len(seeds):
            pop[: len(seeds)] = seeds[: len(pop)]
        pop = apply_fixed(pop)
        out = yield pop
        edp = tracker.register(pop, out)
        gen = 0
        since_improve = 0
        last_best = tracker.best
        total_gens = max(1, (cfg.budget - tracker.evals) // cfg.pop_size)

    op_sens = sens if cfg.use_custom_ops else None
    n_parents = max(2, int(cfg.pop_size * cfg.parent_frac))
    n_elite = max(1, int(cfg.pop_size * cfg.elite_frac))

    if cfg.device_rounds > 1:
        if cfg.stagnation_restart:
            extras = yield from _restart_segment_requests(
                spec, cfg, tracker, rng, op_sens, fixed_genes, pop, edp,
                n_parents, n_elite, total_gens)
        else:
            extras = yield from _segment_requests(
                spec, cfg, tracker, rng, op_sens, fixed_genes, pop, edp,
                n_parents, n_elite, total_gens)
        extras["sensitivity"] = None if sens is None else sens.scores
        return extras

    while not tracker.exhausted:
        if state_out is not None:
            # pre-draw capture: restoring this state replays the
            # CURRENT generation's draws identically (the suspended
            # ``yield kids`` batch is re-derived, never stored)
            state_out["resume"] = dict(
                rng_state=rng.bit_generator.state,
                pop=pop.copy(), edp=edp.copy(), gen=gen,
                since_improve=since_improve, last_best=last_best,
                total_gens=total_gens, sens=sens,
                tracker=dict(
                    evals=tracker.evals, valid=tracker.valid,
                    best=tracker.best,
                    best_genome=None if tracker.best_genome is None
                    else tracker.best_genome.copy(),
                    hist_len=len(tracker.hist)))
        order = np.argsort(edp)
        parents = pop[order[:n_parents]]
        elites = pop[order[:n_elite]].copy()
        elite_edp = edp[order[:n_elite]].copy()

        p_high = annealing_p_high(gen, total_gens)
        kids = crossover(parents, cfg.pop_size - n_elite, spec, rng, op_sens)
        kids = mutate(kids, spec, rng, cfg.p_mutation,
                      cfg.genes_per_mutation, op_sens, p_high)
        kids = apply_fixed(spec.clip(kids))
        kout = yield kids
        kedp = tracker.register(kids, kout)

        pop = np.concatenate([elites, kids], axis=0)
        edp = np.concatenate([elite_edp, kedp])
        gen += 1

        if tracker.best < last_best:
            last_best = tracker.best
            since_improve = 0
        else:
            since_improve += 1
        if cfg.stagnation_restart and since_improve >= cfg.stagnation_restart:
            # beyond-paper: re-seed the non-elite population
            fresh = lhs_init(spec, rng, cfg.pop_size - n_elite)
            fresh = apply_fixed(fresh)
            fout = yield fresh
            fedp = tracker.register(fresh, fout)
            pop = np.concatenate([elites, fresh], axis=0)
            edp = np.concatenate([elite_edp, fedp])
            since_improve = 0

    return dict(generations=gen,
                sensitivity=None if sens is None else sens.scores)


def snapshot_tracker_hist(tracker: _Budget, captured: Dict) -> Dict:
    """Complete a ``state_out["resume"]`` capture into a self-contained
    resume dict.  The per-generation capture records only ``hist_len``
    (copying the full best-so-far history every generation would be
    O(budget) per round); this copies the matching history prefix out of
    the still-live tracker — call it at checkpoint-save time, before the
    process can die."""
    out = dict(captured)
    t = dict(captured["tracker"])
    t["hist"] = list(tracker.hist[: t.pop("hist_len")])
    out["tracker"] = t
    return out


def _segment_requests(spec: GenomeSpec, cfg: ESConfig, tracker: _Budget,
                      rng: np.random.Generator,
                      op_sens: Optional[SensitivityResult],
                      fixed_genes: Optional[Dict[int, int]],
                      pop: np.ndarray, edp: np.ndarray,
                      n_parents: int, n_elite: int,
                      total_gens: int) -> Requests:
    """The device-resident main loop: yields :class:`DeviceSegment`
    requests covering ``cfg.device_rounds`` generations each.  All
    per-generation randomness is planned up front (numpy Generator
    stream, or a torch.Generator keyed by (seed, generation)), so a caller that
    executes the segment on-device (``torch_cost.run_segments``) and a
    caller that sends back ``None`` — making this generator replay the
    plan as ordinary per-generation batch requests — produce the same
    operator choices.  Selection uses the shared *stable* fitness order
    (``es_ops.stable_order``) in both paths; the legacy per-round loop's
    unstable ``np.argsort`` can differ on ties, which is one of the two
    test-pinned parity seams (the other: in-segment float32 EDP vs the
    host-recomputed canonical EDP).

    PIPELINED DISPATCH (COMPAT.md "Pipelined dispatch contract"): this
    generator never blocks on the segment it just received.  The
    response for segment N is stashed unresolved; segment N+1 is planned
    from the ``planned`` evaluation counter (which replicates
    ``_Budget.register``'s value-independent truncation arithmetic, so
    budget exhaustion is known without harvesting) and yielded carrying
    ``resp.carry`` — the device-resident padded (pop, edp) — and only
    THEN is segment N resolved and registered.  With an async caller
    (``run_segments(..., defer=True)``) the host's blocking conversion
    of round N overlaps the device executing round N+1; with a
    synchronous caller the very same code runs, merely blocking earlier
    — registration order and values are identical by construction, which
    is the ``pipeline=False`` escape hatch's bit-identity guarantee."""
    cut_arr = es_ops.crossover_cut_points(spec.length, op_sens)
    hi, lo = es_ops.mutation_index_tables(spec.length, op_sens)
    k = cfg.device_rounds
    n_children = cfg.pop_size - n_elite
    edp_sel = np.asarray(edp, dtype=np.float32)
    gen = 0

    def make_plans(g0):
        if cfg.rng_backend == "torch":
            return [es_ops.torch_plan_generation(
                cfg.seed, g0 + i, n_children=n_children,
                n_parents=n_parents, cut_arr=cut_arr,
                gene_ub=spec.gene_ub, genes_per=cfg.genes_per_mutation,
                p_mut=cfg.p_mutation,
                p_high=annealing_p_high(g0 + i, total_gens),
                hi=hi, lo=lo) for i in range(k)]
        return [es_ops.plan_generation(
            rng, n_children=n_children, n_parents=n_parents,
            cut_arr=cut_arr, gene_ub=spec.gene_ub,
            genes_per=cfg.genes_per_mutation, p_mut=cfg.p_mutation,
            p_high=annealing_p_high(g0 + i, total_gens),
            hi=hi, lo=lo) for i in range(k)]

    def absorb(resp):
        nonlocal pop, edp_sel, gen
        resp.resolve()
        for kids, kout in resp.gens:
            tracker.register(kids, kout)
            gen += 1
        pop = resp.final_pop
        edp_sel = np.asarray(resp.final_edp, dtype=np.float32)

    planned = tracker.evals
    gen_planned = 0
    pending = None
    carry = None
    while planned < cfg.budget:
        plans = make_plans(gen_planned)
        for _ in range(k):
            planned += min(n_children, cfg.budget - planned)
        gen_planned += k
        resp = yield DeviceSegment(
            spec=spec, pop=pop, edp=edp_sel, rounds=k,
            gen0=gen_planned - k, n_parents=n_parents, n_elite=n_elite,
            genes_per=cfg.genes_per_mutation,
            draws=es_ops.stack_draws(plans), fixed_genes=fixed_genes,
            rng_backend=cfg.rng_backend, carry=carry)
        if resp is None:
            # host replay of the identical plan, one generation per yield
            for d in plans:
                parents, elites, elite_edp = es_ops.select(
                    pop, edp_sel, n_parents, n_elite)
                kids = np.ascontiguousarray(
                    es_ops.apply_crossover(parents, d.ab, d.cuts),
                    dtype=pop.dtype)
                kids = es_ops.apply_mutation(kids, d.active, d.gene,
                                             d.vals)
                kids = spec.clip(kids)
                if fixed_genes:
                    for idx, v in fixed_genes.items():
                        kids[..., idx] = v
                kout = yield kids
                tracker.register(kids, kout)
                kedp = np.where(
                    np.asarray(kout["valid"]),
                    np.asarray(kout["edp"], dtype=np.float32),
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
    return dict(generations=gen)


def _restart_segment_requests(spec: GenomeSpec, cfg: ESConfig,
                              tracker: _Budget,
                              rng: np.random.Generator,
                              op_sens: Optional[SensitivityResult],
                              fixed_genes: Optional[Dict[int, int]],
                              pop: np.ndarray, edp: np.ndarray,
                              n_parents: int, n_elite: int,
                              total_gens: int) -> Requests:
    """Device-resident rounds WITH stagnation restart: each segment
    additionally pre-draws one fresh LHS block per generation (fixed
    shapes — the segment always evaluates it but only ADOPTS it when the
    carried stagnation counter trips; only adopted blocks are
    registered, so the eval budget is spent exactly like an adaptive
    restart).  The carried (best-so-far f32, stagnant-generations)
    state crosses segments via ``DeviceSegment.state`` /
    ``SegmentResult.state``.

    Because whether a restart fired — and therefore how many evaluations
    were registered — is DATA-dependent, this generator harvests eagerly
    (``resp.resolve()`` on receipt) instead of one round late; a
    pipelined fleet caller still overlaps it with the other tasks'
    deferred segments in the same round."""
    cut_arr = es_ops.crossover_cut_points(spec.length, op_sens)
    hi, lo = es_ops.mutation_index_tables(spec.length, op_sens)
    k = cfg.device_rounds
    R = int(cfg.stagnation_restart)
    n_children = cfg.pop_size - n_elite
    edp_sel = np.asarray(edp, dtype=np.float32)
    best = np.float32(np.min(edp_sel)) if len(edp_sel) else \
        np.float32(np.inf)
    since = 0
    gen = 0

    def apply_fixed(g: np.ndarray) -> np.ndarray:
        if fixed_genes:
            for idx, v in fixed_genes.items():
                g[..., idx] = v
        return g

    while not tracker.exhausted:
        if cfg.rng_backend == "torch":
            plans = [es_ops.torch_plan_generation(
                cfg.seed, gen + i, n_children=n_children,
                n_parents=n_parents, cut_arr=cut_arr,
                gene_ub=spec.gene_ub, genes_per=cfg.genes_per_mutation,
                p_mut=cfg.p_mutation,
                p_high=annealing_p_high(gen + i, total_gens),
                hi=hi, lo=lo) for i in range(k)]
        else:
            plans = [es_ops.plan_generation(
                rng, n_children=n_children, n_parents=n_parents,
                cut_arr=cut_arr, gene_ub=spec.gene_ub,
                genes_per=cfg.genes_per_mutation, p_mut=cfg.p_mutation,
                p_high=annealing_p_high(gen + i, total_gens),
                hi=hi, lo=lo) for i in range(k)]
        # fresh re-init blocks, one per generation, drawn AFTER the
        # generation plans (deterministic stream order either backend)
        fresh = np.stack([apply_fixed(lhs_init(spec, rng, n_children))
                          for _ in range(k)])
        draws = es_ops.stack_draws(plans)
        draws["fresh"] = fresh
        resp = yield DeviceSegment(
            spec=spec, pop=pop, edp=edp_sel, rounds=k, gen0=gen,
            n_parents=n_parents, n_elite=n_elite,
            genes_per=cfg.genes_per_mutation, draws=draws,
            fixed_genes=fixed_genes, rng_backend=cfg.rng_backend,
            restart=R, state=(float(best), int(since)))
        if resp is None:
            # host replay mirroring step_restart's f32 state machine
            for i, d in enumerate(plans):
                parents, elites, elite_edp = es_ops.select(
                    pop, edp_sel, n_parents, n_elite)
                kids = np.ascontiguousarray(
                    es_ops.apply_crossover(parents, d.ab, d.cuts),
                    dtype=pop.dtype)
                kids = es_ops.apply_mutation(kids, d.active, d.gene,
                                             d.vals)
                kids = apply_fixed(spec.clip(kids))
                kout = yield kids
                tracker.register(kids, kout)
                kedp = np.where(
                    np.asarray(kout["valid"]),
                    np.asarray(kout["edp"], dtype=np.float32),
                    np.float32(np.inf)).astype(np.float32)
                kbest = np.float32(min(best, kedp.min()))
                since = 0 if kbest < best else since + 1
                best = kbest
                gen += 1
                if since >= R:
                    fr = fresh[i].astype(pop.dtype)
                    fout = yield fr
                    tracker.register(fr, fout)
                    fedp = np.where(
                        np.asarray(fout["valid"]),
                        np.asarray(fout["edp"], dtype=np.float32),
                        np.float32(np.inf)).astype(np.float32)
                    pop = np.concatenate([elites, fr], axis=0)
                    edp_sel = np.concatenate(
                        [np.asarray(elite_edp, np.float32), fedp])
                    best = np.float32(min(best, fedp.min()))
                    since = 0
                else:
                    pop = np.concatenate([elites, kids], axis=0)
                    edp_sel = np.concatenate(
                        [np.asarray(elite_edp, np.float32), kedp])
                if tracker.exhausted:
                    break
        else:
            resp.resolve()      # eager: restart consumption is adaptive
            for i, (kids, kout) in enumerate(resp.gens):
                tracker.register(kids, kout)
                gen += 1
                if kout.get("restarted"):
                    fr = draws["fresh"][i].astype(np.int64)
                    tracker.register(fr, kout["fresh"])
                if tracker.exhausted:
                    break
            pop = resp.final_pop
            edp_sel = np.asarray(resp.final_edp, dtype=np.float32)
            best = np.float32(resp.state[0])
            since = int(resp.state[1])
    return dict(generations=gen)


def evolve(spec: GenomeSpec, batch_eval, cfg: ESConfig,
           sens: Optional[SensitivityResult] = None,
           fixed_genes: Optional[Dict[int, int]] = None,
           seeds: Optional[np.ndarray] = None) -> SearchResult:
    """Run SparseMap's ES (or an ablation variant) under an eval budget.

    ``fixed_genes`` pins gene indices to values (used by the SAGE-like
    baseline to freeze the mapping segment).  ``seeds`` (n, L) are injected
    into the initial population verbatim.
    """
    tracker = _Budget(cfg.budget)
    extras = _drive(
        evolve_requests(spec, cfg, tracker, sens=sens,
                        fixed_genes=fixed_genes, seeds=seeds),
        batch_eval) or {}
    return SearchResult(
        best_edp=tracker.best, best_genome=tracker.best_genome,
        history=np.asarray(tracker.hist), evals=tracker.evals,
        valid_evals=tracker.valid, extras=extras)
