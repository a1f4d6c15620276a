"""Baseline optimizers (SparseMap §III.C, §V) + prior-work proxies.

Every method consumes the same genome representation (`GenomeSpec`), the
same batch evaluator and the same evaluation budget, and returns a
`SearchResult` so convergence curves are directly comparable (Fig. 17/18).

Each optimizer is written as a *request generator* (``*_requests``)
conforming to the :data:`repro_torch.core.evolution.Requests` protocol: it
``yield``s every (B, L) genome batch that needs evaluating, is ``send``-ed
the evaluator's output dict, and returns an extras dict via
``StopIteration``.  The closed-form functions (``pso``, ``tbpsa``, ...)
simply drive their generator against one evaluator; ``search.MultiSearch``
instead round-robins a heterogeneous fleet of generators over shared
batch evaluators — optionally concatenating all same-signature pending
batches into one mega-batch dispatch per round.  ``make_requests`` is the
registry entry point for callers.

Prior-work proxies (§V):
* ``random_mapper``  — Sparseloop-Mapper-like: random mapping sampling under
  a fixed, manually chosen sparse strategy.
* ``sage_like``      — SAGE-like: sparse-strategy search under a fixed
  (balanced output-stationary) mapping.

Classical baselines (Fig. 17): PSO, MCTS, TBPSA, PPO, DQN — compact but
faithful implementations; they are *expected* to drown in invalid points,
which is the paper's point.  ``standard_es`` runs on the DIRECT value
encoding; its generator (``direct_encoding.direct_requests``) translates
valid direct genomes to canonical rows before yielding them, so even the
direct-encoding ablation joins a mega-batched fleet.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .arch import ArchSpec, as_arch
from .encoding import GenomeSpec
from .evolution import (ESConfig, Requests, SearchResult, _Budget, _drive,
                        evolve_requests)
from .mapping import balanced_mapping_for_arch
from .sparse import MAX_FMT_GENES


# ---------------------------------------------------------------- helpers


def _finish(tracker: _Budget, **extras) -> SearchResult:
    return SearchResult(best_edp=tracker.best,
                        best_genome=tracker.best_genome,
                        history=np.asarray(tracker.hist),
                        evals=tracker.evals, valid_evals=tracker.valid,
                        extras=extras)


def _run_closed(method: str, spec: GenomeSpec, batch_eval, budget: int,
                seed: int, platform=None, **kw) -> SearchResult:
    """Drive a registered request generator to completion against one
    evaluator — the closed-form path every ``METHODS`` entry uses, so a
    sequential ``search.run`` and a concurrent ``search.MultiSearch`` task
    execute literally the same code."""
    gen, tracker = make_requests(method, spec, platform, budget, seed, **kw)
    extras = _drive(gen, batch_eval) or {}
    return _finish(tracker, **extras)


def manual_sparse_genes(spec: GenomeSpec) -> Dict[int, int]:
    """A sensible hand-picked sparse strategy (the 'manually specified
    sparse strategy' a Sparseloop-Mapper user would fix): bitmask on the two
    innermost sub-dims of P and Q, uncompressed Z, no store-site S/G,
    skip P<->Q at compute (the last S/G site of any arch)."""
    fixed: Dict[int, int] = {}
    for tn in spec.tensor_names:
        seg = spec.segments[f"fmt_{tn}"]
        genes = [0, 0, 0, 1, 1] if tn != "Z" else [0] * MAX_FMT_GENES
        for i, v in enumerate(genes):
            fixed[seg.start + i] = v
    sg = spec.segments["sg"]
    for i in range(sg.start, sg.stop - 1):
        fixed[i] = 0             # store sites: none
    fixed[sg.stop - 1] = 6       # C: skip P<->Q
    return fixed


def _freeze_mapping_genes(spec: GenomeSpec, mapping) -> Dict[int, int]:
    g = spec.encode_mapping(mapping)
    fixed: Dict[int, int] = {}
    for seg_name in ("perm", "tiling"):
        seg = spec.segments[seg_name]
        for i in range(seg.start, seg.stop):
            fixed[i] = int(g[i])
    return fixed


def fixed_mapping_genes_for_arch(spec: GenomeSpec, arch: ArchSpec
                                 ) -> Dict[int, int]:
    """Freeze the mapping segment to the balanced OS mapping on ``arch``
    (SAGE-like).  ``arch`` must share the spec's topology (it supplies
    the fanout numbers; e.g. the resolved edge/mobile/cloud platform)."""
    return _freeze_mapping_genes(
        spec, balanced_mapping_for_arch(spec.workload, arch))


def fixed_mapping_genes(spec: GenomeSpec, n_pe: int, macs_per_pe: int
                        ) -> Dict[int, int]:
    """Paper-topology convenience variant taking explicit fanout caps."""
    from .mapping import balanced_mapping
    return _freeze_mapping_genes(
        spec, balanced_mapping(spec.workload, n_pe, macs_per_pe))


# ---------------------------------------------------------------- proxies


def random_mapper_requests(spec: GenomeSpec, tracker: _Budget, seed: int,
                           platform=None) -> Requests:
    """Sparseloop-Mapper-like: uniform random mapping search, sparse
    strategy fixed manually.  (The paper incorporates the manual settings
    into its random sampling space.)"""
    rng = np.random.default_rng(seed)
    fixed = manual_sparse_genes(spec)
    chunk = 512
    while not tracker.exhausted:
        g = spec.random_genomes(
            rng, min(chunk, tracker.budget - tracker.evals))
        for k, v in fixed.items():
            g[:, k] = v
        out = yield g
        tracker.register(g, out)
    return dict(method="random_mapper")


def random_mapper(spec: GenomeSpec, batch_eval, budget: int, seed: int,
                  platform=None) -> SearchResult:
    return _run_closed("random_mapper", spec, batch_eval, budget, seed,
                       platform)


def _sage_like_setup(spec: GenomeSpec, platform, budget: int, seed: int,
                     **kw) -> Tuple[ESConfig, Dict[int, int], np.ndarray]:
    """SAGE-like search space: fixed balanced-OS mapping, format genes of
    spatially-unrolled sub-dimensions pinned uncompressed, started from the
    engineer's uncompressed default."""
    from .cost_model import spatial_subdim_indices, tiled_subdims
    fixed = fixed_mapping_genes_for_arch(spec, as_arch(platform))
    # pin format genes of spatially-unrolled sub-dimensions to U
    genome0 = np.zeros(spec.length, dtype=np.int64)
    for k, v in fixed.items():
        genome0[k] = v
    mapping = spec.decode(genome0).mapping
    for tn in spec.tensor_names:
        seg = spec.segments[f"fmt_{tn}"]
        k = len(tiled_subdims(mapping, tn))
        for i in spatial_subdim_indices(mapping, tn):
            gidx = i + max(MAX_FMT_GENES - k, 0)
            if 0 <= gidx < MAX_FMT_GENES:
                fixed[seg.start + gidx] = 0
    params = dict(use_hshi=False, use_custom_ops=False, pop_size=64)
    params.update(kw)
    cfg = ESConfig(budget=budget, seed=seed, **params)
    return cfg, fixed, genome0


def sage_like(spec: GenomeSpec, batch_eval, budget: int, seed: int,
              platform, **kw) -> SearchResult:
    """SAGE-like: sparse-strategy search under a FIXED mapping (the
    balanced output-stationary mapping).

    SAGE knows its accelerator template, so the search space excludes
    format choices that are structurally impossible under the fixed
    mapping (formats on spatially-unrolled sub-dimensions stay
    uncompressed), and it starts from the engineer's uncompressed default.
    What it cannot do — the paper's point — is adapt the mapping itself.
    """
    return _run_closed("sage_like", spec, batch_eval, budget, seed,
                       platform, **kw)


# ---------------------------------------------------------------- PSO


def pso_requests(spec: GenomeSpec, tracker: _Budget, seed: int,
                 platform=None, n_particles: int = 50, w: float = 0.72,
                 c1: float = 1.49, c2: float = 1.49) -> Requests:
    rng = np.random.default_rng(seed)
    L = spec.length
    ub = spec.gene_ub.astype(np.float64)
    x = rng.random((n_particles, L)) * ub
    v = (rng.random((n_particles, L)) - 0.5) * ub * 0.2
    pbest_x = x.copy()
    pbest_f = np.full(n_particles, np.inf)
    gbest_x = x[0].copy()
    gbest_f = np.inf
    while not tracker.exhausted:
        g = spec.clip(x.astype(np.int64))
        out = yield g
        edp = tracker.register(g, out)
        improved = edp < pbest_f            # NaN tail compares False
        pbest_f = np.where(improved, edp, pbest_f)
        pbest_x[improved] = x[improved]
        i = int(np.argmin(pbest_f))
        if pbest_f[i] < gbest_f:
            gbest_f, gbest_x = pbest_f[i], pbest_x[i].copy()
        r1, r2 = rng.random((2, n_particles, L))
        v = w * v + c1 * r1 * (pbest_x - x) + c2 * r2 * (gbest_x[None] - x)
        x = np.clip(x + v, 0, ub - 1e-6)
    return dict(method="pso")


def pso(spec: GenomeSpec, batch_eval, budget: int, seed: int,
        platform=None, **kw) -> SearchResult:
    return _run_closed("pso", spec, batch_eval, budget, seed, platform,
                       **kw)


# ---------------------------------------------------------------- MCTS


def mcts_requests(spec: GenomeSpec, tracker: _Budget, seed: int,
                  platform=None, max_children: int = 8, c_ucb: float = 1.4,
                  rollout_batch: int = 16) -> Requests:
    """Gene-by-gene tree search with UCB1 selection and random rollouts.
    Large per-gene ranges are subsampled to ``max_children`` branches
    (standard progressive-widening practice)."""
    rng = np.random.default_rng(seed)
    L = spec.length

    class Node:
        __slots__ = ("depth", "children", "visits", "value", "vals")

        def __init__(self, depth: int):
            self.depth = depth
            self.children: Dict[int, Node] = {}
            self.visits = 0
            self.value = 0.0
            self.vals: Optional[np.ndarray] = None

    root = Node(0)

    def reward(edp: float) -> float:
        if not np.isfinite(edp):
            return 0.0
        return 1.0 / (1.0 + math.log10(max(edp, 1.0)))

    while not tracker.exhausted:
        node = root
        prefix: List[int] = []
        # selection / expansion
        while node.depth < L:
            if node.vals is None:
                k = min(max_children, int(spec.gene_ub[node.depth]))
                node.vals = rng.choice(spec.gene_ub[node.depth], size=k,
                                       replace=False)
            unvisited = [v for v in node.vals if v not in node.children]
            if unvisited:
                v = int(unvisited[0])
                node.children[v] = Node(node.depth + 1)
                prefix.append(v)
                node = node.children[v]
                break
            # UCB1
            best_v, best_u = None, -np.inf
            for v, ch in node.children.items():
                u = (ch.value / max(ch.visits, 1) +
                     c_ucb * math.sqrt(math.log(max(node.visits, 1) + 1) /
                                       max(ch.visits, 1)))
                if u > best_u:
                    best_u, best_v = u, v
            prefix.append(int(best_v))
            node = node.children[int(best_v)]
        # rollout: complete randomly (batched)
        n = min(rollout_batch, tracker.budget - tracker.evals)
        g = spec.random_genomes(rng, n)
        g[:, :len(prefix)] = np.asarray(prefix, dtype=np.int64)[None, :]
        out = yield g
        edp = tracker.register(g, out)
        r = max(reward(float(e)) for e in edp)
        # backprop along path
        node = root
        node.visits += 1
        node.value += r
        for v in prefix:
            if v in node.children:
                node = node.children[v]
                node.visits += 1
                node.value += r
            else:
                break
    return dict(method="mcts")


def mcts(spec: GenomeSpec, batch_eval, budget: int, seed: int,
         platform=None, **kw) -> SearchResult:
    return _run_closed("mcts", spec, batch_eval, budget, seed, platform,
                       **kw)


# ---------------------------------------------------------------- TBPSA


def tbpsa_requests(spec: GenomeSpec, tracker: _Budget, seed: int,
                   platform=None, mu: int = 12, llambda: int = 48
                   ) -> Requests:
    """Test-based population-size-adaptation ES (nevergrad's TBPSA family):
    gaussian search distribution in the continuous relaxation, mean/state
    updated from the mu best of each lambda batch."""
    rng = np.random.default_rng(seed)
    L = spec.length
    ub = spec.gene_ub.astype(np.float64)
    mean = ub / 2.0
    sigma = ub / 4.0
    while not tracker.exhausted:
        n = min(llambda, tracker.budget - tracker.evals)
        x = mean[None] + rng.standard_normal((n, L)) * sigma[None]
        g = spec.clip(np.clip(x, 0, ub - 1e-6).astype(np.int64))
        out = yield g
        edp = tracker.register(g, out)
        order = np.argsort(edp)[:mu]
        sel = x[order]
        new_mean = sel.mean(axis=0)
        sigma = 0.9 * sigma + 0.1 * (sel.std(axis=0) + 1e-3)
        mean = np.clip(new_mean, 0, ub - 1e-6)
    return dict(method="tbpsa")


def tbpsa(spec: GenomeSpec, batch_eval, budget: int, seed: int,
          platform=None, **kw) -> SearchResult:
    return _run_closed("tbpsa", spec, batch_eval, budget, seed, platform,
                       **kw)


# ---------------------------------------------------------------- PPO-lite


def ppo_requests(spec: GenomeSpec, tracker: _Budget, seed: int,
                 platform=None, batch: int = 64, lr: float = 0.15,
                 clip_eps: float = 0.2, epochs: int = 3) -> Requests:
    """Factorized-categorical policy over genes, trained with the clipped
    PPO objective on a normalized -log10(EDP) reward; invalid designs give
    reward -1 (the sparse-reward regime the paper §I points at)."""
    rng = np.random.default_rng(seed)
    L = spec.length
    maxv = int(spec.gene_ub.max())
    logits = np.zeros((L, maxv))
    for j in range(L):
        logits[j, spec.gene_ub[j]:] = -1e9
    r_mean, r_std = 0.0, 1.0

    def softmax(z):
        z = z - z.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)

    while not tracker.exhausted:
        n = min(batch, tracker.budget - tracker.evals)
        pi = softmax(logits)                       # (L, V)
        # vectorized inverse-CDF sampling: one uniform matrix, all genes
        cdf = np.cumsum(pi, axis=-1)               # (L, V)
        u = rng.random((n, L))
        g = (u[:, :, None] > cdf[None, :, :]).sum(axis=-1)
        g = np.minimum(g, spec.gene_ub[None, :] - 1).astype(np.int64)
        out = yield g
        edp = tracker.register(g, out)
        rew = np.where(np.isfinite(edp), 0.0, -1.0)
        ok = np.isfinite(edp)
        if ok.any():
            rew[ok] = -np.log10(edp[ok])
            r_mean = 0.9 * r_mean + 0.1 * rew[ok].mean()
            r_std = 0.9 * r_std + 0.1 * (rew[ok].std() + 1e-6)
            rew[ok] = (rew[ok] - r_mean) / max(r_std, 1e-6)
        adv = rew - rew.mean()
        old_pi = pi.copy()
        onehot = np.zeros((n, L, maxv))
        onehot[np.arange(n)[:, None], np.arange(L)[None, :], g] = 1.0
        for _ in range(epochs):
            pi = softmax(logits)
            ratio = (pi[None, :, :] * onehot).sum(-1) / \
                np.maximum((old_pi[None, :, :] * onehot).sum(-1), 1e-9)
            clipped = np.clip(ratio, 1 - clip_eps, 1 + clip_eps)
            use = (np.minimum(ratio * adv[:, None], clipped * adv[:, None])
                   == ratio * adv[:, None])
            w_adv = adv[:, None] * use                     # (n, L)
            grad = (onehot - pi[None, :, :]) * w_adv[:, :, None]
            logits += lr * grad.mean(axis=0)
            for j in range(L):
                logits[j, spec.gene_ub[j]:] = -1e9
    return dict(method="ppo")


def ppo(spec: GenomeSpec, batch_eval, budget: int, seed: int,
        platform=None, **kw) -> SearchResult:
    return _run_closed("ppo", spec, batch_eval, budget, seed, platform,
                       **kw)


# ---------------------------------------------------------------- DQN-lite


def dqn_td_update(q: np.ndarray, g: np.ndarray, rew: np.ndarray,
                  gamma: float, lr: float) -> None:
    """One batched TD(0) update of the factored Q table, in place.

    All targets come from the round's FROZEN Q snapshot: position j
    bootstraps ``gamma * max(q_old[j+1])`` (the terminal position takes
    the episode reward), and the per-(position, value) increments of the
    whole episode batch are accumulated with one ``np.add.at`` — the
    batch analogue of PPO's vectorized sampling.  This deliberately
    replaces the old LIVE-table episode loop (each episode bootstrapped
    off the previous episode's in-round updates, sequential by
    construction and unvectorizable); the frozen-snapshot semantics ARE
    order-free, and ``np.add.at``'s unbuffered in-element-order
    duplicate accumulation makes this bit-exactly the per-episode
    sequential loop over the same snapshot (parity pinned by
    tests/test_baselines.py)."""
    n, L = g.shape
    q_old = q.copy()
    # masked (out-of-range) cells hold -1e9 and are never selected, so
    # the full-row max IS the masked max
    boot = gamma * np.max(q_old[1:], axis=1)              # (L-1,)
    targets = np.concatenate(
        [np.broadcast_to(boot, (n, L - 1)), rew[:, None]], axis=1)
    pos = np.broadcast_to(np.arange(L), (n, L))
    np.add.at(q, (pos, g), lr * (targets - q_old[pos, g]))


def dqn_requests(spec: GenomeSpec, tracker: _Budget, seed: int,
                 platform=None, batch: int = 32, lr: float = 0.2,
                 eps_start: float = 0.9, eps_end: float = 0.05,
                 gamma: float = 0.98) -> Requests:
    """Sequential gene-picking MDP with a factored Q table (gene position x
    value), epsilon-greedy, batched TD(0) bootstrapping
    (:func:`dqn_td_update`)."""
    rng = np.random.default_rng(seed)
    L = spec.length
    maxv = int(spec.gene_ub.max())
    q = np.zeros((L, maxv))
    for j in range(L):
        q[j, spec.gene_ub[j]:] = -1e9
    step = 0
    total_steps = max(tracker.budget // batch, 1)
    while not tracker.exhausted:
        eps = eps_start + (eps_end - eps_start) * min(step / total_steps, 1)
        n = min(batch, tracker.budget - tracker.evals)
        # vectorized epsilon-greedy: out-of-range q is -1e9, so the full-
        # row argmax is the masked argmax
        explore = rng.random((n, L)) < eps
        rand_vals = rng.integers(0, spec.gene_ub, size=(n, L),
                                 dtype=np.int64)
        greedy = np.argmax(q, axis=1).astype(np.int64)
        g = np.where(explore, rand_vals, greedy[None, :])
        out = yield g
        edp = tracker.register(g, out)
        rew = np.where(np.isfinite(edp), 0.0, -1.0)
        ok = np.isfinite(edp)
        rew[ok] = -np.log10(np.maximum(edp[ok], 1.0)) / 10.0
        # NaN tail rows (budget-truncated, never evaluated) must not
        # train the Q table
        counted = tracker.last_n
        dqn_td_update(q, g[:counted], rew[:counted], gamma, lr)
        step += 1
    return dict(method="dqn")


def dqn(spec: GenomeSpec, batch_eval, budget: int, seed: int,
        platform=None, **kw) -> SearchResult:
    return _run_closed("dqn", spec, batch_eval, budget, seed, platform,
                       **kw)


# ---------------------------------------------------------------- registry


def sparsemap_setup(spec: GenomeSpec, platform, budget: int, seed: int,
                    **kw) -> Tuple[ESConfig, Optional[np.ndarray]]:
    """Shared SparseMap search setup: the ESConfig (population scaled with
    the budget so calibration + HSHI never starve the evolutionary phase
    at CI-scale budgets) and the engineer-default seed genomes.  Used by
    both :func:`sparsemap` and ``search.MultiSearch`` so single and
    concurrent searches are configured identically."""
    if "pop_size" not in kw:
        kw["pop_size"] = int(min(100, max(24, budget // 20)))
    cfg = ESConfig(budget=budget, seed=seed, **kw)
    # seed the initial population with the engineer-default designs that
    # the prior-work baselines also start from (balanced OS mapping with
    # uncompressed / manual sparse strategies) — the joint search then
    # explores outward from them.  Implementation enhancement over the
    # paper, documented in DESIGN.md §6.
    seeds = None
    if platform is not None:
        g0 = np.zeros(spec.length, dtype=np.int64)
        for k, v in fixed_mapping_genes_for_arch(
                spec, as_arch(platform)).items():
            g0[k] = v
        g1 = g0.copy()
        for k, v in manual_sparse_genes(spec).items():
            g1[k] = v
        seeds = np.stack([g0, g1])
    return cfg, seeds


def sparsemap(spec: GenomeSpec, batch_eval, budget: int, seed: int,
              platform=None, **kw) -> SearchResult:
    return _run_closed("sparsemap", spec, batch_eval, budget, seed,
                       platform, **kw)


def standard_es(spec: GenomeSpec, batch_eval, budget: int, seed: int,
                platform=None, **kw) -> SearchResult:
    """Fig. 18 curve 'ES': standard ES with LHS init on the DIRECT value
    encoding (no prime-factor/cantor encoding), uniform operators.  Its
    engine is the ``direct_requests`` generator over canonical genome
    rows, so it also runs inside a concurrent ``MultiSearch`` fleet."""
    from .direct_encoding import direct_standard_es
    return direct_standard_es(spec, batch_eval, budget, seed, platform,
                              **kw)


def pfce_es(spec: GenomeSpec, batch_eval, budget: int, seed: int,
            platform=None) -> SearchResult:
    """Fig. 18 curve 'PFCE': prime-factor + cantor encoding only (the
    encoding is intrinsic to GenomeSpec; custom operators + HSHI off)."""
    return _run_closed("pfce_es", spec, batch_eval, budget, seed, platform)


# -------- request-generator factories (the MultiSearch entry points)


def _pop_runtime_kw(kw: Dict) -> Tuple:
    """Split the process-local runtime extras out of a factory's kwargs
    (``SearchTask.runtime_kw``, merged in by MultiSearch): warm-start
    rows, a resume-state dict, and a live state-capture sink.  Popped
    here so they never reach ESConfig."""
    return (kw.pop("warm_seeds", None), kw.pop("resume_state", None),
            kw.pop("state_out", None))


def _with_warm_seeds(seeds: Optional[np.ndarray], warm,
                     length: int) -> Optional[np.ndarray]:
    """Stack library warm-start rows AHEAD of the engineer-default
    seeds: warm rows are prior search winners for a similar query, the
    strongest prior available, so they must survive the
    ``pop[:len(seeds)]`` injection even when the population is tiny."""
    if warm is None or len(warm) == 0:
        return seeds
    warm = np.asarray(warm, dtype=np.int64).reshape(-1, length)
    return warm if seeds is None else np.concatenate([warm, seeds])


def _factory_sparsemap(spec: GenomeSpec, platform, budget: int, seed: int,
                       **kw) -> Tuple[Requests, _Budget]:
    warm, resume, state_out = _pop_runtime_kw(kw)
    cfg, seeds = sparsemap_setup(spec, platform, budget, seed, **kw)
    tracker = _Budget(cfg.budget)
    return evolve_requests(spec, cfg, tracker,
                           seeds=_with_warm_seeds(seeds, warm,
                                                  spec.length),
                           resume=resume, state_out=state_out), tracker


def _factory_pfce_es(spec: GenomeSpec, platform, budget: int, seed: int,
                     **kw) -> Tuple[Requests, _Budget]:
    warm, resume, state_out = _pop_runtime_kw(kw)
    cfg = ESConfig(budget=budget, seed=seed, use_hshi=False,
                   use_custom_ops=False, **kw)
    tracker = _Budget(cfg.budget)
    return evolve_requests(spec, cfg, tracker,
                           seeds=_with_warm_seeds(None, warm,
                                                  spec.length),
                           resume=resume, state_out=state_out), tracker


def _factory_sage_like(spec: GenomeSpec, platform, budget: int, seed: int,
                       **kw) -> Tuple[Requests, _Budget]:
    warm, resume, state_out = _pop_runtime_kw(kw)
    cfg, fixed, genome0 = _sage_like_setup(spec, platform, budget, seed,
                                           **kw)
    tracker = _Budget(cfg.budget)
    return evolve_requests(spec, cfg, tracker, fixed_genes=fixed,
                           seeds=_with_warm_seeds(genome0[None, :], warm,
                                                  spec.length),
                           resume=resume, state_out=state_out), tracker


def _gen_factory(gen_fn: Callable) -> Callable:
    def factory(spec: GenomeSpec, platform, budget: int, seed: int,
                **kw) -> Tuple[Requests, _Budget]:
        tracker = _Budget(budget)
        return gen_fn(spec, tracker, seed, platform=platform, **kw), tracker
    return factory


def _factory_standard_es(spec: GenomeSpec, platform, budget: int,
                         seed: int, **kw) -> Tuple[Requests, _Budget]:
    from .direct_encoding import direct_requests
    warm, resume, state_out = _pop_runtime_kw(kw)
    if warm is not None or resume is not None or state_out is not None:
        # direct-encoding genomes live in a different space than the
        # canonical rows the warm-start library stores, and the direct
        # generator has no generation-boundary capture — refuse rather
        # than silently drop the caller's durability expectation
        raise ValueError(
            "standard_es supports neither warm_seeds nor checkpoint "
            "resume (direct encoding; see baselines.RESUMABLE_METHODS)")
    tracker = _Budget(budget)
    return direct_requests(spec, tracker, seed, platform=platform,
                           **kw), tracker


#: methods whose request generators can fold generations into
#: device-resident segments (COMPAT.md "Device-resident round protocol"):
#: the ``evolve_requests`` family accepts ``device_rounds``/``rng_backend``
#: through its ESConfig, and ``standard_es`` accepts ``device_rounds``
#: directly — its direct-to-canonical translation runs inside the device
#: segment (``kind="direct"`` segments, ``torch_cost.run_segments``;
#: COMPAT.md "standard_es segment protocol addendum").  The non-ES baselines (PSO/MCTS/TBPSA/PPO/DQN,
#: random_mapper) keep their per-round host paths; in a
#: ``device_rounds=k`` fleet they run unchanged alongside segmented ES
#: tasks.
SEGMENT_METHODS = frozenset({"sparsemap", "pfce_es", "sage_like",
                             "standard_es"})

#: methods whose factories accept library ``warm_seeds`` rows (canonical
#: genome space) and the ``resume_state``/``state_out`` checkpoint hooks
#: (``evolve_requests`` family).  The sweep server gates warm-start
#: injection and checkpointing on this set; other methods run fine but
#: restart from scratch after a crash.
WARM_START_METHODS = frozenset({"sparsemap", "pfce_es", "sage_like"})
RESUMABLE_METHODS = WARM_START_METHODS


#: method name -> (spec, platform, budget, seed, **kw) -> (Requests, _Budget)
REQUEST_METHODS: Dict[str, Callable] = {
    "sparsemap": _factory_sparsemap,
    "standard_es": _factory_standard_es,   # direct encoding (Fig. 18 "ES")
    "pfce_es": _factory_pfce_es,
    "sage_like": _factory_sage_like,
    "random_mapper": _gen_factory(random_mapper_requests),
    "pso": _gen_factory(pso_requests),
    "mcts": _gen_factory(mcts_requests),
    "tbpsa": _gen_factory(tbpsa_requests),
    "ppo": _gen_factory(ppo_requests),
    "dqn": _gen_factory(dqn_requests),
}


def make_requests(method: str, spec: GenomeSpec, platform, budget: int,
                  seed: int, **kw) -> Tuple[Requests, _Budget]:
    """Build the (request generator, budget tracker) pair for ``method``.
    Every method here can be driven sequentially (``_drive``) or as part
    of a concurrent ``search.MultiSearch`` fleet."""
    if method not in REQUEST_METHODS:
        raise KeyError(f"method {method!r} has no request generator; "
                       f"have {sorted(REQUEST_METHODS)}")
    return REQUEST_METHODS[method](spec, platform, budget, seed, **kw)


METHODS: Dict[str, Callable] = {
    "sparsemap": sparsemap,
    "standard_es": standard_es,     # direct encoding (Fig. 18 "ES")
    "pfce_es": pfce_es,             # Fig. 18 "PFCE"
    "pso": pso,
    "mcts": mcts,
    "tbpsa": tbpsa,
    "ppo": ppo,
    "dqn": dqn,
    "random_mapper": random_mapper,
    "sage_like": sage_like,
}
