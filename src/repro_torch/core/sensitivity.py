"""Monte-Carlo high-sensitivity gene calibration (SparseMap §IV.D,
Eqs. 2-5).

For each gene v: fix all other genes to a random combination, Monte-Carlo
sample v, evaluate EDP with the batch cost model, drop invalid points, and
average the pairwise EDP-variation ratio

    S_i(v) = (1/N_i) * sum_{v1,v2} |EDP(v1)-EDP(v2)|
                       / (|v1-v2| * min(EDP(v1), EDP(v2)))

over I independent context combinations (Eq. 3).  Genes with

    S(v) > 3/4 * (S_max - S_min) + S_min          (Eq. 4)

are *high-sensitivity*; the rest are low-sensitivity (Eq. 5).  Valid
genomes discovered during calibration are pooled and reused by the
high-sensitivity hypercube initialization to seed low-sensitivity genes.

Split into :func:`build_probes` / :func:`score_probes` so the evaluation
can be routed through a shared batch evaluator by an external caller
(``search.MultiSearch``); :func:`calibrate` composes the two around a
direct ``batch_eval`` call.  Scoring is fully vectorized: all pairwise
ratios for every (context, gene) cell are computed in one broadcasted
pass over the (I, L, S, S) pair lattice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .encoding import GenomeSpec


@dataclasses.dataclass
class SensitivityResult:
    scores: np.ndarray            # (L,) S(v)
    high_mask: np.ndarray         # (L,) bool
    valid_pool: np.ndarray        # (n_valid, L) valid genomes found
    threshold: float
    evals_used: int

    @property
    def high_indices(self) -> np.ndarray:
        return np.nonzero(self.high_mask)[0]

    @property
    def low_indices(self) -> np.ndarray:
        return np.nonzero(~self.high_mask)[0]

    def high_segments(self) -> List[tuple]:
        """Contiguous runs of high-sensitivity genes [(start, stop), ...] —
        the natural crossover boundaries for sensitivity-aware crossover."""
        segs = []
        in_run = False
        start = 0
        for i, h in enumerate(self.high_mask):
            if h and not in_run:
                in_run, start = True, i
            elif not h and in_run:
                segs.append((start, i))
                in_run = False
        if in_run:
            segs.append((start, len(self.high_mask)))
        return segs


def build_probes(spec: GenomeSpec, rng: np.random.Generator,
                 n_contexts: int = 6, n_samples: int = 12
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the full probe batch: for each context i and gene v,
    ``n_samples`` genomes identical to context i except gene v.  Returns
    (probes, gene_idx, sampled_vals); probe row i*L*S + v*S + s is context
    i with gene v resampled."""
    L = spec.length
    contexts = spec.random_genomes(rng, n_contexts)            # (I, L)
    probes = np.repeat(contexts, L * n_samples, axis=0)        # (I*L*S, L)
    gene_idx = np.tile(np.repeat(np.arange(L), n_samples), n_contexts)
    sampled_vals = (rng.random(len(probes)) *
                    spec.gene_ub[gene_idx]).astype(np.int64)
    probes[np.arange(len(probes)), gene_idx] = sampled_vals
    return probes, gene_idx, sampled_vals


def score_probes(spec: GenomeSpec, probes: np.ndarray, gene_idx: np.ndarray,
                 sampled_vals: np.ndarray, out: dict,
                 rng: np.random.Generator, n_contexts: int, n_samples: int,
                 max_pairs: int = 32) -> SensitivityResult:
    """Compute sensitivity scores from the evaluated probe batch."""
    L = spec.length
    S = n_samples
    valid = np.asarray(out["valid"]).reshape(n_contexts, L, S)
    edp = np.asarray(out["edp"], dtype=np.float64).reshape(n_contexts, L, S)
    vals = sampled_vals.astype(np.float64).reshape(n_contexts, L, S)

    # The seed implementation subsampled pairs per cell purely to bound
    # the Python-loop cost; vectorized, every eligible pair of a normal
    # calibration (S <= ~32) is cheap, and using them all avoids biasing
    # against cells with few valid samples.  Only truly huge lattices get
    # a (shared) subsample, scaled so ~max_pairs pairs survive per cell.
    iu, ju = np.triu_indices(S, k=1)
    if len(iu) > max(max_pairs * 16, 512):
        sel = rng.choice(len(iu), max(max_pairs * 16, 512), replace=False)
        iu, ju = iu[sel], ju[sel]

    ok_a = valid[..., iu]
    ok_b = valid[..., ju]
    va = vals[..., iu]
    vb = vals[..., ju]
    pair_ok = ok_a & ok_b & (va != vb)
    # neutralize invalid entries (inf EDP) before arithmetic
    ea = np.where(ok_a, edp[..., iu], 0.0)
    eb = np.where(ok_b, edp[..., ju], 0.0)
    num = np.abs(ea - eb)
    den = np.abs(va - vb) * np.maximum(np.minimum(ea, eb), 1e-30)
    ratio = np.where(pair_ok, num / np.where(pair_ok, den, 1.0), 0.0)

    n_pairs = pair_ok.sum(axis=-1)                  # (I, L)
    cell_ok = (valid.sum(axis=-1) >= 2) & (n_pairs > 0)
    cell_score = np.where(
        cell_ok, ratio.sum(axis=-1) / np.maximum(n_pairs, 1), 0.0)
    scores = cell_score.sum(axis=0)                 # (L,)
    counts = cell_ok.sum(axis=0)
    with np.errstate(invalid="ignore"):
        scores = np.where(counts > 0, scores / np.maximum(counts, 1), 0.0)

    smax, smin = scores.max(), scores.min()
    threshold = 0.75 * (smax - smin) + smin
    high = scores > threshold
    if not high.any():         # degenerate: everything equal
        high = scores >= smax

    pool = probes[np.asarray(out["valid"])]
    return SensitivityResult(scores=scores, high_mask=high,
                             valid_pool=pool, threshold=float(threshold),
                             evals_used=len(probes))


def calibrate(spec: GenomeSpec, batch_eval, rng: np.random.Generator,
              n_contexts: int = 6, n_samples: int = 12,
              max_pairs: int = 32) -> SensitivityResult:
    """Run the calibration.

    ``batch_eval(genomes) -> dict with 'valid' (bool) and 'edp'`` — normally
    a :class:`repro_torch.core.torch_cost.TorchCostModel`.

    One batched evaluation covers all genes x contexts x samples.
    """
    probes, gene_idx, sampled_vals = build_probes(
        spec, rng, n_contexts=n_contexts, n_samples=n_samples)
    out = batch_eval(probes)
    return score_probes(spec, probes, gene_idx, sampled_vals, out, rng,
                        n_contexts=n_contexts, n_samples=n_samples,
                        max_pairs=max_pairs)
