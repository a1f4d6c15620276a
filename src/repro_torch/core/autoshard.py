"""autoshard — SparseMap's joint-space ES applied to the LM substrate's
distributed mapping space, the counterpart of the JAX package's
``core/autoshard.py``.

Sharding axis assignments (the mapping) and layout/recompute/
microbatching choices (the strategy) interact as the paper's mapping and
sparse strategy do, so the SAME evolution engine
(:func:`repro_torch.core.evolution.evolve` — HSHI, annealing mutation,
sensitivity-aware crossover) searches a decision genome, with a
closed-form three-term roofline (compute, memory, collectives) per device
as the evaluation environment.  The accelerator's constants are an
argument (``accel``, a dict): :data:`repro_torch.core.accel.H100_SXM` by
default; any dict with ``peak_bf16_flops``, ``hbm_bw_bytes_per_s``,
``ici_link_bw_bytes_per_s`` and ``hbm_bytes`` (the capacity a device's
state and activations must fit) will do.  The formulas are the
reference's, term for term.

Decision genome (one gene per decision):

    0 remat          {none, dots, full}
    1 microbatches   {1, 2, 4, 8}
    2 logits         {vocab-sharded, replicated-gather}
    3 embed shard    {vocab, d_model}
    4 attn chunk     {0, 1024, 2048, 4096}
    5 mlp shard      {megatron (ff on model), fsdp (weights on data)}
    6 zero1          {off, on}
    7 moe expert ff  {ff on data, ff replicated}   (MoE archs only)
    8 seq shard kv   {model, data+model}           (decode only)
    9 moment dtype   {fp32, bf16, int8}
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

import numpy as np

from .accel import H100_SXM

REMAT_OPTS = ("none", "dots", "full")
MICRO_OPTS = (1, 2, 4, 8)
CHUNK_OPTS = (0, 1024, 2048, 4096)

GENE_NAMES = ("remat", "microbatches", "logits", "embed", "attn_chunk",
              "mlp_shard", "zero1", "moe_ff", "kv_seq", "moments")
GENE_UB = (3, 4, 2, 2, 4, 2, 2, 2, 2, 3)
MOMENT_OPTS = ("fp32", "bf16", "int8")
MOMENT_BYTES = {"fp32": 12.0, "bf16": 4.0, "int8": 2.0}


class DecisionSpec:
    """Minimal GenomeSpec-compatible adapter for the decision genome."""

    def __init__(self):
        self.length = len(GENE_UB)
        self.gene_ub = np.asarray(GENE_UB, np.int64)
        self.segments = {}          # no segment structure needed

    def random_genomes(self, rng: np.random.Generator, n: int
                       ) -> np.ndarray:
        return (rng.random((n, self.length)) *
                self.gene_ub[None, :]).astype(np.int64)

    def clip(self, g: np.ndarray) -> np.ndarray:
        return np.clip(g, 0, self.gene_ub[None, :] - 1)


def decode_decisions(genome: np.ndarray) -> Dict[str, object]:
    return dict(
        remat=REMAT_OPTS[int(genome[0])],
        microbatches=MICRO_OPTS[int(genome[1])],
        logits="vocab" if genome[2] == 0 else "gather",
        embed="vocab" if genome[3] == 0 else "dmodel",
        attn_chunk=CHUNK_OPTS[int(genome[4])],
        mlp_shard="megatron" if genome[5] == 0 else "fsdp",
        zero1=bool(genome[6]),
        moe_ff="data" if genome[7] == 0 else "replicated",
        kv_seq="model" if genome[8] == 0 else "data_model",
        moments=MOMENT_OPTS[int(genome[9])],
    )


# ---------------------------------------------------------------- model


@dataclasses.dataclass
class RooflineEstimate:
    t_compute: float
    t_memory: float
    t_collective: float
    hbm_bytes_per_device: float
    valid: bool = True
    reason: str = ""

    @property
    def t_total(self) -> float:
        # compute overlaps memory; collectives partially overlap
        return max(self.t_compute, self.t_memory) + 0.5 * self.t_collective

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.t_compute, memory=self.t_memory,
                     collective=self.t_collective)
        return max(terms, key=terms.get)


def estimate(cfg, seq_len: int, global_batch: int, mesh_shape: Dict[str, int],
             decisions: Dict[str, object], kind: str = "train",
             accel: Optional[Dict[str, float]] = None) -> RooflineEstimate:
    """Closed-form three-term roofline for one step (per device) on the
    accelerator ``accel`` (default :data:`H100_SXM`)."""
    accel = H100_SXM if accel is None else accel
    peak = accel["peak_bf16_flops"]
    hbm = accel["hbm_bw_bytes_per_s"]
    ici = accel["ici_link_bw_bytes_per_s"]
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = tp * dp
    d = cfg.d_model
    L = cfg.n_layers
    V = cfg.vocab_size
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    tokens = global_batch * (seq_len if kind != "decode" else 1)
    wb = 2.0                                   # bf16

    remat_mult = {"none": 1.0, "dots": 1.15, "full": 4.0 / 3.0}[
        decisions["remat"]]
    fwdbwd = 3.0 if kind == "train" else 1.0

    # ---- compute ----
    flops = 2.0 * n_active * tokens * fwdbwd * \
        (remat_mult if kind == "train" else 1.0)
    # attention quadratic term: 4*B*S^2*H*hd per attn layer (fwd),
    # x3 for training; attn_chunk doesn't change flops, only memory
    attn_layers = sum(b.repeat for b in cfg.pattern
                      if "attn" in b.kind or b.kind == "moe") * cfg.n_super
    if kind != "decode":
        flops += 4.0 * attn_layers * global_batch * seq_len * seq_len * \
            cfg.n_heads * cfg.hd * fwdbwd
    t_compute = flops / (chips * peak)

    # ---- memory ----
    micro = decisions["microbatches"]
    act_bytes = tokens * d * wb * L * (4.0 if decisions["remat"] == "none"
                                       else 1.5)
    # MoE experts shard over BOTH axes (E on model, ff on data);
    # dense params shard over the model axis only
    param_shard = chips if cfg.n_experts else tp
    mom_b = MOMENT_BYTES[decisions["moments"]]
    param_traffic = n_total * wb * (2.0 if kind == "train" else 1.0)
    opt_traffic = n_total * mom_b if kind == "train" else 0.0
    logits_traffic = tokens * V * wb / (tp if decisions["logits"] == "vocab"
                                        else 1)
    if kind == "train":
        logits_traffic *= 3.0
    hbm_bytes = (act_bytes / chips + param_traffic / tp / micro * micro +
                 opt_traffic / chips + logits_traffic / dp)
    t_memory = hbm_bytes / hbm

    # ---- collectives ----
    # Megatron TP: 2 all-reduces (fwd) + 2 (bwd) of activations per layer
    act_per_layer = tokens / dp * d * wb
    tp_coll = (4.0 if kind == "train" else 2.0) * L * act_per_layer * \
        2.0 * (tp - 1) / tp
    if decisions["mlp_shard"] == "fsdp":
        # all-gather weights per layer instead of activation reductions
        tp_coll = L * (n_total / max(L, 1)) * wb / dp * 2.0
    dp_coll = (2.0 * n_total * wb / tp / micro) * (min(micro, 2)) \
        if kind == "train" else 0.0        # grad reduce-scatter+AG
    logits_coll = 0.0
    if decisions["logits"] == "gather":
        logits_coll = tokens / dp * V * wb      # gather full logits
    moe_coll = 0.0
    if cfg.n_experts:
        # token dispatch all-to-all, both directions, fwd+bwd
        moe_coll = (4.0 if kind == "train" else 1.0) * \
            sum(b.repeat for b in cfg.pattern if b.kind == "moe") * \
            cfg.n_super / max(L, 1) * L * tokens / chips * d * wb * 2.0
        if decisions["moe_ff"] == "replicated":
            moe_coll *= 1.5                     # extra gather of outputs
    coll_bytes = tp_coll / chips * tp + dp_coll / chips * dp + \
        logits_coll / chips + moe_coll
    t_collective = coll_bytes / ici

    # ---- validity: HBM capacity ----
    opt_shard = chips if decisions["zero1"] else param_shard
    state = n_total * wb / param_shard + n_total * mom_b / opt_shard
    if kind != "train":
        state = n_total * wb / param_shard
    act_resident = act_bytes / chips / micro
    hbm_cap = accel["hbm_bytes"]
    valid = state + act_resident < hbm_cap
    reason = "" if valid else (
        f"HBM overflow: {(state + act_resident) / 1e9:.1f} GB > "
        f"{hbm_cap / 1e9:.0f} GB")

    return RooflineEstimate(t_compute=t_compute, t_memory=t_memory,
                            t_collective=t_collective,
                            hbm_bytes_per_device=state + act_resident,
                            valid=valid, reason=reason)


# ---------------------------------------------------------------- search


def make_batch_eval(cfg, seq_len: int, global_batch: int,
                    mesh_shape: Dict[str, int], kind: str = "train",
                    accel: Optional[Dict[str, float]] = None):
    """Batch evaluator with the SearchResult contract of the core ES."""

    def _eval(genomes: np.ndarray) -> Dict[str, np.ndarray]:
        n = len(genomes)
        valid = np.zeros(n, bool)
        edp = np.full(n, np.inf)
        for i, g in enumerate(genomes):
            dec = decode_decisions(g)
            est = estimate(cfg, seq_len, global_batch, mesh_shape, dec,
                           kind, accel)
            valid[i] = est.valid
            if est.valid:
                edp[i] = est.t_total
        return dict(valid=valid, edp=edp,
                    log10_edp=np.log10(np.maximum(edp, 1e-30)))

    return _eval


def search(cfg, seq_len: int, global_batch: int,
           mesh_shape: Dict[str, int], kind: str = "train",
           budget: int = 2000, seed: int = 0,
           accel: Optional[Dict[str, float]] = None):
    """Run the paper's ES over the decision genome; returns
    (best decisions, RooflineEstimate, SearchResult)."""
    from .evolution import ESConfig, evolve

    spec = DecisionSpec()
    ev = make_batch_eval(cfg, seq_len, global_batch, mesh_shape, kind,
                         accel)
    res = evolve(spec, ev, ESConfig(budget=budget, seed=seed, pop_size=32,
                                    cube_budget=4))
    if res.best_genome is None:
        return None, None, res
    dec = decode_decisions(res.best_genome)
    est = estimate(cfg, seq_len, global_batch, mesh_shape, dec, kind, accel)
    return dec, est, res


def exhaustive_best(cfg, seq_len, global_batch, mesh_shape, kind="train",
                    accel: Optional[Dict[str, float]] = None):
    """Tiny genome -> exhaustive reference (the space is ~6k points);
    lets tests verify the ES finds the true optimum."""
    best, best_t = None, np.inf
    ranges = [range(u) for u in GENE_UB]
    for combo in itertools.product(*ranges):
        dec = decode_decisions(np.asarray(combo))
        est = estimate(cfg, seq_len, global_batch, mesh_shape, dec, kind,
                       accel)
        if est.valid and est.t_total < best_t:
            best, best_t = dec, est.t_total
    return best, best_t
