"""SparseMap Table III workloads: mm1-mm15 (DeepBench + sparseGPT SpMM)
and conv1-conv13 (VGG16, 50% global pruning), plus structured-density
sets — the sparseGPT SpMMs (mm8-mm10) carry their real 2:4
block-pruning structure (``BlockNM(2, 4)``) rather than a uniform 50%
scalar, and ``banded_attention_workloads`` adds windowed-attention
score x value GEMMs with ``Banded`` operands.  ``arch_gemms`` turns the
dominant GEMMs of one of the package's LM configs into SpMM workloads (the
LLM-GEMM scenario of ``examples/search_accelerator_torch.py``).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.density import Banded, BlockNM, DensityModel
from repro_torch.core.workload import Workload, spconv, spmm


def _k(x: float) -> int:
    return int(round(x * 1024))


# (name, M, K, N, density_P %, density_Q %) — operand1 = P, operand2 = Q
_MM = [
    ("mm1", 124, 124, 124, 78.5, 78.5),
    ("mm2", 171, _k(92), 171, 20.9, 20.9),
    ("mm3", 730, 730, 730, 11.8, 11.8),
    ("mm4", 7700, 2600, 7700, 5.0, 5.0),
    ("mm5", 9000, 9000, 9000, 4.1, 4.1),
    ("mm6", 2600, 2600, 2600, 1.1, 1.1),
    ("mm7", 1600, 4600, 1600, 0.3, 0.3),
    ("mm8", 2000, 12300, 128, 100.0, 50.0),
    ("mm9", 2000, 12300, 49200, 100.0, 50.0),
    ("mm10", 2000, 49200, 12300, 100.0, 50.0),
    ("mm11", 128, 1024, 128, 0.6, 0.6),
    ("mm12", 768, 64, 768, 5.9, 5.9),
    ("mm13", 12300, 24600, 12300, 1.0, 1.0),
    ("mm14", 256, 512, 2048, 32.8, 71.8),
    ("mm15", 1000, 16000, 16000, 60.0, 78.0),
]

# (name, C, H, W, Kout, R, S, density_input %, density_weight %)
_CONV = [
    ("conv1", 3, 32, 32, 64, 3, 3, 100.0, 54.6),
    ("conv2", 64, 32, 32, 256, 1, 1, 45.0, 25.2),
    ("conv3", 128, 16, 16, 512, 1, 1, 39.6, 36.6),
    ("conv4", 128, 16, 16, 128, 3, 3, 47.7, 64.7),
    ("conv5", 1024, 8, 8, 256, 1, 1, 40.2, 50.1),
    ("conv6", 256, 8, 8, 256, 3, 3, 43.0, 61.7),
    ("conv7", 512, 4, 4, 2048, 1, 1, 59.0, 11.8),
    ("conv8", 128, 64, 64, 512, 4, 4, 40.0, 30.0),
    ("conv9", 128, 64, 64, 64, 1, 1, 100.0, 20.0),
    ("conv10", 256, 64, 64, 512, 1, 1, 40.0, 25.0),
    ("conv11", 4, 32, 32, 64, 3, 3, 34.0, 14.6),
    ("conv12", 1024, 4, 4, 64, 1, 1, 79.0, 11.8),
    ("conv13", 256, 16, 16, 128, 1, 1, 90.2, 5.1),
]


# Structured-density overrides: the sparseGPT SpMMs (mm8-mm10) are 2:4
# block-pruned weight matrices (operand2 = Q), not uniform-random 50%.
# BlockNM(2, 4).density == 0.5, so the mean matches the Table III entry
# while the byte/intersection statistics carry the N:M structure.
_MM_STRUCTURED: Dict[str, Dict[str, DensityModel]] = {
    "mm8": {"Q": BlockNM(2, 4)},
    "mm9": {"Q": BlockNM(2, 4)},
    "mm10": {"Q": BlockNM(2, 4)},
}


def mm_workloads() -> List[Workload]:
    out = []
    for n, m, k, nn, dp, dq in _MM:
        over = _MM_STRUCTURED.get(n, {})
        out.append(spmm(n, m, k, nn,
                        over.get("P", dp / 100.0),
                        over.get("Q", dq / 100.0)))
    return out


def conv_workloads() -> List[Workload]:
    return [spconv(n, c, h, w, ko, r, s, di / 100.0, dw / 100.0)
            for n, c, h, w, ko, r, s, di, dw in _CONV]


# (name, tokens, d_head, band fraction, score density) — windowed/local
# attention score x value GEMMs: P = post-softmax scores S[M=tokens,
# K=tokens], banded with the attention window (nonzeros only inside the
# band, where dropout/thresholding leaves ~70% of entries), Q = the
# dense value matrix V[K=tokens, N=d_head].
_BANDED_ATTN = [
    ("battn1", 512, 64, 0.125, 0.0875),
    ("battn2", 1024, 64, 0.0625, 0.04375),
]


def banded_attention_workloads() -> List[Workload]:
    return [spmm(n, t, t, dh, Banded(d, band), 1.0)
            for n, t, dh, band, d in _BANDED_ATTN]


def structured_workloads() -> List[Workload]:
    """Every workload carrying a non-uniform density model: the 2:4
    sparseGPT family + the banded-attention set."""
    return [w for w in mm_workloads() if w.structured_density] + \
        banded_attention_workloads()


def all_workloads() -> List[Workload]:
    return mm_workloads() + conv_workloads()


def by_name(name: str) -> Workload:
    for wl in all_workloads() + banded_attention_workloads():
        if wl.name == name:
            return wl
    raise KeyError(name)


# ---------------------------------------------------------------- archs


def arch_gemms(arch_name: str, weight_density: float = 0.5,
               act_density: float = 0.6, tokens: int = 512
               ) -> List[Workload]:
    """Extract the dominant GEMMs of an assigned architecture as SpTA
    workloads (activations x pruned weights), so the paper's DSE runs on
    this framework's own models (DESIGN.md §4)."""
    from .archs import get_config
    c = get_config(arch_name)
    d, hd = c.d_model, c.hd
    out = [
        spmm(f"{arch_name}:qkv", tokens, d,
             (c.n_heads + 2 * c.n_kv_heads) * hd,
             act_density, weight_density),
        spmm(f"{arch_name}:attn_out", tokens, c.n_heads * hd, d,
             act_density, weight_density),
    ]
    ff = c.moe_d_ff if c.n_experts else c.d_ff
    if ff:
        out.append(spmm(f"{arch_name}:ffn_up", tokens, d, ff,
                        act_density, weight_density))
        out.append(spmm(f"{arch_name}:ffn_down", tokens, ff, d,
                        act_density, weight_density))
    return out
