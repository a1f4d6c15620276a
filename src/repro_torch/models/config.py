"""Model configuration for all assigned architectures.

A copy of the JAX package's ``models/config.py`` (plain dataclasses).

A model is a sequence of *block groups*; each group is a homogeneous stack
of blocks (the JAX package stacks a group's weights on a leading layer
axis; :mod:`repro_torch.models.model` keeps one module per layer).
Heterogeneous archs (gemma3 5:1 local:global, zamba2 mamba+shared-attn,
xlstm mLSTM/sLSTM alternation) are expressed as a repeating *super-block*
of a few block kinds.

Block kinds:
    "attn"        full-attention + SwiGLU MLP (pre-RMSNorm, residual)
    "attn_local"  sliding-window attention + MLP
    "moe"         attention + mixture-of-experts FFN (optionally + dense
                  residual FFN, Arctic-style)
    "mamba2"      Mamba-2 SSD block
    "mlstm"       xLSTM matrix-LSTM block
    "slstm"       xLSTM scalar-LSTM block
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str
    repeat: int = 1                 # consecutive layers of this kind


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # super-block pattern, repeated ``n_super`` times
    pattern: Tuple[BlockSpec, ...] = (BlockSpec("attn"),)
    n_super: int = 1
    head_dim: Optional[int] = None          # default d_model // n_heads
    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 4096              # for "attn_local"
    m_rope: bool = False                    # Qwen2-VL multimodal RoPE
    attention_chunk: int = 2048             # q-chunking for long sequences
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False        # Arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    moe_grouped: bool = False               # GShard-style grouped dispatch
    moe_n_groups: int = 256                 # groups (= data shards ideally)
    # SSM
    ssm_state: int = 64
    ssm_chunk: int = 256
    mlstm_proj_factor: float = 2.0
    # encoder-decoder
    n_enc_layers: int = 0                   # >0 => enc-dec model
    # multimodal stub frontends (precomputed embeddings via input_specs)
    frontend: Optional[str] = None          # None | "vision" | "audio"
    n_frontend_tokens: int = 0              # prepended embedding positions
    # FFN
    mlp_kind: str = "swiglu"                # swiglu | gelu (2-matrix)
    embed_shard: str = "vocab"              # vocab | dmodel (perf variant)
    # numerics / training
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                     # none | full | dots
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    logit_softcap: float = 0.0
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        per = sum(b.repeat for b in self.pattern)
        return per * self.n_super + self.n_enc_layers

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        def attn_params():
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + \
                self.n_heads * hd * d
        def mlp_params(ff):
            return (3 if self.mlp_kind == "swiglu" else 2) * d * ff
        for blk in self.pattern:
            n = blk.repeat * self.n_super
            if blk.kind in ("attn", "attn_local"):
                total += n * (attn_params() + mlp_params(self.d_ff))
            elif blk.kind == "moe":
                e = n * (attn_params() + d * self.n_experts +
                         self.n_experts * 3 * d * self.moe_d_ff)
                if self.moe_dense_residual:
                    e += n * mlp_params(self.d_ff)
                total += e
            elif blk.kind == "mamba2":
                din = 2 * d
                total += n * (d * (2 * din + 2 * self.ssm_state *
                                   (din // 64)) + din * d + 3 * din)
            elif blk.kind in ("mlstm", "slstm"):
                dp = int(d * self.mlstm_proj_factor)
                total += n * (d * dp * 2 + 4 * d * dp // 4 * 4)
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn_params() +
                                          mlp_params(self.d_ff))
            # decoder cross-attention
            dec_layers = sum(b.repeat for b in self.pattern) * self.n_super
            total += dec_layers * attn_params()
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - (
            sum(b.repeat for b in self.pattern if b.kind == "moe") *
            self.n_super * self.n_experts * 3 * d * self.moe_d_ff)
        n_moe = sum(b.repeat for b in self.pattern
                    if b.kind == "moe") * self.n_super
        return dense + n_moe * self.top_k * 3 * d * self.moe_d_ff
