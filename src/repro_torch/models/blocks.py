"""The attention block (``attn`` / ``attn_local``), the counterpart of the
JAX package's ``build_attn`` / ``train_attn`` / ``cache_init_attn`` /
``decode_attn`` (``models/blocks.py``), without cross-attention.

Weights keep the reference's ``[d_in, d_out]`` layout and are applied as
``x @ w`` (no ``nn.Linear``), so a JAX parameter tree copies over leaf for
leaf (:mod:`repro_torch.models.convert`).  They are built on the
generator's device in the parameter dtype and need no gradient
(serving only).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import attention as attn_lib
from .config import ModelConfig
from .layers import _init_dense, apply_rope, dtype_of, mlp, rms_norm


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _ones(cfg: ModelConfig, gen: torch.Generator) -> nn.Parameter:
    return _param(torch.ones((cfg.d_model,), dtype=dtype_of(cfg.param_dtype),
                             device=gen.device))


class _AttnParams(nn.Module):
    """``wq [d, H*hd]``, ``wk`` / ``wv [d, KV*hd]``, ``wo [H*hd, d]`` (the
    reference's ``_attn_params``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = dtype_of(cfg.param_dtype)
        self.wq = _param(_init_dense(gen, d, h * hd, dt))
        self.wk = _param(_init_dense(gen, d, kv * hd, dt))
        self.wv = _param(_init_dense(gen, d, kv * hd, dt))
        self.wo = _param(_init_dense(gen, h * hd, d, dt))


class _MlpParams(nn.Module):
    """``w1 [d, d_ff]``, ``w2 [d_ff, d]`` and, for SwiGLU, ``w3 [d, d_ff]``
    (``None`` for the 2-matrix GELU MLP): the reference's ``_mlp_params``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, d_ff: int):
        super().__init__()
        d = cfg.d_model
        dt = dtype_of(cfg.param_dtype)
        self.w1 = _param(_init_dense(gen, d, d_ff, dt))
        if cfg.mlp_kind == "swiglu":
            self.w3 = _param(_init_dense(gen, d, d_ff, dt))
        else:
            self.register_parameter("w3", None)
        self.w2 = _param(_init_dense(gen, d_ff, d, dt))


def _qkv(cfg: ModelConfig, p: _AttnParams, x: torch.Tensor,
         positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).reshape(b, s, h, hd)
    k = (x @ p.wk).reshape(b, s, kv, hd)
    v = (x @ p.wv).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


class AttnBlock(nn.Module):
    """Pre-RMSNorm attention + MLP with residuals; ``local`` gives the
    sliding-window kind (``cfg.sliding_window``)."""

    def __init__(self, cfg: ModelConfig, local: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.local = local
        self.ln1 = _ones(cfg, generator)
        self.attn = _AttnParams(cfg, generator)
        self.ln2 = _ones(cfg, generator)
        self.mlp = _MlpParams(cfg, generator, cfg.d_ff)

    @property
    def window(self):
        return self.cfg.sliding_window if self.local else None

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False) -> torch.Tensor:
        """x: [B,S,d] at absolute positions ``off``..``off+S-1``."""
        b, s, _ = x.shape
        positions = off + torch.arange(s, device=x.device)[None, :]
        q, k, v = _qkv(self.cfg, self.attn, rms_norm(x, self.ln1), positions)
        o = attn_lib.attention(q, k, v, causal=True, window=self.window,
                               q_offset=off, chunk=self.cfg.attention_chunk,
                               force_chunked=force_chunked)
        x = x + o.reshape(b, s, -1) @ self.attn.wo
        return x + mlp(rms_norm(x, self.ln2), self.mlp)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zeroed K/V caches [B, max_len, KV, hd] in the compute dtype."""
        cfg = self.cfg
        shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=dtype_of(cfg.compute_dtype), device=self.ln1.device)
        return dict(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw))

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d]; ``pos``: the cache length before this token.  The
        token's K/V are written into ``cache`` in place."""
        b = x_t.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x_t.device)
        q, k, v = _qkv(self.cfg, self.attn, rms_norm(x_t, self.ln1),
                       positions)
        kc, vc = attn_lib.update_cache(cache["k"], cache["v"], k, v, pos)
        o = attn_lib.decode_attention(q, kc, vc, pos + 1, window=self.window)
        x_t = x_t + o.reshape(b, 1, -1) @ self.attn.wo
        return x_t + mlp(rms_norm(x_t, self.ln2), self.mlp)
