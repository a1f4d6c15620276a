"""Model assembly: embeddings + the decoder blocks + LM head, the
counterpart of the JAX package's ``models/model.py`` for dense decoders
(block kinds ``attn`` and ``attn_local``).

The reference stacks each pattern entry's weights ``[n_super, repeat,
...]`` and scans one super-block body; here the blocks are one
``nn.ModuleList`` in the order that scan visits them (super-block by
super-block, each pattern entry's ``repeat`` layers in turn).

Public surface::

    m = Model(cfg, device=None, generator=None)   # weights built on device
    logits = m(tokens)                             # prefill forward [B,S,V]
    cache = m.init_cache(batch, max_len)           # per-layer K/V
    logits = m.decode_step(cache, tokens, pos)     # [B,1,V]; cache in place

The rest of the LM substrate — MoE, Mamba-2, xLSTM, encoder-decoder and
shared-attention blocks, M-RoPE and frontends, sharding, training — is
not ported yet (ROADMAP Queue 1 item 9); :func:`unported` names what a
config needs of it, and :class:`Model` refuses such a config.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .blocks import AttnBlock, _ones, _param
from .config import ModelConfig
from .layers import _init_dense, dtype_of, rms_norm

KINDS = ("attn", "attn_local")


def unported(cfg: ModelConfig) -> Optional[str]:
    """Why :class:`Model` cannot build ``cfg`` yet, or ``None``."""
    missing = [f"block kind {b.kind!r}" for b in cfg.pattern
               if b.kind not in KINDS]
    if cfg.n_enc_layers:
        missing.append("an encoder (n_enc_layers)")
    if cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.m_rope:
        missing.append("M-RoPE")
    if not missing:
        return None
    return (f"{cfg.name} needs {', '.join(dict.fromkeys(missing))}, which "
            f"repro_torch does not have yet (ROADMAP Queue 1 item 9: the "
            f"port's LM substrate has the dense decoder blocks "
            f"{', '.join(KINDS)} only)")


class Model(nn.Module):
    """A dense decoder built on ``device`` (``None`` = the GPU, raising
    where there is none) from ``generator`` (default: seed 0 on that
    device), tensor by tensor, in ``cfg.param_dtype``."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        reason = unported(cfg)
        if reason:
            raise NotImplementedError(reason)
        device = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        dt = dtype_of(cfg.param_dtype)
        embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                            dtype=torch.float32, device=device)
        self.embed = _param(embed.mul_(0.02).to(dt))
        del embed
        self.unembed = None if cfg.tie_embeddings else \
            _param(_init_dense(gen, cfg.d_model, cfg.vocab_size, dt))
        self.final_ln = _ones(cfg, gen)
        self.blocks = nn.ModuleList(
            AttnBlock(cfg, local=b.kind == "attn_local", generator=gen)
            for _ in range(cfg.n_super) for b in cfg.pattern
            for _ in range(b.repeat))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_ln)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T.to(x.dtype)
        return x @ self.unembed

    def forward(self, tokens: torch.Tensor,
                force_chunked: bool = False) -> torch.Tensor:
        """tokens: [B,S] integer -> logits [B,S,V].  ``force_chunked`` puts
        every layer's attention on the chunked route (to hold the flash
        route against it)."""
        x = self.embed[tokens].to(dtype_of(self.cfg.compute_dtype))
        for blk in self.blocks:
            x = blk(x, 0, force_chunked=force_chunked)
        return self._logits(x)

    def init_cache(self, batch: int, max_len: int
                   ) -> List[Dict[str, torch.Tensor]]:
        """One ``{"k", "v"}`` pair of [B, max_len, KV, hd] per block."""
        return [blk.init_cache(batch, max_len) for blk in self.blocks]

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """tokens: [B,1]; ``pos``: the current cache length.  Writes this
        token's K/V into ``cache`` and returns logits [B,1,V]."""
        x = self.embed[tokens].to(dtype_of(self.cfg.compute_dtype))
        for blk, c in zip(self.blocks, cache):
            x = blk.decode(c, x, pos)
        return self._logits(x)
