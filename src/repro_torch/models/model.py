"""Model assembly: embeddings + the blocks + LM head, the counterpart of
the JAX package's ``models/model.py`` for decoders of the block kinds
``attn``, ``attn_local``, ``mamba2``, ``mlstm``, ``slstm`` and the
shared attention block ``shared_attn``.

The reference stacks each pattern entry's weights ``[n_super, repeat,
...]`` and scans one super-block body; here the blocks are one
``nn.ModuleList`` in the order that scan visits them (super-block by
super-block, each pattern entry's ``repeat`` layers in turn).  A shared
entry (zamba2's ``shared_attn``, ``SHARED_KINDS``) is one ``AttnBlock``
referenced from every position it takes in that list: one copy of its
weights, which ``named_parameters()`` lists once, under its first
position's name, and whose gradient sums over its uses; its caches stay
per position.

Public surface::

    m = Model(cfg, device=None, generator=None)   # weights built on device
    logits = m(tokens)                             # prefill forward [B,S,V]
    cache = m.init_cache(batch, max_len)           # one cache per position
    logits = m.decode_step(cache, tokens, pos)     # [B,1,V]; cache updated
    m.requires_grad_(True)                         # make it trainable
    loss, aux = m.loss_fn(batch)                   # {"tokens", "labels"}

The weights are built needing no gradient (serving); ``requires_grad_``
(``nn.Module``'s) turns them into trainable leaves.  While autograd
records and the weights need a gradient, each block runs under
``torch.utils.checkpoint`` as ``cfg.remat`` says (the reference remats
each scanned super-block): ``"full"`` recomputes the whole block in the
backward pass, ``"dots"`` keeps the outputs of its matrix products
(``aten.mm`` / ``bmm`` / ``addmm``, the counterpart of
``checkpoint_dots``) and recomputes the rest, ``"none"`` keeps
everything.  A recomputed block calls :func:`attention` again, so
``attention.calls`` counts it twice.

The rest of the LM substrate is not ported yet; :func:`unported` names
what a config needs of it and the ROADMAP Queue 1 item that brings it,
and :class:`Model` refuses such a config.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import DeviceLike, resolve_device
from .blocks import (AttnBlock, Mamba2Block, MlstmBlock, SlstmBlock, _ones,
                     _param)
from .config import BlockSpec, ModelConfig
from .layers import _init_dense, dtype_of, rms_norm, softmax_xent

#: the block class of each ported kind (``shared_attn``: see SHARED_KINDS)
BLOCKS = {
    "attn": AttnBlock,
    "attn_local": lambda cfg, generator: AttnBlock(cfg, local=True,
                                                   generator=generator),
    "mamba2": Mamba2Block,
    "mlstm": MlstmBlock,
    "slstm": SlstmBlock,
}
SHARED_KINDS = {"shared_attn"}      # zamba2: one weight copy, many uses
KINDS = tuple(BLOCKS) + tuple(sorted(SHARED_KINDS))

#: the ROADMAP Queue 1 item that brings each missing block kind
KIND_ITEMS = {"moe": 4, "attn_cross": 6}


def _entry_kind(b: BlockSpec) -> str:
    return "attn" if b.kind in SHARED_KINDS else b.kind


def unported(cfg: ModelConfig) -> Optional[str]:
    """Why :class:`Model` cannot build ``cfg`` yet, or ``None``: each
    missing part with the ROADMAP Queue 1 item that brings it."""
    missing = [f"block kind {b.kind!r} (ROADMAP Queue 1 item "
               f"{KIND_ITEMS.get(b.kind, '?')})" for b in cfg.pattern
               if b.kind not in KINDS]
    if cfg.n_enc_layers:
        missing.append("an encoder, n_enc_layers (ROADMAP Queue 1 item 6)")
    if cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend (ROADMAP Queue 1 "
                       f"item 7)")
    if cfg.m_rope:
        missing.append("M-RoPE (ROADMAP Queue 1 item 7)")
    if not missing:
        return None
    return (f"{cfg.name} needs {', '.join(dict.fromkeys(missing))}, which "
            f"repro_torch does not have yet: the port's LM substrate has "
            f"the block kinds {', '.join(KINDS)} only")


#: the products whose outputs ``remat="dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str):
    """``fn(block, *args)`` running a block under the remat ``policy``."""
    if policy == "none":
        return lambda blk, *a: blk(*a)
    kw = dict(use_reentrant=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _keep_dots)
    elif policy != "full":
        raise ValueError(f"unknown remat policy {policy!r}")
    return lambda blk, *a: ckpt.checkpoint(blk, *a, **kw)


class Model(nn.Module):
    """A decoder built on ``device`` (``None`` = the GPU, raising where
    there is none) from ``generator`` (default: seed 0 on that device),
    tensor by tensor, in ``cfg.param_dtype``."""

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
        shared: Dict[int, nn.Module] = {}
        blocks = []
        for _ in range(cfg.n_super):
            for i, b in enumerate(cfg.pattern):
                build = BLOCKS[_entry_kind(b)]
                for _ in range(b.repeat):
                    if b.kind not in SHARED_KINDS:
                        blocks.append(build(cfg, generator=gen))
                        continue
                    if i not in shared:     # built at its first use
                        shared[i] = build(cfg, generator=gen)
                    blocks.append(shared[i])
        self.blocks = nn.ModuleList(blocks)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_ln)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T.to(x.dtype)
        return x @ self.unembed

    def forward(self, tokens: torch.Tensor,
                force_chunked: bool = False) -> torch.Tensor:
        """tokens: [B,S] integer -> logits [B,S,V].  ``force_chunked`` puts
        every layer's attention on the chunked route (to hold the flash
        route against it).  Blocks run under ``cfg.remat`` while autograd
        records and the weights need a gradient."""
        x = self.embed[tokens].to(dtype_of(self.cfg.compute_dtype))
        training = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        run = _remat(self.cfg.remat if training else "none")
        for blk in self.blocks:
            x = run(blk, x, 0, force_chunked)
        return self._logits(x)

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``batch``: ``{"tokens": [B,S], "labels": [B,S]}`` -> ``(total,
        {"xent", "aux"})``, the reference's ``loss_fn``: the mean cross
        entropy (softcapped by ``cfg.logit_softcap``) plus ``0.01·aux``,
        where ``aux`` (the MoE balance loss) is 0 for every ported
        block."""
        logits = self(batch["tokens"])
        loss = softmax_xent(logits, batch["labels"], self.cfg.logit_softcap)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        total = loss + 0.01 * aux
        return total, dict(xent=loss, aux=aux)

    def init_cache(self, batch: int, max_len: int
                   ) -> List[Dict[str, torch.Tensor]]:
        """One cache per position of ``blocks`` (a shared block's too):
        K/V of [B, max_len, KV, hd] for attention, the recurrent state
        for the others."""
        return [blk.init_cache(batch, max_len) for blk in self.blocks]

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """tokens: [B,1]; ``pos``: the current cache length.  Advances
        every block's cache by this token and returns logits [B,1,V]."""
        x = self.embed[tokens].to(dtype_of(self.cfg.compute_dtype))
        for blk, c in zip(self.blocks, cache):
            x = blk.decode(c, x, pos)
        return self._logits(x)
