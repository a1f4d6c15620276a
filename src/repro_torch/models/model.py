"""Model assembly: embeddings + the blocks + LM head, the counterpart of
the JAX package's ``models/model.py`` for models of the block kinds
``attn``, ``attn_local``, ``attn_cross``, ``moe``, ``mamba2``, ``mlstm``,
``slstm`` and the shared attention block ``shared_attn``, and for the
encoder of an encoder-decoder (``cfg.n_enc_layers``).

The reference stacks each pattern entry's weights ``[n_super, repeat,
...]`` and scans one super-block body; here the blocks are one
``nn.ModuleList`` in the order that scan visits them (super-block by
super-block, each pattern entry's ``repeat`` layers in turn).  A shared
entry (zamba2's ``shared_attn``, ``SHARED_KINDS``) is one ``AttnBlock``
referenced from every position it takes in that list: one copy of its
weights, which ``named_parameters()`` lists once, under its first
position's name, and whose gradient sums over its uses; its caches stay
per position.

The encoder (``enc``, ``n_enc_layers`` plain attention blocks run
non-causally, then ``enc_ln``) turns ``enc_embeds`` [B,S_enc,d] (the
audio frontend's stub: precomputed frame embeddings) into the output
every ``attn_cross`` block attends to.

Public surface::

    m = Model(cfg, device=None, generator=None,   # weights built on device
              tp=None,                        # or (rank, m): its shards
              dp=None)                        # or (rank, D): experts' width
    logits = m(tokens[, enc_embeds][, frontend=])  # prefill forward [B,S,V]
    cache = m.init_cache(batch, max_len[, enc_embeds])  # one per position
    m.encode_into(cache, enc_embeds)               # the encoder, once
    logits = m.decode_step(cache, tokens, pos)     # [B,1,V]; cache updated
    m.requires_grad_(True)                         # make it trainable
    loss, aux = m.loss_fn(batch)  # {"tokens", "labels"[, "enc_embeds"]
                                  #  [, "frontend"]}
    specs = m.param_specs()       # {parameter name: sharding.P}
    layout = m.layout()           # {parameter name: Leaf}: what is sharded
                                  # and what is not the rank's part
    heads = m.computed_heads()    # {module name: (lo, hi)}: this rank's
    chans = m.computed_channels() # {mLSTM module: (ch_lo, ch_hi)}

A vision-language model (``cfg.frontend == "vision"``, qwen2-vl) takes
the frontend's output ``frontend`` [B,nf,d] (the vision tower's stub:
precomputed patch embeddings) ahead of the token embeddings, so its
positions run 0..nf+S-1 through every layer (M-RoPE, ``cfg.m_rope``,
with all three streams at the token index); ``loss_fn`` drops the ``nf``
frontend positions before the cross entropy.

``loss_fn``'s total is the cross entropy plus ``0.01·aux``, where ``aux``
sums the MoE blocks' balance losses in block order (0 without them); it
leaves each block as an output of the function remat runs, never as
module state a recompute could overwrite.

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

:func:`unported` names a block kind the port does not have (every
config of ``configs/archs.py`` has only kinds it has), and
:class:`Model` refuses such a config.

``Model(cfg, device="meta")`` allocates every weight with ``torch.empty``
on ``meta`` and draws nothing (the dry-run's model).  ``tp=(rank, m)``
builds rank ``rank``'s shards of a "model" group of ``m``
(:mod:`~repro_torch.models.blocks` says which and how they compute): each
leaf is drawn whole from the same seeded stream as the world of one's and
sliced, so the ranks' shards concatenate bit for bit to the one-device
model's leaves.  ``dp=(rank, D)`` keeps, of every expert, only the rank's
``d_ff / D`` slice of its hidden width along the mesh's "data" dimension
(the reference's ``P(E, None, "data")``), drawn the same way.  Such a
model runs only inside ``sharding.parallel(model=..., width=...)`` over
groups of ``m`` and ``D``.  Its embedding is
vocab-parallel (a masked local lookup, summed over "model"), its logits
are the rank's slice of the vocabulary (``forward`` and ``decode_step``
return ``[..., V/m]``), and ``loss_fn``'s cross entropy is vocab-parallel
(all-reduces of the max, the sum of exponentials and the target logit;
``[B, S, V]`` is never built whole).  :meth:`Model.layout` is the one
rule of which leaves a rank holds sliced and which it gathers whole.

One fault of the reference is not copied: its ``init_cache`` projects
the cross-attention's K/V with the decoder's *self*-attention weights
(``attn.wk`` / ``attn.wv``) where its forward uses ``xattn``'s, so its
decode and forward disagree; here both use ``xattn``'s
(:meth:`AttnBlock.cross_kv`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import DeviceLike, resolve_device
from . import sharding
from .blocks import (AttnBlock, Mamba2Block, MlstmBlock, MoeBlock,
                     SlstmBlock, _init_dense, _ones, _param)
from .config import BlockSpec, ModelConfig
from .layers import draw_normal, dtype_of, rms_norm, softmax_xent
from .sharding import P, mdl, model_dim

#: the block class of each ported kind (``shared_attn``: see SHARED_KINDS)
BLOCKS = {
    "attn": AttnBlock,
    "attn_local": lambda cfg, generator: AttnBlock(cfg, local=True,
                                                   generator=generator),
    "attn_cross": lambda cfg, generator: AttnBlock(cfg, cross=True,
                                                   generator=generator),
    "moe": MoeBlock,
    "mamba2": Mamba2Block,
    "mlstm": MlstmBlock,
    "slstm": SlstmBlock,
}
SHARED_KINDS = {"shared_attn"}      # zamba2: one weight copy, many uses
KINDS = tuple(BLOCKS) + tuple(sorted(SHARED_KINDS))


def _entry_kind(b: BlockSpec) -> str:
    return "attn" if b.kind in SHARED_KINDS else b.kind


def unported(cfg: ModelConfig) -> Optional[str]:
    """Why :class:`Model` cannot build ``cfg``, or ``None``: the block
    kinds of its pattern that the port does not have."""
    missing = [f"block kind {b.kind!r}" for b in cfg.pattern
               if b.kind not in KINDS]
    if not missing:
        return None
    return (f"{cfg.name} needs {', '.join(dict.fromkeys(missing))}, which "
            f"repro_torch does not have: the port's LM substrate has "
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


@dataclasses.dataclass(frozen=True)
class Leaf:
    """How a rank holds one parameter over a ("data", "model") mesh:
    ``spec`` its partition spec; ``shard_dim`` the dimension it is stored
    sliced along over "model" (``None``: whole); ``gather`` ``"use"``
    (stored sliced, and the slice is not the part the rank's heads read:
    at each use the leaf is gathered whole over "model" and cut, or its
    product is exchanged instead, by ``blocks.heads_form``) or ``None``; ``data_dim`` the
    dimension its spec shards over "data"; ``width_dim`` the dimension it
    is stored sliced along over "data" (the experts' hidden width, in a
    model built with ``dp=(rank, D)``, D > 1; ``None``: whole over
    "data", and the train step keeps a ZeRO-1 slice of it)."""
    spec: P
    shard_dim: Optional[int]
    gather: Optional[str]
    data_dim: Optional[int]
    width_dim: Optional[int] = None


class _NoDraws:
    """The generator of a ``meta`` build: it names the device and draws
    nothing."""

    def __init__(self):
        self.device = torch.device("meta")


def _embed_spec(cfg: ModelConfig) -> P:
    return P(mdl(cfg.vocab_size), None) if cfg.embed_shard == "vocab" \
        else P(None, mdl(cfg.d_model))


class _VocabParallelXent(torch.autograd.Function):
    """The mean cross entropy of fp32 logits ``lg [N, V/m]``, this rank's
    slice of the vocabulary, against ``labels [N]``: the max, the sum of
    exponentials and the target's logit all-reduced over "model"."""

    @staticmethod
    def forward(ctx, lg, labels):
        axis = sharding.model_axis()
        vl = lg.shape[-1]
        mx = sharding.all_reduce(lg.max(dim=-1).values, axis, op="max")
        ex = torch.exp(lg - mx[:, None])
        se = sharding.all_reduce(ex.sum(dim=-1), axis)
        local = labels - axis.rank * vl
        inside = (local >= 0) & (local < vl)
        local = torch.where(inside, local, 0)
        gold = torch.gather(lg, -1, local[:, None])[:, 0] * inside
        gold = sharding.all_reduce(gold, axis)
        ctx.save_for_backward(ex, se, local, inside)
        return (torch.log(se) + mx - gold).mean()

    @staticmethod
    def backward(ctx, g):
        ex, se, local, inside = ctx.saved_tensors
        grad = ex / se[:, None]
        grad[torch.arange(grad.shape[0], device=grad.device), local] -= \
            inside.to(grad.dtype)
        return grad * (g / grad.shape[0]), None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        softcap: float = 0.0) -> torch.Tensor:
    """:func:`layers.softmax_xent` of logits sharded over "model" by
    vocabulary, ``[..., V/m]``, without gathering them."""
    lg = logits.float()
    if softcap > 0.0:
        lg = torch.tanh(lg / softcap) * softcap
    return _VocabParallelXent.apply(lg.reshape(-1, lg.shape[-1]),
                                    labels.reshape(-1).long())


class Model(nn.Module):
    """A decoder built on ``device`` (``None`` = the GPU, raising where
    there is none; ``"meta"``: allocated, not drawn) from ``generator``
    (default: seed 0 on that device), tensor by tensor, in
    ``cfg.param_dtype``; with ``tp=(rank, m)`` only rank ``rank``'s
    shards of a "model" group of ``m``; with ``dp=(rank, D)`` only rank
    ``rank``'s slice of the experts' hidden width over "data"."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 tp: Optional[Tuple[int, int]] = None,
                 dp: Optional[Tuple[int, int]] = None):
        super().__init__()
        reason = unported(cfg)
        if reason:
            raise NotImplementedError(reason)
        device = resolve_device(device)
        self.cfg = cfg
        self.tp = tuple(tp) if tp is not None else (0, 1)
        self.dp = tuple(dp) if dp is not None else (0, 1)
        with sharding.build_shards(*self.tp, width=self.dp):
            self._build(cfg, device, generator)
        for name, p in self.named_parameters():
            p.leaf_name = name          # named in a gather's count

    def _build(self, cfg: ModelConfig, device: torch.device,
               generator: Optional[torch.Generator]) -> None:
        if device.type == "meta":
            gen = _NoDraws()
        else:
            gen = generator if generator is not None else \
                torch.Generator(device=device).manual_seed(0)
        dt = dtype_of(cfg.param_dtype)
        espec = _embed_spec(cfg)
        embed = draw_normal(gen, (cfg.vocab_size, cfg.d_model))
        self.embed = _param(embed.mul_(0.02).to(dt), espec)
        del embed
        uspec = P(None, mdl(cfg.vocab_size))
        self.unembed = None if cfg.tie_embeddings else \
            _param(_init_dense(gen, cfg.d_model, cfg.vocab_size, dt), uspec)
        m = self.tp[1]
        # the logits are this rank's slice of the vocabulary
        self._vocab_local = m > 1 and (
            model_dim(espec) == 0 if cfg.tie_embeddings else
            model_dim(uspec) == 1)
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
        self.enc = nn.ModuleList(AttnBlock(cfg, generator=gen)
                                 for _ in range(cfg.n_enc_layers))
        self.enc_ln = _ones(cfg, gen) if cfg.n_enc_layers else None

    def _check_group(self) -> None:
        m = self.tp[1]
        if m > 1 and sharding.model_size() != m:
            raise RuntimeError(
                f"this model holds rank {self.tp[0]}'s shards of a 'model' "
                f"group of {m}; run it inside sharding.parallel(model=...) "
                f"over such a group (declared: {sharding.model_size()})")
        width = sharding.width_axis()
        d = 1 if width is None else width.size
        if self.cfg.n_experts and d != self.dp[1]:
            raise RuntimeError(
                f"this model holds rank {self.dp[0]}'s slice of the "
                f"experts' hidden width over {self.dp[1]}; run it inside "
                f"sharding.parallel(width=...) over such a group "
                f"(declared: {d})")

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embeddings of ``tokens``: a lookup; where the table is
        sharded by vocabulary, a masked local lookup summed over "model";
        by width, the local columns gathered over "model"."""
        e = self.embed
        dim = model_dim(_embed_spec(self.cfg)) if self.tp[1] > 1 else None
        if dim is None:
            return e[tokens]
        if dim == 1:
            return sharding.gather_from_model(e[tokens], -1)
        vl = e.shape[0]
        local = tokens - sharding.model_rank() * vl
        inside = (local >= 0) & (local < vl)
        x = e[torch.where(inside, local, 0)] * inside[..., None]
        return sharding.reduce_from_model(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_ln)
        if self._vocab_local:
            x = sharding.copy_to_model(x)
        if not self.cfg.tie_embeddings:
            return x @ self.unembed
        e = self.embed
        dim = model_dim(_embed_spec(self.cfg)) if self.tp[1] > 1 else None
        if dim == 1:                    # sharded by width: gathered
            e = sharding.gather_from_model(e, 1, e.leaf_name)
        return x @ e.T.to(x.dtype)

    def _run(self) -> Callable:
        """``run(block, *args)`` under ``cfg.remat`` while autograd
        records and the weights need a gradient, plainly otherwise."""
        training = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        return _remat(self.cfg.remat if training else "none")

    def encode(self, enc_embeds: torch.Tensor,
               force_chunked: bool = False) -> torch.Tensor:
        """The encoder: ``enc_embeds`` [B,S_enc,d] (cast to the compute
        dtype) through every encoder block, non-causally, then
        ``enc_ln``."""
        x = enc_embeds.to(dtype_of(self.cfg.compute_dtype))
        run = self._run()
        for blk in self.enc:
            x, _ = run(blk, x, 0, force_chunked, None, False)
        return rms_norm(x, self.enc_ln)

    def forward_with_aux(self, tokens: torch.Tensor,
                         enc_embeds: Optional[torch.Tensor] = None,
                         frontend: Optional[torch.Tensor] = None,
                         force_chunked: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: [B,S] integer -> ``(logits [B,nf+S,V], aux)``, ``aux``
        the fp32 sum of the blocks' balance losses in block order.
        ``enc_embeds`` [B,S_enc,d] runs the encoder, whose output the
        cross blocks attend to; ``frontend`` [B,nf,d] (cast to the
        compute dtype) goes ahead of the token embeddings."""
        self._check_group()
        x = self._embed(tokens).to(dtype_of(self.cfg.compute_dtype))
        if frontend is not None:
            x = torch.cat([frontend.to(x.dtype), x], dim=1)
        run = self._run()
        extra = ()
        if enc_embeds is not None:
            extra = (self.encode(enc_embeds, force_chunked),)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x, a = run(blk, x, 0, force_chunked, *extra)
            aux = aux + a
        return self._logits(x), aux

    def forward(self, tokens: torch.Tensor,
                enc_embeds: Optional[torch.Tensor] = None,
                frontend: Optional[torch.Tensor] = None,
                force_chunked: bool = False) -> torch.Tensor:
        """tokens: [B,S] integer -> logits [B,nf+S,V] (``nf`` the
        ``frontend``'s positions, 0 without).  ``force_chunked`` puts
        every attention on the chunked route (to hold the flash route
        against it).  Blocks run under ``cfg.remat`` while autograd
        records and the weights need a gradient."""
        return self.forward_with_aux(tokens, enc_embeds, frontend,
                                     force_chunked)[0]

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``batch``: ``{"tokens": [B,S], "labels": [B,S]}`` and, for an
        encoder-decoder, ``"enc_embeds"``, for a vision-language model,
        ``"frontend"`` [B,nf,d] -> ``(total, {"xent", "aux"})``, the
        reference's ``loss_fn``: the mean cross entropy over the text
        positions (softcapped by ``cfg.logit_softcap``) plus
        ``0.01·aux``."""
        frontend = batch.get("frontend")
        logits, aux = self.forward_with_aux(batch["tokens"],
                                            batch.get("enc_embeds"),
                                            frontend)
        if frontend is not None:
            logits = logits[:, frontend.shape[1]:]
        xent = vocab_parallel_xent if self._vocab_local else softmax_xent
        loss = xent(logits, batch["labels"], self.cfg.logit_softcap)
        total = loss + 0.01 * aux
        return total, dict(xent=loss, aux=aux)

    def param_specs(self) -> Dict[str, sharding.P]:
        """One :class:`~repro_torch.models.sharding.P` per named parameter
        (a shared block's under its first position, as
        ``named_parameters()`` lists it): the reference's
        ``param_specs()`` leaf for leaf, without its stacked layer axes."""
        cfg = self.cfg
        specs = {"embed": _embed_spec(cfg)}
        if self.unembed is not None:
            specs["unembed"] = P(None, mdl(cfg.vocab_size))
        specs["final_ln"] = P(None)
        if self.enc_ln is not None:
            specs["enc_ln"] = P(None)
        seen = set()
        for prefix, blocks in (("blocks", self.blocks), ("enc", self.enc)):
            for n, blk in enumerate(blocks):
                if id(blk) in seen:
                    continue
                seen.add(id(blk))
                for name, spec in blk.param_specs().items():
                    specs[f"{prefix}.{n}.{name}"] = spec
        return {n: specs[n] for n, _ in self.named_parameters()}

    def layout(self) -> Dict[str, Leaf]:
        """The one rule of what a rank of this model's "model" group holds
        and gathers, by parameter name (:class:`Leaf`).  A leaf whose spec
        names "model" is stored sliced; it is computed on as it is where
        its slice is the part the rank's heads read, and where it is not
        (``gather="use"``) each use gathers it whole or exchanges its
        product (``blocks._Heads.product``).  A leaf
        whose spec names "data" (the experts' hidden width) is stored
        sliced along it in a model built with ``dp=(rank, D)``
        (``width_dim``), and whole otherwise."""
        m = self.tp[1]
        owner = {}
        for mname, mod in self.named_modules():
            for pname, _ in mod.named_parameters(recurse=False):
                owner[f"{mname}.{pname}" if mname else pname] = mod
        out = {}
        for n, spec in self.param_specs().items():
            dim = model_dim(spec) if m > 1 else None
            use = n.rsplit(".", 1)[-1] in getattr(owner[n], "gather_leaves",
                                                   ())
            ddim = sharding.data_dim(spec)
            out[n] = Leaf(spec, dim, "use" if use else None, ddim,
                          ddim if self.dp[1] > 1 else None)
        return out

    def computed_heads(self) -> Dict[str, Tuple[int, int]]:
        """The heads ``[lo, hi)`` this rank computes in each module that
        splits heads over "model", by module name (``blocks.heads_split``,
        the mLSTM's ``blocks.value_split``; a shared block once)."""
        return {n: mod.heads for n, mod in self.named_modules()
                if isinstance(getattr(mod, "heads", None), tuple)}

    def computed_channels(self) -> Dict[str, Tuple[int, int]]:
        """The value channels ``[ch_lo, ch_hi)`` of each of its heads
        this rank computes in each mLSTM block, by module name
        (``blocks.value_split``: every channel where the heads split over
        "model", the rank's share of its one head's where they are
        fewer)."""
        return {n: mod.channels for n, mod in self.named_modules()
                if isinstance(getattr(mod, "channels", None), tuple)}

    def whole_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's shape in the world of one, by name: the
        shard's with its "model" dimension (``layout()``) times m and its
        "data" one (``width_dim``) times D."""
        layout = self.layout()
        out = {}
        for n, p in self.named_parameters():
            shape = list(p.shape)
            if layout[n].shard_dim is not None:
                shape[layout[n].shard_dim] *= self.tp[1]
            if layout[n].width_dim is not None:
                shape[layout[n].width_dim] *= self.dp[1]
            out[n] = tuple(shape)
        return out

    def init_cache(self, batch: int, max_len: int,
                   enc_embeds: Optional[torch.Tensor] = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """One cache per position of ``blocks`` (a shared block's too):
        K/V of [B, max_len, KV, hd] for attention, the recurrent state
        for the others.  With ``enc_embeds`` [B,S_enc,d] the encoder runs
        once and each cross block's cache gets its ``xk`` / ``xv``
        [B,S_enc,KV,hd]; without, decode has no cross-attention."""
        caches = [blk.init_cache(batch, max_len) for blk in self.blocks]
        if enc_embeds is not None:
            self.encode_into(caches, enc_embeds)
        return caches

    def encode_into(self, cache: List[Dict[str, torch.Tensor]],
                    enc_embeds: torch.Tensor) -> None:
        """Run the encoder once on ``enc_embeds`` [B,S_enc,d] and set each
        cross block's ``xk`` / ``xv`` [B,S_enc,KV,hd] in ``cache`` (a
        no-op without an encoder)."""
        if not self.cfg.n_enc_layers:
            return
        enc_out = self.encode(enc_embeds)
        for blk, c in zip(self.blocks, cache):
            if isinstance(blk, AttnBlock) and blk.cross:
                c.update(blk.cross_kv(enc_out))

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """tokens: [B,1]; ``pos``: the current cache length.  Advances
        every block's cache by this token and returns logits [B,1,V]."""
        self._check_group()
        x = self._embed(tokens).to(dtype_of(self.cfg.compute_dtype))
        for blk, c in zip(self.blocks, cache):
            x = blk.decode(c, x, pos)
        return self._logits(x)
