"""The block kinds of the LM substrate, the counterparts of the JAX
package's ``build_*`` / ``train_*`` / ``cache_init_*`` / ``decode_*``
(``models/blocks.py``): the attention block (``attn`` / ``attn_local``,
and ``attn_cross`` with cross-attention to an encoder's output), the
attention + mixture-of-experts block (``moe``), Mamba-2 (``mamba2``) and
the xLSTM's ``mlstm`` and ``slstm``.

Each block is an ``nn.Module`` with ``forward(x, off, force_chunked)``,
``init_cache(batch, max_len)``, ``decode(cache, x_t, pos)`` and
``param_specs()`` (the reference builder's partition specs, by parameter
name: Megatron's tensor-parallel split over "model"); ``decode``
updates ``cache`` (a dict) in place or replaces its entries, as the
reference's returned cache would have them.  Every ``forward`` returns
``(x, aux)``: ``aux`` is ``MoeBlock``'s balance loss, an fp32 scalar,
and an fp32 zero for the other kinds.  Weights keep the reference's
``[d_in, d_out]`` layout and are applied as ``x @ w`` (no ``nn.Linear``),
so a JAX parameter tree copies over leaf for leaf
(:mod:`repro_torch.models.convert`).  They are built on the generator's
device in the parameter dtype (Mamba-2's ``a_log``, ``d_skip`` and
``dt_bias`` in fp32, as the reference's) and need no gradient until the
model is made trainable.

Built under :func:`sharding.build_shards` (``Model(cfg, tp=(rank, m))``),
every leaf whose spec names "model" keeps only the rank's slice, drawn
whole and sliced, so the draws are the world of one's.  The attention
block, the MLP, the experts and (in ``Model``) the embeddings then
compute on their shards, Megatron's way: ``wq`` / ``wk`` / ``wv`` and
``w1`` / ``w3`` are column-parallel on the rank's heads and hidden units
behind one :func:`sharding.copy_to_model`, ``wo`` and ``w2`` are
row-parallel with one :func:`sharding.reduce_from_model` after each, and
the experts run expert-parallel (``moe.moe_ffn(expert_parallel=True)``).
Where the heads do not split whole over the group (:func:`heads_split`),
the leaves concerned stay sharded in storage and are gathered whole at
use: only ``wk`` / ``wv`` where each rank's query heads read one K/V head
(cut to that head's columns before the product), all four where the
query heads do not split, and that attention is computed whole.  The recurrent blocks
(``COMPUTES_ON_SHARDS = False``) are built whole and compute whole:
their packed projections (``in_proj``'s z/x/B/C/dt, ``wx``'s four
gates) do not split by heads as a plain column slice, so the train step
gathers their leaves over "model" (``Model.layout``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import attention as attn_lib
from . import moe as moe_lib
from . import sharding
from . import ssm as ssm_lib
from .config import ModelConfig
from .sharding import P, mdl, model_dim
from .layers import (_init_dense, apply_m_rope, apply_rope, draw_normal,
                     dtype_of, mlp, rms_norm)


def _param(t: torch.Tensor, spec: Optional[P] = None) -> nn.Parameter:
    """A leaf that needs no gradient; under :func:`sharding.build_shards`
    only its slice along the dimension ``spec`` names "model"."""
    return nn.Parameter(sharding.keep_shard(t, spec), requires_grad=False)


def heads_split(cfg: ModelConfig, m: int) -> str:
    """How the attention's heads split over a "model" group of ``m``:
    ``"whole"`` (every rank holds whole query heads and the whole K/V
    heads they read), ``"kv"`` (whole query heads, all of which read one
    K/V head, while the K/V heads themselves do not split: ``wk`` / ``wv``
    are gathered at use and cut to the rank's head), or ``"none"`` (the
    query heads do not split: all four leaves are gathered at use)."""
    specs = _attn_leaf_specs(cfg)
    if not all(model_dim(sp) is not None for sp in specs.values()) or \
            cfg.n_heads % m:
        return "none"
    if cfg.n_kv_heads % m == 0:
        return "whole"
    local, n_rep = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    return "kv" if n_rep % local == 0 else "none"


def _ones(cfg: ModelConfig, gen: torch.Generator) -> nn.Parameter:
    return _param(torch.ones((cfg.d_model,), dtype=dtype_of(cfg.param_dtype),
                             device=gen.device))


def _draw(gen: torch.Generator, shape, std: float,
          dtype: torch.dtype) -> torch.Tensor:
    """``normal * std`` drawn in fp32 on ``gen``'s device, cast."""
    return draw_normal(gen, shape).mul_(std).to(dtype)


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    """The balance loss of a block that has none: an fp32 zero."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _randn(gen: torch.Generator, shape, std: float,
           dtype: torch.dtype, spec: Optional[P] = None) -> nn.Parameter:
    return _param(_draw(gen, shape, std, dtype), spec)


def _attn_leaf_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Megatron's column/row split of ``_AttnParams`` over "model"."""
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return dict(wq=P(None, mdl(q)), wk=P(None, mdl(kv)), wv=P(None, mdl(kv)),
                wo=P(mdl(q), None))


def _mlp_leaf_specs(cfg: ModelConfig, d_ff: int) -> Dict[str, P]:
    out = dict(w1=P(None, mdl(d_ff)))
    if cfg.mlp_kind == "swiglu":
        out["w3"] = P(None, mdl(d_ff))
    out["w2"] = P(mdl(d_ff), None)
    return out


def _prefixed(prefix: str, specs: Dict[str, P]) -> Dict[str, P]:
    return {f"{prefix}.{n}": sp for n, sp in specs.items()}


class _AttnParams(nn.Module):
    """``wq [d, H*hd]``, ``wk`` / ``wv [d, KV*hd]``, ``wo [H*hd, d]`` (the
    reference's ``_attn_params``), or the rank's slices of them.  ``tp``:
    ``wq`` / ``wo`` hold whole query heads of this rank, computed on as
    they are; ``kv_select``: ``wk`` / ``wv`` are gathered whole at use
    and cut to the one K/V head the rank's query heads read; where the
    query heads do not split whole, all four are gathered whole at use
    (:meth:`weights`).  ``gather_leaves`` names the leaves gathered at
    use."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.specs = sp = _attn_leaf_specs(cfg)
        self.wq = _param(_init_dense(gen, d, h * hd, dt), sp["wq"])
        self.wk = _param(_init_dense(gen, d, kv * hd, dt), sp["wk"])
        self.wv = _param(_init_dense(gen, d, kv * hd, dt), sp["wv"])
        self.wo = _param(_init_dense(gen, h * hd, d, dt), sp["wo"])
        m = sharding.build_size()
        split = heads_split(cfg, m) if m > 1 else "whole"
        self.tp = m > 1 and split != "none"
        self.kv_select = m > 1 and split == "kv"
        self.gather_leaves = ("wq", "wk", "wv", "wo") if split == "none" \
            else ("wk", "wv") if self.kv_select else ()
        # the K/V head the rank's query heads read (kv_select)
        self.kv_head = sharding.build_rank() * (h // m) // (h // kv) \
            if self.kv_select else 0

    def weights(self):
        """``(wq, wk, wv, wo)`` to compute with: the stored ones, and each
        of ``gather_leaves`` gathered whole over "model" (its gradient
        then this rank's slice of the whole one, which every rank holds
        alike); for ``kv_select`` ``wk`` / ``wv`` cut to the columns of
        the rank's K/V head (their gradient then the sum of the ranks'
        partial ones)."""
        out = []
        hd = self.cfg.hd
        for n in ("wq", "wk", "wv", "wo"):
            w = getattr(self, n)
            if n in self.gather_leaves:
                w = sharding.gather_from_model(
                    w, model_dim(self.specs[n]), getattr(w, "leaf_name", n),
                    partial_grad=self.kv_select)
                if self.kv_select:
                    w = w[:, self.kv_head * hd:(self.kv_head + 1) * hd]
            out.append(w)
        return out

    def kv_heads(self) -> int:
        """The K/V heads this rank computes (its cache's)."""
        if self.kv_select:
            return 1
        return self.wk.shape[1] // self.cfg.hd if self.tp else \
            self.cfg.n_kv_heads


def _column(x: torch.Tensor, tp: bool) -> torch.Tensor:
    """The input of column-parallel products."""
    return sharding.copy_to_model(x) if tp else x


def _row(y: torch.Tensor, tp: bool) -> torch.Tensor:
    """The output of a row-parallel product, summed over "model"."""
    return sharding.reduce_from_model(y) if tp else y


class _MlpParams(nn.Module):
    """``w1 [d, d_ff]``, ``w2 [d_ff, d]`` and, for SwiGLU, ``w3 [d, d_ff]``
    (``None`` for the 2-matrix GELU MLP): the reference's ``_mlp_params``,
    or the rank's slices of ``d_ff`` (``tp``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, d_ff: int):
        super().__init__()
        d = cfg.d_model
        dt = dtype_of(cfg.param_dtype)
        sp = _mlp_leaf_specs(cfg, d_ff)
        self.w1 = _param(_init_dense(gen, d, d_ff, dt), sp["w1"])
        if cfg.mlp_kind == "swiglu":
            self.w3 = _param(_init_dense(gen, d, d_ff, dt), sp["w3"])
        else:
            self.register_parameter("w3", None)
        self.w2 = _param(_init_dense(gen, d_ff, d, dt), sp["w2"])
        self.tp = sharding.build_size() > 1 and \
            model_dim(sp["w1"]) is not None


def _mlp(x: torch.Tensor, p: _MlpParams) -> torch.Tensor:
    """:func:`layers.mlp` on the rank's hidden units, summed over
    "model"."""
    return _row(mlp(_column(x, p.tp), p), p.tp)


def _attn_specs(cfg: ModelConfig, prefix: str) -> Dict[str, P]:
    return _prefixed(prefix, _attn_leaf_specs(cfg))


def _mlp_specs(cfg: ModelConfig, prefix: str, d_ff: int) -> Dict[str, P]:
    return _prefixed(prefix, _mlp_leaf_specs(cfg, d_ff))


def _qkv(cfg: ModelConfig, w, x: torch.Tensor,
         positions: Optional[torch.Tensor] = None,
         x_kv: Optional[torch.Tensor] = None):
    """q from ``x``, k/v from ``x_kv`` (default ``x``) by ``w = (wq, wk,
    wv, ...)``, on as many heads as the weights hold; RoPE at
    ``positions`` when they are given (self-attention only), M-RoPE for
    ``cfg.m_rope``."""
    b, s, _ = x.shape
    hd = cfg.hd
    xk = x if x_kv is None else x_kv
    q = (x @ w[0]).reshape(b, s, -1, hd)
    k = (xk @ w[1]).reshape(b, xk.shape[1], -1, hd)
    v = (xk @ w[2]).reshape(b, xk.shape[1], -1, hd)
    if positions is not None:
        rope = apply_m_rope if cfg.m_rope else apply_rope
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attention(cfg: ModelConfig, p: _AttnParams, x: torch.Tensor,
                    off: int, force_chunked: bool, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """``x`` [B,S,d] (normed) -> the attention's output projected by
    ``wo``, with RoPE at positions ``off``..``off+S-1``."""
    b, s, _ = x.shape
    w = p.weights()
    positions = off + torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(cfg, w, _column(x, p.tp), positions)
    o = attn_lib.attention(q, k, v, causal=causal, window=window,
                           q_offset=off, chunk=cfg.attention_chunk,
                           force_chunked=force_chunked)
    return _row(o.reshape(b, s, -1) @ w[3], p.tp)


def _self_decode(cfg: ModelConfig, p: _AttnParams,
                 cache: Dict[str, torch.Tensor], x: torch.Tensor, pos: int,
                 window: Optional[int] = None) -> torch.Tensor:
    """One token ``x`` [B,1,d] (normed) against the K/V cache, its own
    K/V written at ``pos`` first; returns the output projected by
    ``wo``."""
    b = x.shape[0]
    w = p.weights()
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, w, _column(x, p.tp), positions)
    kc, vc = attn_lib.update_cache(cache["k"], cache["v"], k, v, pos)
    o = attn_lib.decode_attention(q, kc, vc, pos + 1, window=window)
    return _row(o.reshape(b, 1, -1) @ w[3], p.tp)


class AttnBlock(nn.Module):
    """Pre-RMSNorm attention + MLP with residuals; ``local`` gives the
    sliding-window kind (``cfg.sliding_window``), ``cross`` the
    ``attn_cross`` kind: between the two, a pre-RMSNorm (``lnx``)
    non-causal cross-attention (``xattn``, no RoPE) from the decoder's
    stream to the encoder's output."""

    def __init__(self, cfg: ModelConfig, local: bool = False,
                 cross: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.local = local
        self.ln1 = _ones(cfg, generator)
        self.attn = _AttnParams(cfg, generator)
        self.ln2 = _ones(cfg, generator)
        self.mlp = _MlpParams(cfg, generator, cfg.d_ff)
        self.cross = cross
        if cross:
            self.lnx = _ones(cfg, generator)
            self.xattn = _AttnParams(cfg, generator)

    def param_specs(self) -> Dict[str, P]:
        """The reference's ``build_attn`` specs, by parameter name."""
        out = dict(ln1=P(None), **_attn_specs(self.cfg, "attn"), ln2=P(None),
                   **_mlp_specs(self.cfg, "mlp", self.cfg.d_ff))
        if self.cross:
            out.update(lnx=P(None), **_attn_specs(self.cfg, "xattn"))
        return out

    @property
    def window(self):
        return self.cfg.sliding_window if self.local else None

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False,
                enc_out: Optional[torch.Tensor] = None,
                causal: bool = True):
        """x: [B,S,d] at absolute positions ``off``..``off+S-1`` ->
        ``(x, 0)``;
        ``enc_out`` [B,S_enc,d]: the encoder's output, attended to by a
        cross block (ignored by the others); ``causal=False``: the
        encoder's self-attention."""
        x = x + _self_attention(self.cfg, self.attn, rms_norm(x, self.ln1),
                                off, force_chunked, causal, self.window)
        if enc_out is not None and self.cross:
            b, s, _ = x.shape
            xa = self.xattn
            w = xa.weights()
            q, k, v = _qkv(self.cfg, w, _column(rms_norm(x, self.lnx), xa.tp),
                           x_kv=_column(enc_out, xa.tp))
            o = attn_lib.attention(q, k, v, causal=False, chunk=0,
                                   force_chunked=force_chunked)
            x = x + _row(o.reshape(b, s, -1) @ w[3], xa.tp)
        return x + _mlp(rms_norm(x, self.ln2), self.mlp), _no_aux(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zeroed K/V caches [B, max_len, KV, hd] in the compute dtype, of
        this rank's K/V heads (a cross block's ``xk`` / ``xv`` come from
        ``Model.init_cache``)."""
        return _kv_cache(self.cfg, self.attn.kv_heads(), batch, max_len,
                         self.ln1.device)

    def cross_kv(self, enc_out: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The cross-attention's K/V of ``enc_out`` [B,S_enc,d], ``xk`` /
        ``xv`` [B,S_enc,KV,hd] (this rank's K/V heads), projected by
        ``xattn`` as ``forward`` projects them."""
        _, k, v = _qkv(self.cfg, self.xattn.weights(),
                       _column(enc_out, self.xattn.tp))
        return dict(xk=k, xv=v)

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d]; ``pos``: the cache length before this token.  The
        token's K/V are written into ``cache`` in place; a cross block
        attends to the whole of ``cache["xk"]`` / ``["xv"]`` where they
        are."""
        x_t = x_t + _self_decode(self.cfg, self.attn,
                                 cache, rms_norm(x_t, self.ln1), pos,
                                 self.window)
        if self.cross and "xk" in cache:
            b = x_t.shape[0]
            xa = self.xattn
            w = xa.weights()
            q = (_column(rms_norm(x_t, self.lnx), xa.tp) @ w[0]).reshape(
                b, 1, -1, self.cfg.hd)
            o = attn_lib.decode_attention(q, cache["xk"], cache["xv"],
                                          cache["xk"].shape[1])
            x_t = x_t + _row(o.reshape(b, 1, -1) @ w[3], xa.tp)
        return x_t + _mlp(rms_norm(x_t, self.ln2), self.mlp)


def _kv_cache(cfg: ModelConfig, kv_heads: int, batch: int, max_len: int,
              device) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, kv_heads, cfg.hd)
    kw = dict(dtype=dtype_of(cfg.compute_dtype), device=device)
    return dict(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw))


# =========================================================== moe block


def _moe_leaf_specs(cfg: ModelConfig) -> Dict[str, P]:
    """The reference's ``build_moe`` specs of the experts: over "model",
    their hidden width over "data"."""
    e = mdl(cfg.n_experts)
    return dict(wg=P(None, e), w1=P(e, None, "data"), w3=P(e, None, "data"),
                w2=P(e, "data", None))


class _MoeParams(nn.Module):
    """The router ``wg [d, E]`` and the experts' ``w1`` / ``w3 [E, d,
    d_ff]``, ``w2 [E, d_ff, d]`` (``moe.moe_params_shape``), each drawn
    in fp32 with std ``1/sqrt(shape[-2])`` (``wg``: ``1/sqrt(d)``) and
    cast, the experts one at a time: a whole ``w1`` of arctic drawn at
    once would be a 17.8 GB fp32 temporary.  ``tp``: the experts are
    sharded over "model" and only the rank's are kept (every expert is
    still drawn, in order, so the draws are the world of one's); their
    "data" dimension is not split here (the train step gathers it)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        specs = _moe_leaf_specs(cfg)
        self.tp = sharding.build_size() > 1 and \
            model_dim(specs["w1"]) is not None
        for name, shape in moe_lib.moe_params_shape(
                cfg.d_model, cfg.n_experts, cfg.moe_d_ff).items():
            if len(shape) == 2:
                setattr(self, name, _randn(gen, shape,
                                           1.0 / math.sqrt(shape[0]), dt,
                                           specs[name]))
                continue
            lo, n = 0, shape[0]
            if self.tp:
                n = shape[0] // sharding.build_size()
                lo = n * sharding.build_rank()
            w = torch.empty((n,) + tuple(shape[1:]), dtype=dt,
                            device=gen.device)
            for e in range(shape[0] if gen.device.type != "meta" else 0):
                we = _draw(gen, shape[1:], 1.0 / math.sqrt(shape[-2]), dt)
                if lo <= e < lo + n:
                    w[e - lo] = we
            setattr(self, name, _param(w))


class MoeBlock(nn.Module):
    """Pre-RMSNorm causal attention, then a routed mixture-of-experts FFN
    (``moe``) and, for ``cfg.moe_dense_residual`` (arctic), a dense
    SwiGLU FFN (``dense``) on the same normed input, added to it; both
    with residuals.  ``forward`` takes the grouped dispatch when
    ``cfg.moe_grouped`` (``train_moe``), ``decode`` always the flat one
    (``decode_moe``): its capacity is ``max(1, ...)`` of the batch's
    tokens, so at a batch of a few tokens batch-mates routed to one
    expert are dropped, as in the reference."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _ones(cfg, generator)
        self.attn = _AttnParams(cfg, generator)
        self.ln2 = _ones(cfg, generator)
        self.moe = _MoeParams(cfg, generator)
        if cfg.moe_dense_residual:
            self.dense = _MlpParams(cfg, generator, cfg.d_ff)
        else:
            self.dense = None

    def param_specs(self) -> Dict[str, P]:
        """The reference's ``build_moe`` specs: experts over "model", their
        hidden width over "data"."""
        cfg = self.cfg
        out = {"ln1": P(None), **_attn_specs(cfg, "attn"), "ln2": P(None),
               **_prefixed("moe", _moe_leaf_specs(cfg))}
        if self.dense is not None:
            out.update(_mlp_specs(cfg, "dense", cfg.d_ff))
        return out

    def _ffn(self, h: torch.Tensor, grouped: bool):
        cfg = self.cfg
        w = dict(self.moe.named_parameters())
        if grouped:
            y, aux = moe_lib.moe_ffn_grouped(h, w, cfg.top_k,
                                             cfg.capacity_factor,
                                             cfg.moe_n_groups,
                                             expert_parallel=self.moe.tp)
        else:
            y, aux = moe_lib.moe_ffn(h, w, cfg.top_k, cfg.capacity_factor,
                                     expert_parallel=self.moe.tp)
        if self.dense is not None:
            y = y + _mlp(h, self.dense)
        return y, aux

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False):
        """x: [B,S,d] -> ``(x, aux)``, the balance loss an fp32 scalar."""
        x = x + _self_attention(self.cfg, self.attn, rms_norm(x, self.ln1),
                                off, force_chunked)
        y, aux = self._ffn(rms_norm(x, self.ln2), self.cfg.moe_grouped)
        return x + y, aux

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """Zeroed K/V caches [B, max_len, KV, hd] in the compute dtype, of
        this rank's K/V heads."""
        return _kv_cache(self.cfg, self.attn.kv_heads(), batch, max_len,
                         self.ln1.device)

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d]; the token's K/V are written into ``cache``."""
        x_t = x_t + _self_decode(self.cfg, self.attn, cache,
                                 rms_norm(x_t, self.ln1), pos)
        y, _ = self._ffn(rms_norm(x_t, self.ln2), grouped=False)
        return x_t + y


# =========================================================== mamba2 block


def _mamba_dims(cfg: ModelConfig):
    d_in = 2 * cfg.d_model
    headdim = 64
    nh = d_in // headdim
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n
    return d_in, headdim, nh, n, conv_dim


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv, width 4.  x: [B,S,C], w: [4,C].
    state: [B,3,C] previous tokens (decode) or None (zero pad).  Returns
    the output and the last 3 inputs (the next state)."""
    if state is None:
        pad = torch.zeros((x.shape[0], 3, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, 4):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, -3:]


class Mamba2Block(nn.Module):
    """Mamba-2: pre-RMSNorm, ``in_proj`` to (z, xBC, dt), a width-4
    causal conv and SiLU on xBC, SSD over ``nh`` heads of 64 with one
    B/C group, the ``d_skip`` term, a SiLU(z) gate and ``out_proj``, with
    a residual.  ``ln [d]``, ``in_proj [d, 2·d_in + 2·N + nh]``, ``conv_w
    [4, d_in + 2·N]``, ``out_proj [d_in, d]``; ``a_log``, ``d_skip``,
    ``dt_bias [nh]`` fp32."""

    COMPUTES_ON_SHARDS = False      # its leaves are gathered whole

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, _, nh, n, conv_dim = _mamba_dims(cfg)
        dt = dtype_of(cfg.param_dtype)
        gen = generator
        f32 = dict(dtype=torch.float32, device=gen.device)
        self.ln = _ones(cfg, gen)
        self.in_proj = _param(_init_dense(gen, d, 2 * d_in + 2 * n + nh, dt))
        self.conv_w = _randn(gen, (4, conv_dim), 0.2, dt)
        self.a_log = _param(torch.zeros((nh,), **f32))
        self.d_skip = _param(torch.ones((nh,), **f32))
        self.dt_bias = _param(torch.zeros((nh,), **f32))
        self.out_proj = _param(_init_dense(gen, d_in, d, dt))

    def param_specs(self) -> Dict[str, P]:
        d_in, _, nh, n, _ = _mamba_dims(self.cfg)
        return dict(ln=P(None), in_proj=P(None, mdl(2 * d_in + 2 * n + nh)),
                    conv_w=P(None, None), a_log=P(None), d_skip=P(None),
                    dt_bias=P(None), out_proj=P(mdl(d_in), None))

    def _project(self, x):
        d_in, _, _, _, conv_dim = _mamba_dims(self.cfg)
        zxbcdt = rms_norm(x, self.ln) @ self.in_proj
        return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
                zxbcdt[..., d_in + conv_dim:])

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False):
        """x: [B,S,d] with S a multiple of ``cfg.ssm_chunk`` ->
        ``(x, 0)``."""
        b, s, _ = x.shape
        d_in, hdim, nh, n, _ = _mamba_dims(self.cfg)
        z, xbc, dt_raw = self._project(x)
        xbc = F.silu(_causal_conv(xbc, self.conv_w)[0])
        xs = xbc[..., :d_in].reshape(b, s, nh, hdim)
        bmat = xbc[..., d_in:d_in + n]
        cmat = xbc[..., d_in + n:]
        dt = F.softplus(dt_raw.float() + self.dt_bias)
        a = -torch.exp(self.a_log) * dt                   # [B,S,H]
        y, _ = ssm_lib.ssd_chunked(xs * dt[..., None].to(xs.dtype), a,
                                   bmat, cmat, self.cfg.ssm_chunk)
        y = y.to(xs.dtype) + xs * self.d_skip[:, None].to(xs.dtype)
        y = y.reshape(b, s, d_in) * F.silu(z)
        return x + (y @ self.out_proj).to(x.dtype), _no_aux(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """The conv's last 3 inputs [B,3,C] and the SSD state [B,nh,64,N],
        zero, in the compute dtype."""
        _, hdim, nh, n, conv_dim = _mamba_dims(self.cfg)
        kw = dict(dtype=dtype_of(self.cfg.compute_dtype),
                  device=self.ln.device)
        return dict(conv=torch.zeros((batch, 3, conv_dim), **kw),
                    ssm=torch.zeros((batch, nh, hdim, n), **kw))

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d]; the state advances in fp32 and is stored back in
        the cache's dtype, as in the reference."""
        b = x_t.shape[0]
        d_in, hdim, nh, n, _ = _mamba_dims(self.cfg)
        z, xbc, dt_raw = self._project(x_t)
        xbc, conv_state = _causal_conv(xbc, self.conv_w, cache["conv"])
        xbc = F.silu(xbc)
        xs = xbc[:, 0, :d_in].reshape(b, nh, hdim)
        bmat = xbc[:, 0, d_in:d_in + n]
        cmat = xbc[:, 0, d_in + n:]
        dt = F.softplus(dt_raw[:, 0].float() + self.dt_bias)
        a = -torch.exp(self.a_log) * dt                   # [B,H]
        y, ssm = ssm_lib.ssd_decode_step(
            cache["ssm"].float(), (xs * dt[..., None].to(xs.dtype)).float(),
            a, bmat.float(), cmat.float())
        y = y.to(xs.dtype) + xs * self.d_skip[:, None].to(xs.dtype)
        y = y.reshape(b, 1, d_in) * F.silu(z)
        cache["conv"] = conv_state.to(cache["conv"].dtype)
        cache["ssm"] = ssm.to(cache["ssm"].dtype)
        return x_t + y @ self.out_proj


# =========================================================== mlstm block


def _mlstm_dims(cfg: ModelConfig):
    dp = int(cfg.d_model * cfg.mlstm_proj_factor)
    h = cfg.n_heads
    return dp, h, dp // h


class MlstmBlock(nn.Module):
    """xLSTM matrix-LSTM block: pre-RMSNorm, ``up`` to (x, z) of width
    dp = ``mlstm_proj_factor``·d, q/k/v and the i/f gates from x, the
    chunkwise mLSTM (:func:`ssm.mlstm_chunked`), a SiLU(z) gate and
    ``down``, with a residual.  ``ln [d]``, ``up [d, 2·dp]``, ``wq`` /
    ``wk`` / ``wv [dp, dp]``, ``wif [dp, 2·H]``, ``down [dp, d]``."""

    COMPUTES_ON_SHARDS = False      # its leaves are gathered whole

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        dp, h, _ = _mlstm_dims(cfg)
        dt = dtype_of(cfg.param_dtype)
        gen = generator
        self.ln = _ones(cfg, gen)
        self.up = _param(_init_dense(gen, d, 2 * dp, dt))
        self.wq = _param(_init_dense(gen, dp, dp, dt))
        self.wk = _param(_init_dense(gen, dp, dp, dt))
        self.wv = _param(_init_dense(gen, dp, dp, dt))
        self.wif = _param(_init_dense(gen, dp, 2 * h, dt))
        self.down = _param(_init_dense(gen, dp, d, dt))

    def param_specs(self) -> Dict[str, P]:
        dp, _, _ = _mlstm_dims(self.cfg)
        return dict(ln=P(None), up=P(None, mdl(2 * dp)), wq=P(None, mdl(dp)),
                    wk=P(None, mdl(dp)), wv=P(None, mdl(dp)),
                    wif=P(None, None), down=P(mdl(dp), None))

    def _qkv_gates(self, x, shape):
        dp, h, _ = _mlstm_dims(self.cfg)
        up = rms_norm(x, self.ln) @ self.up
        xm, z = up[..., :dp], up[..., dp:]
        q = (xm @ self.wq).reshape(shape)
        k = (xm @ self.wk).reshape(shape)
        v = (xm @ self.wv).reshape(shape)
        gates = xm @ self.wif
        return q, k, v, gates[..., :h], gates[..., h:], z

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False):
        """x: [B,S,d] with S a multiple of ``cfg.ssm_chunk`` ->
        ``(x, 0)``."""
        b, s, _ = x.shape
        dp, h, hd = _mlstm_dims(self.cfg)
        q, k, v, ig, fg, z = self._qkv_gates(x, (b, s, h, hd))
        y, _ = ssm_lib.mlstm_chunked(q, k, v, ig, fg, self.cfg.ssm_chunk)
        y = y.to(x.dtype).reshape(b, s, dp) * F.silu(z)
        return x + y @ self.down, _no_aux(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """``c [B·H,1,hd,hd]`` and ``n [B·H,1,1,hd]``, zero, in the compute
        dtype; :meth:`decode` replaces them with fp32 tensors."""
        dp, h, hd = _mlstm_dims(self.cfg)
        c, n = ssm_lib.mlstm_init_state(
            batch, h, hd, dtype_of(self.cfg.compute_dtype), self.ln.device)
        return dict(c=c, n=n)

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d].  The state comes back in fp32 from the first step
        on (the reference's ``mlstm_decode_step`` promotes it), so the
        cache's ``c`` / ``n`` are replaced, not written into."""
        b = x_t.shape[0]
        dp, h, hd = _mlstm_dims(self.cfg)
        q, k, v, ig, fg, z = self._qkv_gates(x_t[:, 0], (b, h, hd))
        y, (c2, n2) = ssm_lib.mlstm_decode_step((cache["c"], cache["n"]),
                                                q, k, v, ig, fg)
        cache["c"], cache["n"] = c2, n2
        y = y.to(x_t.dtype).reshape(b, 1, dp) * F.silu(z[:, None])
        return x_t + y @ self.down


# =========================================================== slstm block


class SlstmBlock(nn.Module):
    """xLSTM scalar-LSTM block: pre-RMSNorm, ``wx`` to the z/i/f/o
    pre-activations, the per-token sLSTM loop with block-diagonal
    recurrent weights ``r`` (:func:`ssm.slstm_scan`), ``out``, with a
    residual.  ``ln [d]``, ``wx [d, 4·d]``, ``r [4, H, hd, hd]`` (std
    0.3/√hd), ``out [d, d]``."""

    COMPUTES_ON_SHARDS = False      # its leaves are gathered whole

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        dt = dtype_of(cfg.param_dtype)
        gen = generator
        self.ln = _ones(cfg, gen)
        self.wx = _param(_init_dense(gen, d, 4 * d, dt))
        self.r = _randn(gen, (4, h, hd, hd), 0.3 / math.sqrt(hd), dt)
        self.out = _param(_init_dense(gen, d, d, dt))

    def param_specs(self) -> Dict[str, P]:
        d = self.cfg.d_model
        return dict(ln=P(None), wx=P(None, mdl(4 * d)),
                    r=P(None, None, None, mdl(d // self.cfg.n_heads)),
                    out=P(None, mdl(d)))

    def _parts(self, x):
        b, s, d = x.shape
        h = self.cfg.n_heads
        return (rms_norm(x, self.ln) @ self.wx).reshape(b, s, 4, h, d // h)

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False):
        """x: [B,S,d] -> ``(x, 0)``."""
        b, s, d = x.shape
        ys, _ = ssm_lib.slstm_scan(self._parts(x), self.r)
        return x + ys.to(x.dtype).reshape(b, s, d) @ self.out, _no_aux(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """The fp32 state ``c``, ``n``, ``h``, ``m`` [B,H,hd] at its start
        (n = 1e-6, m = -10)."""
        h = self.cfg.n_heads
        z = torch.zeros((batch, h, self.cfg.d_model // h),
                        dtype=torch.float32, device=self.ln.device)
        return dict(c=z, n=z + 1e-6, h=z, m=z - 10.0)

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        b, _, d = x_t.shape
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
        ys, (c, n, hh, m) = ssm_lib.slstm_scan(self._parts(x_t), self.r,
                                               state)
        cache.update(c=c, n=n, h=hh, m=m)
        return x_t + ys.to(x_t.dtype).reshape(b, 1, d) @ self.out
