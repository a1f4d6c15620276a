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
whole and sliced, so the draws are the world of one's.  Every block then
computes on its shards, Megatron's way: each rank computes the heads
:func:`heads_split` gives it (an uneven split: ``⌊h/m⌋`` or ``⌈h/m⌉``,
none where ``h < m``) — the attention's query heads and the K/V heads
they read, Mamba-2's SSD heads, the sLSTM's heads, or, where
:func:`slstm_split` counts it cheaper (a decode step), the sLSTM's
``hd`` output channels of every head, ``h`` exchanged at every step;
the mLSTM's heads,
or where they are fewer than the ranks one head's share of value
channels (:func:`value_split`) — and the hidden units of its slice of
the MLP; the products into them are
column-parallel behind one :func:`sharding.copy_to_model`, those out of
them (``wo``, ``out_proj``, ``down``, ``out``, ``w2``) row-parallel with
one :func:`sharding.reduce_from_model` after each.  The experts run
expert-parallel (``moe.moe_ffn(expert_parallel=True)``), each on the
rank's slice of its hidden width over "data" where the model is built
with ``dp=(rank, D)``.  Storage stays the specs' share; a leaf whose
stored slice is not the part its heads read (an uneven split, K/V heads
that do not split, a packed projection such as ``in_proj``'s
``[z | x | B C | dt]`` or ``wx``'s four gates) exchanges over "model",
at each use, whichever of two things moves fewer bytes
(:func:`heads_form`, from the shapes alone): the leaf, gathered whole and
cut to that part (its gradient reduce-scattered back), or the product,
computed on the stored slice and gathered (:meth:`_Heads.product`).
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Tuple

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


def heads_split(n: int, m: int, rank: int) -> Tuple[int, int]:
    """The heads ``[lo, hi)`` of ``n`` that rank ``rank`` of a "model"
    group of ``m`` computes: ``[⌊n·rank/m⌋, ⌊n·(rank+1)/m⌋)``, an uneven
    split with no padding.  Every rank computes ``⌊n/m⌋`` or ``⌈n/m⌉``
    heads, the last rank ``⌈n/m⌉``; where ``n < m`` some ranks compute
    none (2 heads over 4 ranks, xlstm's 4 over 16), and their share of
    each row-parallel sum is zeros."""
    return n * rank // m, n * (rank + 1) // m


def value_split(h: int, hd: int, m: int,
                rank: int) -> Tuple[int, int, int, int]:
    """The mLSTM's part that rank ``rank`` of a "model" group of ``m``
    computes: the heads ``[head_lo, head_hi)`` and, of each, the value
    channels ``[ch_lo, ch_hi)`` of ``hd``.  Where ``h ≥ m``,
    :func:`heads_split`'s heads and every channel.  Where ``h < m``
    every rank computes one head, ``j = ⌊rank·h/m⌋``, which the ranks
    ``[⌈j·m/h⌉, ⌈(j+1)·m/h⌉)`` share; the i-th of those ``g`` ranks
    computes the channels ``heads_split(hd, g, i)``.  Groups differ in
    size where ``h`` does not divide ``m`` (2 heads over 3 ranks: groups
    of 2 and 1).

    ``C = f·C + i·v kᵀ`` and ``y = C q / max(|n·q|, 1)`` are independent
    per value channel, so a rank needs its head's q, k, gates and
    normalizer whole and its own channels of v, z and ``down``'s rows,
    and no collective inside the recurrence.  At xlstm's 4 heads of 512
    over 16 ranks rank r computes head ⌊r/4⌋, channels
    ``[(r%4)·128, +128)``: the columns ``[r·128, +128)`` of ``wv [dp,
    dp]`` and the same rows of ``down [dp, d]``, which is the slice of
    dp / 16 = 128 that each one's spec stores on rank r, so neither is
    exchanged."""
    if h >= m:
        return (*heads_split(h, m, rank), 0, hd)
    j = rank * h // m
    first = -(-j * m // h)
    g = -(-(j + 1) * m // h) - first
    return (j, j + 1, *heads_split(hd, g, rank - first))


def _build_heads(n: int) -> Tuple[int, int]:
    """:func:`heads_split` of the model being built."""
    return heads_split(n, sharding.build_size(), sharding.build_rank())


Pieces = List[Tuple[int, int]]


def _head_rows(n: int, unit: int) -> Pieces:
    """Every rank's :func:`heads_split` of ``n`` heads of ``unit``
    elements, in rank order, in the model being built: a row leaf's
    ``rows`` (:meth:`_Heads._leaf`)."""
    m = sharding.build_size()
    return [_spans(*heads_split(n, m, j), unit)[0] for j in range(m)]


def _spans(lo: int, hi: int, width: int, *starts: int) -> Pieces:
    """Heads ``[lo, hi)`` of ``width`` elements each, at each of
    ``starts`` (default 0): ``[(start + lo·width, (hi - lo)·width),
    ...]``."""
    return [(s + lo * width, (hi - lo) * width) for s in starts or (0,)]


def _value_spans(split: Tuple[int, int, int, int], hd: int,
                 *starts: int) -> Pieces:
    """The value channels of :func:`value_split`'s ``split`` (heads of
    ``hd``) at each of ``starts``: its heads whole where it has every
    channel, else its one head's channels."""
    lo, hi, clo, chi = split
    if (clo, chi) == (0, hd):
        return _spans(lo, hi, hd, *starts)
    return [(s + lo * hd + clo, chi - clo) for s in starts or (0,)]


def _stored_as_used(shape, spec: Optional[P], dim: int,
                    pieces: Pieces) -> bool:
    """Whether the rank being built stores exactly ``pieces`` (``(start,
    length)`` along dimension ``dim`` of the whole leaf of ``shape``):
    one rank, or the spec's slice is the rank's heads."""
    m, rank = sharding.build_size(), sharding.build_rank()
    if m == 1:
        return True
    sd = model_dim(spec)
    return sd == dim and pieces == [(rank * shape[sd] // m, shape[sd] // m)]


def _add_cut(cuts: Dict[str, tuple], name: str, shape, spec: Optional[P],
             dim: int, pieces: Optional[Pieces],
             rows: Optional[Pieces] = None) -> None:
    """Enter in ``cuts`` the leaf ``name`` of whole ``shape`` (stored as
    ``spec`` gives) where the rank being built uses ``pieces`` of it
    along ``dim`` that it does not store (:meth:`_Heads._leaf`)."""
    if pieces is not None and not _stored_as_used(shape, spec, dim, pieces):
        cuts[name] = (model_dim(spec), dim, pieces, rows)


#: the two things a gathered leaf's use can exchange over "model"
FORMS = ("weights", "activations")
#: the uses of a leaf whose stored slice is not its part, by the form
#: each took (a leaf gathered whole: ``"weights"``), and the bytes each
#: form's uses gathered forward (:func:`heads_form_bytes`' forward count)
heads_forms: collections.Counter = collections.Counter()
heads_moved: collections.Counter = collections.Counter()


def heads_form_bytes(rows: int, d_in: int, width: int, m: int,
                     act_bytes: int, w_bytes: int,
                     share: Optional[int] = None) -> Dict[str, int]:
    """The bytes one forward product of a leaf ``[d_in, width]`` stored in
    ``m`` slices over "model" gathers in each form, counted as
    :data:`sharding.stats` counts them (each collective's operand), for a
    rank of ``rows`` rows (``act_bytes`` / ``w_bytes``: an activation's
    and a weight's element size):

    * ``"weights"``: the rank's slice gathered (``d_in·width/m``);
    * ``"activations"``: the rank's ``share`` of each row gathered
      (``rows·share``; a column leaf's product columns, ``width/m`` by
      default; a row leaf's head outputs, padded to the largest rank's:
      ``⌈h/m⌉`` heads, or the mLSTM's widest channel part).

    The forward alone decides: under autograd each form's backward
    reduce-scatters ``m`` times its forward's operand (the leaf's
    gradient, or the whole product's), and a remat's recompute runs the
    forward's gather again, so both multiply the two forms' bytes alike."""
    share = width // m if share is None else share
    return dict(weights=d_in * width // m * w_bytes,
                activations=rows * share * act_bytes)


def heads_form(*args) -> str:
    """The form of :func:`heads_form_bytes` (same arguments) that moves
    fewer bytes, ``"weights"`` on a tie.  It reads shapes only, so every
    rank of the "model" group takes the same form with no collective.

    A column leaf (gathered and cut along its last dimension: ``wq`` /
    ``wk`` / ``wv``, ``in_proj``, ``up``, ``wx``) and a row leaf (cut
    along its first, the rows its heads' outputs multiply: ``wo``,
    ``down``, ``out_proj``, and the sLSTM's ``out``, which is stored on
    its output columns) have the activations form.  The sLSTM's ``r``,
    stored on ``hd`` and cut on heads, has no product to exchange
    outside its token loop: :func:`slstm_split` chooses between
    gathering it (the heads split) and the reference's split of every
    head's channels, which exchanges ``h`` at every step.  A leaf stored
    whole (``conv_w``, ``wif``, the norms) is not gathered at all: it is
    cut as it is."""
    b = heads_form_bytes(*args)
    return "activations" if b["activations"] < b["weights"] else "weights"


#: the collectives over "model" of one sLSTM call in the heads split
#: (``r`` gathered, ``wx``'s and ``out``'s exchanges)
SLSTM_HEADS_COLLECTIVES = 3


def slstm_split_bytes(rows: int, steps: int, d: int, h: int, m: int,
                      act_bytes: int, w_bytes: int) -> Dict[str, int]:
    """The "model" bytes one sLSTM call of ``steps`` tokens on ``rows``
    rows a rank gathers forward in each split, counted as
    :func:`heads_form_bytes` counts them, for ``d`` channels in ``h``
    heads of ``hd = d/h`` over ``m`` ranks, the specs storing ``wx``
    and ``out`` on their output columns and ``r [4, h, hd, hd]`` on its
    ``hd`` output axis (``act_bytes`` / ``w_bytes``: the activations'
    and the weights' element size):

    * ``"heads"``: the rank's slice of ``r`` gathered,
      ``4·h·hd·(hd/m)·w_bytes``, and ``wx``'s and ``out``'s exchanges in
      the form :func:`heads_form` takes for each;
    * ``"channels"``: every step's ``h`` gathered from the ranks' fp32
      channels, ``steps·rows·h·⌈hd/m⌉·4``, and ``wx``'s exchange;
      ``out`` takes the whole ``h`` and exchanges nothing."""
    hd = d // h
    n = rows * steps
    wx = min(heads_form_bytes(n, d, 4 * d, m, act_bytes, w_bytes).values())
    out = min(heads_form_bytes(n, d, d, m, act_bytes, w_bytes,
                               -(-h // m) * hd).values())
    return dict(heads=4 * h * hd * (hd // m) * w_bytes + wx + out,
                channels=steps * rows * h * -(-hd // m) * 4 + wx)


def slstm_split(*args) -> str:
    """The channels split where it moves fewer bytes than the heads split
    (:func:`slstm_split_bytes`, same arguments) in no more collectives,
    else ``"heads"``.  A call of S steps issues S + 1 collectives over
    "model" in the channels split (``h`` at every step, one after
    another in the token loop, and ``wx``'s exchange), 3 in the heads
    split (``r``, ``wx``, ``out``): bytes alone would trade one gather
    for a chain of S, whose latency they do not count.  It reads shapes
    only, so every rank of the "model" group takes the same split with
    no collective.  At xlstm's 4 heads of 256 over 16 ranks, bf16
    weights, a decode step (8 rows or 1) takes the channels split
    (2,048 B of ``h`` a layer at 8 rows, against 131,072 of ``r``), a
    ``train_4k`` or ``prefill_32k`` call (65,536 rows·steps) the heads
    split (16.8 MB of ``h``, in 4,096 or 32,768 collectives)."""
    b = slstm_split_bytes(*args)
    fewer = args[1] + 1 <= SLSTM_HEADS_COLLECTIVES
    return "channels" if fewer and b["channels"] < b["heads"] else "heads"


class _Heads(nn.Module):
    """A module whose leaves each rank of the "model" group cuts, at use,
    to the parts that the heads it computes read (:meth:`part`,
    :meth:`product`).  Storage is the specs' share
    (:func:`sharding.keep_shard`); a leaf stored whole is cut as it is
    (its gradient all-reduced), and at each use of a leaf whose stored
    slice is not its part :func:`heads_form` picks, from the shapes, what
    goes over "model": the leaf gathered whole and cut (its gradient
    reduce-scattered back: the sum of the ranks' partial ones), or the
    product of the stored slice (:meth:`product`).  ``form``: that
    choice forced, for tests."""

    def __init__(self):
        super().__init__()
        # name -> (the dimension it is gathered along, or None where it
        # is stored whole; the dimension it is cut along; the pieces;
        # a row leaf's every rank's piece, or None)
        self.cuts: Dict[str, tuple] = {}
        self.form: Optional[str] = None

    def _leaf(self, name: str, t: torch.Tensor, spec: P, dim: int = 0,
              pieces: Optional[Pieces] = None,
              rows: Optional[Pieces] = None) -> None:
        """Keep the whole leaf ``t`` as the rank stores it; at use it is
        ``pieces`` along ``dim`` (``None``: whole on every rank, as a
        norm's weight); ``rows``: of a row leaf the rank's heads read
        row-parallel, every rank's one piece along ``dim``, in rank
        order, which together are the whole dimension in order."""
        _add_cut(self.cuts, name, t.shape, spec, dim, pieces, rows)
        setattr(self, name, _param(t, spec))

    @property
    def gather_leaves(self) -> Tuple[str, ...]:
        """The leaves whose stored slice is not their part: at use, each
        is gathered whole over "model", or its product is exchanged."""
        return tuple(n for n, c in self.cuts.items() if c[0] is not None)

    def part(self, name: str, cuts: Optional[Dict[str, tuple]] = None
             ) -> torch.Tensor:
        """The leaf ``name``'s pieces this rank computes with,
        concatenated in order along their dimension; ``cuts``: another
        table of pieces than :attr:`cuts` (a second split of the
        block's work)."""
        cuts = self.cuts if cuts is None else cuts
        w = getattr(self, name)
        if name not in cuts:
            return w
        gdim, dim, pieces, _ = cuts[name]
        if gdim is None:
            w = sharding.copy_to_model(w)
        else:
            if sharding.model_size() > 1:
                heads_forms["weights"] += 1
                heads_moved["weights"] += w.numel() * w.element_size()
            w = sharding.gather_from_model(
                w, gdim, getattr(w, "leaf_name", name), partial_grad=True)
        return _cut(w, dim, pieces)

    def product(self, name: str, x: torch.Tensor,
                cuts: Optional[Dict[str, tuple]] = None) -> torch.Tensor:
        """``x @ part(name, cuts)``: the product of ``x`` [..., k] with the
        leaf ``name``'s part on the rank's heads.  Where the leaf is gathered
        over "model", in the form :func:`heads_form` takes (:attr:`form`
        where it is set):

        * ``"weights"``: the leaf gathered whole and cut (:meth:`part`);
        * ``"activations"``, a column leaf: ``x`` times the stored
          slice, the product's columns gathered (their gradients
          reduce-scattered back) and cut to the rank's pieces; a row
          leaf: every rank's head outputs ``x`` (padded to the largest
          rank's, for an equal-size gather) gathered into the whole
          ``[..., W]``, and its stored rows' columns times the stored
          slice (stored on its output columns, as the sLSTM's ``out``:
          the whole times the slice, placed at the slice's columns among
          zeros), which the caller's :func:`sharding.reduce_from_model`
          sums as before.  A rank with no head computes on its stored
          slice all the same, so every collective runs on every rank."""
        cut = (self.cuts if cuts is None else cuts).get(name)
        if cut is None or cut[0] is None or sharding.model_size() == 1:
            return x @ self.part(name, cuts)
        gdim, dim, pieces, rows = cut
        w = getattr(self, name)
        m = sharding.model_size()
        column = gdim == dim == w.ndim - 1
        row = dim == 0 and rows is not None
        if not (column or row):
            return x @ self.part(name, cuts)
        whole = list(w.shape)
        whole[gdim] *= m
        share = max(n for _, n in rows) if row else None
        args = (math.prod(x.shape[:-1]), *whole, m, x.element_size(),
                w.element_size(), share)
        form = self.form or heads_form(*args)
        if form == "weights":
            return x @ self.part(name, cuts)
        heads_forms[form] += 1
        heads_moved[form] += heads_form_bytes(*args)[form]
        if column:
            return _cut(sharding.gather_from_model(x @ w, -1,
                                                   partial_grad=True),
                        -1, pieces)
        if x.shape[-1] < share:
            x = F.pad(x, (0, share - x.shape[-1]))
        o = sharding.gather_from_model(x, -1, partial_grad=True)
        o = _cut(o, -1, [(j * share, n) for j, (_, n) in enumerate(rows)])
        r, n = sharding.model_rank(), w.shape[gdim]
        if gdim == 0:                   # its stored rows
            return o.narrow(-1, r * n, n) @ w
        # stored on its output columns: the rank's columns of the whole
        # product, in place among zeros for the caller's sum
        return F.pad(o @ w, (r * n, (m - 1 - r) * n))


def force_heads_form(module: nn.Module, form: Optional[str]) -> None:
    """Force every :class:`_Heads` in ``module`` into ``form`` (one of
    :data:`FORMS`; ``None``: the rule), for tests."""
    if form is not None and form not in FORMS:
        raise ValueError(f"unknown heads form {form!r}: one of {FORMS}")
    for mod in module.modules():
        if isinstance(mod, _Heads):
            mod.form = form


def _cut(w: torch.Tensor, dim: int, pieces: Pieces) -> torch.Tensor:
    """``pieces`` of ``w`` along ``dim``, concatenated in order."""
    parts = [w.narrow(dim, a, n) for a, n in pieces]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


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


class _AttnParams(_Heads):
    """``wq [d, H*hd]``, ``wk`` / ``wv [d, KV*hd]``, ``wo [H*hd, d]`` (the
    reference's ``_attn_params``), or the rank's slices of them.  The
    rank computes the query heads ``heads = [lo, hi)`` of
    :func:`heads_split` and the K/V heads ``kv = [klo, khi)`` they read:
    ``wq`` / ``wk`` / ``wv`` column-parallel on those heads, ``wo``
    row-parallel on its query heads' rows (``tp``; :meth:`_Heads.product`).
    ``kv_counts``: how many of its query heads read each of its K/V
    heads, in order; unequal where its query heads straddle two K/V
    groups, and the K/V heads are then repeated to the query heads before
    the attention (:func:`_attend`)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        sp = _attn_leaf_specs(cfg)
        lo, hi = self.heads = _build_heads(h)
        rep = h // kv
        klo = lo // rep
        self.kv = (klo, (hi - 1) // rep + 1 if hi > lo else klo)
        self.kv_counts = tuple(sum(1 for j in range(lo, hi) if j // rep == g)
                               for g in range(*self.kv))
        self._leaf("wq", _init_dense(gen, d, h * hd, dt), sp["wq"], 1,
                   _spans(lo, hi, hd))
        for n in ("wk", "wv"):
            self._leaf(n, _init_dense(gen, d, kv * hd, dt), sp[n], 1,
                       _spans(*self.kv, hd))
        self._leaf("wo", _init_dense(gen, h * hd, d, dt), sp["wo"], 0,
                   _spans(lo, hi, hd), _head_rows(h, hd))
        self.tp = sharding.build_size() > 1

    def kv_heads(self) -> int:
        """The K/V heads this rank computes (its cache's)."""
        return self.kv[1] - self.kv[0]


def _attend(p: _AttnParams, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, fn) -> torch.Tensor:
    """``fn(q, k, v)`` on the rank's heads, q [B,Sq,nq,hd] and k / v
    [B,Sk,nkv,hd], k / v repeated to q's heads where its K/V heads are
    read by unequal numbers of them.  A rank with no head computes
    nothing: q itself, with k and v kept in the graph, so that the
    collectives of their backward run on every rank."""
    if not p.kv_counts:
        return q + (k.sum() + v.sum()).to(q.dtype)
    if len(set(p.kv_counts)) > 1:
        k, v = (torch.cat([t.narrow(2, g, 1).expand(-1, -1, c, -1)
                           for g, c in enumerate(p.kv_counts)], dim=2)
                for t in (k, v))
    return fn(q, k, v)


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


def _heads_of(cfg: ModelConfig, x: torch.Tensor, p: _AttnParams,
              name: str) -> torch.Tensor:
    """``x`` [B,S,d] times ``p``'s part of ``name`` [d, n·hd] as n heads,
    [B,S,n,hd]."""
    y = p.product(name, x)
    return y.reshape(*x.shape[:2], y.shape[-1] // cfg.hd, cfg.hd)


def _qkv(cfg: ModelConfig, p: "_AttnParams", x: torch.Tensor,
         positions: Optional[torch.Tensor] = None,
         x_kv: Optional[torch.Tensor] = None):
    """q from ``x``, k/v from ``x_kv`` (default ``x``), on the rank's
    heads (``p``'s parts of ``wq`` / ``wk`` / ``wv``); RoPE at
    ``positions`` when they are given (self-attention only), M-RoPE for
    ``cfg.m_rope``."""
    xk = x if x_kv is None else x_kv
    q = _heads_of(cfg, x, p, "wq")
    k, v = (_heads_of(cfg, xk, p, n) for n in ("wk", "wv"))
    if positions is not None:
        rope = apply_m_rope if cfg.m_rope else apply_rope
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_heads(cfg: ModelConfig, p: _AttnParams, x: torch.Tensor,
                off: int, force_chunked: bool, causal: bool = True,
                window: Optional[int] = None) -> torch.Tensor:
    """``x`` [B,S,d] (normed) -> the attention's output on the rank's
    query heads [B,S,nq·hd], with RoPE at positions ``off``..``off+S-1``
    (before ``wo``)."""
    positions = off + torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(cfg, p, _column(x, p.tp), positions)
    return _attend(p, q, k, v, lambda q, k, v: attn_lib.attention(
        q, k, v, causal=causal, window=window, q_offset=off,
        chunk=cfg.attention_chunk, force_chunked=force_chunked)).flatten(2)


def _self_attention(cfg: ModelConfig, p: _AttnParams, x: torch.Tensor,
                    off: int, force_chunked: bool, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """``x`` [B,S,d] (normed) -> the attention's output projected by
    ``wo`` (row-parallel: summed over "model")."""
    o = _attn_heads(cfg, p, x, off, force_chunked, causal, window)
    return _row(p.product("wo", o), p.tp)


def _self_decode(cfg: ModelConfig, p: _AttnParams,
                 cache: Dict[str, torch.Tensor], x: torch.Tensor, pos: int,
                 window: Optional[int] = None) -> torch.Tensor:
    """One token ``x`` [B,1,d] (normed) against the K/V cache, its own
    K/V written at ``pos`` first; returns the output projected by
    ``wo``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, _column(x, p.tp), positions)
    kc, vc = attn_lib.update_cache(cache["k"], cache["v"], k, v, pos)
    o = _attend(p, q, kc, vc, lambda q, k, v: attn_lib.decode_attention(
        q, k, v, pos + 1, window=window))
    return _row(p.product("wo", o.flatten(2)), p.tp)


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

    def head_outputs(self, x: torch.Tensor) -> torch.Tensor:
        """The self-attention's output on the rank's query heads
        [B,S,nq·hd] before ``wo`` (causal, from position 0)."""
        return _attn_heads(self.cfg, self.attn, rms_norm(x, self.ln1), 0,
                           False, True, self.window)

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
            xa = self.xattn
            q, k, v = _qkv(self.cfg, xa, _column(rms_norm(x, self.lnx), xa.tp),
                           x_kv=_column(enc_out, xa.tp))
            o = _attend(xa, q, k, v, lambda q, k, v: attn_lib.attention(
                q, k, v, causal=False, chunk=0, force_chunked=force_chunked))
            x = x + _row(xa.product("wo", o.flatten(2)), xa.tp)
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
        xc = _column(enc_out, self.xattn.tp)
        k, v = (_heads_of(self.cfg, xc, self.xattn, n) for n in ("wk", "wv"))
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
            xa = self.xattn
            q = _heads_of(self.cfg, _column(rms_norm(x_t, self.lnx), xa.tp),
                          xa, "wq")
            o = _attend(xa, q, cache["xk"], cache["xv"],
                        lambda q, k, v: attn_lib.decode_attention(
                            q, k, v, k.shape[1]))
            x_t = x_t + _row(xa.product("wo", o.flatten(2)), xa.tp)
        return x_t + _mlp(rms_norm(x_t, self.ln2), self.mlp)


def _kv_cache(cfg: ModelConfig, kv_heads: int, batch: int, max_len: int,
              device) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, kv_heads, cfg.hd)
    kw = dict(dtype=dtype_of(cfg.compute_dtype), device=device)
    return dict(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw))


# =========================================================== moe block


def _moe_leaf_specs(cfg: ModelConfig) -> Dict[str, P]:
    """The reference's ``build_moe`` specs of the experts: over "model",
    their hidden width over "data" (which ``Model(cfg, dp=...)`` splits
    and computes on: ``_MoeParams``, ``moe._dispatch``)."""
    e = mdl(cfg.n_experts)
    return dict(wg=P(None, e), w1=P(e, None, "data"), w3=P(e, None, "data"),
                w2=P(e, "data", None))


class _MoeParams(nn.Module):
    """The router ``wg [d, E]`` and the experts' ``w1`` / ``w3 [E, d,
    d_ff]``, ``w2 [E, d_ff, d]`` (``moe.moe_params_shape``), each drawn
    in fp32 with std ``1/sqrt(shape[-2])`` (``wg``: ``1/sqrt(d)``) and
    cast, the experts one at a time: a whole ``w1`` of arctic drawn at
    once would be a 17.8 GB fp32 temporary.  ``tp``: the experts are
    sharded over "model" and only the rank's are kept; ``width``: under
    ``Model(cfg, dp=(rank, D))`` each kept expert keeps only the rank's
    ``d_ff / D`` slice of its hidden width (``w1`` / ``w3 [E/m, d,
    d_ff/D]``, ``w2 [E/m, d_ff/D, d]``).  Every expert is still drawn
    whole, in order, so the draws are the world of one's and the ranks'
    slices concatenate to its leaves bit for bit."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        specs = _moe_leaf_specs(cfg)
        self.tp = sharding.build_size() > 1 and \
            model_dim(specs["w1"]) is not None
        wrank, width = sharding.build_width()
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
            # the hidden width's dimension within one expert's [.., ..]
            fdim = sharding.data_dim(specs[name]) - 1
            kept = list(shape[1:])
            kept[fdim] //= width
            w = torch.empty((n, *kept), dtype=dt, device=gen.device)
            for e in range(shape[0] if gen.device.type != "meta" else 0):
                we = _draw(gen, shape[1:], 1.0 / math.sqrt(shape[-2]), dt)
                if lo <= e < lo + n:
                    w[e - lo] = sharding.shard_of(we, fdim, wrank, width)
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
        kw = dict(expert_parallel=self.moe.tp, remat=cfg.remat != "none")
        if grouped:
            y, aux = moe_lib.moe_ffn_grouped(h, w, cfg.top_k,
                                             cfg.capacity_factor,
                                             cfg.moe_n_groups, **kw)
        else:
            y, aux = moe_lib.moe_ffn(h, w, cfg.top_k, cfg.capacity_factor,
                                     **kw)
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


class Mamba2Block(_Heads):
    """Mamba-2: pre-RMSNorm, ``in_proj`` to (z, xBC, dt), a width-4
    causal conv and SiLU on xBC, SSD over ``nh`` heads of 64 with one
    B/C group, the ``d_skip`` term, a SiLU(z) gate and ``out_proj``, with
    a residual.  ``ln [d]``, ``in_proj [d, 2·d_in + 2·N + nh]``, ``conv_w
    [4, d_in + 2·N]``, ``out_proj [d_in, d]``; ``a_log``, ``d_skip``,
    ``dt_bias [nh]`` fp32.

    A rank computes its heads ``heads = [lo, hi)`` of :func:`heads_split`:
    ``z``, ``x`` and ``dt`` on them and ``B`` / ``C`` whole (``in_proj``'s
    part is its ``[z | x | B C | dt]`` columns), the conv on its ``x``
    channels and the whole ``B`` / ``C`` ones, the SSD on its heads, and
    ``out_proj`` row-parallel on its heads' rows."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, hdim, nh, n, conv_dim = _mamba_dims(cfg)
        dt = dtype_of(cfg.param_dtype)
        gen = generator
        f32 = dict(dtype=torch.float32, device=gen.device)
        sp = self.param_specs()
        lo, hi = self.heads = _build_heads(nh)
        self.tp = sharding.build_size() > 1
        self.ln = _ones(cfg, gen)
        self._leaf("in_proj", _init_dense(gen, d, 2 * d_in + 2 * n + nh, dt),
                   sp["in_proj"], 1,
                   _spans(lo, hi, hdim, 0, d_in) + [(2 * d_in, 2 * n)] +
                   _spans(lo, hi, 1, 2 * d_in + 2 * n))
        self._leaf("conv_w", _draw(gen, (4, conv_dim), 0.2, dt), sp["conv_w"],
                   1, _spans(lo, hi, hdim) + [(d_in, 2 * n)])
        for name, fill in (("a_log", 0.0), ("d_skip", 1.0), ("dt_bias", 0.0)):
            self._leaf(name, torch.full((nh,), fill, **f32), sp[name], 0,
                       _spans(lo, hi, 1))
        self._leaf("out_proj", _init_dense(gen, d_in, d, dt), sp["out_proj"],
                   0, _spans(lo, hi, hdim), _head_rows(nh, hdim))

    def param_specs(self) -> Dict[str, P]:
        d_in, _, nh, n, _ = _mamba_dims(self.cfg)
        return dict(ln=P(None), in_proj=P(None, mdl(2 * d_in + 2 * n + nh)),
                    conv_w=P(None, None), a_log=P(None), d_skip=P(None),
                    dt_bias=P(None), out_proj=P(mdl(d_in), None))

    def _heads_in(self, x, conv_state=None):
        """The rank's heads' SSD inputs from ``x`` [B,S,d]: ``xs``
        [B,S,nl,64], ``bmat`` / ``cmat`` [B,S,N], ``dt`` [B,S,nl] fp32,
        ``z`` [B,S,nl·64], the conv's next state, ``a_log`` / ``d_skip``
        of its heads."""
        _, hdim, _, n, _ = _mamba_dims(self.cfg)
        nl = self.heads[1] - self.heads[0]
        zxbcdt = self.product("in_proj", _column(rms_norm(x, self.ln), self.tp))
        z = zxbcdt[..., :nl * hdim]
        xbc, conv_state = _causal_conv(
            zxbcdt[..., nl * hdim:2 * nl * hdim + 2 * n], self.part("conv_w"),
            conv_state)
        xbc = F.silu(xbc)
        xs = xbc[..., :nl * hdim].reshape(*x.shape[:2], nl, hdim)
        bmat = xbc[..., nl * hdim:nl * hdim + n]
        cmat = xbc[..., nl * hdim + n:]
        dt = F.softplus(zxbcdt[..., 2 * nl * hdim + 2 * n:].float() +
                        self.part("dt_bias"))
        return (xs, bmat, cmat, dt, z, conv_state, self.part("a_log"),
                self.part("d_skip"))

    def _out(self, x, y):
        """``y`` [B,S,nl·64] (gated) through the rank's rows of
        ``out_proj``, summed over "model", added to ``x``."""
        return x + _row(self.product("out_proj", y), self.tp).to(x.dtype)

    def head_outputs(self, x: torch.Tensor) -> torch.Tensor:
        """The SSD's output on the rank's heads with the ``d_skip`` term,
        gated by SiLU(z), [B,S,nl·64] (before ``out_proj``)."""
        xs, bmat, cmat, dt, z, _, a_log, d_skip = self._heads_in(x)
        a = -torch.exp(a_log) * dt                        # [B,S,nl]
        y, _ = ssm_lib.ssd_chunked(xs * dt[..., None].to(xs.dtype), a,
                                   bmat, cmat, self.cfg.ssm_chunk)
        y = y.to(xs.dtype) + xs * d_skip[:, None].to(xs.dtype)
        return y.flatten(2) * F.silu(z)

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False):
        """x: [B,S,d] with S a multiple of ``cfg.ssm_chunk`` ->
        ``(x, 0)``."""
        return self._out(x, self.head_outputs(x)), _no_aux(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """The conv's last 3 inputs [B,3,C] of the rank's channels (its
        heads' ``x`` and the whole ``B`` / ``C``) and the SSD state
        [B,nl,64,N] of its heads, zero, in the compute dtype."""
        _, hdim, _, n, _ = _mamba_dims(self.cfg)
        nl = self.heads[1] - self.heads[0]
        kw = dict(dtype=dtype_of(self.cfg.compute_dtype),
                  device=self.ln.device)
        return dict(conv=torch.zeros((batch, 3, nl * hdim + 2 * n), **kw),
                    ssm=torch.zeros((batch, nl, hdim, n), **kw))

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d]; the state advances in fp32 and is stored back in
        the cache's dtype, as in the reference."""
        xs, bmat, cmat, dt, z, conv_state, a_log, d_skip = self._heads_in(
            x_t, cache["conv"])
        xs, bmat, cmat, dt = xs[:, 0], bmat[:, 0], cmat[:, 0], dt[:, 0]
        a = -torch.exp(a_log) * dt                        # [B,nl]
        y, ssm = ssm_lib.ssd_decode_step(
            cache["ssm"].float(), (xs * dt[..., None].to(xs.dtype)).float(),
            a, bmat.float(), cmat.float())
        y = y.to(xs.dtype) + xs * d_skip[:, None].to(xs.dtype)
        cache["conv"] = conv_state.to(cache["conv"].dtype)
        cache["ssm"] = ssm.to(cache["ssm"].dtype)
        return self._out(x_t, y[:, None].flatten(2) * F.silu(z))


# =========================================================== mlstm block


def _mlstm_dims(cfg: ModelConfig):
    dp = int(cfg.d_model * cfg.mlstm_proj_factor)
    h = cfg.n_heads
    return dp, h, dp // h


class MlstmBlock(_Heads):
    """xLSTM matrix-LSTM block: pre-RMSNorm, ``up`` to (x, z) of width
    dp = ``mlstm_proj_factor``·d, q/k/v and the i/f gates from x, the
    chunkwise mLSTM (:func:`ssm.mlstm_chunked`), a SiLU(z) gate and
    ``down``, with a residual.  ``ln [d]``, ``up [d, 2·dp]``, ``wq`` /
    ``wk`` / ``wv [dp, dp]``, ``wif [dp, 2·H]``, ``down [dp, d]``.

    A rank computes the heads ``heads = [lo, hi)`` and their value
    channels ``channels = [ch_lo, ch_hi)`` of :func:`value_split` (every
    channel where the heads split over the ranks; where there are fewer
    heads than ranks, the ranks that share a head split its channels):
    x whole (``up``'s first half), its heads' q / k columns and i / f
    gates whole, the v and z columns of its channels, the mLSTM on them
    (the normalizer per head, the same on every rank of a head), and
    ``down`` row-parallel on its channels' rows.  The gradients of q, k,
    the gates and x are then partial on each rank of a head, and the
    reduce-scatter of a gathered leaf, the all-reduce of ``wif``'s and
    of :func:`sharding.copy_to_model` sum them."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        dp, h, hd = _mlstm_dims(cfg)
        dt = dtype_of(cfg.param_dtype)
        gen = generator
        sp = self.param_specs()
        m = sharding.build_size()
        split = value_split(h, hd, m, sharding.build_rank())
        lo, hi = self.heads = split[:2]
        self.channels = split[2:]
        self.tp = m > 1
        self.ln = _ones(cfg, gen)
        self._leaf("up", _init_dense(gen, d, 2 * dp, dt), sp["up"], 1,
                   [(0, dp)] + _value_spans(split, hd, dp))
        for n in ("wq", "wk"):
            self._leaf(n, _init_dense(gen, dp, dp, dt), sp[n], 1,
                       _spans(lo, hi, hd))
        self._leaf("wv", _init_dense(gen, dp, dp, dt), sp["wv"], 1,
                   _value_spans(split, hd))
        self._leaf("wif", _init_dense(gen, dp, 2 * h, dt), sp["wif"], 1,
                   _spans(lo, hi, 1, 0, h))
        self._leaf("down", _init_dense(gen, dp, d, dt), sp["down"], 0,
                   _value_spans(split, hd),
                   [_value_spans(value_split(h, hd, m, j), hd)[0]
                    for j in range(m)])

    def param_specs(self) -> Dict[str, P]:
        dp, _, _ = _mlstm_dims(self.cfg)
        return dict(ln=P(None), up=P(None, mdl(2 * dp)), wq=P(None, mdl(dp)),
                    wk=P(None, mdl(dp)), wv=P(None, mdl(dp)),
                    wif=P(None, None), down=P(mdl(dp), None))

    def _qkv_gates(self, x, lead):
        """q / k [*lead, nl, hd] of the rank's heads, v [*lead, nl, P] of
        their channels, the i / f gates of its heads and z of its
        channels, from ``x``."""
        dp, _, hd = _mlstm_dims(self.cfg)
        nl = self.heads[1] - self.heads[0]
        up = self.product("up", _column(rms_norm(x, self.ln), self.tp))
        xm, z = up[..., :dp], up[..., dp:]
        q, k = (self.product(n, xm).reshape(*lead, nl, hd)
                for n in ("wq", "wk"))
        v = self.product("wv", xm).reshape(*lead, nl, -1)
        gates = xm @ self.part("wif")
        return q, k, v, gates[..., :nl], gates[..., nl:], z

    def _out(self, x, y):
        """``y`` [..., nl·P] (gated) through the rank's rows of ``down``,
        summed over "model", added to ``x``."""
        return x + _row(self.product("down", y), self.tp)

    def head_outputs(self, x: torch.Tensor) -> torch.Tensor:
        """The mLSTM's output on the rank's heads and channels, gated by
        SiLU(z), [B,S,nl·P] (before ``down``)."""
        q, k, v, ig, fg, z = self._qkv_gates(x, x.shape[:2])
        y, _ = ssm_lib.mlstm_chunked(q, k, v, ig, fg, self.cfg.ssm_chunk)
        return y.to(x.dtype).flatten(-2) * F.silu(z)

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False):
        """x: [B,S,d] with S a multiple of ``cfg.ssm_chunk`` ->
        ``(x, 0)``."""
        return self._out(x, self.head_outputs(x)), _no_aux(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """``c [B·nl,1,P,hd]`` and ``n [B·nl,1,1,hd]`` of the rank's
        heads and channels, zero, in the compute dtype; :meth:`decode`
        replaces them with fp32 tensors."""
        _, _, hd = _mlstm_dims(self.cfg)
        c, n = ssm_lib.mlstm_init_state(
            batch, self.heads[1] - self.heads[0], hd,
            dtype_of(self.cfg.compute_dtype), self.ln.device,
            values=self.channels[1] - self.channels[0])
        return dict(c=c, n=n)

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d].  The state comes back in fp32 from the first step
        on (the reference's ``mlstm_decode_step`` promotes it), so the
        cache's ``c`` / ``n`` are replaced, not written into."""
        q, k, v, ig, fg, z = self._qkv_gates(x_t[:, 0], x_t.shape[:1])
        y, (c2, n2) = ssm_lib.mlstm_decode_step((cache["c"], cache["n"]),
                                                q, k, v, ig, fg)
        cache["c"], cache["n"] = c2, n2
        return self._out(x_t, y[:, None].to(x_t.dtype).flatten(-2) *
                         F.silu(z[:, None]))


# =========================================================== slstm block


class SlstmBlock(_Heads):
    """xLSTM scalar-LSTM block: pre-RMSNorm, ``wx`` to the z/i/f/o
    pre-activations, the per-token sLSTM loop with block-diagonal
    recurrent weights ``r`` (:func:`ssm.slstm_scan`), ``out``, with a
    residual.  ``ln [d]``, ``wx [d, 4·d]``, ``r [4, H, hd, hd]`` (std
    0.3/√hd), ``out [d, d]``.

    Over "model" the work splits one of two ways, per call, as
    :func:`slstm_split` counts from the call's rows and steps
    (:meth:`split_of`; :attr:`form` ``"weights"`` forces the first,
    ``"activations"`` the second):

    * ``"heads"``: the recurrence is block-diagonal by head, so a rank
      computes its heads ``heads = [lo, hi)`` of :func:`heads_split`
      with no collective inside the loop: their four gates' columns of
      ``wx``, their blocks of ``r``, and ``out`` row-parallel on their
      rows.  Where the specs' slice is not that part, ``wx``'s and
      ``out``'s products or the leaves themselves are exchanged
      (:func:`heads_form`); ``r`` is gathered whole (stored on ``hd``,
      cut on heads).
    * ``"channels"``, the reference's split of ``r``: a rank computes
      the output channels ``hd_channels = [c_lo, c_hi)`` of
      :func:`heads_split` of ``hd`` in every head and gate: ``wx``'s
      columns ``g·d + j·hd + [c_lo, c_hi)`` (gate g, head j), ``r`` as
      stored, the update of ``c``, ``n``, ``m`` on those channels, and
      each step's ``h`` gathered whole over "model" for the next step's
      product (its gradient reduce-scattered back).  ``out`` takes the
      whole ``h`` times its stored output columns, placed among zeros
      for the row-parallel sum.

    A decode cache holds the state of the split its ``init_cache`` took
    (``c``, ``n``, ``m`` of the rank's heads or channels, ``h`` as the
    loop needs it); stepping it in the other split raises."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        dt = dtype_of(cfg.param_dtype)
        gen = generator
        sp = self.param_specs()
        lo, hi = self.heads = _build_heads(h)
        self.m, rank = sharding.build_size(), sharding.build_rank()
        self.tp = self.m > 1
        self.ln = _ones(cfg, gen)
        self._leaf("wx", _init_dense(gen, d, 4 * d, dt), sp["wx"], 1,
                   _spans(lo, hi, hd, *range(0, 4 * d, d)))
        self._leaf("r", _draw(gen, (4, h, hd, hd), 0.3 / math.sqrt(hd), dt),
                   sp["r"], 1, _spans(lo, hi, 1))
        self._leaf("out", _init_dense(gen, d, d, dt), sp["out"], 0,
                   _spans(lo, hi, hd), _head_rows(h, hd))
        clo, chi = self.hd_channels = heads_split(hd, self.m, rank)
        self.channel_cuts: Dict[str, tuple] = {}
        for name, shape, dim, pieces in (
                ("wx", (d, 4 * d), 1, [(g * d + j * hd + clo, chi - clo)
                                       for g in range(4) for j in range(h)]),
                ("r", (4, h, hd, hd), 3, [(clo, chi - clo)]),
                ("out", (d, d), 1, _spans(*heads_split(d, self.m, rank), 1))):
            _add_cut(self.channel_cuts, name, shape, sp[name], dim, pieces)

    def param_specs(self) -> Dict[str, P]:
        d = self.cfg.d_model
        return dict(ln=P(None), wx=P(None, mdl(4 * d)),
                    r=P(None, None, None, mdl(d // self.cfg.n_heads)),
                    out=P(None, mdl(d)))

    def split_of(self, rows: int, steps: int) -> str:
        """The split, ``"heads"`` or ``"channels"``, a call of ``steps``
        tokens on ``rows`` rows takes: the heads split in the world of one and
        where ``r`` is stored whole (nothing of it to save), else
        :attr:`form`'s, or :func:`slstm_split`'s from the shapes."""
        if self.m == 1 or "r" not in self.gather_leaves:
            return "heads"
        if self.form is not None:
            return "channels" if self.form == "activations" else "heads"
        return slstm_split(rows, steps, self.cfg.d_model, self.cfg.n_heads,
                           self.m, dtype_of(self.cfg.compute_dtype).itemsize,
                           self.wx.element_size())

    def _whole_h(self, hp: torch.Tensor) -> torch.Tensor:
        """Every rank's channels ``hp`` [B,H,P] of ``h``, gathered over
        "model" into the whole ``h`` [B,H,hd] (padded to the widest
        rank's channels for an equal-size gather; the gradient
        reduce-scattered back)."""
        hd = self.cfg.d_model // self.cfg.n_heads
        share = -(-hd // self.m)
        if hp.shape[-1] < share:
            hp = F.pad(hp, (0, share - hp.shape[-1]))
        o = sharding.gather_from_model(hp, -1, partial_grad=True)
        if hd % self.m == 0:
            return o
        return _cut(o, -1, [(j * share, b - a) for j, (a, b) in enumerate(
            heads_split(hd, self.m, q) for q in range(self.m))])

    def _scan(self, x, split, state=None):
        """The sLSTM in ``split``: ``(h_seq, state)`` (before ``out``),
        ``h_seq`` [B,S,nl·hd] of the rank's heads in the heads split, the
        whole [B,S,d] in the channels split."""
        b, s, d = x.shape
        h = self.cfg.n_heads
        xn = _column(rms_norm(x, self.ln), self.tp)
        if split == "heads":
            nl = self.heads[1] - self.heads[0]
            parts = self.product("wx", xn).reshape(b, s, 4, nl, d // h)
            ys, state = ssm_lib.slstm_scan(parts, self.part("r"), state)
            return ys.to(x.dtype).flatten(2), state
        cuts = self.channel_cuts
        clo, chi = self.hd_channels
        parts = self.product("wx", xn, cuts).reshape(b, s, 4, h, chi - clo)
        heads_forms["activations"] += 1
        heads_moved["activations"] += \
            s * b * h * -(-(d // h) // self.m) * 4
        ys, state = ssm_lib.slstm_scan(parts, self.part("r", cuts), state,
                                       self._whole_h)
        return ys.to(x.dtype).flatten(2), state

    def _out(self, x, ys, split):
        if split == "heads":
            return x + _row(self.product("out", ys), self.tp)
        lo, hi = heads_split(self.cfg.d_model, self.m, sharding.model_rank())
        y = ys @ self.part("out", self.channel_cuts)
        return x + _row(F.pad(y, (lo, self.cfg.d_model - hi)), self.tp)

    def head_outputs(self, x: torch.Tensor) -> torch.Tensor:
        """The sLSTM's ``h`` before ``out``: on the rank's heads
        [B,S,nl·hd] in the heads split, on its channels of every head
        [B,S,H·P] in the channels split."""
        split = self.split_of(*x.shape[:2])
        ys = self._scan(x, split)[0]
        if split == "heads":
            return ys
        clo, chi = self.hd_channels
        return ys.unflatten(-1, (self.cfg.n_heads, -1))[..., clo:chi
                                                        ].flatten(2)

    def forward(self, x: torch.Tensor, off: int = 0,
                force_chunked: bool = False):
        """x: [B,S,d] -> ``(x, 0)``."""
        split = self.split_of(*x.shape[:2])
        return self._out(x, self._scan(x, split)[0], split), _no_aux(x)

    def _state_shapes(self, batch: int, split: str):
        """The shapes of ``c`` / ``n`` / ``m`` and of ``h`` in ``split``:
        [B,nl,hd] each of the rank's heads, or [B,H,P] of its channels
        and ``h`` whole [B,H,hd]."""
        h = self.cfg.n_heads
        hd = self.cfg.d_model // h
        if split == "heads":
            part = (batch, self.heads[1] - self.heads[0], hd)
            return part, part
        clo, chi = self.hd_channels
        return (batch, h, chi - clo), (batch, h, hd)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """The fp32 state ``c``, ``n``, ``h``, ``m`` at its start (n =
        1e-6, m = -10) in the split a decode step of ``batch`` rows takes
        (:meth:`split_of`)."""
        part, whole = self._state_shapes(batch, self.split_of(batch, 1))
        kw = dict(dtype=torch.float32, device=self.ln.device)
        z = torch.zeros(part, **kw)
        hz = z if part == whole else torch.zeros(whole, **kw)
        return dict(c=z, n=z + 1e-6, h=hz, m=z - 10.0)

    def decode(self, cache: Dict[str, torch.Tensor], x_t: torch.Tensor,
               pos: int) -> torch.Tensor:
        """x_t: [B,1,d]; the state is replaced.  A cache whose state is not
        of this step's split raises."""
        split = self.split_of(x_t.shape[0], 1)
        want = self._state_shapes(x_t.shape[0], split)
        got = tuple(cache["c"].shape), tuple(cache["h"].shape)
        if got != want:
            raise ValueError(
                f"an sLSTM cache of c / h {got[0]} / {got[1]} stepped in "
                f"the {split} split, whose state is {want[0]} / {want[1]}: "
                "it was made in the other split")
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
        ys, (c, n, hh, m) = self._scan(x_t, split, state)
        cache.update(c=c, n=n, h=hh, m=m)
        return self._out(x_t, ys, split)
