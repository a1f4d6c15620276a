"""Top-k routed mixture-of-experts FFN (GShard-style capacity dispatch),
the counterpart of the JAX package's ``models/moe.py``.

Top-k routing, each (token, slot)'s position within its expert from a
cumulative sum over the one-hot assignment, capacity-bounded buffers
``[E, C, d]``, SwiGLU experts as batched products, a weighted combine.
A (token, slot) past its expert's capacity is dropped: it adds nothing,
and the token passes through the residual.

:func:`moe_ffn` dispatches all tokens at once; :func:`moe_ffn_grouped`
splits them into groups that each own a private capacity slice of every
expert.  Both are one computation here (:func:`_dispatch` over ``[G, Tg,
d]``; the flat form is one group), as the reference's two are the same
function at ``G = 1``.

Where the two packages could part, this one follows the reference:

* **Tie order.**  ``jax.lax.top_k`` puts the lower expert first among
  equal probabilities; ``torch.topk`` does not promise an order.  The
  router's logits are rounded to the weights' dtype before the fp32
  softmax, so in bf16 ties are common, and the slot order decides both
  which (token, slot) a full expert drops and the balance loss.  The top
  k are taken from a stable descending sort, which gives JAX's order.
* **Dropped slots.**  The reference scatter-adds every (token, slot) into
  the buffer, a dropped one as zeros at ``cap - 1``; an indexed
  assignment would let such a zero row overwrite the token kept there,
  so the dispatch adds too (``index_put_(accumulate=True)``), on the
  device, without a host-side mask.
* **Positions** are the cumulative sum of an int64 one-hot (the
  reference's is int32; the values are the same).
* **Capacity** is ``max(1, int(tokens * top_k * capacity_factor / E))``
  in Python floats, the group count ``min(n_groups, T)`` halved until it
  divides ``T``, both as the reference computes them.

The expert products are ``torch.bmm`` on the expert-major buffers; the
reference computes its einsums outside any Pallas kernel.

Over a mesh the semantics stay the reference's global ones under
``jit``.  A rank that holds some of the batch's rows (a "data" axis
declared in :mod:`~repro_torch.models.sharding`) computes the balance
loss from the whole batch's router statistics (all-reduced, weighted by
token count), takes its capacity and its groups from the whole batch's
token count, and offsets its slot positions by the per-expert counts of
the lower ranks that share a group, so it keeps and drops exactly the
(token, slot) pairs the world of one does.  ``expert_parallel`` runs the
experts sharded over "model": every rank routes from the gathered
logits, runs only its own experts, and one all-reduce adds up the
combine.  Under a width axis each rank holds its slice of the experts'
hidden width, and each call takes the cheaper of two exchanges over the
axis (:func:`width_form`): the ``"tokens"`` form computes every data
rank's slots on the slice, the ``"weights"`` form gathers the slices
whole and computes the rank's own slots (:func:`_dispatch`).  With no
axis declared all of this is the single-device code.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from . import sharding

#: the dispatches run under a width axis, by what went over it
#: (``"tokens"``, ``"weights"``, or ``"replicated"``: nothing, the rows
#: being the same on every width rank)
width_forms: collections.Counter = collections.Counter()
#: the forms :func:`width_form` chooses between
FORMS = ("tokens", "weights")


def moe_params_shape(d_model: int, n_experts: int, d_ff: int):
    return dict(
        wg=(d_model, n_experts),
        w1=(n_experts, d_model, d_ff),
        w3=(n_experts, d_model, d_ff),
        w2=(n_experts, d_ff, d_model),
    )


def capacity(tokens: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    """Slots per expert (per group) for ``tokens`` routed tokens."""
    return max(1, int(tokens * top_k * capacity_factor / n_experts))


def n_groups_for(t: int, n_groups: int) -> int:
    """The grouped dispatch's group count for ``t`` tokens."""
    g = min(n_groups, t)
    while t % g != 0:
        g //= 2
    return g


def route(xg: torch.Tensor, wg: torch.Tensor, top_k: int,
          expert_parallel: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of tokens ``xg [..., d]``: the fp32 softmax ``probs [...,
    E]`` of the logits (rounded to ``xg``'s dtype first), the top
    ``top_k`` experts ``top_i`` (JAX's order among ties) and their
    renormalised weights ``top_p``.  With ``expert_parallel`` ``wg`` is
    this rank's slice of the experts and the logits are gathered whole
    over "model" first."""
    logits = xg @ wg
    if expert_parallel:
        logits = sharding.gather_from_model(logits, -1)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :top_k], top_i[..., :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def slot_positions(top_i: torch.Tensor, n_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_i [G, Tg, k]`` -> each (token, slot)'s position within its
    expert's group-private buffer and whether it is kept (``pos < cap``),
    both ``[G, Tg·k]``: token-major, slot-minor, as the reference
    flattens them."""
    flat_pos, _ = _positions(top_i, n_experts)
    return flat_pos, flat_pos < cap


def _positions(top_i: torch.Tensor, n_experts: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local slot positions ``[G, Tg·k]`` and the per-expert counts
    of each group ``[G, E]``."""
    g = top_i.shape[0]
    flat_e = top_i.reshape(g, -1)
    pos = torch.cumsum(F.one_hot(flat_e, n_experts), dim=1) - 1
    flat_pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    return flat_pos, pos[:, -1] + 1


def width_form_bytes(rows: int, d: int, d_ff: int, n_local: int,
                     top_k: int, width: int, act_bytes: int, w_bytes: int,
                     train: bool = False, remat: bool = False
                     ) -> Dict[str, int]:
    """The bytes one layer's routed FFN moves over a width axis of
    ``width`` ranks in each form, counted as :data:`sharding.stats`
    counts them (each collective's operand), for a rank of ``rows``
    tokens and ``n_local`` experts of hidden width ``d_ff``
    (``act_bytes`` / ``w_bytes``: an activation's and a weight's element
    size):

    * ``"tokens"``: the tokens (``rows·d``), their combine weights (fp32)
      and their experts, positions and keep masks (int64) gathered, the
      partial outputs of every width rank's rows sum-scattered
      (``width·rows·d``); backward, the converse of each;
    * ``"weights"``: the rank's slices of ``w1``, ``w3`` and ``w2``
      gathered (``3·n_local·d·d_ff/width``); backward, their gradients
      reduce-scattered (``width`` times that).

    Without ``train`` only the forward counts; with ``remat`` the
    forward's collectives run again in the backward's recompute."""
    gathered = rows * (d * act_bytes + top_k * 4 + 3 * top_k * 8)
    scattered = width * rows * d * act_bytes
    slices = 3 * n_local * d * (d_ff // width) * w_bytes
    fwd = dict(tokens=gathered + scattered, weights=slices)
    bwd = dict(tokens=width * rows * (d * act_bytes + top_k * 4) +
               rows * d * act_bytes, weights=width * slices)
    passes = 2 if train and remat else 1
    return {f: passes * fwd[f] + (bwd[f] if train else 0) for f in FORMS}


def width_form(*args, **kwargs) -> str:
    """The form of :func:`width_form_bytes` (same arguments) that moves
    fewer bytes, ``"tokens"`` on a tie.  It reads shapes only, so every
    rank of the axis takes the same form with no collective."""
    b = width_form_bytes(*args, **kwargs)
    return "weights" if b["weights"] < b["tokens"] else "tokens"


def _width_groups(g: int, share: int, width: sharding.Axis) -> List[int]:
    """The buffer group of each of the ``width.size · g`` groups the
    width gather brings together (every member's ``g`` in member order),
    numbered from 0 by the whole batch's group each belongs to: a group
    of its own where groups fall whole inside a rank's rows (``share``
    1), the one the ``share`` consecutive rows ranks hold together
    otherwise (the flat form: one)."""
    q0 = sharding.data_axis().rank - width.rank * width.stride
    whole = [(q0 + w * width.stride) * g + j if share == 1 else
             (q0 + w * width.stride) // share
             for w in range(width.size) for j in range(g)]
    number = {k: i for i, k in enumerate(sorted(set(whole)))}
    return [number[k] for k in whole]


def _dispatch(xg: torch.Tensor, w: Mapping[str, torch.Tensor], top_k: int,
              cap: int, ranks_per_group: int = 1,
              expert_parallel: bool = False, remat: bool = False,
              form: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed FFN on this rank's groups ``xg [G, Tg, d]`` at ``cap``
    slots per expert and group -> ``(y [G, Tg, d], aux)``; ``w`` holds
    ``wg``, ``w1``, ``w3``, ``w2``.

    Under a "data" axis (:func:`sharding.data_axis`) the balance loss's
    statistics are the whole batch's, and where ``ranks_per_group`` > 1
    consecutive data ranks share one group, each slot's position is
    offset by the counts of the lower ranks of its group, so every rank
    keeps and drops the (token, slot) pairs the world of one does.  With
    ``expert_parallel`` the router's and the experts' leaves are this
    rank's slice over "model": the logits are gathered whole, every rank
    routes alike, fills and runs only its own experts, and the combine's
    partial sums are added up over "model".

    Under a width axis (:func:`sharding.width_axis`) the experts' leaves
    are this rank's slice of their hidden width ``d_ff / D``, and ``form``
    (by default :func:`width_form` of the shapes; ``remat``: the block's
    forward runs again in the backward) says what goes over the axis:

    * ``"tokens"``: every width rank's tokens and their routing are
      gathered (the flat form's slot positions are the whole batch's,
      disjoint between ranks) and dispatched into the buffers of the
      groups they belong to, the SwiGLU runs on the slice (a partial sum
      of each output), and the combined partial outputs are summed back
      to the rank that owns each row (:func:`sharding.scatter_over_width`);
    * ``"weights"``: the slices are gathered whole (their gradients
      reduce-scattered back) and the rank runs the whole SwiGLU on its
      own kept slots alone, in buffers of as many rows an expert as it
      keeps there (``⌈cap/D⌉`` on ``meta``, which cannot count them)
      where its group's slots are shared with other ranks, of ``cap``
      where the group is its own.

    Where every width rank holds the same rows (the batch replicated),
    nothing is gathered and the partial outputs are all-reduced."""
    if form is not None and form not in FORMS:
        raise ValueError(f"unknown width form {form!r}: one of {FORMS}")
    g, tg, d = xg.shape
    data = sharding.data_axis()
    width = sharding.width_axis()
    h = sharding.copy_to_model(xg) if expert_parallel else xg
    probs, top_p, top_i = route(h, w["wg"], top_k, expert_parallel)
    e = probs.shape[-1]

    # load-balancing auxiliary loss (Switch-style): mean router
    # probability times the share of tokens whose first choice it is
    first = top_i[..., 0].reshape(-1)
    f32 = dict(dtype=torch.float32, device=xg.device)
    counts = torch.zeros((e,), **f32).index_add_(
        0, first, torch.ones(first.shape, **f32))
    if data is None:
        me = probs.mean(dim=(0, 1))
        ce = counts / (g * tg)
    else:                       # the whole batch's statistics
        n = g * tg * data.size
        me = sharding.sum_over_data(probs.sum(dim=(0, 1))) / n
        ce = sharding.all_reduce(counts, data) / n
    aux = e * torch.sum(me * ce)

    flat_e = top_i.reshape(g, tg * top_k)
    flat_pos, group_counts = _positions(top_i, e)
    own_pos = flat_pos
    shared = data is not None and ranks_per_group > 1
    if shared:
        every = sharding.all_gather(group_counts[None], data)  # [D, G, E]
        lo = data.rank - data.rank % ranks_per_group
        below = every[lo:data.rank].sum(dim=0)
        flat_pos = flat_pos + torch.gather(below, 1, flat_e)
    keep = flat_pos < cap
    n_local = e
    if expert_parallel:
        n_local = w["w1"].shape[0]
        e0 = sharding.model_rank() * n_local
        mine = (flat_e >= e0) & (flat_e < e0 + n_local)
        keep = keep & mine
        flat_e = torch.where(mine, flat_e - e0, 0)
        top_p = sharding.copy_to_model(top_p)
    flat_w = top_p.reshape(g, tg * top_k) * keep

    # over a width axis the tokens and their routing are gathered, or the
    # experts' slices, unless every width rank holds the same rows
    if width is None:
        form = None
    elif data is None:
        form = "replicated"
    elif form is None:
        train = torch.is_grad_enabled() and w["w1"].requires_grad
        form = width_form(g * tg, d, w["w1"].shape[2] * width.size,
                          n_local, top_k, width.size, xg.element_size(),
                          w["w1"].element_size(), train, remat)
    if form is not None:
        width_forms[form] += 1
    rows = cap
    if form == "weights":
        w = dict(w, **{n: sharding.gather_over_width(
            w[n], 1 if n == "w2" else 2, getattr(w[n], "leaf_name", n))
            for n in ("w1", "w3", "w2")})
        if shared:              # the rank's own kept slots, in order
            flat_pos = own_pos
            if xg.device.type == "meta":
                rows = -(-cap // width.size)
            else:
                rows = max(1, int(torch.where(keep, own_pos + 1, 0).max()))
    safe_pos = torch.where(keep, flat_pos, rows - 1)

    if form == "tokens":
        h = sharding.gather_over_width(h)
        flat_w = sharding.gather_over_width(flat_w)
        keep, flat_e, safe_pos = sharding.all_gather(
            torch.stack([keep.long(), flat_e, safe_pos]), width, dim=1)
        keep = keep.bool()
        groups = _width_groups(g, ranks_per_group, width)
        n_buf = max(groups) + 1
        gidx = torch.tensor(groups, device=xg.device)
    else:
        if form == "replicated":
            h = sharding.copy_to_width(h)
        n_buf = g
        gidx = torch.arange(g, device=xg.device)
    gidx = gidx[:, None].expand(flat_e.shape)

    # dispatch into buffers [G, E, C, d]: dropped slots add zeros
    xk = torch.where(keep[..., None], h.repeat_interleave(top_k, dim=1),
                     0).to(xg.dtype)
    buf = torch.zeros((n_buf, n_local, rows, d), dtype=xg.dtype,
                      device=xg.device)
    buf.index_put_((gidx, flat_e, safe_pos), xk, accumulate=True)
    del xk

    # expert compute (batched SwiGLU): expert-major [E, G·C, d], on this
    # rank's slice of the hidden width in the tokens form
    nb = buf.shape[0]
    be = buf.transpose(0, 1).reshape(n_local, nb * rows, d)
    del buf
    hid = F.silu(torch.bmm(be, w["w1"])) * torch.bmm(be, w["w3"])
    del be
    out = torch.bmm(hid, w["w2"]).reshape(n_local, nb, rows, d)
    out = out.transpose(0, 1)
    del hid

    # combine
    yk = out[gidx, flat_e, safe_pos] * flat_w[..., None].to(xg.dtype)
    y = yk.reshape(-1, tg, top_k, d).sum(dim=2)
    if form == "tokens":
        y = sharding.scatter_over_width(y)
    elif form == "replicated":
        y = sharding.reduce_from_width(y)
    if expert_parallel:
        y = sharding.reduce_from_model(y)
    return y, aux


def _data_size() -> int:
    data = sharding.data_axis()
    return 1 if data is None else data.size


def moe_ffn(x: torch.Tensor, p: Mapping[str, torch.Tensor], top_k: int,
            capacity_factor: float = 1.25, expert_parallel: bool = False,
            remat: bool = False, form: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> (y [B,S,d], aux_loss scalar); one capacity for all
    ``B·S`` tokens (of the whole batch, under a "data" axis).  ``remat``
    and ``form``: :func:`_dispatch`'s, under a width axis."""
    b, s, d = x.shape
    n = _data_size()
    e = p["wg"].shape[1] * (sharding.model_size() if expert_parallel else 1)
    cap = capacity(b * s * n, top_k, capacity_factor, e)
    y, aux = _dispatch(x.reshape(1, b * s, d), p, top_k, cap, n,
                       expert_parallel, remat, form)
    return y.reshape(b, s, d), aux


def moe_ffn_grouped(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                    top_k: int, capacity_factor: float = 1.25,
                    n_groups: int = 256, expert_parallel: bool = False,
                    remat: bool = False, form: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped (GShard-style) dispatch: the ``B·S`` tokens split into
    :func:`n_groups_for` groups, each with its own capacity slice of every
    expert.  x: [B,S,d] -> (y [B,S,d], aux_loss).

    Under a "data" axis the groups are the whole batch's: where they fall
    whole inside each rank's rows the rank runs its own, and where one
    group spans several ranks those ranks share its capacity.  Group and
    rank counts that nest neither way raise ``ValueError``.  ``remat``
    and ``form``: :func:`_dispatch`'s, under a width axis."""
    b, s, d = x.shape
    n = _data_size()
    total = b * s * n
    g = n_groups_for(total, n_groups)
    tg = total // g
    if g % n == 0:
        local, share = g // n, 1
    elif n % g == 0:
        local, share = 1, n // g
    else:
        raise ValueError(f"{g} groups of the batch's {total} tokens do not "
                         f"nest with {n} data ranks")
    e = p["wg"].shape[1] * (sharding.model_size() if expert_parallel else 1)
    cap = capacity(tg, top_k, capacity_factor, e)
    y, aux = _dispatch(x.reshape(local, b * s // local, d), p, top_k, cap,
                       share, expert_parallel, remat, form)
    return y.reshape(b, s, d), aux
