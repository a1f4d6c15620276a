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
hidden width and computes every data rank's slots on it
(:func:`_dispatch`).  With no axis declared all of this is the
single-device code.
"""
from __future__ import annotations

import collections
from typing import List, Mapping, Tuple

import torch
import torch.nn.functional as F

from . import sharding

#: the dispatches run under a width axis, by what went over it
#: (``"tokens"``, or ``"replicated"``: nothing, the rows being the same
#: on every width rank)
width_forms: collections.Counter = collections.Counter()


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
              expert_parallel: bool = False
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
    are this rank's slice of their hidden width ``d_ff / D``.  Every
    width rank's tokens and their routing are gathered over the axis (the
    flat form's slot positions are the whole batch's, disjoint between
    ranks) and dispatched into the buffers of the groups they belong to,
    the SwiGLU runs on the slice (a partial sum of each output), and the
    combined partial outputs are summed back to the rank that owns each
    row (:func:`sharding.scatter_over_width`).  Where every width rank
    holds the same rows (the batch replicated), nothing is gathered and
    the partial outputs are all-reduced."""
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
    if data is not None and ranks_per_group > 1:
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
    safe_pos = torch.where(keep, flat_pos, cap - 1)

    # over a width axis the tokens and their routing are gathered, unless
    # every width rank holds the same rows
    gather = width is not None and data is not None
    if width is not None:
        width_forms["tokens" if gather else "replicated"] += 1
    if gather:
        h = sharding.gather_over_width(h)
        flat_w = sharding.gather_over_width(flat_w)
        keep, flat_e, safe_pos = sharding.all_gather(
            torch.stack([keep.long(), flat_e, safe_pos]), width, dim=1)
        keep = keep.bool()
        groups = _width_groups(g, ranks_per_group, width)
        n_buf = max(groups) + 1
        gidx = torch.tensor(groups, device=xg.device)
    else:
        if width is not None:
            h = sharding.copy_to_width(h)
        n_buf = g
        gidx = torch.arange(g, device=xg.device)
    gidx = gidx[:, None].expand(flat_e.shape)

    # dispatch into buffers [G, E, C, d]: dropped slots add zeros
    xk = torch.where(keep[..., None], h.repeat_interleave(top_k, dim=1),
                     0).to(xg.dtype)
    buf = torch.zeros((n_buf, n_local, cap, d), dtype=xg.dtype,
                      device=xg.device)
    buf.index_put_((gidx, flat_e, safe_pos), xk, accumulate=True)
    del xk

    # expert compute (batched SwiGLU): expert-major [E, G·C, d], on this
    # rank's slice of the hidden width under a width axis
    nb = buf.shape[0]
    be = buf.transpose(0, 1).reshape(n_local, nb * cap, d)
    del buf
    hid = F.silu(torch.bmm(be, w["w1"])) * torch.bmm(be, w["w3"])
    del be
    out = torch.bmm(hid, w["w2"]).reshape(n_local, nb, cap, d).transpose(0, 1)
    del hid

    # combine
    yk = out[gidx, flat_e, safe_pos] * flat_w[..., None].to(xg.dtype)
    y = yk.reshape(-1, tg, top_k, d).sum(dim=2)
    if gather:
        y = sharding.scatter_over_width(y)
    elif width is not None:
        y = sharding.reduce_from_width(y)
    if expert_parallel:
        y = sharding.reduce_from_model(y)
    return y, aux


def _data_size() -> int:
    data = sharding.data_axis()
    return 1 if data is None else data.size


def moe_ffn(x: torch.Tensor, p: Mapping[str, torch.Tensor], top_k: int,
            capacity_factor: float = 1.25, expert_parallel: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> (y [B,S,d], aux_loss scalar); one capacity for all
    ``B·S`` tokens (of the whole batch, under a "data" axis)."""
    b, s, d = x.shape
    n = _data_size()
    e = p["wg"].shape[1] * (sharding.model_size() if expert_parallel else 1)
    cap = capacity(b * s * n, top_k, capacity_factor, e)
    y, aux = _dispatch(x.reshape(1, b * s, d), p, top_k, cap, n,
                       expert_parallel)
    return y.reshape(b, s, d), aux


def moe_ffn_grouped(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                    top_k: int, capacity_factor: float = 1.25,
                    n_groups: int = 256, expert_parallel: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped (GShard-style) dispatch: the ``B·S`` tokens split into
    :func:`n_groups_for` groups, each with its own capacity slice of every
    expert.  x: [B,S,d] -> (y [B,S,d], aux_loss).

    Under a "data" axis the groups are the whole batch's: where they fall
    whole inside each rank's rows the rank runs its own, and where one
    group spans several ranks those ranks share its capacity.  Group and
    rank counts that nest neither way raise ``ValueError``."""
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
                       share, expert_parallel)
    return y.reshape(b, s, d), aux
