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
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F


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


def route(xg: torch.Tensor, wg: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of tokens ``xg [..., d]``: the fp32 softmax ``probs [...,
    E]`` of the logits (rounded to ``xg``'s dtype first), the top
    ``top_k`` experts ``top_i`` (JAX's order among ties) and their
    renormalised weights ``top_p``."""
    probs = torch.softmax((xg @ wg).float(), dim=-1)
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
    g = top_i.shape[0]
    flat_e = top_i.reshape(g, -1)
    pos = torch.cumsum(F.one_hot(flat_e, n_experts), dim=1) - 1
    flat_pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    return flat_pos, flat_pos < cap


def _dispatch(xg: torch.Tensor, w: Mapping[str, torch.Tensor], top_k: int,
              capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed FFN on groups ``xg [G, Tg, d]`` -> ``(y [G, Tg, d],
    aux)``; ``w`` holds ``wg``, ``w1``, ``w3``, ``w2``."""
    g, tg, d = xg.shape
    e = w["wg"].shape[1]
    probs, top_p, top_i = route(xg, w["wg"], top_k)

    # load-balancing auxiliary loss (Switch-style): mean router
    # probability times the share of tokens whose first choice it is
    me = probs.mean(dim=(0, 1))
    first = top_i[..., 0].reshape(-1)
    f32 = dict(dtype=torch.float32, device=xg.device)
    ce = torch.zeros((e,), **f32).index_add_(
        0, first, torch.ones(first.shape, **f32)) / (g * tg)
    aux = e * torch.sum(me * ce)

    cap = capacity(tg, top_k, capacity_factor, e)
    flat_e = top_i.reshape(g, tg * top_k)
    flat_pos, keep = slot_positions(top_i, e, cap)
    flat_w = top_p.reshape(g, tg * top_k) * keep
    safe_pos = torch.where(keep, flat_pos, cap - 1)
    gidx = torch.arange(g, device=xg.device)[:, None].expand(g, tg * top_k)

    # dispatch into buffers [G, E, C, d]: dropped slots add zeros
    xk = torch.where(keep[..., None], xg.repeat_interleave(top_k, dim=1),
                     0).to(xg.dtype)
    buf = torch.zeros((g, e, cap, d), dtype=xg.dtype, device=xg.device)
    buf.index_put_((gidx, flat_e, safe_pos), xk, accumulate=True)
    del xk

    # expert compute (batched SwiGLU): expert-major [E, G·C, d]
    be = buf.transpose(0, 1).reshape(e, g * cap, d)
    del buf
    h = F.silu(torch.bmm(be, w["w1"])) * torch.bmm(be, w["w3"])
    del be
    out = torch.bmm(h, w["w2"]).reshape(e, g, cap, d).transpose(0, 1)
    del h

    # combine
    yk = out[gidx, flat_e, safe_pos] * flat_w[..., None].to(xg.dtype)
    return yk.reshape(g, tg, top_k, d).sum(dim=2), aux


def moe_ffn(x: torch.Tensor, p: Mapping[str, torch.Tensor], top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> (y [B,S,d], aux_loss scalar); one capacity for all
    ``B·S`` tokens."""
    b, s, d = x.shape
    y, aux = _dispatch(x.reshape(1, b * s, d), p, top_k, capacity_factor)
    return y.reshape(b, s, d), aux


def moe_ffn_grouped(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                    top_k: int, capacity_factor: float = 1.25,
                    n_groups: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped (GShard-style) dispatch: the ``B·S`` tokens split into
    :func:`n_groups_for` groups, each with its own capacity slice of every
    expert.  x: [B,S,d] -> (y [B,S,d], aux_loss)."""
    b, s, d = x.shape
    g = n_groups_for(b * s, n_groups)
    y, aux = _dispatch(x.reshape(g, b * s // g, d), p, top_k,
                       capacity_factor)
    return y.reshape(b, s, d), aux

