"""Attention: GQA with causal / sliding-window masks, the counterpart of the
JAX package's ``models/attention.py``, plus single-token decode against a
KV cache.

:func:`attention` takes one of two routes, chosen by
:func:`attention_route` from shape, dtype, mask and autograd state (never
from the device):

* ``"flash"`` — self-attention, causal or not (an encoder's; a
  cross-attention whose query and key lengths are equal), whose shape the
  hand-written kernel takes (:mod:`repro_torch.kernels.flash_attention`,
  its causal or full mode): K and V are repeated to every query head, the
  operands go to the kernel as contiguous ``[B, H, S, hd]``.  On CUDA tensors the kernel is launched or
  the call raises; on CPU tensors the wrapper runs its plain version.
* ``"chunked"`` — everything else (a window, an offset, ``Sq != Sk``, a
  head size or length the kernel does not take, ``meta`` tensors, or an
  input that needs a gradient while autograd records: the kernel has no backward, and
  neither has the reference's): fp32 scores and softmax in query chunks
  of ``chunk`` rows, as the reference computes them.  This route is
  differentiable.

Both compute the same function; ``attention.calls`` counts the calls per
route (plain integers, never reset by the package).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import flash_attention as flash_lib

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,KV,hd] -> [B,S,KV*n_rep,hd]; query head h reads KV head
    h // n_rep (``jnp.repeat(axis=2)``, not a tile)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention_route(q: torch.Tensor, k: torch.Tensor, causal: bool,
                    window: Optional[int], q_offset: int,
                    v: Optional[torch.Tensor] = None) -> Tuple[str, str]:
    """``("flash" | "chunked", reason)`` for q [B,Sq,H,hd], k/v
    [B,Sk,KV,hd] under the current autograd state."""
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    if window is not None:
        return "chunked", f"sliding window {window}"
    if q_offset != 0:
        return "chunked", f"query offset {q_offset}"
    if sq != sk:
        return "chunked", f"Sq={sq} != Sk={sk}"
    if sq % flash_lib.S_MULTIPLE:
        return "chunked", (f"S={sq} is not a multiple of "
                           f"{flash_lib.S_MULTIPLE}")
    if hd not in flash_lib.HD_CHOICES:
        return "chunked", f"head_dim {hd} not in {flash_lib.HD_CHOICES}"
    if q.dtype not in flash_lib.DTYPES:
        return "chunked", f"dtype {q.dtype} not in {flash_lib.DTYPES}"
    if flash_lib.needs_grad(q, k, v):
        return "chunked", ("an input needs a gradient and the kernel has "
                           "no backward (nor has the reference's)")
    if q.device.type == "meta":
        return "chunked", ("meta tensors (the dry-run): no kernel "
                           "launches on them")
    if not causal:
        return "flash", ("not causal, Sq == Sk in the kernel's shapes: its "
                         "full mode")
    return "flash", "causal self-attention in the kernel's shapes"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, chunk: int = 0,
              force_chunked: bool = False) -> torch.Tensor:
    """q: [B,Sq,H,hd], k/v: [B,Sk,KV,hd] -> [B,Sq,H,hd].

    ``window``: sliding-window size (None = full).  ``q_offset``: absolute
    position of q[0] relative to k[0].  ``chunk`` > 0: the chunked route
    computes in query chunks of that size, so the materialized score block
    is [B,H,chunk,Sk].  ``force_chunked`` takes the chunked route whatever
    :func:`attention_route` says (to hold one route against the other).
    """
    route = "chunked" if force_chunked else \
        attention_route(q, k, causal, window, q_offset, v)[0]
    attention.calls[route] += 1
    n_rep = q.shape[2] // k.shape[2]
    if route == "flash":
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat_interleave(n_rep, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(n_rep, dim=1)
        o = flash_lib.flash_attention(qt, kt, vt, causal=causal,
                                      bq=flash_lib.S_MULTIPLE,
                                      bk=flash_lib.S_MULTIPLE)
        return o.transpose(1, 2)
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    sq = q.shape[1]
    if chunk and sq > chunk and sq % chunk == 0:
        return torch.cat([_attn_block(q[:, i:i + chunk], k, v, causal,
                                      window, q_offset + i)
                          for i in range(0, sq, chunk)], dim=1)
    return _attn_block(q, k, v, causal, window, q_offset)


#: calls of :func:`attention` per route
attention.calls = {"flash": 0, "chunked": 0}


def _scale(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded in fp32 as the reference computes it (an
    fp32 value, so multiplying an fp32 tensor by it is exact to the
    reference's op)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _attn_block(q, k, v, causal, window, q_offset):
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * _scale(hd)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-position decode: q [B,1,H,hd] against cache [B,S,KV,hd].

    ``cache_len``: number of valid cache positions (the new token's K/V
    must already be written at cache_len-1).
    """
    hd = q.shape[3]
    s = k_cache.shape[1]
    n_rep = q.shape[2] // k_cache.shape[2]
    k = _repeat_kv(k_cache, n_rep)
    v = _repeat_kv(v_cache, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * _scale(hd)  # [B,H,1,S]
    kpos = torch.arange(s, device=q.device)
    valid = kpos < cache_len
    if window is not None:
        valid &= kpos >= cache_len - window
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, cache_len: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new [B,1,KV,hd] at position cache_len, in place (the
    reference returns new caches); returns the caches.

    ``cache_len`` outside ``[0, max_len)`` raises ``IndexError``; the
    reference clamps it and overwrites the last slot instead."""
    max_len = k_cache.shape[1]
    if not 0 <= cache_len < max_len:
        raise IndexError(f"cache position {cache_len} is outside the cache "
                         f"of max_len={max_len}")
    k_cache[:, cache_len:cache_len + 1] = k_new
    v_cache[:, cache_len:cache_len + 1] = v_new
    return k_cache, v_cache
