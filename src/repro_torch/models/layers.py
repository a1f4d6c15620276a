"""Shared neural layers, the counterparts of the JAX package's
``models/layers.py``: parameter init, RMSNorm, the two MLP kinds and RoPE.

Weights keep the reference's ``[d_in, d_out]`` layout, applied as
``x @ w``.  Every op computes in the dtype and precision the reference
does, step for step: RMSNorm reduces in fp32 and rounds twice, RoPE takes
its angles in fp32, the GELU is the tanh approximation (``jax.nn.gelu``'s
default).  Not here yet: ``apply_m_rope`` (qwen2-vl) and ``softmax_xent``
(training).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------- init


def _init_dense(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``normal / sqrt(d_in)`` of shape ``[d_in, d_out]``, drawn in fp32 on
    ``gen``'s device and cast: the weight never passes through the host."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


# ---------------------------------------------------------------- ops


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x@w1) * (x@w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def mlp(x: torch.Tensor, p) -> torch.Tensor:
    """Dispatch on the weights ``p`` (attributes ``w1``, ``w2`` and ``w3``):
    SwiGLU if ``p.w3`` is set, else the 2-matrix tanh-GELU MLP."""
    if p.w3 is not None:
        return swiglu(x, p.w1, p.w3, p.w2)
    return F.gelu(x @ p.w1, approximate="tanh") @ p.w2


# ---------------------------------------------------------------- RoPE


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(theta, exps)        # fp32, made on the device


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Rotates
    the two halves of the head, ``[x1 cos - x2 sin, x2 cos + x1 sin]``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                       # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
