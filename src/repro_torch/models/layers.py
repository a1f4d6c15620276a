"""Shared neural layers, the counterparts of the JAX package's
``models/layers.py``: parameter init, RMSNorm, the two MLP kinds and RoPE.

Weights keep the reference's ``[d_in, d_out]`` layout, applied as
``x @ w``.  Every op computes in the dtype and precision the reference
does, step for step: RMSNorm reduces in fp32 and rounds twice, RoPE takes
its angles in fp32, the GELU is the tanh approximation (``jax.nn.gelu``'s
default), ``softmax_xent`` reduces in fp32.  ``apply_m_rope`` is
Qwen2-VL's multimodal RoPE: three position streams, each rotating its own
section of the frequencies.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the CPU's vector-math functions the models call (through MKL's vector
#: math where torch is built with it)
CPU_VECTOR_MATH = (torch.cos, torch.sin, torch.exp, torch.log, torch.tanh,
                   torch.sqrt, torch.erf)


def _init_cpu_vector_math() -> None:
    """Call each of :data:`CPU_VECTOR_MATH` once, on one element, on the
    importing thread.  MKL's vector math, first called from several
    OpenMP threads at once, can return low-accuracy values: the first
    ``torch.cos`` of a process on 4,160 fp32 angles up to 519 rad was up
    to 1.5e-4 off (3.5e-8 after) in about 1 of 60 fresh processes, and
    one rank's rotated queries then moved the sharded parity runs'
    gradients 2e-5 to 6e-5 from the world of one's
    (``tests/test_torch_cpu_trig.py``).  A first call on one thread
    initialises it for the process."""
    z = torch.zeros(1)
    for f in CPU_VECTOR_MATH:
        f(z)


_init_cpu_vector_math()

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------- init


def draw_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """A standard normal fp32 tensor of ``shape`` drawn on ``gen``'s
    device; on ``meta`` (``gen`` then only names the device) an empty
    one, drawing nothing."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def _init_dense(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``normal / sqrt(d_in)`` of shape ``[d_in, d_out]``, drawn in fp32 on
    ``gen``'s device and cast: the weight never passes through the host."""
    w = draw_normal(gen, (d_in, d_out))
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


def apply_m_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 sections=(2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  The hd/2 frequencies are split into
    (temporal, height, width) sections of ``s·hd // (2·Σs)`` each (the
    last takes what is left), and each section is rotated by its own
    position stream.  x: [..., S, H, hd]; positions: [..., S, 3], or
    [..., S], which is used for all three streams (the text-only case)."""
    if positions.dim() == x.dim() - 2:                   # [..., S] -> 3 copies
        positions = torch.stack([positions] * 3, dim=-1)
    hd = x.shape[-1]
    total = sum(sections)
    splits = [s * hd // (2 * total) for s in sections]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    bounds = [0] + [sum(splits[:i + 1]) for i in range(len(splits) - 1)] \
        + [hd // 2]
    ang = torch.cat([positions[..., i:i + 1].float() * freqs[a:b]
                     for i, (a, b) in enumerate(zip(bounds, bounds[1:]))],
                    dim=-1)                              # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- loss


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 softcap: float = 0.0) -> torch.Tensor:
    """Mean cross entropy; logits [.., V] bf16-safe (reductions in fp32),
    capped by ``tanh(lg / softcap) * softcap`` when ``softcap`` > 0."""
    lg = logits.float()
    if softcap > 0.0:
        lg = torch.tanh(lg / softcap) * softcap
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()
