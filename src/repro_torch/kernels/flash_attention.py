"""Blocked attention forward with an online softmax, causal or not.

The perf-critical attention layer of the LM stack.  Block-level causal
skipping: key/value tiles strictly above the diagonal are never fetched or
computed — the same tile-granular Skip idea as ``bsr_spmm``, with
causality as the (static) sparsity pattern.

Source note.  :func:`flash_attention` launches the hand-written CUDA
kernels of ``csrc/flash_attention.cu`` (``repro_flash_attention``), which
replace the TPU kernel ``_kernel`` / ``flash_attention`` of the JAX
package's ``kernels/flash_attention.py``.  On the H100 attention at
``hd = 128`` is bound by operations once ``S`` is a few hundred (each key
and value is reused by every query row), so the design keeps everything
but q, k, v and o out of device memory: one thread block per (batch*head,
query tile) carries the running max, running sum and fp32 accumulator in
registers across its own loop over key/value tiles, and the causal skip is
that loop's bound.  :func:`flash_plan` picks the route from dtype and shape
alone.  bf16 inputs take ``"wgmma"``: 128-row query tiles, a producer
warpgroup that streams K and V tiles by TMA into two-stage rings in
shared memory, and two consumer warpgroups that take turns on the tensor
cores, each running both products with ``wgmma`` and its softmax while
the other's products run (the score tile never leaves registers).  fp32
inputs take
``"fma"``: 64-row tiles, both products on FMA arithmetic in full fp32.
Forward only, as the TPU kernel.

:func:`flash_attention_plain` is the same blocked online softmax in plain
PyTorch, tile for tile with the route's tile.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

NEG_INF = -1e30
S_MULTIPLE = 64      # S must be a multiple of this (the fp32 kernel's tile)
HD_CHOICES = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


class FlashPlan(NamedTuple):
    route: str   # a key of _build.ROUTES
    tile: int    # query rows per block = keys per tile


def flash_plan(dtype: torch.dtype, s: int, hd: int) -> FlashPlan:
    """The kernel route and tile for inputs that :func:`_check` accepted:
    bf16 on the tensor cores with 128-row tiles (a last tile that runs
    past ``S`` reads zeros and is masked), fp32 on FMA arithmetic with
    64-row tiles.  ``s`` and ``hd`` do not change the choice."""
    if dtype == torch.bfloat16:
        return FlashPlan("wgmma", 128)
    return FlashPlan("fma", 64)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, tile: int | None = None
                          ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a loop over key/value
    tiles with a running max ``m``, running sum ``l`` and an fp32
    accumulator rescaled by ``exp(m_prev - m_cur)``, the causal loop
    bound per query tile, ``-1e30`` masking inside the diagonal tile and
    a final division by ``max(l, 1e-30)``.  q/k/v: [B, H, S, hd]; ``tile``
    defaults to the route's (:func:`flash_plan`)."""
    b, h, s, hd = q.shape
    if tile is None:
        tile = flash_plan(q.dtype, s, hd).tile
    scale = 1.0 / float(hd) ** 0.5
    qf, kf, vf = (t.float().reshape(b * h, s, hd) for t in (q, k, v))
    out = torch.empty((b * h, s, hd), dtype=torch.float32, device=q.device)
    pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, tile):
        qt = qf[:, q0:q0 + tile]
        rows = pos[q0:q0 + tile]
        m = torch.full((b * h, qt.shape[1]), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        kv_end = min(s, q0 + tile) if causal else s
        for kv0 in range(0, kv_end, tile):
            sc = torch.einsum("bqd,bkd->bqk", qt, kf[:, kv0:kv0 + tile])
            sc = sc * scale
            if causal and kv0 + tile - 1 > q0:
                cols = pos[kv0:kv0 + tile]
                sc = torch.where(rows[:, None] >= cols[None, :], sc, NEG_INF)
            m_cur = torch.maximum(m, sc.max(dim=-1).values)
            p = torch.exp(sc - m_cur[..., None])
            alpha = torch.exp(m - m_cur)
            l = l * alpha + p.sum(dim=-1)
            # the bf16 kernel feeds the second product bf16 probabilities
            # (the running sum keeps fp32); a no-op for fp32 inputs
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkd->bqd", p.to(q.dtype).float(),
                vf[:, kv0:kv0 + tile])
            m = m_cur
        out[:, q0:q0 + tile] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, s, hd).to(q.dtype)


def _check(q, k, v, bq: int, bk: int) -> None:
    if q.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, hd]")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {DTYPES}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must share one device")
    s, hd = q.shape[2], q.shape[3]
    if bq <= 0 or bk <= 0 or s % bq != 0 or s % bk != 0:
        raise ValueError(f"S={s} must be divisible by bq={bq} and bk={bk}")
    if s % S_MULTIPLE != 0:
        raise ValueError(f"S={s} must be a multiple of {S_MULTIPLE}")
    if hd not in HD_CHOICES:
        raise ValueError(f"hd={hd} unsupported: need hd in {HD_CHOICES}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def needs_grad(*ts) -> bool:
    """Whether autograd records and one of ``ts`` (``None`` skipped)
    requires a gradient: the kernel has no backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128
                    ) -> torch.Tensor:
    """q/k/v: [B, H, S, hd] -> [B, H, S, hd]; fp32 or bf16, hd 64 or 128.

    ``bq`` / ``bk`` are kept from the reference's signature with its
    divisibility requirement; the kernel's tile is :func:`flash_plan`'s,
    and ``S`` must also be a multiple of 64.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    :func:`flash_attention_plain`.  Forward only, as the reference: an
    input that requires a gradient while autograd records raises
    ``RuntimeError`` on either device, so no call drops a gradient.
    """
    _check(q, k, v, bq, bk)
    if needs_grad(q, k, v):
        raise RuntimeError(
            "flash_attention has no backward (nor has the reference's): "
            "call it under torch.no_grad() / inference_mode, or on inputs "
            "that need no gradient")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal)
    b, h, s, hd = q.shape
    plan = flash_plan(q.dtype, s, hd)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary")
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device.index):
        # the raw handle of PyTorch's current stream (what Triton's
        # launcher reads): a Stream object costs more than the launch
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b * h, s, hd, 1.0 / float(hd) ** 0.5, int(bool(causal)),
            int(q.dtype == torch.bfloat16), _build.ROUTES[plan.route], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({plan.route}) launch "
                           f"failed (code {err})")
    flash_attention.launches += 1
    return o


#: launches of the CUDA kernel by this wrapper (plain integer)
flash_attention.launches = 0
