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
64-row query tile) carries the running max, running sum and fp32
accumulator in registers across its own loop over key/value tiles, and the
causal skip is that loop's bound.  bf16 inputs run both products on the
tensor cores (``mma.sync`` m16n8k16 with ``ldmatrix`` fragment loads; the
score tile never leaves registers); fp32 inputs run them on FMA
arithmetic in full fp32.  Loads are synchronous; ``wgmma``, TMA and
copy/compute overlap are later work (PERF.md has the times).  Forward
only, as the TPU kernel.

:func:`flash_attention_plain` is the same blocked online softmax in plain
PyTorch, tile for tile.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
TILE = 64            # the kernel's query and key/value tile
HD_CHOICES = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, tile: int = TILE
                          ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a loop over key/value
    tiles with a running max ``m``, running sum ``l`` and an fp32
    accumulator rescaled by ``exp(m_prev - m_cur)``, the causal loop
    bound per query tile, ``-1e30`` masking inside the diagonal tile and
    a final division by ``max(l, 1e-30)``.  q/k/v: [B, H, S, hd]."""
    b, h, s, hd = q.shape
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
    if s % TILE != 0:
        raise ValueError(f"S={s} must be a multiple of the kernel's tile "
                         f"{TILE}")
    if hd not in HD_CHOICES:
        raise ValueError(f"hd={hd} unsupported: need hd in {HD_CHOICES}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128
                    ) -> torch.Tensor:
    """q/k/v: [B, H, S, hd] -> [B, H, S, hd]; fp32 or bf16, hd 64 or 128.

    ``bq`` / ``bk`` are kept from the reference's signature with its
    divisibility requirement; the kernel picks its own 64-row tile, so
    ``S`` must also be a multiple of 64.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    :func:`flash_attention_plain`.
    """
    _check(q, k, v, bq, bk)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal)
    b, h, s, hd = q.shape
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b * h, s, hd, 1.0 / float(hd) ** 0.5, int(bool(causal)),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed (code {err})")
    flash_attention.launches += 1
    return o


#: launches of the CUDA kernel by this wrapper (plain integer)
flash_attention.launches = 0
