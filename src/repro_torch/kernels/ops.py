"""Public entry points of the hand-written kernels, with mode dispatch.

``device`` says where the operands are taken to before the call: ``None``
means the GPU and raises where there is none; ``device="cpu"`` runs on the
CPU on purpose.  Operands may be tensors or numpy arrays.

``mode``:

* ``"auto"``   — the CUDA kernel for CUDA tensors, the kernel's plain
  PyTorch version for CPU tensors;
* ``"kernel"`` — the CUDA kernel, or raise (CPU tensors raise);
* ``"ref"``    — the dense oracle of :mod:`repro_torch.kernels.ref`;
* ``"interpret"`` has no meaning for CUDA C++ and raises ``ValueError``.
"""
from __future__ import annotations

import torch

from ..device import DeviceLike, resolve_device
from . import ref as ref_lib
from .bsr_spmm import bsr_spmm as _bsr_spmm
from .flash_attention import flash_attention as _flash

MODES = ("auto", "kernel", "ref")


def _mode(mode: str) -> str:
    if mode == "interpret":
        raise ValueError(
            "mode='interpret' has no meaning for a CUDA C++ kernel; use "
            "mode='ref' or run on CPU tensors for the plain version")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    return mode


def _to(device: torch.device, *xs):
    return tuple(torch.as_tensor(x).to(device) for x in xs)


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise RuntimeError(f"mode='kernel' needs CUDA tensors; {what} got "
                           f"a tensor on {t.device}")


def bsr_spmm(blocks, col_idx, row_ptr, q, *, m_blocks: int,
             max_row_nnz: int = 0, bn: int = 128, mode: str = "auto",
             device: DeviceLike = None) -> torch.Tensor:
    """Z = P @ Q, P in BSR (see kernels.ref for the format)."""
    mode = _mode(mode)
    blocks, col_idx, row_ptr, q = _to(resolve_device(device), blocks,
                                      col_idx, row_ptr, q)
    if mode == "ref":
        return ref_lib.bsr_spmm_ref(blocks, col_idx, row_ptr, q, m_blocks)
    if mode == "kernel":
        _require_cuda(q, "bsr_spmm")
    return _bsr_spmm(blocks, col_idx, row_ptr, q, m_blocks=m_blocks,
                     max_row_nnz=max_row_nnz, bn=bn)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128, mode: str = "auto",
                    device: DeviceLike = None) -> torch.Tensor:
    """Blocked causal attention [B,H,S,hd]."""
    mode = _mode(mode)
    q, k, v = _to(resolve_device(device), q, k, v)
    if mode == "ref":
        return ref_lib.flash_attention_ref(q, k, v, causal=causal)
    if mode == "kernel":
        _require_cuda(q, "flash_attention")
    return _flash(q, k, v, causal=causal, bq=bq, bk=bk)
