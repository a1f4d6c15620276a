"""Dense oracles for the hand-written kernels (the correctness
references), on torch tensors, and the numpy BSR helpers.

BSR format used throughout (SparseMap's compressed formats + Skip
mechanism at tile granularity):

    blocks   : [nnz, bm, bk]   values of nonzero (bm x bk) blocks of P
    col_idx  : [nnz] int32     block-column of each stored block
    row_ptr  : [m_blocks + 1]  CSR-style row pointers over block rows

A two-level structure: (Bitmask | UOP) over block rows + CP over block
columns — i.e. the B/UOP-CP hierarchy of the paper at tile granularity.

The oracles compute in the dense way with ``torch`` operators; they are
what the kernels' plain versions and the kernels are held against, and
nothing in the package calls them on its main path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


# ------------------------------------------------------------ BSR helpers


def dense_to_bsr(p: np.ndarray, bm: int, bk: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert dense [M,K] to BSR (drops all-zero blocks).  An all-zero
    matrix keeps one zero padding block with ``row_ptr`` all 0, so every
    block-row is empty and the arrays are never zero-length."""
    m, k = p.shape
    assert m % bm == 0 and k % bk == 0
    mb, kb = m // bm, k // bk
    blocks, col_idx, row_ptr = [], [], [0]
    for i in range(mb):
        for j in range(kb):
            blk = p[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk]
            if np.any(blk != 0):
                blocks.append(blk)
                col_idx.append(j)
        row_ptr.append(len(blocks))
    if not blocks:
        blocks = [np.zeros((bm, bk), p.dtype)]
        col_idx = [0]
        row_ptr = [0] * (mb + 1)
    return (np.stack(blocks).astype(p.dtype),
            np.asarray(col_idx, np.int32),
            np.asarray(row_ptr, np.int32))


def bsr_to_dense(blocks, col_idx, row_ptr, m_blocks: int, k_blocks: int
                 ) -> np.ndarray:
    bm, bk = blocks.shape[1:]
    out = np.zeros((m_blocks * bm, k_blocks * bk), blocks.dtype)
    for i in range(m_blocks):
        for jj in range(int(row_ptr[i]), int(row_ptr[i + 1])):
            j = int(col_idx[jj])
            out[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = blocks[jj]
    return out


def bsr_to_dense_torch(blocks: torch.Tensor, col_idx: torch.Tensor,
                       row_ptr: torch.Tensor, m_blocks: int, k_blocks: int
                       ) -> torch.Tensor:
    """Dense [M,K] reconstruction on the tensors' own device (one indexed
    write, no Python loop over blocks)."""
    nnz, bm, bk = blocks.shape
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    stored = int(row_ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(m_blocks, device=blocks.device), counts)
    grid = blocks.new_zeros((m_blocks, k_blocks, bm, bk))
    grid[rows, col_idx[:stored].long()] = blocks[:stored]
    return grid.permute(0, 2, 1, 3).reshape(m_blocks * bm, k_blocks * bk)


# ------------------------------------------------------------ oracles


def bsr_spmm_ref(blocks: torch.Tensor, col_idx: torch.Tensor,
                 row_ptr: torch.Tensor, q: torch.Tensor,
                 m_blocks: int) -> torch.Tensor:
    """Z = P @ Q with P in BSR.  Dense reconstruction oracle."""
    bk = blocks.shape[2]
    p = bsr_to_dense_torch(blocks, col_idx, row_ptr, m_blocks,
                           q.shape[0] // bk)
    return p @ q


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q/k/v: [B, H, S, hd] -> [B, H, S, hd]; fp32 softmax."""
    s = q.shape[2]
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def gated_block_spmm_ref(p: torch.Tensor, q: torch.Tensor,
                         block_nnz: torch.Tensor, bm: int, bk: int
                         ) -> torch.Tensor:
    """Gating oracle: blocks with nnz==0 contribute nothing (a dense
    kernel computes them anyway but predication saves energy —
    numerically identical to a dense matmul with zero blocks)."""
    return p @ q
