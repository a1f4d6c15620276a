"""Block-sparse-row SpMM — SparseMap's Skip mechanism on the GPU.

SparseMap's *Skip P->compute* locates the next effectual operand via the
leader's metadata and bypasses zero work (paper Fig. 6/14).  At tile
granularity that is **block compaction**: the sparse operand is stored as
compacted nonzero (bm x bk) blocks (BSR = UOP over block rows + CP over
block columns), and only effectual blocks are ever fetched and multiplied
— the skip saves both energy AND cycles, exactly the paper's distinction
from gating.

Source note.  :func:`bsr_spmm` launches the hand-written CUDA kernels of
``csrc/bsr_spmm.cu`` (``repro_bsr_spmm``), which replace the TPU kernel
``_kernel`` / ``bsr_spmm`` of the JAX package's ``kernels/bsr_spmm.py``.
What bounds it on the H100 depends on the block density: every stored
block costs ``2*bm*bk*N`` operations, while Q is read and Z written once
whatever the density — in bf16 at a block density of 0.1 (4096^3, 64x64
blocks) the bytes of Q and Z already outweigh the tensor cores' time for
the products, and denser P tips it to operations.  The design: one thread
block per output tile that loops over exactly the stored blocks of its
block-row (no predicated steps, no index clamping), fp32 accumulators in
registers, each output element stored once — so P's stored blocks, Q's
touched slabs and Z are all that moves.  :func:`bsr_plan` picks the route
and column tile from dtype and shape alone: bf16 with ``bm >= 64`` takes
``"wgmma"`` (a producer warp streams each stored block and its Q slab by
TMA into a multi-stage ring, ``bm / 64`` warpgroups multiply with
``wgmma`` on column tiles of up to 256); bf16 with ``bm`` 16 or 32 takes
``"wmma"`` (16x16x16 fragments); fp32, and bf16 blocks of 8 rows, take
``"fma"`` (FMA arithmetic in full fp32).  PERF.md has the times.

Numerics differ from the TPU kernel on purpose: that kernel adds each
step's product into the output tile *in the output type*; this one
accumulates in fp32 and rounds once.  :func:`bsr_spmm_plain` does what
the CUDA kernels do.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

BM_CHOICES = (8, 16, 32, 64, 128)
BK_CHOICES = (32, 64, 128)
N_MULTIPLE = 32       # N must be a multiple of this (the narrowest tile)
DTYPES = (torch.float32, torch.bfloat16)


class BsrPlan(NamedTuple):
    route: str                  # a key of _build.ROUTES
    bn: int                     # column tile of a thread block
    rows_fastest: bool = True   # wgmma: issue blocks block-row fastest


def bsr_plan(dtype: torch.dtype, bm: int, bk: int, n: int) -> BsrPlan:
    """The kernel route and column tile for a shape that :func:`_check`
    accepted: the widest tile that divides ``n`` among the route's.  The
    wgmma route issues 64-row blocks block-row fastest, so that the blocks
    running at once share their slabs of Q in L2, and 128-row blocks
    column tile fastest, which measured a few per cent faster for them
    (PERF.md).  ``bk`` does not change the choice."""
    if dtype == torch.bfloat16 and bm >= 64:
        n_tile = next(t for t in (256, 128, 64, 32) if n % t == 0)
        return BsrPlan("wgmma", n_tile, rows_fastest=bm == 64)
    route = "wmma" if dtype == torch.bfloat16 and bm >= 16 else "fma"
    return BsrPlan(route, 64 if n % 64 == 0 else 32)


def bsr_spmm_plain(blocks: torch.Tensor, col_idx: torch.Tensor,
                   row_ptr: torch.Tensor, q: torch.Tensor, *,
                   m_blocks: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a loop over the stored
    blocks, each multiplied by its bk-row slab of ``q`` in fp32 and added
    into an fp32 output, rounded to ``q.dtype`` once at the end.  Empty
    block-rows stay exactly zero."""
    nnz, bm, bk = blocks.shape
    n = q.shape[1]
    acc = torch.zeros((m_blocks, bm, n), dtype=torch.float32,
                      device=q.device)
    qf = q.float().reshape(q.shape[0] // bk, bk, n)
    bf = blocks.float()
    rp = row_ptr.tolist()
    cols = col_idx.tolist()
    for i in range(m_blocks):
        for s in range(rp[i], rp[i + 1]):
            acc[i] += bf[s] @ qf[cols[s]]
    return acc.reshape(m_blocks * bm, n).to(q.dtype)


def _check(blocks, col_idx, row_ptr, q, m_blocks: int, bn: int) -> None:
    if blocks.dim() != 3 or q.dim() != 2:
        raise ValueError("blocks must be [nnz, bm, bk] and q [K, N]")
    nnz, bm, bk = blocks.shape
    kdim, n = q.shape
    if blocks.dtype not in DTYPES or q.dtype != blocks.dtype:
        raise ValueError(f"blocks and q must share a dtype in {DTYPES}; "
                         f"got {blocks.dtype} and {q.dtype}")
    if col_idx.dtype != torch.int32 or row_ptr.dtype != torch.int32:
        raise ValueError("col_idx and row_ptr must be int32")
    if col_idx.shape != (nnz,) or row_ptr.shape != (m_blocks + 1,):
        raise ValueError(
            f"col_idx must be [{nnz}] and row_ptr [{m_blocks + 1}]; got "
            f"{tuple(col_idx.shape)} and {tuple(row_ptr.shape)}")
    if bm not in BM_CHOICES or bk not in BK_CHOICES:
        raise ValueError(
            f"unsupported block shape bm={bm}, bk={bk}: need bm in "
            f"{BM_CHOICES}, bk in {BK_CHOICES}")
    if nnz < 1 or m_blocks < 1 or kdim % bk != 0:
        raise ValueError(f"need nnz >= 1 and K={kdim} divisible by bk={bk}")
    if bn <= 0 or n % bn != 0 or n % N_MULTIPLE != 0:
        raise ValueError(f"N={n} must be divisible by bn={bn} and by "
                         f"{N_MULTIPLE}")
    devs = {t.device for t in (blocks, col_idx, row_ptr, q)}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device; got {devs}")
    for name, t in (("blocks", blocks), ("col_idx", col_idx),
                    ("row_ptr", row_ptr), ("q", q)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = _build.load("bsr_spmm")
    fn = lib.repro_bsr_spmm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def bsr_spmm(blocks: torch.Tensor, col_idx: torch.Tensor,
             row_ptr: torch.Tensor, q: torch.Tensor, *,
             m_blocks: int, max_row_nnz: int = 0, bn: int = 128,
             plan: BsrPlan | None = None) -> torch.Tensor:
    """Z[M,N] = P[M,K] @ Q[K,N] with P in BSR.

    blocks: [nnz, bm, bk]; col_idx: [nnz] int32; row_ptr: [m_blocks+1]
    int32; q: [K, N]; fp32 or bf16, output in ``q.dtype``.  ``bn`` is kept
    from the reference's signature with its requirement ``N % bn == 0``;
    the kernel's column tile is :func:`bsr_plan`'s, so ``N`` must also be
    a multiple of 32.  ``max_row_nnz`` is accepted for the callers that
    pass it and is not needed: a block loops over its own row.  ``plan``
    overrides :func:`bsr_plan` (to measure another tile or grid order);
    a route the kernels do not have for the shape raises.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    :func:`bsr_spmm_plain`.  ``col_idx`` entries are trusted to lie in
    ``[0, K / bk)`` — checking them would cost a device synchronisation.
    """
    _check(blocks, col_idx, row_ptr, q, m_blocks, bn)
    if not q.is_cuda:
        return bsr_spmm_plain(blocks, col_idx, row_ptr, q,
                              m_blocks=m_blocks)
    nnz, bm, bk = blocks.shape
    kdim, n = q.shape
    if plan is None:
        plan = bsr_plan(q.dtype, bm, bk, n)
    if blocks.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("blocks and q must start on a 16-byte boundary")
    z = torch.empty((m_blocks * bm, n), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device.index):
        # the raw handle of PyTorch's current stream (what Triton's
        # launcher reads): a Stream object costs more than the launch
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        err = lib.repro_bsr_spmm(
            blocks.data_ptr(), col_idx.data_ptr(), row_ptr.data_ptr(),
            q.data_ptr(), z.data_ptr(), nnz, m_blocks, n, kdim, bm, bk,
            int(q.dtype == torch.bfloat16), _build.ROUTES[plan.route], plan.bn,
            int(plan.rows_fastest), stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel ({plan.route}, bn={plan.bn}) "
                           f"launch failed (code {err})")
    bsr_spmm.launches += 1
    return z


#: launches of the CUDA kernel by this wrapper (plain integer)
bsr_spmm.launches = 0
