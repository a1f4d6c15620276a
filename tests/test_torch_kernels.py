"""The plain PyTorch versions of the port's two hand-written kernels (what
the wrappers run for CPU tensors, and what the CUDA kernels are held
against on the card) versus the JAX package's Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them, and versus the JAX
``ref.py`` oracles — same seeded numpy inputs, same shapes, same
tolerances (fp32 1e-5; bf16 2e-2 for bsr_spmm, 3e-2 for flash_attention,
compared in fp32)."""
import re
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bsr_spmm import bsr_spmm as jax_bsr_spmm
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bsr_spmm as bsr_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)


def make_block_sparse(rng, m, k, bm, bk, density, dtype):
    p = rng.standard_normal((m, k)).astype(dtype)
    mask = rng.random((m // bm, k // bk)) < density
    for i in range(m // bm):
        for j in range(k // bk):
            if not mask[i, j]:
                p[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = 0
    return p


def _torch_dtype(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _jnp_dtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _bsr_inputs(m, k, n, bm, bk, density, dtype, seed_tag=""):
    rng = np.random.default_rng(
        zlib.crc32(f"{m}:{k}:{n}:{density}:{dtype}{seed_tag}".encode()))
    p = make_block_sparse(rng, m, k, bm, bk, density, np.float32)
    q = rng.standard_normal((k, n)).astype(np.float32)
    return p, q


# ------------------------------------------------------------- BSR SpMM
@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (32, 256, 128, 8, 128, 128),
    (64, 128, 256, 16, 128, 128),
    (128, 512, 128, 8, 128, 128),
])
@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_spmm_plain_vs_jax_kernel(m, k, n, bm, bk, bn, density, dtype):
    p, q = _bsr_inputs(m, k, n, bm, bk, density, dtype)
    blocks, col_idx, row_ptr = jref.dense_to_bsr(p, bm, bk)
    tb, tc, tr = tref.dense_to_bsr(p, bm, bk)
    for a, b in ((blocks, tb), (col_idx, tc), (row_ptr, tr)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    max_nnz = max(int(np.diff(row_ptr).max()), 1)
    jdt, tdt = _jnp_dtype(dtype), _torch_dtype(dtype)
    z_jax = np.asarray(jax_bsr_spmm(
        jnp.asarray(blocks, jdt), jnp.asarray(col_idx),
        jnp.asarray(row_ptr), jnp.asarray(q, jdt), m_blocks=m // bm,
        max_row_nnz=max_nnz, bn=bn, interpret=True), np.float32)
    z_jref = np.asarray(jref.bsr_spmm_ref(
        jnp.asarray(blocks, jdt), jnp.asarray(col_idx),
        jnp.asarray(row_ptr), jnp.asarray(q, jdt), m // bm), np.float32)
    args = (torch.from_numpy(blocks).to(tdt), torch.from_numpy(col_idx),
            torch.from_numpy(row_ptr), torch.from_numpy(q).to(tdt))
    z = bsr_spmm(*args, m_blocks=m // bm, max_row_nnz=max_nnz, bn=bn)
    assert z.dtype == tdt and tuple(z.shape) == (m, n)
    z_plain = bsr_spmm_plain(*args, m_blocks=m // bm)
    assert torch.equal(z, z_plain)      # a CPU tensor takes the plain path
    z_tref = tref.bsr_spmm_ref(*args, m // bm)
    z_dense = p @ q
    tol = 1e-5 if dtype == "float32" else 2e-2
    atol = tol * max(1.0, np.abs(z_dense).max())
    for other in (z_jax, z_jref, z_dense, z_tref.float().numpy()):
        np.testing.assert_allclose(z.float().numpy(), other, rtol=tol,
                                   atol=atol)


@pytest.mark.parametrize("bm,bk,bn", [(32, 32, 32), (64, 64, 64),
                                      (128, 64, 64), (16, 128, 32)])
def test_bsr_spmm_plain_hopper_block_shapes(bm, bk, bn):
    m, k, n = 2 * bm, 4 * bk, 2 * bn
    p, q = _bsr_inputs(m, k, n, bm, bk, 0.5, "float32", "h")
    blocks, col_idx, row_ptr = tref.dense_to_bsr(p, bm, bk)
    z = ops.bsr_spmm(blocks, col_idx, row_ptr, q, m_blocks=m // bm, bn=bn,
                     device="cpu")
    np.testing.assert_allclose(z.numpy(), p @ q, rtol=1e-5,
                               atol=1e-5 * np.abs(p @ q).max())
    np.testing.assert_array_equal(
        tref.bsr_to_dense(blocks, col_idx, row_ptr, m // bm, k // bk), p)
    np.testing.assert_array_equal(
        tref.bsr_to_dense_torch(torch.from_numpy(blocks),
                                torch.from_numpy(col_idx),
                                torch.from_numpy(row_ptr), m // bm,
                                k // bk).numpy(), p)


def test_bsr_spmm_empty_rows_and_all_zero():
    """Rows with zero stored blocks give exactly zero output rows; the
    all-zero matrix keeps the reference's effective BSR (one zero block,
    row_ptr all 0)."""
    rng = np.random.default_rng(1)
    m, k, n, bm, bk = 32, 256, 128, 8, 128
    p = make_block_sparse(rng, m, k, bm, bk, 0.5, np.float32)
    p[0:bm] = 0
    q = rng.standard_normal((k, n)).astype(np.float32)
    blocks, col_idx, row_ptr = tref.dense_to_bsr(p, bm, bk)
    z = ops.bsr_spmm(blocks, col_idx, row_ptr, q, m_blocks=m // bm,
                     device="cpu").numpy()
    assert np.abs(z[0:bm]).max() == 0.0
    np.testing.assert_allclose(z, p @ q, rtol=1e-5, atol=1e-4)

    zero = np.zeros((m, k), np.float32)
    for a, b in zip(jref.dense_to_bsr(zero, bm, bk),
                    tref.dense_to_bsr(zero, bm, bk)):
        np.testing.assert_array_equal(a, b)
    blocks, col_idx, row_ptr = tref.dense_to_bsr(zero, bm, bk)
    assert blocks.shape == (1, bm, bk) and not row_ptr.any()
    z = ops.bsr_spmm(blocks, col_idx, row_ptr, q, m_blocks=m // bm,
                     device="cpu")
    assert tuple(z.shape) == (m, n) and float(z.abs().max()) == 0.0


def test_bsr_spmm_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(2)
    p = make_block_sparse(rng, 32, 256, 8, 128, 0.5, np.float32)
    q = rng.standard_normal((256, 128)).astype(np.float32)
    b, c, r = (torch.from_numpy(a) for a in tref.dense_to_bsr(p, 8, 128))
    tq = torch.from_numpy(q)
    with pytest.raises(ValueError):                 # N % bn
        bsr_spmm(b, c, r, tq[:, :96].contiguous(), m_blocks=4, bn=64)
    with pytest.raises(ValueError):                 # index dtype
        bsr_spmm(b, c.long(), r, tq, m_blocks=4)
    with pytest.raises(ValueError):                 # mixed dtypes
        bsr_spmm(b.bfloat16(), c, r, tq, m_blocks=4)
    with pytest.raises(ValueError):                 # float64
        bsr_spmm(b.double(), c, r, tq.double(), m_blocks=4)
    with pytest.raises(ValueError):                 # non-contiguous
        bsr_spmm(b, c, r, tq.t().contiguous().t(), m_blocks=4)
    with pytest.raises(ValueError):                 # row_ptr length
        bsr_spmm(b, c, r, tq, m_blocks=5)
    with pytest.raises(ValueError):                 # unsupported bm
        b12 = torch.zeros(1, 12, 128)
        bsr_spmm(b12, c[:1], r[:2], tq[:128].contiguous(), m_blocks=1)


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("s,bq,bk", [(256, 128, 128), (512, 128, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_vs_jax_kernel(s, bq, bk, causal, dtype):
    hd = 128
    rng = np.random.default_rng(
        zlib.crc32(f"{s}:{bq}:{causal}:{dtype}".encode()))
    qn = (rng.standard_normal((1, 2, s, hd)) * 0.3).astype(np.float32)
    kn = (rng.standard_normal((1, 2, s, hd)) * 0.3).astype(np.float32)
    vn = rng.standard_normal((1, 2, s, hd)).astype(np.float32)
    jdt, tdt = _jnp_dtype(dtype), _torch_dtype(dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (qn, kn, vn))
    o_jax = np.asarray(jax_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                 interpret=True), np.float32)
    o_jref = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal),
                        np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (qn, kn, vn))
    o = flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert o.dtype == tdt and o.shape == tq.shape
    assert torch.equal(o, flash_attention_plain(tq, tk, tv, causal=causal))
    o_tref = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for other in (o_jax, o_jref, o_tref.float().numpy()):
        np.testing.assert_allclose(o.float().numpy(), other, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_first_row_causal_and_tile_independence(hd):
    """Causal row 0 attends only to itself -> output == v[0]; and the
    plain version's answer does not depend on its tile."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((1, 1, 256, hd)).astype(np.float32))
        for _ in range(3))
    o = ops.flash_attention(q, k, v, causal=True, device="cpu")
    np.testing.assert_allclose(o[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               rtol=1e-5)
    o128 = flash_attention_plain(q, k, v, causal=True, tile=128)
    np.testing.assert_allclose(o.numpy(), o128.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 1, 256, 128)
    with pytest.raises(ValueError):                 # S % bq
        flash_attention(q, q, q, bq=96)
    with pytest.raises(ValueError):                 # S % 64
        x = torch.zeros(1, 1, 96, 128)
        flash_attention(x, x, x, bq=32, bk=32)
    with pytest.raises(ValueError):                 # hd
        x = torch.zeros(1, 1, 256, 96)
        flash_attention(x, x, x)
    with pytest.raises(ValueError):                 # dtype
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                 # shapes
        flash_attention(q, q[:, :, :128], q)
    with pytest.raises(ValueError):                 # non-contiguous
        x = torch.zeros(1, 256, 2, 128).transpose(1, 2)
        flash_attention(x, x, x)


# ------------------------------------------------------------- dispatch
def test_ops_dispatch_on_cpu_tensors():
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((1, 1, 256, 128)) * 0.3).astype(np.float32)
    auto = ops.flash_attention(q, q, q, causal=True, device="cpu")
    ref = ops.flash_attention(q, q, q, causal=True, mode="ref",
                              device="cpu")
    jr = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(q),
                                             jnp.asarray(q), causal=True))
    assert auto.device.type == "cpu"
    np.testing.assert_allclose(auto.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(auto.numpy(), jr, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError):
        ops.flash_attention(q, q, q, mode="kernel", device="cpu")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, mode="interpret", device="cpu")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, mode="fast", device="cpu")

    p = make_block_sparse(rng, 32, 256, 8, 128, 0.5, np.float32)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    b, c, r = tref.dense_to_bsr(p, 8, 128)
    for mode in ("auto", "ref"):
        z = ops.bsr_spmm(b, c, r, x, m_blocks=4, mode=mode, device="cpu")
        np.testing.assert_allclose(z.numpy(), p @ x, rtol=1e-5, atol=1e-4)
    with pytest.raises(RuntimeError):
        ops.bsr_spmm(b, c, r, x, m_blocks=4, mode="kernel", device="cpu")
    with pytest.raises(ValueError):
        ops.bsr_spmm(b, c, r, x, m_blocks=4, mode="interpret", device="cpu")
    g = torch.from_numpy(p)
    np.testing.assert_array_equal(
        tref.gated_block_spmm_ref(g, torch.from_numpy(x), None, 8,
                                  128).numpy(), (g @ torch.from_numpy(x)
                                                 ).numpy())


def test_launch_counters_count_only_kernel_launches():
    """On CPU tensors the wrappers take the plain version: no launch."""
    q = torch.zeros(1, 1, 64, 64)
    b0, f0 = bsr_spmm.launches, flash_attention.launches
    flash_attention(q, q, q, bq=64, bk=64)
    bsr_spmm(torch.zeros(1, 8, 32), torch.zeros(1, dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32), torch.zeros(32, 32),
             m_blocks=1, bn=32)
    assert (bsr_spmm.launches, flash_attention.launches) == (b0, f0)
    assert isinstance(bsr_spmm.launches, int)


def test_importing_the_kernels_needs_neither_nvcc_nor_a_gpu():
    """The package, the build helper and both wrappers import with no
    compiler and no device; nothing is built until a kernel launches."""
    import shutil

    from repro_torch.kernels import _build
    assert "triton" not in sys.modules
    assert [p.name for p in _build.sources()] == ["bsr_spmm.cu",
                                                  "flash_attention.cu"]
    assert len(_build.source_hash()) == 16
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        assert not _build._LIBS


# ---------------------------------------------------------------- routes
# The wrappers pick each kernel's route and tile from dtype and shape alone
# (bsr_plan, flash_plan); these tests hold that choice, and the set of
# shapes the wrappers accept, which is the set the first CUDA kernels took.
DTYPE_GRID = (torch.float32, torch.bfloat16, torch.float16)


def _accepts(check, *args) -> bool:
    try:
        check(*args)
    except ValueError:
        return False
    return True


def _bsr_taken_before(dtype, bm, bk, n, bn) -> bool:
    return (dtype in (torch.float32, torch.bfloat16)
            and bm in (8, 16, 32, 64, 128) and bk in (32, 64, 128)
            and n % 32 == 0 and n % bn == 0)


def _bsr_expected(dtype, bm, n):
    if dtype == torch.bfloat16 and bm >= 64:
        return "wgmma", next(t for t in (256, 128, 64, 32) if n % t == 0)
    route = "wmma" if dtype == torch.bfloat16 and bm >= 16 else "fma"
    return route, 64 if n % 64 == 0 else 32


@pytest.mark.parametrize("bm", [4, 8, 12, 16, 32, 48, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", DTYPE_GRID)
def test_bsr_route_and_accepted_shapes(dtype, bm):
    idx = torch.zeros(1, dtype=torch.int32)
    ptr = torch.tensor([0, 1], dtype=torch.int32)
    for bk in (16, 32, 48, 64, 128, 256):
        blocks = torch.empty((1, bm, bk), dtype=dtype)
        for n in list(range(16, 1040, 16)) + [4096]:
            q = torch.empty((bk, n), dtype=dtype)
            for bn in (32, 128):
                ok = _accepts(bsr_mod._check, blocks, idx, ptr, q, 1, bn)
                assert ok == _bsr_taken_before(dtype, bm, bk, n, bn), \
                    (bk, n, bn)
            if _bsr_taken_before(dtype, bm, bk, n, 32):
                plan = bsr_mod.bsr_plan(dtype, bm, bk, n)
                assert (plan.route, plan.bn) == _bsr_expected(dtype, bm, n)
                assert plan.rows_fastest == (plan.route != "wgmma"
                                             or bm == 64)
                assert n % plan.bn == 0


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", DTYPE_GRID)
def test_flash_route_and_accepted_shapes(dtype, hd):
    for s in list(range(32, 1056, 32)) + [4096]:
        x = torch.empty((1, 1, s, hd), dtype=dtype)
        for bq, bk in ((64, 64), (128, 128), (64, 128)):
            ok = _accepts(flash_mod._check, x, x, x, bq, bk)
            assert ok == (dtype in (torch.float32, torch.bfloat16)
                          and hd in (64, 128) and s % 64 == 0
                          and s % bq == 0 and s % bk == 0), (s, bq, bk)
        if dtype in (torch.float32, torch.bfloat16) and hd in (64, 128) \
                and s % 64 == 0:
            assert flash_mod.flash_plan(dtype, s, hd) == (
                ("wgmma", 128) if dtype == torch.bfloat16 else ("fma", 64))


def test_route_numbers_match_the_cuda_sources():
    """Both C entry points number the routes as the wrappers do."""
    for src in _build.sources():
        enum = re.search(r"enum \{ (ROUTE_FMA = \d+, ROUTE_WMMA = \d+, "
                         r"ROUTE_WGMMA = \d+) \};", src.read_text())
        assert enum, src.name
        got = {k.split("_", 1)[1].lower(): int(v) for k, v in
               (kv.split(" = ") for kv in enum.group(1).split(", "))}
        assert got == _build.ROUTES, src.name


def test_plain_flash_uses_the_routes_tile():
    """bf16 tiles of 128 rows and keys: the plain version follows the
    kernel, and S = 192 (half a tile) works."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 192, 64)) * sc
                                ).to(torch.bfloat16) for sc in (0.3, 0.3, 1.0))
    for causal in (True, False):
        o = flash_attention(q, k, v, causal=causal, bq=64, bk=64)
        assert torch.equal(o, flash_attention_plain(q, k, v, causal=causal,
                                                    tile=128))
        o32 = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal)
        np.testing.assert_allclose(o.float().numpy(), o32.numpy(), rtol=3e-2,
                                   atol=3e-2)
