"""The port's CUDA kernels against their plain PyTorch versions ON THE
CARD.  Every test here needs a CUDA device and nvcc, carries the ``gpu``
marker and skips where there is none; run them on a machine with a GPU
with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py``.
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmm import (BsrPlan, bsr_plan, bsr_spmm,
                                          bsr_spmm_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_plan)
from repro_torch.kernels.ref import dense_to_bsr
from repro_torch.models.attention import attention

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_block_sparse(rng, m, k, bm, bk, density):
    p = rng.standard_normal((m, k)).astype(np.float32)
    mask = rng.random((m // bm, k // bk)) < density
    p = p.reshape(m // bm, bm, k // bk, bk) * mask[:, None, :, None]
    return np.ascontiguousarray(p.reshape(m, k), np.float32)


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (32, 256, 128, 8, 128, 128),
    (64, 128, 256, 16, 128, 128),
    (128, 512, 128, 8, 128, 128),
    (256, 256, 64, 32, 32, 32),
    (256, 512, 128, 64, 64, 64),
    (256, 512, 256, 128, 64, 128),
])
@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_spmm_kernel_matches_plain(cuda, m, k, n, bm, bk, bn, density,
                                       dtype):
    rng = np.random.default_rng(
        zlib.crc32(f"{m}:{k}:{n}:{density}:{dtype}".encode()))
    p = make_block_sparse(rng, m, k, bm, bk, density)
    p[0:bm] = 0                                   # an empty block-row
    q = rng.standard_normal((k, n)).astype(np.float32)
    blocks, col_idx, row_ptr = dense_to_bsr(p, bm, bk)
    args = (torch.as_tensor(blocks).to(cuda, dtype),
            torch.as_tensor(col_idx).to(cuda),
            torch.as_tensor(row_ptr).to(cuda),
            torch.as_tensor(q).to(cuda, dtype))
    before = bsr_spmm.launches
    z = bsr_spmm(*args, m_blocks=m // bm, bn=bn)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1
    zp = bsr_spmm_plain(*args, m_blocks=m // bm)
    assert z.dtype == dtype and z.shape == (m, n)
    assert float(z[0:bm].float().abs().max()) == 0.0
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    z_ref = p @ q
    np.testing.assert_allclose(
        z.float().cpu().numpy(), z_ref, rtol=tol,
        atol=tol * max(1.0, np.abs(z_ref).max()))
    np.testing.assert_allclose(
        z.float().cpu().numpy(), zp.float().cpu().numpy(), rtol=tol,
        atol=tol * max(1.0, np.abs(z_ref).max()))


# Where outputs are large sums or small averages, the bf16 limit follows the
# values, as in chip_smoke.py: |a - b| <= 0.05 * rms(b) + 2**-6 * |b|.
def assert_scaled_close(a, b):
    a, b = a.float(), b.float()
    atol = 0.05 * float(b.pow(2).mean().sqrt())
    share = float(((a - b).abs() / (atol + 2.0 ** -6 * b.abs())).max())
    assert atol > 0 and share <= 1.0, f"error is {share:.3g} of the limit"


REPEATS = 3   # each edge case runs this often: a missing fence shows rarely


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("bk", [32, 64, 128])
@pytest.mark.parametrize("n", [64, 96, 256, 512])
def test_bsr_spmm_wgmma_edges(cuda, bm, bk, n):
    """An empty block-row, a fully dense one (16 stored blocks: the ring
    wraps several times) and a half-full one, on every column tile."""
    assert bsr_plan(torch.bfloat16, bm, bk, n).route == "wgmma"
    rng = np.random.default_rng(zlib.crc32(f"edge:{bm}:{bk}:{n}".encode()))
    m, k = 3 * bm, 16 * bk
    p = make_block_sparse(rng, m, k, bm, bk, 0.5)
    p[0:bm] = 0
    p[bm:2 * bm] = rng.standard_normal((bm, k))
    q = rng.standard_normal((k, n)).astype(np.float32)
    blocks, col_idx, row_ptr = dense_to_bsr(p, bm, bk)
    args = (torch.as_tensor(blocks).to(cuda, torch.bfloat16),
            torch.as_tensor(col_idx).to(cuda),
            torch.as_tensor(row_ptr).to(cuda),
            torch.as_tensor(q).to(cuda, torch.bfloat16))
    zp = bsr_spmm_plain(*args, m_blocks=3)
    z_ref = torch.as_tensor(p).bfloat16().float().to(cuda) @ args[3].float()
    for _ in range(REPEATS):
        z = bsr_spmm(*args, m_blocks=3, bn=32)
        torch.cuda.synchronize()
        assert float(z[0:bm].float().abs().max()) == 0.0
        assert_scaled_close(z, zp)
        assert_scaled_close(z, z_ref)


def test_bsr_spmm_grid_orders_agree(cuda):
    rng = np.random.default_rng(7)
    p = make_block_sparse(rng, 512, 1024, 64, 64, 0.3)
    q = rng.standard_normal((1024, 512)).astype(np.float32)
    blocks, col_idx, row_ptr = dense_to_bsr(p, 64, 64)
    args = (torch.as_tensor(blocks).to(cuda, torch.bfloat16),
            torch.as_tensor(col_idx).to(cuda),
            torch.as_tensor(row_ptr).to(cuda),
            torch.as_tensor(q).to(cuda, torch.bfloat16))
    a = bsr_spmm(*args, m_blocks=8)
    assert bsr_plan(torch.bfloat16, 64, 64, 512).rows_fastest
    b = bsr_spmm(*args, m_blocks=8, plan=BsrPlan("wgmma", 256, False))
    assert torch.equal(a, b)
    with pytest.raises(RuntimeError):          # no wgmma kernel for bm = 64
        bsr_spmm(*args, m_blocks=8, plan=BsrPlan("wmma", 64))


@pytest.mark.parametrize("bm", [8, 64, 128])
def test_bsr_spmm_all_zero_bf16(cuda, bm):
    blocks, col_idx, row_ptr = dense_to_bsr(
        np.zeros((2 * bm, 256), np.float32), bm, 128)
    q = torch.randn(256, 256, device=cuda, dtype=torch.bfloat16)
    for _ in range(REPEATS):
        z = ops.bsr_spmm(torch.as_tensor(blocks).bfloat16(), col_idx,
                         row_ptr, q, m_blocks=2, bn=32, mode="kernel")
        torch.cuda.synchronize()
        assert z.dtype == torch.bfloat16 and float(z.abs().max()) == 0.0


def test_bsr_spmm_all_zero(cuda):
    blocks, col_idx, row_ptr = dense_to_bsr(
        np.zeros((32, 256), np.float32), 8, 128)
    q = torch.randn(256, 128, device=cuda)
    z = ops.bsr_spmm(blocks, col_idx, row_ptr, q, m_blocks=4, mode="kernel")
    assert float(z.abs().max()) == 0.0


@pytest.mark.parametrize("s,hd", [(256, 128), (512, 128), (256, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, s, hd, causal, dtype):
    rng = np.random.default_rng(
        zlib.crc32(f"{s}:{hd}:{causal}:{dtype}".encode()))
    q, k, v = (torch.as_tensor(
        rng.standard_normal((1, 2, s, hd)).astype(np.float32) * sc
    ).to(cuda, dtype) for sc in (0.3, 0.3, 1.0))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    op = flash_attention_plain(q, k, v, causal=causal)
    o32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for other in (op, o32):
        np.testing.assert_allclose(o.float().cpu().numpy(),
                                   other.float().cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,s", [(1, 2, 192), (1, 2, 384), (1, 2, 4096)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_wgmma_edges(cuda, b, h, s, hd, causal):
    """Half a query tile (192, 384) and the long sequence, bf16."""
    assert flash_plan(torch.bfloat16, s, hd).route == "wgmma"
    gen = torch.Generator(device="cpu").manual_seed(s * hd + causal)
    q, k, v = ((torch.randn((b, h, s, hd), generator=gen) * sc
                ).to(cuda, torch.bfloat16) for sc in (0.3, 0.3, 1.0))
    op = flash_attention_plain(q, k, v, causal=causal)
    o32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    for _ in range(REPEATS):
        o = flash_attention(q, k, v, causal=causal, bq=64, bk=64)
        torch.cuda.synchronize()
        assert_scaled_close(o, op)
        assert_scaled_close(o, o32)


def test_flash_first_row_causal(cuda):
    q, k, v = (torch.randn(1, 1, 256, 128, device=cuda) for _ in range(3))
    o = ops.flash_attention(q, k, v, causal=True, mode="kernel")
    np.testing.assert_allclose(o[0, 0, 0].cpu().numpy(),
                               v[0, 0, 0].cpu().numpy(), rtol=1e-5)


def test_evaluator_cuda_matches_cpu(cuda):
    from repro_torch.configs.paper_workloads import by_name
    from repro_torch.core.encoding import GenomeSpec
    from repro_torch.core.torch_cost import TorchCostModel
    for name in ("conv4", "mm9"):
        spec = GenomeSpec(by_name(name))
        g = spec.random_genomes(np.random.default_rng(0), 4096)
        a = TorchCostModel(spec, "cloud", device=cuda)(g)
        b = TorchCostModel(spec, "cloud", device="cpu")(g)
        both = a["valid"] & b["valid"]
        assert (a["valid"] != b["valid"]).mean() < 5e-3
        lg = b["log10_edp"][both]
        assert np.all(np.abs(a["log10_edp"][both] - lg)
                      <= 2e-3 * np.maximum(np.abs(lg), 1))


def test_gradients_through_attention_on_cuda_equal_the_chunked_route(cuda):
    """On the card, a model's attention under autograd keeps its gradient
    (route chunked, the kernel not launched): the gradients of q, k and v
    are nonzero and equal the same computation on the CPU.  Tolerance:
    fp32, ``1e-4`` of each gradient's largest element (cuBLAS and the CPU
    sum in different orders)."""
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((1, 256, 8, 128), (1, 256, 2, 128), (1, 256, 2, 128)))
    w = rng.standard_normal((1, 256, 8, 128)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True)
              for a in (q, k, v)]
        before = flash_attention.launches
        attention.calls.update(flash=0, chunked=0)
        out = attention(*ts, causal=True)
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        assert attention.calls == {"flash": 0, "chunked": 1}
        assert flash_attention.launches == before
        grads[str(dev)] = [t.grad.cpu() for t in ts]
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
