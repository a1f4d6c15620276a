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
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.ref import dense_to_bsr

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
