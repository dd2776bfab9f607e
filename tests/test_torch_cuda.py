"""Port CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips (the CUDA kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def cuda():
    """Decided here, not at import: every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n,g", [(64, 32, 32, 4), (256, 64, 128, 16),
                                     (1280, 256, 512, 66)])
def test_grouped_gemm_cuda_vs_plain(cuda, m, k, n, g, dtype, tol, rng):
    sizes = torch.as_tensor(rng.multinomial(m - 8, np.ones(g) / g),
                            device=cuda)
    sizes[1] = 0
    x = torch.as_tensor(rng.normal(size=(m, k)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(g, k, n)) * 0.1,
                        device=cuda).to(dtype)
    out = ops.grouped_gemm(x, w, sizes, impl="cuda")
    exp = ops.grouped_gemm(x, w, sizes, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,kv,hd,s", [(2, 8, 2, 32, 64),
                                         (8, 128, 8, 64, 256)])
def test_flash_decode_cuda_vs_plain(cuda, b, h, kv, hd, s, dtype, tol, rng):
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    lengths = torch.as_tensor(rng.integers(1, 2 * s, size=b), device=cuda)
    out = ops.flash_decode(q, k, v, lengths, impl="cuda")
    exp = ops.flash_decode(q, k, v, lengths, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_combine_cuda_vs_plain(cuda, dtype, tol, rng):
    x = torch.as_tensor(rng.normal(size=(64, 8, 7168)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.random(size=(64, 8)), device=cuda).float()
    out = ops.combine_weighted(x, w, impl="cuda")
    exp = ops.combine_weighted(x, w, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
