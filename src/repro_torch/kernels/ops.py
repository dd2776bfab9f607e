"""Kernel dispatch (counterpart of ``src/repro/kernels/ops.py``).

Each op has two implementations:

* ``cuda``  — the hand-written Hopper kernel (``csrc/*.cu``);
* ``torch`` — its plain PyTorch version, defined beside the kernel.

``impl="auto"`` picks ``cuda`` for a CUDA tensor and ``torch`` for a CPU
tensor; ``impl="cuda"`` on a CPU tensor raises.  Nothing falls back from the
kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.combine import (combine_weighted_cuda,
                                         combine_weighted_torch)
from repro_torch.kernels.decode_attention import (flash_decode_cuda,
                                                  flash_decode_torch)
from repro_torch.kernels.grouped_gemm import (grouped_gemm_cuda,
                                              grouped_gemm_torch)

IMPLS = ("auto", "cuda", "torch")


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected {IMPLS}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "torch"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{t.device}")
    return impl


def grouped_gemm(x_sorted: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """out[i] = x_sorted[i] @ w[g(i)]; rows past sum(group_sizes) are 0."""
    if _resolve(impl, x_sorted) == "cuda":
        return grouped_gemm_cuda(x_sorted, w, group_sizes)
    return grouped_gemm_torch(x_sorted, w, group_sizes)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """One-token GQA attention over a dense cache (B, S, KV, hd)."""
    if _resolve(impl, q) == "cuda":
        return flash_decode_cuda(q, k_cache, v_cache, lengths)
    return flash_decode_torch(q, k_cache, v_cache, lengths)


def combine_weighted(x: torch.Tensor, w: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    """out[t] = sum_k w[t, k] * x[t, k, :] in fp32, cast to x's dtype."""
    if _resolve(impl, x) == "cuda":
        return combine_weighted_cuda(x, w)
    return combine_weighted_torch(x, w)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launches`."""
    return dict(build.LAUNCHES)


def reset_launches() -> None:
    build.reset_launches()
