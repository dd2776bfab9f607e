"""Kernel dispatch (counterpart of ``src/repro/kernels/ops.py``).

Each op has two implementations:

* ``cuda``  — the hand-written Hopper kernel (``csrc/*.cu``);
* ``torch`` — its plain PyTorch version, defined beside the kernel.

``impl="auto"`` picks ``cuda`` for a CUDA tensor and ``torch`` for a CPU
tensor; ``impl="cuda"`` on a CPU tensor raises.  Nothing falls back from the
kernel to the plain version.  On ``meta`` tensors (the dry-run's
accounting) ``auto`` is the ``meta`` route (:mod:`repro_torch.kernels.meta`):
an empty output of the kernel's shape, counted by the kernel's own work;
the paged decode and ``combine_weighted`` have none and raise there.

Under grad mode with an input that requires grad, ``grouped_gemm`` and
``combine_slots`` run through their autograd Functions
(:mod:`repro_torch.kernels.autograd`: the backward kernels on the card,
their plain versions on the CPU); the decode kernels have no backward and
their CUDA wrappers raise there.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autograd, build, meta
from repro_torch.kernels.combine import (combine_slots_cuda,
                                         combine_slots_torch,
                                         combine_weighted_cuda,
                                         combine_weighted_torch)
from repro_torch.kernels.decode_attention import (
    flash_decode_cuda, flash_decode_partial_cuda, flash_decode_partial_torch,
    flash_decode_torch, paged_flash_decode_cuda, paged_flash_decode_torch)
from repro_torch.kernels.grouped_gemm import (grouped_gemm_cuda,
                                              grouped_gemm_torch)

IMPLS = ("auto", "cuda", "torch", "meta")


def _resolve(impl: str, t: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected {IMPLS}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "meta" if t.is_meta else "torch"
    if impl == "meta" and not t.is_meta:
        raise ValueError("impl='meta' needs meta tensors; got a tensor on "
                         f"{t.device}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{t.device}")
    return impl


def _no_meta(impl: str, name: str) -> str:
    if impl == "meta":
        raise NotImplementedError(f"{name} has no meta route")
    return impl


def grouped_gemm(x_sorted: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor, *,
                 impl: str = "auto") -> torch.Tensor:
    """out[i] = x_sorted[i] @ w[g(i)]; rows past sum(group_sizes) are 0."""
    impl = _resolve(impl, x_sorted)
    if torch.is_grad_enabled() and (x_sorted.requires_grad
                                    or w.requires_grad):
        return autograd.GroupedGemm.apply(x_sorted, w, group_sizes, impl,
                                          autograd.grad_target(w))
    if impl == "cuda":
        return grouped_gemm_cuda(x_sorted, w, group_sizes)
    if impl == "meta":
        return meta.grouped_gemm(x_sorted, w, group_sizes)
    return grouped_gemm_torch(x_sorted, w, group_sizes)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 softcap: float = 0.0, impl: str = "auto") -> torch.Tensor:
    """One-token GQA attention over a dense cache (B, S, KV, hd); a
    ``softcap > 0`` caps the scaled scores (0 = off)."""
    impl = _resolve(impl, q)
    if impl == "cuda":
        return flash_decode_cuda(q, k_cache, v_cache, lengths, softcap)
    if impl == "meta":
        return meta.flash_decode(q, k_cache, v_cache, lengths)
    return flash_decode_torch(q, k_cache, v_cache, lengths, softcap)


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         softcap: float = 0.0, impl: str = "auto"):
    """The open softmax of one-token GQA attention over a dense cache
    (shard): (acc (B, H, hd), m (B, H), l (B, H)) in fp32."""
    impl = _resolve(impl, q)
    if impl == "cuda":
        return flash_decode_partial_cuda(q, k_cache, v_cache, lengths,
                                         softcap)
    if impl == "meta":
        return meta.flash_decode_partial(q, k_cache, v_cache, lengths)
    return flash_decode_partial_torch(q, k_cache, v_cache, lengths, softcap)


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, softcap: float = 0.0,
                       impl: str = "auto") -> torch.Tensor:
    """One-token GQA attention over a block pool (num_blocks, bs, KV, hd)
    addressed through block tables (B, max_blocks)."""
    impl = _no_meta(_resolve(impl, q), "paged_flash_decode")
    if impl == "cuda":
        return paged_flash_decode_cuda(q, k_pool, v_pool, block_tables,
                                       lengths, softcap)
    return paged_flash_decode_torch(q, k_pool, v_pool, block_tables, lengths,
                                    softcap)


def combine_weighted(x: torch.Tensor, w: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    """out[t] = sum_k w[t, k] * x[t, k, :] in fp32, cast to x's dtype."""
    if _no_meta(_resolve(impl, x), "combine_weighted") == "cuda":
        return combine_weighted_cuda(x, w)
    return combine_weighted_torch(x, w)


def combine_slots(responses, combine_slot: torch.Tensor, *,
                  addend: Optional[torch.Tensor] = None,
                  impl: str = "auto") -> torch.Tensor:
    """The expert servers' responses (one (S, C, d) tensor or S (C, d)
    buffers) combined per token: the rows that ``combine_slot (T, k)``
    names (flat ``s*C + c``, -1 = dropped) summed in fp32, cast to their
    dtype, plus ``addend (T, d)`` if given."""
    bufs = ([responses] if isinstance(responses, torch.Tensor)
            else list(responses))
    impl = _resolve(impl, bufs[0])
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*bufs, addend)):
        return autograd.CombineSlots.apply(impl, combine_slot, addend,
                                           *bufs)
    if impl == "cuda":
        return combine_slots_cuda(responses, combine_slot, addend)
    if impl == "meta":
        return meta.combine_slots(bufs, combine_slot, addend)
    return combine_slots_torch(responses, combine_slot, addend)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launches`."""
    return dict(build.LAUNCHES)


def reset_launches() -> None:
    build.reset_launches()
