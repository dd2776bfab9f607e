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

``grouped_gemm`` has a second lowering, the reference's ``xla_dense``
(``impl="dense"``, :func:`grouped_gemm_dense`): GShard-style per-expert
capacity, rows past it dropped, one batched product.  The reference
computes it as a jnp einsum, outside any Pallas kernel, so here it is
``torch.bmm`` on every device (its own FLOP formula on ``meta``: ``2·G·cap·
K·N``) and autograd's own gradient.  The dry-run's cells run it, as the
reference's do; serving keeps the kernel.

``sample`` draws the reference's temperature sampling exactly
(:mod:`repro_torch.kernels.sampling`).
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
from repro_torch.kernels.sampling import sample_cuda, sample_torch

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


def grouped_gemm_dense(x_sorted: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor,
                       capacity: int) -> torch.Tensor:
    """The reference's ``grouped_gemm_dense``: the group-sorted rows
    scattered into (G, capacity, K), one batched product with fp32
    accumulation, gathered back; a group's rows past ``capacity`` (and the
    rows past ``sum(group_sizes)``) come out 0.  Output in x's dtype."""
    M, K = x_sorted.shape
    G, _, N = w.shape
    dev = x_sorted.device
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(M, device=dev)
    gid = torch.searchsorted(ends, rows, right=True).clamp(max=G - 1)
    pos = rows - (ends[gid] - group_sizes.to(torch.int64)[gid])
    ok = (rows < ends[-1]) & (pos < capacity)
    idx = torch.where(ok, gid * capacity + pos, G * capacity)
    # row G * capacity takes every dropped row and is cut off
    xg = x_sorted.new_zeros((G * capacity + 1, K)).index_put(
        (idx,), x_sorted)[:-1].reshape(G, capacity, K)
    if w.dtype != x_sorted.dtype:          # jnp promotes the pair
        w = w.to(torch.promote_types(x_sorted.dtype, w.dtype))
        xg = xg.to(w.dtype)
    y = torch.bmm(xg, w).reshape(G * capacity, N)
    out = torch.where(ok[:, None], y[idx.clamp(max=G * capacity - 1)], 0)
    return out.to(x_sorted.dtype)


def grouped_gemm(x_sorted: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor, *, impl: str = "auto",
                 expert_capacity: Optional[int] = None) -> torch.Tensor:
    """out[i] = x_sorted[i] @ w[g(i)]; rows past sum(group_sizes) are 0.
    ``impl="dense"``: the capacity lowering (:func:`grouped_gemm_dense`,
    ``expert_capacity`` rows a group, the reference's default if None).
    float32 rows against bfloat16 weights give float32, as
    ``lax.ragged_dot`` promotes them (no gradient: no path of the
    reference trains on such a pair)."""
    if impl == "dense":
        # the reference's default: twice the even share, rounded up to 8
        M, G = x_sorted.shape[0], w.shape[0]
        cap = expert_capacity or max(-(-(2 * M // G + 1) // 8) * 8, 8)
        return grouped_gemm_dense(x_sorted, w, group_sizes, cap)
    impl = _resolve(impl, x_sorted)
    if torch.is_grad_enabled() and (x_sorted.requires_grad
                                    or w.requires_grad):
        if x_sorted.dtype != w.dtype:
            raise TypeError(
                f"grouped_gemm: no gradient for {x_sorted.dtype} rows "
                f"against {w.dtype} weights; the backward kernels take one "
                "dtype")
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


def sample(logits: torch.Tensor, temperatures: torch.Tensor,
           keys: torch.Tensor, steps: torch.Tensor, *,
           impl: str = "auto") -> torch.Tensor:
    """The reference's ``sample_batch``: row b is greedy where
    ``temperatures[b] <= 0``, else the Gumbel-max draw of
    ``fold_in(keys[b], steps[b])`` over ``logits[b] / temperatures[b]``.
    logits (B, V) fp32, temperatures (B,) fp32, keys (B, 2) and steps (B,)
    int64 on the logits' device -> (B,) int64."""
    if _no_meta(_resolve(impl, logits), "sample") == "cuda":
        return sample_cuda(logits, temperatures, keys, steps)
    return sample_torch(logits, temperatures, keys, steps)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launches`."""
    return dict(build.LAUNCHES)


def reset_launches() -> None:
    build.reset_launches()
