"""Gradients of the training path's kernels, and views of stacked
parameters whose gradients go straight into the stacked leaf.

* :class:`GroupedGemm` — forward: the grouped GEMM kernel (CUDA) or its
  plain version (CPU); backward: ``dx[i] = dy[i] @ w[g(i)]^T`` and
  ``dw[g] = x_g^T @ dy_g`` (``grouped_gemm_dx`` / ``grouped_gemm_dw``,
  ``csrc/grouped_gemm_bwd.cu``, or their plain versions).  Rows past
  ``sum(group_sizes)`` get zero dx and add nothing to dw; an empty group
  gets ``dw[g] = 0``; dw is accumulated in fp32 and written in w's dtype.
  The VJP of the reference's ``lax.ragged_dot`` path
  (``src/repro/kernels/ops.py:95``, the trainer's ``gemm_impl``).
* :class:`CombineSlots` — forward: ``ops.combine_slots``; backward: dy
  written into every kept slot's response row and dy as the addend's
  gradient.  Each slot is named by at most one ``(t, j)``, so the scatter
  needs no atomics: plain indexing on both devices (the transpose of the
  reference's gather-sum, ``src/repro/core/dispatch.py:85``; no kernel
  lies behind it there either).

``ops.grouped_gemm`` / ``ops.combine_slots`` go through these Functions
whenever grad mode is on and an input requires grad, on either device, so
the CPU tests exercise the backward logic the card runs.

**Stacked views.**  Parameters are stacked over layer (and server) axes,
and each step of the forward reads one slice.  Autograd's backward of an
indexing view allocates a zero tensor the size of the whole stacked leaf
and accumulates into it — at full width 7.5 GB per expert weight per
view, and one per server and per layer.  :func:`stacked_view` is such a
slice whose gradient is added in place into the stacked leaf's ``.grad``
(allocated once, zeros) and flows no further; the grouped GEMM's dw
kernel writes a server's gradient straight into its slice of that buffer
(``accumulate``), so the expert weights' gradients cost their own size and
nothing more.  The price: such leaves' gradients arrive only through
``loss.backward()`` into ``.grad`` (``torch.autograd.grad`` does not see
them).  Without grad mode, or for a tensor that needs none, it is plain
indexing: the serving paths are unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.combine import combine_slots_cuda, combine_slots_torch
from repro_torch.kernels.grouped_gemm import (grouped_gemm_cuda,
                                              grouped_gemm_dw_cuda,
                                              grouped_gemm_dw_torch,
                                              grouped_gemm_dx_cuda,
                                              grouped_gemm_dx_torch,
                                              grouped_gemm_torch)

_TARGET = "_stacked_grad_target"       # (leaf, index) on a stacked view

def _gemm(impl: str):
    """(forward, dx, dw) of the grouped GEMM for ``impl``, looked up at
    each call (the smoke run wraps ``grouped_gemm_dw_cuda`` to read the
    group sizes)."""
    if impl == "cuda":
        return grouped_gemm_cuda, grouped_gemm_dx_cuda, grouped_gemm_dw_cuda
    if impl == "meta":
        return (meta.grouped_gemm, meta.grouped_gemm_dx,
                meta.grouped_gemm_dw_meta)
    return grouped_gemm_torch, grouped_gemm_dx_torch, grouped_gemm_dw_torch


def _grad_buffer(leaf: torch.Tensor) -> torch.Tensor:
    if leaf.grad is None:
        leaf.grad = torch.zeros_like(leaf,
                                     memory_format=torch.contiguous_format)
    return leaf.grad


class _StackedView(torch.autograd.Function):
    @staticmethod
    def forward(ctx, leaf, index):
        ctx.leaf, ctx.index = leaf, index
        return leaf[index]

    @staticmethod
    def backward(ctx, g):
        _grad_buffer(ctx.leaf)[ctx.index].add_(g)
        return None, None


def stacked_view(t: torch.Tensor, index) -> torch.Tensor:
    """``t[index]`` (ints over leading axes).  Under grad mode, for a leaf
    that requires grad or a stacked view of one, a view whose gradient is
    added into the leaf's ``.grad`` in place (module docstring)."""
    index = index if isinstance(index, tuple) else (index,)
    if not (torch.is_grad_enabled() and t.requires_grad):
        return t[index]
    target = getattr(t, _TARGET, None)
    if target is not None:
        leaf, index = target[0], target[1] + index
    elif t.is_leaf:
        leaf = t
    else:
        return t[index]
    out = _StackedView.apply(leaf, index)
    setattr(out, _TARGET, (leaf, index))
    return out


def grad_target(t: torch.Tensor) -> Optional[Tuple[torch.Tensor, tuple]]:
    """(leaf, index) of a stacked view, else None."""
    return getattr(t, _TARGET, None)


class GroupedGemm(torch.autograd.Function):
    """``out[i] = x[i] @ w[g(i)]`` with its gradient (module docstring).
    ``impl``: "cuda" (the kernels), "torch" (the plain versions) or
    "meta" (shapes and counts, :mod:`.meta`);
    ``target``: w's :func:`grad_target` — dw then goes into that slice of
    the leaf's ``.grad`` and w gets no gradient of its own."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, impl, target):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.impl, ctx.target = impl, target
        return _gemm(impl)[0](x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, sizes = ctx.saved_tensors
        _, dx_fn, dw_fn = _gemm(ctx.impl)
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dx_fn(dy, w, sizes)
        if ctx.needs_input_grad[1]:
            if ctx.target is None:
                dw = dw_fn(x, dy, sizes)
            else:
                leaf, index = ctx.target
                dw_fn(x, dy, sizes, out=_grad_buffer(leaf)[index])
        return dx, dw, None, None, None


class CombineSlots(torch.autograd.Function):
    """``ops.combine_slots`` with its gradient (module docstring).
    ``bufs``: one (S, C, d) tensor or S (C, d) buffers."""

    @staticmethod
    def forward(ctx, impl, combine_slot, addend, *bufs):
        ctx.save_for_backward(combine_slot)
        ctx.stacked = len(bufs) == 1 and bufs[0].dim() == 3
        ctx.shape = ((bufs[0].shape[0], bufs[0].shape[1]) if ctx.stacked
                     else (len(bufs), bufs[0].shape[0]))
        if impl == "meta":
            return meta.combine_slots(list(bufs), combine_slot, addend)
        fwd = combine_slots_cuda if impl == "cuda" else combine_slots_torch
        return fwd(bufs[0] if ctx.stacked else list(bufs), combine_slot,
                   addend)

    @staticmethod
    def backward(ctx, dy):
        (slot,) = ctx.saved_tensors
        S, C = ctx.shape
        rows = S * C
        T, k = slot.shape
        d = dy.shape[1]
        # dropped slots land on a spare row, cut off below
        flat = torch.zeros((rows + 1, d), dtype=dy.dtype, device=dy.device)
        live = (slot >= 0) & (slot < rows)
        flat[torch.where(live, slot, rows).reshape(-1)] = (
            dy[:, None].expand(T, k, d).reshape(T * k, d))
        resp = flat[:rows].view(S, C, d)
        grads = (resp,) if ctx.stacked else resp.unbind(0)
        return (None, None, dy if ctx.needs_input_grad[2] else None, *grads)
