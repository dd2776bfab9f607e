"""The kernels on ``meta`` tensors: shapes and operation counts, no data.

The dry-run's accounting (:mod:`repro_torch.launch.dryrun`) runs a rank's
step on ``meta`` tensors.  There each kernel op of :mod:`.ops` is one of
the ``torch.library`` operators below: its fake implementation returns an
empty output of the kernel's shape and dtype, and a formula registered with
``torch.utils.flop_counter`` counts the kernel's own work, so
``FlopCounterMode`` sees it as it sees a matmul:

* ``grouped_gemm`` / ``grouped_gemm_dx`` / ``grouped_gemm_dw``: ``2·M·K·N``
  over the M capacity rows the kernel is handed (a ``meta`` tensor holds no
  group sizes, so every row counts as live: the most this call can do).
  The dry-run's cells lower the expert GEMMs ``dense``, as the reference's
  do (``ops.grouped_gemm_dense``: no kernel, a ``torch.bmm`` that torch's
  own formula counts as ``2·G·cap·K·N``, the reference's "flop-honest"
  count); this route counts a call of the kernel's lowering;
* ``combine_slots``: ``T·k·d`` additions (the responses are already
  weighted by their scores), plus ``T·d`` for an addend;
* ``flash_decode`` / ``flash_decode_partial``: ``4·B·H·S·hd`` (q·k and p·v
  over every slot of the cache given).

rwkv6's wkv recurrence is no kernel (PyTorch on every device, as it is
jnp in the reference), but its per-token loop would dispatch L steps a
layer on ``meta`` (a 32,768-token prefill: a million steps).  There it is
one op, :func:`wkv`, counted as the loop's matmuls (``2·B·L·H·D²``, the
backward ``4·B·L·H·D²``) with the loop's memory modelled
(``tests/test_torch_meta.py`` holds both to the loop's).  Under autograd
the time-mix calls it once a chunk, inside the chunk's checkpoint, so its
counts model the chunked loop, the backward's recomputation included.

The plain versions are not run there: ``grouped_gemm_torch`` makes G masked
dense products, G times the kernel's work.  Calling these operators on any
other device raises: the ``cuda`` and ``torch`` routes of :mod:`.ops` are
unchanged.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

NS = "repro_torch"


def _refuse(name: str):
    raise RuntimeError(f"repro_torch::{name} is the meta route of a kernel; "
                       "it runs on meta tensors only")


@torch.library.custom_op(f"{NS}::grouped_gemm", mutates_args=())
def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 sizes: torch.Tensor) -> torch.Tensor:
    _refuse("grouped_gemm")


@grouped_gemm.register_fake
def _(x, w, sizes):
    return x.new_empty((x.shape[0], w.shape[2]))


@torch.library.custom_op(f"{NS}::grouped_gemm_dx", mutates_args=())
def grouped_gemm_dx(dy: torch.Tensor, w: torch.Tensor,
                    sizes: torch.Tensor) -> torch.Tensor:
    _refuse("grouped_gemm_dx")


@grouped_gemm_dx.register_fake
def _(dy, w, sizes):
    return dy.new_empty((dy.shape[0], w.shape[1]))


@torch.library.custom_op(f"{NS}::grouped_gemm_dw", mutates_args=())
def grouped_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                    sizes: torch.Tensor) -> torch.Tensor:
    _refuse("grouped_gemm_dw")


@grouped_gemm_dw.register_fake
def _(x, dy, sizes):
    return x.new_empty((sizes.shape[0], x.shape[1], dy.shape[1]))


@torch.library.custom_op(f"{NS}::grouped_gemm_dw_into",
                         mutates_args=("out",))
def grouped_gemm_dw_into(x: torch.Tensor, dy: torch.Tensor,
                         sizes: torch.Tensor, out: torch.Tensor) -> None:
    _refuse("grouped_gemm_dw_into")


@grouped_gemm_dw_into.register_fake
def _(x, dy, sizes, out):
    return None


@torch.library.custom_op(f"{NS}::combine_slots", mutates_args=())
def combine_slots(bufs: List[torch.Tensor], slot: torch.Tensor,
                  addend: Optional[torch.Tensor]) -> torch.Tensor:
    _refuse("combine_slots")


@combine_slots.register_fake
def _(bufs, slot, addend):
    return bufs[0].new_empty((slot.shape[0], bufs[0].shape[-1]))


@torch.library.custom_op(f"{NS}::flash_decode", mutates_args=())
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    _refuse("flash_decode")


@flash_decode.register_fake
def _(q, k, v, lengths):
    return torch.empty_like(q)


@torch.library.custom_op(f"{NS}::flash_decode_partial", mutates_args=())
def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _refuse("flash_decode_partial")


@flash_decode_partial.register_fake
def _(q, k, v, lengths):
    B, H, hd = q.shape
    f = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((B, H, hd), **f), torch.empty((B, H), **f),
            torch.empty((B, H), **f))


# ------------------------------------------- rwkv6's per-token recurrence

@torch.library.custom_op(f"{NS}::wkv", mutates_args=())
def wkv_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor,
           saves: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    _refuse("wkv")


@wkv_op.register_fake
def _(r, k, v, w, u, S0, saves):
    B, L, H, D = r.shape
    work = 3 if L > 1 else 2
    kept = 3 * L - 1 if saves else 0
    return (torch.empty_like(r), torch.empty_like(S0),
            S0.new_empty((work, B, H, D, D)),
            S0.new_empty((kept, B, H, D, D)))


@torch.library.custom_op(f"{NS}::wkv_bwd", mutates_args=())
def wkv_bwd(dy: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
            S0: torch.Tensor, kept: torch.Tensor) -> List[torch.Tensor]:
    _refuse("wkv_bwd")


@wkv_bwd.register_fake
def _(dy, r, k, v, w, u, S0, kept):
    return [torch.empty_like(t) for t in (r, k, v, w, u, S0)]


def _wkv_setup(ctx, inputs, output):
    ctx.mark_non_differentiable(output[2], output[3])
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(*inputs[:6], output[3])


def _wkv_backward(ctx, dy, dS, dwork, dkept):
    return (*wkv_bwd(dy, *ctx.saved_tensors), None)


wkv_op.register_autograd(_wkv_backward, setup_context=_wkv_setup)


def wkv(r, k, v, w, u, S0):
    """rwkv6's recurrence over a sequence on ``meta``: (y (B, L, H, D),
    the last state), as ``models/rwkv.py``'s per-token loop returns them.
    Its memory is the loop's, modelled: the loop's working set at a token
    (kv, u·kv or w·S, and the new state: three (B, H, D, D) states, two
    for one token) is an output dropped at once; under grad the states
    the loop keeps for its backward (kv and the bracket per token, every
    state but the last) are an output saved until the backward."""
    saves = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, S0))
    y, S, _, _ = wkv_op(r, k, v, w, u, S0, saves)
    return y, S


# ------------------------------------------------------ the kernels' work

def gemm_flops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


@register_flop_formula(torch.ops.repro_torch.grouped_gemm)
def _(x_shape, w_shape, sizes_shape, *a, **k) -> int:
    return gemm_flops(x_shape[0], x_shape[1], w_shape[2])


@register_flop_formula(torch.ops.repro_torch.grouped_gemm_dx)
def _(dy_shape, w_shape, sizes_shape, *a, **k) -> int:
    return gemm_flops(dy_shape[0], w_shape[1], w_shape[2])


@register_flop_formula(torch.ops.repro_torch.grouped_gemm_dw)
def _(x_shape, dy_shape, sizes_shape, *a, **k) -> int:
    return gemm_flops(x_shape[0], x_shape[1], dy_shape[1])


@register_flop_formula(torch.ops.repro_torch.grouped_gemm_dw_into)
def _(x_shape, dy_shape, sizes_shape, buf_shape, *a, **k) -> int:
    return gemm_flops(x_shape[0], x_shape[1], dy_shape[1])


def combine_flops(T: int, k: int, d: int, addend: bool) -> int:
    return T * k * d + (T * d if addend else 0)


@register_flop_formula(torch.ops.repro_torch.combine_slots)
def _(bufs_shape, slot_shape, addend_shape, *a, **k) -> int:
    T, kk = slot_shape
    return combine_flops(T, kk, bufs_shape[0][-1], addend_shape is not None)


def decode_flops(B: int, H: int, S: int, hd: int) -> int:
    return 4 * B * H * S * hd


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _(q_shape, k_shape, *a, **k) -> int:
    return decode_flops(q_shape[0], q_shape[1], k_shape[1], q_shape[2])


@register_flop_formula(torch.ops.repro_torch.flash_decode_partial)
def _(q_shape, k_shape, *a, **k) -> int:
    return decode_flops(q_shape[0], q_shape[1], k_shape[1], q_shape[2])


def wkv_flops(B: int, L: int, H: int, D: int, backward: bool) -> int:
    """The per-token loop's matmuls: ``r_t · (S + u k_t v_tᵀ)`` per head
    and token, ``2·D²`` (its backward: ``4·D²``, the gradients of r_t
    and of the bracket); the loop's elementwise updates count nothing, as
    ``FlopCounterMode`` counts them nothing there."""
    return (4 if backward else 2) * B * L * H * D * D


@register_flop_formula(torch.ops.repro_torch.wkv)
def _(r_shape, *a, **k) -> int:
    return wkv_flops(*r_shape, backward=False)


@register_flop_formula(torch.ops.repro_torch.wkv_bwd)
def _(dy_shape, *a, **k) -> int:
    return wkv_flops(*dy_shape, backward=True)


def grouped_gemm_dw_meta(x, dy, sizes, out=None):
    """dw on ``meta``; with ``out``, added into it in place (training's
    mode: no (G, K, N) temporary beside the gradient buffer)."""
    if out is None:
        return grouped_gemm_dw(x, dy, sizes)
    grouped_gemm_dw_into(x, dy, sizes, out)
    return out
