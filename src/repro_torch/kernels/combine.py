"""Top-k combine: the client-side epilogue of the buffer protocol.

Two entries, one CUDA body (``csrc/combine.cu``, two address policies):

* :func:`combine_weighted_cuda` — ``out[t] = sum_k w[t, k] * x[t, k, :]``
  over ``x (T, k, d)``, replacing
  ``src/repro/kernels/combine.py::combine_weighted_pallas``;
* :func:`combine_slots_cuda` — the whole combine stage of
  ``src/repro/core/dispatch.py::combine``, reading the expert servers'
  response buffers in place: slot ``s*C + c`` of ``combine_slot (T, k)``
  is row ``c`` of server ``s``, ``-1`` is dropped (never read); the kept
  rows are summed, cast to the responses' dtype, and an optional
  ``addend (T, d)`` (the shared experts' output) is added.

Both sum the k rows in ascending order, one fp32 add after another, so the
slot entry is bitwise equal to the direct one over the gathered view with
0/1 weights and to :func:`combine_slots_torch`.

It is bound by bytes (one fma per element read).  The kernel reads only
the live rows (no stacked ``(S, C, d)`` copy, no ``(T, k, d)`` view), 16
bytes a thread, with few enough registers that many blocks share an SM;
the block width is chosen from T so a decode call still fills the card.
The S buffer addresses travel by value in the launch's parameters (at most
:data:`MAX_SERVERS`), so the launch can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from repro_torch.kernels import build

MAX_SERVERS = 64    # csrc kMaxServers
MAX_TOP_K = 32      # csrc kMaxTopK

Responses = Union[torch.Tensor, Sequence[torch.Tensor]]


def combine_weighted_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version."""
    return torch.einsum("tkd,tk->td", x.float(), w.float()).to(x.dtype)


def combine_slots_torch(responses: Responses, combine_slot: torch.Tensor,
                        addend: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version: the kept rows summed in ascending j in fp32, cast to
    the responses' dtype, then ``+ addend`` in that dtype."""
    flat = (responses if isinstance(responses, torch.Tensor)
            else torch.stack(list(responses)))
    flat = flat.reshape(-1, flat.shape[-1])
    T, k = combine_slot.shape
    live = (combine_slot >= 0) & (combine_slot < flat.shape[0])
    rows = flat[torch.where(live, combine_slot, 0)]            # (T, k, d)
    acc = torch.zeros((T, flat.shape[1]), dtype=torch.float32,
                      device=flat.device)
    for j in range(k):
        acc += torch.where(live[:, j, None], rows[:, j].float(), 0.0)
    y = acc.to(flat.dtype)
    return y if addend is None else y + addend


def combine_weighted_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync)."""
    build.refuse_grad("combine_weighted", x, w)
    req = build.require
    req(x.is_cuda and w.device == x.device,
        "combine_weighted: x and w must be on one CUDA device")
    req(x.dim() == 3 and w.shape == x.shape[:2],
        f"combine_weighted: shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    req(x.is_contiguous(), "combine_weighted: x must be contiguous")
    T, k, d = x.shape
    req(k <= MAX_TOP_K, f"combine_weighted: k={k} > {MAX_TOP_K}")
    w = w.to(torch.float32).contiguous()
    out = torch.empty((T, d), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    lib = build.load_library()
    err = lib.combine_weighted_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), T, k, d,
        build.dtype_code(x.dtype), build.stream_of(x))
    build.check(err, "combine_weighted")
    build.count("combine_weighted")
    return out


def combine_slots_cuda(responses: Responses, combine_slot: torch.Tensor,
                       addend: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync).

    ``responses``: one contiguous ``(S, C, d)`` tensor, or S contiguous
    ``(C, d)`` buffers of one shape, dtype and device (read in place).
    Its gradient is :class:`repro_torch.kernels.autograd.CombineSlots`;
    called raw under grad with an input that requires grad, it raises."""
    build.refuse_grad("combine_slots", combine_slot, addend,
                      *([responses] if isinstance(responses, torch.Tensor)
                        else responses))
    req = build.require
    if isinstance(responses, torch.Tensor):
        req(responses.dim() == 3 and responses.is_contiguous(),
            "combine_slots: responses must be a contiguous (S, C, d) tensor, "
            f"got {tuple(responses.shape)}")
        bufs = [responses]
        rows = responses.shape[0] * responses.shape[1]
    else:
        bufs = list(responses)
        req(1 <= len(bufs) <= MAX_SERVERS,
            f"combine_slots: {len(bufs)} buffers, expected 1-{MAX_SERVERS}")
        first = bufs[0]
        key = (first.shape, first.dtype, first.device)
        req(first.dim() == 2 and all(
                (b.shape, b.dtype, b.device) == key and b.is_contiguous()
                for b in bufs),
            "combine_slots: buffers must be contiguous (C, d) tensors of one "
            "shape, dtype and device")
        rows = first.shape[0]
    ref = bufs[0]
    d = ref.shape[-1]
    req(ref.is_cuda and combine_slot.device == ref.device,
        "combine_slots: responses and combine_slot must be on one CUDA "
        "device")
    req(combine_slot.dim() == 2 and combine_slot.dtype == torch.int64,
        "combine_slots: combine_slot must be (T, k) int64, got "
        f"{tuple(combine_slot.shape)} {combine_slot.dtype}")
    T, k = combine_slot.shape
    req(k <= MAX_TOP_K, f"combine_slots: k={k} > {MAX_TOP_K}")
    if addend is not None:
        req((addend.shape, addend.dtype, addend.device)
            == ((T, d), ref.dtype, ref.device) and addend.is_contiguous(),
            f"combine_slots: addend must be a contiguous ({T}, {d}) "
            f"{ref.dtype} tensor on {ref.device}")
    slots = combine_slot.contiguous()
    out = torch.empty((T, d), dtype=ref.dtype, device=ref.device)
    if T == 0:
        return out
    bases = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
    lib = build.load_library()
    err = lib.combine_slots_launch(
        bases, len(bufs), rows, slots.data_ptr(),
        None if addend is None else addend.data_ptr(), out.data_ptr(), T, k,
        d, build.dtype_code(ref.dtype), build.stream_of(ref))
    build.check(err, "combine_slots")
    build.count("combine_slots")
    return out


def empty_cuda(device) -> None:
    """Launch an empty kernel: the card's launch floor, timed beside the
    combine (not a kernel of the serving path, so not counted)."""
    lib = build.load_library()
    build.check(lib.empty_launch(ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream)), "empty")
