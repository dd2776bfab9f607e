"""Top-k combine: the client-side epilogue of the buffer protocol.

``out[t] = sum_k w[t, k] * x[t, k, :]`` in fp32, cast to x's dtype.

Replaces ``src/repro/kernels/combine.py::combine_weighted_pallas``.

CUDA kernel (``csrc/combine.cu``): grid = (T tokens) x (chunks of d);
each thread owns one output element and walks the k partials, so
neighbouring threads read neighbouring addresses.  It is bound by bytes
(``T*k*d`` read, ``T*d`` written, 2 operations per element read); the
gather of ``dispatch.combine`` stays outside it for now.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def combine_weighted_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version."""
    return torch.einsum("tkd,tk->td", x.float(), w.float()).to(x.dtype)


def combine_weighted_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync)."""
    req = build.require
    req(x.is_cuda and w.device == x.device,
        "combine_weighted: x and w must be on one CUDA device")
    req(x.dim() == 3 and w.shape == x.shape[:2],
        f"combine_weighted: shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    req(x.is_contiguous(), "combine_weighted: x must be contiguous")
    T, k, d = x.shape
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
