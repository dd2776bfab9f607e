"""Shared building blocks: dtype policy, initializers, RMS norm."""

from __future__ import annotations

import math
from typing import Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init_(out: torch.Tensor, generator: Optional[torch.Generator],
                chunk: int = 8) -> torch.Tensor:
    """Fill ``out (..., in, out_dim)`` with the reference's fan-in init:
    a normal truncated at ±3, times ``1/sqrt(in)``, drawn in fp32 and cast.
    Drawn ``chunk`` leading slices at a time so the fp32 scratch stays
    small at full width.  ``out`` may be a strided view (written through)."""
    if out.dim() > 3:
        for i in range(out.shape[0]):
            dense_init_(out[i], generator, chunk)
        return out
    if out.dim() == 2:
        dense_init_(out[None], generator, chunk)
        return out
    for i in range(0, out.shape[0], chunk):
        dst = out[i:i + chunk]
        tmp = torch.empty(dst.shape, dtype=torch.float32, device=out.device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        dst.copy_(tmp.mul_(1.0 / math.sqrt(out.shape[-2])))
    return out


def dense_init(shape, dtype, device, generator) -> torch.Tensor:
    return dense_init_(torch.empty(shape, dtype=dtype, device=device),
                       generator)


def embed_init(vocab: int, dim: int, dtype, device, generator) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Computed in fp32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
