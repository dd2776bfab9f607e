"""Shared building blocks: dtype policy, initializers, RMS norm,
activations, the gemma-style logit softcap and the checkpoint inside a
layer (:func:`remat_if_recording`)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def activation_fn(name: str):
    """The FFN activations of the reference's ``models/common.py``
    (``jax.nn.gelu`` is the tanh approximation)."""
    if name == "swiglu":      # handled structurally in mlp.py: the gate's
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping."""
    return cap * torch.tanh(logits / cap)


def records(*args) -> bool:
    """Whether autograd records an op on ``args``: grad enabled and a
    tensor among them requiring grad."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def remat_if_recording(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its intermediates recomputed in the
    backward instead of saved (a non-reentrant checkpoint, the reference's
    ``jax.checkpoint`` inside a layer) when autograd records it
    (:func:`records`).  Otherwise a plain call, so serving and the no-grad
    accounting take no checkpoint.  ``fn`` draws no random numbers (no RNG
    state is kept) and issues no collective (the recomputation repeats
    what it issues)."""
    if records(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)
