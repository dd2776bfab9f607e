"""Shared building blocks: dtype policy, initializers, RMS norm,
activations, the gemma-style logit softcap, the checkpoint inside a layer
(:func:`remat_if_recording`) and the compiled scan body
(:func:`compiled_scan`)."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import build

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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's promotion of a mixed pair (float32 rows
    against bfloat16 weights: a float32 product), where torch raises."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


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


# ---------------------------------------------------------- compiled scans

SCAN_BLOCK = 64


@dataclasses.dataclass
class _Body:
    """One body of ``n`` steps: its static inputs, and on the card its
    graph and static output."""
    xs: List[torch.Tensor]
    warm: bool = False
    graph: Optional[torch.cuda.CUDAGraph] = None
    ys: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Scan:
    """The static carry and constants of one scan signature, shared by its
    bodies (so the carry passes from one body to the next in place)."""
    carry: torch.Tensor
    consts: List[torch.Tensor]
    bodies: Dict[int, _Body] = dataclasses.field(default_factory=dict)


# process-wide, as the reference's compilation cache is: one signature's
# bodies serve every layer, prompt, slot and executor
_SCANS: Dict[tuple, _Scan] = {}
_POOLS: Dict[torch.device, tuple] = {}
# per scan name: captures, replays and the reserved bytes each capture
# added to the pool
SCAN_STATS: Dict[str, Dict] = {}


def reset_scans() -> None:
    """Drop every scan's static buffers and graphs (and their pools, freed
    with the allocator's cache) and zero :data:`SCAN_STATS`."""
    _SCANS.clear()
    _POOLS.clear()
    SCAN_STATS.clear()


def _static(like: torch.Tensor, shape=None) -> torch.Tensor:
    """A persistent buffer (not an inference tensor, so calls outside
    ``inference_mode`` may write it too)."""
    with torch.inference_mode(False):
        return torch.empty(like.shape if shape is None else shape,
                           dtype=like.dtype, device=like.device)


def _run_body(name: str, scan: _Scan, n: int,
              body: Callable) -> torch.Tensor:
    """One pass of the ``n``-step body over the static buffers: eagerly on
    the CPU and at a body's first sight on the card, then captured once
    and replayed.  The body writes its last carry into the static carry,
    so the next pass continues from it."""
    b = scan.bodies[n]

    def step():
        ys, carry = body(*b.xs, *scan.consts, scan.carry)
        scan.carry.copy_(carry)
        return ys
    if scan.carry.device.type != "cuda" or not b.warm:
        b.warm = True
        return step()
    stats = SCAN_STATS.setdefault(name, {"captures": 0, "replays": 0,
                                         "pool_bytes": []})
    if b.graph is None:
        dev = scan.carry.device
        if dev not in _POOLS:
            _POOLS[dev] = torch.cuda.graph_pool_handle()
        before = torch.cuda.memory_reserved(dev)
        b.graph, b.ys = build.capture(step, dev, _POOLS[dev], {})
        stats["captures"] += 1
        stats["pool_bytes"].append(torch.cuda.memory_reserved(dev) - before)
    b.graph.replay()
    stats["replays"] += 1
    return b.ys


def compiled_scan(name: str, body: Callable, xs: Sequence[torch.Tensor],
                  consts: Sequence[torch.Tensor], carry: torch.Tensor):
    """``body(*xs, *consts, carry) -> (ys, carry')`` over axis 1 of ``xs``
    (``ys`` stacked over that axis), as the reference's ``lax.scan`` of a
    body compiled once.

    ``body`` runs ``n`` steps of a recurrence over its inputs' axis 1 and
    is the loop itself.  Where it counts, it runs over static buffers in
    blocks: the sequence of L steps passes through a body of
    :data:`SCAN_BLOCK` steps ``L // SCAN_BLOCK`` times and a body of one
    step ``L % SCAN_BLOCK`` times.  Each call copies ``consts`` and the
    incoming ``carry`` in once, each block its slices of ``xs`` in and
    its ``ys`` out into tensors of the call's own; the last carry is
    returned in a fresh tensor.  On the card each body is captured as a
    CUDA graph at its second pass (its first runs eagerly, as cuBLAS must
    set itself up before a capture) and replayed from then on: once per
    (name, block, the shapes and dtypes of a step's inputs, consts and
    carry, device), whatever the layer, prompt or slot.  On the CPU the
    same staging runs the body eagerly.  The kernels and their order are
    the loop's, so every value is bitwise the plain call's.

    The plain call ``body(*xs, *consts, carry)``, with no staging: under
    ``build.eager()``, where autograd records (:func:`records`: the
    training path keeps its checkpoints), on ``meta``, and while the
    current stream is capturing (the loop is then part of a larger
    graph).  A failed capture or replay raises."""
    dev = carry.device
    if (dev.type == "meta" or build.EAGER[0] or records(*xs, *consts, carry)
            or (dev.type == "cuda"
                and torch.cuda.is_current_stream_capturing())):
        return body(*xs, *consts, carry)
    sig = (name, dev, tuple((x.shape[0], *x.shape[2:], x.dtype) for x in xs),
           tuple((tuple(c.shape), c.dtype) for c in consts),
           (tuple(carry.shape), carry.dtype))
    scan = _SCANS.get(sig)
    if scan is None:
        scan = _SCANS[sig] = _Scan(_static(carry),
                                   [_static(c) for c in consts])
    scan.carry.copy_(carry)
    for s, c in zip(scan.consts, consts):
        s.copy_(c)
    L, pos, out = xs[0].shape[1], 0, None
    for n in (SCAN_BLOCK, 1):
        if L - pos >= n and n not in scan.bodies:
            scan.bodies[n] = _Body([_static(x, (x.shape[0], n, *x.shape[2:]))
                                    for x in xs])
        while L - pos >= n:
            for s, x in zip(scan.bodies[n].xs, xs):
                s.copy_(x[:, pos:pos + n])
            ys = _run_body(name, scan, n, body)
            if out is None:
                out = torch.empty((ys.shape[0], L, *ys.shape[2:]),
                                  dtype=ys.dtype, device=dev)
            out[:, pos:pos + n].copy_(ys)
            pos += n
    return out, scan.carry.clone()
