"""Double-batch overlap (paper §4.2) — counterpart of
``src/repro/core/overlap.py``.

Client pipelining: while microbatch A's expert round trip is in flight,
the client computes microbatch B's attention.  On the TPU the reference
expresses the two microbatches as independent subgraphs and XLA's
latency-hiding scheduler overlaps them.  PyTorch runs eagerly, so on the
card the port issues microbatch B on a second CUDA stream, joined to the
caller's stream by an event before the halves' outputs meet: the two
streams' kernels may then run side by side.  On the CPU the halves run one
after the other (the values are the same either way).

The serialized ablation keeps one stream and chains B behind A with a
zero-valued data dependency, as the reference writes it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch


def _check_even(n: int, what: str) -> int:
    if n % 2:
        raise ValueError(f"{what} needs an even batch (got {n})")
    return n // 2


def double_batch_overlap(dense_fn: Callable, moe_fn: Callable,
                         x: torch.Tensor, *, enabled: bool = True
                         ) -> torch.Tensor:
    """y = moe_fn(dense_fn(x)) computed as two interleaved microbatches.

    dense_fn / moe_fn must be batch-elementwise (true for transformer
    blocks).  With ``enabled=False`` the same split runs chained by a
    zero-valued coupling, which pins the expert phase on the critical path
    (the ablation baseline); the values are bit-identical.
    """
    half = _check_even(x.shape[0], "double-batch overlap")
    x0, x1 = x[:half], x[half:]
    if enabled:
        # issue order: attention(1) between dispatch(0) and combine(0)
        a0 = dense_fn(x0)
        a1 = dense_fn(x1)
        y0 = moe_fn(a0)
        y1 = moe_fn(a1)
    else:
        a0 = dense_fn(x0)
        y0 = moe_fn(a0)
        a1 = dense_fn(x1 + (0 * y0.sum()).to(x1.dtype))
        y1 = moe_fn(a1)
    return torch.cat([y0, y1], dim=0)


def _map(fn, tree):
    """Apply ``fn`` to every tensor of a dict / dataclass / tuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return type(tree)(*[_map(fn, v) for v in tree]) \
            if hasattr(tree, "_fields") else tuple(_map(fn, v) for v in tree)
    return tree


def _add(a, b):
    """Field-by-field sum of two stats trees (tensors or numbers)."""
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        vals = [_add(x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return a + b


def split_batch_decode(step_fn: Callable, tokens: torch.Tensor, cache, *,
                       axis: int, enabled: bool = True,
                       stream: Optional[torch.cuda.Stream] = None
                       ) -> Tuple[torch.Tensor, object, object]:
    """One decode step as two half-batch microbatches (engine-level DBO).

    ``step_fn(tokens_half, cache_half) -> (logits, cache, stats)`` is the
    whole-model decode step, which appends to the cache it is given in
    place (the port's ``decode_step`` does).  ``axis`` is the batch axis of
    every cache tensor; each half is a *view* of the cache along it, so the
    halves' appends land in the shared cache and no concatenation follows
    (a layer's half stays contiguous when ``axis`` is the axis right after
    the layer axis).  Returns ``(logits, cache, stats)`` with the stats
    summed field by field.

    ``enabled=True`` (pipelined): on CUDA, microbatch B runs on ``stream``
    (required there), which waits for the caller's stream *before* A is
    issued, so B waits for what the caller wrote and not for A; the
    caller's stream waits for B's event before the logits are
    concatenated, so the caller's next step sees B's cache writes.
    ``enabled=False`` (serialized): one stream, and a zero-valued coupling
    makes B's tokens wait on A's logits without changing the math.
    """
    half = _check_even(tokens.shape[0], "two-microbatch decode")
    t0, t1 = tokens[:half], tokens[half:]

    def cache_half(i: int):
        return _map(lambda a: a.narrow(axis, i * half, half), cache)

    two_streams = enabled and tokens.is_cuda
    if two_streams:
        if stream is None:
            raise ValueError("pipelined decode on CUDA needs the side stream "
                             "that microbatch B runs on")
        main = torch.cuda.current_stream(tokens.device)
        stream.wait_stream(main)      # B reads what the caller wrote, not A

    l0, _, s0 = step_fn(t0, cache_half(0))
    if not enabled:
        # artificial data dependency: mb1's tokens wait on mb0's logits
        t1 = t1 + (0 * l0.sum()).to(t1.dtype)
        l1, _, s1 = step_fn(t1, cache_half(1))
    elif two_streams:
        with torch.cuda.stream(stream):
            l1, _, s1 = step_fn(t1, cache_half(1))
        main.wait_stream(stream)      # join: B's logits and cache writes
        # B's outputs were allocated on the side stream and are read on the
        # caller's: keep their blocks from being reused before that
        _map(lambda a: a.record_stream(main), (l1, s1))
    else:
        l1, _, s1 = step_fn(t1, cache_half(1))
    return torch.cat([l0, l1], dim=0), cache, _add(s0, s1)


def microbatch_schedule(n: int) -> Tuple[Tuple[int, str], ...]:
    """The steady-state two-batch schedule: (mb, phase) pairs —
    attention(i+1) overlaps expert(i)."""
    steps = []
    for i in range(n):
        steps.append((i, "attention"))
        if i > 0:
            steps.append((i - 1, "combine"))
        steps.append((i, "dispatch"))
    steps.append((n - 1, "combine"))
    return tuple(steps)
