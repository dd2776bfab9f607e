"""Token sampling from logits.

Greedy decoding (temperature <= 0) is exact: ``argmax`` picks the first
maximum, as in the reference.  Temperature sampling draws from a
``torch.Generator`` seeded from (request seed, request id, token index), so
a stream is replayable regardless of batch composition — but it is NOT the
reference's stream: the reference draws with jax threefry, which torch does
not reproduce.
"""

from __future__ import annotations

from typing import Sequence

import torch

_MIX = 0x9E3779B97F4A7C15          # 64-bit golden-ratio odd constant


def stream_seed(seed: int, request_id: int, step: int) -> int:
    """A 63-bit generator seed for one (request, token index)."""
    h = (seed * _MIX + request_id) & 0xFFFFFFFFFFFFFFFF
    h = (h * _MIX + step) & 0xFFFFFFFFFFFFFFFF
    return h >> 1


def sample_batch(logits: torch.Tensor, temperatures: Sequence[float],
                 seeds: Sequence[int], request_ids: Sequence[int],
                 steps: Sequence[int]) -> torch.Tensor:
    """logits (B, V) fp32 -> (B,) int64; rows with temperature <= 0 are
    greedy, the others draw from their own (seed, request id, step)
    stream."""
    out = torch.argmax(logits, dim=-1)
    for b, t in enumerate(temperatures):
        if t > 0.0:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(stream_seed(seeds[b], request_ids[b], steps[b]))
            probs = torch.softmax(logits[b] / t, dim=-1)
            out[b] = torch.multinomial(probs, 1, generator=gen)[0]
    return out
