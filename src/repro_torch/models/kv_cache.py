"""Dense KV cache: per-layer ``(batch, slots, kv_heads, head_dim)`` buffers
with a per-sequence length counter (the paged cache is not ported yet).

Unlike the reference's functional updates, the writes here are in place
(the cache is the engine's largest activation buffer); each op still
returns the cache so call sites read like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    """k/v: ([layers,] batch, slots, kv_heads, head_dim); length:
    ([layers,] batch) int32 tokens written per sequence."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache, as views (writes go through)."""
        return KVCache(self.k[i], self.v[i], self.length[i])


def init_kv_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                  dtype, device, layers: int = 0) -> KVCache:
    lead = (layers,) if layers else ()
    shape = (*lead, batch, max_seq, kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((*lead, batch), dtype=torch.int32, device=device))


def append_decode(cache: KVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> KVCache:
    """Append ONE token per sequence; k_new/v_new (batch, 1, kv_heads, hd).

    The write index is clamped to the last slot, as the reference's
    ``dynamic_update_slice`` clamps it: the engine decodes idle slots too,
    whose lengths run past the cache.
    """
    slots = cache.k.shape[1]
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    idx = cache.length.clamp(max=slots - 1).long()
    cache.k[rows, idx] = k_new[:, 0]
    cache.v[rows, idx] = v_new[:, 0]
    cache.length += 1
    return cache


def write_prefill(cache: KVCache, k: torch.Tensor,
                  v: torch.Tensor) -> KVCache:
    """Write a full prompt (batch, seq, kv_heads, hd) from position 0."""
    seq = k.shape[1]
    cache.k[:, :seq] = k
    cache.v[:, :seq] = v
    cache.length.fill_(seq)
    return cache


def valid_mask(cache: KVCache) -> torch.Tensor:
    """(batch, slots) bool — which cache slots hold valid tokens."""
    slots = cache.k.shape[1]
    pos = torch.arange(slots, device=cache.k.device)[None, :]
    return pos < cache.length[:, None]
