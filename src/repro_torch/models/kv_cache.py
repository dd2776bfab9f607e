"""KV caches for serving (counterpart of ``src/repro/models/kv_cache.py``).

:class:`KVCache` — per-layer ``(batch, slots, kv_heads, head_dim)`` buffers
with a per-sequence length counter.  Sliding-window layers allocate only
``window`` slots and write round-robin (a ring: position ``p`` lives in
slot ``p % window``); keys are cached rotated, so the ring's slot order
does not matter to attention.

:class:`PagedKVCache` — the block-pool alternative: one shared
``(num_blocks, block_size, kv_heads, head_dim)`` pool per layer, with each
sequence naming its blocks through a ``(batch, max_blocks)`` block table
(position ``p`` of sequence ``b`` lives in pool block
``block_tables[b, p // block_size]`` at offset ``p % block_size``).  Block
0 is the scratch sink: unset table entries point at it.  Tables and
lengths are host-authoritative (the scheduler's
:class:`~repro_torch.serving.kv_pool.BlockPool` rewrites them between
steps) and shared by every layer.

Unlike the reference's functional updates, the K/V writes here are in
place (the cache is the engine's largest activation buffer); each op still
returns the cache so call sites read like the reference.  The paged ops
return a new :class:`PagedKVCache` whose ``length`` is a new tensor, so the
tables and lengths the executor uploaded stay as they were for the next
layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    """k/v: ([layers,] batch, slots, kv_heads, head_dim); length:
    ([layers,] batch) int32 tokens written per sequence; ``window > 0``
    makes it a ring of ``slots = min(window, max_seq)``."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    window: int = 0

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache, as views (writes go through)."""
        return KVCache(self.k[i], self.v[i], self.length[i], self.window)


def init_kv_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                  dtype, device, layers: int = 0,
                  window: int = 0) -> KVCache:
    lead = (layers,) if layers else ()
    slots = min(window, max_seq) if window else max_seq
    shape = (*lead, batch, slots, kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((*lead, batch), dtype=torch.int32, device=device),
        window=window)


def append_decode(cache: KVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> KVCache:
    """Append ONE token per sequence; k_new/v_new (batch, 1, kv_heads, hd).

    A ring writes at ``length % slots``.  A linear cache's write index is
    clamped to the last slot, as the reference's ``dynamic_update_slice``
    clamps it: the engine decodes idle slots too, whose lengths run past
    the cache.
    """
    slots = cache.k.shape[1]
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    idx = (cache.length % slots if cache.window
           else cache.length.clamp(max=slots - 1)).long()
    cache.k[rows, idx] = k_new[:, 0]
    cache.v[rows, idx] = v_new[:, 0]
    cache.length += 1
    return cache


def write_prefill(cache: KVCache, k: torch.Tensor,
                  v: torch.Tensor) -> KVCache:
    """Write a full prompt (batch, seq, kv_heads, hd) from position 0.  A
    ring shorter than the prompt keeps its trailing ``slots`` tokens at the
    ring's phase (position ``p`` in slot ``p % slots``)."""
    seq, slots = k.shape[1], cache.k.shape[1]
    if cache.window and seq > slots:
        pos = torch.arange(seq - slots, seq, device=k.device) % slots
        cache.k[:, pos] = k[:, -slots:]
        cache.v[:, pos] = v[:, -slots:]
    else:
        cache.k[:, :seq] = k
        cache.v[:, :seq] = v
    cache.length.fill_(seq)
    return cache


def write_chunk(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                start) -> KVCache:
    """Write a prompt chunk (batch, chunk, kv_heads, hd) at ``start``: an
    int or a 0-d int tensor on the cache's device (a CUDA graph's static
    input, read on the device).

    The write offset clamps so the chunk fits, as the reference's
    ``dynamic_update_slice`` clamps it; the length is ``start + chunk``.
    Linear caches only, as in the reference: chunked prefill is off for
    sliding-window layers.
    """
    if cache.window:
        raise ValueError("write_chunk needs a linear cache")
    seq, slots = k.shape[1], cache.k.shape[1]
    start = torch.as_tensor(start, device=cache.k.device)
    at = start.clamp(0, slots - seq) + torch.arange(seq, device=k.device)
    cache.k.index_copy_(1, at, k)
    cache.v.index_copy_(1, at, v)
    cache.length.fill_(start + seq)
    return cache


def valid_mask(cache: KVCache) -> torch.Tensor:
    """(batch, slots) bool — which cache slots hold valid tokens."""
    slots = cache.k.shape[1]
    pos = torch.arange(slots, device=cache.k.device)[None, :]
    if cache.window:
        return pos < cache.length.clamp(max=slots)[:, None]
    return pos < cache.length[:, None]


# --------------------------------------------------------------- paged cache

@dataclass
class PagedKVCache:
    """k/v: ([layers,] num_blocks, block_size, kv_heads, head_dim) shared
    pool; block_tables: (batch, max_blocks) int32 (0 = unset, the scratch
    block); length: (batch,) int32 tokens written per sequence."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    length: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "PagedKVCache":
        """Layer ``i`` of a stacked pool (views; tables and lengths are
        shared by every layer)."""
        return PagedKVCache(self.k[i], self.v[i], self.block_tables,
                            self.length)


def init_paged_kv_cache(num_blocks: int, block_size: int, batch: int,
                        max_blocks: int, kv_heads: int, head_dim: int,
                        dtype, device, layers: int = 0) -> PagedKVCache:
    lead = (layers,) if layers else ()
    shape = (*lead, num_blocks, block_size, kv_heads, head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.zeros((batch, max_blocks), dtype=torch.int32,
                                 device=device),
        length=torch.zeros(batch, dtype=torch.int32, device=device))


def _lookup_blocks(cache: PagedKVCache,
                   positions: torch.Tensor) -> torch.Tensor:
    """Map per-row positions (batch, n) to pool block ids via the table.

    Positions at or past capacity clamp to the last table entry — the same
    "write the final slot" behaviour the dense cache shows at capacity."""
    mb = cache.block_tables.shape[1]
    bi = (positions // cache.block_size).clamp(0, mb - 1).long()
    return torch.gather(cache.block_tables, 1, bi).long()


def paged_append_decode(cache: PagedKVCache, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> PagedKVCache:
    """Append ONE token per sequence; k_new/v_new (batch, 1, kv_heads, hd).

    Live rows' tail blocks are private (the block-pool invariant); idle
    rows (length 0, table all unset) all write scratch block 0 at offset 0.
    Rows that share a slot all write the last such row's values, so the
    scatter resolves duplicates in row order and is deterministic.
    """
    bs = cache.block_size
    blocks = _lookup_blocks(cache, cache.length[:, None])[:, 0]
    slot = blocks * bs + (cache.length % bs).long()           # (batch,)
    rows = torch.arange(slot.shape[0], device=slot.device)
    same = slot[:, None] == slot[None, :]
    last = torch.where(same, rows[None, :], -1).amax(dim=1)
    flat_k = cache.k.view(-1, *cache.k.shape[2:])
    flat_v = cache.v.view(-1, *cache.v.shape[2:])
    flat_k[slot] = k_new[last, 0]
    flat_v[slot] = v_new[last, 0]
    return PagedKVCache(cache.k, cache.v, cache.block_tables,
                        cache.length + 1)


def paged_write_chunk(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                      start) -> PagedKVCache:
    """Write a prompt chunk (batch, chunk, kv_heads, hd) at position
    ``start`` (an int or a 0-d int tensor on the pool's device) through
    the block table."""
    B, C = k.shape[:2]
    bs = cache.block_size
    start = torch.as_tensor(start, device=cache.k.device)
    pos = start + torch.arange(C, device=k.device)
    blocks = _lookup_blocks(cache, pos[None].expand(B, C))
    off = (pos % bs)[None].expand(B, C)
    cache.k[blocks, off] = k
    cache.v[blocks, off] = v
    return PagedKVCache(cache.k, cache.v, cache.block_tables,
                        torch.empty_like(cache.length).fill_(start + C))


def gather_blocks(cache: PagedKVCache):
    """Materialize the per-sequence view: 2x (batch, max_blocks*bs, KV, hd),
    view lane ``j`` of row ``b`` holding position ``j`` — the layout of a
    dense :class:`KVCache` of ``max_blocks * block_size`` slots."""
    B, mb = cache.block_tables.shape
    bs, kvh, hd = cache.k.shape[1:]
    idx = cache.block_tables.long()
    return (cache.k[idx].reshape(B, mb * bs, kvh, hd),
            cache.v[idx].reshape(B, mb * bs, kvh, hd))


def paged_valid_mask(cache: PagedKVCache) -> torch.Tensor:
    """(batch, max_blocks*bs) bool over the gathered view."""
    slots = cache.block_tables.shape[1] * cache.block_size
    pos = torch.arange(slots, device=cache.k.device)[None, :]
    return pos < cache.length[:, None]


def copy_blocks(cache: PagedKVCache, src: torch.Tensor, dst: torch.Tensor,
                *, stacked: bool = False) -> PagedKVCache:
    """Copy pool blocks ``src[i] -> dst[i]`` (copy-on-write forks), in
    place; ``stacked`` is the layer-leading layout (blocks at axis 1).  The
    sources are read before any destination is written."""
    src, dst = src.long(), dst.long()
    if stacked:
        cache.k[:, dst] = cache.k[:, src]
        cache.v[:, dst] = cache.v[:, src]
    else:
        cache.k[dst] = cache.k[src]
        cache.v[dst] = cache.v[src]
    return cache
