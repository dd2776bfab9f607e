"""Flash-decode GQA attention over a dense or a paged KV cache.

One new token per sequence: ``q (B, H, hd)`` attends over its cache with
``G = H / KV`` query heads per KV head, scale ``1/sqrt(hd)``, an optional
softcap (``cap * tanh(s / cap)`` on the scaled scores, before the mask, as
``src/repro/models/attention.py::decode_attention`` applies it), fp32
online softmax, positions ``>= lengths[b]`` masked.  Two variants, as in
``src/repro/kernels/decode_attention.py``:

* dense, replacing ``flash_decode_pallas``: ``k/v (B, S, KV, hd)``;
* paged, replacing ``paged_flash_decode_pallas``: one shared pool
  ``k/v (num_blocks, bs, KV, hd)``; sequence ``b``'s position ``p`` lives
  in pool block ``tables[b, p // bs]`` at offset ``p % bs``;
* partial, the dense variant's body with its softmax left open, for
  sequence-parallel decode over a cache shard (the reference computes that
  partial in jnp, ``src/repro/models/attention.py:244``
  ``decode_attention_partial``): ``(acc (B, H, hd), m (B, H), l (B, H))``
  in fp32 and natural-exp units — ``acc`` the unnormalised sum of p v, so
  shards combine as ``sum acc e^(m - M) / sum l e^(m - M)``.  A shard
  with no valid slot gives acc = 0, l = 0 and m = -1e30.

CUDA kernels (``csrc/flash_decode.cu``, ``csrc/paged_flash_decode.cu``,
one body in ``csrc/decode_attention.cuh``): split-KV flash-decoding in two
launches.  Pass 1 runs one block per ``(b, kv_head, chunk)``, a chunk being
:data:`SPLIT` logical positions; a chunk at or past the sequence's clamped
length returns at once, a live one loads q and its K/V tiles with 16-byte
``cp.async`` into shared memory and writes an fp32 partial
``(m, l, acc[G, hd])``.  In bfloat16 one warp runs the chunk on tensor
cores (``mma.sync.m16n8k16``: the G = 16 query heads of a KV head are the
M side; P enters P V as two bf16 parts, so it stays fp32 to ~2^-17 as in
the reference); in float32 the warps use FMAs, which keep the exact path
exact.  Any ``hd <= 256`` is taken, as the TPU kernel takes any (rows
staged zero-padded to the mma's k of 16, to 32 past 128; element-wise when
a row is not a 16-byte multiple); past 128 two warps share a chunk, each
owning half of the output columns (gemma3's hd = 256).  A sliding-window
layer's ring cache is read unchanged: keys are cached rotated, so slot
order does not matter, and the clamp ``min(length, S)`` is the ring's
valid count.
Pass 2 merges the partials of each ``(b, kv_head)`` in a fixed order (no
atomics: bitwise repeatable), launched as a programmatic dependent of pass
1 so that its launch overlaps it.  The paged kernel resolves each slot's
pool row once, from only the table entries its chunk covers; chunks are
cut in logical positions, so its output is bitwise the dense kernel's over
the gathered view.  Lengths are clamped to the cache width — the engine
decodes idle slots too, whose lengths grow past it.  The C entry points
size the grid from the view width; :func:`split_plan` is the same count,
which sizes the partials' scratch.  The partial entry runs the same two
passes with the output left out: pass 1 writes partials even with one
chunk, and pass 2 merges them into (acc, m, l) without normalising.

What bounds it on an H100: the K/V bytes of the valid prefix (3.35 TB/s);
the operations are ~1 per byte.  At the full-width deepseek-r1 decode shape
that bound is ~0.002 ms, below the latency of the two launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

SPLIT = 64         # logical positions per chunk; equal to csrc kSplit


def split_plan(view: int) -> int:
    """Chunks of the cache view of width ``view`` (S dense,
    ``max_blocks * bs`` paged): the grid's third axis (csrc
    ``split_count``).  A constant chunk width, not derived from the
    lengths (no host sync) or the SM count."""
    return max(1, -(-view // SPLIT))


def _scratch(q: torch.Tensor, KV: int, G: int, hd: int,
             nsplit: int) -> torch.Tensor:
    """Pass 1's fp32 partials: acc (B*KV*nsplit*G, hd) then (m, l) pairs;
    none when one chunk covers the view (pass 1 writes the output)."""
    if nsplit == 1:
        return torch.empty(0, dtype=torch.float32, device=q.device)
    rows = q.shape[0] * KV * nsplit * G
    return torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)


def flash_decode_torch(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lengths: torch.Tensor,
                       softcap: float = 0.0) -> torch.Tensor:
    """Plain version: materialized scores, masked softmax, in fp32."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float())
    scores = scores / math.sqrt(hd)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def flash_decode_partial_torch(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               softcap: float = 0.0):
    """Plain version of the partial: materialized scores in fp32; m the
    max valid score, l and acc the sums of exp(s - m) and exp(s - m) v
    (m = -1e30 and l = acc = 0 where no slot is valid)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float())
    scores = scores / math.sqrt(hd)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, None, :], scores, -math.inf)
    live = mask.any(dim=1)[:, None, None]
    m = torch.where(live, scores.amax(dim=-1), -1e30)
    p = torch.exp(scores - m[..., None])
    acc = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return acc.reshape(B, H, hd), m.reshape(B, H), p.sum(-1).reshape(B, H)


def _check_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *indices: torch.Tensor):
    """The checks both kernels share; returns (B, H, hd, KV, G)."""
    req = build.require
    req(q.is_cuda and all(t.device == q.device for t in (k, v, *indices)),
        f"{name}: all inputs must be on one CUDA device")
    req(q.dim() == 3 and k.dim() == 4 and k.shape == v.shape
        and k.shape[3] == q.shape[2],
        f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
        f"v{tuple(v.shape)}")
    req(q.dtype == k.dtype == v.dtype,
        f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    req(not any(t.is_floating_point() for t in indices),
        f"{name}: lengths and tables must be integers")
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    req(G * KV == H, f"{name}: H={H} not a multiple of KV={KV}")
    req(hd <= 256 and G <= 32 and G * hd <= 4096,
        f"{name}: needs hd <= 256, G <= 32 and G*hd <= 4096 "
        f"(hd={hd}, G={G})")
    req(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
        f"{name}: q, k and v must be contiguous")
    return B, H, hd, KV, G


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor,
                      softcap: float = 0.0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync).  It has no
    backward: under grad with an input that requires grad it raises."""
    build.refuse_grad("flash_decode", q, k_cache, v_cache)
    B, H, hd, KV, G = _check_inputs("flash_decode", q, k_cache, v_cache,
                                    lengths)
    build.require(k_cache.shape[0] == B and lengths.shape == (B,),
                  f"flash_decode: k{tuple(k_cache.shape)} and "
                  f"lengths{tuple(lengths.shape)} need batch {B}")
    S = k_cache.shape[1]
    build.require(B * S < 2 ** 31, f"flash_decode: B*S={B * S} >= 2**31")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    partial = _scratch(q, KV, G, hd, split_plan(S))
    lib = build.load_library()
    err = lib.flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), partial.data_ptr(), B, S, KV, G,
        hd, float(softcap), build.dtype_code(q.dtype), build.stream_of(q))
    build.check(err, "flash_decode")
    build.count("flash_decode")
    return out


def flash_decode_partial_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, lengths: torch.Tensor,
                              softcap: float = 0.0):
    """Launch the partial entry on the current stream (no sync): (acc
    (B, H, hd), m (B, H), l (B, H)) in fp32.  No backward: under grad
    with an input that requires grad it raises."""
    build.refuse_grad("flash_decode_partial", q, k_cache, v_cache)
    B, H, hd, KV, G = _check_inputs("flash_decode_partial", q, k_cache,
                                    v_cache, lengths)
    build.require(k_cache.shape[0] == B and lengths.shape == (B,),
                  f"flash_decode_partial: k{tuple(k_cache.shape)} and "
                  f"lengths{tuple(lengths.shape)} need batch {B}")
    S = k_cache.shape[1]
    build.require(B * S < 2 ** 31,
                  f"flash_decode_partial: B*S={B * S} >= 2**31")
    lengths = lengths.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, H, hd), **f32)
    m = torch.empty((B, H), **f32)
    l = torch.empty((B, H), **f32)
    partial = torch.empty(B * KV * split_plan(S) * G * (hd + 2), **f32)
    lib = build.load_library()
    err = lib.flash_decode_partial_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        partial.data_ptr(), B, S, KV, G, hd, float(softcap),
        build.dtype_code(q.dtype), build.stream_of(q))
    build.check(err, "flash_decode_partial")
    build.count("flash_decode_partial")
    return acc, m, l


def paged_flash_decode_torch(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_tables: torch.Tensor,
                             lengths: torch.Tensor,
                             softcap: float = 0.0) -> torch.Tensor:
    """Plain version: gather the block-table view, then the dense plain
    version (``ref.paged_flash_decode_ref``'s definition)."""
    B, mb = block_tables.shape
    bs, KV, hd = k_pool.shape[1:]
    idx = block_tables.long()
    k = k_pool[idx].reshape(B, mb * bs, KV, hd)
    v = v_pool[idx].reshape(B, mb * bs, KV, hd)
    return flash_decode_torch(q, k, v, lengths, softcap)


def paged_flash_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor,
                            softcap: float = 0.0) -> torch.Tensor:
    """Launch the paged CUDA kernel on the current stream (no sync).

    Table entries are not range-checked here (that would need a device
    sync); the engine's tables come from the host block pool, whose ids
    are always below ``num_blocks``.  No backward: under grad with an
    input that requires grad it raises."""
    build.refuse_grad("paged_flash_decode", q, k_pool, v_pool)
    B, H, hd, KV, G = _check_inputs("paged_flash_decode", q, k_pool, v_pool,
                                    block_tables, lengths)
    build.require(
        block_tables.dim() == 2 and block_tables.shape[0] == B
        and lengths.shape == (B,),
        f"paged_flash_decode: tables{tuple(block_tables.shape)} and "
        f"lengths{tuple(lengths.shape)} need batch {B}")
    nb, bs = k_pool.shape[:2]
    mb = block_tables.shape[1]
    build.require(
        mb >= 1 and mb * bs < 2 ** 31 and nb * bs < 2 ** 31,
        f"paged_flash_decode: needs max_blocks >= 1, max_blocks*bs < 2**31 "
        f"and num_blocks*bs < 2**31 (max_blocks={mb}, bs={bs}, "
        f"num_blocks={nb})")
    tables = block_tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    partial = _scratch(q, KV, G, hd, split_plan(mb * bs))
    lib = build.load_library()
    err = lib.paged_flash_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        partial.data_ptr(), B, mb, bs, KV, G, hd, float(softcap),
        build.dtype_code(q.dtype), build.stream_of(q))
    build.check(err, "paged_flash_decode")
    build.count("paged_flash_decode")
    return out
