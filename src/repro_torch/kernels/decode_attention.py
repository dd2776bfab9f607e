"""Flash-decode GQA attention over a dense or a paged KV cache.

One new token per sequence: ``q (B, H, hd)`` attends over its cache with
``G = H / KV`` query heads per KV head, scale ``1/sqrt(hd)``, fp32 online
softmax, positions ``>= lengths[b]`` masked.  Two variants, as in
``src/repro/kernels/decode_attention.py``:

* dense, replacing ``flash_decode_pallas``: ``k/v (B, S, KV, hd)``;
* paged, replacing ``paged_flash_decode_pallas``: one shared pool
  ``k/v (num_blocks, bs, KV, hd)``; sequence ``b``'s position ``p`` lives
  in pool block ``tables[b, p // bs]`` at offset ``p % bs``.

CUDA kernels (``csrc/flash_decode.cu``, ``csrc/paged_flash_decode.cu``,
one body in ``csrc/decode_attention.cuh``): one block per
``(b, kv_head)`` holding the G query heads of that KV head, one warp per
head (several heads per warp when G > 8).  A loop over logical positions
in 32-slot tiles stages K and V in shared memory; each lane scores one
slot, warp shuffles give the tile max and sum, and the fp32 accumulator
lives in registers.  The paged kernel stages its table row in shared
memory and resolves each slot's address through it, so its output is
bitwise the dense kernel's over the gathered view.  The loop stops at the
length clamped to the cache width — the clamp matters because the engine
decodes idle slots too, whose lengths grow past it.

What bounds it on an H100: the K/V bytes of the valid prefix (3.35 TB/s);
the operations are ~1 per byte.  With ``B * KV`` = 64 blocks at the
full-width deepseek-r1 decode shape, half the 132 SMs idle: a split over
the cache (flash-decoding's second pass) is later work.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

TS = 32            # cache slots per tile (one per lane)


def flash_decode_torch(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: materialized scores, masked softmax, in fp32."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float())
    scores = scores / math.sqrt(hd)
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


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
    req(hd <= 128 and G <= 32 and G * hd <= 2048,
        f"{name}: needs hd <= 128, G <= 32 and G*hd <= 2048 "
        f"(hd={hd}, G={G})")
    req(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
        f"{name}: q, k and v must be contiguous")
    return B, H, hd, KV, G


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync)."""
    B, H, hd, KV, G = _check_inputs("flash_decode", q, k_cache, v_cache,
                                    lengths)
    build.require(k_cache.shape[0] == B and lengths.shape == (B,),
                  f"flash_decode: k{tuple(k_cache.shape)} and "
                  f"lengths{tuple(lengths.shape)} need batch {B}")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = build.load_library()
    err = lib.flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, k_cache.shape[1], KV, G, hd,
        build.dtype_code(q.dtype), build.stream_of(q))
    build.check(err, "flash_decode")
    build.count("flash_decode")
    return out


def paged_flash_decode_torch(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_tables: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the block-table view, then the dense plain
    version (``ref.paged_flash_decode_ref``'s definition)."""
    B, mb = block_tables.shape
    bs, KV, hd = k_pool.shape[1:]
    idx = block_tables.long()
    k = k_pool[idx].reshape(B, mb * bs, KV, hd)
    v = v_pool[idx].reshape(B, mb * bs, KV, hd)
    return flash_decode_torch(q, k, v, lengths)


def paged_flash_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Launch the paged CUDA kernel on the current stream (no sync).

    Table entries are not range-checked here (that would need a device
    sync); the engine's tables come from the host block pool, whose ids
    are always below ``num_blocks``."""
    B, H, hd, KV, G = _check_inputs("paged_flash_decode", q, k_pool, v_pool,
                                    block_tables, lengths)
    build.require(
        block_tables.dim() == 2 and block_tables.shape[0] == B
        and lengths.shape == (B,),
        f"paged_flash_decode: tables{tuple(block_tables.shape)} and "
        f"lengths{tuple(lengths.shape)} need batch {B}")
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    build.require(
        1 <= mb <= 4096 and mb * bs < 2 ** 31,
        f"paged_flash_decode: needs 1 <= max_blocks <= 4096 and "
        f"max_blocks*bs < 2**31 (max_blocks={mb}, bs={bs})")
    tables = block_tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = build.load_library()
    err = lib.paged_flash_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, mb, bs,
        KV, G, hd, build.dtype_code(q.dtype), build.stream_of(q))
    build.check(err, "paged_flash_decode")
    build.count("paged_flash_decode")
    return out
