"""Flash-decode GQA attention over a dense KV cache.

One new token per sequence: ``q (B, H, hd)`` attends over
``k/v (B, S, KV, hd)`` with ``G = H / KV`` query heads per KV head, scale
``1/sqrt(hd)``, fp32 online softmax, positions ``>= lengths[b]`` masked.

Replaces ``src/repro/kernels/decode_attention.py::flash_decode_pallas``
(the dense variant; ``paged_flash_decode_pallas`` is not ported yet).

CUDA kernel (``csrc/flash_decode.cu``): one block per ``(b, kv_head)``
holding the G query heads of that KV head, one warp per head (several heads
per warp when G > 8).  A loop over the cache in 32-slot tiles stages K and
V in shared memory; each lane scores one slot, warp shuffles give the tile
max and sum, and the fp32 accumulator lives in registers.  The loop stops
at ``min(lengths[b], S)`` — the clamp matters because the engine decodes
idle slots too, whose lengths grow past S.

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


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync)."""
    req = build.require
    req(q.is_cuda and all(t.device == q.device
                          for t in (k_cache, v_cache, lengths)),
        "flash_decode: all inputs must be on one CUDA device")
    req(q.dim() == 3 and k_cache.dim() == 4
        and k_cache.shape == v_cache.shape
        and k_cache.shape[0] == q.shape[0]
        and k_cache.shape[3] == q.shape[2]
        and lengths.shape == (q.shape[0],),
        f"flash_decode: shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
        f"v{tuple(v_cache.shape)} lengths{tuple(lengths.shape)}")
    req(q.dtype == k_cache.dtype == v_cache.dtype,
        f"flash_decode: dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    req(G * KV == H, f"flash_decode: H={H} not a multiple of KV={KV}")
    req(hd <= 128 and G <= 32 and G * hd <= 2048,
        f"flash_decode: needs hd <= 128, G <= 32 and G*hd <= 2048 "
        f"(hd={hd}, G={G})")
    req(q.is_contiguous() and k_cache.is_contiguous()
        and v_cache.is_contiguous(),
        "flash_decode: q, k and v must be contiguous")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = build.load_library()
    err = lib.flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, S, KV, G, hd,
        build.dtype_code(q.dtype), build.stream_of(q))
    build.check(err, "flash_decode")
    build.count("flash_decode")
    return out
