"""GQA attention: full (prefill), chunked prefill and one-token decode,
against a dense or a paged cache.

RoPE is applied to q/k before the keys are cached.  ``decode_attention``
computes its core through ``ops.flash_decode`` (dense cache) or
``ops.paged_flash_decode`` (block pool) — the CUDA kernels on the card,
their plain versions on the CPU.  Softcap, sliding-window and M-RoPE
attention are not ported (no ported config uses them).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as kvc
from repro_torch.models.common import dense_init
from repro_torch.models.rope import apply_rope, rope_cos_sin

NEG_INF = -1e30
# sequences at or above this length run the q-block loop, so (S, S) score
# matrices never materialize
CHUNKED_ATTN_THRESHOLD = 2048


def init_attention(cfg: ModelConfig, dtype, device, generator,
                   lead=()) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init((*lead, d, h * hd), dtype, device, generator),
        "wk": dense_init((*lead, d, kv * hd), dtype, device, generator),
        "wv": dense_init((*lead, d, kv * hd), dtype, device, generator),
        "wo": dense_init((*lead, h * hd, d), dtype, device, generator),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_logit_softcap or cfg.sliding_window or cfg.mrope_sections:
        raise NotImplementedError(
            "softcap, sliding-window and M-RoPE attention are not ported")


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (b, sq, H, hd), k (b, sk, KV, hd) -> (b, KV, G, sq, sk) fp32."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, sq, kvh, h // kvh, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (b, KV, G, sq, sk), v (b, sk, KV, hd) -> (b, sq, H, hd) fp32."""
    b, kvh, g, sq, sk = p.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(b, sq, kvh * g, v.shape[-1])


def _dense_core(cfg, q, k, v, q_pos, k_pos):
    """Causal, materialized scores; returns (b, sq, H, hd) fp32."""
    scores = _gqa_scores(q, k) / math.sqrt(cfg.head_dim)
    i = q_pos[:, None, None, :, None]
    j = k_pos[:, None, None, None, :]
    scores = torch.where(j <= i, scores, NEG_INF)
    return _gqa_out(torch.softmax(scores, dim=-1), v)


def _chunked_core(cfg, q, k, v, positions, *, q_blocks: int):
    """The reference's q-block scan: same math, one q block at a time."""
    b, s = q.shape[:2]
    bq = s // q_blocks
    outs = [_dense_core(cfg, q[:, i * bq:(i + 1) * bq], k, v,
                        positions[:, i * bq:(i + 1) * bq], positions)
            for i in range(q_blocks)]
    return torch.cat(outs, dim=1)


def full_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, *, return_kv: bool = False,
                   q_blocks: int = 16):
    """Causal self-attention over the whole sequence (prefill).

    x (b, s, d); positions (b, s) or (s,) int.  ``return_kv`` also returns
    the rotated (k, v) for the cache fill.
    """
    _check_supported(cfg)
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], kvh, hd)
    v = _split_heads(x @ params["wv"], kvh, hd)
    if positions.dim() == 1:
        positions = positions[None].expand(b, s)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if s >= CHUNKED_ATTN_THRESHOLD and s % q_blocks == 0:
        out = _chunked_core(cfg, q, k, v, positions, q_blocks=q_blocks)
    else:
        out = _dense_core(cfg, q, k, v, positions, positions)
    out = out.reshape(b, s, h * hd).to(x.dtype) @ params["wo"]
    return (out, (k, v)) if return_kv else out


def chunk_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    cache, start: int):
    """Prefill one prompt chunk against the cache (chunked prefill).

    x (b, chunk, d) holds global positions ``start + arange(chunk)`` (the
    reference passes those positions; a host int avoids a device sync).
    The chunk's rotated K/V are written at ``start`` and its queries
    attend over every cached position ``<=`` their own, earlier chunks
    included.  A :class:`~repro_torch
    .models.kv_cache.PagedKVCache` is written through the block table and
    attended over the gathered view, which holds prefix-cache blocks an
    earlier request wrote.  Returns (output (b, chunk, d), cache).
    """
    _check_supported(cfg)
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], kvh, hd)
    v = _split_heads(x @ params["wv"], kvh, hd)
    pos_b = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    cos, sin = rope_cos_sin(pos_b, hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if isinstance(cache, kvc.PagedKVCache):
        cache = kvc.paged_write_chunk(cache, k, v, start)
        ck, cv = kvc.gather_blocks(cache)
    else:
        cache = kvc.write_chunk(cache, k, v, start)
        ck, cv = cache.k, cache.v
    k_pos = torch.arange(ck.shape[1], device=x.device)[None].expand(b, -1)
    out = _dense_core(cfg, q, ck, cv, pos_b, k_pos)
    return out.reshape(b, s, h * hd).to(x.dtype) @ params["wo"], cache


def decode_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache):
    """One-token decode: x (b, 1, d) against a dense cache or a block pool
    (K/V written in place).  The paged branch runs the paged kernel on the
    pool itself, not on a gathered copy.

    Returns (output (b, 1, d), cache).
    """
    _check_supported(cfg)
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], h, hd)            # (b, 1, H, hd)
    k = _split_heads(x @ params["wk"], kvh, hd)
    v = _split_heads(x @ params["wv"], kvh, hd)
    cos, sin = rope_cos_sin(cache.length[:, None], hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if isinstance(cache, kvc.PagedKVCache):
        cache = kvc.paged_append_decode(cache, k, v)
        out = ops.paged_flash_decode(q[:, 0], cache.k, cache.v,
                                     cache.block_tables, cache.length)
    else:
        cache = kvc.append_decode(cache, k, v)
        # lengths may exceed the slots for idle rows: the kernel clamps
        out = ops.flash_decode(q[:, 0], cache.k, cache.v, cache.length)
    return out.reshape(b, 1, h * hd) @ params["wo"], cache
