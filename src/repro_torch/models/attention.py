"""GQA attention: full (prefill, optional sliding window, causal or
bidirectional), chunked prefill, one-token decode against a dense, ring or
paged cache, and whisper's cross-attention.

RoPE (or Qwen2-VL's M-RoPE) is applied to q/k before the keys are cached,
so cached keys are already rotated and a sliding-window ring needs no
reordering.  Gemma-style logit softcap caps the scaled scores wherever the
reference applies it.  ``decode_attention`` computes its core through
``ops.flash_decode`` (dense or ring cache) or ``ops.paged_flash_decode``
(block pool) — the CUDA kernels on the card, their plain versions on the
CPU; the softcap is the kernels' own argument.  Cross-attention against the cached encoder
K/V is a one-token decode with every position valid: it runs through
``ops.flash_decode`` with lengths filled with the encoder length.

Under a tensor-parallel layout (``tp``) the self- and cross-attention's
projections are this rank's columns of wq / wk / wv and rows of wo:
attention runs on this rank's heads, or, where a rank's columns hold no
whole head, on every head gathered (:func:`_route`), its output split
back to this rank's columns for wo.

Sequence-parallel decode (a cache sharded over slots on a mesh):
:func:`decode_attention_partial` computes one shard's open softmax through
``ops.flash_decode_partial``, and :func:`combine_partial_attention` merges
the shards with one ``all_reduce`` MAX and two SUMs.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as kvc
from repro_torch.models.common import (dense_init, remat_if_recording,
                                       softcap)
from repro_torch.models.rope import (apply_rope, mrope_cos_sin, rope_cos_sin,
                                     text_mrope_positions)

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


def _rope_for(cfg: ModelConfig, positions: torch.Tensor,
              mrope_positions=None):
    """cos / sin for ``positions (b, s)``: M-RoPE when the config has
    sections (text positions unless ``mrope_positions (3, b, s)`` is
    given), standard RoPE otherwise."""
    if cfg.mrope_sections is not None:
        pos3 = (mrope_positions if mrope_positions is not None
                else text_mrope_positions(positions))
        return mrope_cos_sin(pos3, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


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


def _dense_core(cfg, q, k, v, q_pos, k_pos, *, is_local: bool = False,
                causal: bool = True):
    """Materialized scores (soft-capped when the config says so), causal
    unless ``causal=False``; ``is_local`` masks keys ``sliding_window`` or
    more positions back; returns (b, sq, H, hd) fp32."""
    scores = _gqa_scores(q, k) / math.sqrt(cfg.head_dim)
    if cfg.attn_logit_softcap:
        scores = softcap(scores, cfg.attn_logit_softcap)
    i = q_pos[:, None, None, :, None]
    j = k_pos[:, None, None, None, :]
    mask = j <= i if causal else torch.ones_like(j <= i)
    if is_local and cfg.sliding_window:
        mask &= (i - j) < cfg.sliding_window
    scores = torch.where(mask, scores, NEG_INF)
    return _gqa_out(torch.softmax(scores, dim=-1), v)


def _chunked_core(cfg, q, k, v, positions, *, is_local: bool = False,
                  causal: bool = True, q_blocks: int):
    """The reference's q-block scan: same math, one q block at a time.
    Under autograd each block is checkpointed, as the reference's
    ``jax.checkpoint(body)``: its fp32 scores and probabilities are
    recomputed in the backward, not kept between blocks (the
    flash-attention memory profile).  Without grad, plain calls."""
    b, s = q.shape[:2]
    bq = s // q_blocks
    outs = [remat_if_recording(_dense_core, cfg, q[:, i * bq:(i + 1) * bq],
                               k, v, positions[:, i * bq:(i + 1) * bq],
                               positions, is_local=is_local, causal=causal)
            for i in range(q_blocks)]
    return torch.cat(outs, dim=1)


def full_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, *, is_local: bool = False,
                   mrope_positions=None, causal: bool = True,
                   return_kv: bool = False, q_blocks: int = 16, tp=None):
    """Self-attention over the whole sequence (prefill).

    x (b, s, d); positions (b, s) or (s,) int.  ``is_local`` applies the
    config's sliding window (gemma3's local layers); ``mrope_positions (3,
    b, s)`` are an M-RoPE config's (t, h, w) ids (text positions if None);
    ``causal=False`` is the bidirectional encoder (whisper); ``return_kv``
    also returns the rotated (k, v) of every head for the cache fill.
    ``tp``: a :class:`~repro_torch.distributed.tensor_parallel.Layout`
    whose phase cuts the projections (``att_col`` / ``att_row``) over
    ``model``: this rank's columns of wq / wk / wv and rows of wo.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v, heads = _project(params, cfg, x, tp)
    if positions.dim() == 1:
        positions = positions[None].expand(b, s)
    cos, sin = _rope_for(cfg, positions, mrope_positions)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if s >= CHUNKED_ATTN_THRESHOLD and s % q_blocks == 0:
        out = _chunked_core(cfg, q, k, v, positions, is_local=is_local,
                            causal=causal, q_blocks=q_blocks)
    else:
        out = _dense_core(cfg, q, k, v, positions, positions,
                          is_local=is_local, causal=causal)
    out = _out_proj(out.reshape(b, s, q.shape[2] * hd).to(x.dtype),
                    params, tp, heads)
    if return_kv:
        return out, _whole_heads(k, v, tp, heads)
    return out


def _route(cfg: ModelConfig, tp):
    """How a layout cuts the attention projections: None (whole weights),
    "local" (this rank's heads of column-parallel projections) or
    "gathered" (a rank's columns hold no whole head, as 2 KV heads over 4
    ranks: the columns gathered to every head, attention computed whole on
    every rank)."""
    if tp is None or not tp.attention_cut():
        return None
    return "local" if tp.whole_heads(cfg) else "gathered"


def _heads(t: torch.Tensor, n: int, hd: int, tp, route) -> torch.Tensor:
    """A projection's columns (this rank's block under a cut) split into
    heads: this rank's ``n / n_model`` heads ("local") or all ``n``, the
    blocks gathered ("gathered")."""
    if route == "local":
        n //= tp.n_model
    elif route == "gathered":
        t = tpl.gather(t, -1, tp.model)
    return _split_heads(t, n, hd)


def _out_proj(out: torch.Tensor, params: Dict, tp, route) -> torch.Tensor:
    """``wo`` over the heads' outputs (b, s, heads·hd): whole, or
    row-parallel over this rank's heads (every head's output split to this
    rank's columns first under "gathered")."""
    if route is None:
        return out @ params["wo"]
    if route == "gathered":
        out = tpl.split(out, -1, tp.model)
    return tpl.row_linear(out, params["wo"], tp.model)


def _whole_heads(k: torch.Tensor, v: torch.Tensor, tp, route):
    """(k, v) of every head, for a cache: this rank's heads gathered under
    "local"."""
    if route == "local":
        return tpl.gather(k, 2, tp.model), tpl.gather(v, 2, tp.model)
    return k, v


def _project(params: Dict, cfg: ModelConfig, x: torch.Tensor, tp):
    """(q, k, v) split into heads, and how they are cut (:func:`_route`):
    one ``copy_to`` of x for the three column-parallel projections."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    route = _route(cfg, tp)
    if route is not None:
        x = tpl.copy_to(x, tp.model)
    return (*(_heads(x @ params[w], n, hd, tp, route)
              for w, n in (("wq", h), ("wk", kvh), ("wv", kvh))), route)


def chunk_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    cache, start):
    """Prefill one prompt chunk against the cache (chunked prefill).

    x (b, chunk, d) holds global positions ``start + arange(chunk)``:
    ``start`` is a 0-d int tensor on x's device, as the reference's traced
    ``start`` (a CUDA graph reads it from a static buffer, so one capture
    serves every start), or an int; the positions, the causal mask and
    the rotation (an M-RoPE config's as text, as the reference does) are
    computed from it on the device.
    The chunk's rotated K/V are written at ``start`` and its queries
    attend over every cached position ``<=`` their own, earlier chunks
    included.  A :class:`~repro_torch
    .models.kv_cache.PagedKVCache` is written through the block table and
    attended over the gathered view, which holds prefix-cache blocks an
    earlier request wrote.  Returns (output (b, chunk, d), cache).
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], h, hd)
    k = _split_heads(x @ params["wk"], kvh, hd)
    v = _split_heads(x @ params["wv"], kvh, hd)
    pos_b = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    cos, sin = _rope_for(cfg, pos_b)
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
    """One-token decode: x (b, 1, d) against a dense cache, a sliding
    window's ring or a block pool (K/V written in place).  The paged branch
    runs the paged kernel on the pool itself, not on a gathered copy.  A
    ring needs no local flag: it holds only the window, and the kernel's
    ``min(length, slots)`` is its valid count.

    Returns (output (b, 1, d), cache).
    """
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ params["wq"], h, hd)            # (b, 1, H, hd)
    k = _split_heads(x @ params["wk"], kvh, hd)
    v = _split_heads(x @ params["wv"], kvh, hd)
    cos, sin = _rope_for(cfg, cache.length[:, None])
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    cap = cfg.attn_logit_softcap or 0.0
    if isinstance(cache, kvc.PagedKVCache):
        cache = kvc.paged_append_decode(cache, k, v)
        out = ops.paged_flash_decode(q[:, 0], cache.k, cache.v,
                                     cache.block_tables, cache.length,
                                     softcap=cap)
    else:
        cache = kvc.append_decode(cache, k, v)
        # lengths may exceed the slots (idle rows, a wrapped ring): the
        # kernel clamps
        out = ops.flash_decode(q[:, 0], cache.k, cache.v, cache.length,
                               softcap=cap)
    return out.reshape(b, 1, h * hd) @ params["wo"], cache


def decode_attention_partial(params: Dict, cfg: ModelConfig,
                             q: torch.Tensor, cache: kvc.KVCache):
    """Flash-decode partial pass over a cache shard.  q (b, 1, H, hd)
    already rotated; the shard's ``length`` counts its valid slots (a
    prefix).  Returns (acc (b, 1, H, hd) unnormalised sum of p v, m
    (b, 1, H, 1), l (b, 1, H, 1)), fp32, as the reference's."""
    b, _, h, hd = q.shape
    acc, m, l = ops.flash_decode_partial(q[:, 0], cache.k, cache.v,
                                         cache.length)
    return acc[:, None], m.reshape(b, 1, h, 1), l.reshape(b, 1, h, 1)


def combine_partial_attention(acc: torch.Tensor, m: torch.Tensor,
                              l: torch.Tensor, group) -> torch.Tensor:
    """Combine flash-decode partials across the ranks of ``group``: the
    global max (one ``all_reduce`` MAX), then the scaled sums of acc and l
    (one SUM over both, side by side), normalised as the flash-decode
    kernel normalises (times the reciprocal of the sum), so that one shard
    gives the kernel's output bit for bit."""
    g_m = m.clone()
    dist.all_reduce(g_m, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - g_m)
    sums = torch.cat([acc * scale, l * scale], dim=-1)
    dist.all_reduce(sums, group=group)
    num, den = sums[..., :-1], sums[..., -1:]
    return num * torch.reciprocal(torch.clamp(den, min=1e-30))


# ------------------------------------------------------------- cross-attn

def init_cross_attention(cfg: ModelConfig, dtype, device, generator,
                         lead=()) -> Dict:
    return init_attention(cfg, dtype, device, generator, lead)


def cross_kv(params: Dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder output's K and V (b, S_enc, KV, hd), unrotated."""
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    return (_split_heads(enc_out @ params["wk"], kvh, hd),
            _split_heads(enc_out @ params["wv"], kvh, hd))


def _cross_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                dtype) -> torch.Tensor:
    """Unmasked attention of q (b, s, H, hd) over k / v (b, S_enc, KV, hd)
    in fp32, rounded to ``dtype``: (b, s, H·hd)."""
    b, s, h, hd = q.shape
    p = torch.softmax(_gqa_scores(q, k) / math.sqrt(hd), dim=-1)
    return _gqa_out(p, v).to(dtype).reshape(b, s, h * hd)


def cross_attention_plain(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention of x's queries (b, s, d) over encoder K/V,
    materialized in fp32 (the reference's ``cross_attention_cached``)."""
    q = _split_heads(x @ params["wq"], cfg.num_heads, cfg.head_dim)
    return _cross_core(q, k, v, x.dtype) @ params["wo"]


def cross_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    enc_out: torch.Tensor, tp=None,
                    return_kv: bool = False):
    """Decoder cross-attention over a prompt (whisper's prefill): queries
    from x (b, s, d), K/V from enc_out (b, S_enc, d); no RoPE, no mask.
    Plain PyTorch, as in the reference.  ``tp``: a layout that cuts the
    cross projections as the self-attention's (:func:`_route`: this
    rank's heads, or every head gathered when its columns hold no whole
    head); ``return_kv`` also returns the encoder's K/V of every head for
    the cache."""
    route = _route(cfg, tp)
    if route is None:
        k, v = cross_kv(params, cfg, enc_out)
        out = cross_attention_plain(params, cfg, x, k, v)
        return (out, (k, v)) if return_kv else out
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xg, eg = tpl.copy_to(x, tp.model), tpl.copy_to(enc_out, tp.model)
    q = _heads(xg @ params["wq"], h, hd, tp, route)
    k = _heads(eg @ params["wk"], kvh, hd, tp, route)
    v = _heads(eg @ params["wv"], kvh, hd, tp, route)
    out = _out_proj(_cross_core(q, k, v, x.dtype), params, tp, route)
    if return_kv:
        return out, _whole_heads(k, v, tp, route)
    return out


def cross_attention_cached(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor = None) -> torch.Tensor:
    """Cross-attention of one decode token x (b, 1, d) against the cached
    encoder K/V (b, S_enc, KV, hd): ``ops.flash_decode`` with every
    position valid (``lengths``, filled with S_enc when not given).  More
    than one query runs the plain core."""
    b, s, _ = x.shape
    if s != 1:
        return cross_attention_plain(params, cfg, x, k, v)
    h, hd = cfg.num_heads, cfg.head_dim
    if lengths is None:
        lengths = torch.full((b,), k.shape[1], dtype=torch.int32,
                             device=x.device)
    q = (x @ params["wq"]).reshape(b, h, hd)
    out = ops.flash_decode(q, k, v, lengths)
    return out.reshape(b, 1, h * hd) @ params["wo"]
