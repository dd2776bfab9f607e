"""GQA attention: full (prefill) and one-token decode against a dense cache.

RoPE is applied to q/k before the keys are cached.  ``decode_attention``
computes its core through ``ops.flash_decode`` (the CUDA kernel on the
card, its plain version on the CPU) whenever there is no logit softcap and
no sliding window — always the case for the ported configs.
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


def decode_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: kvc.KVCache):
    """One-token decode: x (b, 1, d) against the cache (updated in place).

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
    cache = kvc.append_decode(cache, k, v)
    # lengths may exceed the slots for idle rows: the kernel clamps
    out = ops.flash_decode(q[:, 0], cache.k, cache.v, cache.length)
    return out.reshape(b, 1, h * hd) @ params["wo"], cache
