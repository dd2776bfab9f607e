"""The uniform decoder with the EAAS MoE FFN (counterpart of
``src/repro/models/transformer.py::_build_decoder``).

Parameters are nested dicts with the reference's keys and layouts (weights
``(in, out)``, used as ``x @ w``; per-layer leaves stacked on a leading
layer axis), so :mod:`repro_torch.bridge` maps the reference's params one
to one.  The reference's ``lax.scan`` over stacked blocks is a loop over
the layer axis here; the dense prefix (``first_k_dense``) runs first.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import moe_layer as eaas
from repro_torch.core.moe_layer import MoERuntime, MoEStats
from repro_torch.models import attention as attn
from repro_torch.models import kv_cache as kvc
from repro_torch.models.common import (dense_init, embed_init, rms_norm,
                                       resolve_dtype)
from repro_torch.models.mlp import init_mlp, mlp


class Model(NamedTuple):
    cfg: ModelConfig
    init_params: Callable      # (generator) -> params
    prefill: Callable          # (params, tokens, rt, max_slots) -> (logits, cache, stats)
    decode_step: Callable      # (params, token, cache, rt) -> (logits, cache, stats)
    init_cache: Callable       # (batch, max_slots) -> cache
    num_servers: int
    # (params, tokens, cache, start, rt) -> (logits, cache, stats)
    prefill_chunk: Callable
    # (num_blocks, block_size, batch, max_slots) -> paged cache
    init_paged_cache: Callable


def build_model(cfg: ModelConfig, num_servers: int, redundant_table,
                device) -> Model:
    if cfg.family not in ("moe", "dense") or cfg.local_global_pattern:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    return _build_decoder(cfg, num_servers, redundant_table, device)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked params dict (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _sum_stats(stats, cfg: ModelConfig, device) -> MoEStats:
    if not stats:
        E = cfg.moe.num_experts if cfg.moe else 1
        z = torch.zeros((), device=device)
        zi = torch.zeros((), dtype=torch.int64, device=device)
        return MoEStats(z, z, zi, zi, torch.zeros(E, dtype=torch.int64,
                                                  device=device))
    return MoEStats(*[sum(v) for v in zip(*stats)])


def _ffn(p: Dict, cfg: ModelConfig, h: torch.Tensor, rt: MoERuntime,
         stats: list) -> torch.Tensor:
    if "moe" not in p:
        return mlp(p["mlp"], h, cfg.activation)
    B, S, d = h.shape
    y, st = eaas.eaas_moe_apply(p["moe"], h.reshape(B * S, d), cfg.moe, rt,
                                activation=cfg.activation)
    stats.append(st)
    return y.reshape(B, S, d)


def _block_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: kvc.KVCache,
                   rt: MoERuntime, stats: list) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    h, (k, v) = attn.full_attention(p["attn"], cfg, h, positions,
                                    return_kv=True)
    kvc.write_prefill(cache, k, v)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    return x + _ffn(p, cfg, h, rt, stats)


def _block_prefill_chunk(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                         start: int, cache, rt: MoERuntime,
                         stats: list) -> torch.Tensor:
    """One block over a prompt chunk: attention against the cache (which
    holds every earlier chunk), the chunk's K/V written in."""
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    h, _ = attn.chunk_attention(p["attn"], cfg, h, cache, start)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    return x + _ffn(p, cfg, h, rt, stats)


def _block_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: kvc.KVCache, rt: MoERuntime,
                  stats: list) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    h, _ = attn.decode_attention(p["attn"], cfg, h, cache)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    return x + _ffn(p, cfg, h, rt, stats)


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = (x @ head).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _build_decoder(cfg: ModelConfig, num_servers: int, redundant_table,
                   device) -> Model:
    """Uniform decoder (+ the dense prefix of a first_k_dense MoE)."""
    m = cfg.moe
    n_dense = m.first_k_dense if m else 0
    n_main = cfg.num_layers - n_dense
    dt = resolve_dtype(cfg.dtype)
    groups = (("dense", "dense_blocks", n_dense), ("blocks", "blocks", n_main))

    def init_blocks(n: int, is_moe: bool, gen) -> Dict:
        d = cfg.d_model
        p = {"ln1": torch.ones((n, d), device=device),
             "ln2": torch.ones((n, d), device=device),
             "attn": attn.init_attention(cfg, dt, device, gen, (n,))}
        if is_moe:
            p["moe"] = eaas.init_eaas_moe(cfg, num_servers, redundant_table,
                                          dt, device, gen, (n,))
        else:
            p["mlp"] = init_mlp(d, cfg.d_ff, cfg.activation, dt, device,
                                gen, (n,))
        return p

    def init_params(generator: Optional[torch.Generator]) -> Dict:
        """Weights drawn on ``device`` with the reference's distributions
        (not its numbers: jax.random cannot be reproduced in torch)."""
        p = {"embed": embed_init(cfg.padded_vocab, cfg.d_model, dt, device,
                                 generator),
             "final_ln": torch.ones(cfg.d_model, device=device),
             "blocks": init_blocks(n_main, m is not None, generator)}
        if n_dense:
            p["dense_blocks"] = init_blocks(n_dense, False, generator)
        if not cfg.tie_embeddings:
            p["head"] = dense_init((cfg.d_model, cfg.padded_vocab), dt,
                                   device, generator)
        return p

    def init_cache(batch: int, max_slots: int) -> Dict:
        return {name: kvc.init_kv_cache(batch, max_slots, cfg.num_kv_heads,
                                        cfg.head_dim, dt, device, layers=n)
                for name, _, n in groups if n}

    def init_paged_cache(num_blocks: int, block_size: int, batch: int,
                         max_slots: int) -> Dict:
        """Block-pool cache: every layer has its own pool; one logical
        block id addresses the same slot of every layer's pool, so the
        host keeps one block table per sequence."""
        if max_slots % block_size:
            raise ValueError(f"max_slots={max_slots} must be a multiple of "
                             f"block_size={block_size}")
        return {name: kvc.init_paged_kv_cache(
                    num_blocks, block_size, batch, max_slots // block_size,
                    cfg.num_kv_heads, cfg.head_dim, dt, device, layers=n)
                for name, _, n in groups if n}

    def prefill(params, tokens: torch.Tensor, rt: MoERuntime,
                max_slots: Optional[int] = None):
        """tokens (B, S) -> (last-position logits (B, V) fp32, cache, stats)."""
        B, S = tokens.shape
        cache = init_cache(B, max_slots or S)
        x = params["embed"][tokens]
        pos = torch.arange(S, device=tokens.device)
        stats = []
        for name, pname, n in groups:
            for i in range(n):
                x = _block_prefill(_layer(params[pname], i), cfg, x, pos,
                                   cache[name].layer(i), rt, stats)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_logits(params, cfg, x[:, -1]), cache,
                _sum_stats(stats, cfg, tokens.device))

    def prefill_chunk(params, tokens: torch.Tensor, cache: Dict, start: int,
                      rt: MoERuntime):
        """Continue a prefill: prompt positions [start, start + C) against a
        cache (dense or paged) already holding [0, start); written in
        place.  Returns (last-position logits (B, V) fp32, cache, stats)."""
        x = params["embed"][tokens]
        stats = []
        for name, pname, n in groups:
            for i in range(n):
                x = _block_prefill_chunk(_layer(params[pname], i), cfg, x,
                                         start, cache[name].layer(i), rt,
                                         stats)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_logits(params, cfg, x[:, -1]), cache,
                _sum_stats(stats, cfg, tokens.device))

    def decode_step(params, token: torch.Tensor, cache: Dict,
                    rt: MoERuntime):
        """token (B, 1) -> (logits (B, V) fp32, cache (in place), stats)."""
        x = params["embed"][token]
        stats = []
        for name, pname, n in groups:
            for i in range(n):
                x = _block_decode(_layer(params[pname], i), cfg, x,
                                  cache[name].layer(i), rt, stats)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_logits(params, cfg, x[:, 0]), cache,
                _sum_stats(stats, cfg, token.device))

    return Model(cfg, init_params, prefill, decode_step, init_cache,
                 num_servers, prefill_chunk, init_paged_cache)
