"""The decoder families (counterpart of ``src/repro/models/transformer.py``):

* ``_build_decoder`` — the uniform decoder with a dense or an EAAS MoE FFN
  (MoE, dense and the Qwen2-VL backbone with M-RoPE); a ``first_k_dense``
  prefix runs first;
* ``_build_local_global`` — gemma3: groups of ``local_global_pattern``
  sliding-window layers plus one global layer, then a remainder of local
  layers; local layers keep a ``sliding_window``-slot ring cache;
* ``_build_zamba`` — zamba2: groups of Mamba2 layers, each group followed
  by the one shared attention + MLP block (its own KV cache per group);
* ``_build_rwkv`` — rwkv6: time-mix and channel-mix layers over recurrent
  states;
* ``_build_encdec`` — whisper: a bidirectional encoder over frame
  embeddings and a decoder with self- and cross-attention (the encoder's
  K/V cached at prefill).

Parameters are nested dicts with the reference's keys and layouts (weights
``(in, out)``, used as ``x @ w``; per-layer leaves stacked on leading layer
axes), so :mod:`repro_torch.bridge` maps the reference's params one to one.
The reference's ``lax.scan`` over stacked blocks is a loop over the layer
axes here.  The decoder families' caches are stacks ``(layers, batch,
...)`` (gemma3's local stack flattens its (group, layer) axes); zamba2's
Mamba states are ``(groups, layers, batch, ...)``: the executor finds each
leaf's batch axis as the reference does.  The hybrid, SSM and
encoder-decoder families prefill whole prompts into a dense cache, as in
the reference (no chunked prefill, no paged cache, no shared batch axis).
Every family without an MoE returns zero stats; the reference's
local/global, hybrid, SSM and encoder-decoder ``decode_step`` return
``None``, which its engine cannot read.

Training: every builder's ``loss_fn(params, batch, ctx)`` is the
reference's — full-sequence blocks without a cache, the cross entropy in
sequence chunks of ``ctx.ce_chunk`` (each recomputed in the backward, as
the reference's ``jax.checkpoint``), one checkpoint per block under
``ctx.remat`` (where the reference remats), ``loss = ce + aux + z`` and
the metrics ``ce`` (+ ``aux``, ``dropped``, ``miss``, ``expert_load`` for
the uniform decoder).  Under grad mode ``_layer`` takes
:func:`~repro_torch.kernels.autograd.stacked_view` slices, so a layer's
gradient is added into its stacked leaf's ``.grad`` in place instead of
through a zero tensor the size of the whole stack.

Serving: every family's ``prefill`` / ``decode_step`` (and the uniform
decoder's ``prefill_chunk``) take a :class:`ParallelCtx` — its
``moe_runtime`` for an MoE arch — or None (one device, no MoE), and every
``init_cache`` is ``(batch, max_slots, ctx=None)``.  On a mesh
(``ctx.mesh``; the reference's ``shard_map`` islands as SPMD ranks of
``torch.distributed``) each rank holds its
batch rows over the data axes, dense weights whole.  The EAAS MoE layer is
:func:`_moe_apply`'s island — this rank one expert server holding its
shard (``distributed.sharding_rules.shard_params``) — in ``a2a`` (tokens
also split over the model axis, one ``all_to_all`` each way) or
``replicated`` (one ``all_reduce`` combines); its stats are reduced over
every axis.  With ``seq_shard_cache`` a linear KV cache is split over
slots (``seq_shard_axes``) and decode attention is
:func:`_sp_decode_attention`: each rank's partial flash decode over its
slots, one combine (gemma3's globals, zamba2's shared block, whisper's
self cache; a sliding window's ring stays whole on every rank).  rwkv6
runs its tensor-parallel block (``rwkv.rwkv_block_spmd``).  Under a
``dense_phase`` every family executes the sharding table's layout
(:mod:`repro_torch.distributed.tensor_parallel`): the embedding, head and
cross entropy vocab-parallel, attention (whisper's cross-attention too)
and MLPs column / row parallel, the Mamba layers' cuts gathered to run
the mixer whole, rwkv6's island on the table's cuts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core import moe_layer as eaas
from repro_torch.core.moe_layer import MoERuntime, MoEStats
from repro_torch.distributed import mesh_axes
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.kernels.autograd import stacked_view
from repro_torch.models import attention as attn
from repro_torch.models import kv_cache as kvc
from repro_torch.models import mamba as mam
from repro_torch.models import rwkv as rwk
from repro_torch.models.common import (dense_init, embed_init, rms_norm,
                                       resolve_dtype)
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.rope import apply_rope, text_mrope_positions


class Model(NamedTuple):
    cfg: ModelConfig
    init_params: Callable      # (generator) -> params
    # (params, tokens, ctx, max_slots, batch) -> (logits, cache, stats);
    # ctx: a ParallelCtx (its moe_runtime for an MoE arch; a mesh) or None
    # (one device, no MoE)
    prefill: Callable
    decode_step: Callable      # (params, token, cache, ctx) -> (logits, cache, stats)
    init_cache: Callable       # (batch, max_slots, ctx=None) -> cache
    num_servers: int
    # (params, tokens, cache, start, ctx) -> (logits, cache, stats); None
    # for families without cache-resident prefill (whole-prompt only)
    prefill_chunk: Optional[Callable] = None
    # (num_blocks, block_size, batch, max_slots) -> paged cache; None for
    # families without paged-cache support (ring caches)
    init_paged_cache: Optional[Callable] = None
    # the batch axis every cache stack shares (microbatch splits, masked
    # decode); None where the reference's cache layout has none
    cache_batch_axis: Optional[int] = None
    # (params, batch, ctx: ParallelCtx) -> (loss, metrics): the train forward
    loss_fn: Optional[Callable] = None
    # whether a prompt's prefill is one fixed sequence of kernels for each
    # prompt length (the executor keeps a CUDA graph per length); False
    # where it loops over tokens or chunks (a recurrent family's scan body
    # is captured inside the eager prefill instead: common.compiled_scan)
    prefill_per_shape: bool = False


@dataclass(frozen=True)
class ParallelCtx:
    """How a step is distributed: the reference's ``ParallelCtx``.
    ``mesh=None`` is one device; with a mesh (a ``DeviceMesh``,
    :mod:`repro_torch.launch.mesh`) every rank calls the model on its own
    rows and shards.  ``dense_phase`` names the sharding table's phase
    whose dense placements the step executes (``serve``, ``train``,
    ``train_tp``, ``decode``: :mod:`repro_torch.distributed.tensor_parallel`;
    the params are ``shard_params(..., dense=True)``'s); None keeps dense
    weights whole on every rank (the serving path's layout).  Training
    reads ``sp_residual`` (the residual stream cut over ``model`` between
    blocks), ``remat`` (one checkpoint per block) and ``ce_chunk``
    (sequence positions per cross-entropy chunk); the reference's
    ``unroll_scans`` is XLA's and has no counterpart (layers are a loop
    here)."""

    mesh: Any = None
    axis_data: Tuple[str, ...] = ("data",)      # batch axes (may incl. "pod")
    axis_model: str = "model"
    moe_runtime: Optional[MoERuntime] = None
    moe_mode: str = "local"                     # local | a2a | replicated
    seq_shard_cache: bool = False               # SP decode (slot-sharded)
    seq_shard_axes: Tuple[str, ...] = ()        # slot axes (default: data)
    dense_phase: Optional[str] = None
    sp_residual: bool = False
    remat: bool = True
    ce_chunk: int = 512

    @property
    def slot_axes(self) -> Tuple[str, ...]:
        return self.seq_shard_axes or self.axis_data


# training takes the same context (one device: no mesh)
TrainCtx = ParallelCtx


def _tp(ctx: Optional[ParallelCtx]) -> Optional[tpl.Layout]:
    """The dense layout ``ctx`` executes, or None (whole weights)."""
    if ctx is None or ctx.mesh is None or ctx.dense_phase is None:
        return None
    return tpl.layout(ctx.mesh, ctx.dense_phase, ctx.axis_data,
                      ctx.axis_model)


def _slot_shard(ctx: Optional[ParallelCtx]) -> Optional[Tuple[int, int]]:
    """(this rank's slot-shard index, the shard count) of a slot-sharded
    cache, or None."""
    if ctx is None or not (ctx.seq_shard_cache and ctx.mesh is not None):
        return None
    axes = ctx.slot_axes
    return (mesh_axes.axes_index(ctx.mesh, axes),
            mesh_axes.axes_size(ctx.mesh, axes))


def _slots_of(max_slots: int, ctx: Optional[ParallelCtx]) -> int:
    """A linear KV cache's slots on this rank: ``max_slots``, or its
    share under a slot-sharded ``ctx``."""
    shard = _slot_shard(ctx)
    if shard is None:
        return max_slots
    if max_slots % shard[1]:
        raise ValueError(f"max_slots={max_slots} does not split over "
                         f"{shard[1]} slot shards")
    return max_slots // shard[1]


def build_model(cfg: ModelConfig, num_servers: int, redundant_table,
                device) -> Model:
    """Dispatch on the model family, as the reference does."""
    if cfg.family == "hybrid":
        return _build_zamba(cfg, device)
    if cfg.family == "ssm":
        return _build_rwkv(cfg, device)
    if cfg.family == "audio":
        return _build_encdec(cfg, device)
    if cfg.local_global_pattern:
        return _build_local_global(cfg, device)
    return _build_decoder(cfg, num_servers, redundant_table, device)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked params dict (views; stacked views under
    grad mode)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return stacked_view(tree, i)


def _remat(fn: Callable, ctx: ParallelCtx) -> Callable:
    """``fn`` recomputed in the backward when ``ctx.remat`` (the
    reference's ``_maybe_remat``).  A block draws no random numbers, so
    no RNG state is kept (reading the CUDA generator's state has no place
    in a captured train step)."""
    if not ctx.remat:
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 preserve_rng_state=False)


def _block_train(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, ctx: Optional[ParallelCtx], *,
                 is_local: bool = False, mrope_positions=None):
    """Full-sequence block without a cache (training).  Returns (x, the
    MoE layer's stats or None).  Under a dense layout the block's
    ZeRO-3 leaves are gathered here (again in the backward under remat),
    and with ``sp_residual`` x arrives and leaves as this rank's
    sequence positions."""
    lay = _tp(ctx)
    p = tpl.gather_params(p, lay)
    sp = lay is not None and ctx.sp_residual
    if sp:
        x = tpl.gather(x, 1, lay.model)
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    x = x + attn.full_attention(p["attn"], cfg, h, positions,
                                is_local=is_local,
                                mrope_positions=mrope_positions, tp=lay)
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    stats = []
    x = x + _ffn(p, cfg, h, ctx, stats)
    if sp:
        x = tpl.split(x, 1, lay.model)
    return x, (stats[0] if stats else None)


def chunked_cross_entropy(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                          labels: torch.Tensor, ctx: ParallelCtx
                          ) -> torch.Tensor:
    """Mean cross entropy without the (B, S, V) logits: chunks of
    ``ctx.ce_chunk`` positions (halved until they divide S), each
    recomputed in the backward (no RNG state kept: a chunk draws no
    random numbers); padded vocab masked to -1e30.  Under a
    dense layout the head is cut over the vocabulary and each chunk's
    loss is computed over the vocab shards (``vocab_parallel_ce_sum``)."""
    B, S, _ = x.shape
    chunk = min(ctx.ce_chunk, S)
    while S % chunk:
        chunk //= 2
    lay = _tp(ctx)
    if lay is not None and lay.n_model > 1:
        head = _head(params, cfg, lay)

        def body(xi, li):
            logits = _vocab_logits(head, cfg, xi, lay)
            return tpl.vocab_parallel_ce_sum(logits, li, lay.model)
    else:
        if lay is not None:                    # ZeRO-3 gathers only
            params = dict(params, **_gathered_head(params, cfg, lay))

        def body(xi, li):
            logits = _logits(params, cfg, xi)
            gold = torch.gather(logits, -1, li[..., None])[..., 0]
            return (torch.logsumexp(logits, dim=-1) - gold).sum()

    labels = labels.long()
    tot = torch.zeros((), device=x.device)
    for c in range(0, S, chunk):
        tot = tot + checkpoint(body, x[:, c:c + chunk],
                               labels[:, c:c + chunk], use_reentrant=False,
                               preserve_rng_state=False)
    return tot / (B * S)


def _data_parallel_loss(ce: torch.Tensor, lay: Optional[tpl.Layout],
                        *extra):
    """(loss, the global batch's ce) from this rank's rows' mean cross
    entropy ``ce``.  On a mesh the loss's value is the global ``ce +
    extra`` (the reference's mean over every row), its gradient the part
    of this rank's rows, ``ce / n_data + extra`` (``extra``, the MoE
    losses, is global already; the train step sums the gradients over the
    data axes)."""
    split = lay is not None and lay.n_data > 1
    part = ce / lay.n_data if split else ce
    loss = part
    for e in extra:
        loss = loss + e
    if not split:
        return loss, ce
    whole = tpl.all_sum(part, lay.data)
    return loss + (whole - part).detach(), whole


def _gathered_head(params: Dict, cfg: ModelConfig, lay) -> Dict:
    """The embedding (and head) with their ZeRO-3 dims gathered."""
    keys = ("embed",) if cfg.tie_embeddings else ("head",)
    return tpl.gather_params({k: params[k] for k in keys}, lay)


def _head(params: Dict, cfg: ModelConfig, lay) -> torch.Tensor:
    """This rank's vocab columns of the head (d, V / n): the head's
    ``col`` block, or the tied embedding's rows transposed."""
    g = _gathered_head(params, cfg, lay)
    return g["embed"].T if cfg.tie_embeddings else g["head"]


def _vocab_logits(head: torch.Tensor, cfg: ModelConfig, x: torch.Tensor,
                  lay) -> torch.Tensor:
    """fp32 logits of this rank's vocab block, padded columns -1e30."""
    logits = tpl.col_linear(x, head, lay.model).float()
    if cfg.padded_vocab != cfg.vocab_size:
        n = logits.shape[-1]
        cols = lay.model_index * n + torch.arange(n, device=x.device)
        logits = logits.masked_fill(cols >= cfg.vocab_size, -1e30)
    return logits


def _embed(params: Dict, tokens: torch.Tensor,
           lay: Optional[tpl.Layout]) -> torch.Tensor:
    """The tokens' embeddings: a lookup, or under a dense layout the
    vocab-parallel lookup of the (ZeRO-3-gathered) table's rows."""
    if lay is None:
        return params["embed"][tokens]
    table = tpl.gather_params({"embed": params["embed"]}, lay)["embed"]
    return tpl.embed_lookup(table, tokens, lay.model)


def _serve_logits(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  lay: Optional[tpl.Layout]) -> torch.Tensor:
    """Serving's fp32 logits over the whole vocabulary (the vocab blocks
    gathered under a dense layout)."""
    if lay is None or lay.n_model == 1:
        if lay is not None:
            params = dict(params, **_gathered_head(params, cfg, lay))
        return _logits(params, cfg, x)
    logits = _vocab_logits(_head(params, cfg, lay), cfg, x, lay)
    return tpl.gather(logits, -1, lay.model)


def _sum_stats(stats, cfg: ModelConfig, device) -> MoEStats:
    if not stats:
        E = cfg.moe.num_experts if cfg.moe else 1
        z = torch.zeros((), device=device)
        zi = torch.zeros((), dtype=torch.int64, device=device)
        return MoEStats(z, z, zi, zi, torch.zeros(E, dtype=torch.int64,
                                                  device=device))
    return MoEStats(*[sum(v) for v in zip(*stats)])


def _ffn(p: Dict, cfg: ModelConfig, h: torch.Tensor,
         ctx: Optional[ParallelCtx], stats: list) -> torch.Tensor:
    """The block's FFN: dense (tensor-parallel under a dense layout), or
    the EAAS layer under ``ctx``."""
    if "moe" not in p:
        lay = _tp(ctx)
        return mlp(p["mlp"], h, cfg.activation,
                   None if lay is None else lay.model)
    B, S, d = h.shape
    y, st = _moe_apply(p["moe"], h.reshape(B * S, d), cfg, ctx)
    stats.append(st)
    return y.reshape(B, S, d)


def _moe_apply(params_moe: Dict, x2d: torch.Tensor, cfg: ModelConfig,
               ctx: Optional[ParallelCtx]):
    """The EAAS MoE layer on one device, or its island on a mesh.

    On a mesh, x2d is this rank's rows (its data block, whole over the
    model axis) and ``params_moe["servers"]`` its server's shard; the
    runtime is whole and its ``local_table`` row is taken here.  a2a: the
    rows split over the model axis (T must divide, else ValueError: no
    silent padding), the island's output gathered back over it.  The stats
    are summed over every axis and divided by the reference's denominators
    (replicated mode counts each data block's tokens once per server).
    The client extras (shared experts / dense residual) run after the
    island on all of x2d."""
    m, rt = cfg.moe, ctx.moe_runtime if ctx is not None else None
    if rt is None:
        raise ValueError("an MoE arch needs ctx.moe_runtime")
    if ctx.mesh is None:
        return eaas.eaas_moe_apply(params_moe, x2d, m, rt,
                                   activation=cfg.activation)
    mesh, mode, model_ax = ctx.mesh, ctx.moe_mode, ctx.axis_model
    if mode not in ("a2a", "replicated"):
        raise ValueError(f"moe_mode {mode!r} on a mesh: 'a2a' or "
                         "'replicated'")
    group = mesh_axes.axes_group(mesh, (model_ax,))
    n_model = mesh_axes.axes_size(mesh, (model_ax,))
    idx = mesh_axes.axes_index(mesh, (model_ax,))
    n_data = mesh_axes.axes_size(mesh, ctx.axis_data)
    x_in = x2d
    routed = {k: params_moe[k] for k in ("router", "servers")}
    if mode == "a2a":
        T = x2d.shape[0]
        if T % n_model:
            raise ValueError(f"a2a needs the tokens to divide over the mesh: "
                             f"{T} rows a data block over {n_model} servers")
        if n_model > 1:           # (one rank: x2d itself, not a view)
            x_in = x2d[idx * (T // n_model):(idx + 1) * (T // n_model)]
        if torch.is_grad_enabled() and n_model > 1:
            # the backward gathers the rows' gradients; the router is
            # replicated but routes this rank's rows only: its gradient
            # is summed over the servers' ranks
            x_in = tpl.split(x2d, 0, group)
            routed["router"] = {k: tpl.copy_to(v, group)
                                for k, v in params_moe["router"].items()}
    rt_local = rt._replace(local_table=rt.local_table[idx:idx + 1])
    y, st = eaas.eaas_moe_apply(routed, x_in, m, rt_local,
                                activation=cfg.activation, mode=mode,
                                group=group)
    # global stats: summed over every axis (two collectives), then the
    # reference's denominators and integer divisions
    world = mesh_axes.axes_group(mesh, (*ctx.axis_data, model_ax))
    per = 1 if mode == "a2a" else n_model
    shards = n_data * (n_model if mode == "a2a" else 1)
    losses = tpl.reduce_from(torch.stack([st.aux_loss.float(),
                                          st.z_loss.float()]), world)
    counts = torch.cat([st.dropped.reshape(1), st.miss.reshape(1),
                        st.expert_load]).long()
    torch.distributed.all_reduce(counts, group=world)
    denom = shards if mode == "a2a" else shards * n_model
    st = MoEStats(aux_loss=losses[0] / denom, z_loss=losses[1] / denom,
                  dropped=counts[0] // per, miss=counts[1],
                  expert_load=counts[2:] // per)
    if mode == "a2a":
        y = comm.all_gather_rows(y, group)
    lay = _tp(ctx)
    extra = eaas.client_extras(params_moe, x2d, cfg.activation,
                               None if lay is None else lay.model)
    return (y if extra is None else y + extra), st


def _block_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: kvc.KVCache,
                   ctx, stats: list, *, is_local: bool = False,
                   mrope_positions=None) -> torch.Tensor:
    lay = _tp(ctx)
    p = tpl.gather_params(p, lay)
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    h, (k, v) = attn.full_attention(p["attn"], cfg, h, positions,
                                    is_local=is_local,
                                    mrope_positions=mrope_positions,
                                    return_kv=True, tp=lay)
    _write_prompt(cache, k, v, ctx)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    return x + _ffn(p, cfg, h, ctx, stats)


def _write_prompt(cache: kvc.KVCache, k: torch.Tensor, v: torch.Tensor,
                  ctx) -> None:
    """A prompt's K/V (b, S, KV, hd) into one layer's cache: all of it,
    or under a slot-sharded ``ctx`` this rank's slots of it; a ring keeps
    its trailing window whole (rings are never slot-sharded)."""
    shard = _slot_shard(ctx)
    if shard is None or cache.window:
        kvc.write_prefill(cache, k, v)
        return
    n, S = cache.k.shape[1], k.shape[1]
    lo = shard[0] * n
    cache.k[:, :max(0, min(n, S - lo))] = k[:, lo:lo + n]
    cache.v[:, :max(0, min(n, S - lo))] = v[:, lo:lo + n]
    cache.length.fill_(S)


def _block_prefill_chunk(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                         start: torch.Tensor, cache, ctx,
                         stats: list) -> torch.Tensor:
    """One block over a prompt chunk at ``start`` (a 0-d device tensor):
    attention against the cache (which holds every earlier chunk), the
    chunk's K/V written in."""
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    h, _ = attn.chunk_attention(p["attn"], cfg, h, cache, start)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    return x + _ffn(p, cfg, h, ctx, stats)


def _block_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: kvc.KVCache, ctx, stats: list, *,
                  is_local: bool = False) -> torch.Tensor:
    """One decode step of a block: attention with whole weights (over a
    slot-sharded cache on a mesh; a local layer's ring is whole on every
    rank, so plain decode attention), the FFN tensor-parallel under a dense
    layout."""
    p = tpl.gather_params(p, _tp(ctx))
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    if _slot_shard(ctx) is not None and not is_local:
        h, _ = _sp_decode_attention(p["attn"], cfg, h, cache, ctx)
    else:
        h, _ = attn.decode_attention(p["attn"], cfg, h, cache)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    return x + _ffn(p, cfg, h, ctx, stats)


def _sp_decode_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                         cache: kvc.KVCache, ctx: ParallelCtx):
    """Flash decode with the KV cache split along slots over
    ``ctx.slot_axes`` (the data axes unless ``seq_shard_axes`` names
    others; decode uses ("model",), so the attention weights stay whole and
    the cache never crosses a link).  ``cache`` is this rank's slots of its
    rows (k / v (b, slots / shards, KV, hd)) with the global lengths.  Each
    rank computes the one-token q / k / v, writes the new token's k / v
    only if it owns the slot (a local write), runs the partial kernel over
    its valid slots (a prefix: the cache fills in order) and one combine
    merges the shards."""
    ridx, _ = _slot_shard(ctx)
    group = mesh_axes.axes_group(ctx.mesh, ctx.slot_axes)
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = cache.k.shape[1]
    q = attn._split_heads(x @ params["wq"], h, hd)
    k = attn._split_heads(x @ params["wk"], kvh, hd)
    v = attn._split_heads(x @ params["wv"], kvh, hd)
    cos, sin = attn._rope_for(cfg, cache.length[:, None])
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    local = cache.length.long() - ridx * n
    ok = ((local >= 0) & (local < n))[:, None, None]
    rows, li = torch.arange(b, device=x.device), local.clamp(0, n - 1)
    cache.k[rows, li] = torch.where(ok, k[:, 0], cache.k[rows, li])
    cache.v[rows, li] = torch.where(ok, v[:, 0], cache.v[rows, li])
    n_valid = (local + 1).clamp(0, n).to(torch.int32)
    acc, m, l = attn.decode_attention_partial(
        params, cfg, q, kvc.KVCache(cache.k, cache.v, n_valid))
    out = attn.combine_partial_attention(acc, m, l, group)
    cache.length += 1
    return out.reshape(b, 1, h * hd).to(x.dtype) @ params["wo"], cache


def _mrope_from_batch(cfg: ModelConfig, batch, tokens: torch.Tensor):
    """An M-RoPE config's (3, [B,] S) position ids: the batch's
    ``mrope_positions`` (an image grid, ``models/vlm.py``) or the text
    positions."""
    if cfg.mrope_sections is None:
        return None
    mp = batch.get("mrope_positions") if batch else None
    if mp is None:
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
        return text_mrope_positions(pos)
    return mp


def _norms(d: int, lead, device, *names) -> Dict:
    """RMS-norm scales (ones, fp32) stacked over ``lead``."""
    return {n: torch.ones((*lead, d), device=device) for n in names}


def _init_blocks(cfg: ModelConfig, lead, dt, device, gen,
                 moe=None) -> Dict:
    """Blocks stacked over ``lead`` layer axes: norms, attention and a
    dense FFN, or ``moe = (num_servers, redundant_table)``'s EAAS layer."""
    d = cfg.d_model
    p = _norms(d, lead, device, "ln1", "ln2")
    p["attn"] = attn.init_attention(cfg, dt, device, gen, lead)
    if moe is not None:
        p["moe"] = eaas.init_eaas_moe(cfg, *moe, dt, device, gen, lead)
    else:
        p["mlp"] = init_mlp(d, cfg.d_ff, cfg.activation, dt, device, gen,
                            lead)
    return p


def _init_embed(cfg: ModelConfig, dt, device, generator) -> Dict:
    return {"embed": embed_init(cfg.padded_vocab, cfg.d_model, dt, device,
                                generator),
            "final_ln": torch.ones(cfg.d_model, device=device)}


def _init_head(cfg: ModelConfig, dt, device, generator) -> Dict:
    """The LM head, drawn last; none when it is the tied embedding."""
    if cfg.tie_embeddings:
        return {}
    return {"head": dense_init((cfg.d_model, cfg.padded_vocab), dt, device,
                               generator)}


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

    def init_params(generator: Optional[torch.Generator]) -> Dict:
        """Weights drawn on ``device`` with the reference's distributions
        (not its numbers: jax.random cannot be reproduced in torch)."""
        p = _init_embed(cfg, dt, device, generator)
        p["blocks"] = _init_blocks(
            cfg, (n_main,), dt, device, generator,
            (num_servers, redundant_table) if m is not None else None)
        if n_dense:
            p["dense_blocks"] = _init_blocks(cfg, (n_dense,), dt, device,
                                             generator)
        p.update(_init_head(cfg, dt, device, generator))
        return p

    def init_cache(batch: int, max_slots: int,
                   ctx: Optional[ParallelCtx] = None) -> Dict:
        """Dense KV stacks; under a slot-sharded ``ctx``, this rank's
        ``max_slots / shards`` slots."""
        max_slots = _slots_of(max_slots, ctx)
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

    def prefill(params, tokens: torch.Tensor,
                ctx: Optional[ParallelCtx] = None,
                max_slots: Optional[int] = None, batch=None):
        """tokens (B, S) -> (last-position logits (B, V) fp32, cache,
        stats); ``batch["mrope_positions"]`` places an image grid (M-RoPE
        configs).  On a mesh (``ctx.mesh``), tokens are this rank's rows,
        and a slot-sharded ctx leaves this rank's slots in the cache
        (decode's layout)."""
        B, S = tokens.shape
        cache = init_cache(B, max_slots or S, ctx)
        lay = _tp(ctx)
        x = _embed(params, tokens, lay)
        pos = torch.arange(S, device=tokens.device)
        mrope = _mrope_from_batch(cfg, batch, tokens)
        stats = []
        for name, pname, n in groups:
            for i in range(n):
                x = _block_prefill(_layer(params[pname], i), cfg, x, pos,
                                   cache[name].layer(i), ctx, stats,
                                   mrope_positions=mrope)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_serve_logits(params, cfg, x[:, -1], lay), cache,
                _sum_stats(stats, cfg, tokens.device))

    def prefill_chunk(params, tokens: torch.Tensor, cache: Dict, start,
                      ctx: Optional[ParallelCtx] = None):
        """Continue a prefill: prompt positions [start, start + C) against a
        cache (dense or paged) already holding [0, start); written in
        place.  ``start``: an int, or a 0-d int tensor on the device (the
        reference's traced ``start``; a CUDA graph's static input).
        Returns (last-position logits (B, V) fp32, cache, stats).  A
        slot-sharded cache is refused (whole prompts only there)."""
        if _slot_shard(ctx) is not None or _tp(ctx) is not None:
            raise NotImplementedError("chunked prefill into a slot-sharded "
                                      "cache or under a dense layout")
        start = torch.as_tensor(start, device=tokens.device)
        x = params["embed"][tokens]
        stats = []
        for name, pname, n in groups:
            for i in range(n):
                x = _block_prefill_chunk(_layer(params[pname], i), cfg, x,
                                         start, cache[name].layer(i), ctx,
                                         stats)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_logits(params, cfg, x[:, -1]), cache,
                _sum_stats(stats, cfg, tokens.device))

    def decode_step(params, token: torch.Tensor, cache: Dict,
                    ctx: Optional[ParallelCtx] = None):
        """token (B, 1) -> (logits (B, V) fp32, cache (in place), stats).
        ``ctx`` as :func:`prefill`'s; a slot-sharded one runs sequence-
        parallel attention over the cache ``prefill`` left."""
        lay = _tp(ctx)
        x = _embed(params, token, lay)
        stats = []
        for name, pname, n in groups:
            for i in range(n):
                x = _block_decode(_layer(params[pname], i), cfg, x,
                                  cache[name].layer(i), ctx, stats)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_serve_logits(params, cfg, x[:, 0], lay), cache,
                _sum_stats(stats, cfg, token.device))

    def loss_fn(params, batch: Dict, ctx: ParallelCtx):
        """batch {tokens, labels (B, S)[, mrope_positions]} -> (loss,
        metrics).  On a mesh the batch is this rank's rows and the loss
        the global batch's (the reference's mean over every row): its
        value is the global ``ce + aux + z``, its gradient the part of
        this rank's rows, ``ce_rank / n_data + aux + z`` (the aux and z
        losses are global already; the train step sums the gradients over
        the data axes)."""
        tokens = batch["tokens"].long()
        lay = _tp(ctx)
        x = _embed(params, tokens, lay)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        mrope = _mrope_from_batch(cfg, batch, tokens)
        block = _remat(lambda p, x: _block_train(
            p, cfg, x, pos, ctx, mrope_positions=mrope), ctx)
        sp = lay is not None and ctx.sp_residual
        if sp:
            x = tpl.split(x, 1, lay.model)
        stats = []
        for _, pname, n in groups:
            for i in range(n):
                x, st = block(_layer(params[pname], i), x)
                if st is not None:
                    stats.append(st)
        if sp:
            x = tpl.gather(x, 1, lay.model)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        ce = chunked_cross_entropy(params, cfg, x, batch["labels"], ctx)
        st = _sum_stats(stats, cfg, tokens.device)
        loss, ce = _data_parallel_loss(ce, lay, st.aux_loss, st.z_loss)
        return loss, {
            "ce": ce.detach(), "aux": st.aux_loss, "dropped": st.dropped,
            "miss": st.miss, "expert_load": st.expert_load}

    return Model(cfg, init_params, prefill, decode_step, init_cache,
                 num_servers, prefill_chunk, init_paged_cache,
                 cache_batch_axis=1, loss_fn=loss_fn,
                 prefill_per_shape=True)


def _build_local_global(cfg: ModelConfig, device) -> Model:
    """gemma3: groups of (``pattern`` local layers + 1 global layer), then
    a remainder of local layers; local layers keep only a
    ``sliding_window``-slot ring cache.  Params keep the reference's keys
    (``groups/local`` stacked (groups, pattern), ``groups/global``,
    ``rem_local``).  Dense-only, whole-prompt prefill, as in the
    reference: no paged cache, no chunked prefill, no batch axis shared by
    every cache (the reference's local stack has a leading group axis).
    Under a ``ParallelCtx`` every block runs the context's dense layout;
    a slot-sharded one cuts the global caches' slots, never a ring's (a
    ring holds the window whole on every rank, and its layers decode with
    plain decode attention, as the reference's)."""
    pat = cfg.local_global_pattern
    n_groups = cfg.num_layers // (pat + 1)
    n_rem = cfg.num_layers - n_groups * (pat + 1)
    dt = resolve_dtype(cfg.dtype)

    def init_params(generator: Optional[torch.Generator]) -> Dict:
        """Weights drawn on ``device`` with the reference's distributions
        (not its numbers)."""
        p = _init_embed(cfg, dt, device, generator)
        p["groups"] = {
            "local": _init_blocks(cfg, (n_groups, pat), dt, device,
                                  generator),
            "global": _init_blocks(cfg, (n_groups,), dt, device, generator)}
        if n_rem:
            p["rem_local"] = _init_blocks(cfg, (n_rem,), dt, device,
                                          generator)
        p.update(_init_head(cfg, dt, device, generator))
        return p

    def init_cache(batch: int, max_slots: int,
                   ctx: Optional[ParallelCtx] = None) -> Dict:
        """Stacks ``local`` (group * pattern + layer), ``global`` and
        ``rem``; the local ones are rings of ``min(window, max_slots)``,
        the global one this rank's slots under a slot-sharded ``ctx``."""
        def stack(n, window=0, slots=max_slots):
            return kvc.init_kv_cache(batch, slots, cfg.num_kv_heads,
                                     cfg.head_dim, dt, device, layers=n,
                                     window=window)
        w = cfg.sliding_window
        cache = {"local": stack(n_groups * pat, w),
                 "global": stack(n_groups,
                                 slots=_slots_of(max_slots, ctx))}
        if n_rem:
            cache["rem"] = stack(n_rem, w)
        return cache

    def layers(params: Dict, cache: Dict):
        """(block params, cache layer, is_local) in the reference's
        order."""
        g = params["groups"]
        for i in range(n_groups):
            loc = _layer(g["local"], i)
            for j in range(pat):
                yield _layer(loc, j), cache["local"].layer(i * pat + j), True
            yield _layer(g["global"], i), cache["global"].layer(i), False
        for i in range(n_rem):
            yield _layer(params["rem_local"], i), cache["rem"].layer(i), True

    def prefill(params, tokens: torch.Tensor, ctx=None,
                max_slots: Optional[int] = None, batch=None):
        """tokens (B, S) -> (last-position logits (B, V) fp32, cache,
        stats); a prompt longer than the window keeps its trailing window
        in each local ring."""
        B, S = tokens.shape
        cache = init_cache(B, max_slots or S, ctx)
        lay = _tp(ctx)
        x = _embed(params, tokens, lay)
        pos = torch.arange(S, device=tokens.device)
        for p, c, local in layers(params, cache):
            x = _block_prefill(p, cfg, x, pos, c, ctx, [], is_local=local)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_serve_logits(params, cfg, x[:, -1], lay), cache,
                _sum_stats([], cfg, tokens.device))

    def decode_step(params, token: torch.Tensor, cache: Dict, ctx=None):
        """token (B, 1) -> (logits (B, V) fp32, cache (in place), stats).
        The stats are zero (no MoE); the reference returns None here, which
        its engine cannot read (ROADMAP Queue 3)."""
        lay = _tp(ctx)
        x = _embed(params, token, lay)
        for p, c, local in layers(params, cache):
            x = _block_decode(p, cfg, x, c, ctx, [], is_local=local)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        return (_serve_logits(params, cfg, x[:, 0], lay), cache,
                _sum_stats([], cfg, token.device))

    def loss_fn(params, batch: Dict, ctx: ParallelCtx):
        """batch {tokens, labels} -> (loss, {"ce"}); on a mesh the data
        axes' convention of :func:`_data_parallel_loss`."""
        tokens = batch["tokens"].long()
        lay = _tp(ctx)
        x = _embed(params, tokens, lay)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        blocks = {local: _remat(lambda p, x, local=local: _block_train(
            p, cfg, x, pos, ctx, is_local=local)[0], ctx)
            for local in (False, True)}
        g = params["groups"]
        for i in range(n_groups):
            loc = _layer(g["local"], i)
            for j in range(pat):
                x = blocks[True](_layer(loc, j), x)
            x = blocks[False](_layer(g["global"], i), x)
        for i in range(n_rem):
            x = blocks[True](_layer(params["rem_local"], i), x)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        ce = chunked_cross_entropy(params, cfg, x, batch["labels"], ctx)
        loss, ce = _data_parallel_loss(ce, lay)
        return loss, {"ce": ce.detach()}

    return Model(cfg, init_params, prefill, decode_step, init_cache, 1,
                 loss_fn=loss_fn, prefill_per_shape=True)


def _build_zamba(cfg: ModelConfig, device) -> Model:
    """zamba2: ``num_layers / shared_block_every`` groups of Mamba2 layers,
    each followed by the SHARED attention + MLP block: one set of params
    for every group, a KV cache per application.  Params keep the
    reference's keys (``mamba`` stacked (groups, layers), ``shared``).
    The cache: ``mamba``, a :class:`~repro_torch.models.mamba.MambaState`
    of (groups, layers, batch, ...), and ``shared``, a KV stack of
    (groups, batch, ...); decode updates both in place.  Under a
    ``ParallelCtx`` the Mamba layers run the dense layout's cuts
    (``mamba.mamba_forward``'s ``tp``: the input projection gathered, the
    mixer whole on every rank), the shared block the layout's attention
    and MLP; a slot-sharded ctx cuts the shared block's KV slots."""
    per = cfg.shared_block_every
    n_groups = cfg.num_layers // per
    if n_groups * per != cfg.num_layers:
        raise ValueError(f"num_layers={cfg.num_layers} is not a multiple of "
                         f"shared_block_every={per}")
    dt = resolve_dtype(cfg.dtype)

    def init_params(generator: Optional[torch.Generator]) -> Dict:
        """Weights drawn on ``device`` with the reference's distributions
        (not its numbers)."""
        lead = (n_groups, per)
        p = _init_embed(cfg, dt, device, generator)
        p["mamba"] = dict(_norms(cfg.d_model, lead, device, "ln"),
                          mamba=mam.init_mamba(cfg, dt, device, generator,
                                               lead))
        p["shared"] = _init_blocks(cfg, (), dt, device, generator)
        p.update(_init_head(cfg, dt, device, generator))
        return p

    def init_cache(batch: int, max_slots: int,
                   ctx: Optional[ParallelCtx] = None) -> Dict:
        return {"mamba": mam.init_mamba_state(cfg, batch, device,
                                              (n_groups, per)),
                "shared": kvc.init_kv_cache(batch, _slots_of(max_slots, ctx),
                                            cfg.num_kv_heads, cfg.head_dim,
                                            dt, device, layers=n_groups)}

    def run(params, x: torch.Tensor, cache: Dict, mamba_step, block, lay):
        """The groups in order: each Mamba layer's state written back in
        place, then the shared block over group ``g``'s KV cache."""
        st = cache["mamba"]
        for g in range(n_groups):
            group = _layer(params["mamba"], g)
            for j in range(per):
                lp = tpl.gather_params(_layer(group, j), lay)
                h = rms_norm(x, lp["ln"], cfg.rms_norm_eps)
                y, new = mamba_step(lp["mamba"], cfg, h, mam.MambaState(
                    st.ssm[g, j], st.conv[g, j]), tp=lay)
                x = x + y
                st.ssm[g, j] = new.ssm
                st.conv[g, j] = new.conv
            x = block(params["shared"], cache["shared"].layer(g), x)
        return rms_norm(x, params["final_ln"], cfg.rms_norm_eps)

    def prefill(params, tokens: torch.Tensor, ctx=None,
                max_slots: Optional[int] = None, batch=None):
        """tokens (B, S) -> (last-position logits (B, V) fp32, cache,
        zero stats)."""
        B, S = tokens.shape
        cache = init_cache(B, max_slots or S, ctx)
        pos = torch.arange(S, device=tokens.device)
        lay = _tp(ctx)
        x = run(params, _embed(params, tokens, lay), cache,
                mam.mamba_forward,
                lambda p, c, x: _block_prefill(p, cfg, x, pos, c, ctx, []),
                lay)
        return (_serve_logits(params, cfg, x[:, -1], lay), cache,
                _sum_stats([], cfg, tokens.device))

    def decode_step(params, token: torch.Tensor, cache: Dict, ctx=None):
        """token (B, 1) -> (logits (B, V) fp32, cache (in place), zero
        stats; the reference returns None here)."""
        lay = _tp(ctx)
        x = run(params, _embed(params, token, lay), cache, mam.mamba_decode,
                lambda p, c, x: _block_decode(p, cfg, x, c, ctx, []), lay)
        return (_serve_logits(params, cfg, x[:, 0], lay), cache,
                _sum_stats([], cfg, token.device))

    def loss_fn(params, batch: Dict, ctx: ParallelCtx):
        """batch {tokens, labels} -> (loss, {"ce"}); every Mamba layer
        starts from a zero state, as the reference's; on a mesh the data
        axes' convention of :func:`_data_parallel_loss`."""
        tokens = batch["tokens"].long()
        lay = _tp(ctx)
        x = _embed(params, tokens, lay)
        pos = torch.arange(tokens.shape[1], device=tokens.device)

        def mamba_block(lp, x):
            lp = tpl.gather_params(lp, lay)
            h = rms_norm(x, lp["ln"], cfg.rms_norm_eps)
            return x + mam.mamba_forward(lp["mamba"], cfg, h, tp=lay)[0]
        mamba_block = _remat(mamba_block, ctx)
        shared = _remat(lambda p, x: _block_train(p, cfg, x, pos, ctx)[0],
                        ctx)
        for g in range(n_groups):
            group = _layer(params["mamba"], g)
            for j in range(per):
                x = mamba_block(_layer(group, j), x)
            x = shared(params["shared"], x)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        ce = chunked_cross_entropy(params, cfg, x, batch["labels"], ctx)
        loss, ce = _data_parallel_loss(ce, lay)
        return loss, {"ce": ce.detach()}

    return Model(cfg, init_params, prefill, decode_step, init_cache, 1,
                 loss_fn=loss_fn)


def _build_rwkv(cfg: ModelConfig, device) -> Model:
    """rwkv6: ``num_layers`` time-mix + channel-mix layers.  Params keep
    the reference's keys (``blocks``: ``ln1``, ``ln2``, ``tmix``,
    ``cmix``); the cache is ``states``, an
    :class:`~repro_torch.models.rwkv.RwkvState` of (layers, batch, ...)
    updated in place.  The state is O(1) in the sequence: prefill ignores
    ``max_slots``.  On a mesh (a ParallelCtx with one) every layer is the
    tensor-parallel ``rwkv_block_spmd`` on this rank's rows, the wkv state
    holding this rank's heads — training, and decode too, as a one-token
    sequence (the reference decodes under GSPMD).  Its params are
    ``shard_params``'s serving layout (the island's own), or under the
    context's ``dense_phase`` the table's (its time-mix ``w_v`` cut as the
    island takes it, ``sharding_rules.placement_of``), with the embedding
    and head vocab-parallel."""
    L = cfg.num_layers
    dt = resolve_dtype(cfg.dtype)

    def spmd(ctx):
        """On a mesh, the island's block function and the wkv heads a rank
        holds; (None, None) on one device."""
        if ctx is None or ctx.mesh is None:
            return None, None
        group = mesh_axes.axes_group(ctx.mesh, (ctx.axis_model,))
        n = mesh_axes.axes_size(ctx.mesh, (ctx.axis_model,))

        def block(tp, cp, cfg_, x, st, norms):
            return rwk.rwkv_block_spmd(tp, cp, cfg_, x, st, norms, group)
        return block, rwk.dims(cfg)[0] // n

    def init_params(generator: Optional[torch.Generator]) -> Dict:
        """Weights drawn on ``device`` with the reference's distributions
        (not its numbers)."""
        p = _init_embed(cfg, dt, device, generator)
        p["blocks"] = dict(
            _norms(cfg.d_model, (L,), device, "ln1", "ln2"),
            tmix=rwk.init_rwkv_tmix(cfg, dt, device, generator, (L,)),
            cmix=rwk.init_rwkv_cmix(cfg, dt, device, generator, (L,)))
        p.update(_init_head(cfg, dt, device, generator))
        return p

    def init_cache(batch: int, max_slots: int,
                   ctx: Optional[ParallelCtx] = None) -> Dict:
        st = rwk.init_rwkv_state(cfg, batch, device, (L,))
        _, heads = spmd(ctx)
        if heads is not None:                # this rank's heads, zeros
            st = st._replace(wkv=st.wkv[:, :, :heads].clone())
        return {"states": st}

    def run(params, x: torch.Tensor, cache: Dict, block, lay
            ) -> torch.Tensor:
        st = cache["states"]
        for i in range(L):
            p = tpl.gather_params(_layer(params["blocks"], i), lay)
            x, new = block(p["tmix"], p["cmix"], cfg, x,
                           rwk.RwkvState(*(a[i] for a in st)),
                           (p["ln1"], p["ln2"]))
            for a, b in zip(st, new):
                a[i] = b
        return rms_norm(x, params["final_ln"], cfg.rms_norm_eps)

    def prefill(params, tokens: torch.Tensor, ctx=None,
                max_slots: Optional[int] = None, batch=None):
        """tokens (B, S) -> (last-position logits (B, V) fp32, cache,
        zero stats)."""
        block, _ = spmd(ctx)
        lay = _tp(ctx)
        cache = init_cache(tokens.shape[0], 0, ctx)
        x = run(params, _embed(params, tokens, lay), cache,
                block or rwk.rwkv_block_forward, lay)
        return (_serve_logits(params, cfg, x[:, -1], lay), cache,
                _sum_stats([], cfg, tokens.device))

    def decode_step(params, token: torch.Tensor, cache: Dict, ctx=None):
        """token (B, 1) -> (logits (B, V) fp32, cache (in place), zero
        stats; the reference returns None here)."""
        block, _ = spmd(ctx)
        lay = _tp(ctx)
        x = run(params, _embed(params, token, lay), cache,
                block or rwk.rwkv_block_decode, lay)
        return (_serve_logits(params, cfg, x[:, 0], lay), cache,
                _sum_stats([], cfg, token.device))

    def loss_fn(params, batch: Dict, ctx: ParallelCtx):
        """batch {tokens, labels} -> (loss, {"ce"}); zero states, no
        per-layer remat (the reference remats no RWKV layer whole), the
        wkv recurrence checkpointed chunk by chunk inside the time-mix (as
        the reference's, ``rwkv.tmix_forward``; the island's too); on a
        mesh the island on this rank's heads and the data axes' convention
        of :func:`_data_parallel_loss`."""
        tokens = batch["tokens"].long()
        lay = _tp(ctx)
        block, heads = spmd(ctx)
        x = _embed(params, tokens, lay)
        zero = rwk.init_rwkv_state(cfg, tokens.shape[0], tokens.device)
        if heads is not None:
            zero = zero._replace(wkv=zero.wkv[:, :heads])
        for i in range(L):
            p = tpl.gather_params(_layer(params["blocks"], i), lay)
            x, _ = (block or rwk.rwkv_block_forward)(
                p["tmix"], p["cmix"], cfg, x, zero, (p["ln1"], p["ln2"]))
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        ce = chunked_cross_entropy(params, cfg, x, batch["labels"], ctx)
        loss, ce = _data_parallel_loss(ce, lay)
        return loss, {"ce": ce.detach()}

    return Model(cfg, init_params, prefill, decode_step, init_cache, 1,
                 loss_fn=loss_fn)


def _build_encdec(cfg: ModelConfig, device) -> Model:
    """whisper-base's backbone: ``num_encoder_layers`` bidirectional blocks
    over frame embeddings (B, encoder_seq_len, d_model) — the conv / mel
    frontend is a stand-in, ``models/whisper.py`` — and ``num_layers``
    decoder blocks of causal self-attention, cross-attention (``ln_x``,
    ``cross``) and MLP.  The cache: ``self``, a KV stack, and the
    encoder's K/V per decoder layer, ``cross_k`` / ``cross_v`` (layers,
    batch, encoder_seq_len, KV, hd), written at prefill, read by decode.
    Under a ``ParallelCtx`` the encoder, the self- and the
    cross-attention and the MLPs run the dense layout (the cross
    projections cut as the self-attention's, heads gathered where a rank's
    columns hold none whole); a slot-sharded ctx cuts the self cache's
    slots (decoded sequence-parallel), never the encoder's K/V."""
    Le, Ld = cfg.num_encoder_layers, cfg.num_layers
    dt = resolve_dtype(cfg.dtype)

    def init_params(generator: Optional[torch.Generator]) -> Dict:
        """Weights drawn on ``device`` with the reference's distributions
        (not its numbers); the head is the tied embedding."""
        p = _init_embed(cfg, dt, device, generator)
        p["encoder"] = _init_blocks(cfg, (Le,), dt, device, generator)
        p["decoder"] = dict(
            _init_blocks(cfg, (Ld,), dt, device, generator),
            **_norms(cfg.d_model, (Ld,), device, "ln_x"),
            cross=attn.init_cross_attention(cfg, dt, device, generator,
                                            (Ld,)))
        p.update(_init_head(cfg, dt, device, generator))
        return p

    def encode(params, frames: torch.Tensor, lay) -> torch.Tensor:
        x = frames.to(dt)
        pos = torch.arange(x.shape[1], device=x.device)
        group = None if lay is None else lay.model
        for i in range(Le):
            p = tpl.gather_params(_layer(params["encoder"], i), lay)
            h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
            x = x + attn.full_attention(p["attn"], cfg, h, pos, causal=False,
                                        tp=lay)
            h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
            x = x + mlp(p["mlp"], h, cfg.activation, group)
        return x

    def init_cache(batch: int, max_slots: int,
                   ctx: Optional[ParallelCtx] = None) -> Dict:
        shape = (Ld, batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"self": kvc.init_kv_cache(batch, _slots_of(max_slots, ctx),
                                          cfg.num_kv_heads, cfg.head_dim,
                                          dt, device, layers=Ld),
                "cross_k": torch.zeros(shape, dtype=dt, device=device),
                "cross_v": torch.zeros(shape, dtype=dt, device=device)}

    def decoder(params, x: torch.Tensor, cache: Dict, self_attn,
                cross_attn, lay) -> torch.Tensor:
        group = None if lay is None else lay.model
        for i in range(Ld):
            p = tpl.gather_params(_layer(params["decoder"], i), lay)
            h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
            x = x + self_attn(p["attn"], h, cache["self"].layer(i))
            h = rms_norm(x, p["ln_x"], cfg.rms_norm_eps)
            x = x + cross_attn(p["cross"], h, i)
            h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
            x = x + mlp(p["mlp"], h, cfg.activation, group)
        return rms_norm(x, params["final_ln"], cfg.rms_norm_eps)

    def prefill(params, tokens: torch.Tensor, ctx=None,
                max_slots: Optional[int] = None, batch=None):
        """Encode ``batch["frames"]`` (zeros when absent, as in the
        reference: the engine passes none), cache each decoder layer's
        cross K/V, prefill the decoder (cross-attention plain, as in the
        reference).  tokens (B, S) -> (last-position logits (B, V) fp32,
        cache, zero stats)."""
        B, S = tokens.shape
        lay = _tp(ctx)
        frames = (batch or {}).get("frames")
        if frames is None:
            frames = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model),
                                 dtype=dt, device=tokens.device)
        enc = encode(params, frames, lay)
        cache = init_cache(B, max_slots or S, ctx)
        pos = torch.arange(S, device=tokens.device)

        def self_attn(p, h, c):
            out, (k, v) = attn.full_attention(p, cfg, h, pos, return_kv=True,
                                              tp=lay)
            _write_prompt(c, k, v, ctx)
            return out

        def cross_attn(p, h, i):
            out, (k, v) = attn.cross_attention(p, cfg, h, enc, tp=lay,
                                               return_kv=True)
            cache["cross_k"][i] = k
            cache["cross_v"][i] = v
            return out

        x = decoder(params, _embed(params, tokens, lay), cache, self_attn,
                    cross_attn, lay)
        return (_serve_logits(params, cfg, x[:, -1], lay), cache,
                _sum_stats([], cfg, tokens.device))

    def decode_step(params, token: torch.Tensor, cache: Dict, ctx=None):
        """token (B, 1) -> (logits (B, V) fp32, cache (in place), zero
        stats; the reference returns None here).  The cross-attention
        runs ``ops.flash_decode`` over the cached encoder K/V with every
        position valid: its lengths are the encoder length, not the self
        cache's.  A slot-sharded ``ctx`` decodes the self cache
        sequence-parallel (``_sp_decode_attention``)."""
        lay = _tp(ctx)
        enc_len = torch.full((token.shape[0],), cache["cross_k"].shape[2],
                             dtype=torch.int32, device=token.device)
        sp = _slot_shard(ctx) is not None

        def self_attn(p, h, c):
            if sp:
                return _sp_decode_attention(p, cfg, h, c, ctx)[0]
            return attn.decode_attention(p, cfg, h, c)[0]

        x = decoder(
            params, _embed(params, token, lay), cache, self_attn,
            lambda p, h, i: attn.cross_attention_cached(
                p, cfg, h, cache["cross_k"][i], cache["cross_v"][i],
                enc_len), lay)
        return (_serve_logits(params, cfg, x[:, 0], lay), cache,
                _sum_stats([], cfg, token.device))

    def loss_fn(params, batch: Dict, ctx: ParallelCtx):
        """batch {tokens, labels, frames (B, encoder_seq_len, d)} -> (loss,
        {"ce"}); decoder blocks under remat, the encoder not (as in the
        reference); on a mesh the data axes' convention of
        :func:`_data_parallel_loss`."""
        lay = _tp(ctx)
        group = None if lay is None else lay.model
        enc = encode(params, batch["frames"], lay)
        tokens = batch["tokens"].long()
        pos = torch.arange(tokens.shape[1], device=tokens.device)

        def block(p, x, enc):
            p = tpl.gather_params(p, lay)
            h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
            x = x + attn.full_attention(p["attn"], cfg, h, pos, tp=lay)
            h = rms_norm(x, p["ln_x"], cfg.rms_norm_eps)
            x = x + attn.cross_attention(p["cross"], cfg, h, enc, tp=lay)
            h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
            return x + mlp(p["mlp"], h, cfg.activation, group)
        block = _remat(block, ctx)
        x = _embed(params, tokens, lay)
        for i in range(Ld):
            x = block(_layer(params["decoder"], i), x, enc)
        x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
        ce = chunked_cross_entropy(params, cfg, x, batch["labels"], ctx)
        loss, ce = _data_parallel_loss(ce, lay)
        return loss, {"ce": ce.detach()}

    return Model(cfg, init_params, prefill, decode_step, init_cache, 1,
                 loss_fn=loss_fn, prefill_per_shape=True)
