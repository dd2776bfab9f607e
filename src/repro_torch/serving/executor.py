"""Step execution — the executor half of the engine split.

The :class:`Executor` owns the params, the batched KV cache and the step
variants:

* ``prefill``       — whole-prompt prefill into a fresh batch-1 cache that
  is then written into the slot, leaf by leaf at each leaf's batch axis
  (KV stacks, Mamba and RWKV states, whisper's cross K/V), as the
  reference's ``_slot_write`` does;
* ``prefill_chunk`` — chunked-prefill continuation against a batch-1
  staging cache, committed into the slot on the last chunk (dense mode);
* ``decode``        — one token for the whole slot batch (idle slots
  included, as in the reference, so capacity use and routing match), in
  one of three modes: ``lockstep`` (one full-batch step), ``pipelined``
  (two half-batch microbatches,
  :func:`repro_torch.core.overlap.split_batch_decode`; on the card the
  second runs on its own CUDA stream, paper §4.2) or ``serialized`` (the
  same split chained on one stream: the ablation).  The halves are views
  of the batch cache, so their appends land in it in place;
* ``decode_masked`` — one full-batch step where only the masked slots
  advance: the other rows' K, V and length are restored bit-exactly (the
  reference's async tier decodes a subset of slots this way).

``kv_mode="paged"`` swaps the dense per-slot cache for the block-pool
cache: one shared pool per layer, addressed through block tables the
host-side scheduler owns.  Tables and lengths are host-authoritative and
written into static device buffers at every step (the reference passes
them as jit arguments); all paged prefill goes through the chunk path
straight into the pool blocks (``prefill_chunk_paged``), and copy-on-write
forks copy pool blocks on every layer (``copy_blocks``).  Paged decode is
lockstep only, as in the reference: the pool is shared across the batch,
so a microbatch split has no batch axis to cut.

The reference's compiled step variants are CUDA graphs here
(:mod:`repro_torch.serving.step_graphs`): ``decode`` in each mode,
``decode_masked`` and ``decode_paged`` are captured once, and the decoder
family's ``prefill``, ``prefill_chunk``, ``prefill_chunk_paged`` and
``copy_blocks``, and gemma3's and whisper's whole-prompt ``prefill``, once
per shape (a prompt or chunk length, a number of copy pairs), as the
reference compiles them, and replayed.  What the
reference passes as jit arguments — the tokens, the expert->server
mapping, the liveness mask, the local table, the router bias, the
replica weights, the block tables and lengths, the wave mask, a chunk's
``start``, the slot, the copy pairs — is written into persistent device
buffers before each replay, so failover, rebalancing, page-out,
admission, another slot, another request and a prefix-cache hit take
effect at the next call without a new capture; only a new shape captures
once more, and a change of structure (a resize, a router bias appearing,
new weight or cache tensors) captures every variant again.  The caches
are written in place at the addresses the graphs were captured with
(dense chunked prefill stages in one static batch-1 cache, see
:meth:`Executor.prefill_chunk`), and the drop / miss totals accumulate
inside them.  A replay overwrites the previous call's logits and expert
load: read them before the next call.  zamba2's and rwkv6's prefill
(``Model.prefill_per_shape`` false: a loop over chunks or tokens) runs
eagerly around the scan bodies it replays, each captured once
(``models/common.py::compiled_scan``: the SSD carry, the wkv
recurrence), as the reference's compiled prefill runs a ``lax.scan``
body compiled once.  On the CPU, and under ``step_graphs.eager()``,
every variant runs eagerly over the same buffers.  ``migrate_slots`` and
``resize`` write the expert weights in place: engines that share them (a
cluster's clients) have one of them write, once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import expert_server
from repro_torch.core.elastic import as_runtime
from repro_torch.core.moe_layer import MoEStats
from repro_torch.core.overlap import split_batch_decode
from repro_torch.models import kv_cache as kvc
from repro_torch.models.transformer import Model, ParallelCtx
from repro_torch.serving import step_graphs


DECODE_MODES = ("lockstep", "pipelined", "serialized")


def _slot_write(big: torch.Tensor, one: torch.Tensor, slot) -> None:
    """Write a batch-1 cache leaf into ``slot`` of the engine's leaf, in
    place: the reference's ``_slot_write``.  ``slot``: an int or a (1,)
    int64 tensor on the device (a graph's static input).  The batch axis
    is the first where ``one`` has 1 and ``big`` does not; equal shapes
    (max_batch 1) replace the leaf whole; a leaf with neither is left as
    it is."""
    if big.shape == one.shape:
        big.copy_(one)
        return
    for axis, (db, do) in enumerate(zip(big.shape, one.shape)):
        if db != do and do == 1:
            big.index_copy_(axis, torch.as_tensor(
                slot, device=big.device).reshape(1), one)
            return


class Executor:
    """Owns params + caches + step variants for one engine."""

    def __init__(self, model: Model, params: Dict, pool, *, max_batch: int,
                 max_seq: int, device, decode_mode: str = "lockstep",
                 kv_mode: str = "dense", kv_block_size: int = 16,
                 kv_num_blocks: int = 0):
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        if decode_mode != "lockstep":
            if model.cache_batch_axis is None:
                raise ValueError(
                    f"decode_mode={decode_mode!r} needs a model family with "
                    "a uniform cache batch axis (decoder-family only)")
            if max_batch % 2:
                raise ValueError(
                    f"decode_mode={decode_mode!r} needs an even max_batch "
                    f"(got {max_batch}) to form two microbatches")
            if kv_mode == "paged":
                raise ValueError(
                    "kv_mode='paged' shares one block pool across the "
                    "batch — microbatch-split decode modes need the dense "
                    "per-slot cache (use decode_mode='lockstep')")
        if kv_mode == "paged" and (model.init_paged_cache is None
                                   or model.prefill_chunk is None):
            raise ValueError(
                "kv_mode='paged' needs a model family with paged-cache and "
                "chunked-prefill support (uniform decoder family)")
        self.model = model
        self.params = params
        self.pool = pool
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.decode_mode = decode_mode
        self.kv_mode = kv_mode
        # pipelined decode's second stream on the card, one for the
        # executor's life (the allocator caches its blocks per stream)
        self._side_stream = (torch.cuda.Stream(self.device)
                             if decode_mode == "pipelined"
                             and self.device.type == "cuda" else None)
        if kv_mode == "paged":
            # raises unless max_seq is a multiple of the block size
            self.cache = model.init_paged_cache(kv_num_blocks, kv_block_size,
                                                max_batch, max_seq)
        else:
            self.cache = model.init_cache(max_batch, max_seq)
        # dense chunked prefill: the static batch-1 staging cache, the
        # slot whose chunks it holds, and the other slots' parked copies
        self._stage = None
        self._stage_slot = None
        self._parked: Dict[int, Dict] = {}
        # MoE drop / miss totals over every step, kept on the device
        self.dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        self.miss = torch.zeros((), dtype=torch.int64, device=self.device)
        # the jit arguments' counterparts, and the captured decode variants
        self.static = step_graphs.StaticInputs(self.device)
        self.graphs = step_graphs.StepGraphs(self.device)

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.model.prefill_chunk is not None

    def _ctx(self) -> ParallelCtx:
        """The serving context of a step: one device, the pool's current
        runtime (None without a pool) over the static buffers."""
        if not self.pool:
            return ParallelCtx()
        return ParallelCtx(moe_runtime=as_runtime(self.pool.runtime_arrays(),
                                                  self.static.put))

    def _key(self, name: str, ctx: ParallelCtx, *static) -> tuple:
        """What a captured variant bakes in: the variant and decode mode,
        the runtime's static fields and which of its optional tensors are
        present, and the address of every tensor the step touches (its
        static inputs, the weights, the caches)."""
        rt = ctx.moe_runtime
        structure = None if rt is None else (
            rt.num_servers, rt.capacity, rt.dispatch_method, rt.gemm_impl,
            rt.route_bias is not None, rt.replica_weights is not None)
        return (name, self.decode_mode, structure,
                step_graphs.addresses(static, rt, self.params, self.cache))

    def _run(self, name: str, key: tuple, fn, shape: tuple):
        """A prefill variant: graphed per shape where the family's prefill
        is one fixed sequence of kernels a prompt length (the decoder
        family, gemma3, whisper: ``Model.prefill_per_shape``); zamba2's
        and rwkv6's run eagerly, around the scan bodies they replay."""
        if self.model.prefill_per_shape:
            return self.graphs.run(name, key, fn, shape)
        return fn()

    def _tally(self, stats: MoEStats) -> None:
        self.dropped += stats.dropped
        self.miss += stats.miss

    def _tokens(self, name: str, tokens: np.ndarray) -> torch.Tensor:
        """A (1, n) prompt or chunk in its length's static buffer."""
        a = np.asarray(tokens, np.int64)[None]
        return self.static.put(f"{name}:{a.shape[1]}", a)

    def _start(self, start: int) -> torch.Tensor:
        """A chunk's ``start`` as a 0-d view of its static buffer."""
        return self.static.put("start", np.array([start], np.int64))[0]

    def _commit(self, slot, one: Dict) -> None:
        """Write a batch-1 dense cache into ``slot`` (an int or a (1,)
        device tensor) of the batch cache, leaf by leaf (KV stacks,
        recurrent states, cross K/V)."""
        for big, small in zip(step_graphs.tensors(self.cache),
                              step_graphs.tensors(one)):
            _slot_write(big, small, slot)

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: np.ndarray) -> torch.Tensor:
        """Whole-prompt prefill straight into ``slot`` of the batch cache;
        returns the last position's logits (1, V) fp32.  The slot is data
        (the prefilled batch-1 cache is written into it inside the step),
        so one graph serves a prompt length whatever the slot; the
        graph's outputs are the logits and the expert load."""
        tok = self._tokens("prompt", prompt)
        at = self.static.put("slot", np.array([slot], np.int64))
        ctx = self._ctx()

        def step():
            logits, one, stats = self.model.prefill(
                self.params, tok, ctx, max_slots=self.max_seq)
            self._commit(at, one)
            self._tally(stats)
            return logits, stats.expert_load
        return self._run("prefill", self._key("prefill", ctx, at), step,
                         (tok.shape[1],))[0]

    def _staged(self, slot: int, is_first: bool) -> Dict:
        """The static staging cache, holding ``slot``'s chunks so far.

        The reference stages each slot's chunks in a fresh batch-1 cache
        of its own (``init_cache(1, max_seq)``,
        ``src/repro/serving/executor.py:236-237``).  A graph reads and
        writes fixed addresses, so here one batch-1 cache is the staging
        of every chunk: a chunk length captures once whatever the slot or
        request.  The slot it holds stays in it
        between chunks (a prompt's chunks mostly run back to back); a
        chunk of another slot first parks it in that slot's copy of its
        own, then loads its own slot's copy, or at ``is_first`` zeroes
        the staging (bitwise the reference's fresh cache).  Parking and
        loading are copies outside the graph, so interleaved requests
        keep their staging bitwise at the cost of one batch-1 cache per
        slot whose prefill was interleaved."""
        if self._stage is None:
            self._stage = self.model.init_cache(1, self.max_seq)
        held = self._stage_slot
        if held != slot:
            if held is not None:
                if held not in self._parked:
                    self._parked[held] = self.model.init_cache(1,
                                                               self.max_seq)
                step_graphs.adopt(self._parked[held], self._stage)
            if not is_first:
                step_graphs.adopt(self._stage, self._parked[slot])
            self._stage_slot = slot
        if is_first:
            for t in step_graphs.tensors(self._stage):
                t.zero_()
        return self._stage

    def drop_staging(self) -> None:
        """Forget every partly prefilled slot (a client failure)."""
        self._stage_slot = None
        self._parked.clear()

    @torch.inference_mode()
    def prefill_chunk(self, slot: int, chunk: np.ndarray, start: int, *,
                      is_first: bool, is_last: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunked-prefill step for ``slot`` (dense mode) -> (logits,
        per-expert token counts).  Chunks accumulate in the static staging
        cache (:meth:`_staged`); the last chunk commits it into the slot.
        ``start`` is data: one graph per chunk length."""
        stage = self._staged(slot, is_first)
        tok = self._tokens("chunk", chunk)
        at = self._start(start)
        ctx = self._ctx()

        def step():
            logits, _, stats = self.model.prefill_chunk(
                self.params, tok, stage, at, ctx)
            self._tally(stats)
            return logits, stats.expert_load
        out = self._run("prefill_chunk",
                        self._key("prefill_chunk", ctx, at, stage), step,
                        (tok.shape[1],))
        if is_last:
            self._commit(self.static.put("slot", np.array([slot], np.int64)),
                         stage)
            self._stage_slot = None
            self._parked.pop(slot, None)
        return out

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """One decode step over the whole slot batch -> (logits (B, V),
        per-expert token counts (E,)), in the executor's decode mode."""
        tok, ctx = self.static.put("tokens", np.asarray(tokens, np.int64)), \
            self._ctx()

        def step():
            if self.decode_mode == "lockstep":
                logits, cache, stats = self.model.decode_step(
                    self.params, tok, self.cache, ctx)
            else:
                logits, cache, stats = split_batch_decode(
                    lambda t, c: self.model.decode_step(self.params, t, c,
                                                        ctx),
                    tok, self.cache, axis=1,
                    enabled=self.decode_mode == "pipelined",
                    stream=self._side_stream)
            step_graphs.adopt(self.cache, cache)
            self._tally(stats)
            return logits, stats.expert_load
        return self.graphs.run("decode", self._key("decode", ctx, tok), step)

    @torch.inference_mode()
    def decode_masked(self, tokens: np.ndarray, mask: np.ndarray
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One full-batch decode step where only ``mask``-true slots advance
        their cache row; the others' K, V and length are restored
        bit-exactly (the dense append advances every row, so the restore is
        what keeps inactive slots resumable).  Active rows' logits are
        bitwise those of :meth:`decode`'s lockstep step."""
        if self.kv_mode != "dense":
            raise ValueError("decode_masked needs the dense per-slot cache")
        tok = self.static.put("tokens", np.asarray(tokens, np.int64))
        keep = self.static.put("mask", np.asarray(mask, bool))
        ctx = self._ctx()

        def step():
            # the slot each row's append is about to write, and its old
            # values
            saved = {}
            for name, c in self.cache.items():
                n_layers, B, slots = c.k.shape[:3]
                li = torch.arange(n_layers, device=self.device)[:, None]
                bi = torch.arange(B, device=self.device)[None, :]
                at = (li, bi, c.length.clamp(max=slots - 1).long())
                saved[name] = (at, c.k[at], c.v[at], c.length.clone())
            logits, cache, stats = self.model.decode_step(
                self.params, tok, self.cache, ctx)
            step_graphs.adopt(self.cache, cache)
            for name, (at, k_old, v_old, len_old) in saved.items():
                c = self.cache[name]
                row = keep[None, :, None, None]
                c.k[at] = torch.where(row, c.k[at], k_old)
                c.v[at] = torch.where(row, c.v[at], v_old)
                c.length.copy_(torch.where(keep[None, :], c.length, len_old))
            self._tally(stats)
            return logits, stats.expert_load
        return self.graphs.run("decode_masked",
                               self._key("decode_masked", ctx, tok, keep),
                               step)

    # -------------------------------------------------------------- paged
    def _with_tables(self, tables: np.ndarray, lengths: np.ndarray,
                     prefix: str) -> Dict:
        """The pools with host tables / lengths written into the static
        buffers ``prefix``-tables / -lengths (shared by every layer of both
        stacks)."""
        t = self.static.put(prefix + "-tables", np.asarray(tables, np.int32))
        n = self.static.put(prefix + "-lengths",
                            np.asarray(lengths, np.int32))
        return {name: kvc.PagedKVCache(c.k, c.v, t, n)
                for name, c in self.cache.items()}

    @torch.inference_mode()
    def prefill_chunk_paged(self, chunk: np.ndarray, start: int,
                            table_row: np.ndarray
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prefill chunk through the slot's block-table row, straight
        into the pool blocks -> (logits, per-expert token counts).  A
        prefix-cache hit starts ``start`` past the cached prefix, and the
        chunk attends over blocks an earlier request wrote.  The row, the
        length and ``start`` are data: one graph per chunk length."""
        view = self._with_tables(np.asarray(table_row)[None], [start],
                                 "chunk")
        tok = self._tokens("chunk", chunk)
        at = self._start(start)
        ctx = self._ctx()

        def step():
            logits, _, stats = self.model.prefill_chunk(
                self.params, tok, view, at, ctx)
            self._tally(stats)
            return logits, stats.expert_load
        return self._run("prefill_chunk_paged",
                         self._key("prefill_chunk_paged", ctx, view, at),
                         step, (tok.shape[1],))

    @torch.inference_mode()
    def decode_paged(self, tokens: np.ndarray, tables: np.ndarray,
                     lengths: np.ndarray) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """One decode step with host-authoritative tables / lengths."""
        tok = self.static.put("tokens", np.asarray(tokens, np.int64))
        view, ctx = self._with_tables(tables, lengths, "decode"), self._ctx()

        def step():
            # the returned lengths are dropped: the host's are the truth
            logits, _, stats = self.model.decode_step(self.params, tok, view,
                                                      ctx)
            self._tally(stats)
            return logits, stats.expert_load
        return self.graphs.run("decode_paged",
                               self._key("decode_paged", ctx, tok, view),
                               step)

    @torch.inference_mode()
    def copy_blocks(self, pairs) -> None:
        """Apply copy-on-write forks: pool blocks src -> dst, every layer
        of both stacks.  The pairs are data: one graph per number of
        pairs."""
        if not pairs:
            return
        n = len(pairs)
        src = self.static.put(f"copy-src:{n}",
                              np.array([s for s, _ in pairs], np.int64))
        dst = self.static.put(f"copy-dst:{n}",
                              np.array([d for _, d in pairs], np.int64))

        def step():
            for c in self.cache.values():
                kvc.copy_blocks(c, src, dst, stacked=True)
        self._run("copy_blocks", self._key("copy_blocks", ParallelCtx()),
                  step, (n,))

    # ------------------------------------------------------ control plane
    def _server_weights(self):
        """The per-server expert weight dicts of every MoE layer stack."""
        return [group["moe"]["servers"] for group in self.params.values()
                if isinstance(group, dict) and "moe" in group]

    @torch.no_grad()
    def migrate_slots(self, updates) -> None:
        """One incremental migration chunk on every MoE layer, in place:
        ``[(server, local_slot, expert_id)]``, ``-1`` zeroes the slot.  The
        pool drops the old replica before this copy and registers the new
        one after it lands (break-before-make)."""
        E = self.model.cfg.moe.num_experts
        for sw in self._server_weights():
            expert_server.migrate_slots(sw, E, updates)

    @torch.no_grad()
    def resize(self, pool) -> None:
        """Adopt a resized pool: reshard the expert weights for its size
        and replication plan, one stacked tensor at a time.  The KV cache
        and staging caches are untouched — scaling drops no work."""
        self.pool = pool
        self.graphs.reset()          # the reference rebuilds its jits here
        E = self.model.cfg.moe.num_experts
        for sw in self._server_weights():
            expert_server.reshard_server_weights(
                sw, E, pool.num_servers, pool.redundant_table)
