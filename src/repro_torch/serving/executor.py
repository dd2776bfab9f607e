"""Step execution — the executor half of the engine split.

The :class:`Executor` owns the params, the batched KV cache and the step
variants:

* ``prefill``       — whole-prompt prefill into a fresh batch-1 cache that
  is then written into the slot;
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
uploaded at every step (the reference passes them as jit arguments); all
paged prefill goes through the chunk path straight into the pool blocks
(``prefill_chunk_paged``), and copy-on-write forks copy pool blocks on
every layer (``copy_blocks``).  Paged decode is lockstep only, as in the
reference: the pool is shared across the batch, so a microbatch split has
no batch axis to cut.

The reference's ``jax.jit`` has no counterpart: PyTorch runs eagerly.  The
expert->server mapping, liveness mask and local table are read from the
pool at every step, so failover, rebalancing and resizing take effect at
the next step.  ``migrate_slots`` and ``resize`` write the expert weights
in place: engines that share them (a cluster's clients) have one of them
write, once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import expert_server
from repro_torch.core.moe_layer import MoEStats
from repro_torch.core.overlap import split_batch_decode
from repro_torch.models import kv_cache as kvc
from repro_torch.models.transformer import Model


DECODE_MODES = ("lockstep", "pipelined", "serialized")


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
            if max_batch % 2:
                raise ValueError(
                    f"decode_mode={decode_mode!r} needs an even max_batch "
                    f"(got {max_batch}) to form two microbatches")
            if kv_mode == "paged":
                raise ValueError(
                    "kv_mode='paged' shares one block pool across the "
                    "batch — microbatch-split decode modes need the dense "
                    "per-slot cache (use decode_mode='lockstep')")
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
        self._staging: Dict[int, Dict] = {}      # slot -> batch-1 cache
        # MoE drop / miss totals over every step, kept on the device
        self.dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        self.miss = torch.zeros((), dtype=torch.int64, device=self.device)

    def _runtime(self):
        return self.pool.runtime(self.device) if self.pool else None

    def _tally(self, stats: MoEStats) -> None:
        self.dropped += stats.dropped
        self.miss += stats.miss

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)

    def _commit(self, slot: int, one: Dict) -> None:
        """Write a batch-1 dense cache into ``slot`` of the batch cache."""
        for name, big in self.cache.items():
            big.k[:, slot] = one[name].k[:, 0]
            big.v[:, slot] = one[name].v[:, 0]
            big.length[:, slot] = one[name].length[:, 0]

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: np.ndarray) -> torch.Tensor:
        """Whole-prompt prefill straight into ``slot`` of the batch cache;
        returns the last position's logits (1, V) fp32."""
        logits, one, stats = self.model.prefill(
            self.params, self._tokens(prompt)[None], self._runtime(),
            max_slots=self.max_seq)
        self._commit(slot, one)
        self._tally(stats)
        return logits

    @torch.inference_mode()
    def prefill_chunk(self, slot: int, chunk: np.ndarray, start: int, *,
                      is_first: bool, is_last: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunked-prefill step for ``slot`` (dense mode) -> (logits,
        per-expert token counts).  Chunks accumulate in a batch-1 staging
        cache; the last chunk commits it into the slot."""
        if is_first:
            self._staging[slot] = self.model.init_cache(1, self.max_seq)
        logits, staging, stats = self.model.prefill_chunk(
            self.params, self._tokens(chunk)[None], self._staging[slot],
            start, self._runtime())
        if is_last:
            self._commit(slot, self._staging.pop(slot))
        self._tally(stats)
        return logits, stats.expert_load

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """One decode step over the whole slot batch -> (logits (B, V),
        per-expert token counts (E,)), in the executor's decode mode."""
        tok, rt = self._tokens(tokens), self._runtime()
        if self.decode_mode == "lockstep":
            logits, self.cache, stats = self.model.decode_step(
                self.params, tok, self.cache, rt)
        else:
            logits, self.cache, stats = split_batch_decode(
                lambda t, c: self.model.decode_step(self.params, t, c, rt),
                tok, self.cache, axis=1,
                enabled=self.decode_mode == "pipelined",
                stream=self._side_stream)
        self._tally(stats)
        return logits, stats.expert_load

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
        keep = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        # the slot each row's append is about to write, and its old values
        saved = {}
        for name, c in self.cache.items():
            n_layers, B, slots = c.k.shape[:3]
            li = torch.arange(n_layers, device=self.device)[:, None]
            bi = torch.arange(B, device=self.device)[None, :]
            at = (li, bi, c.length.clamp(max=slots - 1).long())
            saved[name] = (at, c.k[at], c.v[at], c.length.clone())
        logits, self.cache, stats = self.model.decode_step(
            self.params, self._tokens(tokens), self.cache, self._runtime())
        for name, (at, k_old, v_old, len_old) in saved.items():
            c = self.cache[name]
            row = keep[None, :, None, None]
            c.k[at] = torch.where(row, c.k[at], k_old)
            c.v[at] = torch.where(row, c.v[at], v_old)
            c.length.copy_(torch.where(keep[None, :], c.length, len_old))
        self._tally(stats)
        return logits, stats.expert_load

    # -------------------------------------------------------------- paged
    def _with_tables(self, tables: np.ndarray, lengths: np.ndarray) -> Dict:
        """The pools with host tables / lengths uploaded (shared by every
        layer of both stacks)."""
        t = torch.as_tensor(np.asarray(tables, np.int32), device=self.device)
        n = torch.as_tensor(np.asarray(lengths, np.int32),
                            device=self.device)
        return {name: kvc.PagedKVCache(c.k, c.v, t, n)
                for name, c in self.cache.items()}

    @torch.inference_mode()
    def prefill_chunk_paged(self, chunk: np.ndarray, start: int,
                            table_row: np.ndarray
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prefill chunk through the slot's block-table row, straight
        into the pool blocks -> (logits, per-expert token counts).  A
        prefix-cache hit starts ``start`` past the cached prefix, and the
        chunk attends over blocks an earlier request wrote."""
        view = self._with_tables(np.asarray(table_row)[None], [start])
        logits, _, stats = self.model.prefill_chunk(
            self.params, self._tokens(chunk)[None], view, start,
            self._runtime())
        self._tally(stats)
        return logits, stats.expert_load

    @torch.inference_mode()
    def decode_paged(self, tokens: np.ndarray, tables: np.ndarray,
                     lengths: np.ndarray) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """One decode step with host-authoritative tables / lengths."""
        logits, _, stats = self.model.decode_step(
            self.params, self._tokens(tokens),
            self._with_tables(tables, lengths), self._runtime())
        self._tally(stats)
        return logits, stats.expert_load

    @torch.inference_mode()
    def copy_blocks(self, pairs) -> None:
        """Apply copy-on-write forks: pool blocks src -> dst, every layer
        of both stacks."""
        if not pairs:
            return
        src = torch.as_tensor([s for s, _ in pairs], device=self.device)
        dst = torch.as_tensor([d for _, d in pairs], device=self.device)
        for c in self.cache.values():
            kvc.copy_blocks(c, src, dst, stacked=True)

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
        E = self.model.cfg.moe.num_experts
        for sw in self._server_weights():
            expert_server.reshard_server_weights(
                sw, E, pool.num_servers, pool.redundant_table)
