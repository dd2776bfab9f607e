"""Admission and step planning — the scheduler half of the engine split
(counterpart of ``src/repro/serving/scheduler.py``).

The :class:`Scheduler` owns the request queue and the slot table and decides
what the next engine step *is*: a prefill chunk, a decode step over the
decode-ready slots, or idle.  It never touches params or caches — that is
the :class:`~repro_torch.serving.executor.Executor`'s side of the line — so
policies stay pure host logic, deterministic under a virtual clock.

Chunked prefill: a prompt is split into chunks of at most
``prefill_chunk`` tokens and each chunk is one engine step, so decode steps
can interleave with a long prompt's admission.  ``prefill_chunk=0`` is the
whole prompt in one step.

Policies (what runs when both prefill work and decode-ready slots exist):

* ``prefill-priority`` (default): drain every pending prefill chunk before
  decoding;
* ``fair``: strictly alternate — at most one prefill chunk between
  consecutive decode steps;
* ``fcfs``: in-flight requests decode to completion before any queued
  prompt is prefilled.

Memory-aware mode (a :class:`~repro_torch.serving.kv_pool.BlockPool`
attached): admission adopts cached prefix blocks and gates on the blocks
the first chunk needs; each chunk's blocks are allocated at plan time, the
chunk shrinking to what the pool holds; a full pool preempts the
lowest-priority slot (latest arrival, ties to the larger request id),
which is re-queued at the front and later recomputed as a prompt extension
(``prompt + outputs[:-1]``), so token streams are unchanged.

TP mode (``batch_cap``): admission stops at slot ``batch_cap`` — the
per-unit weight replication caps the batch.

Async exec mode (``hold``): a slot whose final token is already in flight
on the expert tier leaves decode planning until its completion releases
it.

Sampling keys (``slot_keys``): each slot's ``fold_in(PRNGKey(seed),
request_id)``, stored at admission as the reference stores it
(:func:`repro_torch.serving.sampling.slot_key`).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.kv_pool import SCRATCH_BLOCK, BlockPool, block_hashes
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import slot_key

POLICIES = ("prefill-priority", "fair", "fcfs")


@dataclass
class SchedulerConfig:
    max_batch: int
    prefill_chunk: int = 0             # 0 = whole prompt in one step
    policy: str = "prefill-priority"   # prefill-priority | fair | fcfs
    batch_cap: Optional[int] = None    # TP weight-replication slot cap
    max_seq: int = 0                   # cache capacity (paged mode only)


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown scheduling policy {policy!r}; expected one of "
            f"{POLICIES}")


# ------------------------------------------------------------------- plans

@dataclass(frozen=True)
class PrefillChunk:
    """Run sequence positions [start, start+length) of ``request`` (slot b).

    ``tokens`` carries the chunk's token ids (the *effective* sequence —
    after a preemption this is the prompt extended with the regenerated
    tokens, which ``request.prompt`` alone no longer covers).  ``copies``
    lists pending copy-on-write block forks ``(src, dst)`` the executor
    must apply before this chunk runs.
    """
    slot: int
    request: Request
    start: int
    length: int
    is_first: bool
    is_last: bool
    tokens: Optional[np.ndarray] = None
    copies: Tuple[Tuple[int, int], ...] = ()


@dataclass(frozen=True)
class DecodeBatch:
    """One decode step over the decode-ready slots."""
    slots: Tuple[int, ...]


@dataclass(frozen=True)
class Idle:
    """Nothing to do — sweep the clock forward."""


@dataclass
class _SlotKV:
    """Paged-mode per-slot state."""
    hashes: List[bytes] = dc_field(default_factory=list)
    n_prompt_blocks: int = 0           # full prompt blocks (hashable)
    registered: int = 0                # prompt blocks already published
    cached_len: int = 0                # prefix tokens adopted from the cache
    copies: List[Tuple[int, int]] = dc_field(default_factory=list)


# --------------------------------------------------------------- scheduler

class Scheduler:
    """Slot admission + step planning over a fixed slot pool, optionally
    memory-aware over a KV :class:`~repro_torch.serving.kv_pool.BlockPool`."""

    def __init__(self, cfg: SchedulerConfig,
                 kv_pool: Optional[BlockPool] = None):
        _check_policy(cfg.policy)
        self.cfg = cfg
        self.kv = kv_pool
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * cfg.max_batch
        # per-slot sampling keys: fold_in(PRNGKey(sampling.seed), request_id)
        self.slot_keys = np.zeros((cfg.max_batch, 2), np.uint32)
        # slot -> sequence tokens already prefilled (present = mid-prefill,
        # i.e. NOT decode-ready); insertion order = admission order
        self._progress: Dict[int, int] = {}
        # slots held out of decode planning (async exec mode)
        self._held: set = set()
        self._last_was_prefill = False
        self.preemptions = 0
        if kv_pool is not None:
            if cfg.max_seq % kv_pool.block_size:
                raise ValueError(
                    f"max_seq={cfg.max_seq} must be a multiple of the KV "
                    f"block size {kv_pool.block_size}")
            self.max_blocks = cfg.max_seq // kv_pool.block_size
            self.block_tables = np.zeros((cfg.max_batch, self.max_blocks),
                                         np.int32)
            self._kvmeta: Dict[int, _SlotKV] = {}

    # ------------------------------------------------------------ control
    def set_policy(self, policy: str) -> None:
        _check_policy(policy)
        self.cfg.policy = policy

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def release(self, slot: int) -> None:
        """Free a slot whose request completed."""
        self.slots[slot] = None
        self._progress.pop(slot, None)
        self._held.discard(slot)
        if self.kv is not None:
            self._release_slot_kv(slot)

    def hold(self, slot: int) -> None:
        """Exclude a slot from decode planning (async exec mode: its last
        wave is in flight; the release at its completion unholds it)."""
        self._held.add(slot)

    # ------------------------------------------------------------ signals
    def decode_ready(self) -> List[int]:
        return [b for b, r in enumerate(self.slots)
                if r is not None and b not in self._progress
                and b not in self._held]

    @staticmethod
    def _eff_len(req: Request) -> int:
        """Length of the sequence a slot must hold *before* decoding: the
        prompt plus any already-generated tokens except the last (which is
        the next decode step's input) — a plain prompt for fresh requests,
        the recompute target for preempted ones."""
        return len(req.prompt) + max(len(req.output_tokens) - 1, 0)

    @staticmethod
    def _eff_tokens(req: Request) -> np.ndarray:
        if not req.output_tokens:
            return np.asarray(req.prompt, np.int32)
        return np.concatenate([
            np.asarray(req.prompt, np.int32),
            np.asarray(req.output_tokens[:-1], np.int32)])

    def pending_prefill_tokens(self) -> int:
        """Sequence tokens not yet prefilled (queued + mid-chunk backlog) —
        the autoscaler's prefill-pressure signal."""
        queued = sum(self._eff_len(r) for r in self.queue)
        inflight = sum(self._eff_len(self.slots[b]) - done
                       for b, done in self._progress.items())
        return queued + inflight

    def kv_free_fraction(self) -> float:
        """Free-block fraction of the KV pool (1.0 when not paged) — the
        autoscaler's KV-pressure signal."""
        return self.kv.free_fraction() if self.kv is not None else 1.0

    def cache_length(self, slot: int) -> int:
        """Tokens a live slot's cache holds right now (paged lengths are
        host-authoritative; the engine uploads them at each step)."""
        r = self.slots[slot]
        if r is None:
            return 0
        if slot in self._progress:
            return self._progress[slot]
        return self._eff_len(r)

    def cache_lengths(self) -> np.ndarray:
        return np.asarray([self.cache_length(b)
                           for b in range(len(self.slots))], np.int32)

    # ----------------------------------------------------------- planning
    def _admit(self) -> None:
        cap = self.cfg.batch_cap
        for b in range(len(self.slots)):
            if cap is not None and b >= cap:
                break
            if self.slots[b] is None and self.queue:
                req = self.queue[0]
                if self.kv is not None and not self._admit_blocks(b, req):
                    break                  # head-of-line waits for memory
                self.queue.popleft()
                self.slots[b] = req
                # a prefix-cache hit starts progress past the cached prefix
                # (always < eff_len: a whole-sequence hit is capped one
                # token short by the copy-on-write fork, so prefill always
                # has logits to produce)
                self._progress[b] = (self._kvmeta[b].cached_len
                                     if self.kv is not None else 0)
                self.slot_keys[b] = slot_key(req.sampling.seed,
                                             req.request_id)

    def _chunk_plan(self) -> Optional[PrefillChunk]:
        b, done = next(iter(self._progress.items()))
        req = self.slots[b]
        total = self._eff_len(req)
        chunk = self.cfg.prefill_chunk or total
        length = min(chunk, total - done)
        copies: Tuple[Tuple[int, int], ...] = ()
        if self.kv is not None:
            length = self._ensure_prefill_blocks(b, done, length)
            if length == 0:
                return None
            meta = self._kvmeta[b]
            copies = tuple(meta.copies)
            meta.copies = []
            # the engine applies the COW data copies before this chunk runs,
            # with no allocation in between — safe to release the sources
            for src, _ in copies:
                self.kv.decref(src)
        tokens = self._eff_tokens(req)[done:done + length]
        return PrefillChunk(slot=b, request=req, start=done, length=length,
                            is_first=(done == (self._kvmeta[b].cached_len
                                               if self.kv is not None
                                               else 0)),
                            is_last=(done + length >= total),
                            tokens=tokens, copies=copies)

    def next_plan(self):
        """Admit what fits, then pick the next step per the active policy."""
        self._admit()
        pending = bool(self._progress)
        ready = self.decode_ready()
        policy = self.cfg.policy
        if pending and ready:
            if policy == "prefill-priority":
                do_prefill = True
            elif policy == "fcfs":
                do_prefill = False
            else:                        # fair: strict alternation
                do_prefill = not self._last_was_prefill
        else:
            do_prefill = pending
        if do_prefill:
            plan = self._chunk_plan()
            if plan is not None:
                self._last_was_prefill = True
                return plan
            ready = self.decode_ready()  # planning may have preempted
        self._last_was_prefill = False
        if ready:
            if self.kv is not None:
                ready = self._ensure_decode_blocks(ready)
            if ready:
                return DecodeBatch(slots=tuple(ready))
        return Idle()

    def prefill_advanced(self, slot: int, length: int) -> bool:
        """Record chunk completion; True when the slot became decode-ready."""
        self._progress[slot] += length
        done = self._progress[slot]
        if self.kv is not None:
            self._register_full_blocks(slot, done)
        if done >= self._eff_len(self.slots[slot]):
            del self._progress[slot]
            return True
        return False

    # ----------------------------------------------------- paged admission
    def _admit_blocks(self, slot: int, req: Request) -> bool:
        """Adopt cached prefix blocks and allocate the first chunk's fresh
        blocks for ``req``; False (nothing held) when the pool can't cover
        it yet."""
        kv, bs = self.kv, self.kv.block_size
        eff = self._eff_tokens(req)
        eff_len = len(eff)
        if eff_len > self.cfg.max_seq:
            raise ValueError(f"request {req.request_id} needs {eff_len} "
                             f"cache slots > max_seq={self.cfg.max_seq}")
        n_prompt_blocks = len(req.prompt) // bs
        hashes = block_hashes(req.prompt, bs)
        matched = kv.match_prefix(hashes)
        copies: List[Tuple[int, int]] = []
        if len(matched) * bs >= eff_len:
            # whole sequence cached: recompute at least the last position so
            # prefill produces logits — which *writes* into the final shared
            # block, so fork it (copy-on-write).  The match's reference on
            # the source block is kept until the executor applies the data
            # copy (released at plan handoff / slot release).
            dst = kv.fork(matched[-1])
            if dst is None:
                for bid in matched:
                    kv.decref(bid)
                return False
            copies.append((matched[-1], dst))
            matched[-1] = dst
            cached_len = eff_len - 1
        else:
            cached_len = len(matched) * bs
        # fresh blocks for the first prefill chunk past the cached prefix
        chunk = self.cfg.prefill_chunk or (eff_len - cached_len)
        first_end = min(cached_len + chunk, eff_len)
        n_have = len(matched)
        n_need = _ceil_div(first_end, bs) - n_have
        fresh = kv.allocate(n_need) if n_need > 0 else []
        if fresh is None:
            for bid in matched:
                kv.decref(bid)
            for src, _ in copies:
                kv.decref(src)
            return False
        row = self.block_tables[slot]
        row[:] = SCRATCH_BLOCK
        ids = matched + fresh
        row[:len(ids)] = ids
        self._kvmeta[slot] = _SlotKV(
            hashes=hashes, n_prompt_blocks=n_prompt_blocks,
            registered=min(len(matched), n_prompt_blocks),
            cached_len=cached_len, copies=copies)
        return True

    def _ensure_prefill_blocks(self, slot: int, done: int,
                               length: int) -> int:
        """Allocate blocks covering [done, done+length); shrink the chunk
        to what the pool can hold, preempting lower-priority slots when
        even one new token cannot be covered.  (The engine validates at
        construction that one maximal request fits the pool, so with every
        other slot preempted the allocation always succeeds.)"""
        bs = self.kv.block_size
        row = self.block_tables[slot]
        while True:
            for idx in range(self._covered_until(slot) // bs,
                             _ceil_div(done + length, bs)):
                one = self.kv.allocate(1)
                if one is None:
                    break
                row[idx] = one[0]
            have = self._covered_until(slot)
            if have > done:
                return min(length, have - done)
            if self._preempt_lowest(exclude=slot) is None:
                return 0

    def _covered_until(self, slot: int) -> int:
        """First sequence position NOT covered by the slot's block table."""
        row = self.block_tables[slot]
        n = 0
        while n < self.max_blocks and row[n] != SCRATCH_BLOCK:
            n += 1
        return n * self.kv.block_size

    def _ensure_decode_blocks(self, ready: List[int]) -> List[int]:
        """Guarantee each decode-ready slot a block for the position it is
        about to write; preempt victims (dropping them from ``ready``)
        until the survivors fit."""
        bs = self.kv.block_size
        survivors = list(ready)
        for b in list(survivors):
            if b not in survivors:       # preempted as a victim meanwhile
                continue
            if self.slots[b] is None:
                survivors.remove(b)
                continue
            pos = self.cache_length(b)
            idx = pos // bs
            if idx >= self.max_blocks:
                # at cache capacity: the write clamps into the last block
                # (dense-cache behaviour) and the engine retires the
                # request right after this step
                continue
            row = self.block_tables[b]
            while row[idx] == SCRATCH_BLOCK:
                got = self.kv.allocate(1)
                if got is not None:
                    row[idx] = got[0]
                    break
                victim = self._preempt_lowest(exclude=b)
                if victim is None:
                    raise RuntimeError(
                        "KV pool cannot hold a single request — "
                        "num_blocks is below the per-request maximum")
                if victim in survivors:
                    survivors.remove(victim)
        return survivors

    # ---------------------------------------------------------- preemption
    def _preempt_lowest(self, exclude: int) -> Optional[int]:
        """Preempt the lowest-priority live slot (latest arrival, ties to
        the larger request id), excluding ``exclude``.  Returns the slot
        preempted, or None when no victim exists."""
        victims = [(r.arrival_time, r.request_id, b)
                   for b, r in enumerate(self.slots)
                   if r is not None and b != exclude]
        if not victims:
            return None
        _, _, b = max(victims)
        self.preempt(b)
        return b

    def preempt(self, slot: int) -> Request:
        """Release a slot's blocks and re-queue its request at the front
        (it keeps arrival priority); generated tokens ride along so the
        re-admitted request is re-planned as a prompt extension."""
        req = self.slots[slot]
        if req is None or self.kv is None:
            raise ValueError(f"slot {slot} holds no request to preempt")
        self._release_slot_kv(slot)
        self.slots[slot] = None
        self._progress.pop(slot, None)
        self.queue.appendleft(req)
        self.preemptions += 1
        return req

    def _release_slot_kv(self, slot: int) -> None:
        """Release a slot's table blocks plus any still-held COW sources
        (pending copies whose data never got applied)."""
        row = self.block_tables[slot]
        for bid in row:
            if bid != SCRATCH_BLOCK:
                self.kv.decref(int(bid))
        row[:] = SCRATCH_BLOCK
        meta = self._kvmeta.pop(slot, None)
        if meta is not None:
            for src, _ in meta.copies:
                self.kv.decref(src)

    def _register_full_blocks(self, slot: int, done: int) -> None:
        """Publish freshly completed full *prompt* blocks to the prefix
        cache (blocks holding generated tokens stay private)."""
        meta = self._kvmeta[slot]
        bs = self.kv.block_size
        upto = min(meta.n_prompt_blocks, done // bs)
        row = self.block_tables[slot]
        for j in range(meta.registered, upto):
            self.kv.register(int(row[j]), meta.hashes[j])
        meta.registered = max(meta.registered, upto)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
