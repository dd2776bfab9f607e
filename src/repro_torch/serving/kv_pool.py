"""Host-side KV block-pool manager (the paged-KV subsystem's control plane).

A verbatim copy of ``src/repro/serving/kv_pool.py`` (host numpy only), so
block ids, prefix matches and counters equal the reference's step by step.

EaaS makes the expert tier stateless, so *attention-client memory* — the KV
cache — is what caps admitted traffic.  The dense per-slot cache strands
``max_seq - len`` slots per short request; the :class:`BlockPool` instead
carves client memory into fixed-size blocks and hands them out on demand:

* **refcounted blocks** — a block is ``free``, ``live`` (refcount > 0) or
  ``cached`` (refcount 0 but still holding a hashed prompt block: evictable
  LRU, resurrectable on a prefix hit);
* **hash-based prefix caching** — full prompt blocks are registered under a
  running (chained) hash of the token prefix, so a later request with the
  same system prompt adopts the cached blocks and prefills only its
  uncached suffix;
* **copy-on-write** — when a request must *write* a position inside a
  shared block (the fully-cached-prompt case: the last prompt token is
  always recomputed to produce first-token logits), the pool forks the
  block — bookkeeping here, the data copy in the executor;
* **eviction** — allocation falls back to reclaiming cached blocks oldest
  first; live blocks are never reclaimed (that is *preemption*, the
  scheduler's move).

Block 0 is reserved as the scratch sink: unset table entries point at it so
batched writes from inactive rows land somewhere harmless and never
alias a live block.

All of it is pure host bookkeeping over deterministic containers (deque +
insertion-ordered dicts) — replays are bit-identical under the virtual
clock, which the scenario fingerprint tests rely on.
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

SCRATCH_BLOCK = 0


def block_hashes(tokens: np.ndarray, block_size: int) -> List[bytes]:
    """Chained content hashes of the *full* blocks of a token sequence.

    ``out[j]`` digests tokens ``[0, (j+1)*block_size)`` — each hash commits
    to the whole prefix, so equal hashes mean equal prefixes and matching
    can stop at the first miss.  Partial tail blocks are never hashed (they
    are private to their request).
    """
    h = hashlib.sha256()
    out: List[bytes] = []
    arr = np.asarray(tokens, np.int64)
    for j in range(len(arr) // block_size):
        h.update(arr[j * block_size:(j + 1) * block_size].tobytes())
        out.append(h.digest())
    return out


class BlockPool:
    """Refcounted fixed-size KV blocks with prefix caching and LRU eviction.

    Purely host-side: the pool never touches tensors.  It decides *which*
    pool slots hold *whose* tokens; the executor moves the actual K/V bytes.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is reserved scratch), "
                             f"got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        self._free: Deque[int] = deque(range(1, num_blocks))
        self._ref = np.zeros(num_blocks, np.int64)
        self._hash_of: Dict[int, bytes] = {}     # live/cached block -> hash
        self._block_of: Dict[bytes, int] = {}    # hash -> block
        self._evictable: Dict[int, None] = {}    # refcount-0 cached (LRU)
        # counters (read by ServingMetrics)
        self.matched_blocks = 0
        self.queried_blocks = 0
        self.evictions = 0
        self.cow_forks = 0

    # ------------------------------------------------------------ capacity
    @property
    def usable_blocks(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    def available(self) -> int:
        """Blocks an allocation could obtain: free + evictable-cached."""
        return len(self._free) + len(self._evictable)

    def free_fraction(self) -> float:
        """The autoscaler's kv-pressure signal: available / usable."""
        return self.available() / max(self.usable_blocks, 1)

    def utilization(self) -> float:
        """Share of usable blocks currently live (referenced)."""
        return 1.0 - self.free_fraction()

    # ---------------------------------------------------------- allocation
    def allocate(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh private blocks (refcount 1 each), evicting
        cached blocks oldest-first if the free list runs dry.  Returns None
        (allocating nothing) when fewer than ``n`` are obtainable."""
        if self.available() < n:
            return None
        out = []
        for _ in range(n):
            if self._free:
                bid = self._free.popleft()
            else:
                bid = next(iter(self._evictable))     # LRU: oldest first
                self._evict(bid)
            self._ref[bid] = 1
            out.append(bid)
        return out

    def _evict(self, bid: int) -> None:
        del self._evictable[bid]
        h = self._hash_of.pop(bid)
        del self._block_of[h]
        self.evictions += 1

    def incref(self, bid: int) -> None:
        if self._ref[bid] == 0 and bid in self._evictable:
            del self._evictable[bid]                  # resurrect
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        assert self._ref[bid] > 0, bid
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            if bid in self._hash_of:
                self._evictable[bid] = None           # cached, LRU tail
            else:
                self._free.append(bid)

    # -------------------------------------------------------- prefix cache
    def match_prefix(self, hashes: List[bytes]) -> List[int]:
        """Adopt the longest cached prefix: returns the matched block ids
        (each increfed) — stops at the first miss."""
        out: List[int] = []
        if self.enable_prefix_cache:
            for h in hashes:
                self.queried_blocks += 1
                bid = self._block_of.get(h)
                if bid is None:
                    break
                self.incref(bid)
                self.matched_blocks += 1
                out.append(bid)
        return out

    def register(self, bid: int, h: bytes) -> None:
        """Publish a live block's content hash so later prompts can share
        it.  First writer wins — a concurrent duplicate keeps its private
        copy unregistered."""
        if not self.enable_prefix_cache:
            return
        if h in self._block_of or bid in self._hash_of:
            return
        self._block_of[h] = bid
        self._hash_of[bid] = h

    def fork(self, bid: int) -> Optional[int]:
        """Copy-on-write: allocate a fresh private block to replace shared
        ``bid``.  Returns the new block id, or None when the pool cannot
        supply one.

        The caller KEEPS its reference on ``bid`` until the executor has
        applied the data copy ``bid -> new`` (then ``decref(bid)``):
        releasing the source first would let allocation evict and reuse it
        while the copy is still pending, silently corrupting the adopted
        prefix."""
        fresh = self.allocate(1)
        if fresh is None:
            return None
        self.cow_forks += 1
        return fresh[0]
