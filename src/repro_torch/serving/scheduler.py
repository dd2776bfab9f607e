"""Admission and step planning — the scheduler half of the engine split.

This slice ports the reference's dense, whole-prompt, prefill-priority
path: requests enter free slots in arrival order, every pending prompt is
prefilled in one step before decoding, then one decode step runs over the
decode-ready slots.  Chunked prefill, the other policies and the paged
KV pool come in later slices.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclass
class SchedulerConfig:
    max_batch: int


@dataclass(frozen=True)
class PrefillChunk:
    """Prefill ``request``'s whole prompt into slot ``slot``."""
    slot: int
    request: Request
    length: int
    tokens: np.ndarray


@dataclass(frozen=True)
class DecodeBatch:
    """One decode step over the decode-ready slots."""
    slots: tuple


@dataclass(frozen=True)
class Idle:
    """Nothing to do — sweep the clock forward."""


class Scheduler:
    """Slot admission + step planning over a fixed slot pool."""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * cfg.max_batch
        # admitted, not yet prefilled; insertion order = admission order
        self._pending: Dict[int, None] = {}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def release(self, slot: int) -> None:
        """Free a slot whose request completed."""
        self.slots[slot] = None
        self._pending.pop(slot, None)

    def decode_ready(self) -> List[int]:
        return [b for b, r in enumerate(self.slots)
                if r is not None and b not in self._pending]

    def _admit(self) -> None:
        for b in range(len(self.slots)):
            if self.slots[b] is None and self.queue:
                self.slots[b] = self.queue.popleft()
                self._pending[b] = None

    def next_plan(self):
        """Admit what fits; prefill first, else decode, else idle."""
        self._admit()
        if self._pending:
            b = next(iter(self._pending))
            req = self.slots[b]
            tokens = np.asarray(req.prompt, np.int32)
            return PrefillChunk(slot=b, request=req, length=len(tokens),
                                tokens=tokens)
        ready = self.decode_ready()
        return DecodeBatch(slots=tuple(ready)) if ready else Idle()

    def prefill_advanced(self, slot: int, length: int) -> None:
        """Record the slot's whole-prompt prefill: it is decode-ready."""
        self._pending.pop(slot, None)
