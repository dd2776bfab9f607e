"""Step execution — the executor half of the engine split.

The :class:`Executor` owns the params, the batched dense KV cache and the
two step variants of this slice: whole-prompt ``prefill`` into a fresh
batch-1 cache that is then written into the slot, and lockstep ``decode``
of one token for the whole slot batch (idle slots included, as in the
reference, so capacity use and routing match).  The reference's ``jax.jit``
has no counterpart: PyTorch runs eagerly.  The expert->server mapping,
liveness mask and local table are read from the pool at every step, so
failover takes effect at the next step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.moe_layer import MoEStats
from repro_torch.models.transformer import Model


class Executor:
    """Owns params + caches + step variants for one engine."""

    def __init__(self, model: Model, params: Dict, pool, *, max_batch: int,
                 max_seq: int, device):
        self.model = model
        self.params = params
        self.pool = pool
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache = model.init_cache(max_batch, max_seq)
        # MoE drop / miss totals over every step, kept on the device
        self.dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        self.miss = torch.zeros((), dtype=torch.int64, device=self.device)

    def _runtime(self):
        return self.pool.runtime(self.device) if self.pool else None

    def _tally(self, stats: MoEStats) -> None:
        self.dropped += stats.dropped
        self.miss += stats.miss

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: np.ndarray) -> torch.Tensor:
        """Whole-prompt prefill straight into ``slot`` of the batch cache;
        returns the last position's logits (1, V) fp32."""
        tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                 device=self.device)[None]
        logits, one, stats = self.model.prefill(
            self.params, tokens, self._runtime(), max_slots=self.max_seq)
        for name, big in self.cache.items():
            big.k[:, slot] = one[name].k[:, 0]
            big.v[:, slot] = one[name].v[:, 0]
            big.length[:, slot] = one[name].length[:, 0]
        self._tally(stats)
        return logits

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
        """One decode step over the whole slot batch -> (logits (B, V),
        per-expert token counts (E,))."""
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=self.device)
        logits, self.cache, stats = self.model.decode_step(
            self.params, tok, self.cache, self._runtime())
        self._tally(stats)
        return logits, stats.expert_load
