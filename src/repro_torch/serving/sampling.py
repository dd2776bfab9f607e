"""Token sampling from logits: the reference's streams, exactly.

Each slot's base key is ``fold_in(PRNGKey(seed), request_id)``, stored at
admission (:func:`slot_key`); row b of a batch draws with
``fold_in(key_b, step_b)``, ``step_b`` the tokens the request has
generated so far, so a stream is a pure function of (request seed,
request id, token index), whatever the batch or the schedule.  Greedy rows
(temperature <= 0) take the first maximum.  The draw is JAX's threefry
Gumbel-max bit for bit (:mod:`repro_torch.kernels.sampling`; on the card
one kernel launch a batch), so the tokens are the reference's.  A batch
with no row above temperature 0 is ``torch.argmax`` alone: the same
tokens, no key or step to copy.

An engine samples through :class:`SlotSampler`, which keeps the slots'
keys and temperatures on the device: a decode step then copies only its
(slot, step) pairs.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.sampling import fold_in, prng_key, reserve


def slot_key(seed: int, request_id: int) -> np.ndarray:
    """A request's base key, (2,) uint32: ``fold_in(PRNGKey(seed),
    request_id)``, as the reference's scheduler stores it at admission."""
    return np.asarray(fold_in(prng_key(seed), request_id), np.uint32)


def _all_greedy(temperatures) -> bool:
    return not any(t > 0 for t in temperatures)


def sample_batch(logits: torch.Tensor,
                 temperatures: Union[Sequence[float], np.ndarray],
                 keys: np.ndarray,
                 steps: Union[Sequence[int], np.ndarray]) -> torch.Tensor:
    """logits (B, V) fp32 -> (B,) int64 on the logits' device:
    temperatures (B,), keys (B, 2) uint32 base keys, steps (B,) token
    indices, from the host (copied to the device for the one launch)."""
    if _all_greedy(temperatures):
        return torch.argmax(logits, dim=-1)
    dev = logits.device

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype)).to(dev)
    return ops.sample(logits, put(temperatures, np.float32),
                      put(keys, np.int64), put(steps, np.int64))


class SlotSampler:
    """:func:`sample_batch` for a scheduler's slots.  The slots' base keys
    and temperatures live on the logits' device, copied there again only
    when an admission has changed a sampled slot's; a step copies its
    (slot, step) pairs in one non-blocking copy from pinned memory and
    gathers each row's key and temperature on the device.  On a CUDA
    ``device`` the kernel's workspace is reserved for ``max_batch`` rows
    at construction, so that no sampling call allocates it."""

    def __init__(self, max_batch: int, device=None):
        if device is not None and torch.device(device).type == "cuda":
            reserve(device, max_batch)
        # what the device tables hold (NaN: nothing yet)
        self._temps = np.full(max_batch, np.nan, np.float32)
        self._keys = np.zeros((max_batch, 2), np.uint32)
        self._tables = None            # (device, temps, keys) on the device

    def __call__(self, scheduler, logits: torch.Tensor, slots,
                 steps) -> torch.Tensor:
        """Row i of ``logits`` drawn for slot ``slots[i]`` at token index
        ``steps[i]``: (B,) int64 on the logits' device."""
        temps = [scheduler.slots[b].sampling.temperature for b in slots]
        if _all_greedy(temps):
            return torch.argmax(logits, dim=-1)
        temps = np.asarray(temps, np.float32)
        dev = logits.device
        idx = np.asarray(slots, np.int64)
        keys = scheduler.slot_keys[idx]
        if (self._tables is None or self._tables[0] != dev
                or not np.array_equal(self._temps[idx], temps)
                or not np.array_equal(self._keys[idx], keys)):
            self._temps[idx] = temps
            self._keys[idx] = keys
            self._tables = (dev, torch.from_numpy(self._temps).to(dev),
                            torch.from_numpy(
                                self._keys.astype(np.int64)).to(dev))
        pairs = torch.from_numpy(np.stack([idx, np.asarray(steps,
                                                           np.int64)]))
        if dev.type == "cuda":
            pairs = pairs.pin_memory().to(dev, non_blocking=True)
        _, t_dev, k_dev = self._tables
        return ops.sample(logits, t_dev.index_select(0, pairs[0]),
                          k_dev.index_select(0, pairs[0]), pairs[1])
