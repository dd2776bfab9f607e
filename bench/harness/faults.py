"""Faults planted in the timed path, to show that ``correct`` catches
them: each ``fault(cell, setattr)`` breaks a built cell's engine
underneath, through ``setattr(obj, name, value)`` (pytest's
``monkeypatch.setattr`` in the tests, :class:`Patches` in the tools).

* :func:`state_unchanged`: a decode step leaves the KV cache as it was;
* :func:`half_batch`: half of the decode batch's rows are not computed;
* :func:`no_exchange`: the servers' results never come back;
* :func:`token_altered`: a token altered where the sampler produces it;
* :func:`argmax_sampler`: the sampler returns the argmax at any
  temperature;
* :func:`temperature_ignored`: the sampler draws at temperature 1.
"""

from __future__ import annotations

import numpy as np
import torch


class Patches:
    """``setattr`` that remembers, and :meth:`undo` that restores."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name: str, value) -> None:
        own = name in vars(obj) if hasattr(obj, "__dict__") else False
        self.saved.append((obj, name, own, getattr(obj, name, None)))
        setattr(obj, name, value)

    def undo(self) -> None:
        for obj, name, own, old in reversed(self.saved):
            if own:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self.saved.clear()


def state_unchanged(cell, setattr) -> None:
    """Each decode step's KV cache written back as it was before it."""
    from repro_torch.serving import step_graphs
    ex = cell.engine.executor
    real = ex.decode

    def decode(tokens):
        old = [t.clone() for t in step_graphs.tensors(ex.cache)]
        out = real(tokens)
        for t, o in zip(step_graphs.tensors(ex.cache), old):
            t.copy_(o)
        return out
    setattr(ex, "decode", decode)


def half_batch(cell, setattr) -> None:
    """The second half of the decode batch's rows not computed: the
    first half's logits stand in for them."""
    ex = cell.engine.executor
    real = ex.decode

    def decode(tokens):
        logits, load = real(tokens)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, load
    setattr(ex, "decode", decode)


def no_exchange(cell, setattr) -> None:
    """The servers' results never come back to the client (on one card,
    the exchange that crosses chips in a deployment)."""
    from repro_torch.core import comm
    setattr(comm, "return_to_clients",
            lambda outs, mode="local", group=None:
            [torch.zeros_like(o) for o in outs])


def token_altered(cell, setattr) -> None:
    """Each request's third token altered where the sampler produces
    it."""
    eng = cell.engine
    real = eng._sample
    V = cell.m["vocab_size"]

    def sample(logits, slots, steps):
        out = np.array(real(logits, slots, steps))
        for i, step in enumerate(steps):
            if step == 2:
                out[i] = (out[i] + 1) % V
        return out
    setattr(eng, "_sample", sample)


def argmax_sampler(cell, setattr) -> None:
    """Every token the argmax of its logits, whatever the temperature."""
    def sample(logits, slots, steps):
        return torch.argmax(logits, dim=-1).cpu().numpy()
    setattr(cell.engine, "_sample", sample)


def temperature_ignored(cell, setattr) -> None:
    """A row sampled at temperature T drawn at 1 instead: its logits
    scaled by T before the sampler divides them by T (greedy rows as
    they are)."""
    eng = cell.engine
    real = eng._sample

    def sample(logits, slots, steps):
        t = [eng.scheduler.slots[b].sampling.temperature for b in slots]
        scale = torch.tensor([x if x > 0 else 1.0 for x in t],
                             dtype=logits.dtype, device=logits.device)
        return real(logits * scale[:, None], slots, steps)
    setattr(eng, "_sample", sample)


ALL = {f.__name__: f for f in (state_unchanged, half_batch, no_exchange,
                               token_altered, argmax_sampler,
                               temperature_ignored)}
