"""The executor's step variants as CUDA graphs: the counterpart of the
reference's compiled step functions (``Executor._build_jits``,
``src/repro/serving/executor.py``).

The reference compiles each step variant once per distinct input shape
and passes what changes between calls as jit *arguments*: the tokens, the
expert->server mapping, the liveness mask, the local table, the router
bias, the replica weights, the paged block tables and lengths, a prefill
chunk's ``start`` and the copy-on-write ``src`` / ``dst``.  Failover,
rebalancing, page-out, admission, a new slot or a prefix-cache hit then
never recompile; a new prompt or chunk length compiles once more, and a
pool resize does (``num_servers`` and ``capacity`` are static).

Here each variant is captured once per shape as a
``torch.cuda.CUDAGraph`` and replayed:

* :class:`StaticInputs` — the persistent device buffers that take the
  place of the jit arguments.  The executor writes each call's host
  arrays into them with ``copy_`` (only the ones that changed), so the
  captured kernels read the new data at the addresses they were captured
  with.  A buffer whose shape follows the call (a prompt's tokens, the
  copy pairs) is named by its shape, so each shape keeps its own.
* :class:`StepGraphs` — per variant: its structure (what the reference
  bakes in as static: the variant and mode, ``num_servers`` and
  ``capacity``, which optional inputs are present, the dispatch method,
  and the addresses of every tensor the step reads or writes: the static
  inputs, the weights and the caches) and, side by side, one graph per
  shape (a prompt or chunk length, a number of copy pairs), as the jit
  cache keeps one executable per shape: its static outputs and the
  kernel launches it makes.  The first call under a new shape runs the
  step eagerly, as ``eager()`` does (the real step: a warm-up would
  advance the cache), the next captures it and replays it, and later
  ones replay.  A new shape leaves the other shapes' graphs alone; a new
  structure drops every graph of the executor (:meth:`StepGraphs.reset`).
  One graph memory pool serves every variant and shape of one executor.

A resize reallocates the expert weights, so the structure sees new
addresses and every variant is captured again; an in-place migration
chunk or page-out keeps them, and keeps the graphs.  A failure to capture
or replay raises: nothing runs the step eagerly in a graph's place.

On the CPU (``device="cpu"``) and under :func:`eager` (the counterpart of
``jax.disable_jit()``) the same staging runs the step eagerly over the
static buffers.  :func:`eager` is ``kernels/build.py``'s switch, below
both this module and the models: it also turns off the scan bodies the
recurrent models capture once and replay inside an eager prefill
(``models/common.py::compiled_scan``: rwkv6's wkv recurrence, zamba2's
SSD carry).  Captures of both run on the device's one capture stream
(``build.capture``).

:func:`compile_fn` (``build.CompiledFn``) is ``jax.jit`` of a pure
layer call outside an executor (quickstart's two MoE programs): captured
at its first call, its data arguments in static buffers, so new data
replays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

# the switch is process-wide and lives below the models, whose scan bodies
# read it too (``kernels/build.py``); ``eager`` is the name callers use
_EAGER = build.EAGER
eager = build.eager
# a graph's tensors and their addresses, shared with the train step's graph
tensors = build.tensors
addresses = build.addresses
# a step's fresh state tensors copied back into the caller's storage
adopt = build.adopt
# ``jax.jit`` of a pure layer call outside an executor
CompiledFn = compile_fn = build.CompiledFn


class StaticInputs:
    """Persistent device buffers refreshed from host arrays."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: Dict[str, torch.Tensor] = {}
        self._host: Dict[str, np.ndarray] = {}

    def put(self, name: str, array) -> torch.Tensor:
        """The buffer ``name`` holding ``array``: written with ``copy_``
        where the array changed, reallocated only where its shape or dtype
        did (a new address, so a graph that read the old one is captured
        again)."""
        a = np.ascontiguousarray(array)
        buf = self._bufs.get(name)
        if buf is None or tuple(buf.shape) != a.shape \
                or self._host[name].dtype != a.dtype:
            buf = torch.as_tensor(a.copy(), device=self.device)
            self._bufs[name] = buf
            self._host[name] = a.copy()
        elif not np.array_equal(self._host[name], a):
            buf.copy_(torch.from_numpy(a))
            self._host[name] = a.copy()
        return buf


@dataclasses.dataclass
class _Variant:
    warm: bool = False
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: object = None
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class StepGraphs:
    """The captured step variants of one executor.

    ``keys[name]`` lists every (structure, shape) key variant ``name`` has
    run under, in order of first sight (a key seen again after a
    :meth:`reset` is listed again); ``captures[name]`` and
    ``replays[name]`` count the variant's captures and replays over all
    its shapes, and ``per_shape[name, shape]`` is ``[captures, replays]``
    of one shape (all 0 off the card and under :func:`eager`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._structure: Dict[str, tuple] = {}
        self._variants: Dict[str, Dict[tuple, _Variant]] = {}
        self.keys: Dict[str, List[tuple]] = {}
        self.captures: Dict[str, int] = {}
        self.replays: Dict[str, int] = {}
        self.per_shape: Dict[Tuple[str, tuple], List[int]] = {}
        self._pool = None

    @property
    def enabled(self) -> bool:
        return self.device.type == "cuda" and not build.EAGER[0]

    def reset(self) -> None:
        """Drop every graph (a pool resize, a new structure): each variant
        is captured again under its new key, into a new memory pool (the
        dropped graphs' pool is freed with the allocator's cache)."""
        self._variants.clear()
        self._structure.clear()
        self._pool = None

    def run(self, name: str, key: tuple, fn: Callable[[], object],
            shape: tuple = ()):
        """Run step variant ``name`` with structure ``key`` at ``shape``:
        ``fn()`` reads only the static inputs, the weights and the caches
        (their addresses are in ``key``; a buffer named by its shape has
        one address per shape).  Returns its outputs; a replay's are the
        graph's static outputs, overwritten by the next replay of any
        variant of this executor (they share one memory pool)."""
        if self._structure.setdefault(name, key) != key:
            self.reset()                       # the graphs' memory first
            self._structure[name] = key
        shapes = self._variants.setdefault(name, {})
        v = shapes.get(shape)
        if v is None:
            v = shapes[shape] = _Variant()
            self.keys.setdefault(name, []).append((key, shape))
        if not self.enabled:
            return fn()
        if not v.warm:
            v.warm = True
            return fn()
        count = self.per_shape.setdefault((name, shape), [0, 0])
        if v.graph is None:
            self._capture(v, fn)
            self.captures[name] = self.captures.get(name, 0) + 1
            count[0] += 1
        v.graph.replay()
        build.add_launches(v.counts)
        self.replays[name] = self.replays.get(name, 0) + 1
        count[1] += 1
        return v.outputs

    def _capture(self, v: _Variant, fn) -> None:
        """Capture ``fn`` into the executor's pool on the device's capture
        stream (``build.capture``: no synchronize, collection or emptied
        cache per capture)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        v.graph, v.outputs = build.capture(fn, self.device, self._pool,
                                           v.counts)
