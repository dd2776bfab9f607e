"""The executor's step variants as CUDA graphs: the counterpart of the
reference's compiled step functions (``Executor._build_jits``,
``src/repro/serving/executor.py``).

The reference compiles each step variant once and passes what changes
between steps as jit *arguments*: the tokens, the expert->server mapping,
the liveness mask, the local table, the router bias, the replica weights,
the paged block tables and lengths.  Failover, rebalancing, page-out and
admission then never recompile; a pool resize does (``num_servers`` and
``capacity`` are static).

Here each decode variant is captured once as a ``torch.cuda.CUDAGraph``
and replayed:

* :class:`StaticInputs` — the persistent device buffers that take the
  place of the jit arguments.  The executor writes each step's host
  arrays into them with ``copy_`` (only the ones that changed), so the
  captured kernels read the new data at the addresses they were captured
  with.
* :class:`StepGraphs` — per variant: its key (what the reference bakes in
  as static: the variant and mode, ``num_servers`` and ``capacity``, which
  optional inputs are present, the dispatch method, and the addresses of
  every tensor the step reads or writes: the static inputs, the weights
  and the cache), the captured graph, its static outputs and the kernel
  launches it makes.  A new key drops the graph; the next call runs the
  step eagerly (the real step: a warm-up would advance the cache), the
  call after captures it and replays it.  One graph memory pool serves
  every variant of one executor.

A resize reallocates the expert weights, so the key sees new addresses and
the variant is captured again; an in-place migration chunk or page-out
keeps them, and keeps the graph.  A failure to capture or replay raises:
nothing runs the step eagerly in a graph's place.

On the CPU (``device="cpu"``) and under :func:`eager` (the counterpart of
``jax.disable_jit()``) the same staging runs the step eagerly over the
static buffers.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.kernels import build

# process-wide, as jax.disable_jit() is: set only through eager()
_EAGER = [False]


@contextlib.contextmanager
def eager():
    """Run every executor's decode variants eagerly inside the block (the
    reference's ``jax.disable_jit()``): the same staging, no graph.  Graphs
    are the default on the card."""
    prev = _EAGER[0]
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = prev


def tensors(tree) -> Iterator[torch.Tensor]:
    """The tensor leaves of dicts, tuples, named tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from tensors(getattr(tree, f.name))


def addresses(*trees) -> tuple:
    """(data_ptr, shape, dtype) of every tensor leaf: what a captured graph
    reads and writes at fixed addresses."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for tree in trees for t in tensors(tree))


def adopt(old, new) -> None:
    """Copy each leaf of ``new`` that is not its counterpart in ``old`` into
    it, so ``old`` keeps its storage (a step that returns fresh state
    tensors; the port's decode steps write theirs in place)."""
    for a, b in zip(tensors(old), tensors(new)):
        if a is not b:
            a.copy_(b)


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
    key: tuple
    warm: bool = False
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: object = None
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class StepGraphs:
    """The captured decode variants of one executor.

    ``keys[name]`` lists every key variant ``name`` has had, in order (one
    per structure it ran under); ``captures[name]`` counts its captures and
    ``replays[name]`` its replays (both 0 off the card and under
    :func:`eager`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._variants: Dict[str, _Variant] = {}
        self.keys: Dict[str, List[tuple]] = {}
        self.captures: Dict[str, int] = {}
        self.replays: Dict[str, int] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def enabled(self) -> bool:
        return self.device.type == "cuda" and not _EAGER[0]

    def reset(self) -> None:
        """Drop every graph (a pool resize): each variant is captured again
        under its new key."""
        self._variants.clear()

    def run(self, name: str, key: tuple, fn: Callable[[], object]):
        """Run step variant ``name`` under ``key``: ``fn()`` reads only the
        static inputs, the weights and the cache (their addresses are in
        ``key``).  Returns its outputs; a replay's are the graph's static
        outputs, overwritten by the next replay of ``name``."""
        v = self._variants.get(name)
        if v is None or v.key != key:
            self._variants.pop(name, None)         # its graph's memory first
            v = self._variants[name] = _Variant(key)
            self.keys.setdefault(name, []).append(key)
        if not self.enabled:
            return fn()
        if not v.warm:
            v.warm = True
            return self._on_capture_stream(fn)
        if v.graph is None:
            self._capture(name, v, fn)
        v.graph.replay()
        build.add_launches(v.counts)
        self.replays[name] = self.replays.get(name, 0) + 1
        return v.outputs

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _on_capture_stream(self, fn):
        """The first call under a key: the real step, eager, on the stream
        the capture will use (so the lazy setup of cuBLAS and of the
        kernels happens outside the capture), joined both ways to the
        caller's stream."""
        side = self._capture_stream()
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        for t in tensors(out):
            t.record_stream(main)
        return out

    def _capture(self, name: str, v: _Variant, fn) -> None:
        graph, stream = torch.cuda.CUDAGraph(), self._capture_stream()
        with build.recording(v.counts):
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                v.outputs = fn()
        v.graph = graph
        self.captures[name] = self.captures.get(name, 0) + 1
