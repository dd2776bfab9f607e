"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` (all started together), then
the objects are linked into one shared library with a plain C interface,
loaded through ``ctypes``.  The build runs at first use — never at import,
so the package imports on machines without ``nvcc`` — into
``<checkout>/build/kernels/<hash>/``, keyed on the sources' and flags' hash
so an edited source rebuilds and an unchanged one loads at once.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per
kernel launch, nowhere else), so a run can show which kernels carried it.
A CUDA graph's replay passes through no wrapper: :func:`recording` takes
the counts of its capture, and :func:`add_launches` adds them at each
replay, so :data:`LAUNCHES` stays the number of kernels the device ran.

What every CUDA graph of the port shares lives here too, below the models
and the serving layer that capture them: the process-wide switch
:func:`eager` (the counterpart of ``jax.disable_jit()``; the executor's
step graphs, the train step's graph and the models' scan bodies read
it), the capture stream of a device (:func:`capture_stream`), the capture
itself (:func:`capture`), the addresses a graph is keyed on
(:func:`addresses`), the rule that decides whether a compiled step is
graphed (:func:`decide`: from the device, the backends of its process
groups and the switch, before any work) and :class:`CompiledFn`, one
function compiled as one graph (quickstart's layer programs, the train
step, the dry-run's mesh cells) with :class:`CompiledPerShape`, one such
graph per input shape.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"grouped_gemm": 0, "grouped_gemm_f32_bf16": 0,
                            "grouped_gemm_dx": 0, "grouped_gemm_dw": 0,
                            "flash_decode": 0, "flash_decode_partial": 0,
                            "paged_flash_decode": 0, "combine_weighted": 0,
                            "combine_slots": 0, "sample": 0}

_vp, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_float = ctypes.c_float
# C entry points: pointers and the stream as void*, sizes as int; each
# returns cudaGetLastError() right after its launch
_SIGNATURES = {
    # x, w, out, group_sizes (int64), M, K, N, G, dtype, w dtype, stream
    "grouped_gemm_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
                            _int, _vp],
    # dy, w, dx, group_sizes (int64), M, K, N, G, dtype, stream
    "grouped_gemm_dx_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                               _int, _vp],
    # x, dy, dw, group_sizes (int64), M, K, N, G, accumulate, dtype, stream
    "grouped_gemm_dw_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                               _int, _int, _vp],
    # q, k, v, lengths, out, partial, B, S, KV, G, hd, softcap, dtype,
    # stream
    "flash_decode_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                            _int, _int, _float, _int, _vp],
    # q, k, v, lengths, acc, m, l, partial, B, S, KV, G, hd, softcap,
    # dtype, stream
    "flash_decode_partial_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                    _int, _int, _int, _int, _int, _float,
                                    _int, _vp],
    # q, k_pool, v_pool, tables, lengths, out, partial, B, max_blocks, bs,
    # KV, G, hd, softcap, dtype, stream
    "paged_flash_decode_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _int,
                                  _int, _int, _int, _int, _int, _float, _int,
                                  _vp],
    # x, w, out, T, k, d, dtype, stream
    "combine_weighted_launch": [_vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # bases (host array of S pointers), S, rows per base, slots (int64),
    # addend (or null), out, T, k, d, dtype, stream
    "combine_slots_launch": [ctypes.POINTER(_vp), _int, _i64, _vp, _vp, _vp,
                             _int, _int, _int, _int, _vp],
    # logits, row stride, temperatures, keys (int64), steps (int64), out,
    # partial values, partial indices, counters, B, V, splits, stream
    "sample_launch": [_vp, _i64, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _int,
                      _int, _int, _vp],
    # out: the blocks of the sampler the current device holds at once
    "sample_slots": [ctypes.POINTER(_int)],
    # keys (int64), steps (int64), bits, uniforms, noise, B, V, stream
    "sample_probe_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int, _vp],
    # stream
    "empty_launch": [_vp],
}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under $CUDA_HOME)")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"libkernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}")
    lib = out_dir / "libkernels.so"
    os.replace(tmp, lib)                  # atomic against a parallel build
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(logs))
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if needed."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libkernels.so"
    build_info.update(sources=[str(p) for p in sources()], built=False,
                      seconds=0.0)
    if not lib_path.exists():
        lib_path = _build(out_dir)
        build_info["built"] = True
    build_info["path"] = str(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def count(name: str) -> None:
    LAUNCHES[name] += 1


@contextlib.contextmanager
def recording(counts: Dict[str, int]):
    """Count the launches made inside the block into ``counts``, not into
    :data:`LAUNCHES`: a CUDA graph's capture, whose kernels run only when
    it is replayed (:func:`add_launches`)."""
    before = dict(LAUNCHES)
    try:
        yield counts
    finally:
        counts.update({k: LAUNCHES[k] - before[k] for k in before})
        LAUNCHES.update(before)


def add_launches(counts: Dict[str, int]) -> None:
    """One replay of a captured graph: its kernels' launches."""
    for k, n in counts.items():
        LAUNCHES[k] += n


# process-wide, as jax.disable_jit() is: set only through eager()
EAGER = [False]


@contextlib.contextmanager
def eager():
    """Run every CUDA graph's work eagerly inside the block (the
    reference's ``jax.disable_jit()``): the executor's step variants and
    the models' scan bodies, over the same staging, with no graph.  Graphs
    are the default on the card."""
    prev = EAGER[0]
    EAGER[0] = True
    try:
        yield
    finally:
        EAGER[0] = prev


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The stream every capture on ``device`` runs on.  Made at the first
    capture, with a few small matmuls of each dtype run on it first, so
    that cuBLAS sets itself up for the stream (its workspace is per
    stream) outside any capture, as a warm-up on a side stream does."""
    device = torch.device(device)
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            for dt in (torch.float32, torch.bfloat16):
                a = torch.ones(16, 16, dtype=dt, device=device)
                torch.addmm(a, a, a)
                torch.bmm(a[None], a[None])
        stream.synchronize()
        _CAPTURE_STREAMS[device] = stream
    return stream


def capture(fn, device, pool, counts: Dict[str, int],
            collectives: bool = False):
    """Capture ``fn()`` into the graph memory pool ``pool`` on ``device``'s
    capture stream -> (graph, its static outputs); the launches its
    wrappers make go into ``counts`` (:func:`recording`).
    ``torch.cuda.graph`` would first synchronize, collect garbage and
    empty the allocator's cache: with a capture per shape, the eager calls
    after each capture would ``cudaMalloc`` their blocks again.  A failure
    raises: no caller runs the work eagerly in the graph's place.

    ``collectives``: ``fn`` calls NCCL collectives.  c10d's watchdog
    thread polls the events of earlier collectives while such a step may
    be capturing; under the default ``global`` capture mode an unsafe
    call from another thread invalidates a capture, so these captures use
    ``thread_local``, which refuses only this thread's.  Every other
    capture keeps the default."""
    graph, stream = torch.cuda.CUDAGraph(), capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with recording(counts), torch.cuda.stream(stream):
        if collectives:
            graph.capture_begin(pool, capture_error_mode="thread_local")
        else:
            graph.capture_begin(pool)
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out


class GraphDecision(NamedTuple):
    """Whether a compiled step runs as a CUDA graph, and why."""
    graphed: bool
    reason: str


# the process-group backends whose collectives a CUDA graph can hold
CAPTURABLE_BACKENDS = ("nccl",)


def group_backends(groups) -> Tuple[str, ...]:
    """The backend of each process group (``nccl``, ``gloo``, ``fake``)."""
    if not groups:
        return ()
    import torch.distributed as dist
    return tuple(str(dist.get_backend(g)) for g in groups)


def decide(device, backends=(), eager_reason: Optional[str] = None
           ) -> GraphDecision:
    """Graphed or eager, decided before any work: graphed on a ``cuda``
    device when every process group the step's collectives use
    (``backends``) is NCCL's, outside :func:`eager` and unless the step
    stays eager by its own rule (``eager_reason``); eager on the CPU, on
    ``meta`` (the accounting) and where a group is gloo's or the fake
    world's, whose collectives a graph cannot hold.  The reason lists
    every rule that holds.  Never revised after a failure: a capture or
    replay that fails raises."""
    device = torch.device(device)
    why = []
    if device.type != "cuda":
        why.append(f"on {device.type}")
    if EAGER[0]:
        why.append("under eager()")
    other = sorted({b for b in backends if b not in CAPTURABLE_BACKENDS})
    if other:
        why.append(f"{'/'.join(other)} collectives cannot be captured in a "
                   "CUDA graph")
    if eager_reason:
        why.append(eager_reason)
    if why:
        return GraphDecision(False, "eager: " + "; ".join(why))
    return GraphDecision(True, "graphed: on cuda, collectives on NCCL"
                         if backends else "graphed: on cuda")


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
    tensors, written back as a donated argument is; the port's decode
    steps write theirs in place)."""
    for a, b in zip(tensors(old), tensors(new)):
        if a is not b:
            a.copy_(b)


def _clone(tree):
    """The tensor leaves of ``tree`` cloned (tuples, named tuples, dicts,
    dataclasses: a cache)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


class CompiledFn:
    """``jax.jit`` of ``fn(held, *data)``: on the card, one CUDA graph,
    captured once under a key and replayed.

    ``held`` (the weights, a train state) is read where it lies: the
    addresses of its tensors are part of the key.  Each ``data`` argument
    (a tensor or a dict of tensors: the inputs, the runtime's tables, a
    batch, as a jit's arguments) is copied into static buffers of its
    position (and key); a buffer is reallocated only when its shape or
    dtype changes, which changes the key.  So rewriting a liveness mask,
    a mapping or a batch between calls replays the same graph, as the
    reference's jitted function takes them as arguments and does not
    recompile.  A new key drops the old graph and its pool.

    The first call under a key runs ``fn`` eagerly (cuBLAS, the autograd
    engine and the kernels' library set themselves up outside any
    capture).  A pure ``fn`` (:attr:`PURE`) is then captured in the same
    call; a step that writes ``held`` in place (a subclass with ``PURE =
    False``) returns that eager call's result, and its second call
    captures.  The capture runs into a pool of its own after the
    allocator's cache is emptied, so the eager call's cached blocks and
    the graph's pool need not fit the card together.  A call that
    replays returns :meth:`_result`: here clones of the graph's static
    outputs, so a result outlives the next replay, as a jitted
    function's does.

    ``groups`` are the process groups whose collectives ``fn`` calls (a
    mesh step's: ``mesh_axes.mesh_groups``).  Whether a call is graphed
    is :attr:`decision` (:func:`decide`), taken before any work from the
    device, the groups' backends, the :func:`eager` switch and
    ``eager_reason`` (a step that stays eager by its own rule): on NCCL
    the collectives are captured with the step, and the NCCL
    communicators exist by then, made by the first, eager call.

    ``captures`` counts captures (a capturing call replays its new graph
    once), ``replays`` the calls that replayed a graph captured earlier,
    ``counts`` the kernel launches of one replay (added to
    :data:`LAUNCHES` at each), ``collectives`` the ``c10d`` calls the
    last capture holds and ``pool_bytes`` what the last capture added to
    the reserved memory.  Where the decision is eager the staged call
    runs eagerly; a failure to capture or replay raises: nothing runs
    ``fn`` eagerly in the graph's place."""

    PURE = True

    def __init__(self, fn, device, groups=(), eager_reason=None):
        self.fn = fn
        self.device = torch.device(device)
        self.groups = tuple(groups)
        self.eager_reason = eager_reason
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0
        self.collectives = 0
        self.counts: Dict[str, int] = {}
        self._data: Dict = {}
        self._key: Optional[tuple] = None
        self._warm = False
        self._graph = None
        self._outputs = None

    @property
    def decision(self) -> GraphDecision:
        return decide(self.device, group_backends(self.groups),
                      self.eager_reason)

    @property
    def enabled(self) -> bool:
        return self.decision.graphed

    def _buffer(self, name, v) -> torch.Tensor:
        v = torch.as_tensor(v)
        buf = self._data.get(name)
        if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
            buf = self._data[name] = torch.empty(v.shape, dtype=v.dtype,
                                                 device=self.device)
        return buf.copy_(v)

    def _stage(self, data) -> list:
        return [{k: self._buffer((i, k), t) for k, t in v.items()}
                if isinstance(v, dict) else self._buffer(i, v)
                for i, v in enumerate(data)]

    def _run(self, held, staged):
        """One eager call over the staged data."""
        return self.fn(held, *staged)

    def _captured(self, held, staged):
        """What the graph computes: its outputs are the static ones."""
        return self._run(held, staged)

    def _result(self, held):
        """A replaying call's result."""
        return _clone(self._outputs)

    def __call__(self, held, *data):
        staged = self._stage(data)
        if not self.enabled:
            return self._run(held, staged)
        key = addresses(held, staged)
        if key != self._key:
            self._key, self._warm = key, False
            self._graph = self._outputs = None
        if not self._warm:
            self._warm = True
            out = self._run(held, staged)
            if not self.PURE:
                return out
        if self._graph is None:
            self._capture(held, staged)
        else:
            self.replays += 1
        self._graph.replay()
        add_launches(self.counts)
        return self._result(held)

    def _capture(self, held, staged) -> None:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        self.counts = {}
        tally = _C10dCalls() if self.groups else contextlib.nullcontext()
        with tally:
            self._graph, self._outputs = capture(
                lambda: self._captured(held, staged), self.device,
                torch.cuda.graph_pool_handle(), self.counts,
                collectives=bool(self.groups))
        self.collectives = getattr(tally, "n", 0)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.captures += 1


def _C10dCalls():
    """A dispatch mode counting the ``c10d`` ops (collectives) issued
    inside it, on every thread that inherits it (autograd's included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "c10d":
                self.n += 1
            return func(*args, **(kwargs or {}))
    return Count()


class CompiledPerShape:
    """``jax.jit``'s cache of one executable per input shape: a
    :class:`CompiledFn` of ``fn`` per shape and dtype of the data
    arguments, side by side, so another prompt length captures once more
    and leaves the other lengths' graphs alone.  ``per_shape[shape]`` is
    that shape's :class:`CompiledFn`; ``captures``, ``replays`` and
    ``pool_bytes`` sum over them."""

    def __init__(self, fn, device, groups=(), eager_reason=None):
        self.fn = fn
        self.device = torch.device(device)
        self.groups = tuple(groups)
        self.eager_reason = eager_reason
        self.per_shape: Dict[tuple, CompiledFn] = {}

    @property
    def decision(self) -> GraphDecision:
        return decide(self.device, group_backends(self.groups),
                      self.eager_reason)

    def __call__(self, held, *data):
        shape = tuple((tuple(t.shape), t.dtype) for t in tensors(data))
        fn = self.per_shape.get(shape)
        if fn is None:
            fn = self.per_shape[shape] = CompiledFn(
                self.fn, self.device, self.groups, self.eager_reason)
        return fn(held, *data)

    def _sum(self, name: str) -> int:
        return sum(getattr(f, name) for f in self.per_shape.values())

    captures = property(lambda self: self._sum("captures"))
    replays = property(lambda self: self._sum("replays"))
    pool_bytes = property(lambda self: self._sum("pool_bytes"))
    collectives = property(lambda self: max(
        [f.collectives for f in self.per_shape.values()], default=0))


def dtype_code(dtype) -> int:
    """The kernels' element-type switch: 0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def refuse_grad(name: str, *tensors) -> None:
    """A raw CUDA wrapper returns a tensor without a ``grad_fn``: called
    where autograd would record it, it raises rather than drop the
    gradient (``ops`` routes such calls through the autograd Functions)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the raw CUDA wrapper records no gradient; an input "
            "requires grad — call it through repro_torch.kernels.ops (or "
            "under torch.no_grad())")


def require(cond: bool, msg: str) -> None:
    """Wrapper-side argument check (kept under ``-O``, unlike assert)."""
    if not cond:
        raise ValueError(msg)


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
