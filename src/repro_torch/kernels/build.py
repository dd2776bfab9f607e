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
itself (:func:`capture`) and the addresses a graph is keyed on
(:func:`addresses`).
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
from typing import Dict, Iterator, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"grouped_gemm": 0, "grouped_gemm_dx": 0,
                            "grouped_gemm_dw": 0, "flash_decode": 0,
                            "flash_decode_partial": 0,
                            "paged_flash_decode": 0, "combine_weighted": 0,
                            "combine_slots": 0}

_vp, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_float = ctypes.c_float
# C entry points: pointers and the stream as void*, sizes as int; each
# returns cudaGetLastError() right after its launch
_SIGNATURES = {
    # x, w, out, group_sizes (int64), M, K, N, G, dtype, stream
    "grouped_gemm_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int,
                            _vp],
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


def capture(fn, device, pool, counts: Dict[str, int]):
    """Capture ``fn()`` into the graph memory pool ``pool`` on ``device``'s
    capture stream -> (graph, its static outputs); the launches its
    wrappers make go into ``counts`` (:func:`recording`).
    ``torch.cuda.graph`` would first synchronize, collect garbage and
    empty the allocator's cache: with a capture per shape, the eager calls
    after each capture would ``cudaMalloc`` their blocks again.  A failure
    raises: no caller runs the work eagerly in the graph's place."""
    graph, stream = torch.cuda.CUDAGraph(), capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with recording(counts), torch.cuda.stream(stream):
        graph.capture_begin(pool)
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out


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
