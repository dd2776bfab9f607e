"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` (all started together), then
the objects are linked into one shared library with a plain C interface,
loaded through ``ctypes``.  The build runs at first use — never at import,
so the package imports on machines without ``nvcc`` — into
``<checkout>/build/kernels/<hash>/``, keyed on the sources' and flags' hash
so an edited source rebuilds and an unchanged one loads at once.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per
kernel launch, nowhere else), so a run can show which kernels carried it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"grouped_gemm": 0, "flash_decode": 0,
                            "combine_weighted": 0}

_vp, _int = ctypes.c_void_p, ctypes.c_int
# C entry points: pointers and the stream as void*, sizes as int; each
# returns cudaGetLastError() right after its launch
_SIGNATURES = {
    # x, w, out, tiles(4, T), T, K, N, dtype, stream
    "grouped_gemm_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _vp],
    # q, k, v, lengths, out, B, S, KV, G, hd, dtype, stream
    "flash_decode_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                            _int, _int, _vp],
    # x, w, out, T, k, d, dtype, stream
    "combine_weighted_launch": [_vp, _vp, _vp, _int, _int, _int, _int, _vp],
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


def dtype_code(dtype) -> int:
    """The kernels' element-type switch: 0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def require(cond: bool, msg: str) -> None:
    """Wrapper-side argument check (kept under ``-O``, unlike assert)."""
    if not cond:
        raise ValueError(msg)


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
