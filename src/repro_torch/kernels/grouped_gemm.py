"""Grouped GEMM with group-shrink: the expert server's kernel (paper §4.1).

``out[i] = x_sorted[i] @ w[g(i)]`` for rows sorted by group, fp32
accumulation, output in x's dtype; rows past ``sum(group_sizes)`` are 0.

Replaces ``src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas`` (with
``group_shrink.build_tile_table`` / ``pad_rows_to_tiles`` / ``unpad_rows``).

CUDA kernel (``csrc/grouped_gemm.cu``): grid = (``M // tm + G`` row tiles)
x (``N / 64`` column tiles).  Each block reads its tile's group, liveness
and row range from the device-side tile table and returns at once when the
tile is dead, so empty experts cost one metadata read and no weight bytes.
A loop over K (the TPU's sequential K grid axis) stages x and w tiles in
shared memory and accumulates in fp32 — with WMMA tensor-core fragments
for bfloat16, scalar FMAs for float32.

What bounds it on an H100: at decode a server's ~16 live routings touch
~16 experts, so the kernel is bound by the weight bytes of the live groups
(3.35 TB/s); the early stop is what keeps it from streaming all 66 experts'
weights.  At prefill (~1000 rows per server) it is bound by tensor-core
operations.  This first version stages one tile at a time with a register
prefetch of the next; TMA, ``wgmma`` and a persistent schedule are later
work.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import group_shrink as gs

TM = {torch.bfloat16: 64, torch.float32: 32}   # row tile of each kernel


def grouped_gemm_torch(x_sorted: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version: G masked dense products, fp32 accumulation."""
    M = x_sorted.shape[0]
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    starts = ends - group_sizes.to(torch.int64)
    rows = torch.arange(M, device=x_sorted.device)
    xf = x_sorted.float()
    out = torch.zeros((M, w.shape[2]), dtype=torch.float32,
                      device=x_sorted.device)
    for g in range(w.shape[0]):
        mask = ((rows >= starts[g]) & (rows < ends[g]))[:, None]
        out += torch.where(mask, xf, 0.0) @ w[g].float()
    return out.to(x_sorted.dtype)


def grouped_gemm_cuda(x_sorted: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync)."""
    req = build.require
    req(x_sorted.is_cuda and w.device == x_sorted.device
        and group_sizes.device == x_sorted.device,
        "grouped_gemm: x, w and group_sizes must be on one CUDA device")
    req(x_sorted.dim() == 2 and w.dim() == 3
        and w.shape[1] == x_sorted.shape[1] and group_sizes.dim() == 1
        and group_sizes.shape[0] == w.shape[0],
        f"grouped_gemm: shapes x{tuple(x_sorted.shape)} "
        f"w{tuple(w.shape)} sizes{tuple(group_sizes.shape)}")
    req(x_sorted.dtype == w.dtype and x_sorted.dtype in TM,
        f"grouped_gemm: dtype {x_sorted.dtype}/{w.dtype}")
    req(x_sorted.is_contiguous() and w.is_contiguous(),
        "grouped_gemm: x and w must be contiguous")
    M, K = x_sorted.shape
    G, _, N = w.shape
    if x_sorted.dtype == torch.bfloat16:
        # 16-byte vector loads of 8 elements
        req(K % 8 == 0 and N % 8 == 0 and x_sorted.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0,
            f"grouped_gemm bf16: K={K}, N={N} must be multiples of 8 and "
            "x, w 16-byte aligned")
    table = gs.build_tile_table(group_sizes, M, TM[x_sorted.dtype])
    tiles = table.packed()
    out = torch.zeros((M, N), dtype=x_sorted.dtype, device=x_sorted.device)
    lib = build.load_library()
    err = lib.grouped_gemm_launch(
        x_sorted.data_ptr(), w.data_ptr(), out.data_ptr(), tiles.data_ptr(),
        tiles.shape[1], K, N, build.dtype_code(x_sorted.dtype),
        build.stream_of(x_sorted))
    build.check(err, "grouped_gemm")
    build.count("grouped_gemm")
    return out
