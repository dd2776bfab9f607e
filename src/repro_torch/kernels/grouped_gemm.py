"""Grouped GEMM with group-shrink: the expert server's kernel (paper §4.1).

``out[i] = x_sorted[i] @ w[g(i)]`` for rows sorted by group, fp32
accumulation, output in x's dtype; rows past ``sum(group_sizes)`` are 0.

Replaces ``src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas`` (with
``group_shrink.build_tile_table`` / ``pad_rows_to_tiles`` / ``unpad_rows``).

CUDA kernel (``csrc/grouped_gemm.cu``), one launch per call: the kernel
takes ``group_sizes`` as it comes from ``torch.bincount`` and prefix-scans
it in shared memory (``csrc/group_shrink.cuh``; :mod:`.group_shrink` keeps
the same scan as plain PyTorch), writes the rows past ``sum(group_sizes)``
as zeros itself, and the wrapper allocates the output with ``torch.empty``.
bfloat16: a persistent kernel — one CTA per SM walks the live work items
(group, 64-row tile, 64-column tile) in a fixed order; TMA fills an 8-stage
ring of weight and token tiles under mbarriers; one warpgroup runs
``wgmma`` with the weight tile as the M side and the item's tokens (8-64)
as the N side (swap-AB).  float32: scalar FMAs over 32x32 tiles with the
same scan (the exact path of the tests).

What bounds it on an H100: bytes.  At decode ~16 live rows touch ~15
experts and the kernel reads each live expert's weights once (3.35 TB/s);
at prefill ~16 rows per group still leave it bytes-bound.  Dead groups
cost no weight bytes (the early stop), and no tensor-core rows or shared
memory are spent on padding a 1-2 row decode item to 64.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_GROUPS = 1024        # the kernel's shared-memory scan (csrc kMaxGroups)


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
    req(x_sorted.dtype == w.dtype
        and x_sorted.dtype in (torch.bfloat16, torch.float32),
        f"grouped_gemm: dtype {x_sorted.dtype}/{w.dtype}")
    req(not group_sizes.is_floating_point(),
        f"grouped_gemm: group_sizes must be integers, got "
        f"{group_sizes.dtype}")
    req(x_sorted.is_contiguous() and w.is_contiguous(),
        "grouped_gemm: x and w must be contiguous")
    M, K = x_sorted.shape
    G, _, N = w.shape
    req(1 <= G <= MAX_GROUPS and K >= 1 and N >= 1,
        f"grouped_gemm: needs 1 <= G <= {MAX_GROUPS}, K, N >= 1 "
        f"(G={G}, K={K}, N={N})")
    if x_sorted.dtype == torch.bfloat16:
        # TMA: 16-byte aligned bases and row strides
        req(K % 8 == 0 and N % 8 == 0 and x_sorted.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0,
            f"grouped_gemm bf16: K={K}, N={N} must be multiples of 8 and "
            "x, w 16-byte aligned")
    out = torch.empty((M, N), dtype=x_sorted.dtype, device=x_sorted.device)
    if M == 0:
        return out
    sizes = group_sizes.to(torch.int64).contiguous()   # bincount's: no copy
    lib = build.load_library()
    err = lib.grouped_gemm_launch(
        x_sorted.data_ptr(), w.data_ptr(), out.data_ptr(), sizes.data_ptr(),
        M, K, N, G, build.dtype_code(x_sorted.dtype),
        build.stream_of(x_sorted))
    build.check(err, "grouped_gemm")
    build.count("grouped_gemm")
    return out
