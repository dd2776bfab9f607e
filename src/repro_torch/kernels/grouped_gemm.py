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
same scan (the exact path of the tests).  float32 rows against bfloat16
weights (``x f32, w bf16 -> f32``: the pair ``lax.ragged_dot`` promotes to a
float32 product, where the reference's disaggregated servers and its
quickstart meet it) run the widening kernel: the bf16 kernel's walk over
(group, <= 64-row tile, 64-column tile) items, TMA filling a ring of bf16
weight tiles and the item's fp32 rows (8 rows for a decode item); each
stage's rows are split into three bf16 planes whose sum is exactly the
float (:func:`widen_planes`), so every product on ``wgmma`` is exact in
fp32, and each stage's fp32 sum is added to a running fp32 sum in a
fixed order (strides TMA cannot take load the same ring through
predicated copies); the plain version computes ``x @ w[g].float()`` in
fp32 as for any pair.

Its gradient (``csrc/grouped_gemm_bwd.cu``; the autograd Function is
:class:`repro_torch.kernels.autograd.GroupedGemm`): :func:`grouped_gemm_dx_cuda`
(``dx[i] = dy[i] @ w[g(i)]^T``, w read transposed in place) and
:func:`grouped_gemm_dw_cuda` (``dw[g] = x_g^T @ dy_g``, every group
written, zeros for an empty one, or added into a given buffer), each with
its plain version beside it.  They are the VJP of the reference's
``lax.ragged_dot`` path; no TPU kernel lies behind them.  bfloat16: both
persistent TMA + ``wgmma`` kernels like the forward (dx over (group,
128-row tile, 128 columns), dw over (group, 128 x 128 output tile) with
TMA stores; their walks are :func:`.group_shrink.dx_items` /
:func:`.group_shrink.dw_items`); float32: scalar FMAs.

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
# (rows, weights) dtype pairs of the forward kernel; the output takes the
# rows' dtype
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
         (torch.float32, torch.bfloat16))


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


def widen_planes(x: torch.Tensor) -> tuple:
    """The widening kernel's split of float32 rows
    (``csrc/grouped_gemm.cu::split3``), in plain PyTorch: three float32
    tensors of bf16 values, the float's top 8 significant bits, the next 8
    and the last 8, each cut by truncation, so that ``x1 + x2 + x3 == x``
    exactly and a plane times a bf16 weight is exact in float32 (for a
    normal float; of a subnormal one the kernel's third plane drops what
    lies below bf16's reach, < 1e-40); a non-finite value lies whole in
    ``x1``."""
    high = torch.tensor(-65536, dtype=torch.int32)          # 0xffff0000
    finite = torch.isfinite(x)
    x1 = torch.where(finite, (x.view(torch.int32) & high).view(torch.float32),
                     x)
    rest = torch.where(finite, x - x1, 0.0)
    x2 = (rest.view(torch.int32) & high).view(torch.float32)
    return x1, x2, rest - x2


def _group_masks(group_sizes: torch.Tensor, M: int, device):
    """(G, M) bool: row i lies in group g (rows past the sum in none)."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    starts = ends - group_sizes.to(torch.int64)
    rows = torch.arange(M, device=device)
    return (rows[None] >= starts[:, None]) & (rows[None] < ends[:, None])


def grouped_gemm_dx_torch(dy: torch.Tensor, w: torch.Tensor,
                          group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version of dx: ``dy (M, N) @ w[g]^T`` per group over masked
    rows, fp32 accumulation; rows past ``sum(group_sizes)`` are 0."""
    return grouped_gemm_torch(dy, w.transpose(1, 2), group_sizes)


def grouped_gemm_dw_torch(x_sorted: torch.Tensor, dy: torch.Tensor,
                          group_sizes: torch.Tensor,
                          out: torch.Tensor = None) -> torch.Tensor:
    """Plain version of dw: ``x_g^T @ dy_g`` per group (G masked products,
    fp32 accumulation, zeros for an empty group), in x's dtype; with
    ``out`` (G, K, N), ``out[g] = round(float(out[g]) + dw[g])`` in place
    for every group that holds rows."""
    masks = _group_masks(group_sizes, x_sorted.shape[0], x_sorted.device)
    G = group_sizes.shape[0]
    xf, dyf = x_sorted.float(), dy.float()
    dw = out if out is not None else torch.empty(
        (G, x_sorted.shape[1], dy.shape[1]), dtype=x_sorted.dtype,
        device=x_sorted.device)
    for g in range(G):
        acc = torch.where(masks[g][:, None], xf, 0.0).T @ dyf
        if out is None:
            dw[g] = acc.to(dw.dtype)
        elif bool(masks[g].any()):
            dw[g] = (dw[g].float() + acc).to(dw.dtype)
    return dw


def _check(name: str, a: torch.Tensor, b: torch.Tensor,
           group_sizes: torch.Tensor, G: int) -> None:
    """The wrappers' common checks: one CUDA device, one float dtype,
    contiguous 2-D operands of one row count, integer sizes of G."""
    req = build.require
    req(a.is_cuda and b.device == a.device
        and group_sizes.device == a.device,
        f"{name}: operands and group_sizes must be on one CUDA device")
    req(a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float32),
        f"{name}: dtype {a.dtype}/{b.dtype}")
    req(not group_sizes.is_floating_point() and group_sizes.dim() == 1
        and group_sizes.shape[0] == G,
        f"{name}: group_sizes must be ({G},) integers, got "
        f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    req(a.is_contiguous() and b.is_contiguous(),
        f"{name}: operands must be contiguous")
    req(1 <= G <= MAX_GROUPS, f"{name}: needs 1 <= G <= {MAX_GROUPS}")


def _require_tma(name: str, K: int, N: int, *tensors) -> None:
    """bf16 kernels load and store through TMA: 16-byte aligned bases and
    row strides (nothing falls back to another kernel)."""
    build.require(K % 8 == 0 and N % 8 == 0
                  and all(t.data_ptr() % 16 == 0 for t in tensors),
                  f"{name} bf16: K={K}, N={N} must be multiples of 8 and "
                  "the operands 16-byte aligned")


def grouped_gemm_dx_cuda(dy: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the dx kernel on the current stream (no sync): dy (M, N),
    w (G, K, N) -> dx (M, K)."""
    build.refuse_grad("grouped_gemm_dx", dy, w)
    build.require(dy.dim() == 2 and w.dim() == 3 and w.shape[2] == dy.shape[1],
                  f"grouped_gemm_dx: shapes dy{tuple(dy.shape)} "
                  f"w{tuple(w.shape)}")
    _check("grouped_gemm_dx", dy, w, group_sizes, w.shape[0])
    M, N = dy.shape
    G, K, _ = w.shape
    if dy.dtype == torch.bfloat16:
        _require_tma("grouped_gemm_dx", K, N, dy, w)
    dx = torch.empty((M, K), dtype=dy.dtype, device=dy.device)
    if M == 0:
        return dx
    sizes = group_sizes.to(torch.int64).contiguous()
    err = build.load_library().grouped_gemm_dx_launch(
        dy.data_ptr(), w.data_ptr(), dx.data_ptr(), sizes.data_ptr(), M, K,
        N, G, build.dtype_code(dy.dtype), build.stream_of(dy))
    build.check(err, "grouped_gemm_dx")
    build.count("grouped_gemm_dx")
    return dx


def grouped_gemm_dw_cuda(x_sorted: torch.Tensor, dy: torch.Tensor,
                         group_sizes: torch.Tensor,
                         out: torch.Tensor = None) -> torch.Tensor:
    """Launch the dw kernel on the current stream (no sync): x (M, K),
    dy (M, N) -> dw (G, K, N) with G = len(group_sizes); ``out`` (a
    contiguous (G, K, N) buffer of x's dtype) is added into in place."""
    build.refuse_grad("grouped_gemm_dw", x_sorted, dy)
    G = group_sizes.shape[0]
    build.require(x_sorted.dim() == 2 and dy.dim() == 2
                  and dy.shape[0] == x_sorted.shape[0],
                  f"grouped_gemm_dw: shapes x{tuple(x_sorted.shape)} "
                  f"dy{tuple(dy.shape)}")
    _check("grouped_gemm_dw", x_sorted, dy, group_sizes, G)
    M, K = x_sorted.shape
    N = dy.shape[1]
    if out is not None:
        build.require((out.shape, out.dtype, out.device)
                      == ((G, K, N), x_sorted.dtype, x_sorted.device)
                      and out.is_contiguous(),
                      f"grouped_gemm_dw: out must be a contiguous ({G}, {K}, "
                      f"{N}) {x_sorted.dtype} tensor on {x_sorted.device}")
    dw = out if out is not None else torch.empty(
        (G, K, N), dtype=x_sorted.dtype, device=x_sorted.device)
    if x_sorted.dtype == torch.bfloat16:
        _require_tma("grouped_gemm_dw", K, N, x_sorted, dy, dw)
    if M == 0:
        return dw if out is not None else dw.zero_()
    sizes = group_sizes.to(torch.int64).contiguous()
    err = build.load_library().grouped_gemm_dw_launch(
        x_sorted.data_ptr(), dy.data_ptr(), dw.data_ptr(), sizes.data_ptr(),
        M, K, N, G, int(out is not None), build.dtype_code(x_sorted.dtype),
        build.stream_of(x_sorted))
    build.check(err, "grouped_gemm_dw")
    build.count("grouped_gemm_dw")
    return dw


def grouped_gemm_cuda(x_sorted: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync)."""
    build.refuse_grad("grouped_gemm", x_sorted, w)
    req = build.require
    req(x_sorted.is_cuda and w.device == x_sorted.device
        and group_sizes.device == x_sorted.device,
        "grouped_gemm: x, w and group_sizes must be on one CUDA device")
    req(x_sorted.dim() == 2 and w.dim() == 3
        and w.shape[1] == x_sorted.shape[1] and group_sizes.dim() == 1
        and group_sizes.shape[0] == w.shape[0],
        f"grouped_gemm: shapes x{tuple(x_sorted.shape)} "
        f"w{tuple(w.shape)} sizes{tuple(group_sizes.shape)}")
    req((x_sorted.dtype, w.dtype) in PAIRS,
        f"grouped_gemm: dtype {x_sorted.dtype}/{w.dtype}; the kernel takes "
        f"{PAIRS}")
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
        _require_tma("grouped_gemm", K, N, x_sorted, w)
    out = torch.empty((M, N), dtype=x_sorted.dtype, device=x_sorted.device)
    if M == 0:
        return out
    sizes = group_sizes.to(torch.int64).contiguous()   # bincount's: no copy
    lib = build.load_library()
    err = lib.grouped_gemm_launch(
        x_sorted.data_ptr(), w.data_ptr(), out.data_ptr(), sizes.data_ptr(),
        M, K, N, G, build.dtype_code(x_sorted.dtype),
        build.dtype_code(w.dtype), build.stream_of(x_sorted))
    build.check(err, "grouped_gemm")
    # the widening route (float32 rows, bf16 weights) counts on its own
    build.count("grouped_gemm_f32_bf16" if x_sorted.dtype != w.dtype
                else "grouped_gemm")
    return out
