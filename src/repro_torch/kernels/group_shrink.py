"""Group-shrink: active-group compaction for the grouped GEMM (paper §4.1).

Port of ``src/repro/kernels/group_shrink.py``, as plain PyTorch: the
statement of the scan that the CUDA kernel runs itself in shared memory
(``csrc/group_shrink.cuh``).  The group sizes are prefix-scanned into a
*tile table*: for each of the statically bounded ``m // tm + G`` row
tiles, its group, whether it is live, and the range of ``x_sorted`` rows it
covers.  Empty groups get no tile, so the kernel's walk over the live
tiles never meets them (the paper's early stop).  The kernel computes a
tile's entry on demand (``find_tile``: a binary search over the tile
prefix, ``searchsorted`` here) instead of materialising the table.

The reference's ``pad_rows_to_tiles`` / ``unpad_rows`` have no counterpart:
Pallas needs static blocks, so the TPU kernel copies rows into a
tile-aligned buffer and back; the CUDA kernel reads a tile's row range
straight from ``x_sorted`` and writes straight into ``out``.

Everything stays on the device: no ``.item()``, no host sync.

:func:`dx_items` and :func:`dw_items` state the grouped GEMM's backward
kernels' walks over the same scan (``csrc/grouped_gemm_bwd.cu``): which
(group, row range, output tile) each work item covers, in the order the
persistent CTAs stride over them (``tests/test_torch_bwd_tiles.py``
checks their coverage and a tiled emulation that follows them);
:func:`widen_items` states the widening route's walk (float32 rows against
bf16 weights, ``csrc/grouped_gemm.cu``; ``tests/test_torch_widen_tiles.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TileTable(NamedTuple):
    tile_gid: torch.Tensor       # (T,) int32 group per row tile (0 if dead)
    tile_valid: torch.Tensor     # (T,) int32 1 = live tile
    padded_offset: torch.Tensor  # (G,) int32 first tile-aligned row per group
    num_tiles: torch.Tensor      # () int32 live tile count
    row_start: torch.Tensor      # (T,) int32 first x_sorted row of the tile
    row_end: torch.Tensor        # (T,) int32 one past its last row


def max_tiles(m: int, g: int, tm: int) -> int:
    """Static bound on live row tiles: every group wastes < 1 tile."""
    return m // tm + g


def build_tile_table(group_sizes: torch.Tensor, m: int, tm: int) -> TileTable:
    """group_sizes: (G,) int, sum <= m.  O(G + T) device-side scans."""
    G = group_sizes.shape[0]
    T = max_tiles(m, G, tm)
    dev = group_sizes.device
    sizes = group_sizes.to(torch.int32)
    tiles_per = (sizes + tm - 1) // tm                       # 0 for empty
    tile_end = torch.cumsum(tiles_per, 0, dtype=torch.int32)  # inclusive
    first_tile = tile_end - tiles_per
    num_tiles = tile_end[-1]
    t = torch.arange(T, device=dev, dtype=torch.int32)
    valid = t < num_tiles
    # the group of tile t is the number of groups whose tiles end at or
    # before t (empty groups end where they start, so they are skipped)
    gid = torch.searchsorted(tile_end, t, right=True, out_int32=True)
    gid = torch.where(valid, gid, 0)
    row_end_g = torch.cumsum(sizes, 0, dtype=torch.int32)
    row_start_g = row_end_g - sizes
    start = row_start_g[gid] + (t - first_tile[gid]) * tm
    end = torch.minimum(start + tm, row_end_g[gid])
    zero = torch.zeros_like(t)
    return TileTable(
        tile_gid=gid, tile_valid=valid.to(torch.int32),
        padded_offset=first_tile * tm, num_tiles=num_tiles,
        row_start=torch.where(valid, start, zero),
        row_end=torch.where(valid, end, zero))


# ---- the backward kernels' walks (csrc/grouped_gemm_bwd.cu, bf16) ----------

DX_ROWS, DX_COLS = 128, 128     # dx item: up to 128 rows x 128 dx columns
DW_ROWS, DW_COLS = 128, 128     # dw item: 128 dw rows (K) x 128 columns (N)
DW_STAGE = 64                   # group rows a dw stage reduces over


def dx_items(group_sizes: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """The dx kernel's walk: one row per item, in the order a CTA strides
    over them, of (group, r0, r1, k0).  Items are the live 128-row tiles
    of :func:`build_tile_table` (an empty group owns none) times the
    ``ceil(k / 128)`` column tiles, column tile fastest.  The kernel loads
    dy rows ``[r0, r0 + 128)`` and stores only ``[r0, r1)``; rows past the
    sum lie in no item and are zeroed apart."""
    tt = build_tile_table(group_sizes, m, DX_ROWS)
    live = tt.tile_valid.bool()
    tiles = torch.stack([tt.tile_gid, tt.row_start, tt.row_end], 1)[live]
    nkt = -(-k // DX_COLS)
    k0 = torch.arange(nkt, dtype=torch.int64) * DX_COLS
    t = tiles.to(torch.int64).repeat_interleave(nkt, 0)
    return torch.cat([t, k0.repeat(tiles.shape[0])[:, None]], 1)


def dw_items(group_sizes: torch.Tensor, m: int, k: int, n: int,
             accumulate: bool) -> torch.Tensor:
    """The dw kernel's walk: rows of (group, r0, r1, k0, n0), N tile
    fastest, then K tile, then group.  Without ``accumulate`` every group
    is walked (an empty one, r0 == r1, is written as zeros); with it only
    the live ones (the scan at tm = m: one tile per live group), so an
    empty group's gradient is left as it is.  Each item reduces over its
    group's rows in :data:`DW_STAGE`-row stages; a stage's rows past r1
    are zeroed in the x box before the product."""
    end = torch.cumsum(group_sizes.to(torch.int64), 0).clamp(max=m)
    start = torch.cat([end.new_zeros(1), end[:-1]])
    g = torch.arange(group_sizes.shape[0], dtype=torch.int64)
    if accumulate:
        g = g[end > start]
    nkt, nnt = -(-k // DW_ROWS), -(-n // DW_COLS)
    per = nkt * nnt
    gi = g.repeat_interleave(per)
    rem = torch.arange(per, dtype=torch.int64).repeat(g.shape[0])
    return torch.stack([gi, start[gi], end[gi], (rem // nnt) * DW_ROWS,
                        (rem % nnt) * DW_COLS], 1)


# ---- the widening route's walk (csrc/grouped_gemm.cu, fp32 x bf16) ---------

WIDEN_ROWS, WIDEN_COLS, WIDEN_K = 64, 64, 64   # item rows, columns; K a stage


def widen_items(group_sizes: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The widening kernel's walk: one row per item, in the order a CTA
    strides over them, of (group, r0, r1, n0).  Items are the live 64-row
    tiles of :func:`build_tile_table` times the ``ceil(n / 64)`` column
    tiles, the column tile fastest, so that the CTAs of a wave share a few
    row tiles' rows and a group's row tiles read its weights side by side.
    The kernel loads 8, 16, 32 or 64 rows from
    ``r0``, as many as ``r1 - r0`` needs, and stores only ``[r0, r1)``;
    rows past the sum lie in no item and are zeroed apart."""
    tt = build_tile_table(group_sizes, m, WIDEN_ROWS)
    live = tt.tile_valid.bool()
    tiles = torch.stack([tt.tile_gid, tt.row_start, tt.row_end],
                        1)[live].to(torch.int64)
    nct = -(-n // WIDEN_COLS)
    n0 = torch.arange(nct, dtype=torch.int64).repeat(
        tiles.shape[0]) * WIDEN_COLS
    return torch.cat([tiles.repeat_interleave(nct, 0), n0[:, None]], 1)
