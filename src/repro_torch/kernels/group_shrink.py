"""Group-shrink: active-group compaction for the grouped GEMM (paper §4.1).

Port of ``src/repro/kernels/group_shrink.py``.  The group sizes are
prefix-scanned on the device into a *tile table*: for each of the
statically bounded ``m // tm + G`` row tiles, its group, whether it is live,
and — what the CUDA kernel needs in place of the TPU's padded copy — the
range of ``x_sorted`` rows it covers.  Empty groups get no tile, so the
kernel's blocks for dead tiles return at once (the paper's early stop).

The reference's ``pad_rows_to_tiles`` / ``unpad_rows`` have no counterpart:
Pallas needs static blocks, so the TPU kernel copies rows into a
tile-aligned buffer and back; a CUDA block reads its row range straight
from ``x_sorted`` and writes straight into ``out``.

Everything stays on the device: no ``.item()``, no host sync.
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

    def packed(self) -> torch.Tensor:
        """(4, T) int32 [gid, valid, row_start, row_end] — the kernel's
        per-block metadata."""
        return torch.stack([self.tile_gid, self.tile_valid, self.row_start,
                            self.row_end]).contiguous()


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
