// Group-shrink inside the kernel (paper §4.1): the group sizes are
// prefix-scanned in shared memory by each block, so the launch takes
// `group_sizes` straight from torch.bincount and no tile table is built on
// the host.  kernels/group_shrink.py::build_tile_table is the plain
// statement of the same scan.
//
// Row tile t of the live work is the (t - first_tile[g])-th tm-row slice of
// the group g whose tiles cover t; empty groups own no tile, so a walk over
// [0, num_tiles) never meets them — the paper's early stop.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kMaxGroups = 1024;

// Exclusive prefix sum across a warp.
__device__ __forceinline__ long long warp_exclusive_scan(long long v) {
  const int lane = threadIdx.x & 31;
  long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  return inc - v;
}

// Warp 0 scans the G int64 sizes (negative read as 0) into
// row_end[g] (rows of groups 0..g, clamped to M) and tile_end[g] (their tm-row
// tiles); totals = {live rows, live tiles}.  The caller syncs the block
// before reading them.
__device__ __forceinline__ void scan_groups(const long long* sizes, int G,
                                            int M, int tm,
                                            int* row_end, int* tile_end,
                                            int* totals) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (G + 31) / 32;
  const int g0 = min(G, lane * per), g1 = min(G, g0 + per);
  auto size_of = [&](int g) { return sizes[g] > 0 ? sizes[g] : 0ll; };
  long long local = 0;
  for (int g = g0; g < g1; ++g) local += size_of(g);
  long long run = warp_exclusive_scan(local);
  for (int g = g0; g < g1; ++g) {
    run += size_of(g);
    row_end[g] = static_cast<int>(run < M ? run : M);
  }
  __syncwarp();
  auto tiles_of = [&](int g) {
    const int rows = row_end[g] - (g ? row_end[g - 1] : 0);
    return (rows + tm - 1) / tm;
  };
  long long tl = 0;
  for (int g = g0; g < g1; ++g) tl += tiles_of(g);
  long long trun = warp_exclusive_scan(tl);
  for (int g = g0; g < g1; ++g) {
    trun += tiles_of(g);
    tile_end[g] = static_cast<int>(trun);
  }
  __syncwarp();
  if (lane == 0) {
    totals[0] = G ? row_end[G - 1] : 0;
    totals[1] = G ? tile_end[G - 1] : 0;
  }
}

struct RowTile {
  int g, r0, r1;   // group, rows [r0, r1) of x_sorted / out
};

// Live row tile t (< totals[1]): its group is the first whose tiles end
// past t (searchsorted right, as build_tile_table does).
__device__ __forceinline__ RowTile find_tile(int t, const int* row_end,
                                             const int* tile_end, int G,
                                             int tm) {
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tile_end[mid] > t) hi = mid; else lo = mid + 1;
  }
  const int first = lo ? tile_end[lo - 1] : 0;
  const int r0 = (lo ? row_end[lo - 1] : 0) + (t - first) * tm;
  return {lo, r0, min(r0 + tm, row_end[lo])};
}

}  // namespace repro
