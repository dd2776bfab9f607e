// Grouped GEMM with group-shrink: out[i] = x[i] @ w[g(i)] (paper §4.1).
//
// Replaces src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas and the
// tile table and padded copy around it (group_shrink.build_tile_table /
// pad_rows_to_tiles / unpad_rows).  x (M, K) rows sorted by group; w (G, K,
// N); group_sizes (G,) int64, straight from torch.bincount; out
// (M, N), rows past sum(group_sizes) written as 0 here, so the caller
// allocates it with torch.empty and a call is exactly one launch.
//
// What bounds it on an H100: bytes.  At decode a server's ~16 live rows
// touch ~15 experts, and each live expert's weights (K x N bf16) are read
// once: 0.133 ms at 3.35 TB/s for gate/up at deepseek-r1 widths.  At
// prefill ~16 rows per group still leave it below the 295 operations a
// byte at which the tensor cores would bind.  So the design keeps the
// weight stream at full rate and spends nothing on padding:
//   - group-shrink in the kernel: each CTA prefix-scans the sizes in shared
//     memory (group_shrink.cuh) and walks only live work items
//     (group, 64-row tile, 64-column tile); dead groups cost nothing;
//   - persistent: one CTA per SM walks the items in a fixed stride, each
//     output tile written by exactly one CTA, no split-K, no atomics, so
//     the output is bitwise repeatable;
//   - a ring of kStages weight tiles (64 columns x 64 K, 8 KB) and token
//     tiles in shared memory, filled by TMA under mbarriers from one
//     producer thread, so ~128 KB of loads are in flight per SM;
//   - swap-AB: the weight tile is the wgmma M side (64) and the item's few
//     tokens the N side, rounded up to 8, 16, 32 or 64 — a decode item with
//     2 rows runs m64n8k16 and loads 8 token rows, not 64;
//   - the epilogue rounds the fp32 accumulator to bf16 once, stages it in
//     shared memory and writes only the item's own rows [r0, r1) with
//     16-byte stores (neighbouring groups' rows enter the token box and are
//     masked here).
// float32 (the exact path of the tests): 32x32x32 tiles of scalar FMAs,
// one block per (row tile, column tile) of the static bound M/32 + G, with
// the same in-kernel scan.  float32 rows against bfloat16 weights (the
// reference's ragged_dot promotes the pair to a float32 product) run the
// widening kernel below: the bf16 kernel's walk and TMA ring, the rows
// split exactly into three bf16 planes on wgmma.
#include "group_shrink.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::RowTile;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::make_desc;
using repro::smem_u32;

// ---- bfloat16: TMA + wgmma, persistent ----------------------------------

constexpr int kBN = 64;                       // weight columns: wgmma M
constexpr int kBK = 64;                       // K per stage: a 128-byte row
constexpr int kTM = 64;                       // token rows per item, at most
constexpr int kStages = 8;
constexpr int kWBytes = kBN * kBK * 2;        // 8 KB
constexpr int kStageBytes = kWBytes + kTM * kBK * 2;
constexpr int kConsumers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + 32;     // + one producer warp
constexpr int kCsLd = kBN + 8;                // bf16; rows stay 16-byte aligned
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + kTM * kCsLd * 2 + 2 * kStages * 8 +
    (2 * repro::kMaxGroups + 2) * 4;

__device__ __forceinline__ int token_width(int rows) {
  return rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : 64;
}

// The consumer warpgroup's share of one work item: the K loop over the
// ring, then the epilogue.
template <int NT>
__device__ __forceinline__ void consume_item(unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int& stage, uint32_t& phase,
                                             int ksteps, bf16* cs,
                                             bf16* __restrict__ out,
                                             RowTile tl, int n0, int N) {
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  for (int kk = 0; kk < ksteps; ++kk) {
    mbar_wait(full + stage, phase);
    const uint32_t st = smem_u32(ring + stage * kStageBytes);
    repro::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) {
      // A (weights, MN-major): 16 K-rows of 128 bytes, 8-row groups 1024
      // bytes apart; B (tokens, K-major): the next 16 K of each token row
      repro::Wgmma<NT, 1, 0>::mma(acc, make_desc(st + k * 2048, 8192, 1024),
                                  make_desc(st + kWBytes + k * 32, 16, 1024), 1);
    }
    repro::wgmma_commit_wait();
    mbar_arrive(empty + stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int tid = threadIdx.x;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int v = 0; v < NT / 2; ++v) {   // D fragment: row = column of out
    const int n = repro::frag_row(tid, v), t = repro::frag_col(tid, v);
    cs[t * kCsLd + n] = __float2bfloat16(acc[v]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const int rows = tl.r1 - tl.r0;
  for (int i = tid; i < rows * (kBN / 8); i += kConsumers) {
    const int r = i >> 3, c = (i & 7) * 8;
    if (n0 + c < N) {
      *reinterpret_cast<uint4*>(out + static_cast<long long>(tl.r0 + r) * N +
                                n0 + c) =
          *reinterpret_cast<const uint4*>(cs + r * kCsLd + c);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_bf16_kernel(__grid_constant__ const CUtensorMap w_map,
                         __grid_constant__ const CUtensorMap x_map,
                         bf16* __restrict__ out,
                         const long long* __restrict__ sizes, int M, int K,
                         int N, int G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  bf16* cs = reinterpret_cast<bf16*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + kTM * kCsLd);
  uint64_t* empty = full + kStages;
  int* row_end = reinterpret_cast<int*>(empty + kStages);
  int* tile_end = row_end + repro::kMaxGroups;
  int* totals = tile_end + repro::kMaxGroups;

  const int tid = threadIdx.x;
  if (tid == kConsumers) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  repro::scan_groups(sizes, G, M, kTM, row_end, tile_end, totals);
  __syncthreads();
  const int live_rows = totals[0];
  const int nct = (N + kBN - 1) / kBN;
  const int items = totals[1] * nct;
  const int ksteps = (K + kBK - 1) / kBK;

  if (tid >= kConsumers) {              // producer warp: one thread
    if (tid != kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const RowTile tl =
          repro::find_tile(it / nct, row_end, tile_end, G, kTM);
      const int n0 = (it % nct) * kBN;
      const int nt = token_width(tl.r1 - tl.r0);
      const uint32_t bytes = kWBytes + nt * kBK * 2;
      for (int kk = 0; kk < ksteps; ++kk) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* st = ring + stage * kStageBytes;
        mbar_expect_tx(full + stage, bytes);
        repro::tma_load_3d(st, &w_map, full + stage, n0, kk * kBK, tl.g);
        // 8-row boxes, each one 1024-byte swizzle atom; rows past M are
        // zero-filled, rows of the next group masked in the epilogue
        for (int r = 0; r < nt; r += 8)
          repro::tma_load_2d(st + kWBytes + r * 128, &x_map, full + stage,
                             kk * kBK, tl.r0 + r);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: first the rows past the live ones, while the ring fills
  {
    const long long chunks = static_cast<long long>(M - live_rows) * N / 8;
    uint4* tail = reinterpret_cast<uint4*>(
        out + static_cast<long long>(live_rows) * N);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (long long i = static_cast<long long>(blockIdx.x) * kConsumers + tid;
         i < chunks; i += static_cast<long long>(gridDim.x) * kConsumers)
      tail[i] = zero;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const RowTile tl = repro::find_tile(it / nct, row_end, tile_end, G, kTM);
    const int n0 = (it % nct) * kBN;
    switch (token_width(tl.r1 - tl.r0)) {
      case 8:
        consume_item<8>(ring, full, empty, stage, phase, ksteps, cs, out, tl,
                        n0, N);
        break;
      case 16:
        consume_item<16>(ring, full, empty, stage, phase, ksteps, cs, out,
                         tl, n0, N);
        break;
      case 32:
        consume_item<32>(ring, full, empty, stage, phase, ksteps, cs, out,
                         tl, n0, N);
        break;
      default:
        consume_item<64>(ring, full, empty, stage, phase, ksteps, cs, out,
                         tl, n0, N);
    }
  }
}

// ---- float32 rows x bfloat16 weights: the widening route ------------------
//
// The product lax.ragged_dot takes for this pair: float32 rows against
// bf16 weights, summed in float32.  What bounds it on an H100: bytes at the
// disaggregated servers' decode batches (1-2 rows a group: each live
// group's K x N bf16 weights read once), and at quickstart's ~16 rows a
// group nearly the float32 FMA rate (2 * 16 * K * N operations against
// 2 * K * N bytes): on the FMA pipes the kernel would be bound there by the
// operations and by shared memory feeding them their operands.  So the
// products run on the tensor cores, with no rounding a float32 product
// would not make:
//   - x = x1 + x2 + x3 exactly: three bf16 planes, each 8 significant bits
//     of the float cut by truncation (split3); a plane times a bf16 weight
//     is exact in fp32, and wgmma sums a stage's 64 K of the three planes
//     into a fresh fp32 accumulator (acc0 the first plane, acc1 the other
//     two: two independent chains), which each lane adds to its running
//     fp32 sums stage after stage, in a fixed order;
//   - the bf16 kernel's walk: the in-kernel scan, one persistent CTA an SM
//     over (group, <= 64-row tile, 64-column tile) items in a fixed
//     stride, the column tile fastest: a wave of CTAs covers a few row
//     tiles across all their column tiles, so the rows, read again for
//     each column tile, come from L2 (a prefill's rows outgrow it), and a
//     group's row tiles past 64 rows meet its weights in L2 together;
//     each output tile written by one CTA, no split-K, no atomics, so the
//     output repeats bitwise;
//   - a ring of kXStages stages, each a 64 N x 64 K bf16 weight tile
//     (128-byte swizzle: wgmma's A, MN-major, swap-AB as the bf16 kernel)
//     and the item's rows in fp32, in 8-row boxes, 8 to 64 as the rows
//     need (a decode item of 2 rows loads 8), filled by TMA from one
//     producer warp under mbarriers; each weight element is loaded once
//     per item;
//   - two consumer warpgroups take alternate stages: each splits its
//     stage's rows into its own three swizzled planes (wgmma's B, K-major)
//     and runs the 12 wgmma of the stage while the other does the same
//     with the next; the two sums are added at the item's end (even
//     stages' + odd stages');
//   - where TMA cannot take the strides (K % 4, N % 8, unaligned bases)
//     the producer warp fills the same stage layout with predicated
//     copies.

constexpr int kXN = 64;                        // columns an item: wgmma M
constexpr int kXK = 64;                        // K a stage
constexpr int kXTM = 64;                       // rows an item, at most
constexpr int kXStages = 6;
constexpr int kXWBytes = kXN * kXK * 2;        // 8 KB of bf16 weights
constexpr int kXStageBytes = kXWBytes + kXTM * kXK * 4;   // + 16 KB of rows
constexpr int kXPlaneBytes = kXTM * kXK * 2;   // a plane: 64 rows of 128 B
constexpr int kXGroups = 2;                    // consumer warpgroups
constexpr int kXConsumers = 128 * kXGroups;
constexpr int kXThreads = kXConsumers + 128;   // + the producer warpgroup
constexpr int kXCsLd = kXN + 4;                // fp32 staging row
constexpr int kXSmemBytes = 1024 + kXStages * kXStageBytes +
                            kXGroups * 3 * kXPlaneBytes +
                            kXTM * kXCsLd * 4 + 2 * kXStages * 8 +
                            (2 * repro::kMaxGroups + 2) * 4;

// The three bf16 slices of two floats (top 8 significant bits, the next
// 8, the last 8), packed in pairs.  Each slice is cut by truncation, so
// each remainder is exact and x1 + x2 + x3 == x; a non-finite value rides
// whole on the first plane (a NaN as the canonical one).
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const bool fa = isfinite(a), fb = isfinite(b);
  const float ra = fa ? a - __uint_as_float(ua & 0xFFFF0000u) : 0.f;
  const float rb = fb ? b - __uint_as_float(ub & 0xFFFF0000u) : 0.f;
  const float a2 = __uint_as_float(__float_as_uint(ra) & 0xFFFF0000u);
  const float b2 = __uint_as_float(__float_as_uint(rb) & 0xFFFF0000u);
  const float a3 = ra - a2, b3 = rb - b2;     // 8 bits at most: a bf16
  p0 = (a != a ? 0x7FC0u : ua >> 16) | ((b != b ? 0x7FC0u : ub >> 16) << 16);
  p1 = (__float_as_uint(a2) >> 16) | (__float_as_uint(b2) & 0xFFFF0000u);
  p2 = (__float_as_uint(a3) >> 16) | (__float_as_uint(b3) & 0xFFFF0000u);
}

// The producer warp's copy of a stage where TMA cannot run: the layout TMA
// gives (weights in 128-byte swizzle atoms, rows [r][k]), zeros outside
// the tensors.
__device__ __forceinline__ void widen_copy_stage(
    unsigned char* st, const float* __restrict__ x,
    const bf16* __restrict__ w, RowTile tl, int n0, int k0, int nt, int M,
    int K, int N, int lane) {
  const unsigned short* wg = reinterpret_cast<const unsigned short*>(w) +
                             static_cast<long long>(tl.g) * K * N;
  for (int e = lane; e < kXK * kXN; e += 32) {
    const int kr = e / kXN, nc = e % kXN;
    const int k = k0 + kr, n = n0 + nc;
    *reinterpret_cast<unsigned short*>(
        st + kr * 128 + (((nc >> 3) ^ (kr & 7)) << 4) + (nc & 7) * 2) =
        (k < K && n < N) ? wg[static_cast<long long>(k) * N + n]
                         : static_cast<unsigned short>(0);
  }
  float* xs = reinterpret_cast<float*>(st + kXWBytes);
  for (int e = lane; e < nt * kXK; e += 32) {
    const int r = tl.r0 + e / kXK, k = k0 + e % kXK;
    xs[e] = (r < M && k < K) ? x[static_cast<long long>(r) * K + k] : 0.f;
  }
}

// One warpgroup's share of an item: every other stage of the K loop (its
// parity `grp`), then the item's epilogue with the other warpgroup.
template <int NT>
__device__ __forceinline__ void widen_item(
    unsigned char* ring, unsigned char* planes, float* cs, uint64_t* full,
    uint64_t* empty, int& stage, uint32_t& phase, int ksteps,
    float* __restrict__ out, RowTile tl, int n0, int N, int grp) {
  const int tid = threadIdx.x & 127;
  float total[NT / 2], acc0[NT / 2], acc1[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) total[i] = 0.f;
  const uint32_t pa = smem_u32(planes);
  for (int kk = 0; kk < ksteps; ++kk) {
    if ((kk & 1) == grp) {
      mbar_wait(full + stage, phase);
      unsigned char* st = ring + stage * kXStageBytes;
      const float* xs = reinterpret_cast<const float*>(st + kXWBytes);
      repro::named_sync(1 + grp, 128);   // the planes' last wgmma is done
      for (int u = tid; u < NT * 8; u += 128) {   // 8 K of a row: 16 bytes
        const int t = u >> 3, j = u & 7;
        const float4 v0 =
            *reinterpret_cast<const float4*>(xs + t * kXK + j * 8);
        const float4 v1 =
            *reinterpret_cast<const float4*>(xs + t * kXK + j * 8 + 4);
        uint4 q0, q1, q2;
        split3(v0.x, v0.y, q0.x, q1.x, q2.x);
        split3(v0.z, v0.w, q0.y, q1.y, q2.y);
        split3(v1.x, v1.y, q0.z, q1.z, q2.z);
        split3(v1.z, v1.w, q0.w, q1.w, q2.w);
        const int off = t * 128 + ((j ^ (t & 7)) << 4);   // the swizzle
        *reinterpret_cast<uint4*>(planes + off) = q0;
        *reinterpret_cast<uint4*>(planes + kXPlaneBytes + off) = q1;
        *reinterpret_cast<uint4*>(planes + 2 * kXPlaneBytes + off) = q2;
      }
      repro::fence_async_smem();
      repro::named_sync(1 + grp, 128);
      const uint32_t wa = smem_u32(st);
      repro::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kXK / 16; ++k) {
        // A (weights, MN-major): 16 K-rows of 128 bytes; B (a plane,
        // K-major): the next 16 K of each row
        const uint64_t a = make_desc(wa + k * 2048, 8192, 1024);
        repro::Wgmma<NT, 1, 0>::mma(
            acc0, a, make_desc(pa + k * 32, 16, 1024), k != 0);
        repro::Wgmma<NT, 1, 0>::mma(
            acc1, a, make_desc(pa + kXPlaneBytes + k * 32, 16, 1024), k != 0);
        repro::Wgmma<NT, 1, 0>::mma(
            acc1, a, make_desc(pa + 2 * kXPlaneBytes + k * 32, 16, 1024), 1);
      }
      repro::wgmma_commit_wait();
      mbar_arrive(empty + stage);
#pragma unroll
      for (int i = 0; i < NT / 2; ++i)
        total[i] = (total[i] + acc0[i]) + acc1[i];
    }
    if (++stage == kXStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // out = even stages' sums + odd stages', staged as [row][column]
  repro::named_sync(3, kXConsumers);   // cs is free
  if (grp == 1) {
#pragma unroll
    for (int v = 0; v < NT / 2; ++v)   // D fragment: row = column of out
      cs[repro::frag_col(tid, v) * kXCsLd + repro::frag_row(tid, v)] =
          total[v];
  }
  repro::named_sync(3, kXConsumers);
  if (grp == 0) {
#pragma unroll
    for (int v = 0; v < NT / 2; ++v) {
      float* c =
          cs + repro::frag_col(tid, v) * kXCsLd + repro::frag_row(tid, v);
      *c = total[v] + *c;
    }
  }
  repro::named_sync(3, kXConsumers);
  const int rows = tl.r1 - tl.r0;
  for (int i = threadIdx.x; i < rows * kXN; i += kXConsumers) {
    const int r = i / kXN, c = i % kXN;
    if (n0 + c < N)
      out[static_cast<long long>(tl.r0 + r) * N + n0 + c] =
          cs[r * kXCsLd + c];
  }
}

__global__ void __launch_bounds__(kXThreads, 1)
grouped_gemm_widen_kernel(__grid_constant__ const CUtensorMap w_map,
                          __grid_constant__ const CUtensorMap x_map,
                          const float* __restrict__ x,
                          const bf16* __restrict__ w,
                          float* __restrict__ out,
                          const long long* __restrict__ sizes, int M, int K,
                          int N, int G, int tma) {
  extern __shared__ __align__(1024) unsigned char widen_smem[];
  // 128-byte swizzle atoms are 1024 bytes: align the ring and planes
  unsigned char* smem =
      widen_smem + ((1024 - (smem_u32(widen_smem) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* planes = smem + kXStages * kXStageBytes;
  float* cs = reinterpret_cast<float*>(planes + kXGroups * 3 * kXPlaneBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + kXTM * kXCsLd);
  uint64_t* empty = full + kXStages;
  int* row_end = reinterpret_cast<int*>(empty + kXStages);
  int* tile_end = row_end + repro::kMaxGroups;
  int* totals = tile_end + repro::kMaxGroups;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == kXConsumers) {
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(full + s, 32);          // every lane of the producer warp
      mbar_init(empty + s, 128);        // the warpgroup that took the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  repro::scan_groups(sizes, G, M, kXTM, row_end, tile_end, totals);
  __syncthreads();
  const int live_rows = totals[0], tiles = totals[1];
  const int ncols = (N + kXN - 1) / kXN;
  const int items = tiles * ncols;
  const int ksteps = (K + kXK - 1) / kXK;

  if (warp >= kXConsumers / 32) {       // the producer warpgroup
    if (warp != kXConsumers / 32) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const RowTile tl =
          repro::find_tile(it / ncols, row_end, tile_end, G, kXTM);
      const int n0 = (it % ncols) * kXN;
      const int nt = token_width(tl.r1 - tl.r0);
      for (int kk = 0; kk < ksteps; ++kk) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* st = ring + stage * kXStageBytes;
        if (tma) {
          if (lane == 0) {
            mbar_expect_tx(full + stage, kXWBytes + nt * kXK * 4);
            repro::tma_load_3d(st, &w_map, full + stage, n0, kk * kXK, tl.g);
            // rows past M are zero-filled; rows of the next group are
            // loaded, multiplied and never written
            for (int r = 0; r < nt; r += 8)
              repro::tma_load_2d(st + kXWBytes + r * kXK * 4, &x_map,
                                 full + stage, kk * kXK, tl.r0 + r);
          } else {
            mbar_arrive(full + stage);
          }
        } else {
          widen_copy_stage(st, x, w, tl, n0, kk * kXK, nt, M, K, N, lane);
          mbar_arrive(full + stage);
        }
        if (++stage == kXStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: first the rows past the live ones, while the ring fills
  {
    const long long first = static_cast<long long>(live_rows) * N;
    const long long n = static_cast<long long>(M) * N - first;
    for (long long i = static_cast<long long>(blockIdx.x) * kXConsumers + tid;
         i < n; i += static_cast<long long>(gridDim.x) * kXConsumers)
      out[first + i] = 0.f;
  }
  const int grp = warp / 4;
  unsigned char* mine = planes + grp * 3 * kXPlaneBytes;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const RowTile tl =
        repro::find_tile(it / ncols, row_end, tile_end, G, kXTM);
    const int n0 = (it % ncols) * kXN;
    switch (token_width(tl.r1 - tl.r0)) {
      case 8:
        widen_item<8>(ring, mine, cs, full, empty, stage, phase, ksteps, out,
                      tl, n0, N, grp);
        break;
      case 16:
        widen_item<16>(ring, mine, cs, full, empty, stage, phase, ksteps,
                       out, tl, n0, N, grp);
        break;
      case 32:
        widen_item<32>(ring, mine, cs, full, empty, stage, phase, ksteps,
                       out, tl, n0, N, grp);
        break;
      default:
        widen_item<64>(ring, mine, cs, full, empty, stage, phase, ksteps,
                       out, tl, n0, N, grp);
    }
  }
}

// ---- float32 rows and weights: scalar FMAs, the same scan ----------------

constexpr int kFM = 32, kFN = 32, kFK = 32, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
grouped_gemm_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        const long long* __restrict__ sizes, int M, int K,
                        int N, int G) {
  __shared__ int row_end[repro::kMaxGroups], tile_end[repro::kMaxGroups];
  __shared__ int totals[2];
  __shared__ float As[kFM][kFK + 1];
  __shared__ float Bs[kFK][kFN + 1];
  repro::scan_groups(sizes, G, M, kFM, row_end, tile_end, totals);
  __syncthreads();
  const int tid = threadIdx.x;
  {  // rows past the live ones, shared over all blocks
    const long long first = static_cast<long long>(totals[0]) * N;
    const long long n = static_cast<long long>(M) * N - first;
    const long long nthreads =
        static_cast<long long>(gridDim.x) * gridDim.y * kFThreads;
    for (long long i = (static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * kFThreads + tid;
         i < n; i += nthreads)
      out[first + i] = 0.f;
  }
  const int t = blockIdx.x;
  if (t >= totals[1]) return;              // dead tile: group-shrink stop
  const RowTile tl = repro::find_tile(t, row_end, tile_end, G, kFM);
  const int r0 = tl.r0, r1 = tl.r1;
  const int n0 = blockIdx.y * kFN;

  const float* wg = w + static_cast<long long>(tl.g) * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  // this thread's two rows: only threads with a live row run the FMAs
  const bool live0 = r0 + ty < r1, live1 = r0 + ty + 16 < r1;
  float c[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int i = tid; i < kFM * kFK; i += kFThreads) {
      const int row = i / kFK, col = i % kFK;
      const int r = r0 + row, kk = k0 + col;
      As[row][col] =
          (r < r1 && kk < K) ? x[static_cast<long long>(r) * K + kk] : 0.f;
    }
    for (int i = tid; i < kFK * kFN; i += kFThreads) {
      const int row = i / kFN, col = i % kFN;
      const int kr = k0 + row, nn = n0 + col;
      Bs[row][col] =
          (kr < K && nn < N) ? wg[static_cast<long long>(kr) * N + nn] : 0.f;
    }
    __syncthreads();
    if (live1) {
#pragma unroll 8
      for (int kk = 0; kk < kFK; ++kk) {
        const float a0 = As[ty][kk], a1 = As[ty + 16][kk];
        const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
        c[0][0] += a0 * b0;
        c[0][1] += a0 * b1;
        c[1][0] += a1 * b0;
        c[1][1] += a1 * b1;
      }
    } else if (live0) {
#pragma unroll 8
      for (int kk = 0; kk < kFK; ++kk) {
        const float a0 = As[ty][kk];
        c[0][0] += a0 * Bs[kk][tx];
        c[0][1] += a0 * Bs[kk][tx + 16];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + ty + 16 * i, nn = n0 + tx + 16 * j;
      if (r < r1 && nn < N) out[static_cast<long long>(r) * N + nn] = c[i][j];
    }
}

// ---- host ----------------------------------------------------------------

int launch_bf16(const void* x, const void* w, void* out,
                const long long* sizes, int M, int K, int N, int G,
                cudaStream_t s) {
  static bool ready[64] = {};
  static int sms[64] = {};
  int dev = 0;
  const int err = repro::persistent_setup(
      reinterpret_cast<const void*>(grouped_gemm_bf16_kernel), kSmemBytes,
      ready, sms, &dev);
  if (err != 0) return err;
  // the weights' map (box 64 N x 64 K) is cached; the tokens' (64 K x 8
  // rows) changes with every call's activations
  CUtensorMap w_map, x_map;
  if (!repro::cached_map(w, N, K, G, kBN, kBK, &w_map) ||
      !repro::encode_map(x, K, M, 0, kBK, 8, &x_map))
    return static_cast<int>(cudaErrorInvalidValue);
  // more CTAs than the static bound on items would only idle
  const long long bound =
      (static_cast<long long>(M) / kTM + G) * ((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(bound < sms[dev] ? bound : sms[dev]);
  grouped_gemm_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      w_map, x_map, static_cast<bf16*>(out), sizes, M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

int launch_widen(const void* x, const void* w, void* out,
                 const long long* sizes, int M, int K, int N, int G,
                 cudaStream_t s) {
  static bool ready[64] = {};
  static int sms[64] = {};
  int dev = 0;
  const int err = repro::persistent_setup(
      reinterpret_cast<const void*>(grouped_gemm_widen_kernel), kXSmemBytes,
      ready, sms, &dev);
  if (err != 0) return err;
  // TMA takes 16-byte aligned bases and row strides: bf16 weight rows of
  // N % 8 == 0, fp32 token rows of K % 4 == 0
  const bool tma = N % 8 == 0 && K % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // the weights' map (box 64 N x 64 K, the bf16 kernel's) is cached; the
  // rows' (64 K x 8 rows, fp32) changes with every call's activations
  CUtensorMap w_map{}, x_map{};
  if (tma && (!repro::cached_map(w, N, K, G, kXN, kXK, &w_map) ||
              !repro::encode_map(x, K, M, 0, kXK, 8, &x_map,
                                 repro::kF32Plain)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bound =
      (static_cast<long long>(M) / kXTM + G) * ((N + kXN - 1) / kXN);
  const int grid = static_cast<int>(bound < sms[dev] ? bound : sms[dev]);
  grouped_gemm_widen_kernel<<<grid, kXThreads, kXSmemBytes, s>>>(
      w_map, x_map, static_cast<const float*>(x), static_cast<const bf16*>(w),
      static_cast<float*>(out), sizes, M, K, N, G, tma ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: x's and out's; w_dtype: w's (bfloat16 rows take bfloat16
// weights; float32 rows either)
extern "C" int grouped_gemm_launch(const void* x, const void* w, void* out,
                                   const void* group_sizes, int M, int K,
                                   int N, int G, int dtype, int w_dtype,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1 || G < 1 || G > repro::kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sizes = static_cast<const long long*>(group_sizes);
  if (dtype == repro::kBFloat16) {
    if (w_dtype != repro::kBFloat16 || K % 8 != 0 || N % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(x, w, out, sizes, M, K, N, G, s);
  }
  if (w_dtype == repro::kBFloat16)
    return launch_widen(x, w, out, sizes, M, K, N, G, s);
  dim3 grid(M / kFM + G, (N + kFN - 1) / kFN);
  grouped_gemm_f32_kernel<<<grid, kFThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), sizes, M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}
