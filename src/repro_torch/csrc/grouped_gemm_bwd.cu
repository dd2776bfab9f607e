// Gradients of the grouped GEMM (kernels/grouped_gemm.py::GroupedGemm):
//
//   dx[i]  = dy[i] @ w[g(i)]^T          rows past sum(group_sizes) -> 0
//   dw[g]  = x_g^T @ dy_g               an empty group -> 0
//
// for out[i] = x[i] @ w[g(i)] over rows sorted by group.  This is the VJP
// of what the reference trains through, lax.ragged_dot
// (src/repro/kernels/ops.py:95, pinned by src/repro/launch/train.py); the
// Pallas kernel (src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas)
// has no custom_vjp, so no TPU kernel is replaced here: both entries are
// new work for this card.  With `accumulate`, dw adds into what `dw` holds
// (the stacked leaf's gradient, kernels/autograd.py): dw[g] =
// round(float(dw[g]) + acc) for every group that holds rows, rounded once;
// empty groups are left as they are.
//
// Both read group_sizes on the device as torch.bincount leaves it and
// prefix-scan it in shared memory (group_shrink.cuh); nothing syncs with
// the host, one launch a call.  The item walks are stated in plain PyTorch
// in kernels/group_shrink.py (dx_items / dw_items) and tested on the CPU
// (tests/test_torch_bwd_tiles.py).
//
// What bounds them on an H100 at the training path's shapes (one server:
// G = 128, ~64 live rows a group, K/N = 7168/2048): bytes.  dx must read
// every live expert's w (3.76 GB a server tensor, 1.12 ms at 3.35 TB/s);
// dw must write G*K*N values (3.76 GB) after a reduction over only ~64
// rows, and read them as well under `accumulate` (training's mode, 2.25
// ms).  The FLOPs (2 * rows * K * N) would take a quarter of the bytes'
// time on the tensor cores.  So, bf16, both are persistent TMA + wgmma
// kernels built as the forward is (hopper.cuh: one CTA per SM, a producer
// warp keeping a ring of TMA loads in flight under mbarriers, each output
// tile written by exactly one CTA, no split-K, no atomics: bitwise
// repeatable), and each keeps its one large stream at full rate:
//
//   dx: items (group, row tile of up to 128 rows, 128 dx columns).  128
//     rows hold a whole group at training sizes (45-85 rows), so w[g] is
//     read once; two consumer warpgroups take 64 rows each (the second
//     idles on a group of <= 64 rows).  A = dy rows, B = w[g] rows k0..+127,
//     both K-major with the reduction N contiguous: w is read as it lies,
//     transposed by the descriptor, with no copy.  The epilogue rounds to
//     bf16 once, stages in shared memory and stores only the item's rows
//     (rows of the next group enter the dy box and are masked there); rows
//     past the live ones are zeroed by the consumers while the ring fills.
//   dw: items (group, 128 dw rows (K), 128 dw columns (N)); A = x_g^T and
//     B = dy_g, both MN-major, loaded by TMA in 64-row stages.  The last
//     stage of a group holds rows of the next group (or past the sum):
//     each warpgroup zeroes those rows of its x box (whole 128-byte lines,
//     so the swizzle does not matter) before its wgmma.  The output tile
//     is staged in one of kOutSlots shared-memory slots and written by a
//     TMA store that drains while the next items load and multiply; under
//     `accumulate` the old tile is TMA-loaded into the same slot
//     kOutAhead items ahead, added in fp32 and rounded once (no reduce-add,
//     which would round twice).  Without `accumulate` every group's tiles
//     are written, zeros for an empty one; with it, only live groups are
//     walked.
//
// float32 (the exact path of the card-vs-CPU tests): scalar FMAs over
// 64 x 64 output tiles (4 x 4 a thread) staged in shared memory, the same
// scan; dx walks the live 64-row tiles, dw gives each block one (k, n)
// tile and walks every group.
#include "group_shrink.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::make_desc;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::RowTile;
using repro::smem_u32;

constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // + one producer warp
constexpr int kBox = 64 * 64 * 2;             // a 64 x 64 bf16 TMA box: 8 KB
constexpr int kScanBytes = (2 * repro::kMaxGroups + 2) * 4;

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  // 128-byte swizzle atoms are 1024 bytes
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n,
                                              int count_from) {
  // bars[0, count_from) complete on one arrival, the rest on kConsumers
  for (int i = 0; i < n; ++i) mbar_init(bars + i, i < count_from ? 1 :
                                                    kConsumers);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void zero32(float* a) {
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
}

// ---- bfloat16 dx ----------------------------------------------------------

constexpr int kXM = 128;                      // rows per item
constexpr int kXK = 128;                      // dx columns per item
constexpr int kXR = 64;                       // reduction (N) per stage
constexpr int kXStages = 5;
constexpr int kXStageBytes = 2 * kBox + kXK * kXR * 2;   // dy 2 x 8 + w 16 KB
constexpr int kXCsLd = kXK + 8;               // bf16; rows stay 16-byte aligned
constexpr int kXSmem = 1024 + kXStages * kXStageBytes + 2 * 64 * kXCsLd * 2 +
                       2 * kXStages * 8 + kScanBytes;

__global__ void __launch_bounds__(kThreads, 1)
dx_bf16_kernel(__grid_constant__ const CUtensorMap dy_map,
               __grid_constant__ const CUtensorMap w_map,
               bf16* __restrict__ dx, const long long* __restrict__ sizes,
               int M, int K, int N, int G) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  bf16* cs = reinterpret_cast<bf16*>(ring + kXStages * kXStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + 2 * 64 * kXCsLd);
  uint64_t* empty = full + kXStages;
  int* row_end = reinterpret_cast<int*>(empty + kXStages);
  int* tile_end = row_end + repro::kMaxGroups;
  int* totals = tile_end + repro::kMaxGroups;

  const int tid = threadIdx.x;
  if (tid == kConsumers) init_barriers(full, 2 * kXStages, kXStages);
  repro::scan_groups(sizes, G, M, kXM, row_end, tile_end, totals);
  __syncthreads();
  const int live_rows = totals[0];
  const int nkt = (K + kXK - 1) / kXK;
  const int items = totals[1] * nkt;
  const int rsteps = (N + kXR - 1) / kXR;

  if (tid >= kConsumers) {              // producer warp: one thread
    if (tid != kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const RowTile tl =
          repro::find_tile(it / nkt, row_end, tile_end, G, kXM);
      const int k0 = (it % nkt) * kXK;
      const bool two = tl.r1 - tl.r0 > 64;
      const uint32_t bytes = kXStageBytes - (two ? 0 : kBox);
      for (int s = 0; s < rsteps; ++s) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* st = ring + stage * kXStageBytes;
        mbar_expect_tx(full + stage, bytes);
        // w[g] rows k0..k0+127 (past K zero-filled); dy rows r0.. in 64-row
        // boxes (past M zero-filled, the next group's masked below)
        repro::tma_load_3d(st + 2 * kBox, &w_map, full + stage, s * kXR, k0,
                           tl.g);
        repro::tma_load_2d(st, &dy_map, full + stage, s * kXR, tl.r0);
        if (two)
          repro::tma_load_2d(st + kBox, &dy_map, full + stage, s * kXR,
                             tl.r0 + 64);
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
    const long long chunks = static_cast<long long>(M - live_rows) * K / 8;
    uint4* tail = reinterpret_cast<uint4*>(
        dx + static_cast<long long>(live_rows) * K);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (long long i = static_cast<long long>(blockIdx.x) * kConsumers + tid;
         i < chunks; i += static_cast<long long>(gridDim.x) * kConsumers)
      tail[i] = zero;
  }
  const int wg = tid >> 7, t = tid & 127;
  bf16* cw = cs + wg * 64 * kXCsLd;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const RowTile tl = repro::find_tile(it / nkt, row_end, tile_end, G, kXM);
    const int k0 = (it % nkt) * kXK;
    const int rb = tl.r0 + 64 * wg;
    const int rows = min(64, tl.r1 - rb);      // <= 0: this warpgroup idles
    float acc0[32], acc1[32];                  // dx columns k0.. / k0 + 64..
    zero32(acc0);
    zero32(acc1);
    for (int s = 0; s < rsteps; ++s) {
      mbar_wait(full + stage, phase);
      if (rows > 0) {
        const uint32_t st = smem_u32(ring + stage * kXStageBytes);
        const uint32_t a = st + wg * kBox, b = st + 2 * kBox;
        repro::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kXR / 16; ++k) {
          // A: 64 dy rows, B: 64 w rows each, K-major: the next 16 of N
          const uint64_t da = make_desc(a + k * 32, 16, 1024);
          repro::Wgmma<64, 0, 0>::mma(acc0, da,
                                      make_desc(b + k * 32, 16, 1024), 1);
          repro::Wgmma<64, 0, 0>::mma(
              acc1, da, make_desc(b + kBox + k * 32, 16, 1024), 1);
        }
        repro::wgmma_commit_wait();
      }
      mbar_arrive(empty + stage);
      if (++stage == kXStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (rows <= 0) continue;
    repro::named_sync(2 + wg, 128);            // cw free of the last item
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      bf16* p = cw + repro::frag_row(t, v) * kXCsLd + repro::frag_col(t, v);
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(acc0[v], acc0[v + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p + 64) =
          __floats2bfloat162_rn(acc1[v], acc1[v + 1]);
    }
    repro::named_sync(2 + wg, 128);
    for (int i = t; i < rows * (kXK / 8); i += 128) {
      const int r = i >> 4, c = (i & 15) * 8;
      if (k0 + c < K)
        *reinterpret_cast<uint4*>(dx + static_cast<long long>(rb + r) * K +
                                  k0 + c) =
            *reinterpret_cast<const uint4*>(cw + r * kXCsLd + c);
    }
  }
}

// ---- bfloat16 dw ----------------------------------------------------------

constexpr int kWK = 128;                      // dw rows (K) per item
constexpr int kWN = 128;                      // dw columns (N) per item
constexpr int kWR = 64;                       // group rows per stage
constexpr int kWStages = 2;
constexpr int kWStageBytes = 4 * kBox;        // x^T 2 x 8 KB, dy 2 x 8 KB
constexpr int kOutSlots = 4;
constexpr int kOutAhead = 2;                  // old tiles loaded ahead
constexpr int kOutBytes = kWK * kWN * 2;      // 32 KB: two 64 x 128 boxes
constexpr int kWSmem = 1024 + kWStages * kWStageBytes +
                       kOutSlots * kOutBytes +
                       2 * (kWStages + kOutSlots) * 8 + kScanBytes;
static_assert(kOutAhead < kOutSlots, "a slot must be free to load ahead");

struct DwItem {
  int g, r0, r1, k0, n0;
};

// Item `it` of the walk: (group, K tile, N tile), N fastest; the groups are
// every group, or with `accumulate` the live ones (the scan's tiles of
// tm = M rows: one per live group).
__device__ __forceinline__ DwItem dw_item(int it, int nkt, int nnt,
                                          int accumulate, const int* row_end,
                                          const int* tile_end, int G, int M) {
  const int l = it / (nkt * nnt), rem = it % (nkt * nnt);
  DwItem w;
  if (accumulate) {
    const RowTile tl = repro::find_tile(l, row_end, tile_end, G, M);
    w.g = tl.g;
    w.r0 = tl.r0;
    w.r1 = tl.r1;
  } else {
    w.g = l;
    w.r0 = l ? row_end[l - 1] : 0;
    w.r1 = row_end[l];
  }
  w.k0 = (rem / nnt) * kWK;
  w.n0 = (rem % nnt) * kWN;
  return w;
}

// Two adjacent accumulator values into a staged bf16 pair, plus what the
// pair held (the old tile) under `accumulate`: one rounding.
__device__ __forceinline__ void put_pair(unsigned char* p, float a, float b,
                                         int accumulate) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  if (accumulate) {
    const float2 old = __bfloat1622float2(*q);
    a += old.x;
    b += old.y;
  }
  *q = __floats2bfloat162_rn(a, b);
}

__global__ void __launch_bounds__(kThreads, 1)
dw_bf16_kernel(__grid_constant__ const CUtensorMap x_map,
               __grid_constant__ const CUtensorMap dy_map,
               __grid_constant__ const CUtensorMap out_map,
               const long long* __restrict__ sizes, int M, int K, int N,
               int G, int accumulate) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);
  unsigned char* outs = ring + kWStages * kWStageBytes;
  uint64_t* ofull = reinterpret_cast<uint64_t*>(outs + kOutSlots * kOutBytes);
  uint64_t* ofree = ofull + kOutSlots;
  uint64_t* full = ofree + kOutSlots;
  uint64_t* empty = full + kWStages;
  int* row_end = reinterpret_cast<int*>(empty + kWStages);
  int* tile_end = row_end + repro::kMaxGroups;
  int* totals = tile_end + repro::kMaxGroups;

  const int tid = threadIdx.x;
  if (tid == kConsumers)
    init_barriers(ofull, 2 * (kOutSlots + kWStages), 2 * kOutSlots +
                                                         kWStages);
  repro::scan_groups(sizes, G, M, M, row_end, tile_end, totals);
  __syncthreads();
  const int nkt = (K + kWK - 1) / kWK, nnt = (N + kWN - 1) / kWN;
  const int items = (accumulate ? totals[1] : G) * nkt * nnt;
  const int count = items > static_cast<int>(blockIdx.x)
      ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  if (tid >= kConsumers) {              // producer warp: one thread
    if (tid != kConsumers) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int q = 0; q < count; ++q) {
      const DwItem w = dw_item(blockIdx.x + q * gridDim.x, nkt, nnt,
                               accumulate, row_end, tile_end, G, M);
      const int slot = q % kOutSlots;
      unsigned char* o = outs + slot * kOutBytes;
      mbar_wait(ofree + slot, ((q / kOutSlots) & 1) ^ 1);
      if (accumulate) {                 // the old tile, into the slot
        mbar_expect_tx(ofull + slot, kOutBytes);
        repro::tma_load_3d(o, &out_map, ofull + slot, w.n0, w.k0, w.g);
        repro::tma_load_3d(o + kOutBytes / 2, &out_map, ofull + slot,
                           w.n0 + 64, w.k0, w.g);
      } else {
        mbar_arrive(ofull + slot);
      }
      for (int rs = w.r0; rs < w.r1; rs += kWR) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* st = ring + stage * kWStageBytes;
        mbar_expect_tx(full + stage, kWStageBytes);
        repro::tma_load_2d(st, &x_map, full + stage, w.k0, rs);
        repro::tma_load_2d(st + kBox, &x_map, full + stage, w.k0 + 64, rs);
        repro::tma_load_2d(st + 2 * kBox, &dy_map, full + stage, w.n0, rs);
        repro::tma_load_2d(st + 3 * kBox, &dy_map, full + stage, w.n0 + 64,
                           rs);
        if (++stage == kWStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, t = tid & 127;
  int stage = 0;
  uint32_t phase = 0;
  for (int q = 0; q < count; ++q) {
    const DwItem w = dw_item(blockIdx.x + q * gridDim.x, nkt, nnt, accumulate,
                             row_end, tile_end, G, M);
    float acc0[32], acc1[32];                  // dw columns n0.. / n0 + 64..
    zero32(acc0);
    zero32(acc1);
    for (int rs = w.r0; rs < w.r1; rs += kWR) {
      mbar_wait(full + stage, phase);
      unsigned char* st = ring + stage * kWStageBytes;
      unsigned char* a = st + wg * kBox;       // x rows x this warpgroup's K
      const int live = min(kWR, w.r1 - rs);
      if (live < kWR) {
        // rows of the next group (or past the sum): zero their lines
        uint4* p = reinterpret_cast<uint4*>(a + live * 128);
        for (int i = t; i < (kWR - live) * 8; i += 128)
          p[i] = make_uint4(0, 0, 0, 0);
        repro::fence_async_smem();
        repro::named_sync(2 + wg, 128);
      }
      const uint32_t au = smem_u32(a), bu = smem_u32(st + 2 * kBox);
      repro::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWR / 16; ++k) {
        // A = x^T, B = dy, both MN-major: 16 group rows a step
        const uint64_t da = make_desc(au + k * 2048, 8192, 1024);
        repro::Wgmma<64, 1, 1>::mma(acc0, da,
                                    make_desc(bu + k * 2048, 8192, 1024), 1);
        repro::Wgmma<64, 1, 1>::mma(
            acc1, da, make_desc(bu + kBox + k * 2048, 8192, 1024), 1);
      }
      repro::wgmma_commit_wait();
      mbar_arrive(empty + stage);
      if (++stage == kWStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: into the slot, laid out as the out map's 128-byte swizzle
    // (row r of a box is line r, its 16-byte chunk c at c ^ (r % 8))
    const int slot = q % kOutSlots;
    unsigned char* o = outs + slot * kOutBytes;
    mbar_wait(ofull + slot, (q / kOutSlots) & 1);
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int r = 64 * wg + repro::frag_row(t, v);
      const int off = r * 128 + (((v >> 2) ^ (r & 7)) << 4) + 4 * (t & 3);
      put_pair(o + off, acc0[v], acc0[v + 1], accumulate);
      put_pair(o + kOutBytes / 2 + off, acc1[v], acc1[v + 1], accumulate);
    }
    repro::fence_async_smem();
    repro::named_sync(1, kConsumers);
    if (tid == 0) {
      repro::tma_store_3d(&out_map, o, w.n0, w.k0, w.g);
      repro::tma_store_3d(&out_map, o + kOutBytes / 2, w.n0 + 64, w.k0, w.g);
      repro::bulk_commit();
      // the slot of item q + kOutAhead was last read by store
      // q + kOutAhead - kOutSlots: once it is read, the slot is free
      repro::bulk_wait_read<kOutSlots - kOutAhead>();
      const int n = q + kOutAhead;
      if (n >= kOutSlots && n < count) mbar_arrive(ofree + n % kOutSlots);
    }
  }
  if (tid == 0) repro::bulk_wait_all();
}

// ---- float32: scalar FMAs -------------------------------------------------

constexpr int kT = 64;        // output tile edge
constexpr int kR = 32;        // reduction step
constexpr int kFThreads = 256;

// c[4][4] of the 64 x 64 tile: rows ty + 16 i, columns tx + 16 j
struct Acc {
  float c[4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
};

// dx (M, K) = dy (M, N) @ w[g]^T, w (G, K, N): grid (M / 64 + G, ceil(K/64))
__global__ void __launch_bounds__(kFThreads)
dx_f32_kernel(const float* __restrict__ dy, const float* __restrict__ w,
              float* __restrict__ dx, const long long* __restrict__ sizes,
              int M, int K, int N, int G) {
  __shared__ int row_end[repro::kMaxGroups], tile_end[repro::kMaxGroups];
  __shared__ int totals[2];
  __shared__ float As[kT][kR + 1];     // dy rows x n
  __shared__ float Bs[kR][kT + 1];     // n x k (w[g] transposed)
  repro::scan_groups(sizes, G, M, kT, row_end, tile_end, totals);
  __syncthreads();
  const int tid = threadIdx.x;
  {  // rows past the live ones, shared over all blocks
    const long long first = static_cast<long long>(totals[0]) * K;
    const long long n = static_cast<long long>(M) * K - first;
    const long long nthreads =
        static_cast<long long>(gridDim.x) * gridDim.y * kFThreads;
    for (long long i = (static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * kFThreads + tid;
         i < n; i += nthreads)
      dx[first + i] = 0.f;
  }
  const int t = blockIdx.x;
  if (t >= totals[1]) return;              // dead tile: group-shrink stop
  const RowTile tl = repro::find_tile(t, row_end, tile_end, G, kT);
  const int k0 = blockIdx.y * kT;
  const float* wg = w + static_cast<long long>(tl.g) * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  Acc acc;
  acc.zero();
  for (int n0 = 0; n0 < N; n0 += kR) {
    for (int i = tid; i < kT * kR; i += kFThreads) {
      const int row = i / kR, col = i % kR;
      const int r = tl.r0 + row, nn = n0 + col;
      As[row][col] = (r < tl.r1 && nn < N)
          ? dy[static_cast<long long>(r) * N + nn] : 0.f;
    }
    for (int i = tid; i < kT * kR; i += kFThreads) {
      const int kr = i / kR, col = i % kR;    // consecutive threads: n
      const int kk = k0 + kr, nn = n0 + col;
      Bs[col][kr] = (kk < K && nn < N)
          ? wg[static_cast<long long>(kk) * N + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kR; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][r];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc.c[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tl.r0 + ty + 16 * i;
    if (r >= tl.r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + tx + 16 * j;
      if (kk < K) dx[static_cast<long long>(r) * K + kk] = acc.c[i][j];
    }
  }
}

// dw (G, K, N) = x_g^T @ dy_g, x (M, K), dy (M, N): grid (ceil(N/64),
// ceil(K/64)); each block walks the G groups for its (k, n) tile
__global__ void __launch_bounds__(kFThreads)
dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              float* __restrict__ dw, const long long* __restrict__ sizes,
              int M, int K, int N, int G, int accumulate) {
  __shared__ int row_end[repro::kMaxGroups], tile_end[repro::kMaxGroups];
  __shared__ int totals[2];
  __shared__ float As[kR][kT + 1];     // rows x k
  __shared__ float Bs[kR][kT + 1];     // rows x n
  repro::scan_groups(sizes, G, M, kT, row_end, tile_end, totals);
  __syncthreads();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kT, k0 = blockIdx.y * kT;
  const int tx = tid & 15, ty = tid >> 4;
  for (int g = 0; g < G; ++g) {
    const int r0 = g ? row_end[g - 1] : 0, r1 = row_end[g];
    Acc acc;
    acc.zero();
    for (int rb = r0; rb < r1; rb += kR) {
      for (int i = tid; i < kR * kT; i += kFThreads) {
        const int row = i / kT, col = i % kT;
        const int r = rb + row;
        const int kk = k0 + col, nn = n0 + col;
        const bool live = r < r1;
        As[row][col] = (live && kk < K)
            ? x[static_cast<long long>(r) * K + kk] : 0.f;
        Bs[row][col] = (live && nn < N)
            ? dy[static_cast<long long>(r) * N + nn] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < kR; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[r][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc.c[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
    if (accumulate && r1 == r0) continue;   // adding zeros: leave it
    float* dwg = dw + static_cast<long long>(g) * K * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + ty + 16 * i;
      if (kk >= K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n0 + tx + 16 * j;
        if (nn >= N) continue;
        float* p = dwg + static_cast<long long>(kk) * N + nn;
        *p = accumulate ? *p + acc.c[i][j] : acc.c[i][j];
      }
    }
  }
}

// ---- host -------------------------------------------------------------------

bool bad_shape(int M, int K, int N, int G) {
  return M < 1 || K < 1 || N < 1 || G < 1 || G > repro::kMaxGroups ||
         (K + kT - 1) / kT > 65535;
}

int launch_dx_bf16(const void* dy, const void* w, void* dx,
                   const long long* sizes, int M, int K, int N, int G,
                   cudaStream_t s) {
  static bool ready[64] = {};
  static int sms[64] = {};
  int dev = 0;
  const int err = repro::persistent_setup(
      reinterpret_cast<const void*>(dx_bf16_kernel), kXSmem, ready, sms,
      &dev);
  if (err != 0) return err;
  // w's map (box 64 N x 128 K) is cached; dy's changes every call
  CUtensorMap dy_map, w_map;
  if (!repro::encode_map(dy, N, M, 0, 64, 64, &dy_map) ||
      !repro::cached_map(w, N, K, G, 64, kXK, &w_map))
    return static_cast<int>(cudaErrorInvalidValue);
  // more CTAs than the static bound on items would only idle
  const long long bound =
      (static_cast<long long>(M) / kXM + G) * ((K + kXK - 1) / kXK);
  const int grid = static_cast<int>(bound < sms[dev] ? bound : sms[dev]);
  dx_bf16_kernel<<<grid, kThreads, kXSmem, s>>>(
      dy_map, w_map, static_cast<bf16*>(dx), sizes, M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_bf16(const void* x, const void* dy, void* dw,
                   const long long* sizes, int M, int K, int N, int G,
                   int accumulate, cudaStream_t s) {
  static bool ready[64] = {};
  static int sms[64] = {};
  int dev = 0;
  const int err = repro::persistent_setup(
      reinterpret_cast<const void*>(dw_bf16_kernel), kWSmem, ready, sms,
      &dev);
  if (err != 0) return err;
  // dw's map (box 64 N x 128 K) is cached (training hands the stacked
  // leaf's gradient slice, the same pointer every step); x's and dy's
  // change every call
  CUtensorMap x_map, dy_map, out_map;
  if (!repro::encode_map(x, K, M, 0, 64, 64, &x_map) ||
      !repro::encode_map(dy, N, M, 0, 64, 64, &dy_map) ||
      !repro::cached_map(dw, N, K, G, 64, kWK, &out_map))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bound = static_cast<long long>(G) * ((K + kWK - 1) / kWK) *
                          ((N + kWN - 1) / kWN);
  const int grid = static_cast<int>(bound < sms[dev] ? bound : sms[dev]);
  dw_bf16_kernel<<<grid, kThreads, kWSmem, s>>>(
      x_map, dy_map, out_map, sizes, M, K, N, G, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grouped_gemm_dx_launch(const void* dy, const void* w,
                                      void* dx, const void* group_sizes,
                                      int M, int K, int N, int G, int dtype,
                                      void* stream) {
  if (bad_shape(M, K, N, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sizes = static_cast<const long long*>(group_sizes);
  if (dtype == repro::kBFloat16) {
    if (K % 8 != 0 || N % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_dx_bf16(dy, w, dx, sizes, M, K, N, G, s);
  }
  dim3 grid((M + kT - 1) / kT + G, (K + kT - 1) / kT);
  dx_f32_kernel<<<grid, kFThreads, 0, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w),
      static_cast<float*>(dx), sizes, M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grouped_gemm_dw_launch(const void* x, const void* dy,
                                      void* dw, const void* group_sizes,
                                      int M, int K, int N, int G,
                                      int accumulate, int dtype,
                                      void* stream) {
  if (bad_shape(M, K, N, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sizes = static_cast<const long long*>(group_sizes);
  if (dtype == repro::kBFloat16) {
    if (K % 8 != 0 || N % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_dw_bf16(x, dy, dw, sizes, M, K, N, G, accumulate, s);
  }
  dim3 grid((N + kT - 1) / kT, (K + kT - 1) / kT);
  dw_f32_kernel<<<grid, kFThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(dw), sizes, M, K, N, G, accumulate);
  return static_cast<int>(cudaGetLastError());
}
