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
// same kernel, each weight widened as it is loaded into the tile.
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

// ---- float32 rows: scalar FMAs, the same scan ---------------------------
// TW: the weights' type (float, or bf16 widened into the tile)

constexpr int kFM = 32, kFN = 32, kFK = 32, kFThreads = 256;

template <typename TW>
__global__ void __launch_bounds__(kFThreads)
grouped_gemm_f32_kernel(const float* __restrict__ x,
                        const TW* __restrict__ w, float* __restrict__ out,
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

  const TW* wg = w + static_cast<long long>(tl.g) * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  // this thread's two rows: a decode batch's tile holds a row or two of
  // 32, and only threads with a live row run the FMAs
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
          (kr < K && nn < N)
              ? repro::to_float(wg[static_cast<long long>(kr) * N + nn])
              : 0.f;
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
  dim3 grid(M / kFM + G, (N + kFN - 1) / kFN);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (w_dtype == repro::kBFloat16)
    grouped_gemm_f32_kernel<bf16><<<grid, kFThreads, 0, s>>>(
        xf, static_cast<const bf16*>(w), of, sizes, M, K, N, G);
  else
    grouped_gemm_f32_kernel<float><<<grid, kFThreads, 0, s>>>(
        xf, static_cast<const float*>(w), of, sizes, M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}
