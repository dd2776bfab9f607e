// Grouped GEMM with group-shrink: out[i] = x[i] @ w[g(i)] (paper §4.1).
//
// Replaces src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas and the
// padded copy around it (group_shrink.pad_rows_to_tiles / unpad_rows).
// x (M, K) rows sorted by group; w (G, K, N); out (M, N), zeroed by the
// caller so rows past sum(group_sizes) stay 0.  tiles (4, T) int32 is the
// device-side tile table: [group, live, first row, end row] per row tile.
//
// Grid = (T = M / tm + G row tiles) x (N / tn column tiles).  A dead tile
// (empty group or past the live count) returns after one metadata read —
// the paper's early stop — so only the weights of live groups are read.
// The TPU's sequential K grid axis becomes a loop over K: stage the x rows
// of the tile and the w slab in shared memory, accumulate in fp32.
// bfloat16: 64x64x32 tiles, four warps of 2x2 WMMA 16x16x16 fragments, the
// next K slab prefetched into registers during the current products.
// float32: 32x32x32 tiles of scalar FMAs (the exact path for the tests).
// Bound on an H100: the live groups' weight bytes at decode, tensor-core
// operations at prefill; TMA + wgmma + a persistent schedule come later.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;
constexpr int kLda = kBK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int kLdb = kBN + 8;
constexpr int kLdc = kBN + 4;   // floats

__global__ void __launch_bounds__(kThreads)
grouped_gemm_bf16_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w, bf16* __restrict__ out,
                         const int* __restrict__ tiles, int T, int K, int N) {
  const int t = blockIdx.x;
  if (tiles[T + t] == 0) return;           // dead tile: group-shrink stop
  const int g = tiles[t];
  const int r0 = tiles[2 * T + t];
  const int r1 = tiles[3 * T + t];
  const int n0 = blockIdx.y * kBN;

  __shared__ __align__(128) bf16 As[kBM * kLda];
  __shared__ __align__(128) bf16 Bs[kBK * kLdb];
  __shared__ __align__(128) float Cs[kBM * kLdc];

  const bf16* wg = w + static_cast<long long>(g) * K * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;         // warp's 32x32 quadrant
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // 16-byte vectors: A slab 64x32 = 256 vectors, B slab 32x64 = 256
  // vectors, two of each per thread.  K and N are multiples of 8, so a
  // vector is wholly inside or wholly outside the matrix.
  uint4 ra[2], rb[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int ar = v >> 2, ac = (v & 3) * 8;
      const int r = r0 + ar, kk = k0 + ac;
      ra[i] = (r < r1 && kk < K)
                  ? *reinterpret_cast<const uint4*>(
                        x + static_cast<long long>(r) * K + kk)
                  : zero;
      const int br = v >> 3, bc = (v & 7) * 8;
      const int kr = k0 + br, nn = n0 + bc;
      rb[i] = (kr < K && nn < N)
                  ? *reinterpret_cast<const uint4*>(
                        wg + static_cast<long long>(kr) * N + nn)
                  : zero;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(As + (v >> 2) * kLda + (v & 3) * 8) = ra[i];
      *reinterpret_cast<uint4*>(Bs + (v >> 3) * kLdb + (v & 7) * 8) = rb[i];
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    store();
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);      // next slab in flight
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * kLda + kk, kLda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdb + wn + 16 * j, kLdb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLdc + wn + 16 * j,
                              acc[i][j], kLdc, wmma::mem_row_major);
  __syncthreads();

  // 64x64 outputs as 512 vectors of 8, four per thread; only rows of the
  // tile's own range are written
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tid + i * kThreads;
    const int row = v >> 3, col = (v & 7) * 8;
    const int r = r0 + row, nn = n0 + col;
    if (r < r1 && nn < N) {
      union {
        uint4 u;
        __nv_bfloat162 h[4];
      } pk;
      const float* c = Cs + row * kLdc + col;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pk.h[q] = __floats2bfloat162_rn(c[2 * q], c[2 * q + 1]);
      *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * N + nn) =
          pk.u;
    }
  }
}

constexpr int kFM = 32, kFN = 32, kFK = 32, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
grouped_gemm_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        const int* __restrict__ tiles, int T, int K, int N) {
  const int t = blockIdx.x;
  if (tiles[T + t] == 0) return;           // dead tile: group-shrink stop
  const int g = tiles[t];
  const int r0 = tiles[2 * T + t];
  const int r1 = tiles[3 * T + t];
  const int n0 = blockIdx.y * kFN;

  __shared__ float As[kFM][kFK + 1];
  __shared__ float Bs[kFK][kFN + 1];
  const float* wg = w + static_cast<long long>(g) * K * N;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
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
#pragma unroll 8
    for (int kk = 0; kk < kFK; ++kk) {
      const float a0 = As[ty][kk], a1 = As[ty + 16][kk];
      const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
      c[0][0] += a0 * b0;
      c[0][1] += a0 * b1;
      c[1][0] += a1 * b0;
      c[1][1] += a1 * b1;
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

}  // namespace

extern "C" int grouped_gemm_launch(const void* x, const void* w, void* out,
                                   const void* tiles, int T, int K, int N,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    dim3 grid(T, (N + kBN - 1) / kBN);
    grouped_gemm_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), static_cast<const int*>(tiles), T, K, N);
  } else {
    dim3 grid(T, (N + kFN - 1) / kFN);
    grouped_gemm_f32_kernel<<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), static_cast<const int*>(tiles), T, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
