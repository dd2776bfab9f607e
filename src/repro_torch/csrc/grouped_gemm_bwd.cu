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
// new work for this card.
//
// Both read group_sizes on the device as torch.bincount leaves it and
// prefix-scan it in shared memory (group_shrink.cuh); nothing syncs with
// the host.  Scalar FMAs over 64 x 64 output tiles held in registers (4 x 4
// a thread), operands staged in shared memory as float, fp32 accumulation,
// one rounding to the output's type.
//
// What bounds them on an H100 at the training path's shapes (one server:
// G = 128, ~64 live rows a group, K/N = 7168/2048): bytes.  dw writes
// G*K*N values (3.76 GB of bf16 per server tensor) after a reduction over
// only ~64 rows, and dx reads all of w the same way; the FLOPs (2 * rows *
// K * N) would take a quarter of the bytes' time on the tensor cores.  This
// first version runs on the CUDA cores, so the FMAs, not the bytes, set its
// time; wgmma and TMA are later work (ROADMAP Queue 2b).
//
// dx reads w transposed in place (no transposed copy); its blocks walk the
// live 64-row tiles of each group (empty groups own none, the forward's
// group-shrink) and spread the zeroing of the rows past the live ones.  dw
// gives each block one 64 x 64 tile of (K, N) and has it walk every group
// in order: the scan is read once a block, and an empty group's tile is
// written as zeros (or left as it is when accumulating).  With
// `accumulate`, dw adds into what `dw` holds (the stacked leaf's gradient,
// kernels/autograd.py): dw = round(float(dw) + acc).
#include <stdint.h>

#include "common.cuh"
#include "group_shrink.cuh"

namespace {

constexpr int kT = 64;        // output tile edge
constexpr int kR = 32;        // reduction step
constexpr int kThreads = 256;

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ dy, const T* __restrict__ w,
          T* __restrict__ dx, const long long* __restrict__ sizes, int M,
          int K, int N, int G) {
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
        static_cast<long long>(gridDim.x) * gridDim.y * kThreads;
    for (long long i = (static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x) * kThreads + tid;
         i < n; i += nthreads)
      dx[first + i] = repro::from_float<T>(0.f);
  }
  const int t = blockIdx.x;
  if (t >= totals[1]) return;              // dead tile: group-shrink stop
  const repro::RowTile tl = repro::find_tile(t, row_end, tile_end, G, kT);
  const int k0 = blockIdx.y * kT;
  const T* wg = w + static_cast<long long>(tl.g) * K * N;
  const int tx = tid & 15, ty = tid >> 4;
  Acc acc;
  acc.zero();
  for (int n0 = 0; n0 < N; n0 += kR) {
    for (int i = tid; i < kT * kR; i += kThreads) {
      const int row = i / kR, col = i % kR;
      const int r = tl.r0 + row, nn = n0 + col;
      As[row][col] = (r < tl.r1 && nn < N)
          ? repro::to_float(dy[static_cast<long long>(r) * N + nn]) : 0.f;
    }
    for (int i = tid; i < kT * kR; i += kThreads) {
      const int kr = i / kR, col = i % kR;    // consecutive threads: n
      const int kk = k0 + kr, nn = n0 + col;
      Bs[col][kr] = (kk < K && nn < N)
          ? repro::to_float(wg[static_cast<long long>(kk) * N + nn]) : 0.f;
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
      if (kk < K)
        dx[static_cast<long long>(r) * K + kk] =
            repro::from_float<T>(acc.c[i][j]);
    }
  }
}

// dw (G, K, N) = x_g^T @ dy_g, x (M, K), dy (M, N): grid (ceil(N/64),
// ceil(K/64)); each block walks the G groups for its (k, n) tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
          T* __restrict__ dw, const long long* __restrict__ sizes, int M,
          int K, int N, int G, int accumulate) {
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
      for (int i = tid; i < kR * kT; i += kThreads) {
        const int row = i / kT, col = i % kT;
        const int r = rb + row;
        const int kk = k0 + col, nn = n0 + col;
        const bool live = r < r1;
        As[row][col] = (live && kk < K)
            ? repro::to_float(x[static_cast<long long>(r) * K + kk]) : 0.f;
        Bs[row][col] = (live && nn < N)
            ? repro::to_float(dy[static_cast<long long>(r) * N + nn]) : 0.f;
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
    T* dwg = dw + static_cast<long long>(g) * K * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + ty + 16 * i;
      if (kk >= K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n0 + tx + 16 * j;
        if (nn >= N) continue;
        T* p = dwg + static_cast<long long>(kk) * N + nn;
        const float v = accumulate ? repro::to_float(*p) + acc.c[i][j]
                                   : acc.c[i][j];
        *p = repro::from_float<T>(v);
      }
    }
  }
}

bool bad_shape(int M, int K, int N, int G) {
  return M < 1 || K < 1 || N < 1 || G < 1 || G > repro::kMaxGroups ||
         (K + kT - 1) / kT > 65535;
}

}  // namespace

extern "C" int grouped_gemm_dx_launch(const void* dy, const void* w,
                                      void* dx, const void* group_sizes,
                                      int M, int K, int N, int G, int dtype,
                                      void* stream) {
  if (bad_shape(M, K, N, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sizes = static_cast<const long long*>(group_sizes);
  dim3 grid((M + kT - 1) / kT + G, (K + kT - 1) / kT);
  if (dtype == repro::kBFloat16)
    dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(dx), sizes, M, K, N, G);
  else
    dx_kernel<float><<<grid, kThreads, 0, s>>>(
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
  dim3 grid((N + kT - 1) / kT, (K + kT - 1) / kT);
  if (dtype == repro::kBFloat16)
    dw_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dw), sizes, M, K, N, G, accumulate);
  else
    dw_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(dw), sizes, M, K, N, G, accumulate);
  return static_cast<int>(cudaGetLastError());
}
