// Top-k combine: out[t, :] = sum_k w[t, k] * x[t, k, :], fp32 accumulation.
//
// Replaces src/repro/kernels/combine.py::combine_weighted_pallas.  Bound by
// bytes: each element of x is read once and used for 2 operations.  Grid =
// (T) x (chunks of d); one thread per output element, so a warp reads 32
// neighbouring elements of each partial row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void combine_weighted_kernel(const T* __restrict__ x,
                                        const float* __restrict__ w,
                                        T* __restrict__ out, int k, int d) {
  const int t = blockIdx.x;
  const long long row = static_cast<long long>(t) * k;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < d;
       i += gridDim.y * blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      acc += w[row + j] * repro::to_float(x[(row + j) * d + i]);
    }
    out[static_cast<long long>(t) * d + i] = repro::from_float<T>(acc);
  }
}

}  // namespace

extern "C" int combine_weighted_launch(const void* x, const void* w,
                                       void* out, int T, int k, int d,
                                       int dtype, void* stream) {
  const int chunks = (d + kThreads - 1) / kThreads;
  dim3 grid(T, chunks < 65535 ? chunks : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    combine_weighted_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), k, d);
  } else {
    combine_weighted_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), k, d);
  }
  return static_cast<int>(cudaGetLastError());
}
