// Flash-decode GQA attention over a dense KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::flash_decode_pallas.
// q (B, H, hd) with H = KV * G; k/v (B, S, KV, hd); lengths (B,) int32;
// out (B, H, hd).  Positions >= min(lengths[b], S) are masked.
//
// One block per (b, kv_head); the body (decode_attention.cuh) is shared
// with the paged kernel.  The Pallas kernel walks the cache along a
// sequential grid axis with the accumulator in VMEM scratch; here a loop
// inside the block does that, with the accumulator in registers.  The loop
// ends at the valid length, so bytes read are the valid prefix only (the
// bound on an H100: 3.35 TB/s).  B * KV blocks under-fill the 132 SMs at
// small batch; a split over the cache with a second reduction pass is
// later work.
#include "decode_attention.cuh"

namespace {

template <typename T>
__global__ void flash_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int S, int KV, int G,
                                    int hd, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  int len = lengths[b];
  len = len < S ? len : S;               // idle engine slots grow past S
  len = len > 0 ? len : 0;
  repro::decode_body<T>(q, k, v, out, len,
                        repro::DenseRows{static_cast<long long>(b) * S}, KV,
                        G, hd, scale, smem);
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, int B, int S, int KV, int G,
                                   int hd, int dtype, void* stream) {
  const int warps = repro::decode_warps(G, hd);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * repro::decode_smem_floats(G, hd);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  dim3 grid(B, KV);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    flash_decode_kernel<__nv_bfloat16><<<grid, 32 * warps, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), S,
        KV, G, hd, scale);
  } else {
    flash_decode_kernel<float><<<grid, 32 * warps, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(lengths),
        static_cast<float*>(out), S, KV, G, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
