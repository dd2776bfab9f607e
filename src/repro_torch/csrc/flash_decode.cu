// Flash-decode GQA attention over a dense KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::flash_decode_pallas.
// q (B, H, hd) with H = KV * G; k/v (B, S, KV, hd); lengths (B,) int32;
// out (B, H, hd).  Positions >= min(lengths[b], S) are masked; cap > 0
// soft-caps the scaled scores (cap * tanh(s / cap)) first.  A sliding-window
// layer's ring cache (S = window slots, written at length % S) is read as
// it is: keys are cached rotated, so the slot order does not matter, and
// min(length, S) is the ring's valid count.
//
// Split-KV flash-decoding (decode_attention.cuh, shared with the paged
// kernel): grid (B, KV, ceil(S / kSplit)) blocks each attend over one
// 64-position chunk, then decode_combine_kernel merges the chunks in split
// order.  The Pallas kernel walks the cache along a sequential grid axis
// with the accumulator in VMEM scratch; on the card that axis is cut into
// independent chunks, so the small decode batch still fills the SMs.
//
// What bounds it on an H100: the K/V bytes of the valid prefix at 3.35
// TB/s (~1 operation per byte), ~0.002 ms at the deepseek-r1 decode shape
// — far below two launches' latency, which is what the split and the
// 16-byte cp.async loads fight: 64 blocks that each walked up to 17 tiles
// in turn become ~300 blocks of at most two tiles, loaded at once.
#include "decode_attention.cuh"

namespace {

template <typename T, int HD, int MT>
__global__ void flash_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out,
                                    float* __restrict__ partial, int S,
                                    int KV, int G, int hd, float scale,
                                    float cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  int len = lengths[b];
  len = len < S ? len : S;               // idle engine slots grow past S
  len = len > 0 ? len : 0;
  repro::decode_split<T, HD, MT>(q, k, v, out, partial, len,
                                 repro::DenseRows{b * S}, KV, G, hd, scale,
                                 cap, smem);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int*, T*, float*,
                        int, int, int, int, float, float);

// out == nullptr with m / l: the partial entry (pass 1 always writes
// partials; pass 2 merges them into acc = out_acc, m, l).
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* partial, int B, int S, int KV, int G, int hd,
           float cap, cudaStream_t s, void* acc = nullptr,
           float* m = nullptr, float* l = nullptr) {
  const int threads = repro::decode_threads<T>(G, hd);
  Kernel<T> kernel;
  REPRO_PICK_DECODE_KERNEL(flash_decode_kernel, T, hd, G, kernel)
  if (threads == 0 || kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::decode_smem_bytes<T>(G, hd);
  const int nsplit = repro::split_count(S);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  kernel<<<dim3(B, KV, nsplit), threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(partial), S, KV, G, hd,
      scale, cap);
  err = cudaGetLastError();
  if (err == cudaSuccess && acc != nullptr)
    err = repro::launch_combine<T>(partial, lengths, acc, B, KV, G, hd,
                                   nsplit, S, s, m, l);
  else if (err == cudaSuccess && nsplit > 1)
    err = repro::launch_combine<T>(partial, lengths, out, B, KV, G, hd,
                                   nsplit, S, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* partial, int B, int S,
                                   int KV, int G, int hd, float cap,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, partial, B, S, KV, G,
                                 hd, cap, s);
  return launch<float>(q, k, v, lengths, out, partial, B, S, KV, G, hd, cap,
                       s);
}

// The partial entry (sequence-parallel decode over a cache shard): acc
// (B, H, hd) fp32, unnormalised; m, l (B, H) fp32 in natural-exp units
// (see decode_attention.cuh).  `partial` holds B * KV * split_count(S) * G
// * (hd + 2) floats, one split included.
extern "C" int flash_decode_partial_launch(const void* q, const void* k,
                                           const void* v,
                                           const void* lengths, void* acc,
                                           void* m, void* l, void* partial,
                                           int B, int S, int KV, int G,
                                           int hd, float cap, int dtype,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, lengths, nullptr, partial, B, S,
                                 KV, G, hd, cap, s, acc, mf, lf);
  return launch<float>(q, k, v, lengths, nullptr, partial, B, S, KV, G, hd,
                       cap, s, acc, mf, lf);
}
