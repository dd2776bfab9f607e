// Flash-decode GQA attention over a paged KV cache (a shared block pool).
//
// Replaces src/repro/kernels/decode_attention.py::paged_flash_decode_pallas
// (body _paged_kernel = _kernel).  q (B, H, hd) with H = KV * G; k/v pool
// (num_blocks, bs, KV, hd); tables (B, max_blocks) int32; lengths (B,)
// int32; out (B, H, hd); cap > 0 soft-caps the scaled scores as the dense
// kernel does.  Sequence b's position p lives in pool block
// tables[b, p / bs] at offset p % bs; positions >= min(lengths[b],
// max_blocks * bs) are masked (idle engine rows carry length 1 and read
// the scratch block 0).
//
// The Pallas kernel gathers in its index map (grid step (b, kv, s) DMAs
// pool block T[b, s]).  Here the split-KV body of the dense kernel
// (decode_attention.cuh) runs over logical positions, chunk by chunk, and
// only its address policy differs: each of the chunk's 64 slots resolves
// its pool row once, in parallel, reading just the table entries the chunk
// covers (any block size, 12 as well as 16).  The chunks and the summation
// order are thus the dense kernel's, and the output is bitwise equal to it
// over the gathered view.
//
// What bounds it on an H100: the valid K/V bytes (plus q, out, the table
// entries and the lengths) at 3.35 TB/s; ~1 operation per byte.  As for
// the dense kernel, the latency of two launches dominates that bound.
#include "decode_attention.cuh"

namespace {

template <typename T, int HD, int MT>
__global__ void paged_flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ partial, int max_blocks, int bs, int KV, int G,
    int hd, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int cap = max_blocks * bs;
  int len = lengths[b];
  len = len < cap ? len : cap;
  len = len > 0 ? len : 0;
  const int* row = tables + static_cast<long long>(b) * max_blocks;
  repro::decode_split<T, HD, MT>(q, k_pool, v_pool, out, partial, len,
                                 repro::PagedRows{row, bs}, KV, G, hd, scale,
                                 softcap, smem);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int*, const int*,
                        T*, float*, int, int, int, int, int, float, float);

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, void* partial,
           int B, int max_blocks, int bs, int KV, int G, int hd,
           float softcap, cudaStream_t s) {
  const int threads = repro::decode_threads<T>(G, hd);
  Kernel<T> kernel;
  REPRO_PICK_DECODE_KERNEL(paged_flash_decode_kernel, T, hd, G, kernel)
  if (threads == 0 || kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = max_blocks * bs;
  const size_t smem = repro::decode_smem_bytes<T>(G, hd);
  const int nsplit = repro::split_count(cap);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  kernel<<<dim3(B, KV, nsplit), threads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(partial), max_blocks, bs, KV, G, hd, scale,
      softcap);
  err = cudaGetLastError();
  if (err == cudaSuccess && nsplit > 1)
    err = repro::launch_combine<T>(partial, lengths, out, B, KV, G, hd,
                                   nsplit, cap, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int paged_flash_decode_launch(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* tables,
                                         const void* lengths, void* out,
                                         void* partial, int B,
                                         int max_blocks, int bs, int KV,
                                         int G, int hd, float cap,
                                         int dtype, void* stream) {
  if (max_blocks < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out,
                                 partial, B, max_blocks, bs, KV, G, hd, cap,
                                 s);
  return launch<float>(q, k_pool, v_pool, tables, lengths, out, partial, B,
                       max_blocks, bs, KV, G, hd, cap, s);
}
