// Flash-decode GQA attention over a paged KV cache (a shared block pool).
//
// Replaces src/repro/kernels/decode_attention.py::paged_flash_decode_pallas
// (body _paged_kernel = _kernel).  q (B, H, hd) with H = KV * G; k/v pool
// (num_blocks, bs, KV, hd); tables (B, max_blocks) int32; lengths (B,)
// int32; out (B, H, hd).  Sequence b's position p lives in pool block
// tables[b, p / bs] at offset p % bs; positions >= min(lengths[b],
// max_blocks * bs) are masked (idle engine rows carry length 1 and read
// the scratch block 0).
//
// The Pallas kernel gathers in its index map (grid step (b, kv, s) DMAs
// pool block T[b, s]).  Here each block first stages its table row in
// shared memory, then walks logical positions in the dense kernel's
// 32-slot tiles, resolving each slot's address through the row.  The
// summation order is thus the dense kernel's, and the output is bitwise
// equal to it over the gathered view, for any block size.
//
// What bounds it on an H100: the valid K/V bytes (plus q, out and the
// table row) at 3.35 TB/s; ~1 operation per byte.  Like the dense kernel
// it runs B * KV blocks, which under-fill the 132 SMs at decode batch
// sizes; split-KV is later work.
#include "decode_attention.cuh"

namespace {

template <typename T>
__global__ void paged_flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int max_blocks,
    int bs, int KV, int G, int hd, float scale) {
  extern __shared__ float smem[];
  int* table = reinterpret_cast<int*>(smem);      // max_blocks ints
  const int b = blockIdx.x;
  const int* row = tables + static_cast<long long>(b) * max_blocks;
  for (int i = threadIdx.x; i < max_blocks; i += blockDim.x) {
    table[i] = row[i];
  }
  // visible to the whole block after the body's first __syncthreads,
  // which precedes the first read of the table
  const int cap = max_blocks * bs;
  int len = lengths[b];
  len = len < cap ? len : cap;
  len = len > 0 ? len : 0;
  repro::decode_body<T>(q, k_pool, v_pool, out, len,
                        repro::PagedRows{table, bs}, KV, G, hd, scale,
                        smem + max_blocks);
}

}  // namespace

extern "C" int paged_flash_decode_launch(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* tables,
                                         const void* lengths, void* out,
                                         int B, int max_blocks, int bs,
                                         int KV, int G, int hd, int dtype,
                                         void* stream) {
  const int warps = repro::decode_warps(G, hd);
  if (warps == 0 || max_blocks < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (max_blocks + repro::decode_smem_floats(G, hd));
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  dim3 grid(B, KV);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    paged_flash_decode_kernel<__nv_bfloat16><<<grid, 32 * warps, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(tables), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), max_blocks, bs, KV, G, hd, scale);
  } else {
    paged_flash_decode_kernel<float><<<grid, 32 * warps, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), static_cast<const int*>(tables),
        static_cast<const int*>(lengths), static_cast<float*>(out),
        max_blocks, bs, KV, G, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
