// Flash-decode GQA attention over a dense KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::flash_decode_pallas.
// q (B, H, hd) with H = KV * G; k/v (B, S, KV, hd); lengths (B,) int32;
// out (B, H, hd).  Positions >= min(lengths[b], S) are masked.
//
// One block per (b, kv_head).  The Pallas kernel walks the cache along a
// sequential grid axis with the accumulator in VMEM scratch; here a loop
// inside the block does that, with the accumulator in registers.  Warp w
// owns query heads g = w, w + nwarps, ... (at most kMaxHeadsPerWarp).  Per
// 32-slot tile: stage K and V in shared memory (fp32), lane s scores slot
// s, warp shuffles give the tile max and sum, and each lane updates the
// output dims d = lane + 32 j.  The loop ends at the valid length, so
// bytes read are the valid prefix only (the bound on an H100: 3.35 TB/s).
// B * KV blocks under-fill the 132 SMs at small batch; a split over the
// cache with a second reduction pass is later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;           // slots per tile: one per lane
constexpr int kMaxDimsPerLane = 4;  // hd <= 128
constexpr int kMaxHeadsPerWarp = 4; // G <= 32 with 8 warps
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void flash_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int S, int KV, int G,
                                    int hd, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // G * hd
  float* ks = qs + G * hd;               // kTile * (hd + 1), padded rows
  float* vs = ks + kTile * (hd + 1);     // kTile * hd

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  int len = lengths[b];
  len = len < S ? len : S;               // idle engine slots grow past S
  len = len > 0 ? len : 0;

  const long long q_base = (static_cast<long long>(b) * KV + h) * G * hd;
  for (int i = tid; i < G * hd; i += nthreads) {
    qs[i] = repro::to_float(q[q_base + i]);
  }

  float m[kMaxHeadsPerWarp], l[kMaxHeadsPerWarp];
  float acc[kMaxHeadsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kMaxDimsPerLane; ++dd) acc[j][dd] = 0.f;
  }

  for (int s0 = 0; s0 < len; s0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int i = tid; i < kTile * hd; i += nthreads) {
      const int s = i / hd;
      const int d = i - s * hd;
      const int pos = s0 + s;
      float kv_k = 0.f, kv_v = 0.f;
      if (pos < len) {
        const long long off =
            ((static_cast<long long>(b) * S + pos) * KV + h) * hd + d;
        kv_k = repro::to_float(k[off]);
        kv_v = repro::to_float(v[off]);
      }
      ks[s * (hd + 1) + d] = kv_k;
      vs[s * hd + d] = kv_v;
    }
    __syncthreads();

    const bool valid = s0 + lane < len;
#pragma unroll
    for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
      const int g = warp + j * nwarps;   // uniform across the warp
      if (g >= G) break;
      float score = -INFINITY;
      if (valid) {
        float dot = 0.f;
        const float* qg = qs + g * hd;
        const float* kr = ks + lane * (hd + 1);
        for (int d = 0; d < hd; ++d) dot += qg[d] * kr[d];
        score = dot * scale;
      }
      // every tile holds slot s0 < len, so m_new is finite
      const float m_new = fmaxf(m[j], warp_max(score));
      const float p = valid ? expf(score - m_new) : 0.f;
      const float alpha = expf(m[j] - m_new);
      l[j] = l[j] * alpha + warp_sum(p);
#pragma unroll
      for (int dd = 0; dd < kMaxDimsPerLane; ++dd) acc[j][dd] *= alpha;
      for (int s = 0; s < kTile; ++s) {
        const float ps = __shfl_sync(kFull, p, s);
#pragma unroll
        for (int dd = 0; dd < kMaxDimsPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (d < hd) acc[j][dd] += ps * vs[s * hd + d];
        }
      }
      m[j] = m_new;
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    const int g = warp + j * nwarps;
    if (g >= G) break;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kMaxDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd) {
        out[q_base + static_cast<long long>(g) * hd + d] =
            repro::from_float<T>(acc[j][dd] * inv);
      }
    }
  }
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, int B, int S, int KV, int G,
                                   int hd, int dtype, void* stream) {
  const int warps = G < 8 ? G : 8;
  if (hd > 32 * kMaxDimsPerLane || (G + warps - 1) / warps > kMaxHeadsPerWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (G * hd + kTile * (hd + 1) + kTile * hd);
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
