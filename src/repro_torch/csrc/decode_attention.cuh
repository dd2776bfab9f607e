// The one-token GQA attention body shared by the dense and the paged
// flash-decode kernels (as the reference's _paged_kernel calls _kernel).
//
// One block per (b, kv_head), holding that KV head's G query heads; warp w
// owns query heads g = w, w + nwarps, ... (at most kMaxHeadsPerWarp).  A
// loop over logical positions in 32-slot tiles stages K and V in shared
// memory (fp32), lane s scores slot s, warp shuffles give the tile max and
// sum, and each lane updates the output dims d = lane + 32 j, with the fp32
// accumulator in registers.  The loop ends at the valid length, so only
// the valid prefix is read.
//
// The two kernels differ only in where position `pos` lives: a `Rows`
// policy maps it to a row of the (rows, KV, hd) K/V array.  The arithmetic
// and its order are the same for both, so a paged call is bitwise equal to
// the dense kernel over the gathered view.
#pragma once

#include <math.h>

#include "common.cuh"

namespace repro {

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

// Dense cache (B, S, KV, hd): sequence b's position pos is row b * S + pos.
struct DenseRows {
  long long first;
  __device__ __forceinline__ long long operator()(int pos) const {
    return first + pos;
  }
};

// Block pool (num_blocks, bs, KV, hd): position pos is at pool block
// table[pos / bs], offset pos % bs.  `table` is the sequence's table row,
// staged in shared memory by the kernel.
struct PagedRows {
  const int* table;
  int bs;
  __device__ __forceinline__ long long operator()(int pos) const {
    return static_cast<long long>(table[pos / bs]) * bs + pos % bs;
  }
};

// Workspace floats the body needs in shared memory.
__host__ __device__ inline int decode_smem_floats(int G, int hd) {
  return G * hd + kTile * (hd + 1) + kTile * hd;
}

// Attention of block (b, h) over positions [0, len); `smem` holds
// decode_smem_floats(G, hd) floats.  Every thread of the block calls it.
template <typename T, typename Rows>
__device__ __forceinline__ void decode_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int len, Rows rows,
    int KV, int G, int hd, float scale, float* smem) {
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

  const long long q_base = (static_cast<long long>(b) * KV + h) * G * hd;
  for (int i = tid; i < G * hd; i += nthreads) {
    qs[i] = to_float(q[q_base + i]);
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
    __syncthreads();  // previous tile consumed (and q, table staged)
    for (int i = tid; i < kTile * hd; i += nthreads) {
      const int s = i / hd;
      const int d = i - s * hd;
      const int pos = s0 + s;
      float kv_k = 0.f, kv_v = 0.f;
      if (pos < len) {
        const long long off = (rows(pos) * KV + h) * hd + d;
        kv_k = to_float(k[off]);
        kv_v = to_float(v[off]);
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
            from_float<T>(acc[j][dd] * inv);
      }
    }
  }
}

// Warps per block for G query heads, or 0 when the body cannot take them.
inline int decode_warps(int G, int hd) {
  const int warps = G < 8 ? G : 8;
  if (warps < 1 || hd > 32 * kMaxDimsPerLane ||
      (G + warps - 1) / warps > kMaxHeadsPerWarp)
    return 0;
  return warps;
}

}  // namespace repro
