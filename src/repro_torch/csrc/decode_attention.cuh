// The one-token GQA attention shared by the dense and the paged
// flash-decode kernels (as the reference's _paged_kernel calls _kernel):
// split-KV flash-decoding, in two passes.
//
// Pass 1, grid (B, KV, num_splits): block (b, h, z) owns the G query heads
// of KV head h and the chunk of logical positions [z*kSplit, (z+1)*kSplit)
// of sequence b.  A chunk that starts at or past the sequence's clamped
// length returns at once.  The split is a constant number of positions, so
// the boundaries, and with them the summation order, depend on the
// position only: the paged kernel stays bitwise equal to the dense kernel
// over the gathered view.
//   - Addresses: the threads each resolve a valid slot's K/V row (a
//     `Rows` policy: b*S + pos dense, table[pos/bs]*bs + pos%bs paged) into
//     shared memory, reading only the table entries the chunk covers; the
//     loads below then add no divide and no table read.
//   - Loads: q and the chunk's two 32-slot tiles of K and V go to shared
//     memory with 16-byte cp.async, all issued at once (a double buffer);
//     tile 1 lands while tile 0 is scored, so a block waits on one memory
//     round trip.  Tiles stay in the cache's element type; rows are padded
//     by 16 bytes (conflict-free fragment loads); slots past the length are
//     zero-filled.  Any hd <= 256 is taken: a row is staged hdp wide (hd
//     rounded up to the mma's k of 16 in bf16 -- to 32 past 128 -- and to 8
//     in fp32) with the columns past hd zero, and when rows are not 16-byte
//     multiples (or a base is not 16-byte aligned) the same tiles are
//     staged element by element instead.
//   - bfloat16 (the serving path): one warp per chunk on tensor cores.  G =
//     16 query heads are exactly the M of mma.sync.m16n8k16: the scores
//     (16 x hdp) . (hdp x 32) are 16 mma per tile at hd = 64, and P V
//     another 32: P stays fp32 as in the reference, passed from the score
//     fragments as two bf16 A fragments, hi = bf16(P) and lo = bf16(P -
//     hi) (P to ~2^-17), V (bf16 already) through ldmatrix.trans.  An FMA
//     body spent ~1,500 warp instructions a tile on conversions, shuffles
//     and shared loads around 256 FMAs and was bound by instruction issue.
//     Heads past G are zero rows of the tile (G <= 16: one m16 tile, else
//     two).  Past a staged width of 128 (gemma3's hd = 256) the block has
//     two warps: both score the whole row (the same instructions, so the
//     same m and l), and each owns half of the output columns in P V, so
//     a warp's accumulator stays the size of the hd = 128 one.
//   - float32 (the exact path of the tests): the same chunks on FMAs, warp
//     w owning heads w, w + nwarps, ..., lane s scoring slot s; tensor
//     cores would take it to TF32 and break the 1e-5 tolerance.
//   - Softcap (cap > 0, gemma-style): a scaled score s becomes
//     cap * tanh(s / cap) before the mask, as the reference's
//     decode_attention applies it; cap = 0 leaves the scores as they were.
//   - With one split the block normalises and writes the output; else it
//     writes the unnormalised partial (acc[G, hd], m[G], l[G]) in fp32.
//     Called with out == nullptr (the partial entry, flash_decode_partial
//     in flash_decode.cu) it writes the partial with one split too.
// Pass 2 (decode_combine_kernel), grid (B*KV): merges the live partials of
// each (b, h) in a fixed order — no atomics, so runs are bitwise
// repeatable.  It is launched as a programmatic dependent of pass 1, so its
// launch overlaps pass 1 and it waits only for pass 1's results.  A chunk
// is live only if it holds a valid slot, so every live m is finite and no
// exp(-inf - -inf) arises; a length of 0 gives a zero output.  Its PARTIAL
// form (decode_partial_combine) writes the merged partial itself instead:
// acc = sum_z exp(m_z - M) acc_z (unnormalised, fp32), m = M, l = sum_z
// exp(m_z - M) l_z in natural-exp units, as a sequence-parallel shard's
// contribution to a cross-shard softmax; a shard with no valid slot gives
// acc = 0, l = 0 and m = -1e30, which weighs 0 in the cross-shard combine
// (and never makes a NaN there).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kTile = 32;             // slots per tile
constexpr int kSplit = 64;            // logical positions per chunk
constexpr int kTilesPerSplit = kSplit / kTile;
constexpr int kMaxDimPairs = 4;       // fp32: lane owns dims 2l, 2l+1 (+64k)
constexpr int kMaxHeadsPerWarp = 4;   // fp32: G <= 32 with 8 warps
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTilesPerSplit == 2, "the body double-buffers two tiles");

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
  int first;
  __device__ __forceinline__ int operator()(int pos) const {
    return first + pos;
  }
};

// Block pool (num_blocks, bs, KV, hd): position pos is at pool block
// table[pos / bs], offset pos % bs; `table` is the sequence's row of the
// block tables in device memory.
struct PagedRows {
  const int* table;
  int bs;
  __device__ __forceinline__ int operator()(int pos) const {
    const int blk = pos / bs;
    return __ldg(table + blk) * bs + (pos - blk * bs);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;       // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight consecutive fp32 elements from shared memory.
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Staged row width: hd rounded up to the bf16 mma's k (16; past 128 to 32,
// so that each of the two warps owns a multiple of 16 columns), or to the
// fp32 body's 8-wide loads; the columns past hd are zero.
template <typename T>
__host__ __device__ inline int padded_hd(int hd) {
  const int w = sizeof(T) == 2 ? (hd > 128 ? 32 : 16) : 8;
  return (hd + w - 1) / w * w;
}

// Scaled score, soft-capped when cap > 0.
__device__ __forceinline__ float cap_score(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// Row stride of a staged q row or K/V tile row, in elements: the padded
// width + 16 bytes.
template <typename T>
__host__ __device__ inline int tile_ld(int hd) {
  return padded_hd<T>(hd) + 16 / static_cast<int>(sizeof(T));
}

// Query rows staged: G (fp32), G rounded up to the m16 tiles (bf16).
template <typename T>
__host__ __device__ inline int q_rows(int G) {
  return sizeof(T) == 2 ? (G <= 16 ? 16 : 32) : G;
}

// Shared memory bytes the split body needs.
template <typename T>
__host__ __device__ inline int decode_smem_bytes(int G, int hd) {
  return kSplit * 4 + (q_rows<T>(G) + kTilesPerSplit * 2 * kTile) *
                          tile_ld<T>(hd) * static_cast<int>(sizeof(T));
}

// Columns d and d + 1 of a row of hd, those below hd (hd may be odd).
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int d, int hd, float x,
                                           float y) {
  if (d < hd) row[d] = from_float<T>(x);
  if (d + 1 < hd) row[d + 1] = from_float<T>(y);
}

// The chunk a block owns, staged: returns false for a dead chunk (after
// writing the zero output of a length-0 sequence when there is one split);
// else stages q (rows past G zero) and the slot rows, issues one cp.async
// group per tile of K and V, and sets c0, c1 and the number of tiles.
template <typename T, typename Rows>
__device__ __forceinline__ bool stage_chunk(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int len, Rows rows,
    int KV, int G, int hd, unsigned char* smem, int& c0, int& c1,
    int& n_tiles) {
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long q_base =
      (static_cast<long long>(blockIdx.x) * KV + h) * G * hd;
  // let the merge pass launch now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  c0 = blockIdx.z * kSplit;
  if (c0 >= len) {                    // dead chunk
    if (gridDim.z == 1 && out != nullptr) {   // len == 0: the output is 0
      for (int i = tid; i < G * hd; i += nthreads)
        out[q_base + i] = from_float<T>(0.f);
    }
    return false;
  }
  c1 = min(len, c0 + kSplit);
  const int hdp = padded_hd<T>(hd);
  const int ld = tile_ld<T>(hd);
  const int nq = q_rows<T>(G);
  int* srow = reinterpret_cast<int*>(smem);
  T* qs = reinterpret_cast<T*>(srow + kSplit);
  T* tiles = qs + nq * ld;
  const T zero = from_float<T>(0.f);

  // columns [hd, hdp) of every staged row (q, then the tiles) are zero
  if (hdp > hd) {
    const int pw = hdp - hd;
    for (int i = tid; i < (nq + kTilesPerSplit * 2 * kTile) * pw;
         i += nthreads)
      qs[(i / pw) * ld + hd + i % pw] = zero;
  }
  // 16-byte copies need 16-byte rows and bases; else element by element
  const int vec = 16 / static_cast<int>(sizeof(T));
  const bool wide =
      hd % vec == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int per_row = wide ? hd / vec : hd;

  // q rides in the first cp.async group, with tile 0
  for (int i = tid; i < nq * per_row; i += nthreads) {
    const int r = i / per_row, c = i - r * per_row;
    if (wide) {
      cp_async16(qs + r * ld + c * vec,
                 q + q_base + (r < G ? r * hd + c * vec : 0), r < G);
    } else {
      qs[r * ld + c] = r < G ? q[q_base + r * hd + c] : zero;
    }
  }
  for (int s = tid; s < c1 - c0; s += nthreads) srow[s] = rows(c0 + s);
  __syncthreads();

  n_tiles = (c1 - c0 + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    T* ks = tiles + (2 * t) * kTile * ld;
    T* vs = ks + kTile * ld;
    for (int i = tid; i < kTile * per_row; i += nthreads) {
      const int s = i / per_row;
      const int c = i - s * per_row;
      const int e = wide ? c * vec : c;
      const int slot = t * kTile + s;
      const bool ok = c0 + slot < c1;
      const long long off =
          ok ? (static_cast<long long>(srow[slot]) * KV + h) * hd + e : 0;
      if (wide) {
        cp_async16(ks + s * ld + e, k + off, ok);
        cp_async16(vs + s * ld + e, v + off, ok);
      } else {
        ks[s * ld + e] = ok ? k[off] : zero;
        vs[s * ld + e] = ok ? v[off] : zero;
      }
    }
    cp_async_commit();
  }
  return true;
}

// ---- bfloat16 body: mma.sync, one warp per chunk -----------------------

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16(x - hi, y - hi):
// hi + lo carries x and y to ~2^-17 of their size.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warps of a bf16 block: one up to a staged width of 128, else two, each
// owning HD / 2 output columns.
template <int HD>
__host__ __device__ constexpr int mma_warps() {
  return HD > 128 ? 2 : 1;
}

// Fragment rows of lane (gq, tq): g = gq and gq + 8 of each m16 tile;
// columns 2 tq, 2 tq + 1 of each 8-wide n tile.  HD is the staged width
// (padded_hd(hd)); columns at or past hd are computed but not written.
template <int HD, int MT, typename Rows>
__device__ __forceinline__ void decode_split_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ partial, int len, Rows rows, int KV, int G, int hd,
    float scale, float cap, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = HD + 8;
  constexpr int NW = mma_warps<HD>();
  constexpr int NT = HD / NW / 8;     // n tiles of this warp's output
  static_assert(NT % 2 == 0, "P V loads two n tiles per ldmatrix");
  int c0, c1, n_tiles;
  if (!stage_chunk<bf16>(q, k, v, out, len, rows, KV, G, hd, smem, c0, c1,
                         n_tiles))
    return;
  const int lane = threadIdx.x & 31;
  const int col0 = (threadIdx.x >> 5) * (HD / NW);   // this warp's columns
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* qs = reinterpret_cast<const bf16*>(smem + kSplit * 4);
  const bf16* tiles = qs + MT * 16 * LD;

  float o[MT][NT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[mt][j][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
    // tile t (and q) visible to all lanes (both warps issued its copies)
    if constexpr (NW > 1) __syncthreads(); else __syncwarp();
    const bf16* ks = tiles + (2 * t) * kTile * LD;
    const bf16* vs = ks + kTile * LD;
    const int nvalid = c1 - (c0 + t * kTile);    // >= 1

    // S = Q K^T: 4 n tiles of 8 slots
    float sc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[mt][nn][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* qr = qs + (mt * 16 + gq) * LD + kk * 16 + 2 * tq;
        a[mt][0] = lds32(qr);
        a[mt][1] = lds32(qr + 8 * LD);
        a[mt][2] = lds32(qr + 8);
        a[mt][3] = lds32(qr + 8 * LD + 8);
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const bf16* kr = ks + (8 * nn + gq) * LD + kk * 16 + 2 * tq;
        const uint32_t b0 = lds32(kr), b1 = lds32(kr + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(sc[mt][nn], a[mt], b0, b1);
      }
    }

    // online softmax per row; a row's 32 scores sit in one lane quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool ok = 8 * nn + 2 * tq + c < nvalid;
            float& x = sc[mt][nn][2 * r + c];
            x = ok ? cap_score(x * scale, cap) : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx);   // slot 0 is valid
        const float alpha = expf(m[mt][r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[mt][nn][2 * r + c];
            x = expf(x - m_new);              // 0 past the length
            sum += x;
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        l[mt][r] = l[mt][r] * alpha + sum;
        m[mt][r] = m_new;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[mt][j][2 * r] *= alpha;
          o[mt][j][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V: P's score fragments are A fragments (hi and lo parts);
    // V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* p = sc[mt][2 * kk + (f >> 1)] + 2 * (f & 1);
          split_bf16(p[0], p[1], a[mt][f], a_lo[mt][f]);
        }
      }
      const int mat = lane >> 3, i = lane & 7;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const bf16* vr = vs + (16 * kk + (mat & 1) * 8 + i) * LD + col0 +
                         8 * (j + (mat >> 1));
        uint32_t b[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
            : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(vr))));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(o[mt][j], a[mt], b[0], b[1]);
          mma16816(o[mt][j], a_lo[mt], b[0], b[1]);
          mma16816(o[mt][j + 1], a[mt], b[2], b[3]);
          mma16816(o[mt][j + 1], a_lo[mt], b[2], b[3]);
        }
      }
    }
  }

  const int nsplit = gridDim.z;
  const long long bh = static_cast<long long>(blockIdx.x) * KV + blockIdx.y;
  const long long prow = (bh * nsplit + blockIdx.z) * G;
  const long long ml_base =
      static_cast<long long>(gridDim.x) * KV * nsplit * G * hd;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = mt * 16 + gq + 8 * r;
      if (g >= G) continue;
      if (nsplit == 1 && out != nullptr) {
        const float inv = 1.f / fmaxf(l[mt][r], 1e-30f);
        __nv_bfloat16* orow = out + (bh * G + g) * hd;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store_pair(orow, col0 + 8 * j + 2 * tq, hd, o[mt][j][2 * r] * inv,
                     o[mt][j][2 * r + 1] * inv);
      } else {
        float* pa = partial + (prow + g) * hd;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          store_pair(pa, col0 + 8 * j + 2 * tq, hd, o[mt][j][2 * r],
                     o[mt][j][2 * r + 1]);
        if (tq == 0 && col0 == 0) {
          partial[ml_base + 2 * (prow + g)] = m[mt][r];
          partial[ml_base + 2 * (prow + g) + 1] = l[mt][r];
        }
      }
    }
  }
}

// ---- float32 body: FMAs --------------------------------------------------

template <typename Rows>
__device__ __forceinline__ void decode_split_fma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ partial, int len, Rows rows, int KV, int G, int hd,
    float scale, float cap, unsigned char* smem) {
  int c0, c1, n_tiles;
  if (!stage_chunk<float>(q, k, v, out, len, rows, KV, G, hd, smem, c0, c1,
                          n_tiles))
    return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ld = tile_ld<float>(hd);
  const float* qs = reinterpret_cast<const float*>(smem + kSplit * 4);
  const float* tiles = qs + G * ld;

  const int nh = (G - warp + nwarps - 1) / nwarps;   // heads of this warp
  float m[kMaxHeadsPerWarp], l[kMaxHeadsPerWarp];
  float acc[kMaxHeadsPerWarp][2 * kMaxDimPairs];
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int dd = 0; dd < 2 * kMaxDimPairs; ++dd) acc[j][dd] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                  // tile t (and q) visible to all warps
    const float* ks = tiles + (2 * t) * kTile * ld;
    const float* vs = ks + kTile * ld;
    const int s0 = c0 + t * kTile;
    const int ns = min(kTile, c1 - s0);   // valid slots, >= 1
    const bool valid = lane < ns;

    float dot[kMaxHeadsPerWarp];
#pragma unroll
    for (int j = 0; j < kMaxHeadsPerWarp; ++j) dot[j] = 0.f;
    const float* kr = ks + lane * ld;
    for (int d = 0; d < hd; d += 8) {
      float kf[8];
      load8(kr + d, kf);
#pragma unroll
      for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
        if (j < nh) {
          float qf[8];
          load8(qs + (warp + j * nwarps) * ld + d, qf);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[j] += qf[e] * kf[e];
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
      if (j >= nh) break;             // uniform across the warp
      const float score = valid ? cap_score(dot[j] * scale, cap) : -INFINITY;
      // slot s0 < len, so m_new is finite
      const float m_new = fmaxf(m[j], warp_max(score));
      const float p = valid ? expf(score - m_new) : 0.f;
      const float alpha = expf(m[j] - m_new);
      l[j] = l[j] * alpha + warp_sum(p);
#pragma unroll
      for (int dd = 0; dd < 2 * kMaxDimPairs; ++dd) acc[j][dd] *= alpha;
      for (int s = 0; s < ns; ++s) {
        const float ps = __shfl_sync(kFull, p, s);
#pragma unroll
        for (int pp = 0; pp < kMaxDimPairs; ++pp) {
          const int d = 2 * lane + 64 * pp;
          if (d < hd) {
            const float2 vv = *reinterpret_cast<const float2*>(
                vs + s * ld + d);
            acc[j][2 * pp] += ps * vv.x;
            acc[j][2 * pp + 1] += ps * vv.y;
          }
        }
      }
      m[j] = m_new;
    }
  }

  const int nsplit = gridDim.z;
  const long long bh = static_cast<long long>(blockIdx.x) * KV + blockIdx.y;
  const long long prow = (bh * nsplit + blockIdx.z) * G;
  const long long ml_base =
      static_cast<long long>(gridDim.x) * KV * nsplit * G * hd;
#pragma unroll
  for (int j = 0; j < kMaxHeadsPerWarp; ++j) {
    if (j >= nh) break;
    const int g = warp + j * nwarps;
    if (nsplit == 1 && out != nullptr) {
      const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
      for (int pp = 0; pp < kMaxDimPairs; ++pp)
        store_pair(out + (bh * G + g) * hd, 2 * lane + 64 * pp, hd,
                   acc[j][2 * pp] * inv, acc[j][2 * pp + 1] * inv);
    } else {
      float* pa = partial + (prow + g) * hd;
#pragma unroll
      for (int pp = 0; pp < kMaxDimPairs; ++pp)
        store_pair(pa, 2 * lane + 64 * pp, hd, acc[j][2 * pp],
                   acc[j][2 * pp + 1]);
      if (lane == 0) {
        partial[ml_base + 2 * (prow + g)] = m[j];
        partial[ml_base + 2 * (prow + g) + 1] = l[j];
      }
    }
  }
}

// Pass 1, both element types: the bf16 tensor-core body for a staged width
// HD with MT m16 tiles, or the fp32 FMA body (HD = MT = 0).
template <typename T, int HD, int MT, typename Rows>
__device__ __forceinline__ void decode_split(
    const T* q, const T* k, const T* v, T* out, float* partial, int len,
    Rows rows, int KV, int G, int hd, float scale, float cap,
    unsigned char* smem) {
  if constexpr (sizeof(T) == 4) {
    decode_split_fma(q, k, v, out, partial, len, rows, KV, G, hd, scale, cap,
                     smem);
  } else {
    decode_split_mma<HD, MT>(q, k, v, out, partial, len, rows, KV, G, hd,
                             scale, cap, smem);
  }
}

// Sets `fn` to the pass-1 kernel for (hd, G): `Kernel<T, HD, MT>` is the
// including file's __global__ template.  bf16 has one kernel per staged
// width (padded_hd: 16, 32, ..., 128, then 160, ..., 256) and m16 tile
// count (G <= 16: one, else two), chosen here on the host so that each
// gets its own register allocation; fp32 has one.
#define REPRO_DECODE_CASE(Kernel, T, W, two, fn)                           \
  case W:                                                                   \
    fn = two ? Kernel<T, W, 2> : Kernel<T, W, 1>;                           \
    break;
#define REPRO_PICK_DECODE_KERNEL(Kernel, T, hd, G, fn)                      \
  if constexpr (sizeof(T) == 4) {                                           \
    fn = Kernel<T, 0, 0>;                                                   \
  } else {                                                                  \
    const bool two = (G) > 16;                                              \
    switch (repro::padded_hd<T>(hd)) {                                      \
      REPRO_DECODE_CASE(Kernel, T, 16, two, fn)                             \
      REPRO_DECODE_CASE(Kernel, T, 32, two, fn)                             \
      REPRO_DECODE_CASE(Kernel, T, 48, two, fn)                             \
      REPRO_DECODE_CASE(Kernel, T, 64, two, fn)                             \
      REPRO_DECODE_CASE(Kernel, T, 80, two, fn)                             \
      REPRO_DECODE_CASE(Kernel, T, 96, two, fn)                             \
      REPRO_DECODE_CASE(Kernel, T, 112, two, fn)                            \
      REPRO_DECODE_CASE(Kernel, T, 128, two, fn)                            \
      REPRO_DECODE_CASE(Kernel, T, 160, two, fn)                            \
      REPRO_DECODE_CASE(Kernel, T, 192, two, fn)                            \
      REPRO_DECODE_CASE(Kernel, T, 224, two, fn)                            \
      REPRO_DECODE_CASE(Kernel, T, 256, two, fn)                            \
      default:                                                              \
        fn = nullptr;                                                       \
    }                                                                       \
  }

constexpr int kMaxGroupDims = 4096;  // G * hd a merge block holds

// Threads per pass-1 block, or 0 when the kernels cannot take the shape
// (hd <= 256, G <= 32, G * hd <= kMaxGroupDims for the merge): one warp
// for bf16 (two past a staged width of 128), up to 8 for fp32.
template <typename T>
inline int decode_threads(int G, int hd) {
  if (G < 1 || G > 32 || hd < 1 || hd > 256 || G * hd > kMaxGroupDims)
    return 0;
  if (sizeof(T) == 2) return padded_hd<T>(hd) > 128 ? 64 : 32;
  const int warps = G < 8 ? G : 8;
  if ((G + warps - 1) / warps > kMaxHeadsPerWarp) return 0;
  return 32 * warps;
}

constexpr int kCombineThreads = 256;
constexpr int kCombineZ = 32;        // splits whose weights share memory

// Pass 2: out[b, h*G + g, d] from the live chunks of (b, h).  One warp per
// head reduces the chunks' maxima and weighted sums (a fixed shuffle
// tree); the chunks' weights then go to shared memory, kCombineZ at a
// time, and each thread sums its elements over the chunks in split order.
// With one live chunk every weight is exp(0) = 1 and the result is pass
// 1's own acc * (1 / l), bit for bit.  PER elements a thread: 8 up to G *
// hd = 2048, 16 past it (hd 256): the hd <= 128 shapes keep the smaller
// unrolled loop (16 everywhere slowed the deepseek-r1 decode shape).
// PARTIAL: out is the fp32 acc (B, H, hd), m_out / l_out (B, H), and
// nothing is normalised.
template <typename T, int PER, bool PARTIAL>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ partial,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int B, int KV, int G, int hd, int nsplit, int cap) {
  __shared__ float sw[kCombineZ][32];
  __shared__ float smax[32], sinv[32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // pass 1 is done
  const int bh = blockIdx.x;
  const int b = bh / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int len = lengths[b];
  len = len < cap ? len : cap;
  len = len > 0 ? len : 0;
  const int nlive = (len + kSplit - 1) / kSplit;
  const long long base = static_cast<long long>(bh) * nsplit * G;
  const float* ml =
      partial + static_cast<long long>(B) * KV * nsplit * G * hd;
  for (int g = warp; g < G; g += kCombineThreads / 32) {
    float mx = -INFINITY;
    for (int z = lane; z < nlive; z += 32)
      mx = fmaxf(mx, ml[2 * (base + z * G + g)]);
    mx = warp_max(mx);
    float ls = 0.f;
    for (int z = lane; z < nlive; z += 32) {
      const long long r = base + z * G + g;
      ls += expf(ml[2 * r] - mx) * ml[2 * r + 1];
    }
    ls = warp_sum(ls);
    if (lane == 0) {
      smax[g] = mx;
      sinv[g] = 1.f / fmaxf(ls, 1e-30f);
      if constexpr (PARTIAL) {
        m_out[static_cast<long long>(bh) * G + g] = nlive ? mx : -1e30f;
        l_out[static_cast<long long>(bh) * G + g] = ls;   // 0 when dead
      }
    }
  }
  float a[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) a[j] = 0.f;
  for (int z0 = 0; z0 < nlive; z0 += kCombineZ) {
    const int zn = min(kCombineZ, nlive - z0);
    __syncthreads();                  // smax ready; previous weights used
    for (int i = tid; i < zn * G; i += kCombineThreads) {
      const int z = i / G, g = i - z * G;
      sw[z][g] = expf(ml[2 * (base + (z0 + z) * G + g)] - smax[g]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * kCombineThreads;
      if (i < G * hd) {
        const int g = i / hd;
        const float* pa = partial + (base + z0 * G) * hd + i;
#pragma unroll 4
        for (int z = 0; z < zn; ++z) a[j] += sw[z][g] * pa[z * G * hd];
      }
    }
  }
  __syncthreads();                    // sinv ready when nlive == 0
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kCombineThreads;
    if (i < G * hd) {
      const float val = PARTIAL ? a[j] : (nlive ? a[j] * sinv[i / hd] : 0.f);
      out[static_cast<long long>(bh) * G * hd + i] = from_float<T>(val);
    }
  }
}

// Pass 2 on the stream of pass 1, as its programmatic dependent: the
// normalised output (out of T), or with m_out / l_out the merged partial
// (out of fp32).
template <typename T>
inline cudaError_t launch_combine(const void* partial, const void* lengths,
                                  void* out, int B, int KV, int G, int hd,
                                  int nsplit, int cap, cudaStream_t s,
                                  float* m_out = nullptr,
                                  float* l_out = nullptr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (m_out != nullptr) {
    auto* kernel = G * hd <= 2048 ? decode_combine_kernel<float, 8, true>
                                  : decode_combine_kernel<float, 16, true>;
    return cudaLaunchKernelEx(&cfg, kernel,
                              static_cast<const float*>(partial),
                              static_cast<const int*>(lengths),
                              static_cast<float*>(out), m_out, l_out, B, KV,
                              G, hd, nsplit, cap);
  }
  auto* kernel = G * hd <= 2048 ? decode_combine_kernel<T, 8, false>
                                : decode_combine_kernel<T, 16, false>;
  return cudaLaunchKernelEx(&cfg, kernel,
                            static_cast<const float*>(partial),
                            static_cast<const int*>(lengths),
                            static_cast<T*>(out), m_out, l_out, B, KV, G, hd,
                            nsplit, cap);
}

// Chunks of a cache view of `view` positions: the grid's third axis.
inline int split_count(int view) {
  return view > kSplit ? (view + kSplit - 1) / kSplit : 1;
}

// Shared memory above 48 KB is opted into for the kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

}  // namespace repro
