// Temperature sampling as JAX draws it: threefry-2x32 Gumbel-max, one
// launch a batch (kernels/sampling.py says what each step reproduces).
//
// What bounds it on an H100: operations, on the integer pipes (the hash's
// rounds) — so the work must reach every SM, whatever the batch.  A decode
// batch has 8-64 rows and a card 132 SMs: one block a row left most of
// them idle.  So each row is split into S contiguous column ranges, one
// block each, on a grid of B x S blocks (blockIdx.x the row, blockIdx.y
// its split; S from the wrapper, kernels/sampling.py::split_count: half a
// wave of blocks at a decode batch, ~4,096-column ranges past it).
//
// A block's columns.  A sampled row (t > 0): thread t hashes columns
// j0 + t, j0 + t + blockDim, ... of its range under the row's step key
// (fold_in(key, step), derived by every thread), forms logits / t + gumbel
// in fp32 with logf (the build has no fast-math) and keeps a running
// (value, index) maximum, one column an iteration.  A greedy row (t <= 0)
// skips the hash: the plain argmax over 16-byte loads.  A warp-shuffle
// then shared-memory reduction keeps the block's winner.
//
// The row's winner.  Each block writes its winner to a workspace of
// partials, fences, and counts itself on the row's counter; the block
// that finds S - 1 there is the row's last, reduces the S partials, writes
// out[b] and sets the counter back to 0 (a replay of a captured launch
// starts clean).  beats() is a total order — the larger value, a NaN the
// largest, the smaller index on ties — so the winner is the one the plain
// argmax takes, whichever block finishes last.
//
// sample_probe_kernel writes every element's bits, uniform and noise
// through the same helpers, for the tests that hold the hash bitwise.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProbeThreads = 256;
constexpr float kTiny = FLT_MIN;  // finfo(float32).tiny

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20 rounds, key injections after every 4 (JAX's unrolled lowering)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// the row's step key: fold_in(key, step) hashes the counter (0, step)
__device__ __forceinline__ void step_key(const long long* keys,
                                         const long long* steps, int b,
                                         uint32_t& s0, uint32_t& s1) {
  s0 = 0;
  s1 = static_cast<uint32_t>(steps[b]);
  threefry2x32(static_cast<uint32_t>(keys[2 * b]),
               static_cast<uint32_t>(keys[2 * b + 1]), s0, s1);
}

// random_bits of column j: the counter (j >> 32, j), x0 ^ x1
__device__ __forceinline__ uint32_t column_bits(uint32_t s0, uint32_t s1,
                                                int j) {
  uint32_t x0 = 0, x1 = static_cast<uint32_t>(j);
  threefry2x32(s0, s1, x0, x1);
  return x0 ^ x1;
}

// uniform(minval=tiny, maxval=1): the mantissa trick, then max(tiny, f+tiny)
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.f;
  return fmaxf(kTiny, __fadd_rn(f, kTiny));
}

__device__ __forceinline__ float gumbel_of(float u) {
  return -logf(-logf(u));
}

// does (va, ia) beat (vb, ib)?  larger value, NaN largest, then smaller
// index
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

// index V marks "no column yet": beaten by any column
__device__ __forceinline__ void keep(float v, int j, float& best,
                                     int& best_i, int V) {
  if (best_i == V || beats(v, j, best, best_i)) {
    best = v;
    best_i = j;
  }
}

__device__ __forceinline__ void warp_max(float& best, int& best_i, int V) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, o);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, o);
    if (oi < V) keep(ov, oi, best, best_i, V);
  }
}

// the block's winner, in thread 0 (the others' values are partial)
__device__ __forceinline__ void block_max(float& best, int& best_i, int V) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  warp_max(best, best_i, V);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? sv[lane] : 0.f;
    best_i = lane < kThreads / 32 ? si[lane] : V;
    warp_max(best, best_i, V);
  }
}

// the argmax of row[j0, j1): scalar loads up to a 16-byte boundary, then
// float4 loads, then the scalar tail (the row may start anywhere: a view)
__device__ __forceinline__ void greedy_range(const float* __restrict__ row,
                                             int j0, int j1, float& best,
                                             int& best_i, int V) {
  const int head = min(j1 - j0, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(row + j0) & 15)) & 15) >> 2));
  if (static_cast<int>(threadIdx.x) < head)
    keep(row[j0 + threadIdx.x], j0 + threadIdx.x, best, best_i, V);
  const int a = j0 + head;
  const int nv = (j1 - a) >> 2;
  const float4* q = reinterpret_cast<const float4*>(row + a);
#pragma unroll 2
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const float4 v = q[i];
    const int j = a + 4 * i;
    keep(v.x, j, best, best_i, V);
    keep(v.y, j + 1, best, best_i, V);
    keep(v.z, j + 2, best, best_i, V);
    keep(v.w, j + 3, best, best_i, V);
  }
  for (int j = a + 4 * nv + threadIdx.x; j < j1; j += kThreads)
    keep(row[j], j, best, best_i, V);
}

// the columns of split s of S: ceil(V / S) rounded up to 4 (whole float4s
// for an aligned row), the last range cut at V, later ones empty
__device__ __forceinline__ void split_range(int V, int S, int s, int& j0,
                                            int& j1) {
  const long long w = ((static_cast<long long>(V) + S - 1) / S + 3) & ~3ll;
  j0 = static_cast<int>(min(static_cast<long long>(V), s * w));
  j1 = static_cast<int>(min(static_cast<long long>(V), j0 + w));
}

__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ logits, long long row_stride,
              const float* __restrict__ temps,
              const long long* __restrict__ keys,
              const long long* __restrict__ steps,
              long long* __restrict__ out, float* __restrict__ part_v,
              int* __restrict__ part_i, unsigned* __restrict__ counters,
              int V, int S) {
  const int b = blockIdx.x, s = blockIdx.y;
  const float* row = logits + b * row_stride;
  const float t = temps[b];
  int j0, j1;
  split_range(V, S, s, j0, j1);

  float best = 0.f;
  int best_i = V;
  if (t > 0.f) {
    uint32_t s0, s1;
    step_key(keys, steps, b, s0, s1);
#pragma unroll 1
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const float g = gumbel_of(uniform_of(column_bits(s0, s1, j)));
      keep(__fadd_rn(g, __fdiv_rn(row[j], t)), j, best, best_i, V);
    }
  } else {
    greedy_range(row, j0, j1, best, best_i, V);
  }
  block_max(best, best_i, V);

  __shared__ bool last;
  const long long at = static_cast<long long>(b) * S;
  if (threadIdx.x == 0) {
    part_v[at + s] = best;             // an empty range leaves index V
    part_i[at + s] = best_i;
    __threadfence();
    last = atomicAdd(counters + b, 1u) == static_cast<unsigned>(S - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  best = 0.f;
  best_i = V;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const int ix = __ldcg(part_i + at + i);
    if (ix < V) keep(__ldcg(part_v + at + i), ix, best, best_i, V);
  }
  block_max(best, best_i, V);
  if (threadIdx.x == 0) {
    out[b] = best_i;
    counters[b] = 0;
  }
}

__global__ void __launch_bounds__(kProbeThreads)
sample_probe_kernel(const long long* __restrict__ keys,
                    const long long* __restrict__ steps,
                    int* __restrict__ bits_out, float* __restrict__ u_out,
                    float* __restrict__ g_out, int V) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kProbeThreads + threadIdx.x;
  if (j >= V) return;
  uint32_t s0, s1;
  step_key(keys, steps, b, s0, s1);
  const uint32_t bits = column_bits(s0, s1, j);
  const float u = uniform_of(bits);
  const long long at = static_cast<long long>(b) * V + j;
  bits_out[at] = static_cast<int>(bits);
  u_out[at] = u;
  g_out[at] = gumbel_of(u);
}

}  // namespace

// The blocks of sample_kernel the current device holds at once (its SM
// count times the blocks an SM holds): the wrapper's S is this over B.
extern "C" int sample_slots(int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                        sample_kernel,
                                                        kThreads, 0);
  *slots = sms * per_sm;
  return static_cast<int>(err);
}

// logits (B, V) fp32 rows row_stride apart; temps (B,) fp32; keys (B, 2)
// and steps (B,) int64 holding 32-bit words; out (B,) int64; S splits a
// row; part_v / part_i (B * S) fp32 / int32 partials; counters (B,) uint32,
// 0 on entry and on exit
extern "C" int sample_launch(const void* logits, long long row_stride,
                             const void* temps, const void* keys,
                             const void* steps, void* out, void* part_v,
                             void* part_i, void* counters, int B, int V,
                             int S, void* stream) {
  if (B < 1 || V < 1 || S < 1 || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  sample_kernel<<<dim3(B, S), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), row_stride,
      static_cast<const float*>(temps), static_cast<const long long*>(keys),
      static_cast<const long long*>(steps), static_cast<long long*>(out),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      static_cast<unsigned*>(counters), V, S);
  return static_cast<int>(cudaGetLastError());
}

// keys (B, 2), steps (B,) int64; bits_out (B, V) int32 (the uint32 bits),
// u_out and g_out (B, V) fp32
extern "C" int sample_probe_launch(const void* keys, const void* steps,
                                   void* bits_out, void* u_out, void* g_out,
                                   int B, int V, void* stream) {
  if (B < 1 || V < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + kProbeThreads - 1) / kProbeThreads, B);
  sample_probe_kernel<<<grid, kProbeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys),
      static_cast<const long long*>(steps), static_cast<int*>(bits_out),
      static_cast<float*>(u_out), static_cast<float*>(g_out), V);
  return static_cast<int>(cudaGetLastError());
}
