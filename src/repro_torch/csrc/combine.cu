// Top-k combine: out[t, :] = sum_j w[t, j] * row(t, j), fp32 accumulation.
//
// Replaces src/repro/kernels/combine.py::combine_weighted_pallas, and the
// gather of src/repro/core/dispatch.py::combine with it.  One body, two
// address policies (as decode_attention.cuh shares one body between the
// dense and the paged cache):
//
// * DirectRows — x (T, k, d) and w (T, k): the Pallas kernel's signature;
// * SlotRows   — the expert servers' response buffers read in place: slot
//   s*C + c of combine_slot (T, k) is row c of server s's (C, d) buffer, a
//   slot outside [0, S*C) (-1: dropped) is skipped and its row never read;
//   weight 1.  An optional addend (T, d) is added after the cast to the
//   output type, as the shared experts' output was added before.
//
// Every policy sums the k rows in ascending j, one fp32 fma after another.
// fma(1, x, acc) == acc + x, so the slot entry is bitwise the direct one
// over the gathered view with 0/1 weights, and a sequential fp32 loop.
//
// What bounds it on an H100: bytes.  Each element read is used for one
// fma; the live rows, the output and the addend are all that must move.
// The design moves only those (no stacked (S, C, d) copy of the responses,
// no (T, k, d) gathered view) and keeps the memory busy:
// * a thread owns 16 bytes of one output row (ld.global.nc, L1 not
//   allocated: every byte is read once) and walks the k rows in order;
// * the addend does not depend on the slots, so its load is issued before
//   the block resolves its k row addresses (once, into shared memory);
// * occupancy over loads in flight: at 40 registers a thread, 12 blocks
//   of 128 threads share an SM.  Issuing all k row loads before the adds
//   (this kernel's first version) took 80 registers (3 blocks of 256 an
//   SM) and left the 512-token prefill case under half its bytes bound;
// * the block width is chosen on the host from T: a decode call (T = 8)
//   still runs >= 2 blocks per SM, a prefill call many.
// A row not on the 16-byte grid (d not a multiple of the vector, or a base
// off by some bytes) takes the same body one element per thread.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxTopK = 32;      // <= the smallest block, 32 threads
constexpr int kMaxServers = 64;   // response buffers passed by value
constexpr int kMaxThreads = 128;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_nc(const T* p) {
  if constexpr (sizeof(Pack<T, N>) == 16) {
    union {
      uint4 u;
      Pack<T, N> pack;
    } cvt;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(cvt.u.x), "=r"(cvt.u.y), "=r"(cvt.u.z), "=r"(cvt.u.w)
        : "l"(p));
    return cvt.pack;
  } else {
    return *reinterpret_cast<const Pack<T, N>*>(p);
  }
}

// Row j of token t is x[t, j, :] with weight w[t, j].
template <typename T>
struct DirectRows {
  const T* x;
  const float* w;
  __device__ void resolve(long long t, int j, int k, int d, const T** row,
                          float* wt) const {
    const long long r = t * k + j;
    *row = x + r * d;
    *wt = w[r];
  }
};

// Row j of token t is row (slot % rows) of buffer (slot / rows), weight 1.
template <typename T>
struct SlotRows {
  const T* base[kMaxServers];
  long long rows;                 // rows per buffer (C)
  long long total;                // rows over all buffers (S * C)
  const long long* slots;         // (T, k)
  __device__ void resolve(long long t, int j, int k, int d, const T** row,
                          float* wt) const {
    const long long s = slots[t * k + j];
    *row = (s >= 0 && s < total) ? base[s / rows] + (s % rows) * d : nullptr;
    *wt = 1.f;
  }
};

// Grid: T * slices blocks; block b covers token b / slices and blockDim.x
// vectors of N elements of its row, one a thread.
template <typename T, int N, class Rows>
__global__ void __launch_bounds__(kMaxThreads)
    combine_kernel(const __grid_constant__ Rows rows,
                   const T* __restrict__ addend,
                   T* __restrict__ out, int k, int d, int slices) {
  __shared__ const T* row[kMaxTopK];
  __shared__ float wt[kMaxTopK];
  const long long t = blockIdx.x / slices;
  const int slice = blockIdx.x - static_cast<int>(t) * slices;
  const int col = (slice * blockDim.x + threadIdx.x) * N;
  const long long o = t * d + col;
  Pack<T, N> a;
  if (addend != nullptr && col < d) a = load_nc<T, N>(addend + o);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    rows.resolve(t, j, k, d, &row[j], &wt[j]);
  }
  __syncthreads();
  if (col >= d) return;

  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int j = 0; j < k; ++j) {
    if (row[j] == nullptr) continue;
    const Pack<T, N> x = load_nc<T, N>(row[j] + col);
    const float w = wt[j];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      acc[e] = fmaf(w, repro::to_float(x.v[e]), acc[e]);
    }
  }

  Pack<T, N> y;
#pragma unroll
  for (int e = 0; e < N; ++e) y.v[e] = repro::from_float<T>(acc[e]);
  if (addend != nullptr) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      y.v[e] = repro::from_float<T>(repro::to_float(y.v[e]) +
                                    repro::to_float(a.v[e]));
    }
  }
  *reinterpret_cast<Pack<T, N>*>(out + o) = y;
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The vector path needs every row on the 16-byte grid: d a multiple of
// the vector and every base aligned (`vec_ok` covers the row bases).
template <typename T, class Rows>
int launch(const Rows& rows, bool vec_ok, const void* addend, void* out,
           int T_, int k, int d, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (T_ == 0) return 0;
  if (k > kMaxTopK) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_ok && d % V == 0 && aligned16(out) &&
                   (addend == nullptr || aligned16(addend));
  const int units = vec ? d / V : d;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the widest block that still gives every SM two blocks
  int threads = kMaxThreads;
  while (threads > 32 &&
         static_cast<long long>(T_) * ((units + threads - 1) / threads) <
             2LL * sms) {
    threads /= 2;
  }
  const int slices = (units + threads - 1) / threads;
  if (static_cast<long long>(T_) * slices >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(T_ * slices);
  const T* a = static_cast<const T*>(addend);
  T* o = static_cast<T*>(out);
  if (vec) {
    combine_kernel<T, V, Rows><<<grid, threads, 0, s>>>(rows, a, o, k, d,
                                                         slices);
  } else {
    combine_kernel<T, 1, Rows><<<grid, threads, 0, s>>>(rows, a, o, k, d,
                                                         slices);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slots(const void* const* bases, int num_bases, long long rows,
                 const void* slots, const void* addend, void* out, int T_,
                 int k, int d, cudaStream_t s) {
  if (num_bases < 1 || num_bases > kMaxServers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlotRows<T> r{};
  bool vec_ok = true;
  for (int i = 0; i < num_bases; ++i) {
    r.base[i] = static_cast<const T*>(bases[i]);
    vec_ok = vec_ok && aligned16(bases[i]);
  }
  r.rows = rows;
  r.total = rows * num_bases;
  r.slots = static_cast<const long long*>(slots);
  return launch<T>(r, vec_ok, addend, out, T_, k, d, s);
}

}  // namespace

extern "C" int combine_weighted_launch(const void* x, const void* w,
                                       void* out, int T, int k, int d,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    DirectRows<__nv_bfloat16> r{static_cast<const __nv_bfloat16*>(x),
                                static_cast<const float*>(w)};
    return launch<__nv_bfloat16>(r, aligned16(x), nullptr, out, T, k, d, s);
  }
  DirectRows<float> r{static_cast<const float*>(x),
                      static_cast<const float*>(w)};
  return launch<float>(r, aligned16(x), nullptr, out, T, k, d, s);
}

// bases: num_bases host pointers to (rows, d) buffers, copied into the
// kernel's parameters (no upload: a launch that a CUDA graph captures);
// slots (T, k) int64 on the device; addend (T, d) or null.
extern "C" int combine_slots_launch(const void* const* bases, int num_bases,
                                    long long rows, const void* slots,
                                    const void* addend, void* out, int T,
                                    int k, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    return launch_slots<__nv_bfloat16>(bases, num_bases, rows, slots, addend,
                                       out, T, k, d, s);
  }
  return launch_slots<float>(bases, num_bases, rows, slots, addend, out, T,
                             k, d, s);
}

// An empty kernel: the card's launch floor, for timing beside the above.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
