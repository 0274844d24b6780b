// Blocked previous-smaller-value engine for Hopper (sm_90a): K5.
//
// Replaces psac_tpu/ops/bansv.py::block_psv, which XLA fuses on the TPU in
// three stages: all-pairs compares inside each 256-element block and
// against the previous block, a target-block search over block and
// superblock minima, and compacted row gathers (in capacity-bounded chunks)
// for answers in distant blocks.  The chunking and compaction exist only to
// bound XLA's materialized windows; this kernel needs neither.
//
// Output: out[i] = largest j < i with x[j] < x[i] (strict) or x[j] <= x[i]
// (non-strict); -1 when there is none.  Values are int32 or int64 (a
// template); indices are int32 (the wrapper requires s < 2^31).
//
// Design:
//   * a minima hierarchy: level 0 is x, level k+1 holds the minima of the
//     B-entry blocks of level k, built by one small reduction kernel per
//     level until a level has at most B entries (4 levels at s = 2^26);
//   * one thread block per B-element block, with that block and the
//     previous one staged in shared memory; each thread scans backward over
//     the two blocks from its element;
//   * an element still unresolved climbs the hierarchy: at each level it
//     scans backward over the entries of its ancestor's block that lie
//     before the ancestor, then descends from the first entry whose minimum
//     matches, scanning each chosen block's row from its end.
//
// What bounds it: per-thread backward scans (at most 2B shared-memory words,
// then at most B words per level up and down, read through L1/L2; the
// levels above 0 hold s/B + s/B^2 + ... entries and stay cached); typical
// LCP arrays resolve within a few words of the element.  Threads of a warp
// diverge on scan length; device-memory traffic is one read of x per level
// plus one int32 write per element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int B = 256;
constexpr int MAX_LEVELS = 8;

template <typename T>
struct Inf;
template <>
struct Inf<int32_t> {
  static constexpr int32_t v = INT32_MAX;
};
template <>
struct Inf<int64_t> {
  static constexpr int64_t v = INT64_MAX;
};

// ptr[0] = x; ptr[k] = the minima of the B-entry blocks of level k - 1.
template <typename T>
struct Levels {
  const T* ptr[MAX_LEVELS];
  int count;
};

template <typename T, bool STRICT>
__device__ __forceinline__ bool hit(T a, T v) {
  return STRICT ? a < v : a <= v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_down_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// out[b] = min(in[b*B .. min((b+1)*B, n))).
template <typename T>
__global__ void __launch_bounds__(B)
block_min_kernel(const T* __restrict__ in, long long n, T* __restrict__ out) {
  __shared__ T red[B / 32];
  const long long i = static_cast<long long>(blockIdx.x) * B + threadIdx.x;
  T v = warp_min(i < n ? in[i] : Inf<T>::v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = warp_min(threadIdx.x < B / 32 ? red[threadIdx.x] : Inf<T>::v);
    if (threadIdx.x == 0) out[blockIdx.x] = v;
  }
}

// Last index before the level-1 bound p (exclusive) whose element matches v,
// found by climbing the hierarchy and descending from the first matching
// entry; -1 if none.  Every block descended into lies wholly before the
// element, so it is full.
template <typename T, bool STRICT>
__device__ long long climb_descend(const Levels<T>& lv, long long p, T v) {
  long long e = -1;
  int k = 1;
  for (; k < lv.count; ++k) {
    const T* a = lv.ptr[k];
    const long long lo = p / B * B;
    for (long long j = p - 1; j >= lo; --j) {
      if (hit<T, STRICT>(a[j], v)) {
        e = j;
        break;
      }
    }
    if (e >= 0) break;
    p /= B;
  }
  if (e < 0) return -1;
  for (int l = k - 1; l >= 0; --l) {
    const T* a = lv.ptr[l];
    long long j = e * B + B - 1;
    while (!hit<T, STRICT>(a[j], v)) --j;
    e = j;
  }
  return e;
}

template <typename T, bool STRICT>
__global__ void __launch_bounds__(B)
psv_kernel(Levels<T> lv, long long s, int32_t* __restrict__ out) {
  __shared__ T win[2 * B];  // previous block, then this block
  const T* x = lv.ptr[0];
  const long long b = blockIdx.x;
  const long long base = b * B;
  const int t = threadIdx.x;
  const long long i = base + t;
  win[t] = b > 0 ? x[base - B + t] : Inf<T>::v;
  win[B + t] = i < s ? x[i] : Inf<T>::v;
  __syncthreads();
  if (i >= s) return;
  const T v = win[B + t];
  const int lo = b > 0 ? 0 : B;
  int k = B + t - 1;
  while (k >= lo && !hit<T, STRICT>(win[k], v)) --k;
  const long long ans = k >= lo ? base - B + k
                                : climb_descend<T, STRICT>(lv, b > 0 ? b - 1 : 0, v);
  out[i] = static_cast<int32_t>(ans);
}

// scratch: the levels above 0, sum over k >= 1 of ceil(s / B^k) entries
// while the previous level has more than B entries.
template <typename T>
int block_psv(const T* x, int32_t* out, T* scratch, long long s, int strict,
              cudaStream_t stream) {
  Levels<T> lv;
  lv.ptr[0] = x;
  lv.count = 1;
  long long n = s;
  T* dst = scratch;
  while (n > B) {
    if (lv.count == MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
    const long long m = (n + B - 1) / B;
    block_min_kernel<T><<<static_cast<unsigned>(m), B, 0, stream>>>(
        lv.ptr[lv.count - 1], n, dst);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    lv.ptr[lv.count++] = dst;
    dst += m;
    n = m;
  }
  const long long nb = (s + B - 1) / B;
  if (nb > 0) {
    if (strict) {
      psv_kernel<T, true><<<static_cast<unsigned>(nb), B, 0, stream>>>(lv, s,
                                                                      out);
    } else {
      psv_kernel<T, false><<<static_cast<unsigned>(nb), B, 0, stream>>>(lv, s,
                                                                       out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the first CUDA error of the launches, 0 if none.
int psac_block_psv_i32(const int32_t* x, int32_t* out, int32_t* scratch,
                       long long s, int strict, void* stream) {
  return block_psv<int32_t>(x, out, scratch, s, strict,
                            static_cast<cudaStream_t>(stream));
}

int psac_block_psv_i64(const int64_t* x, int32_t* out, int64_t* scratch,
                       long long s, int strict, void* stream) {
  return block_psv<int64_t>(x, out, scratch, s, strict,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
