// LCP resolve by batched range minima for Hopper (sm_90a): K6.
//
// Replaces the chunk body of psac_tpu/models/suffix_array.py::
// _resolve_fused_local (with psac_tpu/ops/rmq.py::query_local_rmq), which
// XLA fuses on the TPU: per query, decode (row, j) from a packed sort key,
// take min(LCP[lo..hi]) and write j*d + min at `row`.  The TPU code answers
// the queries in chunks of s / resolve_div so that its (chunk, 128) row
// windows stay bounded, picks per chunk between a narrow tier (two 8-wide
// rows) and the general path (two masked 128-wide edge rows plus two reads
// of the doubling table over block minima), and scatters into a drop-slot
// padded copy of the LCP.  None of that carries over: one launch takes all
// the queries of a resolve, picks the tier per query, and writes into `out`,
// a copy of the LCP that the wrapper makes before the launch.  Every read
// is of the old LCP and of the table, which nothing writes.
//
// Design: one query per thread, 32 per warp.
//   * the query words are read coalesced: a warp reads 32 consecutive keys,
//     starts and ends (128 bytes each at int32);
//   * a range under 8 wide is read by its own thread: the aligned 16-byte
//     words that cover it (at most three at int32, five at int64), every
//     load issued before any is used, the minimum taken in registers; when
//     the LCP is not 16-byte aligned or s is not a multiple of the words'
//     width, eight independent element loads instead;
//   * the wider ranges of a warp are then taken one at a time by all 32
//     lanes: the part of [lo, hi] in lo's block and the part in hi's block
//     are consecutive values (at most `block` each, coalesced reads), the
//     full blocks between them come from two reads of the doubling table;
//     a five-step shuffle reduce gives the minimum;
//   * each thread writes j*d + min at its row.  In the sorted packings the
//     32 rows of a warp increase, so the writes fall into fewer sectors.
// Invalid queries carry the key INF; they are skipped, so the caller may
// pass sorted queries with `nq` the count of valid ones, or an unsorted
// buffer with `nq` its length.
//
// What bounds it: compulsory bytes.  Each input read once and each output
// written once: the LCP read and its copy written (2 s words), three or
// four query words per query and at most two table words per wide query
// (0.0682 ms for the 7,797,673 queries of the 2^24 `rep_dna` build's
// largest resolve at 3.35 TB/s).  It reaches about 32% of that bound there
// (96% of the queries narrow), and about 6% on a resolve whose queries are
// seven in eight wide, where each warp takes 28 queries in turn (PERF.md
// section 6).  A narrow query reads one or two 32-byte sectors where it
// needs 4-32 bytes, so the scattered reads, not the bound's bytes, set the
// pace.  All index arithmetic is 64-bit, so no int32 product of an invalid
// row can overflow; values are int32 or int64 (a template).
//
// A second entry point, psac_rmq_mins_*, answers the range minima alone,
// for p > 1: there the queries' ranges are global and cross shards, so the
// shard that owns a range's start (and, for a crossing range, the shard
// that owns its end) answers the part inside its own block
// (psac_tpu/parallel/par_rmq.py:52-84), and the issuing shard writes
// j*d + min.  Per query it runs the resolve's code: the narrow tier in
// the query's thread, the wide tier by the warp in turn; a query that is
// not valid gets INF.  Its bound is compulsory bytes too: per query two
// range words and a flag read and one word written, plus the LCP and
// table words the valid ranges cover.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // one query per thread
constexpr int NARROW = 8;     // ranges under 8 wide are read by one thread
constexpr unsigned FULL = 0xffffffffu;

// How (row, j) is packed into the sort key: mode 0 (narrow) is
// ((wide ? s : 0) + row) * Lm + (j - 1), mode 1 (packed) is
// row * Lm + (j - 1), mode 2 (rows) is the row itself, with j from js, or 1
// when js is null.
constexpr int MODE_NARROW = 0;
constexpr int MODE_ROWS = 2;

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

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) {
  return b < a ? b : a;
}

template <typename T>
struct Args {
  const T* lcp;    // (s,) the pre-resolve LCP
  const T* table;  // (levels, nb) doubling table over block minima
  const T* ks;     // (>= nq,) keys
  const T* ls;     // (>= nq,) range starts
  const T* rs;     // (>= nq,) range ends (inclusive)
  const T* js;     // (>= nq,) columns, or null
  T* out;          // (s,) the new LCP, holding a copy of lcp
  long long s, nb, nq, Lm, d;
  int bshift;      // log2(block)
  int mode;
};

// min(lcp[lo..hi]), hi - lo < NARROW, read by one thread.  VEC: the LCP
// is 16-byte aligned and s a multiple of the 16-byte words' width, so the
// words that cover [lo, hi] lie inside it.
template <typename T, bool VEC>
__device__ __forceinline__ T narrow_min(const T* __restrict__ lcp,
                                        long long lo, long long hi) {
  T m = Inf<T>::v;
  if (VEC) {
    constexpr int E = 16 / sizeof(T);   // elements per 16-byte word
    constexpr int NW = NARROW / E + 1;  // words that can cover the range
    union Word {
      uint4 u;
      T e[E];
    };
    const uint4* w = reinterpret_cast<const uint4*>(lcp);
    const long long c0 = lo / E;
    const long long c1 = hi / E;
    Word got[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c)
      if (c0 + c <= c1) got[c].u = __ldg(w + c0 + c);
#pragma unroll
    for (int c = 0; c < NW; ++c) {
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const long long at = (c0 + c) * E + u;
        if (c0 + c <= c1 && at >= lo && at <= hi) m = min_of(m, got[c].e[u]);
      }
    }
  } else {
    T got[NARROW];
#pragma unroll
    for (int u = 0; u < NARROW; ++u)
      if (lo + u <= hi) got[u] = lcp[lo + u];
#pragma unroll
    for (int u = 0; u < NARROW; ++u)
      if (lo + u <= hi) m = min_of(m, got[u]);
  }
  return m;
}

// The wide ranges of a warp, taken one at a time by all 32 lanes: the part
// of [lo, hi] in lo's block and the part in hi's block are read coalesced,
// the full blocks between them come from two reads of the doubling table,
// and a five-step shuffle reduce gives the minimum, which lands in `m` of
// the lane whose query it is.  Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ void warp_wide_min(const T* __restrict__ lcp,
                                              const T* __restrict__ table,
                                              long long nb, int bshift,
                                              bool wide, long long lo,
                                              long long hi, int lane, T& m) {
  unsigned todo = __ballot_sync(FULL, wide);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long wlo = __shfl_sync(FULL, lo, src);
    const long long whi = __shfl_sync(FULL, hi, src);
    const long long bl = wlo >> bshift;
    const long long bh = whi >> bshift;
    T w = Inf<T>::v;
    // the part of the range in lo's block
    const long long lend = bl == bh ? whi : ((bl + 1) << bshift) - 1;
    for (long long i = wlo + lane; i <= lend; i += 32) w = min_of(w, lcp[i]);
    if (bl != bh) {
      // the part in hi's block, and the full blocks between the two
      for (long long i = (bh << bshift) + lane; i <= whi; i += 32)
        w = min_of(w, lcp[i]);
      const long long first = bl + 1;
      const long long len = bh - first;
      if (len > 0 && lane < 2) {
        const int lev = 63 - __clzll(len);
        const long long at = lane == 0 ? first : bh - (1LL << lev);
        w = min_of(w, table[lev * nb + at]);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      w = min_of(w, __shfl_xor_sync(FULL, w, off));
    if (lane == src) m = w;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rmq_resolve_kernel(const __grid_constant__ Args<T> a) {
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;

  bool live = false;
  long long row = 0, j = 1, lo = 0, hi = 0;
  if (q < a.nq) {
    const T key = a.ks[q];
    const long long l = a.ls[q];
    const long long r = a.rs[q];
    if (key != Inf<T>::v) {
      long long k = key;
      if (a.mode == MODE_ROWS) {
        row = k;
        if (a.js != nullptr) j = a.js[q];
      } else {
        if (a.mode == MODE_NARROW && k >= a.s * a.Lm) k -= a.s * a.Lm;
        row = k / a.Lm;
        j = k - row * a.Lm + 1;
      }
      lo = l < 0 ? 0 : (l > a.s - 1 ? a.s - 1 : l);
      hi = r < l ? l : r;
      hi = hi < 0 ? 0 : (hi > a.s - 1 ? a.s - 1 : hi);
      live = row >= 0 && row < a.s;
    }
  }

  // ---- narrow tier: the thread reads its own range
  const bool wide = live && hi - lo >= NARROW;
  T m = Inf<T>::v;
  if (live && !wide) m = narrow_min<T, VEC>(a.lcp, lo, hi);

  // ---- wide tier: the warp takes its wide queries one at a time
  warp_wide_min<T>(a.lcp, a.table, a.nb, a.bshift, wide, lo, hi, lane, m);

  if (live) a.out[row] = static_cast<T>(j * a.d + m);
}


// The range minima alone (the second entry point): at p > 1 the owner shard
// answers min(lcp[lo..hi]) over its own block for the queries routed to it
// (psac_tpu/parallel/par_rmq.py:52-84, query_local_rmq there), and the
// issuing shard combines the parts and writes j*d + min.  Same per-query
// code as the resolve: a range under 8 wide read by its own thread, the
// warp taking the wider ones in turn; INF where a query is not valid.
template <typename T>
struct MinsArgs {
  const T* lcp;           // (s,) the values
  const T* table;         // (levels, nb) doubling table over block minima
  const T* lo;            // (m,) range starts
  const T* hi;            // (m,) range ends (inclusive)
  const uint8_t* valid;   // (m,) 0 or 1
  T* out;                 // (m,) the minima
  long long s, nb, m;
  int bshift;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rmq_mins_kernel(const __grid_constant__ MinsArgs<T> a) {
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  bool live = false;
  long long lo = 0, hi = 0;
  if (q < a.m && a.valid[q]) {
    const long long l = a.lo[q];
    const long long r = a.hi[q];
    lo = l < 0 ? 0 : (l > a.s - 1 ? a.s - 1 : l);
    hi = r < l ? l : r;
    hi = hi < 0 ? 0 : (hi > a.s - 1 ? a.s - 1 : hi);
    live = true;
  }
  const bool wide = live && hi - lo >= NARROW;
  T m = Inf<T>::v;
  if (live && !wide) m = narrow_min<T, VEC>(a.lcp, lo, hi);
  warp_wide_min<T>(a.lcp, a.table, a.nb, a.bshift, wide, lo, hi, lane, m);
  if (q < a.m) a.out[q] = m;
}

template <typename T>
int rmq_resolve(const T* lcp, const T* table, const T* ks, const T* ls,
                const T* rs, const T* js, T* out, long long s, long long nb,
                int block, long long nq, int Lm, int mode, long long d,
                cudaStream_t stream) {
  if (block <= 0 || (block & (block - 1)) != 0 || Lm < 1 || mode < 0 ||
      mode > MODE_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq <= 0) return 0;
  Args<T> a;
  a.lcp = lcp;
  a.table = table;
  a.ks = ks;
  a.ls = ls;
  a.rs = rs;
  a.js = js;
  a.out = out;
  a.s = s;
  a.nb = nb;
  a.nq = nq;
  a.Lm = Lm;
  a.d = d;
  a.bshift = 0;
  while ((1 << a.bshift) < block) ++a.bshift;
  a.mode = mode;
  const long long blocks = (nq + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(lcp) % 16 == 0 && s % E == 0;
  if (vec)
    rmq_resolve_kernel<T, true>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  else
    rmq_resolve_kernel<T, false>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


template <typename T>
int rmq_mins(const T* lcp, const T* table, const T* lo, const T* hi,
             const uint8_t* valid, T* out, long long s, long long nb,
             int block, long long m, cudaStream_t stream) {
  if (block <= 0 || (block & (block - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  MinsArgs<T> a;
  a.lcp = lcp;
  a.table = table;
  a.lo = lo;
  a.hi = hi;
  a.valid = valid;
  a.out = out;
  a.s = s;
  a.nb = nb;
  a.m = m;
  a.bshift = 0;
  while ((1 << a.bshift) < block) ++a.bshift;
  const long long blocks = (m + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(lcp) % 16 == 0 && s % E == 0;
  if (vec)
    rmq_mins_kernel<T, true>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  else
    rmq_mins_kernel<T, false>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch, 0 if none.
int psac_rmq_resolve_i32(const int32_t* lcp, const int32_t* table,
                         const int32_t* ks, const int32_t* ls,
                         const int32_t* rs, const int32_t* js, int32_t* out,
                         long long s, long long nb, int block, long long nq,
                         int Lm, int mode, long long d, void* stream) {
  return rmq_resolve<int32_t>(lcp, table, ks, ls, rs, js, out, s, nb, block,
                              nq, Lm, mode, d,
                              static_cast<cudaStream_t>(stream));
}

int psac_rmq_resolve_i64(const int64_t* lcp, const int64_t* table,
                         const int64_t* ks, const int64_t* ls,
                         const int64_t* rs, const int64_t* js, int64_t* out,
                         long long s, long long nb, int block, long long nq,
                         int Lm, int mode, long long d, void* stream) {
  return rmq_resolve<int64_t>(lcp, table, ks, ls, rs, js, out, s, nb, block,
                              nq, Lm, mode, d,
                              static_cast<cudaStream_t>(stream));
}

int psac_rmq_mins_i32(const int32_t* lcp, const int32_t* table,
                      const int32_t* lo, const int32_t* hi,
                      const uint8_t* valid, int32_t* out, long long s,
                      long long nb, int block, long long m, void* stream) {
  return rmq_mins<int32_t>(lcp, table, lo, hi, valid, out, s, nb, block, m,
                           static_cast<cudaStream_t>(stream));
}

int psac_rmq_mins_i64(const int64_t* lcp, const int64_t* table,
                      const int64_t* lo, const int64_t* hi,
                      const uint8_t* valid, int64_t* out, long long s,
                      long long nb, int block, long long m, void* stream) {
  return rmq_mins<int64_t>(lcp, table, lo, hi, valid, out, s, nb, block, m,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
