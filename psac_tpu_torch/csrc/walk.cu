// Hierarchical-window walks for Hopper (sm_90a): K8.
//
// Replaces psac_tpu/ops/walk.py::levels_prev_lt and ::levels_next_leq,
// which XLA fuses on the TPU into one pass per level of the T = 128-ary min
// tree (a (q, T) row gather, a compare, a mask and a reduction), over every
// level for every query, in 2^19-query chunks.  Eager torch materializes
// each of those windows; this kernel keeps them in registers.
//
// Per query (start, v) over x of (s,), padded to rows * T with the dtype's
// maximum (level 0), and the min tree above it (build_levels: level k + 1
// holds the minima of level k's rows, padded the same way, up to one row):
//   prev_lt:  the largest j < start with x[j] < v (STRICT) or <= v; -1 if
//             none (also when start <= 0);
//   next_leq: the smallest j >= start with x[j] <= v (or < v, STRICT);
//             rows[0] * T, the padded length, if none (also when start >=
//             rows[0] * T).
// The answers equal the plain version's bit for bit, clamped row reads
// included (ops/walk.py::levels_prev_lt_plain / levels_next_leq_plain).
//
// What bounds it: bytes.  Each query's start (8 B), v (4 or 8 B) and answer
// (8 B) once, and each level row that the walks read once (chip_smoke.py
// ::walk_rows): about 0.36 ms at 3.35 TB/s for a shard's three full-width
// walks over 2^24 int32 rows.  What sets the pace is the work per query
// beyond that, and the SIMT lanes it leaves idle.  Most answers of the
// ANSV's walks lie a few entries from the start: in a shard of the LCP of
// random DNA, 43-93% of a full-width walk's answers lie within 8 entries
// and 74-98% within 32, and 2-21% lie beyond the own row (PERF.md section
// 5).  A design that gives every query the same lanes through its whole
// walk (the first K8: 8 lanes a query, the climb inline) runs the rare
// climb of one query while the other queries of its warp wait.
//
// Design: two phases in each block of THREADS threads and THREADS * QPT
// queries.
//   A. The window (PSAC_K8_WINDOW_A 16-byte vectors, 128 B by default):
//      one thread a query reads the window of the own level-0 row that
//      ends at (prev_lt) or starts at (next_leq) the own position, shifted
//      to stay inside the row, all its loads before any compare; a bit
//      mask of the qualifying entries on the searched side, then its
//      highest (lowest) bit, answers the query if the window holds a
//      qualifying entry (every entry of the window lies nearer the start
//      than every other entry of the row).  The warp pushes the indexes of
//      the others onto a queue in shared memory (one atomic a warp).
//   B. The rest (G = PSAC_K8_GROUP lanes a queued query, the block's groups
//      taking the queue in turn): the rest of the own level-0 row's
//      searched side, then the ascent (at each level the row that holds the
//      own position, the entries on the searched side of it, exclusive; a
//      row with none is not read) stopping at the first level with a hit,
//      and the descent (one row a level, its last (first) qualifying
//      entry, or the plain version's default child when none: 0 for
//      prev_lt, T - 1 for next_leq).  The plain version evaluates every
//      level and takes the lowest hit, so the answer is the same.  Each of
//      these row reads takes the window of G * PSAC_K8_WINDOW vectors
//      nearest the query first and the rest of the range only on a miss
//      (PSAC_K8_WINDOW = 0: the whole range in one round); lane g reads
//      vectors wlo + g, wlo + g + G, ..., all of a round's loads before any
//      compare, and one warp reduction (redux) combines the lanes' bests
//      under the group's mask, so control flow stays uniform in a group.
// So a warp of phase A holds 32 queries on one path, and a warp of phase B
// only queries that need more than their window.  The full-width calls'
// queries come in nearly start order, so neighbouring threads read the
// same level-0 rows through L1.  Every level must start on a 16-byte
// boundary (the launcher checks it; build_levels copies a view that does
// not).
//
// PSAC_K8_THREADS, PSAC_K8_QPT (queries per thread), PSAC_K8_WINDOW_A,
// PSAC_K8_GROUP and PSAC_K8_WINDOW are set only by tools/k8_sweep.py's own
// builds; the defaults below are its choice (PERF.md section 6).
// PSAC_K8_WINDOW_A = 0 queues every query (one design throughout).
// PSAC_K8_WINDOW_ONLY builds a variant for timing only: phase A alone,
// writing the miss value for a query its window does not answer, so the
// sweep can split the window's cost from the rest's.  No tensor cores:
// this is comparison work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef PSAC_K8_THREADS
#define PSAC_K8_THREADS 128
#endif
#ifndef PSAC_K8_QPT
#define PSAC_K8_QPT 4
#endif
#ifndef PSAC_K8_WINDOW_A
#define PSAC_K8_WINDOW_A 8
#endif
#ifndef PSAC_K8_GROUP
#define PSAC_K8_GROUP 8
#endif
#ifndef PSAC_K8_WINDOW
#define PSAC_K8_WINDOW 1
#endif
#ifndef PSAC_K8_WINDOW_ONLY
#define PSAC_K8_WINDOW_ONLY 0
#endif

constexpr int T = 128;  // row width of the min tree (ops/walk.py _T)
constexpr int TBITS = 7;
constexpr int THREADS = PSAC_K8_THREADS;
constexpr int QPT = PSAC_K8_QPT;        // queries per thread
constexpr int QB = THREADS * QPT;       // queries per block
constexpr int WA = PSAC_K8_WINDOW_A;    // vectors in phase A's window
constexpr int G = PSAC_K8_GROUP;        // lanes per query in phase B
constexpr int WPL = PSAC_K8_WINDOW;     // vectors per lane, phase B window
constexpr bool WINDOW_ONLY = PSAC_K8_WINDOW_ONLY != 0;
constexpr int MAX_LEVELS = 8;
static_assert(THREADS % 32 == 0 && THREADS <= 1024 && QPT >= 1,
              "threads per block: a multiple of 32 up to 1024");
static_assert(G >= 1 && G <= 32 && 32 % G == 0,
              "lanes per query: a power of two up to 32");
static_assert(WA >= 0 && WA <= 16, "phase A's window: up to 16 vectors");
static_assert(WPL >= 0 && G * WPL <= 32,
              "phase B's window must fit an int32 row's 32 vectors");
static_assert(!WINDOW_ONLY || WA > 0, "the window-only variant needs one");

template <typename V>
struct Levels {
  const V* ptr[MAX_LEVELS];
  long long rows[MAX_LEVELS];
  int count;
};

template <typename V>
struct Vec;
template <>
struct Vec<int32_t> {
  using type = int4;
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const int4& w, int32_t* e) {
    e[0] = w.x;
    e[1] = w.y;
    e[2] = w.z;
    e[3] = w.w;
  }
};
template <>
struct Vec<long long> {
  using type = longlong2;
  static constexpr int N = 2;
  static __device__ __forceinline__ void unpack(const longlong2& w,
                                                long long* e) {
    e[0] = w.x;
    e[1] = w.y;
  }
};

template <typename V, bool STRICT>
__device__ __forceinline__ bool qualifies(V a, V v) {
  return STRICT ? a < v : a <= v;
}

__device__ __forceinline__ long long clamp_row(long long r, long long rows) {
  return r < 0 ? 0 : (r > rows - 1 ? rows - 1 : r);
}

// First vector of a window of W vectors in a row of R that ends (LAST) or
// starts at vector vnear, shifted to stay inside the row.
template <bool LAST>
__device__ __forceinline__ int window_lo(int vnear, int W, int R) {
  return LAST ? max(vnear - W + 1, 0) : min(vnear, R - W);
}

// ---- phase A: one thread, the window of WA vectors next to the own
// position at level 0.  Writes the answer and returns true when the window
// has one (or the query has none at all); false sends it to phase B.
template <typename V, bool STRICT, bool NEXT>
__device__ __forceinline__ bool window_answer(const Levels<V>& lv,
                                              long long st, V v,
                                              int64_t* out) {
  using W = typename Vec<V>::type;
  constexpr int N = Vec<V>::N;
  constexpr int R = T / N;
  const long long s = lv.rows[0] * T;  // the padded length
  if (NEXT ? st >= s : st <= 0) {
    *out = NEXT ? s : -1;
    return true;
  }
  const long long own = NEXT ? (st < 0 ? 0 : st) : st - 1;
  const long long parent = own >> TBITS;
  const int pos = static_cast<int>(own & (T - 1));
  const W* row = reinterpret_cast<const W*>(
      lv.ptr[0] + clamp_row(parent, lv.rows[0]) * T);
  const int wlo = window_lo<!NEXT>(pos / N, WA, R);
  W w[WA > 0 ? WA : 1];
#pragma unroll
  for (int i = 0; i < WA; ++i) w[i] = __ldg(row + wlo + i);
  unsigned long long mask = 0;  // bit b: entry wlo * N + b qualifies
#pragma unroll
  for (int i = 0; i < WA; ++i) {
    V e[N];
    Vec<V>::unpack(w[i], e);
#pragma unroll
    for (int m = 0; m < N; ++m)
      mask |= static_cast<unsigned long long>(qualifies<V, STRICT>(e[m], v))
              << (i * N + m);
  }
  const int lim = pos - wlo * N;  // the own position's bit
  // the searched side: bits <= lim (prev_lt), bits >= lim (next_leq)
  mask &= NEXT ? ~0ull << lim : (2ull << lim) - 1;
  if (mask) {
    *out = parent * T + wlo * N +
           (NEXT ? __ffsll(static_cast<long long>(mask)) - 1
                 : 63 - __clzll(static_cast<long long>(mask)));
    return true;
  }
  if (WINDOW_ONLY) {
    *out = NEXT ? s : -1;
    return true;
  }
  return false;
}

// ---- phase B: G lanes a query

// The mask of the calling lane's group of G lanes in its warp.
__device__ __forceinline__ unsigned group_mask() {
  const unsigned lane = threadIdx.x & 31;
  return (0xffffffffu >> (32 - G)) << (lane & ~static_cast<unsigned>(G - 1));
}

// Lane g's last (LAST) or first offset in [lo, hi] whose entry qualifies,
// over the row's vectors a + g, a + g + G, ... up to COUNT of them that lie
// in [a, b]; -1 (LAST) or T when none.  All the loads come before any
// compare.
template <typename V, bool STRICT, bool LAST, int COUNT>
__device__ __forceinline__ int lane_best(const V* row, int g, int a, int b,
                                         int lo, int hi, V v) {
  using W = typename Vec<V>::type;
  constexpr int N = Vec<V>::N;
  W w[COUNT > 0 ? COUNT : 1];
#pragma unroll
  for (int i = 0; i < COUNT; ++i) {
    const int c = a + g + G * i;
    if (c <= b) w[i] = __ldg(reinterpret_cast<const W*>(row) + c);
  }
  int best = LAST ? -1 : T;
#pragma unroll
  for (int i = 0; i < COUNT; ++i) {
    const int c = a + g + G * i;
    if (c > b) continue;
    V e[N];
    Vec<V>::unpack(w[i], e);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int j = c * N + m;
      if (j >= lo && j <= hi && qualifies<V, STRICT>(e[m], v))
        best = LAST ? max(best, j) : min(best, j);
    }
  }
  return best;
}

// The group's best of its lanes' bests: every lane ends with it.
template <bool LAST>
__device__ __forceinline__ int group_best(unsigned gmask, int best) {
  if (G == 1) return best;
  return LAST ? __reduce_max_sync(gmask, best)
              : __reduce_min_sync(gmask, best);
}

// The last (LAST) or first offset of the row in [lo, hi] (0 <= lo <= hi <
// T) whose entry qualifies; -1 (LAST) or T when none.  The window next to
// the near end (hi for LAST, lo for first) first, the rest of [lo, hi]
// only when the window has no answer (PSAC_K8_WINDOW = 0: the whole range
// in one round).
template <typename V, bool STRICT, bool LAST>
__device__ __forceinline__ int find(unsigned gmask, int g, const V* row, V v,
                                    int lo, int hi) {
  constexpr int N = Vec<V>::N;
  constexpr int R = T / N;  // vectors in a row
  if constexpr (WPL == 0) {
    constexpr int ALL_N = (R + G - 1) / G;  // a row's vectors a lane
    return group_best<LAST>(gmask, lane_best<V, STRICT, LAST, ALL_N>(
                                       row, g, lo / N, hi / N, lo, hi, v));
  } else {
    constexpr int WV = G * WPL;                   // vectors in the window
    constexpr int REST_N = (R - WV + G - 1) / G;  // rest's vectors a lane
    const int wlo = window_lo<LAST>(LAST ? hi / N : lo / N, WV, R);
    const int best = group_best<LAST>(
        gmask, lane_best<V, STRICT, LAST, WPL>(row, g, wlo, wlo + WV - 1, lo,
                                               hi, v));
    if (LAST ? best >= 0 : best < T) return best;
    // the rest of the searched side, beyond the window
    const int a = LAST ? lo / N : wlo + WV;
    const int b = LAST ? wlo - 1 : hi / N;
    if (a > b) return best;
    return group_best<LAST>(
        gmask, lane_best<V, STRICT, LAST, REST_N>(row, g, a, b, lo, hi, v));
  }
}

// Phase B's search of the row that holds the own position at level k: the
// entries up to (from) it, inclusive on level 0 and exclusive above, on
// level 0 without phase A's window.  Returns the offset of the last
// (first) qualifying entry, -1 (prev_lt) or T when none (also when the row
// has no entry on the searched side, which is then not read).
template <typename V, bool STRICT, bool NEXT>
__device__ __forceinline__ int level_find(const Levels<V>& lv, int k,
                                          long long own, V v, unsigned gmask,
                                          int g) {
  constexpr int N = Vec<V>::N;
  constexpr int R = T / N;
  const long long parent = own >> TBITS;
  const int pos = static_cast<int>(own & (T - 1));
  int lo = 0, hi = T - 1;
  if (NEXT)
    lo = k > 0 ? pos + 1
               : (WA > 0 ? (window_lo<false>(pos / N, WA, R) + WA) * N : pos);
  else
    hi = k > 0 ? pos - 1
               : (WA > 0 ? window_lo<true>(pos / N, WA, R) * N - 1 : pos);
  if (lo > hi) return NEXT ? T : -1;
  const V* row = lv.ptr[k] + clamp_row(parent, lv.rows[k]) * T;
  return find<V, STRICT, !NEXT>(gmask, g, row, v, lo, hi);
}

// Phase B of a query that phase A left: the rest of the own level-0 row,
// the ascent, stopping at the first level with a hit, and the descent, one
// row a level (the last (first) qualifying child, or the plain version's
// default child when none: 0 for prev_lt, T - 1 for next_leq).
template <typename V, bool STRICT, bool NEXT>
__device__ __forceinline__ void climb(const Levels<V>& lv, long long st, V v,
                                      int64_t* out) {
  const unsigned gmask = group_mask();
  const int g = threadIdx.x & (G - 1);
  const long long s = lv.rows[0] * T;
  if (NEXT ? st >= s : st <= 0) {  // only without phase A
    if (g == 0) *out = NEXT ? s : -1;
    return;
  }
  long long own = NEXT ? (st < 0 ? 0 : st) : st - 1, node = -1;
  int hit = -1;
  for (int k = 0; k < lv.count; ++k) {
    const int b = level_find<V, STRICT, NEXT>(lv, k, own, v, gmask, g);
    if (NEXT ? b < T : b >= 0) {
      hit = k;
      node = (own >> TBITS) * T + b;
      break;
    }
    own >>= TBITS;
  }
  if (hit < 0) {
    if (g == 0) *out = NEXT ? s : -1;
    return;
  }
  for (int k = hit; k >= 1; --k) {
    const V* row = lv.ptr[k - 1] + clamp_row(node, lv.rows[k - 1]) * T;
    const int b = find<V, STRICT, !NEXT>(gmask, g, row, v, 0, T - 1);
    node = node * T + (NEXT ? (b < T ? b : T - 1) : (b >= 0 ? b : 0));
  }
  if (g == 0) *out = node;
}

// Push the block-local index li onto a queue in shared memory: one atomic
// for the lanes of the warp that push.
__device__ __forceinline__ void push(bool left, int li, int* queue,
                                     int* count) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, left);
  if (!ballot) return;
  int slot = 0;
  if (lane == 0) slot = atomicAdd(count, __popc(ballot));
  slot = __shfl_sync(0xffffffffu, slot, 0);
  if (left) queue[slot + __popc(ballot & ((1u << lane) - 1))] = li;
}

template <typename V, bool STRICT, bool NEXT>
__global__ void __launch_bounds__(THREADS)
walk_kernel(Levels<V> lv, const int64_t* __restrict__ start,
            const V* __restrict__ val, int64_t* __restrict__ out,
            long long q) {
  __shared__ int queue[QB];
  __shared__ int queued;
  const long long base = static_cast<long long>(blockIdx.x) * QB;
  if (threadIdx.x == 0) queued = 0;
  __syncthreads();
  // phase A: one thread a query, its window (none at WA = 0)
#pragma unroll
  for (int t = 0; t < QPT; ++t) {
    const int li = t * THREADS + threadIdx.x;
    const long long qi = base + li;
    bool left = qi < q;
    if constexpr (WA > 0)
      left = left &&
             !window_answer<V, STRICT, NEXT>(lv, start[qi], val[qi], out + qi);
    if (!WINDOW_ONLY) push(left, li, queue, &queued);
  }
  __syncthreads();
  if (WINDOW_ONLY) return;
  // phase B: G lanes a queued query, the block's groups in turn
  const int n = queued;
  for (int i = threadIdx.x / G; i < n; i += THREADS / G) {
    const long long qi = base + queue[i];
    climb<V, STRICT, NEXT>(lv, start[qi], val[qi], out + qi);
  }
}

template <typename V, bool NEXT>
int walk(const void* const* ptrs, const long long* rows, int count,
         const int64_t* start, const V* val, int64_t* out, long long q,
         int strict, cudaStream_t stream) {
  if (count < 1 || count > MAX_LEVELS || q < 0) return cudaErrorInvalidValue;
  Levels<V> lv{};
  for (int k = 0; k < count; ++k) {
    if (rows[k] < 1 || reinterpret_cast<uintptr_t>(ptrs[k]) % 16)
      return cudaErrorInvalidValue;
    lv.ptr[k] = static_cast<const V*>(ptrs[k]);
    lv.rows[k] = rows[k];
  }
  lv.count = count;
  if (q == 0) return cudaGetLastError();
  const long long blocks = (q + QB - 1) / QB;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  if (strict)
    walk_kernel<V, true, NEXT><<<nb, THREADS, 0, stream>>>(lv, start, val,
                                                           out, q);
  else
    walk_kernel<V, false, NEXT><<<nb, THREADS, 0, stream>>>(lv, start, val,
                                                            out, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs / rows: host arrays of the `count` levels' device pointers and row
// counts, level 0 first.  Returns the CUDA error of the launch, 0 if none.
int psac_walk_prev_lt_i32(const void* const* ptrs, const long long* rows,
                          int count, const int64_t* start, const int32_t* v,
                          int64_t* out, long long q, int strict,
                          void* stream) {
  return walk<int32_t, false>(ptrs, rows, count, start, v, out, q, strict,
                              static_cast<cudaStream_t>(stream));
}

int psac_walk_prev_lt_i64(const void* const* ptrs, const long long* rows,
                          int count, const int64_t* start, const long long* v,
                          int64_t* out, long long q, int strict,
                          void* stream) {
  return walk<long long, false>(ptrs, rows, count, start, v, out, q, strict,
                              static_cast<cudaStream_t>(stream));
}

int psac_walk_next_leq_i32(const void* const* ptrs, const long long* rows,
                           int count, const int64_t* start, const int32_t* v,
                           int64_t* out, long long q, int strict,
                           void* stream) {
  return walk<int32_t, true>(ptrs, rows, count, start, v, out, q, strict,
                             static_cast<cudaStream_t>(stream));
}

int psac_walk_next_leq_i64(const void* const* ptrs, const long long* rows,
                           int count, const int64_t* start, const long long* v,
                           int64_t* out, long long q, int strict,
                           void* stream) {
  return walk<long long, true>(ptrs, rows, count, start, v, out, q, strict,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
