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
// Design: a group of G = 8 lanes answers one query (32 queries per block of
// 256 threads).  Each lane holds 16 entries of a 128-entry row, read as
// 16-byte vectors: vector c of the row goes to lane c % G, so one load
// instruction of the group reads 128 contiguous bytes.  The ascent reads the
// row that holds the own position at each level (inclusive at level 0,
// exclusive above) and stops at the first level with a qualifying entry on
// the searched side; the plain version evaluates every level and takes the
// lowest hit, so the answer is the same.  The descent reads one row per
// level and takes its last (first) qualifying entry.  Each pick is a lane's
// own best index, then three xor-shuffles in the group.  Queries of the
// full-width calls come in start order, so neighbouring groups read the
// same level-0 rows through L1 and L2.  Every level must start on a 16-byte
// boundary (the launcher checks it; build_levels copies a view that does
// not).
//
// What bounds it: bytes.  Each query's start (8 B), v (4 or 8 B) and answer
// (8 B) once, and each level's words once: about 403 MB, 0.120 ms at 3.35
// TB/s, for 2^24 queries over 2^24 int32 rows.  A query whose answer lies in
// its own row reads one row (512 B of int32), mostly from L1; the cost
// beyond that is the climb of the queries whose answer lies far away, two
// dependent row reads a level.  No tensor cores: this is comparison work.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int T = 128;  // row width of the min tree (ops/walk.py _T)
constexpr int TBITS = 7;
constexpr int G = 8;  // lanes per query
constexpr int THREADS = 256;
constexpr int QPB = THREADS / G;  // queries per block
constexpr int PER_LANE = T / G;   // row entries per lane
constexpr int MAX_LEVELS = 8;

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

// Row offset of entry e[m] of lane g: vector c = g + G * (m / N), entry
// m % N of it.
template <typename V>
__device__ __forceinline__ int offset_of(int g, int m) {
  constexpr int N = Vec<V>::N;
  return (g + G * (m / N)) * N + m % N;
}

template <typename V>
__device__ __forceinline__ void load_row(const V* row, int g,
                                         V (&e)[PER_LANE]) {
  using W = typename Vec<V>::type;
  constexpr int N = Vec<V>::N;
#pragma unroll
  for (int i = 0; i < PER_LANE / N; ++i)
    Vec<V>::unpack(__ldg(reinterpret_cast<const W*>(row) + g + G * i),
                   e + i * N);
}

template <typename V, bool STRICT>
__device__ __forceinline__ bool qualifies(V a, V v) {
  return STRICT ? a < v : a <= v;
}

__device__ __forceinline__ long long clamp_row(long long r, long long rows) {
  return r < 0 ? 0 : (r > rows - 1 ? rows - 1 : r);
}

// The last (LAST) or first offset in the row whose entry qualifies and
// whose offset lies in [lo, hi]; -1 (LAST) or T (first) when none.
template <typename V, bool STRICT, bool LAST, typename Group>
__device__ __forceinline__ int pick(Group grp, const V (&e)[PER_LANE], V v,
                                    int lo, int hi) {
  const int g = grp.thread_rank();
  int best = LAST ? -1 : T;
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    const int j = offset_of<V>(g, m);
    if (j >= lo && j <= hi && qualifies<V, STRICT>(e[m], v))
      best = LAST ? max(best, j) : min(best, j);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const int other = grp.shfl_xor(best, o);
    best = LAST ? max(best, other) : min(best, other);
  }
  return best;
}

template <typename V, bool STRICT>
__global__ void __launch_bounds__(THREADS)
prev_lt_kernel(Levels<V> lv, const int64_t* __restrict__ start,
               const V* __restrict__ val, int64_t* __restrict__ out,
               long long q) {
  const auto grp = cg::tiled_partition<G>(cg::this_thread_block());
  const long long qi =
      static_cast<long long>(blockIdx.x) * QPB + threadIdx.x / G;
  if (qi >= q) return;
  const int g = grp.thread_rank();
  const long long st = start[qi];
  if (st <= 0) {
    if (g == 0) out[qi] = -1;
    return;
  }
  const V v = val[qi];
  V e[PER_LANE];
  // ascent: the lowest level whose row holds a qualifying entry left of
  // (or at, on level 0) the own position
  long long own = st - 1, node = -1;
  int hit = -1;
  for (int k = 0; k < lv.count; ++k) {
    const long long parent = own >> TBITS;
    const int pos = static_cast<int>(own & (T - 1));
    load_row<V>(lv.ptr[k] + clamp_row(parent, lv.rows[k]) * T, g, e);
    const int last =
        pick<V, STRICT, true>(grp, e, v, 0, k == 0 ? pos : pos - 1);
    if (last >= 0) {
      hit = k;
      node = parent * T + last;
      break;
    }
    own = parent;
  }
  if (hit < 0) {
    if (g == 0) out[qi] = -1;
    return;
  }
  // descent: the last qualifying child, level by level (0 if none)
  for (int k = hit; k >= 1; --k) {
    load_row<V>(lv.ptr[k - 1] + clamp_row(node, lv.rows[k - 1]) * T, g, e);
    const int last = pick<V, STRICT, true>(grp, e, v, 0, T - 1);
    node = node * T + (last < 0 ? 0 : last);
  }
  if (g == 0) out[qi] = node;
}

template <typename V, bool STRICT>
__global__ void __launch_bounds__(THREADS)
next_leq_kernel(Levels<V> lv, const int64_t* __restrict__ start,
                const V* __restrict__ val, int64_t* __restrict__ out,
                long long q) {
  const auto grp = cg::tiled_partition<G>(cg::this_thread_block());
  const long long qi =
      static_cast<long long>(blockIdx.x) * QPB + threadIdx.x / G;
  if (qi >= q) return;
  const int g = grp.thread_rank();
  const long long s = lv.rows[0] * T;  // the padded length
  const long long st = start[qi];
  if (st >= s) {
    if (g == 0) out[qi] = s;
    return;
  }
  const V v = val[qi];
  V e[PER_LANE];
  // ascent: the lowest level whose row holds a qualifying entry right of
  // (or at, on level 0) the own position
  long long own = st < 0 ? 0 : st, node = -1;
  int hit = -1;
  for (int k = 0; k < lv.count; ++k) {
    const long long parent = own >> TBITS;
    const int pos = static_cast<int>(own & (T - 1));
    load_row<V>(lv.ptr[k] + clamp_row(parent, lv.rows[k]) * T, g, e);
    const int first =
        pick<V, STRICT, false>(grp, e, v, k == 0 ? pos : pos + 1, T - 1);
    if (first < T) {
      hit = k;
      node = parent * T + first;
      break;
    }
    own = parent;
  }
  if (hit < 0) {
    if (g == 0) out[qi] = s;
    return;
  }
  // descent: the first qualifying child, level by level (T - 1 if none)
  for (int k = hit; k >= 1; --k) {
    load_row<V>(lv.ptr[k - 1] + clamp_row(node, lv.rows[k - 1]) * T, g, e);
    const int first = pick<V, STRICT, false>(grp, e, v, 0, T - 1);
    node = node * T + (first < T ? first : T - 1);
  }
  if (g == 0) out[qi] = node;
}

template <typename V, bool NEXT, bool STRICT>
void launch_one(const Levels<V>& lv, const int64_t* start, const V* val,
                int64_t* out, long long q, unsigned blocks,
                cudaStream_t stream) {
  if (NEXT)
    next_leq_kernel<V, STRICT>
        <<<blocks, THREADS, 0, stream>>>(lv, start, val, out, q);
  else
    prev_lt_kernel<V, STRICT>
        <<<blocks, THREADS, 0, stream>>>(lv, start, val, out, q);
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
  const long long blocks = (q + QPB - 1) / QPB;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  if (strict)
    launch_one<V, NEXT, true>(lv, start, val, out, q, nb, stream);
  else
    launch_one<V, NEXT, false>(lv, start, val, out, q, nb, stream);
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
