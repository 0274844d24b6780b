// The DESA's blind search for Hopper (sm_90a): K7.
//
// Replaces psac_tpu/models/desa.py::_blind_search (with
// psac_tpu/ops/rmq.py::query_arg_rmq), which XLA fuses on the TPU into one
// lax.while_loop: per pattern, from an inclusive SA range [l, r] of a slab,
// walk the virtual suffix-tree intervals with the leftmost argmin of the
// LCP and the left-branching characters Lc until the range is one row or
// the matched depth q covers the pattern.  The TPU walks the whole batch in
// lockstep, one step per loop trip for every pattern, and compacts the
// active set at fixed rungs so the finished majority stops taxing the deep
// tail; the port's plain version does the same from the host, reading the
// active count back every few steps.  None of that carries over: one launch
// takes the batch, and each pattern is walked to its own end.  There is no
// lockstep, no compaction and no readback.
//
// The walk, per pattern, is the JAX `body` step for step:
//   * inner (phase 0): c = P[q]; if Lc[i] == c the range narrows to
//     [l, i - 1] and the walk goes to the fix phase; otherwise l moves to i,
//     and unless that leaves one row, i becomes the leftmost argmin of
//     LCP[i + 1 .. r]; the walk stays inner while LCP[i] == q;
//   * fix (phase 1): if LCP[i] == q the next child is the argmin of
//     LCP[l + 1 .. r] (descent on l < r, not the C++ reference's
//     l + 1 < r, which loses the split of two-row intervals), or l itself;
//     q becomes that row's LCP; the walk ends unless q < |P|, l < r and
//     l < i;
//   * a hang guard of 2 * cap + 64 steps, as on the TPU.
// Every index is clamped as the plain version clamps it, and the argmin is
// `query_arg_rmq` exactly: the least (value, index) pair over the part of
// the range in lo's block, two entries of the doubling table over block
// argmins (read even where no full block lies between, with the value
// taken as INF there, as the plain version reads them), and the part in
// hi's block; each edge part is seeded with (INF, its block's first index).
// So padding rows whose LCP is INF (a TLDT sample's tail, a slab's unused
// capacity) give the same index as in the plain version.
//
// What bounds it: the bytes that this batch's walks must read, each word
// of an input once over the whole batch, and the outputs written once: the
// lengths, start ranges and flags of every pattern, the pattern codes that
// inner steps compare, every LCP word read (the edge parts and the rows
// stepped to), the Lc words of inner steps, and the table entries (value
// and index) of the argmins that span a full block.  Words that several
// patterns read, or that one pattern's inner run reads again in the same
// right edge block, count once (chip_smoke.py replays the walk to count
// them; the replay must end where this kernel does).  The bound's bytes do
// not set the pace.  The walk is a chain of dependent steps, and one thread
// per pattern scanning its edge parts four words at a time spent about
// eleven dependent load trips on each argmin.  On a slab of 2^26 rows the
// argmins then read scattered 32-byte sectors of an LCP far larger than
// L2, and more patterns in flight with fewer load instructions each are
// what helps; on the TLDT's sample of 512 rows, which stays in L1, the
// instructions set the pace, and every lane of a group repeats the walk's
// scalar work (PERF.md section 6 has the sweep).
//
// Design: a group of G lanes (a template: 1 or PSAC_K7_GROUP, which the
// sweep builds at 1, 4, 8, 16 and 32) walks one pattern.  Every lane holds
// the walk's state, so control flow is uniform inside a group, and the
// lanes talk only through shuffles of the group's width under the group's
// own mask (no whole-warp barrier: groups of one warp leave one by one).
// An argmin issues its loads in rounds, all the loads of a round before
// any comparison:
//   * the edge parts are read as aligned 16-byte vectors (int4 at int32,
//     longlong2 at int64), lane k taking vectors k, k + G, ... of the two
//     parts together, at most PSAC_K7_ROUND vectors per lane in flight;
//     a range whose parts hold more than PSAC_K7_ROUND * G vectors takes
//     further rounds (at the default four per lane: never at G = 32, at
//     G = 16 only for int64 parts over 64 vectors, at G = 4 for parts
//     over 16 vectors);
//   * where full blocks lie between, lanes 0 and 1 read the two table
//     entries (value and index) in the same round; lane 0 also takes the
//     two seeds;
//   * a lane meets its words in increasing order and keeps the first of
//     its least; a word that a vector carries outside [lo, hi] counts as
//     INF, which never beats the left seed (INF, a block start <= lo), so
//     the candidate set's least pair is the plain version's;
//   * a log2(G)-step xor-shuffle tree combines the lanes' pairs by the
//     same rule (least value, then least index), so every lane ends with
//     the answer.  Its value is the LCP at that index unless it is INF, so
//     the row's LCP is reread only then;
//   * where no full block lies between, the table entries carry INF and
//     can only win a range whose words are all INF (padding rows): their
//     indexes are read in a second round then, and only then.
// In-slab indices are 32-bit (cap < 2^31).  The grid has one group per
// pattern.  The lanes fit the slab: a slab of at most PSAC_K7_NARROW_CAP
// rows (a TLDT sample) stays in the caches, where the lanes' repeated
// scalar work sets the pace, and is walked with one lane per pattern; a
// larger one with PSAC_K7_GROUP lanes.  PSAC_K7_GROUP, PSAC_K7_THREADS
// (threads per block), PSAC_K7_ROUND (vectors per lane in a round) and
// PSAC_K7_NARROW_CAP are set only by tools/k7_sweep.py's own builds; the
// defaults below are its fastest (PERF.md section 6), and
// psac_blind_search_shape reports the shape a launch takes.  Values are
// int32 or int64 (a template); the slab's LCP must be 16-byte aligned and
// cap a multiple of the vector's width (the launcher checks both).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef PSAC_K7_GROUP
#define PSAC_K7_GROUP 4
#endif
#ifndef PSAC_K7_THREADS
#define PSAC_K7_THREADS 256
#endif
#ifndef PSAC_K7_ROUND
#define PSAC_K7_ROUND 4
#endif
#ifndef PSAC_K7_NARROW_CAP
#define PSAC_K7_NARROW_CAP (1LL << 20)
#endif

constexpr int WIDE = PSAC_K7_GROUP;      // lanes per pattern on a wide slab
constexpr int THREADS = PSAC_K7_THREADS;  // per block
constexpr int MAX_BLOCK = 128;  // the largest RMQ block the launcher takes
// 1024 threads per SM must fit, which caps a thread at 64 registers
constexpr int MIN_BLOCKS = 1024 / THREADS;
static_assert(THREADS % 32 == 0 && THREADS <= 1024 && 32 % WIDE == 0,
              "threads per block: a multiple of 32; lanes: a divisor of 32");

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

// The 16-byte vector of a value type and its width in words.
template <typename T>
struct Vec;
template <>
struct Vec<int32_t> {
  using type = int4;
  static constexpr int n = 4;
  static constexpr int shift = 2;
  static __device__ __forceinline__ int32_t at(const int4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<int64_t> {
  using type = longlong2;
  static constexpr int n = 2;
  static constexpr int shift = 1;
  static __device__ __forceinline__ int64_t at(const longlong2& v, int e) {
    return e == 0 ? v.x : v.y;
  }
};

template <typename T>
struct Args {
  const int32_t* pat;    // (B, Lmax) pattern codes
  const int32_t* lens;   // (B,) pattern lengths
  const int32_t* l0;     // (B,) inclusive in-slab start ranges
  const int32_t* r0;
  const bool* need;      // (B,) patterns to walk
  const T* lcp;          // (cap,) slab LCP, 16-byte aligned
  const int32_t* lc;     // (cap,) slab Lc
  const T* tab_v;        // (levels, nb) doubling table: block minima
  const int32_t* tab_a;  // (levels, nb) their leftmost argmins
  int32_t* out_l;        // (B,) final ranges
  int32_t* out_r;
  T* out_q;              // (B,) matched depth
  int32_t* out_steps;    // (B,) steps taken
  long long B, cap, nb, last, max_steps;
  int Lmax, bshift;
};

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Keep the least (value, index) pair: the leftmost-min combine of
// psac_tpu/ops/rmq.py::_argmin_op.
template <typename T>
__device__ __forceinline__ void take_min(T& bv, int& bi, T v, int i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// The shuffle mask of the thread's group: its G lanes of the warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// 16-byte vectors per lane in one round: enough for both edge parts of a
// MAX_BLOCK block at G lanes, at most PSAC_K7_ROUND.
template <typename T, int G>
struct Round {
  static constexpr int need = (2 * MAX_BLOCK / Vec<T>::n + G - 1) / G;
  static constexpr int v = need < PSAC_K7_ROUND ? need : PSAC_K7_ROUND;
};

// Leftmost argmin of LCP over [lo, hi] after the plain version's clamps
// (lo into [0, cap - 1], hi to max(hi, lo) and into [0, cap - 1]), taken
// by the group; every lane returns it and sets `at` to the LCP there.
template <typename T, int G>
__device__ __forceinline__ int arg_rmq(const Args<T>& a, int lo, int hi,
                                       int lane, unsigned mask, T& at) {
  using V = typename Vec<T>::type;
  constexpr int SH = Vec<T>::shift;
  constexpr int R = Round<T, G>::v;
  constexpr T INF = Inf<T>::v;
  const int cap1 = static_cast<int>(a.cap - 1);
  lo = clamp_i(lo, 0, cap1);
  hi = clamp_i(hi < lo ? lo : hi, 0, cap1);
  const int bl = lo >> a.bshift;
  const int bh = hi >> a.bshift;
  const int lend = bl == bh ? hi : ((bl + 1) << a.bshift) - 1;
  // the full blocks (bl, bh) from two table entries, lanes 0 and 1
  const int len = bh - 1 - bl;
  const int lev = len > 0 ? 31 - __clz(len) : 0;
  const long long t0 =
      min(max(lev * a.nb + bl + 1, 0LL), a.last);
  const long long t1 =
      min(max(lev * a.nb + bh - 1 - (1LL << lev) + 1, 0LL), a.last);
  T tv0 = INF, tv1 = INF;
  int ta0 = INT_MAX, ta1 = INT_MAX;
  if (len > 0 && lane == 0) {
    tv0 = __ldg(a.tab_v + t0);
    ta0 = __ldg(a.tab_a + t0);
  }
  if (len > 0 && lane == (G > 1 ? 1 : 0)) {
    tv1 = __ldg(a.tab_v + t1);
    ta1 = __ldg(a.tab_a + t1);
  }
  // the edge parts as 16-byte vectors: the left part's, then the right's;
  // a lane meets its words in increasing order, so a strict < keeps the
  // leftmost of its least words
  const V* vp = reinterpret_cast<const V*>(a.lcp);
  const int vl = lo >> SH;
  const int nl = (lend >> SH) - vl + 1;
  const int vr = (bh << a.bshift) >> SH;
  const int n = bl != bh ? nl + (hi >> SH) - vr + 1 : nl;
  const unsigned span = static_cast<unsigned>(hi - lo);
  T bv = INF;
  int bi = INT_MAX;
  for (int base = 0; base < n; base += G * R) {
    V v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int c = base + lane + k * G;
      if (c < n) v[k] = __ldg(vp + (c < nl ? vl + c : vr + (c - nl)));
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int c = base + lane + k * G;
      if (c < n) {
        const int w = (c < nl ? vl + c : vr + (c - nl)) << SH;
#pragma unroll
        for (int e = 0; e < Vec<T>::n; ++e) {
          const T x = Vec<T>::at(v[k], e);
          if (static_cast<unsigned>(w + e - lo) <= span && x < bv) {
            bv = x;
            bi = w + e;
          }
        }
      }
    }
  }
  if (lane == 0) {
    take_min(bv, bi, INF, bl << a.bshift);
    if (bl != bh) take_min(bv, bi, INF, bh << a.bshift);
    take_min(bv, bi, tv0, ta0);
  }
  if (lane == (G > 1 ? 1 : 0)) take_min(bv, bi, tv1, ta1);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(mask, bv, off, G);
    const int oi = __shfl_xor_sync(mask, bi, off, G);
    take_min(bv, bi, ov, oi);
  }
  if (len <= 0 && bv == INF) {
    // no full block between, and every word of the range INF: the table
    // entries' indexes are candidates too, with value INF (the plain
    // version reads them whatever the span); rare, so a second round
    take_min(bv, bi, INF, __ldg(a.tab_a + t0));
    take_min(bv, bi, INF, __ldg(a.tab_a + t1));
  }
  // a value under INF is a word's or a table entry's: the LCP at bi
  at = bv < INF ? bv : __ldg(a.lcp + bi);
  return bi;
}

// Walk pattern b to its end with the group; lane 0 writes the outputs.
// `li` is always LCP[clamp(i)].  In-slab indices fit in int (cap < 2^31).
template <typename T, int G>
__device__ __forceinline__ void walk(const Args<T>& a, long long b, int lane,
                                     unsigned mask) {
  const int cap1 = static_cast<int>(a.cap - 1);
  const T m = static_cast<T>(__ldg(a.lens + b));
  const int32_t* p = a.pat + b * a.Lmax;
  int l = __ldg(a.l0 + b);
  int r = __ldg(a.r0 + b);
  T li;
  int i = arg_rmq<T, G>(a, l + 1, r, lane, mask, li);
  T q = li;
  bool done = !a.need[b] || !(q < m && l < r && l < i);
  int phase = 0;
  long long steps = 0;
  while (!done && steps < a.max_steps) {
    if (phase == 0) {
      const int col = static_cast<int>(
          q < 0 ? 0 : (q > a.Lmax - 1 ? a.Lmax - 1 : q));
      const int32_t c = __ldg(p + col);
      if (__ldg(a.lc + clamp_i(i, 0, cap1)) == c) {
        r = i - 1;  // the child starting at i matches: go down into [l, i-1]
        phase = 1;
      } else if (i == r) {
        l = i;  // the last child: one row left
        phase = 1;
      } else {
        const bool below = i < r;
        l = i;
        i = arg_rmq<T, G>(a, l + 1, r, lane, mask, li);
        if (!(below && li == q)) phase = 1;
      }
    } else {
      if (li == q && l < r) {
        i = arg_rmq<T, G>(a, l + 1, r, lane, mask, li);
        q = li;
      } else if (li == q) {
        i = l;
        li = __ldg(a.lcp + clamp_i(l, 0, cap1));
        q = li;
      } else {
        q = li;
      }
      done = !(q < m && l < r && l < i);
      phase = 0;
    }
    ++steps;
  }
  if (lane == 0) {
    a.out_l[b] = l;
    a.out_r[b] = r;
    a.out_q[b] = q;
    a.out_steps[b] = static_cast<int32_t>(steps);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
blind_search_kernel(const __grid_constant__ Args<T> a) {
  const long long b =
      static_cast<long long>(blockIdx.x) * (THREADS / G) + threadIdx.x / G;
  if (b < a.B) walk<T, G>(a, b, threadIdx.x & (G - 1), group_mask<G>());
}

// Lanes per pattern on a slab of `cap` rows.
int group_for(long long cap) { return cap <= PSAC_K7_NARROW_CAP ? 1 : WIDE; }

template <typename T>
int blind_search(const int32_t* pat, const int32_t* lens, const int32_t* l0,
                 const int32_t* r0, const bool* need, const T* lcp,
                 const int32_t* lc, const T* tab_v, const int32_t* tab_a,
                 int32_t* out_l, int32_t* out_r, T* out_q, int32_t* out_steps,
                 long long B, int Lmax, long long cap, long long nb,
                 int levels, int block, long long max_steps,
                 cudaStream_t stream) {
  if (block <= 0 || block > MAX_BLOCK || (block & (block - 1)) != 0 ||
      Lmax < 1 || cap < 1 || cap > INT_MAX || nb * block != cap ||
      levels < 1 || (cap * static_cast<long long>(sizeof(T))) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lcp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Args<T> a;
  a.pat = pat;
  a.lens = lens;
  a.l0 = l0;
  a.r0 = r0;
  a.need = need;
  a.lcp = lcp;
  a.lc = lc;
  a.tab_v = tab_v;
  a.tab_a = tab_a;
  a.out_l = out_l;
  a.out_r = out_r;
  a.out_q = out_q;
  a.out_steps = out_steps;
  a.B = B;
  a.cap = cap;
  a.nb = nb;
  a.last = static_cast<long long>(levels) * nb - 1;
  a.max_steps = max_steps;
  a.Lmax = Lmax;
  a.bshift = 0;
  while ((1 << a.bshift) < block) ++a.bshift;
  const int group = group_for(cap);
  const long long blocks = (B + THREADS / group - 1) / (THREADS / group);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto k = group == 1 ? blind_search_kernel<T, 1>
                      : blind_search_kernel<T, WIDE>;
  k<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch, 0 if none.
int psac_blind_search_i32(const int32_t* pat, const int32_t* lens,
                          const int32_t* l0, const int32_t* r0,
                          const bool* need, const int32_t* lcp,
                          const int32_t* lc, const int32_t* tab_v,
                          const int32_t* tab_a, int32_t* out_l,
                          int32_t* out_r, int32_t* out_q, int32_t* out_steps,
                          long long B, int Lmax, long long cap, long long nb,
                          int levels, int block, long long max_steps,
                          void* stream) {
  return blind_search<int32_t>(pat, lens, l0, r0, need, lcp, lc, tab_v, tab_a,
                               out_l, out_r, out_q, out_steps, B, Lmax, cap,
                               nb, levels, block, max_steps,
                               static_cast<cudaStream_t>(stream));
}

int psac_blind_search_i64(const int32_t* pat, const int32_t* lens,
                          const int32_t* l0, const int32_t* r0,
                          const bool* need, const int64_t* lcp,
                          const int32_t* lc, const int64_t* tab_v,
                          const int32_t* tab_a, int32_t* out_l,
                          int32_t* out_r, int64_t* out_q, int32_t* out_steps,
                          long long B, int Lmax, long long cap, long long nb,
                          int levels, int block, long long max_steps,
                          void* stream) {
  return blind_search<int64_t>(pat, lens, l0, r0, need, lcp, lc, tab_v, tab_a,
                               out_l, out_r, out_q, out_steps, B, Lmax, cap,
                               nb, levels, block, max_steps,
                               static_cast<cudaStream_t>(stream));
}

// The shape of a launch on a slab of `cap` rows of int64 (`i64`) or int32
// values: out = {lanes per pattern, threads per block, the most 16-byte
// vectors a lane loads in one round}.  Returns 0.
int psac_blind_search_shape(long long cap, int i64, int* out) {
  const int group = group_for(cap);
  out[0] = group;
  out[1] = THREADS;
  out[2] = i64 ? (group == 1 ? Round<int64_t, 1>::v : Round<int64_t, WIDE>::v)
               : (group == 1 ? Round<int32_t, 1>::v : Round<int32_t, WIDE>::v);
  return 0;
}

}  // extern "C"
