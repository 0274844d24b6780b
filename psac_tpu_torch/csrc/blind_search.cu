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
// takes the batch, and each pattern is walked to its own end by one thread.
// There is no lockstep, no compaction and no readback.
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
// hi's block; each edge scan starts from (INF, the block's first index).
// So padding rows whose LCP is INF (a TLDT sample's tail, a slab's unused
// capacity) give the same index as in the plain version.
//
// What bounds it: the bytes that this batch's walks must read, each word
// of an input once over the whole batch, and the outputs written once: the
// lengths, start ranges and flags of every pattern, the pattern codes that
// inner steps compare, every LCP word read (the edge scans and the rows
// stepped to), the Lc words of inner steps, and the table entries (value
// and index) of the argmins that span a full block.  Words that several
// patterns read, or that one pattern's inner run scans again in the same
// right edge block, count once (chip_smoke.py replays the walk to count
// them; the replay must end where this kernel does).  The walk is a chain
// of dependent loads, one step after another, so latency, not the bound's
// bytes, sets its pace; the edge scans issue four independent loads at a
// time.  Values are int32 or int64 (a template); indices are 64-bit inside.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // one pattern per thread

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
struct Args {
  const int32_t* pat;    // (B, Lmax) pattern codes
  const int32_t* lens;   // (B,) pattern lengths
  const int32_t* l0;     // (B,) inclusive in-slab start ranges
  const int32_t* r0;
  const bool* need;      // (B,) patterns to walk
  const T* lcp;          // (cap,) slab LCP
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

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Keep the least (value, index) pair: the leftmost-min combine of
// psac_tpu/ops/rmq.py::_argmin_op.
template <typename T>
__device__ __forceinline__ void take_min(T& bv, long long& bi, T v,
                                         long long i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Least (LCP[j], j) over j in [from, to], seeded with (INF, seed).
template <typename T>
__device__ __forceinline__ void scan_min(const T* __restrict__ lcp,
                                         long long from, long long to,
                                         T& bv, long long& bi) {
  long long j = from;
  for (; j + 3 <= to; j += 4) {
    const T v0 = __ldg(lcp + j);
    const T v1 = __ldg(lcp + j + 1);
    const T v2 = __ldg(lcp + j + 2);
    const T v3 = __ldg(lcp + j + 3);
    if (v0 < bv) { bv = v0; bi = j; }
    if (v1 < bv) { bv = v1; bi = j + 1; }
    if (v2 < bv) { bv = v2; bi = j + 2; }
    if (v3 < bv) { bv = v3; bi = j + 3; }
  }
  for (; j <= to; ++j) {
    const T v = __ldg(lcp + j);
    if (v < bv) { bv = v; bi = j; }
  }
}

// Leftmost argmin of LCP over [lo, hi] after the plain version's clamps
// (lo into [0, cap - 1], hi to max(hi, lo) and into [0, cap - 1]).
template <typename T>
__device__ long long arg_rmq(const Args<T>& a, long long lo, long long hi) {
  lo = clamp_ll(lo, 0, a.cap - 1);
  hi = clamp_ll(hi < lo ? lo : hi, 0, a.cap - 1);
  const long long bl = lo >> a.bshift;
  const long long bh = hi >> a.bshift;
  T bv = Inf<T>::v;
  long long bi = bl << a.bshift;
  scan_min(a.lcp, lo, bl == bh ? hi : ((bl + 1) << a.bshift) - 1, bv, bi);
  // the full blocks (bl, bh) from two table entries
  const long long first = bl + 1;
  const long long len = bh - 1 - first + 1;
  const int lev = len > 0 ? 63 - __clzll(len) : 0;
  const long long i1 = clamp_ll(lev * a.nb + first, 0, a.last);
  const long long i2 =
      clamp_ll(lev * a.nb + bh - 1 - (1LL << lev) + 1, 0, a.last);
  take_min(bv, bi, len > 0 ? __ldg(a.tab_v + i1) : Inf<T>::v,
           static_cast<long long>(__ldg(a.tab_a + i1)));
  take_min(bv, bi, len > 0 ? __ldg(a.tab_v + i2) : Inf<T>::v,
           static_cast<long long>(__ldg(a.tab_a + i2)));
  if (bl != bh) {
    T rv = Inf<T>::v;
    long long ri = bh << a.bshift;
    scan_min(a.lcp, bh << a.bshift, hi, rv, ri);
    take_min(bv, bi, rv, ri);
  }
  return bi;
}

template <typename T>
__device__ __forceinline__ T lcp_at(const Args<T>& a, long long i) {
  return __ldg(a.lcp + clamp_ll(i, 0, a.cap - 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blind_search_kernel(const __grid_constant__ Args<T> a) {
  const long long b =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const long long m = a.lens[b];
  const int32_t* p = a.pat + b * a.Lmax;
  long long l = a.l0[b];
  long long r = a.r0[b];
  long long i = arg_rmq(a, l + 1, r);
  T q = lcp_at(a, i);
  bool done = !a.need[b] ||
              !(static_cast<long long>(q) < m && l < r && l < i);
  int phase = 0;
  long long steps = 0;
  while (!done && steps < a.max_steps) {
    if (phase == 0) {
      const long long col = clamp_ll(static_cast<long long>(q), 0, a.Lmax - 1);
      const int32_t c = __ldg(p + col);
      if (__ldg(a.lc + clamp_ll(i, 0, a.cap - 1)) == c) {
        r = i - 1;  // the child starting at i matches: go down into [l, i-1]
        phase = 1;
      } else if (i == r) {
        l = i;  // the last child: one row left
        phase = 1;
      } else {
        const bool below = i < r;
        l = i;
        i = arg_rmq(a, l + 1, r);
        if (!(below && lcp_at(a, i) == q)) phase = 1;
      }
    } else {
      const T lcpi = lcp_at(a, i);
      if (lcpi == q && l < r) {
        i = arg_rmq(a, l + 1, r);
        q = lcp_at(a, i);
      } else if (lcpi == q) {
        i = l;
        q = lcp_at(a, l);
      } else {
        q = lcpi;
      }
      done = !(static_cast<long long>(q) < m && l < r && l < i);
      phase = 0;
    }
    ++steps;
  }
  a.out_l[b] = static_cast<int32_t>(l);
  a.out_r[b] = static_cast<int32_t>(r);
  a.out_q[b] = q;
  a.out_steps[b] = static_cast<int32_t>(steps);
}

template <typename T>
int blind_search(const int32_t* pat, const int32_t* lens, const int32_t* l0,
                 const int32_t* r0, const bool* need, const T* lcp,
                 const int32_t* lc, const T* tab_v, const int32_t* tab_a,
                 int32_t* out_l, int32_t* out_r, T* out_q, int32_t* out_steps,
                 long long B, int Lmax, long long cap, long long nb,
                 int levels, int block, long long max_steps,
                 cudaStream_t stream) {
  if (block <= 0 || (block & (block - 1)) != 0 || Lmax < 1 || cap < 1 ||
      nb * block != cap || levels < 1)
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
  const long long blocks = (B + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  blind_search_kernel<T>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
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

}  // extern "C"
