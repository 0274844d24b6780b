// ANSV scans for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of psac_tpu/ops/nsv_scan.py:
//   * K1 nsv_scan_spine (_spine_kernel): FURTHEST_EQ left matches of the
//     explicit-index stream (xf, gf), with each element's run first after
//     merge/push (fh), and NEAREST_SM left matches of (xn, gn);
//   * K2 nsv_scan_dual (_dual_kernel): left matches of x (typ_l) and of the
//     second array xr (typ_r), any of the three match types;
//   * K3 nsv_scan_left (_scan_kernel): left matches of x, one match type.
//
// Semantics are those of psac_tpu/ops/ansv.py::_left_scan: a monotone stack
// of runs (value, endpoint) where the endpoint is the run's FIRST index for
// FURTHEST_EQ and its LAST index otherwise.  Answers are the stream's
// indices (explicit for K1, positions for K2/K3); -1 means no match and the
// value is then 0.
//
// The TPU grid ran its chunks in order and carried the stack across them.
// Here no kernel keeps a stack: every answer depends on x alone, not on the
// order of a scan.  With PSV<(i) the nearest j < i with x[j] < x[i] and
// PSV<=(i) the nearest with x[j] <= x[i]:
//   NEAREST_SM(i)  = PSV<(i)
//   NEAREST_EQ(i)  = PSV<=(i)
//   FURTHEST_EQ(i) = H(PSV<=(i)) (-1 when PSV<=(i) = -1), where H(t), the
//                    head of t's run, is the first j >= PSV<(t) + 1 with
//                    x[j] <= x[t] (everything in (PSV<(t), t] is >= x[t], so
//                    x[H(t)] = x[t]).
// The value is x at the match.  K1's run first after merge/push is H(t)
// when x[t] = x[i] at t = PSV<=(i) (the element merges into the top run),
// else the element itself; K1 maps both through its stream's explicit
// indices g inside the kernel.
//
// The block engine (K1, K2 and K3 alike):
//   * a minima hierarchy per stream: level 0 is x, level k+1 holds the
//     minima of the G = 32-entry groups of level k, one warp-reduction
//     kernel per level until a level has at most G entries (6 levels at
//     2^26).  The levels are the only scratch (s/31 entries per stream);
//   * one thread block per TILE-element tile (the two streams of K1 and K2
//     are the two rows of one grid, blockIdx.y), the tile plus a G-entry
//     halo on its left staged in shared memory with 16-byte loads;
//   * each thread first tries the cheap answer (the neighbour, from shared
//     memory); the queries left over are answered one at a time by the
//     whole warp: a __ballot_sync over a G-entry group and the highest (for
//     a previous match) or lowest (for H) set lane.  A search that misses
//     its group climbs one level, and from the group where it hits descends
//     one ballot per level.  So every search costs at most 2 ballots per
//     level and no thread scans linearly;
//   * FURTHEST_EQ runs three such phases (PSV<=, PSV< of the match, the
//     forward search for H).
// What bounds it: the bytes are one read of each input and one write of
// each output (K1 36 bytes per stream entry, K2 24 per element, K3 12).
// The engine reads x about twice (the level build and the tile) and keeps
// the levels (1/31 of x) in L2; the rest of its time goes to the dependent
// loads of the warp searches, which only the many resident warps hide
// (K1 6.6%, K2 4.5%, K3 2.6% of the bound on an NVIDIA H100 80GB HBM3 at
// 700 W).  K1's spine streams are the worst case of a search: in every
// 512-wide tile of the LCP a spine falls (weak prefix minima) and then
// rises, and its falling halves miss their neighbour.  No tensor cores:
// this is comparison work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEAREST_SM = 0;
constexpr int NEAREST_EQ = 1;
constexpr int FURTHEST_EQ = 2;

constexpr int G = 32;          // entries per hierarchy group (one warp)
constexpr int LOG_G = 5;
constexpr int MAX_LEVELS = 8;  // s < 2^31 needs at most 7
constexpr int THREADS = 256;
constexpr int TILE = 1024;     // elements per block (4 per thread)
constexpr int HALO = G;        // staged entries left of the tile
constexpr unsigned FULL = 0xffffffffu;

// lv[0] = x; lv[k] = the minima of the G-entry groups of lv[k - 1].
struct Hier {
  const int32_t* lv[MAX_LEVELS];
  int n[MAX_LEVELS];
  int count;
};

// One stream: its hierarchy, its outputs and its match type.  When g is
// given, answers are written as g[match] (-1 kept), and head, when given,
// receives K1's run first (FURTHEST_EQ only).
struct Side {
  Hier h;
  int32_t* idx;
  int32_t* val;
  const int32_t* g;
  int32_t* head;
  int typ;
};

// out[g] = min(in[g*G .. min((g+1)*G, n))), one warp per group.
__global__ void __launch_bounds__(THREADS)
group_min_kernel(const int32_t* __restrict__ in, int n,
                 int32_t* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const int v = __reduce_min_sync(FULL, e < n ? in[e] : INT32_MAX);
  if ((threadIdx.x & (G - 1)) == 0 && e < n) out[e >> LOG_G] = v;
}

// What a warp's searches read: level 0 through the staged tile where it
// covers the position, the rest of level 0 and the upper levels from
// device memory (L1/L2).  Groups are G-aligned, as is the tile's range, so
// each group read is wholly in or out of the tile: no divergence.
struct Ctx {
  const Hier* h;
  const int32_t* tile;  // staged x[tlo, tlo + TILE + HALO)
  int tlo;
  int lane;
  __device__ __forceinline__ int32_t x(int e) const {
    const unsigned off = static_cast<unsigned>(e - tlo);
    return off < static_cast<unsigned>(TILE + HALO) ? tile[off]
                                                    : __ldg(h->lv[0] + e);
  }
  __device__ __forceinline__ int32_t at(int k, int e) const {
    return k == 0 ? x(e) : __ldg(h->lv[k] + e);
  }
};

template <bool STRICT>
__device__ __forceinline__ bool hit(int32_t a, int32_t v) {
  return STRICT ? a < v : a <= v;
}

// Largest j < i with x[j] < v (STRICT) or x[j] <= v, -1 if none; i and v
// are the same on every lane, and so is the result.
template <bool STRICT>
__device__ int prev_search(const Ctx& c, int i, int32_t v) {
  int p = i;  // exclusive bound at level k
  int k = 0;
  int j;
  for (;;) {
    if (p <= 0) return -1;
    const int lo = (p - 1) & ~(G - 1);
    const int e = lo + c.lane;
    const bool ok = e < p;
    const unsigned b = __ballot_sync(FULL, ok && hit<STRICT>(c.at(k, e), v));
    if (b) {
      j = lo + 31 - __clz(b);
      break;
    }
    if (lo == 0 || k + 1 == c.h->count) return -1;
    p = lo >> LOG_G;
    ++k;
  }
  // every group descended into lies wholly before the bound, so it is full
  while (k > 0) {
    --k;
    const int lo = j << LOG_G;
    const unsigned b = __ballot_sync(FULL, hit<STRICT>(c.at(k, lo + c.lane),
                                                       v));
    j = lo + 31 - __clz(b);
  }
  return j;
}

// Smallest j >= q with x[j] <= v, -1 if none (the callers always have one).
__device__ int next_search(const Ctx& c, int q, int32_t v) {
  int k = 0;
  int j;
  for (;;) {
    const int n = c.h->n[k];
    if (q >= n) return -1;
    const int lo = q & ~(G - 1);
    const int e = lo + c.lane;
    const bool ok = e >= q && e < n;
    const unsigned b = __ballot_sync(FULL, ok && c.at(k, e) <= v);
    if (b) {
      j = lo + __ffs(b) - 1;
      break;
    }
    if (k + 1 == c.h->count) return -1;
    q = (lo >> LOG_G) + 1;
    ++k;
  }
  while (k > 0) {
    --k;
    const int lo = j << LOG_G;
    const int e = lo + c.lane;
    const bool ok = e < c.h->n[k];
    const unsigned b = __ballot_sync(FULL, ok && c.at(k, e) <= v);
    j = lo + __ffs(b) - 1;
  }
  return j;
}

// The lanes with ``need`` set get out = the search from (arg, v), answered
// one lane after another by the whole warp.
template <int KIND>  // 0: PSV<, 1: PSV<=, 2: next <=
__device__ __forceinline__ void warp_search(const Ctx& c, bool need, int arg,
                                            int32_t v, int& out) {
  unsigned m = __ballot_sync(FULL, need);
  while (m) {
    const int q = __ffs(m) - 1;
    m &= m - 1;
    const int qa = __shfl_sync(FULL, arg, q);
    const int32_t qv = __shfl_sync(FULL, v, q);
    const int r = KIND == 0   ? prev_search<true>(c, qa, qv)
                  : KIND == 1 ? prev_search<false>(c, qa, qv)
                              : next_search(c, qa, qv);
    if (c.lane == q) out = r;
  }
}

// Left match of element i (value v) for match type TYP; every lane of the
// warp calls it (inactive lanes only take part in the ballots).
template <int TYP>
__device__ __forceinline__ void answer(const Ctx& c, const Side& sd, int i,
                                       bool active, int32_t v) {
  // PSV (<= for the two equal types): the neighbour first
  int t = -1;
  bool need = false;
  if (active && i > 0) {
    if (hit<TYP == NEAREST_SM>(c.x(i - 1), v)) {
      t = i - 1;
    } else {
      need = true;
    }
  }
  warp_search<TYP == NEAREST_SM ? 0 : 1>(c, need, i, v, t);
  int32_t vt = t >= 0 ? c.x(t) : 0;
  int r = t;
  if (TYP == FURTHEST_EQ) {
    // u = PSV<(t), then H(t) = the first j > u with x[j] <= x[t]
    int u = -1;
    need = false;
    if (t > 0) {
      if (c.x(t - 1) < vt) {
        u = t - 1;
      } else {
        need = true;
      }
    }
    warp_search<0>(c, need, t, vt, u);
    need = false;
    if (t >= 0) {
      if (c.x(u + 1) <= vt) {
        r = u + 1;
      } else {
        need = true;
      }
    }
    warp_search<2>(c, need, u + 1, vt, r);
  }
  if (!active) return;
  const int32_t* g = sd.g;
  sd.idx[i] = g == nullptr ? r : r >= 0 ? __ldg(g + r) : -1;
  sd.val[i] = r >= 0 ? vt : 0;
  if (TYP == FURTHEST_EQ && sd.head != nullptr) {
    // K1: the element merges into the top run when PSV<=(i) is an equal
    sd.head[i] = __ldg(g + (t >= 0 && vt == v ? r : i));
  }
}

// blockIdx.y selects the stream (K1, K2: two, K3: one); blockIdx.x the
// tile.  __grid_constant__ lets the kernel select a Side by reference
// without a per-thread local copy of the parameters.
__global__ void __launch_bounds__(THREADS)
block_scan_kernel(const __grid_constant__ Side a,
                  const __grid_constant__ Side b, int s) {
  __shared__ __align__(16) int32_t tile[TILE + HALO];
  const Side& sd = blockIdx.y == 0 ? a : b;
  const int32_t* x = sd.h.lv[0];
  const int base = static_cast<int>(blockIdx.x) * TILE;
  const int tlo = base - HALO;
  if (tlo >= 0 && tlo + TILE + HALO <= s &&
      (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(x + tlo);
    int4* dst = reinterpret_cast<int4*>(tile);
    for (int k = threadIdx.x; k < (TILE + HALO) / 4; k += THREADS) {
      dst[k] = __ldg(src + k);
    }
  } else {
    for (int k = threadIdx.x; k < TILE + HALO; k += THREADS) {
      const int e = tlo + k;
      tile[k] = e >= 0 && e < s ? x[e] : INT32_MAX;
    }
  }
  __syncthreads();
  const Ctx c{&sd.h, tile, tlo, static_cast<int>(threadIdx.x & (G - 1))};
  for (int r = 0; r < TILE / THREADS; ++r) {
    const int i = base + r * THREADS + static_cast<int>(threadIdx.x);
    const bool active = i < s;
    const int32_t v = active ? tile[i - tlo] : 0;
    switch (sd.typ) {
      case NEAREST_SM:
        answer<NEAREST_SM>(c, sd, i, active, v);
        break;
      case NEAREST_EQ:
        answer<NEAREST_EQ>(c, sd, i, active, v);
        break;
      default:
        answer<FURTHEST_EQ>(c, sd, i, active, v);
        break;
    }
  }
}

// Builds x's hierarchy into scratch; returns the scratch past its levels.
int32_t* build_hier(const int32_t* x, int s, int32_t* scratch, Hier* h,
                    cudaStream_t stream, cudaError_t* err) {
  h->lv[0] = x;
  h->n[0] = s;
  h->count = 1;
  int n = s;
  while (n > G && *err == cudaSuccess) {
    const int m = (n + G - 1) / G;
    group_min_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                       THREADS, 0, stream>>>(h->lv[h->count - 1], n, scratch);
    *err = cudaGetLastError();
    h->lv[h->count] = scratch;
    h->n[h->count] = m;
    h->count += 1;
    scratch += m;
    n = m;
  }
  return scratch;
}

// One stream as the C entry points hand it over (g, head: K1 only).
struct Stream {
  const int32_t* x;
  const int32_t* g;
  int32_t* idx;
  int32_t* val;
  int32_t* head;
  int typ;
};

// Left matches of stream p and, when q is given, of stream q (same length).
int block_scan(const Stream& p, const Stream* q, int32_t* scratch,
               long long s, cudaStream_t stream) {
  if (s >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSuccess;
  const int n = static_cast<int>(s);
  Side sides[2] = {};
  for (int k = 0; k < (q != nullptr ? 2 : 1); ++k) {
    const Stream& st = k == 0 ? p : *q;
    scratch = build_hier(st.x, n, scratch, &sides[k].h, stream, &err);
    sides[k].idx = st.idx;
    sides[k].val = st.val;
    sides[k].g = st.g;
    sides[k].head = st.head;
    sides[k].typ = st.typ;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + TILE - 1) / TILE),
                  q != nullptr ? 2u : 1u);
  block_scan_kernel<<<grid, THREADS, 0, stream>>>(sides[0], sides[1], n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point returns the first CUDA error of its launches, 0 if
// none.  scratch: the hierarchy levels above 0 of each stream, sum over
// k >= 1 of ceil(s / G^k) while the level below has more than G entries
// (K1, K2: twice that, one set per stream).

int psac_nsv_spine(const int32_t* xf, const int32_t* gf, const int32_t* xn,
                   const int32_t* gn, int32_t* fi, int32_t* fv, int32_t* fh,
                   int32_t* ni, int32_t* nv, int32_t* scratch, long long s,
                   void* stream) {
  const Stream q{xn, gn, ni, nv, nullptr, NEAREST_SM};
  return block_scan(Stream{xf, gf, fi, fv, fh, FURTHEST_EQ}, &q, scratch, s,
                    static_cast<cudaStream_t>(stream));
}

int psac_nsv_dual(const int32_t* x, const int32_t* xr, int32_t* il,
                  int32_t* vl, int32_t* ir, int32_t* vr, int32_t* scratch,
                  long long s, int typ_l, int typ_r, void* stream) {
  const Stream q{xr, nullptr, ir, vr, nullptr, typ_r};
  return block_scan(Stream{x, nullptr, il, vl, nullptr, typ_l}, &q, scratch,
                    s, static_cast<cudaStream_t>(stream));
}

int psac_nsv_left(const int32_t* x, int32_t* idx, int32_t* val,
                  int32_t* scratch, long long s, int typ, void* stream) {
  return block_scan(Stream{x, nullptr, idx, val, nullptr, typ}, nullptr,
                    scratch, s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
