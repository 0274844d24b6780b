// ANSV scans for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of psac_tpu/ops/nsv_scan.py:
//   * K1 nsv_scan_spine (_spine_kernel): a FURTHEST_EQ chain over the
//     explicit-index stream (xf, gf) that also emits each element's run
//     first after merge/push (fh), and a NEAREST_SM chain over (xn, gn);
//   * K2 nsv_scan_dual (_dual_kernel): left matches of x (typ_l) and of the
//     second array xr (typ_r), any of the three match types;
//   * K3 nsv_scan_left (_scan_kernel): left matches of x, one match type.
//
// Semantics are those of psac_tpu/ops/ansv.py::_left_scan: a monotone stack
// of runs (value, endpoint) where the endpoint is the run's FIRST index for
// FURTHEST_EQ and its LAST index otherwise.  Answers are the stream's
// indices (explicit for K1, positions for K2/K3); -1 means no match and the
// value is then 0.  The flag output is always written 0 (nothing here can
// overflow); it is kept for the JAX interface.
//
// ---- K1: the run-stack chain -------------------------------------------
// The TPU grid ran its 2048-element chunks in order and carried the stack
// across them in SMEM.  Here each chain is one warp on its own block: the
// warp stages a chunk of B inputs into shared memory with coalesced loads,
// lane 0 runs the scan over it, and the warp writes the chunk's answers
// back.  The top run lives in lane 0's registers; the cells below it live
// in shared memory up to C cells and spill beyond that to a global scratch
// stack the wrapper sizes to the stream length.
// What bounds it: one serial dependency chain per scan (~130-150 ns per
// element); its bound (36 bytes per stream entry at 3.35 TB/s) is ~0.01% of
// its time.  It is the next one to move onto the block engine below.
//
// ---- K2, K3: the block engine --------------------------------------------
// Every answer depends on x alone, not on the order of a scan.  With
// PSV<(i) the nearest j < i with x[j] < x[i] and PSV<=(i) the nearest with
// x[j] <= x[i]:
//   NEAREST_SM(i)  = PSV<(i)
//   NEAREST_EQ(i)  = PSV<=(i)
//   FURTHEST_EQ(i) = H(PSV<=(i)) (-1 when PSV<=(i) = -1), where H(t), the
//                    head of t's run, is the first j >= PSV<(t) + 1 with
//                    x[j] <= x[t] (everything in (PSV<(t), t] is >= x[t], so
//                    x[H(t)] = x[t]).
// The value is x at the match.
//
// Design:
//   * a minima hierarchy per stream: level 0 is x, level k+1 holds the
//     minima of the G = 32-entry groups of level k, one warp-reduction
//     kernel per level until a level has at most G entries (6 levels at
//     2^26).  The levels are the only scratch (s/31 entries per stream);
//   * one thread block per TILE-element tile (both streams of K2 are the
//     two rows of one grid, blockIdx.y), the tile plus a G-entry halo on
//     its left staged in shared memory with 16-byte loads;
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
// each output (K2 24 bytes per element, K3 12), 0.48 ms and 0.060 ms at the
// chip_smoke shapes.  The engine reads x about twice (the level build and
// the tile) and keeps the levels (1/31 of x) in L2; the rest of its time
// goes to the dependent loads of the warp searches, which only the many
// resident warps hide (2-4% of the bound on an H100 SXM at 700 W).  No
// tensor cores: this is comparison work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEAREST_SM = 0;
constexpr int NEAREST_EQ = 1;
constexpr int FURTHEST_EQ = 2;

// ===========================================================================
// K1: the run-stack chain
// ===========================================================================

constexpr int B = 2048;    // stream elements staged per chunk
constexpr int C = 16384;   // stack cells held in shared memory
constexpr size_t SMEM_BYTES = sizeof(int32_t) * (2 * C + 5 * B);  // 168 KB

// Stack cells [0, C) in shared memory, [C, ...) in global scratch (indexed
// by the absolute cell number).
struct Stack {
  int32_t* sv_s;
  int32_t* se_s;
  int32_t* sv_g;
  int32_t* se_g;
  __device__ __forceinline__ int32_t v(long long i) const {
    return i < C ? sv_s[i] : sv_g[i];
  }
  __device__ __forceinline__ int32_t e(long long i) const {
    return i < C ? se_s[i] : se_g[i];
  }
  __device__ __forceinline__ void put(long long i, int32_t val, int32_t end) {
    if (i < C) {
      sv_s[i] = val;
      se_s[i] = end;
    } else {
      sv_g[i] = val;
      se_g[i] = end;
    }
  }
};

// Chain state: cells [0, sp-1) are in the stack; the top cell sp-1 is in
// (tv, te).
struct Chain {
  Stack st;
  long long sp;
  int32_t tv, te;
};

// One element of the scan; writes the match (index, value) and returns
// the top run's endpoint after merge/push (the run FIRST for FURTHEST_EQ).
template <int TYP>
__device__ __forceinline__ int32_t chain_step(Chain& c, int32_t v, int32_t gi,
                                              int32_t* midx_out,
                                              int32_t* mval_out) {
  while (c.sp > 0 && c.tv > v) {
    c.sp -= 1;
    if (c.sp > 0) {
      c.tv = c.st.v(c.sp - 1);
      c.te = c.st.e(c.sp - 1);
    }
  }
  const bool has = c.sp > 0;
  const bool eq_top = has && c.tv == v;
  int32_t midx, mval;
  if (TYP == NEAREST_SM && eq_top) {
    // nearest strictly smaller = the run below the equal top
    if (c.sp > 1) {
      midx = c.st.e(c.sp - 2);
      mval = c.st.v(c.sp - 2);
    } else {
      midx = -1;
      mval = 0;
    }
  } else {
    midx = has ? c.te : -1;
    mval = c.tv;
  }
  *midx_out = midx;
  *mval_out = midx >= 0 ? mval : 0;
  if (eq_top) {
    if (TYP != FURTHEST_EQ) c.te = gi;  // run last moves to gi
  } else {
    if (has) c.st.put(c.sp - 1, c.tv, c.te);
    c.sp += 1;
    c.tv = v;
    c.te = gi;
  }
  return c.te;
}

// One chain on one warp over the explicit-index stream (x, g).
template <int TYP>
__device__ void run_chain(const int32_t* __restrict__ x,
                          const int32_t* __restrict__ g,
                          int32_t* __restrict__ idx, int32_t* __restrict__ val,
                          int32_t* __restrict__ head, int32_t* sv_g,
                          int32_t* se_g, long long s, int32_t* smem) {
  int32_t* xs = smem + 2 * C;
  int32_t* gs = xs + B;
  int32_t* oi = gs + B;
  int32_t* ov = oi + B;
  int32_t* oh = ov + B;
  const int lane = threadIdx.x;
  Chain c{Stack{smem, smem + C, sv_g, se_g}, 0, 0, 0};
  for (long long base = 0; base < s; base += B) {
    const int len = static_cast<int>(s - base < B ? s - base : B);
    for (int k = lane; k < len; k += 32) {
      xs[k] = x[base + k];
      gs[k] = g[base + k];
    }
    __syncwarp();
    if (lane == 0) {
      for (int k = 0; k < len; ++k) {
        int32_t mi, mv;
        oh[k] = chain_step<TYP>(c, xs[k], gs[k], &mi, &mv);
        oi[k] = mi;
        ov[k] = mv;
      }
    }
    __syncwarp();
    for (int k = lane; k < len; k += 32) {
      idx[base + k] = oi[k];
      val[base + k] = ov[k];
      if (head) head[base + k] = oh[k];
    }
    __syncwarp();
  }
}

// blockIdx.x 0: FURTHEST_EQ chain over (xf, gf); 1: NEAREST_SM over (xn, gn).
__global__ void __launch_bounds__(32)
spine_kernel(const int32_t* xf, const int32_t* gf, const int32_t* xn,
             const int32_t* gn, int32_t* fi, int32_t* fv, int32_t* fh,
             int32_t* ni, int32_t* nv, int32_t* flag, int32_t* scratch,
             long long s) {
  extern __shared__ int32_t smem[];
  int32_t* sv_g = scratch + 2 * s * blockIdx.x;
  int32_t* se_g = sv_g + s;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) flag[0] = 0;
    run_chain<FURTHEST_EQ>(xf, gf, fi, fv, fh, sv_g, se_g, s, smem);
  } else {
    run_chain<NEAREST_SM>(xn, gn, ni, nv, nullptr, sv_g, se_g, s, smem);
  }
}

// ===========================================================================
// K2, K3: the block engine
// ===========================================================================

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

// One stream: its hierarchy, its outputs and its match type.
struct Side {
  Hier h;
  int32_t* idx;
  int32_t* val;
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
__device__ __forceinline__ void answer(const Ctx& c, int i, bool active,
                                       int32_t v, int32_t* idx,
                                       int32_t* val) {
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
  if (active) {
    idx[i] = r;
    val[i] = r >= 0 ? vt : 0;
  }
}

// blockIdx.y selects the stream (K2: two, K3: one); blockIdx.x the tile.
__global__ void __launch_bounds__(THREADS)
block_scan_kernel(Side a, Side b, int s) {
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
        answer<NEAREST_SM>(c, i, active, v, sd.idx, sd.val);
        break;
      case NEAREST_EQ:
        answer<NEAREST_EQ>(c, i, active, v, sd.idx, sd.val);
        break;
      default:
        answer<FURTHEST_EQ>(c, i, active, v, sd.idx, sd.val);
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

// Left matches of x (typ_x) and, when y is given, of y (typ_y).
int block_scan(const int32_t* x, const int32_t* y, int32_t* ix, int32_t* vx,
               int32_t* iy, int32_t* vy, int32_t* flag, int32_t* scratch,
               long long s, int typ_x, int typ_y, cudaStream_t stream) {
  if (s >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess || s == 0) return static_cast<int>(err);
  const int n = static_cast<int>(s);
  Side a{}, b{};
  scratch = build_hier(x, n, scratch, &a.h, stream, &err);
  a.idx = ix;
  a.val = vx;
  a.typ = typ_x;
  if (y != nullptr) {
    build_hier(y, n, scratch, &b.h, stream, &err);
    b.idx = iy;
    b.val = vy;
    b.typ = typ_y;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + TILE - 1) / TILE),
                  y != nullptr ? 2u : 1u);
  block_scan_kernel<<<grid, THREADS, 0, stream>>>(a, b, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scratch: 4*s int32.  Returns the first CUDA error of the launch, 0 if none.
int psac_nsv_spine(const int32_t* xf, const int32_t* gf, const int32_t* xn,
                   const int32_t* gn, int32_t* fi, int32_t* fv, int32_t* fh,
                   int32_t* ni, int32_t* nv, int32_t* flag, int32_t* scratch,
                   long long s, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  spine_kernel<<<2, 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xf, gf, xn, gn, fi, fv, fh, ni, nv, flag, scratch, s);
  return static_cast<int>(cudaGetLastError());
}

// scratch: the hierarchy levels above 0 of both streams, 2 * sum over
// k >= 1 of ceil(s / G^k) while the level below has more than G entries.
int psac_nsv_dual(const int32_t* x, const int32_t* xr, int32_t* il,
                  int32_t* vl, int32_t* ir, int32_t* vr, int32_t* flag,
                  int32_t* scratch, long long s, int typ_l, int typ_r,
                  void* stream) {
  return block_scan(x, xr, il, vl, ir, vr, flag, scratch, s, typ_l, typ_r,
                    static_cast<cudaStream_t>(stream));
}

// scratch: the hierarchy levels above 0 of x (half of K2's).
int psac_nsv_left(const int32_t* x, int32_t* idx, int32_t* val, int32_t* flag,
                  int32_t* scratch, long long s, int typ, void* stream) {
  return block_scan(x, nullptr, idx, val, nullptr, nullptr, flag, scratch, s,
                    typ, typ, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
