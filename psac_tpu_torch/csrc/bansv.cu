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
// Design: no thread runs a loop whose length depends on the data.
//   * a minima hierarchy: level 0 is x, level k+1 holds the minima of the
//     B-entry blocks of level k, built by one small reduction kernel per
//     level until a level has at most B entries (4 levels at s = 2^26);
//   * one resident wave of thread blocks; each answers a run of
//     consecutive TILE-element tiles, THREADS threads taking TILE / THREADS
//     elements of each tile (four by default, so that their liftings
//     interleave).  A tile's window is the tile before and the tile
//     itself, with a doubling min-table over it in shared memory,
//     tab[k][j] = min(w[j .. j + 2^k)), kept as a ring of two tiles per
//     level: when the window moves on by a tile, the entries inside the
//     older tile stay, and per level the TILE entries that reach into the
//     new tile are computed, one level per step.  So each element
//     is read from device memory once and costs one table entry per level.
//     Each element is answered by binary lifting leftwards from its
//     position, log2(2 TILE) steps without a branch: it skips the longest
//     run of window entries that miss its value;
//   * the elements whose answer lies before the window (0.3% of a random
//     DNA LCP and of random values, all of a decreasing array) are found by
//     their warp, by ballot.  Going up, the warp loads the entries of the
//     level's block that lie before the ancestor (B/32 = 8 per lane,
//     coalesced, all issued at once), shared by all its climbing lanes,
//     since they lie in one tile; the region's minimum tells in one ballot
//     which lanes find their entry at this level, and for each of those,
//     one ballot per 32 entries from the end gives the last hit (the lowest
//     set lane).  Going down, the warp loads the chosen block's B entries
//     the same way, for each found lane in turn.
//
// What bounds it: compulsory bytes, one read of x and one int32 write per
// element (0.0401 ms at 2^24 int32, 0.1603 ms at 2^26, at 3.35 TB/s); the
// levels above 0 (s/B + s/B^2 + ... entries) stay in L2.  It reaches about
// 17% of that bound on the 2^24 random values and 18% on the 2^26 LCP of
// random DNA (PERF.md section 6).  What it spends instead is the window's
// shared-memory work, about 165 instructions per element: one table entry
// per level (two loads and a store), behind one barrier per level, and the
// lifting's log2(2 TILE) dependent loads, seven instructions a step.  An
// increasing array, where no element leaves its window, takes over 80% of
// the random values' time.  No tensor cores: this is comparison work.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef PSAC_K5_TILE
#define PSAC_K5_TILE 256
#endif
#ifndef PSAC_K5_THREADS
#define PSAC_K5_THREADS (PSAC_K5_TILE / 4)
#endif

namespace {

constexpr int B = 256;  // width of the minima hierarchy's blocks
constexpr int TILE = PSAC_K5_TILE;
constexpr int THREADS = PSAC_K5_THREADS;  // per block
constexpr int ELEMS = TILE / THREADS;     // tile elements per thread
constexpr int WIN = 2 * TILE;
constexpr int LOG_WIN = TILE == 256 ? 9 : TILE == 512 ? 10 : 11;
constexpr int MAX_LEVELS = 8;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE % B == 0 && TILE <= 1024 && (1 << LOG_WIN) == WIN,
              "TILE is 256, 512 or 1024");
static_assert(TILE % THREADS == 0 && THREADS % 32 == 0 && ELEMS <= 4,
              "a thread takes 1, 2 or 4 elements of each tile");

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
    const T o = __shfl_down_sync(FULL, v, off);
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

constexpr int RUN = B / 32;  // entries of a B-entry block per lane

// Lane `lane` loads a[top - lane - 32 r] for r < RUN, the entries >= lo
// (INF elsewhere): a block's run from its end, every load issued at once.
template <typename T>
__device__ __forceinline__ void load_run(const T* a, long long top,
                                         long long lo, int lane,
                                         T (&ent)[RUN]) {
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const long long j = top - lane - 32 * r;
    ent[r] = j >= lo ? a[j] : Inf<T>::v;
  }
}

// The last index in [lo, top] of a loaded run whose entry hits v, or -1;
// one ballot per 32 entries, from the end (lower lanes hold later
// entries, so the lowest set lane is the last hit).  Warp-uniform.
template <typename T, bool STRICT>
__device__ __forceinline__ long long last_hit(const T (&ent)[RUN],
                                              long long top, long long lo,
                                              T v, int lane) {
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const long long j = top - lane - 32 * r;
    const unsigned m =
        __ballot_sync(FULL, j >= lo && hit<T, STRICT>(ent[r], v));
    if (m) return top - 32 * r - (__ffs(m) - 1);
  }
  return -1;
}

// The answers of the warp's lanes in `todo`, whose own values v miss the
// whole window: the last index before level-1 entry p (exclusive) whose
// element hits v, or -1.  The lanes share p (one tile), so the warp
// climbs once for all of them: at each level it loads the entries of the
// level's block that lie before the ancestor, and its region minimum tells
// in one ballot which of the lanes still open find their entry there;
// those are resolved by `last_hit`, each in turn.  Then each found lane's
// entry is descended, in turn, one loaded block per level.  Every entry
// read lies wholly before the window, so every block read is full and
// every minimum read is exact.
template <typename T, bool STRICT>
__device__ long long warp_climb(const Levels<T>& lv, long long p, T v,
                                unsigned todo, int lane) {
  long long e = -1;  // this lane's entry once found
  int kf = 0;        // and its level
  unsigned open = todo;
  T ent[RUN];
  for (int k = 1; k < lv.count && open; ++k) {
    const long long lo = p / B * B;
    if (p > lo) {
      load_run(lv.ptr[k], p - 1, lo, lane, ent);
      T rmin = ent[0];
#pragma unroll
      for (int r = 1; r < RUN; ++r) rmin = ent[r] < rmin ? ent[r] : rmin;
      for (int off = 16; off > 0; off >>= 1) {
        const T o = __shfl_xor_sync(FULL, rmin, off);
        rmin = o < rmin ? o : rmin;
      }
      const unsigned found =
          __ballot_sync(FULL, ((open >> lane) & 1) && hit<T, STRICT>(rmin, v));
      for (unsigned f = found; f;) {
        const int c = __ffs(f) - 1;
        f &= f - 1;
        const T vc = __shfl_sync(FULL, v, c);
        const long long at = last_hit<T, STRICT>(ent, p - 1, lo, vc, lane);
        if (lane == c) {
          e = at;
          kf = k;
        }
      }
      open &= ~found;
    }
    p /= B;
  }
  // descend: each found lane's entry, one full block per level
  for (unsigned f = todo & ~open; f;) {
    const int c = __ffs(f) - 1;
    f &= f - 1;
    const T vc = __shfl_sync(FULL, v, c);
    long long ec = __shfl_sync(FULL, e, c);
    const int kc = __shfl_sync(FULL, kf, c);
    for (int l = kc - 1; l >= 0; --l) {
      const long long first = ec * B;
      load_run(lv.ptr[l], first + B - 1, first, lane, ent);
      ec = last_hit<T, STRICT>(ent, first + B - 1, first, vc, lane);
    }
    if (lane == c) e = ec;
  }
  return e;
}

// Slot of window position j (0 = the first element of the tile before
// tile b) in the ring: tile q's elements sit in slots (q & 1) * TILE + ...
__device__ __forceinline__ int slot(long long b, int j) {
  return (j + static_cast<int>((b - 1) & 1) * TILE) & (WIN - 1);
}

template <typename T, bool STRICT>
__global__ void __launch_bounds__(THREADS)
psv_kernel(const __grid_constant__ Levels<T> lv, long long s, long long nt,
           long long per_block, int32_t* __restrict__ out) {
  // tab[k * WIN + slot(b, j)] = min(w[j .. j + 2^k)), defined for
  // j + 2^k <= WIN; w = tile b - 1, then tile b.  Thread t takes the
  // tile's elements t + THREADS * e, e < ELEMS.
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  const T* x = lv.ptr[0];
  const long long c0 = static_cast<long long>(blockIdx.x) * per_block;
  const long long c1 = c0 + per_block < nt ? c0 + per_block : nt;
  const int t = threadIdx.x;
  const int lane = t & 31;

  // the first tile of the run: stage and build the whole window
  {
    const long long base = c0 * TILE;
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      const int u = t + THREADS * e;
      tab[slot(c0, u)] = c0 > 0 ? x[base - TILE + u] : Inf<T>::v;
      tab[slot(c0, TILE + u)] = base + u < s ? x[base + u] : Inf<T>::v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 1; k < LOG_WIN; ++k) {
      const int w = 1 << (k - 1);
      const T* prev = tab + (k - 1) * WIN;
      T* cur = tab + k * WIN;
#pragma unroll
      for (int e = 0; e < 2 * ELEMS; ++e) {
        const int j = t + THREADS * e;
        if (j + 2 * w <= WIN) {
          const T a0 = prev[slot(c0, j)], a1 = prev[slot(c0, j + w)];
          cur[slot(c0, j)] = a1 < a0 ? a1 : a0;
        }
      }
      __syncthreads();
    }
  }

  T v[ELEMS];
#pragma unroll
  for (int e = 0; e < ELEMS; ++e) {
    const long long i = c0 * TILE + t + THREADS * e;
    v[e] = i < s ? x[i] : Inf<T>::v;
  }
  for (long long b = c0; b < c1; ++b) {
    const long long base = b * TILE;
    // the next tile's elements, loaded while these are answered
    T vn[ELEMS];
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      const long long i = base + TILE + t + THREADS * e;
      vn[e] = b + 1 < c1 && i < s ? x[i] : Inf<T>::v;
    }
    if (b > c0) {
      // the window moves by one tile: tile b - 1's entries stay; stage
      // tile b over tile b - 2 and compute, per level, the TILE entries
      // that reach into tile b
      __syncthreads();  // tile b - 1's liftings are done
#pragma unroll
      for (int e = 0; e < ELEMS; ++e)
        tab[slot(b, TILE + t + THREADS * e)] = v[e];
      __syncthreads();
#pragma unroll
      for (int k = 1; k < LOG_WIN; ++k) {
        const int w = 1 << (k - 1);
#pragma unroll
        for (int e = 0; e < ELEMS; ++e) {
          const int j = TILE - (1 << k) + 1 + t + THREADS * e;
          const T a0 = tab[(k - 1) * WIN + slot(b, j)];
          const T a1 = tab[(k - 1) * WIN + slot(b, j + w)];
          tab[k * WIN + slot(b, j)] = a1 < a0 ? a1 : a0;
        }
        __syncthreads();
      }
    }

    // skip the longest run of window entries that miss v, ending at p - 1.
    // r is p's ring position, p + off, unmasked; a step may not start
    // before the window's first position lob.  Branch free: every step
    // loads its entry (the ring's mask keeps the load inside the table)
    // and is kept only where it is allowed and misses.
    const int lob = b > 0 ? 0 : TILE;
    const int off = static_cast<int>((b - 1) & 1) * TILE;
    int at[ELEMS];
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      int r = TILE + t + THREADS * e + off;
#pragma unroll
      for (int k = LOG_WIN - 1; k >= 0; --k) {
        const int c = r - (1 << k);
        const T m = tab[k * WIN + (c & (WIN - 1))];
        r = (c >= lob + off) & !hit<T, STRICT>(m, v[e]) ? c : r;
      }
      at[e] = r - off - 1;
    }

    const long long ws = base - TILE;  // window start, a multiple of B
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      const long long i = base + t + THREADS * e;
      long long ans = at[e] >= lob ? ws + at[e] : -1;
      // before the window: the warp climbs once for all such lanes
      const unsigned todo =
          __ballot_sync(FULL, i < s && at[e] < lob && ws > 0);
      if (todo) {
        const long long f = warp_climb<T, STRICT>(lv, ws / B, v[e], todo, lane);
        if ((todo >> lane) & 1) ans = f;
      }
      if (i < s) out[i] = static_cast<int32_t>(ans);
      v[e] = vn[e];
    }
  }
}

// One resident wave of blocks, each answering a run of consecutive tiles.
template <typename T, bool STRICT>
int launch_psv(const Levels<T>& lv, long long s, int32_t* out,
               cudaStream_t stream) {
  const size_t smem = sizeof(T) * LOG_WIN * WIN;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(psv_kernel<T, STRICT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, psv_kernel<T, STRICT>, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long nt = (s + TILE - 1) / TILE;
  const long long wave =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long per_block = (nt + wave - 1) / wave;
  const long long blocks = (nt + per_block - 1) / per_block;
  psv_kernel<T, STRICT>
      <<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
          lv, s, nt, per_block, out);
  return static_cast<int>(cudaGetLastError());
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
  if (s <= 0) return static_cast<int>(cudaGetLastError());
  return strict ? launch_psv<T, true>(lv, s, out, stream)
                : launch_psv<T, false>(lv, s, out, stream);
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
