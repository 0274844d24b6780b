// Routed records bucketed by destination shard for Hopper (sm_90a): K12
// route_bucket.
//
// Replaces psac_tpu/parallel/route.py::_bucket_by_dest (an XLA stable
// argsort of the destination keys, a run-start mask and a cummax of the
// run starts; no Pallas kernel).  The port first ran the same chain in
// PyTorch, where the 1-D torch.cummax over tens of millions of rows runs on
// few threads: at p = 4 it took 2.8 s of a 4.4-s build of 491 M characters
// on each card.
//
// K12: record i has key k_i = p where skip[i] is set or dest[i] lies
// outside [0, p), else dest[i].  Its slot is the number of records j < i
// with k_j = k_i; its buffer position pos[i] = k_i * cap + slot, or the
// drop slot p * cap where k_i = p or slot >= cap.  ovf receives the count
// of records with k_i < p and slot >= cap.  So within a destination the
// records keep index order, the first cap of each are kept and skipped
// records use no capacity: the positions the stable sort and the cummax
// gave, written in record order instead of as a permutation.
//
// Design: a stable counting sort over the p + 1 keys, in three launches.
// A block of 8 warps takes a tile of 8 x 1024 rows, each warp 1024
// consecutive rows, 32 at a time (four rounds of loads in flight).
//  1. count: __match_any_sync groups a warp's 32 lanes by key; the group's
//     lowest lane adds its size to the warp's counter of that key in shared
//     memory.  Each warp writes its (p + 1) counts (tile-major, wcount), and
//     the block their sums per key (key-major, tcount).
//  2. scan: one block turns each key's row of tcount into the exclusive
//     prefix over the tiles (int64) and writes the overflow count, the sum
//     over keys k < p of max(0, total_k - cap).
//  3. place: the block adds to each key's tile offset the counts of the
//     warps before each warp (a warps x (p + 1) table in shared memory);
//     each warp then walks its rows again in the same order, a lane's slot
//     being its key's running offset plus the lanes below it in its
//     __match_any_sync group; the group's lowest lane advances the offset.
//
// What bounds it: compulsory bytes.  It reads dest (4 B) and skip (1 B)
// twice and writes pos (4 B, 8 B where p * cap >= 2^31) once: 14 B a row,
// 0.28 ms for 67,108,864 rows at 3.35 TB/s.  The tables add 4 (p + 1) B
// and 8 (p + 1) B a tile of 8,192 rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 256;                 // threads a block: 8 warps
constexpr int WARPS = T / 32;
constexpr int WARP_ROWS = 1024;        // rows a warp takes in a tile
constexpr long long TILE = static_cast<long long>(WARPS) * WARP_ROWS;
constexpr int U = 4;                   // rounds of 32 rows loaded at once
constexpr int SCAN_T = 1024;           // threads of the scan's block
constexpr int SCAN_ITEMS = 8;          // entries a scan thread takes a pass

static_assert(WARP_ROWS % (32 * U) == 0, "a warp's rows split into loads");

// The key of row i (p where skipped or out of range), -1 past the end.
__device__ __forceinline__ int key_of(const int32_t* __restrict__ dest,
                                      const uint8_t* __restrict__ skip,
                                      long long i, long long m, int p) {
  if (i >= m) return -1;
  int k = dest[i];
  if (k < 0 || k >= p || (skip != nullptr && skip[i])) k = p;
  return k;
}

// Pass 1: wcount[(tile * WARPS + w) * K + k] and tcount[k * tiles + tile],
// the rows of key k in warp w's rows and in the tile (K = p + 1 keys).
__global__ void __launch_bounds__(T)
bucket_count_kernel(const int32_t* __restrict__ dest,
                    const uint8_t* __restrict__ skip, long long m, int p,
                    long long tiles, int32_t* __restrict__ wcount,
                    long long* __restrict__ tcount) {
  extern __shared__ long long smem[];
  const int K = p + 1;
  int32_t* cnt = reinterpret_cast<int32_t*>(smem);  // WARPS x K
  for (int j = threadIdx.x; j < WARPS * K; j += T) cnt[j] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int32_t* mine = cnt + w * K;
  const long long tile = blockIdx.x;
  const long long first = tile * TILE + static_cast<long long>(w) * WARP_ROWS;
  for (int r = 0; r < WARP_ROWS; r += 32 * U) {
    int key[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = key_of(dest, skip, first + r + 32 * u + lane, m, p);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned grp = __match_any_sync(0xffffffffu, key[u]);
      if (key[u] >= 0 && lane == __ffs(grp) - 1) mine[key[u]] += __popc(grp);
      __syncwarp();
    }
  }
  __syncthreads();
  int32_t* wout = wcount + tile * WARPS * K;
  for (int j = threadIdx.x; j < WARPS * K; j += T) wout[j] = cnt[j];
  for (int k = threadIdx.x; k < K; k += T) {
    long long sum = 0;
    for (int v = 0; v < WARPS; ++v) sum += cnt[v * K + k];
    tcount[k * tiles + tile] = sum;
  }
}

// Pass 2: each key's row of tcount in place to its exclusive prefix; ovf
// the records past cap over the keys below p.  One block.
__global__ void __launch_bounds__(SCAN_T)
bucket_scan_kernel(long long* __restrict__ tcount, long long tiles, int p,
                   long long cap, int32_t* __restrict__ ovf) {
  __shared__ long long warp_sum[SCAN_T / 32];
  __shared__ long long carry;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  long long over = 0;  // kept by thread 0
  for (int k = 0; k <= p; ++k) {
    long long* row = tcount + k * tiles;
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (long long base = 0; base < tiles;
         base += static_cast<long long>(SCAN_T) * SCAN_ITEMS) {
      const long long at = base + static_cast<long long>(threadIdx.x) *
                                      SCAN_ITEMS;
      long long v[SCAN_ITEMS];
      long long sum = 0;
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; ++j) {
        v[j] = at + j < tiles ? row[at + j] : 0;
        sum += v[j];
      }
      // inclusive scan of the threads' sums within the warp, then over
      // the warps
      long long inc = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long o = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += o;
      }
      if (lane == 31) warp_sum[w] = inc;
      __syncthreads();
      if (w == 0) {
        long long ws = lane < SCAN_T / 32 ? warp_sum[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const long long o = __shfl_up_sync(0xffffffffu, ws, d);
          if (lane >= d) ws += o;
        }
        if (lane < SCAN_T / 32) warp_sum[lane] = ws;  // inclusive
      }
      __syncthreads();
      long long run = carry + inc - sum + (w > 0 ? warp_sum[w - 1] : 0);
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; ++j) {
        if (at + j < tiles) row[at + j] = run;
        run += v[j];
      }
      __syncthreads();
      if (threadIdx.x == 0) carry += warp_sum[SCAN_T / 32 - 1];
      __syncthreads();
    }
    if (threadIdx.x == 0 && k < p && carry > cap) over += carry - cap;
  }
  if (threadIdx.x == 0) *ovf = static_cast<int32_t>(over);
}

// Pass 3: pos[i] for every row of the tile, from the scanned tcount and
// the warps' counts.
template <typename Pos>
__global__ void __launch_bounds__(T)
bucket_place_kernel(const int32_t* __restrict__ dest,
                    const uint8_t* __restrict__ skip, long long m, int p,
                    long long cap, long long tiles,
                    const int32_t* __restrict__ wcount,
                    const long long* __restrict__ tcount,
                    Pos* __restrict__ pos) {
  extern __shared__ long long offs[];  // WARPS x K running offsets
  const int K = p + 1;
  const long long tile = blockIdx.x;
  const int32_t* wc = wcount + tile * WARPS * K;
  for (int k = threadIdx.x; k < K; k += T) {
    long long run = tcount[k * tiles + tile];
    for (int v = 0; v < WARPS; ++v) {
      offs[v * K + k] = run;
      run += wc[v * K + k];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  long long* mine = offs + w * K;
  const unsigned below = (1u << lane) - 1u;
  const long long drop = static_cast<long long>(p) * cap;
  const long long first = tile * TILE + static_cast<long long>(w) * WARP_ROWS;
  for (int r = 0; r < WARP_ROWS; r += 32 * U) {
    int key[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = key_of(dest, skip, first + r + 32 * u + lane, m, p);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = key[u];
      const unsigned grp = __match_any_sync(0xffffffffu, k);
      const int lead = __ffs(grp) - 1;
      long long base = 0;
      if (k >= 0 && lane == lead) base = mine[k];
      base = __shfl_sync(0xffffffffu, base, lead);
      if (k >= 0 && lane == lead) mine[k] = base + __popc(grp);
      __syncwarp();
      if (k >= 0) {
        const long long slot = base + __popc(grp & below);
        const long long at = k < p && slot < cap ? k * cap + slot : drop;
        pos[first + r + 32 * u + lane] = static_cast<Pos>(at);
      }
    }
  }
}

int bucket(const int32_t* dest, const uint8_t* skip, long long m, int p,
           long long cap, int32_t* wcount, long long* tcount, int32_t* ovf,
           void* pos, bool wide, void* stream) {
  if (p < 1 || cap < 0 || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (m + TILE - 1) / TILE;
  const int K = p + 1;
  if (tiles > 0) {
    bucket_count_kernel<<<static_cast<unsigned>(tiles), T,
                          WARPS * K * sizeof(int32_t), s>>>(
        dest, skip, m, p, tiles, wcount, tcount);
  }
  bucket_scan_kernel<<<1, SCAN_T, 0, s>>>(tcount, tiles, p, cap, ovf);
  if (tiles > 0) {
    const size_t shm = WARPS * K * sizeof(long long);
    if (wide) {
      bucket_place_kernel<int64_t><<<static_cast<unsigned>(tiles), T, shm,
                                     s>>>(dest, skip, m, p, cap, tiles,
                                          wcount, tcount,
                                          static_cast<int64_t*>(pos));
    } else {
      bucket_place_kernel<int32_t><<<static_cast<unsigned>(tiles), T, shm,
                                     s>>>(dest, skip, m, p, cap, tiles,
                                          wcount, tcount,
                                          static_cast<int32_t*>(pos));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K12.  dest: (m,) int32; skip: (m,) bytes or null; wcount: (tiles * 8 *
// (p + 1),) int32 and tcount: ((p + 1) * tiles,) int64 scratch, tiles =
// ceil(m / 8192); ovf: one int32; pos: (m,) int32, or int64 with the
// suffix _i64 (the wrapper's choice where p * cap >= 2^31).  The scratch
// needs no zeroing.  p + 1 keys take 8 * (p + 1) * 8 B of shared memory
// (48 KB: p <= 767).  Returns cudaGetLastError() after the launches.
int psac_route_bucket_i32(const int32_t* dest, const uint8_t* skip,
                          long long m, int p, long long cap, int32_t* wcount,
                          long long* tcount, int32_t* ovf, int32_t* pos,
                          void* stream) {
  return bucket(dest, skip, m, p, cap, wcount, tcount, ovf, pos, false,
                stream);
}

int psac_route_bucket_i64(const int32_t* dest, const uint8_t* skip,
                          long long m, int p, long long cap, int32_t* wcount,
                          long long* tcount, int32_t* ovf, int64_t* pos,
                          void* stream) {
  return bucket(dest, skip, m, p, cap, wcount, tcount, ovf, pos, true,
                stream);
}

}  // extern "C"
