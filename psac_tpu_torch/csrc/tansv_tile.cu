// In-tile phase of the tile-spine ANSV for Hopper (sm_90a).
//
// Replaces psac_tpu/ops/tansv.py::_tile_side, which XLA fuses on the TPU as
// (s/512, 512, 512) all-pairs compares (2^35 elements at s = 2^26; eager
// torch would materialize them).  One block of T = 512 threads owns one
// tile, one thread per element:
//
//   psv_g / psv_val  in-tile previous strictly smaller (global index, value;
//                    -1 and 0 when none)
//   chain            no in-tile previous smaller (the match lies in an
//                    earlier tile)
//   spine            (chain | weak suffix minimum) & (run first | run last)
//   nxt              in-tile position of the next spine member at or right
//                    of the element (T when none)
//   e_g, h_in        (with_eq only) leftmost in-tile equal after the PSV
//                    (INT32_MAX when none) and the in-tile run head:
//                    that equal, else the element itself (global indices)
//
// psv_val is the value at the PSV exactly.  (The JAX formula reduces
// where(sel, a, 0) with max, which reads 0 instead of a negative value;
// the two agree on the non-negative inputs the JAX package feeds it.)
//
// Design: no thread runs a loop whose length depends on the data, so no
// warp waits for its slowest lane.  The block builds a doubling min-table
// of its tile in shared memory, lv[k][j] = min(t[j .. j + 2^k)) for
// k < 9 (one level per step, every thread one entry), and then each thread
// answers with a fixed number of steps:
//   * psv: binary lifting from i leftwards over the levels, 9 steps: the
//     longest run of entries >= v ending at i - 1 (the plain versions'
//     doubling descent, ops/nsv_scan.py::_prev_lt);
//   * chain: psv < 0, i.e. min(t[0 .. i)) >= v;
//   * sufvis: v <= min(t(i .. T)), one range-minimum of two table entries;
//   * nxt: a ballot of the spine flags per warp, the 16 warp masks in shared
//     memory and one more ballot for the first later warp with a member;
//   * e: everything in (psv, i) is >= v, so the first j > psv with
//     t[j] <= v is the leftmost equal, or i itself when there is none:
//     binary lifting rightwards from psv + 1, 9 steps.
// What bounds it: the bytes, one int32 read and 22 bytes written per
// element with with_eq (0.52 ms at 2^26 at 3.35 TB/s).  The table costs 9
// shared-memory steps per element, each search 9 dependent shared-memory
// loads; the nine __syncthreads of the build are hidden by the other
// resident blocks.  It reaches 63% of that bound (0.829 ms at 2^26 on an
// NVIDIA H100 80GB HBM3 at 700 W).  No tensor cores: this is comparison
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 512;
constexpr int LOG_T = 9;
constexpr int WARPS = T / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t I32_INF = 2147483647;

__global__ void __launch_bounds__(T)
tile_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ psv_g,
            int32_t* __restrict__ psv_val, uint8_t* __restrict__ chain,
            uint8_t* __restrict__ spine, int32_t* __restrict__ nxt,
            int32_t* __restrict__ e_g, int32_t* __restrict__ h_in,
            int with_eq) {
  // lv[k][j] = min(t[j .. j + 2^k)), defined for j + 2^k <= T
  __shared__ int32_t lv[LOG_T][T];
  __shared__ unsigned spm[WARPS];  // each warp's spine ballot
  const long long base = static_cast<long long>(blockIdx.x) * T;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int32_t v = a[base + i];
  lv[0][i] = v;
  __syncthreads();
#pragma unroll
  for (int k = 1; k < LOG_T; ++k) {
    const int w = 1 << (k - 1);
    if (i + 2 * w <= T) lv[k][i] = min(lv[k - 1][i], lv[k - 1][i + w]);
    __syncthreads();
  }

  // psv: skip the longest run of entries >= v that ends at i - 1
  int skip = 0;
#pragma unroll
  for (int k = LOG_T - 1; k >= 0; --k) {
    const int w = 1 << k;
    const int lo = i - skip - w;
    if (lo >= 0 && lv[k][lo] >= v) skip += w;
  }
  const int psv = i - skip - 1;
  const bool is_chain = psv < 0;

  // sufvis: nothing strictly smaller after i in the tile
  bool sufvis = true;
  if (i < T - 1) {
    const int k = 31 - __clz(T - 1 - i);
    sufvis = v <= min(lv[k][i + 1], lv[k][T - (1 << k)]);
  }
  const bool run_first = i == 0 || lv[0][i - 1] != v;
  const bool run_last = i == T - 1 || lv[0][i + 1] != v;
  const bool sp2 = (is_chain || sufvis) && (run_first || run_last);

  // nxt: the first spine member at or right of i
  const unsigned b = __ballot_sync(FULL, sp2);
  if (lane == 0) spm[warp] = b;
  __syncthreads();
  const unsigned here = b & (FULL << lane);
  const unsigned later = __ballot_sync(
      FULL, lane < WARPS && lane > warp && spm[lane & (WARPS - 1)] != 0);
  const int w2 = __ffs(later) - 1;
  const int nx = here ? warp * 32 + __ffs(here) - 1
                 : w2 >= 0 ? w2 * 32 + __ffs(spm[w2 & (WARPS - 1)]) - 1
                           : T;

  const long long gi = base + i;
  psv_g[gi] = is_chain ? -1 : static_cast<int32_t>(base + psv);
  psv_val[gi] = is_chain ? 0 : lv[0][psv < 0 ? 0 : psv];
  chain[gi] = is_chain;
  spine[gi] = sp2;
  nxt[gi] = nx;
  if (with_eq) {
    // e: skip the longest run of entries > v that starts at psv + 1; it
    // stops at i at the latest (t[i] = v)
    const int start = psv + 1;
    int fwd = 0;
#pragma unroll
    for (int k = LOG_T - 1; k >= 0; --k) {
      const int w = 1 << k;
      const int lo = start + fwd;
      if (lo + w <= T && lv[k][lo] > v) fwd += w;
    }
    const int e = start + fwd;  // <= i
    e_g[gi] = e < i ? static_cast<int32_t>(base + e) : I32_INF;
    h_in[gi] = static_cast<int32_t>(base + e);
  }
}

}  // namespace

extern "C" {

// a: (nt*T,) int32.  e_g and h_in may be null when with_eq == 0.
// Returns cudaGetLastError() after the launch.
int psac_tansv_tile(const int32_t* a, int32_t* psv_g, int32_t* psv_val,
                    uint8_t* chain, uint8_t* spine, int32_t* nxt,
                    int32_t* e_g, int32_t* h_in, long long nt, int with_eq,
                    void* stream) {
  if (nt > 0) {
    tile_kernel<<<static_cast<unsigned>(nt), T, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        a, psv_g, psv_val, chain, spine, nxt, e_g, h_in, with_eq);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
