// In-tile phase of the tile-spine ANSV for Hopper (sm_90a).
//
// Replaces psac_tpu/ops/tansv.py::_tile_side, which XLA fuses on the TPU as
// (s/512, 512, 512) all-pairs compares (2^35 elements at s = 2^26; eager
// torch would materialize them).  Here one block of T = 512 threads owns
// one tile, held in shared memory, and each thread computes its element's
// answers with short scans of the tile instead of a (T, T) compare matrix:
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
// What bounds it: each thread scans at most T shared-memory words per
// question (O(T^2) per tile in the worst case, an all-equal tile; a few
// words on typical LCP arrays), so shared-memory load throughput, far from
// device-memory bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 512;
constexpr int32_t I32_INF = 2147483647;

__global__ void __launch_bounds__(T)
tile_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ psv_g,
            int32_t* __restrict__ psv_val, uint8_t* __restrict__ chain,
            uint8_t* __restrict__ spine, int32_t* __restrict__ nxt,
            int32_t* __restrict__ e_g, int32_t* __restrict__ h_in,
            int with_eq) {
  __shared__ int32_t t[T];
  __shared__ uint8_t sp[T];
  const long long base = static_cast<long long>(blockIdx.x) * T;
  const int i = threadIdx.x;
  t[i] = a[base + i];
  __syncthreads();

  const int32_t v = t[i];
  int psv = -1;
  for (int j = i - 1; j >= 0; --j) {
    if (t[j] < v) {
      psv = j;
      break;
    }
  }
  const bool is_chain = psv < 0;
  bool sufvis = true;  // nothing strictly smaller after i in the tile
  for (int j = i + 1; j < T; ++j) {
    if (t[j] < v) {
      sufvis = false;
      break;
    }
  }
  const bool run_first = i == 0 || t[i - 1] != v;
  const bool run_last = i == T - 1 || t[i + 1] != v;
  const bool sp2 = (is_chain || sufvis) && (run_first || run_last);
  sp[i] = sp2;
  __syncthreads();

  int nx = T;
  for (int j = i; j < T; ++j) {
    if (sp[j]) {
      nx = j;
      break;
    }
  }
  const long long gi = base + i;
  psv_g[gi] = is_chain ? -1 : static_cast<int32_t>(base + psv);
  psv_val[gi] = is_chain ? 0 : t[psv];
  chain[gi] = is_chain;
  spine[gi] = sp2;
  nxt[gi] = nx;
  if (with_eq) {
    int e = T;
    for (int j = psv + 1; j < i; ++j) {
      if (t[j] == v) {
        e = j;
        break;
      }
    }
    e_g[gi] = e < T ? static_cast<int32_t>(base + e) : I32_INF;
    h_in[gi] = static_cast<int32_t>(base + (e < T ? e : i));
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
