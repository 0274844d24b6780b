// Run-stack ANSV scans for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of psac_tpu/ops/nsv_scan.py:
//   * K1 nsv_scan_spine (_spine_kernel): a FURTHEST_EQ chain over the
//     explicit-index stream (xf, gf) that also emits each element's run
//     first after merge/push (fh), and a NEAREST_SM chain over (xn, gn);
//   * K2 nsv_scan_dual (_dual_kernel): left matches of x (typ_l) and of the
//     reversed array xr (typ_r), any of the three match types;
//   * K3 nsv_scan_left (_scan_kernel): left matches of x, one chain of any
//     of the three match types.
//
// Semantics are those of psac_tpu/ops/ansv.py::_left_scan: a monotone stack
// of runs (value, endpoint) where the endpoint is the run's FIRST index for
// FURTHEST_EQ and its LAST index otherwise.  Answers are the stream's
// indices (explicit for K1, positions for K2); -1 means no match and the
// value is then 0.
//
// The TPU grid ran its 2048-element chunks in order and carried the stack
// across them in SMEM (8192 runs, with an overflow flag).  Here each chain
// is one warp on its own block (the two chains of K1/K2 run on two SMs):
// the warp stages a chunk of B inputs into shared memory with coalesced
// loads, lane 0 runs the scan over it, and the warp writes the chunk's
// answers back.  The top run lives in lane 0's registers; the cells below
// it live in shared memory up to C cells and spill beyond that to a global
// scratch stack that the wrapper sizes to the stream length, so the stack
// cannot overflow and the flag output is always written 0.
//
// What bounds it: one serial dependency chain per scan (compare, pop,
// push) over shared-memory latency, so ~tens of cycles per element on one
// thread; the card's bandwidth is idle.  A parallel decomposition is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEAREST_SM = 0;
constexpr int NEAREST_EQ = 1;
constexpr int FURTHEST_EQ = 2;

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

// One chain on one warp.  g == nullptr: the explicit index is the position.
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
      gs[k] = g ? g[base + k] : static_cast<int32_t>(base + k);
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

__device__ void run_chain_typ(int typ, const int32_t* x, int32_t* idx,
                              int32_t* val, int32_t* sv_g, int32_t* se_g,
                              long long s, int32_t* smem) {
  switch (typ) {
    case NEAREST_SM:
      run_chain<NEAREST_SM>(x, nullptr, idx, val, nullptr, sv_g, se_g, s,
                            smem);
      break;
    case NEAREST_EQ:
      run_chain<NEAREST_EQ>(x, nullptr, idx, val, nullptr, sv_g, se_g, s,
                            smem);
      break;
    default:
      run_chain<FURTHEST_EQ>(x, nullptr, idx, val, nullptr, sv_g, se_g, s,
                             smem);
      break;
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

// blockIdx.x 0: left matches of x (typ_l); 1: left matches of xr (typ_r).
__global__ void __launch_bounds__(32)
dual_kernel(const int32_t* x, const int32_t* xr, int32_t* il, int32_t* vl,
            int32_t* ir, int32_t* vr, int32_t* flag, int32_t* scratch,
            long long s, int typ_l, int typ_r) {
  extern __shared__ int32_t smem[];
  int32_t* sv_g = scratch + 2 * s * blockIdx.x;
  int32_t* se_g = sv_g + s;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) flag[0] = 0;
    run_chain_typ(typ_l, x, il, vl, sv_g, se_g, s, smem);
  } else {
    run_chain_typ(typ_r, xr, ir, vr, sv_g, se_g, s, smem);
  }
}

// One chain: left matches of x for match type typ (K3).
__global__ void __launch_bounds__(32)
left_kernel(const int32_t* x, int32_t* idx, int32_t* val, int32_t* flag,
            int32_t* scratch, long long s, int typ) {
  extern __shared__ int32_t smem[];
  if (threadIdx.x == 0) flag[0] = 0;
  run_chain_typ(typ, x, idx, val, scratch, scratch + s, s, smem);
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

int psac_nsv_dual(const int32_t* x, const int32_t* xr, int32_t* il,
                  int32_t* vl, int32_t* ir, int32_t* vr, int32_t* flag,
                  int32_t* scratch, long long s, int typ_l, int typ_r,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dual_kernel<<<2, 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, xr, il, vl, ir, vr, flag, scratch, s, typ_l, typ_r);
  return static_cast<int>(cudaGetLastError());
}

// scratch: 2*s int32.  Returns the first CUDA error of the launch, 0 if none.
int psac_nsv_left(const int32_t* x, int32_t* idx, int32_t* val, int32_t* flag,
                  int32_t* scratch, long long s, int typ, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      left_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  left_kernel<<<1, 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, idx, val, flag, scratch, s, typ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
