// The DESA's pattern encoding for Hopper (sm_90a): K11 pattern_pack.
//
// Replaces no TPU kernel: the JAX package encodes a query batch on the host
// in numpy (psac_tpu/models/desa.py:177-196, DESA.encode_patterns), a
// scatter of every code by two int64 index arrays into a padded matrix that
// then goes up whole.  At 65,536 patterns of 20 bytes that took about 60 ms
// of a 100-ms batch on the host, for about 4 ms of search on the card, and
// the matrix crossed the bus as 8.4 MB for 1.3 MB of pattern bytes.  Here
// the host hands over the patterns' bytes end to end and their offsets,
// and the card builds the matrix and the flags.
//
// K11: row i of the (B, Lmax) int32 matrix holds code[flat[offs[i] + j]]
// for j < len_i = offs[i + 1] - offs[i], and 0 from there to Lmax (a power
// of two, at least 2 and at least every length); len_i goes to lens[i];
// bad[i] is 1 where the pattern is empty or a byte of it has code 0 (lies
// outside the alphabet).  The alphabet's 256-entry byte -> code table sits
// in shared memory, widened to int32, loaded once a block.
//
// Design: a group of G = min(Lmax, 32) lanes takes a row, so a warp takes
// 32 / G rows at a time, consecutive in memory: each lane stores the
// columns sub, sub + G, ... of its row, and a warp's store is 32
// consecutive int32 words, one 128-byte line, at every Lmax.  The lanes
// read the row's bytes as consecutive single bytes (one or two 32-byte
// sectors a row).  A lane notes a code 0 among its columns; after the
// columns one ballot of the warp gives each group's rows their bad flag,
// and the group's first lane writes it with the length.  Every lane of a
// warp runs the same column loop (Lmax is uniform) and the same number of
// row steps, so the ballot takes the full mask.  The grid is at most 8
// blocks of 256 threads a streaming multiprocessor (the card full), the
// warps stepping over the rows.
//
// What bounds it: compulsory bytes.  It reads each pattern byte once, 8 B
// of offsets a row and the 256-byte table, and writes 4 * Lmax B of the
// matrix, 4 B of length and 1 B of flag a row: at 65,536 x 20-byte
// patterns (Lmax 32) about 10.5 MB, 3.1 us at 3.35 TB/s.  At that size the
// launch and the rows' dependent loads (offsets, then bytes, then the
// table) set its time, not the bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 256;                 // threads a block: 8 warps
constexpr int WARPS = T / 32;
constexpr long long MAX_BLOCKS = 132 * 8;

static_assert(T == 256, "a thread loads one entry of the code table");

__global__ void __launch_bounds__(T)
pattern_pack_kernel(const uint8_t* __restrict__ flat,
                    const int64_t* __restrict__ offs,
                    const uint8_t* __restrict__ mapping,
                    int32_t* __restrict__ mat, int32_t* __restrict__ lens,
                    uint8_t* __restrict__ bad, long long B, int Lmax,
                    int G) {
  __shared__ int32_t code[256];
  code[threadIdx.x] = mapping[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int first = lane - sub;       // the group's first lane
  const unsigned group = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  const int rows = 32 / G;            // rows a warp takes at a time
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long w = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / 32;
       w * rows < B; w += step) {
    const long long row = w * rows + lane / G;
    const bool live = row < B;
    long long start = 0;
    int len = 0;
    if (live) {
      start = offs[row];
      len = static_cast<int>(offs[row + 1] - start);
    }
    bool zero = false;
    int32_t* out = mat + row * Lmax;
    for (int c = sub; c < Lmax; c += G) {
      int v = 0;
      if (c < len) {
        v = code[flat[start + c]];
        zero |= v == 0;
      }
      if (live) out[c] = v;
    }
    const unsigned hit = (__ballot_sync(0xffffffffu, zero) >> first) & group;
    if (live && sub == 0) {
      lens[row] = len;
      bad[row] = len == 0 || hit != 0;
    }
  }
}

}  // namespace

extern "C" {

// K11.  flat: the patterns' bytes end to end; offs: (B + 1,) int64, each
// pattern's first byte in flat and then the end; mapping: (256,) uint8 byte
// -> code (0 outside the alphabet); mat: (B, Lmax) int32, lens: (B,) int32
// and bad: (B,) bytes, the outputs.  Lmax: a power of two, at least 2 and at
// least every length.  Returns cudaGetLastError() after the launch.
int psac_pattern_pack(const uint8_t* flat, const int64_t* offs,
                      const uint8_t* mapping, int32_t* mat, int32_t* lens,
                      uint8_t* bad, long long B, int Lmax, void* stream) {
  if (Lmax < 2 || (Lmax & (Lmax - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B > 0) {
    const int G = Lmax < 32 ? Lmax : 32;
    const long long warps = (B + 32 / G - 1) / (32 / G);
    long long blocks = (warps + WARPS - 1) / WARPS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    pattern_pack_kernel<<<static_cast<unsigned>(blocks), T, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        flat, offs, mapping, mat, lens, bad, B, Lmax, G);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
