// The k-mer init of SA+LCP and of the GSA for Hopper (sm_90a): K9 and K10.
//
// Replaces the XLA fusions of the JAX package's jitted k-mer init (no
// Pallas kernel; XLA fuses each of them into a few passes, where eager
// torch writes every intermediate to device memory, about 130 passes and
// 2 KB a position at DNA widths):
//
//   K9  kmer_pack   psac_tpu/ops/kmer.py:28-48 (pack_kmers_local) with the
//                   pad-rank select of psac_tpu/models/suffix_array.py:
//                   205-216, and the eos-masked pack with its pad rank of
//                   psac_tpu/models/gsa.py:124-140;
//   K10 kmer_heads  the bucket heads (prev_of per word, the newb reduce)
//                   and the bitwise LCP of psac_tpu/ops/bitops.py:21-55 with
//                   the lcp0 rules of psac_tpu/models/suffix_array.py:
//                   217-231 and psac_tpu/models/gsa.py:145-160.
//
// K9: word w of position i packs chars off_w .. off_w + ks[w] - 1 of the
// window codes[i ..] (the shard's codes, then the k - 1 halo codes from the
// right neighbours, read through a second pointer so the shard is never
// copied), MSB-first, `bits` a char, as unsigned 32-bit arithmetic (the sum
// of a word's bits is at most 31; every code is below 2^bits, as the
// alphabets give them).  The GSA takes char j only where gidx + j < eos[i].
// Where word 0 is 0 (a padding suffix) the last word becomes the pad rank
// (int32)(N - gidx).
//
// K9's design: a thread takes a run of R consecutive positions (R = 4,
// T = 64 threads a block, so 256 positions a block; PSAC_K9_RUN,
// PSAC_K9_THREADS, set by tools/k9_sweep.py).  Its words are one k-char
// shift register over the nw words: a char moves every word left by
// `bits`, the top char of word w + 1 enters word w, the new char enters
// the last word, and each word's mask drops the char that leaves its top
// (a shift, a shift and a three-input logic op a word).  The thread feeds
// the register the k - 1 chars before its first position's last one (the
// full build), then one char a position and takes the words after each,
// where each position used to build its words alone (k shared reads and
// shift-ors, about 120 instructions).  The block's window of codes sits
// in shared memory split into R phases (char a of the window in row a %
// R, column a / R), the phase origin moved so that a thread's first read
// of each position falls in row 0: every read of the stream is one row at
// a compile-time offset, and the 32 threads of a warp read 32 consecutive
// columns of it (no bank conflicts at stride R); the rows are padded so
// that the window's coalesced stores fall in 32 banks too.  The window's
// tail past the block's own chars (R * kp, up to 92 at k = 93) takes
// TAIL_ROUNDS unrolled rounds of the threads (two at R = 4 x 64; a
// runtime loop there took 40 registers and cost 12%).  The GSA's
// mask is arithmetic: each position's cut, the chars past its string's
// end (clamp(g + k - eos, 0, k)), is staged from coalesced eos loads as a
// byte a position; word w then keeps its top chars with one shift of ~0
// by max(cut - (chars after word w), 0) * bits (PTX's shl gives 0 for
// shifts of 32 or more, so the whole word goes when its last kept char
// lies before it) and an and, on a copy: the register keeps every char
// for the next position.  Four positions' words go out as one 16-byte
// store a word, so at R = 4 a warp stores 512 contiguous bytes a word.
// Longer runs spread the full build over more positions but scatter those
// stores (16 B every 4R bytes): at the 2^26 SA init R = 8 took 0.369 ms,
// R = 16 0.521 ms and R = 32 1.003 ms against R = 4's 0.274 ms.
//
// K10: row i of the sorted words is a bucket head (newb) where some word
// differs from row i - 1's (the left halo, one value a word, -1 on shard 0,
// for row 0).  With the LCP, per word
//   lw = kw                                   where the words are equal,
//   lw = floor((clz(a ^ b) - (32 - kw*bits)) / bits)   otherwise,
// summed over words while all earlier words were equal.  The quotient is
// floored as JAX's `//` and torch's rounding_mode="floor" do: C's `/`
// truncates, and the numerator is negative where a row meets the fill -1
// or a pad rank above the k-mer's bits.  Then lcp0 = newb ? lcp : N; the
// SA gives its padding rows (gidx < N - n_real) gidx, the GSA caps lcp by
// both suffixes' remaining lengths (rem of rows i - 1 and i, the left halo
// 0 on shard 0) before the select, and row 0 gets 0.  One thread a row: it
// reads row i of each word and row i - 1, which the previous thread read
// too (an L1 hit), and writes newb as a byte and lcp0 in the index type.
// Variants: int32 and int64 index types, SA and GSA, with and without the
// LCP (templates).
//
// What bounds them: compulsory bytes.  K9 reads 4 B of codes (and 4 or 8 B
// of eos in the GSA) and writes 4 B a word: 12 B a position for SA at two
// words (0.24 ms at 2^26 at 3.35 TB/s), 16 B for the int32 GSA.  K10 reads
// 4 B a word and writes 1 B of newb and the lcp0 word: 13 B a row for the
// int32 SA at two words, 17 B with the GSA's rem.  K9's first version built
// every position alone (k shared reads and shift-ors, about 120
// instructions a position) and took 0.665 ms at 2^26, 36% of its bound:
// the card's integer pipes were the limit, not the bytes.  The shift
// register at R = 4 takes (k - 1 + delta + 4) / 4 chars a position, six
// at two words, a shared read and five integer instructions each, and
// reaches 88% of the bound at the 2^26 SA init and 89% at the GSA init
// (tools/k9_sweep.py, NVIDIA H100 80GB HBM3, 700 W); three words (dna3)
// reach 78%.  K10's work (one clz a word) is far below it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 256;           // K10: rows (threads) per block
constexpr int MAX_WORDS = 3;
constexpr int MAX_K = 93;        // three words of 31 one-bit chars

#ifndef PSAC_K9_THREADS
#define PSAC_K9_THREADS 64
#endif
#ifndef PSAC_K9_RUN
#define PSAC_K9_RUN 4
#endif

constexpr int T9 = PSAC_K9_THREADS;  // K9: threads per block
constexpr int R9 = PSAC_K9_RUN;      // K9: positions per thread
constexpr int BLOCK9 = T9 * R9;      // K9: positions per block
// columns of the window past a block's own: (k - 1 + the phase shift) / R9
constexpr int KP_MAX = (MAX_K - 1 + R9 - 1) / R9;
// rounds of the block's threads that load the R9 * kp chars of the window
// past the block's own: two at R9 * KP_MAX > T9 (k = 93 at R4 x 64)
constexpr int TAIL_ROUNDS = (R9 * KP_MAX + T9 - 1) / T9;

// a row's length: at least T9 + KP_MAX columns, and 32 / R9 banks (mod
// 32), so that a warp's 32 coalesced window stores (32 / R9 columns in
// each of R9 rows) fall in 32 banks
constexpr int row_stride() {
  int p = T9 + KP_MAX;
  while (p % 32 != (32 / R9) % 32) ++p;
  return p;
}
constexpr int PS = row_stride();

static_assert(R9 == 4 || R9 == 8 || R9 == 16 || R9 == 32,
              "PSAC_K9_RUN: 4, 8, 16 or 32 positions a thread");
static_assert(T9 % 32 == 0 && T9 >= 64 && T9 <= 1024,
              "PSAC_K9_THREADS: whole warps, 64 to 1024");
static_assert(BLOCK9 <= 8192, "K9's shared memory holds 8192 positions");
static_assert(R9 * PS * 4 + BLOCK9 <= 48 * 1024, "K9: static shared memory");

struct Ks {
  int k[MAX_WORDS];
};

// x << n with PTX's shl: 0 for n >= 32
__device__ __forceinline__ uint32_t shl_sat(uint32_t x, uint32_t n) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

// one char into the k-char shift register of nw words
template <int NW>
__device__ __forceinline__ void roll(uint32_t (&w)[NW], uint32_t c, int bits,
                                     const uint32_t (&mask)[NW],
                                     const int (&top)[NW]) {
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) {
    w[i] = ((w[i] << bits) | (w[i + 1] >> top[i + 1])) & mask[i];
  }
  w[NW - 1] = ((w[NW - 1] << bits) | c) & mask[NW - 1];
}

// the window's entry at global index gi: the shard's codes, the halo, 0
__device__ __forceinline__ int32_t window_code(
    const int32_t* __restrict__ codes, const int32_t* __restrict__ halo,
    long long gi, long long s, int k) {
  if (gi < 0) return 0;
  if (gi < s) return codes[gi];
  if (gi - s < k - 1) return halo[gi - s];
  return 0;
}

template <int NW>
__device__ __forceinline__ void store4(int32_t* const (&out)[MAX_WORDS],
                                       const uint32_t (&grp)[NW][4],
                                       long long i, long long s, bool full) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    if (full) {
      *reinterpret_cast<int4*>(out[w] + i) = make_int4(
          static_cast<int>(grp[w][0]), static_cast<int>(grp[w][1]),
          static_cast<int>(grp[w][2]), static_cast<int>(grp[w][3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e < s) out[w][i + e] = static_cast<int32_t>(grp[w][e]);
      }
    }
  }
}

template <int NW, bool MASKED, typename Idx>
__global__ void __launch_bounds__(T9)
pack_kernel(const int32_t* __restrict__ codes,
            const int32_t* __restrict__ halo, const Idx* __restrict__ eos,
            int32_t* __restrict__ w0, int32_t* __restrict__ w1,
            int32_t* __restrict__ w2, long long s, Ks ks, int k, int bits,
            long long base, long long N) {
  // the window, char a (of the block's, from `delta` chars before its first
  // position) at win[(a % R9) * PS + a / R9]
  __shared__ int32_t win[R9 * PS];
  // the GSA's cut of block position p at cut[(p % R9) * T9 + p / R9]
  __shared__ uint8_t cut[MASKED ? BLOCK9 : 1];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * BLOCK9;
  // the phase shift: a thread's run starts in row 0 at column t, and its
  // first position's last char (j = k - 1) falls in row 0 of column t + kp
  const int delta = (R9 - (k - 1) % R9) % R9;
  const int kp = (k - 1 + delta) / R9;
  const long long g0 = first - delta;  // global index of window char 0
  const int nwin = R9 * (T9 + kp);
  {
    // window chars tid + m * T9 (m < R9), then the tail past the block's
    // own, R9 * kp chars at R9 * T9 + e: e = tid + j * T9 has e % R9 ==
    // tid % R9, so it lands in the thread's row at column T9 + e / R9
    int32_t* const dst = win + (tid % R9) * PS + tid / R9;
    constexpr int STEP = T9 / R9;  // columns between a thread's stores
    const int ntail = R9 * kp;
    if (g0 >= 0 && g0 + nwin <= s) {
      const int32_t* const src = codes + g0 + tid;
#pragma unroll
      for (int m = 0; m < R9; ++m) dst[m * STEP] = src[m * T9];
#pragma unroll
      for (int j = 0; j < TAIL_ROUNDS; ++j) {
        if (tid + j * T9 < ntail) dst[T9 + j * STEP] = src[(R9 + j) * T9];
      }
    } else {
#pragma unroll
      for (int m = 0; m < R9; ++m) {
        dst[m * STEP] = window_code(codes, halo, g0 + tid + m * T9, s, k);
      }
#pragma unroll
      for (int j = 0; j < TAIL_ROUNDS; ++j) {
        if (tid + j * T9 < ntail) {
          dst[T9 + j * STEP] =
              window_code(codes, halo, g0 + tid + (R9 + j) * T9, s, k);
        }
      }
    }
  }
  if (MASKED) {
    uint8_t* const dst = cut + (tid % R9) * T9 + tid / R9;
#pragma unroll
    for (int m = 0; m < R9; ++m) {
      const long long p = first + tid + m * T9;
      if (p < s) {
        const Idx g = static_cast<Idx>(base + p);
        Idx c = g + static_cast<Idx>(k) - eos[p];
        c = c < 0 ? 0 : (c > k ? static_cast<Idx>(k) : c);
        dst[m * (T9 / R9)] = static_cast<uint8_t>(c);
      }
    }
  }
  __syncthreads();

  const long long i0 = first + static_cast<long long>(R9) * tid;
  if (i0 >= s) return;
  uint32_t mask[NW];
  int top[NW];    // shift of a word's top char to its bottom
  int after[NW];  // bits of the words after word w
  {
    int rest = 0;
#pragma unroll
    for (int w = NW - 1; w >= 0; --w) {
      mask[w] = (1u << (ks.k[w] * bits)) - 1u;
      top[w] = (ks.k[w] - 1) * bits;
      after[w] = rest;
      rest += ks.k[w] * bits;
    }
  }
  uint32_t reg[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) reg[w] = 0u;
  const int32_t* rd = win + tid;
  for (int c = 0; c < kp; ++c, ++rd) {
#pragma unroll
    for (int f = 0; f < R9; ++f) {
      roll<NW>(reg, static_cast<uint32_t>(rd[f * PS]), bits, mask, top);
    }
  }
  int32_t* const out[MAX_WORDS] = {w0, w1, w2};
  const uint32_t pad0 = static_cast<uint32_t>(N - base - i0);  // mod 2^32
  const bool full = i0 + R9 <= s;
  uint32_t grp[NW][4];
#pragma unroll
  for (int f = 0; f < R9; ++f) {
    roll<NW>(reg, static_cast<uint32_t>(rd[f * PS]), bits, mask, top);
    uint32_t o[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) o[w] = reg[w];
    if (MASKED) {
      const int cb = static_cast<int>(cut[f * T9 + tid]) * bits;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int sh = cb - after[w];
        o[w] &= shl_sat(~0u, static_cast<uint32_t>(sh > 0 ? sh : 0));
      }
    }
    if (o[0] == 0u) o[NW - 1] = pad0 - static_cast<uint32_t>(f);
#pragma unroll
    for (int w = 0; w < NW; ++w) grp[w][f % 4] = o[w];
    if (f % 4 == 3) store4<NW>(out, grp, i0 + f - 3, s, full);
  }
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <bool GSA, bool LCP, typename Idx>
__global__ void __launch_bounds__(T)
heads_kernel(const int32_t* __restrict__ w0, const int32_t* __restrict__ w1,
             const int32_t* __restrict__ w2,
             const int32_t* __restrict__ halo, const Idx* __restrict__ rem,
             const Idx* __restrict__ rem_halo, uint8_t* __restrict__ newb,
             Idx* __restrict__ lcp0, long long s, int nw, Ks ks, int bits,
             long long base, long long N, long long n_real) {
  const long long i = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (i >= s) return;
  const int32_t* const ws[MAX_WORDS] = {w0, w1, w2};
  bool head = false;
  bool live = true;  // all earlier words equal
  int lcp = 0;
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) {
    if (w < nw) {
      const int32_t b = ws[w][i];
      const int32_t a = i > 0 ? ws[w][i - 1] : halo[w];
      const int32_t x = a ^ b;
      head = head || x != 0;
      if (LCP) {
        const int kw = ks.k[w];
        const int lw =
            x == 0 ? kw : floor_div(__clz(x) - (32 - kw * bits), bits);
        if (w == 0) {
          lcp = lw;
        } else if (live) {
          lcp += lw;
        }
        live = live && x == 0;
      }
    }
  }
  newb[i] = head ? 1 : 0;
  if (!LCP) return;
  const long long g = base + i;
  Idx v = static_cast<Idx>(lcp);
  if (GSA) {
    const Idx pr = i > 0 ? rem[i - 1] : rem_halo[0];
    const Idx r = rem[i];
    v = pr < v ? pr : v;
    v = r < v ? r : v;
  }
  v = head ? v : static_cast<Idx>(N);
  if (!GSA && g < N - n_real) v = static_cast<Idx>(g);
  if (g == 0) v = 0;
  lcp0[i] = v;
}

unsigned blocks_for(long long s) {
  return static_cast<unsigned>((s + T - 1) / T);
}

template <int NW, typename Idx>
void pack_launch(const int32_t* codes, const int32_t* halo, const Idx* eos,
                 int32_t* w0, int32_t* w1, int32_t* w2, long long s, Ks ks,
                 int k, int bits, long long base, long long N,
                 cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((s + BLOCK9 - 1) / BLOCK9);
  if (eos != nullptr) {
    pack_kernel<NW, true, Idx><<<blocks, T9, 0, stream>>>(
        codes, halo, eos, w0, w1, w2, s, ks, k, bits, base, N);
  } else {
    pack_kernel<NW, false, Idx><<<blocks, T9, 0, stream>>>(
        codes, halo, eos, w0, w1, w2, s, ks, k, bits, base, N);
  }
}

template <typename Idx>
int kmer_pack(const int32_t* codes, const int32_t* halo, const Idx* eos,
              int32_t* w0, int32_t* w1, int32_t* w2, long long s, int nw,
              int k0, int k1, int k2, int bits, long long base, long long N,
              cudaStream_t stream) {
  const Ks ks{{k0, k1, k2}};
  const int k = k0 + (nw > 1 ? k1 : 0) + (nw > 2 ? k2 : 0);
  // the words go out as 16-byte stores
  const uintptr_t outs = reinterpret_cast<uintptr_t>(w0) |
                         reinterpret_cast<uintptr_t>(w1) |
                         reinterpret_cast<uintptr_t>(w2);
  if (outs % 16 != 0 || nw < 1 || nw > MAX_WORDS || k > MAX_K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s > 0) {
    if (nw == 1) {
      pack_launch<1, Idx>(codes, halo, eos, w0, w1, w2, s, ks, k, bits, base,
                          N, stream);
    } else if (nw == 2) {
      pack_launch<2, Idx>(codes, halo, eos, w0, w1, w2, s, ks, k, bits, base,
                          N, stream);
    } else {
      pack_launch<3, Idx>(codes, halo, eos, w0, w1, w2, s, ks, k, bits, base,
                          N, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool GSA, typename Idx>
void heads_launch(const int32_t* w0, const int32_t* w1, const int32_t* w2,
                  const int32_t* halo, const Idx* rem, const Idx* rem_halo,
                  uint8_t* newb, Idx* lcp0, long long s, int nw, Ks ks,
                  int bits, long long base, long long N, long long n_real,
                  cudaStream_t stream) {
  if (lcp0 != nullptr) {
    heads_kernel<GSA, true, Idx><<<blocks_for(s), T, 0, stream>>>(
        w0, w1, w2, halo, rem, rem_halo, newb, lcp0, s, nw, ks, bits, base,
        N, n_real);
  } else {
    heads_kernel<GSA, false, Idx><<<blocks_for(s), T, 0, stream>>>(
        w0, w1, w2, halo, rem, rem_halo, newb, lcp0, s, nw, ks, bits, base,
        N, n_real);
  }
}

template <typename Idx>
int kmer_heads(const int32_t* w0, const int32_t* w1, const int32_t* w2,
               const int32_t* halo, const Idx* rem, const Idx* rem_halo,
               uint8_t* newb, Idx* lcp0, long long s, int nw, int k0, int k1,
               int k2, int bits, long long base, long long N,
               long long n_real, cudaStream_t stream) {
  const Ks ks{{k0, k1, k2}};
  if (s > 0) {
    if (rem != nullptr) {
      heads_launch<true, Idx>(w0, w1, w2, halo, rem, rem_halo, newb, lcp0,
                              s, nw, ks, bits, base, N, n_real, stream);
    } else {
      heads_launch<false, Idx>(w0, w1, w2, halo, rem, rem_halo, newb, lcp0,
                               s, nw, ks, bits, base, N, n_real, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K9.  codes: (s,) int32; halo: (k - 1,) int32; eos: (s,) of the index type
// for the GSA, null for the SA; w0..w2: (s,) int32 outputs, the unused ones
// null (nw words, ks k0..k2).  Returns cudaGetLastError() after the launch.
int psac_kmer_pack_i32(const int32_t* codes, const int32_t* halo,
                       const int32_t* eos, int32_t* w0, int32_t* w1,
                       int32_t* w2, long long s, int nw, int k0, int k1,
                       int k2, int bits, long long base, long long N,
                       void* stream) {
  return kmer_pack<int32_t>(codes, halo, eos, w0, w1, w2, s, nw, k0, k1, k2,
                            bits, base, N,
                            static_cast<cudaStream_t>(stream));
}

int psac_kmer_pack_i64(const int32_t* codes, const int32_t* halo,
                       const int64_t* eos, int32_t* w0, int32_t* w1,
                       int32_t* w2, long long s, int nw, int k0, int k1,
                       int k2, int bits, long long base, long long N,
                       void* stream) {
  return kmer_pack<int64_t>(codes, halo, eos, w0, w1, w2, s, nw, k0, k1, k2,
                            bits, base, N,
                            static_cast<cudaStream_t>(stream));
}

// K10.  w0..w2: the (s,) sorted int32 words (unused ones null); halo: (nw,)
// int32, each word's value on the row before this shard; rem, rem_halo:
// (s,) and (1,) of the index type for the GSA, null for the SA; newb: (s,)
// bytes; lcp0: (s,) of the index type, null without the LCP.
int psac_kmer_heads_i32(const int32_t* w0, const int32_t* w1,
                        const int32_t* w2, const int32_t* halo,
                        const int32_t* rem, const int32_t* rem_halo,
                        uint8_t* newb, int32_t* lcp0, long long s, int nw,
                        int k0, int k1, int k2, int bits, long long base,
                        long long N, long long n_real, void* stream) {
  return kmer_heads<int32_t>(w0, w1, w2, halo, rem, rem_halo, newb, lcp0, s,
                             nw, k0, k1, k2, bits, base, N, n_real,
                             static_cast<cudaStream_t>(stream));
}

int psac_kmer_heads_i64(const int32_t* w0, const int32_t* w1,
                        const int32_t* w2, const int32_t* halo,
                        const int64_t* rem, const int64_t* rem_halo,
                        uint8_t* newb, int64_t* lcp0, long long s, int nw,
                        int k0, int k1, int k2, int bits, long long base,
                        long long N, long long n_real, void* stream) {
  return kmer_heads<int64_t>(w0, w1, w2, halo, rem, rem_halo, newb, lcp0, s,
                             nw, k0, k1, k2, bits, base, N, n_real,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
