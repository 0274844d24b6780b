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
// of a word's bits is at most 31).  The GSA takes char j only where
// gidx + j < eos[i].  Where word 0 is 0 (a padding suffix) the last word
// becomes the pad rank (int32)(N - gidx).  One thread a position, 256 a
// block: the block first reads its window of 256 + k - 1 codes into shared
// memory with coalesced loads, so the k - 1 codes shared with the next
// block are the only ones read twice; each thread then reads its k chars
// from shared memory (consecutive threads, consecutive words: no bank
// conflicts) and writes each word coalesced.
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
// int32 SA at two words, 17 B with the GSA's rem.  The work per position
// (k shared-memory reads and shift-ors, one clz a word) is far below the
// card's integer rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 256;           // positions (threads) per block
constexpr int MAX_WORDS = 3;
constexpr int MAX_K = 93;        // three words of 31 one-bit chars

struct Ks {
  int k[MAX_WORDS];
};

template <bool MASKED, typename Idx>
__global__ void __launch_bounds__(T)
pack_kernel(const int32_t* __restrict__ codes,
            const int32_t* __restrict__ halo, const Idx* __restrict__ eos,
            int32_t* __restrict__ w0, int32_t* __restrict__ w1,
            int32_t* __restrict__ w2, long long s, int nw, Ks ks, int k,
            int bits, long long base, long long N) {
  __shared__ int32_t win[T + MAX_K - 1];
  const long long first = static_cast<long long>(blockIdx.x) * T;
  for (int t = threadIdx.x; t < T + k - 1; t += T) {
    const long long pos = first + t;
    int32_t c = 0;
    if (pos < s) {
      c = codes[pos];
    } else if (pos - s < k - 1) {
      c = halo[pos - s];
    }
    win[t] = c;
  }
  __syncthreads();
  const long long i = first + threadIdx.x;
  if (i >= s) return;
  const long long g = base + i;
  // chars j < lim are taken (the GSA: gidx + j < eos[i])
  long long lim = k;
  if (MASKED) lim = static_cast<long long>(eos[i]) - g;
  uint32_t word[MAX_WORDS] = {0u, 0u, 0u};
  int off = 0;
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) {
    if (w < nw) {
      uint32_t acc = 0u;
      for (int j = off; j < off + ks.k[w]; ++j) {
        uint32_t c = static_cast<uint32_t>(win[threadIdx.x + j]);
        if (MASKED && j >= lim) c = 0u;
        acc = (acc << bits) | c;
      }
      word[w] = acc;
      off += ks.k[w];
    }
  }
  if (word[0] == 0u) {
    const uint32_t pad_rank = static_cast<uint32_t>(N - g);  // mod 2^32
    if (nw == 1) {
      word[0] = pad_rank;
    } else if (nw == 2) {
      word[1] = pad_rank;
    } else {
      word[2] = pad_rank;
    }
  }
  w0[i] = static_cast<int32_t>(word[0]);
  if (nw > 1) w1[i] = static_cast<int32_t>(word[1]);
  if (nw > 2) w2[i] = static_cast<int32_t>(word[2]);
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

template <typename Idx>
int kmer_pack(const int32_t* codes, const int32_t* halo, const Idx* eos,
              int32_t* w0, int32_t* w1, int32_t* w2, long long s, int nw,
              int k0, int k1, int k2, int bits, long long base, long long N,
              cudaStream_t stream) {
  const Ks ks{{k0, k1, k2}};
  const int k = k0 + (nw > 1 ? k1 : 0) + (nw > 2 ? k2 : 0);
  if (s > 0) {
    if (eos != nullptr) {
      pack_kernel<true, Idx><<<blocks_for(s), T, 0, stream>>>(
          codes, halo, eos, w0, w1, w2, s, nw, ks, k, bits, base, N);
    } else {
      pack_kernel<false, Idx><<<blocks_for(s), T, 0, stream>>>(
          codes, halo, eos, w0, w1, w2, s, nw, ks, k, bits, base, N);
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
