// Native sequential oracle: SA-IS suffix array construction + Kasai LCP.
//
// Plays the role libdivsufsort plays for the reference (the sequential
// ground truth used by tests, benchmarks and the psac-vs-dss style
// conformance gate, cf. reference include/divsufsort_wrapper.hpp) — but is
// an independent from-scratch implementation of the SA-IS algorithm
// (Nong, Zhang & Chan, DCC'09), not a copy of any existing library.
//
// Exposed C ABI (ctypes):
//   sais_u8(text, n, sa)    — sa[i] int64, suffix array of text[0..n)
//   kasai_u8(text, n, sa, lcp) — lcp[0]=0, lcp[i]=lcp(text[sa[i-1]..], text[sa[i]..])
//
// Build: g++ -O3 -fPIC -shared sais.cpp -o libpsac_native.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using I = int64_t;

// Core SA-IS over an integer string s[0..n) with s[n-1] == 0 the unique
// minimum (sentinel). K = alphabet size (values in [0, K)).
static void sais_core(const I* s, I* sa, I n, I K) {
  if (n == 1) { sa[0] = 0; return; }

  std::vector<char> stype(n);
  stype[n - 1] = 1;
  for (I i = n - 2; i >= 0; --i)
    stype[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && stype[i + 1]);
  auto is_lms = [&](I i) { return i > 0 && stype[i] && !stype[i - 1]; };

  std::vector<I> counts(K, 0), bkt(K);
  for (I i = 0; i < n; ++i) counts[s[i]]++;
  auto bkt_ends = [&]() {
    I sum = 0;
    for (I k = 0; k < K; ++k) { sum += counts[k]; bkt[k] = sum; }
  };
  auto bkt_starts = [&]() {
    I sum = 0;
    for (I k = 0; k < K; ++k) { bkt[k] = sum; sum += counts[k]; }
  };

  auto induce = [&]() {
    // L-type left-to-right
    bkt_starts();
    for (I i = 0; i < n; ++i) {
      I j = sa[i] - 1;
      if (sa[i] > 0 && !stype[j]) sa[bkt[s[j]]++] = j;
    }
    // S-type right-to-left
    bkt_ends();
    for (I i = n - 1; i >= 0; --i) {
      I j = sa[i] - 1;
      if (sa[i] > 0 && stype[j]) sa[--bkt[s[j]]] = j;
    }
  };

  // Step 1: place LMS suffixes at bucket ends (text order), induce once.
  std::memset(sa, -1, sizeof(I) * n);
  bkt_ends();
  for (I i = n - 1; i >= 0; --i)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce();

  // Step 2: name LMS substrings in their induced order.
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (is_lms(sa[i])) sa[n1++] = sa[i];  // sorted LMS positions -> prefix of sa
  I* lms_sorted = sa;                      // first n1 entries
  I* names = sa + n1;                      // reuse tail as name workspace
  std::memset(names, -1, sizeof(I) * (n - n1));
  I name = 0, prev = -1;
  for (I r = 0; r < n1; ++r) {
    I pos = lms_sorted[r];
    bool differ = (prev < 0);
    if (!differ) {
      // compare LMS substrings at prev and pos
      for (I d = 0;; ++d) {
        bool end_p = d > 0 && is_lms(prev + d);
        bool end_q = d > 0 && is_lms(pos + d);
        if (prev + d >= n || pos + d >= n) { differ = true; break; }
        if (s[prev + d] != s[pos + d] || stype[prev + d] != stype[pos + d]) { differ = true; break; }
        if (end_p || end_q) { differ = !(end_p && end_q); break; }
      }
    }
    if (differ) { ++name; prev = pos; }
    names[pos / 2] = name - 1;
  }

  // Collect the reduced string (names of LMS in text order).
  std::vector<I> s1(n1);
  std::vector<I> lms_pos(n1);
  {
    I j = 0;
    for (I i = 0; i < n; ++i)
      if (is_lms(i)) lms_pos[j++] = i;
    for (I j2 = 0; j2 < n1; ++j2) s1[j2] = names[lms_pos[j2] / 2];
  }

  // Step 3: sort the reduced problem.
  std::vector<I> sa1(n1);
  if (name == n1) {
    for (I j = 0; j < n1; ++j) sa1[s1[j]] = j;
  } else {
    sais_core(s1.data(), sa1.data(), n1, name);
  }

  // Step 4: place LMS suffixes in their final order, induce.
  std::memset(sa, -1, sizeof(I) * n);
  bkt_ends();
  for (I r = n1 - 1; r >= 0; --r) {
    I pos = lms_pos[sa1[r]];
    sa[--bkt[s[pos]]] = pos;
  }
  induce();
}

}  // namespace

extern "C" {

void sais_u8(const uint8_t* text, int64_t n, int64_t* sa_out) {
  if (n <= 0) return;
  // Append a sentinel 0 strictly smaller than every char (chars mapped +1).
  std::vector<I> s(n + 1);
  for (I i = 0; i < n; ++i) s[i] = (I)text[i] + 1;
  s[n] = 0;
  std::vector<I> sa(n + 1);
  sais_core(s.data(), sa.data(), n + 1, 257);
  std::memcpy(sa_out, sa.data() + 1, sizeof(I) * n);  // drop sentinel suffix
}

void kasai_u8(const uint8_t* text, int64_t n, const int64_t* sa, int64_t* lcp_out) {
  if (n <= 0) return;
  std::vector<I> rank(n);
  for (I i = 0; i < n; ++i) rank[sa[i]] = i;
  I h = 0;
  lcp_out[0] = 0;
  for (I i = 0; i < n; ++i) {
    I r = rank[i];
    if (r > 0) {
      I j = sa[r - 1];
      while (i + h < n && j + h < n && text[i + h] == text[j + h]) ++h;
      lcp_out[r] = h;
      if (h > 0) --h;
    } else {
      h = 0;
    }
  }
}

}  // extern "C"
