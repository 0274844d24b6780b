"""(Numpy-only copy of ``psac_tpu/seq.py``, held equal to it by
tests/test_torch_ops.py.)

Sequential in-memory pattern indexes (reference include/seq_query.hpp).

The reference's ladder of single-node indexes — used there as local building
blocks and baselines — re-expressed in NumPy:

  SAIndex          binary search over suffixes        (seq_query.hpp:228-252)
  SALCPIndex       + LCP array                        (seq_query.hpp:254-271)
  ESAIndex         + RMQ top-down interval descent    (seq_query.hpp:275-361)
  BSESAIndex       Manber-Myers llcp/rlcp binsearch   (seq_query.hpp:368-445)
  DESAIndex        + materialized Lc, blind search    (seq_query.hpp:447-712)
  LookupDESAIndex  + TLLT k-mer table narrowing       (seq_query.hpp:715-904)

All ``locate`` methods return the half-open SA range [l, r) of exact
occurrences (``locate_possible`` on the DESA tiers returns the unverified
candidate range of the blind search).
"""

from __future__ import annotations

import numpy as np

from psac_tpu_torch.ops.alphabet import Alphabet
from psac_tpu_torch.ops.oracle import lcp_kasai


class _RMQ:
    """Leftmost-argmin sparse table (host-side)."""

    def __init__(self, a: np.ndarray):
        a = np.asarray(a, np.int64)
        n = len(a)
        L = max(1, (n - 1).bit_length() + 1)
        self.arg = np.zeros((L, n), np.int64)
        self.a = a
        self.arg[0] = np.arange(n)
        for k in range(1, L):
            w = 1 << (k - 1)
            prev = self.arg[k - 1]
            right = np.concatenate([prev[w:], prev[-w:] if w <= n else prev])[:n]
            take_r = a[right] < a[prev]
            self.arg[k] = np.where(take_r, right, prev)

    def query(self, l: int, r: int) -> int:
        """Leftmost index of the min of a[l..r] (inclusive)."""
        if l == r:
            return l
        k = (r - l + 1).bit_length() - 1
        i1 = self.arg[k][l]
        i2 = self.arg[k][r - (1 << k) + 1]
        if self.a[i2] < self.a[i1]:
            return int(i2)
        if self.a[i1] <= self.a[i2]:
            return int(i1)
        return int(min(i1, i2))


class SAIndex:
    """Plain binary search over the suffix array."""

    def __init__(self, text: bytes, sa: np.ndarray | None = None):
        self.text = bytes(text)
        self.n = len(self.text)
        if sa is None:
            from psac_tpu_torch import native
            sa = native.suffix_array(self.text)
        self.sa = np.asarray(sa, np.int64)

    def _suffix(self, row: int, m: int) -> bytes:
        s = int(self.sa[row])
        return self.text[s:s + m]

    def locate(self, P: bytes) -> tuple[int, int]:
        m = len(P)
        lo, hi = 0, self.n
        while lo < hi:  # first suffix >= P
            mid = (lo + hi) // 2
            if self._suffix(mid, m) < P:
                lo = mid + 1
            else:
                hi = mid
        l = lo
        hi = self.n
        while lo < hi:  # first suffix > P (prefix-wise)
            mid = (lo + hi) // 2
            if self._suffix(mid, m) <= P:
                lo = mid + 1
            else:
                hi = mid
        return l, lo


class SALCPIndex(SAIndex):
    """Adds the LCP array (Kasai)."""

    def __init__(self, text: bytes, sa=None):
        super().__init__(text, sa)
        self.lcp = lcp_kasai(self.text, self.sa)


class ESAIndex(SALCPIndex):
    """Adds the RMQ; locate via top-down lcp-interval descent.

    Branching chars are read from the text on the fly
    (Lc[i] = text[SA[i-1] + LCP[i]], reference seq_query.hpp:463-467)."""

    def __init__(self, text: bytes, sa=None):
        super().__init__(text, sa)
        self.rmq = _RMQ(self.lcp)

    def _lc(self, i: int) -> int:
        idx = int(self.sa[i - 1] + self.lcp[i])
        return self.text[idx] if idx < self.n else 0

    def locate_possible(self, P: bytes) -> tuple[int, int]:
        """Blind search: candidate range; all-or-none occurrences."""
        m = len(P)
        n = self.n
        if n == 0 or m == 0:
            return 0, 0
        l, r = 0, n - 1
        if l == r:
            return l, r + 1
        i = self.rmq.query(l + 1, r)
        q = int(self.lcp[i])
        while q < m and l < r and l < i:
            c = P[q]
            while True:
                if self._lc(i) == c:
                    r = i - 1
                    break
                l = i
                if l == r:
                    break
                i = self.rmq.query(l + 1, r)
                if not (l < r and self.lcp[i] == q):
                    break
            if self.lcp[i] == q:
                # NB: descend whenever l < r (the reference only descends
                # when l+1 < r, mishandling 2-row intervals; see
                # psac_tpu_torch.models.desa for the matching device-side note)
                i = self.rmq.query(l + 1, r) if l < r else l
            q = int(self.lcp[i])
        return l, r + 1

    def locate(self, P: bytes) -> tuple[int, int]:
        l, r = self.locate_possible(P)
        if l >= r:
            return l, l
        s = int(self.sa[l])
        if self.text[s:s + len(P)] == bytes(P):
            return l, r
        return l, l


class BSESAIndex(SALCPIndex):
    """Manber-Myers binary search with llcp/rlcp answered by RMQ
    (reference bs_esa_index, seq_query.hpp:368-445)."""

    def __init__(self, text: bytes, sa=None):
        super().__init__(text, sa)
        self.rmq = _RMQ(self.lcp)

    def _lcp_rows(self, i: int, j: int) -> int:
        """lcp(suffix at SA row i, suffix at SA row j), i < j."""
        return int(self.lcp[self.rmq.query(i + 1, j)])

    def _cmp_from(self, row: int, P: bytes, h: int) -> tuple[int, int]:
        """Compare P to suffix SA[row] starting at offset h.
        Returns (cmp, matched_len)."""
        s = int(self.sa[row])
        m = len(P)
        k = h
        while k < m and s + k < self.n:
            if self.text[s + k] != P[k]:
                return (1 if self.text[s + k] > P[k] else -1), k
            k += 1
        if k == m:
            return 0, m
        return -1, k  # suffix exhausted first -> suffix < P

    def locate(self, P: bytes) -> tuple[int, int]:
        n, m = self.n, len(P)
        if n == 0 or m == 0:
            return 0, 0

        def boundary(upper: bool) -> int:
            lo, hi = -1, n  # invariant: sa[lo] < P(-ish) <= sa[hi]
            hlo = hhi = 0
            while hi - lo > 1:
                mid = (lo + hi) // 2
                h = min(hlo, hhi)
                cmp, k = self._cmp_from(mid, P, h)
                after = cmp < 0 or (cmp == 0 and upper)
                if after:
                    lo, hlo = mid, min(k, m)
                else:
                    hi, hhi = mid, min(k, m)
            return hi

        l = boundary(False)
        r = boundary(True)
        return l, r


class DESAIndex(ESAIndex):
    """Materializes the Lc array (reference desa_index)."""

    def __init__(self, text: bytes, sa=None):
        super().__init__(text, sa)
        lc = np.zeros(self.n, np.int64)
        idx = self.sa[:-1] + self.lcp[1:]
        ok = idx < self.n
        lc[1:][ok] = np.frombuffer(self.text, np.uint8)[idx[ok]]
        self._lc_arr = lc

    def _lc(self, i: int) -> int:
        return int(self._lc_arr[i])


class LookupDESAIndex(DESAIndex):
    """Adds the TLLT k-mer prefix table to skip the top of the descent."""

    def __init__(self, text: bytes, sa=None, bits: int = 12):
        super().__init__(text, sa)
        self.alpha = Alphabet.from_bytes(text)
        b = self.alpha.bits_per_char
        self.k = max(1, min(bits // b, 12))
        codes = self.alpha.encode(text).astype(np.int64)
        km = np.zeros(self.n, np.int64)
        for j in range(self.k):
            c = np.concatenate([codes[j:], np.zeros(j, np.int64)])
            km = (km << b) | c
        self.table = np.cumsum(np.bincount(km, minlength=1 << (self.k * b)))

    def lookup(self, P: bytes) -> tuple[int, int]:
        b = self.alpha.bits_per_char
        codes = self.alpha.mapping[np.frombuffer(bytes(P[:self.k]), np.uint8)]
        km = 0
        for c in codes:
            km = (km << b) | int(c)
        if len(P) >= self.k:
            lo = 0 if km == 0 else int(self.table[km - 1])
            return lo, int(self.table[km])
        extra = self.k - len(P)
        km <<= extra * b
        lo = 0 if km == 0 else int(self.table[km - 1])
        return lo, int(self.table[km + (1 << (extra * b)) - 1])

    def locate_possible(self, P: bytes) -> tuple[int, int]:
        m = len(P)
        l, r = self.lookup(P)
        if m <= self.k or l >= r:
            return l, r
        r -= 1
        if l >= r:
            return l, r + 1
        i = self.rmq.query(l + 1, r)
        q = int(self.lcp[i])
        while q < m and l < r and l < i:
            c = P[q]
            while True:
                if self._lc(i) == c:
                    r = i - 1
                    break
                l = i
                if l == r:
                    break
                i = self.rmq.query(l + 1, r)
                if not (l < r and self.lcp[i] == q):
                    break
            if self.lcp[i] == q:
                i = self.rmq.query(l + 1, r) if l < r else l
            q = int(self.lcp[i])
        return l, r + 1
