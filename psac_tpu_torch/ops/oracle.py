"""Sequential oracles for conformance testing.

(Numpy-only copy of ``psac_tpu/ops/oracle.py``, held equal to it by
tests/test_torch_ops.py.)

The reference verifies against libdivsufsort (``include/divsufsort_wrapper.hpp``)
plus Kasai LCP (``include/lcp.hpp:46``) and golden tiny cases (SURVEY.md §4).
Here the oracle tier is:

1. ``suffix_array_naive`` — direct suffix sort, trivially correct, tiny inputs.
2. ``suffix_array_np`` — NumPy prefix-doubling (lexsort), medium inputs.
3. the native C++ SA-IS oracle in ``psac_tpu_torch/native`` (ctypes), large inputs.

These are *independent implementations*, not ports of the reference's checkers.
"""

from __future__ import annotations

import numpy as np


def suffix_array_naive(text: bytes) -> np.ndarray:
    n = len(text)
    return np.array(sorted(range(n), key=lambda i: text[i:]), dtype=np.int64)


def suffix_array_np(text: bytes | np.ndarray) -> np.ndarray:
    """O(n log^2 n) prefix-doubling with np.lexsort (sequential oracle)."""
    t = np.frombuffer(text, dtype=np.uint8) if isinstance(text, (bytes, bytearray)) else np.asarray(text)
    n = len(t)
    if n == 0:
        return np.zeros(0, np.int64)
    rank = t.astype(np.int64)
    d = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        rank2 = np.where(idx + d < n, np.concatenate([rank[d:], np.full(min(d, n), -1)])[:n], -1)
        order = np.lexsort((rank2, rank))
        r1, r2 = rank[order], rank2[order]
        boundary = np.ones(n, dtype=np.int64)
        boundary[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        newrank_sorted = np.cumsum(boundary) - 1
        rank = np.empty(n, np.int64)
        rank[order] = newrank_sorted
        if newrank_sorted[-1] == n - 1:
            return order.astype(np.int64)
        d *= 2


def lcp_kasai(text: bytes | np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai's O(n) LCP-from-SA (cf. reference ``include/lcp.hpp:46``).

    Returns LCP with the reference convention LCP[0] = 0,
    LCP[i] = lcp(S[SA[i-1]..], S[SA[i]..]).
    """
    t = np.frombuffer(text, dtype=np.uint8) if isinstance(text, (bytes, bytearray)) else np.asarray(text)
    n = len(t)
    sa = np.asarray(sa, np.int64)
    rank = np.empty(n, np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, np.int64)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            while i + h < n and j + h < n and t[i + h] == t[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp
