"""(Numpy-only copy of ``psac_tpu/ops/sample_lcp.py``, held equal to it by
tests/test_torch_ops.py.)

LCP sampling for the top-level doubling trie (reference include/tldt.hpp).

``sample_lcp`` keeps the LCP entries whose suffix-tree parent interval
exceeds ``maxsize`` (reference ``tldt.hpp:33-106``).  The kept set has the
closed-form characterization

    keep(i)  <=>  i == 0  or  LCP[i] == 0  or  (R_i - L_i) > maxsize

where L_i / R_i are the nearest positions left / right of i with a strictly
smaller LCP value (L_i of an equal run is shared = the run's left boundary;
R_i = n when none) — i.e. exactly the nearest-smaller-value matches.  The
single-device implementation in ``psac_tpu_torch.models.desa`` therefore
reuses the ANSV instead of porting the reference's two-pass stack protocol
(``sample_lcp_distr``, ``tldt.hpp:278-410``).

This module provides the sequential stack implementation (faithful to the
reference's algorithm, used as the test oracle) and the ANSV-based
characterization.
"""

from __future__ import annotations

import numpy as np


def sample_lcp_seq(lcp: np.ndarray, maxsize: int) -> np.ndarray:
    """Stack-based sequential sampling; returns the sorted kept indices."""
    lcp = np.asarray(lcp, np.int64)
    n = len(lcp)
    if n == 0:
        return np.zeros(0, np.int64)
    keep = np.zeros(n, bool)
    keep[0] = True
    # stack of (lcp_value, pos, left_boundary)
    st: list[tuple[int, int, int]] = [(0, 0, 0)]
    for i in range(1, n):
        v = int(lcp[i])
        while st and st[-1][0] > v:
            _, pos, lb = st.pop()
            if i - lb > maxsize:
                keep[pos] = True
        if st and st[-1][0] == v:
            st.append((v, i, st[-1][2]))
            if v == 0:
                keep[i] = True
        else:
            st.append((v, i, st[-1][1]))
    while st and st[-1][0] > 0:
        _, pos, lb = st.pop()
        if n - lb > maxsize:
            keep[pos] = True
    return np.nonzero(keep)[0].astype(np.int64)


def sample_lcp_ansv(lcp: np.ndarray, maxsize: int) -> np.ndarray:
    """The ANSV characterization (sequential form, for cross-checking)."""
    from psac_tpu_torch.ops.ansv import NEAREST_SM, ansv_seq

    lcp = np.asarray(lcp, np.int64)
    n = len(lcp)
    if n == 0:
        return np.zeros(0, np.int64)
    left, right = ansv_seq(lcp, NEAREST_SM, NEAREST_SM, nonsv=-1)
    L = np.where(left == -1, 0, left)
    R = np.where((right == -1) | (right == np.iinfo(np.int64).max), n, right)
    keep = (np.arange(n) == 0) | (lcp == 0) | ((R - L) > maxsize)
    return np.nonzero(keep)[0].astype(np.int64)
