"""(Numpy-only copy of ``psac_tpu/ops/ansv.py``, held equal to it by
tests/test_torch_ops.py.)

Sequential All-Nearest-Smaller-Values with the reference's match types.

Match semantics (per side; stated here for the LEFT side, right mirrors):

- ``nearest_sm``:  nearest j < i with A[j] <  A[i].
- ``nearest_eq``:  nearest j < i with A[j] <= A[i].
- ``furthest_eq``: let the *visible* positions from i be the prefix-minima
  chain j < i with min(A[j+1..i-1]) >= A[j].  Among visible positions with
  A[j] <= A[i], take the run with the largest value (== A[i] if an equal is
  visible, else the nearest-smaller's value) and return the run's furthest
  (leftmost) member.  This makes the match the canonical representative of
  its equal run — the property the suffix tree relies on for duplicate-node
  elimination (reference ``include/suffix_tree.hpp:126-160``), and the
  property asserted by the reference's checker
  (``test/test_ansv.cpp:85-88``: the match's own left match is strictly
  smaller).

This file is the sequential oracle (run-stack scan, O(n)); the distributed
device implementation lives in ``psac_tpu_torch.parallel.ansv``.  Reference behavior:
``include/ansv.hpp:47-65`` (plain), ``include/ansv.hpp:66-93``
(``update_nsv_queue`` match types).
"""

from __future__ import annotations

import numpy as np

NEAREST_SM = 0
NEAREST_EQ = 1
FURTHEST_EQ = 2

NONSV = np.iinfo(np.int64).max


def _left_scan(a: np.ndarray, typ: int) -> np.ndarray:
    """Left matches via a monotone stack of (value, first_idx, last_idx) runs."""
    n = len(a)
    out = np.full(n, NONSV, dtype=np.int64)
    # stack of runs: value strictly increasing bottom->top
    vals: list = []
    firsts: list = []
    lasts: list = []
    for i in range(n):
        v = a[i]
        while vals and vals[-1] > v:
            vals.pop(); firsts.pop(); lasts.pop()
        if vals:
            if typ == NEAREST_SM:
                if vals[-1] == v:
                    if len(vals) > 1:
                        out[i] = lasts[-2]
                else:
                    out[i] = lasts[-1]
            elif typ == NEAREST_EQ:
                out[i] = lasts[-1]
            else:  # FURTHEST_EQ: leftmost member of the matched run
                out[i] = firsts[-1]
        if vals and vals[-1] == v:
            lasts[-1] = i
        else:
            vals.append(v); firsts.append(i); lasts.append(i)
    return out


def ansv_seq(a, left_type: int = NEAREST_SM, right_type: int = NEAREST_SM,
             nonsv: int = NONSV):
    """Sequential ANSV; returns (left, right) int64 index arrays (nonsv = no match)."""
    a = np.asarray(a)
    left = _left_scan(a, left_type)
    right = _left_scan(a[::-1], right_type)
    n = len(a)
    right = np.where(right == NONSV, NONSV, n - 1 - right)[::-1].copy()
    if nonsv != NONSV:
        left[left == NONSV] = nonsv
        right[right == NONSV] = nonsv
    return left, right
