"""Sequential suffix-tree oracle: expected flat node table from SA+LCP.

(Numpy-only copy of ``psac_tpu/verify/suffix_tree_oracle.py``, held equal
to it by tests/test_torch_ops.py.)

Independent implementation (interval decomposition over the LCP array, the
classic enhanced-suffix-array lcp-interval tree) used to verify the
distributed construction — the same role the reference's DFS checker plays
(``include/check_suffix_tree.hpp:34-123``), but built bottom-up from first
principles rather than ported.

Conventions match ``psac_tpu_torch.models.suffix_tree``: internal node id = LCP
index of the *first* position achieving the interval's depth (root = 0),
leaf id for SA position j = n + j, child slot = encoded char (0 = past-end).
"""

from __future__ import annotations

import numpy as np


def suffix_tree_oracle(codes: np.ndarray, sa: np.ndarray, lcp: np.ndarray,
                       sigma: int) -> np.ndarray:
    """codes: (n,) encoded text (1..sigma); returns (n, sigma+1) int64 table."""
    n = len(sa)
    nodes = np.zeros((n, sigma + 1), np.int64)
    if n <= 1:
        return nodes
    lcp = np.asarray(lcp, np.int64)
    sa = np.asarray(sa, np.int64)

    # explicit stack of intervals: (l, r, node_id, depth) over SA rows [l, r]
    stack = [(0, n - 1, 0, 0)]
    while stack:
        l, r, node_id, d = stack.pop()
        seg = lcp[l + 1:r + 1]
        # min > d happens only at the root of a text whose suffixes all share
        # a prefix (e.g. a^n): the root then has a single child interval
        assert seg.min() >= d, (l, r, node_id, d, seg.min())
        splits = (l + 1 + np.nonzero(seg == d)[0]).tolist()
        bounds = [l] + splits + [r + 1]
        for a, b_next in zip(bounds[:-1], bounds[1:]):
            b = b_next - 1
            cidx = sa[a] + d
            c = 0 if cidx >= n else int(codes[cidx])
            if a == b:
                nodes[node_id][c] = n + a
            else:
                sub = lcp[a + 1:b + 1]
                d2 = int(sub.min())
                cid = a + 1 + int(np.argmax(sub == d2))
                nodes[node_id][c] = cid
                stack.append((a, b, cid, d2))
    return nodes


def gst_oracle(codes: np.ndarray, sa: np.ndarray, lcp: np.ndarray,
               eos: np.ndarray, sigma: int) -> np.ndarray:
    """Expected generalized-suffix-tree table ((n, sigma+2) int64).

    Layout per ``construct_gst`` (reference include/suffix_tree.hpp:521-608):
    char-c edges in slot c+1; ``$``-edges aggregated as (min, max) child ids
    in slots 0-1; edges whose parent depth is 0 are not recorded.
    """
    n = len(sa)
    nodes = np.zeros((n, sigma + 2), np.int64)
    if n <= 1:
        return nodes
    lcp = np.asarray(lcp, np.int64)
    sa = np.asarray(sa, np.int64)
    dmin = np.full(n, np.iinfo(np.int64).max)
    dmax = np.full(n, -1, np.int64)

    stack = [(0, n - 1, 0, 0)]
    while stack:
        l, r, node_id, d = stack.pop()
        seg = lcp[l + 1:r + 1]
        splits = (l + 1 + np.nonzero(seg == d)[0]).tolist()
        bounds = [l] + splits + [r + 1]
        for a, b_next in zip(bounds[:-1], bounds[1:]):
            b = b_next - 1
            cidx = sa[a] + d
            if a == b:
                child = n + a
            else:
                sub = lcp[a + 1:b + 1]
                d2 = int(sub.min())
                child = a + 1 + int(np.argmax(sub == d2))
                stack.append((a, b, child, d2))
            if d == 0:
                continue  # root edges are not recorded
            if cidx >= eos[sa[a]]:
                dmin[node_id] = min(dmin[node_id], child)
                dmax[node_id] = max(dmax[node_id], child)
            else:
                nodes[node_id][int(codes[cidx]) + 1] = child
    has = dmax >= 0
    nodes[has, 0] = dmin[has]
    nodes[has, 1] = dmax[has]
    return nodes
