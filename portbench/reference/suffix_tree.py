"""Plain suffix-tree node table from a suffix array and its LCP array.

The tree is the LCP-interval tree.  Its internal nodes are the intervals
[lb, rb] of rows whose LCPs (inside) are all at least their depth d, with
the LCP at lb and at rb + 1 below d; the root is [0, n - 1] at depth 0.
A node's id is the first row of its interval whose LCP is d (row 0, whose
LCP counts as 0, for the root); leaf j, the suffix at row j, has the id
n + j.  The table has one row per id and sigma + 1 slots: a node's child
whose path goes on with code c (1..sigma) is in slot c, and the leaf
whose suffix ends at the node's depth in slot 0; empty slots hold 0.
This is the layout of psac's ``construct_suffix_tree``
(``include/suffix_tree.hpp``).

Computed with plain PyTorch from first principles: a doubling table of
range minima over the LCPs, and, for every row, the previous and the
next smaller LCP and the first row of its run of equal LCPs, each found
by descending the table.  Nothing of the program is used."""

from __future__ import annotations

import torch

INF = torch.iinfo(torch.int32).max


def _min_table(L: torch.Tensor) -> list[torch.Tensor]:
    """T[k][i] = min(L[i .. i + 2^k - 1]), INF past the end."""
    n = L.shape[0]
    T = [L]
    w = 1
    while 2 * w <= n:
        prev = T[-1]
        nxt = prev.clone()
        nxt[:n - w] = torch.minimum(prev[:n - w], prev[w:])
        T.append(nxt)
        w *= 2
    return T


def _first_at_most(T, start: torch.Tensor, thr: torch.Tensor):
    """For each query, the first row i >= start with L[i] <= thr (n when
    there is none)."""
    n = T[0].shape[0]
    pos = start.clone()
    for k in range(len(T) - 1, -1, -1):
        inside = pos < n
        m = torch.where(inside, T[k][pos.clamp(max=n - 1)], INF)
        pos += torch.where(inside & (m > thr), 1 << k, 0)
    return pos.clamp_(max=n)


def _last_below(T, end: torch.Tensor, thr: torch.Tensor):
    """For each query (thr >= 1, so row 0, whose LCP is 0, qualifies), the
    last row i <= end with L[i] < thr."""
    pos = end.clone()
    for k in range(len(T) - 1, -1, -1):
        lo = pos - (1 << k) + 1
        # a block reaching below row 0 holds row 0 and so a smaller value
        m = torch.where(lo >= 0, T[k][lo.clamp(min=0)], 0)
        pos -= torch.where(m >= thr, 1 << k, 0)
    return pos


def node_table(codes: torch.Tensor, sa: torch.Tensor, lcp: torch.Tensor,
               sigma: int) -> torch.Tensor:
    """(n, sigma + 1) int32 node table of the text ``codes`` (1..sigma),
    its suffix array ``sa`` and LCP array ``lcp`` (lcp[0] taken as 0)."""
    n = codes.shape[0]
    dev = codes.device
    L = lcp.to(torch.int32).clone()
    L[0] = 0
    T = _min_table(L)
    rows = torch.arange(n, device=dev)
    # previous strictly smaller LCP (-1 for LCP 0: nothing is smaller)
    ps = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pos = L > 0
    q = rows[pos]
    ps[pos] = _last_below(T, q - 1, L[pos])
    # first row of each row's run of equal LCPs (no smaller LCP between)
    rep = _first_at_most(T, ps + 1, L)
    # next strictly smaller LCP (n: none)
    ns = _first_at_most(T, rows + 1, L - 1)
    del T

    def L_at(i, past_end):
        return torch.where(i < n, L[i.clamp(max=n - 1)], past_end)

    table = torch.zeros((n, sigma + 1), dtype=torch.int32, device=dev)

    def put(parent, depth, row, child):
        at = sa[row] + depth
        slot = torch.where(at < n, codes[at.clamp(max=n - 1)].long(), 0)
        table[parent, slot] = child.to(torch.int32)

    # leaves: the deeper of the two intervals the row borders
    L_next = L_at(rows + 1, 0)
    left = L >= L_next
    parent = torch.where(left, rep, rows + 1)
    depth = torch.where(left, L, L_next).long()
    put(parent, depth, rows, rows + n)
    del L_next, left, parent, depth
    # internal nodes other than the root, each by its id
    ids = rows[(L > 0) & (rep == rows)]
    lp, rn = ps[ids], ns[ids]
    Ll, Lr = L[lp], L_at(rn, -1)
    use_left = Ll >= Lr
    parent = torch.where(use_left, rep[lp], rn)
    depth = torch.where(use_left, Ll, Lr).long()
    put(parent, depth, ids, ids)
    return table
