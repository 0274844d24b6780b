"""Suffix-array correctness checks (port of ``psac_tpu/verify/check_sa.py``
at p = 1).

1. ``check_sa_np`` / ``check_lcp_np``: sequential property checks on the
   host (the reference's ``check_SA`` / ``check_lcp``,
   ``include/check_suffix_array.hpp:55-126``).
2. ``d_check_sa``: the check on the device that needs no host oracle and
   copies nothing but its verdict back: SA is a permutation (a
   max-combining scatter hits every real row), and the order invariants
   hold by one character gather, one rank gather and a neighbour compare
   (the reference's ``d_check_sa``, ``include/check_suffix_array.hpp:
   206-267``).
"""

from __future__ import annotations

import numpy as np
import torch

from psac_tpu_torch.ops.oracle import lcp_kasai
from psac_tpu_torch.parallel.route import route_scatter


def check_sa_np(text: bytes, sa: np.ndarray) -> bool:
    """SA is the sorted suffix order: permutation + order + rank tiebreak."""
    t = np.frombuffer(text, np.uint8) if isinstance(text, (bytes, bytearray)) \
        else np.asarray(text, np.uint8)
    n = len(t)
    sa = np.asarray(sa, np.int64)
    if len(sa) != n or n == 0:
        return len(sa) == n
    if not np.array_equal(np.sort(sa), np.arange(n)):
        return False
    rank = np.empty(n + 1, np.int64)
    rank[sa] = np.arange(n)
    rank[n] = -1  # empty suffix is smallest
    a, b = sa[:-1], sa[1:]
    ca, cb = t[a], t[b]
    # first chars non-decreasing; on equal first char, the rank of the
    # one-shorter suffixes must increase (the reference's ISA condition)
    ra = rank[np.minimum(a + 1, n)]
    rb = rank[np.minimum(b + 1, n)]
    ra = np.where(a + 1 >= n, -1, ra)
    rb = np.where(b + 1 >= n, -1, rb)
    return bool(np.all((ca < cb) | ((ca == cb) & (ra < rb))))


def check_lcp_np(text: bytes, sa: np.ndarray, lcp: np.ndarray) -> bool:
    return np.array_equal(np.asarray(lcp, np.int64), lcp_kasai(text, sa))


def d_check_sa(dsa, xs: torch.Tensor) -> bool:
    """Check a device-resident SA (``DeviceSuffixArray``: (N,) padded, real
    rows last) against the (N,) codes it was built from, on their device;
    one readback of the verdict."""
    sa, n, N = dsa.sa, dsa.n, dsa.N
    off = N - n
    g = torch.arange(N, dtype=sa.dtype, device=sa.device)
    real = g >= off
    # (1) permutation: n real values scattered onto n real rows with every
    # row hit at least once <=> exactly once (pigeonhole); a value outside
    # [0, n) hits nothing
    inr = real & (sa >= 0) & (sa < n)
    dest = torch.where(inr, sa + off, g)  # text position -> padded row
    (hits,) = route_scatter(dest, (torch.ones_like(g, dtype=torch.int32),),
                            (torch.zeros_like(g, dtype=torch.int32),), inr,
                            combine=("max",))
    missed = (real & (hits == 0)).sum()

    # (2) rank[pos + off] = the row that holds pos
    (rank,) = route_scatter(dest, (g,), (torch.zeros_like(g),), inr)

    # (3) the first character of each row's suffix, and the rank of the
    # suffix one shorter (-1: the empty suffix, smallest of all)
    ch = torch.where(real, xs[torch.where(real, sa, 0).clamp(0, N - 1)], 0)
    nxt = real & (sa + 1 < n)
    rk1 = torch.where(nxt, rank[torch.where(nxt, sa + 1 + off, 0)
                                .clamp(0, N - 1)], -1)

    # (4) each pair of real neighbours is in order
    pair = real[:-1] & real[1:]
    ok = ~pair | (ch[:-1] < ch[1:]) | ((ch[:-1] == ch[1:]) &
                                       (rk1[:-1] < rk1[1:]))
    bad = (~ok).sum()
    # (5) one readback
    return bool(((missed == 0) & (bad == 0)).item())
