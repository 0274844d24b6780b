"""Suffix-array correctness checks (port of ``psac_tpu/verify/check_sa.py``).

1. ``check_sa_np`` / ``check_lcp_np``: sequential property checks on the
   host (the reference's ``check_SA`` / ``check_lcp``,
   ``include/check_suffix_array.hpp:55-126``).
2. ``d_check_sa``: the check on the device that needs no host oracle and
   copies nothing but its verdict back: SA is a permutation (a
   max-combining scatter hits every real row), and the order invariants
   hold by one character gather, one rank gather and a neighbour compare
   (the reference's ``d_check_sa``, ``include/check_suffix_array.hpp:
   206-267``).  On a mesh the scatters and gathers are routed to the
   shards that own the rows (JAX ``_d_check_local``, ``:60-124``).
"""

from __future__ import annotations

import numpy as np
import torch

from psac_tpu_torch.ops.oracle import lcp_kasai
from psac_tpu_torch.parallel.collectives import (global_index_base, next_of,
                                                 psum)
from psac_tpu_torch.parallel.mesh import Rep, run_on
from psac_tpu_torch.parallel.route import gather_global, route_scatter


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


def _d_check(ctx, sa, xs, n: int):
    """``d_check_sa`` on this shard's rows (``ctx`` None on one device;
    JAX ``_d_check_local``): the verdict, replicated."""
    s = sa.shape[0]
    N = s * (1 if ctx is None else ctx.p)
    off = N - n
    base = global_index_base(s, ctx)
    g = torch.arange(base, base + s, dtype=sa.dtype, device=sa.device)
    real = g >= off
    # (1) permutation: n real values scattered onto n real rows with every
    # row hit at least once <=> exactly once (pigeonhole); a value outside
    # [0, n) hits nothing
    inr = real & (sa >= 0) & (sa < n)
    dest = torch.where(inr, sa + off, g)  # text position -> padded row
    (hits,) = route_scatter(dest, (torch.ones_like(g, dtype=torch.int32),),
                            (torch.zeros_like(g, dtype=torch.int32),), inr,
                            combine=("max",), ctx=ctx)
    missed = psum((real & (hits == 0)).sum(), ctx)

    # (2) rank[pos + off] = the row that holds pos
    (rank,) = route_scatter(dest, (g,), (torch.zeros_like(g),), inr, ctx=ctx)

    # (3) the first character of each row's suffix, and the rank of the
    # suffix one shorter (-1: the empty suffix, smallest of all), gathered
    # from the shards that hold them
    ch = gather_global(xs, sa, real, ctx=ctx)
    nxt = real & (sa + 1 < n)
    rk1 = torch.where(nxt, gather_global(rank, sa + 1 + off, nxt, ctx=ctx),
                      -1)

    # (4) each pair of real neighbours is in order, across shard edges too
    nc, nr = next_of(ch, 0, ctx), next_of(rk1, 0, ctx)
    pair = real & next_of(real, False, ctx)
    ok = ~pair | (ch < nc) | ((ch == nc) & (rk1 < nr))
    bad = psum((~ok).sum(), ctx)
    # (5) one readback
    return Rep(bool(((missed == 0) & (bad == 0)).item()))


def d_check_sa(dsa, xs: torch.Tensor) -> bool:
    """Check a device-resident SA (``DeviceSuffixArray``: (N,) padded, real
    rows last) against the (N,) codes it was built from, on their device
    (or their shards, ``dsa.mesh``); one readback of the verdict."""
    return run_on(dsa.mesh, _d_check, dsa.sa, xs, dsa.n)
