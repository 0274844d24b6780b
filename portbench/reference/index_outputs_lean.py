"""The comparison of ``index_outputs`` at sizes where its node table does
not fit one card: the same SA, LCP and node-table counts, each limit 0,
from the same plain SA and LCP (``index_outputs._reference``).

The node table is the one ``suffix_tree.node_table`` computes, by the
same method, with less memory: the doubling table of range minima holds
the narrowest integer type above the largest LCP (one byte a row a level
on DNA, against four), the queries run in blocks of ``BLOCK`` rows, the
per-row answers are int32, and each array is compared with the program's
``BLOCK`` rows at a time.  At n = 491,149,951 that is about 40 GB on the
card, where ``index_outputs`` needs over 80."""

from __future__ import annotations

import torch

from portbench.reference import index_outputs as full

#: rows a query block, and a comparison block, holds
BLOCK = 1 << 25


def _narrow(L: torch.Tensor):
    """(dtype, INF): the narrowest integer type whose maximum, INF, lies
    above every value of ``L``."""
    top = int(L.max()) if L.numel() else 0
    for dt in (torch.uint8, torch.int16, torch.int32):
        if top < torch.iinfo(dt).max:
            return dt, torch.iinfo(dt).max
    raise ValueError(f"an LCP of {top} does not fit int32")


def _min_table(L: torch.Tensor, dt) -> list[torch.Tensor]:
    """T[k][i] = min(L[i .. i + 2^k - 1]) in ``dt``, INF past the end (as
    ``suffix_tree._min_table``)."""
    n = L.shape[0]
    T = [L.to(dt)]
    w = 1
    while 2 * w <= n:
        prev = T[-1]
        nxt = prev.clone()
        nxt[:n - w] = torch.minimum(prev[:n - w], prev[w:])
        T.append(nxt)
        w *= 2
    return T


def _first_at_most(T, INF: int, start, thr):
    """For each query, the first row i >= start with L[i] <= thr (n: none)."""
    n = T[0].shape[0]
    pos = start.clone()
    for k in range(len(T) - 1, -1, -1):
        inside = pos < n
        m = torch.where(inside, T[k][pos.clamp(max=n - 1)], INF)
        pos += torch.where(inside & (m > thr), 1 << k, 0)
    return pos.clamp_(max=n)


def _last_below(T, end, thr):
    """For each query (thr >= 1), the last row i <= end with L[i] < thr."""
    pos = end.clone()
    for k in range(len(T) - 1, -1, -1):
        lo = pos - (1 << k) + 1
        m = torch.where(lo >= 0, T[k][lo.clamp(min=0)], 0)
        pos -= torch.where(m >= thr, 1 << k, 0)
    return pos


def node_table(codes: torch.Tensor, sa: torch.Tensor, lcp: torch.Tensor,
               sigma: int) -> torch.Tensor:
    """(n, sigma + 1) int32 node table, equal to
    ``suffix_tree.node_table(codes, sa, lcp, sigma)``."""
    n = codes.shape[0]
    dev = codes.device
    L = lcp.to(torch.int32).clone()
    L[0] = 0
    dt, INF = _narrow(L)
    T = _min_table(L, dt)
    # per row: the previous strictly smaller LCP (-1: none), the first row
    # of its run of equal LCPs, the next strictly smaller LCP (n: none)
    ps = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rep = torch.empty(n, dtype=torch.int32, device=dev)
    ns = torch.empty(n, dtype=torch.int32, device=dev)
    for lo in range(0, n, BLOCK):
        hi = min(n, lo + BLOCK)
        rows = torch.arange(lo, hi, device=dev)
        Lb = L[lo:hi]
        pos = Lb > 0
        ps_b = torch.full((hi - lo,), -1, dtype=torch.int64, device=dev)
        ps_b[pos] = _last_below(T, rows[pos] - 1, Lb[pos])
        ps[lo:hi] = ps_b
        rep[lo:hi] = _first_at_most(T, INF, ps_b + 1, Lb)
        ns[lo:hi] = _first_at_most(T, INF, rows + 1, Lb - 1)
    del T

    def L_at(i, past_end):
        return torch.where(i < n, L[i.clamp(max=n - 1)], past_end)

    table = torch.zeros((n, sigma + 1), dtype=torch.int32, device=dev)

    def put(parent, depth, row, child):
        at = sa[row] + depth
        slot = torch.where(at < n, codes[at.clamp(max=n - 1)].long(), 0)
        table[parent.long(), slot] = child.to(torch.int32)

    for lo in range(0, n, BLOCK):
        hi = min(n, lo + BLOCK)
        rows = torch.arange(lo, hi, device=dev)
        Lb, repb = L[lo:hi], rep[lo:hi].long()
        # leaves: the deeper of the two intervals the row borders
        L_next = L_at(rows + 1, 0)
        left = Lb >= L_next
        put(torch.where(left, repb, rows + 1),
            torch.where(left, Lb, L_next).long(), rows, rows + n)
        # internal nodes other than the root, each by its id
        ids = rows[(Lb > 0) & (repb == rows)]
        lp, rn = ps[ids].long(), ns[ids].long()
        Ll, Lr = L[lp], L_at(rn, -1)
        use_left = Ll >= Lr
        put(torch.where(use_left, rep[lp].long(), rn),
            torch.where(use_left, Ll, Lr).long(), ids, ids)
    return table


def _wrong(got, want, first_zero: bool = False) -> int:
    """``index_outputs._wrong`` a block of ``BLOCK`` rows at a time (with
    ``first_zero`` the first row of ``got`` read as 0, as the LCP's)."""
    got = got.reshape(want.shape)
    wrong = 0
    for lo in range(0, want.shape[0], BLOCK):
        g = full._on(got[lo:lo + BLOCK], want.device)
        if first_zero and lo == 0 and g.shape[0]:
            g = g.clone()
            g[0] = 0
        wrong += full._wrong(g, want[lo:lo + BLOCK])
    return wrong


def check(inputs: dict, outputs: dict, device) -> tuple[list[dict], int]:
    """(checks, failed) as ``index_outputs.check`` gives them."""
    codes, sigma, sa, lcp = full._reference(inputs["text"], device)
    out = [{"name": "sa_rows_wrong", "value": _wrong(outputs["sa"], sa),
            "limit": 0},
           {"name": "lcp_rows_wrong",
            "value": _wrong(outputs["lcp"], lcp, first_zero=True),
            "limit": 0}]
    if outputs.get("nodes") is not None:
        table = node_table(codes, sa, lcp, sigma)
        out.append({"name": "st_slots_wrong",
                    "value": _wrong(outputs["nodes"], table), "limit": 0})
    return out, int(any(c["value"] > c["limit"] for c in out))


def control(inputs: dict, pipeline_outputs: set, device) -> dict:
    """``index_outputs.control`` with this module's node table."""
    codes, sigma, sa, lcp = full._reference(inputs["text"], device,
                                            depth=full.CONTROL_DEPTH)
    out = {"sa": sa, "lcp": lcp}
    if "nodes" in pipeline_outputs:
        out["nodes"] = node_table(codes, sa, lcp, sigma)
    return out
