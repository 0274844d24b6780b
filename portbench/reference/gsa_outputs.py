"""The comparison that decides ``correct`` in the read-set cell: the
generalized suffix array (GSA), its LCP array (GLCP) and the generalized
suffix tree's node table (GST) that the window's last build produced,
each entry against this file's own, worked out from the newline-separated
reads alone.  Every number is a count of wrong entries and its limit is
0: the configuration guarantees exact arrays.

Plain PyTorch (it runs on the card or the CPU), importing nothing of the
program.  Written from psac's description (``gsac``: a string set from a
``\\n``-separated text, ``simple_dstringset``, doubled within each string,
``shift_buckets_ds``; ``construct_gst``, ``include/suffix_tree.hpp:
501-608``, as SURVEY.md describes it):

* the set: the reads with the newlines dropped (empty lines dropped), the
  positions indexing that flat text; eos[i] is one past the end of the
  string that holds position i;
* the GSA by prefix doubling: the suffixes ranked by their first ``k0``
  characters (one int64 key, 0 at and past their string's end), then by
  pairs of ranks at doubling distances h (the second 0 where i + h reaches
  eos[i]), a full stable sort in position order each round, until every
  rank is distinct or h reaches the longest string.  So each suffix ends
  at its string's end and identical whole suffixes stay tied in position
  order;
* the GLCP of each pair of neighbouring rows from the kept rank arrays by
  lifting (largest distance first), then character by character, then
  capped by both suffixes' remaining lengths;
* the GST: the LCP-interval tree of the GSA (``suffix_tree.py`` beside
  this file finds each row's previous and next smaller LCP), its node ids
  as psac's (an internal node: the first row of its interval whose LCP is
  its depth; the root 0; the leaf of row j: n + j), sigma + 2 slots a
  node: the child whose edge begins with code c in slot c + 1, and the
  children whose edge is ``$`` (the suffix ends at the node's depth)
  reduced to their (min, max) ids in slots 0 and 1; edges of the root are
  not recorded.

Departures from psac's description: one process, no distribution of the
set across ranks; the doubling keeps every round's ranks for the lifting,
where psac resolves LCPs by range minima; ``construct_gst`` reads each
edge's first character by bulk queries across ranks, this file by one
gather; its (min, max) slots are two reducing scatters here.

The control (``control``) puts the reference in the program's place with
one guarantee broken: suffixes sorted by their first ``CONTROL_DEPTH``
characters only (ties left in position order, LCPs capped there), the
k-mer init's depth without the doubling after it."""

from __future__ import annotations

import torch

from portbench.reference import suffix_array as ref_sa
from portbench.reference import suffix_tree as ref_st
from portbench.reference.index_outputs import _on, _wrong

CONTROL_DEPTH = 20
SEP = ord("\n")


def parse(reads: bytes, device):
    """(codes int32 1..sigma, sigma, eos int64) of the flat text of the
    newline-separated ``reads``."""
    raw = ref_sa.text_tensor(reads, device)
    sep = raw == SEP
    pos = torch.arange(raw.shape[0], device=device)
    # each raw position's next separator (the end of its line)
    nxt = torch.where(sep, pos, raw.shape[0])
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    keep = ~sep
    at = pos[keep]
    codes, sigma = ref_sa.encode(raw[keep])
    del raw, sep, keep
    n = codes.shape[0]
    eos = torch.arange(n, device=device) + (nxt[at] - at)
    return codes, sigma, eos


def _ahead(x, pos, eos, h: int):
    """x[i + h] where i + h is inside i's string, else 0."""
    at = pos + h
    return torch.where(at < eos, x[at.clamp(max=x.shape[0] - 1)], 0)


def gsa(codes, eos, sigma: int, depth: int | None = None):
    """(sa int64, levels): the GSA, and [(h, rank)] with rank the int32
    rank of every suffix's h-prefix cut at its string's end (equal iff the
    cut prefixes are).  With ``depth``, stop once the prefixes of that many
    characters are sorted (the control)."""
    n = codes.shape[0]
    bits = ref_sa.bits_for(sigma)
    k0 = 63 // bits if depth is None else min(63 // bits, depth)
    pos = torch.arange(n, device=codes.device)
    key = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j in range(k0):
        key = (key << bits) | _ahead(codes, pos, eos, j).to(torch.int64)
    keys, sa = torch.sort(key, stable=True)
    del key
    rank_sorted = ref_sa._rank_sorted(keys)
    del keys
    rank = torch.empty(n, dtype=torch.int32, device=codes.device)
    rank[sa] = rank_sorted
    levels, h = [(k0, rank)], k0
    longest = int((eos - pos).max())
    while h < longest and int(rank_sorted[-1]) < n and \
            (depth is None or h < depth):
        del rank_sorted
        key = (rank.to(torch.int64) << 32) | \
            _ahead(rank, pos, eos, h).to(torch.int64)
        keys, sa = torch.sort(key, stable=True)
        del key
        rank_sorted = ref_sa._rank_sorted(keys)
        del keys
        rank = torch.empty(n, dtype=torch.int32, device=codes.device)
        rank[sa] = rank_sorted
        h *= 2
        levels.append((h, rank))
    return sa, levels


def glcp(codes, eos, sa, levels, cap: int | None = None) -> torch.Tensor:
    """int32 GLCP of each row with the row before it (0 at row 0)."""
    n = codes.shape[0]
    a, b = sa[:-1], sa[1:]
    ea, eb = eos[a], eos[b]
    lcp = torch.zeros(n - 1, dtype=torch.int64, device=codes.device)

    def same(x, i, j):  # x[i] == x[j], both inside their strings
        ok = (i < ea) & (j < eb)
        return ok & (x[i.clamp(max=n - 1)] == x[j.clamp(max=n - 1)])

    for h, rank in reversed(levels):
        lcp += h * same(rank, a + lcp, b + lcp)
    live = torch.ones_like(lcp, dtype=torch.bool)
    for _ in range(levels[0][0] - 1):
        live &= same(codes, a + lcp, b + lcp)
        lcp += live
    lcp = torch.minimum(lcp, torch.minimum(ea - a, eb - b))
    if cap is not None:
        lcp.clamp_(max=cap)
    out = torch.zeros(n, dtype=torch.int32, device=codes.device)
    out[1:] = lcp.to(torch.int32)
    return out


def gst_table(codes, eos, sa, lcp, sigma: int) -> torch.Tensor:
    """(n, sigma + 2) int32 GST node table of the set (module docstring)
    from its GSA ``sa`` and GLCP ``lcp`` (lcp[0] taken as 0)."""
    n = codes.shape[0]
    dev = codes.device
    L = lcp.to(torch.int32).clone()
    L[0] = 0
    T = ref_st._min_table(L)
    rows = torch.arange(n, device=dev)
    # previous strictly smaller LCP (-1 for LCP 0: nothing is smaller)
    ps = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pos = L > 0
    ps[pos] = ref_st._last_below(T, rows[pos] - 1, L[pos])
    # first row of each row's run of equal LCPs (no smaller LCP between)
    rep = ref_st._first_at_most(T, ps + 1, L)
    # next strictly smaller LCP (n: none)
    ns = ref_st._first_at_most(T, rows + 1, L - 1)
    del T

    def L_at(i, past_end):
        return torch.where(i < n, L[i.clamp(max=n - 1)], past_end)

    table = torch.zeros((n, sigma + 2), dtype=torch.int32, device=dev)
    lo = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                    device=dev)
    hi = torch.full((n,), -1, dtype=torch.int64, device=dev)

    def put(parent, depth, row, child):
        rec = depth > 0  # the root's edges are not recorded
        parent, depth, child = parent[rec], depth[rec], child[rec]
        start = sa[row[rec]]
        at = start + depth
        end = at >= eos[start]
        ch = codes[at[~end].clamp(max=n - 1)].long()
        table[parent[~end], ch + 1] = child[~end].to(torch.int32)
        lo.scatter_reduce_(0, parent[end], child[end], "amin")
        hi.scatter_reduce_(0, parent[end], child[end], "amax")

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
    has = hi >= 0
    table[has, 0] = lo[has].to(torch.int32)
    table[has, 1] = hi[has].to(torch.int32)
    return table


def _reference(reads: bytes, device, depth=None):
    codes, sigma, eos = parse(reads, device)
    sa, levels = gsa(codes, eos, sigma, depth)
    lcp = glcp(codes, eos, sa, levels, cap=depth)
    del levels
    return codes, sigma, eos, sa, lcp


def check(inputs: dict, outputs: dict, device) -> tuple[list[dict], int]:
    """(checks, failed): each number with its limit, and 1 when the build
    compared is wrong anywhere."""
    codes, sigma, eos, sa, lcp = _reference(inputs["reads"], device)
    out = [{"name": "gsa_rows_wrong", "value": _wrong(outputs["gsa"], sa),
            "limit": 0}]
    got = _on(outputs["glcp"], device).clone()
    got[0] = 0
    out.append({"name": "glcp_rows_wrong", "value": _wrong(got, lcp),
                "limit": 0})
    del got
    table = gst_table(codes, eos, sa, lcp, sigma)
    out.append({"name": "gst_slots_wrong",
                "value": _wrong(outputs["gst"], table), "limit": 0})
    return out, int(any(c["value"] > c["limit"] for c in out))


def control(inputs: dict, pipeline_outputs: set, device) -> dict:
    """The outputs a program would give that sorted suffixes by their
    first ``CONTROL_DEPTH`` characters only."""
    codes, sigma, eos, sa, lcp = _reference(inputs["reads"], device,
                                            depth=CONTROL_DEPTH)
    return {"gsa": sa, "glcp": lcp,
            "gst": gst_table(codes, eos, sa, lcp, sigma)}
