"""The plain reference against brute force: sorted suffixes, LCPs by
direct comparison, the suffix tree by recursive splitting of the sorted
suffixes, pattern ranges by scanning; and against the program on the
CPU, at small sizes."""

import numpy as np
import pytest
import torch

from portbench.harness import spec
from portbench.reference import locate_ranges
from portbench.reference import suffix_array as R
from portbench.reference import suffix_tree as ST

F = spec.Finder()
TEXTS = {
    "random": {"n": 1500, "alphabet": "ACGT"},
    "copies": {"n": 8 * 200, "alphabet": "ACGT", "copies": 8,
               "sub_rate": 0.01},
    "binary_copies": {"n": 6 * 150, "alphabet": "AB", "copies": 6},
    "one_letter": {"n": 300, "alphabet": "A"},
    "bytes": {"n": 1200, "alphabet": "abcdefghijklmnopqrstuvwxyz"},
}


def text_of(kind, seed=2**31 + 3):
    return F.module("gen", "text").make(TEXTS[kind], seed, "cpu")


def brute(text: bytes):
    n = len(text)
    sa = sorted(range(n), key=lambda i: text[i:])
    lcp = [0]
    for a, b in zip(sa, sa[1:]):
        k = 0
        while b + k < n and a + k < n and text[a + k] == text[b + k]:
            k += 1
        lcp.append(k)
    return np.array(sa), np.array(lcp)


def brute_tree(text: bytes, sa, lcp):
    """The node table by splitting the sorted suffixes recursively: a
    node's children are the runs of rows with one character at its
    depth."""
    n = len(text)
    codes = {c: i + 1 for i, c in enumerate(sorted(set(text)))}
    sigma = len(codes)
    table = np.zeros((n, sigma + 1), np.int64)

    def node(lb, rb, depth):
        ident = 0 if lb == 0 and depth == 0 else next(
            i for i in range(lb + 1, rb + 1) if lcp[i] == depth)
        groups = {}
        for r in range(lb, rb + 1):
            at = sa[r] + depth
            groups.setdefault(codes[text[at]] if at < n else 0,
                              []).append(r)
        for slot, rows in groups.items():
            lo, hi = rows[0], rows[-1]
            if lo == hi:
                child = n + lo
            else:
                d = min(lcp[lo + 1:hi + 1])
                child = node(lo, hi, d)
            table[ident, slot] = child
        return ident

    node(0, n - 1, 0)
    return table


@pytest.mark.parametrize("kind", list(TEXTS))
def test_sa_lcp_tree_against_brute_force(kind):
    text = text_of(kind)
    codes, sigma = R.encode(R.text_tensor(text, "cpu"))
    sa, levels = R.suffix_array(codes, sigma)
    lcp = R.lcp_array(codes, sa, levels)
    bsa, blcp = brute(text)
    assert np.array_equal(sa.numpy(), bsa)
    assert np.array_equal(lcp.numpy(), blcp)
    table = ST.node_table(codes, sa, lcp, sigma)
    assert np.array_equal(table.numpy(), brute_tree(text, bsa, blcp))


@pytest.mark.parametrize("kind", ["random", "copies", "bytes"])
def test_pattern_ranges_against_scan(kind):
    text = text_of(kind)
    rng = np.random.default_rng(5)
    pos = rng.integers(0, len(text) - 20, 40)
    pats = [text[p:p + 20] for p in pos]
    pats += [bytes(rng.choice(list(text[:50]), 20)) for _ in range(40)]
    pats.append(b"Z" * 20)  # a byte the text lacks
    mat = np.frombuffer(b"".join(pats), np.uint8).reshape(-1, 20)
    got = locate_ranges._ranges(text, mat, "cpu")
    bsa, _ = brute(text)
    for p, (lo, hi) in zip(pats, got):
        rows = [r for r, s in enumerate(bsa) if text[s:s + 20] == p]
        if rows:
            assert (lo, hi) == (rows[0], rows[-1] + 1)
        else:
            assert lo == hi


def test_depth_bounded_sort_keeps_ties_in_text_order():
    text = b"AC" * 40
    codes, sigma = R.encode(R.text_tensor(text, "cpu"))
    sa, levels = R.suffix_array(codes, sigma, depth=4)
    assert levels[-1][0] == 4
    lcp = R.lcp_array(codes, sa, levels, cap=4)
    assert int(lcp.max()) == 4
    # the suffixes starting "ACAC" stay in text order
    assert sa[:0].numel() == 0 and list(sa[1:39]) == sorted(sa[1:39])


@pytest.mark.parametrize("kind", ["random", "copies", "one_letter"])
def test_reference_equals_the_program_on_the_cpu(kind):
    from psac_tpu_torch.models.suffix_array import (construct_device,
                                                    encode_and_shard)
    from psac_tpu_torch.models.suffix_tree import (
        construct_suffix_tree_device)

    text = text_of(kind)
    xs, alpha, n, N = encode_and_shard(text, "cpu")
    dsa = construct_device(xs, alpha, n, N)
    tree = construct_suffix_tree_device(dsa, xs)
    codes, sigma = R.encode(R.text_tensor(text, "cpu"))
    sa, levels = R.suffix_array(codes, sigma)
    lcp = R.lcp_array(codes, sa, levels)
    plcp = dsa.lcp[N - n:].clone()
    plcp[0] = 0
    assert torch.equal(dsa.sa[N - n:].long(), sa)
    assert torch.equal(plcp, lcp)
    assert torch.equal(tree.nodes.view(N, sigma + 1)[N - n:],
                       ST.node_table(codes, sa, lcp, sigma))
