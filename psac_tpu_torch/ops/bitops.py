"""Bit-level primitives on int32 tensors (port of ``psac_tpu/ops/bitops.py``).

k-mers are packed MSB-first into tuples of int32 words so that
lexicographic order of the tuple equals k-mer order; the LCP of two k-mers
is an xor plus a count of leading zeros.  torch has no ``clz``, so it is
computed exactly by a five-step shift ladder on the zero-extended word.
"""

from __future__ import annotations

import torch


def ceillog2(x: int) -> int:
    """Smallest b with 2**b >= x (host-side)."""
    return max(0, int(x - 1).bit_length())


def pow2ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1; host-side)."""
    return 1 << ceillog2(x)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each 32-bit word of int32 ``x`` (32 for 0)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(v)
    for sh in (16, 8, 4, 2, 1):
        top_clear = v < (1 << (32 - sh))
        n = n + top_clear.to(torch.int64) * sh
        v = torch.where(top_clear, v << sh, v)
    return (n + (v == 0).to(torch.int64)).to(torch.int32)


def lcp_bitwise32(a: torch.Tensor, b: torch.Tensor, k: int, bits: int):
    """Number of leading equal ``bits``-wide chars of two k-mers packed in
    the low ``k*bits`` bits of int32 words."""
    x = torch.bitwise_xor(a, b)
    lz = clz32(x) - (32 - k * bits)
    lcp = torch.div(lz, bits, rounding_mode="floor").to(torch.int32)
    return torch.where(x == 0, torch.full_like(lcp, k), lcp)


def lcp_bitwise_pair(ahi, alo, bhi, blo, k1: int, k2: int, bits: int):
    """LCP of two (k1 + k2)-char k-mers packed as (hi, lo) int32 pairs."""
    return lcp_bitwise_words((ahi, alo), (bhi, blo), (k1, k2), bits)


def kmer_char_at(kmer: torch.Tensor, k: int, bits: int, pos):
    """The char at position ``pos`` (0-based from the left) of k-mers
    packed in the low ``k * bits`` bits of int32 words (reference
    ``include/kmer.hpp:65``, ``get_kmer_char``)."""
    shift = (k - 1 - pos) * bits
    return torch.bitwise_right_shift(kmer, shift) & ((1 << bits) - 1)


def lcp_bitwise_words(a_words, b_words, ks: tuple[int, ...], bits: int):
    """LCP of two sum(ks)-char k-mers packed as tuples of int32 words
    (MSB-first word order)."""
    lcp = None
    live = None  # all previous words equal
    for aw, bw, kw in zip(a_words, b_words, ks):
        lw = lcp_bitwise32(aw, bw, kw, bits)
        if lcp is None:
            lcp, live = lw, aw == bw
        else:
            lcp = torch.where(live, lcp + lw, lcp)
            live = live & (aw == bw)
    return lcp
