"""k-mer packing (port of ``psac_tpu/ops/kmer.py``).

A k-mer is a tuple of int32 words filled MSB-first, so lexicographic order
of the tuple is k-mer order (reference ``include/kmer.hpp:25-40,119-177``).
"""

from __future__ import annotations

import numpy as np
import torch


def optimal_k(bits_per_char: int, max_bits: int = 31,
              words: int = 2) -> tuple[int, ...]:
    """Chars per int32 word (sign bit kept zero), for ``words`` words."""
    per_word = max(1, max_bits // bits_per_char)
    return (per_word,) * words


def pack_kmers_local(chars_with_halo: torch.Tensor, s: int,
                     ks: tuple[int, ...], bits: int):
    """Pack the sum(ks)-mers starting at each of the first ``s`` positions
    of ``chars_with_halo`` ((s + sum(ks) - 1,) int32 codes, zeros past the
    end of the text).  Returns a tuple of len(ks) (s,) int32 words."""
    words = []
    off = 0
    for kw in ks:
        w = torch.zeros(s, dtype=torch.int32, device=chars_with_halo.device)
        for j in range(off, off + kw):
            w = torch.bitwise_left_shift(w, bits) | chars_with_halo[j:j + s]
        words.append(w)
        off += kw
    return tuple(words)


def pack_kmers_host(codes, ks: tuple[int, ...], bits: int):
    """NumPy reference of ``pack_kmers_local`` over a whole host code
    array (zeros past its end): a tuple of len(ks) (n,) int32 words."""
    n = len(codes)
    k = sum(ks)
    padded = np.concatenate([np.asarray(codes, np.int64),
                             np.zeros(k - 1, np.int64)])
    words = []
    off = 0
    for kw in ks:
        w = np.zeros(n, np.int64)
        for j in range(off, off + kw):
            w = (w << bits) | padded[j:j + n]
        words.append(w.astype(np.int32))
        off += kw
    return tuple(words)
