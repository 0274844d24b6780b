"""k-mer packing (port of ``psac_tpu/ops/kmer.py``) and the k-mer init of
SA+LCP and of the GSA.

A k-mer is a tuple of int32 words filled MSB-first, so lexicographic order
of the tuple is k-mer order (reference ``include/kmer.hpp:25-40,119-177``).

The init's two passes are hand-written CUDA kernels
(``psac_tpu_torch/csrc/kmer_init.cu``), each with the JAX formula in torch
beside it as its plain version; the JAX package jits the init whole, so
XLA fuses them, where eager torch would write every shift, compare and
``clz`` step to device memory:

- K9 ``kmer_pack`` (plain ``pack_kmers_plain``): the words of every
  position of a shard, the GSA's chars masked past each string's end, and
  the padding rows' pad rank in the last word;
- K10 ``kmer_heads`` (plain ``kmer_heads_plain``): over the sorted words,
  the bucket heads (``newb``) and the initial LCP (``lcp0``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.ops.bitops import lcp_bitwise_words

MAX_WORDS = 3  # MAX_WORDS of csrc/kmer_init.cu
#: K9's positions per thread and threads per block as built
#: (``PSAC_K9_RUN`` and ``PSAC_K9_THREADS`` of csrc/kmer_init.cu)
K9_RUN = 4
K9_THREADS = 64


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


def pack_kmers_plain(codes: torch.Tensor, halo: torch.Tensor,
                     ks: tuple[int, ...], bits: int, base: int, N: int,
                     idt: torch.dtype, eos: torch.Tensor | None = None):
    """Plain version of K9: the len(ks) (s,) int32 words of the
    sum(ks)-mers at a shard's s positions (global indices base ..
    base + s - 1 of N), from its (s,) int32 ``codes`` and the (sum(ks) - 1,)
    ``halo`` codes right of it, every code below 2^bits.  With ``eos``
    ((s,) of ``idt``, the GSA) char j of position g is taken only where
    g + j < eos.  Rows whose first word is 0 (padding suffixes) get the pad
    rank (int32)(N - g) as their last word: unique final ranks, by
    descending position, before every real suffix."""
    s = codes.shape[0]
    win = torch.cat([codes, halo])
    gidx = torch.arange(base, base + s, dtype=idt, device=codes.device)
    if eos is None:
        words = pack_kmers_local(win, s, ks, bits)
    else:
        words = []
        off = 0
        for kw in ks:
            w = torch.zeros(s, dtype=torch.int32, device=codes.device)
            for j in range(off, off + kw):
                c = torch.where(gidx + j < eos, win[j:j + s], 0)
                w = torch.bitwise_left_shift(w, bits) | c
            words.append(w)
            off += kw
        words = tuple(words)
    pad_rank = (N - gidx).to(torch.int32)
    return words[:-1] + (torch.where(words[0] == 0, pad_rank, words[-1]),)


def kmer_heads_plain(words, halo: torch.Tensor, ks: tuple[int, ...],
                     bits: int, base: int, N: int, n_real: int,
                     idt: torch.dtype, with_lcp: bool,
                     rem: torch.Tensor | None = None,
                     rem_halo: torch.Tensor | None = None):
    """Plain version of K10 over a shard's sorted (s,) int32 ``words`` (SA
    rows base .. base + s - 1 of N), with ``halo`` the (len(words),) int32
    words of the row before the shard (-1 before row 0).  Returns (newb,
    lcp0): the bool bucket heads (some word differs from the row before),
    and with ``with_lcp`` the initial LCP in ``idt``: the bitwise k-mer
    LCP at heads, N elsewhere; the SA gives its padding rows
    (g < N - n_real) g, the GSA (``rem`` (s,) and ``rem_halo`` (1,) in
    ``idt``: the sorted suffixes' remaining lengths and the row before's,
    0 before row 0) caps the LCP by both rows' lengths; row 0 gets 0."""
    prevs = tuple(torch.cat([halo[j:j + 1], w[:-1]])
                  for j, w in enumerate(words))
    newb = functools.reduce(
        torch.logical_or, (w != pw for w, pw in zip(words, prevs)))
    if not with_lcp:
        return newb, None
    s = words[0].shape[0]
    gidx = torch.arange(base, base + s, dtype=idt, device=newb.device)
    lcpv = lcp_bitwise_words(prevs, words, ks, bits).to(idt)
    if rem is None:
        lcp0 = torch.where(newb, lcpv, N)
        # rows 0..N-n-1 are the padding suffixes: adjacent ones overlap in
        # exactly (row) chars
        lcp0 = torch.where(gidx < N - n_real, gidx, lcp0)
    else:
        prev_rem = torch.cat([rem_halo, rem[:-1]])
        lcpv = torch.minimum(torch.minimum(lcpv, prev_rem), rem)
        lcp0 = torch.where(newb, lcpv, N)
    return newb, torch.where(gidx == 0, 0, lcp0)


def _check_ks(name: str, ks: tuple[int, ...], bits: int) -> None:
    if not 1 <= bits <= 31:
        raise ValueError(f"{name}: bits must be 1 to 31, got {bits}")
    if not 1 <= len(ks) <= MAX_WORDS or \
            any(kw < 1 or kw * bits > 31 for kw in ks):
        raise ValueError(f"{name}: expected 1 to {MAX_WORDS} words of at "
                         f"most 31 bits, got ks={ks} at {bits} bits")


def _check_vec(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
               device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != 1 \
            or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n},) {dtype} "
                         f"tensor on {device}")


def _ptrs(ts) -> list[int]:
    """Data pointers of up to MAX_WORDS tensors, 0 for the missing."""
    ts = list(ts)
    return [t.data_ptr() for t in ts] + [0] * (MAX_WORDS - len(ts))


def _kws(ks) -> list[int]:
    return list(ks) + [0] * (MAX_WORDS - len(ks))


def _suffix(name: str, idt: torch.dtype) -> str:
    if idt not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: expected an int32 or int64 index type, "
                         f"got {idt}")
    return "i32" if idt == torch.int32 else "i64"


def kmer_pack(codes: torch.Tensor, halo: torch.Tensor, ks: tuple[int, ...],
              bits: int, base: int, N: int, idt: torch.dtype,
              eos: torch.Tensor | None = None):
    """K9 (replaces the XLA fusion of ``psac_tpu/ops/kmer.py::
    pack_kmers_local`` with the init's pad-rank select, and of the GSA's
    masked pack): see ``pack_kmers_plain`` for the contract."""
    if codes.device.type == "cpu":
        return pack_kmers_plain(codes, halo, ks, bits, base, N, idt, eos)
    name = "kmer_pack"
    ks = tuple(ks)
    _check_ks(name, ks, bits)
    suffix = _suffix(name, idt)
    s = codes.shape[0]
    dev = codes.device
    cuda_lib.check_cuda_int32(name, codes)
    _check_vec(name, halo, torch.int32, sum(ks) - 1, dev)
    if eos is not None:
        _check_vec(name, eos, idt, s, dev)
    words = tuple(torch.empty(s, dtype=torch.int32, device=dev) for _ in ks)
    if s == 0:
        return words
    cuda_lib.launch(f"psac_kmer_pack_{suffix}", codes.data_ptr(),
                    halo.data_ptr(), 0 if eos is None else eos.data_ptr(),
                    *_ptrs(words), s, len(ks), *_kws(ks), bits, base, N,
                    device=dev)
    cuda_lib.count_launch(kmer_pack)
    return words


kmer_pack.launches = 0


def kmer_heads(words, halo: torch.Tensor, ks: tuple[int, ...], bits: int,
               base: int, N: int, n_real: int, idt: torch.dtype,
               with_lcp: bool, rem: torch.Tensor | None = None,
               rem_halo: torch.Tensor | None = None):
    """K10 (replaces the XLA fusion of the init's ``prev_of`` per word, the
    ``newb`` reduce and ``psac_tpu/ops/bitops.py::lcp_bitwise_words`` with
    the lcp0 rules): see ``kmer_heads_plain`` for the contract."""
    words = tuple(words)
    if words[0].device.type == "cpu":
        return kmer_heads_plain(words, halo, ks, bits, base, N, n_real, idt,
                                with_lcp, rem, rem_halo)
    name = "kmer_heads"
    ks = tuple(ks)
    _check_ks(name, ks, bits)
    suffix = _suffix(name, idt)
    if len(words) != len(ks):
        raise ValueError(f"{name}: {len(words)} words for ks={ks}")
    cuda_lib.check_cuda_int32(name, *words)
    s = words[0].shape[0]
    dev = words[0].device
    _check_vec(name, halo, torch.int32, len(ks), dev)
    if (rem is None) != (rem_halo is None):
        raise ValueError(f"{name}: rem and rem_halo come together")
    if rem is not None:
        _check_vec(name, rem, idt, s, dev)
        _check_vec(name, rem_halo, idt, 1, dev)
    newb = torch.empty(s, dtype=torch.bool, device=dev)
    lcp0 = torch.empty(s, dtype=idt, device=dev) if with_lcp else None
    if s == 0:
        return newb, lcp0
    cuda_lib.launch(f"psac_kmer_heads_{suffix}", *_ptrs(words),
                    halo.data_ptr(), 0 if rem is None else rem.data_ptr(),
                    0 if rem is None else rem_halo.data_ptr(),
                    newb.data_ptr(), 0 if lcp0 is None else lcp0.data_ptr(),
                    s, len(ks), *_kws(ks), bits, base, N, n_real,
                    device=dev)
    cuda_lib.count_launch(kmer_heads)
    return newb, lcp0


kmer_heads.launches = 0
