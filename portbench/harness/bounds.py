"""The card's peaks and the byte bounds of the kernels whose roofline
share a metric reads.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3 and
67 TFLOP/s outside the tensor cores, taken as integer operations a second.

``kmer_pack_bound`` and ``kmer_heads_bound`` copy the arithmetic of
``chip_smoke.py::kmer_bound`` (repository root, as of the port's PR 17)
for one p = 1 SA+LCP init: each input read once and each output written
once, at 3.35 TB/s."""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def bound_s(nbytes: int, ops: int) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory's rate and the operations over the cores' rate."""
    return max(nbytes / MEM_BYTES_PER_S, ops / CORE_OPS_PER_S)


def kmer_pack_bound(N: int, ks: tuple, code_bytes: int = 4) -> float:
    """K9 of an SA+LCP init over N codes: the codes and their right halo of
    sum(ks) - 1 codes read, one int32 word a position for each word
    written; a shift and an or a char."""
    nbytes = code_bytes * N + code_bytes * (sum(ks) - 1) + 4 * len(ks) * N
    return bound_s(nbytes, 2 * sum(ks) * N)


def kmer_heads_bound(N: int, ks: tuple, idx_bytes: int = 4,
                     with_lcp: bool = True) -> float:
    """K10 of an SA+LCP init over N sorted rows: the words and their left
    halo (one value a word) read, one byte of bucket head and, with the
    LCP, one index word a row written; six operations a word."""
    nbytes = 4 * len(ks) * N + 4 * len(ks) + N
    nbytes += idx_bytes * N if with_lcp else 0
    return bound_s(nbytes, 6 * len(ks) * N)
