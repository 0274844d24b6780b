"""Alphabet detection and encoding (host-side preprocessing).

(Numpy-only copy of ``psac_tpu/ops/alphabet.py``, held equal to it by
tests/test_torch_ops.py.)

Equivalent of the reference's histogram-based ``alphabet`` class
(``include/alphabet.hpp:72-348``): detect the set of distinct bytes, map them
to dense codes ``1..sigma`` (0 is reserved for the end-of-text / padding
sentinel, exactly as the reference reserves 0 for ``$``), and report
``bits_per_char = ceillog2(sigma+1)``.

This runs on the host over raw bytes before the text is sharded onto the
mesh: it is O(n) streaming work that belongs on the CPU data path, and it
keeps the device code free of byte-level table lookups.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from psac_tpu_torch.ops.bitops import ceillog2


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """Dense alphabet over a byte string.

    Attributes:
      chars: sorted unique raw byte values present in the text.
      mapping: (256,) uint8 table raw byte -> dense code in 1..sigma.
      inverse: (sigma+1,) uint8 table dense code -> raw byte (index 0 unused).
      bits_per_char: bits needed per encoded char incl. the 0 sentinel.
    """

    chars: np.ndarray
    mapping: np.ndarray
    inverse: np.ndarray
    bits_per_char: int

    @property
    def sigma(self) -> int:
        return len(self.chars)

    @staticmethod
    def from_bytes(data: bytes | np.ndarray) -> "Alphabet":
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
        return Alphabet.from_hist(np.bincount(arr, minlength=256))

    @staticmethod
    def from_hist(hist: np.ndarray, pad_zeros: int = 0) -> "Alphabet":
        """Build from a (256,) byte histogram (the reference's allreduced
        ``alphabet_histogram``, include/alphabet.hpp:72-100).  On the
        multi-host staging path the histogram is computed on device over
        the zero-padded staged array; ``pad_zeros`` is the expected
        padding count so genuine NUL bytes still raise."""
        hist = np.asarray(hist, np.int64)
        if hist[0] != pad_zeros:
            raise ValueError("input text must not contain NUL bytes (0 is the sentinel)")
        chars = np.nonzero(hist[1:])[0].astype(np.uint8) + 1
        mapping = np.zeros(256, dtype=np.uint8)
        mapping[chars] = np.arange(1, len(chars) + 1, dtype=np.uint8)
        inverse = np.zeros(len(chars) + 1, dtype=np.uint8)
        inverse[1:] = chars
        return Alphabet(chars=chars, mapping=mapping, inverse=inverse,
                        bits_per_char=ceillog2(len(chars) + 1))

    def encode(self, data: bytes | np.ndarray) -> np.ndarray:
        """Encode raw bytes to dense int32 codes in 1..sigma."""
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
        return self.mapping[arr].astype(np.int32)

    def decode(self, codes: np.ndarray) -> bytes:
        return self.inverse[np.asarray(codes)].tobytes()


def rand_dna(n: int, seed: int = 0) -> bytes:
    """Deterministic random DNA generator (test corpus helper, mirrors the
    reference's ``rand_dna``, ``include/alphabet.hpp:32-45``)."""
    rng = np.random.RandomState(seed)
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


def rep_dna(n: int, unit_len: int = 16384, seed: int = 0,
            mutations: int | None = None) -> bytes:
    """Repetitive DNA: a random unit tiled to length n with sparse point
    mutations — the adversarial corpus class for prefix doubling (long
    repeats keep every suffix's bucket large for ~log2(unit_len)
    iterations).  The BASELINE.md repetitive config uses the defaults
    (16 KiB unit, ~1 mutation per 8 KiB)."""
    unit = np.frombuffer(rand_dna(unit_len, seed=seed + 3), np.uint8)
    reps = -(-n // unit_len)
    arr = np.tile(unit, reps)[:n].copy()
    rng = np.random.RandomState(seed)
    k = mutations if mutations is not None else max(1, n // 8192)
    idx = rng.randint(0, n, k)
    arr[idx] = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, k)]
    return arr.tobytes()


@dataclasses.dataclass(frozen=True)
class IntAlphabet:
    """Alphabet over wide integer characters via global min/max (reference
    ``int_alphabet``, include/alphabet.hpp:355-502): codes are
    ``x - min_val + 1`` (0 reserved for the sentinel)."""

    min_val: int
    max_val: int
    bits_per_char: int

    @property
    def sigma(self) -> int:
        return self.max_val - self.min_val + 1

    @staticmethod
    def from_array(arr: np.ndarray) -> "IntAlphabet":
        a = np.asarray(arr)
        if a.size == 0:
            return IntAlphabet(min_val=0, max_val=0, bits_per_char=1)
        lo, hi = int(a.min()), int(a.max())
        sigma = hi - lo + 1
        if sigma >= (1 << 30):
            raise ValueError(f"int alphabet too large: {sigma}")
        return IntAlphabet(min_val=lo, max_val=hi,
                           bits_per_char=ceillog2(sigma + 1))

    def encode(self, arr) -> np.ndarray:
        return (np.asarray(arr, np.int64) - self.min_val + 1).astype(np.int32)

    def decode(self, codes) -> np.ndarray:
        return np.asarray(codes, np.int64) + self.min_val - 1
