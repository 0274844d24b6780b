"""Persistence of finished artifacts (port of ``psac_tpu/io.py``, the
single-process forms).

Artifacts are plain little-endian uint64 flat files with the reference's
extensions (``.sa64``, ``.lcp64``, ``.lc64``) and the alphabet as its raw
byte set (``.alpha``), byte-identical to what the JAX package writes, so
either package reads what the other wrote.  ``read_suffix_array`` reads
``.sa64``, ``.lcp64`` and ``.alpha``; like the JAX package's, it does not
read ``.lc64`` back.
"""

from __future__ import annotations

import os

import numpy as np

from psac_tpu_torch.ops.alphabet import Alphabet
from psac_tpu_torch.ops.bitops import ceillog2


def write_u64(path: str, arr) -> None:
    np.asarray(arr, dtype="<u8").tofile(path)


def read_u64(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<u8").astype(np.int64)


def write_alphabet(prefix: str, alphabet) -> None:
    with open(prefix + ".alpha", "wb") as f:
        f.write(alphabet.chars.tobytes())


def write_suffix_array(prefix: str, res) -> None:
    """Write ``<prefix>.sa64`` (+ ``.lcp64``/``.lc64`` when present) and
    ``<prefix>.alpha``."""
    write_u64(prefix + ".sa64", res.sa)
    if getattr(res, "lcp", None) is not None:
        write_u64(prefix + ".lcp64", res.lcp)
    lc = getattr(res, "lc", None)
    if lc is not None:
        write_u64(prefix + ".lc64", lc)
    write_alphabet(prefix, res.alphabet)


def read_alphabet(prefix: str) -> Alphabet:
    with open(prefix + ".alpha", "rb") as f:
        chars = np.frombuffer(f.read(), np.uint8)
    mapping = np.zeros(256, np.uint8)
    mapping[chars] = np.arange(1, len(chars) + 1, dtype=np.uint8)
    inverse = np.zeros(len(chars) + 1, np.uint8)
    inverse[1:] = chars
    return Alphabet(chars=chars.copy(), mapping=mapping, inverse=inverse,
                    bits_per_char=ceillog2(len(chars) + 1))


def read_suffix_array(prefix: str):
    """Reload a persisted SA(+LCP) artifact as a host ``SuffixArray``."""
    from psac_tpu_torch.models.suffix_array import SuffixArray

    sa = read_u64(prefix + ".sa64")
    lcp = None
    if os.path.exists(prefix + ".lcp64"):
        lcp = read_u64(prefix + ".lcp64")
    alpha = read_alphabet(prefix) if os.path.exists(prefix + ".alpha") else None
    return SuffixArray(sa=sa, lcp=lcp, alphabet=alpha, n=len(sa))
