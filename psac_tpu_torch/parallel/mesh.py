"""Padded global size (port of ``psac_tpu/parallel/mesh.py::padded_size``).

The port runs on one device (p = 1); the padded length N is computed
exactly as the JAX package computes it, so SA rows line up with its
(N,) arrays.
"""

from __future__ import annotations


def padded_size(n: int, p: int = 1, multiple: int = 8) -> int:
    """Global padded size: divisible by p*multiple, rounded up to a
    quarter-power-of-two bucket (<= 25% padding)."""
    chunk = p * multiple
    n = max(n, chunk)
    # next bucket of the form m * 2^e with m in {4, 5, 6, 7}
    e = max(0, n.bit_length() - 3)
    bucket = -(-n >> e) << e  # ceil to multiple of 2^e
    return ((bucket + chunk - 1) // chunk) * chunk
