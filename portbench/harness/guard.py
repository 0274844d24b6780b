"""The import guard: the JAX package and JAX itself never run in a
benchmark process.  Names are compared whole, by the part before the first
dot, so the port (``psac_tpu_torch``) is not taken for the JAX package
(``psac_tpu``)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "psac_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
