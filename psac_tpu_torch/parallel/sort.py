"""Multi-key sort (port of ``psac_tpu/parallel/sort.py`` at p = 1).

``lax.sort(operands, num_keys=k)`` has no torch counterpart.  It is
composed here from stable single-key sorts, least significant key first,
each gathering the next key through the permutation so far (LSD order).
Every key tuple the construction sorts ends in a unique column (global
index, row or position), so the order is total and equals the JAX one.
"""

from __future__ import annotations

import torch


def lex_perm(keys) -> torch.Tensor:
    """Permutation that stably sorts rows by ``keys`` (most significant
    first): rows with equal keys keep their input order."""
    perm = None
    for k in reversed(tuple(keys)):
        kk = k if perm is None else k[perm]
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def dist_sort_local(operands: tuple, num_keys: int) -> tuple:
    """Sort ``operands`` by their first ``num_keys`` entries."""
    perm = lex_perm(operands[:num_keys])
    return tuple(o[perm] for o in operands)


def scatter_by_index_local(dest_idx: torch.Tensor, values: tuple) -> tuple:
    """result[dest_idx[j]] = values[j] with ``dest_idx`` a permutation
    (the SA -> ISA un-permute)."""
    outs = []
    for v in values:
        out = torch.empty_like(v)
        out[dest_idx] = v
        outs.append(out)
    return tuple(outs)
