"""Distributed multi-key sort (port of ``psac_tpu/parallel/sort.py``).

``lax.sort(operands, num_keys=k)`` has no torch counterpart.  It is
composed here from stable single-key sorts, least significant key first,
each gathering the next key through the permutation so far (LSD order).

On a mesh (``ctx`` of ``Mesh.run``, p > 1) each shard sorts its block,
then the blocks are merged as the JAX package merges them: a merge-split
bitonic network for power-of-two p (log2(p)*(log2(p)+1)/2 stages), odd-even
block transposition for other p (p rounds).  In each stage both partners
merge the same 2s rows in canonical order (lower rank first) with a stable
sort and keep the lower or the upper half.  Ties keep their input order
within a shard, and the JAX package sorts unstably; every key tuple the
construction sorts ends in a unique column (global index, row or
position), so the order is total and equals the JAX one there.
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


def _local_sort(operands: tuple, num_keys: int) -> tuple:
    perm = lex_perm(operands[:num_keys])
    return tuple(o[perm] for o in operands)


def _merge_split(operands: tuple, partner: tuple, num_keys: int,
                 take_lower: bool, am_lower_rank: bool) -> tuple:
    """Merge two sorted blocks and keep the lower or the upper half; both
    partners merge (lower rank's block, higher rank's block) alike."""
    s = operands[0].shape[0]
    firsts, seconds = (operands, partner) if am_lower_rank else \
        (partner, operands)
    merged = _local_sort(tuple(torch.cat([a, b])
                               for a, b in zip(firsts, seconds)), num_keys)
    return tuple(m[:s] if take_lower else m[s:] for m in merged)


def dist_sort_local(operands: tuple, num_keys: int, ctx=None) -> tuple:
    """Sort block-distributed ``operands`` globally by their first
    ``num_keys`` entries; each shard gets back its (s,) block of the
    result.  Without ``ctx`` (one shard) a local stable sort."""
    operands = _local_sort(tuple(operands), num_keys)
    if ctx is None or ctx.p == 1:
        return operands
    p, i = ctx.p, ctx.rank
    if p & (p - 1):
        return _odd_even_sort_local(operands, num_keys, ctx)
    m = p.bit_length() - 1
    for k in range(1, m + 1):
        for j in reversed(range(k)):
            pairs = [(a, a ^ (1 << j)) for a in range(p)]
            partner = ctx.ppermute(operands, pairs)
            ascending = (i & (1 << k)) == 0
            is_lower = (i & (1 << j)) == 0
            operands = _merge_split(operands, partner, num_keys,
                                    ascending == is_lower, is_lower)
    return operands


def _odd_even_sort_local(operands: tuple, num_keys: int, ctx) -> tuple:
    """Odd-even block transposition: p rounds of neighbour merge-splits
    (round r pairs blocks (2i + r%2, 2i + 1 + r%2); a block without a
    partner keeps its rows)."""
    p, i = ctx.p, ctx.rank
    for r in range(p):
        off = r % 2
        partner = []
        for a in range(p):
            if a < off or (a - off) % 2 == 0:
                b = a + 1 if (a >= off and a + 1 < p) else a
            else:
                b = a - 1
            partner.append(b)
        got = ctx.ppermute(operands, [(a, partner[a]) for a in range(p)])
        if partner[i] != i:
            lower = i < partner[i]
            operands = _merge_split(operands, got, num_keys, lower, lower)
    return operands


def scatter_by_index_local(dest_idx: torch.Tensor, values: tuple,
                           ctx=None) -> tuple:
    """result[dest_idx[j]] = values[j] with ``dest_idx`` a permutation of
    the global indices (the SA -> ISA un-permute).  On a mesh a distributed
    sort by the destination leaves each value block-aligned at its place
    (the reference's ``bulk_permute_inplace``)."""
    if ctx is not None and ctx.p > 1:
        return dist_sort_local((dest_idx, *values), 1, ctx)[1:]
    outs = []
    for v in values:
        out = torch.empty_like(v)
        out[dest_idx] = v
        outs.append(out)
    return tuple(outs)
