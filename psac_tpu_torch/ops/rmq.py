"""In-device range-minimum queries (port of ``psac_tpu/ops/rmq.py`` in its
``with_small=False`` mode, plus ``parallel/par_rmq.py::bulk_rmq_local``
at p = 1).

A doubling table over fixed-size block minima answers the interior full
blocks of a query; the two edge blocks are answered by masked reads of
whole block rows.  At p = 1 the bulk query is this local query with INF
where the query is not valid.
"""

from __future__ import annotations

import dataclasses

import torch


def block_size_for(s: int, cap: int = 128) -> int:
    """Largest power-of-two divisor of s, capped."""
    return min(s & (-s), cap)


@dataclasses.dataclass
class LocalRMQ:
    """RMQ over a (s,) tensor: ``table[j]`` holds the minima of 2^j
    consecutive blocks of ``block`` elements."""

    x: torch.Tensor
    table: torch.Tensor   # (levels, nb)
    block: int

    @property
    def nb(self) -> int:
        return self.table.shape[1]


def _inf(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def build_local_rmq(x: torch.Tensor, block: int | None = None) -> LocalRMQ:
    s = x.shape[0]
    inf = _inf(x.dtype)
    block = block or block_size_for(s)
    nb = s // block
    rows = [x.view(nb, block).amin(dim=1)]
    for j in range(1, max(1, nb.bit_length())):
        prev = rows[-1]
        w = 1 << (j - 1)
        shifted = torch.cat([prev[w:], prev.new_full((min(w, nb),), inf)])[:nb]
        rows.append(torch.minimum(prev, shifted))
    return LocalRMQ(x=x, table=torch.stack(rows), block=block)


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(v, 1))) for integer tensors below 2^31."""
    v = v.clamp(min=1).to(torch.int64)
    out = torch.zeros_like(v)
    for sh in (16, 8, 4, 2, 1):
        big = v >= (1 << sh)
        out = out + big.to(torch.int64) * sh
        v = torch.where(big, v >> sh, v)
    return out


def query_local_rmq(rmq: LocalRMQ, lo: torch.Tensor, hi: torch.Tensor):
    """min(x[lo..hi]) per query, inclusive, 0 <= lo <= hi < s."""
    block, nb = rmq.block, rmq.nb
    inf = _inf(rmq.x.dtype)
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    bl = lo // block
    bh = hi // block
    # interior full blocks (bl, bh) exclusive, from the doubling table
    a = bl + 1
    b = bh - 1
    length = b - a + 1
    lev = _floor_log2(length)
    flat = rmq.table.reshape(-1)
    last = flat.shape[0] - 1
    t1 = flat[(lev * nb + a).clamp(0, last)]
    t2 = flat[(lev * nb + b - (1 << lev) + 1).clamp(0, last)]
    mid = torch.where(length > 0, torch.minimum(t1, t2), inf)
    return torch.minimum(edge_mins(rmq.x, block, lo, hi), mid)


def edge_mins(x: torch.Tensor, block: int, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """min over the parts of [lo, hi] inside the two edge blocks (the
    blocks of lo and of hi), by masked reads of whole block rows; the
    full answer when hi - lo < block."""
    inf = _inf(x.dtype)
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    xb = x.view(-1, block)
    bl = lo // block
    bh = hi // block
    offs = torch.arange(block, device=lo.device)[None, :]
    lo_off = (lo - bl * block)[:, None]
    hi_off = (hi - bh * block)[:, None]
    same = (bl == bh)[:, None]
    lmask = (offs >= lo_off) & (~same | (offs <= hi_off))
    rmask = (offs <= hi_off) & (~same | (offs >= lo_off))
    return torch.minimum(
        torch.where(lmask, xb[bl], inf).amin(dim=1),
        torch.where(rmask, xb[bh], inf).amin(dim=1))


def bulk_rmq_local(rmq: LocalRMQ, l, r, valid):
    """Min over [l, r] where ``valid`` (INF elsewhere); p = 1 form of the
    JAX package's distributed bulk RMQ."""
    s = rmq.x.shape[0]
    inf = _inf(rmq.x.dtype)
    lo = torch.where(valid, l, 0).clamp(0, s - 1)
    hi = torch.where(valid, r, 0).clamp(0, s - 1)
    return torch.where(valid, query_local_rmq(rmq, lo, hi), inf)
