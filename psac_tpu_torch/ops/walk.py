"""Hierarchical-window walks for nearest-value searches (port of
``psac_tpu/ops/walk.py``, in plain torch: no Pallas kernel stands behind
it in the JAX package either).

For a batch of queries over a local (s,) array they answer "largest
j < start with x[j] < v (or <= v)" and "smallest j >= start with
x[j] <= v (or < v)" over a T-ary min tree: ascend until an ancestor's row
holds a qualifying sibling, then descend picking the last (first)
qualifying child, one row gather of T entries per level.  The p > 1 ANSV
answers its routed queries and its furthest_eq run searches with them.
Queries go in chunks of ``_QCHUNK`` so that a level's (q, T) windows stay
bounded.
"""

from __future__ import annotations

import torch

_T = 128
_TBITS = 7
_QCHUNK = 1 << 19


def _chunked_walk(fn, start: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    q = start.shape[0]
    if q <= _QCHUNK:
        return fn(start, v)
    return torch.cat([fn(start[c:c + _QCHUNK], v[c:c + _QCHUNK])
                      for c in range(0, q, _QCHUNK)])


def _rows(a: torch.Tensor) -> torch.Tensor:
    """Pad to a multiple of T with the dtype's max and view as (rows, T)."""
    pad = (-a.shape[0]) % _T
    if pad:
        a = torch.cat([a, a.new_full((pad,), torch.iinfo(a.dtype).max)])
    return a.view(-1, _T)


def build_levels(x: torch.Tensor) -> tuple:
    """T-ary min-tree levels: levels[k][j] = min over x[j*T^k : (j+1)*T^k],
    each a (rows, T) tensor; level 0 is the padded input and the last level
    has a single row."""
    levels = [_rows(x)]
    while levels[-1].shape[0] > 1:
        levels.append(_rows(levels[-1].amin(dim=1)))
    return tuple(levels)


def _take_row(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return rows[r.clamp(0, rows.shape[0] - 1)]


def levels_prev_lt(levels, start: torch.Tensor, v: torch.Tensor,
                   strict: bool = True) -> torch.Tensor:
    """Largest j < start with x[j] < v (strict) or <= v; -1 if none.
    ``start`` (q,) in [0, s]; returns (q,) int64."""
    return _chunked_walk(
        lambda st, vv: _prev_lt(levels, st, vv, strict), start, v)


def _prev_lt(levels, start, v, strict: bool) -> torch.Tensor:
    L = len(levels)
    dev = start.device
    offs = torch.arange(_T, dtype=torch.int32, device=dev)[None, :]
    vv = v[:, None]

    def lt(a):
        return (a < vv) if strict else (a <= vv)

    start = start.to(torch.int64)
    p0 = (start - 1).clamp(min=0)
    none0 = start <= 0
    # ascent: the lowest level whose ancestor row has a qualifying entry
    # left of (or at, for level 0) the own position
    hits, sibs = [], []
    own = p0
    for k in range(L):
        parent = own >> _TBITS
        row = _take_row(levels[k], parent)
        pos = (own & (_T - 1))[:, None]
        qual = lt(row) & ((offs <= pos) if k == 0 else (offs < pos))
        hits.append(qual.any(dim=1))
        last = torch.where(qual, offs, -1).amax(dim=1)
        sibs.append(parent * _T + last)
        own = parent
    K = torch.full_like(p0, L)
    for k in reversed(range(L)):
        K = torch.where(hits[k], k, K)
    # descent from the hit node down to level 0
    c = torch.zeros_like(p0)
    for k in range(L - 1, 0, -1):
        ck = torch.where(K == k, sibs[k], c)
        row = _take_row(levels[k - 1], ck)
        last = torch.where(lt(row), offs, 0).amax(dim=1)
        c = torch.where(K >= k, ck * _T + last, c)
    ans = torch.where(K == 0, sibs[0], c)
    return torch.where(none0 | (K >= L), -1, ans)


def levels_next_leq(levels, start: torch.Tensor, v: torch.Tensor,
                    strict: bool = False) -> torch.Tensor:
    """Smallest j >= start with x[j] <= v (or < v); the padded length s
    if none (padding is the dtype's max and never qualifies).  Returns
    (q,) int64."""
    return _chunked_walk(
        lambda st, vv: _next_leq(levels, st, vv, strict), start, v)


def _next_leq(levels, start, v, strict: bool) -> torch.Tensor:
    L = len(levels)
    s = levels[0].shape[0] * _T
    dev = start.device
    offs = torch.arange(_T, dtype=torch.int32, device=dev)[None, :]
    vv = v[:, None]

    def le(a):
        return (a < vv) if strict else (a <= vv)

    start = start.to(torch.int64)
    p0 = start.clamp(0, s - 1)
    none0 = start >= s
    hits, sibs = [], []
    own = p0
    for k in range(L):
        parent = own >> _TBITS
        row = _take_row(levels[k], parent)
        pos = (own & (_T - 1))[:, None]
        qual = le(row) & ((offs >= pos) if k == 0 else (offs > pos))
        hits.append(qual.any(dim=1))
        first = torch.where(qual, offs, _T).amin(dim=1)
        sibs.append(parent * _T + first.clamp(max=_T - 1))
        own = parent
    K = torch.full_like(p0, L)
    for k in reversed(range(L)):
        K = torch.where(hits[k], k, K)
    c = torch.zeros_like(p0)
    for k in range(L - 1, 0, -1):
        ck = torch.where(K == k, sibs[k], c)
        row = _take_row(levels[k - 1], ck)
        first = torch.where(le(row), offs, _T - 1).amin(dim=1)
        c = torch.where(K >= k, ck * _T + first, c)
    ans = torch.where(K == 0, sibs[0], c)
    return torch.where(none0 | (K >= L), s, ans)
