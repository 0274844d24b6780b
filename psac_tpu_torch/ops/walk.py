"""Hierarchical-window walks for nearest-value searches (port of
``psac_tpu/ops/walk.py``): K8, ``levels_prev_lt`` and ``levels_next_leq``
as a hand-written CUDA kernel (``psac_tpu_torch/csrc/walk.cu``), with the
JAX formula in torch beside it as its plain version.  In the JAX package
they are plain XLA, which fuses each level's row gather, compare, mask and
reduction; eager torch would materialize every (q, T) window instead.

For a batch of queries over a local (s,) array they answer "largest
j < start with x[j] < v (or <= v)" and "smallest j >= start with
x[j] <= v (or < v)" over a T-ary min tree: ascend until an ancestor's row
holds a qualifying sibling, then descend picking the last (first)
qualifying child, one row gather of T entries per level.  The p > 1 ANSV
answers its routed queries and its furthest_eq run searches with them,
and the p = 1 ``walk`` engine its whole pass.  The plain versions take
the queries in chunks of ``_QCHUNK`` so that a level's (q, T) windows stay
bounded.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises.  ``build_levels`` stays plain torch (an
``amin`` per level), as it is plain XLA in JAX.
"""

from __future__ import annotations

import ctypes

import torch

from psac_tpu_torch.ops import cuda_lib

_T = 128
_TBITS = 7
_QCHUNK = 1 << 19
MAX_LEVELS = 8  # MAX_LEVELS of csrc/walk.cu (5 levels reach 2^35 entries)


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
    each a (rows, T) tensor; level 0 is the padded input (a copy of an
    input that starts off a 16-byte boundary) and the last level has a
    single row."""
    if x.data_ptr() % 16:  # K8 reads rows as 16-byte words
        x = x.clone()
    levels = [_rows(x)]
    while levels[-1].shape[0] > 1:
        levels.append(_rows(levels[-1].amin(dim=1)))
    return tuple(levels)


def _take_row(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return rows[r.clamp(0, rows.shape[0] - 1)]


def levels_prev_lt_plain(levels, start: torch.Tensor, v: torch.Tensor,
                         strict: bool = True) -> torch.Tensor:
    """Plain version of K8's ``levels_prev_lt``: the largest j < start with
    x[j] < v (strict) or <= v; -1 if none.  ``start`` (q,) in [0, s];
    returns (q,) int64."""
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


def levels_next_leq_plain(levels, start: torch.Tensor, v: torch.Tensor,
                          strict: bool = False) -> torch.Tensor:
    """Plain version of K8's ``levels_next_leq``: the smallest j >= start
    with x[j] <= v (or < v); the padded length s if none (padding is the
    dtype's max and never qualifies).  Returns (q,) int64."""
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


def _launch(kind: str, wrapper, levels, start: torch.Tensor,
            v: torch.Tensor, strict: bool) -> torch.Tensor:
    """Check the levels and the queries, launch ``psac_walk_<kind>_*`` and
    count it on ``wrapper``; q = 0 launches nothing."""
    name = f"levels_{kind}"
    dt = v.dtype
    if dt not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: expected int32 or int64 values, got {dt}")
    cuda_lib.check_cuda(name, torch.int64, start)
    cuda_lib.check_cuda(name, dt, v)
    if v.device != start.device or v.shape != start.shape:
        raise ValueError(f"{name}: start and v differ in device or shape")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{name}: expected 1 to {MAX_LEVELS} levels, got "
                         f"{len(levels)}")
    for lv in levels:
        if lv.device != start.device or lv.dtype != dt or lv.dim() != 2 \
                or lv.shape[1] != _T or lv.shape[0] < 1 \
                or not lv.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (rows, {_T}) "
                             f"levels of {dt} on {start.device}")
        if lv.data_ptr() % 16:
            raise ValueError(f"{name}: every level must start on a 16-byte "
                             "boundary (build_levels makes them so)")
    q = start.shape[0]
    out = torch.empty(q, dtype=torch.int64, device=start.device)
    if q == 0:
        return out
    L = len(levels)
    ptrs = (ctypes.c_void_p * L)(*[lv.data_ptr() for lv in levels])
    rows = (ctypes.c_longlong * L)(*[lv.shape[0] for lv in levels])
    suffix = "i32" if dt == torch.int32 else "i64"
    cuda_lib.launch(f"psac_walk_{kind}_{suffix}", ctypes.addressof(ptrs),
                    ctypes.addressof(rows), L, start.data_ptr(),
                    v.data_ptr(), out.data_ptr(), q, int(strict),
                    device=start.device)
    cuda_lib.count_launch(wrapper)
    return out


def levels_prev_lt(levels, start: torch.Tensor, v: torch.Tensor,
                   strict: bool = True) -> torch.Tensor:
    """K8 (replaces ``psac_tpu/ops/walk.py::levels_prev_lt``): see
    ``levels_prev_lt_plain`` for the contract.  On the card ``start`` is
    int64 and ``v`` of the levels' dtype."""
    if start.device.type == "cpu":
        return levels_prev_lt_plain(levels, start, v, strict)
    return _launch("prev_lt", levels_prev_lt, levels, start, v, strict)


levels_prev_lt.launches = 0


def levels_next_leq(levels, start: torch.Tensor, v: torch.Tensor,
                    strict: bool = False) -> torch.Tensor:
    """K8 (replaces ``psac_tpu/ops/walk.py::levels_next_leq``): see
    ``levels_next_leq_plain`` for the contract.  On the card ``start`` is
    int64 and ``v`` of the levels' dtype."""
    if start.device.type == "cpu":
        return levels_next_leq_plain(levels, start, v, strict)
    return _launch("next_leq", levels_next_leq, levels, start, v, strict)


levels_next_leq.launches = 0
