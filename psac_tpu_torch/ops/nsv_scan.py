"""Run-stack ANSV scans: K1 (spine) and K2 (dual) of the JAX package's
``psac_tpu/ops/nsv_scan.py``, as hand-written CUDA kernels
(``psac_tpu_torch/csrc/nsv_scan.cu``) with plain PyTorch versions beside
them.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  The plain versions do not replay the stack:
they compute the same answers by a vectorized descent over a doubling
min-table (the JAX package's ``_left_match_local_only`` formulation), which
also checks the kernels independently.

Answers follow ``psac_tpu_torch/ops/ansv.py::_left_scan``: index -1 means
no match and the value is then 0.  The stack cannot overflow here (the
kernel spills to a scratch stack as long as the stream), so the returned
flag is always 0; it is kept for the JAX interface.
"""

from __future__ import annotations

import torch

from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM

CHUNK = 2048  # stream lengths the JAX kernels take are multiples of this

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _min_table(x: torch.Tensor) -> list[torch.Tensor]:
    """levels[k][j] = min(x[j : j + 2^k])."""
    levels = [x]
    w = 1
    while 2 * w <= x.shape[0]:
        prev = levels[-1]
        levels.append(torch.minimum(prev[:-w], prev[w:]))
        w *= 2
    return levels


def _prev_lt(levels, start, v, strict: bool):
    """Largest j < start with x[j] < v (strict) or <= v; -1 if none."""
    skip = torch.zeros_like(start)
    for k in reversed(range(len(levels))):
        w = 1 << k
        lo = start - skip - w
        blk = levels[k][lo.clamp(0, levels[k].shape[0] - 1)]
        clear = (blk >= v) if strict else (blk > v)
        skip = skip + ((lo >= 0) & clear).to(skip.dtype) * w
    return start - skip - 1


def _next_leq(levels, start, v):
    """Smallest j >= start with x[j] <= v; s (or start) if none."""
    s = levels[0].shape[0]
    skip = torch.zeros_like(start)
    for k in reversed(range(len(levels))):
        w = 1 << k
        lo = start + skip
        blk = levels[k][lo.clamp(0, levels[k].shape[0] - 1)]
        skip = skip + ((lo + w <= s) & (blk > v)).to(skip.dtype) * w
    return start + skip


def left_matches_plain(x: torch.Tensor, typ: int):
    """Left matches of every element of (s,) ``x`` for match type ``typ``.

    Returns (idx, val): int64 match positions (-1 = none) and the values
    there (0 = none).
    """
    if typ == FURTHEST_EQ:
        return _furthest_eq_plain(x)[:2]
    i = torch.arange(x.shape[0], device=x.device)
    j = _prev_lt(_min_table(x), i, x, strict=(typ == NEAREST_SM))
    return j, torch.where(j >= 0, x[j.clamp(min=0)], 0)


def _furthest_eq_plain(x: torch.Tensor):
    """FURTHEST_EQ left matches plus ``has_eq``: whether an equal value is
    visible, i.e. whether the scan merges the element into the top run."""
    s = x.shape[0]
    i = torch.arange(s, device=x.device)
    levels = _min_table(x)
    jstar = _prev_lt(levels, i, x, strict=True)
    e = _next_leq(levels, jstar + 1, x)
    has_eq = e < i
    jsafe = jstar.clamp(min=0)
    v2 = x[jsafe]
    j0 = _prev_lt(levels, jsafe + 1, v2, strict=True) + 1
    eh = _next_leq(levels, j0, v2).clamp(max=s - 1)
    idx = torch.where(has_eq, e, torch.where(jstar >= 0, eh, -1))
    val = torch.where(has_eq, x, torch.where(jstar >= 0, v2, 0))
    return idx, val, has_eq


def _explicit(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Map stream positions to the stream's explicit indices (-1 kept)."""
    return torch.where(idx >= 0, g[idx.clamp(min=0)], -1).to(torch.int32)


def _zero_flag(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=x.device)


def nsv_scan_spine_plain(xf, gf, xn, gn):
    """Plain version of K1: FURTHEST_EQ left matches of stream (xf, gf) with
    each element's run first after merge/push, and NEAREST_SM left matches
    of stream (xn, gn), in the streams' explicit indices.

    Returns (f_idx, f_val, f_h, n_idx, n_val, overflow)."""
    fidx, fval, feq = _furthest_eq_plain(xf)
    fi = _explicit(fidx, gf)
    fh = torch.where(feq, fi, gf)
    nidx, nval = left_matches_plain(xn, NEAREST_SM)
    return (fi, fval.to(torch.int32), fh, _explicit(nidx, gn),
            nval.to(torch.int32), _zero_flag(xf))


def nsv_scan_dual_plain(x, xr, typ_l: int, typ_r: int):
    """Plain version of K2: left matches of ``x`` (typ_l) and of ``xr``
    (typ_r), each in its own coordinates.

    Returns (idx_l, val_l, idx_r, val_r, overflow)."""
    il, vl = left_matches_plain(x, typ_l)
    ir, vr = left_matches_plain(xr, typ_r)
    i32 = torch.int32
    return (il.to(i32), vl.to(i32), ir.to(i32), vr.to(i32), _zero_flag(x))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def nsv_scan_spine(xf, gf, xn, gn):
    """K1 (replaces ``psac_tpu/ops/nsv_scan.py::nsv_scan_spine``): see
    ``nsv_scan_spine_plain`` for the contract."""
    if xf.device.type == "cpu":
        return nsv_scan_spine_plain(xf, gf, xn, gn)
    cuda_lib.check_cuda_int32("nsv_scan_spine", xf, gf, xn, gn)
    s = xf.shape[0]
    fi, fv, fh, ni, nv = (torch.empty_like(xf) for _ in range(5))
    flag = torch.empty(1, dtype=torch.int32, device=xf.device)
    scratch = torch.empty(4 * s, dtype=torch.int32, device=xf.device)
    cuda_lib.launch("psac_nsv_spine", *(t.data_ptr() for t in (
        xf, gf, xn, gn, fi, fv, fh, ni, nv, flag, scratch)), s)
    nsv_scan_spine.launches += 1
    return fi, fv, fh, ni, nv, flag[0]


nsv_scan_spine.launches = 0


def nsv_scan_dual(x, xr, typ_l: int, typ_r: int):
    """K2 (replaces ``psac_tpu/ops/nsv_scan.py::nsv_scan_dual``): see
    ``nsv_scan_dual_plain`` for the contract."""
    if x.device.type == "cpu":
        return nsv_scan_dual_plain(x, xr, typ_l, typ_r)
    cuda_lib.check_cuda_int32("nsv_scan_dual", x, xr)
    if {typ_l, typ_r} - {NEAREST_SM, NEAREST_EQ, FURTHEST_EQ}:
        raise ValueError(f"unknown match types {typ_l}, {typ_r}")
    s = x.shape[0]
    il, vl, ir, vr = (torch.empty_like(x) for _ in range(4))
    flag = torch.empty(1, dtype=torch.int32, device=x.device)
    scratch = torch.empty(4 * s, dtype=torch.int32, device=x.device)
    cuda_lib.launch("psac_nsv_dual", *(t.data_ptr() for t in (
        x, xr, il, vl, ir, vr, flag, scratch)), s, typ_l, typ_r)
    nsv_scan_dual.launches += 1
    return il, vl, ir, vr, flag[0]


nsv_scan_dual.launches = 0
