"""Single-device All-Nearest-Smaller-Values (port of
``psac_tpu/parallel/ansv.py::ansv_local`` at p = 1).

The (FURTHEST_EQ, NEAREST_SM) pass of the suffix tree always runs on the
tile-spine engine (``ops/tansv.py``: kernels K4 and K1), falling back to
the dual run-stack scan (K2) when the spine overflows its capacity; other
match-type pairs run on the dual scan directly.  The JAX package instead
dispatches by backend and shape (K3 and the block engine when the length is
not a multiple of 2048); here the input is padded at the END with
INT32_MAX up to a multiple of 2048, which changes no answer of a real
element (padding is never strictly smaller, and a right match that lands
in it means none).

The kernels are int32; int64 inputs (``force_int64`` builds) are narrowed
while they fit and the results widened back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_SM
from psac_tpu_torch.ops.nsv_scan import (CHUNK, nsv_scan_dual,
                                         nsv_scan_dual_plain, nsv_scan_spine,
                                         nsv_scan_spine_plain)
from psac_tpu_torch.ops.tansv import (I32_INF, tansv_feq_nsm, tile_side,
                                      tile_side_plain)


@dataclasses.dataclass(frozen=True)
class AnsvKernels:
    """The functions ANSV runs: the tile phase (K4), the spine scan (K1)
    and the dual scan (K2)."""

    tile_side: Callable
    spine_scan: Callable
    dual_scan: Callable


KERNELS = AnsvKernels(tile_side, nsv_scan_spine, nsv_scan_dual)
# the kernels' plain versions, called explicitly: the reference the kernels
# are held against on the card
PLAIN = AnsvKernels(tile_side_plain, nsv_scan_spine_plain,
                    nsv_scan_dual_plain)


def nonsv_for(dt: torch.dtype) -> int:
    """No-match sentinel for an index dtype (one above any valid index)."""
    return torch.iinfo(dt).max


def ansv_local(x: torch.Tensor, left_type: int, right_type: int,
               kernels: AnsvKernels = KERNELS):
    """Left and right matches of every element of (s,) ``x``.

    Returns (lidx, lval, ridx, rval) in ``x``'s dtype: match indices
    (``nonsv_for(x.dtype)`` when none) and the values there (0 when none).
    """
    idt = x.dtype
    s = x.shape[0]
    if idt == torch.int64 and s >= (1 << 31):
        raise NotImplementedError("ANSV kernels are int32: length >= 2^31")
    sp = max(CHUNK, -(-s // CHUNK) * CHUNK)
    xp = torch.cat([x.to(torch.int32),
                    x.new_full((sp - s,), I32_INF, dtype=torch.int32)])

    res = None
    if (left_type, right_type) == (FURTHEST_EQ, NEAREST_SM):
        *res, ovf = tansv_feq_nsm(xp, kernels.tile_side, kernels.spine_scan)
        if ovf:
            res = None
    if res is None:
        res = kernels.dual_scan(xp, xp.flip(0), left_type, right_type)[:4]
    li, lv, ri_r, rv_r = res

    ri = ri_r.flip(0)
    rv = rv_r.flip(0)
    ri = torch.where(ri < 0, -1, sp - 1 - ri)
    li, lv, ri, rv = li[:s], lv[:s], ri[:s], rv[:s]
    inf = nonsv_for(idt)
    lmiss = li < 0
    rmiss = (ri < 0) | (ri >= s)
    return (torch.where(lmiss, inf, li.to(idt)),
            torch.where(lmiss, 0, lv.to(idt)),
            torch.where(rmiss, inf, ri.to(idt)),
            torch.where(rmiss, 0, rv.to(idt)))
