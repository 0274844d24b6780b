"""Single-device All-Nearest-Smaller-Values (port of
``psac_tpu/parallel/ansv.py`` at p = 1): ``ansv_local`` and the public
``ansv``.

The engine is the JAX package's ``PSAC_NSV`` selector, an explicit
``engine=`` argument here (None reads ``PSAC_NSV``, and ``hybrid`` where
that is unset), never the device.  On int32 input:

- ``hybrid`` (the default) and ``spine``: (FURTHEST_EQ, NEAREST_SM), the
  suffix tree's pass, runs the tile-spine engine (``ops/tansv.py``:
  kernels K4 and K1), falling back to the dual run-stack scan (K2) when
  the spine overflows its capacity; (FURTHEST_EQ, FURTHEST_EQ) runs the
  dual scan (K2, a block engine over both directions in one launch); any
  other pair runs each side on its own: a furthest_eq side on the left
  scan (K3), a nearest_sm or nearest_eq side on the block engine
  (``ops/bansv.py::nsv_left`` on K5);
- ``scan``: every pair on the dual scan (K2), both sides in one launch;
- ``block``: every side on the block engine (K5), furthest_eq through its
  run-head table.

int64 values (the public ``ansv`` keeps values that do not fit int32 in
int64) run every side on the block engine under every engine.  The JAX
package sends those to its walk engine; ANSV answers are unique, so both
give the same result.  The ``walk`` engine itself (the hierarchical-window
walks) is not ported and raises, as does an unknown name.

int32 input is padded at the END with INT32_MAX up to a multiple of 2048
for the scans, which changes no answer of a real element (padding is never
strictly smaller, and a right match that lands in it means none).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from psac_tpu_torch import config as cfg_mod
from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_SM
from psac_tpu_torch.ops.bansv import block_psv, block_psv_plain, nsv_left
from psac_tpu_torch.ops.nsv_scan import (CHUNK, nsv_scan_dual,
                                         nsv_scan_dual_plain, nsv_scan_left,
                                         nsv_scan_left_plain, nsv_scan_spine,
                                         nsv_scan_spine_plain)
from psac_tpu_torch.ops.tansv import (I32_INF, tansv_feq_nsm, tile_side,
                                      tile_side_plain)
from psac_tpu_torch.parallel.mesh import padded_size


@dataclasses.dataclass(frozen=True)
class AnsvKernels:
    """The functions ANSV runs: the tile phase (K4), the spine scan (K1),
    the dual scan (K2), the left scan (K3) and the block engine's
    previous-smaller pass (K5)."""

    tile_side: Callable
    spine_scan: Callable
    dual_scan: Callable
    left_scan: Callable
    block_psv: Callable


KERNELS = AnsvKernels(tile_side, nsv_scan_spine, nsv_scan_dual,
                      nsv_scan_left, block_psv)
# the kernels' plain versions, called explicitly: the reference the kernels
# are held against on the card
PLAIN = AnsvKernels(tile_side_plain, nsv_scan_spine_plain,
                    nsv_scan_dual_plain, nsv_scan_left_plain,
                    block_psv_plain)


def nonsv_for(dt: torch.dtype) -> int:
    """No-match sentinel for an index dtype (one above any valid index)."""
    return torch.iinfo(dt).max


def _left_side(x: torch.Tensor, typ: int, kernels: AnsvKernels):
    """Left matches of one side: (idx, val), idx -1 when none."""
    if typ == FURTHEST_EQ and x.dtype == torch.int32:
        return kernels.left_scan(x, typ)[:2]
    return nsv_left(x, typ, kernels.block_psv)


ENGINES = ("hybrid", "spine", "scan", "block")


def resolve_engine(engine: str | None = None) -> str:
    """The ANSV engine a call runs: ``engine``, else ``PSAC_NSV``, else
    ``hybrid``.  Raises ValueError for ``walk`` (not ported) and for an
    unknown name."""
    eng = engine or os.environ.get("PSAC_NSV") or "hybrid"
    if eng == "walk":
        raise ValueError("the walk ANSV engine (hierarchical-window walks) "
                         "is not ported")
    if eng not in ENGINES:
        raise ValueError(f"unknown ANSV engine {eng!r}: expected one of "
                         f"{', '.join(ENGINES)}")
    return eng


def _matches(x: torch.Tensor, left_type: int, right_type: int,
             kernels: AnsvKernels, engine: str):
    """(lidx, lval, ridx_r, rval_r) of (s,) ``x`` on ``engine``, the right
    side in reversed coordinates; idx -1 when none."""
    pair = (left_type, right_type)
    if x.dtype == torch.int32 and engine == "scan":
        return kernels.dual_scan(x, x.flip(0), left_type, right_type)[:4]
    if x.dtype == torch.int32 and engine == "block":
        return (*nsv_left(x, left_type, kernels.block_psv),
                *nsv_left(x.flip(0), right_type, kernels.block_psv))
    if x.dtype == torch.int32:
        if pair == (FURTHEST_EQ, NEAREST_SM):
            *res, ovf = tansv_feq_nsm(x, kernels.tile_side,
                                      kernels.spine_scan)
            if not ovf:
                return res
        if pair in ((FURTHEST_EQ, NEAREST_SM), (FURTHEST_EQ, FURTHEST_EQ)):
            return kernels.dual_scan(x, x.flip(0), left_type, right_type)[:4]
    return (*_left_side(x, left_type, kernels),
            *_left_side(x.flip(0), right_type, kernels))


def _ansv(x: torch.Tensor, left_type: int, right_type: int,
          kernels: AnsvKernels, idt: torch.dtype, engine: str | None = None):
    """Matches of int32 or int64 ``x`` on ``engine`` (``resolve_engine``),
    in ``idt`` with ``nonsv_for(idt)`` where there is none."""
    engine = resolve_engine(engine)
    s = x.shape[0]
    if s >= (1 << 31):
        raise NotImplementedError("ANSV indices are int32: length >= 2^31")
    xp = x
    if x.dtype == torch.int32:
        sp = max(CHUNK, -(-s // CHUNK) * CHUNK)
        xp = torch.cat([x, x.new_full((sp - s,), I32_INF)])
    sp = xp.shape[0]
    li, lv, ri_r, rv_r = _matches(xp, left_type, right_type, kernels,
                                  engine)

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


def ansv_local(x: torch.Tensor, left_type: int, right_type: int,
               kernels: AnsvKernels = KERNELS, engine: str | None = None):
    """Left and right matches of every element of an (s,) LCP array ``x``
    on ``engine`` (None: ``PSAC_NSV``, else ``hybrid``).

    Returns (lidx, lval, ridx, rval) in ``x``'s dtype: match indices
    (``nonsv_for(x.dtype)`` when none) and the values there (0 when none).
    LCP values fit int32, so int64 input (``force_int64`` builds) is
    narrowed for the int32 engines and the results are widened back.
    """
    return _ansv(x.to(torch.int32), left_type, right_type, kernels, x.dtype,
                 engine)


def ansv(arr, left_type: int = NEAREST_SM, right_type: int = NEAREST_SM,
         device=None, nonsv: int | None = None, indexing: str = "global",
         kernels: AnsvKernels = KERNELS, engine: str | None = None):
    """ANSV of a host array on ``device`` (port of the JAX package's public
    ``ansv`` at p = 1); ``device=None`` is the CUDA card (pass "cpu" for
    the plain versions on the host).

    Values that do not fit int32 run at int64 (the reference's ``T``
    template) and are never narrowed.  ``nonsv`` defaults to n (one past
    the end).  ``kernels=PLAIN`` runs the kernels' plain versions under any
    ``engine`` (None: ``PSAC_NSV``, else ``hybrid``; module docstring).

    - ``indexing="global"``: returns (left, right) np.int64 indices.
    - ``indexing="local"``: returns (left, right) where each side is a
      (rank, local_idx, value) triple of np.int64 arrays; with one shard
      rank is 0 (-1 when unmatched, local_idx then ``nonsv`` and value 0).
    """
    if indexing not in ("global", "local"):
        raise ValueError(f"indexing must be 'global' or 'local': {indexing}")
    vals = np.asarray(arr)
    i32 = np.iinfo(np.int32)
    wide = bool(vals.size) and (int(vals.min()) < i32.min
                                or int(vals.max()) >= i32.max)
    dt = np.int64 if wide else np.int32
    infd = np.iinfo(dt).max  # doubles as the +inf padding sentinel
    n = len(vals)
    N = padded_size(max(n, 1), 1)
    xp = np.full(N, infd, dt)
    xp[:n] = vals.astype(dt)
    x = torch.from_numpy(xp).to(cfg_mod.resolve_device(device))
    lidx, lval, ridx, rval = (t.cpu().numpy() for t in _ansv(
        x, left_type, right_type, kernels, x.dtype, engine))

    sent = n if nonsv is None else nonsv
    left = lidx[:n].astype(np.int64)
    right = ridx[:n].astype(np.int64)
    lmiss = left == infd
    # a right match pointing into the +inf padding means "no match"
    rmiss = (right == infd) | (right >= n)
    left[lmiss] = sent
    right[rmiss] = sent
    if indexing == "global":
        return left, right
    lv = lval[:n].astype(np.int64)
    rv = rval[:n].astype(np.int64)
    lv[lmiss] = 0
    rv[rmiss] = 0

    def to_local(g, miss):
        return np.where(miss, -1, g // N), np.where(miss, sent, g % N)

    lrank, lloc = to_local(left, lmiss)
    rrank, rloc = to_local(right, rmiss)
    return (lrank, lloc, lv), (rrank, rloc, rv)
