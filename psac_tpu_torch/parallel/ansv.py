"""All-Nearest-Smaller-Values (port of ``psac_tpu/parallel/ansv.py``):
``ansv_local`` and the public ``ansv`` on one device, ``ansv_mesh_local``
on a mesh of p > 1 shards.

On one device the engine is the JAX package's ``PSAC_NSV`` selector, an
explicit ``engine=`` argument here (None reads ``PSAC_NSV``, and
``hybrid`` where that is unset), never the device.  On int32 input:

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
  run-head table;
- ``walk``: every side on the hierarchical-window walks (``ops/walk.py``,
  plain torch; the JAX ``_left_match_local_only``).

int64 values (the public ``ansv`` keeps values that do not fit int32 in
int64) run every side on the block engine under every engine but
``walk``.  The JAX package sends those to its walk engine; ANSV answers
are unique, so both give the same result.

int32 input is padded at the END with INT32_MAX up to a multiple of 2048
for the scans, which changes no answer of a real element (padding is never
strictly smaller, and a right match that lands in it means none).

On a mesh (JAX ``_left_nearest`` / ``_left_furthest_eq``, ``:52-233``)
every shard finds its elements' in-shard matches with K5 ``block_psv``;
an element without one picks the shard that holds its match from the
replicated shard minima, and the query goes there by ``route_apply``,
where the walks answer it.  The right side is the left side of the
block-reversed array.  The engine selector does not apply there.
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
from psac_tpu_torch.ops.walk import (build_levels, levels_next_leq,
                                     levels_prev_lt)
from psac_tpu_torch.parallel.mesh import Rep, padded_size
from psac_tpu_torch.parallel.route import cap_for, route_apply


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


def _walk_side(x: torch.Tensor, typ: int):
    """Left matches of one side on the hierarchical-window walks (the JAX
    ``_left_match_local_only``): (idx, val), idx -1 when none."""
    s = x.shape[0]
    table = build_levels(x)
    i_loc = torch.arange(s, device=x.device)
    if typ != FURTHEST_EQ:
        jl = levels_prev_lt(table, i_loc, x, strict=(typ == NEAREST_SM))
        return jl, torch.where(jl >= 0, x[jl.clamp(min=0)], 0)
    jstar = levels_prev_lt(table, i_loc, x, strict=True)
    e_loc = levels_next_leq(table, jstar + 1, x)
    has_eq = e_loc < i_loc
    jsafe = jstar.clamp(min=0)
    v2 = x[jsafe]
    j0 = levels_prev_lt(table, jsafe + 1, v2, strict=True) + 1
    eh = levels_next_leq(table, j0, v2).clamp(max=s - 1)
    idx = torch.where(has_eq, e_loc, torch.where(jstar >= 0, eh, -1))
    val = torch.where(has_eq, x, torch.where(jstar >= 0, v2, 0))
    return idx, val


ENGINES = ("hybrid", "spine", "scan", "block", "walk")


def resolve_engine(engine: str | None = None) -> str:
    """The ANSV engine a call runs: ``engine``, else ``PSAC_NSV``, else
    ``hybrid``.  Raises ValueError for an unknown name."""
    eng = engine or os.environ.get("PSAC_NSV") or "hybrid"
    if eng not in ENGINES:
        raise ValueError(f"unknown ANSV engine {eng!r}: expected one of "
                         f"{', '.join(ENGINES)}")
    return eng


def _matches(x: torch.Tensor, left_type: int, right_type: int,
             kernels: AnsvKernels, engine: str):
    """(lidx, lval, ridx_r, rval_r) of (s,) ``x`` on ``engine``, the right
    side in reversed coordinates; idx -1 when none."""
    pair = (left_type, right_type)
    if engine == "walk":
        return (*_walk_side(x, left_type), *_walk_side(x.flip(0), right_type))
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


# ---------------------------------------------------------------------------
# p > 1: in-shard matches on K5, the rest routed to the walks of their shard
# ---------------------------------------------------------------------------


def _shard_last_lt(sm, v, lim, strict: bool):
    """Largest shard t < lim with sm[t] < v (or <= v); -1 if none."""
    t = torch.arange(sm.shape[0], dtype=torch.int64, device=v.device)[None, :]
    cmp = (sm[None, :] < v[:, None]) if strict else (sm[None, :] <= v[:, None])
    return torch.where(cmp & (t < lim[:, None]), t, -1).amax(dim=1)


def _shard_first_eq(sm, v, tlo, thi):
    """Smallest shard t with tlo < t < thi and sm[t] == v; p if none."""
    p = sm.shape[0]
    t = torch.arange(p, dtype=torch.int64, device=v.device)[None, :]
    ok = (sm[None, :] == v[:, None]) & (t > tlo[:, None]) & (t < thi[:, None])
    return torch.where(ok, t, p).amin(dim=1)


def _on_valid(recv_valid, fn, *cols) -> tuple:
    """``fn(*cols)`` over the received rows that are valid only, answers 0
    elsewhere (no record reads them): most rows of a full-capacity
    exchange are padding, and the owner's walks are the answers' cost."""
    at = torch.nonzero(recv_valid).squeeze(1)
    outs = []
    for g in fn(*(c[at] for c in cols)):
        o = g.new_zeros((recv_valid.shape[0],) + g.shape[1:])
        o[at] = g
        outs.append(o)
    return tuple(outs)


def _left_nearest(ctx, x, table, sm, strict: bool, cap, kernels):
    """nearest_sm (strict) / nearest_eq left matches on a mesh: (global
    index, value, overflow count), in ``x``'s dtype."""
    idt, s, p = x.dtype, x.shape[0], ctx.p
    inf = nonsv_for(idt)
    base = ctx.rank * s
    jl = kernels.block_psv(x, strict).to(torch.int64)
    found = jl >= 0
    C = _shard_last_lt(sm, x, torch.full_like(jl, ctx.rank), strict)

    def walk(qv):
        j = levels_prev_lt(table, torch.full_like(qv, s, dtype=torch.int64),
                           qv, strict=strict)
        ok = j >= 0
        return (torch.where(ok, base + j, inf).to(idt),
                torch.where(ok, x[j.clamp(min=0)], 0).to(idt))

    def answer(recv, recv_valid):
        return _on_valid(recv_valid, walk, *recv)

    (ridx, rval), ovf = route_apply((x,), answer, found | (C < 0),
                                    dest=C.clamp(0, p - 1), ctx=ctx, cap=cap,
                                    with_overflow=True)
    idx = torch.where(found, base + jl, torch.where(C >= 0, ridx, inf))
    val = torch.where(found, x[jl.clamp(min=0)],
                      torch.where(C >= 0, rval, 0))
    return idx.to(idt), val.to(idt), ovf


def _left_furthest_eq(ctx, x, table, sm, cap, kernels):
    """furthest_eq left matches on a mesh: (global index, value, overflow
    count).  (a) the nearest strictly smaller j* (K5 in the shard, else a
    routed walk, whose owner also reports the leftmost visible member of
    j*'s run in its block and whether the run may go on left of it);
    (b) the leftmost visible equal of the element's value between j* and
    the element; (c) without one, the leftmost visible member of j*'s run,
    in an earlier shard when it goes on there (a second round)."""
    idt, s, p, r = x.dtype, x.shape[0], ctx.p, ctx.rank
    inf = nonsv_for(idt)
    base = r * s
    v = x
    i_loc = torch.arange(s, device=x.device)
    r_vec = torch.full((s,), r, dtype=torch.int64, device=x.device)

    jstar = kernels.block_psv(v, True).to(torch.int64)
    has_loc = jstar >= 0
    C = _shard_last_lt(sm, v, r_vec, strict=True)
    has_rem = ~has_loc & (C >= 0)

    def walk1(qv):
        j = levels_prev_lt(table, torch.full_like(qv, s, dtype=torch.int64),
                           qv, strict=True)
        jsafe = j.clamp(min=0)
        v2 = x[jsafe]
        # leftmost visible member of j*'s run in this block, and whether
        # the run reaches the block's left edge (may go on further left)
        j0 = levels_prev_lt(table, jsafe + 1, v2, strict=True) + 1
        e_home = levels_next_leq(table, j0, v2)
        # leftmost occurrence of the query value after j* (everything in
        # (j*, i) is >= qv, so the first <= qv is an equal, and visible)
        e_after = levels_next_leq(table, jsafe + 1, qv)
        return ((base + j).to(idt), v2,
                (base + e_home.clamp(max=s - 1)).to(idt),
                (j0 == 0).to(torch.int32),
                (base + e_after.clamp(max=s - 1)).to(idt),
                (e_after < s).to(torch.int32))

    def answer1(recv, recv_valid):
        return _on_valid(recv_valid, walk1, *recv)

    (g1, v2_1, eh1, ext1, ea1, ea1_ok), ovf1 = route_apply(
        (v,), answer1, ~has_rem, dest=C.clamp(0, p - 1), ctx=ctx, cap=cap,
        with_overflow=True)

    # the same run facts for elements whose j* is in this shard
    jsafe = jstar.clamp(min=0)
    v2_l = x[jsafe]
    j0_l = levels_prev_lt(table, jsafe + 1, v2_l, strict=True) + 1
    eh_l = levels_next_leq(table, j0_l, v2_l)

    has_star = has_loc | has_rem
    gstar = torch.where(has_loc, base + jstar, g1)
    v2 = torch.where(has_loc, v2_l, v2_1)
    e_home = torch.where(has_loc, base + eh_l.clamp(max=s - 1), eh1)
    extend = torch.where(has_loc, j0_l == 0, ext1 != 0)
    shard_g = torch.where(has_star, gstar // s, -1)
    # an equal of v in shard(j*)'s suffix after a remote j*
    e_after_ok = has_rem & (ea1_ok != 0)

    # (b) shard(j*)'s suffix (e_after), whole shards strictly between (any
    # equal there is visible), then this shard's prefix (e_loc)
    startpos = torch.where(has_loc, jstar + 1, 0)
    e_loc = levels_next_leq(table, startpos, v)
    e_loc_ok = e_loc < i_loc
    t_eq = _shard_first_eq(sm, v, shard_g, r_vec)
    t_eq_ok = t_eq < p

    # (c) no equal anywhere: the leftmost visible member of j*'s run, in
    # t2 (the first shard with minimum v2 between the blocker C2 and
    # shard(j*)) or in the suffix of the blocker C2 itself
    no_eq = ~(e_after_ok | t_eq_ok | e_loc_ok)
    want_ext = no_eq & has_star & extend
    C2 = _shard_last_lt(sm, v2, shard_g, strict=True)
    t2 = _shard_first_eq(sm, v2, C2, shard_g)
    want_c2 = want_ext & (C2 >= 0)
    want_t2 = want_ext & (t2 < p)

    def walk2(qv):
        # the leftmost visible occurrence of qv in this block: the first
        # qv after the block's last element < qv
        j0 = levels_prev_lt(table, torch.full_like(qv, s, dtype=torch.int64),
                            qv, strict=True) + 1
        e = levels_next_leq(table, j0, qv)
        return ((base + e.clamp(max=s - 1)).to(idt),
                (e < s).to(torch.int32))

    def answer2(recv, recv_valid):
        return _on_valid(recv_valid, walk2, *recv)

    qval_a = torch.where(t_eq_ok, v, v2)
    dest_a = torch.where(t_eq_ok, t_eq, C2).clamp(0, p - 1)
    (e_a, e_a_ok), ovf2 = route_apply(
        (qval_a,), answer2, ~(t_eq_ok | want_c2), dest=dest_a, ctx=ctx,
        cap=cap, with_overflow=True)
    (e_b, _), ovf3 = route_apply(
        (v2,), answer2, ~want_t2, dest=t2.clamp(0, p - 1), ctx=ctx, cap=cap,
        with_overflow=True)

    ext_idx = torch.where(want_c2 & (e_a_ok != 0), e_a,
                          torch.where(want_t2, e_b, e_home))
    idx = torch.where(
        e_after_ok, ea1,
        torch.where(t_eq_ok, e_a,
                    torch.where(e_loc_ok, base + e_loc,
                                torch.where(has_star,
                                            torch.where(extend, ext_idx,
                                                        e_home), inf))))
    val = torch.where(e_after_ok | t_eq_ok | e_loc_ok, v,
                      torch.where(has_star, v2, 0))
    return idx.to(idt), val.to(idt), ovf1 + ovf2 + ovf3


def _left_match_mesh(ctx, x, typ: int, cap, kernels):
    table = build_levels(x)
    sm = ctx.all_gather(x.amin())
    if typ == FURTHEST_EQ:
        return _left_furthest_eq(ctx, x, table, sm, cap, kernels)
    return _left_nearest(ctx, x, table, sm, typ == NEAREST_SM, cap, kernels)


def _reverse_dist(ctx, x: torch.Tensor) -> torch.Tensor:
    """The block-distributed array reversed: each block reversed, and the
    blocks' order flipped."""
    p = ctx.p
    return ctx.ppermute(x.flip(0), [(i, p - 1 - i) for i in range(p)])


def ansv_mesh_local(ctx, x: torch.Tensor, left_type: int, right_type: int,
                    capscale: int | None = None,
                    kernels: AnsvKernels = KERNELS):
    """ANSV of a block-distributed array inside ``Mesh.run`` (p > 1).

    Returns (lidx, lval, ridx, rval, ovf) in ``x``'s dtype: global match
    indices (``nonsv_for(x.dtype)`` when none), the values there (0 when
    none), and the psum'd count of records the routing capacity dropped
    (``capscale`` bounds each destination's buffer, ``route.cap_for``;
    nonzero ovf means the answers are incomplete and the caller retries with
    a larger capscale)."""
    s, p = x.shape[0], ctx.p
    cap = cap_for(s, p, capscale)
    lidx, lval, ovf_l = _left_match_mesh(ctx, x, left_type, cap, kernels)
    ridx_r, rval_r, ovf_r = _left_match_mesh(ctx, _reverse_dist(ctx, x),
                                             right_type, cap, kernels)
    ridx_r = _reverse_dist(ctx, ridx_r)
    rval = _reverse_dist(ctx, rval_r)
    inf = nonsv_for(x.dtype)
    ridx = torch.where(ridx_r == inf, inf, s * p - 1 - ridx_r)
    return lidx, lval, ridx.to(x.dtype), rval, ovf_l + ovf_r


def _ansv_run(ctx, x, left_type, right_type, capscale, kernels):
    *res, ovf = ansv_mesh_local(ctx, x, left_type, right_type, capscale,
                                kernels)
    return (*res, Rep(int(ovf)))


def ansv(arr, left_type: int = NEAREST_SM, right_type: int = NEAREST_SM,
         device=None, nonsv: int | None = None, indexing: str = "global",
         kernels: AnsvKernels = KERNELS, engine: str | None = None,
         mesh=None):
    """ANSV of a host array (port of the JAX package's public ``ansv``) on
    ``device`` (None: the CUDA card; "cpu" runs the plain versions on the
    host), or on the p shards of ``mesh`` (``parallel.mesh.make_mesh``),
    which then replaces ``device``.

    Values that do not fit int32 run at int64 (the reference's ``T``
    template) and are never narrowed.  ``nonsv`` defaults to n (one past
    the end).  ``kernels=PLAIN`` runs the kernels' plain versions under any
    ``engine`` (None: ``PSAC_NSV``, else ``hybrid``; module docstring; on a
    mesh of p > 1 the engine does not apply).  A mesh retries with
    unbounded routing buffers when capscale 4 overflows, as JAX does.

    - ``indexing="global"``: returns (left, right) np.int64 indices.
    - ``indexing="local"``: returns (left, right) where each side is a
      (rank, local_idx, value) triple of np.int64 arrays: the shard that
      holds the match, the index in it, and the matched value (rank -1,
      local_idx ``nonsv`` and value 0 when unmatched).
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
    p = 1 if mesh is None else mesh.p
    if mesh is not None and p == 1:
        device = mesh.devices[0]
    if mesh is not None and mesh.multiprocess:
        raise ValueError("ansv gathers its answers to the caller: on a mesh "
                         "that spans processes call ansv_mesh_local in "
                         "Mesh.run")
    N = padded_size(max(n, 1), p)
    xp = np.full(N, infd, dt)
    xp[:n] = vals.astype(dt)
    if p == 1:
        x = torch.from_numpy(xp).to(cfg_mod.resolve_device(device))
        lidx, lval, ridx, rval = (t.cpu().numpy() for t in _ansv(
            x, left_type, right_type, kernels, x.dtype, engine))
    else:
        xs = mesh.shard(torch.from_numpy(xp))
        for capscale in (4, None):
            *outs, ovf = mesh.run(_ansv_run, xs, left_type, right_type,
                                  capscale, kernels)
            if capscale is None or ovf == 0:
                break
        lidx, lval, ridx, rval = (o.gather().numpy() for o in outs)

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
    s = N // p

    def to_local(g, miss):
        return np.where(miss, -1, g // s), np.where(miss, sent, g % s)

    lrank, lloc = to_local(left, lmiss)
    rrank, rloc = to_local(right, rmiss)
    return (lrank, lloc, lv), (rrank, rloc, rv)
