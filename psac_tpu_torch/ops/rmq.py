"""In-device range-minimum queries (port of ``psac_tpu/ops/rmq.py``: the
``with_small=False`` mode of ``LocalRMQ`` and the leftmost-argmin
``ArgLocalRMQ``).

A doubling table over fixed-size block minima answers the interior full
blocks of a query; the two edge blocks are answered by masked reads of
whole block rows.

K6, the LCP resolve (the chunk body of the JAX package's
``_Builder._resolve_fused_local``), lives here too: ``rmq_resolve`` is a
hand-written CUDA kernel (``psac_tpu_torch/csrc/rmq_resolve.cu``) with the
JAX chunk loop in torch beside it as its plain version.  Its second entry,
``rmq_mins``, answers range minima alone: the owner's part of a routed
query on a mesh (``parallel/par_rmq.py``), with ``query_local_rmq`` as its
plain version.  Given CPU tensors a wrapper runs the plain version; given
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from psac_tpu_torch.ops import cuda_lib


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


# ---------------------------------------------------------------------------
# K6: the LCP resolve (decode, range minimum, write back)
# ---------------------------------------------------------------------------

#: how a resolve packs (row, j) into its sort key: ``narrow`` =
#: ((wide ? s : 0) + row) * Lm + (j - 1), a class bit above the row so that
#: ranges under 8 wide sort first; ``packed`` = row * Lm + (j - 1);
#: ``rows`` = the row itself, j in a tensor of its own (or 1 throughout)
PACKINGS = ("narrow", "packed", "rows")


def rmq_resolve_plain(rmq: LocalRMQ, ks, ls, rs, js, d: int, *, Lm: int,
                      packing: str, nq: int,
                      m_pad: int | None = None) -> torch.Tensor:
    """Plain version of K6: the JAX chunk loop.

    ``rmq`` is the table of the PRE-resolve LCP ``rmq.x`` (s,); ``ks``,
    ``ls``, ``rs`` (and ``js`` for ``rows`` with Lm > 1, else None) are (m,)
    query buffers in the LCP's dtype: key (INF = no query), inclusive range
    [ls, rs].  For each valid query among the first ``nq`` slots the new
    LCP takes ``j * d + min(LCP[ls..rs])`` at its row; every other row keeps
    its value.  Returns the new (s,) LCP.

    The queries are answered in chunks of ``m_pad`` (default: all slots at
    once); the last chunk's start is clamped to m - m_pad (as
    ``lax.dynamic_slice`` clamps), its repeated rows rewrite identical
    values.  With ``narrow`` the valid keys are sorted, ranges under 8 wide
    (keys below s * Lm) before the others: a chunk without a wide one reads
    two 8-wide rows per query instead of the table."""
    lcp = rmq.x
    s = lcp.shape[0]
    m = ks.shape[0]
    m_pad = min(m_pad or m, m)
    inf = _inf(lcp.dtype)
    narrow = packing == "narrow"
    n_narrow = int((ks[:nq] < s * Lm).sum()) if narrow else 0
    lcp_pad = torch.cat([lcp, lcp.new_zeros(1)])
    c = 0
    while c * m_pad < nq:
        off = min(c * m_pad, m - m_pad)
        sl = slice(off, off + m_pad)
        kq_c, l_c, r_c = ks[sl], ls[sl], rs[sl]
        valid = kq_c != inf
        if packing == "rows":
            row_loc = torch.where(valid, kq_c, 0)
            j_c = js[sl] if js is not None else torch.ones_like(kq_c)
        else:
            kdec = torch.where(valid, kq_c, 0)
            if narrow:
                kdec = torch.where(kdec >= s * Lm, kdec - s * Lm, kdec)
            row_loc = (kdec // Lm).clamp(0, s - 1)
            j_c = kdec - row_loc * Lm + 1
        lo = torch.where(valid, l_c, 0).clamp(0, s - 1)
        hi = torch.where(valid, torch.maximum(r_c, l_c), 0).clamp(0, s - 1)
        has_wide = max(off, n_narrow) < min(off + m_pad, nq)
        if narrow and not has_wide:
            mins = edge_mins(lcp, 8, lo, hi)
        else:
            mins = query_local_rmq(rmq, lo, hi)
        row = torch.where(valid, row_loc, s)
        lcp_pad[row] = torch.where(valid, j_c * d + mins, 0)
        c += 1
    return lcp_pad[:s]


def rmq_resolve(rmq: LocalRMQ, ks, ls, rs, js, d: int, *, Lm: int,
                packing: str, nq: int,
                m_pad: int | None = None) -> torch.Tensor:
    """K6 (replaces the chunk body of
    ``psac_tpu/models/suffix_array.py::_Builder._resolve_fused_local``): see
    ``rmq_resolve_plain`` for the contract.  The kernel takes all ``nq``
    slots in one launch and picks the tier per query; ``m_pad`` is read
    for CPU tensors only, as the plain version's chunk.  ``launches`` counts
    the kernel's launches: a resolve without a slot launches nothing."""
    lcp = rmq.x
    if lcp.device.type == "cpu":
        return rmq_resolve_plain(rmq, ks, ls, rs, js, d, Lm=Lm,
                                 packing=packing, nq=nq, m_pad=m_pad)
    if lcp.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rmq_resolve: expected int32 or int64, got "
                         f"{lcp.dtype}")
    if packing not in PACKINGS:
        raise ValueError(f"rmq_resolve: unknown packing {packing!r}")
    queries = (ks, ls, rs) + (() if js is None else (js,))
    cuda_lib.check_cuda("rmq_resolve", lcp.dtype, *queries)
    cuda_lib.check_cuda("rmq_resolve", lcp.dtype, lcp)
    table = rmq.table
    s, block = lcp.shape[0], rmq.block
    if ks.device != lcp.device:
        raise ValueError("rmq_resolve: expected CUDA tensors on one device")
    if table.dtype != lcp.dtype or table.device != lcp.device or \
            not table.is_contiguous() or table.shape[1] * block != s:
        raise ValueError("rmq_resolve: the table is not this LCP's")
    if block & (block - 1):
        raise ValueError(f"rmq_resolve: block {block} is not a power of two")
    if not 0 <= nq <= ks.shape[0] or Lm < 1:
        raise ValueError(f"rmq_resolve: nq {nq} of {ks.shape[0]}, Lm {Lm}")
    out = lcp.clone()
    if nq == 0:
        return out
    name = "psac_rmq_resolve_i32" if lcp.dtype == torch.int32 else \
        "psac_rmq_resolve_i64"
    cuda_lib.launch(name, lcp.data_ptr(), table.data_ptr(), ks.data_ptr(),
                    ls.data_ptr(), rs.data_ptr(),
                    None if js is None else js.data_ptr(), out.data_ptr(),
                    s, table.shape[1], block, nq, Lm,
                    PACKINGS.index(packing), d, device=lcp.device)
    cuda_lib.count_launch(rmq_resolve)
    return out


rmq_resolve.launches = 0


def rmq_mins_plain(rmq: LocalRMQ, lo, hi, valid) -> torch.Tensor:
    """Plain version of K6's min-only entry: ``query_local_rmq`` over the
    inclusive ranges [lo, max(lo, hi)] clamped into [0, s), INF where
    ``valid`` is False.  ``lo`` / ``hi`` are (m,) tensors, ``valid`` (m,)
    bool; returns (m,) minima in the values' dtype."""
    s = rmq.x.shape[0]
    lo2 = torch.where(valid, lo, 0).clamp(0, s - 1)
    hi2 = torch.where(valid, torch.maximum(hi, lo), 0).clamp(0, s - 1)
    return torch.where(valid, query_local_rmq(rmq, lo2, hi2),
                       _inf(rmq.x.dtype))


def rmq_mins(rmq: LocalRMQ, lo, hi, valid) -> torch.Tensor:
    """K6's min-only entry (replaces the owner's ``query_local_rmq`` of
    ``psac_tpu/parallel/par_rmq.py::bulk_rmq_local``): see
    ``rmq_mins_plain`` for the contract; ``lo`` and ``hi`` in the values'
    dtype.  CPU tensors take the plain version.  ``launches`` counts the
    kernel's launches: a call with no valid query launches nothing."""
    x = rmq.x
    if x.device.type == "cpu":
        return rmq_mins_plain(rmq, lo, hi, valid)
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rmq_mins: expected int32 or int64, got {x.dtype}")
    cuda_lib.check_cuda("rmq_mins", x.dtype, lo, hi)
    cuda_lib.check_cuda("rmq_mins", x.dtype, x)
    cuda_lib.check_cuda("rmq_mins", torch.bool, valid)
    table, block, s = rmq.table, rmq.block, x.shape[0]
    if lo.device != x.device or valid.device != x.device or \
            valid.shape != lo.shape:
        raise ValueError("rmq_mins: expected CUDA tensors on one device")
    if table.dtype != x.dtype or table.device != x.device or \
            not table.is_contiguous() or table.shape[1] * block != s or \
            block & (block - 1):
        raise ValueError("rmq_mins: the table is not these values'")
    out = torch.full_like(lo, _inf(x.dtype))
    if not bool(valid.any()):
        return out
    rmq_mins_launch(rmq, lo, hi, valid, out)
    cuda_lib.count_launch(rmq_mins)
    return out


rmq_mins.launches = 0


def rmq_mins_launch(rmq: LocalRMQ, lo, hi, valid, out) -> None:
    """The launch of ``rmq_mins`` alone, on tensors it has checked: the
    minima into ``out`` (m,), INF where not valid."""
    name = "psac_rmq_mins_i32" if rmq.x.dtype == torch.int32 else \
        "psac_rmq_mins_i64"
    cuda_lib.launch(name, rmq.x.data_ptr(), rmq.table.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), valid.data_ptr(),
                    out.data_ptr(), rmq.x.shape[0], rmq.table.shape[1],
                    rmq.block, lo.shape[0], device=lo.device)


# ---------------------------------------------------------------------------
# argmin-carrying variant (leftmost index of the minimum)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArgLocalRMQ:
    """RMQ returning the leftmost argmin index (what the DESA's blind
    search needs): a doubling table over block minima, values ``tab_v`` and
    leftmost argmins ``tab_a``; edge blocks are read per query."""

    x: torch.Tensor
    tab_v: torch.Tensor   # (L, nb) block-min doubling table values
    tab_a: torch.Tensor   # (L, nb) leftmost argmin (int32 index into x)
    block: int

    @property
    def nb(self) -> int:
        return self.tab_v.shape[1]


def _argmin_op(a, b):
    """Leftmost-min combine of (value, index) pairs: ties break on the
    smaller index, so operand order never matters."""
    av, ai = a
    bv, bi = b
    take_b = (bv < av) | ((bv == av) & (bi < ai))
    return torch.where(take_b, bv, av), torch.where(take_b, bi, ai)


def build_arg_rmq(x: torch.Tensor, block: int | None = None) -> ArgLocalRMQ:
    """One block-argmin reduce and a doubling table over the block minima."""
    s = x.shape[0]
    inf = _inf(x.dtype)
    block = block or block_size_for(s)
    nb = s // block
    xb = x.view(nb, block)
    rows_v = [xb.amin(dim=1)]
    rows_a = [(torch.arange(nb, dtype=torch.int32, device=x.device) * block
               + xb.argmin(dim=1).to(torch.int32))]
    for j in range(1, max(1, nb.bit_length())):
        w = 1 << (j - 1)
        pv, pa = rows_v[-1], rows_a[-1]
        if w >= nb:
            rows_v.append(pv)
            rows_a.append(pa)
            continue
        sv = torch.cat([pv[w:], pv.new_full((w,), inf)])
        sa = torch.cat([pa[w:], pa.new_zeros(w)])
        v, a = _argmin_op((pv, pa), (sv, sa))
        rows_v.append(v)
        rows_a.append(a)
    return ArgLocalRMQ(x=x, tab_v=torch.stack(rows_v),
                       tab_a=torch.stack(rows_a), block=block)


def query_arg_rmq(rmq: ArgLocalRMQ, lo: torch.Tensor, hi: torch.Tensor):
    """Leftmost argmin index over inclusive ranges [lo, hi],
    0 <= lo <= hi < s; returns int32 indices."""
    block, nb = rmq.block, rmq.nb
    inf = _inf(rmq.x.dtype)
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    bl = lo // block
    bh = hi // block
    xb = rmq.x.view(nb, block)
    offs = torch.arange(block, device=lo.device)[None, :]
    lo_off = (lo - bl * block)[:, None]
    hi_off = (hi - bh * block)[:, None]
    same = (bl == bh)[:, None]
    lmask = (offs >= lo_off) & (~same | (offs <= hi_off))
    rmask = (offs <= hi_off) & (~same | (offs >= lo_off))
    lwm = torch.where(lmask, xb[bl], inf)
    rwm = torch.where(rmask, xb[bh], inf)
    # argmin returns the first minimal index: leftmost by construction
    left = (lwm.amin(dim=1), bl * block + lwm.argmin(dim=1))
    right = (rwm.amin(dim=1), bh * block + rwm.argmin(dim=1))
    # interior full blocks (bl, bh) exclusive
    a = bl + 1
    b = bh - 1
    length = b - a + 1
    lev = _floor_log2(length)
    flat_v = rmq.tab_v.reshape(-1)
    flat_a = rmq.tab_a.reshape(-1).to(torch.int64)
    last = flat_v.shape[0] - 1
    i1 = (lev * nb + a).clamp(0, last)
    i2 = (lev * nb + b - (1 << lev) + 1).clamp(0, last)
    t1 = (torch.where(length > 0, flat_v[i1], inf), flat_a[i1])
    t2 = (torch.where(length > 0, flat_v[i2], inf), flat_a[i2])
    cand = _argmin_op(left, t1)
    cand = _argmin_op(cand, t2)
    cand = _argmin_op(cand, right)
    return cand[1].to(torch.int32)
