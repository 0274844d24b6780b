"""Capacity-padded record routing (port of ``psac_tpu/parallel/route.py``,
the ragged ``all2allv`` / ``bulk_rma`` replacement of the reference,
``include/bulk_rma.hpp:13-135``).

Each shard buckets its m records by destination shard into a (p, cap)
buffer, one ``all_to_all`` ships them, the owner answers, and the reverse
exchange brings the answers back.  ``cap`` is the per-destination send
capacity: records beyond it are dropped (answers fill with zeros) and
counted in a psum'd overflow count (``with_overflow``), so the host can
retry with a larger capacity (``cap_for``).  ``cap=None`` never overflows:
it routes in p chunks of cap = ceil(m / p) each, bounding the exchange
buffers at O(m) instead of the one-shot O(p*m).

With one shard (``ctx=None``) every record is already at its owner:
``route_apply`` is a local call of the answer function, and
``route_scatter`` an indexed write (or, with ``combine``, a reducing
scatter).  Records that are not routed land on one extra drop slot (JAX
drops out-of-range scatter indices; torch raises, hence the explicit slot).
"""

from __future__ import annotations

import torch


def _multi(ctx) -> bool:
    return ctx is not None and ctx.p > 1


def cap_for(m: int, p: int, capscale: int | None) -> int | None:
    """Per-destination send capacity for about balanced destinations:
    capscale * ceil(m / p) + 64, or None (cap = m, never overflows) when
    ``capscale`` is None or at least p."""
    if capscale is None or capscale >= p:
        return None
    return min(m, capscale * (-(-m // p)) + 64)


def _bucket_by_dest(dest: torch.Tensor, p: int, cap: int, skip=None):
    """Stable buckets of the records by destination shard.

    Returns (order, dropped, ovf, flat_pos): record ``order[t]`` goes to
    flat buffer position ``flat_pos[t] = dest_sorted[t] * cap + slot[t]``.
    Records with ``skip`` sort last and take the drop slot p * cap without
    using capacity; records whose slot reaches ``cap`` overflow (dropped and
    counted)."""
    m = dest.shape[0]
    dkey = dest.to(torch.int32)
    if skip is not None:
        dkey = torch.where(skip, p, dkey)
    dsort, order = torch.sort(dkey, stable=True)
    i = torch.arange(m, dtype=torch.int32, device=dest.device)
    is_start = torch.ones(m, dtype=torch.bool, device=dest.device)
    is_start[1:] = dsort[1:] != dsort[:-1]
    start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    slot = i - start
    skipped = dsort >= p
    ovf = (slot >= cap) & ~skipped
    dropped = ovf | skipped
    # the flat index reaches p*cap: int64 beyond int32 (huge int64 builds)
    fdt = torch.int32 if p * cap < (1 << 31) else torch.int64
    flat_pos = torch.where(dropped, p * cap,
                           dsort.to(fdt) * cap + slot.to(fdt)).to(fdt)
    return order, dropped, ovf, flat_pos


def _to_buf(x: torch.Tensor, order, flat_pos, buf_len: int, fill=0):
    buf = x.new_full((buf_len + 1,) + x.shape[1:], fill)
    buf[flat_pos.long()] = x[order]
    return buf[:buf_len]


def _exchange(xs: tuple, cap: int, ctx) -> tuple:
    """One all-to-all of (p * cap, ...) buffers, all together."""
    p = ctx.p
    out = ctx.all_to_all(tuple(x.reshape((p, cap) + x.shape[1:]) for x in xs))
    return tuple(o.reshape((p * cap,) + o.shape[2:]) for o in out)


def route_apply(payloads: tuple, answer_fn, skip=None, *, dest=None,
                ctx=None, cap: int | None = None,
                with_overflow: bool = False):
    """Ship each record to shard ``dest`` (int, in [0, p)), apply
    ``answer_fn(received_payloads, valid)`` at the owner, and return its
    answers aligned with the records (zeros where skipped or dropped).

    ``payloads`` are (m, ...) local tensors; ``skip`` (m,) bool marks the
    records resolved by the caller (not routed, no capacity, zero answers);
    ``answer_fn`` returns a tuple of (rows, ...) answers.  With
    ``with_overflow`` also returns the psum'd count of dropped records (a
    0-d tensor; the int 0 on one shard, where nothing is dropped).  Without
    ``ctx`` (one shard) the answer function runs on the records as they
    are, ``valid`` False where ``skip`` holds."""
    m = payloads[0].shape[0]
    if not _multi(ctx):
        valid = torch.ones(m, dtype=torch.bool, device=payloads[0].device) \
            if skip is None else ~skip
        outs = answer_fn(tuple(payloads), valid)
        return (outs, 0) if with_overflow else outs
    p = ctx.p
    if cap is None and m > p:
        return _route_apply_chunked(payloads, dest, answer_fn, ctx, skip,
                                    with_overflow)
    cap = min(m if cap is None else cap, m)
    order, dropped, ovf, flat_pos = _bucket_by_dest(dest, p, cap, skip)
    buf_len = p * cap
    sent = tuple(_to_buf(x, order, flat_pos, buf_len) for x in payloads)
    sent_valid = _to_buf(torch.ones(m, dtype=torch.bool, device=dest.device),
                         order, flat_pos, buf_len, False)
    *recv, recv_valid = _exchange(sent + (sent_valid,), cap, ctx)
    answers = answer_fn(tuple(recv), recv_valid)
    back = _exchange(tuple(answers), cap, ctx)
    # un-bucket: the answer of record order[t] sits at flat_pos[t]
    safe_pos = flat_pos.clamp(max=buf_len - 1).long()
    outs = []
    for a in back:
        picked = a[safe_pos]
        mask = dropped if picked.dim() == 1 else \
            dropped.view((-1,) + (1,) * (picked.dim() - 1))
        picked = torch.where(mask, torch.zeros_like(picked), picked)
        out = torch.zeros((m,) + a.shape[1:], dtype=a.dtype, device=a.device)
        out[order] = picked
        outs.append(out)
    if with_overflow:
        return tuple(outs), ctx.psum(ovf.sum(dtype=torch.int32))
    return tuple(outs)


def _chunks(m: int, p: int):
    """(slice, padding) of each of p chunks of ceil(m / p) records (the
    last ones short or empty)."""
    chunk = -(-m // p)
    for c in range(p):
        sl = slice(min(c * chunk, m), min((c + 1) * chunk, m))
        yield sl, chunk - (sl.stop - sl.start)


def _chunk(x: torch.Tensor, sl: slice, pad: int, fill=0) -> torch.Tensor:
    """x[sl] followed by ``pad`` rows of ``fill``."""
    x = x[sl]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])


#: Shape of the most recent chunked full-capacity pass:
#: {"chunk": int, "buf_rows": int, "m": int}.
LAST_CHUNKED_ROUTE: dict = {}


def _route_apply_chunked(payloads: tuple, dest, answer_fn, ctx, skip,
                         with_overflow: bool):
    """The never-overflowing routing as p sequential passes over record
    chunks of ceil(m / p), each exchanged at cap = chunk (a chunk cannot
    exceed its own size at any destination): the reference's all2allv
    moves O(m) (``include/bulk_rma.hpp:112-135``), and so does this."""
    p = ctx.p
    m = dest.shape[0]
    chunk = -(-m // p)
    skip_all = torch.zeros(m, dtype=torch.bool, device=dest.device) \
        if skip is None else skip
    parts = []
    for sl, pad in _chunks(m, p):
        outs = route_apply(tuple(_chunk(x, sl, pad) for x in payloads),
                           answer_fn, _chunk(skip_all, sl, pad, True),
                           dest=_chunk(dest, sl, pad), ctx=ctx, cap=chunk)
        parts.append(tuple(o[:sl.stop - sl.start] for o in outs))
    outs = tuple(torch.cat([pt[i] for pt in parts])
                 for i in range(len(parts[0])))
    LAST_CHUNKED_ROUTE.update(chunk=chunk, buf_rows=p * chunk, m=m)
    if with_overflow:
        return outs, torch.zeros((), dtype=torch.int32, device=dest.device)
    return outs


def gather_global(arr: torch.Tensor, idx: torch.Tensor, valid, *,
                  ctx=None, cap: int | None = None,
                  with_overflow: bool = False):
    """arr[idx] where ``valid``, 0 elsewhere, for global indices ``idx``
    into the block-distributed ``arr`` (this shard's (s,) block): each
    valid index is routed to the shard that holds it (``route_apply``;
    ``cap`` / ``with_overflow`` as there); on one shard an indexed read."""
    s = arr.shape[0]
    p = ctx.p if _multi(ctx) else 1
    safe = torch.where(valid, idx, 0).clamp(0, s * p - 1)
    if p == 1:
        out = torch.where(valid, arr[safe], 0)
        return (out, 0) if with_overflow else out
    base = ctx.rank * s

    def answer(recv, recv_valid):
        (q,) = recv
        return (arr[(q - base).clamp(0, s - 1)],)

    res = route_apply((safe,), answer, ~valid, dest=safe // s, ctx=ctx,
                      cap=cap, with_overflow=with_overflow)
    (out,), ovf = res if with_overflow else (res, 0)
    out = torch.where(valid, out, 0)
    return (out, ovf) if with_overflow else out


def _route_scatter_chunked(dest_idx, values, targets, valid, width, slots,
                           combine, ctx, with_overflow: bool):
    """``route_scatter`` without a bound as p passes over record chunks of
    ceil(m / p), each at cap = chunk (which no chunk can exceed), each
    writing into the targets the last one left: the places of a "set" are
    distinct, and "min" / "max" merge with what is there."""
    p = ctx.p
    m = dest_idx.shape[0]
    outs = tuple(targets)
    for sl, pad in _chunks(m, p):
        outs = route_scatter(
            _chunk(dest_idx, sl, pad),
            tuple(_chunk(v, sl, pad) for v in values), outs,
            _chunk(valid, sl, pad, False), width,
            None if slots is None else _chunk(slots, sl, pad), combine,
            ctx=ctx, cap=-(-m // p))
    if with_overflow:
        return outs, torch.zeros((), dtype=torch.int32,
                                 device=dest_idx.device)
    return outs


_REDUCE = {"min": "amin", "max": "amax"}


def _write(tgt: torch.Tensor, loc: torch.Tensor, v: torch.Tensor,
           how: str) -> torch.Tensor:
    """tgt with v written at loc (loc == len(tgt) drops), a new tensor."""
    padded = torch.cat([tgt, tgt.new_zeros(1)])
    if how == "set":
        padded[loc] = v.to(tgt.dtype)
    elif how in _REDUCE:
        padded.scatter_reduce_(0, loc, v.to(tgt.dtype), _REDUCE[how],
                               include_self=True)
    else:
        raise ValueError(how)
    return padded[:tgt.shape[0]]


def route_scatter(dest_idx, values: tuple, targets: tuple, valid,
                  width: int = 1, slots=None,
                  combine: tuple | None = None, *, ctx=None,
                  cap: int | None = None, with_overflow: bool = False):
    """targets[k][dest_idx[j] * width + slots[j]] = values[k][j] where
    ``valid``, at the shard that owns row ``dest_idx[j]``; returns new
    target tensors (inputs are left untouched).

    ``dest_idx`` are global row indices (N = s * p rows; each target holds
    its shard's s * width entries, row-major).  ``combine`` selects per
    target how records that meet in one place are merged, with each other
    and with the value already there: ``"set"`` (the default; the places
    must then be distinct, since an indexed write with repeated indices is
    unordered on CUDA), ``"min"`` or ``"max"`` (a reducing scatter: the
    GST's ``$``-edge child ranges).  ``cap`` / ``with_overflow`` as in
    ``route_apply``, ``cap=None`` as there in p chunks of ceil(m / p)
    (buffers O(m), not O(p*m)); routing by (row, slot) keeps every shipped
    index within the row dtype (the flat global index N * width never
    exists)."""
    combine = combine or ("set",) * len(targets)
    tgt_len = targets[0].shape[0]
    s = tgt_len // width
    if not _multi(ctx):
        loc = dest_idx.to(torch.int64)
        if width > 1:
            loc = loc * width + slots.to(torch.int64)
        loc = torch.where(valid, loc, tgt_len)
        outs = tuple(_write(t, loc, v, how)
                     for t, v, how in zip(targets, values, combine))
        return (outs, 0) if with_overflow else outs
    p = ctx.p
    m = dest_idx.shape[0]
    if cap is None and m > p:
        return _route_scatter_chunked(dest_idx, values, targets, valid,
                                      width, slots, combine, ctx,
                                      with_overflow)
    safe_idx = torch.where(valid, dest_idx, 0)
    cap = min(m if cap is None else cap, m)
    dest = (safe_idx // s).to(torch.int32)
    # invalid records are never routed (they use no capacity)
    order, dropped, ovf, flat_pos = _bucket_by_dest(dest, p, cap, ~valid)
    buf_len = p * cap
    sent = (_to_buf(safe_idx, order, flat_pos, buf_len),) + tuple(
        _to_buf(v, order, flat_pos, buf_len) for v in values)
    if width > 1:
        sent += (_to_buf(slots, order, flat_pos, buf_len),)
    sent_valid = _to_buf(valid, order, flat_pos, buf_len, False)
    *recv, recv_valid = _exchange(sent + (sent_valid,), cap, ctx)
    loc = recv[0].to(torch.int64) - ctx.rank * s
    if width > 1:
        loc = loc * width + recv[-1].to(torch.int64)
    loc = torch.where(recv_valid, loc, tgt_len)
    vals = recv[1:-1] if width > 1 else recv[1:]
    outs = tuple(_write(t, loc, v, how)
                 for t, v, how in zip(targets, vals, combine))
    if with_overflow:
        return outs, ctx.psum(ovf.sum(dtype=torch.int32))
    return outs
