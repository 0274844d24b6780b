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

The bucketing (``_bucket_by_dest``) gives each record its buffer position
in record order, so a payload goes out with one scatter and its answers
come back with one gather.  On a card it is the hand-written kernel K12
(``psac_tpu_torch/csrc/route_bucket.cu``), a stable counting sort over the
p + 1 keys (p destinations and the skipped records) in three launches:
per-tile counts, one block's scan of them, the positions.  It replaces the
JAX package's stable argsort and 1-D cummax of the run starts
(``psac_tpu/parallel/route.py::_bucket_by_dest``), whose PyTorch twin ran
the cummax on few threads; its bound is 14 B a record (the keys and skip
flags read twice, the positions written once).  On the CPU
``_bucket_by_dest_plain`` computes the same positions.
"""

from __future__ import annotations

import torch

from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.utils import timers


def _multi(ctx) -> bool:
    return ctx is not None and ctx.p > 1


def cap_for(m: int, p: int, capscale: int | None) -> int | None:
    """Per-destination send capacity for about balanced destinations:
    capscale * ceil(m / p) + 64, or None (cap = m, never overflows) when
    ``capscale`` is None or at least p."""
    if capscale is None or capscale >= p:
        return None
    return min(m, capscale * (-(-m // p)) + 64)


#: K12's keys a launch takes: 8 warps x (p + 1) int64 offsets in 48 KB of
#: shared memory
MAX_KEYS = 768
_WARPS = 8  # K12's warps a block, each counting 1024 rows of its tile
_TILE = _WARPS * 1024


def _pos_dtype(p: int, cap: int) -> torch.dtype:
    # the flat index reaches p*cap: int64 beyond int32 (huge int64 builds)
    return torch.int32 if p * cap < (1 << 31) else torch.int64


def _bucket_by_dest_plain(dest: torch.Tensor, p: int, cap: int, skip=None):
    """Plain version of K12: (pos, ovf) as ``_bucket_by_dest`` gives them,
    from a stable sort of the keys and each key's first place among them
    (a bincount's exclusive prefix)."""
    m = dest.shape[0]
    key = dest.to(torch.int64)
    out = (key < 0) | (key >= p)
    if skip is not None:
        out |= skip
    key = torch.where(out, p, key)
    dsort, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=p + 1)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(m, device=dest.device) - first[dsort]
    flat = torch.where((dsort < p) & (slot < cap), dsort * cap + slot, p * cap)
    pos = torch.empty(m, dtype=_pos_dtype(p, cap), device=dest.device)
    pos[order] = flat.to(pos.dtype)
    ovf = (counts[:p] - cap).clamp(min=0).sum().to(torch.int32)
    return pos, ovf


def _bucket_by_dest(dest: torch.Tensor, p: int, cap: int, skip=None):
    """Stable buckets of the records by destination shard, K12.

    Returns (pos, ovf): record i goes to flat buffer position ``pos[i] =
    dest[i] * cap + slot``, its slot the count of the records before it
    with the same destination, so each destination keeps index order.
    Records with ``skip`` (or a destination outside [0, p)) take the drop
    slot p * cap without using capacity; records whose slot reaches ``cap``
    overflow: they take the drop slot too, and ``ovf`` (a 0-d int32
    tensor) counts them.  ``pos`` is int32, int64 where p * cap reaches
    2^31.  Given CUDA tensors it launches K12 or raises; given CPU tensors
    it runs ``_bucket_by_dest_plain``.  This is the JAX package's function
    of the same name (``psac_tpu/parallel/route.py::_bucket_by_dest``)
    with its (order, flat_pos) written as ``pos[order] = flat_pos``.

    K12 is a stable counting sort in three launches: each warp counts its
    1024 rows per key (``__match_any_sync``), one block scans the tiles'
    counts per key and writes ``ovf``, and each warp walks its rows again,
    a record's slot being its key's running count plus the lanes below it
    in its match group.  Bound: 14 B a record (the keys and skip flags
    read twice, the int32 positions written once)."""
    if dest.device.type == "cpu":
        return _bucket_by_dest_plain(dest, p, cap, skip)
    name = "route_bucket"
    if not 1 <= p < MAX_KEYS or cap < 0:
        raise ValueError(f"{name}: expected 1 <= p < {MAX_KEYS} and cap >= "
                         f"0, got p = {p}, cap = {cap}")
    dev = dest.device
    dest = dest.to(torch.int32).contiguous()
    if dest.dim() != 1:
        raise ValueError(f"{name}: expected 1-D destinations")
    if skip is not None:
        if skip.dtype != torch.bool or skip.shape != dest.shape \
                or skip.device != dev:
            raise ValueError(f"{name}: expected a bool skip mask of the "
                             "destinations' shape on their device")
        skip = skip.contiguous()
    m = dest.shape[0]
    tiles = -(-m // _TILE)
    wcount = torch.empty(tiles * _WARPS * (p + 1), dtype=torch.int32,
                         device=dev)
    tcount = torch.empty((p + 1) * tiles, dtype=torch.int64, device=dev)
    ovf = torch.empty((), dtype=torch.int32, device=dev)
    pos = torch.empty(m, dtype=_pos_dtype(p, cap), device=dev)
    wide = pos.dtype == torch.int64
    cuda_lib.launch(f"psac_route_bucket_{'i64' if wide else 'i32'}",
                    dest.data_ptr(),
                    None if skip is None else skip.data_ptr(), m, p, cap,
                    wcount.data_ptr(), tcount.data_ptr(), ovf.data_ptr(),
                    pos.data_ptr(), device=dev)
    cuda_lib.count_launch(_bucket_by_dest)
    timers.count("bucket_rows_on_card", m)
    return pos, ovf


_bucket_by_dest.launches = 0


def _to_buf(x: torch.Tensor, idx: torch.Tensor, buf_len: int, fill=0):
    """x written at the records' int64 buffer positions ``idx`` of a
    (buf_len, ...) buffer of ``fill`` (dropped records at buf_len, cut
    off)."""
    buf = x.new_full((buf_len + 1,) + x.shape[1:], fill)
    buf[idx] = x
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
    idx, ovf = _bucket_by_dest(dest, p, cap, skip)
    buf_len = p * cap
    idx = idx.long()
    sent = tuple(_to_buf(x, idx, buf_len) for x in payloads)
    sent_valid = _to_buf(torch.ones(m, dtype=torch.bool, device=dest.device),
                         idx, buf_len, False)
    *recv, recv_valid = _exchange(sent + (sent_valid,), cap, ctx)
    answers = answer_fn(tuple(recv), recv_valid)
    back = _exchange(tuple(answers), cap, ctx)
    # un-bucket: the answer of record i sits at pos[i]
    dropped = idx == buf_len
    idx = idx.clamp_(max=buf_len - 1)
    outs = []
    for a in back:
        picked = a[idx]
        mask = dropped if picked.dim() == 1 else \
            dropped.view((-1,) + (1,) * (picked.dim() - 1))
        outs.append(picked.masked_fill_(mask, 0))
    if with_overflow:
        return tuple(outs), ctx.psum(ovf)
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
    idx, ovf = _bucket_by_dest(dest, p, cap, ~valid)
    buf_len = p * cap
    idx = idx.long()
    sent = (_to_buf(safe_idx, idx, buf_len),) + tuple(
        _to_buf(v, idx, buf_len) for v in values)
    if width > 1:
        sent += (_to_buf(slots, idx, buf_len),)
    sent_valid = _to_buf(valid, idx, buf_len, False)
    *recv, recv_valid = _exchange(sent + (sent_valid,), cap, ctx)
    loc = recv[0].to(torch.int64) - ctx.rank * s
    if width > 1:
        loc = loc * width + recv[-1].to(torch.int64)
    loc = torch.where(recv_valid, loc, tgt_len)
    vals = recv[1:-1] if width > 1 else recv[1:]
    outs = tuple(_write(t, loc, v, how)
                 for t, v, how in zip(targets, vals, combine))
    if with_overflow:
        return outs, ctx.psum(ovf)
    return outs
