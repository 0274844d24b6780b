"""Distributed bulk range-minimum queries (port of
``psac_tpu/parallel/par_rmq.py``; the reference's ``bulk_rmq_v2``,
``include/par_rmq.hpp:199-332``).

Each shard issues q global inclusive ranges [l, r] over a block-distributed
array.  Every query is shipped to shard(l): a same-shard query is answered
there whole; a crossing one gets min(the part in shard(l), the shards
strictly between, from the replicated shard minima).  A crossing query is
also shipped to shard(r) for the part there, and the issuer takes the
minimum of the two partials.  Two ``route_apply`` round trips; the owner
answers its parts with K6's min-only entry (``ops.rmq.rmq_mins``: the
kernel on CUDA tensors, ``query_local_rmq`` on CPU ones).
"""

from __future__ import annotations

import torch

from psac_tpu_torch.ops.rmq import LocalRMQ, rmq_mins
from psac_tpu_torch.parallel.route import route_apply


def bulk_rmq_local(rmq: LocalRMQ, shard_mins: torch.Tensor, l, r, valid,
                   ctx, cap: int | None = None,
                   with_overflow: bool = False):
    """Minima over global ranges [l, r] (inclusive, l <= r where valid):
    (q,) queries per shard, ``rmq`` over this shard's (s,) block,
    ``shard_mins`` the (p,) replicated block minima.  ``cap`` bounds the
    routing buffers per destination (``route_apply``; invalid queries use
    no capacity).  Returns (q,) minima, INF where not valid; with
    ``with_overflow`` also the psum'd count of dropped queries."""
    x = rmq.x
    s, p = x.shape[0], ctx.p
    inf = torch.iinfo(x.dtype).max
    l = torch.where(valid, l, 0)
    r = torch.where(valid, r, 0)
    shard_l = (l // s).to(torch.int32)
    shard_r = (r // s).to(torch.int32)
    cross = shard_l != shard_r
    base = ctx.rank * s
    sh = torch.arange(p, dtype=torch.int32, device=x.device)[None, :]

    def answer_left(recv, recv_valid):
        rl, rr = recv
        ql = (rl // s).to(torch.int32)
        qr = (rr // s).to(torch.int32)
        lo = (rl - base).clamp(0, s - 1).to(x.dtype)
        hi = torch.where(ql != qr, s - 1,
                         (rr - base).clamp(0, s - 1)).to(x.dtype)
        part = rmq_mins(rmq, lo, hi, recv_valid)
        # the shards strictly between, from the replicated minima
        mid_mask = (sh > ql[:, None]) & (sh < qr[:, None])
        mid = torch.where(mid_mask, shard_mins[None, :], inf).amin(dim=1)
        ans = torch.where(ql != qr, torch.minimum(part, mid), part)
        return (torch.where(recv_valid, ans, inf),)

    (left,), ovf_l = route_apply((l, r), answer_left, ~valid, dest=shard_l,
                                 ctx=ctx, cap=cap, with_overflow=True)

    def answer_right(recv, recv_valid):
        (rr,) = recv
        hi = (rr - base).clamp(0, s - 1).to(x.dtype)
        return (rmq_mins(rmq, torch.zeros_like(hi), hi, recv_valid),)

    (right,), ovf_r = route_apply((r,), answer_right, ~(valid & cross),
                                  dest=shard_r, ctx=ctx, cap=cap,
                                  with_overflow=True)
    # skipped or dropped answers come back as 0, which would win the min
    right = torch.where(cross, right, inf)
    out = torch.where(valid, torch.minimum(left, right), inf)
    if with_overflow:
        return out, ovf_l + ovf_r
    return out
