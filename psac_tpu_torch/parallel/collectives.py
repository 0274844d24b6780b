"""The mesh collectives (port of ``psac_tpu/parallel/collectives.py``).

Each function works on one shard's local block inside ``Mesh.run``; its
``ctx`` (``parallel.mesh.Ctx``) carries the rank and the exchanges.  With
``ctx=None`` (or a mesh of one shard) there is no neighbour: halos are pure
fill, the global prefix-max is a local scan, and the doubling shift is a
slice with zero fill.  Shift distances are host integers (the construction
loops run on the host), so the shard distance q = d // s is known before
any exchange and the JAX package's traced-distance ladder
(``global_shift_left_dyn``'s p > 1 branch) has no counterpart.
"""

from __future__ import annotations

import torch


def _multi(ctx) -> bool:
    return ctx is not None and ctx.p > 1


def _perm_shift(p: int, dist: int) -> list:
    """ppermute pairs moving data from shard i+dist to shard i (no
    wraparound)."""
    if dist >= 0:
        return [(i + dist, i) for i in range(p - dist)]
    return [(i + dist, i) for i in range(-dist, p)]


def halo_from_right(x: torch.Tensor, count: int, fill=0,
                    ctx=None) -> torch.Tensor:
    """The ``count`` elements right of this shard's block, ``fill`` past
    the global end; ``count`` may exceed the block (whole blocks from
    several neighbours: tiny inputs, large k).  The k-mer halo
    ``mxx::left_shift`` of reference ``include/kmer.hpp:142``."""
    if not _multi(ctx):
        return torch.full((count,), fill, dtype=x.dtype, device=x.device)
    s, p = x.shape[0], ctx.p
    if count <= s:
        got = ctx.ppermute(x[:count], _perm_shift(p, 1))
    else:
        parts = [ctx.ppermute(x, _perm_shift(p, j)) if j < p
                 else torch.zeros_like(x)
                 for j in range(1, -(-count // s) + 1)]
        got = torch.cat(parts)[:count]
    if fill != 0:
        gpos = (ctx.rank + 1) * s + torch.arange(count, device=x.device)
        got = torch.where(gpos < p * s, got, fill)
    return got


def halo_from_left(x: torch.Tensor, count: int, fill=0,
                   ctx=None) -> torch.Tensor:
    """The last ``count`` elements of the left neighbour (``fill`` at
    shard 0): ``mxx::right_shift``, reference ``include/bucketing.hpp:151``."""
    if not _multi(ctx):
        return torch.full((count,), fill, dtype=x.dtype, device=x.device)
    got = ctx.ppermute(x[x.shape[0] - count:], _perm_shift(ctx.p, -1))
    return torch.full_like(got, fill) if ctx.rank == 0 else got


def left_halos(xs, fill, ctx=None) -> torch.Tensor:
    """The element before this shard's block of each of the (s,) arrays
    ``xs`` (one dtype), as one (len(xs),) tensor, ``fill`` at shard 0: one
    exchange for all of them."""
    if not _multi(ctx):
        return torch.full((len(xs),), fill, dtype=xs[0].dtype,
                          device=xs[0].device)
    return halo_from_left(torch.stack([x[-1] for x in xs]), len(xs), fill,
                          ctx)


def prev_of(x: torch.Tensor, fill=-1, ctx=None) -> torch.Tensor:
    """out[i] = x[i-1] over the global index space, ``fill`` at i = 0."""
    return torch.cat([halo_from_left(x, 1, fill, ctx), x[:-1]])


def next_of(x: torch.Tensor, fill, ctx=None) -> torch.Tensor:
    """out[i] = x[i+1] over the global index space, ``fill`` at the end."""
    return torch.cat([x[1:], halo_from_right(x, 1, fill, ctx)])


_CUMMAX_ROW = 1024


def _local_cummax(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    rows = -(-n // _CUMMAX_ROW)
    lowest = torch.iinfo(x.dtype).min
    xp = torch.cat([x, x.new_full((rows * _CUMMAX_ROW - n,), lowest)])
    part = torch.cummax(xp.view(rows, _CUMMAX_ROW), dim=1).values
    carry = torch.cummax(part[:, -1], dim=0).values
    carry = torch.cat([carry.new_full((1,), lowest), carry[:-1]])
    return torch.maximum(part, carry[:, None]).view(-1)[:n]


def global_cummax(x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Inclusive global prefix max (the segmented broadcast of rebucketing,
    reference ``include/bucketing.hpp:21-53``).  Locally a two-level blocked
    scan: ``torch.cummax`` over rows of 1024, then over the row maxima (one
    ``torch.cummax`` over a long 1-D CUDA tensor runs its scan on few
    threads: 58 ms at 2^26 on an H100, 69% of the SA+LCP device time); on a
    mesh, then the exclusive max-scan of the shards' last values."""
    local = _local_cummax(x)
    if not _multi(ctx):
        return local
    carry = exscan_scalar(local[-1], ctx, op="max",
                          init=torch.iinfo(x.dtype).min)
    return torch.maximum(local, carry)


def global_shift_left_dyn(x: torch.Tensor, d: int) -> torch.Tensor:
    """out[g] = x[g + d], 0 past the end (d >= 0), on one shard."""
    s = x.shape[0]
    if d >= s:
        return torch.zeros_like(x)
    return torch.cat([x[d:], torch.zeros(d, dtype=x.dtype, device=x.device)])


def global_shift_left(x: torch.Tensor, d: int, ctx=None) -> torch.Tensor:
    """out[g] = x[g + d] over the global index space, 0 past the end: the
    reference's doubling shift ``shift_vector``
    (``include/shifting.hpp:32-122``), at most two transfers from the
    shards q = d // s and q + 1 blocks to the right."""
    if not _multi(ctx):
        return global_shift_left_dyn(x, d)
    s, p = x.shape[0], ctx.p
    q = d // s
    if q >= p:
        return torch.zeros_like(x)
    r = d - q * s
    a = ctx.ppermute(x, _perm_shift(p, q)) if q > 0 else x
    b = ctx.ppermute(x, _perm_shift(p, q + 1)) if q + 1 < p \
        else torch.zeros_like(x)
    return torch.cat([a, b])[r:r + s]


def exscan_scalar(v: torch.Tensor, ctx, op: str = "add", init=0):
    """Exclusive scan of one 0-d tensor per shard across the mesh
    (``mxx::exscan``): the carry into this shard (0, or ``init`` for max
    and min, into the first shard and on one shard)."""
    if not _multi(ctx):
        return torch.tensor(0 if op == "add" else init, dtype=v.dtype,
                            device=v.device)
    all_v = ctx.all_gather(v)
    before = all_v[:ctx.rank]
    if op == "add":
        return before.sum(dtype=v.dtype)
    if before.shape[0] == 0:
        return torch.tensor(init, dtype=v.dtype, device=v.device)
    if op == "max":
        return before.amax()
    if op == "min":
        return before.amin()
    raise ValueError(op)


def psum(x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Sum of ``x`` over the shards (``x`` itself on one shard)."""
    return ctx.psum(x) if _multi(ctx) else x


def pmax(x: torch.Tensor, ctx=None) -> torch.Tensor:
    """Maximum of ``x`` over the shards (``x`` itself on one shard)."""
    return ctx.pmax(x) if _multi(ctx) else x


def global_index_base(s: int, ctx=None) -> int:
    """Global index of this shard's first element (a host int: no int32
    product can overflow)."""
    return 0 if ctx is None else ctx.rank * s


def shard_minima(x: torch.Tensor, ctx) -> torch.Tensor:
    """(p,) minima of every shard (replicated), par_rmq's per-processor
    minima."""
    return ctx.all_gather(x.amin())


def reshard_prefix(x: torch.Tensor, m: int, ctx) -> torch.Tensor:
    """The first ``m`` elements of a block-distributed array (m a multiple
    of p), block-distributed anew: this shard's (m // p,) part.  One
    all-to-all; a source block sends each destination the part of it that
    the destination holds (at most m // p elements), at the head of its
    row, and the destination knows from the ranks where each part goes."""
    s, p, r = x.shape[0], ctx.p, ctx.rank
    sl = m // p
    buf = x.new_zeros((p, sl) + x.shape[1:])
    for t in range(p):
        lo, hi = max(r * s, t * sl), min((r + 1) * s, (t + 1) * sl)
        if lo < hi:
            buf[t, :hi - lo] = x[lo - r * s:hi - r * s]
    recv = ctx.all_to_all(buf)
    out = x.new_zeros((sl,) + x.shape[1:])
    for j in range(p):
        lo, hi = max(j * s, r * sl), min((j + 1) * s, (r + 1) * sl)
        if lo < hi:
            out[lo - r * sl:hi - r * sl] = recv[j, :hi - lo]
    return out
