"""Suffix-array + LCP construction (port of
``psac_tpu/models/suffix_array.py``), on one device or on a mesh of p
shards.

k-mer initial ranking, then dense prefix-L-pling steps (sort by
(B, B@d, ..., B@(L-1)d, i), rebucket by prefix max, SA -> ISA un-permute)
with the LCP resolved per step by range-minimum queries (K6,
``ops.rmq.rmq_resolve``), then a sparse
"bucket chaising" tail over the compacted unfinished rows.  Two drivers
run these steps, as in the JAX package:

- the fused path (``fused=True``, the default): the JAX package's
  ``_Builder.fused_full`` program, whose ``lax.while_loop``s become host
  loops here that read one stacked scalar tensor back per step: dense
  L-pling at ``dense_factor`` until the active set fits N /
  ``fused_tail_div``, then a two-stage tail;
- the host-driven loop (``fused=False``, and where the fused dense loop
  stops at its iteration bound with work left): doubling steps (or the
  SA-only ``construct_arr<L>`` steps at ``factor``) until fewer than
  N * ``tail_threshold_frac`` elements are unfinished, then a one-stage
  tail at the power of two above that count.

On a mesh (``parallel.mesh``, p > 1) each step is one ``Mesh.run`` of the
same shard function that runs on one device: the shifts, halos, prefix
maxima and counters are collectives, the sorts distributed, the LCP
queries' global ranges answered by ``parallel.par_rmq.bulk_rmq_local``
(K6's min-only entry at the owner shards), the tail's gathers and scatters
routed; the host loop's resolve compacts its queries by a distributed sort
and retries with unbounded routing when capscale 6 overflows
(``resolve_with_retry``).  Both drivers stay in the caller's thread.

Conventions (as in the JAX package): bucket id = 1-based index of the
bucket's first SA row, 0 = shifted past the end; the padded text has
N = padded_size(n, p) chars, and the N - n all-sentinel padding suffixes
take SA rows [0, N - n) with their ranks fixed at init.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import threading

import numpy as np
import torch

from psac_tpu_torch import config as cfg_mod
from psac_tpu_torch.ops.alphabet import Alphabet, IntAlphabet
from psac_tpu_torch.ops.bitops import lcp_bitwise_words, pow2ceil
from psac_tpu_torch.ops.kmer import optimal_k, pack_kmers_local
from psac_tpu_torch.ops.rmq import build_local_rmq, rmq_resolve
from psac_tpu_torch.parallel.collectives import (global_cummax,
                                                 global_index_base,
                                                 global_shift_left,
                                                 halo_from_right, next_of,
                                                 prev_of, psum,
                                                 reshard_prefix, shard_minima)
from psac_tpu_torch.parallel.mesh import Rep, Sharded, padded_size, run_on
from psac_tpu_torch.parallel.par_rmq import bulk_rmq_local
from psac_tpu_torch.parallel.route import (cap_for, gather_global,
                                           route_scatter)
from psac_tpu_torch.parallel.sort import (dist_sort_local, lex_perm,
                                          scatter_by_index_local)
from psac_tpu_torch.parallel.staging import (stage_bytes_block,
                                             stage_file_block,
                                             staged_histogram)
from psac_tpu_torch.utils.timers import SectionTimer, timers_enabled


class _LastBuild(threading.local):
    """Diagnostics of this thread's most recent ``construct_device``:
    whether the fused path ran (``fused``) and how many host-driven loop
    iterations followed it (``host_iters``), with ``p``, ``n`` and ``N``."""

    def __init__(self):
        self.d: dict = {}

    def update(self, **kw):
        self.d.update(kw)

    def __getitem__(self, k):
        return self.d[k]

    def __setitem__(self, k, v):
        self.d[k] = v

    def __repr__(self):
        return repr(self.d)


LAST_BUILD = _LastBuild()


def fused_max_iters(N: int) -> int:
    """The fused path's bound on the iterations of each of its loops."""
    return max(4, int(N).bit_length() + 2)


@dataclasses.dataclass
class SuffixArray:
    """Finished artifact: SA (and optionally LCP) of the input text."""

    sa: np.ndarray
    lcp: np.ndarray | None
    alphabet: object
    n: int


def host_tensor(x) -> torch.Tensor:
    """A device tensor, or a ``Sharded`` array gathered, as a CPU tensor
    (raises for an array whose shards span processes, as the JAX
    ``device_get`` does: ``parallel.dist.process_allgather`` gathers
    it)."""
    return x.gather() if isinstance(x, Sharded) else x.cpu()


@dataclasses.dataclass
class DeviceSuffixArray:
    """Device-resident result.  ``sa``/``lcp``/``isa`` are (N,) padded: the
    first N - n SA rows are the all-sentinel padding suffixes.  ``lc`` is
    the (N,) int32 left-branching-character array when
    ``SAConfig.construct_lc`` was set.  On a mesh of p > 1 shards
    (``mesh``) each is a ``parallel.mesh.Sharded`` array, block-distributed
    as in the JAX package (nothing is gathered)."""

    sa: torch.Tensor
    lcp: torch.Tensor | None
    isa: torch.Tensor
    alphabet: object
    n: int
    N: int
    lc: torch.Tensor | None = None
    mesh: object = None

    @classmethod
    def from_numpy(cls, sa, lcp, isa, alphabet, n: int, N: int,
                   device, mesh=None) -> "DeviceSuffixArray":
        """Wrap padded (N,) host arrays (e.g. the JAX package's device
        arrays after ``jax.device_get``, in its index dtype) as a
        device-resident result, on ``device`` or sharded over ``mesh`` (on
        a mesh that spans processes, each keeps its own blocks of the
        arrays that every process holds)."""

        def put(a):
            if a is None:
                return None
            t = torch.from_numpy(np.array(a))
            return mesh.shard(t) if mesh is not None else t.to(device)

        return cls(sa=put(sa), lcp=put(lcp), isa=put(isa), alphabet=alphabet,
                   n=n, N=N, mesh=mesh)

    def materialize(self) -> SuffixArray:
        sa = host_tensor(self.sa)[self.N - self.n:].numpy().astype(np.int64)
        lcp = None
        if self.lcp is not None:
            lcp = host_tensor(self.lcp)[self.N - self.n:].numpy() \
                .astype(np.int64)
            if self.n > 0:
                lcp[0] = 0
        return SuffixArray(sa=sa, lcp=lcp, alphabet=self.alphabet, n=self.n)


def resolve_packing(s: int, Lm: int, inf: int) -> str:
    """The tightest of ``ops.rmq.PACKINGS`` whose keys fit below ``inf``
    for ``s`` rows and ``Lm`` columns: a class bit above the row key
    (``narrow``: ranges under 8 wide, which span at most two 8-wide rows,
    sort first), else row and column in one key (``packed``), else the
    column in a tensor of its own (``rows``)."""
    if s % 8 == 0 and inf // (2 * Lm) > s:
        return "narrow"
    if inf // Lm > s and Lm > 1:
        return "packed"
    return "rows"


def _read(*scalars) -> list[int]:
    """One device -> host readback of several 0-d tensors."""
    return [int(v) for v in torch.stack([s.to(torch.int64)
                                         for s in scalars]).tolist()]


class _Builder:
    """Geometry and construction steps of one build, on one device (s == N)
    or on the p shards of a mesh (the JAX package's ``_Builder`` under
    ``shard_map``).  Each step is one shard function ``_<step>(ctx, ...)``
    over a shard's (s,) blocks, which exchanges with the other shards
    through ``ctx`` (None on one device, where the collectives take their
    p = 1 forms) and returns its counters replicated (``Rep``).  The
    drivers (``_fused_drive``, ``host_loop``, ``resolve_with_retry``) run
    in the caller's thread and call each step through its ``_<step>_local``
    (``parallel.mesh.run_on``: a direct call on one device, one
    ``Mesh.run`` on a mesh).  One device has code of its own only where it
    has its own sort or kernel: the key sort (``lex_perm``) and the LCP
    resolve (K6, which a mesh replaces by ``bulk_rmq_local``)."""

    def __init__(self, N: int, ks: tuple[int, ...], bits: int,
                 with_lcp: bool, idt: torch.dtype, device, pack: bool = False,
                 mesh=None):
        self.N = N
        self.mesh = mesh
        self.p = 1 if mesh is None else mesh.p
        self.s = N // self.p
        self.ks, self.bits = tuple(ks), bits
        self.with_lcp = with_lcp
        self.idt = idt
        self.INF = torch.iinfo(idt).max
        self.device = device
        # pairs of int32 key columns in one int64 sort lane (int32 builds)
        self.pack = pack and idt == torch.int32

    def _run(self, fn, *args):
        return run_on(self.mesh, fn, *args)

    def _gidx(self, ctx=None, m: int | None = None) -> torch.Tensor:
        """Global indices of this shard's m (default s) rows."""
        m = self.s if m is None else m
        base = global_index_base(m, ctx)
        return torch.arange(base, base + m, dtype=self.idt,
                            device=self.device if ctx is None else ctx.device)

    def _sort_keys(self, ctx, cols, gidx, payload: tuple = ()):
        """Sort rows by (cols..., gidx), carrying ``payload`` along.
        Returns (sorted cols, sa, sorted payload).  On one device gidx is
        the row index, so a stable lexicographic sort of the cols keeps
        equal-key rows in gidx order; on a mesh the distributed sort takes
        gidx as its last key.

        Packed-key mode (``pack``, sorts of at least 6 columns counting
        gidx): pairs of the 31-bit nonnegative key columns, gidx last, ride
        one int64 lane each (a trailing odd column stays int32), so the
        sort takes one stable pass per lane instead of one per column; the
        order is the same."""
        cols = tuple(cols)
        seq = cols + (gidx,)
        odd = len(seq) % 2
        packed = self.pack and len(seq) >= 6
        if packed:
            i64 = torch.int64
            lanes = tuple((seq[k].to(i64) << 32) | seq[k + 1].to(i64)
                          for k in range(0, len(seq) - 1, 2))
            seq = lanes + (seq[-1:] if odd else ())
        payload = tuple(payload)
        if ctx is None:
            perm = lex_perm(seq if packed else cols)
            return (tuple(c[perm] for c in cols), perm.to(self.idt),
                    tuple(x[perm] for x in payload))
        srt = dist_sort_local(seq + payload, len(seq), ctx)
        seq, pay = srt[:len(seq)], srt[len(seq):]
        if packed:
            out = []
            for lane in seq[:len(seq) - odd]:
                out += [(lane >> 32).to(torch.int32),
                        (lane & 0xFFFFFFFF).to(torch.int32)]
            seq = tuple(out) + seq[len(seq) - odd:]
        return seq[:-1], seq[-1], pay

    # ---------------- init: k-mer ranking ----------------

    def _init(self, ctx, codes, n_real: int):
        s, N, idt = self.s, self.N, self.idt
        ks, bits = self.ks, self.bits
        halo = halo_from_right(codes, sum(ks) - 1, ctx=ctx)
        words = pack_kmers_local(torch.cat([codes, halo]), s, ks, bits)
        gidx = self._gidx(ctx)
        # padding suffixes (word0 == 0) get their final ranks now: by
        # descending position, before every real suffix
        pad_rank = (N - gidx).to(torch.int32)
        words = words[:-1] + (torch.where(words[0] == 0, pad_rank,
                                          words[-1]),)
        wsort, sa, _ = self._sort_keys(ctx, words, gidx)
        prevs = tuple(prev_of(w, ctx=ctx) for w in wsort)
        newb = functools.reduce(
            torch.logical_or, (w != pw for w, pw in zip(wsort, prevs)))
        isa, brow, active, counts = self._rebucket_and_isa(ctx, newb, gidx,
                                                           sa)
        lcp0 = None
        if self.with_lcp:
            lcpv = lcp_bitwise_words(prevs, wsort, ks, bits)
            lcp0 = torch.where(newb, lcpv.to(idt), N)
            # rows 0..N-n-1 are the padding suffixes: adjacent ones overlap
            # in exactly (row) chars
            lcp0 = torch.where(gidx < N - n_real, gidx, lcp0)
            lcp0 = torch.where(gidx == 0, 0, lcp0)
        return isa, sa, lcp0, brow, active, counts

    def _init_local(self, codes, n_real: int):
        return self._run(self._init, codes, n_real)

    # ---------------- shared rebucket + SA->ISA ----------------

    def _rebucket_and_isa(self, ctx, newb, gpos, sa):
        """New bucket ids by SA row (prefix max of the 1-based head
        index, across the shards), the ISA un-permute (a distributed sort
        on a mesh), the active (non-singleton) mask, and the replicated
        (unfinished buckets, unfinished elements) counters."""
        cand = torch.where(newb, gpos + 1, 0).to(self.idt)
        b_new = global_cummax(cand, ctx)
        singleton = newb & next_of(newb, True, ctx)
        tot_single = psum(singleton.sum(), ctx)
        ub = psum(newb.sum(), ctx) - tot_single
        ue = self.N - tot_single
        (isa_new,) = scatter_by_index_local(sa, (b_new,), ctx)
        return isa_new, b_new, ~singleton, (Rep(ub), Rep(ue))

    # ---------------- one dense prefix-L-pling step ----------------

    def _stepL(self, ctx, isa, lcp, d: int, L: int):
        """Sort by (B, B@d, ..., B@(L-1)d, i); a split at first-differing
        column j gets LCP = j*d + the range min between the two column-j
        buckets (L = 2 is classic doubling, the JAX ``_step_local``).  The
        query buffers ``q`` carry the replicated query count ``nq``."""
        N, idt = self.N, self.idt
        gidx = self._gidx(ctx)
        cols = [isa] + [global_shift_left(isa, j * d, ctx)
                        for j in range(1, L)]
        bcols, sa, _ = self._sort_keys(ctx, cols, gidx)
        pcols = [prev_of(b, ctx=ctx) for b in bcols]
        diffs = [b != pb for b, pb in zip(bcols, pcols)]
        newb = functools.reduce(torch.logical_or, diffs)
        isa_new, b_new, active, counts = self._rebucket_and_isa(ctx, newb,
                                                                gidx, sa)
        if not self.with_lcp:
            return isa_new, sa, None, None, b_new, active, counts

        split = ~diffs[0] & functools.reduce(torch.logical_or, diffs[1:])
        # first differing column j in 1..L-1 and its (prev, cur) bucket pair
        jcol = torch.full_like(gidx, L - 1)
        pv, cv = pcols[L - 1], bcols[L - 1]
        for j in range(L - 2, 0, -1):
            jcol = torch.where(diffs[j], j, jcol)
            pv = torch.where(diffs[j], pcols[j], pv)
            cv = torch.where(diffs[j], bcols[j], cv)
        zero = (pv == 0) | (cv == 0)
        # a real split has j*d <= N, so d is capped there for the arithmetic
        lcp = torch.where(split & zero & (lcp == N), jcol * min(d, N), lcp)
        querycase = split & ~zero
        q = dict(qkey=torch.where(querycase, gidx, self.INF),
                 lq=torch.minimum(pv, cv), rq=torch.maximum(pv, cv) - 1,
                 jcol=jcol, nq=Rep(psum(querycase.sum(), ctx)))
        return isa_new, sa, lcp, q, b_new, active, counts

    def _stepL_local(self, isa, lcp, d: int, L: int):
        return self._run(self._stepL, isa, lcp, d, L)

    def _cap(self, m: int) -> int:
        """A tail capacity: ``m`` rounded up to a multiple of p (every shard
        holds m / p slots), at most N."""
        return min(self.N, -(-m // self.p) * self.p)

    def _host_resolve(self, lcp, q, d: int, nq: int):
        """The host-driven loop's LCP resolve of a doubling step's ``nq``
        queries: K6 on one device; on a mesh a compaction by one
        distributed sort, then the routed resolve (``resolve_with_retry``)."""
        if self.mesh is None:
            return self._resolve_fused_local(
                lcp, q, d, m_pad=min(pow2ceil(nq), self.N), L=2, nq=nq)
        return resolve_with_retry(self, self._cap(max(pow2ceil(nq), self.p)),
                                  lcp, q, d)

    # ---------------- LCP resolve (K6: range minima, written back) -------

    def _pack_queries(self, q, L: int, packing: str | None = None):
        """Compact a dense step's queries by one sort of a packed key (row *
        (L-1) + column; ``packing`` forces one of ``ops.rmq.PACKINGS``,
        None takes the tightest that fits the index dtype).  Returns (ks,
        ls, rs, js, Lm, packing): the sorted (s,) buffers K6 takes, valid
        queries first."""
        s, idt, INF = self.s, self.idt, self.INF
        Lm = max(1, L - 1)
        packing = packing or resolve_packing(s, Lm, INF)
        qkey, lq, rq, jcol = q["qkey"], q["lq"], q["rq"], q["jcol"]
        isq = qkey != INF
        js = None
        if packing == "narrow":
            wide = (rq - lq) >= 8
            key2 = torch.where(
                isq, (qkey + wide.to(idt) * s) * Lm + (jcol - 1), INF)
        elif packing == "packed":
            key2 = torch.where(isq, qkey * Lm + (jcol - 1), INF)
        else:
            key2 = qkey
            js = jcol if Lm > 1 else None
        perm = torch.sort(key2).indices
        if js is not None:
            js = js[perm]
        return key2[perm], lq[perm], rq[perm], js, Lm, packing

    def _resolve_fused_local(self, lcp, q, d: int, *, m_pad: int, L: int,
                             nq: int):
        """Answer a dense step's queries against the PRE-resolve LCP and
        write ``j*d + min`` at each query's row.  One device: K6 on the
        compacted queries (``m_pad``: the chunk of K6's plain version, which
        CPU tensors take).  A mesh: ``_resolve_rows``."""
        if self.mesh is not None:
            if nq == 0:
                return lcp
            return self.mesh.run(self._resolve_rows, lcp, q["qkey"], q["lq"],
                                 q["rq"], q["jcol"], d)
        ks, ls, rs, js, Lm, packing = self._pack_queries(q, L)
        # any real answer has j*d <= N
        return rmq_resolve(build_local_rmq(lcp), ks, ls, rs, js,
                           min(d, self.N), Lm=Lm, packing=packing, nq=nq,
                           m_pad=m_pad)

    def _resolve_local(self, lcp, kq, lq, rq, d: int):
        """K6 on the tail's unsorted (m,) buffer: keys are rows (INF = no
        query), one column, every slot offered."""
        return rmq_resolve(build_local_rmq(lcp), kq, lq, rq, None, d, Lm=1,
                           packing="rows", nq=kq.shape[0])

    def _resolve_rows(self, ctx, lcp, qkey, lq, rq, jcol, d: int):
        """The fused path's resolve on a mesh (JAX ``_resolve_fused_local``,
        p > 1 branch, ``:516-521``): the queries' ranges are global, so
        ``bulk_rmq_local`` answers them against the pre-resolve LCP, and
        each answer j*d + min lands at its own row, which is the query's
        (a dense step keys a query by its row's global index), so the write
        is an elementwise select.  The JAX compaction sort and its chunk
        loop bound the TPU's (chunk, 128) row windows; here the full-capacity
        routing already goes in p chunks, which bounds the exchange buffers
        at O(s)."""
        valid = qkey != self.INF
        mins = bulk_rmq_local(build_local_rmq(lcp), shard_minima(lcp, ctx),
                              lq, rq, valid, ctx)
        return torch.where(valid, jcol * min(d, self.N) + mins, lcp)

    def _resolve_routed(self, ctx, lcp, kq, lq, rq, d: int,
                        capscale: int | None):
        """Routed resolve of (m,) query buffers on a mesh (keys are global
        rows, INF = none): ``bulk_rmq_local`` at capacity ``cap_for(m, p,
        capscale)``, then ``route_scatter`` of d + min to the rows' shards.
        Returns (lcp, psum'd overflow count)."""
        valid = kq != self.INF
        cap = cap_for(kq.shape[0], ctx.p, capscale)
        mins, ovf_q = bulk_rmq_local(build_local_rmq(lcp),
                                     shard_minima(lcp, ctx), lq, rq, valid,
                                     ctx, cap=cap, with_overflow=True)
        (lcp,), ovf_s = route_scatter(kq, (min(d, self.N) + mins,), (lcp,),
                                      valid, ctx=ctx, cap=cap,
                                      with_overflow=True)
        return lcp, ovf_q + ovf_s

    def _compact_queries(self, ctx, qkey, lq, rq, m_pad: int):
        """The host loop's query compaction on a mesh: one distributed 1-key
        sort (INF keys sink), then the first ``m_pad`` rows
        block-distributed anew."""
        ks, ls, rs = dist_sort_local((qkey, lq, rq), 1, ctx)
        return tuple(reshard_prefix(x, m_pad, ctx) for x in (ks, ls, rs))

    def _resolve_run(self, ctx, lcp, kq, lq, rq, d: int, capscale):
        lcp, ovf = self._resolve_routed(ctx, lcp, kq, lq, rq, d, capscale)
        return lcp, Rep(int(ovf))

    # ---------------- sparse tail ("bucket chaising") ----------------
    #
    # The compact tail buffers are (position, bucket) and, in a GSA build,
    # each record's end-of-string bound as a third.  On a mesh they are
    # block-distributed: m_cap / p slots per shard.

    def _compact(self, mask, vals: tuple, fills: tuple, m: int) -> tuple:
        """The first ``m`` rows where ``mask`` holds, in row order, padded
        with ``fills`` to length m (the JAX package's searchsorted /
        stable-sort extraction; m exceeds the rows only on a mesh)."""
        order = torch.sort((~mask).to(torch.int32), stable=True).indices[:m]
        ok = torch.arange(m, device=mask.device) < mask.sum()
        outs = []
        for v, f in zip(vals, fills):
            g = v[order]
            if g.shape[0] < m:
                g = torch.cat([g, g.new_full((m - g.shape[0],), f)])
            outs.append(torch.where(ok, g, f))
        return tuple(outs)

    def _tail_fills(self, count: int) -> tuple:
        """Padding of the first ``count`` tail buffers."""
        return (0, self.INF, 0)[:count]

    def _redistribute_compact(self, ctx, bufs: tuple, mask, fills: tuple,
                              m_cap: int) -> tuple:
        """Per-shard compacted prefixes (the first ``mask.sum()`` entries of
        each buffer valid, in global row order) block-distributed over
        (m_cap,) global buffers, m_cap / p slots per shard: the global place
        of shard r's slot t is (the counts before r) + t.  On one device
        the buffers as they are."""
        if ctx is None:
            return bufs
        p, sl = ctx.p, m_cap // ctx.p
        llen = bufs[0].shape[0]
        counts = ctx.all_gather(mask.sum().to(torch.int64))
        carries = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        g = ctx.rank * sl + torch.arange(sl, device=ctx.device)
        owner = (torch.searchsorted(carries, g, right=True) - 1).clamp(0,
                                                                        p - 1)
        slot = (g - carries[owner]).clamp(0, llen - 1)
        valid = g < min(int(carries[-1]), m_cap)
        return tuple(torch.where(valid, ga[owner, slot], f)
                     for ga, f in zip(ctx.all_gather(tuple(bufs)), fills))

    def _tail_enter(self, ctx, sa, brow, active, m_cap: int, extra: tuple):
        vals = (sa, brow) + extra
        fills = self._tail_fills(len(vals))
        bufs = self._compact(active, vals, fills, m_cap)
        return self._redistribute_compact(ctx, bufs, active, fills, m_cap)

    def _tail_enter_local(self, sa, brow, active, m_cap: int,
                          extra: tuple = ()):
        """Compact the active rows into (m_cap,) tail buffers; ``extra``
        holds the per-row companions the tail carries (GSA: the row's
        end-of-string bound)."""
        return self._run(self._tail_enter, sa, brow, active, m_cap,
                         tuple(extra))

    def _tail_recompact(self, ctx, cbufs, m_to: int):
        fills = self._tail_fills(len(cbufs))
        valid = cbufs[1] != self.INF
        loc = self._compact(valid, cbufs, fills, min(cbufs[0].shape[0], m_to))
        return self._redistribute_compact(ctx, loc, valid, fills, m_to)

    def _tail_recompact_local(self, cbufs: tuple, m_to: int):
        """Shrink the tail buffers to a smaller capacity."""
        return self._run(self._tail_recompact, tuple(cbufs), m_to)

    def _tail_step(self, ctx, cbufs, isa, sa, lcp, d: int):
        N, INF = self.N, self.INF
        # no split lies N or more characters deep: d is capped there so the
        # tensors' dtype holds it
        d = min(d, N)
        cs, cb = cbufs[:2]
        ce = cbufs[2] if len(cbufs) == 3 else None
        valid = cb != INF
        # sparse B2 = ISA[pos + d] (0 past the end of the text, or of the
        # record's own string in GSA mode), from the shard that holds it
        tgt = cs + d
        inb = valid & (tgt < (N if ce is None else ce))
        b2 = torch.where(valid, gather_global(isa, tgt, inb, ctx=ctx), INF)

        # sort the compacted records by (bucket, B2, position)
        ops = (cb, b2, cs) + (() if ce is None else (ce,))
        cb_s, b2_s, cs_s, *ce_s = dist_sort_local(ops, 3, ctx)
        valid_s = cb_s != INF
        gi = self._gidx(ctx, cb.shape[0])
        pcb = prev_of(cb_s, ctx=ctx)
        pb2 = prev_of(b2_s, ctx=ctx)
        new_bkt = cb_s != pcb
        new_seg = new_bkt | (b2_s != pb2)
        # SA row within the bucket's row range [cb-1, cb-1+size); invalid
        # records (cb = INF, sorted last) get row 0 and are never written
        bkt_start = global_cummax(torch.where(new_bkt, gi + 1, 0), ctx) - 1
        row = torch.where(valid_s, cb_s - 1 + (gi - bkt_start), 0)
        b_new = global_cummax(torch.where(new_seg, row + 1, 0), ctx)
        settled = new_seg & next_of(new_seg, True, ctx)
        if ce is not None:
            # GSA: fully-ended suffix groups (B2 == 0) can never split
            settled = settled | (b2_s == 0)
        ue = Rep(psum((valid_s & ~settled).sum(), ctx))

        (sa_new,) = route_scatter(row, (cs_s,), (sa,), valid_s, ctx=ctx)
        (isa_new,) = route_scatter(cs_s, (b_new,), (isa,), valid_s, ctx=ctx)
        cb_out = torch.where(valid_s & ~settled, b_new, INF)
        cbufs = (cs_s, cb_out) + tuple(ce_s)
        if not self.with_lcp:
            return cbufs, isa_new, sa_new, None, ue

        # LCP at the new split rows
        split = valid_s & ~new_bkt & (b2_s != pb2)
        zerocase = split & ((pb2 == 0) | (b2_s == 0))
        querycase = split & (pb2 != 0) & (b2_s != 0)
        (lcp,) = route_scatter(row, (torch.full_like(row, d),), (lcp,),
                               zerocase, ctx=ctx)
        kq = torch.where(querycase, row, INF)
        lq, rq = torch.minimum(pb2, b2_s), torch.maximum(pb2, b2_s) - 1
        if ctx is None:
            lcp = self._resolve_local(lcp, kq, lq, rq, d)
        else:
            lcp, _ = self._resolve_routed(ctx, lcp, kq, lq, rq, d, None)
        return cbufs, isa_new, sa_new, lcp, ue

    def _tail_step_local(self, cbufs: tuple, isa, sa, lcp, d: int):
        return self._run(self._tail_step, tuple(cbufs), isa, sa, lcp, d)

    def _tail_loop(self, cbufs, isa, sa, lcp, d: int, tue: int, stop: int,
                   max_iters: int):
        it = 0
        while tue > stop and it < max_iters:
            cbufs, isa, sa, lcp, ue = self._tail_step_local(
                cbufs, isa, sa, lcp, d)
            d = min(d * 2, self.N)
            it += 1
            (tue,) = _read(ue)
        return cbufs, isa, sa, lcp, d, tue

    # ---------------- host-driven loop ----------------

    def host_loop(self, isa, sa, lcp, brow, active, d: int, ub: int,
                  ue: int, *, factor: int, tail_limit: int, timer):
        """The JAX package's host-driven loop (``fused=False``, or
        resuming where the fused dense loop stopped): dense steps, one
        stacked (ub, ue[, nq]) readback each, the LCP resolve (K6, one
        launch) only when the step has queries; once 0 < ue <=
        ``tail_limit``, the sparse tail at one capacity, the power of two
        above ue, until every element is finished.  ``factor`` > 2 (SA
        only) steps by ``construct_arr<factor>``, else by doubling.  ``d``
        stays uncapped for the convergence checks; the steps cap what they
        hand to tensors at N.  Returns (isa, sa, lcp)."""
        N = self.N
        L = factor if not self.with_lcp and factor > 2 else 2
        name = "doubling-step" if L == 2 else f"{L}-pling-step"
        while ub > 0:
            LAST_BUILD["host_iters"] += 1
            if d >= 2 * N:
                raise AssertionError("doubling failed to converge")
            if 0 < ue <= tail_limit:
                # the active count is ue from the last rebucket: no readback
                m_cap = self._cap(max(8 * self.p, pow2ceil(ue)))
                cbufs = self._tail_enter_local(sa, brow, active, m_cap)
                timer.end_section(f"tail-enter ({ue} active, cap {m_cap})")
                while True:
                    cbufs, isa, sa, lcp, tue = self._tail_step_local(
                        cbufs, isa, sa, lcp, d)
                    (ue,) = _read(tue)
                    timer.end_section(f"tail-step d={d}")
                    timer.info(f"d={d}: tail unfinished elements={ue}")
                    d *= 2
                    if ue == 0:
                        break
                    if d >= 4 * N:
                        raise AssertionError("tail failed to converge")
                break
            isa, sa, lcp, q, brow, active, counts = self._stepL_local(
                isa, lcp, d, L)
            if lcp is None:
                ub, ue = _read(*counts)
                timer.end_section(f"{name} d={d}")
            else:
                ub, ue, nq = _read(*counts, q["nq"])
                timer.end_section(f"{name} d={d}")
                if nq > 0:
                    lcp = self._host_resolve(lcp, q, d, nq)
                    timer.end_section(f"lcp-resolve d={d} ({nq} queries)")
            timer.info(f"d={d}: unfinished buckets={ub} elements={ue}")
            d *= L
        return isa, sa, lcp

    # ---------------- fused construction ----------------

    def _dense_resolve(self, lcp, q, counts, d: int, *, m_pad: int, L: int):
        """Read the step's counters back (with the query count the resolve
        needs, in the same readback) and resolve the LCP queries.  Returns
        (lcp, ub, ue)."""
        if not self.with_lcp:
            return (None, *_read(*counts))
        ub, ue, nq = _read(*counts, q["nq"])
        lcp = self._resolve_fused_local(lcp, q, d, m_pad=m_pad, L=L, nq=nq)
        return lcp, ub, ue

    def fused_full(self, codes, n_real: int, *, m_cap: int, m_cap2: int,
                   factor: int, resolve_div: int):
        """init -> dense L-pling loop -> two-stage sparse tail (see
        ``_fused_drive``).  Returns (isa, sa, lcp, brow, active, stats)."""
        m_pad = max(8, self.s // resolve_div)
        isa, sa, lcp, brow, active, counts = self._init_local(codes, n_real)

        def dense_step(isa, lcp, extra, d):
            isa, sa, lcp, q, brow, active, counts = self._stepL_local(
                isa, lcp, d, L=factor)
            lcp, ub, ue = self._dense_resolve(lcp, q, counts, d, m_pad=m_pad,
                                              L=factor)
            return isa, sa, lcp, brow, active, (), ub, ue, d * factor

        isa, sa, lcp, brow, active, _, stats = self._fused_drive(
            (isa, sa, lcp, brow, active, (), *_read(*counts)), dense_step,
            m_cap=m_cap, m_cap2=m_cap2)
        return isa, sa, lcp, brow, active, stats

    def _fused_drive(self, init_outs, dense_step, *, m_cap: int,
                     m_cap2: int):
        """Shared orchestration of the SA and GSA constructions.

        ``init_outs`` = (isa, sa, lcp | None, brow, active, extra, ub, ue)
        with ``extra`` the per-SA-row companions the tail entry needs (GSA:
        the row-aligned end-of-string bound) and ub, ue host integers.
        ``dense_step(isa, lcp, extra, d)`` runs one dense iteration with
        its LCP resolve and returns (isa, sa, lcp, brow, active, extra, ub,
        ue, d_next).

        The dense loop hands over once the active set fits ``m_cap``; the
        tail enters at ``m_cap`` and recompacts to ``m_cap2`` once the
        active count drops, or enters at ``m_cap2`` directly.  Returns
        (isa, sa, lcp, brow, active, extra, stats) with stats = (unfinished
        buckets, unfinished elements, tail_ran, d) and d the distance the
        dense loop reached: where it stopped at its iteration bound with
        work left (not tail_ran, ue > 0), the host-driven loop resumes from
        this state."""
        isa, sa, lcp, brow, active, extra, ub, ue = init_outs
        d = sum(self.ks)
        max_iters = fused_max_iters(self.N)
        it = 0
        while ub > 0 and ue > m_cap and it < max_iters:
            isa, sa, lcp, brow, active, extra, ub, ue, d = dense_step(
                isa, lcp, extra, d)
            it += 1

        fits = 0 < ue <= m_cap
        if fits:
            dt = d
            if ue > m_cap2:
                cbufs = self._tail_enter_local(sa, brow, active, m_cap, extra)
                cbufs, isa, sa, lcp, dt, tue = self._tail_loop(
                    cbufs, isa, sa, lcp, dt, ue, m_cap2, max_iters)
                cbufs = self._tail_recompact_local(cbufs, m_cap2)
            else:
                cbufs = self._tail_enter_local(sa, brow, active, m_cap2,
                                               extra)
                tue = ue
            _, isa, sa, lcp, dt, ue = self._tail_loop(
                cbufs, isa, sa, lcp, dt, tue, 0, max_iters)
        return isa, sa, lcp, brow, active, extra, (ub, ue, fits, d)



def resolve_with_retry(b: _Builder, m_pad: int, lcp, q, d: int):
    """The host-driven loop's LCP resolve on a mesh: compact the queries by
    one distributed sort, then answer them with routing buffers of
    capscale 6 (O(m) exchange volume); only when the destinations' skew
    overflows that, again with cap = m, which never overflows (the
    reference's imbalance report, ``bulk_rma.hpp:27-35``)."""
    ks, ls, rs = b.mesh.run(b._compact_queries, q["qkey"], q["lq"],
                            q["rq"], m_pad)
    for capscale in (6, None):
        lcp_new, ovf = b.mesh.run(b._resolve_run, lcp, ks, ls, rs, d,
                                  capscale)
        if capscale is None or ovf == 0:
            break
        if timers_enabled():
            print(f"[psac_tpu] resolve route overflow ({ovf} records "
                  f"at capscale={capscale}); retrying with cap=m",
                  file=sys.stderr)
    return lcp_new


def index_dtype_for(N: int, config) -> torch.dtype:
    """int32 while every derived quantity fits, int64 beyond (or when
    ``force_int64``)."""
    if config.force_int64:
        return torch.int64
    return cfg_mod.index_dtype(N)


def kmer_words_for(bits_per_char: int,
                   config: cfg_mod.SAConfig) -> tuple[int, ...]:
    """Per-word char counts of the initial k-mer ranking: ``kmer_words``
    int32 words filled to capacity, optionally capped by ``config.k``."""
    ks = list(optimal_k(bits_per_char, words=config.kmer_words))
    if config.k:
        rem = max(1, config.k)
        out = []
        for i, kw in enumerate(ks):
            take = min(kw, max(1, -(-rem // (len(ks) - i))))
            out.append(take)
            rem -= take
            if rem <= 0:
                break
        ks = out
    return tuple(ks)


def _decode_staged(xb: torch.Tensor, alpha: Alphabet) -> torch.Tensor:
    """Staged uint8 bytes -> (N,) int32 codes through the alphabet's
    mapping, on the bytes' device (padding bytes map to 0)."""
    mapping = torch.from_numpy(alpha.mapping.astype(np.int32)).to(xb.device)
    return mapping[xb.to(torch.int32)]


def _decode_shards(xb: Sharded, n: int, N: int, mesh):
    """Staged bytes on a mesh -> (xs, alpha): the alphabet from the
    histogram summed over every shard, each block decoded on its device."""
    alpha = Alphabet.from_hist(staged_histogram(xb, mesh), pad_zeros=N - n)
    return xb.map(lambda t: _decode_staged(t, alpha)), alpha


def encode_and_shard(text, device=None, mesh=None):
    """Alphabet detection and encoding onto ``device`` (None: the CUDA
    card, ``config.resolve_device``), or block-distributed over the p
    shards of ``mesh`` (which replaces ``device``; N = padded_size(n, p)):
    returns (xs, alpha, n, N) with xs the (N,) int32 codes (1..sigma),
    zero-padded, a ``Sharded`` array on a mesh of p > 1.

    Bytes are staged raw and counted on the device
    (``parallel.staging``; NUL is the sentinel and raises); wider integer
    arrays use the min/max ``IntAlphabet``."""
    p = 1 if mesh is None else mesh.p
    if mesh is not None and p == 1:
        device = mesh.devices[0]
    device = "cpu" if p > 1 else cfg_mod.resolve_device(device)
    if len(text) >= (1 << 40):
        raise ValueError(f"text too large: {len(text)} (2^40 char ceiling)")
    if isinstance(text, (bytes, bytearray)) or \
            np.asarray(text).dtype == np.uint8:
        if p > 1:
            xb, n, N = stage_bytes_block(text, mesh)
            xs, alpha = _decode_shards(xb, n, N, mesh)
            return xs, alpha, n, N
        xb, n, N = stage_bytes_block(text, device)
        alpha = Alphabet.from_hist(staged_histogram(xb), pad_zeros=N - n)
        xs = _decode_staged(xb, alpha)
    else:
        alpha = IntAlphabet.from_array(text)
        codes = alpha.encode(text)
        n = len(codes)
        N = padded_size(max(n, 1), p)
        padded = np.zeros(N, np.int32)
        padded[:n] = codes
        xs = torch.from_numpy(padded)
        xs = mesh.shard(xs) if p > 1 else xs.to(device)
    return xs, alpha, n, N


def encode_and_shard_file(path: str, device=None, mesh=None):
    """``encode_and_shard`` of a file's bytes, staged raw on ``device``
    (one read) or over ``mesh``, where each process reads only its own
    shards' byte ranges (``parallel.staging``), and the alphabet counted
    there.  Returns (xs, alpha, n, N)."""
    if mesh is not None and mesh.p > 1:
        xb, n, N = stage_file_block(path, mesh)
        xs, alpha = _decode_shards(xb, n, N, mesh)
        return xs, alpha, n, N
    if mesh is not None:
        device = mesh.devices[0]
    xb, n, N = stage_file_block(path, cfg_mod.resolve_device(device))
    alpha = Alphabet.from_hist(staged_histogram(xb), pad_zeros=N - n)
    return _decode_staged(xb, alpha), alpha, n, N


def construct_device(xs, alpha, n: int, N: int,
                     config: cfg_mod.SAConfig = cfg_mod.DEFAULT, mesh=None
                     ) -> DeviceSuffixArray:
    """Run the construction on ``xs``'s device, or on ``mesh`` when ``xs``
    is ``Sharded`` over it (``encode_and_shard(..., mesh=)``); the result
    stays there.  ``config.fused`` picks the driver (module docstring);
    with ``PSAC_TIMER=1`` each phase prints a ``[timer] [construct]`` line,
    and ``LAST_BUILD`` records which driver ran, the host-loop iterations
    and p.  The drivers run in the caller's thread at any p."""
    ks = kmer_words_for(alpha.bits_per_char, config)
    k = sum(ks)
    idt = index_dtype_for(N, config)
    # only wide dense sorts (>= 6 key columns: factor >= 5) pack keys
    wide = max(config.dense_factor if config.fused else 2, config.factor) >= 5
    pack = config.pack_keys and wide
    if isinstance(xs, Sharded):
        if mesh is None or mesh.p != xs.p:
            raise ValueError("construct_device: sharded codes need their "
                             "mesh (mesh=)")
        device = None
    else:
        mesh, device = None, xs.device
    b = _Builder(N, ks, alpha.bits_per_char, config.construct_lcp, idt,
                 device, pack=pack, mesh=mesh)
    timer = SectionTimer(label="construct")
    d = k
    if config.fused:
        m_cap2 = b._cap(max(8 * b.p, min(N, pow2ceil(max(256, N // 1024)))))
        m_cap = b._cap(max(m_cap2, min(N, pow2ceil(
            N // max(1, config.fused_tail_div)))))
        factor = config.dense_factor if config.construct_lcp else \
            config.factor
        isa, sa, lcp, brow, active, (ub, ue, tail_ran, d_out) = \
            b.fused_full(xs, n, m_cap=m_cap, m_cap2=m_cap2, factor=factor,
                         resolve_div=config.resolve_div)
        timer.end_section(f"fused construction (k={k}, cap {m_cap}, "
                          f"tail_ran={int(tail_ran)})")
        timer.info(f"n={n} N={N} p={b.p} unfinished buckets={ub} "
                   f"elements(after)={ue}")
        if tail_ran:
            if ue != 0:
                raise AssertionError("fused tail failed to converge")
            ub = 0
        elif ue == 0:
            ub = 0
        else:
            # the dense loop hit its iteration bound: the host-driven loop
            # resumes from its state
            d = max(d, d_out)
        LAST_BUILD.update(fused=True, host_iters=0, p=b.p, n=n, N=N)
    else:
        isa, sa, lcp, brow, active, counts = b._init_local(xs, n)
        ub, ue = _read(*counts)
        timer.end_section(f"kmer-init (k={k})")
        timer.info(f"n={n} N={N} p={b.p} unfinished buckets={ub} "
                   f"elements={ue}")
        LAST_BUILD.update(fused=False, host_iters=0, p=b.p, n=n, N=N)
    isa, sa, lcp = b.host_loop(
        isa, sa, lcp, brow, active, d, ub, ue, factor=config.factor,
        tail_limit=int(N * config.tail_threshold_frac), timer=timer)
    timer.summary()
    dsa = DeviceSuffixArray(sa=sa, lcp=lcp, isa=isa, alphabet=alpha, n=n, N=N,
                            mesh=mesh)
    if config.construct_lc:
        if not config.construct_lcp:
            raise ValueError("construct_lc requires construct_lcp")
        dsa = dataclasses.replace(dsa, lc=compute_lc_device(dsa, xs))
    return dsa


def _lc(ctx, lcp, sa, xs, n: int, capscale: int | None):
    """Lc[g] = text[SA[g-1] + LCP[g]] (0 past the end / at the first row)
    of this shard's rows, the characters gathered from the shards that hold
    them (JAX ``_lc_local``, ``:1021-1048``); with the replicated overflow
    count of that routing."""
    s = lcp.shape[0]
    p = 1 if ctx is None else ctx.p
    N = s * p
    base = global_index_base(s, ctx)
    g = torch.arange(base, base + s, device=lcp.device)
    idx = prev_of(sa, fill=0, ctx=ctx) + lcp
    real = (g > N - n) & (idx < n)
    ch, ovf = gather_global(xs, idx, real, ctx=ctx,
                            cap=cap_for(s, p, capscale), with_overflow=True)
    return ch, Rep(int(ovf))


def compute_lc_device(dsa: DeviceSuffixArray, xs) -> torch.Tensor:
    """Left-branching-character array (reference ``_CONSTRUCT_LC``:
    Lc[i] = S[SA[i-1] + LCP[i]]), one gather after the construction.
    Returns the (N,) int32 padded array (codes, 0 = none/$); on a mesh a
    ``Sharded`` one, routed at capscale 6 first and retried with cap = m
    on overflow."""
    if dsa.lcp is None:
        raise ValueError("Lc requires the LCP array")
    for capscale in (6, None):
        lc, ovf = run_on(dsa.mesh, _lc, dsa.lcp, dsa.sa, xs, dsa.n, capscale)
        if capscale is None or ovf == 0:
            return lc


def construct_from_file(path: str, device=None,
                        config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                        mesh=None):
    """Build SA(+LCP) of a file's bytes on ``device`` (None: the CUDA
    card) or on ``mesh``; returns the device-resident result and the staged
    codes, which ``verify.check_sa.d_check_sa(dsa, xs)`` checks without a
    host oracle."""
    xs, alpha, n, N = encode_and_shard_file(path, device, mesh)
    return construct_device(xs, alpha, n, N, config, mesh), xs


def build_suffix_array(text, device=None,
                       config: cfg_mod.SAConfig | None = None,
                       mesh=None) -> SuffixArray:
    """Suffix array (and optionally LCP) of ``text`` built on ``device``
    (None: the CUDA card; ``"cpu"`` runs the plain versions), or on the p
    shards of ``mesh`` (``parallel.mesh.make_mesh``), which then replaces
    ``device``."""
    config = config or cfg_mod.DEFAULT
    if len(text) < 1:
        return SuffixArray(
            sa=np.zeros(0, np.int64),
            lcp=np.zeros(0, np.int64) if config.construct_lcp else None,
            alphabet=Alphabet.from_bytes(text), n=0)
    xs, alpha, n, N = encode_and_shard(text, device, mesh)
    return construct_device(xs, alpha, n, N, config, mesh).materialize()
