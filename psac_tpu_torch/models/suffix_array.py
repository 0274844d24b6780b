"""Single-device suffix-array + LCP construction (port of
``psac_tpu/models/suffix_array.py`` at p = 1, fused construction path).

k-mer initial ranking, then dense prefix-L-pling steps (sort by
(B, B@d, ..., B@(L-1)d, i), rebucket by prefix max, SA -> ISA un-permute)
with the LCP resolved per step by range-minimum queries, then a sparse
"bucket chaising" tail over the compacted unfinished rows — the JAX
package's ``_Builder.fused_full`` program.  Its ``lax.while_loop``s become
host loops here that read one stacked scalar tensor back per step.

Conventions (as in the JAX package): bucket id = 1-based index of the
bucket's first SA row, 0 = shifted past the end; the padded text has
N = padded_size(n) chars, and the N - n all-sentinel padding suffixes
take SA rows [0, N - n) with their ranks fixed at init.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from psac_tpu_torch import config as cfg_mod
from psac_tpu_torch.ops.alphabet import Alphabet, IntAlphabet
from psac_tpu_torch.ops.bitops import lcp_bitwise_words
from psac_tpu_torch.ops.kmer import optimal_k, pack_kmers_local
from psac_tpu_torch.ops.rmq import (bulk_rmq_local, build_local_rmq,
                                    edge_mins, query_local_rmq)
from psac_tpu_torch.parallel.collectives import (global_cummax,
                                                 global_shift_left_dyn,
                                                 halo_from_right, prev_of)
from psac_tpu_torch.parallel.mesh import padded_size
from psac_tpu_torch.parallel.route import route_scatter
from psac_tpu_torch.parallel.sort import (dist_sort_local, lex_perm,
                                          scatter_by_index_local)


@dataclasses.dataclass
class SuffixArray:
    """Finished artifact: SA (and optionally LCP) of the input text."""

    sa: np.ndarray
    lcp: np.ndarray | None
    alphabet: object
    n: int


@dataclasses.dataclass
class DeviceSuffixArray:
    """Device-resident result.  ``sa``/``lcp``/``isa`` are (N,) padded: the
    first N - n SA rows are the all-sentinel padding suffixes."""

    sa: torch.Tensor
    lcp: torch.Tensor | None
    isa: torch.Tensor
    alphabet: object
    n: int
    N: int

    @classmethod
    def from_numpy(cls, sa, lcp, isa, alphabet, n: int, N: int,
                   device) -> "DeviceSuffixArray":
        """Wrap padded (N,) host arrays (e.g. the JAX package's device
        arrays after ``jax.device_get``, in its index dtype) as a
        device-resident result."""

        def put(a):
            return None if a is None else \
                torch.from_numpy(np.array(a)).to(device)

        return cls(sa=put(sa), lcp=put(lcp), isa=put(isa), alphabet=alphabet,
                   n=n, N=N)

    def materialize(self) -> SuffixArray:
        sa = self.sa[self.N - self.n:].cpu().numpy().astype(np.int64)
        lcp = None
        if self.lcp is not None:
            lcp = self.lcp[self.N - self.n:].cpu().numpy().astype(np.int64)
            if self.n > 0:
                lcp[0] = 0
        return SuffixArray(sa=sa, lcp=lcp, alphabet=self.alphabet, n=self.n)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _read(*scalars) -> list[int]:
    """One device -> host readback of several 0-d tensors."""
    return [int(v) for v in torch.stack([s.to(torch.int64)
                                         for s in scalars]).tolist()]


class _Builder:
    """Geometry and construction steps of one build (p = 1: s == N)."""

    def __init__(self, N: int, ks: tuple[int, ...], bits: int,
                 with_lcp: bool, idt: torch.dtype, device):
        self.N = self.s = N
        self.ks, self.bits = tuple(ks), bits
        self.with_lcp = with_lcp
        self.idt = idt
        self.INF = torch.iinfo(idt).max
        self.device = device

    def _gidx(self, m: int | None = None) -> torch.Tensor:
        return torch.arange(self.s if m is None else m, dtype=self.idt,
                            device=self.device)

    def _sort_keys(self, cols):
        """Sort rows by (cols..., gidx): a stable lexicographic sort keeps
        equal-key rows in gidx order.  Returns (sorted cols, sa)."""
        perm = lex_perm(cols)
        return tuple(c[perm] for c in cols), perm.to(self.idt)

    # ---------------- init: k-mer ranking ----------------

    def _init_local(self, codes, n_real: int):
        s, N, idt = self.s, self.N, self.idt
        ks, bits = self.ks, self.bits
        halo = halo_from_right(codes, sum(ks) - 1)
        words = pack_kmers_local(torch.cat([codes, halo]), s, ks, bits)
        gidx = self._gidx()
        # padding suffixes (word0 == 0) get their final ranks now: by
        # descending position, before every real suffix
        pad_rank = (N - gidx).to(torch.int32)
        words = words[:-1] + (torch.where(words[0] == 0, pad_rank,
                                          words[-1]),)
        wsort, sa = self._sort_keys(words)
        prevs = tuple(prev_of(w) for w in wsort)
        newb = functools.reduce(
            torch.logical_or, (w != pw for w, pw in zip(wsort, prevs)))
        isa, brow, active, counts = self._rebucket_and_isa(newb, gidx, sa)
        lcp0 = None
        if self.with_lcp:
            lcpv = lcp_bitwise_words(prevs, wsort, ks, bits)
            lcp0 = torch.where(newb, lcpv.to(idt), N)
            # rows 0..N-n-1 are the padding suffixes: adjacent ones overlap
            # in exactly (row) chars
            lcp0 = torch.where(gidx < N - n_real, gidx, lcp0)
            lcp0 = torch.where(gidx == 0, 0, lcp0)
        return isa, sa, lcp0, brow, active, counts

    # ---------------- shared rebucket + SA->ISA ----------------

    def _rebucket_and_isa(self, newb, gpos, sa):
        """New bucket ids by SA row (prefix max of the 1-based head
        index), the ISA un-permute, the active (non-singleton) mask, and
        the (unfinished buckets, unfinished elements) counters."""
        cand = torch.where(newb, gpos + 1, 0).to(self.idt)
        b_new = global_cummax(cand)
        nxt = torch.cat([newb[1:], newb.new_ones(1)])
        singleton = newb & nxt
        tot_single = singleton.sum()
        ub = newb.sum() - tot_single
        ue = self.N - tot_single
        (isa_new,) = scatter_by_index_local(sa, (b_new,))
        return isa_new, b_new, ~singleton, (ub, ue)

    # ---------------- one dense prefix-L-pling step ----------------

    def _stepL_local(self, isa, lcp, d: int, L: int):
        """Sort by (B, B@d, ..., B@(L-1)d, i); a split at first-differing
        column j gets LCP = j*d + the range min between the two column-j
        buckets (L = 2 is classic doubling, the JAX ``_step_local``)."""
        N, idt = self.N, self.idt
        gidx = self._gidx()
        cols = [isa] + [global_shift_left_dyn(isa, j * d)
                        for j in range(1, L)]
        bcols, sa = self._sort_keys(cols)
        pcols = [prev_of(b) for b in bcols]
        diffs = [b != pb for b, pb in zip(bcols, pcols)]
        newb = functools.reduce(torch.logical_or, diffs)
        isa_new, b_new, active, counts = self._rebucket_and_isa(newb, gidx, sa)
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
                 jcol=jcol)
        return isa_new, sa, lcp, q, b_new, active, counts

    # ---------------- LCP resolve (bulk RMQ + scatter) ----------------

    def _resolve_fused_local(self, lcp, q, d: int, *, m_pad: int, L: int,
                             nq: int, n_narrow: int):
        """Compact the queries by one sort of a packed key (row * (L-1) +
        column), answer them in m_pad-sized chunks against the PRE-resolve
        LCP, scatter back.  The last chunk's start is clamped to s - m_pad
        (as ``lax.dynamic_slice`` clamps); its repeated rows rewrite
        identical values."""
        s, idt, INF = self.s, self.idt, self.INF
        Lm = max(1, L - 1)
        # narrow tier: queries with rq - lq < 8 span at most two 8-wide
        # rows; a class bit above the row key groups them into own chunks
        narrow = s % 8 == 0 and INF // (2 * Lm) > s
        packed = INF // Lm > s
        qkey, lq, rq, jcol = q["qkey"], q["lq"], q["rq"], q["jcol"]
        isq = qkey != INF
        js = None
        if narrow:
            wide = (rq - lq) >= 8
            key2 = torch.where(
                isq, (qkey + wide.to(idt) * s) * Lm + (jcol - 1), INF)
        elif packed and Lm > 1:
            key2 = torch.where(isq, qkey * Lm + (jcol - 1), INF)
        else:
            key2 = qkey
            js = jcol if Lm > 1 else None
        perm = torch.sort(key2).indices
        ks, ls, rs = key2[perm], lq[perm], rq[perm]
        if js is not None:
            js = js[perm]
        rmq = build_local_rmq(lcp)
        d = min(d, self.N)  # any real answer has j*d <= N
        lcp_pad = torch.cat([lcp, lcp.new_zeros(1)])

        c = 0
        while c * m_pad < nq:
            off = min(c * m_pad, s - m_pad)
            sl = slice(off, off + m_pad)
            kq_c, l_c, r_c = ks[sl], ls[sl], rs[sl]
            valid = kq_c != INF
            if js is not None:
                j_c = js[sl]
                row_loc = torch.where(valid, kq_c, 0)
            elif narrow or Lm > 1:
                kdec = torch.where(valid, kq_c, 0)
                if narrow:
                    kdec = torch.where(kdec >= s * Lm, kdec - s * Lm, kdec)
                row_loc = (kdec // Lm).clamp(0, s - 1)
                j_c = kdec - row_loc * Lm + 1
            else:
                row_loc = torch.where(valid, kq_c, 0)
                j_c = torch.ones_like(kq_c)
            lo = torch.where(valid, l_c, 0).clamp(0, s - 1)
            hi = torch.where(valid, torch.maximum(r_c, l_c), 0).clamp(0, s - 1)
            # sorted valid keys: narrow ones at [0, n_narrow), wide ones at
            # [n_narrow, nq) — a chunk is all-narrow unless it meets those
            has_wide = max(off, n_narrow) < min(off + m_pad, nq)
            if narrow and not has_wide:
                mins = edge_mins(lcp, 8, lo, hi)
            else:
                mins = query_local_rmq(rmq, lo, hi)
            row = torch.where(valid, row_loc, s)
            lcp_pad[row] = torch.where(valid, j_c * d + mins, 0)
            c += 1
        return lcp_pad[:s]

    def _resolve_local(self, lcp, kq, lq, rq, d: int):
        """Bulk RMQ of every valid query against ``lcp``, scattered back."""
        rmq = build_local_rmq(lcp)
        valid = kq != self.INF
        mins = bulk_rmq_local(rmq, lq, rq, valid)
        (lcp_new,) = route_scatter(kq, (d + mins,), (lcp,), valid)
        return lcp_new

    # ---------------- sparse tail ("bucket chaising") ----------------

    def _compact(self, mask, vals: tuple, fills: tuple, m: int) -> tuple:
        """The first ``m`` rows where ``mask`` holds, in row order, padded
        with ``fills`` (the JAX package's searchsorted / stable-sort
        extraction)."""
        order = torch.sort((~mask).to(torch.int32), stable=True).indices[:m]
        ok = torch.arange(order.shape[0], device=mask.device) < mask.sum()
        return tuple(torch.where(ok, v[order], f) for v, f in zip(vals, fills))

    def _tail_enter_local(self, sa, brow, active, m_cap: int):
        """Compact the active rows into (m_cap,) (position, bucket) buffers."""
        return self._compact(active, (sa, brow), (0, self.INF), m_cap)

    def _tail_recompact_local(self, cs, cb, m_to: int):
        """Shrink the tail buffers to a smaller capacity."""
        return self._compact(cb != self.INF, (cs, cb), (0, self.INF), m_to)

    def _tail_step_local(self, cs, cb, isa, sa, lcp, d: int):
        s, N, INF = self.s, self.N, self.INF
        valid = cb != INF
        # sparse B2 = ISA[pos + d] (0 past the end of the text)
        tgt = cs + d
        inb = valid & (tgt < N)
        b2 = isa[torch.where(inb, tgt, 0).clamp(0, s - 1)]
        b2 = torch.where(valid, torch.where(inb, b2, 0), INF)

        # sort the compacted records by (bucket, B2, position)
        cb_s, b2_s, cs_s = dist_sort_local((cb, b2, cs), num_keys=3)
        valid_s = cb_s != INF
        gi = self._gidx(cb.shape[0])
        pcb = prev_of(cb_s)
        pb2 = prev_of(b2_s)
        new_bkt = cb_s != pcb
        new_seg = new_bkt | (b2_s != pb2)
        # SA row within the bucket's row range [cb-1, cb-1+size); invalid
        # records (cb = INF, sorted last) get row 0 and are never written
        bkt_start = global_cummax(torch.where(new_bkt, gi + 1, 0)) - 1
        row = torch.where(valid_s, cb_s - 1 + (gi - bkt_start), 0)
        b_new = global_cummax(torch.where(new_seg, row + 1, 0))
        nseg = torch.cat([new_seg[1:], new_seg.new_ones(1)])
        settled = new_seg & nseg
        ue = (valid_s & ~settled).sum()

        (sa_new,) = route_scatter(row, (cs_s,), (sa,), valid_s)
        (isa_new,) = route_scatter(cs_s, (b_new,), (isa,), valid_s)
        cb_out = torch.where(valid_s & ~settled, b_new, INF)
        if not self.with_lcp:
            return cs_s, cb_out, isa_new, sa_new, None, ue

        # LCP at the new split rows
        split = valid_s & ~new_bkt & (b2_s != pb2)
        zerocase = split & ((pb2 == 0) | (b2_s == 0))
        querycase = split & (pb2 != 0) & (b2_s != 0)
        (lcp,) = route_scatter(row, (torch.full_like(row, d),), (lcp,),
                               zerocase)
        kq = torch.where(querycase, row, INF)
        lcp = self._resolve_local(lcp, kq, torch.minimum(pb2, b2_s),
                                  torch.maximum(pb2, b2_s) - 1, d)
        return cs_s, cb_out, isa_new, sa_new, lcp, ue

    def _tail_loop(self, cs, cb, isa, sa, lcp, d: int, tue: int, stop: int,
                   max_iters: int):
        it = 0
        while tue > stop and it < max_iters:
            cs, cb, isa, sa, lcp, ue = self._tail_step_local(
                cs, cb, isa, sa, lcp, d)
            d = min(d * 2, self.N)
            it += 1
            (tue,) = _read(ue)
        return cs, cb, isa, sa, lcp, d, tue

    # ---------------- fused construction ----------------

    def fused_full(self, codes, n_real: int, *, m_cap: int, m_cap2: int,
                   factor: int, resolve_div: int):
        """init -> dense L-pling loop (hands over once the active set fits
        ``m_cap``) -> two-stage sparse tail: entry at ``m_cap`` and
        recompaction to ``m_cap2`` once the active count drops, or entry at
        ``m_cap2`` directly.  Returns (isa, sa, lcp, stats) with stats =
        (unfinished buckets, unfinished elements, tail_ran)."""
        N = self.N
        m_pad = max(8, self.s // resolve_div)
        isa, sa, lcp, brow, active, (ub, ue) = self._init_local(codes, n_real)
        ub, ue = _read(ub, ue)
        d = sum(self.ks)
        max_iters = max(4, int(N).bit_length() + 2)
        it = 0
        while ub > 0 and ue > m_cap and it < max_iters:
            isa, sa, lcp, q, brow, active, (ub, ue) = self._stepL_local(
                isa, lcp, d, L=factor)
            if self.with_lcp:
                isq = q["qkey"] != self.INF
                ub, ue, nq, n_narrow = _read(
                    ub, ue, isq.sum(), (isq & (q["rq"] - q["lq"] < 8)).sum())
                lcp = self._resolve_fused_local(
                    lcp, q, d, m_pad=m_pad, L=factor, nq=nq,
                    n_narrow=n_narrow)
            else:
                ub, ue = _read(ub, ue)
            d *= factor
            it += 1

        fits = 0 < ue <= m_cap
        if fits:
            if ue > m_cap2:
                cs, cb = self._tail_enter_local(sa, brow, active, m_cap)
                cs, cb, isa, sa, lcp, d, tue = self._tail_loop(
                    cs, cb, isa, sa, lcp, d, ue, m_cap2, max_iters)
                cs, cb = self._tail_recompact_local(cs, cb, m_cap2)
            else:
                cs, cb = self._tail_enter_local(sa, brow, active, m_cap2)
                tue = ue
            *_, isa, sa, lcp, d, ue = self._tail_loop(
                cs, cb, isa, sa, lcp, d, tue, 0, max_iters)
        return isa, sa, lcp, (ub, ue, fits)


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


def encode_and_shard(text, device):
    """Alphabet detection and encoding onto ``device``: returns (xs, alpha,
    n, N) with xs the (N,) int32 codes (1..sigma), zero-padded.

    Bytes use the dense histogram alphabet (NUL is the sentinel and
    raises); wider integer arrays use the min/max ``IntAlphabet``."""
    if len(text) >= (1 << 40):
        raise ValueError(f"text too large: {len(text)} (2^40 char ceiling)")
    if isinstance(text, (bytes, bytearray)) or \
            np.asarray(text).dtype == np.uint8:
        buf = np.frombuffer(bytes(text), np.uint8) \
            if isinstance(text, (bytes, bytearray)) else np.asarray(text)
        n = len(buf)
        N = padded_size(max(n, 1))
        # ship raw bytes and count them on the device: a host bincount
        # widens every byte to int64 first
        raw = torch.from_numpy(buf.copy()).to(device).to(torch.int32)
        hist = torch.bincount(raw, minlength=256).cpu().numpy()
        alpha = Alphabet.from_hist(hist)
        mapping = torch.from_numpy(alpha.mapping.astype(np.int32)).to(device)
        xs = torch.zeros(N, dtype=torch.int32, device=device)
        xs[:n] = mapping[raw]
    else:
        alpha = IntAlphabet.from_array(text)
        codes = alpha.encode(text)
        n = len(codes)
        N = padded_size(max(n, 1))
        padded = np.zeros(N, np.int32)
        padded[:n] = codes
        xs = torch.from_numpy(padded).to(device)
    return xs, alpha, n, N


def construct_device(xs, alpha, n: int, N: int,
                     config: cfg_mod.SAConfig = cfg_mod.DEFAULT
                     ) -> DeviceSuffixArray:
    """Run the construction on ``xs``'s device; the result stays there."""
    config.check_supported()
    ks = kmer_words_for(alpha.bits_per_char, config)
    idt = index_dtype_for(N, config)
    b = _Builder(N, ks, alpha.bits_per_char, config.construct_lcp, idt,
                 xs.device)
    m_cap2 = max(8, min(N, _pow2ceil(max(256, N // 1024))))
    m_cap = max(m_cap2, min(N, _pow2ceil(N // max(1, config.fused_tail_div))))
    factor = config.dense_factor if config.construct_lcp else config.factor
    isa, sa, lcp, (ub, ue, tail_ran) = b.fused_full(
        xs, n, m_cap=m_cap, m_cap2=m_cap2, factor=factor,
        resolve_div=config.resolve_div)
    if tail_ran and ue != 0:
        raise RuntimeError("fused tail failed to converge")
    if not tail_ran and ue != 0:
        raise RuntimeError(f"dense loop stopped with {ue} unfinished "
                           f"elements ({ub} buckets)")
    return DeviceSuffixArray(sa=sa, lcp=lcp, isa=isa, alphabet=alpha, n=n,
                             N=N)


def build_suffix_array(text, device,
                       config: cfg_mod.SAConfig = cfg_mod.DEFAULT
                       ) -> SuffixArray:
    """Suffix array (and optionally LCP) of ``text`` built on ``device``."""
    if len(text) < 1:
        return SuffixArray(
            sa=np.zeros(0, np.int64),
            lcp=np.zeros(0, np.int64) if config.construct_lcp else None,
            alphabet=Alphabet.from_bytes(text), n=0)
    xs, alpha, n, N = encode_and_shard(text, device)
    return construct_device(xs, alpha, n, N, config).materialize()
