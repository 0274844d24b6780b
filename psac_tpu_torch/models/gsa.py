"""Generalized suffix array (+LCP) over string sets (port of
``psac_tpu/models/gsa.py``), on one device or on a mesh of p shards.

All suffixes of all strings sorted together, each suffix ending at its own
string's end (a virtual ``$`` = 0 terminator), positions indexing the
separator-removed concatenation (the reference's ``gsac`` output); equal
suffixes of different strings tie in position order.

The flat formulation needs one extra array, ``eos[i]`` = one past the end
of the string that holds position i:

  * doubling shift:   B2 = where(i + d < eos[i], ISA[i + d], 0)
  * initial k-mers:   chars zero-masked past eos
  * initial LCP:      bitwise k-mer LCP capped by both suffixes' remaining
                      lengths
  * termination:      an element is settled when its (B, B2) pair is unique
                      OR B2 == 0: groups of identical whole suffixes can
                      never split and are final (stable tie order)
  * final LCP ties:   rows still carrying the sentinel N after the loop are
                      ties of identical suffixes; their LCP is the full
                      suffix length.

Each step is one shard function (``_GsaBuilder._ginit``, ``_gstep``, the
shared tail, ``_lcp_tiefix``, ``_eos``, ``_drop_separators``) that runs at
every p, as the suffix array's do (``models.suffix_array``): ``ctx=None``
on one device, one ``Mesh.run`` on a mesh, where eos is expanded per shard
from the replicated string boundaries, the k-mer window takes its halo from
the right neighbours, the sorts are distributed and the tie-fix's eos
lookups routed (capscale 6, then unbounded on overflow).  The dense loop's
LCP resolve and the tail's run K6 (``ops.rmq.rmq_resolve``) on one device
and the routed range minima (K6's min-only entry) on a mesh.  Two drivers
run the steps, as in the JAX package: the fused path (``fused=True``), and
the host-driven loop (``fused=False``, and where the fused path does not
converge: it redoes the build).  The in-memory and the file input
(``build_gsa_from_file``) share one build from the staged codes.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from psac_tpu_torch import config as cfg_mod
from psac_tpu_torch.models.suffix_array import (_Builder, _decode_staged,
                                                _read, encode_and_shard,
                                                host_tensor, index_dtype_for,
                                                kmer_words_for)
from psac_tpu_torch.ops.alphabet import Alphabet
from psac_tpu_torch.ops.bitops import lcp_bitwise_words, pow2ceil
from psac_tpu_torch.parallel.collectives import (exscan_scalar,
                                                 global_cummax,
                                                 global_index_base,
                                                 global_shift_left,
                                                 halo_from_right, next_of,
                                                 prev_of, psum)
from psac_tpu_torch.parallel.mesh import (Rep, Sharded, num_shards,
                                          padded_size, run_on)
from psac_tpu_torch.parallel.route import (cap_for, gather_global,
                                           route_scatter)
from psac_tpu_torch.parallel.staging import (stage_file_block,
                                             staged_histogram)


@dataclasses.dataclass
class GeneralizedSuffixArray:
    """GSA over a string set: positions index the separator-removed flat
    text."""

    sa: np.ndarray
    lcp: np.ndarray | None
    alphabet: Alphabet
    lens: np.ndarray      # per-string lengths
    n: int

    @property
    def nstrings(self) -> int:
        return len(self.lens)


@dataclasses.dataclass
class DeviceGSA:
    """Device-resident GSA: (N,) padded arrays (real rows are the trailing
    n, as in ``DeviceSuffixArray``) plus the eos array and the encoded flat
    text, the inputs the generalized suffix tree needs.  On a mesh of p > 1
    shards (``mesh``) each is a ``parallel.mesh.Sharded`` array."""

    sa: torch.Tensor
    lcp: torch.Tensor | None
    eos: torch.Tensor
    xs: torch.Tensor
    alphabet: Alphabet
    lens: np.ndarray
    n: int
    N: int
    mesh: object = None

    @classmethod
    def from_numpy(cls, sa, lcp, eos, xs, alphabet, lens, n: int, N: int,
                   device, mesh=None) -> "DeviceGSA":
        """Wrap padded (N,) host arrays (e.g. the JAX package's ``DeviceGSA``
        after ``jax.device_get``, in its dtypes) as a device-resident
        result, on ``device`` or sharded over ``mesh`` (a mesh of one shard
        is its device)."""
        if mesh is not None and mesh.p == 1:
            device, mesh = mesh.devices[0], None

        def put(a):
            if a is None:
                return None
            t = torch.from_numpy(np.array(a))
            return mesh.shard(t) if mesh is not None else t.to(device)

        return cls(sa=put(sa), lcp=put(lcp), eos=put(eos), xs=put(xs),
                   alphabet=alphabet, lens=np.asarray(lens, np.int64), n=n,
                   N=N, mesh=mesh)

    def materialize(self) -> GeneralizedSuffixArray:
        off = self.N - self.n
        sa = host_tensor(self.sa)[off:].numpy().astype(np.int64)
        lcp = None
        if self.lcp is not None:
            lcp = host_tensor(self.lcp)[off:].numpy().astype(np.int64)
            if self.n > 0:
                lcp[0] = 0
        return GeneralizedSuffixArray(sa=sa, lcp=lcp, alphabet=self.alphabet,
                                      lens=self.lens, n=self.n)


class _GsaBuilder(_Builder):
    """Doubling builder threaded with the per-position eos array; its tail
    carries each record's end-of-string bound as a third buffer."""

    # ---------------- init: masked k-mer ranking ----------------

    def _ginit(self, ctx, codes, eos):
        s, N = self.s, self.N
        ks, bits = self.ks, self.bits
        win = torch.cat([codes, halo_from_right(codes, sum(ks) - 1,
                                                ctx=ctx)])
        gidx = self._gidx(ctx)
        words = []
        off = 0
        for kw in ks:
            w = torch.zeros(s, dtype=torch.int32, device=codes.device)
            for j in range(off, off + kw):
                c = torch.where(gidx + j < eos, win[j:j + s], 0)
                w = torch.bitwise_left_shift(w, bits) | c
            words.append(w)
            off += kw
        rem = eos - gidx
        # padding rows (word0 == 0: only all-past-end windows; real suffixes
        # start with a char >= 1) get unique final ranks before all real rows
        pad_rank = (N - gidx).to(torch.int32)
        words[-1] = torch.where(words[0] == 0, pad_rank, words[-1])
        # sort by (words, gidx) with rem as payload
        wsort, sa, (rem_s,) = self._sort_keys(ctx, words, gidx, (rem,))
        prevs = tuple(prev_of(w, ctx=ctx) for w in wsort)
        prev_rem = prev_of(rem_s, fill=0, ctx=ctx)
        newb = functools.reduce(
            torch.logical_or, (w != pw for w, pw in zip(wsort, prevs)))
        isa, brow, active, counts = self._rebucket_and_isa(ctx, newb, gidx,
                                                           sa)
        # row-aligned end-of-string bound for direct tail entry
        eos_row = sa + rem_s
        lcp0 = None
        if self.with_lcp:
            lcpv = lcp_bitwise_words(prevs, wsort, ks, bits).to(self.idt)
            lcpv = torch.minimum(torch.minimum(lcpv, prev_rem), rem_s)
            lcp0 = torch.where(newb, lcpv, N)
            lcp0 = torch.where(gidx == 0, 0, lcp0)
        return isa, sa, lcp0, brow, active, eos_row, counts

    def _ginit_local(self, codes, eos):
        return self._run(self._ginit, codes, eos)

    # ---------------- one doubling iteration ----------------

    def _gstep(self, ctx, isa, eos, lcp, d: int):
        N = self.N
        # past N every suffix has ended: d is capped there so the tensors'
        # dtype holds it (the shift of N is zero on every shard)
        d = min(d, N)
        gidx = self._gidx(ctx)
        b2 = global_shift_left(isa, d, ctx)
        b2 = torch.where(gidx + d < eos, b2, 0)
        # sort by (B, B2, gidx) with eos as payload
        (b_s, b2_s), sa, (eos_s,) = self._sort_keys(ctx, (isa, b2), gidx,
                                                    (eos,))
        pb, pb2 = prev_of(b_s, ctx=ctx), prev_of(b2_s, ctx=ctx)
        newb = (b_s != pb) | (b2_s != pb2)
        isa_new, b_new, _, _ = self._rebucket_and_isa(ctx, newb, gidx, sa)
        # GSA termination: settled = unique (B, B2) pair or fully-ended
        # suffix group (B2 == 0 ties can never split; their order is final)
        active = ~((newb & next_of(newb, True, ctx)) | (b2_s == 0))
        ue = Rep(psum(active.sum(), ctx))
        counts = (ue, ue)
        if not self.with_lcp:
            return isa_new, sa, None, None, b_new, active, eos_s, counts
        split = (b_s == pb) & (b2_s != pb2)
        zero = (pb2 == 0) | (b2_s == 0)
        lcp = torch.where(split & zero & (lcp == N), d, lcp)
        querycase = split & ~zero
        q = dict(qkey=torch.where(querycase, gidx, self.INF),
                 lq=torch.minimum(pb2, b2_s), rq=torch.maximum(pb2, b2_s) - 1,
                 jcol=torch.ones_like(gidx),
                 nq=Rep(psum(querycase.sum(), ctx)))
        return isa_new, sa, lcp, q, b_new, active, eos_s, counts

    def _gstep_local(self, isa, eos, lcp, d: int):
        return self._run(self._gstep, isa, eos, lcp, d)

    # ---------------- fused GSA construction ----------------

    def gfused_full(self, codes, eos, *, m_cap: int, m_cap2: int,
                    resolve_div: int):
        """masked k-mer init -> dense eos-masked doubling (the shared
        ``_fused_drive``) -> eos-aware two-stage sparse tail ->
        sentinel-LCP tie-fix at capscale 6.  Returns (isa, sa, lcp, stats)
        with the tie-fix's routing overflow count appended to the drive's
        stats (JAX ``_gfused_full_local``): where it is > 0 the caller
        reruns the fix at full capacity."""
        m_pad = max(8, self.s // resolve_div)
        isa, sa, lcp, brow, active, eos_row, counts = self._ginit_local(
            codes, eos)

        def dense_step(isa, lcp, extra, d):
            isa, sa, lcp, q, brow, active, eos_row, counts = \
                self._gstep_local(isa, eos, lcp, d)
            lcp, ub, ue = self._dense_resolve(lcp, q, counts, d, m_pad=m_pad,
                                              L=2)
            return isa, sa, lcp, brow, active, (eos_row,), ub, ue, d * 2

        isa, sa, lcp, _, _, _, stats = self._fused_drive(
            (isa, sa, lcp, brow, active, (eos_row,), *_read(*counts)),
            dense_step, m_cap=m_cap, m_cap2=m_cap2)
        tovf = 0
        if self.with_lcp:
            lcp, tovf = self._run(_lcp_tiefix, lcp, sa, eos, 6)
        return isa, sa, lcp, stats + (tovf,)

    # ---------------- host-driven GSA construction ----------------

    def ghost_full(self, codes, eos, *, tail_limit: int):
        """The JAX package's host-driven GSA loop: masked k-mer init, then
        eos-masked doubling steps (one stacked (nq, ue) readback each, the
        LCP resolve only when the step has queries: K6 on one device, the
        routed ``resolve_with_retry`` on a mesh) until 0 < ue <=
        ``tail_limit``, then the eos-aware tail at one capacity, the power
        of two above ue, and the sentinel-LCP tie-fix.  Returns (isa, sa,
        lcp)."""
        N = self.N
        isa, sa, lcp, brow, active, eos_row, counts = self._ginit_local(
            codes, eos)
        (ue,) = _read(counts[1])
        d = sum(self.ks)
        while ue > 0:
            if d >= 4 * N:
                raise AssertionError("GSA doubling failed to converge")
            if 0 < ue <= tail_limit:
                # the active count is ue from the last step: no readback
                m_cap = self._cap(max(8 * self.p, pow2ceil(ue)))
                cbufs = self._tail_enter_local(sa, brow, active, m_cap,
                                               extra=(eos_row,))
                while ue > 0:
                    cbufs, isa, sa, lcp, tue = self._tail_step_local(
                        cbufs, isa, sa, lcp, d)
                    (ue,) = _read(tue)
                    d *= 2
                    if d >= 8 * N:
                        raise AssertionError("GSA tail failed to converge")
                break
            isa, sa, lcp, q, brow, active, eos_row, counts = \
                self._gstep_local(isa, eos, lcp, d)
            if lcp is None:
                (ue,) = _read(counts[1])
            else:
                nq, ue = _read(q["nq"], counts[1])
                if nq > 0:
                    lcp = self._host_resolve(lcp, q, d, nq)
            d *= 2
        if self.with_lcp:
            lcp = _gsa_tiefix(self.mesh, lcp, sa, eos)
        return isa, sa, lcp


def _flatten(strings) -> tuple[bytes, np.ndarray]:
    """The separator-removed flat text and the per-string lengths of a list
    of byte strings, or of one newline-separated byte string; empty strings
    are dropped."""
    if isinstance(strings, (bytes, bytearray)):
        parts = [x for x in bytes(strings).split(b"\n") if x]
    else:
        parts = [bytes(x) for x in strings if len(x)]
    lens = np.array([len(x) for x in parts], np.int64)
    return b"".join(parts), lens


def _eos(ctx, starts, ends, n: int, s: int, idt: torch.dtype, device):
    """This shard's (s,) block of the per-position eos array (JAX
    ``_gsa_inputs_fn``), from the replicated (m,) string starts and ends:
    string ends are increasing, so each shard scatters the ends of the
    strings that start in its block and a global prefix max gives eos;
    positions g >= n take eos[g] = g (an empty suffix)."""
    dev = device if ctx is None else ctx.device
    base = global_index_base(s, ctx)
    loc = starts.to(dev) - base
    ok = (loc >= 0) & (loc < s)
    mark = torch.zeros(s + 1, dtype=idt, device=dev)
    mark.scatter_reduce_(0, torch.where(ok, loc, s),
                         torch.where(ok, ends.to(dev, idt), 0), "amax")
    g = torch.arange(base, base + s, dtype=idt, device=dev)
    return torch.where(g < n, global_cummax(mark[:s], ctx), g)


def _eos_device(lens: np.ndarray, n: int, N: int, idt: torch.dtype,
                device, mesh=None) -> torch.Tensor:
    """The (N,) eos array of strings of lengths ``lens`` on ``device``, or
    ``Sharded`` over ``mesh``; only the O(m) string boundaries go up."""
    ends = np.cumsum(lens)
    return run_on(mesh, _eos, torch.from_numpy(ends - lens),
                  torch.from_numpy(ends), n, N // num_shards(mesh), idt,
                  device)


def _lcp_tiefix(ctx, lcp, sa, eos, capscale: int | None):
    """Sentinel LCP rows (never-split groups of identical whole suffixes)
    take the suffix's full length, eos[SA[g]] - SA[g], the eos read from
    the shard that holds it (routed at ``cap_for(s, p, capscale)``).  A
    dropped (overflowed) row answers 0 where a real answer is >= 1, so it
    keeps the sentinel N and a full-capacity pass finds it.  Returns (lcp,
    the replicated overflow count)."""
    s = lcp.shape[0]
    p = 1 if ctx is None else ctx.p
    need = lcp == s * p
    eos_at_sa, ovf = gather_global(eos, sa, need, ctx=ctx,
                                   cap=cap_for(s, p, capscale),
                                   with_overflow=True)
    return torch.where(need & (eos_at_sa > 0), eos_at_sa - sa, lcp), \
        Rep(int(ovf))


def _gsa_tiefix(mesh, lcp, sa, eos, capscales=(6, None)):
    """The tie-fix with the reference's capacity escalation: capscale 6,
    then, only if rows were dropped, no bound (JAX ``_gsa_tiefix``)."""
    for capscale in capscales:
        lcp, ovf = run_on(mesh, _lcp_tiefix, lcp, sa, eos, capscale)
        if ovf == 0:
            break
    return lcp


def _decode(xb, alpha: Alphabet):
    """Staged uint8 bytes (a tensor, or ``Sharded``) -> int32 codes."""
    if isinstance(xb, Sharded):
        return xb.map(lambda t: _decode_staged(t, alpha))
    return _decode_staged(xb, alpha)


def _build_gsa_staged(xs, alpha: Alphabet, lens: np.ndarray, n: int, N: int,
                      config: cfg_mod.SAConfig, mesh=None) -> DeviceGSA:
    """The device-side GSA build shared by the in-memory and the file
    inputs: from the (N,) int32 codes of the separator-free flat text (on
    a device, or ``Sharded`` over ``mesh``) and the host string lengths,
    expand eos on the device(s), then run the construction: the fused path,
    redone on the host-driven loop when it does not converge, or the
    host-driven loop alone (``fused=False``).  Never packs sort keys, as in
    the JAX package."""
    if isinstance(xs, Sharded):
        device = None
    else:
        mesh, device = None, xs.device
    idt = index_dtype_for(N, config)
    eos = _eos_device(lens, n, N, idt, device, mesh)
    ks = kmer_words_for(alpha.bits_per_char, config)
    b = _GsaBuilder(N, ks, alpha.bits_per_char, config.construct_lcp, idt,
                    device, mesh=mesh)

    def result(sa, lcp):
        return DeviceGSA(sa=sa, lcp=lcp, eos=eos, xs=xs, alphabet=alpha,
                         lens=lens, n=n, N=N, mesh=mesh)

    if config.fused:
        m_cap2 = b._cap(max(8 * b.p, min(N, pow2ceil(max(256, N // 1024)))))
        m_cap = b._cap(max(m_cap2, min(N, pow2ceil(N // 32))))
        _, sa, lcp, (_, ue, _, _, tie_ovf) = b.gfused_full(
            xs, eos, m_cap=m_cap, m_cap2=m_cap2,
            resolve_div=config.resolve_div)
        if ue == 0:
            if tie_ovf > 0:
                # the fused tie-fix dropped rows: they kept the sentinel,
                # so the full-capacity pass finds them
                lcp = _gsa_tiefix(mesh, lcp, sa, eos, (None,))
            return result(sa, lcp)
        print(f"[psac_tpu_torch] fused GSA did not converge (ue={ue}); "
              "redoing the build on the host-driven loop", file=sys.stderr)
    _, sa, lcp = b.ghost_full(
        xs, eos, tail_limit=int(N * config.tail_threshold_frac))
    return result(sa, lcp)


def _build_gsa_flat(flat: bytes, lens: np.ndarray, device,
                    config: cfg_mod.SAConfig, mesh=None) -> DeviceGSA:
    """Stage the flat text raw (the histogram counted on the device, or on
    each shard's) and build."""
    if len(flat) == 0:
        raise ValueError("build_gsa_device: no string content")
    xs, alpha, n, N = encode_and_shard(flat, device, mesh)
    return _build_gsa_staged(xs, alpha, lens, n, N, config, mesh)


def build_gsa_device(strings, device=None,
                     config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                     mesh=None) -> DeviceGSA:
    """GSA (+GLCP) of a string set (a list of byte strings, or one
    newline-separated flat byte string as the reference's ``gsac -f``) on
    ``device`` (None: the CUDA card; ``"cpu"`` runs the plain versions), or
    on the p shards of ``mesh`` (``parallel.mesh.make_mesh``), which then
    replaces ``device``; the result stays there."""
    return _build_gsa_flat(*_flatten(strings), device, config, mesh)


def _drop_separators(ctx, fb, n_file: int, s_flat: int, nsep: int, sep: int,
                     idt: torch.dtype):
    """The file staging's separator drop on this shard's block of the
    staged file (JAX ``_gsac_stage_fn``): each byte's flat position is its
    file position less the separators before it (an in-shard exclusive
    count plus the shards' exclusive scan), one routed scatter writes the
    real bytes into the (s_flat,) blocks of the flat text, and the
    separators' file positions, each at its ordinal, come back replicated
    (the psum of the shards' zero-filled parts).  Returns (flat block,
    (nsep,) positions)."""
    dev = fb.device
    base = global_index_base(fb.shape[0], ctx)
    g = torch.arange(base, base + fb.shape[0], dtype=idt, device=dev)
    is_file = g < n_file
    msk = (fb == sep) & is_file
    mi = msk.to(idt)
    c = exscan_scalar(mi.sum().to(idt), ctx) + torch.cumsum(mi, 0,
                                                            dtype=idt) - mi
    (flat,) = route_scatter(g - c, (fb,),
                            (torch.zeros(s_flat, dtype=torch.uint8,
                                         device=dev),),
                            is_file & ~msk, ctx=ctx)
    at = torch.nonzero(msk).squeeze(1)
    seps = torch.zeros(nsep, dtype=idt, device=dev)
    seps[c[at].to(torch.int64)] = g[at]
    return flat, Rep(psum(seps, ctx))


def build_gsa_from_file(path: str, device=None,
                        config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                        sep: int = 0x0A, mesh=None) -> DeviceGSA:
    """GSA (+GLCP) of a ``sep``-delimited file (the reference's ``gsac
    -f``) on ``device`` (None: the CUDA card) or on the p shards of
    ``mesh``.  The file is staged raw, one read on a device and on a mesh
    each process reading only its own shards' byte ranges, and its bytes
    counted on the device(s), summed over the mesh; the separators are
    dropped there (``_drop_separators``), and only their positions (O(m)
    metadata) come back, to make the string lengths on the host.  Empty
    strings are dropped; a trailing separator is optional."""
    p = num_shards(mesh)
    if p == 1:
        device = mesh.devices[0] if mesh is not None else device
        mesh = None
        xbf, n_file, N_file = stage_file_block(
            path, cfg_mod.resolve_device(device))
        hist = staged_histogram(xbf)
    else:
        xbf, n_file, N_file = stage_file_block(path, mesh)
        hist = staged_histogram(xbf, mesh)
    nsep = int(hist[sep])
    n_flat = n_file - nsep
    if n_flat <= 0:
        raise ValueError(f"{path}: no string content")
    N_flat = padded_size(n_flat, p, multiple=8)
    hist2 = hist.copy()
    hist2[sep] = 0
    # the histogram ran over the file's padded staging, so its zero count
    # is the file padding (genuine NULs still raise)
    alpha = Alphabet.from_hist(hist2, pad_zeros=N_file - n_file)
    idt = index_dtype_for(max(N_file, N_flat), config)
    xb, sep_pos = run_on(mesh, _drop_separators, xbf, n_file, N_flat // p,
                         nsep, sep, idt)
    del xbf  # the file's staging is not needed by the build
    sep_pos = sep_pos.cpu().numpy().astype(np.int64)
    ends_flat = sep_pos - np.arange(nsep, dtype=np.int64)
    if nsep == 0 or sep_pos[-1] != n_file - 1:
        ends_flat = np.concatenate([ends_flat, [n_flat]])
    lens = np.diff(np.concatenate([[0], ends_flat]))
    lens = lens[lens > 0]
    return _build_gsa_staged(_decode(xb, alpha), alpha, lens, n_flat, N_flat,
                             config, mesh)


def build_gsa(strings, device=None,
              config: cfg_mod.SAConfig = cfg_mod.DEFAULT, mesh=None
              ) -> GeneralizedSuffixArray:
    """Host-facing GSA construction (the reference's ``gsac`` output) on
    ``device`` (None: the CUDA card) or on the p shards of ``mesh``."""
    flat, lens = _flatten(strings)
    if len(flat) == 0:
        return GeneralizedSuffixArray(
            sa=np.zeros(0, np.int64),
            lcp=np.zeros(0, np.int64) if config.construct_lcp else None,
            alphabet=Alphabet.from_bytes(flat), lens=lens, n=0)
    return _build_gsa_flat(flat, lens, device, config, mesh).materialize()
