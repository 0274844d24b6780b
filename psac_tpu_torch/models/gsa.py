"""Generalized suffix array (+LCP) over string sets on one device (port of
``psac_tpu/models/gsa.py`` at p = 1).

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

The dense loop's LCP resolve and the tail's run K6
(``ops.rmq.rmq_resolve``) as the suffix array's do.  Two drivers run the
steps, as in the JAX package: the fused path (``fused=True``), and the
host-driven loop (``fused=False``, and where the fused path does not
converge: it redoes the build).  The in-memory and the file input
(``build_gsa_from_file``) share one build from staged bytes.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from psac_tpu_torch import config as cfg_mod
from psac_tpu_torch.models.suffix_array import (_Builder, _decode_staged,
                                                _read, index_dtype_for,
                                                kmer_words_for)
from psac_tpu_torch.ops.alphabet import Alphabet
from psac_tpu_torch.ops.bitops import lcp_bitwise_words, pow2ceil
from psac_tpu_torch.parallel.collectives import (global_cummax,
                                                 global_shift_left_dyn,
                                                 halo_from_right, prev_of)
from psac_tpu_torch.parallel.mesh import padded_size, single_device
from psac_tpu_torch.parallel.sort import lex_perm
from psac_tpu_torch.parallel.staging import (stage_bytes_block,
                                             stage_file_block,
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
    text, the inputs the generalized suffix tree needs."""

    sa: torch.Tensor
    lcp: torch.Tensor | None
    eos: torch.Tensor
    xs: torch.Tensor
    alphabet: Alphabet
    lens: np.ndarray
    n: int
    N: int

    @classmethod
    def from_numpy(cls, sa, lcp, eos, xs, alphabet, lens, n: int, N: int,
                   device) -> "DeviceGSA":
        """Wrap padded (N,) host arrays (e.g. the JAX package's ``DeviceGSA``
        after ``jax.device_get``, in its dtypes) as a device-resident
        result."""

        def put(a):
            return None if a is None else \
                torch.from_numpy(np.array(a)).to(device)

        return cls(sa=put(sa), lcp=put(lcp), eos=put(eos), xs=put(xs),
                   alphabet=alphabet, lens=np.asarray(lens, np.int64), n=n,
                   N=N)

    def materialize(self) -> GeneralizedSuffixArray:
        off = self.N - self.n
        sa = self.sa[off:].cpu().numpy().astype(np.int64)
        lcp = None
        if self.lcp is not None:
            lcp = self.lcp[off:].cpu().numpy().astype(np.int64)
            if self.n > 0:
                lcp[0] = 0
        return GeneralizedSuffixArray(sa=sa, lcp=lcp, alphabet=self.alphabet,
                                      lens=self.lens, n=self.n)


class _GsaBuilder(_Builder):
    """Doubling builder threaded with the per-position eos array; its tail
    carries each record's end-of-string bound as a third buffer."""

    # ---------------- init: masked k-mer ranking ----------------

    def _ginit(self, ctx, codes, eos):
        s, N, idt = self.s, self.N, self.idt
        ks, bits = self.ks, self.bits
        win = torch.cat([codes, halo_from_right(codes, sum(ks) - 1)])
        gidx = self._gidx()
        words = []
        off = 0
        for kw in ks:
            w = torch.zeros(s, dtype=torch.int32, device=self.device)
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
        perm = lex_perm(words)
        wsort = tuple(w[perm] for w in words)
        sa, rem_s = perm.to(idt), rem[perm]
        prevs = tuple(prev_of(w) for w in wsort)
        prev_rem = prev_of(rem_s, fill=0)
        newb = functools.reduce(
            torch.logical_or, (w != pw for w, pw in zip(wsort, prevs)))
        isa, brow, active, counts = self._rebucket_and_isa(ctx, newb, gidx,
                                                           sa)
        # row-aligned end-of-string bound for direct tail entry
        eos_row = sa + rem_s
        lcp0 = None
        if self.with_lcp:
            lcpv = lcp_bitwise_words(prevs, wsort, ks, bits).to(idt)
            lcpv = torch.minimum(torch.minimum(lcpv, prev_rem), rem_s)
            lcp0 = torch.where(newb, lcpv, N)
            lcp0 = torch.where(gidx == 0, 0, lcp0)
        return isa, sa, lcp0, brow, active, eos_row, counts

    def _ginit_local(self, codes, eos):
        return self._run(self._ginit, codes, eos)

    # ---------------- one doubling iteration ----------------

    def _gstep_local(self, isa, eos, lcp, d: int):
        N, idt = self.N, self.idt
        # past N every suffix has ended: d is capped there so the tensors'
        # dtype holds it
        d = min(d, N)
        gidx = self._gidx()
        b2 = global_shift_left_dyn(isa, d)
        b2 = torch.where(gidx + d < eos, b2, 0)
        # sort by (B, B2, gidx) with eos as payload
        perm = lex_perm((isa, b2))
        b_s, b2_s, eos_s, sa = isa[perm], b2[perm], eos[perm], perm.to(idt)
        pb, pb2 = prev_of(b_s), prev_of(b2_s)
        newb = (b_s != pb) | (b2_s != pb2)
        isa_new, b_new, _, _ = self._rebucket_and_isa(None, newb, gidx, sa)
        # GSA termination: settled = unique (B, B2) pair or fully-ended
        # suffix group (B2 == 0 ties can never split; their order is final)
        nxt = torch.cat([newb[1:], newb.new_ones(1)])
        active = ~((newb & nxt) | (b2_s == 0))
        ue = active.sum()
        counts = (ue, ue)
        if not self.with_lcp:
            return isa_new, sa, None, None, b_new, active, eos_s, counts
        split = (b_s == pb) & (b2_s != pb2)
        zero = (pb2 == 0) | (b2_s == 0)
        lcp = torch.where(split & zero & (lcp == N), d, lcp)
        querycase = split & ~zero
        q = dict(qkey=torch.where(querycase, gidx, self.INF),
                 lq=torch.minimum(pb2, b2_s), rq=torch.maximum(pb2, b2_s) - 1,
                 jcol=torch.ones_like(gidx), nq=querycase.sum())
        return isa_new, sa, lcp, q, b_new, active, eos_s, counts

    # ---------------- fused GSA construction ----------------

    def gfused_full(self, codes, eos, *, m_cap: int, m_cap2: int,
                    resolve_div: int):
        """masked k-mer init -> dense eos-masked doubling (the shared
        ``_fused_drive``) -> eos-aware two-stage sparse tail ->
        sentinel-LCP tie-fix.  Returns (isa, sa, lcp, stats)."""
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
        if self.with_lcp:
            lcp = _lcp_tiefix_local(lcp, sa, eos, self.N)
        return isa, sa, lcp, stats

    # ---------------- host-driven GSA construction ----------------

    def ghost_full(self, codes, eos, *, tail_limit: int):
        """The JAX package's host-driven GSA loop at p = 1: masked k-mer
        init, then eos-masked doubling steps (one stacked (nq, ue) readback
        each, K6 only when the step has queries) until 0 < ue <=
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
                m_cap = min(N, max(8, pow2ceil(ue)))
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
                    lcp = self._resolve_fused_local(
                        lcp, q, d, m_pad=min(pow2ceil(nq), N), L=2, nq=nq)
            d *= 2
        if self.with_lcp:
            lcp = _lcp_tiefix_local(lcp, sa, eos, N)
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


def _eos_device(lens: np.ndarray, n: int, N: int, idt: torch.dtype,
                device) -> torch.Tensor:
    """The (N,) per-position eos array, expanded on the device from the
    string boundaries: string ends are increasing, so a scatter of each
    string's end at its start position and a prefix max give eos; padding
    positions g >= n take eos[g] = g (an empty suffix)."""
    ends_np = np.cumsum(lens)
    ends = torch.from_numpy(ends_np).to(device).to(idt)
    starts = torch.from_numpy(ends_np - lens).to(device)
    mark = torch.zeros(N, dtype=idt, device=device)
    mark[starts] = ends  # the starts are distinct (no empty strings)
    g = torch.arange(N, dtype=idt, device=device)
    return torch.where(g < n, global_cummax(mark), g)


def _lcp_tiefix_local(lcp, sa, eos, N: int) -> torch.Tensor:
    """Sentinel LCP rows (never-split groups of identical whole suffixes)
    take the suffix's full length, eos[SA[g]] - SA[g]: one gather."""
    need = lcp == N
    eos_at_sa = eos[sa.to(torch.int64).clamp(0, N - 1)]
    return torch.where(need & (eos_at_sa > 0), eos_at_sa - sa, lcp)


def _build_gsa_staged(xb: torch.Tensor, alpha: Alphabet, lens: np.ndarray,
                      n: int, N: int, config: cfg_mod.SAConfig) -> DeviceGSA:
    """The device-side GSA build shared by the in-memory and the file
    inputs: from the staged (N,) uint8 separator-free flat text and the
    host string lengths, decode the codes and expand eos on the device, then
    run the construction: the fused path, redone on the host-driven loop
    when it does not converge, or the host-driven loop alone
    (``fused=False``).  Never packs sort keys, as in the JAX package."""
    xs = _decode_staged(xb, alpha)
    idt = index_dtype_for(N, config)
    eos = _eos_device(lens, n, N, idt, xs.device)
    ks = kmer_words_for(alpha.bits_per_char, config)
    b = _GsaBuilder(N, ks, alpha.bits_per_char, config.construct_lcp, idt,
                    xs.device)
    if config.fused:
        m_cap2 = max(8, min(N, pow2ceil(max(256, N // 1024))))
        m_cap = max(m_cap2, min(N, pow2ceil(N // 32)))
        _, sa, lcp, (_, ue, _, _) = b.gfused_full(
            xs, eos, m_cap=m_cap, m_cap2=m_cap2,
            resolve_div=config.resolve_div)
        if ue == 0:
            return DeviceGSA(sa=sa, lcp=lcp, eos=eos, xs=xs, alphabet=alpha,
                             lens=lens, n=n, N=N)
        print(f"[psac_tpu_torch] fused GSA did not converge (ue={ue}); "
              "redoing the build on the host-driven loop", file=sys.stderr)
    _, sa, lcp = b.ghost_full(
        xs, eos, tail_limit=int(N * config.tail_threshold_frac))
    return DeviceGSA(sa=sa, lcp=lcp, eos=eos, xs=xs, alphabet=alpha,
                     lens=lens, n=n, N=N)


def _build_gsa_flat(flat: bytes, lens: np.ndarray, device,
                    config: cfg_mod.SAConfig) -> DeviceGSA:
    """Stage the flat text raw (the histogram counted on the device) and
    build."""
    if len(flat) == 0:
        raise ValueError("build_gsa_device: no string content")
    xb, n, N = stage_bytes_block(flat, cfg_mod.resolve_device(device))
    alpha = Alphabet.from_hist(staged_histogram(xb), pad_zeros=N - n)
    return _build_gsa_staged(xb, alpha, lens, n, N, config)


def build_gsa_device(strings, device=None,
                     config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                     mesh=None) -> DeviceGSA:
    """GSA (+GLCP) of a string set (a list of byte strings, or one
    newline-separated flat byte string as the reference's ``gsac -f``) on
    ``device`` (None: the CUDA card; ``"cpu"`` runs the plain versions);
    the result stays on the device.  A ``mesh`` of p > 1 raises (not
    ported yet)."""
    device = single_device(mesh, device, "build_gsa_device")
    return _build_gsa_flat(*_flatten(strings), device, config)


def build_gsa_from_file(path: str, device=None,
                        config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                        sep: int = 0x0A, mesh=None) -> DeviceGSA:
    """GSA (+GLCP) of a ``sep``-delimited file (the reference's ``gsac
    -f``) on ``device`` (None: the CUDA card).  The file is staged raw and
    counted on the device; the separators are dropped there by a mask and
    one compaction, and only their positions (O(m) metadata) come back, to
    make the string lengths on the host.  Empty strings are dropped; a
    trailing separator is optional.  A ``mesh`` of p > 1 raises (not
    ported yet)."""
    device = single_device(mesh, device, "build_gsa_from_file")
    xbf, n_file, N_file = stage_file_block(path,
                                           cfg_mod.resolve_device(device))
    hist = staged_histogram(xbf)
    nsep = int(hist[sep])
    n_flat = n_file - nsep
    if n_flat <= 0:
        raise ValueError(f"{path}: no string content")
    N_flat = padded_size(n_flat, multiple=8)
    hist2 = hist.copy()
    hist2[sep] = 0
    # the histogram ran over the file's padded staging, so its zero count
    # is the file padding (genuine NULs still raise)
    alpha = Alphabet.from_hist(hist2, pad_zeros=N_file - n_file)
    is_sep = xbf[:n_file] == sep
    xb = torch.zeros(N_flat, dtype=torch.uint8, device=xbf.device)
    xb[:n_flat] = xbf[:n_file][~is_sep]
    sep_pos = torch.nonzero(is_sep).squeeze(1).cpu().numpy().astype(np.int64)
    del xbf, is_sep  # the file's staging is not needed by the build
    ends_flat = sep_pos - np.arange(nsep, dtype=np.int64)
    if nsep == 0 or sep_pos[-1] != n_file - 1:
        ends_flat = np.concatenate([ends_flat, [n_flat]])
    lens = np.diff(np.concatenate([[0], ends_flat]))
    lens = lens[lens > 0]
    return _build_gsa_staged(xb, alpha, lens, n_flat, N_flat, config)


def build_gsa(strings, device=None,
              config: cfg_mod.SAConfig = cfg_mod.DEFAULT, mesh=None
              ) -> GeneralizedSuffixArray:
    """Host-facing GSA construction (the reference's ``gsac`` output) on
    ``device`` (None: the CUDA card).  A ``mesh`` of p > 1 raises (not
    ported yet)."""
    device = single_device(mesh, device, "build_gsa")
    flat, lens = _flatten(strings)
    if len(flat) == 0:
        return GeneralizedSuffixArray(
            sa=np.zeros(0, np.int64),
            lcp=np.zeros(0, np.int64) if config.construct_lcp else None,
            alphabet=Alphabet.from_bytes(flat), lens=lens, n=0)
    return _build_gsa_flat(flat, lens, device, config).materialize()
