"""Enhanced suffix array pattern index, the DESA (port of
``psac_tpu/models/desa.py`` at p = 1).

  * **TLLT** top-level lookup table: inclusive prefix sums of the k-mer
    histogram; ``lookup(P)`` gives the SA range of P's first k chars.
  * **TLDT** top-level index: the LCP rows sampled by the ANSV
    characterization of ``ops/sample_lcp.py`` (nearest smaller values on
    both sides: the block engine, kernel K5), searched like the slab.
  * **Slabs**: the SA/LCP/Lc rows of the text in one segment padded to a
    capacity (the JAX package's subtree-aligned layout with one shard).
  * **Blind search**: per pattern, walk the virtual suffix-tree intervals
    using only the leftmost-argmin RMQ over LCP and the left-branching
    characters Lc (``ops/blind_search.py``: kernel K7 on the card, one
    launch that walks each pattern to its end; the batched torch walk on
    the CPU).
  * **bulk_locate**: TLLT or TLDT lookup, blind search, then verification
    of one candidate row per pattern against the text.  Returns the exact
    half-open SA range of each pattern's matches.
  * **Persistence**: ``write_desa`` / ``read_desa`` keep SA/LCP/Lc as the
    JAX package's flat ``.sa64/.lcp64/.lc64/.alpha`` files (byte-identical;
    either package loads the other's); the top-level index, the partition
    and the RMQ are rebuilt on load.  ``build_desa_from_file`` and
    ``read_desa_from_file`` stage the text from a file.

Left out of this port: the per-process distributed writes and reads, the
multi-process fetch, the ``PSAC_TIMER`` lines of query-routing and
partition imbalance (shard statistics) and the ``PSAC_DESA_RUNGS`` switch
of the lockstep walk's compaction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from psac_tpu_torch import config as cfg_mod
from psac_tpu_torch import io as io_mod
from psac_tpu_torch.models.suffix_array import (compute_lc_device,
                                                construct_device,
                                                encode_and_shard,
                                                encode_and_shard_file)
from psac_tpu_torch.ops.alphabet import Alphabet
from psac_tpu_torch.ops.ansv import NEAREST_SM
from psac_tpu_torch.ops.bitops import pow2ceil
from psac_tpu_torch.ops.blind_search import blind_search
from psac_tpu_torch.ops.rmq import ArgLocalRMQ, build_arg_rmq
from psac_tpu_torch.parallel.ansv import (KERNELS, AnsvKernels, ansv_local,
                                          nonsv_for)
from psac_tpu_torch.parallel.collectives import halo_from_right
from psac_tpu_torch.parallel.mesh import single_device
from psac_tpu_torch.parallel.route import route_apply, route_scatter

_MAX_LEN_GROUPS = 3


def _length_groups(lens: np.ndarray,
                   max_groups: int = _MAX_LEN_GROUPS) -> list:
    """Partition pattern indices into <= ``max_groups`` contiguous
    pow2-length tiers, minimizing the total padded code volume
    sum_g(count_g * Lmax_g) by exact DP over the (few) distinct tiers."""
    tier = np.left_shift(
        1, np.ceil(np.log2(np.maximum(lens, 2))).astype(np.int64))
    uniq, inv = np.unique(tier, return_inverse=True)
    k = len(uniq)
    if k <= 1:
        return [np.arange(len(lens))]
    counts = np.bincount(inv, minlength=k)
    csum = np.concatenate([[0], np.cumsum(counts)])

    def seg_cost(i, j):  # tiers i..j inclusive, padded to uniq[j]
        return (csum[j + 1] - csum[i]) * int(uniq[j])

    G = min(max_groups, k)
    INF = float("inf")
    dp = [[INF] * k for _ in range(G + 1)]
    cut = [[-1] * k for _ in range(G + 1)]
    for j in range(k):
        dp[1][j] = seg_cost(0, j)
    for g in range(2, G + 1):
        for j in range(g - 1, k):
            for i in range(g - 1, j + 1):  # last segment = tiers i..j
                c = dp[g - 1][i - 1] + seg_cost(i, j)
                if c < dp[g][j]:
                    dp[g][j] = c
                    cut[g][j] = i
    # walk back the best full partition (fewer groups can win on volume ties
    # and save compiles)
    best_g = min(range(1, G + 1), key=lambda g: dp[g][k - 1])
    bounds = []
    g, j = best_g, k - 1
    while g > 1:
        i = cut[g][j]
        bounds.append(i)
        j, g = i - 1, g - 1
    bounds = [0] + bounds[::-1] + [k]
    seg_of_tier = np.zeros(k, np.int64)
    for si in range(len(bounds) - 1):
        seg_of_tier[bounds[si]:bounds[si + 1]] = si
    seg = seg_of_tier[inv]
    return [np.nonzero(seg == si)[0] for si in range(len(bounds) - 1)]


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def _kmer_hist_local(xs, *, n: int, k: int, bits: int, T: int,
                     idt: torch.dtype) -> torch.Tensor:
    """k-mer histogram of the text (positions < n, zero-padded past it)."""
    if k * bits >= 31:
        raise ValueError(f"k-mer of {k} x {bits} bits does not fit int32")
    s = xs.shape[0]
    win = torch.cat([xs, halo_from_right(xs, k - 1)])
    km = torch.zeros(s, dtype=torch.int32, device=xs.device)
    for j in range(k):
        km = (km << bits) | win[j:j + s]
    return torch.bincount(km[:n].long(), minlength=T).to(idt)


def _partition_from_prefix(ps: np.ndarray, n: int, p: int):
    """Host weighted 1-D partition at bin boundaries given inclusive prefix
    bin sizes (reference include/partition.hpp + desa.hpp:186-215)."""
    targets = (np.arange(1, p) * n) // p
    cuts = np.minimum(np.searchsorted(ps, targets, side="left"), len(ps) - 1)
    begins_np = np.zeros(p, np.int64)
    begins_np[1:] = ps[cuts]
    ends = np.concatenate([begins_np[1:], [n]])
    segs = ends - begins_np
    cap = max(8, -(-int(segs.max()) // 8) * 8)
    return begins_np, cap


def _reshard_local(lcp, sa, lc, *, n: int, cap: int, idt: torch.dtype):
    """Scatter the real SA/LCP/Lc rows into the padded slabs (one segment:
    real row g lands at slot g - (N - n)); the first real row's LCP is 0."""
    N = lcp.shape[0]
    off = N - n
    g = torch.arange(N, dtype=idt, device=lcp.device)
    real = g >= off
    slot = torch.where(real, g - off, 0)
    dev = lcp.device
    slabs = (torch.zeros(cap, dtype=idt, device=dev),
             torch.full((cap,), torch.iinfo(idt).max, dtype=idt, device=dev),
             torch.zeros(cap, dtype=torch.int32, device=dev))
    lcp_adj = torch.where(g == off, 0, lcp)
    return route_scatter(slot, (sa, lcp_adj, lc.to(torch.int32)), slabs, real)


def _sample_mask_local(lcp, *, n: int, maxsize: int,
                       kernels: AnsvKernels = KERNELS) -> torch.Tensor:
    """LCP-sampling mask by ANSV (see ``ops/sample_lcp.py`` for the
    characterization); ``kernels=PLAIN`` runs the kernels' plain
    versions."""
    idt = lcp.dtype
    inf = nonsv_for(idt)
    N = lcp.shape[0]
    off = N - n
    g = torch.arange(N, dtype=idt, device=lcp.device)
    real = g >= off
    lcp_adj = torch.where(real, lcp, -1)
    lcp_adj = torch.where(g == off, 0, lcp_adj)
    lidx, _, ridx, _ = ansv_local(lcp_adj, NEAREST_SM, NEAREST_SM, kernels)
    L = torch.clamp(torch.where(lidx == inf, off, lidx), min=off)
    R = torch.where(ridx == inf, N, ridx)
    return real & ((g == off) | (lcp_adj == 0) | ((R - L) > maxsize))


def _sample_compact_local(keep, lcp, lc, *, n: int):
    """The sampled rows in SA order: (text-offset row, LCP, Lc); the first
    real row's LCP is 0."""
    N = lcp.shape[0]
    off = N - n
    rows = torch.nonzero(keep).squeeze(1)
    lcp_adj = torch.where(rows == off, 0, lcp[rows])
    return (rows - off).to(lcp.dtype), lcp_adj, lc[rows].to(torch.int32)


@dataclasses.dataclass
class DESA:
    """Device-resident pattern index of one text."""

    alphabet: Alphabet
    n: int
    N: int
    k: int                    # TLLT k-mer length (= minmatch)
    table: torch.Tensor       # (T,) inclusive k-mer prefix sums
    begins: torch.Tensor      # (1,) segment start (SA row space)
    begins_np: np.ndarray
    cap: int                  # segment capacity
    sa: torch.Tensor          # (cap,) SA rows
    lcp: torch.Tensor
    lc: torch.Tensor
    rmq: ArgLocalRMQ          # leftmost-argmin RMQ over ``lcp``
    xs: torch.Tensor          # (N,) encoded text (verification)
    tli: str = "tllt"         # top-level index kind: "tllt" or "tldt"
    samp: dict | None = None  # tldt: sampled-LCP search structure
    idt: torch.dtype = torch.int32  # index dtype
    #: the last query batch's blind-search steps (each search's longest
    #: walk, summed over the searches) and the plain walk's host readbacks
    last_stats: dict = dataclasses.field(default_factory=dict)

    # ---------------- queries ----------------

    def encode_patterns(self, patterns):
        """Host: encode byte patterns to a padded (B, Lmax) code matrix."""
        B = len(patterns)
        lens = np.fromiter((len(pt) for pt in patterns), np.int64, B)
        Lmax = pow2ceil(max(2, int(lens.max()) if B else 2))
        flat = np.frombuffer(b"".join(bytes(pt) for pt in patterns), np.uint8)
        codes = self.alphabet.mapping[flat].astype(np.int32)
        ends = np.cumsum(lens)
        starts = ends - lens
        row = np.repeat(np.arange(B, dtype=np.int64), lens)
        col = np.arange(len(flat), dtype=np.int64) - np.repeat(starts, lens)
        mat = np.zeros((B, Lmax), np.int32)
        mat[row, col] = codes
        # bad = empty pattern or any character outside the alphabet (code 0)
        zero_cum = np.concatenate([[0], np.cumsum(codes == 0)])
        bad = (lens == 0) | ((zero_cum[ends] - zero_cum[starts]) > 0)
        return mat, lens.astype(np.int32), bad

    def bulk_locate(self, patterns) -> np.ndarray:
        """Exact half-open SA ranges [l, r) for a batch of byte patterns:
        SA rows l..r-1 hold every occurrence position of each pattern
        (empty range = no occurrence)."""
        return self._run_query(patterns, verify=True)

    def bulk_locate_possible(self, patterns) -> np.ndarray:
        """Candidate SA ranges without text verification (the reference's
        ``locate_possible``): may be a spurious non-empty range when the
        pattern does not occur."""
        return self._run_query(patterns, verify=False)

    def locate(self, pattern) -> np.ndarray:
        """Single-pattern exact SA range."""
        return self.bulk_locate([pattern])[0]

    def locate_possible(self, pattern) -> np.ndarray:
        """Single-pattern candidate range without verification."""
        return self.bulk_locate_possible([pattern])[0]

    def _run_query(self, patterns, verify: bool) -> np.ndarray:
        """Length-bucketed dispatch: ragged batches are split into at most
        ``_MAX_LEN_GROUPS`` Lmax tiers before padding, so one long pattern
        cannot inflate the whole (B, Lmax) code matrix."""
        stats = self.last_stats = {"steps": 0, "readbacks": 0,
                                   "step_max": []}
        if len(patterns) == 0:
            out = np.zeros((0, 2), np.int64)
        else:
            lens = np.fromiter((len(pt) for pt in patterns), np.int64,
                               len(patterns))
            groups = _length_groups(lens)
            if len(groups) == 1:
                out = self._run_query_group(patterns, verify)
            else:
                out = np.zeros((len(patterns), 2), np.int64)
                for idx in groups:
                    out[idx] = self._run_query_group(
                        [patterns[i] for i in idx], verify)
        # steps: the longest walk of each blind search, summed over them
        step_max = stats.pop("step_max")
        if step_max:
            stats["steps"] = int(torch.stack(step_max).sum())
        return out

    def _run_query_group(self, patterns, verify: bool) -> np.ndarray:
        mat, lens, bad = self.encode_patterns(patterns)
        dev = self.xs.device
        dmat = torch.from_numpy(mat).to(dev)
        dlens = torch.from_numpy(lens).to(dev)
        run = _bulk_locate_local if self.tli == "tllt" else \
            _bulk_locate_tldt_local
        l, r = run(dmat, dlens, self, verify, self.last_stats)
        out = torch.stack([l, r], dim=1).cpu().numpy().astype(np.int64)
        out[bad] = 0
        return out


def build_desa(text, device=None,
               config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
               tli_bits: int = 24, tli: str = "tllt",
               maxsize: int | None = None, mesh=None) -> DESA:
    """Construct the DESA of a byte text on ``device`` (None: the CUDA
    card; ``"cpu"`` runs the plain versions): SA+LCP+Lc, the top-level
    index (TLLT or TLDT), the slabs and the RMQ.  A ``mesh`` of p > 1
    raises (not ported yet)."""
    device = single_device(mesh, device, "build_desa")
    if not (isinstance(text, (bytes, bytearray))
            or np.asarray(text).dtype == np.uint8):
        # a TLLT of (sigma bits)^k entries over a wide integer alphabet
        # would be enormous; the DESA is a byte-text index
        raise ValueError("build_desa requires a byte text "
                         "(bytes or uint8 array); got dtype "
                         f"{np.asarray(text).dtype}")
    xs, alpha, n, N = encode_and_shard(text, device)
    return _build_from_codes(xs, alpha, n, N, config, tli_bits, tli, maxsize)


def build_desa_from_file(path: str, device=None,
                         config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                         tli_bits: int = 24, tli: str = "tllt",
                         maxsize: int | None = None, mesh=None) -> DESA:
    """``build_desa`` of a file's bytes: the file is staged raw on
    ``device`` (None: the CUDA card) and its alphabet counted there.  A
    ``mesh`` of p > 1 raises (not ported yet)."""
    device = single_device(mesh, device, "build_desa_from_file")
    xs, alpha, n, N = encode_and_shard_file(path, device)
    return _build_from_codes(xs, alpha, n, N, config, tli_bits, tli, maxsize)


def _build_from_codes(xs, alpha, n: int, N: int, config, tli_bits: int,
                      tli: str, maxsize: int | None) -> DESA:
    dsa = construct_device(xs, alpha, n, N, config)
    lc = dsa.lc if dsa.lc is not None else compute_lc_device(dsa, xs)
    return _assemble_desa(xs, alpha, n, N, dsa.lcp, dsa.sa, lc, tli_bits,
                          tli, maxsize, force_int64=config.force_int64)


def _assemble_desa(xs, alpha, n: int, N: int, lcp, sa, lc, tli_bits: int,
                   tli: str = "tllt", maxsize: int | None = None,
                   force_int64: bool = False) -> DESA:
    """Top-level index + slabs + RMQ from the padded (N,) SA/LCP/Lc.

    The slabs, ``table``, ``begins`` and the answers carry the index dtype
    (int64 at N >= 2^30 or with ``force_int64``); in-slab offsets, pattern
    codes and Lc stay int32."""
    idt = torch.int64 if force_int64 else cfg_mod.index_dtype(N)
    lcp, sa = lcp.to(idt), sa.to(idt)
    bits = alpha.bits_per_char
    # k-mer depth of the top-level table: the reference's 2^24-entry budget,
    # capped so tiny inputs don't allocate a table vastly larger than the text
    k = max(1, min(tli_bits // bits, 12))
    while k > 1 and (1 << (k * bits)) > max(1024, 4 * n):
        k -= 1
    samp = None
    table = torch.zeros(1, dtype=idt, device=xs.device)

    if tli == "tllt":
        T = 1 << (k * bits)
        table = torch.cumsum(
            _kmer_hist_local(xs, n=n, k=k, bits=bits, T=T, idt=idt), 0,
            dtype=idt)
        begins_np, cap = _partition_from_prefix(table.cpu().numpy(), n, 1)
    elif tli == "tldt":
        # sampled-LCP top-level trie (reference tldt, maxsize = n/p/128)
        ms = maxsize or max(2, n // 128)
        keep = _sample_mask_local(lcp, n=n, maxsize=ms)
        offs, s_lcp, s_lc = _sample_compact_local(keep, lcp, lc, n=n)
        m = offs.shape[0]
        if m < 2:
            raise ValueError("tldt sampling produced < 2 rows; lower maxsize")
        M = max(8, pow2ceil(m))
        samp_lcp = torch.full((M,), torch.iinfo(idt).max, dtype=idt,
                              device=xs.device)
        samp_lcp[:m] = s_lcp
        samp_lc = torch.zeros(M, dtype=torch.int32, device=xs.device)
        samp_lc[:m] = s_lc
        off_ext = torch.full((M + 1,), n, dtype=idt, device=xs.device)
        off_ext[:m] = offs
        samp = {"off_ext": off_ext, "lcp": samp_lcp, "lc": samp_lc,
                "rmq": build_arg_rmq(samp_lcp), "m": m, "M": M}
        ps = np.concatenate([offs[1:].cpu().numpy(), [n]]).astype(np.int64)
        begins_np, cap = _partition_from_prefix(ps, n, 1)
    else:
        raise ValueError(f"unknown tli kind {tli!r}")

    begins = torch.from_numpy(begins_np).to(idt).to(xs.device)
    sa_slab, lcp_slab, lc_slab = _reshard_local(lcp, sa, lc, n=n, cap=cap,
                                                idt=idt)
    return DESA(alphabet=alpha, n=n, N=N, k=k, table=table, begins=begins,
                begins_np=begins_np, cap=cap, sa=sa_slab, lcp=lcp_slab,
                lc=lc_slab, rmq=build_arg_rmq(lcp_slab), xs=xs, tli=tli,
                samp=samp, idt=idt)


def desa_arrays(desa: DESA):
    """Host (n,) SA/LCP/Lc arrays in SA order (slab padding stripped)."""
    return tuple(slab[:desa.n].cpu().numpy().astype(np.int64)
                 for slab in (desa.sa, desa.lcp, desa.lc))


def write_desa(desa: DESA, prefix: str) -> None:
    """Persist the index as ``.sa64/.lcp64/.lc64/.alpha`` (the top-level
    index, the partition and the RMQ are rebuilt on load, as the
    reference's ``dist_desa::write``, ``include/desa.hpp:366-397``)."""
    sa, lcp, lc = desa_arrays(desa)
    io_mod.write_u64(prefix + ".sa64", sa)
    io_mod.write_u64(prefix + ".lcp64", lcp)
    io_mod.write_u64(prefix + ".lc64", lc)
    io_mod.write_alphabet(prefix, desa.alphabet)


def _load_index(xs, alpha, n: int, N: int, prefix: str, tli_bits: int,
                tli: str, maxsize: int | None, force_int64: bool) -> DESA:
    """The persisted SA/LCP/Lc, front-padded to the (N,) construction
    layout on the codes' device, assembled with a top-level index chosen
    now."""
    sa = io_mod.read_u64(prefix + ".sa64")
    if len(sa) != n:
        raise ValueError(f"index built for n={len(sa)}, text has n={n}")
    idt = torch.int64 if force_int64 else cfg_mod.index_dtype(N)

    def pad_block(a, dt):
        full = torch.zeros(N, dtype=dt)
        full[N - n:] = torch.from_numpy(a).to(dt)
        return full.to(xs.device)

    return _assemble_desa(
        xs, alpha, n, N, pad_block(io_mod.read_u64(prefix + ".lcp64"), idt),
        pad_block(sa, idt),
        pad_block(io_mod.read_u64(prefix + ".lc64"), torch.int32), tli_bits,
        tli, maxsize, force_int64=force_int64)


def read_desa(text, prefix: str, device=None, tli_bits: int = 24,
              tli: str = "tllt", maxsize: int | None = None,
              force_int64: bool = False) -> DESA:
    """Load a persisted DESA (it needs the original text, as the
    reference's ``desa-main -l`` does) on ``device`` (None: the CUDA card);
    ``tli``/``maxsize`` select the top-level index rebuilt on load."""
    xs, alpha, n, N = encode_and_shard(text, device)
    return _load_index(xs, alpha, n, N, prefix, tli_bits, tli, maxsize,
                       force_int64)


def read_desa_from_file(text_path: str, prefix: str, device=None,
                        tli_bits: int = 24, tli: str = "tllt",
                        maxsize: int | None = None,
                        force_int64: bool = False) -> DESA:
    """``read_desa`` with the text staged from a file."""
    xs, alpha, n, N = encode_and_shard_file(text_path, device)
    return _load_index(xs, alpha, n, N, prefix, tli_bits, tli, maxsize,
                       force_int64)


# --------------------------------------------------------------------------
# queries
# --------------------------------------------------------------------------

def _tli_lookup(mat, lens, table, k: int, bits: int):
    """Vectorized TLLT lookup (reference lookup_table.hpp:113-148).

    mat: (b, Lmax) int32 codes (0 beyond each length); returns the
    half-open ranges (lo, hi) in the table's dtype."""
    b, Lmax = mat.shape
    T = table.shape[0]
    chars = mat[:, :k] if k <= Lmax else torch.nn.functional.pad(
        mat, (0, k - Lmax))
    km = torch.zeros(b, dtype=torch.int32, device=mat.device)
    for j in range(k):
        km = (km << bits) | chars[:, j]
    extra = (k - lens).clamp(min=0)
    hi_add = torch.where(
        extra > 0, torch.bitwise_left_shift(torch.ones_like(extra),
                                            extra * bits) - 1, 0)
    lo = torch.where(km == 0, 0, table[(km - 1).clamp(0, T - 1)])
    hi = table[(km + hi_add).clamp(0, T - 1)]
    return lo, hi


def _search(pat, lens, l0, r0, need, lcp, lc, rmq: ArgLocalRMQ, cap: int,
            stats: dict):
    """The blind search (K7 on the card, its plain version on the CPU);
    each pattern's step count stays on the device until the batch's
    results are read back (``DESA._run_query``)."""
    l, r, q, nsteps = blind_search(pat, lens, l0, r0, need, lcp, lc, rmq, cap,
                                   stats)
    stats["step_max"].append(nsteps.max())
    return l, r, q


def _verify_match(rp, rlen, ver_row, sa_slab, xs, *, Lmax: int, n: int,
                  cap: int):
    """Text verification of one candidate row per pattern: gather the
    pattern-length window of the text starting at SA[ver_row] and
    compare."""
    N = xs.shape[0]
    sal = sa_slab[ver_row.clamp(0, cap - 1)]
    M = ver_row.shape[0]
    cols = torch.arange(Lmax, device=xs.device)
    pos = sal.to(torch.int64)[:, None] + cols[None, :]
    in_pat = cols[None, :] < rlen[:, None]
    in_text = pos < n
    flatpos = torch.where(in_text, pos, 0).clamp(0, N - 1).reshape(-1)

    def gather(recv, recv_valid):
        (q,) = recv
        return (xs[q],)

    (got,) = route_apply((flatpos,), gather)
    okc = torch.where(in_pat, in_text & (got.view(M, Lmax) == rp), True)
    return okc.all(dim=1)


def _locate_in_slab(rp, rlen, rlo, rhi, need_q, search, desa: DESA,
                    verify: bool, stats: dict, finished=None):
    """The owner's part of a query: blind search of the candidate SA range
    [rlo, rhi) on the slab and verification of one row.  Returns the
    in-slab (l_loc, fl, fr, match)."""
    begin = int(desa.begins_np[0])
    cap = desa.cap
    # in-slab coordinates are int32 (cap < 2^31) even for int64 indexes
    l_loc = (rlo - begin).clamp(0, cap - 1).to(torch.int32)
    r_loc = (rhi - 1 - begin).clamp(0, cap - 1).to(torch.int32)
    search = search & (l_loc < r_loc)
    fl, fr, _ = _search(rp, rlen, l_loc, r_loc, search, desa.lcp, desa.lc,
                        desa.rmq, cap, stats)
    fl = torch.where(search, fl, l_loc)
    fr = torch.where(search, fr, r_loc)
    if verify:
        ver_row = fl if finished is None else torch.where(finished, l_loc, fl)
        match = _verify_match(rp, rlen, ver_row, desa.sa, desa.xs,
                              Lmax=rp.shape[1], n=desa.n, cap=cap)
    else:
        match = torch.ones_like(need_q)
    return fl, fr, match


def _bulk_locate_local(mat, lens, desa: DESA, verify: bool, stats: dict):
    """bulk_locate with the TLLT: the table gives each pattern's range of
    its first k chars; longer patterns continue by blind search."""
    idt, k, begin = desa.idt, desa.k, int(desa.begins_np[0])
    lo, hi = _tli_lookup(mat, lens, desa.table, k,
                         desa.alphabet.bits_per_char)
    need = (lens > k) & (lo < hi)

    def answer(recv, recv_valid):
        rp, rlen, rlo, rhi = recv
        need_q = recv_valid & (rlen > k) & (rlo < rhi)
        fl, fr, match = _locate_in_slab(rp, rlen, rlo, rhi, need_q, need_q,
                                        desa, verify, stats)
        out_l = fl.to(idt) + begin
        out_r = torch.where(need_q & match, fr.to(idt) + begin + 1, out_l)
        return (torch.where(need_q, out_l, 0), torch.where(need_q, out_r, 0))

    al, ar = route_apply((mat, lens, lo, hi), answer)
    return torch.where(need, al, lo), torch.where(need, ar, hi)


def _bulk_locate_tldt_local(mat, lens, desa: DESA, verify: bool,
                            stats: dict):
    """bulk_locate with the TLDT (reference ``tldt::lookup``): the sampled
    LCP rows are searched first; if that consumed the whole pattern the
    owner only verifies, otherwise it continues the search on the slab.
    Every result is verified against the text."""
    idt, begin = desa.idt, int(desa.begins_np[0])
    samp = desa.samp
    M_samp = samp["M"]
    zero = torch.zeros_like(lens)
    need0 = lens > 0
    ls, rs, qf = _search(mat, lens, zero, zero + (samp["m"] - 1), need0,
                         samp["lcp"], samp["lc"], samp["rmq"], M_samp, stats)
    glo = samp["off_ext"][ls.clamp(0, M_samp)]
    ghi = samp["off_ext"][(rs + 1).clamp(0, M_samp)]
    finished = (qf >= lens) | (ghi <= glo)
    need = need0 & (glo < ghi)

    def answer(recv, recv_valid):
        rp, rlen, rlo, rhi, rfin = recv
        need_q = recv_valid & (rlen > 0) & (rlo < rhi)
        fl, fr, match = _locate_in_slab(rp, rlen, rlo, rhi, need_q,
                                        need_q & ~rfin, desa, verify, stats,
                                        finished=rfin)
        out_l = torch.where(rfin, rlo, fl.to(idt) + begin)
        out_r_full = torch.where(rfin, rhi, fr.to(idt) + begin + 1)
        out_r = torch.where(need_q & match, out_r_full, out_l)
        return (torch.where(need_q, out_l, 0), torch.where(need_q, out_r, 0))

    al, ar = route_apply((mat, lens, glo, ghi, finished), answer)
    # unrouted patterns have an empty lookup range -> empty result
    return torch.where(need, al, glo), torch.where(need, ar, glo)
