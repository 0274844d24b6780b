"""Enhanced suffix array pattern index, the DESA (port of
``psac_tpu/models/desa.py``), on one device or on a mesh of p shards.

  * **TLLT** top-level lookup table: inclusive prefix sums of the k-mer
    histogram (each shard counts the k-mers that start in its block, their
    tails read from a halo, and the counts are summed), replicated on every
    shard; ``lookup(P)`` gives the SA range of P's first k chars.
  * **TLDT** top-level index: the LCP rows sampled by the ANSV
    characterization of ``ops/sample_lcp.py`` (nearest smaller values on
    both sides: the block engine, kernel K5, and on a mesh the routed walks
    of ``parallel.ansv.ansv_mesh_local``), replicated on every shard and
    searched like a slab.
  * **Subtree-aligned slabs**: the SA/LCP/Lc rows redistributed by one
    routed scatter so that each top-level bucket lies wholly on one shard
    (the reference's weighted 1-D partition, ``include/desa.hpp:128-216``),
    each shard's segment padded to a common capacity, with a
    leftmost-argmin RMQ per slab.
  * **Blind search**: per pattern, walk the virtual suffix-tree intervals
    using only the RMQ over LCP and the left-branching characters Lc
    (``ops/blind_search.py``: kernel K7 on the card, one launch that walks
    each pattern to its end; the batched torch walk on the CPU).
  * **bulk_locate**: the top-level lookup at the pattern's origin shard,
    then one routed pass (``route_apply`` in p chunks) to the owner of the
    pattern's bucket, which runs the blind search on its slab and verifies
    one candidate row against the block-distributed text with a nested
    routed gather (this also verifies occurrences that cross a shard
    boundary); the answers ride back.  Returns the exact half-open SA range
    of each pattern's matches.
  * **Persistence**: ``write_desa`` / ``read_desa`` keep SA/LCP/Lc as the
    JAX package's flat ``.sa64/.lcp64/.lc64/.alpha`` files (byte-identical
    at every p; either package loads the other's); the top-level index, the
    partition and the RMQ are rebuilt on load.  ``write_desa_distributed``
    writes the same files with each process writing only its own slabs'
    segments (a mesh that spans processes); the loads, and
    ``build_desa_from_file``, stage the text and the files per shard, each
    process reading only its own shards' byte ranges.

Every step is one shard function for every p: ``ctx`` is None on one
device, where the collectives take their p = 1 forms, and the callers reach
it through ``parallel.mesh.run_on``.  With ``PSAC_TIMER=1`` the build
prints the partition imbalance and each query group its routing imbalance
(the JAX package's ``[timer] [desa]`` lines); ``PSAC_DESA_RUNGS`` sets the
plain walk's compaction rungs (``ops.blind_search.rung_widths``).  On a
mesh that spans processes every process holds the whole pattern batch and
gets every answer (``parallel.dist.process_allgather``), as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys

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
from psac_tpu_torch.ops.pattern_pack import pattern_pack
from psac_tpu_torch.ops.rmq import ArgLocalRMQ, block_size_for, build_arg_rmq
from psac_tpu_torch.parallel.ansv import (KERNELS, AnsvKernels, ansv_local,
                                          ansv_mesh_local, nonsv_for)
from psac_tpu_torch.parallel.collectives import (global_index_base,
                                                 halo_from_right, psum)
from psac_tpu_torch.parallel.dist import process_allgather, process_index
from psac_tpu_torch.parallel.mesh import (Rep, Replicated, Sharded,
                                          num_shards, run_on)
from psac_tpu_torch.parallel.route import (gather_global, route_apply,
                                           route_scatter)
from psac_tpu_torch.utils import timers
from psac_tpu_torch.utils.timers import timers_enabled

_MAX_LEN_GROUPS = 3


def _tier(n: int) -> int:
    """The padded width of a pattern of length ``n``."""
    return pow2ceil(max(2, int(n)))


def _length_groups(lens: np.ndarray,
                   max_groups: int = _MAX_LEN_GROUPS) -> list:
    """Partition pattern indices into <= ``max_groups`` contiguous
    pow2-length tiers, minimizing the total padded code volume
    sum_g(count_g * Lmax_g) by exact DP over the (few) distinct tiers."""
    if len(lens) == 0 or _tier(lens.min()) == _tier(lens.max()):
        return [np.arange(len(lens))]
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


class _Group(list):
    """A query group's patterns with their int64 lengths, counted once a
    batch (``DESA._run_query``), so that ``encode_patterns`` does not
    count them again."""

    __slots__ = ("lens",)

    def __init__(self, patterns, lens: np.ndarray):
        super().__init__(patterns)
        self.lens = lens


def _joined(patterns) -> np.ndarray:
    """The patterns' bytes end to end, a writable uint8 array: one join in
    C, or ``bytes`` of each pattern where some is not a contiguous buffer
    (a list of ints, a strided view)."""
    try:
        buf = bytearray().join(patterns)
    except TypeError:
        buf = bytearray().join(bytes(pt) for pt in patterns)
    return np.frombuffer(buf, np.uint8)


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def _nshards(ctx) -> int:
    return 1 if ctx is None else ctx.p


def _one_device(mesh, device):
    """An entry point's (mesh, device): a mesh of one shard is its
    device."""
    if mesh is not None and mesh.p == 1:
        return None, mesh.devices[0]
    return mesh, device


def _replicas(x):
    """A shard function's copies of a replicated array as ``Replicated``
    (on one device the tensor itself)."""
    return Replicated(x.shards, x.first, x.p) if isinstance(x, Sharded) \
        else x


def _replicate(mesh, x: torch.Tensor, device):
    """``x`` on ``device`` without a mesh, a copy per shard on a mesh."""
    return x.to(device) if mesh is None else mesh.replicate(x)


def _whole(x) -> torch.Tensor:
    """A shard function's output whole on every process: a ``Sharded``
    one gathered to the host in shard order (from every process that
    holds blocks of it), the local copy of a ``Replicated`` one, a tensor
    of one device as it is."""
    return process_allgather(x) if isinstance(x, Sharded) else x


def _kmer_table(ctx, xs, *, n: int, k: int, bits: int, T: int,
                idt: torch.dtype) -> torch.Tensor:
    """This shard's copy of the TLLT: the inclusive prefix sums of the
    k-mer histogram of the text (positions < n, zero-padded past it), each
    shard counting the k-mers that start in its block (JAX
    ``_kmer_hist_local``)."""
    if k * bits >= 31:
        raise ValueError(f"k-mer of {k} x {bits} bits does not fit int32")
    s = xs.shape[0]
    win = torch.cat([xs, halo_from_right(xs, k - 1, ctx=ctx)])
    km = torch.zeros(s, dtype=torch.int32, device=xs.device)
    for j in range(k):
        km = (km << bits) | win[j:j + s]
    real = min(s, max(0, n - global_index_base(s, ctx)))
    hist = torch.bincount(km[:real].long(), minlength=T).to(idt)
    return torch.cumsum(psum(hist, ctx), 0, dtype=idt)


def _partition_from_prefix(ps: np.ndarray, n: int, p: int):
    """Host weighted 1-D partition at bin boundaries given inclusive prefix
    bin sizes (reference include/partition.hpp + desa.hpp:186-215); with
    ``PSAC_TIMER`` it prints the imbalance, as the reference does at
    construction (include/desa.hpp:169-183)."""
    targets = (np.arange(1, p) * n) // p
    cuts = np.minimum(np.searchsorted(ps, targets, side="left"), len(ps) - 1)
    begins_np = np.zeros(p, np.int64)
    begins_np[1:] = ps[cuts]
    ends = np.concatenate([begins_np[1:], [n]])
    segs = ends - begins_np
    cap = max(8, -(-int(segs.max()) // 8) * 8)
    if timers_enabled() and p > 0:
        print(f"[timer] [desa] partition imbalance: max={int(segs.max())} "
              f"avg={n / p:.0f} factor={segs.max() * p / max(n, 1):.3f}",
              file=sys.stderr, flush=True)
    return begins_np, cap


def _owner(begins: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The shard whose segment holds each SA row: the last one whose
    segment begins at or before it (int32)."""
    return (torch.searchsorted(begins, rows, right=True) - 1).to(torch.int32)


def _reshard_local(ctx, lcp, sa, lc, begins, *, n: int, cap: int,
                   idt: torch.dtype):
    """This shard's (cap,) SA/LCP/Lc slabs (JAX ``_reshard_local``): each
    real row goes to the shard whose segment holds it, at its offset in the
    segment, by one routed scatter; the first real row's LCP is 0, and
    empty slots hold SA 0, LCP INF and Lc 0."""
    lcp, sa = lcp.to(idt), sa.to(idt)
    s, dev = lcp.shape[0], lcp.device
    off = s * _nshards(ctx) - n
    base = global_index_base(s, ctx)
    g = torch.arange(base, base + s, dtype=idt, device=dev)
    real = g >= off
    rg = torch.where(real, g - off, 0)
    owner = _owner(begins, rg).long()
    row = owner * cap + (rg - begins[owner]).long()
    slabs = (torch.zeros(cap, dtype=idt, device=dev),
             torch.full((cap,), torch.iinfo(idt).max, dtype=idt, device=dev),
             torch.zeros(cap, dtype=torch.int32, device=dev))
    lcp_adj = torch.where(g == off, 0, lcp)
    return route_scatter(row, (sa, lcp_adj, lc.to(torch.int32)), slabs, real,
                         ctx=ctx)


def _rmq_tables(ctx, x):
    """The leftmost-argmin RMQ tables (tab_v, tab_a) of this shard's block
    or copy of ``x``."""
    r = build_arg_rmq(x)
    return r.tab_v, r.tab_a


def _sample_mask_local(ctx, lcp, *, n: int, maxsize: int,
                       kernels: AnsvKernels = KERNELS) -> torch.Tensor:
    """This shard's LCP-sampling mask by ANSV (see ``ops/sample_lcp.py``
    for the characterization; JAX ``_sample_mask_local``): ``ansv_local``
    on one device, ``ansv_mesh_local`` with unbounded routing on a mesh;
    ``kernels=PLAIN`` runs the kernels' plain versions."""
    idt = lcp.dtype
    inf = nonsv_for(idt)
    s = lcp.shape[0]
    N = s * _nshards(ctx)
    off = N - n
    base = global_index_base(s, ctx)
    g = torch.arange(base, base + s, dtype=idt, device=lcp.device)
    real = g >= off
    lcp_adj = torch.where(real, lcp, -1)
    lcp_adj = torch.where(g == off, 0, lcp_adj)
    if ctx is None:
        lidx, _, ridx, _ = ansv_local(lcp_adj, NEAREST_SM, NEAREST_SM,
                                      kernels)
    else:
        lidx, _, ridx, _, _ = ansv_mesh_local(ctx, lcp_adj, NEAREST_SM,
                                              NEAREST_SM, None, kernels)
    L = torch.clamp(torch.where(lidx == inf, off, lidx), min=off)
    R = torch.where(ridx == inf, N, ridx)
    return real & ((g == off) | (lcp_adj == 0) | ((R - L) > maxsize))


def _sample_rows(ctx, keep, lcp, lc, *, n: int):
    """Every shard's sampled rows in SA order, the same on each shard:
    (text-offset row, LCP, Lc), the first real row's LCP 0.  Each shard's
    rows, concatenated in shard order: the rows that the JAX package's
    1-key distributed sort (``_sample_compact_local``) brings to the
    front, in its order.  The shards exchange their rows padded to the
    largest count (an exchange's buffers match in shape)."""
    s = lcp.shape[0]
    off = s * _nshards(ctx) - n
    base = global_index_base(s, ctx)
    loc = torch.nonzero(keep).squeeze(1)
    rows = loc + base
    lcp_adj = torch.where(rows == off, 0, lcp[loc])
    out = ((rows - off).to(lcp.dtype), lcp_adj, lc[loc].to(torch.int32))
    if ctx is None or ctx.p == 1:
        return out
    counts = ctx.all_gather(torch.tensor(loc.shape[0], device=lcp.device))
    cmax = int(counts.max())
    padded = tuple(torch.cat([t, t.new_zeros(cmax - t.shape[0])])
                   for t in out)
    got = ctx.all_gather(padded)
    keep_all = (torch.arange(cmax, device=lcp.device)[None, :]
                < counts[:, None]).reshape(-1)
    return tuple(g.reshape(-1)[keep_all] for g in got)


@dataclasses.dataclass
class DESA:
    """Device-resident pattern index of one text, on one device or on the
    p shards of ``mesh``: there ``xs`` and the slabs are ``Sharded`` (p
    slabs of ``cap`` rows), the RMQ holds each slab's tables, and
    ``table``, ``begins`` and the TLDT sample are ``Replicated``."""

    alphabet: Alphabet
    n: int
    N: int
    k: int                    # TLLT k-mer length (= minmatch)
    table: torch.Tensor       # (T,) inclusive k-mer prefix sums
    begins: torch.Tensor      # (p,) segment starts (SA row space)
    begins_np: np.ndarray
    cap: int                  # segment capacity
    sa: torch.Tensor          # (cap,) SA rows of each segment
    lcp: torch.Tensor
    lc: torch.Tensor
    rmq: ArgLocalRMQ          # leftmost-argmin RMQ over each ``lcp`` slab
    xs: torch.Tensor          # (N,) encoded text (verification)
    tli: str = "tllt"         # top-level index kind: "tllt" or "tldt"
    samp: dict | None = None  # tldt: sampled-LCP search structure
    idt: torch.dtype = torch.int32  # index dtype
    mesh: object = None       # the mesh of p > 1 shards, None on one device
    #: the last query batch's blind-search steps (each search's longest
    #: walk, summed over the searches and shards) and the plain walk's
    #: host readbacks
    last_stats: dict = dataclasses.field(default_factory=dict)

    # ---------------- queries ----------------

    def encode_patterns(self, patterns):
        """Encode byte patterns as (mat, lens, bad): the padded (B, Lmax)
        int32 code matrix (Lmax = pow2ceil(max(2, longest)), 0 past each
        length), the int32 lengths and the bool bad flags (an empty
        pattern, or a byte outside the alphabet), tensors on the DESA's
        device (the host on a mesh).  The host joins the bytes and sums
        the lengths (counted here unless the batch brings them); the bytes
        and the offsets go up, and K11 builds the matrix and the flags
        there (its plain version off the card)."""
        B = len(patterns)
        dev = self._device()
        with timers.span("psac.locate.encode.join", patterns=B):
            lens = getattr(patterns, "lens", None)
            if lens is None:
                lens = np.fromiter(map(len, patterns), np.int64, B)
            flat = _joined(patterns)
            offs = np.zeros(B + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
        with timers.span("psac.locate.upload", dev):
            home = torch.device("cpu") if dev is None else dev
            dflat = torch.from_numpy(flat).to(home)
            doffs = torch.from_numpy(offs).to(home)
        with timers.span("psac.locate.encode.pack", dev):
            out = pattern_pack(dflat, doffs, self._code_table,
                               _tier(lens.max() if B else 2))
            if dflat.is_cuda:
                timers.count("patterns_on_card", B)
        return out

    @functools.cached_property
    def _code_table(self) -> torch.Tensor:
        """The alphabet's (256,) uint8 byte -> code table where
        ``encode_patterns`` builds the matrix."""
        dev = self._device()
        return torch.from_numpy(self.alphabet.mapping).to(
            torch.device("cpu") if dev is None else dev)

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
        cannot inflate the whole (B, Lmax) code matrix.  Spans:
        ``psac.locate`` (the call) > ``.groups``, then a group's
        ``.encode.join``, ``.upload``, ``.encode.pack`` (a mesh's
        ``.upload`` to the shards after it), ``.search``, ``.download``."""
        dev = self._device()
        with timers.call("psac.locate", dev, patterns=len(patterns)):
            steps, reads = [], []
            if len(patterns) == 0:
                out = np.zeros((0, 2), np.int64)
            else:
                with timers.span("psac.locate.groups"):
                    lens = np.fromiter(map(len, patterns), np.int64,
                                       len(patterns))
                    groups = _length_groups(lens)
                if len(groups) == 1:
                    out = self._run_query_group(_Group(patterns, lens),
                                                verify, steps, reads)
                else:
                    out = np.zeros((len(patterns), 2), np.int64)
                    for idx in groups:
                        out[idx] = self._run_query_group(
                            _Group([patterns[i] for i in idx], lens[idx]),
                            verify, steps, reads)
            with timers.span("psac.locate.download", dev):
                self.last_stats = {
                    "steps": sum(int(_whole(x).sum()) for x in steps),
                    "readbacks": sum(int(_whole(x).sum()) for x in reads)}
                timers.readback(len(steps))
        return out

    def _device(self):
        """The card of a one-device DESA (None on a mesh)."""
        return None if num_shards(self.mesh) > 1 else self.xs.device

    def _run_query_group(self, patterns, verify: bool, steps: list,
                         reads: list) -> np.ndarray:
        """One length group: on a mesh the batch is padded with rows of
        length 0 as the JAX package pads it (to a power of two of at least
        p rows; to the next multiple of an odd p) and split into p blocks;
        each shard's step and readback counts join ``steps`` and
        ``reads``; the bad patterns' ranges are zeroed where the ranges
        are, before the one download."""
        dmat, dlens, bad = self.encode_patterns(patterns)
        B = dmat.shape[0]
        p = num_shards(self.mesh)
        dev = self._device()
        if p > 1:
            with timers.span("psac.locate.upload", dev):
                pad = -(-max(p, pow2ceil(B)) // p) * p - B
                dmat, dlens = (self.mesh.shard(torch.cat(
                    [a, a.new_zeros((pad,) + a.shape[1:])]))
                    for a in (dmat, dlens))
        run = _bulk_locate_local if self.tli == "tllt" else \
            _bulk_locate_tldt_local
        timed = timers_enabled()
        with timers.span("psac.locate.search", dev, patterns=B):
            lr, nsteps, nreads, counts = run_on(
                self.mesh,
                functools.partial(run, verify=verify, stats=timed),
                dmat, dlens, self)
        steps.append(nsteps)
        reads.append(nreads)
        if timed:
            # query load imbalance (reference bulk_rma.hpp:27-35)
            counts = counts.cpu().numpy().astype(np.int64)
            tot = max(int(counts.sum()), 1)
            print(f"[timer] [desa] query routing: max={int(counts.max())} "
                  f"avg={tot / p:.0f} "
                  f"imbalance={counts.max() * p / tot:.3f}",
                  file=sys.stderr, flush=True)
        with timers.span("psac.locate.download", dev):
            out = torch.where(bad[:, None], 0, _whole(lr)[:B])
            out = out.cpu().numpy().astype(np.int64)
            timers.readback()
        return out


def build_desa(text, device=None,
               config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
               tli_bits: int = 24, tli: str = "tllt",
               maxsize: int | None = None, mesh=None) -> DESA:
    """Construct the DESA of a byte text on ``device`` (None: the CUDA
    card; ``"cpu"`` runs the plain versions), or on the p shards of
    ``mesh`` (``parallel.mesh.make_mesh``), which then replaces ``device``:
    SA+LCP+Lc, the top-level index (TLLT or TLDT), the partition, the
    slabs and the RMQ.  ``maxsize`` (TLDT) defaults to n / p / 128."""
    mesh, device = _one_device(mesh, device)
    if not (isinstance(text, (bytes, bytearray))
            or np.asarray(text).dtype == np.uint8):
        # a TLLT of (sigma bits)^k entries over a wide integer alphabet
        # would be enormous; the DESA is a byte-text index
        raise ValueError("build_desa requires a byte text "
                         "(bytes or uint8 array); got dtype "
                         f"{np.asarray(text).dtype}")
    xs, alpha, n, N = encode_and_shard(text, device, mesh)
    return _build_from_codes(xs, alpha, n, N, config, tli_bits, tli, maxsize,
                             mesh)


def build_desa_from_file(path: str, device=None,
                         config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                         tli_bits: int = 24, tli: str = "tllt",
                         maxsize: int | None = None, mesh=None) -> DESA:
    """``build_desa`` of a file's bytes, staged raw on ``device`` (None:
    the CUDA card; one read) or over the shards of ``mesh`` (each process
    reading only its own shards' byte ranges), and its alphabet counted
    there."""
    mesh, device = _one_device(mesh, device)
    xs, alpha, n, N = encode_and_shard_file(path, device, mesh)
    return _build_from_codes(xs, alpha, n, N, config, tli_bits, tli, maxsize,
                             mesh)


def _build_from_codes(xs, alpha, n: int, N: int, config, tli_bits: int,
                      tli: str, maxsize: int | None, mesh) -> DESA:
    dsa = construct_device(xs, alpha, n, N, config, mesh)
    lc = dsa.lc if dsa.lc is not None else compute_lc_device(dsa, xs)
    return _assemble_desa(xs, alpha, n, N, dsa.lcp, dsa.sa, lc, tli_bits,
                          tli, maxsize, force_int64=config.force_int64,
                          mesh=mesh)


def _assemble_desa(xs, alpha, n: int, N: int, lcp, sa, lc, tli_bits: int,
                   tli: str = "tllt", maxsize: int | None = None,
                   force_int64: bool = False, mesh=None) -> DESA:
    """Top-level index + partition + slabs + RMQ from the padded (N,)
    SA/LCP/Lc (``Sharded`` on a mesh).

    The slabs, ``table``, ``begins`` and the answers carry the index dtype
    (int64 at N >= 2^30 or with ``force_int64``); in-slab offsets, pattern
    codes and Lc stay int32.  On a mesh the replicated arrays are made on
    the host and copied to every shard's device."""
    idt = torch.int64 if force_int64 else cfg_mod.index_dtype(N)
    p = num_shards(mesh)
    home = xs.device if mesh is None else "cpu"
    bits = alpha.bits_per_char
    # k-mer depth of the top-level table: the reference's 2^24-entry budget,
    # capped so tiny inputs don't allocate a table vastly larger than the text
    k = max(1, min(tli_bits // bits, 12))
    while k > 1 and (1 << (k * bits)) > max(1024, 4 * n):
        k -= 1
    samp = None
    table = _replicate(mesh, torch.zeros(1, dtype=idt), home)

    if tli == "tllt":
        table = _replicas(run_on(mesh, functools.partial(
            _kmer_table, n=n, k=k, bits=bits, T=1 << (k * bits), idt=idt),
            xs))
        begins_np, cap = _partition_from_prefix(
            _whole(table).cpu().numpy(), n, p)
    elif tli == "tldt":
        # sampled-LCP top-level trie (reference tldt, maxsize = n/p/128):
        # the mask on the shards, their sampled rows (about n / maxsize)
        # to one place, then replicated
        ms = maxsize or max(2, n // p // 128)
        keep = run_on(mesh, functools.partial(_sample_mask_local, n=n,
                                              maxsize=ms), lcp)
        offs, s_lcp, s_lc = (_whole(_replicas(x)) for x in run_on(
            mesh, functools.partial(_sample_rows, n=n), keep, lcp, lc))
        m = offs.shape[0]
        if m < 2:
            raise ValueError("tldt sampling produced < 2 rows; lower maxsize")
        M = max(8, pow2ceil(m))
        at = offs.device
        samp_lcp = torch.full((M,), torch.iinfo(idt).max, dtype=idt,
                              device=at)
        samp_lcp[:m] = s_lcp
        samp_lc = torch.zeros(M, dtype=torch.int32, device=at)
        samp_lc[:m] = s_lc
        off_ext = torch.full((M + 1,), n, dtype=idt, device=at)
        off_ext[:m] = offs
        samp_lcp = _replicate(mesh, samp_lcp, home)
        s_tab_v, s_tab_a = run_on(mesh, _rmq_tables, samp_lcp)
        samp = {"off_ext": _replicate(mesh, off_ext, home), "lcp": samp_lcp,
                "lc": _replicate(mesh, samp_lc, home),
                "rmq": ArgLocalRMQ(x=samp_lcp, tab_v=_replicas(s_tab_v),
                                   tab_a=_replicas(s_tab_a),
                                   block=block_size_for(M)),
                "m": m, "M": M}
        ps = np.concatenate([offs[1:].cpu().numpy(), [n]]).astype(np.int64)
        begins_np, cap = _partition_from_prefix(ps, n, p)
    else:
        raise ValueError(f"unknown tli kind {tli!r}")

    begins = _replicate(mesh, torch.from_numpy(begins_np).to(idt), home)
    sa_slab, lcp_slab, lc_slab = run_on(mesh, functools.partial(
        _reshard_local, n=n, cap=cap, idt=idt), lcp, sa, lc, begins)
    tab_v, tab_a = run_on(mesh, _rmq_tables, lcp_slab)
    return DESA(alphabet=alpha, n=n, N=N, k=k, table=table, begins=begins,
                begins_np=begins_np, cap=cap, sa=sa_slab, lcp=lcp_slab,
                lc=lc_slab,
                rmq=ArgLocalRMQ(x=lcp_slab, tab_v=tab_v, tab_a=tab_a,
                                block=block_size_for(cap)),
                xs=xs, tli=tli, samp=samp, idt=idt, mesh=mesh)


def _segments(desa: DESA) -> np.ndarray:
    """The real rows of each shard's slab (its segment's length)."""
    ends = np.concatenate([desa.begins_np[1:], [desa.n]])
    return (ends - desa.begins_np).astype(np.int64)


def _slabs(slab) -> list:
    """(global shard, local slab) of each slab this process holds."""
    if isinstance(slab, Sharded):
        return list(enumerate(slab.shards, start=slab.first))
    return [(0, slab)]


def desa_arrays(desa: DESA):
    """Host (n,) SA/LCP/Lc arrays in global SA order: each segment's rows
    (slab padding stripped), in shard order.  Raises on a mesh that spans
    processes (no process holds every slab): ``write_desa_distributed``
    writes the files there."""
    if desa.mesh is not None and desa.mesh.multiprocess:
        raise ValueError("desa_arrays: the slabs span processes; use "
                         "write_desa_distributed")
    segs = _segments(desa)
    return tuple(np.concatenate(
        [t[:segs[g]].cpu().numpy() for g, t in _slabs(slab)]
    ).astype(np.int64) for slab in (desa.sa, desa.lcp, desa.lc))


def write_desa(desa: DESA, prefix: str) -> None:
    """Persist the index as ``.sa64/.lcp64/.lc64/.alpha`` (the top-level
    index, the partition and the RMQ are rebuilt on load, as the
    reference's ``dist_desa::write``, ``include/desa.hpp:366-397``); the
    files do not depend on p."""
    sa, lcp, lc = desa_arrays(desa)
    io_mod.write_u64(prefix + ".sa64", sa)
    io_mod.write_u64(prefix + ".lcp64", lcp)
    io_mod.write_u64(prefix + ".lc64", lc)
    io_mod.write_alphabet(prefix, desa.alphabet)


def write_desa_distributed(desa: DESA, prefix: str) -> None:
    """``write_desa``'s files, byte for byte, with each process writing
    only its own slabs' segments at their ``begins`` file rows (the JAX
    package's ``write_desa_distributed``); process 0 writes ``.alpha``.
    Call ``parallel.dist.barrier`` before reading them on another
    process."""
    segs = _segments(desa)
    for ext, slab in ((".sa64", desa.sa), (".lcp64", desa.lcp),
                      (".lc64", desa.lc)):
        fd = os.open(prefix + ext, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.truncate(fd, 8 * desa.n)
            for g, t in _slabs(slab):
                if segs[g]:
                    io_mod.pwrite_rows(fd, t[:segs[g]].cpu().numpy(),
                                        int(desa.begins_np[g]))
        finally:
            os.close(fd)
    if process_index() == 0:
        io_mod.write_alphabet(prefix, desa.alphabet)


def _load_index(xs, alpha, n: int, N: int, prefix: str, tli_bits: int,
                tli: str, maxsize: int | None, force_int64: bool,
                mesh) -> DESA:
    """The persisted SA/LCP/Lc in the (N,) construction layout, staged on
    the codes' device or per shard of the mesh (each process reading only
    its own shards' rows), assembled with a top-level index chosen now."""
    n_art = os.path.getsize(prefix + ".sa64") // 8
    if n_art != n:
        raise ValueError(f"index built for n={n_art}, text has n={n}")
    idt = torch.int64 if force_int64 else cfg_mod.index_dtype(N)
    where = xs.device if mesh is None else mesh

    def stage(ext, dt):
        return io_mod.stage_u64_front_padded(prefix + ext, where, dt)[0]

    return _assemble_desa(
        xs, alpha, n, N, stage(".lcp64", idt), stage(".sa64", idt),
        stage(".lc64", torch.int32), tli_bits, tli, maxsize,
        force_int64=force_int64, mesh=mesh)


def read_desa(text, prefix: str, device=None, tli_bits: int = 24,
              tli: str = "tllt", maxsize: int | None = None,
              force_int64: bool = False, mesh=None) -> DESA:
    """Load a persisted DESA (it needs the original text, as the
    reference's ``desa-main -l`` does) on ``device`` (None: the CUDA card)
    or on ``mesh``, whatever p wrote it; ``tli``/``maxsize`` select the
    top-level index rebuilt on load."""
    mesh, device = _one_device(mesh, device)
    xs, alpha, n, N = encode_and_shard(text, device, mesh)
    return _load_index(xs, alpha, n, N, prefix, tli_bits, tli, maxsize,
                       force_int64, mesh)


def read_desa_from_file(text_path: str, prefix: str, device=None,
                        tli_bits: int = 24, tli: str = "tllt",
                        maxsize: int | None = None,
                        force_int64: bool = False, mesh=None) -> DESA:
    """``read_desa`` with the text read from a file: on a mesh each
    process reads only its own shards' byte ranges of the text and rows of
    the files (the JAX package's ``read_desa_from_file``)."""
    mesh, device = _one_device(mesh, device)
    xs, alpha, n, N = encode_and_shard_file(text_path, device, mesh)
    return _load_index(xs, alpha, n, N, prefix, tli_bits, tli, maxsize,
                       force_int64, mesh)


# --------------------------------------------------------------------------
# queries (shard functions: ``ctx`` None on one device)
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
            counts: dict):
    """The blind search (K7 on the card, its plain version on the CPU);
    each pattern's step count stays on the device until the group's
    results are read back (``DESA._run_query``)."""
    l, r, q, nsteps = blind_search(pat, lens, l0, r0, need, lcp, lc, rmq, cap,
                                   counts)
    counts["step_max"].append(nsteps.max())
    return l, r, q


def _verify_match(ctx, rp, rlen, ver_row, rows, sa_slab, xs, *, n: int,
                  cap: int):
    """Text verification of one candidate row per pattern: the
    pattern-length window of the text starting at SA[ver_row], each
    character gathered from the shard that holds it, compared with the
    pattern.  Only the ``rows`` whose answer reads the match gather."""
    M, Lmax = rp.shape
    sal = sa_slab[ver_row.clamp(0, cap - 1)]
    cols = torch.arange(Lmax, device=xs.device)
    pos = sal.to(torch.int64)[:, None] + cols[None, :]
    in_pat = cols[None, :] < rlen[:, None]
    in_text = pos < n
    got = gather_global(xs, pos.reshape(-1),
                        (in_pat & in_text & rows[:, None]).reshape(-1),
                        ctx=ctx)
    okc = torch.where(in_pat, in_text & (got.view(M, Lmax) == rp), True)
    return okc.all(dim=1)


def _locate_in_slab(ctx, rp, rlen, rlo, rhi, need_q, search, desa: DESA,
                    verify: bool, counts: dict, finished=None):
    """The owner's part of a query: blind search of the candidate SA range
    [rlo, rhi) on this shard's slab and verification of one row.  Returns
    the in-slab (fl, fr) and the match flags."""
    cap = desa.cap
    begin = int(desa.begins_np[0 if ctx is None else ctx.rank])
    # in-slab coordinates are int32 (cap < 2^31) even for int64 indexes
    l_loc = (rlo - begin).clamp(0, cap - 1).to(torch.int32)
    r_loc = (rhi - 1 - begin).clamp(0, cap - 1).to(torch.int32)
    search = search & (l_loc < r_loc)
    # a row not searched (most of a received buffer on a mesh) starts on
    # one row, so the walk's first range minimum reads one word; its
    # outputs are not used
    fl, fr, _ = _search(rp, rlen, l_loc, torch.where(search, r_loc, l_loc),
                        search, desa.lcp, desa.lc, desa.rmq, cap, counts)
    fl = torch.where(search, fl, l_loc)
    fr = torch.where(search, fr, r_loc)
    if verify:
        ver_row = fl if finished is None else torch.where(finished, l_loc, fl)
        match = _verify_match(ctx, rp, rlen, ver_row, need_q, desa.sa,
                              desa.xs, n=desa.n, cap=cap)
    else:
        match = torch.ones_like(need_q)
    return fl, fr, match


def _group_out(ctx, l, r, need, dest, counts: dict, stats: bool):
    """A query shard function's outputs: the (b, 2) ranges, its blind
    searches' longest walks summed, the plain walk's readbacks and, with
    ``stats``, the patterns routed to each shard (replicated, None
    without)."""
    routed = None
    if stats:
        routed = psum(torch.zeros(_nshards(ctx), dtype=torch.int32,
                                  device=need.device).index_add_(
            0, dest.long(), need.to(torch.int32)), ctx)
    return (torch.stack([l, r], dim=1),
            torch.stack(counts["step_max"]).sum().reshape(1),
            torch.tensor([counts["readbacks"]]), Rep(routed))


def _bulk_locate_local(ctx, mat, lens, desa: DESA, *, verify: bool,
                       stats: bool):
    """bulk_locate with the TLLT (JAX ``_bulk_locate_local``): the table
    gives each pattern's range of its first k chars; longer patterns go to
    the owner of that range and continue by blind search there."""
    counts = {"readbacks": 0, "step_max": []}
    idt, k = desa.idt, desa.k
    begin = int(desa.begins_np[0 if ctx is None else ctx.rank])
    lo, hi = _tli_lookup(mat, lens, desa.table, k,
                         desa.alphabet.bits_per_char)
    need = (lens > k) & (lo < hi)
    dest = torch.where(need, _owner(desa.begins, lo),
                       0 if ctx is None else ctx.rank)

    def answer(recv, recv_valid):
        rp, rlen, rlo, rhi = recv
        need_q = recv_valid & (rlen > k) & (rlo < rhi)
        fl, fr, match = _locate_in_slab(ctx, rp, rlen, rlo, rhi, need_q,
                                        need_q, desa, verify, counts)
        out_l = fl.to(idt) + begin
        out_r = torch.where(need_q & match, fr.to(idt) + begin + 1, out_l)
        return (torch.where(need_q, out_l, 0), torch.where(need_q, out_r, 0))

    al, ar = route_apply((mat, lens, lo, hi), answer, dest=dest, ctx=ctx)
    return _group_out(ctx, torch.where(need, al, lo), torch.where(need, ar, hi),
                      need, dest, counts, stats)


def _bulk_locate_tldt_local(ctx, mat, lens, desa: DESA, *, verify: bool,
                            stats: bool):
    """bulk_locate with the TLDT (JAX ``_bulk_locate_tldt_local``, the
    reference's ``tldt::lookup``): the replicated sample is searched at the
    pattern's origin shard; if that consumed the whole pattern the owner
    only verifies, otherwise it continues the search on its slab.  Every
    result is verified against the text."""
    counts = {"readbacks": 0, "step_max": []}
    idt = desa.idt
    begin = int(desa.begins_np[0 if ctx is None else ctx.rank])
    samp = desa.samp
    M_samp = samp["M"]
    zero = torch.zeros_like(lens)
    need0 = lens > 0
    ls, rs, qf = _search(mat, lens, zero,
                         torch.where(need0, samp["m"] - 1, zero), need0,
                         samp["lcp"], samp["lc"], samp["rmq"], M_samp, counts)
    glo = samp["off_ext"][ls.clamp(0, M_samp)]
    ghi = samp["off_ext"][(rs + 1).clamp(0, M_samp)]
    finished = (qf >= lens) | (ghi <= glo)
    need = need0 & (glo < ghi)
    dest = torch.where(need, _owner(desa.begins, glo),
                       0 if ctx is None else ctx.rank)

    def answer(recv, recv_valid):
        rp, rlen, rlo, rhi, rfin = recv
        need_q = recv_valid & (rlen > 0) & (rlo < rhi)
        fl, fr, match = _locate_in_slab(ctx, rp, rlen, rlo, rhi, need_q,
                                        need_q & ~rfin, desa, verify, counts,
                                        finished=rfin)
        out_l = torch.where(rfin, rlo, fl.to(idt) + begin)
        out_r_full = torch.where(rfin, rhi, fr.to(idt) + begin + 1)
        out_r = torch.where(need_q & match, out_r_full, out_l)
        return (torch.where(need_q, out_l, 0), torch.where(need_q, out_r, 0))

    al, ar = route_apply((mat, lens, glo, ghi, finished), answer, dest=dest,
                         ctx=ctx)
    # unrouted patterns have an empty lookup range -> empty result
    return _group_out(ctx, torch.where(need, al, glo),
                      torch.where(need, ar, glo), need, dest, counts, stats)
