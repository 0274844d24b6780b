#!/usr/bin/env python3
"""Smoke run of psac_tpu_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``psac_tpu_torch/csrc``, checks
each against its plain PyTorch version on the card (at the main path's
shapes and on adversaries; the k-mer init's K9 and K10 on the arguments
of the init of the 2^26 SA+LCP, of the random string set's GSA and of a
2^20 ``force_int64`` build), times the suffix tree's ANSV pass both ways
(the spine engine's tile-spine pass, K4 + K1, against the tree's dual
scan K2), then drives the
main paths through the user entry points, most with no device (the card
is the default): SA+LCP of 2^26 random DNA, SA+LCP of 2^24 repetitive DNA
(the LCP resolve K6 in every dense and tail step), the suffix tree of the
2^26 text and that of the 2^24 repetitive text (each ANSV pass one K2
launch);
the public ANSV of 2^24 values for five match-type pairs; the DESA of the
2^26 text with both top-level indexes, answering batches of 65,536
patterns of lengths 8, 20 and 64 (the blind search K7, held against its
plain version on those batches' inputs); the generalized suffix array +
LCP and the generalized suffix tree of 16,384 random 4 KiB strings (2^26
characters) and of a family of 64 near-identical 256 KiB strings (2^24);
the host-driven construction loop (``fused=False``) on the same texts and
sets (SA+LCP at tail thresholds 0.1 and 0.0, SA-only at factors 2-4, K6 in
every doubling step of ``rep_dna``, the GSA of both sets) and
``pack_keys`` at ``dense_factor=5``; the mesh of p = 4 shards on the
card(s) (``[mesh]``: SA+LCP of the 2^26 text and of ``rep_dna``, fused
and host-driven, the 2^26 suffix tree (the walks K8 in every shard's
ANSV, held against their plain version on one shard's full-width walks
and on the largest routed one), ``d_check_sa``, the DESA of the 2^26 text
with both top-level indexes answering the same batches as at p = 1 (K7 on
every shard's slab, held against its plain version there) and its files
written and read back, the public ANSV (and on 2^20 int64 values, K8
held against its plain version there), SA+LCP at p = 3, and GSA + GLCP
and the GST of both string sets; K6's min-only entry, ``rmq_mins``, held
against its plain version there); the mesh of 4 shards
across 2 processes of this script (``[procs]``: gloo on ``cuda:0``, and
NCCL with a card per process where there are two: SA+LCP of the 2^26
file, ``d_check_sa``, the per-shard SA files and their reload, the DESA
from the file answering the length-20 batch, its per-shard files and
reload, and GSA + GLCP and the GST of the family's file, against p = 1 and
``[mesh]``); each ANSV engine
(hybrid, scan, block, spine) against the plain path on 2^24 values; then
the command-line tools in processes of their own (``psac -f``, ``gsac
-f``, ``mkpattern``, ``desa -q`` building, saving and loading the index,
and at p = 4 (``--devices 4``), ``benchmark`` and ``benchmark-ansv``) on
the same inputs, and ``d_check_sa`` on the file build.
Every result is held against the native SA-IS + Kasai oracle, the
sequential ANSV oracle, the sorting oracles or the plain path; the script
prints the kernel table (each kernel's time beside its bound: the bytes it
must move once at the card's memory rate, and its launches summed over the
main-path phases), the card's name and power limit, and a last JSON line.
Any mismatch raises; the exit code is then non-zero.

Run from the repository root:  python3 chip_smoke.py
(``--log2n``/``--rep-log2n``/``--ansv-log2n``/``--batch``/``--gsa-log2n``/
``--fam-log2n``/``--bench-reps`` shrink the work for a quick rehearsal.)
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): device memory,
# and float32 outside the tensor cores, against which a comparison counts as
# one operation (the ANSV kernels only compare).
MEM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, device=None) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run (CUDA events around the whole batch, on the current stream
    of ``device``, by default the current device: the device whose tensors
    ``fn`` works on)."""
    import torch

    with torch.cuda.device(device):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``ops`` comparisons, and which of the two bounds it."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = ops / CORE_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=None)  # no single PyTorch call computes these


def scan_adversaries(dev) -> dict:
    """Inputs that stress K2/K3's minima hierarchy (32-wide groups, 1024-
    element tiles): long monotone and equal runs, a sawtooth whose every
    query crosses a tile, a leading INT32_MAX run (the public ANSV's padding
    as the reversed stream sees it), and lengths 32^k - 1 and 32^k + 1."""
    import torch

    rng = np.random.RandomState(31)
    i = np.arange(1 << 20)
    cases = {
        "increasing": np.arange(1 << 17),
        "decreasing": i[::-1] + 1,
        "homopolymer_lcp": np.concatenate([[-1, 0], i[1:-1]]),
        "all_equal": np.full(1 << 20, 5),
        "sawtooth": i // 1024 * 1024 + 1023 - i % 1024,
        "max_lead": np.concatenate([np.full(300000, 2**31 - 1),
                                    rng.randint(0, 9, (1 << 20) - 300000)]),
    }
    for k in (1, 2, 3, 4):
        for n in (32**k - 1, 32**k + 1):
            cases[f"len{n}"] = rng.randint(0, 1 << (4 * k), n)
    return {k: torch.from_numpy(v.astype(np.int32)).to(dev)
            for k, v in cases.items()}


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching tuples of tensors (None = absent
    in both); raises if any differs."""
    import torch

    worst = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        worst = max(worst, int(diff.max()) if diff.numel() else 0)
        if not torch.equal(g.to(torch.int64), w.to(torch.int64)):
            raise AssertionError(f"output {k} differs (max abs err {worst})")
    return worst


def tansv_cases():
    """The tile-boundary adversaries of tests/test_ansv.py::_tansv_cases."""
    rng = np.random.RandomState(11)
    T = 512
    cases = {
        "random_small_alpha": rng.randint(0, 7, 4096),
        "random_wide": rng.randint(0, 100000, 2048),
        "all_equal": np.full(2048, 5),
        "tile_edge_runs": np.tile(
            np.repeat(np.arange(8), T // 2)[:T], 8)[:4096],
        "sawtooth": np.arange(4096) % 37,
        "two_level_runs": np.where(np.arange(4096) % T < 3, 1, 2),
    }
    x = np.full(4096, 9)
    x[T + 1::T] = 4
    cases["straddle"] = x
    # every element a chain member; one tile of one value
    cases["decreasing"] = np.arange(4096, 0, -1)
    cases["one_value_tile"] = np.full(T, 3)
    return {k: v.astype(np.int32) for k, v in cases.items()}


# K8's two wrappers are one row of the kernel table
TABLE_NAME = {"levels_prev_lt": "walks", "levels_next_leq": "walks",
              "_bucket_by_dest": "route_bucket"}


def counter(fns):
    """(reset, read) over the launch counts of kernel wrappers, read under
    their kernel-table names (K8's two walks summed as ``walks``).  Each
    main-path phase adds what it read into ``LAUNCHES``, the count the
    kernel table reports."""
    def reset():
        for fn in fns:
            fn.launches = 0

    def read():
        out = {}
        for fn in fns:
            k = TABLE_NAME.get(fn.__name__, fn.__name__)
            out[k] = out.get(k, 0) + fn.launches
        return out

    return reset, read


LAUNCHES: dict = {}


def add_launches(counts: dict) -> None:
    for k, v in counts.items():
        LAUNCHES[k] = LAUNCHES.get(k, 0) + v


def pad_chunk(x, value: int = 2**31 - 1):
    """x padded at the end with ``value`` to a multiple of 2048, as the
    ANSV's spine engine pads an int32 array."""
    import torch

    pad = -x.shape[0] % 2048
    return torch.cat([x, x.new_full((pad,), value)]) if pad else x


def check_k4_k1(dev, lcp_adj, log2n: int, kern: dict) -> None:
    """K4 (tile phase) and K1 (spine scan) against their plain versions:
    K4 on the tile adversaries and the 2^26 LCP, both directions, with_eq
    on and off; K1 on the 2^26 LCP's spine streams and on the spine streams
    of the scan adversaries and of the suffix tree's -1 padding rows."""
    import torch

    from psac_tpu_torch.ops.nsv_scan import (nsv_scan_spine,
                                             nsv_scan_spine_plain)
    from psac_tpu_torch.ops.tansv import (spine_streams, tile_side,
                                          tile_side_plain)

    S = lcp_adj.shape[0]
    cases = tansv_cases()
    errs = []
    for a in cases.values():
        x = torch.from_numpy(a).to(dev)
        for xx in (x, x.flip(0)):
            for with_eq in (True, False):
                errs.append(max_abs_err(tile_side(xx, with_eq),
                                        tile_side_plain(xx, with_eq)))
    errs += [max_abs_err(tile_side(xx, we), tile_side_plain(xx, we))
             for xx in (lcp_adj, lcp_adj.flip(0)) for we in (True, False)]
    kern["tile_side"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/tansv_tile.cu",
        replaces="psac_tpu/ops/tansv.py:67", max_abs_err=max(errs),
        ms=cuda_ms(lambda: tile_side(lcp_adj, True), 10),
        plain_ms=cuda_ms(lambda: tile_side_plain(lcp_adj, True), 1),
        # 4 B in; psv_g, psv_val, nxt, e_g, h_in (4 B) and two masks (1 B)
        **bound(26 * S, 2 * S))
    log(f"[kernel] K4 tile_side == plain on {len(cases)} adversaries "
        f"({', '.join(cases)}) and the 2^{log2n} LCP, both directions, "
        "with_eq on and off")

    spine_f = tile_side(lcp_adj, True)[3]
    spine_n = tile_side(lcp_adj.flip(0), False)[3]
    kf, vf, kn, vn = spine_streams(lcp_adj, spine_f, spine_n)
    errs = [max_abs_err(nsv_scan_spine(vf, kf, vn, kn),
                        nsv_scan_spine_plain(vf, kf, vn, kn))]
    advs = scan_adversaries(dev)
    rng = np.random.RandomState(77)
    advs["st_padding"] = torch.from_numpy(np.concatenate(
        [np.full(700, -1), [0], rng.randint(0, 12, 8 * 2048 - 701)]
    ).astype(np.int32)).to(dev)
    for x in advs.values():
        x = pad_chunk(x)
        f_k, f_v, n_k, n_v = spine_streams(
            x, tile_side_plain(x, True)[3],
            tile_side_plain(x.flip(0), False)[3])
        errs.append(max_abs_err(nsv_scan_spine(f_v, f_k, n_v, n_k),
                                nsv_scan_spine_plain(f_v, f_k, n_v, n_k)))
    m = kf.shape[0]
    kern["nsv_scan_spine"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/nsv_scan.cu",
        replaces="psac_tpu/ops/nsv_scan.py:325", max_abs_err=max(errs),
        ms=cuda_ms(lambda: nsv_scan_spine(vf, kf, vn, kn), 10),
        plain_ms=cuda_ms(lambda: nsv_scan_spine_plain(vf, kf, vn, kn), 1),
        **bound(36 * m + 4, 2 * m))
    log(f"[kernel] K1 nsv_scan_spine == plain on the 2^{log2n} LCP's spine "
        f"streams ({m} entries; spines {int(spine_f.sum())} and "
        f"{int(spine_n.sum())} of {S}) and on the spine streams of "
        f"{len(advs)} adversaries ({', '.join(advs)})")


def engine_comparison(x, label: str, card: str) -> dict:
    """The suffix tree's (FURTHEST_EQ, NEAREST_SM) pass on the LCP ``x``
    through ``ansv_local`` on two engines: ``spine`` (K4 twice, the spine
    streams, K1, the combine) and the tree's, ``hybrid`` (the dual scan K2
    on x and its reverse); both must agree.  CUDA-event means over 5 calls
    after a warm-up."""
    from psac_tpu_torch.ops import tansv
    from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_SM
    from psac_tpu_torch.parallel.ansv import ansv_local

    S = x.shape[0]
    spines = (int(tansv.tile_side(x, True)[3].sum()),
              int(tansv.tile_side(x.flip(0), False)[3].sum()))

    def run(engine):
        return ansv_local(x, FURTHEST_EQ, NEAREST_SM, engine=engine)

    max_abs_err(run("spine"), run("hybrid"))
    t_spine = cuda_ms(lambda: run("spine"), 5)
    t_dual = cuda_ms(lambda: run("hybrid"), 5)
    out = dict(tile_spine_ms=t_spine, dual_ms=t_dual, spines=spines,
               spine_share=max(spines) / S)
    log(f"[engines] {label} ({S} rows): tile-spine pass {t_spine:.3f} ms, "
        f"dual scan K2 {t_dual:.3f} ms; spines {spines} "
        f"({100 * max(spines) / S:.3f}% of the rows); both agree; on {card}")
    return out


def check_k3_k5(dev, lcp_adj, log2n: int, ansv_log2n: int, kern: dict):
    """K3 (the block engine's left scan) and K5 (the block engine's previous-smaller
    pass) against their plain versions: the random values of the public
    ANSV phase and the 2^26 LCP, every match type, int32 and int64; K5
    also on three adversaries that leave its window, with the split of
    where it found its answers (``k5_split``)."""
    import torch

    from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM
    from psac_tpu_torch.ops.bansv import block_psv, block_psv_plain
    from psac_tpu_torch.ops.nsv_scan import nsv_scan_left, nsv_scan_left_plain
    from psac_tpu_torch.verify.cases import psv_adversaries

    rnd = torch.from_numpy(ansv_values(ansv_log2n)).to(dev)
    advs = scan_adversaries(dev)
    errs = []
    for x in (rnd, lcp_adj, *advs.values()):
        for typ in (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ):
            errs.append(max_abs_err(nsv_scan_left(x, typ),
                                    nsv_scan_left_plain(x, typ)))
    m = rnd.shape[0]
    kern["nsv_scan_left"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/nsv_scan.cu",
        replaces="psac_tpu/ops/nsv_scan.py:392", max_abs_err=max(errs),
        ms=cuda_ms(lambda: nsv_scan_left(rnd, FURTHEST_EQ), 10),
        plain_ms=cuda_ms(lambda: nsv_scan_left_plain(rnd, FURTHEST_EQ), 1),
        **bound(12 * m + 4, m))
    log(f"[kernel] K3 nsv_scan_left == plain for NSM, NEQ, FEQ on "
        f"2^{ansv_log2n} random int32, the 2^{log2n} LCP and "
        f"{len(advs)} adversaries ({', '.join(advs)})")

    wide = torch.from_numpy(
        ansv_values(ansv_log2n - 2).astype(np.int64) << 33).to(dev)
    advs5 = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
             for k, v in psv_adversaries(1 << ansv_log2n, seed=5).items()
             if k in ("decreasing", "far_min", "sparse_tiny")}
    errs = [max_abs_err((block_psv(x, strict),), (block_psv_plain(x, strict),))
            for x in (rnd, lcp_adj, wide, *advs5.values())
            for strict in (True, False)]
    S = lcp_adj.shape[0]
    split = {f"2^{ansv_log2n} random int32": k5_split(block_psv(rnd, True)),
             f"2^{log2n} LCP": k5_split(block_psv(lcp_adj, True))}
    for label, sp in split.items():
        log(f"[k5-split] {label}, strict: " + ", ".join(
            f"{k} {v} ({100 * v / sp['elements']:.4f}%)"
            for k, v in sp.items() if k != "elements"))
    # also at the public ANSV's shape, where most of its launches run, and
    # on the decreasing adversary, whose every element climbs in vain
    at_ansv = dict(
        shape=f"2^{ansv_log2n} random int32, strict",
        ms=cuda_ms(lambda: block_psv(rnd, True), 10),
        plain_ms=cuda_ms(lambda: block_psv_plain(rnd, True), 1),
        bound_ms=bound(8 * m, m)["bound_ms"])
    dec = advs5["decreasing"]
    at_dec = dict(shape=f"2^{ansv_log2n} decreasing int32, strict",
                  ms=cuda_ms(lambda: block_psv(dec, True), 10))
    kern["block_psv"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/bansv.cu",
        replaces="psac_tpu/ops/bansv.py:76", max_abs_err=max(errs),
        ms=cuda_ms(lambda: block_psv(lcp_adj, True), 10),
        plain_ms=cuda_ms(lambda: block_psv_plain(lcp_adj, True), 1),
        **bound(8 * S, S), at_ansv_shape=at_ansv, at_decreasing=at_dec,
        split=split)
    log(f"[kernel] K5 block_psv == plain, strict and not, on 2^{ansv_log2n} "
        f"random int32, the 2^{log2n} LCP, 2^{ansv_log2n - 2} int64 and "
        f"2^{ansv_log2n} {', '.join(advs5)}; {at_ansv['ms']:.3f} ms at "
        f"2^{ansv_log2n} (bound {at_ansv['bound_ms']:.4f} ms, plain "
        f"{at_ansv['plain_ms']:.3f} ms), {at_dec['ms']:.3f} ms on the "
        "decreasing array")


def k5_split(psv) -> dict:
    """Where K5 found each answer, from its output alone: inside the
    element's window (its tile and the one before), one level up the
    minima hierarchy (in the level-1 block that holds the entry before the
    window), further up, or nowhere (-1)."""
    import torch

    from psac_tpu_torch.ops.bansv import KERNEL_BLOCK as B, KERNEL_TILE as T

    i = torch.arange(psv.shape[0], device=psv.device)
    p = psv.to(torch.int64)
    none = p < 0
    ws = (i // T - 1) * T  # window start (negative: the window is all)
    inwin = ~none & (p >= ws)
    out = ~none & ~inwin
    one = out & (p // B >= ws // B // B * B)
    return dict(elements=int(psv.shape[0]), window=int(inwin.sum()),
                one_level=int(one.sum()), more_levels=int((out & ~one).sum()),
                none=int(none.sum()))


def k6_bound(rmq, ks, ls, rs, js, nq: int) -> dict:
    """K6's bound from this resolve's data, each input read once and each
    output written once: the LCP read and its resolved copy written (the
    queries' ranges and rows lie inside them), three or four query words
    per valid query, and two table words per query with whole blocks
    between its edge blocks, the table once at most.  One comparison per
    LCP or table word a query reads."""
    import torch

    lcp = rmq.x
    s, block, isz = lcp.shape[0], rmq.block, lcp.element_size()
    valid = ks[:nq] != torch.iinfo(lcp.dtype).max
    lo = ls[:nq].to(torch.int64).clamp(0, s - 1)[valid]
    hi = torch.maximum(rs[:nq], ls[:nq]).to(torch.int64).clamp(0, s - 1)[valid]
    bl, bh = lo // block, hi // block
    narrow = hi - lo < 8
    cross = bl != bh
    between = bh - bl > 1
    lend = torch.where(cross, (bl + 1) * block - 1, hi)
    wide_words = lend - lo + 1 + torch.where(
        cross, hi - bh * block + 1, 0) + 2 * between
    words = torch.where(narrow, hi - lo + 1, wide_words)
    nv = int(valid.sum())
    table_words = min(2 * int((between & ~narrow).sum()), rmq.table.numel())
    nbytes = (2 * s + nv * (3 + (js is not None)) + table_words) * isz
    return dict(bound(nbytes, int(words.sum())),
                n_narrow=int(narrow.sum()))


def resolve_spy(resolve):
    """``resolve`` (K6's wrapper or its plain version) wrapped to note each
    call: returns (spy, calls), ``calls`` a list of (slots, rows, nq, args,
    kw).  A dense step offers as many slots as the LCP has rows, a tail step
    its buffer's capacity."""
    calls = []

    def spy(rmq, ks, ls, rs, js, d, **kw):
        calls.append((ks.shape[0], rmq.x.shape[0], kw["nq"],
                      (rmq, ks, ls, rs, js, d), kw))
        return resolve(rmq, ks, ls, rs, js, d, **kw)

    return spy, calls


def resolve_steps(calls) -> str:
    """'D dense, T tail (capacities ...)' of a build's resolve calls."""
    tails = [c[0] for c in calls if c[0] != c[1]]
    return (f"{len(calls) - len(tails)} dense, {len(tails)} tail"
            + (f" (capacities {sorted(set(tails), reverse=True)})"
               if tails else ""))


def check_k6(dev, rep_text: bytes, rep_lcp: np.ndarray, log2n: int,
             card: str, kern: dict) -> None:
    """K6 (the LCP resolve) against its plain version, bit for bit: on the
    native LCP of the repetitive text with 2^(log2n - 2) seeded queries, L
    in {2, 4}, the three key packings, int32 and int64; on small arrays
    whose block is 8, 32 and 128; and on an unsorted tail-style buffer.
    Timed at the largest resolve of the repetitive text's SA+LCP build and
    on a mostly wide resolve of 2^(log2n - 2) queries of the same LCP."""
    import torch
    from unittest import mock

    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.ops.rmq import (PACKINGS, build_local_rmq,
                                        rmq_resolve, rmq_resolve_plain)
    from psac_tpu_torch.verify.cases import (resolve_lcp, resolve_queries,
                                             resolve_query_arrays,
                                             wide_resolve_queries)

    errs = []

    def compare(lcp_np, m, L, dt, seed, d):
        s = len(lcp_np)
        b = sa_mod._Builder(s, (10, 10), 3, True, dt, dev)
        rmq = build_local_rmq(torch.from_numpy(lcp_np).to(dev).to(dt))
        rows, lo, hi, j = resolve_queries(s, m, rmq.block, L, seed)
        q = {k: torch.from_numpy(v).to(dev).to(dt) for k, v in
             resolve_query_arrays(s, rows, lo, hi, j,
                                  torch.iinfo(dt).max).items()}
        for packing in PACKINGS:
            ks, ls, rs, js, Lm, _ = b._pack_queries(q, L, packing)
            kw = dict(Lm=Lm, packing=packing, nq=m)
            got = rmq_resolve(rmq, ks, ls, rs, js, d, **kw)
            want = rmq_resolve_plain(rmq, ks, ls, rs, js, d, **kw,
                                     m_pad=max(8, s // 32))
            errs.append(max_abs_err((got,), (want,)))
        return rmq.block

    m = 1 << (log2n - 2)
    for dt in (torch.int32, torch.int64):
        for L in (2, 4):
            compare(rep_lcp, m, L, dt, seed=60 + L, d=1 << 14)
    blocks = set()
    for s in (8 * 37, 32 * 9, 128 * 5, 8 * 4099, 128 * 257):
        small = resolve_lcp(s, seed=s)
        for dt in (torch.int32, torch.int64):
            for L in (2, 4):
                blocks.add(compare(small, s // 2, L, dt, seed=s + L, d=7))
    if not {8, 32, 128} <= blocks:
        raise AssertionError(f"small K6 arrays had blocks {blocks}")
    # the tail's buffer: unsorted rows with INF keys between them
    s = len(rep_lcp)
    for dt in (torch.int32, torch.int64):
        rmq = build_local_rmq(torch.from_numpy(rep_lcp).to(dev).to(dt))
        mt = 1 << (log2n - 5)
        rows, lo, hi, _ = resolve_queries(s, mt // 2, rmq.block, 2, seed=9)
        inf = torch.iinfo(dt).max
        buf = np.stack([np.full(mt, inf), np.full(mt, -3), np.full(mt, 2 * s)])
        slots = np.sort(np.random.RandomState(9).permutation(mt)[:mt // 2])
        buf[:, slots] = np.stack([rows, lo, hi])
        kq, lq, rq = (torch.from_numpy(a).to(dev).to(dt) for a in buf)
        kw = dict(Lm=1, packing="rows", nq=mt)
        errs.append(max_abs_err(
            (rmq_resolve(rmq, kq, lq, rq, None, 33, **kw),),
            (rmq_resolve_plain(rmq, kq, lq, rq, None, 33, **kw),)))
    log(f"[kernel] K6 rmq_resolve == plain on the 2^{log2n} rep_dna LCP with "
        f"{m} mixed queries (L 2 and 4, packings {', '.join(PACKINGS)}, "
        f"int32 and int64), on small arrays of blocks {sorted(blocks)}, and "
        "on an unsorted tail buffer")

    # the largest dense resolve of the repetitive text's SA+LCP build
    spy, calls = resolve_spy(rmq_resolve)
    xs, alpha, n, N = sa_mod.encode_and_shard(rep_text, dev)
    with mock.patch.object(sa_mod, "rmq_resolve", spy):
        sa_mod.construct_device(xs, alpha, n, N)
    dense = [c for c in calls if c[0] == c[1]]
    if not dense:
        raise AssertionError("the SA+LCP build of rep_dna ran no dense "
                             "resolve")
    *_, args, kw = max(dense, key=lambda c: c[2])
    steps = resolve_steps(calls)
    del calls, dense
    errs.append(max_abs_err((rmq_resolve(*args, **kw),),
                            (rmq_resolve_plain(*args, **kw),)))
    rmq, ks, ls, rs, js, d = args
    k6 = k6_bound(rmq, ks, ls, rs, js, kw["nq"])
    n_narrow = k6.pop("n_narrow")
    kern["rmq_resolve"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/rmq_resolve.cu",
        replaces="psac_tpu/models/suffix_array.py:463-526",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda: rmq_resolve(*args, **kw), 10),
        plain_ms=cuda_ms(lambda: rmq_resolve_plain(*args, **kw), 1),
        **k6,
        shape=dict(rows=rmq.x.shape[0], nq=kw["nq"],
                   n_narrow=n_narrow, packing=kw["packing"],
                   Lm=kw["Lm"], d=d, block=rmq.block))
    log(f"[kernel] K6 timed at the largest resolve of the 2^{log2n} rep_dna "
        f"build: {kw['nq']} queries ({n_narrow} under 8 wide) of "
        f"{rmq.x.shape[0]} rows, packing {kw['packing']}, L - 1 = "
        f"{kw['Lm']}, d = {d}; the build's resolves: {steps}; on {card}")

    # a mostly wide resolve at the same length: seven in eight ranges 8 or
    # more wide, so each warp takes most of its queries in turn
    s = len(rep_lcp)
    rmq = build_local_rmq(torch.from_numpy(rep_lcp).to(dev).to(torch.int32))
    mw = 1 << (log2n - 2)
    rows, lo, hi, j = wide_resolve_queries(s, mw, rmq.block, 4, seed=8)
    q = {k: torch.from_numpy(v).to(dev).to(torch.int32) for k, v in
         resolve_query_arrays(s, rows, lo, hi, j, 2**31 - 1).items()}
    packing = sa_mod.resolve_packing(s, 3, 2**31 - 1)
    ks, ls, rs, js, Lm, _ = sa_mod._Builder(
        s, (10, 10), 3, True, torch.int32, dev)._pack_queries(q, 4, packing)
    wargs = (rmq, ks, ls, rs, js, 1 << 14)
    wkw = dict(Lm=Lm, packing=packing, nq=mw)
    pkw = dict(wkw, m_pad=max(8, s // 32))
    errs.append(max_abs_err((rmq_resolve(*wargs, **wkw),),
                            (rmq_resolve_plain(*wargs, **pkw),)))
    wb = k6_bound(*wargs[:5], mw)
    kern["rmq_resolve"]["max_abs_err"] = max(errs)
    kern["rmq_resolve"]["mostly_wide"] = dict(
        rows=s, nq=mw, n_narrow=wb["n_narrow"], packing=packing,
        ms=cuda_ms(lambda: rmq_resolve(*wargs, **wkw), 10),
        plain_ms=cuda_ms(lambda: rmq_resolve_plain(*wargs, **pkw), 1),
        bound_ms=wb["bound_ms"])
    mwd = kern["rmq_resolve"]["mostly_wide"]
    log(f"[kernel] K6 == plain on a mostly wide resolve of the 2^{log2n} "
        f"rep_dna LCP: {mw} queries ({mwd['n_narrow']} under 8 wide), "
        f"packing {packing}: {mwd['ms']:.3f} ms, bound "
        f"{mwd['bound_ms']:.4f} ms ({100 * mwd['bound_ms'] / mwd['ms']:.2f}% "
        f"of it), plain {mwd['plain_ms']:.3f} ms on {card}")
    del rows, lo, hi, j, q, ks, ls, rs, js, wargs

    # does the build's wall follow K6?  The same construct_device with the
    # plain resolve in K6's place, in turns within this process
    def build_s(resolve) -> float:
        with mock.patch.object(sa_mod, "rmq_resolve", resolve):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sa_mod.construct_device(xs, alpha, n, N)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    turns = [(name, build_s(fn)) for name, fn in (
        ("plain", rmq_resolve_plain), ("K6", rmq_resolve),
        ("K6", rmq_resolve), ("plain", rmq_resolve_plain))]
    kern["rmq_resolve"]["rep_build_s"] = {
        k: [t for name, t in turns if name == k] for k in ("K6", "plain")}
    log(f"[resolve] construct_device of 2^{log2n} rep_dna (synchronized, in "
        "turns): " + ", ".join(f"{name} {t:.3f} s" for name, t in turns)
        + f" on {card}")


def kmer_bound(name: str, args: tuple) -> dict:
    """The bound of one K9 or K10 call from its arguments: each input read
    once and each output written once (K9: the codes, the halo, the GSA's
    eos and one int32 word a position for each word; K10: the sorted words
    and their halo, the GSA's rem and its halo, and one byte of newb and,
    with the LCP, one index word a row), and as operations a shift and an
    or a char (K9) or six a word (K10: xor, compare, clz, subtract,
    divide, add)."""
    if name == "kmer_pack":
        codes, halo, ks = args[:3]
        eos = args[7] if len(args) > 7 else None
        s = codes.shape[0]
        nbytes = codes.nbytes + halo.nbytes + 4 * len(ks) * s
        nbytes += 0 if eos is None else eos.nbytes
        return bound(nbytes, 2 * sum(ks) * s)
    words, halo, ks = args[:3]
    idt, with_lcp = args[7], args[8]
    rem = args[9] if len(args) > 9 else None
    s = words[0].shape[0]
    nbytes = sum(w.nbytes for w in words) + halo.nbytes + s
    nbytes += s * idt.itemsize if with_lcp else 0
    nbytes += 0 if rem is None else rem.nbytes + args[10].nbytes
    return bound(nbytes, 6 * len(ks) * s)


def check_k9_k10(dev, text: bytes, gsa_set: list, card: str,
                 kern: dict) -> None:
    """K9 (``kmer_pack``) and K10 (``kmer_heads``) against their plain
    versions on the card, on the arguments they were called with (noted by
    spies) in the k-mer init of three builds: SA+LCP of the 2^26 random
    DNA (the main path's shape, which the kernel table's times are of), the
    GSA + GLCP of the random string set, and SA+LCP of the first 2^20
    characters with ``force_int64``; K10 also without the LCP on the first.
    Each call is timed both ways with CUDA events.  K9 also on the first
    call with its codes moved 4 bytes off a 16-byte boundary, and on the
    seeded GSA cases whose string ends fall at every offset of a thread's
    run (``dna3-gsa-runs``), across four blocks (``dna2-gsa-blocks3-int64``,
    int64) and at k = 93 (``bin3-gsa-p1``)."""
    from unittest import mock

    import torch

    from psac_tpu_torch.config import SAConfig
    from psac_tpu_torch.models import gsa as gsa_mod
    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.ops import kmer
    from psac_tpu_torch.verify import cases

    plain = {"kmer_pack": kmer.pack_kmers_plain,
             "kmer_heads": kmer.kmer_heads_plain}
    wrapper = {"kmer_pack": kmer.kmer_pack, "kmer_heads": kmer.kmer_heads}

    def recorded(build) -> dict:
        calls = {k: [] for k in wrapper}

        def spy(name):
            def noted(*args):
                calls[name].append(args)
                return wrapper[name](*args)
            return noted

        with mock.patch.object(sa_mod, "kmer_pack", spy("kmer_pack")), \
                mock.patch.object(sa_mod, "kmer_heads", spy("kmer_heads")), \
                mock.patch.object(gsa_mod, "kmer_pack", spy("kmer_pack")), \
                mock.patch.object(gsa_mod, "kmer_heads", spy("kmer_heads")):
            build()
        torch.cuda.synchronize()
        return calls

    def sa_build(t, cfg=None):
        xs, alpha, n, N = sa_mod.encode_and_shard(t, dev)
        return sa_mod.construct_device(xs, alpha, n, N, cfg or SAConfig())

    builds = {
        f"2^{len(text).bit_length() - 1} DNA SA+LCP": lambda: sa_build(text),
        f"GSA of {len(gsa_set)} strings":
            lambda: gsa_mod.build_gsa_device(gsa_set, dev),
        "2^20 DNA SA+LCP int64": lambda: sa_build(
            text[:1 << 20], SAConfig(force_int64=True)),
    }
    errs = {k: [] for k in wrapper}
    for bi, (label, build) in enumerate(builds.items()):
        calls = recorded(build)
        for name in wrapper:
            if not calls[name]:
                raise AssertionError(f"{name} was not called by the {label} "
                                     "build")
            args = calls[name][0]
            variants = [args]
            if name == "kmer_heads" and bi == 0:
                variants.append(args[:8] + (False,) + args[9:])
            if name == "kmer_pack" and bi == 0:
                buf = torch.empty(args[0].shape[0] + 4, dtype=torch.int32,
                                  device=dev)
                view = buf[1:1 + args[0].shape[0]]
                view.copy_(args[0])
                assert view.data_ptr() % 16 == 4
                variants.append((view,) + tuple(args[1:]))
            for a in variants:
                errs[name].append(max_abs_err(wrapper[name](*a),
                                              plain[name](*a)))
            st = dict(ms=cuda_ms(lambda: wrapper[name](*args), 20),
                      plain_ms=cuda_ms(lambda: plain[name](*args), 3),
                      **kmer_bound(name, args))
            if bi == 0:
                kern[name] = dict(
                    route="cuda", source="psac_tpu_torch/csrc/kmer_init.cu",
                    replaces=("psac_tpu/ops/kmer.py:28" if name == "kmer_pack"
                              else "psac_tpu/ops/bitops.py:21"),
                    max_abs_err=0, **st)
            rows = (args[0] if name == "kmer_pack" else args[0][0]).shape[0]
            log(f"[kernel] {'K9' if name == 'kmer_pack' else 'K10'} {name} "
                f"== plain on the {label} init ({rows} rows, "
                f"{len(calls[name])} call(s)): kernel {st['ms']:.4f} "
                f"ms, plain {st['plain_ms']:.3f} ms, bound "
                f"{st['bound_ms']:.4f} ms ({st['bound_by']}) on {card}")
        del calls
    for cname in ("dna3-gsa-runs", "dna2-gsa-blocks3-int64", "bin3-gsa-p1"):
        c, case = cases.kmer_case(cname)
        idt = torch.int64 if c["int64"] else torch.int32
        for b, codes, halo, eos in cases.kmer_pack_inputs(case, c["p"]):
            args = (torch.from_numpy(codes).to(dev),
                    torch.from_numpy(halo).to(dev), case["ks"], case["bits"],
                    b, case["N"], idt, torch.from_numpy(eos).to(dev, idt))
            errs["kmer_pack"].append(max_abs_err(kmer.kmer_pack(*args),
                                                 plain["kmer_pack"](*args)))
    log("[kernel] K9 kmer_pack == plain on the first call's codes 4 bytes "
        "off a 16-byte boundary and on the GSA cases dna3-gsa-runs (a "
        "string end at every offset of a run), dna2-gsa-blocks3-int64 and "
        "bin3-gsa-p1 (k = 93: the window's tail in two rounds)")
    for name in wrapper:
        kern[name]["max_abs_err"] = max(errs[name])


def gsa_phase(label: str, strings: list, want_k6: bool, card: str) -> dict:
    """GSA + GLCP (``build_gsa_device``) and GST (``construct_gst_device``)
    of a string set on the card, no device given; first and second run by
    the host clock around synchronized calls, peak memory, launches per
    kernel.  The GSA + GLCP is held against the native host oracle, the GST
    against the plain path on the card.  With ``want_k6`` the build must
    launch K6 and is repeated with the plain resolve in K6's place.  The
    host oracle's (GSA, GLCP) is returned as ``out["oracle"]``, the padded
    GST node table, on the host, as ``out["gst"]`` (the mesh phase's
    references)."""
    import torch

    from psac_tpu_torch.models.gsa import _flatten, build_gsa_device
    from psac_tpu_torch.models.suffix_tree import (_gst_local,
                                                   construct_gst_device)
    from psac_tpu_torch.ops.kmer import kmer_heads, kmer_pack
    from psac_tpu_torch.ops.nsv_scan import nsv_scan_dual, nsv_scan_spine
    from psac_tpu_torch.ops.rmq import rmq_resolve
    from psac_tpu_torch.ops.tansv import tile_side
    from psac_tpu_torch.parallel.ansv import PLAIN
    from psac_tpu_torch.verify.gsa_oracle import gsa_oracle_native

    reset, read = counter((rmq_resolve, tile_side, nsv_scan_spine,
                           nsv_scan_dual, kmer_pack, kmer_heads))
    out = {}
    dgsa = tree = None
    for run in ("first", "second"):
        del dgsa, tree
        reset()
        gc.collect()  # cyclic garbage of earlier phases holds no memory
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        dgsa = build_gsa_device(strings)
        torch.cuda.synchronize()
        out[f"gsa_{run}_s"] = time.perf_counter() - t0
        mem_gsa = torch.cuda.max_memory_allocated()
        gsa_counts = read()
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = construct_gst_device(dgsa)
        torch.cuda.synchronize()
        out[f"gst_{run}_s"] = time.perf_counter() - t0
        mem_gst = torch.cuda.max_memory_allocated()
        gst_counts = read()
        if run == "first":
            add_launches(gsa_counts)
            add_launches(gst_counts)
    if not (dgsa.sa.is_cuda and tree.nodes.is_cuda):
        raise AssertionError("the GSA build with no device left the card")
    if want_k6 and gsa_counts["rmq_resolve"] == 0:
        raise AssertionError(f"K6 was not launched by the GSA of {label}")
    for k in ("kmer_pack", "kmer_heads"):
        if gsa_counts[k] == 0:
            raise AssertionError(f"{k} was not launched by the GSA of "
                                 f"{label}")
    if (gst_counts["nsv_scan_dual"], gst_counts["tile_side"],
            gst_counts["nsv_scan_spine"]) != (1, 0, 0):
        raise AssertionError(f"GST of {label} launched {gst_counts}")
    flat, lens = _flatten(strings)
    t0 = time.perf_counter()
    want_sa, want_lcp = gsa_oracle_native(flat, lens)
    t_oracle = time.perf_counter() - t0
    res = dgsa.materialize()
    if not (np.array_equal(res.sa, want_sa)
            and np.array_equal(res.lcp, want_lcp)):
        raise AssertionError(f"GSA + GLCP of {label} differ from the host "
                             "oracle")
    rem = np.repeat(np.cumsum(lens), lens)[want_sa] - want_sa
    ties = int(((want_lcp[1:] == rem[1:]) & (want_lcp[1:] == rem[:-1])).sum())
    out["oracle"] = (want_sa, want_lcp)
    del res, want_sa, want_lcp, rem
    plain = _gst_local(dgsa, PLAIN)
    if not torch.equal(tree.nodes, plain.nodes):
        raise AssertionError(f"GST of {label} differs from the plain path")
    out["gst"] = tree.nodes.cpu()
    del plain
    if want_k6:
        # the same build with the plain resolve in K6's place
        from unittest import mock

        from psac_tpu_torch.models import suffix_array as sa_mod
        from psac_tpu_torch.ops.rmq import rmq_resolve_plain

        spy, calls = resolve_spy(rmq_resolve_plain)
        with mock.patch.object(sa_mod, "rmq_resolve", spy):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build_gsa_device(strings)
            torch.cuda.synchronize()
            out["gsa_plain_resolve_s"] = time.perf_counter() - t0
        log(f"[gsa] {label}: GSA + GLCP with the plain resolve in K6's "
            f"place {out['gsa_plain_resolve_s']:.3f} s (with K6 "
            f"{out['gsa_second_s']:.3f} s); resolves: "
            f"{resolve_steps(calls)}; on {card}")
        del calls
    n = len(flat)
    log(f"[gsa] {label} ({len(lens)} strings, {n} characters): GSA + GLCP == "
        f"host oracle (SA-IS + Kasai of the joined strings, "
        f"{t_oracle:.2f} s on the host; {ties} rows repeat the whole suffix "
        f"above them): "
        f"{out['gsa_first_s']:.3f} s first, {out['gsa_second_s']:.3f} s "
        f"second ({n / out['gsa_second_s'] / 1e6:.1f} MB/s), peak "
        f"{mem_gsa / 2**30:.2f} GiB ({live / 2**30:.2f} GiB live before "
        f"it), launches {gsa_counts} on {card}")
    log(f"[gsa] {label}: GST == plain path: {out['gst_first_s']:.3f} s "
        f"first, {out['gst_second_s']:.3f} s second, peak "
        f"{mem_gst / 2**30:.2f} GiB, launches {gst_counts} on {card}")
    out["k6_launches"] = gsa_counts["rmq_resolve"]
    return out


def small_gsa_sets(card: str) -> None:
    """Small string sets on the card (no device given) against the sorting
    oracle and ``gst_oracle``."""
    from psac_tpu_torch import build_gsa, build_gst
    from psac_tpu_torch.ops.alphabet import Alphabet, rand_dna
    from psac_tpu_torch.verify.gsa_oracle import gsa_oracle
    from psac_tpu_torch.verify.suffix_tree_oracle import gst_oracle

    rng = np.random.RandomState(13)
    sets = {
        "24 random DNA strings": [
            rand_dna(int(ln), seed=100 + i)
            for i, ln in enumerate(rng.randint(5, 200, size=24))],
        "(ab)^i": [b"ab" * i for i in range(1, 12)],
        "duplicates": [b"banana"] * 5 + [b"ban", b"anana"],
    }
    for name, parts in sets.items():
        flat = b"".join(parts)
        lens = np.array([len(x) for x in parts], np.int64)
        sa, lcp = gsa_oracle(parts)
        res = build_gsa(parts)
        if not (np.array_equal(res.sa, sa) and np.array_equal(res.lcp, lcp)):
            raise AssertionError(f"GSA of {name} differs from the sorting "
                                 "oracle")
        alpha = Alphabet.from_bytes(flat)
        want = gst_oracle(alpha.encode(flat), sa, lcp,
                          np.repeat(np.cumsum(lens), lens), alpha.sigma)
        if not np.array_equal(build_gst(parts), want):
            raise AssertionError(f"GST of {name} differs from gst_oracle")
    log(f"[small] GSA == sorting oracle and GST == gst_oracle for "
        f"{', '.join(sets)} on {card}")


def tail_stages_check(card: str) -> None:
    """The eos-aware two-stage tail on the card, for correctness only: a
    small set whose tied pairs leave the dense loop one after another, so
    that a GSA build runs dense steps, the big tail stage, the recompaction
    and the small stage, K6 in each step.  Held against the native host
    oracle; the GST against the plain path."""
    import torch
    from unittest import mock

    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.models.gsa import _flatten, build_gsa_device
    from psac_tpu_torch.models.suffix_tree import (_gst_local,
                                                   construct_gst_device)
    from psac_tpu_torch.ops.rmq import rmq_resolve
    from psac_tpu_torch.parallel.ansv import PLAIN
    from psac_tpu_torch.verify.cases import twin_prefix_set
    from psac_tpu_torch.verify.gsa_oracle import gsa_oracle_native

    parts = twin_prefix_set()
    spy, calls = resolve_spy(rmq_resolve)
    before = rmq_resolve.launches
    with mock.patch.object(sa_mod, "rmq_resolve", spy):
        dgsa = build_gsa_device(parts)
    tails = {c[0] for c in calls if c[0] != c[1]}
    if len(tails) < 2 or len(tails) == len(calls):
        raise AssertionError("the twin-prefix set's GSA ran resolves "
                             f"{resolve_steps(calls)}: no dense step, or "
                             "fewer than two tail stages")
    if rmq_resolve.launches - before != sum(c[2] > 0 for c in calls):
        raise AssertionError("K6's launch count differs from its calls "
                             "with a query slot")
    want_sa, want_lcp = gsa_oracle_native(*_flatten(parts))
    res = dgsa.materialize()
    if not (np.array_equal(res.sa, want_sa)
            and np.array_equal(res.lcp, want_lcp)):
        raise AssertionError("GSA + GLCP of the twin-prefix set differ from "
                             "the host oracle")
    if not torch.equal(construct_gst_device(dgsa).nodes,
                       _gst_local(dgsa, PLAIN).nodes):
        raise AssertionError("GST of the twin-prefix set differs from the "
                             "plain path")
    log(f"[small] twin-prefix set ({len(parts)} strings, {len(want_sa)} "
        f"characters): GSA + GLCP == host oracle through resolves "
        f"{resolve_steps(calls)}; GST == plain path; on {card}")


def rep_tree_phase(dev, rep_text: bytes, log2n: int, card: str) -> dict:
    """The suffix tree of repetitive DNA on the card: its ANSV pass is one
    K2 launch and no K4 or K1 launch, counted; the tree is held against the
    plain path's; timed with the host clock around a synchronized call,
    first and second."""
    import torch

    from psac_tpu_torch.models.suffix_array import (construct_device,
                                                    encode_and_shard)
    from psac_tpu_torch.models.suffix_tree import (
        _st_local, construct_suffix_tree_device)
    from psac_tpu_torch.ops.nsv_scan import nsv_scan_dual, nsv_scan_spine
    from psac_tpu_torch.ops.tansv import tile_side
    from psac_tpu_torch.parallel.ansv import PLAIN

    xs, alpha, n, N = encode_and_shard(rep_text, dev)
    dsa = construct_device(xs, alpha, n, N)
    reset, read = counter((tile_side, nsv_scan_spine, nsv_scan_dual))
    want = {"tile_side": 0, "nsv_scan_spine": 0, "nsv_scan_dual": 1}
    out = {}
    for run in ("cold", "warm"):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = construct_suffix_tree_device(dsa, xs)
        torch.cuda.synchronize()
        out[run] = time.perf_counter() - t0
        counts = read()
        if counts != want:
            raise AssertionError(f"ST of rep_dna launched {counts}, "
                                 f"expected {want}")
        if run == "cold":
            add_launches(counts)
    plain = _st_local(dsa, xs, PLAIN)
    if not torch.equal(tree.nodes, plain.nodes):
        raise AssertionError("suffix tree of rep_dna differs from the plain "
                             "path")
    log(f"[rep-st] ST 2^{log2n} rep_dna == plain path: {out['cold']:.3f} s "
        f"first, {out['warm']:.3f} s second; launches {counts} on {card}")
    return out


def ansv_values(log2n: int, seed: int = 24) -> np.ndarray:
    """Seeded random int32 values with ties (a 2^16-value range)."""
    rng = np.random.RandomState(seed + log2n)
    return rng.randint(0, 1 << 16, 1 << log2n).astype(np.int32)


def public_ansv_phase(dev, log2n: int, card: str) -> dict:
    """The public ``ansv`` on the card for five match-type pairs, each call
    counted on its own and held against the plain path on the card; the
    same pairs at 2^16 against ``ansv_seq``; wide int64 values at 2^20;
    the device's share of (NSM,NSM) (K5 only) and (FEQ,NSM) (seconds)."""
    import torch

    from psac_tpu_torch import ansv
    from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                         ansv_seq)
    from psac_tpu_torch.ops.bansv import block_psv
    from psac_tpu_torch.ops.nsv_scan import (nsv_scan_dual, nsv_scan_left,
                                             nsv_scan_spine)
    from psac_tpu_torch.ops.tansv import tile_side
    from psac_tpu_torch.parallel.ansv import KERNELS, PLAIN, _ansv
    from psac_tpu_torch.parallel.mesh import padded_size

    reset, read = counter((tile_side, nsv_scan_spine, nsv_scan_dual,
                           nsv_scan_left, block_psv))
    NSM, NEQ, FEQ = NEAREST_SM, NEAREST_EQ, FURTHEST_EQ
    expect = {(NSM, NSM): {"block_psv": 2},
              (NEQ, FEQ): {"block_psv": 1, "nsv_scan_left": 1},
              (FEQ, NEQ): {"block_psv": 1, "nsv_scan_left": 1},
              (FEQ, FEQ): {"nsv_scan_dual": 1},
              (FEQ, NSM): {"nsv_scan_dual": 1}}
    names = {NSM: "NSM", NEQ: "NEQ", FEQ: "FEQ"}
    vals = ansv_values(log2n)
    total = dict.fromkeys(read(), 0)
    times = {}

    def run(lt, rt, **kw):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ansv(vals, lt, rt, device=dev, **kw)
        dt = time.perf_counter() - t0
        counts = read()
        for k, v in counts.items():
            total[k] += v
        want = ansv(vals, lt, rt, device=dev, kernels=PLAIN, **kw)
        for g, w in zip(got, want):
            for a, b in (zip(g, w) if kw else ((g, w),)):
                if not np.array_equal(a, b):
                    raise AssertionError(f"ansv {names[lt]},{names[rt]} {kw} "
                                         "differs from the plain path")
        return dt, counts

    for (lt, rt), want in expect.items():
        dt, counts = run(lt, rt)
        ran = {k: v for k, v in counts.items() if v}
        if ran != want:
            raise AssertionError(f"ansv {names[lt]},{names[rt]} launched "
                                 f"{ran}, expected {want}")
        times[f"{names[lt]},{names[rt]}"] = dt
        log(f"[ansv] 2^{log2n} {names[lt]},{names[rt]}: {dt:.3f} s, "
            f"launches {ran}, == plain path")
    dt, counts = run(FEQ, NSM, indexing="local")
    log(f"[ansv] 2^{log2n} FEQ,NSM indexing=local: {dt:.3f} s == plain path")

    small = vals[:1 << 16]
    for lt, rt in expect:
        got = ansv(small, lt, rt, device=dev)
        for g, w in zip(got, ansv_seq(small, lt, rt, nonsv=len(small))):
            if not np.array_equal(g, w):
                raise AssertionError(f"ansv {names[lt]},{names[rt]} at 2^16 "
                                     "differs from ansv_seq")
    log("[ansv] the five pairs at 2^16 == ansv_seq")

    wide = ansv_values(20).astype(np.int64) << 33
    for lt, rt in ((NSM, NSM), (FEQ, NEQ), (FEQ, FEQ)):
        reset()
        got = ansv(wide, lt, rt, device=dev)
        counts = read()
        if counts["block_psv"] != 2 or sum(counts.values()) != 2:
            raise AssertionError(f"wide ansv launched {counts}")
        for k, v in counts.items():
            total[k] += v
        want = ansv(wide, lt, rt, device=dev, kernels=PLAIN)
        for g, w in zip(got, want):
            if not np.array_equal(g, w):
                raise AssertionError("wide ansv differs from the plain path")
    log("[ansv] 2^20 int64 values (NSM,NSM), (FEQ,NEQ), (FEQ,FEQ): K5 only, "
        "== plain path")
    for k in ("nsv_scan_left", "block_psv"):
        if total[k] == 0:
            raise AssertionError(f"{k} was not launched by the public ansv")
    add_launches(total)
    log(f"[ansv] launches over the public ANSV calls: {total} on {card}")

    # the device's share: the same passes on values already on the card,
    # padded as ``ansv`` pads them (CUDA-event means over 5 calls)
    xp = np.full(padded_size(len(vals), 1), 2**31 - 1, np.int32)
    xp[:len(vals)] = vals
    xd = torch.from_numpy(xp).to(dev)
    for lt, rt in ((NSM, NSM), (FEQ, NSM)):
        key = f"{names[lt]},{names[rt]} on device"
        times[key] = cuda_ms(lambda: _ansv(xd, lt, rt, KERNELS, xd.dtype),
                             5) / 1e3
        log(f"[ansv] 2^{log2n} {names[lt]},{names[rt]} on the device alone: "
            f"{1e3 * times[key]:.3f} ms on {card}")
    return times


def sa_bounds(tpad: np.ndarray, sa: np.ndarray, pats: np.ndarray,
              upper: bool) -> np.ndarray:
    """Vectorized binary search of the native SA: per pattern row, the
    first SA row whose suffix is >= (upper: >) the pattern, comparing the
    pattern's length; ``tpad`` is the text with zero bytes past its end."""
    n = len(sa)
    B, L = pats.shape
    lo = np.zeros(B, np.int64)
    hi = np.full(B, n, np.int64)
    rows = np.arange(B)
    cols = np.arange(L)
    while (lo < hi).any():
        active = lo < hi
        mid = (lo + hi) // 2
        win = tpad[sa[np.minimum(mid, n - 1)][:, None] + cols]
        diff = win != pats
        first = diff.argmax(axis=1)
        less = diff.any(axis=1) & (win[rows, first] < pats[rows, first])
        right = less | (upper & ~diff.any(axis=1))
        lo = np.where(active & right, mid + 1, lo)
        hi = np.where(active & ~right, mid, hi)
    return lo


def file_digests(prefix: str,
                 exts=(".sa64", ".lcp64", ".lc64", ".alpha")) -> dict:
    """SHA-256 of each file of a written index (a DESA's by default)."""
    import hashlib

    out = {}
    for ext in exts:
        h = hashlib.sha256()
        with open(prefix + ext, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                h.update(block)
        out[ext] = h.hexdigest()
    return out


def desa_phase(dev, text: bytes, sa_ref: np.ndarray, batch: int,
               card: str, kern: dict) -> tuple:
    """DESA of the text on the card (``build_desa`` with no device) with
    the TLLT and the TLDT; batches of ``batch`` patterns (half text
    substrings, half random DNA) of lengths 8, 20 and 64; every range
    checked against the native SA.  K7's launches on the timed batches
    count as the main path's; the inputs of the length-20 and -64 batches'
    blind searches are recorded and K7 is checked on them
    (``check_k7``, which adds its row to ``kern``).  Returns the timings
    and, for the mesh phase, the batches, their TLLT ranges and the
    digests of the TLLT index's files (``write_desa``)."""
    import torch

    from unittest import mock

    from psac_tpu_torch import build_desa
    from psac_tpu_torch.models import desa as desa_mod
    from psac_tpu_torch.models.desa import _sample_mask_local, write_desa
    from psac_tpu_torch.models.suffix_array import (construct_device,
                                                    encode_and_shard)
    from psac_tpu_torch.ops.bansv import block_psv
    from psac_tpu_torch.ops.blind_search import blind_search
    from psac_tpu_torch.ops.nsv_scan import nsv_scan_left
    from psac_tpu_torch.ops.pattern_pack import pattern_pack
    from psac_tpu_torch.parallel.ansv import PLAIN
    from psac_tpu_torch.seq import SAIndex

    n = len(text)
    reset, read = counter((block_psv, nsv_scan_left))
    reset_k7, read_k7 = counter((blind_search, pattern_pack))
    out = {}
    idx = {}
    for tli in ("tllt", "tldt"):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx[tli] = build_desa(text, tli=tli)
        torch.cuda.synchronize()
        out[f"build_{tli}_s"] = time.perf_counter() - t0
        counts = read()
        log(f"[desa] build 2^{n.bit_length() - 1} {tli}: "
            f"{out[f'build_{tli}_s']:.3f} s, launches {counts}")
        add_launches(counts)
        if tli == "tldt" and counts["block_psv"] == 0:
            raise AssertionError("K5 was not launched by the TLDT build")
    samp = idx["tldt"].samp
    log(f"[desa] tldt samples {samp['m']} rows (maxsize {n // 128}); "
        f"tllt k {idx['tllt'].k}, table {idx['tllt'].table.shape[0]}")

    xs, alpha, n_, N = encode_and_shard(text, dev)
    dsa = construct_device(xs, alpha, n_, N)
    mask = _sample_mask_local(None, dsa.lcp, n=n, maxsize=n // 128)
    plain = _sample_mask_local(None, dsa.lcp, n=n, maxsize=n // 128,
                               kernels=PLAIN)
    if not torch.equal(mask, plain):
        raise AssertionError("TLDT sampling mask differs from the plain path")
    log(f"[desa] TLDT sampling mask == plain path ({int(mask.sum())} rows)")
    del xs, dsa, mask, plain
    work = os.path.join(ROOT, "_smoke")
    os.makedirs(work, exist_ok=True)
    prefix = os.path.join(work, "desa1")
    t0 = time.perf_counter()
    write_desa(idx["tllt"], prefix)
    ref = dict(files=file_digests(prefix), batches={}, answers={})
    for ext in ref["files"]:
        os.remove(prefix + ext)
    log(f"[desa] write_desa of the TLLT index: "
        f"{time.perf_counter() - t0:.1f} s with its digests (host)")

    rng = np.random.RandomState(2026)
    tarr = np.frombuffer(text, np.uint8)
    dna = np.frombuffer(b"ACGT", np.uint8)
    oracle = SAIndex(text, sa_ref)
    k7_calls = {}
    for L in (8, 20, 64):
        half = batch // 2
        starts = rng.randint(0, n - L, half)
        sub = tarr[starts[:, None] + np.arange(L)]
        rnd = dna[rng.randint(0, 4, (batch - half, L))]
        mat = np.concatenate([sub, rnd])
        pats = [row.tobytes() for row in mat]
        res = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx["tllt"].encode_patterns(pats)
        torch.cuda.synchronize()
        log(f"[desa] encoding of {batch} x len {L} patterns "
            f"(DESA.encode_patterns: the host's join and offsets, two "
            f"uploads, K11): {time.perf_counter() - t0:.4f} s")
        if L == 20:
            k11_pats = pats
        for tli, d in idx.items():
            d.bulk_locate(pats)  # warm-up at this shape
            reset_k7()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[tli] = d.bulk_locate(pats)
            dt = time.perf_counter() - t0
            k7_counts = read_k7()
            add_launches(k7_counts)
            out[f"qps_{tli}_L{L}"] = batch / dt
            log(f"[desa] {tli} bulk_locate {batch} x len {L}: {dt:.3f} s, "
                f"{batch / dt:,.0f} patterns/s, blind-search steps "
                f"{d.last_stats['steps']}, readbacks "
                f"{d.last_stats['readbacks']}, launches {k7_counts}")
            if (L > idx["tllt"].k or tli == "tldt") and \
                    k7_counts["blind_search"] == 0:
                raise AssertionError(f"K7 was not launched by {tli} "
                                     f"bulk_locate at len {L}")
            if L in (20, 64):
                # the blind searches' inputs, for K7's check (not counted)
                calls = []

                def record(*args, calls=calls):
                    calls.append(args)
                    return blind_search(*args)

                with mock.patch.object(desa_mod, "blind_search", record):
                    d.bulk_locate(pats)
                k7_calls[(tli, L)] = calls
        if not np.array_equal(res["tllt"], res["tldt"]):
            raise AssertionError(f"tllt and tldt ranges differ at len {L}")
        ref["batches"][L], ref["answers"][L] = pats, res["tllt"]
        tpad = np.concatenate([tarr, np.zeros(L, np.uint8)])
        lo = sa_bounds(tpad, sa_ref, mat, False)
        hi = sa_bounds(tpad, sa_ref, mat, True)
        got = res["tllt"]
        found = hi > lo
        if not (np.array_equal(got[found, 0], lo[found])
                and np.array_equal(got[found, 1], hi[found])
                and np.all(got[~found, 0] == got[~found, 1])):
            raise AssertionError(f"bulk_locate ranges at len {L} differ from "
                                 "the native SA")
        for i in rng.choice(batch, min(batch, 1024), replace=False):
            want = oracle.locate(pats[i])
            if not (tuple(got[i]) == want
                    or (got[i, 0] == got[i, 1] and want[0] == want[1])):
                raise AssertionError(f"pattern {i} of len {L}: {got[i]} vs "
                                     f"SAIndex {want}")
        log(f"[desa] len {L}: {int(found.sum())} of {batch} patterns occur "
            f"({int((hi - lo).sum())} rows); every range == the native SA, "
            f"{min(batch, 1024)} == SAIndex")
    log(f"[desa] on {card}")
    check_k7(k7_calls, card, kern)
    check_k11(idx["tllt"], k11_pats, card, kern)
    return out, ref


def k11_bound(flat, offs, lmax: int) -> dict:
    """K11's bound: each pattern byte, each offset and the byte table read
    once, and the code matrix, the lengths and the bad flags written once;
    one comparison a code."""
    B = offs.shape[0] - 1
    return bound(flat.nbytes + offs.nbytes + 256 + B * (4 * lmax + 4 + 1),
                 B * lmax)


def check_k11(desa, pats: list, card: str, kern: dict) -> None:
    """K11 against its plain version on the main path's batch of 65,536
    patterns of length 20 (Lmax 32), from the bytes and offsets that
    ``DESA.encode_patterns`` uploads, timed both ways; and the encoding's
    phases on the host clock (each ended by a synchronise): the join and
    the offsets, the two uploads, K11.  The kernel's time is that of a
    CUDA graph of 20 calls, replayed: calls back to back wait on the
    wrapper's host path (three allocations and the ctypes call, some 40
    us), not on the card."""
    import torch

    from psac_tpu_torch.models.desa import _joined
    from psac_tpu_torch.ops.bitops import pow2ceil
    from psac_tpu_torch.ops.pattern_pack import (pattern_pack,
                                                 pattern_pack_plain)

    dev = desa.xs.device
    walls = {}

    def phase(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return got

    def host():
        lens = np.fromiter(map(len, pats), np.int64, len(pats))
        offs = np.zeros(len(pats) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        return _joined(pats), offs, pow2ceil(max(2, int(lens.max())))

    flat, offs, lmax = phase("host", host)
    flat, offs = phase("upload", lambda: (torch.from_numpy(flat).to(dev),
                                          torch.from_numpy(offs).to(dev)))
    table = desa._code_table
    got = phase("k11", lambda: pattern_pack(flat, offs, table, lmax))
    err = max_abs_err(tuple(t.cpu() for t in got),
                      pattern_pack_plain(flat.cpu(), offs.cpu(), table.cpu(),
                                         lmax))
    b = k11_bound(flat, offs, lmax)
    call_ms = cuda_ms(lambda: pattern_pack(flat, offs, table, lmax), 50)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            captured = pattern_pack(flat, offs, table, lmax)
    ms = cuda_ms(graph.replay, 10) / 20
    err = max(err, max_abs_err(tuple(t.cpu() for t in captured),
                               tuple(t.cpu() for t in got)))
    plain_ms = cuda_ms(lambda: pattern_pack_plain(flat, offs, table, lmax), 5)
    log(f"[k11] pattern_pack, {len(pats)} x len {len(pats[0])} (Lmax {lmax}, "
        f"{flat.shape[0]} bytes): == plain (max abs err {err}); kernel "
        f"{ms:.4f} ms (a graph's replays; calls back to back {call_ms:.4f} "
        f"ms), plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, {100 * b['bound_ms'] / ms:.2f}% reached); "
        f"encoding walls (synchronised): host join and offsets "
        f"{1e3 * walls['host']:.3f} ms, uploads {1e3 * walls['upload']:.3f} "
        f"ms, K11 launch to done {1e3 * walls['k11']:.3f} ms on {card}")
    kern["pattern_pack"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/pattern_pack.cu",
        replaces="psac_tpu/models/desa.py:177", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, **b)


#: K12's shapes in the 4-chip cell (p = 4, s = 134,217,728 rows a shard):
#: the ANSV's routed calls (s / 4 rows, 99.9% skipped) and the tree's
#: (s / 2 rows, 19% skipped), each at cap = m (a chunk of the
#: never-overflowing route)
K12_SHAPES = ((33_554_432, 0.999), (67_108_864, 0.19))


def k12_bound(m: int, wide: bool) -> dict:
    """K12's bound: the destinations (4 B) and skip flags (1 B) read twice
    (a count pass and a place pass), the positions written once."""
    return bound(m * (2 * 5 + (8 if wide else 4)), 0)


def _chain_bucket(dest, p: int, cap: int, skip):
    """The bucketing K12 replaced, as PyTorch ops (the yardstick): a stable
    sort of the keys, the run starts' 1-D ``torch.cummax``, the slots and
    flat positions in sorted order; (order, flat_pos)."""
    import torch

    m = dest.shape[0]
    dkey = torch.where(skip, p, dest)
    dsort, order = torch.sort(dkey, stable=True)
    i = torch.arange(m, dtype=torch.int32, device=dest.device)
    is_start = torch.ones(m, dtype=torch.bool, device=dest.device)
    is_start[1:] = dsort[1:] != dsort[:-1]
    start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    slot = i - start
    dropped = ((slot >= cap) & (dsort < p)) | (dsort >= p)
    return order, torch.where(dropped, p * cap, dsort * cap + slot)


def check_k12(dev, card: str, kern: dict, p: int = 4) -> None:
    """K12 against its plain version, and against the chain it replaced
    (the positions that chain wrote in sorted order, put in record order),
    at the 4-chip cell's shapes (``K12_SHAPES``), timed each way: K12, the
    plain version, the chain, and the chain's 1-D ``torch.cummax`` alone."""
    import torch

    from psac_tpu_torch.parallel import route

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    for m, share in K12_SHAPES:
        dest = torch.randint(0, p, (m,), dtype=torch.int32, device=dev,
                             generator=g)
        skip = torch.rand(m, device=dev, generator=g) < share
        cap = m
        pos, ovf = route._bucket_by_dest(dest, p, cap, skip)
        want, wovf = route._bucket_by_dest_plain(dest, p, cap, skip)
        order, flat = _chain_bucket(dest, p, cap, skip)
        chain = torch.empty_like(pos)
        chain[order] = flat.to(pos.dtype)
        err = max(max_abs_err((pos, ovf), (want, wovf)),
                  max_abs_err((pos,), (chain,)))
        del want, order, flat, chain
        ms = cuda_ms(lambda: route._bucket_by_dest(dest, p, cap, skip), 20)
        plain_ms = cuda_ms(
            lambda: route._bucket_by_dest_plain(dest, p, cap, skip), 3)
        chain_ms = cuda_ms(lambda: _chain_bucket(dest, p, cap, skip), 3)
        runs = torch.where(torch.rand(m, device=dev, generator=g) < 1e-3,
                           torch.arange(m, dtype=torch.int32, device=dev), 0)
        cummax_ms = cuda_ms(lambda: torch.cummax(runs, dim=0), 3)
        del runs
        b = k12_bound(m, pos.dtype == torch.int64)
        log(f"[k12] route_bucket p = {p}, {m} rows, {100 * share:.1f}% "
            f"skipped, cap {cap}: == plain and == the sort + cummax chain "
            f"(max abs err {err}); kernel {ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}, "
            f"{100 * b['bound_ms'] / ms:.2f}% reached), plain "
            f"{plain_ms:.3f} ms, chain {chain_ms:.3f} ms (its 1-D "
            f"torch.cummax {cummax_ms:.3f} ms) on {card}")
        kern["route_bucket"] = dict(
            route="cuda", source="psac_tpu_torch/csrc/route_bucket.cu",
            replaces="psac_tpu/parallel/route.py:45", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, **b, library_ms_chain=chain_ms,
            cummax_ms=cummax_ms, rows=m, skipped=share)
        del dest, skip, pos


def k7_reads(args, got) -> dict:
    """What K7's walks read on this batch, each word of an input counted
    once over the whole batch: a lockstep replay of the kernel's walk,
    branch for branch, that marks the pattern codes and the Lc words of
    each inner step, every LCP word read, the LCP words of each argmin's
    edge scans and the table entries of each argmin that spans a full
    block.  Its final (l, r, q, steps) must equal the kernel's ``got``.
    ``scanned`` sums the edge words over the argmins (their comparisons);
    ``argmins`` counts them, ``rounds`` sums their load rounds at the
    launch's shape (``launch_shape``: 16-byte vectors, lanes per pattern
    and vectors per lane in a round, and a second round for the table's
    indexes where no full block lies between and every word is INF) and
    ``multi`` counts those that took more than one."""
    import torch

    from psac_tpu_torch.ops.blind_search import launch_shape, max_steps_for
    from psac_tpu_torch.ops.rmq import _floor_log2, edge_mins, query_arg_rmq

    pat, lens, l0, r0, need, lcp, lc, rmq, cap = args[:9]
    B, Lmax = pat.shape
    dev, block, nb = lcp.device, rmq.block, rmq.nb
    i64 = torch.int64

    def flags(size):  # one spare slot at the end takes unselected rows
        return torch.zeros(size + 1, dtype=torch.bool, device=dev)

    codes, lcp_w, lc_w = flags(B * Lmax), flags(cap), flags(cap)
    tab_w = flags(rmq.tab_v.numel())
    runs = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    scanned = torch.zeros((), dtype=i64, device=dev)
    vec = 16 // lcp.element_size()  # words per 16-byte vector
    shape = launch_shape(lcp.dtype, cap, B)
    per_round = shape["group"] * shape["round"]
    inf = torch.iinfo(lcp.dtype).max
    rounds = {k: torch.zeros((), dtype=i64, device=dev)
              for k in ("argmins", "rounds", "multi")}

    def mark(w, sel, idx):
        w[torch.where(sel, idx, w.shape[0] - 1)] = True

    def at(sel, i):
        i = i.clamp(0, cap - 1)
        mark(lcp_w, sel, i)
        return lcp[i]

    def argmin(sel, lo, hi):
        nonlocal scanned
        lo = lo.clamp(0, cap - 1)
        hi = torch.maximum(hi, lo).clamp(0, cap - 1)
        bl, bh = lo // block, hi // block
        for a, b, s in ((lo, torch.where(bl == bh, hi, bl * block + block - 1),
                         sel),
                        (bh * block, hi, sel & (bl != bh))):
            one = s.to(torch.int32)
            runs.index_add_(0, torch.where(s, a, cap), one)
            runs.index_add_(0, torch.where(s, b + 1, cap), -one)
            scanned = scanned + torch.where(s, b - a + 1, 0).sum()
        span = bh - bl - 1
        full = sel & (span > 0)
        lev = _floor_log2(span)
        mark(tab_w, full, lev * nb + bl + 1)
        mark(tab_w, full, lev * nb + bh - (1 << lev))
        lend = torch.where(bl == bh, hi, bl * block + block - 1)
        nvec = lend // vec - lo // vec + 1 + torch.where(
            bl != bh, hi // vec - bh * block // vec + 1, 0)
        nr = -(-nvec // per_round) + (
            (span <= 0) & (edge_mins(lcp, block, lo, hi) == inf)).to(i64)
        rounds["argmins"] += sel.sum()
        rounds["rounds"] += torch.where(sel, nr, 0).sum()
        rounds["multi"] += (sel & (nr > 1)).sum()
        return query_arg_rmq(rmq, lo, hi).to(i64)

    l, r, m = l0.to(i64), r0.to(i64), lens.to(i64)
    rows = torch.arange(B, device=dev, dtype=i64) * Lmax
    every = torch.ones(B, dtype=torch.bool, device=dev)
    i = argmin(every, l + 1, r)
    q = at(every, i)
    done = ~need | ~((q < m) & (l < r) & (l < i))
    fixing = torch.zeros_like(done)
    steps = torch.zeros(B, dtype=i64, device=dev)
    for _ in range(max_steps_for(cap)):
        walk = ~done
        if not bool(walk.any()):
            break
        inner, fix = walk & ~fixing, walk & fixing
        code = rows + q.to(i64).clamp(0, Lmax - 1)
        mark(codes, inner, code)
        ic = i.clamp(0, cap - 1)
        mark(lc_w, inner, ic)
        hit = inner & (lc[ic] == pat.view(-1)[code])
        last = inner & ~hit & (i == r)
        go = inner & ~hit & (i != r)
        below = i < r
        r = torch.where(hit, i - 1, r)
        l = torch.where(last | go, i, l)
        i_go = argmin(go, l + 1, r)
        stay = go & below & (at(go, i_go) == q)
        i = torch.where(go, i_go, i)
        lcpi = at(fix, i)
        down = fix & (lcpi == q) & (l < r)
        back = fix & (lcpi == q) & ~(l < r)
        i_dn = argmin(down, l + 1, r)
        q_fx = torch.where(down, at(down, i_dn),
                           torch.where(back, at(back, l), lcpi))
        i = torch.where(down, i_dn, torch.where(back, l, i))
        q = torch.where(fix, q_fx, q)
        done = done | (fix & ~((q < m) & (l < r) & (l < i)))
        fixing = torch.where(fix, False, fixing | hit | last | (go & ~stay))
        steps += walk
    if not (torch.equal(l.to(torch.int32), got[0])
            and torch.equal(r.to(torch.int32), got[1])
            and torch.equal(q, got[2])
            and torch.equal(steps.to(torch.int32), got[3])):
        raise AssertionError("K7's read count replays another walk than the "
                             "kernel's")
    edge = runs[:cap].cumsum(0, dtype=torch.int32) > 0
    return dict(codes=int(codes[:-1].sum()),
                lcp=int((edge | lcp_w[:-1]).sum()), lc=int(lc_w[:-1].sum()),
                tab=int(tab_w[:-1].sum()), scanned=int(scanned),
                steps=int(steps.sum()),
                **{k: int(v) for k, v in rounds.items()})


def k7_bound(args, got) -> dict:
    """K7's bound from this batch's data, each input read once and each
    output written once: the lengths, start ranges and flags, the
    outputs, and the words of the pattern codes, the LCP, Lc and the table
    (value and index) that the walks read (``k7_reads``).  One comparison
    per edge word scanned and four per step."""
    B, sz = args[0].shape[0], args[5].element_size()
    w = k7_reads(args, got)
    nbytes = (B * (3 * 4 + 1) + B * (3 * 4 + sz) + w["codes"] * 4
              + w["lcp"] * sz + w["lc"] * 4 + w["tab"] * (sz + 4))
    return dict(bound(nbytes, w["scanned"] + 4 * (B + w["steps"])), reads=w)


def check_k7(k7_calls: dict, card: str, kern: dict) -> None:
    """K7 against its plain version on the inputs of the main path's blind
    searches (the 65,536-pattern batches of lengths 20 and 64: the TLLT's
    slab search, the TLDT's sample and slab searches), timed both ways;
    the kernel table's row is the TLLT slab search at length 20."""
    from psac_tpu_torch.ops.blind_search import (blind_search,
                                                 blind_search_plain,
                                                 launch_shape)

    for (tli, L), calls in sorted(k7_calls.items()):
        for where, args in zip(("sample", "slab") if tli == "tldt"
                               else ("slab",), calls):
            got = blind_search(*args)
            stats = {"readbacks": 0}
            want = blind_search_plain(*args[:-1], stats)
            err = max_abs_err(got, want)
            b = k7_bound(args, got)
            w = b.pop("reads")
            ms = cuda_ms(lambda: blind_search(*args), 10)
            plain_ms = cuda_ms(lambda: blind_search_plain(
                *args[:-1], {"readbacks": 0}), 1)
            grid = launch_shape(args[5].dtype, args[8], args[0].shape[0])
            log(f"[k7] {tli} {where} search, {args[0].shape[0]} x len {L} "
                f"({args[5].shape[0]} rows): == plain (max abs err {err}); "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({100 * b['bound_ms'] / ms:.2f}% "
                f"reached), longest walk {int(got[3].max())} steps, "
                f"{w['steps']} steps in all; words read once: {w['lcp']} LCP, "
                f"{w['lc']} Lc, {w['tab']} table, {w['codes']} pattern; "
                f"{w['scanned']} edge words scanned; {w['argmins']} argmins "
                f"in {w['rounds']} load rounds ({w['multi']} took more than "
                f"one); G {grid['group']}, {grid['threads']} threads per "
                f"block, {grid['round']} vectors per lane in a round, "
                f"{grid['blocks']} blocks; "
                f"{stats['readbacks']} plain readbacks on {card}")
            if (tli, L, where) == ("tllt", 20, "slab"):
                kern["blind_search"] = dict(
                    route="cuda", source="psac_tpu_torch/csrc/blind_search.cu",
                    replaces="psac_tpu/models/desa.py:609", max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, **b)


def timed_build(build, label: str, card: str) -> tuple:
    """``build()`` on the card, synchronized, with K6's launches counted
    (they join the kernel table's), its host-loop iterations
    (``LAST_BUILD``; an SA build sets them, a GSA build does not) and its
    peak memory, with what was allocated before it; logged.  Returns
    (result, stats)."""
    import torch

    from psac_tpu_torch.models.suffix_array import LAST_BUILD
    from psac_tpu_torch.ops.kmer import kmer_heads, kmer_pack
    from psac_tpu_torch.ops.rmq import rmq_resolve

    reset, read = counter((rmq_resolve, kmer_pack, kmer_heads))
    LAST_BUILD.update(fused=None, host_iters=None)
    reset()
    gc.collect()  # cyclic garbage of earlier builds holds no memory
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = build()
    torch.cuda.synchronize()
    counts = read()
    st = dict(wall_s=time.perf_counter() - t0, k6=counts["rmq_resolve"],
              host_iters=LAST_BUILD["host_iters"], fused=LAST_BUILD["fused"],
              peak_gib=torch.cuda.max_memory_allocated() / 2**30,
              live_gib=live / 2**30)
    add_launches(counts)
    if counts["kmer_pack"] == 0 or counts["kmer_heads"] == 0:
        raise AssertionError(f"{label}: the k-mer init ran without K9 or "
                             f"K10 ({counts})")
    log(f"[hostloop] {label}: {st['wall_s']:.3f} s, K6 launches {st['k6']}, "
        + (f"host_iters {st['host_iters']}, fused {st['fused']}, "
           if st["host_iters"] is not None else "")
        + f"peak {st['peak_gib']:.2f} GiB ({st['live_gib']:.2f} GiB live "
        f"before it) on {card}")
    return res, st


def hostloop_phase(dev, text: bytes, sa_ref, lcp_ref, log2n: int,
                   rep_text: bytes, rsa, rlcp, rep_log2n: int,
                   gsa_sets: dict, card: str) -> dict:
    """The host-driven construction loop (``SAConfig(fused=False)``) at full
    size through ``construct_device`` and ``build_gsa_device``, each result
    held against the oracle the script already has: SA+LCP of the random
    text at tail thresholds 0.1 and 0.0 and SA-only at factors 2, 3 and 4;
    SA+LCP of ``rep_dna`` (K6 in every doubling step) in turns with the
    fused build; ``pack_keys`` on and off at ``dense_factor=5`` on
    ``rep_dna`` (equal results), in turns; the GSA + GLCP of each set of
    ``gsa_sets`` (label -> (strings, (sa, lcp) oracle)) in turns with the
    fused build."""
    from psac_tpu_torch import SAConfig
    from psac_tpu_torch.models.gsa import build_gsa_device
    from psac_tpu_torch.models.suffix_array import (construct_device,
                                                    encode_and_shard)

    out = {}

    def sa_build(t, conf, label, want_sa, want_lcp, keep=False):
        """(the result if ``keep``, else None; stats)."""
        xs, alpha, n, N = encode_and_shard(t, dev)
        dsa, st = timed_build(
            lambda: construct_device(xs, alpha, n, N, conf), label, card)
        res = dsa.materialize()
        if not np.array_equal(res.sa, want_sa) or (
                conf.construct_lcp and not np.array_equal(res.lcp,
                                                          want_lcp)):
            raise AssertionError(f"{label} differs from the native oracle")
        return (dsa if keep else None), st

    for frac in (0.1, 0.0):
        _, out[f"rand_lcp_frac{frac}"] = sa_build(
            text, SAConfig(fused=False, tail_threshold_frac=frac),
            f"SA+LCP 2^{log2n} rand_dna fused=False tail_threshold_frac "
            f"{frac}", sa_ref, lcp_ref)
    for f in (2, 3, 4):
        _, out[f"rand_sa_f{f}"] = sa_build(
            text, SAConfig(fused=False, construct_lcp=False, factor=f),
            f"SA-only 2^{log2n} rand_dna fused=False factor {f}", sa_ref,
            None)
    log(f"[hostloop] 2^{log2n} rand_dna: every host-loop build == native "
        "SA-IS + Kasai")

    turns = []
    for fused in (True, False, False, True):
        _, st = sa_build(rep_text, SAConfig(fused=fused),
                         f"SA+LCP 2^{rep_log2n} rep_dna fused={fused}", rsa,
                         rlcp)
        turns.append(("fused" if fused else "host", st))
    host = [st for name, st in turns if name == "host"]
    if min(st["k6"] for st in host) == 0 or host[0]["host_iters"] == 0:
        raise AssertionError("the host loop of rep_dna launched no K6")
    out["rep_turns"] = turns

    # the timer's sections of one more host-loop build, summed by kind
    import contextlib
    import io
    import re
    xs, alpha, n, N = encode_and_shard(rep_text, dev)
    err = io.StringIO()
    os.environ["PSAC_TIMER"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            construct_device(xs, alpha, n, N, SAConfig(fused=False))
    finally:
        del os.environ["PSAC_TIMER"]
    del xs
    kinds: dict = {}
    for m in re.finditer(r"^\[timer\] \[construct\] ([a-z-]+)[^\n]*: "
                         r"([0-9.]+) ms$", err.getvalue(), re.M):
        t, c = kinds.get(m.group(1), (0.0, 0))
        kinds[m.group(1)] = (t + float(m.group(2)), c + 1)
    out["rep_sections_ms"] = kinds
    log(f"[hostloop] PSAC_TIMER sections of the 2^{rep_log2n} rep_dna "
        "fused=False build, summed by kind: " + ", ".join(
            f"{k} {t:.2f} ms x{c}" for k, (t, c) in kinds.items())
        + " (a section ends at the next readback: a resolve's device time "
        f"falls into the step after it) on {card}")

    states, ptimes = {}, []
    for packed in (True, False, False, True):
        dsa, st = sa_build(rep_text, SAConfig(dense_factor=5,
                                              pack_keys=packed),
                           f"SA+LCP 2^{rep_log2n} rep_dna dense_factor=5 "
                           f"pack_keys={packed}", rsa, rlcp,
                           keep=packed not in states)
        if dsa is not None:
            states[packed] = dsa
        ptimes.append(("packed" if packed else "unpacked", st))
        del dsa
    import torch
    for field in ("sa", "isa", "lcp"):
        if not torch.equal(getattr(states[True], field),
                           getattr(states[False], field)):
            raise AssertionError(f"pack_keys changed the padded {field}")
    del states
    out["pack_turns"] = ptimes
    log(f"[hostloop] pack_keys at dense_factor=5 on 2^{rep_log2n} rep_dna: "
        "padded SA, ISA, LCP equal packed and unpacked, == native; walls "
        + ", ".join(f"{name} {st['wall_s']:.3f} s" for name, st in ptimes)
        + f" on {card}")

    for label, (strings, (want_sa, want_lcp)) in gsa_sets.items():
        gturns = []
        for fused in (True, False, False, True):
            dgsa, st = timed_build(
                lambda: build_gsa_device(strings,
                                         config=SAConfig(fused=fused)),
                f"GSA + GLCP of {label} fused={fused}", card)
            res = dgsa.materialize()
            if not (np.array_equal(res.sa, want_sa)
                    and np.array_equal(res.lcp, want_lcp)):
                raise AssertionError(f"GSA + GLCP of {label} fused={fused} "
                                     "differ from the host oracle")
            del dgsa, res
            gturns.append(("fused" if fused else "host", st))
        out[f"gsa_{label}"] = gturns
        log(f"[hostloop] GSA + GLCP of {label}: fused and host loop == host "
            "oracle")
    return out


def mins_bound(rmq, lo, hi, valid) -> dict:
    """K6's min-only bound from this call's data, each input read once and
    each output written once: per query a flag read and one word written,
    per valid query its two range words, the LCP words the valid ranges
    cover (at most all of them, each once), and two table words per valid
    range with whole blocks between its edge blocks (at most the table).
    One comparison per word a query reads."""
    import torch

    s, block, isz = rmq.x.shape[0], rmq.block, rmq.x.element_size()
    m = lo.shape[0]
    lo = lo.to(torch.int64)[valid].clamp(0, s - 1)
    hi = torch.maximum(hi.to(torch.int64)[valid], lo).clamp(0, s - 1)
    bl, bh = lo // block, hi // block
    narrow = hi - lo < 8
    between = (bh - bl > 1) & ~narrow
    cross = bl != bh
    edge = torch.where(cross, (bl + 1) * block - lo + hi - bh * block + 1,
                       hi - lo + 1)
    words = torch.where(narrow, hi - lo + 1, edge)
    table = min(2 * int(between.sum()), rmq.table.numel())
    lcp_words = min(int(words.sum()), s)
    nbytes = m * (isz + 1) + (2 * int(valid.sum()) + lcp_words + table) * isz
    return dict(bound(nbytes, int(words.sum()) + 2 * int(between.sum())),
                n_valid=int(valid.sum()), n_narrow=int(narrow.sum()))


def mesh_desa(mesh, timed, sync, text: bytes, ref: dict, log2n: int,
              card: str, kern: dict, out: dict) -> None:
    """The DESA of the text at p = 4 (``[mesh]``), TLLT and TLDT: each
    build's wall, peak and launches (``timed``: K6-mins under the
    construction, as many as the p = 4 SA+LCP build's, K5 in the TLDT's
    mask), its partition and sample; the
    p = 1 batches (``ref``: lengths 8, 20 and 64) answered as p = 1
    answered them, K7's launches counted (p^2 slab searches a batch, p
    more of the TLDT's sample); K7 held against its plain version on the
    shard's slab search with the most valid rows; ``write_desa`` at p = 4 byte for
    byte the p = 1 files (their digests), and ``read_desa(mesh=)`` of them
    answering as p = 1."""
    import threading
    from unittest import mock

    from psac_tpu_torch.models import desa as desa_mod
    from psac_tpu_torch.ops.blind_search import (blind_search,
                                                 blind_search_plain,
                                                 launch_shape)

    n, p = len(text), mesh.p
    reset7, read7 = counter((blind_search,))
    idx = {}
    for tli in ("tllt", "tldt"):
        label = f"DESA {tli} 2^{log2n} p=4"
        d = timed(label, lambda: desa_mod.build_desa(text, tli=tli,
                                                     mesh=mesh))
        segs = np.concatenate([d.begins_np[1:], [n]]) - d.begins_np
        st = out[label]
        st.update(imbalance=float(segs.max() * p / n), cap=d.cap)
        if tli == "tldt":
            st["samples"] = d.samp["m"]
        log(f"[mesh] {label}: segments {segs.tolist()} (imbalance "
            f"{st['imbalance']:.3f}), cap {d.cap}"
            + (f", {d.samp['m']} sampled rows (M {d.samp['M']}, maxsize "
               f"{n // p // 128})" if tli == "tldt" else ""))
        sa_mins = out[f"SA+LCP 2^{log2n} DNA p=4"]["rmq_mins"]
        if st["rmq_mins"] != sa_mins:
            raise AssertionError(f"the p = 4 DESA build ({tli}) launched "
                                 f"K6-mins {st['rmq_mins']} times, its "
                                 f"SA+LCP build {sa_mins}")
        if tli == "tldt" and st["block_psv"] == 0:
            raise AssertionError("K5 was not launched by the p = 4 TLDT "
                                 "build")
        idx[tli] = d

    for L, pats in ref["batches"].items():
        for tli, d in idx.items():
            label = f"DESA {tli} 2^{log2n} p=4"
            d.bulk_locate(pats)  # warm-up at this shape
            reset7()
            sync()
            t0 = time.perf_counter()
            got = d.bulk_locate(pats)
            sync()
            dt = time.perf_counter() - t0
            k7n = read7()["blind_search"]
            add_launches({"blind_search": k7n})
            want = p * p + (p if tli == "tldt" else 0)
            if len(pats) // p > p and k7n != want:
                raise AssertionError(f"K7 launched {k7n} times by the p = 4 "
                                     f"{tli} batch at len {L}, not {want}")
            if not np.array_equal(got, ref["answers"][L]):
                raise AssertionError(f"p = 4 {tli} bulk_locate at len {L} "
                                     "differs from p = 1")
            out[label][f"qps_L{L}"] = len(pats) / dt
            log(f"[mesh] {tli} bulk_locate p=4 {len(pats)} x len {L}: "
                f"{dt:.3f} s, {len(pats) / dt:,.0f} patterns/s, == p = 1; "
                f"K7 launches {k7n}, steps {d.last_stats['steps']}, "
                f"readbacks {d.last_stats['readbacks']} on {card}")

    # K7 on the slab search with the most valid rows (calls noted in an
    # untimed run of the length-20 and -64 batches)
    calls, lock = [], threading.Lock()

    def record(*args):
        nv = int(args[4].sum())
        with lock:
            calls.append((nv, args))
        return blind_search(*args)

    with mock.patch.object(desa_mod, "blind_search", record):
        for L in (20, 64):
            for d in idx.values():
                d.bulk_locate(ref["batches"][L])
    caps = {d.cap for d in idx.values()}
    nv, args = max((c for c in calls if c[1][8] in caps), key=lambda c: c[0])
    mdev = args[0].device
    got = blind_search(*args)
    err = max_abs_err(got, blind_search_plain(*args[:-1], {"readbacks": 0}))
    b = k7_bound(args, got)
    b.pop("reads")
    ms = cuda_ms(lambda: blind_search(*args), 10, mdev)
    plain_ms = cuda_ms(lambda: blind_search_plain(
        *args[:-1], {"readbacks": 0}), 1, mdev)
    k = kern["blind_search"]
    k["max_abs_err"] = max(k["max_abs_err"], err)
    grid = launch_shape(args[5].dtype, args[8], args[0].shape[0])
    k["mesh_call"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                          B=args[0].shape[0], valid=nv,
                          rows=args[5].shape[0], group=grid["group"])
    if err:
        raise AssertionError("K7 differs from its plain version on a p = 4 "
                             "slab search")
    log(f"[kernel] K7 blind_search == plain on the p = 4 slab search with the "
        f"most valid rows ({nv} of {args[0].shape[0]} received rows, a "
        f"{args[5].shape[0]}-row slab, G {grid['group']}): {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.5f} ms "
        f"({b['bound_by']}) on {card}")
    del calls, args, got

    # write_desa at p = 4 == p = 1, and read_desa(mesh=) of the files
    work = os.path.join(ROOT, "_smoke")
    os.makedirs(work, exist_ok=True)
    prefix = os.path.join(work, "desa4")
    try:
        desa_mod.write_desa(idx["tllt"], prefix)
        if file_digests(prefix) != ref["files"]:
            raise AssertionError("write_desa at p = 4 differs from p = 1")
        r = timed(f"read_desa 2^{log2n} p=4",
                  lambda: desa_mod.read_desa(text, prefix, mesh=mesh))
        if not np.array_equal(r.bulk_locate(ref["batches"][20]),
                              ref["answers"][20]):
            raise AssertionError("read_desa(mesh=) answers differ from p = 1")
    finally:
        for ext in (".sa64", ".lcp64", ".lc64", ".alpha"):
            if os.path.exists(prefix + ext):
                os.remove(prefix + ext)
    log("[mesh] write_desa at p = 4 == p = 1 byte for byte; read_desa(mesh=) "
        f"of the files answers as p = 1 on {card}")


def walk_rows(field: str, levels, start, ans) -> int:
    """The distinct level rows that K8 reads for one walk call, derived
    from its answers: the ascent reads the row of the own position's
    ancestor at each level up to the first row that holds the answer
    (every level on a miss), the descent the rows of the answer's
    ancestors below that level.  Each row is counted once per call."""
    import torch

    s = levels[0].numel()
    st = start.to(torch.int64)
    if field == "walk_next_leq":
        live = st < s
        own, hit = st.clamp(min=0), ans < s
    else:
        live = st > 0
        own, hit = st - 1, ans >= 0
    own, a, hit = own[live], ans[live], hit[live]
    L = len(levels)
    K = torch.full_like(own, L)  # the level the ascent stops at
    for k in reversed(range(L)):
        sh = 7 * (k + 1)
        K = torch.where(hit & ((a >> sh) == (own >> sh)), k, K)
    rows = 0
    for k, lv in enumerate(levels):
        sh = 7 * (k + 1)
        up = (own[K >= k] >> sh).clamp(0, lv.shape[0] - 1)
        down = a[hit & (K > k)] >> sh
        rows += torch.unique(torch.cat([up, down])).numel()
    return rows


def walk_bound(calls, answers) -> dict:
    """K8's bound over walk calls ``(field, levels, start, v, strict)`` and
    their answers: per call each query's start (8 B), value and answer
    (8 B) once and each level row that the call's walks read
    (``walk_rows``) once; one comparison a query."""
    nbytes = ops = 0
    for (field, levels, start, v, _), ans in zip(calls, answers):
        q = start.shape[0]
        row_bytes = levels[0].shape[1] * levels[0].element_size()
        nbytes += q * (16 + v.element_size()) + row_bytes * walk_rows(
            field, levels, start, ans)
        ops += q
    return bound(nbytes, ops)


def k8_held(calls, label: str, card: str) -> dict:
    """K8 against its plain version on walk calls (answers exactly equal),
    both timed on the calls' card: the kernel a mean over 10 runs, the
    plain version one run.  These launches are not counted."""
    from psac_tpu_torch.parallel.ansv import KERNELS, PLAIN

    def run(table):
        return [getattr(table, f)(lv, st, v, sr)
                for f, lv, st, v, sr in calls]

    got = run(KERNELS)
    err = max_abs_err(tuple(got), tuple(run(PLAIN)))
    dev = calls[0][2].device
    res = dict(calls=len(calls), queries=sum(c[2].shape[0] for c in calls),
               rows=calls[0][1][0].numel(), dtype=str(calls[0][3].dtype),
               max_abs_err=err, ms=cuda_ms(lambda: run(KERNELS), 10, dev),
               plain_ms=cuda_ms(lambda: run(PLAIN), 1, dev),
               **walk_bound(calls, got))
    log(f"[kernel] K8 walks == plain on {label} ({res['calls']} calls, "
        f"{res['queries']} queries over {res['rows']} {res['dtype']} rows): "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.6f} ms ({res['bound_by']}) on {card}")
    return res


def mesh_phase(dev, text: bytes, sa_ref, lcp_ref, tree_p1, rep_text: bytes,
               rsa, rlcp, log2n: int, rep_log2n: int, ansv_log2n: int,
               gsa_sets: dict, desa_ref: dict, card: str,
               kern: dict) -> dict:
    """The mesh of p = 4 shards on the card(s), ``devices[i] = cuda:(i %
    count)``: SA+LCP of the 2^26 random DNA and of the 2^24 ``rep_dna``
    (fused, and the host-driven loop with its routed resolve and capacity
    escalation) against their native references, the 2^26 suffix tree
    against the p = 1 tree, SA+LCP at p = 3 (the odd-even sort) on 2^20
    random DNA against the native oracle, ``d_check_sa`` at p = 4 (true,
    and false with two rows swapped), the DESA of the 2^26 text
    (``mesh_desa``, against the p = 1 index's answers and files in
    ``desa_ref``), the public ``ansv`` at p = 4 against p = 1 (on the int32
    values and on 2^20 int64 values), and the GSA + GLCP and the GST of
    each string set of
    ``gsa_sets`` (label -> (strings, the p = 1 (GSA, GLCP), the p = 1 GST
    table, whether K6's min-only entry is checked there)) against the p = 1
    results, with, on the checked set, ``build_gsa_from_file`` of the set
    written as lines against the in-memory build.  Each build's wall, peak
    memory and its launches of K6's min-only entry, K5, K6 and K8 (counted
    into the kernel table); K6's min-only entry held against its plain
    version on the largest call of the rep_dna build and of the checked
    GSA build and on small adversaries, K5 on one shard's suffix tree
    input, K8 on one shard's three full-width walks of the 2^26 tree, on
    its largest routed walk and on the int64 ANSV's largest walk; the
    walks' time in each tree's and ANSV's run, K8 against the plain
    version (their calls replayed one by one with CUDA events)."""
    import threading
    from unittest import mock

    import torch

    from psac_tpu_torch import native
    from psac_tpu_torch.config import SAConfig
    from psac_tpu_torch.models import gsa as gsa_mod
    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.models import suffix_tree as st_mod
    from psac_tpu_torch.ops import kmer as kmer_mod
    from psac_tpu_torch.ops import rmq as rmq_mod
    from psac_tpu_torch.ops import walk as walk_mod
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM
    from psac_tpu_torch.ops.bansv import block_psv, block_psv_plain
    from psac_tpu_torch.parallel import ansv as ansv_mod
    from psac_tpu_torch.parallel import par_rmq
    from psac_tpu_torch.parallel import route as route_mod
    from psac_tpu_torch.parallel.mesh import Sharded, make_mesh
    from psac_tpu_torch.tools.k8_sweep import held_calls, recorded
    from psac_tpu_torch.verify.cases import resolve_lcp
    from psac_tpu_torch.verify.check_sa import d_check_sa

    count = torch.cuda.device_count()
    devices = [f"cuda:{i % count}" for i in range(4)]
    cards = sorted(set(devices))
    log(f"[mesh] p = 4 shards on {devices} ({count} card(s)); {card}")
    mesh = make_mesh(4, devices)
    reset, read = counter((rmq_mod.rmq_mins, block_psv, rmq_mod.rmq_resolve,
                           walk_mod.levels_prev_lt,
                           walk_mod.levels_next_leq, kmer_mod.kmer_pack,
                           kmer_mod.kmer_heads, route_mod._bucket_by_dest))
    out = {}

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def timed(label, fn):
        gc.collect()
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        reset()
        t0 = time.perf_counter()
        res = fn()
        sync()
        st = dict(wall_s=time.perf_counter() - t0, peak_gib=sum(
            torch.cuda.max_memory_allocated(d) for d in cards) / 2**30,
            **read())
        add_launches({k: st[k] for k in ("rmq_mins", "block_psv",
                                         "rmq_resolve", "walks", "kmer_pack",
                                         "kmer_heads", "route_bucket")})
        out[label] = st
        log(f"[mesh] {label}: {st['wall_s']:.3f} s, peak "
            f"{st['peak_gib']:.2f} GiB, launches K6-mins {st['rmq_mins']}, "
            f"K5 {st['block_psv']}, K6 {st['rmq_resolve']}, K8 "
            f"{st['walks']}, K9 {st['kmer_pack']}, K10 {st['kmer_heads']}, "
            f"K12 {st['route_bucket']}")
        return res

    def build(t, cfg=None, m=mesh):
        xs, alpha, n, N = sa_mod.encode_and_shard(t, mesh=m)
        return sa_mod.construct_device(xs, alpha, n, N, cfg or SAConfig(),
                                       m), xs

    # ---- SA+LCP and ST of the 2^26 random DNA at p = 4
    dsa, xs = timed(f"SA+LCP 2^{log2n} DNA p=4", lambda: build(text))
    lb = dict(sa_mod.LAST_BUILD.d)
    res = dsa.materialize()
    if not (np.array_equal(res.sa, sa_ref)
            and np.array_equal(res.lcp, lcp_ref)):
        raise AssertionError("p = 4 SA+LCP of the random DNA differs from "
                             "SA-IS + Kasai")
    del res
    log(f"[mesh] SA+LCP 2^{log2n} DNA p=4 == native (fused {lb['fused']}, "
        f"host_iters {lb['host_iters']})")
    tree = timed(f"ST 2^{log2n} DNA p=4",
                 lambda: st_mod.construct_suffix_tree_device(dsa, xs))
    w = tree.sigma + 1
    got = tree.nodes.gather().view(dsa.N, w)[dsa.N - dsa.n:]
    want = tree_p1.view(-1, w)[-dsa.n:]
    if not torch.equal(got, want):
        raise AssertionError("p = 4 suffix tree differs from the p = 1 tree")
    del tree, got, want
    log(f"[mesh] ST 2^{log2n} DNA p=4 == p = 1 tree")
    if out[f"ST 2^{log2n} DNA p=4"]["walks"] == 0:
        raise AssertionError("K8 was not launched by the p = 4 suffix tree")

    def walks(label, fn, plain=False):
        """The walks' time inside ``fn()``: a second run with the walk calls
        noted (``KERNELS``' walk fields swapped for spies), then replayed
        one by one on K8, and with ``plain`` on the plain versions too (one
        card's stream is shared by the shards, so events around a call in
        the run would time the other shards' work too).  Returns the calls,
        ``(field, levels, start, v, strict)``."""
        calls = recorded(fn)
        for d in cards:
            torch.cuda.synchronize(d)
        n_walk = sum(c[2].shape[0] for c in calls)
        # each shard's calls timed on its own card's stream
        by_card = {}
        for c in calls:
            by_card.setdefault(c[3].device, []).append(c)

        def replay(table, cs):
            return [getattr(table, f)(lv, st, v, sr)
                    for f, lv, st, v, sr in cs]

        def total(table):
            return sum(cuda_ms(lambda cs=cs: replay(table, cs), 1, d)
                       for d, cs in by_card.items())

        st = out[label]
        st.update(walk_ms=total(ansv_mod.KERNELS), walk_queries=n_walk,
                  walk_calls=len(calls))
        if plain:
            st["walk_plain_ms"] = total(ansv_mod.PLAIN)
        log(f"[mesh] walks in {label}: {len(calls)} calls, {n_walk} "
            f"queries, {st['walk_ms']:.3f} ms on K8"
            + (f", {st['walk_plain_ms']:.3f} ms plain" if plain else "")
            + f", replayed on {card}")
        return calls

    calls = walks(f"ST 2^{log2n} DNA p=4",
                  lambda: st_mod.construct_suffix_tree_device(dsa, xs),
                  plain=True)
    # K8 on one shard's three full-width walks and on the largest routed
    # walk
    full, routed = held_calls(calls)
    k8 = k8_held(full, f"one shard's full-width walks of the p = 4 tree of "
                 f"2^{log2n} DNA", card)
    k8["routed"] = k8_held([routed], "the p = 4 tree's largest routed walk",
                           card)
    kern["walks"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/walk.cu",
        replaces="psac_tpu/ops/walk.py:84", **k8)
    del calls, full, routed

    # K5 at the shape each shard gives it: shard 1's suffix tree input
    lcp1 = dsa.lcp.shards[1]
    errs5 = [max_abs_err((block_psv(lcp1, strict),),
                         (block_psv_plain(lcp1, strict),))
             for strict in (True, False)]
    if max(errs5):
        raise AssertionError("K5 differs from its plain version on a mesh "
                             "shard")
    log(f"[mesh] K5 == plain on shard 1's LCP ({lcp1.shape[0]} rows)")

    # d_check_sa at p = 4: true, and false with two real rows swapped
    ok = timed(f"d_check_sa 2^{log2n} p=4", lambda: d_check_sa(dsa, xs))
    shards = [t.clone() for t in dsa.sa.shards]
    a, b = shards[-1][-1].item(), shards[-1][-7].item()
    shards[-1][-1], shards[-1][-7] = b, a
    bad = d_check_sa(dataclasses.replace(dsa, sa=Sharded(shards)), xs)
    if not ok or bad:
        raise AssertionError(f"d_check_sa at p = 4: {ok} for the build, "
                             f"{bad} with two rows swapped")
    log("[mesh] d_check_sa p=4: True for the build, False with two rows "
        "swapped")
    del dsa, xs, shards

    # ---- the DESA of the 2^26 text at p = 4
    mesh_desa(mesh, timed, sync, text, desa_ref, log2n, card, kern, out)

    # ---- rep_dna at p = 4: fused, then the host loop (routed resolve)
    real_mins = par_rmq.rmq_mins

    def largest_mins(build):
        """The K6-mins call with the most valid queries in ``build()`` (an
        untimed build: the spy reads each call's query count back)."""
        calls, lock = [], threading.Lock()

        def spy(rmq, lo, hi, valid):
            nv = int(valid.sum())
            with lock:
                if not calls or nv > calls[0][0]:
                    calls[:] = [(nv, rmq, lo, hi, valid)]
            return real_mins(rmq, lo, hi, valid)

        with mock.patch.object(par_rmq, "rmq_mins", spy):
            build()
        return calls[0][1:]

    rdsa, _ = timed(f"SA+LCP 2^{rep_log2n} rep_dna p=4",
                    lambda: build(rep_text))
    res = rdsa.materialize()
    if not (np.array_equal(res.sa, rsa) and np.array_equal(res.lcp, rlcp)):
        raise AssertionError("p = 4 SA+LCP of rep_dna differs")
    if out[f"SA+LCP 2^{rep_log2n} rep_dna p=4"]["rmq_mins"] == 0:
        raise AssertionError("K6's min-only entry was not launched by the "
                             "p = 4 rep_dna build")
    del rdsa, res
    # K6-mins' calls noted in a second, untimed build
    rmq, lo, hi, valid = largest_mins(lambda: build(rep_text))
    retries = []
    real_run = sa_mod._Builder._resolve_run

    def run_spy(self, ctx, lcp, kq, lq, rq, d, capscale):
        got = real_run(self, ctx, lcp, kq, lq, rq, d, capscale)
        if ctx.rank == 0:
            retries.append((capscale, got[1].value))
        return got

    with mock.patch.object(sa_mod._Builder, "_resolve_run", run_spy):
        hdsa, _ = timed(f"SA+LCP 2^{rep_log2n} rep_dna p=4 fused=False",
                        lambda: build(rep_text, SAConfig(fused=False)))
    res = hdsa.materialize()
    if not (np.array_equal(res.sa, rsa) and np.array_equal(res.lcp, rlcp)):
        raise AssertionError("p = 4 host-loop SA+LCP of rep_dna differs")
    escalated = sum(1 for c, o in retries if c == 6 and o > 0)
    out["resolves"] = dict(calls=len(retries), escalated=escalated,
                           host_iters=sa_mod.LAST_BUILD["host_iters"])
    log(f"[mesh] rep_dna p=4 == native, fused and host loop (host_iters "
        f"{sa_mod.LAST_BUILD['host_iters']}, routed resolves "
        f"{len(retries)}, escalated to cap = m {escalated} times)")
    del hdsa, res

    # ---- K6's min-only entry against its plain version
    # the call came from a shard's thread: its tensors may lie on another
    # card than the current one, whose stream the timings must use
    mdev = lo.device
    errs = [max_abs_err((rmq_mod.rmq_mins(rmq, lo, hi, valid),),
                        (rmq_mod.rmq_mins_plain(rmq, lo, hi, valid),))]
    rng = np.random.RandomState(31)
    for s_, dt in ((8 * 37, torch.int32), (128 * 257, torch.int64),
                   (1 << 20, torch.int32), (1 << 20, torch.int64)):
        x = torch.from_numpy(resolve_lcp(s_, seed=s_)).to(dev).to(dt)
        r = rmq_mod.build_local_rmq(x)
        m = 1 << 14
        qlo = rng.randint(0, s_, m)
        qhi = np.minimum(s_ - 1, qlo + rng.choice(
            [0, 3, 7, 8, r.block + 1, 9 * r.block, s_], m))
        qv = torch.from_numpy(rng.rand(m) < 0.9).to(dev)
        ql, qh = (torch.from_numpy(a).to(dev).to(dt) for a in (qlo, qhi))
        errs.append(max_abs_err((rmq_mod.rmq_mins(r, ql, qh, qv),),
                                (rmq_mod.rmq_mins_plain(r, ql, qh, qv),)))
    mb = mins_bound(rmq, lo, hi, valid)
    kern["rmq_mins"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/rmq_resolve.cu",
        replaces="psac_tpu/parallel/par_rmq.py:64", max_abs_err=max(errs),
        # the launch alone: the wrapper's check for a valid query reads
        # back, which would time the host round trip, not the kernel
        ms=cuda_ms(lambda: rmq_mod.rmq_mins_launch(rmq, lo, hi, valid,
                                                   torch.empty_like(lo)), 10,
                   mdev),
        plain_ms=cuda_ms(lambda: rmq_mod.rmq_mins_plain(rmq, lo, hi, valid),
                         1, mdev),
        bound_ms=mb["bound_ms"], bound_by=mb["bound_by"], library_ms=None,
        shape=dict(rows=rmq.x.shape[0], m=lo.shape[0], valid=mb["n_valid"],
                   narrow=mb["n_narrow"], block=rmq.block,
                   dtype=str(rmq.x.dtype)))
    k = kern["rmq_mins"]
    log(f"[kernel] K6-mins rmq_mins == plain on the p=4 rep_dna build's call "
        f"with the most valid queries"
        f" ({lo.shape[0]} queries, {mb['n_valid']} valid, "
        f"{mb['n_narrow']} under 8 wide, of {rmq.x.shape[0]} rows) and on "
        f"4 adversarial sets: {k['ms']:.4f} ms, plain {k['plain_ms']:.3f} "
        f"ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}) on {card}")
    del rmq, lo, hi, valid

    # ---- p = 3 (odd-even block sort) on 2^20 random DNA
    small = rand_dna(1 << 20, seed=20)
    ssa = native.suffix_array(small)
    mesh3 = make_mesh(3, [f"cuda:{i % count}" for i in range(3)])
    d3, _ = timed("SA+LCP 2^20 DNA p=3", lambda: build(small, m=mesh3))
    r3 = d3.materialize()
    if not (np.array_equal(r3.sa, ssa) and
            np.array_equal(r3.lcp, native.lcp_array(small, ssa))):
        raise AssertionError("p = 3 SA+LCP differs from SA-IS + Kasai")
    mesh3.close()
    log("[mesh] SA+LCP 2^20 DNA p=3 == native")

    # ---- the public ANSV at p = 4 against p = 1
    vals = ansv_values(ansv_log2n)
    for lt, rt, name in ((NEAREST_SM, NEAREST_SM, "NSM,NSM"),
                         (FURTHEST_EQ, NEAREST_SM, "FEQ,NSM"),
                         (NEAREST_EQ, NEAREST_EQ, "NEQ,NEQ")):
        label = f"ansv 2^{ansv_log2n} {name} p=4"
        got = timed(label, lambda: ansv_mod.ansv(vals, lt, rt, mesh=mesh))
        want = ansv_mod.ansv(vals, lt, rt, device=dev)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"p = 4 ansv {name} differs from p = 1")
        walks(label, lambda: ansv_mod.ansv(vals, lt, rt, mesh=mesh))
    if out[f"ansv 2^{ansv_log2n} FEQ,NSM p=4"]["walks"] == 0:
        raise AssertionError("K8 was not launched by the p = 4 ansv FEQ,NSM")
    log(f"[mesh] public ansv 2^{ansv_log2n} p=4 == p = 1 for NSM,NSM, "
        "FEQ,NSM and NEQ,NEQ")
    # int64 values (the public ANSV phase's wide input): K8's int64 walks
    wide = ansv_values(20).astype(np.int64) << 33
    label = "ansv 2^20 int64 FEQ,NSM p=4"
    got = timed(label, lambda: ansv_mod.ansv(wide, FURTHEST_EQ, NEAREST_SM,
                                             mesh=mesh))
    want = ansv_mod.ansv(wide, FURTHEST_EQ, NEAREST_SM, device=dev)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("p = 4 ansv of int64 values differs from p = 1")
    if out[label]["walks"] == 0:
        raise AssertionError("K8 was not launched by the p = 4 int64 ansv")
    calls = walks(label, lambda: ansv_mod.ansv(wide, FURTHEST_EQ, NEAREST_SM,
                                               mesh=mesh))
    k = kern["walks"]
    k["int64"] = k8_held([max(calls, key=lambda c: c[2].shape[0])],
                         "the p = 4 int64 ansv's largest walk", card)
    k["max_abs_err"] = max(k["max_abs_err"], k["routed"]["max_abs_err"],
                           k["int64"]["max_abs_err"])
    del calls
    log("[mesh] public ansv 2^20 int64 FEQ,NSM p=4 == p = 1")

    # ---- GSA + GLCP, GST and the file input at p = 4
    for label, (strings, (want_sa, want_lcp), gst_p1, check) in \
            gsa_sets.items():
        glabel, tlabel = f"GSA+GLCP {label} p=4", f"GST {label} p=4"
        dg = timed(glabel, lambda: gsa_mod.build_gsa_device(strings,
                                                            mesh=mesh))
        res = dg.materialize()
        if not (np.array_equal(res.sa, want_sa)
                and np.array_equal(res.lcp, want_lcp)):
            raise AssertionError(f"p = 4 GSA + GLCP of {label} differs from "
                                 "p = 1")
        del res
        if out[glabel]["rmq_mins"] == 0:
            raise AssertionError(f"K6's min-only entry was not launched by "
                                 f"the p = 4 GSA of {label}")
        tree = timed(tlabel, lambda: st_mod.construct_gst_device(dg))
        for k, name in (("block_psv", "K5"), ("walks", "K8")):
            if out[tlabel][k] == 0:
                raise AssertionError(f"{name} was not launched by the p = 4 "
                                     f"GST of {label}")
        if tree.N != gst_p1.shape[0] // (tree.sigma + 1) or \
                not torch.equal(tree.nodes.gather(), gst_p1):
            raise AssertionError(f"p = 4 GST of {label} differs from p = 1")
        if check:  # the [procs] phase's reference
            out["fam_shards"] = dict(
                n=dg.n, N=dg.N, sa=shard_digests(dg.sa),
                lcp=shard_digests(dg.lcp), nodes=shard_digests(tree.nodes))
        del tree
        walks(tlabel, lambda: st_mod.construct_gst_device(dg))
        log(f"[mesh] {label} p=4: GSA + GLCP == p = 1 (== host oracle), "
            f"GST == p = 1 (padded table) on {card}")
        if not check:
            del dg
            continue
        # K6's min-only entry on this build's largest call
        rmq, lo, hi, valid = largest_mins(
            lambda: gsa_mod.build_gsa_device(strings, mesh=mesh))
        mdev = lo.device
        err = max_abs_err((rmq_mod.rmq_mins(rmq, lo, hi, valid),),
                          (rmq_mod.rmq_mins_plain(rmq, lo, hi, valid),))
        k = kern["rmq_mins"]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        mb = mins_bound(rmq, lo, hi, valid)
        ms = cuda_ms(lambda: rmq_mod.rmq_mins_launch(
            rmq, lo, hi, valid, torch.empty_like(lo)), 10, mdev)
        plain_ms = cuda_ms(lambda: rmq_mod.rmq_mins_plain(rmq, lo, hi,
                                                          valid), 1, mdev)
        out[glabel]["mins_call"] = dict(ms=ms, plain_ms=plain_ms, err=err,
                                        **mb)
        if err:
            raise AssertionError(f"K6-mins differs from its plain version on "
                                 f"the p = 4 GSA of {label}")
        log(f"[kernel] K6-mins rmq_mins == plain on the p=4 GSA of {label}'s "
            f"call with the most valid queries ({lo.shape[0]} queries, "
            f"{mb['n_valid']} valid, {mb['n_narrow']} under 8 wide, of "
            f"{rmq.x.shape[0]} rows): {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {mb['bound_ms']:.5f} ms ({mb['bound_by']}) on {card}")
        del rmq, lo, hi, valid
        # the file input: the set written as lines, a trailing separator
        work = os.path.join(ROOT, "_smoke")
        os.makedirs(work, exist_ok=True)
        path = os.path.join(work, "strings.txt")
        try:
            with open(path, "wb") as f:
                f.write(b"\n".join(strings) + b"\n")
            fd = timed(f"GSA+GLCP {label} from file p=4",
                       lambda: gsa_mod.build_gsa_from_file(path, mesh=mesh))
        finally:
            os.remove(path)
        if not (np.array_equal(fd.lens, dg.lens) and all(
                torch.equal(getattr(fd, f).gather(), getattr(dg, f).gather())
                for f in ("sa", "lcp", "eos", "xs"))):
            raise AssertionError(f"p = 4 build_gsa_from_file of {label} "
                                 "differs from the in-memory build")
        log(f"[mesh] {label} p=4: build_gsa_from_file == the in-memory "
            "build (padded sa, lcp, eos, xs)")
        del fd, dg
    mesh.close()
    return out


def shard_digests(x) -> list:
    """SHA-256 of each local block of a ``Sharded`` array."""
    import hashlib

    return [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
            for t in x.shards]


PROCS_KERNELS = ("rmq_mins", "block_psv", "blind_search", "walks",
                 "kmer_pack", "kmer_heads", "route_bucket")


def procs_worker(rank: int, port: str, work: str, backend: str) -> int:
    """One process of the ``[procs]`` phase (``chip_smoke.py --procs-worker
    RANK PORT WORK BACKEND``): 2 shards of a global mesh of 4 spread over 2
    processes, on ``cuda:0`` under gloo (host-staged) or on this process's
    card under NCCL.  Builds from the files in ``work`` against the
    references there (``ref.json``), each step timed with its peak and its
    launches of K6-mins, K5, K7 and K8, and writes ``report.RANK.json``.  Any
    mismatch raises (the exit code is then non-zero)."""
    import torch

    sys.path.insert(0, ROOT)
    from psac_tpu_torch import io as io_mod
    from psac_tpu_torch.models import desa as desa_mod
    from psac_tpu_torch.models import gsa as gsa_mod
    from psac_tpu_torch.models import suffix_tree as st_mod
    from psac_tpu_torch.models.suffix_array import construct_from_file
    from psac_tpu_torch.ops import bansv, blind_search, kmer, rmq, walk
    from psac_tpu_torch.parallel import dist as pdist
    from psac_tpu_torch.parallel import route
    from psac_tpu_torch.parallel.mesh import Sharded, make_mesh
    from psac_tpu_torch.verify.check_sa import d_check_sa

    with open(os.path.join(work, "ref.json")) as f:
        ref = json.load(f)
    pdist.init_distributed(backend, rank=rank, world_size=2,
                           init_method=f"tcp://127.0.0.1:{port}",
                           timeout=600)
    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(dev)
    mesh = make_mesh(4, [dev] * 2)
    reset, read = counter((rmq.rmq_mins, bansv.block_psv,
                           blind_search.blind_search, walk.levels_prev_lt,
                           walk.levels_next_leq, kmer.kmer_pack,
                           kmer.kmer_heads, route._bucket_by_dest))
    report = dict(rank=rank, backend=backend, device=str(dev), steps={})

    def step(label, fn):
        pdist.barrier(label)
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        st = dict(wall_s=time.perf_counter() - t0,
                  peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                  **read())
        report["steps"][label] = st
        log(f"[procs] rank {rank} {backend}: {label} {st['wall_s']:.3f} s, "
            f"peak {st['peak_gib']:.2f} GiB, K6-mins {st['rmq_mins']}, K5 "
            f"{st['block_psv']}, K7 {st['blind_search']}, K8 "
            f"{st['walks']}, K9 {st['kmer_pack']}, K10 {st['kmer_heads']}, "
            f"K12 {st['route_bucket']}")
        return res

    def same_files(prefix, want, exts):
        pdist.barrier(prefix)
        if rank == 0 and file_digests(prefix, exts) != want:
            raise AssertionError(f"{prefix}: files differ from p = 1")

    text_path = os.path.join(work, "text.bin")
    dsa, xs = step("SA+LCP from file",
                   lambda: construct_from_file(text_path, mesh=mesh))
    if not step("d_check_sa", lambda: d_check_sa(dsa, xs)):
        raise AssertionError("d_check_sa failed on the process mesh")
    shards = [t.clone() for t in dsa.sa.shards]
    if dsa.sa.first == 2:  # two rows of the last shard swapped
        a, b = shards[-1][-1].item(), shards[-1][-7].item()
        shards[-1][-1], shards[-1][-7] = b, a
    if d_check_sa(dataclasses.replace(
            dsa, sa=Sharded(shards, dsa.sa.first, dsa.sa.p)), xs):
        raise AssertionError("d_check_sa passed with two rows swapped")
    del shards
    sa_exts = (".sa64", ".lcp64", ".alpha")
    pre = os.path.join(work, "sa4")
    step("write_suffix_array_distributed",
         lambda: io_mod.write_suffix_array_distributed(pre, dsa))
    same_files(pre, ref["sa_files"], sa_exts)
    back = step("read_suffix_array_distributed",
                lambda: io_mod.read_suffix_array_distributed(pre, mesh))
    off = dsa.N - dsa.n
    s = dsa.N // 4
    for r in range(2):
        g = torch.arange((dsa.sa.first + r) * s, (dsa.sa.first + r + 1) * s,
                         device=dev)
        real = g >= off
        lcp_want = torch.where(g == off, 0, dsa.lcp.shards[r])
        for got, want in ((back.sa.shards[r], dsa.sa.shards[r]),
                          (back.lcp.shards[r], lcp_want)):
            if not torch.equal(torch.where(real, want, 0).to(got.dtype),
                               got):
                raise AssertionError("the reloaded SA/LCP differ")
    del dsa, xs, back
    log(f"[procs] rank {rank}: d_check_sa True (False with two rows "
        "swapped); the distributed SA files == p = 1 (digests); the reload "
        "== the build")

    pats = [row.tobytes() for row in np.load(os.path.join(work, "pats.npy"))]
    want = np.load(os.path.join(work, "answers.npy"))
    idx = step("DESA tllt from file",
               lambda: desa_mod.build_desa_from_file(text_path, mesh=mesh))
    idx.bulk_locate(pats)  # warm-up at this shape
    got = step(f"bulk_locate {len(pats)} x len {len(pats[0])}",
               lambda: idx.bulk_locate(pats))
    if not np.array_equal(got, want):
        raise AssertionError("the process mesh's bulk_locate differs from "
                             "p = 1")
    dpre = os.path.join(work, "desa4")
    step("write_desa_distributed",
         lambda: desa_mod.write_desa_distributed(idx, dpre))
    same_files(dpre, ref["desa_files"], (".sa64", ".lcp64", ".lc64",
                                         ".alpha"))
    del idx
    idx = step("read_desa_from_file",
               lambda: desa_mod.read_desa_from_file(text_path, dpre,
                                                    mesh=mesh))
    if not np.array_equal(idx.bulk_locate(pats), want):
        raise AssertionError("the reloaded DESA answers differ from p = 1")
    del idx
    log(f"[procs] rank {rank}: bulk_locate == p = 1; the distributed DESA "
        "files == p = 1 (digests); the reload answers as p = 1")

    fam = ref["fam"]
    dg = step("GSA+GLCP family from file", lambda: gsa_mod.build_gsa_from_file(
        os.path.join(work, "fam.txt"), mesh=mesh))
    tree = step("GST family", lambda: st_mod.construct_gst_device(dg))
    first = dg.sa.first
    for key, x in (("sa", dg.sa), ("lcp", dg.lcp), ("nodes", tree.nodes)):
        if shard_digests(x) != fam[key][first:first + 2]:
            raise AssertionError(f"the process mesh's family {key} differs "
                                 "from the [mesh] p = 4 build")
    if (dg.n, dg.N) != (fam["n"], fam["N"]):
        raise AssertionError("the family's padded size differs")
    log(f"[procs] rank {rank}: family GSA + GLCP and GST == [mesh] p = 4 "
        "(shard digests)")
    with open(os.path.join(work, f"report.{rank}.json"), "w") as f:
        json.dump(report, f)
    pdist.barrier("end")
    pdist.shutdown()
    return 0


def procs_phase(text: bytes, sa_ref, lcp_ref, desa_ref: dict, fam_set: list,
                fam_ref: dict, card: str) -> dict:
    """The mesh across processes (``[procs]``): 2 processes of this script
    (``--procs-worker``), each holding 2 shards of a global mesh of 4, on
    ``cuda:0`` over gloo, host-staged (NCCL refuses two ranks on one card);
    under NCCL too, one card per process, where there are two cards.  The
    workers build SA+LCP of the text from its file (``d_check_sa``, the
    distributed files against the p = 1 files' digests, the reload), the
    DESA (TLLT) from the file answering the p = 1 length-20 batch as p = 1,
    its distributed files against ``write_desa``'s at p = 1, the reload,
    and GSA + GLCP and the GST of the family from its file against the
    ``[mesh]`` p = 4 shards.  Each reports its walls, peaks and launches;
    the launches join the kernel table's.  A failing worker fails the
    script."""
    import socket

    import torch

    from psac_tpu_torch import io as io_mod
    from psac_tpu_torch.models.suffix_array import SuffixArray
    from psac_tpu_torch.ops.alphabet import Alphabet

    work = os.path.join(ROOT, "_smoke", "procs")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(work, "text.bin"), "wb") as f:
        f.write(text)
    with open(os.path.join(work, "fam.txt"), "wb") as f:
        f.write(b"\n".join(fam_set) + b"\n")
    pats = desa_ref["batches"][20]
    np.save(os.path.join(work, "pats.npy"),
            np.frombuffer(b"".join(pats), np.uint8).reshape(len(pats), -1))
    np.save(os.path.join(work, "answers.npy"), desa_ref["answers"][20])
    pre = os.path.join(work, "sa1")
    io_mod.write_suffix_array(pre, SuffixArray(
        sa=sa_ref, lcp=lcp_ref, alphabet=Alphabet.from_bytes(text),
        n=len(text)))
    sa_exts = (".sa64", ".lcp64", ".alpha")
    ref = dict(sa_files=file_digests(pre, sa_exts),
               desa_files=desa_ref["files"], fam=fam_ref)
    for ext in sa_exts:
        os.remove(pre + ext)
    with open(os.path.join(work, "ref.json"), "w") as f:
        json.dump(ref, f)
    log(f"[procs] inputs and p = 1 references written: "
        f"{time.perf_counter() - t0:.1f} s (host)")

    backends = ["gloo"]
    if torch.cuda.device_count() >= 2:
        backends.append("nccl")
    # the workers share this process's card: give its cached blocks back
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    try:
        for backend in backends:
            log(f"[procs] {backend}: 2 processes x 2 shards, P = 4, "
                + ("on cuda:0, host-staged (NCCL refuses two ranks on one "
                   "card)" if backend == "gloo" else "one card each")
                + f"; {card}")
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = str(sk.getsockname()[1])
            env = dict(os.environ)
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--procs-worker",
                 str(r), port, work, backend], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
            try:
                outs = [p.communicate(timeout=900)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
            for r, (p, o) in enumerate(zip(procs, outs)):
                for line in o.splitlines():
                    if line.startswith("[procs]"):
                        log(line)
                if p.returncode != 0:
                    raise AssertionError(f"[procs] {backend} worker {r} "
                                         f"failed ({p.returncode}):\n"
                                         f"{o[-6000:]}")
            reports = []
            for r in range(2):
                with open(os.path.join(work, f"report.{r}.json")) as f:
                    reports.append(json.load(f))
                os.remove(os.path.join(work, f"report.{r}.json"))
            launched = {k: sum(st[k] for rep in reports
                               for st in rep["steps"].values())
                        for k in PROCS_KERNELS}
            add_launches(launched)
            for k, v in launched.items():
                if v == 0:
                    raise AssertionError(f"{k} was not launched in the "
                                         f"[procs] {backend} workers")
            out[backend] = dict(wall_s=wall, reports=reports,
                                launches=launched)
            log(f"[procs] {backend}: both processes == p = 1 / [mesh] p = 4; "
                f"launches {launched}; phase {wall:.1f} s on {card}")
    finally:
        for name in os.listdir(work):
            os.remove(os.path.join(work, name))
        os.rmdir(work)
    if len(backends) == 1:
        log("[procs] nccl: not run, 1 card")
    return out


def engines_phase(dev, log2n: int, card: str) -> None:
    """Each ANSV engine (``hybrid``, ``scan``, ``block``, ``spine``) on the
    card for every pair ``benchmark-ansv`` times and each of its inputs
    (and the public ANSV phase's values), at 2^log2n: every answer equals
    the plain path's (the kernels' plain versions), and each call launches
    the kernels its engine names.  Comparisons only: these launches are not
    counted."""
    import torch

    from psac_tpu_torch.cli import ansv_inputs
    from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM
    from psac_tpu_torch.ops.bansv import block_psv
    from psac_tpu_torch.ops.nsv_scan import (nsv_scan_dual, nsv_scan_left,
                                             nsv_scan_spine)
    from psac_tpu_torch.ops.tansv import tile_side
    from psac_tpu_torch.parallel.ansv import KERNELS, PLAIN, _ansv

    reset, read = counter((tile_side, nsv_scan_spine, nsv_scan_dual,
                           nsv_scan_left, block_psv))
    combos = {"sm-sm": (NEAREST_SM, NEAREST_SM),
              "feq-sm": (FURTHEST_EQ, NEAREST_SM),
              "eq-eq": (NEAREST_EQ, NEAREST_EQ)}
    inputs = dict(ansv_values=ansv_values(log2n),
                  **ansv_inputs(1 << log2n, 0))
    ran = {}
    for iname, a in inputs.items():
        x = torch.from_numpy(a).to(dev)
        for cname, (lt, rt) in combos.items():
            want = _ansv(x, lt, rt, PLAIN, x.dtype, "scan")
            for eng in ("hybrid", "scan", "block", "spine"):
                if eng == "spine" and cname != "feq-sm":
                    continue
                reset()
                got = _ansv(x, lt, rt, KERNELS, x.dtype, eng)
                counts = {k: v for k, v in read().items() if v}
                max_abs_err(got, want)
                expect = {"tile_side": 2, "nsv_scan_spine": 1} \
                    if eng == "spine" else {"nsv_scan_dual": 1} \
                    if eng == "scan" or (eng, cname) == ("hybrid", "feq-sm") \
                    else {"block_psv": 2}
                if counts != expect:
                    raise AssertionError(f"{eng} {iname} {cname} launched "
                                         f"{counts}")
                ran[eng, iname, cname] = ",".join(
                    f"{k} {v}" for k, v in counts.items())
    log(f"[engines-ansv] every engine == plain path on 2^{log2n} "
        f"{', '.join(inputs)} for {', '.join(combos)}; on {card}")
    for eng in ("hybrid", "scan", "block", "spine"):
        log(f"[engines-ansv] {eng}: " + "; ".join(
            f"{i} {c}: {v}" for (e, i, c), v in ran.items() if e == eng))


def run_cli(args: list, label: str):
    """``python -m psac_tpu_torch.cli`` with ``args`` and no ``--device``
    (the card is the default) in a process of its own; logs its stderr and
    stdout lines and returns the finished process.  A non-zero exit raises;
    the process is killed at its time limit."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "psac_tpu_torch.cli"] + args, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    log(f"[cli] {label}: {dt:.2f} s of process wall; "
        + (" | ".join(proc.stderr.strip().splitlines()) or "no stderr")
        + (" | stdout: " + " | ".join(proc.stdout.strip().splitlines())
           if proc.stdout.strip() else ""))
    return proc


def cli_phase(text: bytes, sa_ref: np.ndarray, lcp_ref: np.ndarray,
              gsa_strings: list, gsa_oracle: tuple, batch: int,
              ansv_log2n: int, bench_reps: int, card: str) -> dict:
    """The command-line tools at full size, each in a process of its own
    with no device given, their outputs held against the oracles the
    script already has: ``psac -f -l -o`` of the text (read back == native
    SA + LCP) and ``psac -f -t``; ``gsac -f -o`` of the string set written
    as lines (== the GSA phase's oracle); ``mkpattern`` of ``batch``
    length-20 patterns, ``desa -q --reps 3`` with each top-level index
    (saving the index), then ``--load``, then ``--devices 4 --device
    cuda:0`` (matched counts, and the saved index's ranges loaded in this
    process, == the native SA's).  Also
    ``d_check_sa`` on the file build: true, and false with two SA rows
    swapped; then ``benchmark -f --reps bench_reps`` of the text and
    ``benchmark-ansv -n 2^ansv_log2n --reps 1`` (all four engines), whose
    rows must be the JAX CLI's (p = 1).  The files live in ``_smoke/`` of
    the checkout, removed at the end."""
    import re
    import shutil

    import torch

    from psac_tpu_torch.io import read_u64
    from psac_tpu_torch.models.desa import read_desa_from_file
    from psac_tpu_torch.models.suffix_array import construct_from_file
    from psac_tpu_torch.verify.check_sa import d_check_sa

    out = {}
    n = len(text)
    work = os.path.join(ROOT, "_smoke")
    os.makedirs(work, exist_ok=True)
    torch.cuda.empty_cache()
    try:
        tpath = os.path.join(work, "text.txt")
        with open(tpath, "wb") as f:
            f.write(text)
        pre = os.path.join(work, "sa")
        run_cli(["psac", "-f", tpath, "-l", "-o", pre], "psac -f -l -o")
        if not (np.array_equal(read_u64(pre + ".sa64"), sa_ref)
                and np.array_equal(read_u64(pre + ".lcp64"), lcp_ref)):
            raise AssertionError("psac -f -l -o wrote another SA or LCP")
        with open(pre + ".alpha", "rb") as f:
            if f.read() != b"ACGT":
                raise AssertionError("psac -f -l -o wrote another alphabet")
        for ext in (".sa64", ".lcp64", ".alpha"):
            os.remove(pre + ext)
        log("[cli] psac -f -l -o: .sa64 / .lcp64 == native SA-IS + Kasai")
        err = run_cli(["psac", "-f", tpath, "-t"], "psac -f -t").stderr
        if f"({n} nodes x 5 slots)" not in err:
            raise AssertionError("psac -f -t printed no tree of the text")

        # the check that needs no host oracle, on the file build
        dsa, xs = construct_from_file(tpath)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = d_check_sa(dsa, xs)
        out["d_check_sa_s"] = time.perf_counter() - t0
        off = dsa.N - dsa.n
        sa = dsa.sa.clone()
        sa[off + 7], sa[off + 8] = dsa.sa[off + 8], dsa.sa[off + 7]
        bad = d_check_sa(dataclasses.replace(dsa, sa=sa), xs)
        if not ok or bad:
            raise AssertionError(f"d_check_sa gave {ok} on the file build "
                                 f"and {bad} with two rows swapped")
        log(f"[cli] d_check_sa of construct_from_file (2^"
            f"{n.bit_length() - 1}): True in {out['d_check_sa_s']:.3f} s; "
            f"False with two SA rows swapped; on {card}")
        del dsa, xs, sa
        torch.cuda.empty_cache()

        gpath = os.path.join(work, "set.txt")
        with open(gpath, "wb") as f:
            f.write(b"\n".join(gsa_strings) + b"\n")
        gpre = os.path.join(work, "g")
        run_cli(["gsac", "-f", gpath, "-o", gpre], "gsac -f -o")
        if not (np.array_equal(read_u64(gpre + ".gsa64"), gsa_oracle[0])
                and np.array_equal(read_u64(gpre + ".glcp64"),
                                   gsa_oracle[1])):
            raise AssertionError("gsac -f -o differs from the host oracle")
        for f in (gpath, gpre + ".gsa64", gpre + ".glcp64"):
            os.remove(f)
        log(f"[cli] gsac -f -o of {len(gsa_strings)} lines: .gsa64 / "
            ".glcp64 == host oracle")

        ppath = os.path.join(work, "patterns.txt")
        run_cli(["mkpattern", "-f", tpath, "-n", str(batch), "-l", "20",
                 "-o", ppath], "mkpattern")
        with open(ppath, "rb") as f:
            pats = [x for x in f.read().split(b"\n") if x]
        mat = np.frombuffer(b"".join(pats), np.uint8).reshape(len(pats), 20)
        tpad = np.concatenate([np.frombuffer(text, np.uint8),
                               np.zeros(20, np.uint8)])
        lo = sa_bounds(tpad, sa_ref, mat, False)
        hi = sa_bounds(tpad, sa_ref, mat, True)
        found = int((hi > lo).sum())
        ipre = os.path.join(work, "idx")
        matched = re.compile(r"bulk_locate: (\d+) patterns, (\d+) matched, "
                             r"([0-9.]+) ms/rep")
        for label, extra in (("tllt", ["--tli", "tllt", "-o", ipre]),
                             ("tldt", ["--tli", "tldt"]),
                             ("load", ["--load", ipre]),
                             ("mesh", ["--devices", "4", "--device",
                                       "cuda:0"])):
            err = run_cli(["desa", "-f", tpath, "-q", ppath, "--reps", "3"]
                          + extra, f"desa -q {' '.join(extra)}").stderr
            m = matched.search(err)
            if not m or int(m.group(1)) != len(pats) or \
                    int(m.group(2)) != found:
                raise AssertionError(f"desa {label}: matched counts differ "
                                     f"from the native SA's {found}")
            out[f"desa_{label}_ms"] = float(m.group(3))
            out[f"desa_{label}_qps"] = len(pats) / float(m.group(3)) * 1e3
        for tli in ("tllt", "tldt"):
            got = read_desa_from_file(tpath, ipre, tli=tli).bulk_locate(pats)
            if not (np.array_equal(got[:, 0], lo)
                    and np.array_equal(got[:, 1], hi)):
                raise AssertionError(f"the saved index ({tli}) gives other "
                                     "ranges than the native SA")
        log(f"[cli] desa: {found} of {len(pats)} patterns matched in every "
            "run; the saved index read back with each top-level index "
            f"answers every range == the native SA; on {card}")

        rows = [r.split(";") for r in run_cli(
            ["benchmark", "-f", tpath, "--reps", str(bench_reps)],
            f"benchmark --reps {bench_reps}").stdout.split()]
        names = ["sa-nolcp-reg", "sa-nolcp-fast", "sa-lcp-reg",
                 "sa-lcp-fast", "sa-nolcp-arr3", "sa-nolcp-arr4"]
        if [r[:2] for r in rows] != [["1", k] for k in names]:
            raise AssertionError(f"benchmark printed {rows}")
        out["benchmark_ms"] = {r[1]: float(r[2]) for r in rows}
        m = 1 << ansv_log2n
        rows = [r.split(";") for r in run_cli(
            ["benchmark-ansv", "-n", str(m), "--reps", "1"],
            "benchmark-ansv --reps 1").stdout.split()]
        want = [[str(m), "1", e, i, c]
                for e in ("hybrid", "scan", "block", "spine")
                for i in ("uniform", "peaks", "bitonic")
                for c in ("sm-sm", "feq-sm", "eq-eq")
                if e != "spine" or c == "feq-sm"]
        if [r[:5] for r in rows] != want:
            raise AssertionError(f"benchmark-ansv printed {rows}")
        out["benchmark_ansv_ms"] = {";".join(r[2:5]): float(r[5])
                                    for r in rows}
        log(f"[cli] benchmark and benchmark-ansv printed the JAX CLI's rows "
            f"with p = 1; on {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=26,
                    help="random DNA corpus size (log2 chars)")
    ap.add_argument("--rep-log2n", type=int, default=24,
                    help="repetitive DNA corpus size (log2 chars)")
    ap.add_argument("--ansv-log2n", type=int, default=24,
                    help="public ANSV input size (log2 values)")
    ap.add_argument("--batch", type=int, default=65536,
                    help="DESA patterns per bulk_locate batch")
    ap.add_argument("--gsa-log2n", type=int, default=26,
                    help="random string set size (log2 chars, 4 KiB strings)")
    ap.add_argument("--fam-log2n", type=int, default=24,
                    help="near-identical family size (log2 chars, 64 strings)")
    ap.add_argument("--bench-reps", type=int, default=3,
                    help="--reps of the CLI phase's benchmark run")
    ap.add_argument("--procs-worker", nargs=4, help=argparse.SUPPRESS,
                    metavar=("RANK", "PORT", "WORK", "BACKEND"))
    args = ap.parse_args()

    # ---- 1. device ------------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.procs_worker:
        rank, port, work, backend = args.procs_worker
        return procs_worker(int(rank), port, work, backend)
    sys.path.insert(0, ROOT)
    import psac_tpu_torch  # noqa: F401  (fails outside a checkout)
    from psac_tpu_torch import native
    from psac_tpu_torch.models.suffix_array import (build_suffix_array,
                                                    construct_device,
                                                    encode_and_shard)
    from psac_tpu_torch.models.suffix_tree import (
        _st_local, build_suffix_tree, construct_suffix_tree_device)
    from psac_tpu_torch.ops import cuda_lib
    from psac_tpu_torch.ops.alphabet import Alphabet, rand_dna, rep_dna
    from psac_tpu_torch.ops.kmer import kmer_heads, kmer_pack
    from psac_tpu_torch.verify.cases import near_identical_family
    from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                         ansv_seq)
    from psac_tpu_torch.ops.nsv_scan import (nsv_scan_dual,
                                             nsv_scan_dual_plain,
                                             nsv_scan_spine)
    from psac_tpu_torch.ops.rmq import rmq_resolve
    from psac_tpu_torch.ops.tansv import tile_side
    from psac_tpu_torch.parallel.ansv import PLAIN, ansv_local
    from psac_tpu_torch.verify.suffix_tree_oracle import suffix_tree_oracle

    dev = torch.device("cuda", 0)
    card = smi_name_power()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"| nvidia-smi: {card}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = cuda_lib.build()
    cuda_lib.lib()
    native.build()
    log(f"[build] nvcc {nvcc_s:.1f} s, total {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.BUILD_LOG.splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")

    # ---- corpora and the native oracle (host) ---------------------------
    n = 1 << args.log2n
    text = rand_dna(n, seed=42)
    t0 = time.perf_counter()
    sa_ref = native.suffix_array(text)
    lcp_ref = native.lcp_array(text, sa_ref)
    log(f"[oracle] native SA-IS+Kasai of 2^{args.log2n} DNA: "
        f"{time.perf_counter() - t0:.2f} s (host)")
    rep_n = 1 << args.rep_log2n
    rep_text = rep_dna(rep_n)
    rsa = native.suffix_array(rep_text)
    rlcp = native.lcp_array(rep_text, rsa)

    # ---- 3. kernels against their plain versions on the card ------------
    kern = {}

    def padded_lcp(lcp):
        """A host LCP array as the ANSV's spine engine takes it: int32 on
        the card, padded at the end with INT32_MAX to a multiple of
        2048."""
        return pad_chunk(torch.from_numpy(lcp.astype(np.int32)).to(dev))

    lcp_adj = padded_lcp(lcp_ref)
    S = lcp_adj.shape[0]
    check_k4_k1(dev, lcp_adj, args.log2n, kern)

    xr = lcp_adj.flip(0)
    errs = [max_abs_err(nsv_scan_dual(lcp_adj, xr, FURTHEST_EQ, NEAREST_SM),
                        nsv_scan_dual_plain(lcp_adj, xr, FURTHEST_EQ,
                                            NEAREST_SM))]
    small = lcp_adj[:1 << 20]
    for tl, tr in ((NEAREST_EQ, NEAREST_EQ), (NEAREST_SM, FURTHEST_EQ)):
        errs.append(max_abs_err(
            nsv_scan_dual(small, small.flip(0), tl, tr),
            nsv_scan_dual_plain(small, small.flip(0), tl, tr)))
    advs = scan_adversaries(dev)
    for x in advs.values():
        for tl, tr in ((FURTHEST_EQ, NEAREST_SM), (FURTHEST_EQ, FURTHEST_EQ),
                       (NEAREST_EQ, NEAREST_SM)):
            errs.append(max_abs_err(
                nsv_scan_dual(x, x.flip(0), tl, tr),
                nsv_scan_dual_plain(x, x.flip(0), tl, tr)))
    # the second stream is an input of its own, not x reversed
    other = lcp_adj[:1 << 20].roll(12345)
    errs.append(max_abs_err(
        nsv_scan_dual(small, other, FURTHEST_EQ, NEAREST_SM),
        nsv_scan_dual_plain(small, other, FURTHEST_EQ, NEAREST_SM)))
    kern["nsv_scan_dual"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/nsv_scan.cu",
        replaces="psac_tpu/ops/nsv_scan.py:358", max_abs_err=max(errs),
        ms=cuda_ms(lambda: nsv_scan_dual(lcp_adj, xr, FURTHEST_EQ,
                                         NEAREST_SM), 10),
        plain_ms=cuda_ms(lambda: nsv_scan_dual_plain(
            lcp_adj, xr, FURTHEST_EQ, NEAREST_SM), 1),
        **bound(24 * S + 4, 2 * S))
    log("[kernel] K2 nsv_scan_dual == plain for (FEQ, NSM) at full length, "
        "(NEQ, NEQ) and (NSM, FEQ) at 2^20, (FEQ, NSM), (FEQ, FEQ) and "
        f"(NEQ, NSM) on {len(advs)} adversaries ({', '.join(advs)}), and "
        "two unrelated streams")
    check_k3_k5(dev, lcp_adj, args.log2n, args.ansv_log2n, kern)
    check_k6(dev, rep_text, rlcp, args.rep_log2n, card, kern)
    whole = rand_dna(1 << args.gsa_log2n, seed=43)
    gsa_set = [whole[i:i + 4096] for i in range(0, len(whole), 4096)]
    del whole
    check_k9_k10(dev, text, gsa_set, card, kern)
    check_k12(dev, card, kern)
    label = f"2^{args.log2n} LCP"
    engines = {label: engine_comparison(lcp_adj, label, card)}
    del lcp_adj, xr, small, other, advs

    # ---- 4. main path (counted) ------------------------------------------
    reset_counts, read_counts = counter((tile_side, nsv_scan_spine,
                                         nsv_scan_dual, rmq_resolve,
                                         kmer_pack, kmer_heads))

    # SA+LCP and suffix tree of the 2^26 text: the tree's ANSV pass is one
    # K2 launch, and K4 and K1 (the spine engine's) do not run
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, alpha, n_, N = encode_and_shard(text, dev)
    dsa = construct_device(xs, alpha, n_, N)
    torch.cuda.synchronize()
    t_sa = time.perf_counter() - t0
    mem_sa = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = construct_suffix_tree_device(dsa, xs)
    torch.cuda.synchronize()
    t_st = time.perf_counter() - t0
    mem_st = torch.cuda.max_memory_allocated()
    main_counts = read_counts()
    add_launches(main_counts)
    log(f"[main] launches in SA+LCP+ST of 2^{args.log2n} DNA: {main_counts}")
    for k in ("kmer_pack", "kmer_heads"):
        if main_counts[k] == 0:
            raise AssertionError(f"{k} was not launched on the main path")
    tree_pass = ("nsv_scan_dual", "tile_side", "nsv_scan_spine")
    if tuple(main_counts[k] for k in tree_pass) != (1, 0, 0):
        raise AssertionError(f"the tree's ANSV pass launched {main_counts}")

    # the suffix tree of a homopolymer (its LCP rises in every tile: a
    # spine of every row), counted on its own, and that of the repetitive
    # text (phase 4b).  Both builds here take no device: the card is the
    # default.
    homo = b"A" * 4096
    reset_counts()
    homo_tree = build_suffix_tree(homo)
    homo_counts = read_counts()
    add_launches(homo_counts)
    log(f"[main] launches in build_suffix_tree(A^{len(homo)}): {homo_counts}")
    if tuple(homo_counts[k] for k in tree_pass) != (1, 0, 0):
        raise AssertionError("the homopolymer's ANSV pass was not one K2 "
                             "launch")

    # SA+LCP of the repetitive text: K6 in every dense and tail step
    reset_counts()
    t0 = time.perf_counter()
    rres = build_suffix_array(rep_text)
    t_rep = time.perf_counter() - t0
    rep_counts = read_counts()
    add_launches(rep_counts)
    if rep_counts["rmq_resolve"] == 0:
        raise AssertionError("K6 was not launched by the SA+LCP build of "
                             "rep_dna")
    # second, warm runs (allocator and library state settled)
    t0 = time.perf_counter()
    construct_device(xs, alpha, n_, N)
    torch.cuda.synchronize()
    t_sa_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    construct_suffix_tree_device(dsa, xs)
    torch.cuda.synchronize()
    t_st_warm = time.perf_counter() - t0

    res = dsa.materialize()
    if not (np.array_equal(res.sa, sa_ref) and np.array_equal(res.lcp,
                                                              lcp_ref)):
        raise AssertionError("SA+LCP of the random DNA differ from SA-IS")
    del res
    log(f"[main] SA+LCP 2^{args.log2n} DNA == native: {t_sa:.3f} s "
        f"(with encoding), {n / t_sa / 1e6:.1f} MB/s, peak "
        f"{mem_sa / 2**30:.2f} GiB; warm construct_device {t_sa_warm:.3f} s")
    if not (np.array_equal(rres.sa, rsa) and np.array_equal(rres.lcp, rlcp)):
        raise AssertionError("SA+LCP of the repetitive DNA differ from SA-IS")
    log(f"[main] SA+LCP 2^{args.rep_log2n} rep_dna == native: {t_rep:.3f} s "
        f"(to host arrays), K6 launches {rep_counts['rmq_resolve']} on {card}")
    rx = padded_lcp(rres.lcp)
    label = f"2^{args.rep_log2n} rep_dna LCP"
    engines[label] = engine_comparison(rx, label, card)
    del rres, rx
    plain_tree = _st_local(dsa, xs, PLAIN)
    if not torch.equal(tree.nodes, plain_tree.nodes):
        raise AssertionError("suffix tree differs from the plain path")
    del plain_tree
    log(f"[main] ST 2^{args.log2n} == plain path: {t_st:.3f} s, "
        f"peak {mem_st / 2**30:.2f} GiB; warm {t_st_warm:.3f} s")
    m = len(homo)
    want = suffix_tree_oracle(np.ones(m, np.int64), np.arange(m - 1, -1, -1),
                              np.arange(m), 1)
    if not np.array_equal(homo_tree, want):
        raise AssertionError("suffix tree of the homopolymer differs")
    log(f"[main] ST of A^{m} (a spine of every row, on K2) == oracle")
    tree_p1 = tree.nodes.cpu()  # the mesh phase's reference
    del tree, dsa, xs

    # ---- 4b. suffix tree of the repetitive text (counted) ---------------
    rep_st = rep_tree_phase(dev, rep_text, args.rep_log2n, card)

    # ---- 5. the tree's pass through ansv_local on a spine of every row ---
    dec = np.arange(1 << 20, 0, -1).astype(np.int32)
    before = nsv_scan_dual.launches
    li, lv, ri, rv = ansv_local(torch.from_numpy(dec).to(dev), FURTHEST_EQ,
                                NEAREST_SM)
    if nsv_scan_dual.launches != before + 1:
        raise AssertionError("strictly decreasing input did not reach K2")
    wl, wr = ansv_seq(dec, FURTHEST_EQ, NEAREST_SM, nonsv=2**31 - 1)
    if not (np.array_equal(li.cpu().numpy(), wl)
            and np.array_equal(ri.cpu().numpy(), wr)):
        raise AssertionError("ansv_local differs from ansv_seq")
    log("[ansv_local] decreasing 2^20 array: K2 ran, == ansv_seq")

    # ---- 6. small oracles -----------------------------------------------
    for t in (b"mississippi", rand_dna(4177, seed=4177), b"abc" * 300):
        a = Alphabet.from_bytes(t)
        sa = native.suffix_array(t)
        want = suffix_tree_oracle(a.encode(t), sa, native.lcp_array(t, sa),
                                  a.sigma)
        if not np.array_equal(build_suffix_tree(t), want):
            raise AssertionError(f"suffix tree of {t[:12]!r} differs")
    log("[small] ST == suffix_tree_oracle for mississippi, rand_dna(4177), "
        "abc*300")

    # ---- 7. public ANSV (counted per call) --------------------------------
    ansv_times = public_ansv_phase(dev, args.ansv_log2n, card)

    # ---- 8. DESA of the 2^26 text: both top-level indexes, bulk_locate ---
    desa, desa_ref = desa_phase(dev, text, sa_ref, args.batch, card, kern)

    # ---- 9. generalized suffix array and tree (counted) -------------------
    small_gsa_sets(card)
    tail_stages_check(card)
    gsa_rand = gsa_phase(
        f"2^{args.gsa_log2n} random DNA in 4 KiB strings", gsa_set, False,
        card)
    # one seeded base and 63 copies with about 0.1% substitutions each
    fam_len = (1 << args.fam_log2n) // 64
    fam_set = near_identical_family(64, fam_len, max(1, fam_len // 1000))
    fam_label = f"2^{args.fam_log2n} near-identical family"
    gsa_fam = gsa_phase(fam_label, fam_set, True, card)

    # ---- 9b. the host-driven loop at full size (counted) -----------------
    rand_label = f"2^{args.gsa_log2n} random DNA in 4 KiB strings"
    host = hostloop_phase(
        dev, text, sa_ref, lcp_ref, args.log2n, rep_text, rsa, rlcp,
        args.rep_log2n,
        {fam_label: (fam_set, gsa_fam["oracle"]),
         rand_label: (gsa_set, gsa_rand["oracle"])}, card)

    # ---- 9c. the mesh of p = 4 shards (counted) --------------------------
    t0 = time.perf_counter()
    mesh_res = mesh_phase(
        dev, text, sa_ref, lcp_ref, tree_p1, rep_text, rsa, rlcp, args.log2n,
        args.rep_log2n, args.ansv_log2n,
        {rand_label: (gsa_set, gsa_rand["oracle"], gsa_rand.pop("gst"),
                      False),
         fam_label: (fam_set, gsa_fam.pop("oracle"), gsa_fam.pop("gst"),
                     True)}, desa_ref, card, kern)
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s")
    del rsa, rlcp, tree_p1

    # ---- 9d. the mesh across processes (counted in the workers) ---------
    t0 = time.perf_counter()
    procs = procs_phase(text, sa_ref, lcp_ref, desa_ref, fam_set,
                        mesh_res.pop("fam_shards"), card)
    log(f"[procs] phase {time.perf_counter() - t0:.1f} s")
    del fam_set

    # ---- 10. the ANSV engines, then the command-line tools at full size ---
    engines_phase(dev, args.ansv_log2n, card)
    cli = cli_phase(text, sa_ref, lcp_ref, gsa_set, gsa_rand.pop("oracle"),
                    args.batch, args.ansv_log2n, args.bench_reps, card)
    del text, sa_ref, lcp_ref, gsa_set

    # ---- 11. results ------------------------------------------------------
    log(f"[result] SA+LCP 2^{args.log2n} DNA {t_sa:.3f} s "
        f"({n / t_sa / 1e6:.1f} MB/s; warm {t_sa_warm:.3f} s), rep_dna "
        f"2^{args.rep_log2n} {t_rep:.3f} s, ST {t_st:.3f} s (warm "
        f"{t_st_warm:.3f} s) on {card}")
    log(f"[result] ST 2^{args.rep_log2n} rep_dna {rep_st['cold']:.3f} s "
        f"(second {rep_st['warm']:.3f} s)")
    log(f"[result] public ANSV 2^{args.ansv_log2n} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ansv_times.items()))
    log("[result] DESA: " + ", ".join(
        f"{k} {v:.3f}" if k.startswith("build") else f"{k} {v:,.0f}"
        for k, v in desa.items()))
    for label, g in (("random set", gsa_rand), ("family", gsa_fam)):
        log(f"[result] GSA + GLCP of the {label}: {g['gsa_first_s']:.3f} s "
            f"(second {g['gsa_second_s']:.3f} s), GST "
            f"{g['gst_first_s']:.3f} s (second {g['gst_second_s']:.3f} s), "
            f"K6 launches {g['k6_launches']}")
    for k, e in engines.items():
        log(f"[result] engines on the {k}: tile-spine pass "
            f"{e['tile_spine_ms']:.3f} ms vs K2 {e['dual_ms']:.3f} ms "
            f"(spine {100 * e['spine_share']:.3f}% of the rows)")
    for key, turns in host.items():
        if key == "rep_sections_ms":
            continue
        if isinstance(turns, list):
            log(f"[result] hostloop {key}: " + ", ".join(
                f"{name} {st['wall_s']:.3f} s (K6 {st['k6']}"
                + (f", host_iters {st['host_iters']}"
                   if st["host_iters"] is not None else "") + ")"
                for name, st in turns))
        else:
            log(f"[result] hostloop {key}: {turns['wall_s']:.3f} s (K6 "
                f"{turns['k6']}, host_iters {turns['host_iters']}, peak "
                f"{turns['peak_gib']:.2f} GiB)")
    log("[result] mesh: " + ", ".join(
        f"{k} {v['wall_s']:.3f} s ({v['peak_gib']:.2f} GiB; K6-mins "
        f"{v['rmq_mins']}, K5 {v['block_psv']}, K6 {v['rmq_resolve']}, "
        f"K8 {v['walks']}"
        + (f"; walks {v['walk_ms']:.3f} ms" if "walk_ms" in v else "")
        + (f", plain {v['walk_plain_ms']:.3f} ms"
           if "walk_plain_ms" in v else "") + ")"
        for k, v in mesh_res.items() if "wall_s" in v)
        + f"; host-loop resolves {mesh_res['resolves']}")
    log("[result] mesh DESA patterns/s: " + ", ".join(
        f"{k.split()[1]} len {q[5:]} {v[q]:,.0f}"
        for k, v in mesh_res.items() if k.startswith("DESA")
        for q in v if q.startswith("qps_L")))
    for backend, res in procs.items():
        for rep in res["reports"]:
            log(f"[result] procs {backend} rank {rep['rank']} "
                f"({rep['device']}): " + ", ".join(
                    f"{k} {v['wall_s']:.3f} s ({v['peak_gib']:.2f} GiB)"
                    for k, v in rep["steps"].items()))
        log(f"[result] procs {backend}: phase {res['wall_s']:.1f} s, "
            f"launches {res['launches']}")
    log("[result] CLI benchmark ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in cli["benchmark_ms"].items()))
    log("[result] CLI benchmark-ansv ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in cli["benchmark_ansv_ms"].items()))
    log(f"[result] CLI: desa -q ms/rep " + ", ".join(
        f"{k} {cli[f'desa_{k}_ms']:.2f} ({cli[f'desa_{k}_qps']:,.0f} "
        "patterns/s)" for k in ("tllt", "tldt", "load", "mesh"))
        + f"; d_check_sa {cli['d_check_sa_s']:.3f} s")
    log(f"[result] launches over the main-path phases: {LAUNCHES}")
    for k, v in kern.items():
        v["launches"] = LAUNCHES.get(k, 0)
        # K4 and K1 serve the spine engine only, which no main path takes
        if (v["launches"] == 0) != (k in ("tile_side", "nsv_scan_spine")):
            raise AssertionError(f"{k} launched {v['launches']} times on "
                                 "the main path")
    for k, v in kern.items():
        log(f"[kernel] {k}: kernel {v['ms']:.3f} ms, plain "
            f"{v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']}, {100 * v['bound_ms'] / v['ms']:.2f}% of it "
            f"reached), launches {v['launches']}")
    table = [dict(name=k, **v) for k, v in kern.items()]
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
