#!/usr/bin/env python3
"""Smoke run of psac_tpu_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``psac_tpu_torch/csrc``, checks
each against its plain PyTorch version on the card, then drives the main
path (SA+LCP of 2^26 random DNA, SA+LCP of 2^24 repetitive DNA, and the
suffix tree of the 2^26 text) through the user entry points, holds every
result against the native SA-IS + Kasai oracle or the plain path, and
prints the kernel table, the card's name and power limit, and a last JSON
line.  Any mismatch raises; the exit code is then non-zero.

Run from the repository root:  python3 chip_smoke.py
(``--log2n``/``--rep-log2n`` shrink the corpora for a quick rehearsal.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run (CUDA events around the whole batch)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    return {k: v.astype(np.int32) for k, v in cases.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=26,
                    help="random DNA corpus size (log2 chars)")
    ap.add_argument("--rep-log2n", type=int, default=24,
                    help="repetitive DNA corpus size (log2 chars)")
    args = ap.parse_args()

    # ---- 1. device ------------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                         ansv_seq)
    from psac_tpu_torch.ops.nsv_scan import (CHUNK, nsv_scan_dual,
                                             nsv_scan_dual_plain,
                                             nsv_scan_spine,
                                             nsv_scan_spine_plain)
    from psac_tpu_torch.ops.tansv import (CAPDIV, spine_streams, tile_side,
                                          tile_side_plain)
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

    # ---- 3. kernels against their plain versions on the card ------------
    kern = {}

    def padded_lcp(lcp):
        """A host LCP array as the ANSV takes it: int32 on the card, padded
        at the end with INT32_MAX to a multiple of 2048."""
        x = torch.from_numpy(lcp.astype(np.int32)).to(dev)
        pad = -len(lcp) % 2048
        return torch.cat([x, x.new_full((pad,), 2**31 - 1)]) if pad else x

    lcp_adj = padded_lcp(lcp_ref)
    S = lcp_adj.shape[0]

    for name, a in tansv_cases().items():
        x = torch.from_numpy(a).to(dev)
        for xx in (x, x.flip(0)):
            for with_eq in (True, False):
                max_abs_err(tile_side(xx, with_eq),
                            tile_side_plain(xx, with_eq))
    errs = [max_abs_err(tile_side(xx, we), tile_side_plain(xx, we))
            for xx in (lcp_adj, lcp_adj.flip(0)) for we in (True, False)]
    kern["tile_side"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/tansv_tile.cu",
        replaces="psac_tpu/ops/tansv.py:67", max_abs_err=max(errs),
        ms=cuda_ms(lambda: tile_side(lcp_adj, True), 3),
        plain_ms=cuda_ms(lambda: tile_side_plain(lcp_adj, True), 1))
    log(f"[kernel] K4 tile_side == plain on {len(tansv_cases())} "
        f"adversaries and the 2^{args.log2n} LCP")

    spine_f = tile_side(lcp_adj, True)[3]
    spine_n = tile_side(lcp_adj.flip(0), False)[3]
    kf, vf, kn, vn, ovf = spine_streams(lcp_adj, spine_f, spine_n)
    if ovf:
        raise AssertionError("spine of the random-DNA LCP overflowed")
    err = max_abs_err(nsv_scan_spine(vf, kf, vn, kn),
                      nsv_scan_spine_plain(vf, kf, vn, kn))
    kern["nsv_scan_spine"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/nsv_scan.cu",
        replaces="psac_tpu/ops/nsv_scan.py:325", max_abs_err=err,
        ms=cuda_ms(lambda: nsv_scan_spine(vf, kf, vn, kn), 3),
        plain_ms=cuda_ms(lambda: nsv_scan_spine_plain(vf, kf, vn, kn), 1))
    log(f"[kernel] K1 nsv_scan_spine == plain on the spine streams "
        f"({kf.shape[0]} entries; spines {int(spine_f.sum())} and "
        f"{int(spine_n.sum())} of {S})")

    xr = lcp_adj.flip(0)
    errs = [max_abs_err(nsv_scan_dual(lcp_adj, xr, FURTHEST_EQ, NEAREST_SM),
                        nsv_scan_dual_plain(lcp_adj, xr, FURTHEST_EQ,
                                            NEAREST_SM))]
    small = lcp_adj[:1 << 20]
    for tl, tr in ((NEAREST_EQ, NEAREST_EQ), (NEAREST_SM, FURTHEST_EQ)):
        errs.append(max_abs_err(
            nsv_scan_dual(small, small.flip(0), tl, tr),
            nsv_scan_dual_plain(small, small.flip(0), tl, tr)))
    # an increasing array stacks every element: spills past shared memory
    inc = torch.arange(1 << 17, dtype=torch.int32, device=dev)
    errs.append(max_abs_err(
        nsv_scan_dual(inc, inc.flip(0), FURTHEST_EQ, NEAREST_SM),
        nsv_scan_dual_plain(inc, inc.flip(0), FURTHEST_EQ, NEAREST_SM)))
    kern["nsv_scan_dual"] = dict(
        route="cuda", source="psac_tpu_torch/csrc/nsv_scan.cu",
        replaces="psac_tpu/ops/nsv_scan.py:358", max_abs_err=max(errs),
        ms=cuda_ms(lambda: nsv_scan_dual(lcp_adj, xr, FURTHEST_EQ,
                                         NEAREST_SM), 1),
        plain_ms=cuda_ms(lambda: nsv_scan_dual_plain(
            lcp_adj, xr, FURTHEST_EQ, NEAREST_SM), 1))
    log("[kernel] K2 nsv_scan_dual == plain for (FEQ, NSM) at full length, "
        "(NEQ, NEQ) and (NSM, FEQ) at 2^20, and an increasing 2^17 array")
    del lcp_adj, xr, small, inc, spine_f, spine_n, kf, vf, kn, vn
    for k, v in kern.items():
        log(f"[kernel] {k}: kernel {v['ms']:.3f} ms, plain "
            f"{v['plain_ms']:.3f} ms")

    # ---- 4. main path (counted) ------------------------------------------
    counted = (tile_side, nsv_scan_spine, nsv_scan_dual)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in counted}

    # SA+LCP and suffix tree of the 2^26 text: K4 and K1 must run here
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
    log(f"[main] launches in SA+LCP+ST of 2^{args.log2n} DNA: {main_counts}")
    for k in ("tile_side", "nsv_scan_spine"):
        kern[k]["launches"] = main_counts[k]
        if main_counts[k] == 0:
            raise AssertionError(f"{k} was not launched on the main path")

    # K2 runs on the main path only when a spine overflows: the suffix tree
    # of a homopolymer (its LCP rises in every tile), counted on its own
    homo = b"A" * 4096
    reset_counts()
    homo_tree = build_suffix_tree(homo, dev)
    homo_counts = read_counts()
    log(f"[main] launches in build_suffix_tree(A^{len(homo)}): {homo_counts}")
    kern["nsv_scan_dual"]["launches"] = homo_counts["nsv_scan_dual"]
    if homo_counts["nsv_scan_dual"] == 0:
        raise AssertionError("nsv_scan_dual was not launched on an "
                             "overflowing spine")

    rep_n = 1 << args.rep_log2n
    rep_text = rep_dna(rep_n)
    t0 = time.perf_counter()
    rres = build_suffix_array(rep_text, dev)
    t_rep = time.perf_counter() - t0
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
    rsa = native.suffix_array(rep_text)
    if not (np.array_equal(rres.sa, rsa) and np.array_equal(
            rres.lcp, native.lcp_array(rep_text, rsa))):
        raise AssertionError("SA+LCP of the repetitive DNA differ from SA-IS")
    log(f"[main] SA+LCP 2^{args.rep_log2n} rep_dna == native: {t_rep:.3f} s "
        f"(to host arrays)")
    # how long the spines of a repetitive LCP are against the capacity that
    # sends a suffix tree to K2 (s // CAPDIV)
    rx = padded_lcp(rres.lcp)
    rs = rx.shape[0]
    spines = (int(tile_side(rx, True)[3].sum()),
              int(tile_side(rx.flip(0), False)[3].sum()))
    cap = max(CHUNK, rs // CAPDIV // CHUNK * CHUNK)
    log(f"[main] rep_dna 2^{args.rep_log2n} LCP spines {spines} of {rs} rows "
        f"({100 * max(spines) / rs:.3f}%), capacity {cap}: "
        f"{'overflows -> K2' if max(spines) > cap else 'fits -> K1'}")
    del rres, rsa, rx
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
    log(f"[main] ST of A^{m} (spine overflow -> dual scan) == oracle")
    del tree, dsa, xs

    # ---- 5. fallback through ansv_local ---------------------------------
    dec = np.arange(1 << 20, 0, -1).astype(np.int32)
    before = nsv_scan_dual.launches
    li, lv, ri, rv = ansv_local(torch.from_numpy(dec).to(dev), FURTHEST_EQ,
                                NEAREST_SM)
    if nsv_scan_dual.launches != before + 1:
        raise AssertionError("strictly decreasing input did not reach K2")
    wl, wr = ansv_seq(dec, FURTHEST_EQ, NEAREST_SM, nonsv=2**31 - 1)
    if not (np.array_equal(li.cpu().numpy(), wl)
            and np.array_equal(ri.cpu().numpy(), wr)):
        raise AssertionError("fallback ANSV differs from ansv_seq")
    log("[fallback] decreasing 2^20 array: K2 ran, == ansv_seq")

    # ---- 6. small oracles -----------------------------------------------
    for t in (b"mississippi", rand_dna(4177, seed=4177), b"abc" * 300):
        a = Alphabet.from_bytes(t)
        sa = native.suffix_array(t)
        want = suffix_tree_oracle(a.encode(t), sa, native.lcp_array(t, sa),
                                  a.sigma)
        if not np.array_equal(build_suffix_tree(t, dev), want):
            raise AssertionError(f"suffix tree of {t[:12]!r} differs")
    log("[small] ST == suffix_tree_oracle for mississippi, rand_dna(4177), "
        "abc*300")

    # ---- 7. results -------------------------------------------------------
    log(f"[result] SA+LCP 2^{args.log2n} DNA {t_sa:.3f} s "
        f"({n / t_sa / 1e6:.1f} MB/s; warm {t_sa_warm:.3f} s), rep_dna "
        f"2^{args.rep_log2n} {t_rep:.3f} s, ST {t_st:.3f} s (warm "
        f"{t_st_warm:.3f} s) on {card}")
    table = [dict(name=k, **v) for k, v in kern.items()]
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
