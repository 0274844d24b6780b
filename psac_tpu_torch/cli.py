"""Command-line tools (port of ``psac_tpu/cli.py``): the reference's
``src/`` binaries as subcommands, on one device or on a mesh of P shards.

  psac (src/psac.cpp)              -> ``psac``        SA / SA+LCP / +suffix tree
  gsac (src/gsac.cpp)              -> ``gsac``        generalized SA of a string set
  desa-main (src/desa_main.cpp)    -> ``desa``        DESA build/load/save + bulk query
  benchmark_sac (src/benchmark.cpp)-> ``benchmark``   construction-variant timings CSV
  benchmark_k (src/benchmark_k.cpp)-> ``benchmark-k`` initial k-mer length sweep
  benchmark-ansv                   -> ``benchmark-ansv`` ANSV engines x inputs x pairs
  dss (src/dss.cpp)                -> ``dss``         native sequential baseline
  psac-vs-dss (src/psac_vs_dss.cpp)-> ``psac-vs-dss`` cross-check + timings
  print64 (src/print64.cpp)        -> ``print64``
  mkpattern (src/mkpattern.cpp)    -> ``mkpattern``
  kmer-stats (src/kmer_partition.cpp)-> ``kmer-stats`` partition imbalance study

Flags, defaults, output lines and exit codes are the JAX package's, with
``--device`` besides (default: the CUDA card; ``cpu`` runs the kernels'
plain versions).  ``--devices P`` runs the subcommand on a mesh of P
shards (``parallel.mesh.make_mesh``): with ``--device D`` all P on D (as
the tests run it on the CPU, and one card holds four shards), else on the
first P cards, raising with fewer.  Without ``--devices`` a subcommand
runs on one device, where the JAX CLI takes every device it sees.  The
device-count column of the benchmark lines is P.  Every timed line stops
its clock after the result is copied to the host or the devices are
synchronized.

Usage: ``python -m psac_tpu_torch.cli <subcommand> [args]``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _load_text(args) -> bytes:
    if getattr(args, "file", None):
        with open(args.file, "rb") as f:
            return f.read()
    if getattr(args, "random", 0):
        from psac_tpu_torch.ops.alphabet import rand_dna
        return rand_dna(args.random, seed=args.seed)
    raise SystemExit("need -f FILE or -r N")


def _mesh(args):
    """The mesh of ``--devices P`` (None without it: one device)."""
    p = getattr(args, "devices", None)
    if not p:
        return None
    from psac_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(p, None if args.device is None else [args.device] * p)


def _sync(device, mesh=None) -> None:
    """Wait for the queued work of the device or of the mesh's devices
    (this process's: a mesh that spans processes lists only its own; a
    no-op on the CPU)."""
    import torch

    from psac_tpu_torch.config import resolve_device

    for dev in mesh.devices if mesh is not None else [resolve_device(device)]:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def cmd_psac(args) -> int:
    from psac_tpu_torch import config as cfg
    from psac_tpu_torch.models.suffix_array import build_suffix_array

    text = _load_text(args)
    dev = args.device
    mesh = _mesh(args)
    conf = cfg.SAConfig(construct_lcp=args.lcp or args.tree, k=args.k,
                        dense_factor=args.factor,
                        resolve_div=args.rdiv,
                        kmer_words=args.kmer_words)
    if args.tree:
        # one construction feeds both outputs (the reference's psac.cpp:96-114
        # likewise reuses the SA for the ST build)
        from psac_tpu_torch.models.suffix_array import (construct_device,
                                                        encode_and_shard)
        from psac_tpu_torch.models.suffix_tree import \
            construct_suffix_tree_device
        t0 = time.time()
        xs, alpha, n, N = encode_and_shard(text, dev, mesh)
        dsa = construct_device(xs, alpha, n, N, conf, mesh)
        res = dsa.materialize()
        _log(f"PSAC time: {(time.time() - t0) * 1000:.1f} ms")
        t0 = time.time()
        nodes = construct_suffix_tree_device(dsa, xs).materialize()
        _log(f"ST time: {(time.time() - t0) * 1000:.1f} ms "
             f"({nodes.shape[0]} nodes x {nodes.shape[1]} slots)")
    elif getattr(args, "file", None):
        # the file is staged raw on the device and counted there
        from psac_tpu_torch.models.suffix_array import construct_from_file
        t0 = time.time()
        dsa, _xs = construct_from_file(args.file, dev, conf, mesh)
        res = dsa.materialize()
        _log(f"PSAC time: {(time.time() - t0) * 1000:.1f} ms")
    else:
        t0 = time.time()
        res = build_suffix_array(text, dev, conf, mesh)
        _log(f"PSAC time: {(time.time() - t0) * 1000:.1f} ms")
    if args.check:
        from psac_tpu_torch import native
        ok = np.array_equal(res.sa, native.suffix_array(text))
        if ok and res.lcp is not None:
            ok = np.array_equal(res.lcp, native.lcp_array(text, res.sa))
        _log("[SUCCESS] SA/LCP correct" if ok else "[ERROR] mismatch vs oracle")
        if not ok:
            return 1
    if args.output:
        from psac_tpu_torch.io import write_suffix_array
        write_suffix_array(args.output, res)
    return 0


def cmd_gsac(args) -> int:
    from psac_tpu_torch.models.gsa import build_gsa, build_gsa_from_file

    mesh = _mesh(args)
    t0 = time.time()
    if getattr(args, "file", None):
        res = build_gsa_from_file(args.file, args.device,
                                  mesh=mesh).materialize()
    else:
        res = build_gsa(_load_text(args), args.device, mesh=mesh)
    _log(f"GSAC time: {(time.time() - t0) * 1000:.1f} ms "
         f"({res.nstrings} strings, {res.n} chars)")
    if args.check:
        # the native oracle gives the sorting oracle's arrays at any size
        from psac_tpu_torch.verify.gsa_oracle import gsa_oracle_native
        text = _load_text(args)
        parts = [x for x in text.split(b"\n") if x]
        sa, lcp = gsa_oracle_native(b"".join(parts),
                                    [len(x) for x in parts])
        ok = np.array_equal(res.sa, sa) and np.array_equal(res.lcp, lcp)
        _log("[SUCCESS] GSA correct" if ok else "[ERROR] GSA mismatch")
        if not ok:
            return 1
    if args.output:
        from psac_tpu_torch.io import write_u64
        write_u64(args.output + ".gsa64", res.sa)
        if res.lcp is not None:
            write_u64(args.output + ".glcp64", res.lcp)
    return 0


def cmd_desa(args) -> int:
    from psac_tpu_torch.models.desa import build_desa, read_desa, write_desa

    text = _load_text(args)
    dev = args.device
    mesh = _mesh(args)
    if args.load:
        idx = read_desa(text, args.load, dev, tli=args.tli,
                        maxsize=args.maxsize, mesh=mesh)
        _log(f"loaded DESA from {args.load} (tli={args.tli})")
    else:
        t0 = time.time()
        idx = build_desa(text, dev, tli=args.tli, maxsize=args.maxsize,
                         mesh=mesh)
        _sync(dev, mesh)
        _log(f"DESA construct (tli={args.tli}): "
             f"{(time.time() - t0) * 1000:.1f} ms")
    if args.output:
        write_desa(idx, args.output)
        _log(f"saved DESA to {args.output}")
    if args.query:
        with open(args.query, "rb") as f:
            patterns = [ln for ln in f.read().split(b"\n") if ln]
        idx.bulk_locate(patterns)  # warm-up
        t0 = time.time()
        for _ in range(args.reps):
            ranges = idx.bulk_locate(patterns)
        dt = (time.time() - t0) / args.reps
        hits = int((ranges[:, 1] > ranges[:, 0]).sum())
        _log(f"bulk_locate: {len(patterns)} patterns, {hits} matched, "
             f"{dt * 1000:.2f} ms/rep ({args.reps} reps)")
    return 0


def cmd_benchmark(args) -> int:
    """Construction-variant timings CSV (reference src/benchmark.cpp): the
    reference's {reg, reg-fast} x {lcp, nolcp} ("reg" = the host-driven
    loop, pure doubling with no sparse tail; "fast" = the default build)
    and the SA-only construct_arr<3> and <4> rows, each as
    ``<p>;<name>;<ms>``, the mean of ``--reps`` builds to host arrays after
    one warm-up."""
    from psac_tpu_torch import config as cfg
    from psac_tpu_torch.models.suffix_array import build_suffix_array
    from psac_tpu_torch.parallel.mesh import num_shards

    text = _load_text(args)
    mesh = _mesh(args)
    p = num_shards(mesh)
    variants = [
        ("sa-nolcp-reg", cfg.SAConfig(construct_lcp=False,
                                      tail_threshold_frac=0.0, fused=False)),
        ("sa-nolcp-fast", cfg.SAConfig(construct_lcp=False)),
        ("sa-lcp-reg", cfg.SAConfig(construct_lcp=True,
                                    tail_threshold_frac=0.0, fused=False)),
        ("sa-lcp-fast", cfg.SAConfig(construct_lcp=True)),
        ("sa-nolcp-arr3", cfg.SAConfig(construct_lcp=False, factor=3,
                                       fused=False)),
        ("sa-nolcp-arr4", cfg.SAConfig(construct_lcp=False, factor=4,
                                       fused=False)),
    ]
    for name, conf in variants:
        build_suffix_array(text, args.device, conf, mesh)  # warm-up
        t0 = time.time()
        for _ in range(args.reps):
            build_suffix_array(text, args.device, conf, mesh)
        print(f"{p};{name};{(time.time() - t0) / args.reps * 1000:.2f}")
    return 0


def ansv_inputs(n: int, seed: int, which: str = "all") -> dict:
    """The ``benchmark-ansv`` inputs of n int32 values: ``uniform`` (seeded
    random in [0, n)), ``peaks`` (a 1000-periodic |i mod 1000 - 500|) and
    ``bitonic`` (rising to n/2, then falling)."""
    rng = np.random.RandomState(seed)
    inputs = {}
    if which in ("uniform", "all"):
        inputs["uniform"] = rng.randint(0, n, size=n).astype(np.int32)
    if which in ("peaks", "all"):
        inputs["peaks"] = (np.abs(np.arange(n) % 1000 - 500)).astype(np.int32)
    if which in ("bitonic", "all"):
        h = n // 2
        inputs["bitonic"] = np.concatenate(
            [np.arange(h), np.arange(n - h)[::-1]]).astype(np.int32)
    return inputs


def cmd_benchmark_ansv(args) -> int:
    """ANSV timing: engines x inputs x match-type pairs (the reference
    sweeps 6 implementations x 3 inputs, src/benchmark_ansv.cpp:38-171;
    here the implementation axis is the engine, ``parallel.ansv``'s
    ``engine=``; on a mesh of p > 1 shards the routed pipeline, where the
    engine does not apply).  Prints ``n;p;<engine>;<input>;<pair>;<ms>``,
    the mean of ``--reps`` calls after one warm-up; the ``spine`` engine
    differs from ``hybrid`` only on ``feq-sm``, the suffix tree's pair."""
    import os

    from psac_tpu_torch.config import resolve_device
    from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM
    from psac_tpu_torch.parallel.ansv import ansv
    from psac_tpu_torch.parallel.mesh import num_shards

    n = args.n
    inputs = ansv_inputs(n, args.seed, args.input)
    mesh = _mesh(args)
    p = num_shards(mesh)
    if args.engines:
        engines = args.engines.split(",")
    elif p == 1 and resolve_device(args.device).type == "cuda":
        engines = ["hybrid", "scan", "block", "spine"]
    else:
        engines = [os.environ.get("PSAC_NSV", "")]
    combos = [("sm-sm", (NEAREST_SM, NEAREST_SM)),
              ("feq-sm", (FURTHEST_EQ, NEAREST_SM)),
              ("eq-eq", (NEAREST_EQ, NEAREST_EQ))]
    for eng in engines:
        for iname, a in inputs.items():
            for cname, (lt, rt) in combos:
                if eng == "spine" and cname != "feq-sm":
                    continue  # the spine engine runs hybrid's path there
                kw = dict(device=args.device, engine=eng or None, mesh=mesh)
                ansv(a, lt, rt, **kw)  # warm-up
                t0 = time.time()
                for _ in range(args.reps):
                    ansv(a, lt, rt, **kw)
                print(f"{n};{p};{eng or 'default'};{iname};{cname};"
                      f"{(time.time() - t0) / args.reps * 1000:.2f}")
    return 0


def cmd_benchmark_k(args) -> int:
    """Initial k-mer length sweep (reference src/benchmark_k.cpp); the
    device count column is p."""
    from psac_tpu_torch import config as cfg
    from psac_tpu_torch.models.suffix_array import build_suffix_array
    from psac_tpu_torch.parallel.mesh import num_shards

    text = _load_text(args)
    mesh = _mesh(args)
    p = num_shards(mesh)
    for k in args.ks:
        conf = cfg.SAConfig(construct_lcp=args.lcp, k=k)
        build_suffix_array(text, args.device, conf, mesh)  # warm-up
        t0 = time.time()
        for _ in range(args.reps):
            build_suffix_array(text, args.device, conf, mesh)
        print(f"{p};psac;{k};{(time.time() - t0) / args.reps * 1000:.2f}")
    return 0


def cmd_dss(args) -> int:
    from psac_tpu_torch import native

    text = _load_text(args)
    t0 = time.time()
    sa = native.suffix_array(text)
    _log(f"divsufsort-class (SA-IS) time: {(time.time() - t0) * 1000:.1f} ms")
    if args.lcp:
        t0 = time.time()
        native.lcp_array(text, sa)
        _log(f"Kasai LCP time: {(time.time() - t0) * 1000:.1f} ms")
    return 0


def cmd_psac_vs_dss(args) -> int:
    from psac_tpu_torch import native
    from psac_tpu_torch.models.suffix_array import build_suffix_array

    text = _load_text(args)
    mesh = _mesh(args)
    build_suffix_array(text, args.device, mesh=mesh)  # warm-up
    t0 = time.time()
    res = build_suffix_array(text, args.device, mesh=mesh)
    t_psac = time.time() - t0
    t0 = time.time()
    sa_ref = native.suffix_array(text)
    t_dss = time.time() - t0
    ok = np.array_equal(res.sa, sa_ref)
    print(f"psac={t_psac * 1000:.1f}ms dss={t_dss * 1000:.1f}ms "
          f"speedup={t_dss / max(t_psac, 1e-9):.2f}x "
          f"{'[SUCCESS]' if ok else '[ERROR] MISMATCH'}")
    return 0 if ok else 1


def cmd_print64(args) -> int:
    from psac_tpu_torch.io import read_u64
    for v in read_u64(args.file):
        print(v)
    return 0


def cmd_mkpattern(args) -> int:
    text = _load_text(args)
    rng = np.random.RandomState(args.seed)
    with open(args.output, "wb") as f:
        for _ in range(args.num):
            st = rng.randint(0, max(1, len(text) - args.len))
            f.write(text[st:st + args.len] + b"\n")
    return 0


def cmd_kmer_stats(args) -> int:
    """k-mer table partition imbalance study (reference src/kmer_partition.cpp)."""
    from psac_tpu_torch.ops.alphabet import Alphabet

    text = _load_text(args)
    alpha = Alphabet.from_bytes(text)
    bits = alpha.bits_per_char
    k = max(1, min(args.bits // bits, 12))
    codes = alpha.encode(text).astype(np.int64)
    n = len(codes)
    km = np.zeros(n, np.int64)
    for j in range(k):
        c = np.concatenate([codes[j:], np.zeros(j, np.int64)])
        km = (km << bits) | c
    hist = np.bincount(km, minlength=1 << (k * bits))
    table = np.cumsum(hist)
    for p in args.parts:
        targets = (np.arange(1, p) * n) // p
        cuts = np.minimum(np.searchsorted(table, targets), len(table) - 1)
        begins = np.concatenate([[0], table[cuts]])
        ends = np.concatenate([begins[1:], [n]])
        segs = ends - begins
        print(f"p={p} k={k} max={segs.max()} avg={n / p:.0f} "
              f"imbalance={segs.max() * p / n:.3f}")
    return 0


DEVICES_HELP = ("shards of a mesh: all on --device when given, else on the "
                "first P cards (default: one device)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="psac_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(s, rand=True):
        s.add_argument("-f", "--file")
        if rand:
            s.add_argument("-r", "--random", type=int, default=0,
                           help="random DNA of this length instead of a file")
        s.add_argument("--seed", type=int, default=0)
        s.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card; cpu runs "
                            "the kernels' plain versions)")
        s.add_argument("--devices", type=int, default=None,
                       help=DEVICES_HELP)

    s = sub.add_parser("psac")
    common(s)
    s.add_argument("-l", "--lcp", action="store_true")
    s.add_argument("-t", "--tree", action="store_true")
    s.add_argument("-c", "--check", action="store_true")
    s.add_argument("-o", "--output")
    s.add_argument("-k", type=int, default=0)
    s.add_argument("--factor", type=int, default=4,
                   help="dense prefix-multiplication factor (2/3/4/8)")
    s.add_argument("--rdiv", type=int, default=32,
                   help="LCP-resolve chunk divisor of the plain version "
                        "(chunk = n/rdiv)")
    s.add_argument("--kmer-words", type=int, default=2,
                   help="int32 words of the initial k-mer ranking")
    s.set_defaults(fn=cmd_psac)

    s = sub.add_parser("gsac")
    common(s, rand=False)
    s.add_argument("-c", "--check", action="store_true")
    s.add_argument("-o", "--output")
    s.set_defaults(fn=cmd_gsac)

    s = sub.add_parser("desa")
    common(s)
    s.add_argument("-q", "--query", help="pattern file (one per line)")
    s.add_argument("-o", "--output", help="save index to this prefix")
    s.add_argument("--load", help="load index from this prefix")
    s.add_argument("--reps", type=int, default=10)
    s.add_argument("--tli", choices=["tllt", "tldt"], default="tllt",
                   help="top-level index kind (reference dist_desa<_,TLI>)")
    s.add_argument("--maxsize", type=int, default=None,
                   help="tldt sampling maxsize (default n/p/128)")
    s.set_defaults(fn=cmd_desa)

    s = sub.add_parser("benchmark")
    common(s)
    s.add_argument("--reps", type=int, default=3)
    s.set_defaults(fn=cmd_benchmark)

    s = sub.add_parser("benchmark-k")
    common(s)
    s.add_argument("-l", "--lcp", action="store_true")
    s.add_argument("--ks", type=int, nargs="+", default=[0, 4, 8, 12, 16, 20])
    s.add_argument("--reps", type=int, default=3)
    s.set_defaults(fn=cmd_benchmark_k)

    s = sub.add_parser("benchmark-ansv")
    s.add_argument("-n", type=int, default=1 << 20)
    s.add_argument("-i", "--input",
                   choices=["uniform", "peaks", "bitonic", "all"],
                   default="all")
    s.add_argument("--engines", default=None,
                   help="comma list of ANSV engines to sweep (default: "
                        "hybrid,scan,block,spine on the card, else PSAC_NSV "
                        "or the default engine)")
    s.add_argument("--reps", type=int, default=3)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; cpu runs "
                        "the kernels' plain versions)")
    s.add_argument("--devices", type=int, default=None, help=DEVICES_HELP)
    s.set_defaults(fn=cmd_benchmark_ansv)

    s = sub.add_parser("dss")
    common(s)
    s.add_argument("-l", "--lcp", action="store_true")
    s.set_defaults(fn=cmd_dss)

    s = sub.add_parser("psac-vs-dss")
    common(s)
    s.set_defaults(fn=cmd_psac_vs_dss)

    s = sub.add_parser("print64")
    s.add_argument("file")
    s.set_defaults(fn=cmd_print64)

    s = sub.add_parser("mkpattern")
    common(s)
    s.add_argument("-n", "--num", type=int, default=100)
    s.add_argument("-l", "--len", type=int, default=20)
    s.add_argument("-o", "--output", required=True)
    s.set_defaults(fn=cmd_mkpattern)

    s = sub.add_parser("kmer-stats")
    common(s)
    s.add_argument("-t", "--bits", type=int, default=16)
    s.add_argument("-p", "--parts", type=int, nargs="+", default=[4, 8, 16])
    s.set_defaults(fn=cmd_kmer_stats)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
