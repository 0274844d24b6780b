"""Time K9 (``kmer_pack`` of ``csrc/kmer_init.cu``, the k-mer pack) at
each shape it can be built with, on one NVIDIA GPU.

The kernel's shape is fixed when it is compiled: the positions a thread
rolls its words along (``PSAC_K9_RUN``) and the threads per block
(``PSAC_K9_THREADS``). This script compiles ``kmer_init.cu`` once for each
variant of ``variants()`` into ``psac_tpu_torch/_build/`` (one ``nvcc``
each, all started together), prints their ptxas reports, holds each
variant and the library as built (``library``) against the plain version
(``pack_kmers_plain``) on every call, and times them in turns
(``k8_sweep.turns``: the variants in order, then in reverse; CUDA-event
means over 20 calls after a warm-up). The calls are K9's at the shapes
``chip_smoke.py`` holds it on: the init of SA+LCP of ``rand_dna(2^26,
seed=42)`` (ks (10, 10)) and of the GSA of ``rand_dna(2^26, seed=43)``
cut into 4 KiB strings (noted by spies on a build of each), and 2^26
random codes at the ``dna3`` (3 bits, ks (10, 10, 10)) and ``bytes`` (8
bits, ks (3, 3)) shapes of ``verify/cases.py::KMER_SHAPES``. Each
variant is also held against the plain version on the SA call with its
codes moved 4 bytes off a 16-byte boundary, and on 2^20 random codes at
one bit a char with ks (31, 31, 31) (k = 93, the longest: the window's
tail is then longer than a block's threads at some shapes). ``--parent`` adds another
``kmer_init.cu`` with the same C interface (e.g. an earlier commit's,
put under a git-ignored directory) to the turns. It prints one line per
call set with each time's share of the call's byte bound (each input
read once, each output written once, at 3.35 TB/s), the card's name and
power limit, and one JSON line.

Run from the repository root:  python3 -m psac_tpu_torch.tools.k9_sweep
(``--log2n`` sets the length of every call set.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

from psac_tpu_torch.tools.k7_sweep import ptxas_report, start_build
from psac_tpu_torch.tools.k8_sweep import turns

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
_SYMBOLS = ("psac_kmer_pack_i32", "psac_kmer_pack_i64",
            "psac_kmer_heads_i32", "psac_kmer_heads_i64")


def variants() -> dict:
    """label -> macros of each build: ``R`` positions a thread, ``x``
    threads a block.  The first is the library's shape."""
    return {f"R{r} x{t}": {"PSAC_K9_RUN": r, "PSAC_K9_THREADS": t}
            for r, t in ((4, 64), (4, 128), (4, 256), (4, 512), (8, 128),
                         (8, 256), (16, 128), (16, 256), (32, 128))}


def load(tag: str, proc, so: str):
    """The library of a build started by ``start_build``, its ptxas report
    of K9 printed."""
    import ctypes

    from psac_tpu_torch.ops import cuda_lib

    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so}:\n{err}")
    for kernel, regs, spill in ptxas_report(err, "pack_kernel"):
        print(f"[k9-sweep] ptxas {tag} {kernel}: {regs} registers, "
              f"{spill} bytes spilled", flush=True)
    lib = ctypes.CDLL(so)
    for name in _SYMBOLS:
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def through(lib):
    """K9's wrapper with its launches sent to ``lib``."""
    from psac_tpu_torch.ops import cuda_lib, kmer

    def run(args):
        with mock.patch.object(cuda_lib, "_lib", lib):
            return kmer.kmer_pack(*args)
    return run


def recorded(build) -> tuple:
    """The arguments of the first ``kmer_pack`` call that ``build()``
    makes (a spy on the SA's and the GSA's builder modules)."""
    from psac_tpu_torch.models import gsa as gsa_mod
    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.ops import kmer

    calls = []

    def spy(*args):
        calls.append(args)
        return kmer.kmer_pack(*args)

    with mock.patch.object(sa_mod, "kmer_pack", spy), \
            mock.patch.object(gsa_mod, "kmer_pack", spy):
        build()
    return calls[0]


def call_sets(log2n: int) -> dict:
    """name -> K9's arguments (codes, halo, ks, bits, base, N, idt[, eos])
    at each shape the sweep times (see the module's docstring)."""
    import torch

    from psac_tpu_torch.models import gsa as gsa_mod
    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.ops.alphabet import rand_dna

    dev = torch.device("cuda", 0)
    n = 1 << log2n

    def sa():
        xs, alpha, n_, N = sa_mod.encode_and_shard(rand_dna(n, seed=42), dev)
        sa_mod.construct_device(xs, alpha, n_, N)

    whole = rand_dna(n, seed=43)
    strings = [whole[i:i + 4096] for i in range(0, len(whole), 4096)]
    out = {f"sa_2^{log2n}": recorded(sa),
           "gsa_4KiB": recorded(lambda: gsa_mod.build_gsa_device(strings,
                                                                 dev))}
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    for name, bits, ks in (("dna3", 3, (10, 10, 10)), ("bytes", 8, (3, 3))):
        codes = torch.randint(1, 1 << bits, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        halo = torch.zeros(sum(ks) - 1, dtype=torch.int32, device=dev)
        out[f"{name}_2^{log2n}"] = (codes, halo, ks, bits, 0, n,
                                    torch.int32)
    return out


def unaligned(args: tuple) -> tuple:
    """``args`` with its codes copied to a view 4 bytes off a 16-byte
    boundary."""
    import torch

    codes = args[0]
    buf = torch.empty(codes.shape[0] + 4, dtype=torch.int32,
                      device=codes.device)
    view = buf[1:1 + codes.shape[0]]
    view.copy_(codes)
    assert view.data_ptr() % 16 == 4
    return (view,) + tuple(args[1:])


def longest_k(n: int) -> tuple:
    """K9's arguments for ``n`` random one-bit codes at ks (31, 31, 31)."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    ks = (31, 31, 31)
    codes = torch.randint(0, 2, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    halo = torch.randint(0, 2, (sum(ks) - 1,), generator=gen, device=dev,
                         dtype=torch.int32)
    return (codes, halo, ks, 1, 0, n, torch.int32)


def bound_ms(args: tuple) -> float:
    """Each input read once and each output written once at 3.35 TB/s."""
    codes, halo, ks = args[:3]
    eos = args[7] if len(args) > 7 else None
    nbytes = codes.nbytes + halo.nbytes + 4 * len(ks) * codes.shape[0]
    nbytes += 0 if eos is None else eos.nbytes
    return nbytes / MEM_BYTES_PER_S * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=26)
    ap.add_argument("--parent", default=None,
                    help="another kmer_init.cu with the same C interface, "
                    "timed in the same turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k9_sweep: no CUDA device", file=sys.stderr)
        return 2
    from psac_tpu_torch.ops import cuda_lib, kmer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    src = os.path.join(cuda_lib.CSRC_DIR, "kmer_init.cu")
    builds = {tag: start_build(tag, src, defs, "k9")
              for tag, defs in variants().items()}
    if args.parent:
        builds["parent"] = start_build("parent", args.parent, {}, "k9")
    fns = {"library": through(cuda_lib.lib())}
    fns.update({tag: through(load(tag, *b)) for tag, b in builds.items()})
    print(f"[k9-sweep] {len(builds)} builds and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    sets = call_sets(args.log2n)
    torch.cuda.synchronize()
    checks = dict(sets)
    first = next(iter(sets))
    checks[f"{first}_unaligned"] = unaligned(sets[first])
    checks["bin3_2^20"] = longest_k(1 << 20)
    for k, a in checks.items():
        want = kmer.pack_kmers_plain(*a)
        for name, fn in fns.items():
            for j, (g, w) in enumerate(zip(fn(a), want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version on {k} (word {j})")
        print(f"[k9-sweep] {len(fns)} variants == plain on {k} "
              f"({a[0].shape[0]} positions, ks {a[2]}, {a[3]} bits"
              + (", masked" if len(a) > 7 else "") + ")", flush=True)
        del want
    del checks

    times = turns(fns, sets, reps=20)
    bounds = {k: bound_ms(a) for k, a in sets.items()}

    def fmt(row, v, b):
        mean = sum(row[v]) / 2
        return (f"{v} {' / '.join(f'{t:.4f}' for t in row[v])} "
                f"({100 * b / mean:.1f}%)")

    for k, row in times.items():
        mean = {v: sum(t) / len(t) for v, t in row.items()}
        order = sorted(mean, key=mean.get)
        print(f"[k9-sweep] {k} (bound {bounds[k]:.4f} ms): " + ", ".join(
            fmt(row, v, bounds[k]) for v in order) + f" ms on {card}",
            flush=True)
    total = {v: sum(sum(times[k][v]) / 2 for k in times) for v in fns}
    order = sorted(total, key=total.get)
    print("[k9-sweep] summed over the call sets: " + ", ".join(
        f"{v} {total[v]:.4f}" for v in order) + f" ms on {card}", flush=True)
    print(card)
    print(json.dumps({"k9_ms": times, "bound_ms": bounds, "summed_ms": total,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
