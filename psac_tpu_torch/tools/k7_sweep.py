"""Time K7 (``csrc/blind_search.cu``, the DESA's blind search) at each
launch shape it can be built with, on one NVIDIA GPU.

The kernel's shape is fixed when it is compiled: the lanes per pattern on
a large slab (``PSAC_K7_GROUP``; 1 is one thread per pattern), the
threads per block (``PSAC_K7_THREADS``), the most 16-byte vectors a lane
loads in one round (``PSAC_K7_ROUND``) and the largest slab walked with one
lane per pattern (``PSAC_K7_NARROW_CAP``).  This script compiles
``blind_search.cu`` once for each variant of ``variants()`` into
``psac_tpu_torch/_build/`` (one ``nvcc`` each, all started together; the
variants set the narrow slab to 0 rows, so each walks every slab with its
own lanes), prints their ptxas reports, holds each and the library as
built (``library``) against the plain version on every search (all four
outputs), and times them in turns (the variants in order, then in
reverse; CUDA-event means over 10 launches after a warm-up).  The
searches are those of ``chip_smoke.py``'s main path at 2^26 random DNA
(``rand_dna(2^26, seed=42)``; 65,536 patterns of lengths 20 and 64, half
text substrings, half random DNA, drawn as ``chip_smoke.py`` draws them):
the TLLT slab search and the TLDT sample and slab searches, in int32, the
TLLT slab search at length 20 of the ``force_int64`` index, and, to place
the narrow slab's bound, the TLDT sample searches at length 20 of indexes
built with smaller ``maxsize`` (``SAMPLES``: larger samples).  ``--parent``
adds another ``blind_search.cu`` with the same C interface (e.g. an
earlier commit's, unpacked under a git-ignored directory) to the turns.
It prints one line per search, the sums, the card's name and power limit,
and one JSON line.

Run from the repository root:  python3 -m psac_tpu_torch.tools.k7_sweep
(``--log2n`` sets the text's length, ``--batch`` the patterns per batch.)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np

#: TLDT ``maxsize`` of the larger samples, as n >> k for each k
SAMPLES = (11, 15, 19)


def variants() -> dict:
    """label -> macros of each build."""
    out = {f"G{g} x{t}": {"PSAC_K7_GROUP": g, "PSAC_K7_THREADS": t,
                          "PSAC_K7_NARROW_CAP": 0}
           for g in (1, 4, 8, 16, 32) for t in (64, 128, 256)}
    for r in (2, 8):
        out[f"G4 x256 r{r}"] = {"PSAC_K7_GROUP": 4, "PSAC_K7_THREADS": 256,
                                "PSAC_K7_ROUND": r, "PSAC_K7_NARROW_CAP": 0}
    return out


def ptxas_report(log: str, match: str = "blind_search_kernel") -> list:
    """(kernel, registers, spill bytes) of each kernel of an ``nvcc -Xptxas
    -v`` log whose name holds ``match`` (by default K7's)."""
    out, cur, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if match in m.group(1) else None
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if cur and m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out.append((cur, int(m.group(1)), spill))
            cur = None
    return out


def start_build(tag: str, src: str, defs: dict, kernel: str = "k7") -> tuple:
    """Start compiling ``src`` with the macros ``defs`` into
    ``_build/libpsac_<kernel>_<tag>.so``; returns (process, path)."""
    from psac_tpu_torch.ops import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(cuda_lib.BUILD_DIR,
                      f"libpsac_{kernel}_"
                      f"{re.sub(r'[^A-Za-z0-9]', '_', tag)}.so")
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas",
         "-v"] + [f"-D{k}={v}" for k, v in defs.items()] + ["-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, so


def load(tag: str, proc, so: str) -> ctypes.CDLL:
    """The library of a build started by ``start_build``, its ptxas report
    printed."""
    from psac_tpu_torch.ops import cuda_lib

    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so}:\n{err}")
    for kernel, regs, spill in ptxas_report(err):
        print(f"[k7-sweep] ptxas {tag} {kernel}: {regs} registers, "
              f"{spill} bytes spilled", flush=True)
    lib = ctypes.CDLL(so)
    for name in ("psac_blind_search_i32", "psac_blind_search_i64"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def through(lib):
    """``blind_search`` with its launches sent to ``lib``."""
    from psac_tpu_torch.ops import cuda_lib
    from psac_tpu_torch.ops.blind_search import blind_search

    def run(args):
        with mock.patch.object(cuda_lib, "_lib", lib):
            return blind_search(*args)
    return run


def searches(text: bytes, batch: int) -> dict:
    """The blind searches' arguments of the main path's batches, by
    (index, length, search)."""
    import torch

    from psac_tpu_torch import SAConfig, build_desa
    from psac_tpu_torch.models import desa as desa_mod
    from psac_tpu_torch.ops.blind_search import blind_search

    n = len(text)
    idx = {"tllt": build_desa(text, tli="tllt"),
           "tldt": build_desa(text, tli="tldt"),
           "tllt int64": build_desa(text, tli="tllt",
                                    config=SAConfig(force_int64=True))}
    for k in SAMPLES:
        idx[f"tldt n/2^{k}"] = build_desa(text, tli="tldt", maxsize=n >> k)
    rng = np.random.RandomState(2026)  # chip_smoke.py's draws, in order
    tarr = np.frombuffer(text, np.uint8)
    dna = np.frombuffer(b"ACGT", np.uint8)
    out = {}
    for L in (8, 20, 64):
        half = batch // 2
        starts = rng.randint(0, n - L, half)
        sub = tarr[starts[:, None] + np.arange(L)]
        rnd = dna[rng.randint(0, 4, (batch - half, L))]
        pats = [row.tobytes() for row in np.concatenate([sub, rnd])]
        if L == 8:
            continue
        for name, d in idx.items():
            if name not in ("tllt", "tldt") and L != 20:
                continue
            calls = []

            def record(*args, calls=calls):
                calls.append(args)
                return blind_search(*args)

            with mock.patch.object(desa_mod, "blind_search", record):
                d.bulk_locate(pats)
            wheres = ("sample", "slab") if name.startswith("tldt") else \
                ("slab",)
            for where, args in zip(wheres, calls):
                if name.startswith("tldt n/") and where == "slab":
                    continue
                out[(name, L, where)] = args
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=26)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--parent", default=None,
                    help="another blind_search.cu with the same C "
                    "interface, timed in the same turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k7_sweep: no CUDA device", file=sys.stderr)
        return 2
    from psac_tpu_torch.ops import cuda_lib
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.ops.blind_search import (blind_search_plain,
                                                 launch_shape)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    src = os.path.join(cuda_lib.CSRC_DIR, "blind_search.cu")
    builds = {tag: start_build(tag, src, defs)
              for tag, defs in variants().items()}
    if args.parent:
        builds["parent"] = start_build("parent", args.parent, {})
    fns = {"library": through(cuda_lib.lib())}
    fns.update({tag: through(load(tag, *b)) for tag, b in builds.items()})
    print(f"[k7-sweep] {len(builds)} builds and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    text = rand_dna(1 << args.log2n, seed=42)
    calls = searches(text, args.batch)
    for key, a in calls.items():
        want = blind_search_plain(*a[:-1], {"readbacks": 0})
        for name, fn in fns.items():
            got = fn(a)
            for k, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version on {key} (output {k})")
    print(f"[k7-sweep] {len(fns)} variants == plain on {len(calls)} "
          "searches", flush=True)
    names = list(fns)
    times = {key: {v: [] for v in names} for key in calls}
    for v in names + names[::-1]:
        for key, a in calls.items():
            fn = fns[v]
            fn(a)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn(a)
            end.record()
            torch.cuda.synchronize()
            times[key][v].append(start.elapsed_time(end) / 10)

    def fmt(row, v):
        return f"{v} {' / '.join(f'{t:.4f}' for t in row[v])}"

    for key, row in times.items():
        mean = {v: sum(t) / len(t) for v, t in row.items()}
        order = sorted(mean, key=mean.get)
        a = calls[key]
        shape = launch_shape(a[5].dtype, a[8], a[0].shape[0])
        print(f"[k7-sweep] {key[0]} {key[2]} len {key[1]} ({a[8]} rows; "
              f"library: G {shape['group']}, {shape['threads']} threads, "
              f"{shape['round']} vectors per lane in a round): fastest "
              + ", ".join(fmt(row, v) for v in order[:6])
              + "; " + ", ".join(fmt(row, v) for v in
                                 ("library", "G1 x256", "G4 x256")
                                 + (("parent",) if args.parent else ()))
              + f" ms on {card}", flush=True)
    main_keys = [k for k in times if not k[0].startswith("tldt n/")]
    total = {v: sum(sum(times[k][v]) / 2 for k in main_keys) for v in names}
    order = sorted(total, key=total.get)
    print(f"[k7-sweep] summed over the {len(main_keys)} main-path "
          "searches: " + ", ".join(f"{v} {total[v]:.4f}" for v in order)
          + f" ms on {card}", flush=True)
    print(card)
    print(json.dumps({
        "k7_ms": {f"{k[0]} {k[2]} len {k[1]} ({calls[k][8]} rows)": v
                  for k, v in times.items()},
        "summed_ms": total, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
