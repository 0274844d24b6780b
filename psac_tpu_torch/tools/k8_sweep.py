"""Time K8 (``csrc/walk.cu``, the walks) at each launch shape it can be
built with, on one NVIDIA GPU.

The kernel's shape is fixed when it is compiled: the 16-byte vectors of
phase A's window (``PSAC_K8_WINDOW_A``, one thread a query; 0 sends every
query to phase B), phase B's lanes a query (``PSAC_K8_GROUP``) and the
vectors each of them reads in its window (``PSAC_K8_WINDOW``; 0 reads a
row's searched side in one round, as the first version of the kernel
did), the threads per block (``PSAC_K8_THREADS``) and the queries per
thread (``PSAC_K8_QPT``).  ``PSAC_K8_WINDOW_ONLY`` builds a variant that
runs only phase A and writes the miss value for the queries it leaves: it
is timed, never compared, and splits the window's cost from the rest's.
This script compiles ``walk.cu`` once for each variant of
``variants()`` and ``WINDOW_ONLY`` into ``psac_tpu_torch/_build/`` (one
``nvcc`` each, all started together), prints their ptxas reports, holds
each compared variant and the library as built (``library``) against the
plain walks (``levels_*_plain``) on every call, and times them in turns
(the variants in order, then in reverse; CUDA-event means over 10 runs of
a call set after a warm-up).  The call sets are those ``chip_smoke.py``
holds K8 on: one shard's three full-width walks (``j0_l``, ``eh_l``,
``e_loc`` of ``parallel/ansv.py::_left_furthest_eq``) and the largest
routed walk of the p = 4 suffix tree of ``rand_dna(2^26, seed=42)`` on one
card, one shard's three full-width walks of the p = 4 public ``ansv``
(FEQ,NSM) of 2^24 random int32 values (``chip_smoke.py::ansv_values(24)``,
answers farther from their starts than an LCP's), and the largest walk of
the same of 2^20 int64 values (``chip_smoke.py::ansv_values(20) <<
33``).  It also prints how far the answers of both sets of full-width
walks lie from their starts.  ``--parent``
adds another ``walk.cu`` with the same C interface (e.g. an earlier
commit's, unpacked under a git-ignored directory) to the turns.  It prints
one line per call set, the card's name and power limit, and one JSON line.

Run from the repository root:  python3 -m psac_tpu_torch.tools.k8_sweep
(``--log2n`` sets the text's length, ``--ansv-log2n`` the int64 values'.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from unittest import mock

import numpy as np

from psac_tpu_torch.tools.k7_sweep import ptxas_report, start_build

#: the variants timed only: phase A's window and nothing else
WINDOW_ONLY = {f"A{a} x128 q4 window only": {
    "PSAC_K8_WINDOW_A": a, "PSAC_K8_THREADS": 128, "PSAC_K8_QPT": 4,
    "PSAC_K8_WINDOW_ONLY": 1} for a in (4, 8, 16)}
FIELDS = ("walk_prev_lt", "walk_next_leq")
_SYMBOLS = [f"psac_walk_{k}_{d}" for k in ("prev_lt", "next_leq")
            for d in ("i32", "i64")]


def variants() -> dict:
    """label -> macros of each compared build: ``A`` phase A's window in
    vectors (0: none, every query to phase B), ``G`` phase B's lanes a
    query, ``w`` its window in vectors a lane (0: none), ``x`` threads a
    block, ``q`` queries a thread.  The first is the library's shape."""
    out = {}
    for a, g, w, t, qpt in (
            (8, 8, 1, 128, 4), (8, 8, 1, 256, 4), (8, 8, 1, 256, 1),
            (8, 8, 1, 128, 1), (8, 8, 1, 512, 2), (4, 8, 1, 128, 4),
            (16, 8, 1, 128, 4), (8, 8, 0, 128, 4), (8, 4, 2, 128, 4),
            (8, 16, 1, 128, 4), (0, 8, 1, 128, 1), (0, 8, 0, 128, 1)):
        out[f"A{a} G{g} w{w} x{t} q{qpt}"] = {
            "PSAC_K8_WINDOW_A": a, "PSAC_K8_GROUP": g, "PSAC_K8_WINDOW": w,
            "PSAC_K8_THREADS": t, "PSAC_K8_QPT": qpt}
    return out


def load(tag: str, proc, so: str):
    """The library of a build started by ``start_build``, its ptxas report
    printed."""
    import ctypes

    from psac_tpu_torch.ops import cuda_lib

    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so}:\n{err}")
    for kernel, regs, spill in ptxas_report(err, "_kernel"):
        print(f"[k8-sweep] ptxas {tag} {kernel}: {regs} registers, "
              f"{spill} bytes spilled", flush=True)
    lib = ctypes.CDLL(so)
    for name in _SYMBOLS:
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def through(lib):
    """Run a call set ``[(field, levels, start, v, strict), ...]`` on K8's
    wrappers with their launches sent to ``lib``; returns the answers."""
    from psac_tpu_torch.ops import cuda_lib
    from psac_tpu_torch.parallel.ansv import KERNELS

    def run(calls):
        with mock.patch.object(cuda_lib, "_lib", lib):
            return [getattr(KERNELS, f)(lv, st, v, sr)
                    for f, lv, st, v, sr in calls]
    return run


def plain(calls):
    """A call set's answers from the plain walks."""
    from psac_tpu_torch.parallel.ansv import PLAIN

    return [getattr(PLAIN, f)(lv, st, v, sr) for f, lv, st, v, sr in calls]


def recorded(fn) -> list:
    """The walk calls ``(field, levels, start, v, strict)`` that ``fn()``
    makes through ``KERNELS`` (its walk fields swapped for spies that
    note each call and then make it)."""
    from psac_tpu_torch.parallel import ansv as ansv_mod

    calls, lock = [], threading.Lock()
    real = {f: getattr(ansv_mod.KERNELS, f) for f in FIELDS}

    def spy(field):
        def wrapped(levels, start, v, strict):
            with lock:
                calls.append((field, levels, start, v, strict))
            return real[field](levels, start, v, strict)
        return wrapped

    # KERNELS is frozen, and every caller holds this one instance
    try:
        for f in FIELDS:
            object.__setattr__(ansv_mod.KERNELS, f, spy(f))
        fn()
    finally:
        for f in FIELDS:
            object.__setattr__(ansv_mod.KERNELS, f, real[f])
    return calls


def held_calls(calls) -> tuple:
    """Of a mesh suffix tree's walk calls: one shard's three full-width
    walks (``j0_l``, ``eh_l``, ``e_loc`` of ``_left_furthest_eq``, one
    query per row of the shard) and the largest routed walk (the valid rows
    of a mostly-padding exchange buffer)."""
    by_table = {}
    for c in calls:
        if c[2].shape[0] == c[1][0].numel():
            by_table.setdefault(id(c[1]), []).append(c)
    full = next(cs for cs in by_table.values() if len(cs) == 3)
    routed = max((c for c in calls if 0 < c[2].shape[0] < c[1][0].numel()),
                 key=lambda c: c[2].shape[0])
    return full, routed


def call_sets(mesh, log2n: int, ansv_log2n: int) -> dict:
    """name -> call set: one shard's three full-width walks and the largest
    routed walk of the p = 4 suffix tree of ``rand_dna(2^log2n, seed=42)``
    on ``mesh``, one shard's three full-width walks of the public ``ansv``
    FEQ,NSM of 2^(log2n - 2) random int32 values on it (the public ANSV
    phase's input) and the largest walk of the same of 2^ansv_log2n int64
    values."""
    from psac_tpu_torch.config import SAConfig
    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.models import suffix_tree as st_mod
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_SM
    from psac_tpu_torch.parallel.ansv import ansv

    text = rand_dna(1 << log2n, seed=42)
    xs, alpha, n, N = sa_mod.encode_and_shard(text, mesh=mesh)
    dsa = sa_mod.construct_device(xs, alpha, n, N, SAConfig(), mesh)
    full, routed = held_calls(recorded(
        lambda: st_mod.construct_suffix_tree_device(dsa, xs)))
    del dsa, xs
    out = {"full": full, "routed": [routed]}
    # chip_smoke.py::ansv_values(log2n - 2) and ansv_values(ansv_log2n)
    for name, log2v, shift in (("ansv", log2n - 2, 0),
                               ("int64", ansv_log2n, 33)):
        vals = np.random.RandomState(24 + log2v).randint(
            0, 1 << 16, 1 << log2v).astype(np.int64 if shift else np.int32)
        calls = recorded(lambda: ansv(vals << shift, FURTHEST_EQ, NEAREST_SM,
                                      mesh=mesh))
        out[name] = held_calls(calls)[0] if name == "ansv" else \
            [max(calls, key=lambda c: c[2].shape[0])]
    return out


def distances(calls, answers) -> list:
    """Per call: its field, queries, and the share of its answers (misses
    included in the count) within 8 and 32 entries of the own position
    (start - 1 for prev_lt, start for next_leq), in the own row, and
    misses."""
    import torch

    out = []
    for (field, levels, start, _, _), ans in zip(calls, answers):
        s = levels[0].numel()
        st = start.to(torch.int64)
        if field == "walk_prev_lt":
            own, hit = st - 1, ans >= 0
            d = own - ans
        else:
            own, hit = st.clamp(max=s - 1), ans < s
            d = ans - st
        q = max(1, st.shape[0])
        out.append(dict(
            field=field, queries=st.shape[0],
            within_8=int((hit & (d < 8)).sum()) / q,
            within_32=int((hit & (d < 32)).sum()) / q,
            own_row=int((hit & ((ans >> 7) == (own >> 7))).sum()) / q,
            miss=int((~hit).sum()) / q))
    return out


def turns(fns: dict, sets: dict, reps: int = 10) -> dict:
    """set -> variant -> [ms forward, ms reverse]: each variant's mean
    over ``reps`` runs of each call set after one warm-up run (CUDA
    events), the variants in order, then in reverse."""
    import torch

    names = list(fns)
    times = {k: {v: [] for v in names} for k in sets}
    for v in names + names[::-1]:
        for k, calls in sets.items():
            fn = fns[v]
            fn(calls)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(calls)
            end.record()
            torch.cuda.synchronize()
            times[k][v].append(start.elapsed_time(end) / reps)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=26)
    ap.add_argument("--ansv-log2n", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="another walk.cu with the same C interface, timed "
                    "in the same turns")
    args = ap.parse_args()

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("k8_sweep: no CUDA device", file=sys.stderr)
        return 2
    from psac_tpu_torch.ops import cuda_lib
    from psac_tpu_torch.parallel.mesh import make_mesh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    src = os.path.join(cuda_lib.CSRC_DIR, "walk.cu")
    builds = {tag: start_build(tag, src, defs, "k8")
              for tag, defs in {**variants(), **WINDOW_ONLY}.items()}
    if args.parent:
        builds["parent"] = start_build("parent", args.parent, {}, "k8")
    fns = {"library": through(cuda_lib.lib())}
    fns.update({tag: through(load(tag, *b)) for tag, b in builds.items()})
    print(f"[k8-sweep] {len(builds)} builds and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    mesh = make_mesh(4, ["cuda:0"] * 4)
    sets = call_sets(mesh, args.log2n, args.ansv_log2n)
    mesh.close()
    torch.cuda.synchronize()
    for k, calls in sets.items():
        want = plain(calls)
        for name, fn in fns.items():
            if name in WINDOW_ONLY:
                continue
            for i, (g, w) in enumerate(zip(fn(calls), want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"walks on {k} (call {i})")
        print(f"[k8-sweep] {len(fns) - len(WINDOW_ONLY)} variants == plain "
              f"on {k} ({len(calls)} calls, "
              f"{sum(c[2].shape[0] for c in calls)} queries over "
              f"{calls[0][1][0].numel()} {calls[0][3].dtype} rows)",
              flush=True)
    dist = {k: distances(sets[k], fns["library"](sets[k]))
            for k in ("full", "ansv")}
    for k, ds in dist.items():
        for d in ds:
            print(f"[k8-sweep] {k} {d['field']}: {d['queries']} queries, "
                  f"{d['within_8']:.4f} within 8 entries, "
                  f"{d['within_32']:.4f} within 32, {d['own_row']:.4f} in "
                  f"the own row, {d['miss']:.4f} misses", flush=True)

    times = turns(fns, sets)

    def fmt(row, v):
        return f"{v} {' / '.join(f'{t:.4f}' for t in row[v])}"

    for k, row in times.items():
        mean = {v: sum(t) / len(t) for v, t in row.items()}
        order = sorted((v for v in mean if v not in WINDOW_ONLY),
                       key=mean.get)
        print(f"[k8-sweep] {k}: fastest " + ", ".join(
            fmt(row, v) for v in order[:6]) + "; " + ", ".join(
            fmt(row, v) for v in ["library", *WINDOW_ONLY]
            + (["parent"] if args.parent else [])) + f" ms on {card}",
            flush=True)
    total = {v: sum(sum(times[k][v]) / 2 for k in times) for v in fns}
    order = sorted(total, key=total.get)
    print("[k8-sweep] summed over the call sets: " + ", ".join(
        f"{v} {total[v]:.4f}" for v in order) + f" ms on {card}", flush=True)
    print(card)
    print(json.dumps({"k8_ms": times, "summed_ms": total,
                      "distances": dist,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
