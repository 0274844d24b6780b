"""Time K5 (``csrc/bansv.cu``, the previous-smaller pass) at each tile
width and block size it takes, on one NVIDIA GPU.

The kernel's tile (elements per tile, the window being two tiles) and its
threads per block are fixed when it is compiled (``PSAC_K5_TILE``, 256 by
default; ``PSAC_K5_THREADS``, the tile by default, so one element per
thread; 128 or 64 give a thread two or four elements of each tile).  This
script compiles ``bansv.cu`` once for each (tile, threads) of ``VARIANTS``
into ``psac_tpu_torch/_build/`` (one ``nvcc`` each, all started
together), holds each against the plain version on the inputs below, and
times them in turns (the variants in order, then in reverse; CUDA-event
means over 10 launches after a warm-up; ``--against`` adds other
``bansv.cu`` files to the turns): the LCP of 2^26 random DNA (the DESA's
TLDT build), 2^24 random values in [0, 2^16) (the public ANSV), the 2^24
decreasing array (every element climbs the minima hierarchy), the 2^24
increasing array (no element leaves its window, and no lifting step
skips) and 2^22 int64 values.  It prints one JSON line and,
before it, the card's name and power limit.

Run from the repository root:  python3 -m psac_tpu_torch.tools.k5_tile_sweep
(``--log2n`` sets the LCP's length.)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

# (tile, threads per block)
VARIANTS = ((256, 256), (256, 128), (256, 64), (512, 256), (1024, 256))


def start_build(tag: str, src: str, defs: dict) -> tuple:
    """Start compiling ``src`` (a ``bansv.cu``) with the macros ``defs``
    into ``_build/libpsac_k5_<tag>.so``; returns (process, path)."""
    from psac_tpu_torch.ops import cuda_lib

    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(cuda_lib.BUILD_DIR, f"libpsac_k5_{tag}.so")
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared"]
        + [f"-D{k}={v}" for k, v in defs.items()] + ["-o", so, src])
    return proc, so


def load(proc, so: str) -> ctypes.CDLL:
    """The library of a build started by ``start_build``."""
    from psac_tpu_torch.ops import cuda_lib

    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {so}")
    lib = ctypes.CDLL(so)
    for name in ("psac_block_psv_i32", "psac_block_psv_i64"):
        fn = getattr(lib, name)
        fn.argtypes = cuda_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def psv(lib, x, strict: bool):
    """``ops.bansv.block_psv`` through the library ``lib``."""
    import torch

    from psac_tpu_torch.ops import cuda_lib
    from psac_tpu_torch.ops.bansv import KERNEL_BLOCK

    s = x.shape[0]
    out = torch.empty(s, dtype=torch.int32, device=x.device)
    scratch = torch.empty(max(1, sum(cuda_lib.level_sizes(s, KERNEL_BLOCK))),
                          dtype=x.dtype, device=x.device)
    name = "psac_block_psv_i32" if x.dtype == torch.int32 else \
        "psac_block_psv_i64"
    rc = getattr(lib, name)(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                            s, int(strict),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=26)
    ap.add_argument("--against", action="append", default=[],
                    help="another bansv.cu (e.g. an earlier commit's, "
                    "unpacked under scratch/), timed in the same turns; "
                    "may be repeated")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k5_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from psac_tpu_torch import native
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.ops.bansv import block_psv_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    text = rand_dna(1 << args.log2n, seed=42)
    lcp = native.lcp_array(text, native.suffix_array(text))
    rng = np.random.RandomState(48)
    inputs = {
        f"2^{args.log2n} LCP": lcp.astype(np.int32),
        "2^24 random int32": rng.randint(0, 1 << 16, 1 << 24).astype(np.int32),
        "2^24 decreasing int32": np.arange(1 << 24, 0, -1).astype(np.int32),
        "2^24 increasing int32": np.arange(1 << 24).astype(np.int32),
        "2^22 int64": rng.randint(0, 1 << 16, 1 << 22).astype(np.int64) << 33,
    }
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    from psac_tpu_torch.ops import cuda_lib

    src = os.path.join(cuda_lib.CSRC_DIR, "bansv.cu")
    builds = {f"tile {t} x {n}": start_build(
        f"t{t}x{n}", src, {"PSAC_K5_TILE": t, "PSAC_K5_THREADS": n})
        for t, n in VARIANTS}
    for n, path in enumerate(args.against):
        builds[path] = start_build(f"against{n}", path, {})
    libs = {k: load(*b) for k, b in builds.items()}
    for label, x in inputs.items():
        for strict in (True, False):
            want = block_psv_plain(x, strict)
            for t, lib in libs.items():
                if not torch.equal(psv(lib, x, strict), want):
                    raise AssertionError(f"{t} differs from the plain "
                                         f"version on {label}")
    names = list(libs)
    times = {label: {t: [] for t in names} for label in inputs}
    for t in names + names[::-1]:
        for label, x in inputs.items():
            fn = lambda: psv(libs[t], x, True)  # noqa: E731
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[label][t].append(start.elapsed_time(end) / 10)
    for label, row in times.items():
        print(f"[k5-tile] {label}, strict: " + ", ".join(
            f"{t} {' / '.join(f'{v:.4f}' for v in row[t])} ms"
            for t in names) + f" on {card}", flush=True)
    print(card)
    print(json.dumps({"k5_ms": times,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
