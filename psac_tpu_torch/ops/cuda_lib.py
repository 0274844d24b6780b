"""Build and load the port's hand-written CUDA kernels.

Every ``psac_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use into ``psac_tpu_torch/_build/``
(ignored by git) and is redone when a source is newer than the library.
Nothing here runs at import time, so the package imports on machines
without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libpsac_kernels.so")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C signatures (restype int = cudaGetLastError() after the launch)
_SIGNATURES = {
    "psac_nsv_spine": [_P] * 10 + [_I64, _P],
    "psac_nsv_dual": [_P] * 7 + [_I64, _I32, _I32, _P],
    "psac_nsv_left": [_P] * 4 + [_I64, _I32, _P],
    "psac_tansv_tile": [_P] * 8 + [_I64, _I32, _P],
    "psac_block_psv_i32": [_P] * 3 + [_I64, _I32, _P],
    "psac_block_psv_i64": [_P] * 3 + [_I64, _I32, _P],
    "psac_rmq_resolve_i32": [_P] * 7 + [_I64, _I64, _I32, _I64, _I32, _I32,
                                        _I64, _P],
    "psac_rmq_resolve_i64": [_P] * 7 + [_I64, _I64, _I32, _I64, _I32, _I32,
                                        _I64, _P],
    "psac_rmq_mins_i32": [_P] * 6 + [_I64, _I64, _I32, _I64, _P],
    "psac_rmq_mins_i64": [_P] * 6 + [_I64, _I64, _I32, _I64, _P],
    "psac_blind_search_i32": [_P] * 13 + [_I64, _I32, _I64, _I64, _I32, _I32,
                                          _I64, _P],
    "psac_blind_search_i64": [_P] * 13 + [_I64, _I32, _I64, _I64, _I32, _I32,
                                          _I64, _P],
    "psac_blind_search_shape": [_I64, _I32, _P],
    "psac_walk_prev_lt_i32": [_P, _P, _I32] + [_P] * 3 + [_I64, _I32, _P],
    "psac_walk_prev_lt_i64": [_P, _P, _I32] + [_P] * 3 + [_I64, _I32, _P],
    "psac_walk_next_leq_i32": [_P, _P, _I32] + [_P] * 3 + [_I64, _I32, _P],
    "psac_walk_next_leq_i64": [_P, _P, _I32] + [_P] * 3 + [_I64, _I32, _P],
    "psac_kmer_pack_i32": [_P] * 6 + [_I64] + [_I32] * 5 + [_I64, _I64, _P],
    "psac_kmer_pack_i64": [_P] * 6 + [_I64] + [_I32] * 5 + [_I64, _I64, _P],
    "psac_kmer_heads_i32": [_P] * 8 + [_I64] + [_I32] * 5
                           + [_I64, _I64, _I64, _P],
    "psac_kmer_heads_i64": [_P] * 8 + [_I64] + [_I32] * 5
                           + [_I64, _I64, _I64, _P],
    "psac_pattern_pack": [_P] * 6 + [_I64, _I32, _P],
    "psac_route_bucket_i32": [_P, _P, _I64, _I32, _I64] + [_P] * 5,
    "psac_route_bucket_i64": [_P, _P, _I64, _I32, _I64] + [_P] * 5,
}

_lib = None
# the first use may come from several shard threads of a mesh at once:
# one builds and loads, the others wait
_LIB_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()
#: ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG = ""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of psac_tpu_torch cannot be built")


def build() -> float:
    """Compile the kernels if the library is missing or stale; returns the
    seconds spent (0.0 when up to date)."""
    with _LIB_LOCK:
        return _build()


def _build() -> float:
    global BUILD_LOG
    srcs = sources()
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= max(
            os.path.getmtime(p) for p in srcs):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(p) + f".{tag}.o")
            for p in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", obj, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(srcs, objs)]
    logs = []
    for src, proc in zip(srcs, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                               f"({proc.returncode}):\n{err}")
        logs.append(err)
    tmp = f"{_SO}.{tag}"
    res = subprocess.run([nvcc, "-shared", "-o", tmp] + objs,
                         capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, _SO)
    BUILD_LOG = "".join(logs)
    return time.perf_counter() - t0


def lib():
    """The loaded kernel library (built on first use, once)."""
    global _lib
    if _lib is None:
        with _LIB_LOCK:
            if _lib is None:
                build()
                so = ctypes.CDLL(_SO)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = so
    return _lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel
    wrapper; safe from the shard threads of a mesh."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def launch(name: str, *args, device: torch.device) -> None:
    """Call C launcher ``name`` with ``args`` on ``device`` (the device of
    the launch's tensors), plus that device's current stream; raise if the
    launch reported a CUDA error.  The CUDA current device is per thread,
    so the launch does not rely on the caller's."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def level_sizes(s: int, width: int) -> list[int]:
    """Entries of each level above level 0 of a minima hierarchy over ``s``
    values with ``width``-entry groups, built until a level has at most
    ``width`` entries: the scratch of K5 (``csrc/bansv.cu``) and of K1, K2
    and K3 (``csrc/nsv_scan.cu``)."""
    sizes = []
    n = s
    while n > width:
        n = -(-n // width)
        sizes.append(n)
    return sizes


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 1-D CUDA tensor of
    ``dtype`` and of the first one's shape, on one device."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != t0.device:
            raise ValueError(f"{name}: expected CUDA tensors on one device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.shape != t0.shape or t.dim() != 1:
            raise ValueError(f"{name}: expected equal 1-D shapes")


def check_cuda_int32(name: str, *tensors: torch.Tensor) -> None:
    """``check_cuda`` for int32 tensors."""
    check_cuda(name, torch.int32, *tensors)
