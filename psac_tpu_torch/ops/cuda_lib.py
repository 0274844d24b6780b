"""Build and load the port's hand-written CUDA kernels.

Every ``psac_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
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
    "psac_nsv_spine": [_P] * 11 + [_I64, _P],
    "psac_nsv_dual": [_P] * 8 + [_I64, _I32, _I32, _P],
    "psac_tansv_tile": [_P] * 8 + [_I64, _I32, _P],
}

_lib = None
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
    global BUILD_LOG
    srcs = sources()
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= max(
            os.path.getmtime(p) for p in srcs):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp] + srcs
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, _SO)
    BUILD_LOG = res.stderr
    return time.perf_counter() - t0


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        build()
        so = ctypes.CDLL(_SO)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def launch(name: str, *args) -> None:
    """Call C launcher ``name`` with ``args`` plus the current stream;
    raise if the launch reported a CUDA error."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check_cuda_int32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 CUDA tensor of the
    first one's shape, on one device."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != t0.device:
            raise ValueError(f"{name}: expected CUDA tensors on one device")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.shape != t0.shape or t.dim() != 1:
            raise ValueError(f"{name}: expected equal 1-D shapes")
