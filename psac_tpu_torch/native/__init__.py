"""ctypes bindings to the native sequential oracle (SA-IS + Kasai).

A copy of the JAX package's C++ source (``sais.cpp``), built with ``g++``
at first use into ``psac_tpu_torch/_build/`` — the ground truth the port is
held against on machines that have no JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "sais.cpp")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "libpsac_native.so")
_lib = None


def build() -> None:
    """Compile the oracle if the library is missing or stale."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC,
                    "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, _SO)


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(_SO)
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.sais_u8.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.sais_u8.restype = None
        lib.kasai_u8.argtypes = [u8p, ctypes.c_int64, i64p, i64p]
        lib.kasai_u8.restype = None
        _lib = lib
    return _lib


def _as_u8(text) -> np.ndarray:
    if isinstance(text, (bytes, bytearray)):
        return np.frombuffer(text, dtype=np.uint8)
    return np.ascontiguousarray(text, np.uint8)


def suffix_array(text) -> np.ndarray:
    """SA-IS suffix array (native, O(n))."""
    t = _as_u8(text)
    sa = np.empty(len(t), np.int64)
    if len(t):
        _load().sais_u8(t, len(t), sa)
    return sa


def lcp_array(text, sa: np.ndarray) -> np.ndarray:
    """Kasai LCP from SA (native, O(n)); lcp[0] = 0."""
    t = _as_u8(text)
    lcp = np.zeros(len(t), np.int64)
    if len(t):
        _load().kasai_u8(t, len(t), np.ascontiguousarray(sa, np.int64), lcp)
    return lcp
