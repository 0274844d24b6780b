"""Staging of raw bytes on the device (port of
``psac_tpu/parallel/staging.py``).

A file or an in-memory byte string goes up as raw uint8 bytes, zero-padded
to the padded length N (which depends on the shard count p), and its byte
histogram is counted on the device: bytes are a quarter of int32 codes on
the host-to-device link, and a host ``bincount`` would widen every byte to
int64 first.  On one device (``stage_file_block(path, device)``) the file
is one read and one upload.  On a mesh (``stage_file_block(path, mesh)``)
each shard gets its block of N, and each process reads only its own
shards' byte ranges, so no process holds the whole input; the histogram is
each shard's ``bincount`` summed over the whole mesh (a ``psum``), the
same on every process.

No host copy of the text is made: the caller's bytes (read-only
``bytes`` included) are viewed as a uint8 tensor in place and uploaded
straight into their place in the padded device buffer, whose padding alone
is zeroed.  On one device the span ``psac.stage.copy`` times the view
(near zero) and ``psac.stage.upload`` the buffer and the upload; the
counter ``stage_bytes_direct`` under it counts the bytes uploaded from the
caller's buffer (n a stage; each block's m on a mesh).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from psac_tpu_torch.parallel.collectives import psum
from psac_tpu_torch.parallel.mesh import Mesh, Rep, Sharded, padded_size, \
    run_on
from psac_tpu_torch.utils import timers


def _host_view(buf: np.ndarray) -> torch.Tensor:
    """``buf`` (contiguous uint8) as a CPU tensor over the same memory."""
    with warnings.catch_warnings():
        # a read-only buffer (bytes) gives a non-writable tensor; staging
        # only ever reads it, as the source of one copy
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        return torch.from_numpy(buf)


def _upload(view: torch.Tensor, size: int, device) -> torch.Tensor:
    """The (size,) uint8 buffer on ``device``: ``view``'s m bytes at its
    start, read from the caller's memory, then zeros."""
    m = len(view)
    out = torch.empty(size, dtype=torch.uint8, device=device)
    out[m:].zero_()
    # pageable, straight from the caller's memory: copies through pinned
    # chunks won on a 1-card H100 host but ran 3-10x slower than this on
    # a 4-card one (PERF.md)
    out[:m].copy_(view)
    timers.count("stage_bytes_direct", m)
    return out


def _stage(buf: np.ndarray, device):
    n = len(buf)
    N = padded_size(max(n, 1), 1, multiple=8)
    with timers.span("psac.stage.copy"):
        view = _host_view(buf)
    with timers.span("psac.stage.upload", device):
        xb = _upload(view, N, device)
    return xb, n, N


def _stage_blocks(read_range, n: int, mesh: Mesh):
    """This process's blocks of the (N,) zero-padded bytes of a source of
    n bytes; ``read_range(lo, m)`` supplies the m bytes at offset lo (only
    for this process's shards)."""
    N = padded_size(max(n, 1), mesh.p, multiple=8)
    s = N // mesh.p
    blocks = []
    with timers.span("psac.stage.upload"):
        for r, dev in enumerate(mesh.devices):
            lo = (mesh.first + r) * s
            m = max(0, min(lo + s, n) - lo)
            blocks.append(_upload(_host_view(read_range(lo, m)), s, dev))
    return Sharded(blocks, mesh.first, mesh.p), n, N


def stage_file_block(path: str, where):
    """Stage a file on a device, or block-distributed over a mesh.

    ``where`` a device: one ``np.fromfile`` and one upload.  ``where`` a
    ``Mesh``: each shard's block, each process reading only its own
    shards' byte ranges (zero past the file's end).

    Returns (xb, n, N): the (N,) uint8 tensor (``Sharded`` on a mesh), the
    file size, and the padded length."""
    if isinstance(where, Mesh):
        with open(path, "rb") as f:

            def read_range(lo, m):
                f.seek(lo)
                return np.frombuffer(f.read(m), np.uint8)

            return _stage_blocks(read_range, os.path.getsize(path), where)
    return _stage(np.fromfile(path, dtype=np.uint8), where)


def stage_bytes_block(text, where):
    """Stage an in-memory byte string (bytes, bytearray, memoryview or a
    uint8 array) on a device or over a mesh (each shard's block), read in
    place: no host copy of a contiguous input; returns (xb, n, N) as
    ``stage_file_block``."""
    buf = np.frombuffer(text, np.uint8) \
        if isinstance(text, (bytes, bytearray)) else \
        np.ascontiguousarray(text, np.uint8)
    if isinstance(where, Mesh):
        return _stage_blocks(lambda lo, m: buf[lo:lo + m], len(buf), where)
    return _stage(buf, where)


def _hist(ctx, xb):
    """The (256,) byte histogram of the whole mesh's staged bytes: this
    shard's counts summed over the shards."""
    return Rep(psum(torch.bincount(xb.to(torch.int32), minlength=256)
                    .to(torch.int64), ctx))


def staged_histogram(xb, mesh=None) -> np.ndarray:
    """(256,) int64 byte histogram of staged uint8 bytes, counted on their
    device, or on each shard of ``mesh`` and summed over all of them (the
    zero count includes the padding)."""
    hist = run_on(mesh, _hist, xb).cpu()
    timers.readback()
    return hist.numpy().astype(np.int64)
