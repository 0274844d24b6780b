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
"""

from __future__ import annotations

import os

import numpy as np
import torch

from psac_tpu_torch.parallel.collectives import psum
from psac_tpu_torch.parallel.mesh import Mesh, Rep, Sharded, padded_size, \
    run_on


def _stage(buf: np.ndarray, device):
    n = len(buf)
    N = padded_size(max(n, 1), 1, multiple=8)
    xb = torch.zeros(N, dtype=torch.uint8, device=device)
    if n:
        # torch.from_numpy wants a writable array (bytes give a read-only one)
        host = buf if buf.flags.writeable else buf.copy()
        xb[:n] = torch.from_numpy(host).to(device)
    return xb, n, N


def _stage_blocks(read_range, n: int, mesh: Mesh):
    """This process's blocks of the (N,) zero-padded bytes of a source of
    n bytes; ``read_range(lo, m)`` supplies the m bytes at offset lo (only
    for this process's shards)."""
    N = padded_size(max(n, 1), mesh.p, multiple=8)
    s = N // mesh.p
    blocks = []
    for r, dev in enumerate(mesh.devices):
        lo = (mesh.first + r) * s
        out = np.zeros(s, np.uint8)
        m = max(0, min(lo + s, n) - lo)
        if m:
            out[:m] = read_range(lo, m)
        blocks.append(torch.from_numpy(out).to(dev))
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
    """Stage an in-memory byte string (bytes or a uint8 array) on a device
    or over a mesh (each shard's block, with no padded host copy of the
    whole); returns (xb, n, N) as ``stage_file_block``."""
    buf = np.frombuffer(bytes(text), np.uint8) \
        if isinstance(text, (bytes, bytearray)) else np.asarray(text, np.uint8)
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
    return run_on(mesh, _hist, xb).cpu().numpy().astype(np.int64)
