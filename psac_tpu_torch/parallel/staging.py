"""Staging of raw bytes on the device (port of
``psac_tpu/parallel/staging.py``, one read).

A file or an in-memory byte string goes up as raw uint8 bytes, zero-padded
to the padded length N (which depends on the shard count p), and its byte
histogram is counted on the device: bytes are a quarter of int32 codes on
the host-to-device link, and a host ``bincount`` would widen every byte to
int64 first.  With one device the JAX package's per-shard callbacks are one
upload; on a mesh the bytes are staged on the host and split over the
shards (``models.suffix_array.encode_and_shard``).
"""

from __future__ import annotations

import numpy as np
import torch

from psac_tpu_torch.parallel.mesh import padded_size


def _stage(buf: np.ndarray, device, p: int = 1):
    n = len(buf)
    N = padded_size(max(n, 1), p, multiple=8)
    xb = torch.zeros(N, dtype=torch.uint8, device=device)
    if n:
        # torch.from_numpy wants a writable array (bytes give a read-only one)
        host = buf if buf.flags.writeable else buf.copy()
        xb[:n] = torch.from_numpy(host).to(device)
    return xb, n, N


def stage_file_block(path: str, device, p: int = 1):
    """Stage a file on ``device``: one ``np.fromfile``, one upload, padded
    for a mesh of ``p`` shards.

    Returns (xb, n, N): the (N,) uint8 tensor (zero past the file's end),
    the file size, and the padded length."""
    return _stage(np.fromfile(path, dtype=np.uint8), device, p)


def stage_bytes_block(text, device, p: int = 1):
    """Stage an in-memory byte string (bytes or a uint8 array) on
    ``device``; returns (xb, n, N) as ``stage_file_block``."""
    buf = np.frombuffer(bytes(text), np.uint8) \
        if isinstance(text, (bytes, bytearray)) else np.asarray(text, np.uint8)
    return _stage(buf, device, p)


def staged_histogram(xb: torch.Tensor) -> np.ndarray:
    """(256,) int64 byte histogram of a staged uint8 tensor, counted on its
    device (the zero count includes the padding)."""
    return torch.bincount(xb.to(torch.int32), minlength=256).cpu().numpy() \
        .astype(np.int64)
