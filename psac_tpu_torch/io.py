"""Persistence of finished artifacts (port of ``psac_tpu/io.py``).

Artifacts are plain little-endian uint64 flat files with the reference's
extensions (``.sa64``, ``.lcp64``, ``.lc64``) and the alphabet as its raw
byte set (``.alpha``), byte-identical to what the JAX package writes, so
either package reads what the other wrote.  ``read_suffix_array`` reads
``.sa64``, ``.lcp64`` and ``.alpha``; like the JAX package's, it does not
read ``.lc64`` back.

The per-shard forms (``write_shards_u64``, ``write_suffix_array_
distributed``, ``stage_u64_front_padded``, ``read_suffix_array_
distributed``) move only the rows of the shards that a process holds: on a
mesh that spans processes each process ``pwrite``s its shards' real rows
at their file offsets (disjoint ranges, so they need no order among the
processes; every process sets the file's length, which is idempotent) and
reads back only its shards' byte ranges, so no process holds a whole
array.  They write the same bytes as ``write_suffix_array``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from psac_tpu_torch import config as cfg_mod
from psac_tpu_torch.ops.alphabet import Alphabet
from psac_tpu_torch.ops.bitops import ceillog2
from psac_tpu_torch.parallel.dist import process_index
from psac_tpu_torch.parallel.mesh import Mesh, Sharded, padded_size


def write_u64(path: str, arr) -> None:
    np.asarray(arr, dtype="<u8").tofile(path)


def read_u64(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<u8").astype(np.int64)


def write_alphabet(prefix: str, alphabet) -> None:
    with open(prefix + ".alpha", "wb") as f:
        f.write(alphabet.chars.tobytes())


def write_suffix_array(prefix: str, res) -> None:
    """Write ``<prefix>.sa64`` (+ ``.lcp64``/``.lc64`` when present) and
    ``<prefix>.alpha``."""
    write_u64(prefix + ".sa64", res.sa)
    if getattr(res, "lcp", None) is not None:
        write_u64(prefix + ".lcp64", res.lcp)
    lc = getattr(res, "lc", None)
    if lc is not None:
        write_u64(prefix + ".lc64", lc)
    write_alphabet(prefix, res.alphabet)


def read_alphabet(prefix: str) -> Alphabet:
    with open(prefix + ".alpha", "rb") as f:
        chars = np.frombuffer(f.read(), np.uint8)
    mapping = np.zeros(256, np.uint8)
    mapping[chars] = np.arange(1, len(chars) + 1, dtype=np.uint8)
    inverse = np.zeros(len(chars) + 1, np.uint8)
    inverse[1:] = chars
    return Alphabet(chars=chars.copy(), mapping=mapping, inverse=inverse,
                    bits_per_char=ceillog2(len(chars) + 1))


def read_suffix_array(prefix: str):
    """Reload a persisted SA(+LCP) artifact as a host ``SuffixArray``."""
    from psac_tpu_torch.models.suffix_array import SuffixArray

    sa = read_u64(prefix + ".sa64")
    lcp = None
    if os.path.exists(prefix + ".lcp64"):
        lcp = read_u64(prefix + ".lcp64")
    alpha = read_alphabet(prefix) if os.path.exists(prefix + ".alpha") else None
    return SuffixArray(sa=sa, lcp=lcp, alphabet=alpha, n=len(sa))


def _blocks(arr) -> tuple:
    """(global length, [(first global row, local block)]) of a ``Sharded``
    array's local blocks, or of a tensor on one device."""
    if isinstance(arr, Sharded):
        s = arr.shards[0].shape[0]
        return s * arr.p, [((arr.first + r) * s, t)
                           for r, t in enumerate(arr.shards)]
    return arr.shape[0], [(0, arr)]


def pwrite_rows(fd: int, rows: np.ndarray, file_row: int) -> None:
    """Write ``rows`` as ``<u8`` at row ``file_row`` of an open file."""
    os.pwrite(fd, np.ascontiguousarray(rows, dtype="<u8").tobytes(),
              8 * file_row)


def write_shards_u64(path: str, arr, n: int, *, front_pad: bool = True,
                     fix_first_zero: bool = False) -> None:
    """Write the local blocks of a block-sharded (N,) array (``Sharded``,
    or a tensor on one device) into a flat ``<u8`` file of n rows.
    ``front_pad``: the first N - n global rows are padding (the
    construction layout), so global row g is file row g - (N - n).
    ``fix_first_zero`` zeroes file row 0 (the LCP's first row, as
    ``materialize`` does)."""
    N, blocks = _blocks(arr)
    off = N - n if front_pad else 0
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        os.truncate(fd, 8 * n)
        for lo, t in blocks:
            start, hi = max(lo, off), min(lo + t.shape[0], off + n)
            if start >= hi:
                continue
            seg = t[start - lo:hi - lo].cpu().numpy()
            if fix_first_zero and start == off:
                seg = seg.copy()
                seg[0] = 0
            pwrite_rows(fd, seg, start - off)
    finally:
        os.close(fd)


def write_suffix_array_distributed(prefix: str, dsa) -> None:
    """Write a device-resident SA(+LCP) (``DeviceSuffixArray``) as
    ``<prefix>.sa64`` / ``.lcp64``, each process its own shards' rows;
    process 0 writes ``.alpha``.  Call ``parallel.dist.barrier`` before
    reading the files on another process."""
    write_shards_u64(prefix + ".sa64", dsa.sa, dsa.n)
    if dsa.lcp is not None:
        write_shards_u64(prefix + ".lcp64", dsa.lcp, dsa.n,
                         fix_first_zero=True)
    if process_index() == 0:
        write_alphabet(prefix, dsa.alphabet)


def stage_u64_front_padded(path: str, where, dtype=torch.int64):
    """Stage a flat ``<u8`` artifact of n rows in the construction layout
    (global row g = file row g - (N - n), zero above): over a mesh of p >
    1 shards (``where`` a ``Mesh``, N = padded_size(n, p)) each process
    reads only its own shards' byte ranges into ``Sharded`` blocks; on a
    device (None: the CUDA card), or a mesh of one shard, one (N,)
    tensor.  Returns (arr, n, N)."""
    n = os.path.getsize(path) // 8
    mesh = where if isinstance(where, Mesh) and where.p > 1 else None
    if mesh is None:
        where = where.devices[0] if isinstance(where, Mesh) else \
            cfg_mod.resolve_device(where)
    p = 1 if mesh is None else mesh.p
    N = padded_size(max(n, 1), p)
    off, s = N - n, N // p
    firsts = [0] if mesh is None else \
        [(mesh.first + r) * s for r in range(mesh.local)]
    devices = [where] if mesh is None else mesh.devices
    np_dt = torch.empty(0, dtype=dtype).numpy().dtype
    blocks = []
    with open(path, "rb") as f:
        for lo, dev in zip(firsts, devices):
            out = np.zeros(s, np_dt)
            a = max(lo, off)
            if a < lo + s:
                f.seek(8 * (a - off))
                out[a - lo:] = np.frombuffer(f.read(8 * (lo + s - a)),
                                             "<u8").astype(np_dt)
            blocks.append(torch.from_numpy(out).to(dev))
    if mesh is None:
        return blocks[0], n, N
    return Sharded(blocks, mesh.first, mesh.p), n, N


def read_suffix_array_distributed(prefix: str, mesh,
                                  force_int64: bool = False):
    """Reload a persisted SA(+LCP) as a ``DeviceSuffixArray`` over
    ``mesh`` (any p, whatever p wrote it; a device, or a mesh of one
    shard, gives it on that device), each process staging only its own
    shards' rows, in the index dtype of the padded length (int64 with
    ``force_int64``).  The padding rows are zero."""
    from psac_tpu_torch.models.suffix_array import DeviceSuffixArray

    n = os.path.getsize(prefix + ".sa64") // 8
    multi = isinstance(mesh, Mesh) and mesh.p > 1
    N = padded_size(max(n, 1), mesh.p if multi else 1)
    idt = torch.int64 if force_int64 else cfg_mod.index_dtype(N)
    sa, n, N = stage_u64_front_padded(prefix + ".sa64", mesh, idt)
    lcp = None
    if os.path.exists(prefix + ".lcp64"):
        lcp, _, _ = stage_u64_front_padded(prefix + ".lcp64", mesh, idt)
    alpha = read_alphabet(prefix) if os.path.exists(prefix + ".alpha") \
        else None
    return DeviceSuffixArray(sa=sa, lcp=lcp, isa=None, alphabet=alpha, n=n,
                             N=N, mesh=mesh if multi else None)
