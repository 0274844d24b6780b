"""Staging reads the caller's bytes in place (``parallel/staging.py``).

Every input kind (read-only ``bytes``, ``bytearray``, ``memoryview``,
read-only and writable uint8 arrays, a file) on one device and on thread
meshes of 2 and 4 shards must give the copy-and-pad of the text, zero
padding, leave the caller's buffer as it was, let no warning out, and
count every byte under ``stage_bytes_direct``."""

import hashlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from psac_tpu_torch.parallel.mesh import make_mesh, padded_size
from psac_tpu_torch.parallel.staging import stage_bytes_block, \
    stage_file_block
from psac_tpu_torch.utils import timers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(n: int) -> bytes:
    return np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()


def _source(kind: str, text: bytes, tmp_path):
    if kind == "bytes":
        return text
    if kind == "bytearray":
        return bytearray(text)
    if kind == "memoryview":
        return memoryview(text)
    if kind == "readonly_array":
        return np.frombuffer(text, np.uint8)
    if kind == "array":
        return np.frombuffer(text, np.uint8).copy()
    path = tmp_path / "text.bin"
    path.write_bytes(text)
    return str(path)


def _content(kind: str, src) -> bytes:
    if kind == "file":
        with open(src, "rb") as f:
            return f.read()
    return bytes(src)


@pytest.mark.parametrize("n", [0, 1, 1001, 4099])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview",
                                  "readonly_array", "array", "file"])
def test_stage_in_place(kind, p, n, tmp_path, monkeypatch):
    text = _text(n)
    src = _source(kind, text, tmp_path)
    digest = hashlib.sha256(_content(kind, src)).hexdigest()
    where = "cpu" if p == 1 else make_mesh(p, devices=["cpu"] * p)
    monkeypatch.setenv("PSAC_TIMER", "1")
    timers.clear()
    stage = stage_file_block if kind == "file" else stage_bytes_block
    with warnings.catch_warnings(), timers.call("psac.stage"):
        warnings.simplefilter("error")
        xb, got_n, N = stage(src, where)
    counted = sum(r.counts.get("stage_bytes_direct", 0)
                  for r in timers.records())
    timers.clear()
    assert (got_n, N) == (n, padded_size(max(n, 1), p, multiple=8))
    flat = xb if p == 1 else torch.cat(xb.shards)
    assert flat.dtype == torch.uint8 and flat.shape == (N,)
    want = np.zeros(N, np.uint8)
    want[:n] = np.frombuffer(text, np.uint8)
    np.testing.assert_array_equal(flat.numpy(), want)
    assert not flat[n:].any()
    assert hashlib.sha256(_content(kind, src)).hexdigest() == digest
    assert counted == n
    if kind in ("bytearray", "array") and n:
        src[0] ^= 0xFF  # the staged buffer is its own memory
        assert flat[0].item() == text[0]


def test_fresh_process_warns_nothing():
    """PyTorch warns once a process on a non-writable array, so only a
    fresh process shows that staging read-only bytes lets nothing out."""
    code = ("from psac_tpu_torch.parallel.staging import stage_bytes_block\n"
            "xb, n, N = stage_bytes_block(bytes(range(1, 200)), 'cpu')\n"
            "assert n == 199 and xb[:n].tolist() == list(range(1, 200))\n")
    out = subprocess.run([sys.executable, "-W", "error", "-c", code],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stderr == ""
