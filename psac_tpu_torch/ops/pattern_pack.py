"""The DESA's pattern encoding, K11 (replaces the host's numpy packing of
``psac_tpu/models/desa.py::DESA.encode_patterns``).

A query batch arrives as the patterns' bytes end to end (``flat``) and the
(B + 1,) int64 offsets of each pattern's first byte and of the end
(``offs``).  ``pattern_pack`` returns the padded (B, Lmax) int32 code
matrix (the alphabet's code of each byte, 0 past each length), the (B,)
int32 lengths and the (B,) bool bad flags (an empty pattern, or a byte
outside the alphabet: code 0).  Given CUDA tensors it launches the
hand-written kernel (``psac_tpu_torch/csrc/pattern_pack.cu``) or raises;
given CPU tensors it runs ``pattern_pack_plain``, with the same outputs.
"""

from __future__ import annotations

import torch

from psac_tpu_torch.ops import cuda_lib


def pattern_pack_plain(flat: torch.Tensor, offs: torch.Tensor,
                       mapping: torch.Tensor, Lmax: int):
    """Plain version of K11: row i holds ``mapping[flat[offs[i] + j]]`` for
    j < offs[i + 1] - offs[i], 0 from there to ``Lmax``; (mat, lens,
    bad)."""
    starts = offs[:-1]
    lens = offs[1:] - starts
    cols = torch.arange(Lmax, device=flat.device)
    live = cols < lens[:, None]
    # a row's columns past its length read the zero appended to the bytes
    src = torch.cat([flat, flat.new_zeros(1)])
    pos = torch.where(live, starts[:, None] + cols, flat.shape[0])
    mat = torch.where(live, mapping.to(torch.int32)[src[pos].long()], 0)
    bad = (lens == 0) | (live & (mat == 0)).any(1)
    return mat, lens.to(torch.int32), bad


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype} tensor "
                         f"on {device}")


def pattern_pack(flat: torch.Tensor, offs: torch.Tensor,
                 mapping: torch.Tensor, Lmax: int):
    """K11: see ``pattern_pack_plain`` for the contract.  ``Lmax`` is a
    power of two, at least 2 and at least every length; ``offs`` lies
    within ``flat`` (the kernel reads what the offsets say)."""
    if flat.device.type == "cpu":
        return pattern_pack_plain(flat, offs, mapping, Lmax)
    name = "pattern_pack"
    if Lmax < 2 or Lmax & (Lmax - 1) or Lmax >= 2**31:
        raise ValueError(f"{name}: Lmax must be a power of two from 2 to "
                         f"2^30, got {Lmax}")
    dev = flat.device
    _check(name, flat, torch.uint8, dev)
    _check(name, offs, torch.int64, dev)
    _check(name, mapping, torch.uint8, dev)
    if mapping.shape[0] != 256 or offs.shape[0] < 1:
        raise ValueError(f"{name}: expected a (256,) byte table and (B + 1,) "
                         "offsets")
    B = offs.shape[0] - 1
    mat = torch.empty((B, Lmax), dtype=torch.int32, device=dev)
    lens = torch.empty(B, dtype=torch.int32, device=dev)
    bad = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return mat, lens, bad
    cuda_lib.launch("psac_pattern_pack", flat.data_ptr(), offs.data_ptr(),
                    mapping.data_ptr(), mat.data_ptr(), lens.data_ptr(),
                    bad.data_ptr(), B, Lmax, device=dev)
    cuda_lib.count_launch(pattern_pack)
    return mat, lens, bad


pattern_pack.launches = 0
