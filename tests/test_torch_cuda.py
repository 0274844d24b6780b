"""The hand-written CUDA kernels against their plain PyTorch versions, and
the port's main path on the GPU against the oracles.  Needs an NVIDIA GPU
(a CUDA kernel has no CPU mode): every test here is marked ``cuda`` and
skips where ``torch.cuda.is_available()`` is false.

This module imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda
"""

import numpy as np
import pytest
import torch

from psac_tpu_torch.ops import nsv_scan, tansv
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     ansv_seq)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _arrays(seed: int):
    rng = np.random.RandomState(seed)
    return {
        "random": rng.randint(0, 9, 1 << 16),
        "runs": np.repeat(rng.randint(0, 5, 1024), 64),
        "decreasing": np.arange(1 << 14, 0, -1),
        "increasing": np.arange(1 << 17),  # stack spills past shared memory
        "st_padding": np.concatenate([np.full(700, -1), [0],
                                      rng.randint(0, 12, 8 * 2048 - 701)]),
    }


def _same(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        assert torch.equal(g.cpu().to(torch.int64), w.cpu().to(torch.int64)), k


@pytest.mark.parametrize("kind", sorted(_arrays(0)))
def test_tile_side_kernel_vs_plain(cuda, kind):
    x = torch.from_numpy(_arrays(1)[kind].astype(np.int32)).to(cuda)
    before = tansv.tile_side.launches
    for xx in (x, x.flip(0)):
        for with_eq in (True, False):
            _same(tansv.tile_side(xx, with_eq),
                  tansv.tile_side_plain(xx, with_eq))
    assert tansv.tile_side.launches == before + 4


@pytest.mark.parametrize("kind", sorted(_arrays(0)))
def test_dual_kernel_vs_plain(cuda, kind):
    x = torch.from_numpy(_arrays(2)[kind].astype(np.int32)).to(cuda)
    for typs in ((FURTHEST_EQ, NEAREST_SM), (NEAREST_EQ, NEAREST_EQ),
                 (NEAREST_SM, FURTHEST_EQ)):
        _same(nsv_scan.nsv_scan_dual(x, x.flip(0), *typs),
              nsv_scan.nsv_scan_dual_plain(x, x.flip(0), *typs))


def test_spine_kernel_vs_plain(cuda):
    x = torch.from_numpy(_arrays(3)["st_padding"].astype(np.int32)).to(cuda)
    kf, vf, kn, vn, ovf = tansv.spine_streams(
        x, tansv.tile_side(x, True)[3], tansv.tile_side(x.flip(0), False)[3])
    assert ovf == 0
    before = nsv_scan.nsv_scan_spine.launches
    _same(nsv_scan.nsv_scan_spine(vf, kf, vn, kn),
          nsv_scan.nsv_scan_spine_plain(vf, kf, vn, kn))
    assert nsv_scan.nsv_scan_spine.launches == before + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2048, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        nsv_scan.nsv_scan_dual(x, x, 0, 0)
    with pytest.raises(ValueError):
        tansv.tile_side(torch.zeros(1000, dtype=torch.int32, device=cuda),
                        True)


def test_ansv_fallback_on_gpu(cuda):
    from psac_tpu_torch.parallel.ansv import ansv_local

    a = np.arange(1 << 14, 0, -1).astype(np.int32)
    before = nsv_scan.nsv_scan_dual.launches
    li, _, ri, _ = ansv_local(torch.from_numpy(a).to(cuda), FURTHEST_EQ,
                              NEAREST_SM)
    assert nsv_scan.nsv_scan_dual.launches == before + 1
    wl, wr = ansv_seq(a, FURTHEST_EQ, NEAREST_SM, nonsv=2**31 - 1)
    np.testing.assert_array_equal(li.cpu().numpy(), wl)
    np.testing.assert_array_equal(ri.cpu().numpy(), wr)


@pytest.mark.parametrize("text", [b"mississippi", b"zyxa", b"abc" * 300])
def test_suffix_tree_on_gpu(cuda, text):
    from psac_tpu_torch import build_suffix_tree, native
    from psac_tpu_torch.ops.alphabet import Alphabet
    from psac_tpu_torch.verify.suffix_tree_oracle import suffix_tree_oracle

    a = Alphabet.from_bytes(text)
    sa = native.suffix_array(text)
    want = suffix_tree_oracle(a.encode(text), sa, native.lcp_array(text, sa),
                              a.sigma)
    np.testing.assert_array_equal(build_suffix_tree(text, cuda), want)


def test_suffix_array_on_gpu(cuda):
    from psac_tpu_torch import build_suffix_array, native
    from psac_tpu_torch.ops.alphabet import rep_dna

    text = rep_dna(1 << 16, unit_len=1024, seed=7, mutations=64)
    res = build_suffix_array(text, cuda)
    sa = native.suffix_array(text)
    np.testing.assert_array_equal(res.sa, sa)
    np.testing.assert_array_equal(res.lcp, native.lcp_array(text, sa))
