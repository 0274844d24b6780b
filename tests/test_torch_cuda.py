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

from psac_tpu_torch.ops import bansv, nsv_scan, rmq, tansv
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     ansv_seq)
from psac_tpu_torch.verify import cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _arrays(seed: int):
    rng = np.random.RandomState(seed)
    saw = 1024  # K2/K3's tile: every query of the sawtooth crosses one
    i = np.arange(1 << 15)
    return {
        "random": rng.randint(0, 9, 1 << 16),
        "runs": np.repeat(rng.randint(0, 5, 1024), 64),
        "decreasing": np.arange(1 << 14, 0, -1),
        # past two levels of K2/K3's 32-wide minima hierarchy
        "decreasing_deep": np.arange(1 << 17, 0, -1),
        "increasing": np.arange(1 << 17),
        "all_equal": np.full(1 << 15, 3),
        "sawtooth": i // saw * saw + saw - 1 - i % saw,
        # the public ansv's padding, as K2's reversed stream sees it
        "max_lead": np.concatenate([np.full(5000, 2**31 - 1),
                                    rng.randint(0, 4, 3 * 2048 - 5000)]),
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
    before = nsv_scan.nsv_scan_dual.launches
    for typs in ((FURTHEST_EQ, NEAREST_SM), (NEAREST_EQ, NEAREST_EQ),
                 (NEAREST_SM, FURTHEST_EQ), (FURTHEST_EQ, FURTHEST_EQ)):
        _same(nsv_scan.nsv_scan_dual(x, x.flip(0), *typs),
              nsv_scan.nsv_scan_dual_plain(x, x.flip(0), *typs))
    # the two streams are independent inputs
    y = x.roll(777)
    _same(nsv_scan.nsv_scan_dual(x, y, FURTHEST_EQ, NEAREST_SM),
          nsv_scan.nsv_scan_dual_plain(x, y, FURTHEST_EQ, NEAREST_SM))
    assert nsv_scan.nsv_scan_dual.launches == before + 5


G = nsv_scan.GROUP


@pytest.mark.parametrize("n", [1, G - 1, G, G + 1, G**2 - 1, G**2 + 1,
                               G**3 - 1, G**3 + 1, G**4 + 1])
def test_block_scans_around_group_powers(cuda, n):
    """K2 and K3 at lengths around the levels of their hierarchy."""
    rng = np.random.RandomState(n)
    for a in (rng.randint(0, 7, n), np.arange(n, 0, -1)):
        x = torch.from_numpy(a.astype(np.int32)).to(cuda)
        before = (nsv_scan.nsv_scan_left.launches,
                  nsv_scan.nsv_scan_dual.launches)
        for typ in (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ):
            _same(nsv_scan.nsv_scan_left(x, typ),
                  nsv_scan.nsv_scan_left_plain(x, typ))
        _same(nsv_scan.nsv_scan_dual(x, x.flip(0), FURTHEST_EQ, NEAREST_EQ),
              nsv_scan.nsv_scan_dual_plain(x, x.flip(0), FURTHEST_EQ,
                                           NEAREST_EQ))
        assert (nsv_scan.nsv_scan_left.launches,
                nsv_scan.nsv_scan_dual.launches) == (before[0] + 3,
                                                     before[1] + 1)


@pytest.mark.parametrize("kind", ["one_value", "decreasing", "increasing",
                                  "negative"])
def test_tile_side_kernel_on_whole_tiles(cuda, kind):
    """K4's extreme tiles: one value (every element has an equal, none a
    PSV), strictly decreasing (every element a chain member), strictly
    increasing, and the suffix tree's negative padding values."""
    t = tansv.T
    a = {"one_value": np.full(8 * t, 3),
         "decreasing": np.tile(np.arange(t, 0, -1), 8),
         "increasing": np.tile(np.arange(t), 8),
         "negative": np.concatenate([np.full(700, -1), [0],
                                     np.arange(8 * t - 701) % 5 - 2])}[kind]
    x = torch.from_numpy(a.astype(np.int32)).to(cuda)
    for xx in (x, x.flip(0)):
        for with_eq in (True, False):
            _same(tansv.tile_side(xx, with_eq),
                  tansv.tile_side_plain(xx, with_eq))


def _padded(a, cuda):
    pad = -len(a) % nsv_scan.CHUNK
    return torch.from_numpy(np.concatenate(
        [a, np.full(pad, 2**31 - 1)]).astype(np.int32)).to(cuda)


@pytest.mark.parametrize("kind", sorted(_arrays(0)))
def test_spine_kernel_on_spines_of_arrays(cuda, kind):
    """K1 on the spine streams of each array (the tile phase's plain
    version, no capacity), against its plain version."""
    x = _padded(_arrays(6)[kind], cuda)
    kf, vf, kn, vn = tansv.pack_spines(
        x, tansv.tile_side_plain(x, True)[3],
        tansv.tile_side_plain(x.flip(0), False)[3])
    before = nsv_scan.nsv_scan_spine.launches
    _same(nsv_scan.nsv_scan_spine(vf, kf, vn, kn),
          nsv_scan.nsv_scan_spine_plain(vf, kf, vn, kn))
    assert nsv_scan.nsv_scan_spine.launches == before + 1


@pytest.mark.parametrize("n", [1, G - 1, G + 1, G**2 - 1, G**2 + 1,
                               G**3 - 1, G**3 + 1, G**4 + 1])
def test_spine_kernel_around_group_powers(cuda, n):
    """K1 at stream lengths around the levels of its hierarchy: random,
    falling and one-value FEQ streams with increasing explicit indices."""
    rng = np.random.RandomState(n + 3)
    g = np.sort(rng.choice(4 * n + 8, n, replace=False))
    xn = rng.randint(0, 9, n)
    for xf in (rng.randint(0, 7, n), np.arange(n, 0, -1), np.full(n, 5)):
        args = [torch.from_numpy(a.astype(np.int32)).to(cuda)
                for a in (xf, g, xn, g)]
        _same(nsv_scan.nsv_scan_spine(*args),
              nsv_scan.nsv_scan_spine_plain(*args))


def test_spine_kernel_vs_plain(cuda):
    x = torch.from_numpy(_arrays(3)["st_padding"].astype(np.int32)).to(cuda)
    kf, vf, kn, vn, ovf = tansv.spine_streams(
        x, tansv.tile_side(x, True)[3], tansv.tile_side(x.flip(0), False)[3])
    assert ovf == 0
    before = nsv_scan.nsv_scan_spine.launches
    _same(nsv_scan.nsv_scan_spine(vf, kf, vn, kn),
          nsv_scan.nsv_scan_spine_plain(vf, kf, vn, kn))
    assert nsv_scan.nsv_scan_spine.launches == before + 1


@pytest.mark.parametrize("kind", sorted(_arrays(0)))
def test_left_kernel_vs_plain(cuda, kind):
    x = torch.from_numpy(_arrays(4)[kind].astype(np.int32)).to(cuda)
    before = nsv_scan.nsv_scan_left.launches
    for typ in (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ):
        _same(nsv_scan.nsv_scan_left(x, typ),
              nsv_scan.nsv_scan_left_plain(x, typ))
    assert nsv_scan.nsv_scan_left.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", sorted(_arrays(0)))
def test_block_psv_kernel_vs_plain(cuda, kind, dtype):
    a = _arrays(5)[kind].astype(np.int64)
    if dtype == torch.int64:
        a = a * (1 << 33) - (1 << 40)  # order kept, out of int32
    for n in (len(a), 1, 255, 256, 257, 70000):
        x = torch.from_numpy(a[:n]).to(dtype).to(cuda)
        before = bansv.block_psv.launches
        for strict in (True, False):
            got = bansv.block_psv(x, strict)
            assert got.dtype == torch.int32
            _same((got,), (bansv.block_psv_plain(x, strict),))
        assert bansv.block_psv.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", ["decreasing", "far_min", "sparse_tiny",
                                  "random"])
def test_block_psv_kernel_on_adversaries(cuda, kind, dtype):
    """K5 at 2^20 on the inputs that leave the window: every element climbs
    to the top in vain (decreasing), the last ones climb and descend
    through every level (far_min), a few climbers in many warps
    (sparse_tiny)."""
    a = cases.psv_adversaries(1 << 20, seed=20)[kind]
    if dtype == torch.int64:
        a = a * (1 << 33) - (1 << 40)
    x = torch.from_numpy(a).to(dtype).to(cuda)
    before = bansv.block_psv.launches
    for strict in (True, False):
        _same((bansv.block_psv(x, strict),),
              (bansv.block_psv_plain(x, strict),))
    assert bansv.block_psv.launches == before + 2


@pytest.mark.parametrize("n", [511, 512, 513, 65535, 65537, (1 << 24) - 1,
                               (1 << 24) + 1])
def test_block_psv_kernel_around_tiles_and_levels(cuda, n):
    """Lengths around one and two tiles and B^2 and B^3 (B = 256), where the
    hierarchy gains a level."""
    for kind in ("far_min", "sparse_tiny"):
        a = cases.psv_adversaries(n, seed=n)[kind]
        x = torch.from_numpy(a.astype(np.int32)).to(cuda)
        for strict in (True, False):
            _same((bansv.block_psv(x, strict),),
                  (bansv.block_psv_plain(x, strict),))


def test_public_ansv_runs_on_the_card_by_default(cuda):
    from psac_tpu_torch import ansv

    a = np.random.RandomState(7).randint(0, 6, 5000).astype(np.int32)
    before = (bansv.block_psv.launches, nsv_scan.nsv_scan_left.launches)
    got = ansv(a, NEAREST_EQ, FURTHEST_EQ)
    assert (bansv.block_psv.launches,
            nsv_scan.nsv_scan_left.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, ansv_seq(a, NEAREST_EQ, FURTHEST_EQ, nonsv=5000)):
        np.testing.assert_array_equal(g, w)


def test_public_ansv_on_gpu(cuda):
    from psac_tpu_torch.parallel.ansv import ansv

    rng = np.random.RandomState(6)
    types = (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ)
    for a in (rng.randint(0, 6, 5000).astype(np.int32),
              rng.randint(0, 6, 5000).astype(np.int64) << 33):
        for lt in types:
            for rt in types:
                got = ansv(a, lt, rt, device=cuda)
                for g, w in zip(got, ansv_seq(a, lt, rt, nonsv=len(a))):
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tli", ["tllt", "tldt"])
def test_desa_on_gpu(cuda, tli):
    from psac_tpu_torch import build_desa
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.seq import SAIndex

    text = rand_dna(5000, seed=3)
    d = build_desa(text, cuda, tli=tli, maxsize=16)
    idx = SAIndex(text)
    rng = np.random.RandomState(1)
    pats = [text[i:i + ln] for ln in (3, 8, 20, 64)
            for i in rng.randint(0, len(text) - ln, 8)] + [b"G" * 40]
    for pat, (l, r) in zip(pats, d.bulk_locate(pats)):
        want = idx.locate(pat)
        assert (l, r) == want or (l == r and want[0] == want[1]), pat


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2048, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        nsv_scan.nsv_scan_dual(x, x, 0, 0)
    with pytest.raises(ValueError):
        tansv.tile_side(torch.zeros(1000, dtype=torch.int32, device=cuda),
                        True)
    with pytest.raises(ValueError):
        nsv_scan.nsv_scan_left(x, 0)
    with pytest.raises(ValueError):
        bansv.block_psv(x.to(torch.int16), True)


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


def test_build_entry_points_default_to_the_card(cuda):
    """With no device, the builds run on the card: the SA of mississippi,
    its encoded text and SA+LCP on the card, and a suffix tree that
    launches K4 and K1."""
    from psac_tpu_torch import build_suffix_array, build_suffix_tree
    from psac_tpu_torch.models.suffix_array import (construct_device,
                                                    encode_and_shard)

    res = build_suffix_array(b"mississippi")
    np.testing.assert_array_equal(res.sa, [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2])
    np.testing.assert_array_equal(res.lcp, [0, 1, 1, 4, 0, 0, 1, 0, 2, 1, 3])
    xs, alpha, n, N = encode_and_shard(b"mississippi")
    dsa = construct_device(xs, alpha, n, N)
    assert xs.is_cuda and dsa.sa.is_cuda and dsa.lcp.is_cuda
    before = (tansv.tile_side.launches, nsv_scan.nsv_scan_spine.launches)
    build_suffix_tree(b"mississippi")
    assert (tansv.tile_side.launches,
            nsv_scan.nsv_scan_spine.launches) == (before[0] + 2,
                                                  before[1] + 1)


# ---------------------------------------------------------------------------
# K6 (the LCP resolve) and the generalized suffix array / tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("s", [8 * 37, 32 * 9, 128 * 5, 8 * 4099, 128 * 257,
                               1 << 18])
def test_rmq_resolve_kernel_vs_plain(cuda, s, L, dtype):
    """K6 against its plain version and a direct computation, for every
    key packing, at blocks 8, 32 and 128."""
    from psac_tpu_torch.models.suffix_array import _Builder

    block = rmq.block_size_for(s)
    lcp = cases.resolve_lcp(s, seed=s)
    rows, lo, hi, j = cases.resolve_queries(s, s // 2, block, L, seed=s + L)
    inf = torch.iinfo(dtype).max
    q = {k: torch.from_numpy(v).to(cuda).to(dtype) for k, v in
         cases.resolve_query_arrays(s, rows, lo, hi, j, inf).items()}
    b = _Builder(s, (4, 4), 3, True, dtype, cuda)
    r = rmq.build_local_rmq(torch.from_numpy(lcp).to(cuda).to(dtype))
    assert r.block == block
    d = 7
    want = cases.resolve_expected(lcp, rows, lo, hi, j, d)
    for packing in rmq.PACKINGS:
        ks, ls, rs, js, Lm, _ = b._pack_queries(q, L, packing)
        kw = dict(Lm=Lm, packing=packing, nq=len(rows))
        before = rmq.rmq_resolve.launches
        got = rmq.rmq_resolve(r, ks, ls, rs, js, d, **kw)
        assert rmq.rmq_resolve.launches == before + 1
        assert got.dtype == dtype
        plain = rmq.rmq_resolve_plain(r, ks, ls, rs, js, d, **kw, m_pad=64)
        _same((got,), (plain,))
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    # the tail's unsorted buffer, through the builder
    m = 256
    slots = np.sort(np.random.RandomState(s).permutation(m)[:m // 2])
    buf = np.stack([np.full(m, inf), np.full(m, -3), np.full(m, 2 * s)])
    buf[:, slots] = np.stack([rows[:m // 2], lo[:m // 2], hi[:m // 2]])
    kq, lq, rq = (torch.from_numpy(a).to(cuda).to(dtype) for a in buf)
    got = b._resolve_local(r.x, kq, lq, rq, d)
    _same((got,), (rmq.rmq_resolve_plain(r, kq, lq, rq, None, d, Lm=1,
                                         packing="rows", nq=m),))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("s", [8 * 4099, 128 * 257, 1 << 18])
def test_rmq_resolve_kernel_mostly_wide(cuda, s, dtype):
    """K6 on a resolve whose ranges are mostly 8 or more wide (each warp
    takes its wide queries in turn), every packing; and on an LCP that
    starts 4 bytes past a 16-byte boundary, where narrow ranges are read
    element by element."""
    from psac_tpu_torch.models.suffix_array import _Builder

    block = rmq.block_size_for(s)
    lcp = cases.resolve_lcp(s, seed=s + 1)
    rows, lo, hi, j = cases.wide_resolve_queries(s, s // 2, block, 4, seed=s)
    inf = torch.iinfo(dtype).max
    q = {k: torch.from_numpy(v).to(cuda).to(dtype) for k, v in
         cases.resolve_query_arrays(s, rows, lo, hi, j, inf).items()}
    b = _Builder(s, (4, 4), 3, True, dtype, cuda)
    host = torch.from_numpy(lcp).to(dtype)
    shifted = torch.cat([host[:1], host]).to(cuda)[1:]  # unaligned view
    assert shifted.data_ptr() % 16 != 0
    want = cases.resolve_expected(lcp, rows, lo, hi, j, 9)
    for x in (host.to(cuda), shifted):
        r = rmq.build_local_rmq(x)
        for packing in rmq.PACKINGS:
            ks, ls, rs, js, Lm, _ = b._pack_queries(q, 4, packing)
            kw = dict(Lm=Lm, packing=packing, nq=len(rows))
            before = rmq.rmq_resolve.launches
            got = rmq.rmq_resolve(r, ks, ls, rs, js, 9, **kw)
            assert rmq.rmq_resolve.launches == before + 1
            _same((got,), (rmq.rmq_resolve_plain(r, ks, ls, rs, js, 9, **kw,
                                                 m_pad=4096),))
            np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rmq_resolve_without_a_query_launches_nothing(cuda, dtype):
    """A dense step without a query case: the LCP comes back as a copy and
    the launch count stays as it was."""
    x = torch.arange(256, dtype=dtype, device=cuda)
    r = rmq.build_local_rmq(x)
    inf = torch.full_like(x, torch.iinfo(dtype).max)
    before = rmq.rmq_resolve.launches
    out = rmq.rmq_resolve(r, inf, x, x, None, 5, Lm=1, packing="narrow", nq=0)
    assert rmq.rmq_resolve.launches == before
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    # one slot more and it launches (all keys INF: nothing is written)
    out = rmq.rmq_resolve(r, inf, x, x, None, 5, Lm=1, packing="rows", nq=1)
    assert rmq.rmq_resolve.launches == before + 1
    assert torch.equal(out, x)


def test_rmq_resolve_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(256, dtype=torch.int32, device=cuda)
    r = rmq.build_local_rmq(x)
    kw = dict(Lm=1, packing="rows", nq=4)
    with pytest.raises(ValueError):
        rmq.rmq_resolve(r, x.to(torch.int64), x, x, None, 1, **kw)
    with pytest.raises(ValueError):
        rmq.rmq_resolve(r, x.cpu(), x, x, None, 1, **kw)
    with pytest.raises(ValueError):
        rmq.rmq_resolve(r, x, x, x, None, 1, Lm=1, packing="wide", nq=4)
    with pytest.raises(ValueError):
        rmq.rmq_resolve(r, x, x, x, None, 1, Lm=1, packing="rows", nq=257)
    with pytest.raises(ValueError):
        rmq.rmq_resolve(rmq.build_local_rmq(x.to(torch.int16)), x, x, x,
                        None, 1, **kw)


@pytest.mark.parametrize("force_int64", [False, True])
@pytest.mark.parametrize("kind", ["family", "random", "duplicates"])
def test_gsa_and_gst_default_to_the_card(cuda, kind, force_int64):
    """``build_gsa`` / ``build_gst`` with no device run on the card (K6 in
    the family's dense steps, the ANSV kernels in the tree) and equal the
    CPU path."""
    from psac_tpu_torch import SAConfig, build_gsa, build_gst
    from psac_tpu_torch.models.gsa import build_gsa_device
    from psac_tpu_torch.ops.alphabet import rand_dna

    parts = {"family": cases.near_identical_family(16, 4096, 4, seed=2),
             "random": [rand_dna(300 + 17 * i, seed=i) for i in range(40)],
             "duplicates": [b"banana"] * 5 + [b"ban", b"anana"]}[kind]
    cfg = SAConfig(force_int64=force_int64)
    before = (rmq.rmq_resolve.launches, tansv.tile_side.launches)
    got = build_gsa(parts, config=cfg)
    assert rmq.rmq_resolve.launches > before[0] or kind == "duplicates"
    want = build_gsa(parts, "cpu", cfg)
    np.testing.assert_array_equal(got.sa, want.sa)
    np.testing.assert_array_equal(got.lcp, want.lcp)
    dg = build_gsa_device(parts, config=cfg)
    assert dg.sa.is_cuda and dg.eos.is_cuda and dg.xs.is_cuda
    assert dg.sa.dtype == (torch.int64 if force_int64 else torch.int32)
    tree = build_gst(parts, config=cfg)
    assert tansv.tile_side.launches == before[1] + 2
    np.testing.assert_array_equal(tree, build_gst(parts, "cpu", cfg))


def test_suffix_array_int64_on_gpu(cuda):
    """The int64 build runs K6's int64 launcher in its dense steps."""
    from psac_tpu_torch import SAConfig, build_suffix_array, native
    from psac_tpu_torch.ops.alphabet import rep_dna

    text = rep_dna(1 << 16, unit_len=1024, seed=7, mutations=64)
    before = rmq.rmq_resolve.launches
    res = build_suffix_array(text, config=SAConfig(force_int64=True))
    assert rmq.rmq_resolve.launches > before
    sa = native.suffix_array(text)
    np.testing.assert_array_equal(res.sa, sa)
    np.testing.assert_array_equal(res.lcp, native.lcp_array(text, sa))


# ---------------------------------------------------------------------------
# K7 (the DESA's blind search) and the command-line tools
# ---------------------------------------------------------------------------

def _k7_spy(monkeypatch):
    """Route every blind search of ``bulk_locate`` through K7 and its plain
    version on the same inputs, hold them equal, and record the batch
    widths; returns the list of widths."""
    from psac_tpu_torch.models import desa as t_desa
    from psac_tpu_torch.ops import blind_search as k7

    widths = []

    def spy(pat, lens, l0, r0, need, lcp, lc, rmq, cap, stats):
        before = k7.blind_search.launches
        got = k7.blind_search(pat, lens, l0, r0, need, lcp, lc, rmq, cap,
                              stats)
        assert k7.blind_search.launches == before + 1
        want = k7.blind_search_plain(pat, lens, l0, r0, need, lcp, lc, rmq,
                                     cap, {"readbacks": 0})
        assert got[2].dtype == lcp.dtype
        _same(got, want)
        widths.append(pat.shape[0])
        return got

    monkeypatch.setattr(t_desa, "blind_search", spy)
    return widths


def _k7_patterns(text: bytes, B: int, seed: int) -> list:
    """``B`` patterns: text substrings of lengths 12, 20 and 64 and random
    DNA of the same lengths, mixed."""
    rng = np.random.RandomState(seed)
    t = np.frombuffer(text, np.uint8)
    dna = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for j in range(B):
        ln = (12, 20, 64)[j % 3]
        if j % 2:
            out.append(dna[rng.randint(0, 4, ln)].tobytes())
        else:
            st = rng.randint(0, len(t) - ln)
            out.append(t[st:st + ln].tobytes())
    return out


@pytest.mark.parametrize("B", [1, 255, 4093, 65536])
@pytest.mark.parametrize("tli", ["tllt", "tldt"])
@pytest.mark.parametrize("force_int64", [False, True])
def test_blind_search_kernel_vs_plain(cuda, monkeypatch, force_int64, tli,
                                      B):
    from psac_tpu_torch import SAConfig, build_desa
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.seq import SAIndex

    text = rand_dna(1 << 16, seed=B)
    d = build_desa(text, cuda, config=SAConfig(force_int64=force_int64),
                   tli=tli)
    assert d.lcp.dtype == (torch.int64 if force_int64 else torch.int32)
    widths = _k7_spy(monkeypatch)
    pats = _k7_patterns(text, B, seed=B + 1)
    got = d.bulk_locate(pats)
    assert widths and d.last_stats["readbacks"] == 0
    assert d.last_stats["steps"] > 0 or B == 1
    idx = SAIndex(text)
    for i in range(0, B, max(1, B // 300)):
        want = idx.locate(pats[i])
        assert tuple(got[i]) == want or (got[i, 0] == got[i, 1]
                                         and want[0] == want[1]), i


@pytest.mark.parametrize("tli", ["tllt", "tldt"])
def test_blind_search_kernel_on_a_homopolymer(cuda, monkeypatch, tli):
    """A^n: every interval is a chain, so the walks are as deep as the
    patterns are long."""
    from psac_tpu_torch import build_desa

    n = 4096
    d = build_desa(b"A" * n, cuda, tli=tli, maxsize=8)
    _k7_spy(monkeypatch)
    pats = [b"A" * ln for ln in (1, 2, 13, 100, 1000, n - 1, n, n + 1)]
    got = d.bulk_locate(pats)
    for pat, (l, r) in zip(pats, got):
        occ = n - len(pat) + 1 if len(pat) <= n else 0
        assert r - l == occ, (len(pat), l, r)
    assert d.last_stats["steps"] >= 100


def test_blind_search_rejects_what_the_kernel_does_not_take(cuda):
    from psac_tpu_torch.ops.blind_search import blind_search
    from psac_tpu_torch.ops.rmq import build_arg_rmq

    cap, B = 256, 4
    lcp = torch.zeros(cap, dtype=torch.int32, device=cuda)
    lc = torch.zeros(cap, dtype=torch.int32, device=cuda)
    rmq = build_arg_rmq(lcp)
    pat = torch.ones((B, 8), dtype=torch.int32, device=cuda)
    v = torch.zeros(B, dtype=torch.int32, device=cuda)
    need = torch.ones(B, dtype=torch.bool, device=cuda)
    args = (pat, v + 8, v, v + 9, need, lcp, lc, rmq, cap, {})
    before = blind_search.launches
    blind_search(*args)
    assert blind_search.launches == before + 1
    bad = [
        (pat, v + 8, v, v + 9, need, lcp.to(torch.int16), lc, rmq, cap, {}),
        (pat, v + 8, v, v + 9, need, lcp, lc.to(torch.int64), rmq, cap, {}),
        (pat.t().contiguous().t(), v + 8, v, v + 9, need, lcp, lc, rmq, cap,
         {}),
        (pat.to(torch.int64), v + 8, v, v + 9, need, lcp, lc, rmq, cap, {}),
        (pat, v + 8, v, v + 9, need.to(torch.int32), lcp, lc, rmq, cap, {}),
        (pat, v + 8, v, v + 9, need, lcp, lc, rmq, cap - 8, {}),
        (pat, v + 8, v, v + 9, need, lcp, lc, build_arg_rmq(lcp.clone()),
         cap, {}),
        (pat, v + 8, v, v + 9, need, lcp, lc, build_arg_rmq(lcp, 256), cap,
         {}),
        (pat.cpu(), v + 8, v, v + 9, need, lcp, lc, rmq, cap, {}),
    ]
    for a in bad:
        with pytest.raises(ValueError):
            blind_search(*a)
    assert blind_search.launches == before + 1
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    out = blind_search(pat[:0], empty, empty, empty, need[:0], lcp, lc, rmq,
                       cap, {})
    assert all(o.shape == (0,) for o in out)
    assert blind_search.launches == before + 1


def _k7_calls(d, pats) -> list:
    """The arguments of the blind searches of ``d.bulk_locate(pats)``."""
    from unittest import mock

    from psac_tpu_torch.models import desa as t_desa
    from psac_tpu_torch.ops import blind_search as k7

    calls = []

    def record(*args):
        calls.append(args)
        return k7.blind_search(*args)

    with mock.patch.object(t_desa, "blind_search", record):
        d.bulk_locate(pats)
    assert calls
    return calls


def _k7_plain(args):
    from psac_tpu_torch.ops.blind_search import blind_search_plain

    return blind_search_plain(*args[:-1], {"readbacks": 0})


def _k7_padded(args, cap2: int):
    """The blind search's arguments on its slab padded with INF rows (as a
    slab's unused capacity) to ``cap2`` rows, with the padded slab's RMQ."""
    from psac_tpu_torch.ops.rmq import build_arg_rmq

    pat, lens, l0, r0, need, lcp, lc, _, cap, stats = args
    lcp2 = torch.full((cap2,), torch.iinfo(lcp.dtype).max, dtype=lcp.dtype,
                      device=lcp.device)
    lcp2[:cap] = lcp
    lc2 = torch.zeros(cap2, dtype=torch.int32, device=lc.device)
    lc2[:cap] = lc
    return (pat, lens, l0, r0, need, lcp2, lc2, build_arg_rmq(lcp2), cap2,
            stats)


def _k7_wide_cap(dtype, cap: int) -> int:
    """The least ``cap`` * 2^k rows on which K7 walks a pattern with more
    than one lane (the launcher picks the lanes from the slab's size)."""
    from psac_tpu_torch.ops.blind_search import launch_shape

    while launch_shape(dtype, cap, 1)["group"] == 1:
        cap *= 2
        assert cap < 1 << 28, "K7 never takes more than one lane"
    return cap


@pytest.mark.parametrize("B", [1, 255, 4093, 65536])
@pytest.mark.parametrize("tli", ["tllt", "tldt"])
@pytest.mark.parametrize("force_int64", [False, True])
def test_blind_search_kernel_every_shape(cuda, force_int64, tli, B):
    """K7 at both lane counts it launches (one lane per pattern on a small
    slab, a group on a large one) equals the plain version in all four
    outputs: the main path's searches as they are, and on their slabs
    padded past the size where the launcher takes a group."""
    from psac_tpu_torch import SAConfig, build_desa
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.ops.blind_search import blind_search, launch_shape

    text = rand_dna(1 << 16, seed=B)
    d = build_desa(text, cuda, config=SAConfig(force_int64=force_int64),
                   tli=tli)
    calls = _k7_calls(d, _k7_patterns(text, B, seed=B + 2))
    groups = set()
    for args in calls:
        dt, cap = args[5].dtype, args[8]
        wide = _k7_padded(args, _k7_wide_cap(dt, cap))
        for a in (args, wide):
            nb = a[0].shape[0]
            shape = launch_shape(dt, a[8], nb)
            groups.add(shape["group"])
            assert shape["blocks"] * shape["threads"] >= nb * shape["group"]
            _same(blind_search(*a), _k7_plain(a))
    assert 1 in groups and len(groups) == 2


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_blind_search_kernel_on_every_block(cuda, dtype, block):
    """The slab's RMQ block is any power of two from 8 to 128: the TLLT
    slab search's inputs re-padded (INF rows, as a slab's unused capacity)
    to a capacity whose block is ``block``, one small and one large enough
    for the launcher to take a group of lanes."""
    from psac_tpu_torch import SAConfig, build_desa
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.ops.blind_search import blind_search

    text = rand_dna(1 << 15, seed=block)
    d = build_desa(text, cuda, config=SAConfig(
        force_int64=dtype == torch.int64))
    # one length tier, so one blind search
    pats = [p[:12] for p in _k7_patterns(text, 2048, seed=block)]
    (args,) = _k7_calls(d, pats)
    cap = args[8]
    for least in (cap + 1, _k7_wide_cap(dtype, cap)):
        cap2 = -(-least // 256) * 256 + block  # block divides, 2 * block not
        a = _k7_padded(args, cap2)
        assert a[7].block == block
        _same(blind_search(*a), _k7_plain(a))


def test_blind_search_kernel_twice_on_one_stream(cuda):
    """Two launches in a row on one stream, with no synchronization
    between, and freed memory filled with -7 before each: both equal the
    plain version, on a slab walked by one lane per pattern and on one
    walked by a group."""
    from psac_tpu_torch import build_desa
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.ops.blind_search import blind_search

    text = rand_dna(1 << 16, seed=77)
    d = build_desa(text, cuda)
    B = 3001
    (args,) = _k7_calls(d, [p[:12] for p in _k7_patterns(text, B, seed=78)])
    assert args[0].shape[0] == B
    for a in (args, _k7_padded(args, _k7_wide_cap(torch.int32, args[8]))):
        want = _k7_plain(a)
        torch.cuda.synchronize()
        got = []
        for _ in range(2):
            junk = [torch.full_like(a[2], -7) for _ in range(8)]
            del junk
            got.append(blind_search(*a))
        torch.cuda.synchronize()
        for g in got:
            _same(g, want)


def test_blind_search_rejects_a_misaligned_lcp(cuda):
    """An LCP view that does not start on a 16-byte boundary raises and
    launches nothing."""
    from psac_tpu_torch.ops.blind_search import blind_search
    from psac_tpu_torch.ops.rmq import build_arg_rmq

    cap, B = 256, 4
    base = torch.zeros(cap + 1, dtype=torch.int32, device=cuda)
    lcp = base[1:]
    assert lcp.is_contiguous() and lcp.data_ptr() % 16
    lc = torch.zeros(cap, dtype=torch.int32, device=cuda)
    pat = torch.ones((B, 8), dtype=torch.int32, device=cuda)
    v = torch.zeros(B, dtype=torch.int32, device=cuda)
    need = torch.ones(B, dtype=torch.bool, device=cuda)
    before = blind_search.launches
    with pytest.raises(ValueError, match="16-byte"):
        blind_search(pat, v + 8, v, v + 9, need, lcp, lc, build_arg_rmq(lcp),
                     cap, {})
    assert blind_search.launches == before
    aligned = base[4:4 + cap - 8]  # 16 bytes in
    blind_search(pat, v + 8, v, v + 9, need, aligned, lc[:cap - 8],
                 build_arg_rmq(aligned), cap - 8, {})
    assert blind_search.launches == before + 1


def test_psac_cli_on_the_card_writes_what_the_cpu_writes(cuda, tmp_path):
    """``psac -f`` with no ``--device`` runs on the card and writes the
    same ``.sa64/.lcp64/.alpha`` files as ``--device cpu``; so does
    ``gsac -f``."""
    from psac_tpu_torch.cli import main
    from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna

    f = tmp_path / "t.txt"
    # repetitive: the build resolves its LCP with K6
    f.write_bytes(rep_dna(1 << 15, unit_len=500, seed=6))
    before = rmq.rmq_resolve.launches
    assert main(["psac", "-f", str(f), "-l", "-c",
                 "-o", str(tmp_path / "gpu")]) == 0
    assert rmq.rmq_resolve.launches > before
    assert main(["psac", "-f", str(f), "-l", "--device", "cpu",
                 "-o", str(tmp_path / "cpu")]) == 0
    for ext in (".sa64", ".lcp64", ".alpha"):
        assert (tmp_path / ("gpu" + ext)).read_bytes() == \
            (tmp_path / ("cpu" + ext)).read_bytes(), ext
    g = tmp_path / "ss.txt"
    g.write_bytes(b"\n".join(rand_dna(300, seed=s) for s in range(40)))
    assert main(["gsac", "-f", str(g), "-c", "-o", str(tmp_path / "g")]) == 0
    assert main(["gsac", "-f", str(g), "--device", "cpu",
                 "-o", str(tmp_path / "c")]) == 0
    for ext in (".gsa64", ".glcp64"):
        assert (tmp_path / ("g" + ext)).read_bytes() == \
            (tmp_path / ("c" + ext)).read_bytes(), ext


def test_d_check_sa_on_gpu(cuda):
    from psac_tpu_torch.models.suffix_array import (construct_device,
                                                    encode_and_shard)
    from psac_tpu_torch.ops.alphabet import rep_dna
    from psac_tpu_torch.verify.check_sa import d_check_sa

    xs, alpha, n, N = encode_and_shard(rep_dna(1 << 15, unit_len=500), cuda)
    dsa = construct_device(xs, alpha, n, N)
    assert d_check_sa(dsa, xs)
    sa = dsa.sa.clone()
    off = N - n
    sa[off + 10], sa[off + 11] = dsa.sa[off + 11], dsa.sa[off + 10]
    import dataclasses
    assert not d_check_sa(dataclasses.replace(dsa, sa=sa), xs)


# ---------------------------------------------------------------------------
# the host-driven loop, pack_keys and the ANSV engines on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(fused=False),
                                 dict(fused=False, tail_threshold_frac=0.0),
                                 dict(fused=False, construct_lcp=False,
                                      factor=3)])
def test_host_loop_on_gpu_equals_cpu(cuda, cfg):
    """The host-driven loop on the card: the padded state equals its CPU
    run, and the LCP builds launch K6 once per resolve."""
    from psac_tpu_torch import SAConfig
    from psac_tpu_torch.models import suffix_array as t_sa
    from psac_tpu_torch.ops.alphabet import rep_dna

    t = rep_dna(1 << 16, unit_len=1024, seed=7, mutations=64)
    conf = SAConfig(**cfg)
    states = {}
    for dev in ("cpu", cuda):
        xs, alpha, n, N = t_sa.encode_and_shard(t, dev)
        before = rmq.rmq_resolve.launches
        states[str(dev)] = t_sa.construct_device(xs, alpha, n, N, conf)
        launched = rmq.rmq_resolve.launches - before
        assert t_sa.LAST_BUILD["host_iters"] > 0
    assert (launched > 0) == conf.construct_lcp
    got, want = states[str(cuda)], states["cpu"]
    for field in ("sa", "isa", "lcp"):
        if getattr(want, field) is not None:
            assert torch.equal(getattr(got, field).cpu(),
                               getattr(want, field))


def test_gsa_host_loop_on_gpu_equals_cpu(cuda):
    from psac_tpu_torch import SAConfig
    from psac_tpu_torch.models.gsa import build_gsa_device

    strings = cases.near_identical_family(16, 2000, 20, seed=3)
    conf = SAConfig(fused=False)
    before = rmq.rmq_resolve.launches
    got = build_gsa_device(strings, cuda, conf)
    assert rmq.rmq_resolve.launches > before
    want = build_gsa_device(strings, "cpu", conf)
    assert torch.equal(got.sa.cpu(), want.sa)
    assert torch.equal(got.lcp.cpu(), want.lcp)


@pytest.mark.parametrize("cfg", [dict(dense_factor=5),
                                 dict(fused=False, factor=5,
                                      construct_lcp=False)])
def test_pack_keys_on_gpu(cuda, cfg):
    from psac_tpu_torch import SAConfig, build_suffix_array
    from psac_tpu_torch.native import lcp_array, suffix_array
    from psac_tpu_torch.ops.alphabet import rep_dna

    t = rep_dna(1 << 16, unit_len=1024, seed=7, mutations=64)
    sa = suffix_array(t)
    for packed in (True, False):
        res = build_suffix_array(t, cuda, SAConfig(pack_keys=packed, **cfg))
        np.testing.assert_array_equal(res.sa, sa)
        if res.lcp is not None:
            np.testing.assert_array_equal(res.lcp, lcp_array(t, sa))


#: the kernels each engine launches on int32 input, per pair (the FEQ,NSM
#: spine fits its capacity on these values)
ENGINE_LAUNCHES = {
    ("hybrid", "sm-sm"): {"block_psv": 2},
    ("hybrid", "feq-sm"): {"tile_side": 2, "nsv_scan_spine": 1},
    ("hybrid", "eq-eq"): {"block_psv": 2},
    ("spine", "feq-sm"): {"tile_side": 2, "nsv_scan_spine": 1},
    ("scan", "sm-sm"): {"nsv_scan_dual": 1},
    ("scan", "feq-sm"): {"nsv_scan_dual": 1},
    ("scan", "eq-eq"): {"nsv_scan_dual": 1},
    ("block", "sm-sm"): {"block_psv": 2},
    ("block", "feq-sm"): {"block_psv": 2},
    ("block", "eq-eq"): {"block_psv": 2},
}


@pytest.mark.parametrize("engine,combo", sorted(ENGINE_LAUNCHES))
def test_ansv_engines_on_gpu(cuda, engine, combo):
    """Each engine launches its kernels and equals the plain path."""
    from psac_tpu_torch.parallel.ansv import PLAIN, ansv

    pair = {"sm-sm": (NEAREST_SM, NEAREST_SM),
            "feq-sm": (FURTHEST_EQ, NEAREST_SM),
            "eq-eq": (NEAREST_EQ, NEAREST_EQ)}[combo]
    a = np.random.RandomState(21).randint(0, 1 << 12, 1 << 18).astype(
        np.int32)
    fns = {"tile_side": tansv.tile_side,
           "nsv_scan_spine": nsv_scan.nsv_scan_spine,
           "nsv_scan_dual": nsv_scan.nsv_scan_dual,
           "nsv_scan_left": nsv_scan.nsv_scan_left,
           "block_psv": bansv.block_psv}
    before = {k: f.launches for k, f in fns.items()}
    got = ansv(a, *pair, device=cuda, engine=engine)
    ran = {k: f.launches - before[k] for k, f in fns.items()
           if f.launches != before[k]}
    assert ran == ENGINE_LAUNCHES[engine, combo]
    want = ansv(a, *pair, device=cuda, kernels=PLAIN, engine=engine)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the mesh (p > 1 shards on the card) and K6's min-only entry
# ---------------------------------------------------------------------------

def _mins_queries(s: int, block: int, m: int, seed: int):
    """Narrow ranges (under 8 wide), ranges inside one block, ranges across
    one block edge and ranges over many blocks, some reversed (read as
    [lo, lo]), about one in eight not valid."""
    rng = np.random.RandomState(seed)
    lo = rng.randint(0, s, m)
    width = rng.choice([0, 1, 5, 7, block // 2, block + 3, 5 * block,
                        s // 3], m)
    hi = np.minimum(s - 1, lo + width)
    rev = rng.rand(m) < 0.05
    hi = np.where(rev, np.maximum(lo - 3, 0), hi)
    valid = rng.rand(m) < 0.875
    return lo, hi, valid


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("s", [8 * 37, 32 * 9, 128 * 257, 1 << 20])
def test_rmq_mins_kernel_vs_plain(cuda, s, dtype):
    """K6's min-only entry against ``query_local_rmq`` (its plain version)
    and numpy, at blocks 8, 32 and 128, on an aligned LCP and on one that
    starts 4 bytes past a 16-byte boundary."""
    x_np = cases.resolve_lcp(s, seed=s)
    lo, hi, valid = _mins_queries(s, rmq.block_size_for(s), 5000, seed=s)
    host = torch.from_numpy(x_np).to(dtype)
    shifted = torch.cat([host[:1], host]).to(cuda)[1:]
    inf = torch.iinfo(dtype).max
    want = np.array([x_np[a:max(a, b) + 1].min() if v else inf
                     for a, b, v in zip(lo, hi, valid)])
    args = [torch.from_numpy(a).to(cuda) for a in (lo, hi)]
    args = [a.to(dtype) for a in args] + [torch.from_numpy(valid).to(cuda)]
    for x in (host.to(cuda), shifted):
        r = rmq.build_local_rmq(x)
        before = rmq.rmq_mins.launches
        got = rmq.rmq_mins(r, *args)
        assert rmq.rmq_mins.launches == before + 1
        assert got.dtype == dtype
        _same((got,), (rmq.rmq_mins_plain(r, *args),))
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_rmq_mins_without_a_valid_query_launches_nothing(cuda, dtype):
    x = torch.arange(256, dtype=dtype, device=cuda)
    r = rmq.build_local_rmq(x)
    valid = torch.zeros(64, dtype=torch.bool, device=cuda)
    lo = torch.zeros(64, dtype=dtype, device=cuda)
    before = rmq.rmq_mins.launches
    out = rmq.rmq_mins(r, lo, lo + 9, valid)
    assert rmq.rmq_mins.launches == before
    assert bool((out == torch.iinfo(dtype).max).all())
    valid[5] = True
    out = rmq.rmq_mins(r, lo, lo + 9, valid)
    assert rmq.rmq_mins.launches == before + 1
    assert int(out[5]) == 0 and int(out[4]) == torch.iinfo(dtype).max


def test_mesh_build_on_the_card_equals_cpu(cuda):
    """A p = 4 build of SA+LCP and its suffix tree on four shards of the
    one card equals the same build on four CPU shards, launching K6's
    min-only entry (the routed resolve) and K5 (each shard's ANSV)."""
    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.models import suffix_tree as st_mod
    from psac_tpu_torch.ops.alphabet import rep_dna
    from psac_tpu_torch.parallel.mesh import make_mesh

    text = rep_dna(1 << 15, unit_len=512, seed=3, mutations=40)
    outs = {}
    for name, devs in (("cuda", ["cuda:0"] * 4), ("cpu", ["cpu"] * 4)):
        mesh = make_mesh(4, devs)
        before = (rmq.rmq_mins.launches, bansv.block_psv.launches)
        xs, alpha, n, N = sa_mod.encode_and_shard(text, mesh=mesh)
        dsa = sa_mod.construct_device(xs, alpha, n, N, mesh=mesh)
        tree = st_mod.construct_suffix_tree_device(dsa, xs)
        launched = (rmq.rmq_mins.launches - before[0],
                    bansv.block_psv.launches - before[1])
        assert all(t.device.type == name for t in dsa.sa.shards)
        outs[name] = (dsa.isa.gather(), dsa.sa.gather(), dsa.lcp.gather(),
                      tree.nodes.gather(), launched)
        mesh.close()
    for g, w in zip(outs["cuda"][:4], outs["cpu"][:4]):
        assert torch.equal(g, w)
    assert outs["cuda"][4][0] > 0 and outs["cuda"][4][1] > 0
    assert outs["cpu"][4] == (0, 0)


def test_mesh_gsa_on_the_card_equals_cpu(cuda, tmp_path):
    """A p = 4 GSA + GLCP and its generalized suffix tree on four shards of
    the one card equal the same builds on four CPU shards (the dense loop,
    the tie-fix and, with ``fused=False``, the host loop's routed resolve),
    launching K6's min-only entry and K5; the file input equals the
    in-memory build there."""
    from psac_tpu_torch.config import SAConfig
    from psac_tpu_torch.models import gsa as gsa_mod
    from psac_tpu_torch.models import suffix_tree as st_mod
    from psac_tpu_torch.parallel.mesh import make_mesh

    strings = cases.near_identical_family(8, 3000, 3, seed=5)
    strings += [b"ACGTACGT" * 5] * 3 + [b"ACG", b"T"]
    path = tmp_path / "strings.txt"
    path.write_bytes(b"\n".join(strings) + b"\n")
    fields = ("sa", "lcp", "eos", "xs")
    outs = {}
    for name, devs in (("cuda", ["cuda:0"] * 4), ("cpu", ["cpu"] * 4)):
        mesh = make_mesh(4, devs)
        before = (rmq.rmq_mins.launches, bansv.block_psv.launches)
        dg = gsa_mod.build_gsa_device(strings, mesh=mesh)
        host = gsa_mod.build_gsa_device(strings, mesh=mesh,
                                        config=SAConfig(fused=False))
        tree = st_mod.construct_gst_device(dg)
        launched = (rmq.rmq_mins.launches - before[0],
                    bansv.block_psv.launches - before[1])
        fd = gsa_mod.build_gsa_from_file(str(path), mesh=mesh)
        assert all(t.device.type == name for t in dg.sa.shards)
        for f in fields:
            assert torch.equal(getattr(fd, f).gather(),
                               getattr(dg, f).gather()), f
            assert torch.equal(getattr(host, f).gather(),
                               getattr(dg, f).gather()), f
        outs[name] = [getattr(dg, f).gather() for f in fields] + [
            tree.nodes.gather(), launched]
        mesh.close()
    for g, w in zip(outs["cuda"][:5], outs["cpu"][:5]):
        assert torch.equal(g, w)
    assert outs["cuda"][5][0] > 0 and outs["cuda"][5][1] > 0
    assert outs["cpu"][5] == (0, 0)


def test_mesh_worker_error_on_the_card_does_not_hang(cuda):
    """A shard that raises while the others wait in a collective: ``run``
    raises in the caller, and the mesh runs the next call."""
    import time

    from psac_tpu_torch.parallel.mesh import Rep, make_mesh

    mesh = make_mesh(4, ["cuda:0"] * 4)
    xs = mesh.shard(torch.arange(64, device=cuda))

    def fn(ctx, x):
        if ctx.rank == 2:
            raise RuntimeError("shard 2 failed")
        return ctx.all_gather(x)

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        mesh.run(fn, xs)
    assert time.perf_counter() - t0 < 30
    assert mesh.run(lambda ctx, x: Rep(int(ctx.psum(x.sum()))), xs) == 2016
    mesh.close()


def _mesh_desa_patterns(text: bytes, seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [text[i:i + ln] for ln in (5, 12, 30)
            for i in rng.randint(0, len(text) - ln, 300)] + [
        b"G" * 40, b"", b"AC\x01", b"ACGT" * 10]


@pytest.mark.parametrize("tli", ["tllt", "tldt"])
def test_mesh_desa_on_the_card_equals_cpu(cuda, tli):
    """A p = 4 DESA on four shards of the one card equals the same build on
    four CPU shards (slabs, table, answers verified and not), launching K7
    on the shards' slabs (and on the TLDT's sample) and, with the TLDT, K5
    in the sampling mask; the ranges are the host index's."""
    from psac_tpu_torch.models import desa as desa_mod
    from psac_tpu_torch.ops import blind_search as k7
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.parallel.mesh import make_mesh
    from psac_tpu_torch.seq import SAIndex

    text = rand_dna(1 << 15, seed=11)
    pats = _mesh_desa_patterns(text, 12)
    kw = dict(tli=tli, maxsize=64) if tli == "tldt" else {}
    outs = {}
    for name, devs in (("cuda", ["cuda:0"] * 4), ("cpu", ["cpu"] * 4)):
        mesh = make_mesh(4, devs)
        before = (k7.blind_search.launches, bansv.block_psv.launches)
        d = desa_mod.build_desa(text, mesh=mesh, **kw)
        got = d.bulk_locate(pats)
        launched = (k7.blind_search.launches - before[0],
                    bansv.block_psv.launches - before[1])
        assert all(t.device.type == name for t in d.sa.shards)
        outs[name] = [getattr(d, f).gather() for f in
                      ("sa", "lcp", "lc", "table")] + [
            torch.from_numpy(got),
            torch.from_numpy(d.bulk_locate_possible(pats)), launched]
        mesh.close()
    for g, w in zip(outs["cuda"][:6], outs["cpu"][:6]):
        assert torch.equal(g, w)
    assert outs["cuda"][6][0] > 0
    assert outs["cuda"][6][1] > 0 or tli == "tllt"
    assert outs["cpu"][6] == (0, 0)
    idx = SAIndex(text)
    for pat, (l, r) in zip(pats, outs["cuda"][4].numpy()):
        if not pat or b"\x01" in pat:  # no answer for these: (0, 0)
            assert (l, r) == (0, 0), pat
            continue
        want = idx.locate(pat)
        assert (l, r) == want or (l == r and want[0] == want[1]), pat


@pytest.mark.parametrize("force_int64", [False, True])
def test_blind_search_kernel_on_mesh_shapes(cuda, monkeypatch, force_int64):
    """K7 equals its plain version on the shapes only a mesh gives it: an
    owner's received buffer, most of whose rows are invalid (the chunked
    pass's p chunks of ceil(b / p) rows), the same buffer with no valid
    row, and a TLDT sample of M = 8 rows; int32 and int64 slabs."""
    import threading

    from psac_tpu_torch import SAConfig
    from psac_tpu_torch.models import desa as desa_mod
    from psac_tpu_torch.ops import blind_search as k7
    from psac_tpu_torch.ops.alphabet import rand_dna
    from psac_tpu_torch.parallel.mesh import make_mesh

    text = rand_dna(1 << 14, seed=5)
    conf = SAConfig(force_int64=force_int64)
    mesh = make_mesh(4, ["cuda:0"] * 4)
    calls, lock = [], threading.Lock()

    def record(*args):
        with lock:
            calls.append(args)
        return k7.blind_search(*args)

    monkeypatch.setattr(desa_mod, "blind_search", record)
    d = desa_mod.build_desa(text, mesh=mesh, config=conf)
    # a skewed batch: nearly every pattern's bucket lies on one shard
    pats = [b"A" * 12] * 500 + _mesh_desa_patterns(text, 3)[:40]
    d.bulk_locate(pats)
    s = desa_mod.build_desa(text, mesh=mesh, config=conf, tli="tldt",
                            maxsize=len(text))
    assert s.samp["M"] == 8
    s.bulk_locate(pats)
    mesh.close()
    slab = [a for a in calls if a[8] == d.cap]
    sample = [a for a in calls if a[8] == 8]
    assert slab and sample
    sparse = min(slab, key=lambda a: int(a[4].sum()))
    assert int(sparse[4].sum()) < sparse[0].shape[0] // 2
    empty = sparse[:4] + (torch.zeros_like(sparse[4]),) + sparse[5:]
    for args in (sparse, empty, max(slab, key=lambda a: int(a[4].sum())),
                 sample[0]):
        got = k7.blind_search(*args)
        want = k7.blind_search_plain(*args[:-1], {"readbacks": 0})
        assert got[2].dtype == args[5].dtype
        _same(got, want)


def test_two_processes_on_the_card_equal_the_thread_mesh(cuda, tmp_path):
    """2 processes x 1 shard on the one card over gloo (NCCL refuses two
    ranks on one card): SA+LCP of a repetitive file staged per process and
    its suffix tree equal the thread mesh of 2 shards on the card, with
    K6's min-only entry and K5 launched in the workers."""
    from psac_tpu_torch.models import suffix_array as sa_mod
    from psac_tpu_torch.models import suffix_tree as st_mod
    from psac_tpu_torch.ops import cuda_lib
    from psac_tpu_torch.ops.alphabet import rep_dna
    from psac_tpu_torch.parallel.mesh import make_mesh
    from test_torch_multiprocess import found, run_workers

    cuda_lib.lib()  # one build before the workers start
    path = tmp_path / "corpus.bin"
    path.write_bytes(rep_dna(1 << 15, unit_len=512, seed=3, mutations=40))
    run_workers(tmp_path, "build", 2, 1, device="cuda:0")
    mesh = make_mesh(2, ["cuda:0"] * 2)
    dsa, xs = sa_mod.construct_from_file(str(path), mesh=mesh)
    tree = st_mod.construct_suffix_tree_device(dsa, xs)
    want = [a.gather() for a in (dsa.isa, dsa.sa, dsa.lcp, tree.nodes)]
    mesh.close()
    got = found(tmp_path, "build")
    for g in got:
        assert g["devices"] == ["cuda:0"]
        for a, w in zip(g["arrays"], want):
            assert torch.equal(a, w)
        assert g["launches"][1] > 0  # K5: each shard's ANSV
    assert sum(g["launches"][0] for g in got) > 0  # K6-mins at the owners
