"""Tile-spine ANSV: the tile phase (K4's plain version) against the JAX
``_tile_side``, the whole engine against interpret-mode
``tansv_feq_nsm`` and ``ansv_seq``, and the spine-overflow path to the dual
scan (K2).  Exact equality (integers only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psac_tpu_torch.ops import tansv as t_tansv
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     NONSV, ansv_seq)
from psac_tpu_torch.parallel.ansv import ansv_local

torch.set_num_threads(1)

I32_NONSV = np.iinfo(np.int32).max  # ansv_local's no-match index (int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tansv_cases():
    """Same family as tests/test_ansv.py::_tansv_cases (tile-boundary
    adversaries), rebuilt here from its seed."""
    rng = np.random.RandomState(11)
    T = 512
    cases = {
        "random_small_alpha": rng.randint(0, 7, 4096).astype(np.int32),
        "random_wide": rng.randint(0, 100000, 2048).astype(np.int32),
        "all_equal": np.full(2048, 5, np.int32),
        "tile_edge_runs": np.tile(
            np.repeat(np.arange(8, dtype=np.int32), T // 2)[:T], 8)[:4096],
        "sawtooth": (np.arange(4096, dtype=np.int32) % 37),
        "two_level_runs": np.where(np.arange(4096) % T < 3, 1, 2
                                   ).astype(np.int32),
    }
    x = np.full(4096, 9, np.int32)
    x[T + 1::T] = 4
    cases["straddle"] = x
    return cases


CASES = _tansv_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_side_vs_jax(name):
    from psac_tpu.ops.tansv import _tile_side

    a = CASES[name]
    nt = len(a) // t_tansv.T
    fn = jax.jit(_tile_side, static_argnums=(1, 2))
    for arr in (a, a[::-1].copy()):
        for with_eq in (True, False):
            want = fn(jnp.asarray(arr), nt, with_eq)
            got = t_tansv.tile_side_plain(_t(arr), with_eq)
            for k, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    assert g is None
                    continue
                np.testing.assert_array_equal(
                    g.numpy(), np.asarray(w).reshape(-1), err_msg=f"{k}")


def test_tile_side_negative_psv_value():
    """psv_val is the value at the PSV exactly, also when it is negative
    (the suffix tree's padding rows carry LCP -1)."""
    a = np.zeros(512, np.int32)
    a[:5] = -1
    a[7] = -3
    psv_g, psv_val, chain, *_ = t_tansv.tile_side_plain(_t(a), True)
    assert psv_g[5] == 4 and psv_val[5] == -1 and not chain[5]
    assert psv_g[8] == 7 and psv_val[8] == -3
    assert chain[0] and psv_val[0] == 0


def _check_vs_oracle(a, li, lv, ri_r, rv_r):
    n = len(a)
    want_l, want_r = ansv_seq(a, FURTHEST_EQ, NEAREST_SM, nonsv=NONSV)
    got_l = li.numpy().astype(np.int64)
    got_l[got_l < 0] = NONSV
    got_r = ri_r.numpy().astype(np.int64)
    got_r = np.where(got_r < 0, NONSV, n - 1 - got_r)[::-1]
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_r, want_r)
    lv, rv = lv.numpy(), rv_r.numpy()[::-1]
    has_l, has_r = want_l != NONSV, want_r != NONSV
    np.testing.assert_array_equal(lv[has_l], a[want_l[has_l]])
    np.testing.assert_array_equal(rv[has_r], a[want_r[has_r]])
    assert (lv[~has_l] == 0).all() and (rv[~has_r] == 0).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_tansv_vs_oracle(name):
    a = CASES[name]
    *res, ovf = t_tansv.tansv_feq_nsm(_t(a))
    assert ovf == 0
    _check_vs_oracle(a, *res)


@pytest.mark.parametrize("name", ["straddle", "random_small_alpha"])
def test_tansv_vs_jax_interpret(name):
    from psac_tpu.ops.tansv import tansv_feq_nsm

    a = CASES[name]
    want = jax.jit(tansv_feq_nsm, static_argnums=(1, 2, 3))(
        jnp.asarray(a), len(a), (), True)
    got = t_tansv.tansv_feq_nsm(_t(a))
    assert int(want[-1]) == 0 and got[-1] == 0
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_tansv_randomized_lcp(seed):
    """Run-heavy random arrays and a real LCP array of a repetitive text."""
    from psac_tpu_torch.ops.oracle import lcp_kasai, suffix_array_np

    rng = np.random.RandomState(seed + 50)
    text = bytes(rng.randint(97, 100, 600).astype(np.uint8)) * 8
    lcp = lcp_kasai(text, suffix_array_np(text)).astype(np.int32)
    for a in (rng.randint(0, 3, 4096).astype(np.int32),
              np.repeat(rng.randint(0, 5, 64), 64).astype(np.int32),
              lcp[:4096]):
        *res, ovf = t_tansv.tansv_feq_nsm(_t(a))
        assert ovf == 0
        _check_vs_oracle(a, *res)


def test_tansv_overflow_reported():
    """A strictly decreasing array: every element is on the spine, which
    exceeds s // CAPDIV; the engine reports it and returns no answers."""
    a = np.arange(4096, 0, -1).astype(np.int32)
    *res, ovf = t_tansv.tansv_feq_nsm(_t(a))
    assert ovf > 0 and all(r is None for r in res)


@pytest.mark.parametrize("kind", ["decreasing", "increasing", "st_padding",
                                  "odd_length"])
def test_ansv_local_spine_and_fallback(kind):
    """ansv_local pads to a multiple of 2048 at the end; overflowing
    spines fall back to the dual scan; the answers equal ansv_seq."""
    rng = np.random.RandomState(5)
    a = {"decreasing": np.arange(5000, 0, -1),
         "increasing": np.arange(3000),
         "st_padding": np.concatenate([np.full(700, -1), [0],
                                       rng.randint(0, 9, 3395)]),
         "odd_length": rng.randint(0, 4, 2049)}[kind].astype(np.int32)
    want_l, want_r = ansv_seq(a, FURTHEST_EQ, NEAREST_SM, nonsv=I32_NONSV)
    li, lv, ri, rv = ansv_local(_t(a), FURTHEST_EQ, NEAREST_SM)
    np.testing.assert_array_equal(li.numpy(), want_l)
    np.testing.assert_array_equal(ri.numpy(), want_r)
    has = want_r != I32_NONSV
    np.testing.assert_array_equal(rv.numpy()[has], a[want_r[has]])


def test_ansv_local_other_types_and_int64():
    rng = np.random.RandomState(8)
    a = rng.randint(0, 6, 3000).astype(np.int32)
    for lt, rt in ((NEAREST_EQ, NEAREST_EQ), (NEAREST_SM, FURTHEST_EQ)):
        want_l, want_r = ansv_seq(a, lt, rt, nonsv=I32_NONSV)
        li, _, ri, _ = ansv_local(_t(a), lt, rt)
        np.testing.assert_array_equal(li.numpy(), want_l)
        np.testing.assert_array_equal(ri.numpy(), want_r)
    want_l, want_r = ansv_seq(a, FURTHEST_EQ, NEAREST_SM,
                              nonsv=np.iinfo(np.int64).max)
    li, lv, ri, rv = ansv_local(_t(a).long(), FURTHEST_EQ, NEAREST_SM)
    assert li.dtype == torch.int64 and lv.dtype == torch.int64
    np.testing.assert_array_equal(li.numpy(), want_l)
    np.testing.assert_array_equal(ri.numpy(), want_r)
