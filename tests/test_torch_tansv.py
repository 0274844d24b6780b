"""Tile-spine ANSV: the tile phase (K4's plain version) against the JAX
``_tile_side``, the whole engine against interpret-mode
``tansv_feq_nsm`` and ``ansv_seq`` (also on spines past the JAX engine's
capacity), and ``ansv_local`` on the default and the spine engine.  Exact
equality (integers only)."""

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
    _check_vs_oracle(a, *t_tansv.tansv_feq_nsm(_t(a)))


@pytest.mark.parametrize("name", ["straddle", "random_small_alpha"])
def test_tansv_vs_jax_interpret(name):
    from psac_tpu.ops.tansv import tansv_feq_nsm

    a = CASES[name]
    want = jax.jit(tansv_feq_nsm, static_argnums=(1, 2, 3))(
        jnp.asarray(a), len(a), (), True)
    got = t_tansv.tansv_feq_nsm(_t(a))
    assert int(want[-1]) == 0  # the JAX engine's spine capacity holds
    assert len(got) == 4
    for g, w in zip(got, want[:4]):
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
        _check_vs_oracle(a, *t_tansv.tansv_feq_nsm(_t(a)))


def test_tansv_overflow_reported():
    """A strictly decreasing array: every element is on the spine, past
    the JAX engine's capacity of s / 16 rows; the engine has none and
    answers as ``ansv_seq`` does."""
    a = np.arange(4096, 0, -1).astype(np.int32)
    _check_vs_oracle(a, *t_tansv.tansv_feq_nsm(_t(a)))


_LOCAL_KINDS = ["decreasing", "increasing", "st_padding", "odd_length"]


@pytest.mark.parametrize("kind,engine", [
    *(pytest.param(k, "hybrid", id=k) for k in _LOCAL_KINDS),
    *(pytest.param(k, "spine", id=f"{k}-spine") for k in _LOCAL_KINDS)])
def test_ansv_local_spine_and_fallback(kind, engine):
    """ansv_local on the default engine (the dual scan, unpadded) and on
    the spine engine (padded at the end to a multiple of 2048, every spine
    scanned whole): the answers equal ansv_seq."""
    rng = np.random.RandomState(5)
    a = {"decreasing": np.arange(5000, 0, -1),
         "increasing": np.arange(3000),
         "st_padding": np.concatenate([np.full(700, -1), [0],
                                       rng.randint(0, 9, 3395)]),
         "odd_length": rng.randint(0, 4, 2049)}[kind].astype(np.int32)
    want_l, want_r = ansv_seq(a, FURTHEST_EQ, NEAREST_SM, nonsv=I32_NONSV)
    li, lv, ri, rv = ansv_local(_t(a), FURTHEST_EQ, NEAREST_SM,
                                engine=engine)
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


# ---------------------------------------------------------------------------
# A numpy model of the K4 kernel's steps (csrc/tansv_tile.cu)
# ---------------------------------------------------------------------------

def _tile_engine_model(a, with_eq):
    """``csrc/tansv_tile.cu`` in numpy, one tile at a time: the doubling
    min-table, psv and e by nine-step binary lifting, sufvis as a range
    minimum of two table entries, and nxt from per-warp ballots.  Every
    table read asserts that the entry is defined (j + 2^k <= T), as the
    kernel reads the table without masks."""
    T, LOG_T, W = t_tansv.T, 9, 32
    i = np.arange(T)
    outs = [[] for _ in range(7)]
    for tile in range(len(a) // T):
        t = a[tile * T:(tile + 1) * T].astype(np.int64)
        base = tile * T
        lv = [t]
        for k in range(1, LOG_T):
            w = 1 << (k - 1)
            lv.append(np.minimum(lv[-1][:-w], lv[-1][w:]))
        assert all(len(lv[k]) == T - (1 << k) + 1 for k in range(LOG_T))

        def read(k, j, ok):
            assert (j[ok] >= 0).all() and (j[ok] < len(lv[k])).all()
            return lv[k][np.where(ok, j, 0)]

        skip = np.zeros(T, np.int64)
        for k in reversed(range(LOG_T)):
            w = 1 << k
            lo = i - skip - w
            ok = lo >= 0
            skip += np.where(ok & (read(k, lo, ok) >= t), w, 0)
        psv = i - skip - 1
        chain = psv < 0
        prefix = np.minimum.accumulate(np.concatenate([[I32_NONSV], t]))[:T]
        np.testing.assert_array_equal(chain, prefix >= t)

        sufvis = np.ones(T, bool)
        inner = i < T - 1
        kk = np.floor(np.log2(np.maximum(T - 1 - i, 1))).astype(int)
        for k in range(LOG_T):
            sel = inner & (kk == k)
            m = np.minimum(read(k, i + 1, sel), read(k, np.full(T, T - (1 << k)),
                                                      sel))
            sufvis[sel] = t[sel] <= m[sel]
        run_first = np.concatenate([[True], t[1:] != t[:-1]])
        run_last = np.concatenate([t[:-1] != t[1:], [True]])
        spine = (chain | sufvis) & (run_first | run_last)

        masks = spine.reshape(T // W, W)
        nxt = np.full(T, T)
        for j in range(T):
            w, lane = divmod(j, W)
            here = np.flatnonzero(masks[w, lane:])
            later = [u for u in range(w + 1, T // W) if masks[u].any()]
            if len(here):
                nxt[j] = w * W + lane + here[0]
            elif later:
                nxt[j] = later[0] * W + np.flatnonzero(masks[later[0]])[0]

        cols = [np.where(chain, -1, base + psv),
                np.where(chain, 0, t[np.maximum(psv, 0)]), chain, spine, nxt]
        if with_eq:
            start = psv + 1
            fwd = np.zeros(T, np.int64)
            for k in reversed(range(LOG_T)):
                w = 1 << k
                lo = start + fwd
                ok = lo + w <= T
                fwd += np.where(ok & (read(k, lo, ok) > t), w, 0)
            e = start + fwd
            assert (e <= i).all()
            cols += [np.where(e < i, base + e, I32_NONSV), base + e]
        for acc, col in zip(outs, cols):
            acc.append(col)
    return [np.concatenate(acc) if acc else None for acc in outs]


def _tile_engine_cases():
    """The tile-boundary adversaries, random LCP arrays, a tile of one
    value, strictly decreasing and increasing tiles, and negative values
    (the suffix tree's -1 padding rows)."""
    from psac_tpu_torch.ops.oracle import lcp_kasai, suffix_array_np

    rng = np.random.RandomState(17)
    cases = dict(CASES)
    text = bytes(rng.randint(97, 101, 2100).astype(np.uint8))
    cases["lcp_random"] = lcp_kasai(text, suffix_array_np(text))[:2048]
    rep = bytes(rng.randint(97, 99, 300).astype(np.uint8)) * 7
    cases["lcp_repetitive"] = lcp_kasai(rep, suffix_array_np(rep))[:2048]
    cases["one_value_tile"] = np.full(512, 3)
    cases["decreasing_tile"] = np.arange(512, 0, -1)
    cases["increasing_tile"] = np.arange(512)
    cases["negative"] = np.concatenate([np.full(600, -1), [0],
                                        rng.randint(-3, 9, 423)])
    return {k: np.asarray(v).astype(np.int32) for k, v in cases.items()}


ENGINE_CASES = _tile_engine_cases()


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_tile_engine_model_vs_plain(name):
    """The model of the K4 kernel equals K4's plain version (and, on
    non-negative input, the JAX ``_tile_side``), both directions, with
    and without the equal search."""
    from psac_tpu.ops.tansv import _tile_side

    a = ENGINE_CASES[name]
    fn = jax.jit(_tile_side, static_argnums=(1, 2))
    for arr in (a, a[::-1].copy()):
        for with_eq in (True, False):
            got = _tile_engine_model(arr, with_eq)
            want = t_tansv.tile_side_plain(_t(arr), with_eq)
            jax_ok = (arr >= 0).all()
            jwant = fn(jnp.asarray(arr), len(arr) // t_tansv.T, with_eq)
            for k, (g, w, jw) in enumerate(zip(got, want, jwant)):
                if w is None:
                    assert g is None and jw is None
                    continue
                np.testing.assert_array_equal(g, w.numpy(),
                                              err_msg=f"{k} eq={with_eq}")
                if jax_ok:
                    np.testing.assert_array_equal(
                        g, np.asarray(jw).reshape(-1), err_msg=f"jax {k}")
