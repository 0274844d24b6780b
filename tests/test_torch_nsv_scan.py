"""The ANSV scans K1 (spine), K2 (dual) and K3 (left): the port's plain
versions against the JAX package's Pallas kernels in interpret mode and
against the sequential oracle ``ansv_seq``, and a numpy model of the CUDA
block engine that runs all three.  Exact equality (integers only).  The CUDA
kernels themselves are held against these plain versions in
tests/test_torch_cuda.py, which needs a GPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psac_tpu_torch.ops import nsv_scan as t_scan
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     NONSV, _left_scan, ansv_seq)

torch.set_num_threads(1)

I32_INF = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle_left(a, typ):
    out = _left_scan(a, typ)
    return np.where(out == NONSV, -1, out)


def _spine_streams(seed, s=2048, m=1500):
    """Two explicit-index streams as the tile-spine engine builds them:
    m real entries with increasing global indices, then (INF, INF)
    padding."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(2):
        g = np.full(s, I32_INF, np.int32)
        x = np.full(s, I32_INF, np.int32)
        g[:m] = np.sort(rng.choice(10 * s, m, replace=False))
        x[:m] = rng.randint(0, 6 + 20 * k, m)
        out += [x, g]
    return out  # xf, gf, xn, gn


def test_spine_plain_vs_pallas_interpret():
    from psac_tpu.ops.nsv_scan import nsv_scan_spine

    xf, gf, xn, gn = _spine_streams(0)
    want = nsv_scan_spine(*map(jnp.asarray, (xf, gf, xn, gn)), True)
    got = t_scan.nsv_scan_spine(*map(_t, (xf, gf, xn, gn)))
    assert int(want[-1]) == 0 and len(got) == 5
    for g, w in zip(got, want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("typs", [(FURTHEST_EQ, NEAREST_SM),
                                  (NEAREST_EQ, FURTHEST_EQ),
                                  (NEAREST_SM, NEAREST_EQ)])
def test_dual_plain_vs_pallas_interpret(typs):
    from psac_tpu.ops.nsv_scan import nsv_scan_dual

    rng = np.random.RandomState(sum(typs))
    x = rng.randint(0, 9, 2048).astype(np.int32)
    x[100:400] = 4  # a long equal run
    xr = x[::-1].copy()
    want = nsv_scan_dual(jnp.asarray(x), jnp.asarray(xr), *typs, True)
    got = t_scan.nsv_scan_dual(_t(x), _t(xr), *typs)
    assert int(want[-1]) == 0 and len(got) == 4
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("typ", [NEAREST_SM, NEAREST_EQ, FURTHEST_EQ])
def test_left_plain_vs_pallas_interpret(typ):
    from psac_tpu.ops.nsv_scan import CHUNK, nsv_scan_left

    rng = np.random.RandomState(11 + typ)
    for x in (rng.randint(0, 5, 2 * CHUNK), rng.randint(0, 10**6, CHUNK),
              np.repeat(rng.randint(0, 3, 64), 64)):
        x = x.astype(np.int32)
        want = nsv_scan_left(jnp.asarray(x), typ, True)
        got = t_scan.nsv_scan_left(_t(x), typ)
        assert int(want[2]) == 0 and len(got) == 2
        for g, w in zip(got, want[:2]):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("typ", [NEAREST_SM, NEAREST_EQ, FURTHEST_EQ])
@pytest.mark.parametrize("kind", ["random", "runs", "increasing",
                                  "decreasing", "negative"])
def test_left_matches_vs_oracle(typ, kind):
    rng = np.random.RandomState(len(kind) + typ)
    n = 3001
    x = {"random": rng.randint(0, 50, n),
         "runs": np.repeat(rng.randint(0, 4, 150), 20)[:n],
         "increasing": np.arange(n),
         "decreasing": np.arange(n, 0, -1),
         "negative": np.concatenate([np.full(9, -1), [0],
                                     rng.randint(0, 3, n - 10)]),
         }[kind].astype(np.int32)
    idx, val = t_scan.left_matches_plain(_t(x), typ)
    want = _oracle_left(x, typ)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(
        val.numpy(), np.where(want >= 0, x[np.maximum(want, 0)], 0))


def test_spine_plain_run_first_output():
    """f_h = the FURTHEST_EQ chain's top run first after merge/push: the
    match when an equal is visible, else the element's own index."""
    x = np.array([5, 3, 3, 7, 3, 2, 2, 9, 2], np.int32)
    g = np.arange(100, 109, dtype=np.int32)
    fi, fv, fh, *_ = t_scan.nsv_scan_spine(_t(x), _t(g), _t(x), _t(g))
    np.testing.assert_array_equal(
        fi.numpy(), [-1, -1, 101, 101, 101, -1, 105, 105, 105])
    np.testing.assert_array_equal(
        fh.numpy(), [100, 101, 101, 103, 101, 105, 105, 107, 105])
    np.testing.assert_array_equal(fv.numpy(), [0, 0, 3, 3, 3, 0, 2, 2, 2])


def test_wrappers_reject_bad_tensors():
    x = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises((ValueError, RuntimeError)):
        t_scan.nsv_scan_dual(x.to("meta"), x.to("meta"), 0, 0)
    with pytest.raises((ValueError, RuntimeError)):
        t_scan.nsv_scan_left(x.to("meta"), 0)
    from psac_tpu_torch.ops import cuda_lib
    with pytest.raises(ValueError):
        cuda_lib.check_cuda_int32("k", x)


# ---------------------------------------------------------------------------
# K2/K3 block engine: adversaries of a minima hierarchy, and a numpy model
# of the CUDA kernel's search at a tiny group width
# ---------------------------------------------------------------------------

SAW = 1024  # the CUDA kernel's tile: a sawtooth of this period crosses it


def _adversaries():
    """Inputs that stress the block engine (lengths multiples of CHUNK)."""
    rng = np.random.RandomState(5)
    n = 4096
    i = np.arange(n)
    return {
        "all_equal": np.full(n, 7),
        "sawtooth": i // SAW * SAW + SAW - 1 - i % SAW,
        "decreasing": i[::-1] + 1,
        "increasing": i,
        "max_lead": np.concatenate([np.full(1500, I32_INF),
                                    rng.randint(0, 5, n - 1500)]),
        "short_runs": np.repeat(rng.randint(0, 3, n // 16), 16),
    }


@pytest.mark.parametrize("kind", sorted(_adversaries()))
def test_adversaries_plain_vs_pallas_interpret(kind):
    from psac_tpu.ops.nsv_scan import nsv_scan_dual, nsv_scan_left

    x = _adversaries()[kind].astype(np.int32)
    xr = x[::-1].copy()
    for typ in (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ):
        want = nsv_scan_left(jnp.asarray(x), typ, True)
        got = t_scan.nsv_scan_left(_t(x), typ)
        assert int(want[2]) == 0 and len(got) == 2
        for g, w in zip(got, want[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = nsv_scan_dual(jnp.asarray(x), jnp.asarray(xr), FURTHEST_EQ,
                         NEAREST_SM, True)
    got = t_scan.nsv_scan_dual(_t(x), _t(xr), FURTHEST_EQ, NEAREST_SM)
    assert int(want[-1]) == 0 and len(got) == 4
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", sorted(_adversaries()))
def test_adversaries_plain_vs_oracle(kind):
    x = _adversaries()[kind].astype(np.int32)
    s = len(x)
    for typ in (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ):
        idx, val = t_scan.nsv_scan_left(_t(x), typ)
        want = _oracle_left(x, typ)
        np.testing.assert_array_equal(idx.numpy(), want)
        np.testing.assert_array_equal(
            val.numpy(), np.where(want >= 0, x[np.maximum(want, 0)], 0))
    for lt, rt in ((FURTHEST_EQ, FURTHEST_EQ), (NEAREST_EQ, NEAREST_SM)):
        il, _, ir, _ = t_scan.nsv_scan_dual(_t(x), _t(x[::-1].copy()),
                                            lt, rt)
        wl, wr = ansv_seq(x, lt, rt, nonsv=-1)
        np.testing.assert_array_equal(il.numpy(), wl)
        ir = ir.numpy()[::-1]
        np.testing.assert_array_equal(np.where(ir < 0, -1, s - 1 - ir), wr)


class _BlockEngineModel:
    """The search of ``csrc/nsv_scan.cu``'s K2/K3 engine in numpy, with the
    kernel's group width G as a parameter: the minima hierarchy, the
    neighbour fast paths, the group-wide 'ballots' that climb and descend,
    and FURTHEST_EQ as H(PSV<=(i)).  Every read asserts that it stays
    inside its level, and each descent that the group it reads is full,
    which is what the kernel relies on to read without masks."""

    def __init__(self, x, G):
        self.G = G
        self.lv = [np.asarray(x, np.int64)]
        while len(self.lv[-1]) > G:
            a = self.lv[-1]
            pad = np.full(-len(a) % G, np.iinfo(np.int64).max)
            self.lv.append(np.concatenate([a, pad]).reshape(-1, G).min(1))

    def at(self, k, e):
        assert 0 <= e < len(self.lv[k]), (k, e)
        return self.lv[k][e]

    def prev(self, i, v, strict):
        """Largest j < i with x[j] < v (strict) or <= v; -1 if none."""
        G = self.G
        hit = (lambda a: a < v) if strict else (lambda a: a <= v)
        p, k = i, 0
        while True:
            if p <= 0:
                return -1
            lo = (p - 1) // G * G
            lanes = [e for e in range(lo, lo + G)
                     if e < p and hit(self.at(k, e))]
            if lanes:
                j = max(lanes)
                break
            if lo == 0 or k + 1 == len(self.lv):
                return -1
            p, k = lo // G, k + 1
        while k > 0:
            k -= 1
            j = max(e for e in range(j * G, j * G + G) if hit(self.at(k, e)))
        return j

    def next(self, q, v):
        """Smallest j >= q with x[j] <= v; -1 if none."""
        G = self.G
        k = 0
        while True:
            n = len(self.lv[k])
            if q >= n:
                return -1
            lo = q // G * G
            lanes = [e for e in range(lo, lo + G)
                     if q <= e < n and self.at(k, e) <= v]
            if lanes:
                j = min(lanes)
                break
            if k + 1 == len(self.lv):
                return -1
            q, k = lo // G + 1, k + 1
        while k > 0:
            k -= 1
            n = len(self.lv[k])
            j = min(e for e in range(j * G, j * G + G)
                    if e < n and self.at(k, e) <= v)
        return j

    def left(self, typ):
        x = self.lv[0]
        idx = np.full(len(x), -1, np.int64)
        for i in range(len(x)):
            v = x[i]
            strict = typ == NEAREST_SM
            if i > 0 and (x[i - 1] < v if strict else x[i - 1] <= v):
                t = i - 1
            else:
                t = self.prev(i, v, strict)
            if typ == FURTHEST_EQ and t >= 0:
                vt = x[t]
                u = (t - 1 if t > 0 and x[t - 1] < vt
                     else self.prev(t, vt, True))
                h = u + 1 if x[u + 1] <= vt else self.next(u + 1, vt)
                assert u < h <= t and x[h] == vt
                t = h
            idx[i] = t
        return idx


def _model_inputs():
    """The adversaries at the model's scale, and lengths G^k - 1, G^k and
    G^k + 1 around the levels of a G = 4 hierarchy."""
    rng = np.random.RandomState(8)
    cases = {k: v[:700] for k, v in _adversaries().items()}
    cases["max_lead"] = np.concatenate([np.full(70, I32_INF),
                                        rng.randint(0, 4, 630)])
    cases["sawtooth"] = np.arange(700) // 16 * 16 + 15 - np.arange(700) % 16
    for n in (3, 4, 5, 15, 17, 63, 65, 255, 257):
        cases[f"len{n}"] = rng.randint(0, 4, n)
    cases["negative"] = np.concatenate([np.full(9, -1), [0],
                                        rng.randint(0, 3, 190)])
    return cases


@pytest.mark.parametrize("kind", sorted(_model_inputs()))
def test_block_engine_model_vs_oracle(kind):
    x = _model_inputs()[kind].astype(np.int32)
    for G in (4, 32):
        model = _BlockEngineModel(x, G)
        for typ in (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ):
            np.testing.assert_array_equal(model.left(typ),
                                          _oracle_left(x, typ),
                                          err_msg=f"G={G} typ={typ}")


# ---------------------------------------------------------------------------
# K1 on the block engine: both spine streams through the engine's search,
# then the kernel's explicit-index mapping and its run-first rule
# ---------------------------------------------------------------------------

def _spine_engine_model(xf, gf, xn, gn, G):
    """K1 as ``csrc/nsv_scan.cu`` computes it: FURTHEST_EQ matches r and
    PSV<=(i) = t of stream f, NEAREST_SM matches of stream n, each from
    ``_BlockEngineModel``; answers are g[r] (-1 kept), and the run first is
    g[r] when x[t] equals x[i] (the element merges into the top run), else
    g[i]."""
    out = []
    for x, g, typ in ((xf, gf, FURTHEST_EQ), (xn, gn, NEAREST_SM)):
        model = _BlockEngineModel(x, G)
        r = model.left(typ)
        hit = r >= 0
        rs = np.maximum(r, 0)
        out += [np.where(hit, g[rs], -1), np.where(hit, x[rs], 0)]
        if typ == FURTHEST_EQ:
            t = model.left(NEAREST_EQ)  # the engine's first phase
            has_eq = (t >= 0) & (x[np.maximum(t, 0)] == x)
            out.append(g[np.where(has_eq, rs, np.arange(len(x)))])
    return tuple(out)  # fi, fv, fh, ni, nv


def _pack_spines(x):
    """The two spine streams of ``x`` (padded at the end with I32_INF to a
    multiple of CHUNK, as ``ansv_local`` pads it) without a capacity:
    (xf, gf, xn, gn) in numpy."""
    from psac_tpu_torch.ops import tansv

    s = -(-len(x) // t_scan.CHUNK) * t_scan.CHUNK
    xp = _t(np.concatenate([x, np.full(s - len(x), I32_INF)]).astype(np.int32))
    kf, vf, kn, vn = tansv.spine_streams(
        xp, tansv.tile_side_plain(xp, True)[3],
        tansv.tile_side_plain(xp.flip(0), False)[3])
    return [t.numpy() for t in (vf, kf, vn, kn)]


def _spine_cases():
    """Spine streams of the model's adversaries (each with the I32_INF
    padding run of its tiles and the (I32_INF, I32_INF) stream padding),
    of the suffix tree's -1 padding rows, and streams of one value."""
    rng = np.random.RandomState(21)
    cases = {k: _pack_spines(v.astype(np.int32))
             for k, v in _model_inputs().items()}
    cases["st_padding"] = _pack_spines(np.concatenate(
        [np.full(300, -1), [0], rng.randint(0, 9, 1747)]).astype(np.int32))
    g = np.sort(rng.choice(10**6, 2048, replace=False)).astype(np.int32)
    eq = np.full(2048, 7, np.int32)
    eq[1900:] = I32_INF
    cases["all_equal_stream"] = [eq, g, eq.copy(), g.copy()]
    return cases


SPINE_CASES = _spine_cases()


@pytest.mark.parametrize("kind", sorted(SPINE_CASES))
def test_spine_engine_model_vs_plain(kind):
    """The model of K1 on the engine equals K1's plain version at group
    widths 4 and 32."""
    xf, gf, xn, gn = SPINE_CASES[kind]
    want = t_scan.nsv_scan_spine_plain(*map(_t, (xf, gf, xn, gn)))
    for G in (4, 32):
        got = _spine_engine_model(xf, gf, xn, gn, G)
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w.numpy(),
                                          err_msg=f"G={G} output {k}")


@pytest.mark.parametrize("kind", ["all_equal", "all_equal_stream",
                                  "decreasing", "max_lead", "sawtooth",
                                  "st_padding"])
def test_spine_cases_plain_vs_pallas_interpret(kind):
    from psac_tpu.ops.nsv_scan import nsv_scan_spine

    xf, gf, xn, gn = SPINE_CASES[kind]
    want = nsv_scan_spine(*map(jnp.asarray, (xf, gf, xn, gn)), True)
    got = t_scan.nsv_scan_spine(*map(_t, (xf, gf, xn, gn)))
    assert int(want[-1]) == 0 and len(got) == 5
    for k, (g, w) in enumerate(zip(got, want[:5])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"output {k}")


def test_spine_padding_changes_no_real_answer():
    """Appending (I32_INF, I32_INF) entries to both streams leaves every
    answer of the real entries as it was."""
    xf, gf, xn, gn = SPINE_CASES["st_padding"]
    real = int((gf != I32_INF).sum())
    short = t_scan.nsv_scan_spine_plain(
        *(_t(a[:real]) for a in (xf, gf, xn, gn)))
    long_ = t_scan.nsv_scan_spine_plain(*map(_t, (xf, gf, xn, gn)))
    for g, w in zip(long_, short):
        np.testing.assert_array_equal(g.numpy()[:real], w.numpy())
    model = _spine_engine_model(xf, gf, xn, gn, 32)
    for g, w in zip(model, short):
        np.testing.assert_array_equal(g[:real], w.numpy())
