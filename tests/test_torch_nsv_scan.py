"""The run-stack scans K1 (spine) and K2 (dual): the port's plain versions
against the JAX package's Pallas kernels in interpret mode, and against the
sequential oracle ``ansv_seq``.  Exact equality (integers only).  The CUDA
kernels themselves are held against these plain versions in
tests/test_torch_cuda.py, which needs a GPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psac_tpu_torch.ops import nsv_scan as t_scan
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     NONSV, _left_scan)

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
    assert int(want[-1]) == 0 and int(got[-1]) == 0
    for g, w in zip(got[:5], want[:5]):
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
    for g, w in zip(got[:4], want[:4]):
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
    from psac_tpu_torch.ops import cuda_lib
    with pytest.raises(ValueError):
        cuda_lib.check_cuda_int32("k", x)
