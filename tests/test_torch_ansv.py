"""The public ANSV (``parallel/ansv.py::ansv``) of the port against the
JAX package's ``ansv(arr, lt, rt, mesh=make_mesh(1))`` and the sequential
oracle ``ansv_seq``: all nine match-type pairs, ties, the ``nonsv``
sentinel, ``indexing="local"`` and values that do not fit int32.  The
engine dispatch (which kernel runs for which pair and dtype) is checked
with counting stand-ins for the kernels.  Exact equality (integers only).
"""

import dataclasses

import numpy as np
import pytest
import torch

from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     ansv_seq)
from psac_tpu_torch.parallel import ansv as t_ansv

torch.set_num_threads(1)

TYPES = [NEAREST_SM, NEAREST_EQ, FURTHEST_EQ]
PAIRS = [(lt, rt) for lt in TYPES for rt in TYPES]


def _inputs():
    """One tiny array and four of one padded length (one JAX compile
    each per pair): ties, plateaus, a bitonic run and wide values."""
    rng = np.random.RandomState(3)
    return {
        "tiny": np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], np.int32),
        "equal_heavy": rng.randint(0, 4, 300).astype(np.int32),
        "uniform": rng.randint(0, 10**6, 300).astype(np.int32),
        "bitonic": np.concatenate([np.arange(150),
                                   np.arange(150)[::-1]]).astype(np.int32),
        "const": np.full(300, 7, np.int32),
    }


@pytest.fixture(scope="module")
def jax_ansv(mesh1):
    from psac_tpu.parallel.ansv import ansv

    return lambda *a, **k: ansv(*a, mesh=mesh1, **k)


@pytest.mark.parametrize("lt,rt", PAIRS)
def test_public_ansv_vs_jax_and_oracle(jax_ansv, lt, rt):
    for name, a in _inputs().items():
        n = len(a)
        got = t_ansv.ansv(a, lt, rt, device="cpu")
        want = jax_ansv(a, lt, rt)
        seq = ansv_seq(a, lt, rt, nonsv=n)
        for g, w, o in zip(got, want, seq):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w, err_msg=name)
            np.testing.assert_array_equal(g, o, err_msg=name)


@pytest.mark.parametrize("lt,rt", PAIRS)
def test_public_ansv_past_one_scan_chunk(lt, rt):
    """Lengths that are not multiples of the scans' 2048-element chunk."""
    rng = np.random.RandomState(lt * 3 + rt)
    for a in (rng.randint(0, 6, 2500), rng.randint(0, 10**6, 4097)):
        a = a.astype(np.int32)
        got = t_ansv.ansv(a, lt, rt, device="cpu")
        for g, o in zip(got, ansv_seq(a, lt, rt, nonsv=len(a))):
            np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("lt,rt", [(NEAREST_SM, NEAREST_SM),
                                   (FURTHEST_EQ, NEAREST_SM),
                                   (NEAREST_EQ, FURTHEST_EQ)])
def test_nonsv_and_local_indexing(jax_ansv, lt, rt):
    a = _inputs()["equal_heavy"]
    for got, want in zip(t_ansv.ansv(a, lt, rt, device="cpu", nonsv=-7),
                         jax_ansv(a, lt, rt, nonsv=-7)):
        np.testing.assert_array_equal(got, want)
    got = t_ansv.ansv(a, lt, rt, device="cpu", indexing="local")
    want = jax_ansv(a, lt, rt, indexing="local")
    for g_side, w_side in zip(got, want):
        for g, w in zip(g_side, w_side):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        t_ansv.ansv(a, lt, rt, device="cpu", indexing="bogus")


@pytest.mark.parametrize("lt,rt", [(NEAREST_SM, NEAREST_SM),
                                   (FURTHEST_EQ, NEAREST_EQ),
                                   (FURTHEST_EQ, FURTHEST_EQ)])
def test_wide_values(jax_ansv, lt, rt):
    """Values that do not fit int32 run at int64 and are never narrowed."""
    rng = np.random.RandomState(9)
    a = (rng.randint(0, 2**31, size=333).astype(np.int64) << 10) + 5
    a[::7] = a[3]
    for arr in (a, np.full(50, np.int64(1) << 35),
                np.array([2**33, 5, 2**34, 2**34, 7, 2**33], np.int64),
                np.array([-2**40, 3, 2**31 - 1, 3], np.int64)):
        n = len(arr)
        got = t_ansv.ansv(arr, lt, rt, device="cpu")
        for g, w, o in zip(got, jax_ansv(arr, lt, rt),
                           ansv_seq(arr, lt, rt, nonsv=n)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, o)
        got = t_ansv.ansv(arr, lt, rt, device="cpu", indexing="local")
        want = jax_ansv(arr, lt, rt, indexing="local")
        for g_side, w_side in zip(got, want):
            for g, w in zip(g_side, w_side):
                np.testing.assert_array_equal(g, w)


def _counting_plain():
    """``PLAIN`` with every function counting its calls."""
    calls = {}

    def counted(name, fn):
        def run(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return run

    kernels = t_ansv.AnsvKernels(**{
        f.name: counted(f.name, getattr(t_ansv.PLAIN, f.name))
        for f in dataclasses.fields(t_ansv.AnsvKernels)})
    return kernels, calls


@pytest.mark.parametrize("lt,rt,wide,want", [
    # the suffix tree's pair: tile phase both ways, then the spine scan
    (FURTHEST_EQ, NEAREST_SM, False, {"tile_side": 2, "spine_scan": 1}),
    (FURTHEST_EQ, FURTHEST_EQ, False, {"dual_scan": 1}),
    (NEAREST_SM, NEAREST_SM, False, {"block_psv": 2}),
    (NEAREST_EQ, FURTHEST_EQ, False, {"block_psv": 1, "left_scan": 1}),
    (FURTHEST_EQ, NEAREST_EQ, False, {"left_scan": 1, "block_psv": 1}),
    (FURTHEST_EQ, NEAREST_EQ, True, {"block_psv": 2}),
    (FURTHEST_EQ, FURTHEST_EQ, True, {"block_psv": 2}),
    (FURTHEST_EQ, NEAREST_SM, True, {"block_psv": 2}),
])
def test_dispatch_by_pair_and_dtype(lt, rt, wide, want):
    rng = np.random.RandomState(4)
    a = rng.randint(0, 9, 5000).astype(np.int64)
    if wide:
        a = a << 33
    kernels, calls = _counting_plain()
    got = t_ansv.ansv(a, lt, rt, device="cpu", kernels=kernels)
    assert calls == want
    for g, o in zip(got, ansv_seq(a, lt, rt, nonsv=len(a))):
        np.testing.assert_array_equal(g, o)


def test_spine_overflow_falls_back_to_dual_scan():
    a = np.arange(5000, 0, -1).astype(np.int32)  # every row on the spine
    kernels, calls = _counting_plain()
    got = t_ansv.ansv(a, FURTHEST_EQ, NEAREST_SM, device="cpu",
                      kernels=kernels)
    assert calls == {"tile_side": 2, "dual_scan": 1}
    for g, o in zip(got, ansv_seq(a, FURTHEST_EQ, NEAREST_SM, nonsv=5000)):
        np.testing.assert_array_equal(g, o)


def test_lcp_callers_keep_their_dtype():
    """``ansv_local`` (the LCP callers) answers in the input's dtype."""
    x = torch.tensor([0, 2, 1, 3, 1], dtype=torch.int64)
    li, lv, ri, rv = t_ansv.ansv_local(x, NEAREST_SM, NEAREST_SM)
    assert li.dtype == torch.int64
    inf = t_ansv.nonsv_for(torch.int64)
    assert li.tolist() == [inf, 0, 0, 2, 0]
    assert ri.tolist() == [inf, 2, inf, 4, inf]
