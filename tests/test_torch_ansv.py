"""The public ANSV (``parallel/ansv.py::ansv``) of the port against the
JAX package's ``ansv(arr, lt, rt, mesh=make_mesh(1))`` and the sequential
oracle ``ansv_seq``: all nine match-type pairs, ties, the ``nonsv``
sentinel, ``indexing="local"`` and values that do not fit int32.  The
engine dispatch (which kernel runs for which pair and dtype) is checked
with counting stand-ins for the kernels.  Exact equality (integers only).
"""

import dataclasses
import functools

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
    # the suffix tree's pair: one dual scan
    (FURTHEST_EQ, NEAREST_SM, False, {"dual_scan": 1}),
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
    """The spine engine has no capacity: an array whose every row is on
    the spine (past the JAX engine's s / 16) runs the tile phase and the
    spine scan, and its answers equal ``ansv_seq``."""
    a = np.arange(5000, 0, -1).astype(np.int32)  # every row on the spine
    kernels, calls = _counting_plain()
    got = t_ansv.ansv(a, FURTHEST_EQ, NEAREST_SM, device="cpu",
                      kernels=kernels, engine="spine")
    assert calls == {"tile_side": 2, "spine_scan": 1}
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


# ---------------------------------------------------------------------------
# the engine selector (engine= / PSAC_NSV)
# ---------------------------------------------------------------------------

def _engine_input(wide: bool) -> np.ndarray:
    """Ties and a bitonic run: one scan chunk's length in int32; shorter in
    int64, which no scan pads."""
    rng = np.random.RandomState(12)
    k = 200 if wide else 400
    a = np.concatenate([rng.randint(0, 9, 3 * k), np.arange(k),
                        np.arange(k)[::-1]])
    return a.astype(np.int64) << 33 if wide else a.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _engine_oracle(wide: bool) -> dict:
    """``ansv_seq`` of the input for each pair (shared by the engines)."""
    a = _engine_input(wide)
    return {(lt, rt): ansv_seq(a, lt, rt, nonsv=len(a)) for lt, rt in PAIRS}


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("engine", t_ansv.ENGINES)
def test_every_engine_vs_oracle(engine, wide):
    """Every engine, every pair, int32 and int64 values, == ``ansv_seq``."""
    a, want = _engine_input(wide), _engine_oracle(wide)
    for lt, rt in PAIRS:
        got = t_ansv.ansv(a, lt, rt, device="cpu", engine=engine)
        for g, o in zip(got, want[lt, rt]):
            np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("engine,lt,rt,want", [
    ("scan", NEAREST_SM, NEAREST_SM, {"dual_scan": 1}),
    ("scan", FURTHEST_EQ, NEAREST_SM, {"dual_scan": 1}),
    ("scan", NEAREST_EQ, NEAREST_EQ, {"dual_scan": 1}),
    ("block", NEAREST_SM, NEAREST_SM, {"block_psv": 2}),
    ("block", FURTHEST_EQ, NEAREST_SM, {"block_psv": 2}),
    ("block", FURTHEST_EQ, FURTHEST_EQ, {"block_psv": 2}),
    ("spine", FURTHEST_EQ, NEAREST_SM, {"tile_side": 2, "spine_scan": 1}),
    ("spine", NEAREST_EQ, NEAREST_EQ, {"block_psv": 2}),
    ("hybrid", NEAREST_EQ, NEAREST_EQ, {"block_psv": 2}),
])
def test_dispatch_by_engine(engine, lt, rt, want):
    rng = np.random.RandomState(5)
    a = rng.randint(0, 9, 5000).astype(np.int32)
    kernels, calls = _counting_plain()
    got = t_ansv.ansv(a, lt, rt, device="cpu", kernels=kernels,
                      engine=engine)
    assert calls == want
    for g, o in zip(got, ansv_seq(a, lt, rt, nonsv=len(a))):
        np.testing.assert_array_equal(g, o)
    # int64 values run the block engine under every engine
    kernels, calls = _counting_plain()
    t_ansv.ansv(a.astype(np.int64) << 33, lt, rt, device="cpu",
                kernels=kernels, engine=engine)
    assert calls == {"block_psv": 2}


def test_engine_from_the_environment(monkeypatch):
    """``engine=None`` reads ``PSAC_NSV``, and takes ``hybrid`` where it is
    unset; an explicit engine wins; ``ansv_local`` (the suffix tree's and
    the DESA's pass) honours it too."""
    a = np.random.RandomState(6).randint(0, 9, 3000).astype(np.int32)
    monkeypatch.delenv("PSAC_NSV", raising=False)
    assert t_ansv.resolve_engine() == "hybrid"
    monkeypatch.setenv("PSAC_NSV", "scan")
    assert t_ansv.resolve_engine() == "scan"
    assert t_ansv.resolve_engine("block") == "block"
    kernels, calls = _counting_plain()
    t_ansv.ansv(a, NEAREST_SM, NEAREST_SM, device="cpu", kernels=kernels)
    assert calls == {"dual_scan": 1}
    kernels, calls = _counting_plain()
    t_ansv.ansv_local(torch.from_numpy(a), FURTHEST_EQ, NEAREST_SM, kernels)
    assert calls == {"dual_scan": 1}
    kernels, calls = _counting_plain()
    t_ansv.ansv_local(torch.from_numpy(a), FURTHEST_EQ, NEAREST_SM, kernels,
                      engine="block")
    assert calls == {"block_psv": 2}


@pytest.mark.parametrize("engine", ["bogus"])
def test_unported_and_unknown_engines_raise(monkeypatch, engine):
    a = np.arange(10, dtype=np.int32)
    with pytest.raises(ValueError, match="engine"):
        t_ansv.ansv(a, device="cpu", engine=engine)
    monkeypatch.setenv("PSAC_NSV", engine)
    with pytest.raises(ValueError, match="engine"):
        t_ansv.ansv(a, device="cpu")


def test_walk_engine_from_the_environment(monkeypatch):
    """``PSAC_NSV=walk`` selects the walk engine (``ops/walk.py``), which
    answers as ``ansv_seq`` does, as ``engine="walk"`` does, through the
    kernels' walk fields only (one previous-smaller walk a side)."""
    a = np.random.RandomState(8).randint(0, 9, 500).astype(np.int32)
    want = ansv_seq(a, NEAREST_SM, NEAREST_SM, nonsv=len(a))
    monkeypatch.setenv("PSAC_NSV", "walk")
    assert t_ansv.resolve_engine() == "walk"
    kernels, calls = _counting_plain()
    for got in (t_ansv.ansv(a, device="cpu", kernels=kernels),
                t_ansv.ansv(a, device="cpu", engine="walk")):
        for g, o in zip(got, want):
            np.testing.assert_array_equal(g, o)
    assert calls == {"walk_prev_lt": 2}
