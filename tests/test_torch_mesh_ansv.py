"""The ANSV and the suffix tree on a mesh of p > 1 CPU shards, against the
JAX package on the conftest's virtual devices and the sequential oracles:
the hierarchical-window walks (``ops/walk.py``) against the JAX walks;
``ansv_mesh_local`` for the 9 match-type pairs, int32 and int64, against
the JAX ``ansv_local`` under ``shard_map`` and ``ansv_seq``; the public
``ansv(..., mesh=)`` in both indexings, with a forced routing overflow and
its retry; the suffix tree at p = 4 and 8 against the JAX node table and
``suffix_tree_oracle``, at p = 3 against the oracle, and with its capscale
retry forced.  Exact equality (integers only)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from psac_tpu.ops import walk as j_walk
from psac_tpu.parallel.mesh import AXIS, block_sharding
from psac_tpu.parallel.mesh import make_mesh as j_make_mesh
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.models import suffix_tree as t_st
from psac_tpu_torch.ops import walk as t_walk
from psac_tpu_torch.ops.alphabet import Alphabet, rand_dna, rep_dna
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     ansv_seq)
from psac_tpu_torch.ops.oracle import lcp_kasai, suffix_array_np
from psac_tpu_torch.parallel import ansv as t_ansv
from psac_tpu_torch.parallel.mesh import Rep, make_mesh
from psac_tpu_torch.verify.suffix_tree_oracle import suffix_tree_oracle

torch.set_num_threads(1)

TYPES = (NEAREST_SM, NEAREST_EQ, FURTHEST_EQ)
PAIRS = [(lt, rt) for lt in TYPES for rt in TYPES]


@functools.lru_cache(maxsize=None)
def cpu_mesh(p: int):
    return make_mesh(p, ["cpu"] * p)


def x64(wide: bool):
    """The JAX package's scoped x64 context for int64 values."""
    from psac_tpu.models.suffix_array import _x64_ctx

    return _x64_ctx(jnp.int64 if wide else jnp.int32)


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [5, 128, 1000, 20000])
def test_walks_vs_jax(n, dtype):
    """Both walks, strict and not, from random starts (and 0 and n) for
    random query values, over one to three tree levels."""
    rng = np.random.RandomState(n)
    x = rng.randint(0, 40, n).astype(dtype)
    q = 600
    start = np.concatenate([[0, n], rng.randint(0, n + 1, q - 2)])
    v = rng.randint(-1, 42, q).astype(dtype)
    with x64(dtype == np.int64):
        jl = j_walk.build_levels(jnp.asarray(x))
        tl = t_walk.build_levels(torch.from_numpy(x))
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for strict in (True, False):
            for jf, tf in ((j_walk.levels_prev_lt, t_walk.levels_prev_lt),
                           (j_walk.levels_next_leq, t_walk.levels_next_leq)):
                want = np.asarray(jf(jl, jnp.asarray(start, jnp.int32),
                                     jnp.asarray(v), strict=strict))
                got = tf(tl, torch.from_numpy(start), torch.from_numpy(v),
                         strict=strict)
                np.testing.assert_array_equal(got.numpy(), want)


def test_walks_in_chunks(monkeypatch):
    """Queries past one chunk go in chunks, with the same answers."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randint(0, 9, 3000).astype(np.int32))
    start = torch.from_numpy(rng.randint(0, 3001, 5000))
    v = torch.from_numpy(rng.randint(0, 10, 5000).astype(np.int32))
    tl = t_walk.build_levels(x)
    whole = (t_walk.levels_prev_lt(tl, start, v),
             t_walk.levels_next_leq(tl, start, v))
    monkeypatch.setattr(t_walk, "_QCHUNK", 777)
    assert torch.equal(t_walk.levels_prev_lt(tl, start, v), whole[0])
    assert torch.equal(t_walk.levels_next_leq(tl, start, v), whole[1])


# ---------------------------------------------------------------------------
# ansv_mesh_local and the public ansv
# ---------------------------------------------------------------------------

def _values(kind: str, n: int, dtype):
    rng = np.random.RandomState(n)
    if kind == "small":
        a = rng.randint(0, 4, n)
    elif kind == "runs":
        a = np.repeat(rng.randint(0, 6, -(-n // 9)), 9)[:n]
    else:  # a decreasing staircase: every match is shards away
        a = np.repeat(np.arange(n // 8 + 1, 0, -1), 8)[:n]
    if dtype == np.int64:
        a = (a.astype(np.int64) << 34) - (1 << 40)
    return a.astype(dtype)


def _mesh_local(ctx, x, lt, rt):
    *res, ovf = t_ansv.ansv_mesh_local(ctx, x, lt, rt)
    return (*res, Rep(int(ovf)))


@functools.lru_cache(maxsize=None)
def _jax_ansv_local(p: int, N: int, lt: int, rt: int, wide: bool):
    from psac_tpu.parallel.ansv import ansv_local

    mesh = j_make_mesh(p)
    return mesh, jax.jit(jax.shard_map(
        functools.partial(ansv_local, s=N // p, p=p, left_type=lt,
                          right_type=rt),
        mesh=mesh, in_specs=(P(AXIS),), out_specs=(P(AXIS),) * 4 + (P(),)))


@pytest.mark.parametrize("p,kind,dtype", [
    (2, "small", np.int32), (2, "runs", np.int64), (2, "staircase", np.int32),
    (4, "small", np.int64), (4, "runs", np.int32), (4, "staircase", np.int64),
    (8, "staircase", np.int32)])
def test_ansv_mesh_local_vs_oracle(p, kind, dtype):
    """Every pair: the global indices and values of ``ansv_mesh_local``
    against ``ansv_seq`` on the whole array."""
    N = 48 * p
    a = _values(kind, N, dtype)
    xs = cpu_mesh(p).shard(torch.from_numpy(a))
    inf = np.iinfo(dtype).max
    for lt, rt in PAIRS:
        li, lv, ri, rv, ovf = cpu_mesh(p).run(_mesh_local, xs, lt, rt)
        assert ovf == 0
        wl, wr = ansv_seq(a, lt, rt, nonsv=inf)
        np.testing.assert_array_equal(li.gather().numpy(), wl)
        np.testing.assert_array_equal(ri.gather().numpy(), wr)
        for idx, val in ((wl, lv), (wr, rv)):
            want = np.where(idx == inf, 0, a[np.minimum(idx, N - 1)])
            np.testing.assert_array_equal(val.gather().numpy(), want)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_ansv_mesh_local_vs_jax(wide):
    """All four outputs of every pair against the JAX ``ansv_local`` at
    p = 4 (int32) or p = 8 (int64)."""
    p = 8 if wide else 4
    N = 64 * p
    dtype = np.int64 if wide else np.int32
    a = _values("runs", N, dtype)
    xs = cpu_mesh(p).shard(torch.from_numpy(a))
    pairs = PAIRS if not wide else [(FURTHEST_EQ, NEAREST_SM),
                                    (NEAREST_EQ, FURTHEST_EQ)]
    with x64(wide):
        for lt, rt in pairs:
            mesh, fn = _jax_ansv_local(p, N, lt, rt, wide)
            want = fn(jax.device_put(a, block_sharding(mesh)))
            got = cpu_mesh(p).run(_mesh_local, xs, lt, rt)
            for g, w in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(g.gather().numpy(),
                                              np.asarray(w))


@pytest.mark.parametrize("indexing", ["global", "local"])
@pytest.mark.parametrize("lt,rt", [(NEAREST_SM, NEAREST_SM),
                                   (FURTHEST_EQ, NEAREST_SM),
                                   (NEAREST_EQ, NEAREST_EQ)])
def test_public_ansv_on_a_mesh_vs_jax(lt, rt, indexing):
    """The public ``ansv(..., mesh=)`` at p = 4 (a length that is not a
    multiple of the shards) against the JAX package's, both indexings."""
    from psac_tpu.parallel.ansv import ansv as j_ansv

    a = _values("runs", 1000, np.int32)
    got = t_ansv.ansv(a, lt, rt, mesh=cpu_mesh(4), indexing=indexing)
    want = j_ansv(a, lt, rt, mesh=j_make_mesh(4), indexing=indexing)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    if indexing == "global":
        for g, o in zip(got, ansv_seq(a, lt, rt, nonsv=len(a))):
            np.testing.assert_array_equal(g, o)


def test_public_ansv_retries_an_overflow(monkeypatch):
    """Routing capacity 1 at capscale 4 drops records; the public ansv
    sees the overflow count and retries without a bound, as JAX does."""
    a = _values("staircase", 3000, np.int32)
    real = t_ansv.cap_for
    seen = []

    def tiny(m, p, capscale):
        seen.append(capscale)
        return 1 if capscale is not None else real(m, p, capscale)

    monkeypatch.setattr(t_ansv, "cap_for", tiny)
    for lt, rt in ((NEAREST_SM, NEAREST_SM), (FURTHEST_EQ, NEAREST_EQ)):
        got = t_ansv.ansv(a, lt, rt, mesh=cpu_mesh(4))
        for g, o in zip(got, ansv_seq(a, lt, rt, nonsv=len(a))):
            np.testing.assert_array_equal(g, o)
    assert 4 in seen and None in seen


# ---------------------------------------------------------------------------
# the suffix tree
# ---------------------------------------------------------------------------

TREE_TEXTS = {
    "mississippi": b"mississippi",
    "dna1000": rand_dna(1000, seed=1000),
    "rep": rep_dna(2048, unit_len=64, seed=7, mutations=40),
    "zyxa": b"zyxa",
    "abc300": b"abc" * 300,
}


def oracle_tree(text: bytes) -> np.ndarray:
    alpha = Alphabet.from_bytes(text)
    sa = suffix_array_np(text)
    return suffix_tree_oracle(alpha.encode(text), sa, lcp_kasai(text, sa),
                              alpha.sigma)


@pytest.mark.parametrize("p,text", [(4, "mississippi"), (4, "rep"),
                                    (8, "dna1000"), (8, "zyxa")])
def test_suffix_tree_vs_jax_and_oracle(p, text):
    """The whole padded node table against the JAX package's at the same
    p, and the real rows against the oracle."""
    from psac_tpu.models import suffix_array as j_sa
    from psac_tpu.models import suffix_tree as j_st

    t = TREE_TEXTS[text]
    jm = j_make_mesh(p)
    xs, alpha, n, N = j_sa.encode_and_shard(t, jm)
    jd = j_sa.construct_device(xs, alpha, n, N, jm)
    want = np.asarray(j_st.construct_suffix_tree_device(jd, xs, jm).nodes)
    mesh = cpu_mesh(p)
    txs, talpha, tn, tN = t_sa.encode_and_shard(t, mesh=mesh)
    dsa = t_sa.construct_device(txs, talpha, tn, tN, mesh=mesh)
    tree = t_st.construct_suffix_tree_device(dsa, txs)
    np.testing.assert_array_equal(tree.nodes.gather().numpy(), want)
    np.testing.assert_array_equal(tree.materialize(), oracle_tree(t))


@pytest.mark.parametrize("text", ["dna1000", "rep", "abc300"])
def test_suffix_tree_odd_mesh_vs_oracle(text):
    t = TREE_TEXTS[text]
    np.testing.assert_array_equal(
        t_st.build_suffix_tree(t, mesh=cpu_mesh(3)), oracle_tree(t))


def test_suffix_tree_capscale_retry(monkeypatch):
    """Routing capacity 1 at capscale 6 overflows the tree's routes; the
    retry without a bound gives the oracle's table."""
    real = t_st.cap_for
    seen = []

    def tiny(m, p, capscale):
        seen.append(capscale)
        return 1 if capscale is not None else real(m, p, capscale)

    monkeypatch.setattr(t_st, "cap_for", tiny)
    t = TREE_TEXTS["rep"]
    np.testing.assert_array_equal(
        t_st.build_suffix_tree(t, mesh=cpu_mesh(4)), oracle_tree(t))
    assert 6 in seen and None in seen


def test_suffix_tree_plain_k5_on_a_mesh():
    """The tree built with K5's plain version (``parallel.ansv.PLAIN``)
    equals the default one: on CPU both run the plain version, on the card
    this pair holds the kernel against it."""
    mesh = cpu_mesh(4)
    t = TREE_TEXTS["dna1000"]
    xs, alpha, n, N = t_sa.encode_and_shard(t, mesh=mesh)
    dsa = t_sa.construct_device(xs, alpha, n, N, mesh=mesh)
    a = t_st.construct_suffix_tree_device(dsa, xs)
    b = t_st._st_local(dsa, xs, t_ansv.PLAIN)
    assert torch.equal(a.nodes.gather(), b.nodes.gather())
