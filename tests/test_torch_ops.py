"""Parity of the port's small ops with the JAX package: bitops (with the
clz edge cases), k-mer packing, RMQ queries (min and leftmost argmin), the
multi-key sort, the p = 1 collectives and routing, the config converter,
and the numpy helpers and modules the port copies.  Integers only: every
comparison is exact."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import psac_tpu_torch.ops.alphabet as t_alpha
import psac_tpu_torch.ops.ansv as t_ansv
import psac_tpu_torch.ops.oracle as t_oracle
import psac_tpu_torch.verify.suffix_tree_oracle as t_sto
from psac_tpu_torch import config as t_config
from psac_tpu_torch import native as t_native
from psac_tpu_torch.ops import bitops as t_bitops
from psac_tpu_torch.ops import kmer as t_kmer
from psac_tpu_torch.ops import rmq as t_rmq
from psac_tpu_torch.parallel import collectives as t_coll
from psac_tpu_torch.parallel import mesh as t_mesh
from psac_tpu_torch.parallel import route as t_route
from psac_tpu_torch.parallel import sort as t_sort

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


EDGE_WORDS = np.array([0, 1, 2, 3, 1 << 15, (1 << 16) - 1, 1 << 16,
                       (1 << 30) - 1, 1 << 30, (1 << 31) - 1, -(1 << 31),
                       -1, -2, 0x55555555, 0x2AAAAAAA], np.int32)


def test_clz_edge_cases():
    rng = np.random.RandomState(0)
    x = np.concatenate([EDGE_WORDS, rng.randint(-(1 << 31), (1 << 31) - 1,
                                                 4096, dtype=np.int64
                                                 ).astype(np.int32)])
    want = np.asarray(lax.clz(jnp.asarray(x)))
    got = t_bitops.clz32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 32 and got[list(EDGE_WORDS).index(1 << 30)] == 1
    assert t_bitops.ceillog2(5) == 3 and t_bitops.ceillog2(1) == 0


@pytest.mark.parametrize("bits,ks", [(3, (10, 10)), (2, (15, 15)),
                                     (8, (3, 3, 3)), (5, (6,))])
def test_lcp_bitwise_words(bits, ks):
    from psac_tpu.ops.bitops import lcp_bitwise_words

    rng = np.random.RandomState(bits)
    m = 2000
    sigma = (1 << bits) - 1
    a_chars = rng.randint(1, sigma + 1, (m, sum(ks)))
    b_chars = a_chars.copy()
    cut = rng.randint(0, sum(ks) + 1, m)
    for i in range(m):  # random divergence position (or none)
        if cut[i] < sum(ks):
            b_chars[i, cut[i]] = (a_chars[i, cut[i]] % sigma) + 1
    b_chars[:4] = 0  # sentinel words
    a_chars[-1] = 0

    def words(ch):
        out, off = [], 0
        for kw in ks:
            w = np.zeros(m, np.int64)
            for j in range(off, off + kw):
                w = (w << bits) | ch[:, j]
            out.append(w.astype(np.int32))
            off += kw
        return out

    aw, bw = words(a_chars), words(b_chars)
    aw[0][5] = -1  # the init's fill word before row 0
    want = np.asarray(lcp_bitwise_words(tuple(map(jnp.asarray, aw)),
                                        tuple(map(jnp.asarray, bw)), ks, bits))
    got = t_bitops.lcp_bitwise_words(tuple(map(_t, aw)), tuple(map(_t, bw)),
                                     ks, bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,words", [(3, 2), (2, 3), (8, 1)])
def test_pack_kmers(bits, words):
    from psac_tpu.ops.kmer import optimal_k, pack_kmers_local

    ks = optimal_k(bits, words=words)
    assert ks == t_kmer.optimal_k(bits, words=words)
    rng = np.random.RandomState(words)
    s = 1000
    chars = np.concatenate([rng.randint(1, (1 << bits), s),
                            np.zeros(sum(ks) - 1, np.int64)]).astype(np.int32)
    want = pack_kmers_local(jnp.asarray(chars), s, ks, bits)
    got = t_kmer.pack_kmers_local(_t(chars), s, ks, bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("s,dt", [(1024, np.int32), (4096, np.int32),
                                  (1000, np.int64), (8, np.int32)])
def test_rmq_queries(s, dt):
    from psac_tpu.models.suffix_array import _x64_ctx
    from psac_tpu.ops.rmq import build_local_rmq, query_local_rmq

    rng = np.random.RandomState(s)
    x = rng.randint(0, 50, s).astype(dt)
    q = 3000
    lo = rng.randint(0, s, q)
    hi = np.minimum(s - 1, lo + rng.geometric(0.01, q) - 1)
    lo[:s // 8] = hi[:s // 8]  # single-element ranges
    with _x64_ctx(jnp.int64 if dt == np.int64 else jnp.int32):
        r = build_local_rmq(jnp.asarray(x), with_small=False)
        want = np.asarray(query_local_rmq(r, jnp.asarray(lo, jnp.int32),
                                          jnp.asarray(hi, jnp.int32)))
    rt = t_rmq.build_local_rmq(_t(x))
    assert rt.block == r.block
    np.testing.assert_array_equal(rt.table.numpy(), np.asarray(r.table))
    got = t_rmq.query_local_rmq(rt, _t(lo), _t(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    brute = np.array([x[a:b + 1].min() for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(got, brute)


@pytest.mark.parametrize("s,dt", [(1024, np.int32), (4096, np.int64),
                                  (8, np.int32), (48, np.int32)])
def test_arg_rmq_queries(s, dt):
    """Leftmost argmin (the DESA's blind search RMQ) vs the JAX package and
    a brute force, on small alphabets so minima tie often."""
    from psac_tpu.models.suffix_array import _x64_ctx
    from psac_tpu.ops.rmq import build_arg_rmq, query_arg_rmq

    rng = np.random.RandomState(s + 1)
    x = rng.randint(0, 4, s).astype(dt)
    q = 2000
    lo = rng.randint(0, s, q)
    hi = np.minimum(s - 1, lo + rng.geometric(0.02, q) - 1)
    lo[:q // 8] = hi[:q // 8]
    with _x64_ctx(jnp.int64 if dt == np.int64 else jnp.int32):
        r = build_arg_rmq(jnp.asarray(x))
        want = np.asarray(query_arg_rmq(r, jnp.asarray(lo, jnp.int32),
                                        jnp.asarray(hi, jnp.int32)))
    rt = t_rmq.build_arg_rmq(_t(x))
    assert rt.block == r.block
    np.testing.assert_array_equal(rt.tab_v.numpy(), np.asarray(r.tab_v))
    np.testing.assert_array_equal(rt.tab_a.numpy(), np.asarray(r.tab_a))
    got = t_rmq.query_arg_rmq(rt, _t(lo), _t(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    brute = np.array([a + int(np.argmin(x[a:b + 1])) for a, b in zip(lo, hi)])
    np.testing.assert_array_equal(got.numpy(), brute)


@pytest.mark.parametrize("num_keys,ncols", [(1, 3), (3, 3), (5, 5)])
def test_multikey_sort(num_keys, ncols):
    """Lexicographic LSD composition vs lax.sort; the last key column is
    unique (as on the construction path), so the order is total."""
    rng = np.random.RandomState(num_keys * 7 + ncols)
    m = 5000
    cols = [rng.randint(0, 4, m).astype(np.int32) for _ in range(ncols - 1)]
    cols.append(rng.permutation(m).astype(np.int32))
    if num_keys < ncols:  # unique first key when it alone decides
        cols[0] = rng.permutation(m).astype(np.int32)
    want = lax.sort(tuple(map(jnp.asarray, cols)), num_keys=num_keys)
    got = t_sort.dist_sort_local(tuple(map(_t, cols)), num_keys)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # stable: equal keys keep row order
    perm = t_sort.lex_perm([_t(cols[1] % 2)]).numpy()
    np.testing.assert_array_equal(perm, np.argsort(cols[1] % 2,
                                                   kind="stable"))


def test_scatter_by_index_and_route():
    rng = np.random.RandomState(3)
    m = 777
    dest = rng.permutation(m).astype(np.int32)
    vals = rng.randint(0, 1000, m).astype(np.int32)
    (out,) = t_sort.scatter_by_index_local(_t(dest), (_t(vals),))
    want = np.empty(m, np.int32)
    want[dest] = vals
    np.testing.assert_array_equal(out.numpy(), want)
    # scatter with a drop slot, width 3 rows x slots
    rows = rng.randint(0, 100, 50)
    slots = rng.randint(0, 3, 50)
    key = rows * 3 + slots
    _, first = np.unique(key, return_index=True)
    valid = np.zeros(50, bool)
    valid[first] = True
    valid[::4] = False
    tgt = np.zeros(300, np.int64)
    (got,) = t_route.route_scatter(_t(rows), (_t(np.arange(50)),),
                                   (_t(tgt),), _t(valid), width=3,
                                   slots=_t(slots))
    tgt[key[valid]] = np.arange(50)[valid]
    np.testing.assert_array_equal(got.numpy(), tgt)


def test_collectives_p1():
    x = _t(np.arange(1, 41, dtype=np.int32))
    for d in (0, 1, 7, 39, 40, 100):
        got = t_coll.global_shift_left_dyn(x, d).numpy()
        want = np.concatenate([np.arange(1 + d, 41), np.zeros(d)])[:40] \
            if d < 40 else np.zeros(40)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_coll.prev_of(x)[:3].numpy(), [-1, 1, 2])
    np.testing.assert_array_equal(
        t_coll.global_cummax(_t(np.array([3, 1, 4, 1, 5], np.int32))).numpy(),
        [3, 3, 4, 4, 5])
    rng = np.random.RandomState(12)
    for n in (1, 1023, 1024, 1025, 5000):
        for dt in (np.int32, np.int64):
            a = rng.randint(-10**6, 10**6, n).astype(dt)
            a[rng.rand(n) < 0.3] = np.iinfo(dt).min
            np.testing.assert_array_equal(
                t_coll.global_cummax(_t(a)).numpy(), np.maximum.accumulate(a))


def test_padded_size_matches():
    from psac_tpu.parallel.mesh import padded_size

    for n in list(range(1, 300)) + [1 << 20, (1 << 26) + 5, 10**8]:
        assert t_mesh.padded_size(n) == padded_size(n, 1)


def test_config_from_jax():
    from psac_tpu.config import SAConfig, index_dtype

    assert t_config.SAConfig.from_jax(SAConfig()) == t_config.SAConfig()
    cfg = SAConfig(dense_factor=2, force_int64=True, kmer_words=3,
                   resolve_div=16, construct_lcp=False, factor=4)
    got = t_config.SAConfig.from_jax(cfg)
    assert (got.dense_factor, got.force_int64, got.kmer_words,
            got.resolve_div, got.construct_lcp, got.factor) == \
        (2, True, 3, 16, False, 4)
    for n in (8, (1 << 30) - 1, 1 << 30):
        assert str(t_config.index_dtype(n)).endswith(
            np.dtype(index_dtype(n)).name)
    # every option builds the oracle's result (none is left unsupported)
    from psac_tpu_torch import build_suffix_array
    text = b"ab" * 300 + b"ba" * 40
    sa = t_oracle.suffix_array_np(text)
    for opt in (dict(pack_keys=True, dense_factor=5), dict(fused=False),
                dict(construct_lc=True)):
        res = build_suffix_array(text, "cpu", t_config.SAConfig(**opt))
        np.testing.assert_array_equal(res.sa, sa, err_msg=str(opt))
        np.testing.assert_array_equal(res.lcp, t_oracle.lcp_kasai(text, sa))


def test_copied_numpy_helpers_equal_originals():
    """The port carries copies of JAX-free numpy modules (the originals sit
    under psac_tpu, whose import pulls JAX); they must not drift."""
    import psac_tpu.ops.alphabet as j_alpha
    import psac_tpu.ops.ansv as j_ansv
    import psac_tpu.ops.oracle as j_oracle
    import psac_tpu.verify.suffix_tree_oracle as j_sto

    for mod_t, mod_j, names in (
            (t_alpha, j_alpha, ("Alphabet", "IntAlphabet", "rand_dna",
                                "rep_dna")),
            (t_oracle, j_oracle, ("suffix_array_naive", "suffix_array_np",
                                  "lcp_kasai")),
            (t_ansv, j_ansv, ("_left_scan", "ansv_seq")),
            (t_sto, j_sto, ("suffix_tree_oracle", "gst_oracle"))):
        for name in names:
            assert inspect.getsource(getattr(mod_t, name)) == \
                inspect.getsource(getattr(mod_j, name)), name
    assert (t_ansv.NEAREST_SM, t_ansv.NEAREST_EQ, t_ansv.FURTHEST_EQ,
            t_ansv.NONSV) == (j_ansv.NEAREST_SM, j_ansv.NEAREST_EQ,
                              j_ansv.FURTHEST_EQ, j_ansv.NONSV)
    assert t_alpha.rep_dna(5000, unit_len=300) == \
        j_alpha.rep_dna(5000, unit_len=300)
    text = t_alpha.rand_dna(3000, seed=9) + b"zz!"
    a_t, a_j = t_alpha.Alphabet.from_bytes(text), \
        j_alpha.Alphabet.from_bytes(text)
    np.testing.assert_array_equal(a_t.encode(text), a_j.encode(text))
    assert a_t.bits_per_char == a_j.bits_per_char


def test_native_oracle_matches_jax_package():
    from psac_tpu.native import lcp_array, suffix_array

    text = t_alpha.rep_dna(20000, unit_len=700, seed=4)
    sa = t_native.suffix_array(text)
    np.testing.assert_array_equal(sa, suffix_array(text))
    np.testing.assert_array_equal(t_native.lcp_array(text, sa),
                                  lcp_array(text, sa))
    with open(t_native._SRC) as f_t, \
            open(t_native._SRC.replace("psac_tpu_torch", "psac_tpu")) as f_j:
        assert f_t.read() == f_j.read()


def _source(mod, name: str) -> str:
    """Source of a definition with the package name normalized."""
    return inspect.getsource(getattr(mod, name)).replace("psac_tpu_torch",
                                                         "psac_tpu")


def test_copied_query_modules_equal_originals():
    """``ops/sample_lcp.py`` and ``seq.py`` are numpy copies (the host
    oracles of the DESA on a machine without JAX)."""
    import psac_tpu.ops.sample_lcp as j_samp
    import psac_tpu.seq as j_seq
    import psac_tpu_torch.ops.sample_lcp as t_samp
    import psac_tpu_torch.seq as t_seq

    for mod_t, mod_j, names in (
            (t_samp, j_samp, ("sample_lcp_seq", "sample_lcp_ansv")),
            (t_seq, j_seq, ("_RMQ", "SAIndex", "SALCPIndex", "ESAIndex",
                            "BSESAIndex", "DESAIndex", "LookupDESAIndex"))):
        for name in names:
            assert _source(mod_t, name) == _source(mod_j, name), name
    rng = np.random.RandomState(2)
    lcp = rng.randint(0, 6, 3000)
    lcp[0] = 0
    for maxsize in (2, 16, 200):
        np.testing.assert_array_equal(t_samp.sample_lcp_ansv(lcp, maxsize),
                                      j_samp.sample_lcp_seq(lcp, maxsize))
    text = t_alpha.rand_dna(3000, seed=3)
    pats = [text[i:i + ln] for ln in (1, 4, 9, 30) for i in (0, 777, 2900)]
    pats += [b"GGGGGGGGGGGGGGGGG", b"xyz"]
    t_idx = t_seq.LookupDESAIndex(text)
    j_idx = j_seq.LookupDESAIndex(text)
    t_sa_idx = t_seq.SAIndex(text, t_idx.sa)
    for pat in pats:
        got = t_idx.locate(pat)
        assert got == j_idx.locate(pat), pat
        l, r = t_sa_idx.locate(pat)
        # absent patterns: both ranges empty (at different rows)
        assert got == (l, r) or (got[0] == got[1] and l == r), pat
