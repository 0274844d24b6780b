"""K6, the LCP resolve (``psac_tpu_torch.ops.rmq.rmq_resolve``), on the CPU:
its plain version and the port's ``query_local_rmq`` against the JAX
package's row-window RMQ and its ``_Builder._resolve_fused_local`` on the
same seeded numpy inputs, for every key packing, L in {2, 4}, block sizes
8 / 32 / 128, int32 and int64; and a numpy model of the CUDA kernel's
per-query logic held to the plain version.  Exact equality (integers
only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.ops import rmq as t_rmq
from psac_tpu_torch.parallel.route import route_scatter
from psac_tpu_torch.verify.cases import (resolve_expected as expected,
                                         resolve_lcp, resolve_queries,
                                         resolve_query_arrays,
                                         wide_resolve_queries)

torch.set_num_threads(1)

#: lengths whose largest power-of-two divisor is the block size
SIZES = {8: 8 * 37, 32: 32 * 33, 128: 128 * 17}


def _inf(dt):
    return torch.iinfo(dt).max


def make_case(s: int, L: int, seed: int, block: int):
    """(lcp, rows, lo, hi, j): a seeded LCP and s // 2 mixed queries."""
    return (resolve_lcp(s, seed),
            *resolve_queries(s, s // 2, block, L, seed + 1))


def query_dict(s, rows, lo, hi, j, dt):
    return {k: torch.from_numpy(v).to(dt) for k, v in
            resolve_query_arrays(s, rows, lo, hi, j, _inf(dt)).items()}


def _builder(s, dt):
    return t_sa._Builder(s, (4, 4), 3, True, dt, torch.device("cpu"))


def _resolve_packed(lcp_t, q, d, *, L, nq, packing, m_pad):
    """A dense step's resolve with the key packing forced."""
    s = lcp_t.shape[0]
    ks, ls, rs, js, Lm, _ = _builder(s, lcp_t.dtype)._pack_queries(
        q, L, packing)
    return t_rmq.rmq_resolve(t_rmq.build_local_rmq(lcp_t), ks, ls, rs, js, d,
                             Lm=Lm, packing=packing, nq=nq, m_pad=m_pad)


@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("packing", t_rmq.PACKINGS)
@pytest.mark.parametrize("block", sorted(SIZES))
def test_resolve_plain_every_packing(block, packing, L, dt):
    s = SIZES[block]
    assert t_rmq.block_size_for(s) == block
    lcp, rows, lo, hi, j = make_case(s, L, seed=block + L, block=block)
    d = 7
    q = query_dict(s, rows, lo, hi, j, dt)
    want = expected(lcp, rows, lo, hi, j, d)
    lcp_t = torch.from_numpy(lcp).to(dt)
    for m_pad in (s, 64, 8):
        got = _resolve_packed(lcp_t, q, d, L=L, nq=len(rows),
                              packing=packing, m_pad=m_pad)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.numpy(), want)
    # the input LCP is left as it was
    np.testing.assert_array_equal(lcp_t.numpy(), lcp)


@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("block", sorted(SIZES))
def test_resolve_vs_jax_builder(mesh1, block, L, dt):
    """The port's resolve (its own choice of packing) against the JAX
    package's ``_resolve_fused_local`` at p = 1."""
    from psac_tpu.models.suffix_array import _Builder as JaxBuilder
    from psac_tpu.models.suffix_array import _x64_ctx

    s = SIZES[block]
    lcp, rows, lo, hi, j = make_case(s, L, seed=3 * block + L, block=block)
    d, m_pad = 11, 64
    q = query_dict(s, rows, lo, hi, j, dt)
    jdt = jnp.int32 if dt == torch.int32 else jnp.int64
    with _x64_ctx(jdt):
        jb = JaxBuilder(mesh1, s, (4, 4), 3, True, idt=jdt)
        want = np.asarray(jb._resolve_fused_local(
            jnp.asarray(lcp, jdt), *(jnp.asarray(q[k].numpy(), jdt)
                                     for k in ("qkey", "lq", "rq", "jcol")),
            jnp.asarray(d, jdt), m_pad=m_pad, L=L))
    got = _builder(s, dt)._resolve_fused_local(
        torch.from_numpy(lcp).to(dt), q, d, m_pad=m_pad, L=L, nq=len(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, expected(lcp, rows, lo, hi, j, d))


@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("block", sorted(SIZES))
def test_query_local_rmq_vs_jax(block, dt):
    from psac_tpu.models.suffix_array import _x64_ctx
    from psac_tpu.ops.rmq import build_local_rmq, query_local_rmq

    s = SIZES[block]
    lcp, _, lo, hi, _ = make_case(s, 2, seed=block, block=block)
    jdt = jnp.int32 if dt == torch.int32 else jnp.int64
    with _x64_ctx(jdt):
        r = build_local_rmq(jnp.asarray(lcp, jdt), with_small=False)
        assert r.block == block
        want = np.asarray(query_local_rmq(r, jnp.asarray(lo, jnp.int32),
                                          jnp.asarray(hi, jnp.int32)))
        table = np.asarray(r.table)
    rt = t_rmq.build_local_rmq(torch.from_numpy(lcp).to(dt))
    assert rt.block == block
    np.testing.assert_array_equal(rt.table.numpy(), table)
    got = t_rmq.query_local_rmq(rt, torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, [lcp[a:b + 1].min() for a, b in zip(lo, hi)])


# ---------------------------------------------------------------------------
# numpy model of csrc/rmq_resolve.cu: one query per thread, 32 per warp
# ---------------------------------------------------------------------------

NARROW = 8
WARP = 32


def _kernel_model(lcp, table, block, ks, ls, rs, js, nq, Lm, mode, d, inf,
                  vec=None, stats=None):
    """The kernel's arithmetic, warp by warp and thread by thread, on numpy
    arrays; every read is asserted to be in bounds.  ``vec``: whether a
    narrow range is read as the 16-byte words that cover it (the launcher's
    choice when the LCP is aligned and s a multiple of the words' width;
    default: that rule with an aligned LCP).  ``stats`` (a dict) counts the
    narrow and wide queries and the warps holding both."""
    s = len(lcp)
    nb = table.shape[1]
    flat = table.reshape(-1)
    bshift = block.bit_length() - 1
    E = 16 // table.dtype.itemsize  # elements per 16-byte word
    if vec is None:
        vec = s % E == 0
    out = lcp.copy()

    def read(i):
        assert 0 <= i < s
        return int(lcp[i])

    def narrow_min(lo, hi):
        if not vec:
            return min(read(lo + u) for u in range(NARROW) if lo + u <= hi)
        c0, c1 = lo // E, hi // E
        assert c1 - c0 < NARROW // E + 1  # the words a thread may load
        words = {c: [read(c * E + u) for u in range(E)]
                 for c in range(c0, c1 + 1)}  # whole words, all in bounds
        return min(words[at // E][at % E] for at in range(lo, hi + 1))

    def wide_min(lo, hi):
        bl, bh = lo >> bshift, hi >> bshift
        lanes = [inf] * WARP
        lend = hi if bl == bh else ((bl + 1) << bshift) - 1
        for lane in range(WARP):
            for i in range(lo + lane, lend + 1, WARP):
                lanes[lane] = min(lanes[lane], read(i))
        if bl != bh:
            for lane in range(WARP):
                for i in range((bh << bshift) + lane, hi + 1, WARP):
                    lanes[lane] = min(lanes[lane], read(i))
            first = bl + 1
            length = bh - first
            if length > 0:
                lev = length.bit_length() - 1
                for lane, at in ((0, first), (1, bh - (1 << lev))):
                    idx = lev * nb + at
                    assert 0 <= at < nb and idx < len(flat)
                    lanes[lane] = min(lanes[lane], int(flat[idx]))
        return min(lanes)

    for w0 in range(0, nq, WARP):
        live, wide = {}, []
        for q in range(w0, min(w0 + WARP, nq)):  # one thread each
            key = int(ks[q])
            if key == inf:
                continue
            k, j = key, 1
            if mode == 2:
                row = k
                if js is not None:
                    j = int(js[q])
            else:
                if mode == 0 and k >= s * Lm:
                    k -= s * Lm
                row = k // Lm
                j = k - row * Lm + 1
            l, r = int(ls[q]), int(rs[q])
            lo = min(max(l, 0), s - 1)
            hi = min(max(max(r, l), 0), s - 1)
            if not 0 <= row < s:
                continue
            if hi - lo < NARROW:
                live[q] = (row, j, narrow_min(lo, hi))
            else:
                live[q] = (row, j, None)
                wide.append((q, lo, hi))
        for q, lo, hi in wide:  # the warp takes them in lane order
            row, j, _ = live[q]
            live[q] = (row, j, wide_min(lo, hi))
        for row, j, m in live.values():
            out[row] = j * d + m
        if stats is not None:
            stats["wide"] = stats.get("wide", 0) + len(wide)
            stats["narrow"] = stats.get("narrow", 0) + len(live) - len(wide)
            stats["mixed_warps"] = stats.get("mixed_warps", 0) + int(
                0 < len(wide) < len(live))
    return out


@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("packing", t_rmq.PACKINGS)
@pytest.mark.parametrize("block", sorted(SIZES))
def test_kernel_model_vs_plain(block, packing, L, dt):
    """The sorted query buffers a dense step hands to K6, through the model
    and through the plain version."""
    s = SIZES[block]
    lcp, rows, lo, hi, j = make_case(s, L, seed=7 * block + L, block=block)
    q = query_dict(s, rows, lo, hi, j, dt)
    inf = _inf(dt)
    ks, ls, rs, js, Lm, _ = _builder(s, dt)._pack_queries(q, L, packing)
    assert (js is None) == (packing != "rows" or Lm == 1)
    rmq = t_rmq.build_local_rmq(torch.from_numpy(lcp).to(dt))
    d = 13
    plain = t_rmq.rmq_resolve_plain(
        rmq, ks, ls, rs, js, d, Lm=Lm, packing=packing, nq=len(rows),
        m_pad=64)
    model = _kernel_model(
        lcp, rmq.table.numpy(), block, ks.numpy(), ls.numpy(), rs.numpy(),
        None if js is None else js.numpy(), len(rows), Lm,
        t_rmq.PACKINGS.index(packing), d, inf)
    np.testing.assert_array_equal(model, plain.numpy())
    np.testing.assert_array_equal(model, expected(lcp, rows, lo, hi, j, d))
    # on a CPU tensor the wrapper is the plain version and counts no launch
    before = t_rmq.rmq_resolve.launches
    via = t_rmq.rmq_resolve(rmq, ks, ls, rs, js, d, Lm=Lm, packing=packing,
                            nq=len(rows), m_pad=64)
    assert torch.equal(via, plain)
    assert t_rmq.rmq_resolve.launches == before


@pytest.mark.parametrize("vec", [True, False], ids=["words", "elements"])
@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("packing", t_rmq.PACKINGS)
@pytest.mark.parametrize("block", sorted(SIZES))
def test_kernel_model_mostly_wide(block, packing, dt, vec):
    """A resolve whose ranges are mostly 8 or more wide: nearly every warp
    takes 28 wide queries in turn, beside its narrow ones.  Model, plain
    version and the direct computation agree."""
    s, L = SIZES[block], 4
    lcp = resolve_lcp(s, seed=block + 5)
    rows, lo, hi, j = wide_resolve_queries(s, s // 2, block, L, seed=block)
    q = query_dict(s, rows, lo, hi, j, dt)
    ks, ls, rs, js, Lm, _ = _builder(s, dt)._pack_queries(q, L, packing)
    rmq = t_rmq.build_local_rmq(torch.from_numpy(lcp).to(dt))
    d = 17
    st = {}
    model = _kernel_model(
        lcp, rmq.table.numpy(), block, ks.numpy(), ls.numpy(), rs.numpy(),
        None if js is None else js.numpy(), len(rows), Lm,
        t_rmq.PACKINGS.index(packing), d, _inf(dt), vec=vec, stats=st)
    want = expected(lcp, rows, lo, hi, j, d)
    np.testing.assert_array_equal(model, want)
    plain = t_rmq.rmq_resolve_plain(rmq, ks, ls, rs, js, d, Lm=Lm,
                                    packing=packing, nq=len(rows), m_pad=64)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert st["wide"] > 6 * st["narrow"]


@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
def test_kernel_model_narrow_and_wide_in_one_warp(dt):
    """One warp of 32 rows-packed queries: narrow ranges at every offset
    from a 16-byte word's start (so a range covers one to three words at
    int32, up to five at int64), wide ones between them, an INF key and a
    range past the end; plus a length that is no multiple of the word
    width, read element by element."""
    for s in (32 * 33, 32 * 33 + 2):
        lcp = resolve_lcp(s, seed=s)
        rmq = t_rmq.build_local_rmq(torch.from_numpy(lcp).to(dt),
                                    block=2 if s % 32 else 32)
        inf = _inf(dt)
        rng = np.random.RandomState(s)
        rows = rng.permutation(s)[:WARP]
        lo = 64 + np.arange(WARP) * 9 % 16 + np.arange(WARP) * 20
        width = np.where(np.arange(WARP) % 3 == 2, 40 + 9 * np.arange(WARP),
                         np.arange(WARP) % NARROW)
        hi = lo + width
        ks = rows.copy()
        ks[5] = inf
        hi[7] = 10 * s  # clamped to s - 1
        t = {k: torch.from_numpy(v).to(dt) for k, v in
             (("ks", ks), ("ls", lo), ("rs", hi))}
        vec = s % (16 // torch.tensor([], dtype=dt).element_size()) == 0
        st = {}
        model = _kernel_model(lcp, rmq.table.numpy(), rmq.block, ks, lo, hi,
                              None, WARP, 1, 2, 5, inf, vec=vec, stats=st)
        plain = t_rmq.rmq_resolve_plain(rmq, t["ks"], t["ls"], t["rs"], None,
                                        5, Lm=1, packing="rows", nq=WARP)
        np.testing.assert_array_equal(model, plain.numpy())
        assert st["mixed_warps"] == 1 and st["narrow"] > st["wide"] > 5


@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("block", sorted(SIZES))
def test_tail_resolve_unsorted_buffer(block, dt):
    """The tail's resolve: an unsorted (m,) buffer whose keys are rows with
    INF between them.  Model, plain version and the range-minimum query +
    scatter formula it replaced agree."""
    s = SIZES[block]
    lcp, rows, lo, hi, _ = make_case(s, 2, seed=11 * block, block=block)
    inf = _inf(dt)
    m = 128
    rng = np.random.RandomState(block)
    slots = np.sort(rng.permutation(m)[:m // 2])
    kq = np.full(m, inf, np.int64)
    lq = rng.randint(-3, 2 * s, m)
    rq = rng.randint(-3, 2 * s, m)
    kq[slots], lq[slots], rq[slots] = (a[:m // 2] for a in (rows, lo, hi))
    kq_t, lq_t, rq_t = (torch.from_numpy(a).to(dt) for a in (kq, lq, rq))
    lcp_t = torch.from_numpy(lcp).to(dt)
    d = 40
    got = _builder(s, dt)._resolve_local(lcp_t, kq_t, lq_t, rq_t, d)
    rmq = t_rmq.build_local_rmq(lcp_t)
    valid = kq_t != inf
    mins = t_rmq.query_local_rmq(
        rmq, *(torch.where(valid, x, 0).clamp(0, s - 1)
               for x in (lq_t, rq_t)))
    (old,) = route_scatter(kq_t, (d + mins,), (lcp_t,), valid)
    assert torch.equal(got, old)
    model = _kernel_model(lcp, rmq.table.numpy(), block, kq, lq, rq, None, m,
                          1, 2, d, inf)
    np.testing.assert_array_equal(model, got.numpy())


@pytest.mark.parametrize("packing", t_rmq.PACKINGS)
def test_large_d_on_an_int32_build(packing):
    """d is capped at N, below 2^30 on an int32 build, so j * d reaches
    3 * 2^30 on rows without a query (their column is arbitrary).  Only real
    queries are written, and theirs (j = 1 here) stay exact."""
    s, L = SIZES[32], 4
    lcp, rows, lo, hi, j = make_case(s, L, seed=1, block=32)
    lcp = lcp % 2
    j = np.ones_like(j)
    d = (1 << 30) - 8
    q = query_dict(s, rows, lo, hi, j, torch.int32)
    got = _resolve_packed(torch.from_numpy(lcp).to(torch.int32), q, d, L=L,
                          nq=len(rows), packing=packing, m_pad=64)
    np.testing.assert_array_equal(got.numpy(),
                                  expected(lcp, rows, lo, hi, j, d))


@pytest.mark.parametrize("s,Lm,inf,want", [
    (1 << 20, 3, 2**31 - 1, "narrow"),
    (1 << 20, 1, 2**31 - 1, "narrow"),
    ((1 << 20) + 4, 3, 2**31 - 1, "packed"),    # not a multiple of 8
    ((1 << 20) + 4, 1, 2**31 - 1, "rows"),
    (1 << 29, 3, 2**31 - 1, "packed"),          # no room for the class bit
    (1 << 30, 3, 2**31 - 1, "rows"),            # no room for the column
    (1 << 30, 1, 2**31 - 1, "rows"),
    (1 << 40, 7, 2**63 - 1, "narrow"),
])
def test_resolve_packing_choice(s, Lm, inf, want):
    assert t_sa.resolve_packing(s, Lm, inf) == want


def test_plain_finds_the_narrow_chunks_itself():
    """With the ``narrow`` packing the plain version reads where the wide
    queries start from the sorted keys: an all-narrow resolve never touches
    the table, a resolve with one wide query does."""
    s, dt = SIZES[32], torch.int32
    lcp = resolve_lcp(s, seed=2)
    rows = np.arange(0, 400, 2)
    lo = np.arange(200) * 5
    hi = lo + np.arange(200) % 8
    j = np.ones(200, np.int64)
    for widen in (False, True):
        if widen:
            hi[17] = lo[17] + 300
        q = query_dict(s, rows, lo, hi, j, dt)
        ks, ls, rs, js, Lm, _ = _builder(s, dt)._pack_queries(q, 2, "narrow")
        rmq = t_rmq.build_local_rmq(torch.from_numpy(lcp).to(dt))
        rmq.table = torch.full_like(rmq.table, -1)  # wrong on purpose
        got = t_rmq.rmq_resolve_plain(rmq, ks, ls, rs, js, 3, Lm=Lm,
                                      packing="narrow", nq=200)
        same = np.array_equal(got.numpy(), expected(lcp, rows, lo, hi, j, 3))
        assert same != widen


def test_wrapper_counts_launches_only_on_the_card():
    assert isinstance(t_rmq.rmq_resolve.launches, int)
    rmq = t_rmq.build_local_rmq(torch.arange(64, dtype=torch.int32))
    k = torch.tensor([3, 2**31 - 1], dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    before = t_rmq.rmq_resolve.launches
    out = t_rmq.rmq_resolve(rmq, k, z, z + 5, None, 9, Lm=1, packing="rows",
                            nq=2)
    assert out[3] == 9 and t_rmq.rmq_resolve.launches == before
