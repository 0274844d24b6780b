"""The DESA pattern index of the port against the JAX package's
``build_desa(text, mesh=make_mesh(1))``: the same k-mer depth, table,
segment start and capacity, slabs, RMQ tables, sampled TLDT rows, and the
same ``bulk_locate`` / ``bulk_locate_possible`` ranges; every exact range
is also checked by a naive occurrence scan.  Both top-level indexes, the
int64 index, mixed pattern lengths (several length groups), empty patterns
and characters outside the alphabet.  Exact equality (integers only)."""

import functools
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from psac_tpu_torch import SAConfig
from psac_tpu_torch.models import desa as t_desa
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.ops.oracle import suffix_array_np
from psac_tpu_torch.verify import cases

torch.set_num_threads(1)

TEXTS = {
    "mississippi": (b"mississippi", dict(tli_bits=6)),
    "dna1000": (rand_dna(1000, seed=1000), {}),
    "rep_dna": (rep_dna(3000, unit_len=400, seed=5, mutations=6), {}),
    "abab": (b"abab" * 250, dict(tli_bits=8)),
    "tldt_dna1000": (rand_dna(1000, seed=1001), dict(tli="tldt", maxsize=8)),
    "tldt_dna3000": (rand_dna(3000, seed=3001), dict(tli="tldt", maxsize=8)),
    "tldt_repeats": (b"abab" * 200 + b"bba" * 100,
                     dict(tli="tldt", maxsize=4)),
    "tldt_rep_dna": (rep_dna(3000, unit_len=400, seed=6, mutations=6),
                     dict(tli="tldt")),
}


def occurrences(text: bytes, pat: bytes) -> list:
    out, start = [], 0
    while pat:
        i = text.find(pat, start)
        if i < 0:
            break
        out.append(i)
        start = i + 1
    return out


def _patterns(text: bytes, seed: int) -> list:
    """Text substrings of lengths 1..40 (so the batch splits into length
    groups), absent patterns, an empty one and one with a character
    outside the alphabet."""
    rng = np.random.RandomState(seed)
    pats = [text[st:st + ln] for ln in (1, 2, 3, 5, 9, 17, 40)
            if ln < len(text) for st in rng.randint(0, len(text) - ln, 4)]
    absent = bytes([text[0]]) * 18
    return pats + [absent, text[:3] + b"\x01", b"", b"xyz", text[-5:]]


def _jax_build(text, mesh, **kw):
    import dataclasses

    import psac_tpu.config as j_cfg
    from psac_tpu.models.desa import build_desa

    conf = kw.pop("config", None)
    jconf = None if conf is None else dataclasses.replace(
        j_cfg.DEFAULT, force_int64=conf.force_int64,
        construct_lc=conf.construct_lc)
    return build_desa(text, mesh=mesh, **({"config": jconf} if jconf else {}),
                      **kw)


def _same_index(td, jd):
    assert (td.k, td.cap, td.n, td.N, td.tli) == \
        (jd.k, jd.cap, jd.n, jd.N, jd.tli)
    np.testing.assert_array_equal(td.begins_np, jd.begins_np)
    for name in ("table", "begins", "sa", "lcp", "lc"):
        got, want = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(td.rmq.tab_v.numpy(), jd.rmq_parts[0])
    np.testing.assert_array_equal(td.rmq.tab_a.numpy(), jd.rmq_parts[1])
    assert (td.samp is None) == (jd.samp is None)
    if td.samp is not None:
        assert (td.samp["m"], td.samp["M"]) == (jd.samp["m"], jd.samp["M"])
        for key in ("off_ext", "lcp", "lc"):
            np.testing.assert_array_equal(td.samp[key].numpy(),
                                          np.asarray(jd.samp[key]), key)
        np.testing.assert_array_equal(td.samp["rmq"].tab_v.numpy(),
                                      jd.samp["rmq"][0])
    for got, want in zip(t_desa.desa_arrays(td), _jax_arrays(jd)):
        np.testing.assert_array_equal(got, want)


def _jax_arrays(jd):
    from psac_tpu.models.desa import desa_arrays

    return desa_arrays(jd)


def _same_answers(td, jd, text, pats):
    got = td.bulk_locate(pats)
    np.testing.assert_array_equal(got, jd.bulk_locate(pats))
    np.testing.assert_array_equal(td.bulk_locate_possible(pats),
                                  jd.bulk_locate_possible(pats))
    sa = suffix_array_np(text)
    for pat, (l, r) in zip(pats, got):
        assert sorted(sa[l:r].tolist()) == sorted(occurrences(text, pat)), \
            (pat, l, r)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_build_and_locate_vs_jax(mesh1, name):
    text, kw = TEXTS[name]
    td = t_desa.build_desa(text, "cpu", **kw)
    jd = _jax_build(text, mesh1, **kw)
    _same_index(td, jd)
    _same_answers(td, jd, text, _patterns(text, len(name)))
    assert td.last_stats["readbacks"] >= 1


def test_int64_index(mesh1):
    text = rand_dna(1700, seed=41)
    conf = SAConfig(force_int64=True, construct_lc=True)
    td = t_desa.build_desa(text, "cpu", config=conf)
    assert td.idt == torch.int64 and td.sa.dtype == torch.int64
    assert td.lc.dtype == torch.int32
    jd = _jax_build(text, mesh1, config=conf)
    _same_index(td, jd)
    pats = _patterns(text, 6)
    _same_answers(td, jd, text, pats)
    d32 = t_desa.build_desa(text, "cpu")
    np.testing.assert_array_equal(td.bulk_locate(pats), d32.bulk_locate(pats))


def test_tldt_int64_index():
    text = b"abab" * 200 + b"bba" * 100
    kw = dict(tli="tldt", maxsize=4)
    d64 = t_desa.build_desa(text, "cpu", config=SAConfig(force_int64=True),
                            **kw)
    assert d64.samp["off_ext"].dtype == torch.int64
    d32 = t_desa.build_desa(text, "cpu", **kw)
    pats = _patterns(text, 9)
    np.testing.assert_array_equal(d64.bulk_locate(pats),
                                  d32.bulk_locate(pats))


def test_single_pattern_entry_points():
    text = rand_dna(2000, seed=17)
    d = t_desa.build_desa(text, "cpu")
    sa = suffix_array_np(text)
    for pat in (text[100:108], text[5:6], text[900:925]):
        l, r = d.locate_possible(pat)
        assert (l, r) == tuple(d.locate(pat))
        assert sorted(sa[l:r].tolist()) == occurrences(text, pat)
    el, er = d.locate(b"ACGT" * 3 + b"A" * 16)
    assert el == er
    assert d.bulk_locate([]).shape == (0, 2)


def test_length_groups_split_the_batch():
    lens = np.array([3] * 50 + [20] * 50 + [100] * 3 + [0, 1])
    groups = t_desa._length_groups(lens)
    from psac_tpu.models.desa import _length_groups

    want = _length_groups(lens)
    assert len(groups) == len(want) > 1
    for g, w in zip(groups, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def pattern_desa():
    return t_desa.build_desa(cases.PATTERN_TEXT, "cpu")


@pytest.mark.parametrize("name", cases.PATTERN_CASES)
def test_encode_patterns_vs_jax(pattern_desa, name):
    """The CPU DESA's encoding (K11's plain version) against the JAX
    package's numpy encoding of the same batch with the same alphabet: the
    (B, Lmax) code matrix, the lengths and the bad flags, dtypes included.
    The JAX method reads only the DESA's alphabet, so it runs on a stand-in
    that holds the JAX package's alphabet of the same text."""
    import types

    from psac_tpu.models.desa import DESA as JaxDESA
    from psac_tpu.ops.alphabet import Alphabet as JaxAlphabet

    pats = cases.pattern_batch(name)
    jax_alpha = JaxAlphabet.from_bytes(cases.PATTERN_TEXT)
    np.testing.assert_array_equal(pattern_desa.alphabet.mapping,
                                  jax_alpha.mapping)
    want = JaxDESA.encode_patterns(types.SimpleNamespace(alphabet=jax_alpha),
                                   pats)
    got = pattern_desa.encode_patterns(pats)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    if name in ("bytearray", "memoryview", "uint8_array", "int_list"):
        np.testing.assert_array_equal(
            got[0].numpy(), pattern_desa.encode_patterns(
                cases.pattern_batch("mixed_lengths")[:-1])[0].numpy())


@pytest.mark.parametrize("name", ["mkpattern_65536x20", "mixed_lengths"])
def test_lengths_counted_once_a_batch(pattern_desa, name):
    """``bulk_locate`` takes each pattern's length once (its length
    groups), and each group's encoding takes those lengths along: the same
    answers as a batch of plain ``bytes``."""
    calls = [0]

    class Counted(bytes):
        def __len__(self):
            calls[0] += 1
            return bytes.__len__(self)

    pats = cases.pattern_batch(name)[:4096]
    got = pattern_desa.bulk_locate([Counted(p) for p in pats])
    assert calls[0] == len(pats)
    np.testing.assert_array_equal(got, pattern_desa.bulk_locate(pats))


def test_rejects_wide_texts_and_unknown_tli():
    with pytest.raises(ValueError):
        t_desa.build_desa(np.arange(10, dtype=np.int64), "cpu")
    with pytest.raises(ValueError):
        t_desa.build_desa(b"mississippi", "cpu", tli="bogus")


def test_construct_lc_vs_compute_lc_device(mesh1):
    """``SAConfig(construct_lc=True)`` wires the Lc array into
    ``construct_device``; it equals the post-hoc gather and the JAX
    package's."""
    import jax

    import psac_tpu.config as j_cfg
    from psac_tpu.models import suffix_array as j_sa

    text = rand_dna(2000, seed=8)
    xs, alpha, n, N = t_sa.encode_and_shard(text, "cpu")
    dsa = t_sa.construct_device(xs, alpha, n, N, SAConfig(construct_lc=True))
    assert dsa.lc is not None and dsa.lc.dtype == torch.int32
    np.testing.assert_array_equal(dsa.lc.numpy(),
                                  t_sa.compute_lc_device(dsa, xs).numpy())
    assert t_sa.construct_device(xs, alpha, n, N).lc is None
    import dataclasses
    jconf = dataclasses.replace(j_cfg.DEFAULT, construct_lc=True)
    jxs, jalpha, _, _ = j_sa.encode_and_shard(text, mesh1, jconf)
    jd = j_sa.construct_device(jxs, jalpha, n, N, mesh1, jconf)
    np.testing.assert_array_equal(dsa.lc.numpy(),
                                  np.asarray(jax.device_get(jd.lc)))
    with pytest.raises(ValueError):
        t_sa.construct_device(xs, alpha, n, N, SAConfig(
            construct_lc=True, construct_lcp=False))


# ---------------------------------------------------------------------------
# K7, the blind search: a numpy model of the kernel's per-pattern walk
# ---------------------------------------------------------------------------

def _clamp(v, lo, hi):
    return min(max(int(v), lo), hi)


def _k7_serial_argmin(lcp, tab_v, tab_a, block: int, cap: int,
                      events: dict):
    """The argmin of the kernel at one lane, serially: the least (value,
    index) pair over the in-range edge-block entries, each edge seeded with
    (INF, its block's first index), and two doubling-table entries (value
    INF where no full block lies between).  Returns ``arg_rmq(lo, hi)``;
    ``events["tie"]`` counts the ranges with tied minima."""
    INF = int(np.iinfo(lcp.dtype).max)
    levels, nb = tab_v.shape
    last = levels * nb - 1
    fv, fa = tab_v.reshape(-1), tab_a.reshape(-1)
    clamp = _clamp

    def arg_rmq(lo, hi):
        lo = clamp(lo, 0, cap - 1)
        hi = clamp(max(hi, lo), 0, cap - 1)
        bl, bh = lo // block, hi // block
        lend = hi if bl == bh else (bl + 1) * block - 1
        best = min([(INF, bl * block)] +
                   [(int(lcp[j]), j) for j in range(lo, lend + 1)])
        ln = bh - bl - 1
        lev = ln.bit_length() - 1 if ln > 0 else 0
        for t in (clamp(lev * nb + bl + 1, 0, last),
                  clamp(lev * nb + bh - 1 - (1 << lev) + 1, 0, last)):
            best = min(best, (int(fv[t]) if ln > 0 else INF, int(fa[t])))
        if bl != bh:
            best = min(best, min([(INF, bh * block)] + [
                (int(lcp[j]), j) for j in range(bh * block, hi + 1)]))
        vals = lcp[lo:hi + 1]
        events["tie"] += int((vals == vals.min()).sum() > 1)
        return best[1]

    return arg_rmq


def _k7_model(pat, lens, l0, r0, need, lcp, lc, tab_v, tab_a, block: int,
              cap: int, events: dict, argmin=_k7_serial_argmin):
    """What ``csrc/blind_search.cu`` computes, one pattern at a time: the
    walk of the JAX ``body`` with the argmin of ``argmin`` (the serial one
    by default, or ``_k7_group_argmin``).  ``events`` counts the descents
    into two-row intervals, the argmin ranges with tied minima and the
    patterns that ran out of pattern or of range."""
    B, Lmax = pat.shape
    clamp = _clamp
    arg_rmq = argmin(lcp, tab_v, tab_a, block, cap, events)

    def lcp_at(i):
        return int(lcp[clamp(i, 0, cap - 1)])

    out = np.zeros((4, B), np.int64)
    for b in range(B):
        m = int(lens[b])
        l, r = int(l0[b]), int(r0[b])
        i = arg_rmq(l + 1, r)
        q = lcp_at(i)
        done = not need[b] or not (q < m and l < r and l < i)
        phase = steps = 0
        while not done and steps < 2 * cap + 64:
            if phase == 0:
                c = int(pat[b, clamp(q, 0, Lmax - 1)])
                if int(lc[clamp(i, 0, cap - 1)]) == c:
                    r, phase = i - 1, 1
                elif i == r:
                    l, phase = i, 1
                else:
                    below = i < r
                    l = i
                    i = arg_rmq(l + 1, r)
                    if not (below and lcp_at(i) == q):
                        phase = 1
            else:
                lcpi = lcp_at(i)
                if lcpi == q and l < r:
                    events["two_row"] += int(r == l + 1)
                    i = arg_rmq(l + 1, r)
                    q = lcp_at(i)
                elif lcpi == q:
                    i, q = l, lcp_at(l)
                else:
                    q = lcpi
                done = not (q < m and l < r and l < i)
                events["ran_out"] += int(done and q < m)
                phase = 0
            steps += 1
        out[:, b] = (l, r, q, steps)
    return out


K7_CASES = {
    # "ab" is the second row of the two-row interval of "a"
    "two_rows": (b"aab" * 3 + b"ab" + b"aab", dict(tli_bits=2)),
    # nodes of three or four children: tied minima in the argmin ranges
    "ties": (rand_dna(1500, seed=7), dict(tli_bits=6)),
    "periodic": (b"abab" * 250, dict(tli_bits=8)),
    "mississippi": (b"mississippi", dict(tli_bits=6)),
    "rep_dna": (rep_dna(3000, unit_len=400, seed=5, mutations=6), {}),
    "tldt_dna": (rand_dna(3000, seed=3001), dict(tli="tldt", maxsize=8)),
    "tldt_repeats": (b"abab" * 200 + b"bba" * 100,
                     dict(tli="tldt", maxsize=4)),
    "int64_tllt": (rand_dna(1700, seed=41),
                   dict(config=SAConfig(force_int64=True))),
    "int64_tldt": (rep_dna(2000, unit_len=300, seed=2, mutations=4),
                   dict(tli="tldt", maxsize=8,
                        config=SAConfig(force_int64=True))),
}


@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_blind_search_model_vs_plain(monkeypatch, name):
    from psac_tpu_torch.ops import blind_search as k7

    text, kw = K7_CASES[name]
    d = t_desa.build_desa(text, "cpu", **kw)
    events = {"tie": 0, "two_row": 0, "ran_out": 0, "calls": 0}

    def checked(pat, lens, l0, r0, need, lcp, lc, rmq, cap, stats):
        got = k7.blind_search_plain(pat, lens, l0, r0, need, lcp, lc, rmq,
                                    cap, stats)
        assert got[2].dtype == lcp.dtype and got[0].dtype == torch.int32
        want = _k7_model(pat.numpy(), lens.numpy(), l0.numpy(), r0.numpy(),
                         need.numpy(), lcp.numpy(), lc.numpy(),
                         rmq.tab_v.numpy(), rmq.tab_a.numpy(), rmq.block,
                         cap, events)
        for k, g in enumerate(got):
            np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                          want[k], err_msg=str(k))
        events["calls"] += 1
        return got

    monkeypatch.setattr(t_desa, "blind_search", checked)
    # substrings, absent patterns, patterns longer than any match or than
    # the text, and empty ones (zero-length rows of the batch)
    pats = _patterns(text, 3) + [text[:40] + text[:5],
                                 text + text[:7], b"", b""]
    got = d.bulk_locate(pats)
    assert events["calls"] >= (2 if kw.get("tli") == "tldt" else 1)
    sa = suffix_array_np(text)
    for pat, (l, r) in zip(pats, got):
        assert sorted(sa[l:r].tolist()) == sorted(occurrences(text, pat)), \
            (pat, l, r)
    assert d.last_stats["steps"] > 0
    if name == "two_rows":
        assert events["two_row"] > 0
    if name == "ties":
        assert events["tie"] > 0
    assert events["ran_out"] > 0 or name == "mississippi"


def test_blind_search_reports_steps_per_pattern():
    """The plain walk's step counts are per pattern: a pattern that is not
    walked takes none, and the batch's ``steps`` is the longest walk."""
    from psac_tpu_torch.ops.blind_search import blind_search

    text = rand_dna(2000, seed=5)
    d = t_desa.build_desa(text, "cpu")
    pats = [text[10:40], text[:3], b"", text[500:520]]
    pat, dl, _ = d.encode_patterns(pats)
    l0 = torch.zeros(4, dtype=torch.int32)
    r0 = torch.full((4,), d.cap - 1, dtype=torch.int32)
    need = dl > 0
    stats = {"readbacks": 0}
    l, r, q, steps = blind_search(pat, dl, l0, r0, need, d.lcp, d.lc, d.rmq,
                                  d.cap, stats)
    assert steps.dtype == torch.int32 and steps[2] == 0
    assert int(steps.max()) > 0 and stats["readbacks"] >= 1
    d.bulk_locate(pats)
    assert d.last_stats["steps"] > 0


# ---------------------------------------------------------------------------
# K7's group argmin: G lanes, 16-byte vectors, one shuffle tree
# ---------------------------------------------------------------------------

K7_LANES = (1, 4, 8, 16, 32)
#: most 16-byte vectors per lane in a load round (``PSAC_K7_ROUND``)
K7_ROUNDS = (2, 4, 8)


def _k7_round(lanes: int, itemsize: int, max_round: int) -> int:
    """Vectors per lane in a round: enough for both edge parts of the
    largest block, at most ``max_round``."""
    from psac_tpu_torch.ops.blind_search import MAX_BLOCK

    return min(max_round, -(-(2 * MAX_BLOCK * itemsize // 16) // lanes))


def _k7_group_argmin(lcp, tab_v, tab_a, block: int, cap: int, events: dict,
                     *, lanes: int, max_round: int,
                     rounds: list | None = None):
    """The argmin of ``csrc/blind_search.cu`` taken by a group of ``lanes``
    lanes: the edge parts read as aligned 16-byte vectors (16 //
    itemsize words), the left part's then the right part's, lane k taking
    vectors k, k + G, ... in rounds of ``_k7_round`` per lane; each lane
    meets its words in increasing order and keeps the first of its least,
    a word outside [lo, hi] counting as INF; where full blocks lie between,
    lane 0 takes the first table entry and lane 1 (lane 0 at G = 1) the
    second, in the same round; lane 0 takes the two seeds; an xor-shuffle
    tree combines the lanes' least pairs, after which every lane holds the
    same pair; where no full block lies between and that pair's value is
    INF, the table entries' indexes join it with value INF (a second
    round).  Each call appends its load rounds to ``rounds``.  Also checks
    the kernel's shortcut: the winning value is the LCP at the winning
    index unless it is INF."""
    G = lanes
    INF = int(np.iinfo(lcp.dtype).max)
    IMAX = int(np.iinfo(np.int32).max)
    VE = 16 // lcp.dtype.itemsize
    R = _k7_round(G, lcp.dtype.itemsize, max_round)
    levels, nb = tab_v.shape
    last = levels * nb - 1
    fv, fa = tab_v.reshape(-1), tab_a.reshape(-1)
    clamp = _clamp
    assert lcp.shape[0] == cap and cap % VE == 0

    def arg_rmq(lo, hi):
        lo = clamp(lo, 0, cap - 1)
        hi = clamp(max(hi, lo), 0, cap - 1)
        bl, bh = lo // block, hi // block
        lend = hi if bl == bh else (bl + 1) * block - 1
        ln = bh - bl - 1
        lev = ln.bit_length() - 1 if ln > 0 else 0
        t0 = clamp(lev * nb + bl + 1, 0, last)
        t1 = clamp(lev * nb + bh - 1 - (1 << lev) + 1, 0, last)
        vl = lo // VE
        nl = lend // VE - vl + 1
        vr = bh * block // VE
        n = nl + (hi // VE - vr + 1 if bl != bh else 0)
        best = [(INF, IMAX)] * G
        nround = 0
        for base in range(0, n, G * R):
            nround += 1
            for lane in range(G):
                for k in range(R):
                    c = base + lane + k * G
                    if c >= n:
                        continue
                    w = (vl + c if c < nl else vr + c - nl) * VE
                    vec = lcp[w:w + VE]  # one 16-byte load
                    assert vec.shape[0] == VE
                    for e in range(VE):
                        x = int(vec[e]) if lo <= w + e <= hi else INF
                        if x < best[lane][0]:
                            best[lane] = (x, w + e)
        best[0] = min(best[0], (INF, bl * block))
        if bl != bh:
            best[0] = min(best[0], (INF, bh * block))
        if ln > 0:
            best[0] = min(best[0], (int(fv[t0]), int(fa[t0])))
            t1_lane = 1 if G > 1 else 0
            best[t1_lane] = min(best[t1_lane], (int(fv[t1]), int(fa[t1])))
        off = G // 2
        while off:
            best = [min(best[k], best[k ^ off]) for k in range(G)]
            off //= 2
        assert len(set(best)) == 1
        v, i = best[0]
        if ln <= 0 and v == INF:
            nround += 1
            v, i = min((v, i), (INF, int(fa[t0])), (INF, int(fa[t1])))
        assert 0 <= i < cap and (v == INF or v == int(lcp[i]))
        if rounds is not None:
            rounds.append(nround)
        return i

    return arg_rmq


def _k7_table(lcp: np.ndarray, block: int):
    from psac_tpu_torch.ops.rmq import build_arg_rmq

    rmq = build_arg_rmq(torch.from_numpy(lcp), block)
    return rmq.tab_v.numpy(), rmq.tab_a.numpy()


@st.composite
def _k7_ranges(draw, block: int, itemsize: int):
    """An LCP of one to six blocks with runs of INF and many ties (values
    from a small alphabet) and a list of query ranges: lo == hi, ranges
    inside one block, ranges over two blocks (no full block between),
    reversed and out-of-slab ranges (clamped), and wide ones."""
    nblk = draw(st.integers(1, 6))
    cap = nblk * block
    dt = np.int32 if itemsize == 4 else np.int64
    INF = int(np.iinfo(dt).max)
    vals = draw(st.lists(st.integers(0, 3), min_size=cap, max_size=cap))
    lcp = np.array(vals, dt)
    for _ in range(draw(st.integers(0, 3))):
        a = draw(st.integers(0, cap - 1))
        lcp[a:a + draw(st.integers(1, 2 * block))] = INF
    if draw(st.booleans()):
        lcp[-draw(st.integers(1, cap)):] = INF  # a padded tail
    if itemsize == 8 and draw(st.booleans()):
        lcp = np.where(lcp == INF, lcp, lcp + (1 << 40))  # wide values
    pos = st.integers(-2, cap + 2)
    ranges = draw(st.lists(st.tuples(pos, pos), min_size=1, max_size=12))
    for lo in draw(st.lists(st.integers(0, cap - 1), max_size=4)):
        b0 = lo // block * block
        ranges += [(lo, lo), (lo, min(cap - 1, b0 + block - 1)),
                   (lo, min(cap - 1, b0 + 2 * block - 1))]
    return lcp, ranges


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("lanes", K7_LANES)
@settings(max_examples=30, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_k7_group_argmin_vs_serial(lanes, block, itemsize, data):
    """The group argmin equals the serial argmin of ``_k7_model`` on every
    range, bit for bit, at every lane count, block and vector width."""
    lcp, ranges = data.draw(_k7_ranges(block, itemsize))
    max_round = data.draw(st.sampled_from(K7_ROUNDS))
    cap = lcp.shape[0]
    tab_v, tab_a = _k7_table(lcp, block)
    events = {"tie": 0}
    serial = _k7_serial_argmin(lcp, tab_v, tab_a, block, cap, events)
    rounds = []
    group = _k7_group_argmin(lcp, tab_v, tab_a, block, cap, events,
                             lanes=lanes, max_round=max_round,
                             rounds=rounds)
    INF = int(np.iinfo(lcp.dtype).max)
    for lo, hi in ranges:
        assert group(lo, hi) == serial(lo, hi), (lo, hi)
        # one round, unless the edge parts outgrow a round's vectors or
        # every word is INF with no full block between (the table's indexes)
        lo_, hi_ = _clamp(lo, 0, cap - 1), _clamp(max(hi, lo), 0, cap - 1)
        wide = hi_ // block - lo_ // block > 1
        nvec = 2 * block * itemsize // 16  # the most the edge parts hold
        fits = lanes * _k7_round(lanes, itemsize, max_round) >= nvec
        if fits and (wide or lcp[lo_:hi_ + 1].min() < INF):
            assert rounds[-1] == 1, (lo, hi)


@functools.lru_cache(maxsize=None)
def _k7_case_calls(name: str) -> list:
    """The blind searches of ``bulk_locate`` on K7_CASES[name]'s index and
    patterns: each call's arguments and the plain version's outputs."""
    from psac_tpu_torch.ops import blind_search as k7

    text, kw = K7_CASES[name]
    d = t_desa.build_desa(text, "cpu", **kw)
    calls = []

    def record(*args):
        got = k7.blind_search_plain(*args)
        calls.append((args, tuple(g.numpy().astype(np.int64) for g in got)))
        return got

    pats = _patterns(text, 3) + [text[:40] + text[:5],
                                 text + text[:7], b"", b""]
    with mock.patch.object(t_desa, "blind_search", record):
        d.bulk_locate(pats)
    return calls


@pytest.mark.parametrize("lanes", K7_LANES)
@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_blind_search_group_model_vs_plain(name, lanes):
    """The whole walk with the group argmin equals the plain version on
    the cases of ``test_blind_search_model_vs_plain`` (two-row intervals,
    ties, TLDT samples and slabs, int64) in all four outputs."""
    calls = _k7_case_calls(name)
    assert calls
    for args, want in calls:
        pat, lens, l0, r0, need, lcp, lc, rmq, cap, _ = args
        events = {"tie": 0, "two_row": 0, "ran_out": 0}
        got = _k7_model(pat.numpy(), lens.numpy(), l0.numpy(), r0.numpy(),
                        need.numpy(), lcp.numpy(), lc.numpy(),
                        rmq.tab_v.numpy(), rmq.tab_a.numpy(), rmq.block,
                        cap, events,
                        argmin=functools.partial(_k7_group_argmin,
                                                 lanes=lanes, max_round=2))
        for k in range(4):
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
