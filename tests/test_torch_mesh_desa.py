"""The DESA on a mesh of p > 1 CPU shards against the JAX package's
``build_desa(text, mesh=make_mesh(p))`` on the conftest's virtual devices
at the same p: the whole padded state (k, the capacity, the segment
starts, the table, each shard's SA/LCP/Lc slab, each shard's RMQ tables
against the column blocks of the JAX ``rmq_parts``, the TLDT sample) and
the ``bulk_locate`` / ``bulk_locate_possible`` ranges with both top-level
indexes, on patterns that straddle the shard boundaries, absent, empty and
out-of-alphabet ones and batches of several length groups; an int64
index.  At p = 3, 6 and 13 against p = 1 and the naive occurrence scan.
The file entry points, ``read_desa`` and ``write_desa`` (byte-identical
at every p and to the JAX package's), the ``PSAC_TIMER`` lines,
``PSAC_DESA_RUNGS``, and ``last_stats`` summed over the shards with the
blind search's calls counted.  Exact equality (integers and bytes only);
each JAX build and query group compiles its programs, seconds apiece, so
the cases are few and small."""

import functools
import re
import threading

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig
from psac_tpu_torch.models import desa as t_desa
from psac_tpu_torch.ops import blind_search as k7
from psac_tpu_torch.ops.alphabet import rand_dna
from psac_tpu_torch.ops.oracle import suffix_array_np
from psac_tpu_torch.parallel.mesh import Replicated, Sharded, make_mesh
from test_torch_desa import _jax_build, occurrences

torch.set_num_threads(1)

TEXTS = {
    "mississippi": (b"mississippi", dict(tli_bits=6)),
    "dna1000": (rand_dna(1000, seed=1000), {}),
    "abab": (b"abab" * 250, dict(tli_bits=8)),
    "int64": (rand_dna(1700, seed=41),
              dict(config=SAConfig(force_int64=True, construct_lc=True))),
    "tldt_dna1000": (rand_dna(1000, seed=1001), dict(tli="tldt", maxsize=8)),
    "tldt_dna13337": (rand_dna(13337, seed=13337), dict(tli="tldt")),
    # the length (so the padded length) and alphabet of "abab"
    "tldt_repeats": (b"abab" * 190 + b"bba" * 80,
                     dict(tli="tldt", maxsize=4)),
}
#: every text at p = 4, the two 1000-character ones at p = 2 and 8; the
#: cases whose batches take three length groups (the others take two: each
#: JAX group compiles its query programs)
JAX_CASES = [(4, name) for name in TEXTS] + [
    (p, name) for p in (2, 8) for name in ("dna1000", "tldt_dna1000")]
THREE_GROUPS = {(4, "dna1000"), (4, "tldt_dna1000")}


@functools.lru_cache(maxsize=None)
def cpu_mesh(p: int):
    return make_mesh(p, ["cpu"] * p)


@functools.lru_cache(maxsize=None)
def j_mesh(p: int):
    from psac_tpu.parallel.mesh import make_mesh as j_make_mesh
    return j_make_mesh(p)


@functools.lru_cache(maxsize=None)
def jax_desa(p: int, name: str):
    """The JAX package's DESA of a text at p (cached: its builds and query
    groups compile for their shapes)."""
    text, kw = TEXTS[name]
    return _jax_build(text, j_mesh(p), **dict(kw))


def mesh_patterns(text: bytes, p: int, seed: int, groups: int = 3) -> list:
    """Substrings, the windows that straddle each shard boundary of the
    block-distributed text, an absent pattern, one with a character
    outside the alphabet, an empty one, one of characters outside the
    alphabet and one longer than any match: of lengths 1..40 (three length
    groups), or, with ``groups=2``, of lengths 9..16 and the empty one."""
    from psac_tpu_torch.parallel.mesh import padded_size

    rng = np.random.RandomState(seed)
    lens = (1, 3, 6, 11, 20, 40) if groups == 3 else (9, 12, 16)
    pats = [text[st:st + ln] for ln in lens
            if ln < len(text) for st in rng.randint(0, len(text) - ln, 3)]
    s = padded_size(len(text), p) // p
    cuts = ((3, 5), (1, 12), (7, 2)) if groups == 3 else ((3, 7), (1, 12))
    for r in range(1, p):
        for a, b in cuts:
            if r * s + b <= len(text) and r * s - a >= 0:
                pats.append(text[r * s - a:r * s + b])
    if groups == 3:
        return pats + [bytes([text[0]]) * 18, text[:3] + b"\x01", b"",
                       b"xyz", text[-5:], text[:30] + text[:9]]
    return pats + [bytes([text[0]]) * 12, text[:8] + b"\x01", b"",
                   b"xyz" * 4, text[-9:], text[:10] + text[:6]]


def same_state(td, jd, p: int):
    """The port's padded DESA at p equals the JAX package's."""
    import jax

    assert td.mesh is cpu_mesh(p) and td.sa.p == p
    assert (td.k, td.cap, td.n, td.N, td.tli) == \
        (jd.k, jd.cap, jd.n, jd.N, jd.tli)
    np.testing.assert_array_equal(td.begins_np, jd.begins_np)

    def host(a):
        return np.asarray(jax.device_get(a))

    for name in ("table", "begins"):
        rep = getattr(td, name)
        assert isinstance(rep, Replicated) and rep.p == p
        want = host(getattr(jd, name))
        for t in rep.shards:
            assert t.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    for name in ("sa", "lcp", "lc"):
        got, want = getattr(td, name), host(getattr(jd, name))
        assert all(t.shape == (td.cap,) for t in got.shards)
        got = got.gather().numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert td.rmq.x is td.lcp and td.rmq.block == jd.rmq_block
    for got, want in zip((td.rmq.tab_v, td.rmq.tab_a), jd.rmq_parts):
        want = host(want)
        nb = want.shape[1] // p
        for r, t in enumerate(got.shards):
            np.testing.assert_array_equal(t.numpy(),
                                          want[:, r * nb:(r + 1) * nb])
    assert (td.samp is None) == (jd.samp is None)
    if td.samp is not None:
        assert (td.samp["m"], td.samp["M"]) == (jd.samp["m"], jd.samp["M"])
        for key in ("off_ext", "lcp", "lc"):
            np.testing.assert_array_equal(td.samp[key].gather().numpy(),
                                          host(jd.samp[key]), key)
        for got, want in zip((td.samp["rmq"].tab_v, td.samp["rmq"].tab_a),
                             jd.samp["rmq"]):
            np.testing.assert_array_equal(got.gather().numpy(), host(want))
    from psac_tpu.models.desa import desa_arrays

    for got, want in zip(t_desa.desa_arrays(td), desa_arrays(jd)):
        np.testing.assert_array_equal(got, want)


def check_ranges(text: bytes, pats: list, got: np.ndarray) -> None:
    sa = suffix_array_np(text)
    for pat, (l, r) in zip(pats, got):
        assert sorted(sa[l:r].tolist()) == sorted(occurrences(text, pat)), \
            (pat, l, r)


@pytest.mark.parametrize("p,name", JAX_CASES)
def test_state_and_answers_vs_jax(p, name):
    text, kw = TEXTS[name]
    td = t_desa.build_desa(text, mesh=cpu_mesh(p), **kw)
    jd = jax_desa(p, name)
    same_state(td, jd, p)
    groups = 3 if (p, name) in THREE_GROUPS else 2
    pats = mesh_patterns(text, p, seed=len(name) + p, groups=groups)
    assert len(t_desa._length_groups(
        np.array([len(x) for x in pats]))) == groups
    got = td.bulk_locate(pats)
    np.testing.assert_array_equal(got, jd.bulk_locate(pats))
    np.testing.assert_array_equal(td.bulk_locate_possible(pats),
                                  jd.bulk_locate_possible(pats))
    check_ranges(text, pats, got)
    if "int64" in name:
        assert td.idt == torch.int64 and td.sa.dtype == torch.int64


#: every shard's thread takes its turn at the interpreter, so the texts
#: thin out as p grows
ODD_P = {3: ("mississippi", "dna1000", "tldt_dna1000", "tldt_repeats"),
         6: ("dna1000", "tldt_repeats"), 13: ("mississippi", "tldt_dna1000")}


@pytest.mark.parametrize("p", sorted(ODD_P))
def test_odd_p_vs_one_device_and_naive(p):
    """Odd p (the odd-even block sort under the construction, shards with
    empty segments at p = 13) answer as one device does, both top-level
    indexes, verified and not."""
    for name in ODD_P[p]:
        text, kw = TEXTS[name]
        one = t_desa.build_desa(text, "cpu", **kw)
        d = t_desa.build_desa(text, mesh=cpu_mesh(p), **kw)
        assert d.sa.p == p and d.tli == one.tli
        pats = mesh_patterns(text, p, seed=p)
        got = d.bulk_locate(pats)
        np.testing.assert_array_equal(got, one.bulk_locate(pats), name)
        check_ranges(text, pats, got)
        possible = d.bulk_locate_possible(pats)
        assert np.all(possible[:, 0] <= possible[:, 1])
        found = got[:, 1] > got[:, 0]
        np.testing.assert_array_equal(possible[found], got[found])
        for t_, o in zip(t_desa.desa_arrays(d), t_desa.desa_arrays(one)):
            np.testing.assert_array_equal(t_, o)


def test_mesh_of_one_shard_is_its_device(tmp_path):
    """A mesh of one shard builds, reads and answers on its device, as
    ``device=`` does."""
    text = rand_dna(700, seed=7)
    one = make_mesh(1, ["cpu"])
    d = t_desa.build_desa(text, mesh=one)
    assert d.mesh is None and d.sa.device.type == "cpu"
    want = t_desa.build_desa(text, "cpu")
    pats = mesh_patterns(text, 1, seed=1)
    np.testing.assert_array_equal(d.bulk_locate(pats), want.bulk_locate(pats))
    pre = str(tmp_path / "i")
    t_desa.write_desa(d, pre)
    r = t_desa.read_desa(text, pre, mesh=one, tli="tldt", maxsize=8)
    assert r.mesh is None
    np.testing.assert_array_equal(r.bulk_locate(pats), want.bulk_locate(pats))


def test_files_and_io_on_a_mesh(tmp_path):
    """``build_desa_from_file`` at p = 4 equals ``build_desa``;
    ``write_desa`` at p = 4 writes the files of p = 1 and of the JAX
    package's ``write_desa`` at p = 4, byte for byte; ``read_desa`` and
    ``read_desa_from_file`` with ``mesh=`` load them into the state of a
    build, with either top-level index."""
    from psac_tpu.models.desa import write_desa as j_write

    text, kw = TEXTS["dna1000"]
    mesh = cpu_mesh(4)
    path = tmp_path / "t.txt"
    path.write_bytes(text)
    d = t_desa.build_desa(text, mesh=mesh)
    f = t_desa.build_desa_from_file(str(path), mesh=mesh)
    for name in ("xs", "sa", "lcp", "lc", "table"):
        assert torch.equal(getattr(f, name).gather(),
                           getattr(d, name).gather()), name
    pres = {k: str(tmp_path / k) for k in ("p4", "p1", "jax")}
    t_desa.write_desa(d, pres["p4"])
    t_desa.write_desa(t_desa.build_desa(text, "cpu"), pres["p1"])
    j_write(jax_desa(4, "dna1000"), pres["jax"])
    for other in ("p1", "jax"):
        for ext in (".sa64", ".lcp64", ".lc64", ".alpha"):
            with open(pres["p4"] + ext, "rb") as a, \
                    open(pres[other] + ext, "rb") as b:
                assert a.read() == b.read(), (other, ext)
    pats = mesh_patterns(text, 4, seed=5)
    want = d.bulk_locate(pats)
    tldt = t_desa.build_desa(text, mesh=mesh, tli="tldt", maxsize=8)
    for tli, built in (("tllt", d), ("tldt", tldt)):
        kw = dict(tli=tli, maxsize=8) if tli == "tldt" else {}
        for r in (t_desa.read_desa(text, pres["p1"], mesh=mesh, **kw),
                  t_desa.read_desa_from_file(str(path), pres["p1"],
                                             mesh=mesh, **kw)):
            assert r.mesh is mesh and r.tli == tli
            for name in ("xs", "sa", "lcp", "lc", "table", "begins"):
                assert torch.equal(getattr(r, name).gather(),
                                   getattr(built, name).gather()), name
            np.testing.assert_array_equal(r.bulk_locate(pats), want)
    with pytest.raises(ValueError, match="index built for"):
        t_desa.read_desa(text[:-1], pres["p4"], mesh=mesh)


def _desa_lines(err: str) -> list:
    return [ln for ln in err.splitlines() if ln.startswith("[timer] [desa]")]


@pytest.mark.parametrize("name", ["dna1000", "tldt_dna1000"])
def test_timer_lines_as_jax(monkeypatch, capsys, name):
    """With ``PSAC_TIMER=1`` the build's partition line and each query
    group's routing line read as the JAX package's at p = 4."""
    text, kw = TEXTS[name]
    monkeypatch.setenv("PSAC_TIMER", "1")
    pats = [text[i:i + 12] for i in range(0, 600, 7)] + [b"C" * 9]
    capsys.readouterr()
    t_desa.build_desa(text, mesh=cpu_mesh(4), **kw).bulk_locate(pats)
    got = _desa_lines(capsys.readouterr().err)
    _jax_build(text, j_mesh(4), **dict(kw)).bulk_locate(pats)
    want = _desa_lines(capsys.readouterr().err)
    assert len(got) == 2 and "partition imbalance" in got[0] and \
        "query routing" in got[1]
    assert got == want
    m = re.search(r"imbalance=([0-9.]+)", got[1])
    assert float(m.group(1)) >= 1.0


def test_rungs_switch_widths_not_answers(monkeypatch):
    """``PSAC_DESA_RUNGS`` sets the plain walk's compaction widths at call
    time; the answers stay."""
    assert k7.rung_widths(4096) == [2048, 512, 256]
    monkeypatch.setenv("PSAC_DESA_RUNGS", "4,16")
    assert k7.rung_widths(4096) == [1024, 256]
    monkeypatch.setenv("PSAC_DESA_RUNGS", "64")
    assert k7.rung_widths(4096) == [256]
    assert k7.rung_widths(256) == []
    text = rand_dna(3000, seed=9)
    rng = np.random.RandomState(4)
    pats = [text[i:i + 30] for i in rng.randint(0, 2970, 2100)]
    d = t_desa.build_desa(text, "cpu")
    got = {}
    for spec in ("", "2,8,64", "64", "1000"):
        monkeypatch.setenv("PSAC_DESA_RUNGS", spec)
        got[spec] = (d.bulk_locate(pats), d.last_stats["readbacks"])
    for spec in got:
        np.testing.assert_array_equal(got[spec][0], got[""][0])
    assert got[""][1] == got["2,8,64"][1] != got["64"][1]


@pytest.mark.parametrize("tli", ["tllt", "tldt"])
def test_stats_and_launches_summed_over_shards(monkeypatch, tli):
    """``last_stats`` sums every shard's blind searches: their longest
    walks and the plain walk's readbacks.  Each shard's answer function
    runs once per chunk of the routed pass, so a length group makes p^2
    slab searches (p chunks on each of p shards), and with the TLDT p more
    of the sample; each search's buffer is the p chunks' received rows."""
    p = 4
    text, kw = TEXTS["tldt_dna1000" if tli == "tldt" else "dna1000"]
    d = t_desa.build_desa(text, mesh=cpu_mesh(p), **kw)
    calls, lock = [], threading.Lock()

    def spy(pat, lens, l0, r0, need, lcp, lc, rmq, cap, stats):
        before = stats["readbacks"]
        out = k7.blind_search_plain(pat, lens, l0, r0, need, lcp, lc, rmq,
                                    cap, stats)
        with lock:
            calls.append((pat.shape[0], cap, int(out[3].max()),
                          stats["readbacks"] - before))
        return out

    monkeypatch.setattr(t_desa, "blind_search", spy)
    pats = [text[i:i + 20] for i in range(0, 900, 9)]  # one length group
    B = len(pats)
    got = d.bulk_locate(pats)
    b = max(p, 1 << (B - 1).bit_length()) // p
    chunk = -(-b // p)
    slab = [c for c in calls if c[1] == d.cap]
    assert len(slab) == p * p and all(c[0] == p * chunk for c in slab)
    if tli == "tldt":
        top = [c for c in calls if c[1] == d.samp["M"]]
        assert len(top) == p and all(c[0] == b for c in top)
    assert len(calls) == p * p + (p if tli == "tldt" else 0)
    assert d.last_stats == {"steps": sum(c[2] for c in calls),
                            "readbacks": sum(c[3] for c in calls)}
    assert d.last_stats["steps"] > 0
    check_ranges(text, pats, got)


def test_replicated_and_sharded_parts():
    """The mesh DESA's replicated arrays hold one equal copy per shard and
    its slabs one block per shard; ``Mesh.run`` hands a shard function the
    DESA with its own copies and blocks."""
    d = t_desa.build_desa(TEXTS["tldt_dna1000"][0], mesh=cpu_mesh(4),
                          tli="tldt", maxsize=8)
    assert isinstance(d.sa, Sharded) and not isinstance(d.sa, Replicated)
    assert len(d.samp["lcp"]) == d.samp["M"]
    for rep in (d.table, d.begins, d.samp["off_ext"], d.samp["rmq"].tab_v):
        assert isinstance(rep, Replicated)
        assert all(torch.equal(t, rep.shards[0]) for t in rep.shards)

    def local(ctx, desa):
        return (desa.lcp.shape[0] == desa.cap,
                desa.rmq.x is desa.lcp,
                desa.samp["rmq"].x is desa.samp["lcp"],
                desa.samp["lcp"].shape[0] == desa.samp["M"],
                desa.begins.shape[0] == ctx.p)

    got = cpu_mesh(4).run(lambda ctx, desa: torch.tensor(local(ctx, desa)),
                          d)
    assert all(bool(t.all()) for t in got.shards)
