"""The port's tracer (``psac_tpu_torch.utils.timers``) on the CPU: off, it
records nothing and adds no readback; with ``PSAC_TIMER=1`` the builds,
the tree, the host arrays and the DESA queries give their span trees, the
``readbacks`` counters match the reads the program makes, and the
``[timer]`` sections are spans of the same store; under
``torch.profiler`` the spans are on and appear among the host events,
and only there; on a CPU mesh of 4 shards the shard threads' spans nest
under the caller's and carry their shard.  The ``[timer]`` lines' text is
held to the JAX package's in ``tests/test_torch_host_loop.py``."""

import io
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from psac_tpu_torch import SAConfig
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.models.desa import build_desa
from psac_tpu_torch.models.suffix_tree import construct_suffix_tree_device
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.parallel.mesh import make_mesh
from psac_tpu_torch.utils import timers

torch.set_num_threads(1)

#: enters the host loop's tail at tail_threshold_frac 0.1, and the fused
#: path's at fused_tail_div 2 after one dense step (with a recompaction)
REP_TAIL = rep_dna(n=4096, unit_len=128, seed=5, mutations=200)
CONFIGS = {
    "fused": dict(fused_tail_div=2),
    "host_loop": dict(fused=False),
    "fused_sa_only": dict(fused_tail_div=2, construct_lcp=False),
}


@pytest.fixture(autouse=True)
def fresh_store():
    timers.clear()
    yield
    timers.clear()


def build(text, device="cpu", mesh=None, **cfg):
    xs, alpha, n, N = t_sa.encode_and_shard(text, device, mesh)
    dsa = t_sa.construct_device(xs, alpha, n, N, SAConfig(**cfg), mesh)
    return dsa, xs


def roots(recs, name):
    return [r for r in recs if r.name == name and r.id == r.root]


def under(recs, root):
    return [r for r in recs if r.root == root.id and r is not root]


def named(recs, name):
    return [r for r in recs if r.name == name]


def phases(recs):
    """The construction's phase spans in the order they started."""
    got = sorted((r for r in recs if r.name.startswith("psac.construct.")),
                 key=lambda r: r.t0)
    return [(r.name.rsplit(".", 1)[1], r.attrs.get("op")) for r in got]


# ---------------------------------------------------------------- off

def test_off_records_nothing(monkeypatch):
    monkeypatch.delenv("PSAC_TIMER", raising=False)
    dsa, xs = build(REP_TAIL, **CONFIGS["fused"])
    construct_suffix_tree_device(dsa, xs)
    dsa.materialize()
    assert timers.records() == []


@pytest.mark.parametrize("value", [None, "", "0", "false"])
def test_off_returns_the_shared_null_span(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("PSAC_TIMER", raising=False)
    else:
        monkeypatch.setenv("PSAC_TIMER", value)
    assert not timers.timers_enabled()
    assert timers.span("psac.x") is timers.OFF
    assert timers.call("psac.x", "cpu", n=1) is timers.OFF
    with timers.call("psac.x") as sp:
        sp.set(a=1)
        timers.count("readbacks")
        timers.readback()
        with timers.span("psac.x.y"):
            pass
    assert timers.current() is None
    assert timers.records() == []


def _readback_spies(monkeypatch):
    """Counts of every way the program reads a tensor to the host, and of
    the synchronisations."""
    calls = {}

    def spy(owner, name):
        orig = getattr(owner, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(owner, name, wrapped)

    for name in ("tolist", "cpu", "item", "numpy", "__int__"):
        spy(torch.Tensor, name)
    spy(torch.cuda, "synchronize")
    spy(torch.cuda.Event, "synchronize")
    return calls


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_the_tracer_adds_no_readback(monkeypatch, cfg):
    """The same build, tree and host arrays read the same tensors back
    with the tracer off and on, and nothing synchronises."""
    counts = []
    for on in (False, True):
        if on:
            monkeypatch.setenv("PSAC_TIMER", "1")
        else:
            monkeypatch.delenv("PSAC_TIMER", raising=False)
        with monkeypatch.context() as m:
            calls = _readback_spies(m)
            dsa, xs = build(REP_TAIL, **CONFIGS[cfg])
            if dsa.lcp is not None:
                construct_suffix_tree_device(dsa, xs)
            dsa.materialize()
        counts.append(calls)
    assert counts[0] == counts[1]
    assert "synchronize" not in counts[1]
    assert timers.records()


# ---------------------------------------------------------- PSAC_TIMER=1

@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_span_tree_of_a_build(monkeypatch, capsys, cfg):
    monkeypatch.setenv("PSAC_TIMER", "1")
    reads = []
    real = t_sa._read

    def spy(*scalars):
        reads.append(len(scalars))
        return real(*scalars)

    monkeypatch.setattr(t_sa, "_read", spy)
    build(REP_TAIL, **CONFIGS[cfg])
    recs = timers.records()
    (root,) = roots(recs, "psac.construct")
    assert root.attrs == {"n": 4096, "N": 4096}
    assert root.thread == threading.current_thread().name
    assert root.shard is None
    inner = under(recs, root)
    assert inner and all(r.parent is not None for r in inner)
    assert all(root.t0 <= r.t0 <= r.t1 <= root.t1 for r in inner)
    got = phases(recs)
    assert got[0] == ("init", None)
    assert ("tail", "enter") in got and ("tail", "step") in got
    dense = [r for r in named(recs, "psac.construct.dense")]
    resolve = named(recs, "psac.construct.resolve")
    assert dense
    key = [(r.attrs["d"], r.attrs["nq"]) for r in resolve]
    if cfg == "fused_sa_only":
        assert not resolve
        assert all(r.attrs["nq"] == 0 for r in dense)
    elif cfg == "fused":
        assert key == [(r.attrs["d"], r.attrs["nq"]) for r in dense]
    else:
        assert key == [(r.attrs["d"], r.attrs["nq"]) for r in dense
                       if r.attrs["nq"] > 0]
    assert all(r.attrs["nq"] > 0 for r in resolve)
    if cfg != "host_loop":
        assert ("tail", "recompact") in got
    tails = [r for r in named(recs, "psac.construct.tail")
             if r.attrs["op"] == "step"]
    assert tails[-1].attrs["ue"] == 0
    assert sum(r.counts.get("readbacks", 0) for r in under(recs, root)) \
        == len(reads)
    # each dense step and tail step reads its counters once, inside it
    for r in dense + tails:
        assert r.counts == {"readbacks": 1}
    # on the CPU a span carries no device time
    assert all(r.device_ms is None for r in recs)
    capsys.readouterr()


@pytest.mark.parametrize("on", [False, True])
def test_phases_free_their_arrays_as_before(monkeypatch, capsys, on):
    """Splitting the work into spans keeps no array alive longer, which
    would raise the card's peak: the tree's ANSV answers are freed before
    the character gather, and a dense step's query buffers before the
    next step."""
    import weakref

    from psac_tpu_torch.models import suffix_tree as t_st

    if on:
        monkeypatch.setenv("PSAC_TIMER", "1")
    else:
        monkeypatch.delenv("PSAC_TIMER", raising=False)
    answers, at_gather = [], []

    def ansv_spy(*a, **kw):
        out = real_ansv(*a, **kw)
        answers.extend(weakref.ref(t) for t in out)
        return out

    def gather_spy(*a, **kw):
        at_gather.append(sum(r() is not None for r in answers))
        return real_gather(*a, **kw)

    queries, at_step = [], []

    def step_spy(self, *a, **kw):
        at_step.append(sum(r() is not None for r in queries))
        out = real_step(self, *a, **kw)
        q = out[3]
        if q is not None:
            queries.extend(weakref.ref(q[k])
                           for k in ("qkey", "lq", "rq", "jcol"))
        return out

    real_ansv, real_gather = t_st.ansv_local, t_st.gather_global
    real_step = t_sa._Builder._stepL_local
    monkeypatch.setattr(t_st, "ansv_local", ansv_spy)
    monkeypatch.setattr(t_st, "gather_global", gather_spy)
    monkeypatch.setattr(t_sa._Builder, "_stepL_local", step_spy)
    dsa, xs = build(REP_TAIL, dense_factor=2, fused_tail_div=64)
    construct_suffix_tree_device(dsa, xs)
    capsys.readouterr()
    assert len(answers) == 4 and at_gather == [0]
    assert len(at_step) >= 2 and not any(at_step)


def test_sections_are_spans_of_the_store(monkeypatch, capsys):
    """The ``[timer]`` lines of a host-loop build: one closed section span
    per ``end_section``, in order, each holding the phase it timed."""
    monkeypatch.setenv("PSAC_TIMER", "1")
    build(REP_TAIL, **CONFIGS["host_loop"])
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("[timer]")
             and ": " in ln and ln.endswith(" ms")
             and not ln.startswith("[timer] [construct]   ")]
    secs = sorted(named(timers.records(), "psac.timer.construct"),
                  key=lambda r: r.t0)
    assert [s.attrs["section"] for s in secs] == \
        [ln[len("[timer] [construct] "):ln.rindex(": ")] for ln in lines]
    for s in secs:
        kids = [r for r in timers.records() if r.parent == s.id]
        assert len(kids) == 1 and s.t0 <= kids[0].t0 <= kids[0].t1 <= s.t1
    assert "---- summary" in err


def test_section_timer_prints_when_enabled_alone(monkeypatch):
    monkeypatch.delenv("PSAC_TIMER", raising=False)
    out = io.StringIO()
    t = timers.SectionTimer(label="x", enabled=True, stream=out)
    t.end_section("a")
    t.info("note")
    t.end_section("b")
    t.end_section("a")
    t.summary()
    lines = out.getvalue().splitlines()
    assert [ln.rsplit(": ", 1)[0] for ln in lines[:4]] == \
        ["[timer] [x] a", "[timer] [x] note", "[timer] [x] b",
         "[timer] [x] a"]
    assert lines[4].startswith("[timer] [x] ---- summary (")
    assert sorted(ln.split(" ms x")[1] for ln in lines[5:]) == ["1", "2"]
    assert timers.current() is None
    assert len(named(timers.records(), "psac.timer.x")) == 3


def test_section_timer_off_prints_nothing(monkeypatch):
    monkeypatch.delenv("PSAC_TIMER", raising=False)
    out = io.StringIO()
    t = timers.SectionTimer(label="x", stream=out)
    t.end_section("a")
    t.info("note")
    t.summary()
    assert out.getvalue() == "" and timers.records() == []


def test_tree_host_arrays_and_staging(monkeypatch, capsys):
    monkeypatch.setenv("PSAC_TIMER", "1")
    dsa, xs = build(REP_TAIL)
    construct_suffix_tree_device(dsa, xs)
    dsa.materialize()
    capsys.readouterr()
    recs = timers.records()
    for root_name, kids in (
            ("psac.stage", ["psac.stage.copy", "psac.stage.upload",
                            "psac.stage.count", "psac.stage.decode"]),
            ("psac.st", ["psac.st.ansv", "psac.st.nodes"]),
            ("psac.materialize", ["psac.materialize.widen",
                                  "psac.materialize.copy"])):
        (root,) = roots(recs, root_name)
        got = sorted(under(recs, root), key=lambda r: r.t0)
        assert [r.name for r in got] == kids
        assert all(r.parent == root.id for r in got)
    tot = timers.totals(recs, ("psac.stage", "psac.construct", "psac.st"))
    assert tot.calls == 3
    # the histogram, the init's counters and the tree's overflow count
    assert tot.count("readbacks") >= 3
    assert named(recs, "psac.stage.count")[0].counts == {"readbacks": 1}
    assert named(recs, "psac.st.nodes")[0].counts == {"readbacks": 1}
    assert named(recs, "psac.materialize.copy")[0].counts == \
        {"readbacks": 2}


def test_locate_spans(monkeypatch, capsys):
    text = rand_dna(3000, seed=4)
    d = build_desa(text, "cpu", tli="tldt", tli_bits=8)
    monkeypatch.setenv("PSAC_TIMER", "1")
    timers.clear()
    # two length groups: each is encoded, uploaded, searched and read back
    pats = [text[i:i + 20] for i in range(0, 600, 7)] + \
        [text[i:i + 200] for i in range(0, 600, 50)]
    got = d.bulk_locate(pats)
    capsys.readouterr()
    assert got.shape == (len(pats), 2)
    recs = timers.records()
    (root,) = roots(recs, "psac.locate")
    assert root.attrs == {"patterns": len(pats)}
    names = [r.name for r in sorted(under(recs, root), key=lambda r: r.t0)]
    # the bytes and offsets go up inside the encoding, before the pack
    group = ["psac.locate.encode.join", "psac.locate.upload",
             "psac.locate.encode.pack", "psac.locate.search",
             "psac.locate.download"]
    assert names == ["psac.locate.groups"] + group * 2 + \
        ["psac.locate.download"]
    assert sum(r.attrs["patterns"]
               for r in named(recs, "psac.locate.search")) == len(pats)
    tot = timers.totals(recs, "psac.locate")
    assert tot.count("readbacks") == 2 + 2
    # the pack ran off the card: no pattern was encoded there
    assert tot.count("patterns_on_card") == 0
    assert tot.total("psac.locate.search", "host") > 0
    assert tot.total("psac.locate.search", "device") is None


# ------------------------------------------------------------ the store

def test_spans_nest_count_and_unwind(monkeypatch):
    monkeypatch.setenv("PSAC_TIMER", "1")
    with pytest.raises(KeyError):
        with timers.call("psac.a", k=1) as a:
            with timers.span("psac.a.b") as b:
                timers.count("x", 2)
                timers.count("x")
                b.set(done=True)
            timers.count("y")
            # a section left open, then an exception: both unwound
            sec = timers.SectionTimer(label="open", enabled=True)
            with timers.span("psac.a.c"):
                raise KeyError("c")
    assert timers.current() is None
    recs = timers.records()
    assert [r.name for r in recs] == ["psac.a.b", "psac.a.c", "psac.a"]
    rb, rc, ra = recs
    assert (rb.parent, rb.root, rc.root, ra.parent) == \
        (a.id, a.id, a.id, None)
    # the open section, dropped: it kept no record
    assert rc.parent not in {r.id for r in recs}
    sec.summary()
    assert rb.counts == {"x": 3} and rb.attrs == {"done": True}
    assert ra.counts == {"y": 1} and ra.attrs == {"k": 1}
    assert ra.t0 <= rb.t0 <= rb.t1 <= rc.t0 <= rc.t1 <= ra.t1
    assert ra.host_ms >= rb.host_ms + rc.host_ms
    assert ra.ms == ra.host_ms


def test_phase_spans_need_a_call_or_the_profiler(monkeypatch):
    """``PSAC_TIMER`` turns on the calls; a phase outside any call stays
    off."""
    monkeypatch.setenv("PSAC_TIMER", "1")
    assert timers.span("psac.alone") is timers.OFF
    with timers.call("psac.c"):
        assert timers.span("psac.c.p") is not timers.OFF


def test_totals_take_the_last_calls(monkeypatch):
    monkeypatch.setenv("PSAC_TIMER", "1")
    for i in range(5):
        with timers.call("psac.r"):
            with timers.span("psac.r.p"):
                timers.count("readbacks", i)
        with timers.call("psac.other"):
            timers.count("readbacks", 100)
    recs = timers.records()
    t = timers.totals(recs, "psac.r", 2)
    assert t.calls == 2 and t.count("readbacks") == 3 + 4
    assert t.total("psac.r.q", "host") == 0.0
    assert t.total("psac.r.p", "device") is None
    assert timers.totals(recs, "psac.r", 9).calls == 5
    assert timers.totals(recs, ("psac.r", "psac.other"), 1).count(
        "readbacks") == 104
    none = timers.totals(recs, "psac.none", 3)
    assert none.calls == 0 and none.total("psac.r.p", "host") is None
    assert none.count("readbacks") is None


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(timers, "_store", timers.deque(maxlen=8))
    monkeypatch.setenv("PSAC_TIMER", "1")
    for i in range(20):
        with timers.call("psac.r", i=i):
            pass
    recs = timers.records()
    assert [r.attrs["i"] for r in recs] == list(range(12, 20))


def test_threads_keep_their_own_stacks(monkeypatch):
    monkeypatch.setenv("PSAC_TIMER", "1")
    gate = threading.Barrier(4)

    def work(k):
        with timers.call("psac.t", k=k):
            gate.wait()
            with timers.span("psac.t.p", k=k):
                timers.count("n", k)
                gate.wait()

    ts = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    recs = timers.records()
    for k in range(4):
        (root,) = [r for r in roots(recs, "psac.t") if r.attrs["k"] == k]
        (kid,) = under(recs, root)
        assert kid.attrs["k"] == k and kid.counts == {"n": k}
        assert kid.thread == root.thread


def test_adopted_counts_lose_no_update(monkeypatch):
    """More threads than cores count on one span handed over to them (as
    ``Mesh.run`` hands the caller's span to its shards) and open spans of
    their own, with the interpreter switching threads as often as it can:
    no count and no record is lost."""
    import sys

    monkeypatch.setenv("PSAC_TIMER", "1")
    threads, each = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timers.call("psac.p") as parent:
            def work(rank):
                with timers.adopt(parent, rank):
                    for _ in range(each):
                        timers.count("n")
                        with timers.span("psac.p.k"):
                            timers.count("k")

            ts = [threading.Thread(target=work, args=(r,))
                  for r in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    recs = timers.records()
    (root,) = roots(recs, "psac.p")
    assert root.counts == {"n": threads * each}
    kids = named(recs, "psac.p.k")
    assert len(kids) == threads * each
    assert all(r.parent == root.id and r.counts == {"k": 1} for r in kids)
    assert sorted({r.shard for r in kids}) == list(range(threads))
    assert timers.current() is None


# ------------------------------------------------------------ profiler

def test_spans_under_the_profiler(monkeypatch):
    """Off outside the profile, on inside it with no ``PSAC_TIMER``; the
    profiler's host events carry every span's name."""
    monkeypatch.delenv("PSAC_TIMER", raising=False)
    build(REP_TAIL, **CONFIGS["fused"])
    assert timers.records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dsa, xs = build(REP_TAIL, **CONFIGS["fused"])
        construct_suffix_tree_device(dsa, xs)
        dsa.materialize()
    recs = timers.records()
    assert recs
    host = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert {r.name for r in recs} <= host
    assert {"psac.stage.copy", "psac.construct.init",
            "psac.construct.tail", "psac.st.ansv",
            "psac.materialize.widen"} <= host
    # a span is a FUNCTION-scope record, not a user annotation
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("psac."):
            assert not ev.is_user_annotation()
    timers.clear()
    build(REP_TAIL, **CONFIGS["fused"])
    assert timers.records() == []


# ----------------------------------------------------------------- mesh

def test_mesh_shards_carry_their_shard(monkeypatch, capsys):
    monkeypatch.setenv("PSAC_TIMER", "1")
    mesh = make_mesh(4, devices=["cpu"] * 4)
    try:
        dsa, xs = build(REP_TAIL, mesh=mesh)
        construct_suffix_tree_device(dsa, xs)
        res = dsa.materialize()
    finally:
        mesh.close()
    capsys.readouterr()
    recs = timers.records()
    (croot,) = roots(recs, "psac.construct")
    assert croot.shard is None
    assert phases(recs)[0] == ("init", None)
    (sroot,) = roots(recs, "psac.st")
    shard_spans = [r for r in under(recs, sroot)]
    assert shard_spans
    by = {}
    for r in shard_spans:
        assert r.thread == f"psac-shard-{r.shard}"
        by.setdefault(r.name, []).append(r.shard)
    assert sorted(by["psac.st.ansv"]) == sorted(by["psac.st.nodes"])
    assert set(by["psac.st.ansv"]) == {0, 1, 2, 3}
    for r in named(recs, "psac.st.ansv"):
        assert r.parent == sroot.id
    for r in named(recs, "psac.st.nodes"):
        assert r.counts == {"readbacks": 1}
    # the mesh's staging and host arrays have their spans too
    (stroot,) = roots(recs, "psac.stage")
    assert {r.name for r in under(recs, stroot)} == {
        "psac.stage.upload", "psac.stage.count", "psac.stage.decode"}
    assert roots(recs, "psac.materialize")
    ref, _ = build(REP_TAIL)
    np.testing.assert_array_equal(res.sa, ref.materialize().sa)


def test_bucket_rows_count_only_on_the_card(monkeypatch, capsys):
    """The routing's ``bucket_rows_on_card`` counter counts the rows K12
    places: none on a CPU mesh, where the tree's routes bucket with the
    plain version (the count a card gives: ``test_torch_cuda.py``)."""
    from psac_tpu_torch.parallel import route

    monkeypatch.setenv("PSAC_TIMER", "1")
    calls = []
    plain = route._bucket_by_dest_plain

    def noted(dest, *args):
        calls.append(dest.shape[0])
        return plain(dest, *args)

    monkeypatch.setattr(route, "_bucket_by_dest_plain", noted)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    try:
        dsa, xs = build(REP_TAIL, mesh=mesh)
        construct_suffix_tree_device(dsa, xs)
    finally:
        mesh.close()
    capsys.readouterr()
    tot = timers.totals(timers.records(), ("psac.construct", "psac.st"))
    assert calls and sum(calls) > 0
    assert tot.count("bucket_rows_on_card") == 0


# ---------------------------------------------------------- GSA and GST

def _gsa_set():
    """Near-identical strings, their repeats and short strings: dense
    steps, identical whole suffixes and ``$``-edges."""
    from psac_tpu_torch.verify.cases import near_identical_family

    parts = near_identical_family(6, 400, 3, seed=8)
    return parts + parts[:2] + [b"ACGT", b"CGT", b"GT", b"T", b"T"]


def _true_counts(parts):
    """(identical whole suffixes after the first of each group, ``$``-edges
    among the leaves) of the set, from the host oracle."""
    from psac_tpu_torch.verify.gsa_oracle import gsa_oracle

    sa, lcp = gsa_oracle(parts)
    lens = np.array([len(x) for x in parts])
    rem = np.repeat(np.cumsum(lens), lens)[sa] - sa
    ties = int(((lcp[1:] == rem[1:]) & (lcp[1:] == rem[:-1])).sum())
    depth = np.maximum(lcp, np.append(lcp[1:], 0))
    return ties, int(((rem == depth) & (depth > 0)).sum())


def _gsa_and_gst(buf, **cfg):
    from psac_tpu_torch.models.gsa import build_gsa_device
    from psac_tpu_torch.models.suffix_tree import construct_gst_device

    dg = build_gsa_device(buf, "cpu", SAConfig(**cfg))
    return dg, construct_gst_device(dg)


def test_gsa_and_gst_span_trees(monkeypatch, capsys):
    """``psac.gsa`` holds staging's phases, the split, eos, the
    construction's phases and the tie-fix (no construction span hangs
    loose); ``psac.gst`` holds ``psac.st.ansv``, ``.nodes`` and
    ``.dollar``; the counters read their true values."""
    monkeypatch.setenv("PSAC_TIMER", "1")
    parts = _gsa_set()
    dg, _ = _gsa_and_gst(b"\n".join(parts) + b"\n")
    capsys.readouterr()
    recs = timers.records()
    (g,) = roots(recs, "psac.gsa")
    assert g.attrs == {"n": dg.n, "N": dg.N, "strings": len(parts)}
    kids = [r.name for r in sorted(under(recs, g), key=lambda r: r.t0)]
    assert kids[:3] == ["psac.stage.copy", "psac.stage.upload",
                        "psac.stage.count"]
    assert kids[3:6] == ["psac.gsa.split", "psac.stage.decode",
                         "psac.gsa.eos"]
    assert kids[6] == "psac.construct.init" and kids[-1] == "psac.gsa.tiefix"
    assert "psac.construct.dense" in kids
    assert not [r for r in recs if r.root == r.id and r is not g
                and r.name.startswith(("psac.construct", "psac.stage"))]
    (t,) = roots(recs, "psac.gst")
    assert t.attrs == {"n": dg.n}
    assert [r.name for r in sorted(under(recs, t), key=lambda r: r.t0)] == [
        "psac.st.ansv", "psac.gst.nodes", "psac.gst.dollar",
        "psac.gst.nodes", "psac.gst.dollar"]
    ties, dollar = _true_counts(parts)
    tot = timers.totals(recs, "psac.gsa")
    assert (tot.count("gsa_strings"), tot.count("gsa_tie_rows"),
            tot.count("gsa_redo")) == (len(parts), ties, 0)
    assert ties > 0 and dollar > 0
    assert timers.totals(recs, "psac.gst").count("gst_dollar_edges") == \
        dollar


def test_gsa_redo_is_counted(monkeypatch, capsys):
    """Where the fused path stops with work left (its loops bounded at 0
    iterations) the build is redone on the host-driven loop: ``gsa_redo``
    reads 1, and the tie-fix still fills its rows once."""
    monkeypatch.setenv("PSAC_TIMER", "1")
    monkeypatch.setattr(t_sa, "fused_max_iters", lambda N: 0)
    parts = _gsa_set()
    _gsa_and_gst(b"\n".join(parts))
    err = capsys.readouterr().err
    assert "did not converge" in err
    tot = timers.totals(timers.records(), "psac.gsa")
    assert tot.count("gsa_redo") == 1
    assert tot.count("gsa_tie_rows") == _true_counts(parts)[0]


def test_gsa_and_gst_tracer_adds_no_readback(monkeypatch):
    """The counters made on the device are read when the records are
    taken: a traced GSA and GST read back what an untraced one does."""
    buf = b"\n".join(_gsa_set())
    counts = []
    for on in (False, True):
        if on:
            monkeypatch.setenv("PSAC_TIMER", "1")
        else:
            monkeypatch.delenv("PSAC_TIMER", raising=False)
        with monkeypatch.context() as m:
            calls = _readback_spies(m)
            _gsa_and_gst(buf)
        counts.append(calls)
    assert counts[0] == counts[1]
    assert "synchronize" not in counts[1]
    assert timers.totals(timers.records(), "psac.gst").count(
        "gst_dollar_edges") > 0
