"""Generalized suffix array and generalized suffix tree of the port at
``device="cpu"`` against the JAX package at p = 1 (the whole padded device
state) and against the sorting oracle and ``gst_oracle`` on the cases of
tests/test_gsa.py, int32 and int64.  Exact equality (integers only)."""

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig, build_gsa, build_gst
from psac_tpu_torch.models import gsa as t_gsa
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.models import suffix_tree as t_st
from psac_tpu_torch.ops import rmq as t_rmq
from psac_tpu_torch.ops.alphabet import Alphabet, rand_dna
from psac_tpu_torch.ops.oracle import lcp_kasai, suffix_array_np
from psac_tpu_torch.parallel.ansv import PLAIN
from psac_tpu_torch.parallel.route import route_scatter
from psac_tpu_torch.verify.cases import near_identical_family as family
from psac_tpu_torch.verify.cases import twin_prefix_set
from psac_tpu_torch.verify.gsa_oracle import gsa_oracle, gsa_oracle_native
from psac_tpu_torch.verify.suffix_tree_oracle import gst_oracle

torch.set_num_threads(1)


def gst_expected(parts):
    flat = b"".join(parts)
    lens = np.array([len(x) for x in parts], np.int64)
    eos = np.repeat(np.cumsum(lens), lens)
    alpha = Alphabet.from_bytes(flat)
    sa, lcp = gsa_oracle(parts)
    return gst_oracle(alpha.encode(flat), sa, lcp, eos, alpha.sigma)


def _dna_set(seed, count, lo, hi, salt):
    rng = np.random.RandomState(seed)
    return [rand_dna(int(ln), seed=int(ln) + salt * j)
            for j, ln in enumerate(rng.randint(lo, hi, size=count))]


def _mixed_set(seed, base):
    rng = np.random.RandomState(seed)
    strings = [rand_dna(int(ln), seed=base + i)
               for i, ln in enumerate(rng.randint(2, 150, 30))]
    return strings + [b"abab" * 40] * 3 + [b"a" * 120, b"a" * 60]


SETS = {
    "repeat_family": [b"ab" * i for i in range(1, 12)],
    "duplicates": [b"banana"] * 5 + [b"ban", b"anana"],
    "single": [b"mississippi"],
    "random_dna": _dna_set(9, 12, 1, 400, 1),
    "newline_flat": b"abc\nbca\ncab\n",
    "tiny": [b"a", b"b", b"a", b"ab", b"ba", b"b", b"aa"] * 3,
    "mixed": _mixed_set(17, 300),
    "graft24": [rand_dna(int(ln), seed=100 + i) for i, ln in enumerate(
        np.random.RandomState(13).randint(5, 200, size=24))],
    "near_identical": family(8, 3000, 3, seed=5),
}
GST_SETS = {
    "repeat_family": [b"ab" * i for i in range(1, 8)],
    "bananas": [b"banana", b"ananas", b"banana", b"nab"],
    "rotations": [b"abc", b"bca", b"cab"],
    "random_dna": _dna_set(3, 10, 2, 300, 7),
    "graft24": SETS["graft24"],
    "duplicates": SETS["duplicates"],
    "tiny": SETS["tiny"],
}
CONFIGS = {"default": SAConfig(), "int64": SAConfig(force_int64=True)}


def _parts(strings):
    return t_gsa._flatten(strings)[0], [
        bytes(x) for x in (strings.split(b"\n") if isinstance(strings, bytes)
                           else strings) if len(x)]


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(SETS))
def test_gsa_vs_sorting_oracle(name, cfg):
    res = build_gsa(SETS[name], "cpu", CONFIGS[cfg])
    _, parts = _parts(SETS[name])
    want_sa, want_lcp = gsa_oracle(parts)
    np.testing.assert_array_equal(res.sa, want_sa)
    np.testing.assert_array_equal(res.lcp, want_lcp)
    np.testing.assert_array_equal(res.lens, [len(x) for x in parts])
    assert res.nstrings == len(parts) and res.n == len(want_sa)


def test_gsa_single_string_equals_sa():
    text = b"mississippi"
    res = build_gsa([text], "cpu")
    sa = suffix_array_np(text)
    np.testing.assert_array_equal(res.sa, sa)
    np.testing.assert_array_equal(res.lcp, lcp_kasai(text, sa))


@pytest.mark.parametrize("name", ["near_identical", "mixed", "tiny"])
def test_gsa_without_lcp(name):
    res = build_gsa(SETS[name], "cpu", SAConfig(construct_lcp=False))
    assert res.lcp is None
    np.testing.assert_array_equal(res.sa, gsa_oracle(_parts(SETS[name])[1])[0])


@pytest.mark.parametrize("name,cfg", [("near_identical", "default"),
                                      ("mixed", "default"),
                                      ("mixed", "int64"),
                                      ("newline_flat", "default"),
                                      ("twin_prefix", "default")])
def test_device_state_vs_jax(mesh1, name, cfg):
    """The whole padded (N,) sa, lcp, eos and xs equal the JAX package's
    (``twin_prefix`` runs both tail stages with their third buffer)."""
    import jax

    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models.gsa import build_gsa_device

    config = CONFIGS[cfg]
    strings = twin_prefix_set() if name == "twin_prefix" else SETS[name]
    jd = build_gsa_device(strings, mesh=mesh1,
                          config=JaxSAConfig(force_int64=config.force_int64))
    td = t_gsa.build_gsa_device(strings, "cpu", config)
    assert (td.n, td.N) == (jd.n, jd.N)
    np.testing.assert_array_equal(td.lens, jd.lens)
    for field in ("sa", "lcp", "eos", "xs"):
        want = np.asarray(jax.device_get(getattr(jd, field)))
        got = getattr(td, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def test_gsa_stages_reached(monkeypatch):
    """The twin-prefix set runs dense eos-masked steps with K6 in each, the
    big tail stage with its third buffer for several steps, the
    recompaction and the small stage, and equals the native oracle; the
    near-identical family stays in the dense loop; a random set enters the
    tail at once."""
    calls = []
    for cls, name in ((t_gsa._GsaBuilder, "_gstep_local"),
                      (t_sa._Builder, "_tail_enter_local"),
                      (t_sa._Builder, "_tail_recompact_local"),
                      (t_sa._Builder, "_tail_step_local"),
                      (t_sa._Builder, "_resolve_fused_local"),
                      (t_sa._Builder, "_resolve_local")):
        orig = getattr(cls, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append((_name, a))
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, name, spy)
    parts = twin_prefix_set()
    res = build_gsa(parts, "cpu")
    names = [c[0] for c in calls]
    assert names.count("_gstep_local") >= 2
    assert names.count("_resolve_fused_local") == names.count("_gstep_local")
    assert names.count("_tail_recompact_local") == 1
    before = names.index("_tail_recompact_local")
    assert names[:before].count("_tail_step_local") >= 3
    assert names[before:].count("_tail_step_local") >= 1
    assert names.count("_resolve_local") == names.count("_tail_step_local")
    enter = next(a for nm, a in calls if nm == "_tail_enter_local")
    assert len(enter[4]) == 1  # the row-aligned eos bound rides along
    step = next(a for nm, a in calls if nm == "_tail_step_local")
    assert len(step[0]) == 3   # (cs, cb, ce)
    want_sa, want_lcp = gsa_oracle_native(*t_gsa._flatten(parts))
    np.testing.assert_array_equal(res.sa, want_sa)
    np.testing.assert_array_equal(res.lcp, want_lcp)
    calls.clear()
    build_gsa(family(16, 4096, 4, seed=2), "cpu")
    assert [c[0] for c in calls].count("_gstep_local") >= 6
    calls.clear()
    build_gsa(SETS["random_dna"], "cpu")
    names = [c[0] for c in calls]
    assert "_gstep_local" not in names and "_tail_enter_local" in names


@pytest.mark.parametrize("name", sorted(SETS))
def test_native_oracle_vs_sorting_oracle(name):
    """The SA-IS based host oracle (what the GPU smoke run holds the large
    sets against) equals the sorting oracle."""
    flat, parts = _parts(SETS[name])
    got_sa, got_lcp = gsa_oracle_native(flat, [len(x) for x in parts])
    want_sa, want_lcp = gsa_oracle(parts)
    np.testing.assert_array_equal(got_sa, want_sa)
    np.testing.assert_array_equal(got_lcp, want_lcp)


def test_seeded_sets_are_what_they_say():
    """The family's copies differ from the base in a few places; the
    twin-prefix pairs share exactly their prefix."""
    fam = family(5, 400, 3, seed=4)
    assert len(fam) == 5 and {len(x) for x in fam} == {400}
    assert fam == family(5, 400, 3, seed=4)
    assert all(1 <= sum(a != b for a, b in zip(fam[0], x)) <= 3
               for x in fam[1:])
    prefixes = (700, 300, 150, 90)
    parts = twin_prefix_set(prefixes)
    assert [len(x) for x in parts[:14]] == [4096] * 14
    for p, a, b in zip(prefixes, parts[14::2], parts[15::2]):
        assert len(a) == len(b) == p + 21
        assert a[:p] == b[:p] and a[p] != b[p]


def test_eos_and_padding():
    flat, lens = t_gsa._flatten([b"abc", b"", b"de", b"f"])
    assert flat == b"abcdef" and lens.tolist() == [3, 2, 1]
    for dt in (torch.int32, torch.int64):
        eos = t_gsa._eos_device(lens, 6, 8, dt, "cpu")
        assert eos.dtype == dt
        assert eos.tolist() == [3, 3, 3, 5, 5, 6, 6, 7]


def test_tiefix_fills_identical_whole_suffixes():
    """Rows still at the sentinel N after the loop are identical whole
    suffixes and take eos[SA] - SA."""
    N = 8
    lcp = torch.tensor([0, 0, 0, N, 1, N, 2, N], dtype=torch.int32)
    sa = torch.tensor([7, 6, 5, 2, 0, 4, 1, 3], dtype=torch.int32)
    eos = torch.tensor([3, 3, 3, 5, 5, 5, 6, 7], dtype=torch.int32)
    got = t_gsa._gsa_tiefix(None, lcp, sa, eos)
    assert got.tolist() == [0, 0, 0, 1, 1, 1, 2, 2]


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(GST_SETS))
def test_gst_vs_oracle(name, cfg):
    got = build_gst(GST_SETS[name], "cpu", CONFIGS[cfg])
    np.testing.assert_array_equal(got, gst_expected(GST_SETS[name]))


@pytest.mark.parametrize("name", ["graft24", "bananas"])
def test_gst_vs_jax_from_one_gsa(mesh1, name):
    """The JAX package's device GSA, carried over as numpy arrays through
    ``DeviceGSA.from_numpy``, gives the same padded node table in the port
    as in the JAX package, and as the port's own GSA does."""
    import jax

    from psac_tpu.models.gsa import build_gsa_device
    from psac_tpu.models.suffix_tree import construct_gst_device

    parts = GST_SETS[name]
    jd = build_gsa_device(parts, mesh=mesh1)
    want = construct_gst_device(jd)
    sa, lcp, eos, xs = (np.asarray(jax.device_get(a))
                        for a in (jd.sa, jd.lcp, jd.eos, jd.xs))
    dgsa = t_gsa.DeviceGSA.from_numpy(sa, lcp, eos, xs, jd.alphabet, jd.lens,
                                      jd.n, jd.N, "cpu")
    assert dgsa.sa.dtype == torch.int32 and dgsa.xs.dtype == torch.int32
    tree = t_st.construct_gst_device(dgsa)
    assert (tree.sigma, tree.n, tree.N) == (want.sigma, want.n, want.N)
    np.testing.assert_array_equal(tree.nodes.numpy(),
                                  np.asarray(jax.device_get(want.nodes)))
    np.testing.assert_array_equal(tree.materialize(), gst_expected(parts))
    own = t_st.construct_gst_device(t_gsa.build_gsa_device(parts, "cpu"))
    assert torch.equal(own.nodes, tree.nodes)
    assert torch.equal(t_st._gst_local(dgsa, PLAIN).nodes, tree.nodes)
    res = dgsa.materialize()
    np.testing.assert_array_equal(res.sa, gsa_oracle(parts)[0])


def test_start_bit_only_below_n():
    """Position n is no string start, though eos[n - 1] == n: the start
    bits are computed for positions below n only, so the ``$`` test does not
    lean on the mask that hides position n from the gather."""
    lens = np.array([3, 2, 1])
    for n, N in ((6, 8), (6, 6)):
        eos = t_gsa._eos_device(lens, n, N, torch.int32, "cpu")
        bits = t_st._start_bits(eos, n)
        assert bits.tolist() == ([True, False, False, True, False, True]
                                 + [False] * (N - n))
    # a set whose flat text fills its padded length: SA + depth reaches n = N
    parts = [b"abab", b"ab", b"ba"]
    dg = t_gsa.build_gsa_device(parts, "cpu")
    assert dg.n == dg.N == 8
    np.testing.assert_array_equal(
        t_st.construct_gst_device(dg).materialize(), gst_expected(parts))


def test_gst_requires_lcp():
    dg = t_gsa.build_gsa_device([b"banana", b"ban"], "cpu",
                                SAConfig(construct_lcp=False))
    with pytest.raises(ValueError):
        t_st.construct_gst_device(dg)


@pytest.mark.parametrize("how", ["set", "min", "max"])
@pytest.mark.parametrize("dt", [torch.int32, torch.int64], ids=["i32", "i64"])
def test_route_scatter_combine_vs_jax(how, dt):
    """``route_scatter`` with ``combine`` against the JAX package's p = 1
    branch: repeated (row, slot) places merge with each other and with the
    value already there; invalid records are dropped."""
    import jax.numpy as jnp

    from psac_tpu.models.suffix_array import _x64_ctx
    from psac_tpu.parallel.route import route_scatter as jax_scatter

    rng = np.random.RandomState(4)
    s, width, m = 40, 3, 200
    rows = rng.randint(0, s, m)
    slots = rng.randint(0, width, m)
    if how == "set":  # distinct places: an indexed write is unordered
        flat = rng.permutation(s * width)[:m % (s * width)]
        rows, slots = flat // width, flat % width
    m = len(rows)
    vals = rng.randint(-50, 50, m)
    valid = rng.rand(m) < 0.8
    tgt = rng.randint(-20, 20, s * width)
    jdt = jnp.int32 if dt == torch.int32 else jnp.int64
    with _x64_ctx(jdt):
        (want,) = jax_scatter(jnp.asarray(rows, jdt), (jnp.asarray(vals, jdt),),
                              (jnp.asarray(tgt, jdt),), jnp.asarray(valid),
                              s, 1, combine=(how,), width=width,
                              slots=jnp.asarray(slots, jnp.int32))
        want = np.asarray(want)
    tgt_t = torch.from_numpy(tgt).to(dt)
    (got,) = route_scatter(torch.from_numpy(rows).to(dt),
                           (torch.from_numpy(vals).to(dt),), (tgt_t,),
                           torch.from_numpy(valid), width=width,
                           slots=torch.from_numpy(slots), combine=(how,))
    assert got.dtype == dt
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tgt_t.numpy(), tgt)  # input untouched


@pytest.mark.parametrize("entry", ["build_gsa", "build_gst",
                                   "build_gsa_device"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Called with no device, the GSA and GST builds resolve None through
    ``config.resolve_device``, which gives the card.  The spy hands the CPU
    back so the call runs here."""
    import psac_tpu_torch
    from psac_tpu_torch import config

    asked = []
    real = config.resolve_device

    def spy(device=None):
        asked.append(real(device))
        return torch.device("cpu")

    monkeypatch.setattr(config, "resolve_device", spy)
    fn = t_gsa.build_gsa_device if entry == "build_gsa_device" else \
        getattr(psac_tpu_torch, entry)
    fn([b"banana", b"bandana"])
    assert asked == [torch.device("cuda")]


def test_edge_inputs_and_errors():
    res = build_gsa([], "cpu")
    assert res.n == 0 and len(res.sa) == 0 and len(res.lcp) == 0
    assert build_gsa([b"", b""], "cpu", SAConfig(construct_lcp=False)).lcp \
        is None
    with pytest.raises(ValueError):
        t_gsa.build_gsa_device([], "cpu")
    with pytest.raises(ValueError):
        build_gsa([b"ab\x00c"], "cpu")
    # fused=False (once NotImplementedError) builds the oracle's result
    res = build_gsa([b"abc", b"bc"], "cpu", SAConfig(fused=False))
    want_sa, want_lcp = gsa_oracle([b"abc", b"bc"])
    np.testing.assert_array_equal(res.sa, want_sa)
    np.testing.assert_array_equal(res.lcp, want_lcp)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_gsa([b"abc", b"abd"])


def test_k6_not_launched_on_cpu():
    before = t_rmq.rmq_resolve.launches
    build_gsa(SETS["near_identical"], "cpu")
    assert t_rmq.rmq_resolve.launches == before


#: newline-separated buffers: the device split of ``build_gsa_device`` and
#: ``build_gsa`` against the host split of the same buffer (the list form)
BUFFERS = {
    "empty_lines": b"banana\n\n\nana\n\nnab\n",
    "leading_and_trailing": b"\nbanana\nananas\n",
    "no_trailing_newline": b"banana\nana\nnab\nbanana",
    "one_string": b"mississippi\n",
    "one_string_no_newline": b"mississippi",
    "length_one": b"a\nb\na\nc\nb\na\n",
    "newline_only_at_end": b"abracadabra\n",
    "random_reads": b"\n".join(_dna_set(21, 40, 1, 160, 3)) + b"\n",
}


def _read_set(reads, genome, seed):
    """A seeded read set of ``reads`` reads of 150 bp from a ``genome``-bp
    genome, as the benchmark's ``gen/reads.py`` makes it."""
    from portbench.harness import spec

    params = {"n": 150 * reads, "read_length": 150, "genome": genome,
              "alphabet": "ACGT", "revcomp": 0.5, "sub_rate": 0.002}
    return spec.Finder().module("gen", "reads").make(params, seed, "cpu")


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_buffer_splits_on_the_device_as_the_list_form(name, monkeypatch):
    """A buffer is staged raw and split on the device (never on the host):
    its whole padded device state equals the list form's bit for bit, and
    its GSA, GLCP and GST the oracles'."""
    buf = BUFFERS[name]
    flat, parts = _parts(buf)
    lst = t_gsa.build_gsa_device(parts, "cpu")
    monkeypatch.setattr(t_gsa, "_flatten", None)  # no host split of bytes
    dg = t_gsa.build_gsa_device(buf, "cpu")
    assert (dg.n, dg.N) == (lst.n, lst.N) == (len(flat), dg.N)
    np.testing.assert_array_equal(dg.lens, [len(x) for x in parts])
    for field in ("sa", "lcp", "eos", "xs"):
        a, b = getattr(dg, field), getattr(lst, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    want_sa, want_lcp = gsa_oracle(parts)
    res = build_gsa(bytearray(buf), "cpu")
    np.testing.assert_array_equal(res.sa, want_sa)
    np.testing.assert_array_equal(res.lcp, want_lcp)
    np.testing.assert_array_equal(t_st.construct_gst_device(dg).materialize(),
                                  gst_expected(parts))


def test_buffer_equals_the_file(tmp_path):
    """``build_gsa_device(bytes)`` and ``build_gsa_from_file`` of the same
    content take one path from the staged raw bytes: equal device state."""
    buf = BUFFERS["empty_lines"] + BUFFERS["random_reads"]
    f = tmp_path / "reads.txt"
    f.write_bytes(buf)
    a = t_gsa.build_gsa_device(buf, "cpu")
    b = t_gsa.build_gsa_from_file(str(f), "cpu")
    assert (a.n, a.N) == (b.n, b.N)
    np.testing.assert_array_equal(a.lens, b.lens)
    for field in ("sa", "lcp", "eos", "xs"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_buffer_errors_and_empty_sets():
    for buf in (b"", b"\n", b"\n\n\n"):
        with pytest.raises(ValueError, match="no string content"):
            t_gsa.build_gsa_device(buf, "cpu")
        res = build_gsa(buf, "cpu")
        assert res.n == 0 and len(res.sa) == 0 and res.nstrings == 0
    with pytest.raises(ValueError, match="NUL"):
        t_gsa.build_gsa_device(b"ab\nc\x00d\n", "cpu")


def test_read_set_against_the_benchmark_reference():
    """2,000 reads of 150 bp from a 20-kbp genome (15x, half reverse-
    complemented, 0.2% substitutions), built from their newline buffer:
    the GSA, GLCP and GST equal the benchmark's plain reference, with
    identical whole suffixes and ``$``-edges in most leaf rows."""
    from portbench.reference import gsa_outputs as R

    reads = _read_set(2000, 20000, 2**31 + 26)
    assert len(reads) == 2000 * 151
    dg = t_gsa.build_gsa_device(reads, "cpu")
    tree = t_st.construct_gst_device(dg)
    codes, sigma, eos, sa, lcp = R._reference(reads, "cpu")
    table = R.gst_table(codes, eos, sa, lcp, sigma)
    cut = dg.N - dg.n
    assert torch.equal(dg.sa[cut:].long(), sa)
    got_lcp = dg.lcp[cut:].clone()
    got_lcp[0] = 0
    assert torch.equal(got_lcp, lcp)
    assert torch.equal(tree.nodes.view(dg.N, sigma + 2)[cut:], table)
    rem = eos[sa] - sa
    ties = (lcp[1:] == rem[1:]) & (lcp[1:].long() == rem[:-1])
    # a leaf's edge is ``$`` where its suffix ends at its parent's depth
    depth = torch.maximum(lcp, torch.cat([lcp[1:], lcp.new_zeros(1)]))
    dollar = (rem == depth) & (depth > 0)
    assert ties.sum() > 10000 and dollar.sum() > dg.n // 2
