"""The read-set cell's pieces (``read_set.gst``): the read generator
repeats per seed and keeps its shape; the plain GSA, GLCP and GST
reference (``reference/gsa_outputs.py``) agrees with the port's host
oracles on small seeded sets, and its control reads wrong; the cell loads
by its names.  (That the reference loads nothing of the program is
``test_guard.py``'s, over every reference module.)"""

import numpy as np
import pytest

from portbench.harness import spec
from portbench.reference import gsa_outputs as R

F = spec.Finder()
BIG = 2**31 + 12345  # seeds run past 32 signed bits
READS = {"n": 150 * 300, "read_length": 150, "genome": 6000,
         "alphabet": "ACGT", "revcomp": 0.5, "sub_rate": 0.002}


def reads_of(params=READS, seed=BIG):
    return F.module("gen", "reads").make(params, seed, "cpu")


def test_reads_repeat_per_seed_and_keep_their_shape():
    a, b, c = reads_of(), reads_of(), reads_of(seed=BIG + 1)
    assert a == b and a != c
    lines = a.split(b"\n")
    assert lines[-1] == b"" and len(lines) == 301
    assert {len(x) for x in lines[:-1]} == {150}
    assert set(a) == set(b"ACGT\n")
    # n is cut down to whole reads
    assert len(reads_of(dict(READS, n=150 * 300 + 149))) == 300 * 151


def _lines(params, seed=BIG):
    return np.frombuffer(reads_of(params, seed), np.uint8).reshape(
        -1, params["read_length"] + 1)[:, :-1]


def test_reads_on_both_strands():
    """One seed draws the genome and the starts first: with revcomp 0.5
    each read is the revcomp-0 read or its reverse complement, about half
    of them the complement."""
    p = dict(READS, n=150 * 400, genome=3000, sub_rate=0)
    fwd, got = _lines(dict(p, revcomp=0)), _lines(p)
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    rc = comp[fwd][:, ::-1]
    same, flipped = (got == fwd).all(1), (got == rc).all(1)
    assert (same | flipped).all()
    assert 150 < flipped.sum() < 250


def test_substitutions_at_their_rate():
    p = dict(READS, n=150 * 2000, sub_rate=0.01)
    diff = _lines(p) != _lines(dict(p, sub_rate=0))
    assert 0.008 < diff.mean() < 0.012


def _oracles(reads: bytes):
    from psac_tpu_torch.ops.alphabet import Alphabet
    from psac_tpu_torch.verify.gsa_oracle import gsa_oracle_native
    from psac_tpu_torch.verify.suffix_tree_oracle import gst_oracle

    parts = [x for x in reads.split(b"\n") if x]
    flat = b"".join(parts)
    lens = np.array([len(x) for x in parts])
    sa, lcp = gsa_oracle_native(flat, lens)
    alpha = Alphabet.from_bytes(flat)
    eos = np.repeat(np.cumsum(lens), lens)
    return sa, lcp, gst_oracle(alpha.encode(flat), sa, lcp, eos,
                               alpha.sigma)


SETS = {
    "reads": lambda: reads_of(),
    "short_reads": lambda: reads_of(dict(READS, read_length=12, n=12 * 200,
                                         genome=80)),
    "ragged_lines": lambda: b"\n\nbanana\nana\n\nnab\nbanana\na\nb\na",
    "one_line": lambda: b"mississippi\n",
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_reference_against_the_oracles(name):
    reads = SETS[name]()
    codes, sigma, eos, sa, lcp = R._reference(reads, "cpu")
    want_sa, want_lcp, want_table = _oracles(reads)
    assert np.array_equal(sa.numpy(), want_sa)
    assert np.array_equal(lcp.numpy(), want_lcp)
    table = R.gst_table(codes, eos, sa, lcp, sigma)
    assert np.array_equal(table.numpy(), want_table)


@pytest.mark.parametrize("seed", [3, BIG])
def test_control_reads_wrong(seed):
    outputs = R.control({"reads": reads_of(seed=seed)}, {"gsa", "glcp",
                                                          "gst"}, "cpu")
    checks, failed = R.check({"reads": reads_of(seed=seed)}, outputs, "cpu")
    assert failed == 1
    assert all(c["value"] > c["limit"] for c in checks)


def test_the_cell_loads_by_its_names():
    bench = spec.load_benchmark()
    c = spec.load_cell("read_set.gst", None, F)
    assert c.cell["chips"] == 1 and c.config["name"] == "read_set"
    assert c.pipeline.REFERENCE == "gsa_outputs"
    assert F.module("gen", c.traffic["text"]["gen"]) is not None
    e2e = {m["name"] for m in spec.metrics_for(bench, "read_set.gst",
                                               "end_to_end")}
    assert e2e == {"build_mbps", "peak_bytes_per_char", "setup_s"}
    layer = {m["name"] for m in spec.metrics_for(bench, "read_set.gst",
                                                 "per_layer")}
    assert layer == {"gsa_ms", "gst_ms", "gsa_split_ms", "gsa_tiefix_ms",
                     "gst_dollar_ms", "device_idle_pct.gsa"}
