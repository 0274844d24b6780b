"""The generators repeat per seed and keep their source's shape."""

import numpy as np
import pytest

from portbench.harness import spec

F = spec.Finder()
BIG = 2**31 + 12345  # seeds run past 32 signed bits


@pytest.mark.parametrize("params", [
    {"n": 5000, "alphabet": "ACGT"},
    {"n": 23 * 300, "alphabet": "ACGT", "copies": 23, "sub_rate": 0.01},
])
def test_text_repeats_per_seed(params):
    gen = F.module("gen", "text")
    a, b = gen.make(params, BIG, "cpu"), gen.make(params, BIG, "cpu")
    c = gen.make(params, BIG + 1, "cpu")
    assert a == b and a != c
    assert len(a) == params["n"] and set(a) == set(b"ACGT")


def test_text_uniform_letters():
    t = np.frombuffer(F.module("gen", "text").make(
        {"n": 400000, "alphabet": "ACGT"}, 7, "cpu"), np.uint8)
    share = np.bincount(t, minlength=256)[list(b"ACGT")] / t.size
    assert np.allclose(share, 0.25, atol=0.005)


def test_text_copies_with_substitutions():
    base, copies, rate = 20000, 23, 0.001
    t = np.frombuffer(F.module("gen", "text").make(
        {"n": base * copies, "alphabet": "ACGT", "copies": copies,
         "sub_rate": rate}, BIG, "cpu"), np.uint8).reshape(copies, base)
    # each copy differs from the consensus at about rate * base positions
    cons = np.array([np.bincount(col, minlength=256).argmax()
                     for col in t.T], np.uint8)
    diff = (t != cons).sum(1)
    assert (diff > 0).all()
    assert abs(diff.mean() - rate * base) < 0.3 * rate * base


def test_patterns_are_substrings_and_repeat():
    text = F.module("gen", "text").make({"n": 3000, "alphabet": "ACGT"},
                                        BIG, "cpu")
    gen = F.module("gen", "patterns")
    params = {"batch": 50, "length": 20, "batches_per_s": 3}
    mat, batches = gen.make(params, text, BIG, "cpu", seconds=2.0)
    mat2, _ = gen.make(params, text, BIG, "cpu", seconds=2.0)
    assert np.array_equal(mat, mat2)
    assert mat.shape == (gen.pool_size(params, 2.0), 50, 20) == (7, 50, 20)
    for b, lines in enumerate(batches):
        assert len(lines) == 50
        for i, p in enumerate(lines):
            assert p == mat[b, i].tobytes() and len(p) == 20 and p in text
