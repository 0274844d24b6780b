"""Suffix tree of the port against the sequential interval oracle and the
JAX package (p = 1), on the texts of tests/test_suffix_tree.py, plus the
JAX package's SA+LCP fed into the port's tree stage through
``DeviceSuffixArray.from_numpy``.  Exact equality (integers only)."""

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig, build_suffix_tree
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.models import suffix_tree as t_st
from psac_tpu_torch.ops.alphabet import Alphabet, rand_dna
from psac_tpu_torch.ops.oracle import lcp_kasai, suffix_array_np
from psac_tpu_torch.parallel.ansv import PLAIN
from psac_tpu_torch.verify.suffix_tree_oracle import suffix_tree_oracle

torch.set_num_threads(1)


def expected_tree(text: bytes) -> np.ndarray:
    alpha = Alphabet.from_bytes(text)
    sa = suffix_array_np(text)
    return suffix_tree_oracle(alpha.encode(text), sa, lcp_kasai(text, sa),
                              alpha.sigma)


TEXTS = {
    "mississippi": b"mississippi",
    "abab": b"abab",
    "a10": b"a" * 10,
    "banana": b"banana",
    "dna116": rand_dna(116, seed=116),
    "dna1000": rand_dna(1000, seed=1000),
    "dna4177": rand_dna(4177, seed=4177),
    "abc300": b"abc" * 300,
    "bytes3000": np.random.RandomState(17).randint(
        32, 122, size=3000).astype(np.uint8).tobytes(),
    # the two smallest suffixes differ in their first char and the first
    # real row sits inside a tile after padding rows: its left match is a
    # padding row of LCP -1 (the in-tile PSV value must stay -1)
    "zyxa": b"zyxa",
    "homopolymer": b"A" * 3000,  # spine overflow: dual-scan fallback
}


@pytest.mark.parametrize("text", sorted(TEXTS))
def test_st_vs_oracle(text):
    t = TEXTS[text]
    np.testing.assert_array_equal(build_suffix_tree(t, "cpu"),
                                  expected_tree(t))


@pytest.mark.parametrize("text", ["mississippi", "dna4177", "abc300"])
def test_st_int64_build(text):
    t = TEXTS[text]
    got = build_suffix_tree(t, "cpu", SAConfig(force_int64=True))
    np.testing.assert_array_equal(got, expected_tree(t))


@pytest.mark.parametrize("text", ["mississippi", "dna1000"])
def test_st_vs_jax(mesh1, text):
    from psac_tpu.models.suffix_tree import build_suffix_tree as jax_st

    t = TEXTS[text]
    np.testing.assert_array_equal(build_suffix_tree(t, "cpu"),
                                  jax_st(t, mesh=mesh1))


def test_st_from_jax_suffix_array(mesh1):
    """The JAX package's device SA+LCP, carried over as numpy arrays, gives
    the same tree in the port as the port's own SA+LCP."""
    import jax

    from psac_tpu.models.suffix_array import construct_device, encode_and_shard

    t = TEXTS["dna4177"]
    xs, alpha, n, N = encode_and_shard(t, mesh1)
    jd = construct_device(xs, alpha, n, N, mesh1)
    sa, lcp, isa = (np.asarray(jax.device_get(a))
                    for a in (jd.sa, jd.lcp, jd.isa))
    dsa = t_sa.DeviceSuffixArray.from_numpy(sa, lcp, isa, alpha, n, N, "cpu")
    xs_t, *_ = t_sa.encode_and_shard(t, "cpu")
    tree = t_st.construct_suffix_tree_device(dsa, xs_t)
    np.testing.assert_array_equal(tree.materialize(), expected_tree(t))
    plain = t_st._st_local(dsa, xs_t, PLAIN)
    assert torch.equal(plain.nodes, tree.nodes)


def test_st_requires_lcp():
    xs, alpha, n, N = t_sa.encode_and_shard(b"banana", "cpu")
    dsa = t_sa.construct_device(xs, alpha, n, N,
                                SAConfig(construct_lcp=False))
    with pytest.raises(ValueError):
        t_st.construct_suffix_tree_device(dsa, xs)
