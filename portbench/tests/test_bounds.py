"""The copy of chip_smoke.py's kmer_bound gives PERF.md's K9 and K10
bounds at N = 2^26, int32 codes and indexes, ks (10, 10)."""

import pytest

from portbench.harness.bounds import kmer_heads_bound, kmer_pack_bound


def test_kmer_bounds_at_2_26():
    N = 1 << 26
    assert kmer_pack_bound(N, (10, 10)) * 1e3 == pytest.approx(0.2404,
                                                               abs=5e-5)
    assert kmer_heads_bound(N, (10, 10)) * 1e3 == pytest.approx(0.2604,
                                                                abs=5e-5)
