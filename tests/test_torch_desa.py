"""The DESA pattern index of the port against the JAX package's
``build_desa(text, mesh=make_mesh(1))``: the same k-mer depth, table,
segment start and capacity, slabs, RMQ tables, sampled TLDT rows, and the
same ``bulk_locate`` / ``bulk_locate_possible`` ranges; every exact range
is also checked by a naive occurrence scan.  Both top-level indexes, the
int64 index, mixed pattern lengths (several length groups), empty patterns
and characters outside the alphabet.  Exact equality (integers only)."""

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig
from psac_tpu_torch.models import desa as t_desa
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.ops.oracle import suffix_array_np

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
