"""The GSA's host-driven loop (``SAConfig(fused=False)``) against the JAX
package's at p = 1 and the sorting / native oracles, ``pack_keys`` (pairs
of int32 sort keys in one int64 lane) on and off, and the fused path's
hand-over to the host-driven loop when its dense loop stops at the
iteration bound (forced by patching ``fused_max_iters``).  Exact equality
(integers only)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig, build_gsa, build_suffix_array
from psac_tpu_torch.models import gsa as t_gsa
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.native import lcp_array, suffix_array
from psac_tpu_torch.ops import rmq as t_rmq
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.parallel import sort as t_sort
from psac_tpu_torch.verify.cases import near_identical_family as family
from psac_tpu_torch.verify.gsa_oracle import gsa_oracle_native
from test_torch_gsa import SETS

torch.set_num_threads(1)

GSA_CONFIGS = {
    "host": dict(fused=False),
    "host_tail0": dict(fused=False, tail_threshold_frac=0.0),
    "host_sa_only": dict(fused=False, construct_lcp=False),
    "host_int64": dict(fused=False, force_int64=True),
}
#: every set with the default host loop; the variants on two sets
GSA_CASES = [(name, "host") for name in sorted(SETS)] + [
    (name, cfg) for name in ("mixed", "near_identical")
    for cfg in ("host_tail0", "host_sa_only", "host_int64")]


def _oracle(strings):
    return gsa_oracle_native(*t_gsa._flatten(strings))


@pytest.mark.parametrize("name,cfg", GSA_CASES)
def test_gsa_host_loop_vs_jax_and_oracle(mesh1, name, cfg):
    import jax

    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models.gsa import build_gsa_device as jax_build

    strings, c = SETS[name], GSA_CONFIGS[cfg]
    jd = jax_build(strings, mesh1, JaxSAConfig(**c))
    td = t_gsa.build_gsa_device(strings, "cpu", SAConfig(**c))
    lcp = c.get("construct_lcp", True)
    for field in ("sa", "eos") + (("lcp",) if lcp else ()):
        want = np.asarray(jax.device_get(getattr(jd, field)))
        got = getattr(td, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    res = td.materialize()
    sa, glcp = _oracle(strings)
    np.testing.assert_array_equal(res.sa, sa)
    if lcp:
        np.testing.assert_array_equal(res.lcp, glcp)
    else:
        assert res.lcp is None


def test_gsa_host_loop_reaches_the_tail_and_resolves(monkeypatch):
    """The mixed set runs dense steps, then enters the eos-aware tail at
    threshold 0.1, and resolves with K6's wrapper in both."""
    calls = []

    def spy(rmq, ks, *args, **kw):
        calls.append(ks.shape[0] == rmq.x.shape[0])  # dense: one slot a row
        return t_rmq.rmq_resolve(rmq, ks, *args, **kw)

    monkeypatch.setattr(t_sa, "rmq_resolve", spy)
    strings = SETS["mixed"]
    res = build_gsa(strings, "cpu", SAConfig(fused=False))
    assert True in calls and False in calls
    sa, lcp = _oracle(strings)
    np.testing.assert_array_equal(res.sa, sa)
    np.testing.assert_array_equal(res.lcp, lcp)


# ---------------------------------------------------------------------------
# pack_keys (tests/test_suffix_array.py::test_pack_keys_parity)
# ---------------------------------------------------------------------------

PACK_TEXTS = {"dna": rand_dna(4000, seed=77),
              "ab_ba": b"ab" * 900 + b"ba" * 100}
PACK_CONFIGS = {
    # fused dense F=5: 6 key columns -> 3 packed lanes, LCP on
    "fused_f5": dict(dense_factor=5),
    # host-loop construct_arr<5> (SA-only, like the reference)
    "host_f5": dict(fused=False, factor=5, construct_lcp=False),
}


def _lane_dtypes(monkeypatch):
    """Record the key dtypes of every ``lex_perm`` the SA and GSA builds
    run (the GSA's steps sort through the shared ``_Builder._sort_keys``)."""
    seen = []

    def spy(keys):
        keys = tuple(keys)
        seen.append(tuple(k.dtype for k in keys))
        return t_sort.lex_perm(keys)

    monkeypatch.setattr(t_sa, "lex_perm", spy)
    return seen


@pytest.mark.parametrize("cfg", sorted(PACK_CONFIGS))
@pytest.mark.parametrize("text", sorted(PACK_TEXTS))
def test_pack_keys_parity(monkeypatch, mesh1, text, cfg):
    """Packed and unpacked builds give the same padded state, the JAX
    package's (packed) and the native oracle's; packing happens only in
    the sorts of 6 or more columns."""
    import jax

    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models import suffix_array as j_sa

    t, c = PACK_TEXTS[text], PACK_CONFIGS[cfg]
    seen = _lane_dtypes(monkeypatch)
    states, sorts = {}, {}
    for packed in (True, False):
        seen.clear()
        xs, alpha, n, N = t_sa.encode_and_shard(t, "cpu")
        states[packed] = t_sa.construct_device(
            xs, alpha, n, N, SAConfig(pack_keys=packed, **c))
        sorts[packed] = list(seen)
    # each 5-column dense sort (+ gidx) runs as three int64 lanes
    wide = sum(len(k) == 5 for k in sorts[False])
    assert not any(torch.int64 in k for k in sorts[False])
    assert sum(k == (torch.int64,) * 3 for k in sorts[True]) == wide
    assert sum(torch.int64 in k for k in sorts[True]) == wide
    if text == "ab_ba":
        assert wide > 0
    jcfg = JaxSAConfig(pack_keys=True, **c)
    xs, alpha, n, N = j_sa.encode_and_shard(t, mesh1, jcfg)
    jd = j_sa.construct_device(xs, alpha, n, N, mesh1, jcfg)
    fields = ("sa", "isa") + (("lcp",) if c.get("construct_lcp", True)
                              else ())
    for field in fields:
        want = np.asarray(jax.device_get(getattr(jd, field)))
        for packed, td in states.items():
            np.testing.assert_array_equal(getattr(td, field).numpy(), want,
                                          err_msg=f"{field} packed={packed}")
    res = states[True].materialize()
    sa = suffix_array(t)
    np.testing.assert_array_equal(res.sa, sa)
    if "lcp" in fields:
        np.testing.assert_array_equal(res.lcp, lcp_array(t, sa))


def test_pack_keys_gate(monkeypatch):
    """The JAX gate: packing needs ``max(dense_factor if fused else 2,
    factor) >= 5`` and an int32 build; the GSA never packs."""
    seen = _lane_dtypes(monkeypatch)
    t = PACK_TEXTS["ab_ba"]
    for c in (dict(dense_factor=4), dict(dense_factor=5, force_int64=True),
              dict(fused=False, dense_factor=5)):
        sorts = {}
        for packed in (True, False):
            seen.clear()
            res = build_suffix_array(t, "cpu",
                                     SAConfig(pack_keys=packed, **c))
            np.testing.assert_array_equal(res.sa, suffix_array(t))
            sorts[packed] = list(seen)
        # the same sorts, column for column
        assert sorts[True] == sorts[False], c
    strings = SETS["repeat_family"]
    sorts = {}
    for packed in (True, False):
        seen.clear()
        res = build_gsa(strings, "cpu",
                        SAConfig(pack_keys=packed, dense_factor=5))
        np.testing.assert_array_equal(res.sa, _oracle(strings)[0])
        sorts[packed] = list(seen)
    assert sorts[True] == sorts[False] and sorts[True]


# ---------------------------------------------------------------------------
# the fused path's hand-over to the host-driven loop
# ---------------------------------------------------------------------------

#: leaves more active elements after the k-mer init than the fused tail
#: takes, so a dense loop bounded at 0 iterations hands over
HANDOVER_TEXT = rep_dna(4096, unit_len=128, seed=5, mutations=200)


@pytest.mark.parametrize("cfg", [dict(), dict(construct_lcp=False, factor=3),
                                 dict(tail_threshold_frac=0.0)])
def test_sa_hand_over(monkeypatch, cfg):
    t = HANDOVER_TEXT
    xs, alpha, n, N = t_sa.encode_and_shard(t, "cpu")
    want = t_sa.construct_device(xs, alpha, n, N, SAConfig(**cfg))
    assert t_sa.LAST_BUILD["host_iters"] == 0
    monkeypatch.setattr(t_sa, "fused_max_iters", lambda N: 0)
    got = t_sa.construct_device(xs, alpha, n, N, SAConfig(**cfg))
    assert t_sa.LAST_BUILD["fused"] is True
    assert t_sa.LAST_BUILD["host_iters"] > 0
    for field in ("sa", "isa", "lcp"):
        if getattr(want, field) is not None:
            assert torch.equal(getattr(got, field), getattr(want, field))
    res = got.materialize()
    sa = suffix_array(t)
    np.testing.assert_array_equal(res.sa, sa)
    if res.lcp is not None:
        np.testing.assert_array_equal(res.lcp, lcp_array(t, sa))


@pytest.mark.parametrize("cfg", [dict(), dict(construct_lcp=False)])
def test_gsa_hand_over(monkeypatch, cfg):
    strings = family(8, 1500, 3, seed=9)
    want = t_gsa.build_gsa_device(strings, "cpu", SAConfig(**cfg))
    monkeypatch.setattr(t_sa, "fused_max_iters", lambda N: 0)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = t_gsa.build_gsa_device(strings, "cpu", SAConfig(**cfg))
    assert err.getvalue().startswith(
        "[psac_tpu_torch] fused GSA did not converge (ue=")
    assert torch.equal(got.sa, want.sa)
    if want.lcp is not None:
        assert torch.equal(got.lcp, want.lcp)
    res = got.materialize()
    sa, lcp = _oracle(strings)
    np.testing.assert_array_equal(res.sa, sa)
    if res.lcp is not None:
        np.testing.assert_array_equal(res.lcp, lcp)
