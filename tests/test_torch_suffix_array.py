"""SA+LCP construction of the port against the JAX package (p = 1, whole
padded device state) and against the native SA-IS + Kasai oracle, across
corpora that reach every stage: k-mer init only, dense L-pling steps with
narrow and wide resolve chunks, and the two-stage sparse tail.  Exact
equality (integers only)."""

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig, build_suffix_array
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.native import lcp_array, suffix_array
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.ops.oracle import lcp_kasai, suffix_array_np

torch.set_num_threads(1)

#: reaches the big tail stage, its recompaction and the small stage
REP_BIG_TAIL = dict(n=1 << 16, unit_len=1024, seed=7, mutations=64)
#: enters the small tail stage directly
REP_SMALL_TAIL = dict(n=1 << 17, seed=2)

TEXTS = {
    "a": b"a",
    "ab": b"ab",
    "banana": b"banana",
    "a10": b"a" * 10,
    "abc300": b"abc" * 300,
    "dna1000": rand_dna(1000, seed=1),
    "dna4177": rand_dna(4177, seed=2),
    "rep_small_tail": rep_dna(**REP_SMALL_TAIL),
    "rep_big_tail": rep_dna(**REP_BIG_TAIL),
}
CONFIGS = {
    "default": SAConfig(),
    "int64": SAConfig(force_int64=True),
    "dense2": SAConfig(dense_factor=2),
    "sa_only": SAConfig(construct_lcp=False),
    "sa_only_f4": SAConfig(construct_lcp=False, factor=4),
}


def test_mississippi_golden():
    res = build_suffix_array(b"mississippi", "cpu")
    np.testing.assert_array_equal(res.sa, [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2])
    np.testing.assert_array_equal(res.lcp, [0, 1, 1, 4, 0, 0, 1, 0, 2, 1, 3])


def test_resolve_device_defaults_to_the_card():
    from psac_tpu_torch.config import resolve_device

    assert resolve_device() == torch.device("cuda")
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


@pytest.mark.parametrize("entry", ["encode_and_shard", "build_suffix_array",
                                   "build_suffix_tree", "build_desa",
                                   "ansv"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Called with no device, every build entry point resolves None through
    ``config.resolve_device``, which gives the card.  The spy hands the
    CPU back so the call runs here."""
    import psac_tpu_torch
    from psac_tpu_torch import config

    asked = []
    real = config.resolve_device

    def spy(device=None):
        asked.append(real(device))
        return torch.device("cpu")

    monkeypatch.setattr(config, "resolve_device", spy)
    fn = t_sa.encode_and_shard if entry == "encode_and_shard" else \
        getattr(psac_tpu_torch, entry)
    fn(np.array([3, 1, 2]) if entry == "ansv" else b"mississippi")
    assert asked == [torch.device("cuda")]


def test_no_device_means_the_card_without_fallback():
    """With no card, a build with no device raises rather than running on
    the CPU; with one, its tensors are on the card."""
    if torch.cuda.is_available():
        xs = t_sa.encode_and_shard(b"mississippi")[0]
        assert xs.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            t_sa.encode_and_shard(b"mississippi")
        with pytest.raises((RuntimeError, AssertionError)):
            build_suffix_array(b"mississippi")
    np.testing.assert_array_equal(
        build_suffix_array(b"mississippi", "cpu").sa,
        [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2])


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("text", sorted(TEXTS))
def test_vs_native(text, cfg):
    t = TEXTS[text]
    config = CONFIGS[cfg]
    res = build_suffix_array(t, "cpu", config)
    sa = suffix_array(t)
    np.testing.assert_array_equal(res.sa, sa)
    if config.construct_lcp:
        np.testing.assert_array_equal(res.lcp, lcp_array(t, sa))
    else:
        assert res.lcp is None


@pytest.mark.parametrize("text,cfg", [("dna1000", "default"),
                                      ("rep_big_tail", "default"),
                                      ("rep_big_tail", "int64"),
                                      ("banana", "sa_only")])
def test_device_state_vs_jax(mesh1, text, cfg):
    """The whole padded (N,) SA, LCP and ISA equal the JAX package's."""
    import jax

    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models.suffix_array import construct_device, encode_and_shard

    t = TEXTS[text]
    config = CONFIGS[cfg]
    jcfg = JaxSAConfig(**{k: getattr(config, k) for k in
                          ("construct_lcp", "force_int64", "dense_factor",
                           "factor")})
    assert SAConfig.from_jax(jcfg) == config
    xs, alpha, n, N = encode_and_shard(t, mesh1, jcfg)
    jd = construct_device(xs, alpha, n, N, mesh1, jcfg)
    xs_t, alpha_t, n_t, N_t = t_sa.encode_and_shard(t, "cpu")
    assert (n_t, N_t) == (n, N)
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs))
    td = t_sa.construct_device(xs_t, alpha_t, n_t, N_t, config)
    for name in ("sa", "isa") + (("lcp",) if config.construct_lcp else ()):
        want = np.asarray(jax.device_get(getattr(jd, name)))
        got = getattr(td, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_tail_stages_reached(monkeypatch):
    """The corpora above do reach the tail stages they are named for."""
    calls = []
    for name in ("_tail_enter_local", "_tail_recompact_local",
                 "_stepL_local"):
        orig = getattr(t_sa._Builder, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(t_sa._Builder, name, spy)
    build_suffix_array(TEXTS["rep_big_tail"], "cpu")
    assert calls.count("_tail_recompact_local") == 1
    assert calls.count("_stepL_local") >= 2
    calls.clear()
    build_suffix_array(TEXTS["rep_small_tail"], "cpu")
    assert "_tail_enter_local" in calls
    assert "_tail_recompact_local" not in calls


def test_int_alphabet_and_kmer_cap():
    rng = np.random.RandomState(3)
    arr = rng.randint(-5, 300, 1500).astype(np.int64)
    res = build_suffix_array(arr, "cpu")
    sa = suffix_array_np(arr)
    np.testing.assert_array_equal(res.sa, sa)
    np.testing.assert_array_equal(res.lcp, lcp_kasai(arr, sa))
    t = rand_dna(2000, seed=5)
    res = build_suffix_array(t, "cpu", SAConfig(k=7, kmer_words=3))
    np.testing.assert_array_equal(res.sa, suffix_array(t))


def test_edge_inputs_and_errors():
    res = build_suffix_array(b"", "cpu")
    assert res.n == 0 and len(res.sa) == 0 and len(res.lcp) == 0
    with pytest.raises(ValueError):
        build_suffix_array(b"ab\x00c", "cpu")
    # the options that once raised NotImplementedError build the oracle's
    for opt in (dict(pack_keys=True), dict(fused=False)):
        res = build_suffix_array(b"abc", "cpu", SAConfig(**opt))
        np.testing.assert_array_equal(res.sa, [0, 1, 2])
        np.testing.assert_array_equal(res.lcp, [0, 0, 0])


def test_device_suffix_array_from_numpy_roundtrip():
    t = rand_dna(3000, seed=8)
    xs, alpha, n, N = t_sa.encode_and_shard(t, "cpu")
    dsa = t_sa.construct_device(xs, alpha, n, N)
    back = t_sa.DeviceSuffixArray.from_numpy(
        dsa.sa.numpy(), dsa.lcp.numpy(), dsa.isa.numpy(), alpha, n, N, "cpu")
    assert back.sa.dtype == torch.int32
    res, want = back.materialize(), dsa.materialize()
    np.testing.assert_array_equal(res.sa, want.sa)
    np.testing.assert_array_equal(res.lcp, want.lcp)
    wide = t_sa.DeviceSuffixArray.from_numpy(
        dsa.sa.numpy().astype(np.int64), None, dsa.isa.numpy(), alpha, n, N,
        "cpu")
    assert wide.sa.dtype == torch.int64 and wide.lcp is None
