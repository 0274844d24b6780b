"""SA+LCP construction on a mesh of p > 1 CPU shards against the JAX
package on the conftest's virtual devices at the same p: the whole padded
(isa, sa, lcp) state (N depends on p), Lc, and ``LAST_BUILD``'s driver
record; texts that finish at the k-mer init, that run the dense loop and
the sparse tail, SA-only, int64 indexes and the host-driven loop
(``fused=False``).  Odd p (3, 6, 13: the odd-even block sort) against the
JAX p = 1 result's real rows and the native oracle; ``resolve_with_retry``
forced to escalate; ``d_check_sa`` on a mesh, true and with two rows
swapped; the file input.  Exact equality (integers only)."""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

from psac_tpu_torch import SAConfig
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.native import lcp_array, suffix_array
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.parallel.mesh import make_mesh
from psac_tpu_torch.verify.check_sa import d_check_sa

torch.set_num_threads(1)

#: dense loop and sparse tail at every p (the host loop enters its tail
#: after two doubling steps)
REP = dict(n=4096, unit_len=128, seed=5, mutations=200)
TEXTS = {
    "mississippi": b"mississippi",
    "dna": rand_dna(2000, seed=1),
    "rep_dna": rep_dna(**REP),
}
CONFIGS = {
    "default": {},
    "host_loop": dict(fused=False),
    "sa_only": dict(construct_lcp=False),
    "int64": dict(force_int64=True),
    "lc": dict(construct_lc=True),
}


@functools.lru_cache(maxsize=None)
def cpu_mesh(p: int):
    return make_mesh(p, ["cpu"] * p)


@functools.lru_cache(maxsize=None)
def jax_build(p: int, text: str, cfg: str):
    """The JAX package's padded state and LAST_BUILD at p (cached)."""
    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models import suffix_array as j_sa
    from psac_tpu.parallel.mesh import make_mesh as j_make_mesh

    jcfg = JaxSAConfig(**CONFIGS[cfg])
    mesh = j_make_mesh(p)
    xs, alpha, n, N = j_sa.encode_and_shard(TEXTS[text], mesh, jcfg)
    jd = j_sa.construct_device(xs, alpha, n, N, mesh, jcfg)
    state = {f: None if getattr(jd, f) is None else np.asarray(getattr(jd, f))
             for f in ("isa", "sa", "lcp", "lc")}
    return state, N, dict(j_sa.LAST_BUILD.d)


def port_build(p: int, text: bytes, **cfg):
    mesh = cpu_mesh(p)
    xs, alpha, n, N = t_sa.encode_and_shard(text, mesh=mesh)
    dsa = t_sa.construct_device(xs, alpha, n, N, SAConfig(**cfg), mesh)
    return dsa, xs, dict(t_sa.LAST_BUILD.d)


def _padded(dsa, f):
    x = getattr(dsa, f)
    return None if x is None else x.gather().numpy()


def _check_vs_jax(p, text, cfg):
    want, N, jlb = jax_build(p, text, cfg)
    dsa, _, lb = port_build(p, TEXTS[text], **CONFIGS[cfg])
    assert dsa.N == N
    for f in ("isa", "sa", "lcp", "lc"):
        got = _padded(dsa, f)
        if want[f] is None:
            assert got is None, f
        else:
            np.testing.assert_array_equal(got, want[f], err_msg=f)
    for k in ("fused", "host_iters", "p", "n", "N"):
        assert lb[k] == jlb[k], (k, lb, jlb)


@pytest.mark.parametrize("p,text", [
    (2, "rep_dna"), (4, "mississippi"), (4, "dna"), (4, "rep_dna"),
    (8, "dna"), (8, "rep_dna")])
def test_padded_state_vs_jax(p, text):
    _check_vs_jax(p, text, "default")


@pytest.mark.parametrize("cfg", ["host_loop", "sa_only", "int64", "lc"])
def test_configs_vs_jax(cfg):
    _check_vs_jax(4, "rep_dna", cfg)


@pytest.mark.parametrize("p", [3, 6, 13])
@pytest.mark.parametrize("text", ["dna", "rep_dna"])
def test_odd_mesh_vs_p1_and_oracle(p, text):
    """Odd p takes the odd-even block sort: real rows equal the JAX p = 1
    build's and the native SA-IS + Kasai oracle's."""
    t = TEXTS[text]
    dsa, _, lb = port_build(p, t)
    assert lb["p"] == p
    res = dsa.materialize()
    sa = suffix_array(t)
    np.testing.assert_array_equal(res.sa, sa)
    np.testing.assert_array_equal(res.lcp, lcp_array(t, sa))
    want, N1, _ = jax_build(1, text, "default")
    n = len(t)
    np.testing.assert_array_equal(res.sa, want["sa"][N1 - n:])


def test_odd_mesh_host_loop_and_sa_only():
    t = TEXTS["rep_dna"]
    sa = suffix_array(t)
    for cfg in (dict(fused=False), dict(construct_lcp=False, factor=3,
                                        fused=False)):
        res = port_build(3, t, **cfg)[0].materialize()
        np.testing.assert_array_equal(res.sa, sa)


def test_build_suffix_array_entry(tmp_path):
    """``build_suffix_array(text, mesh=)`` and ``construct_from_file(path,
    mesh=)`` give the oracle's arrays; a mesh of one shard is its device."""
    t = TEXTS["rep_dna"]
    sa = suffix_array(t)
    lcp = lcp_array(t, sa)
    for mesh in (cpu_mesh(4), make_mesh(1, ["cpu"])):
        res = t_sa.build_suffix_array(t, mesh=mesh)
        np.testing.assert_array_equal(res.sa, sa)
        np.testing.assert_array_equal(res.lcp, lcp)
    path = tmp_path / "rep.txt"
    path.write_bytes(t)
    dsa, xs = t_sa.construct_from_file(str(path), mesh=cpu_mesh(4))
    np.testing.assert_array_equal(dsa.materialize().sa, sa)
    assert d_check_sa(dsa, xs)


def test_resolve_escalates_on_overflow(monkeypatch):
    """The host loop's resolve at capscale 6 forced to overflow (a routing
    capacity of 2): it says so on stderr under ``PSAC_TIMER``, retries with
    cap = m, and the build equals the one that never overflows."""
    real = t_sa.cap_for
    calls = []

    def tiny(m, p, capscale):
        calls.append(capscale)
        return 2 if capscale is not None else real(m, p, capscale)

    t = TEXTS["rep_dna"]
    want = port_build(4, t, fused=False)[0]
    monkeypatch.setattr(t_sa, "cap_for", tiny)
    monkeypatch.setenv("PSAC_TIMER", "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = port_build(4, t, fused=False)[0]
    assert 6 in calls and None in calls
    lines = [ln for ln in err.getvalue().splitlines()
             if "resolve route overflow" in ln]
    assert lines and all(ln.startswith("[psac_tpu] resolve route overflow (")
                         and ln.endswith("at capscale=6); retrying with "
                                         "cap=m") for ln in lines)
    for f in ("isa", "sa", "lcp"):
        np.testing.assert_array_equal(_padded(got, f), _padded(want, f))


@pytest.mark.parametrize("p", [3, 4])
def test_d_check_sa_on_a_mesh(p):
    """True for the build; false once two real rows are swapped."""
    dsa, xs, _ = port_build(p, TEXTS["dna"])
    assert d_check_sa(dsa, xs)
    sa = _padded(dsa, "sa").copy()
    sa[-1], sa[-7] = sa[-7], sa[-1]
    bad = t_sa.DeviceSuffixArray.from_numpy(
        sa, None, _padded(dsa, "isa"), dsa.alphabet, dsa.n, dsa.N, None,
        mesh=cpu_mesh(p))
    assert not d_check_sa(bad, xs)


def test_rep_dna_2048_at_p8_stays_fused():
    """``rep_dna(2048, unit_len=256, seed=11)`` at p = 8 converges on the
    fused path with no host-loop iteration, as the JAX package's multichip
    dry run requires of it."""
    t = rep_dna(2048, unit_len=256, seed=11)
    res = t_sa.build_suffix_array(t, mesh=cpu_mesh(8))
    assert t_sa.LAST_BUILD["fused"] is True
    assert t_sa.LAST_BUILD["host_iters"] == 0
    assert t_sa.LAST_BUILD["p"] == 8
    np.testing.assert_array_equal(res.sa, suffix_array(t))
