"""Generalized suffix tree on a mesh of p > 1 CPU shards: the padded node
table against the JAX package's ``construct_gst_device`` on the
conftest's virtual devices at p = 2, 4 and 8 (on a GSA the port builds,
and on the JAX package's GSA carried over by ``DeviceGSA.from_numpy(...,
mesh=)``), the real rows against ``gst_expected`` at p = 2-13, the start
bits across the shard boundaries, the plain ANSV kernels and the routing's
capacity retry forced.  Exact equality (integers only)."""

import functools

import numpy as np
import pytest
import torch

from psac_tpu_torch import build_gst
from psac_tpu_torch.models import gsa as t_gsa
from psac_tpu_torch.models import suffix_tree as t_st
from psac_tpu_torch.parallel.ansv import PLAIN
from psac_tpu_torch.parallel.mesh import make_mesh
from test_torch_gsa import GST_SETS, gst_expected
from test_torch_mesh_gsa import ALL_SETS, _tiny_caps, cpu_mesh, jax_build

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_gst(p: int, name: str):
    """The JAX package's ``DeviceGSA`` and padded GST node table of a set
    at p (cached)."""
    import jax
    from psac_tpu.models.suffix_tree import construct_gst_device

    jd = jax_build(p, name)
    return jd, np.asarray(jax.device_get(construct_gst_device(jd).nodes))


#: every set at p = 4, two at p = 2 and 8
GST_CASES = [(4, name) for name in ("bananas", "duplicates", "graft24",
                                    "tiny", "n_eq_N")] + [
    (2, "duplicates"), (2, "n_eq_N"), (8, "tiny"), (8, "n_eq_N")]


@pytest.mark.parametrize("p,name", GST_CASES)
def test_gst_vs_jax(p, name):
    """The padded GST node table equals the JAX package's at p, and its
    real rows ``gst_expected``; in the ``n == N`` set the JAX side's start
    bit at n (``psac_tpu/models/suffix_tree.py:197``) has no position to
    sit on, and elsewhere it is never read: the tables agree."""
    key = f"n_eq_N{p}" if name == "n_eq_N" else name
    parts = ALL_SETS[key]
    jd, want = jax_gst(p, key)
    dg = t_gsa.build_gsa_device(parts, mesh=cpu_mesh(p))
    if name == "n_eq_N":
        assert dg.n == dg.N == jd.N
    tree = t_st.construct_gst_device(dg)
    assert (tree.n, tree.N, tree.sigma) == (jd.n, jd.N, jd.alphabet.sigma + 1)
    np.testing.assert_array_equal(tree.nodes.gather().numpy(), want)
    np.testing.assert_array_equal(tree.materialize(), gst_expected(parts))


@pytest.mark.parametrize("p", [2, 3, 4, 6, 8, 13])
def test_gst_vs_oracle_every_p(p):
    """Every GST set at p = 3, the small ones at the other p."""
    for name, parts in GST_SETS.items():
        if p != 3 and sum(map(len, parts)) > 400:
            continue
        got = build_gst(parts, mesh=cpu_mesh(p))
        np.testing.assert_array_equal(got, gst_expected(parts),
                                      err_msg=name)


def test_start_bits_below_n_on_a_mesh():
    """The start bits of a mesh's shards are the p = 1 bits, below n
    only, also across the shard boundaries."""
    lens = np.array([3, 5, 1, 7, 2, 4, 6])
    n = int(lens.sum())
    for p in (2, 4):
        N = 8 * p * (-(-n // (8 * p)))
        want = t_st._start_bits(
            t_gsa._eos_device(lens, n, N, torch.int32, "cpu"), n)
        mesh = cpu_mesh(p)
        eos = t_gsa._eos_device(lens, n, N, torch.int32, None, mesh)
        np.testing.assert_array_equal(
            eos.gather().numpy(),
            t_gsa._eos_device(lens, n, N, torch.int32, "cpu").numpy())
        got = mesh.run(lambda ctx, e: t_st._start_bits(e, n, ctx), eos)
        assert torch.equal(got.gather(), want)
        assert int(want.sum()) == len(lens) and not want[n:].any()


def test_from_numpy_carries_the_jax_state():
    """``DeviceGSA.from_numpy(..., mesh=)`` shards the JAX package's p = 4
    state; the port's GST of it equals the JAX GST, and a mesh of one
    shard is its device."""
    import jax

    jd, want = jax_gst(4, "graft24")
    arrs = [np.asarray(jax.device_get(a))
            for a in (jd.sa, jd.lcp, jd.eos, jd.xs)]
    dg = t_gsa.DeviceGSA.from_numpy(*arrs, jd.alphabet, jd.lens, jd.n, jd.N,
                                    None, mesh=cpu_mesh(4))
    assert dg.mesh is cpu_mesh(4) and dg.sa.p == 4
    tree = t_st.construct_gst_device(dg)
    np.testing.assert_array_equal(tree.nodes.gather().numpy(), want)
    res = dg.materialize()
    np.testing.assert_array_equal(
        res.sa, np.asarray(jax.device_get(jd.sa))[jd.N - jd.n:])
    one = t_gsa.DeviceGSA.from_numpy(*arrs, jd.alphabet, jd.lens, jd.n, jd.N,
                                     None, mesh=make_mesh(1, ["cpu"]))
    assert one.mesh is None and one.sa.device.type == "cpu"


def test_gst_plain_kernels_on_a_mesh():
    for p in (2, 4):
        dg = t_gsa.build_gsa_device(GST_SETS["random_dna"],
                                    mesh=cpu_mesh(p))
        assert torch.equal(t_st._gst_local(dg, PLAIN).nodes.gather(),
                           t_st.construct_gst_device(dg).nodes.gather())


def test_gst_retries_on_overflow(monkeypatch):
    """The GST's routing at capscale 6 forced to overflow: the build is
    redone without a bound and equals the one that never overflows."""
    for name in ("duplicates", "random_dna"):
        dg = t_gsa.build_gsa_device(GST_SETS[name], mesh=cpu_mesh(4))
        want = t_st.construct_gst_device(dg).nodes.gather()
        calls = []
        with monkeypatch.context() as mp:
            _tiny_caps(mp, t_st, calls)
            got = t_st.construct_gst_device(dg).nodes.gather()
        assert 6 in calls and None in calls
        assert torch.equal(got, want), name
